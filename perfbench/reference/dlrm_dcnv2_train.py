"""Plain reference of DLRM-DCNv2's training step (MLPerf Training's
recommendation benchmark: mlcommons/training ``recommendation_v2/
torchrec_dlrm``, torchrec's ``DLRM_DCN`` trained with FBGEMM's exact
Adagrad), in plain PyTorch and float32 with TF32 off. It imports nothing of
the program and nothing of JAX: each piece is written out from its
published definition.

* Bags: each field's ids looked up with ``torch.index_select`` and summed,
  row by row.
* Dense arch: ``Linear`` then ReLU, every layer (torchrec's ``MLP``).
* Interaction: ``x0 = concat(dense vector, the pooled fields)``, then
  ``x_{l+1} = x0 ⊙ (x_l V_l W_l + b_l) + x_l`` (``LowRankCrossNet``).
* Over arch: ``Linear`` then ReLU for each hidden layer, then a plain
  ``Linear`` to one logit; torch's mean BCE with logits.
* Gradients by autograd: the dense params', and each looked-up row's;
  duplicates within and across bags summed per distinct row by
  ``index_add_``.
* Exact Adagrad (torch's ``Adagrad`` on the dense params, FBGEMM's
  ``EXACT_ADAGRAD`` on the table's touched rows): ``acc += g²;
  p -= lr · (g / (√acc + eps))``, accumulators from 0.

Every product goes through :func:`perfbench.reference.precision.matmul`
at ``prec`` (``f32`` is the reference; the control computes one precision
lower). The params are taken over, not copied (a cell's table is most of
the card), and :func:`run` reads the three steps as the harness compares
them. Departures from torchrec: the params are taken as given (their
initial scales under ``assumed`` in the configuration); the weights use
JAX's (in, out) layout (torchrec's ``Linear`` holds (out, in)); one table
stacks every field's rows at static offsets, so ids are rows of one table
(torchrec holds a table a field; the same rows). Params are a dict under
``models/ctr.py``'s names.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from perfbench.reference.precision import full_f32, matmul

ROW_BLOCK = 1 << 20       # rows read back at a time


def bag_bounds(bag_sizes: Sequence[int]) -> List[Tuple[int, int]]:
    """Each field's slots ``[a, e)`` in an example's ids."""
    out, a = [], 0
    for k in bag_sizes:
        out.append((a, a + int(k)))
        a += int(k)
    return out


def n_layers(params: Dict[str, torch.Tensor], prefix: str) -> int:
    n = 0
    while f"{prefix}_w{n + 1}" in params:
        n += 1
    return n


def cross_layers(params: Dict[str, torch.Tensor]) -> int:
    n = 0
    while f"cross_v{n + 1}" in params:
        n += 1
    return n


def forward(p: Dict[str, torch.Tensor], dense: torch.Tensor, pooled: torch.Tensor,
            prec: str = "f32") -> torch.Tensor:
    """(B,) logits from the (B, F, D) pooled fields."""
    x = dense
    for i in range(1, n_layers(p, "bot") + 1):
        x = torch.relu(matmul(x, p[f"bot_w{i}"], prec) + p[f"bot_b{i}"])
    x0 = torch.cat([x, pooled.reshape(pooled.shape[0], -1)], dim=1)
    x = x0
    for li in range(1, cross_layers(p) + 1):
        x = x0 * (matmul(matmul(x, p[f"cross_v{li}"], prec), p[f"cross_w{li}"], prec)
                  + p[f"cross_b{li}"]) + x
    n = n_layers(p, "top")
    for i in range(1, n + 1):
        x = matmul(x, p[f"top_w{i}"], prec) + p[f"top_b{i}"]
        if i < n:
            x = torch.relu(x)
    return x[:, 0]


def bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The mean BCE with logits, torch's (torchrec's ``BCEWithLogitsLoss``)."""
    return torch.nn.functional.binary_cross_entropy_with_logits(logits, labels)


def bag_sum(rows: torch.Tensor) -> torch.Tensor:
    """(B, k, D) → (B, D): the bag's rows added one by one in slot order,
    from zeros (any order is a sum; this one rounds as the port's kernel
    does, so the comparison sees the model and not the order)."""
    out = torch.zeros_like(rows[:, 0])
    for j in range(rows.shape[1]):
        out = out + rows[:, j]
    return out


class Reference:
    """Three-step state over ``params`` (taken over), an accumulator beside
    each; ``prec`` the products' precision."""

    def __init__(self, params: Dict[str, torch.Tensor], bag_sizes: Sequence[int],
                 lr: float = 0.005, eps: float = 1e-8, prec: str = "f32"):
        self.p = {k: v.detach() for k, v in params.items()}
        self.acc = {k: torch.zeros_like(v) for k, v in self.p.items()}
        self.bounds = bag_bounds(bag_sizes)
        self.lr, self.eps, self.prec = lr, eps, prec

    def loss_and_grads(self, dense, ids, labels):
        """(loss, {dense param: gradient}, distinct rows, their summed
        gradients, each slot's row and gradient)."""
        table = self.p["embed"]
        b, d = ids.shape[0], table.shape[1]
        leaves = {k: v.clone().requires_grad_(True) for k, v in self.p.items() if k != "embed"}
        rows = [table.index_select(0, ids[:, a:e].reshape(-1).long()).requires_grad_(True)
                for a, e in self.bounds]
        pooled = torch.stack([bag_sum(r.reshape(b, e - a, d))
                              for r, (a, e) in zip(rows, self.bounds)], dim=1)
        with full_f32():
            loss = bce(forward(leaves, dense, pooled, self.prec), labels)
            grads = torch.autograd.grad(loss, list(leaves.values()) + rows)
        dense_grads = dict(zip(leaves, grads[:len(leaves)]))
        all_ids = torch.cat([ids[:, a:e].reshape(-1).long() for a, e in self.bounds])
        slot_grads = torch.cat(grads[len(leaves):])
        uniq, inv = torch.unique(all_ids, return_inverse=True)
        g = torch.zeros((uniq.numel(), d), dtype=table.dtype, device=table.device)
        g.index_add_(0, inv, slot_grads)
        return float(loss.detach()), dense_grads, uniq, g, (inv, slot_grads)

    def table_update(self, uniq: torch.Tensor, g: torch.Tensor, slots) -> None:
        """Exact Adagrad of the distinct rows ``uniq`` from their summed
        gradients ``g`` (``slots``: each slot's row and gradient, unused
        here)."""
        a = self.acc["embed"][uniq] + g * g
        self.acc["embed"][uniq] = a
        self.p["embed"][uniq] -= self.lr * (g / (torch.sqrt(a) + self.eps))

    def step(self, dense, ids, labels):
        """One step; → (loss, the dense params' gradients)."""
        loss, grads, uniq, g, slots = self.loss_and_grads(dense, ids, labels)
        with torch.no_grad():
            for k, gk in grads.items():
                self.acc[k] += gk * gk
                self.p[k] -= self.lr * (gk / (torch.sqrt(self.acc[k]) + self.eps))
            self.table_update(uniq, g, slots)
        return loss, grads


def rows_at(t: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``t[rows]`` on the host, gathered in blocks of rows."""
    return torch.cat([t[rows[a:a + ROW_BLOCK]].cpu() for a in range(0, rows.numel(),
                                                                    ROW_BLOCK)])


def run(ref: Reference, batches, rows: torch.Tensor, steps: int = 3) -> dict:
    """The reference's readings over the first ``steps`` of ``batches``
    ((dense, ids, labels) each): the losses, the first step's dense
    gradients, and after the last step the table and its accumulator at
    ``rows`` (on the host)."""
    losses, grads = [], None
    for k in range(steps):
        loss, g = ref.step(*batches[k])
        losses.append(loss)
        if grads is None:
            grads = {n: v.detach() for n, v in g.items()}
    return {"losses": losses, "dense_grads": grads,
            "w": rows_at(ref.p["embed"], rows), "acc": rows_at(ref.acc["embed"], rows)}
