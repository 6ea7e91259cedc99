"""Plain reference of the two-tower training step, in plain PyTorch: one
rank's tables (or the whole tables on a world of one) and the dense
weights, drawn again from the benchmark's seed; the towers (gather → ReLU
MLP with dropout → L2), the in-batch BPR loss, its gradients by autograd,
``optax.clip_by_global_norm`` then ``optax.adamw`` — each written out from
its published definition, nothing of the program imported.

The table gradients are sparse: the gathered rows' gradients summed per
distinct id. The optimizer updates every row (untouched rows only decay),
one block of rows at a time, so the reference fits beside nothing else:
run it after the program's state is freed. Over a world of several ranks
each holds one shard of rows of each table (``shard`` of a ``group``): the
batch's rows are summed over the group from the shards that hold them, every
rank computes the same loss and gradients, updates its own rows, and the
tables' change norms are summed over the group. Dropout draws its masks from a
generator seeded as the program's, in the program's order (user tower,
then item tower, each step), so both see the same masks. ``prec`` lowers
every product to another precision (the control).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List

import numpy as np
import torch

from perfbench.reference.precision import matmul

B1, B2, EPS = 0.9, 0.999, 1e-8
ROW_BLOCK = 1 << 21


def _tower(x, w1, b1, w2, b2, rate: float, gen, prec: str):
    h = torch.relu(matmul(x, w1, prec) + b1)
    if rate > 0.0:
        keep = torch.rand(h.shape, generator=gen, device=h.device) < 1.0 - rate
        h = torch.where(keep, h / (1.0 - rate), torch.zeros_like(h))
    out = matmul(h, w2, prec) + b2
    return out * torch.rsqrt((out * out).sum(-1, keepdim=True) + 1e-12)


def bpr_loss(u: torch.Tensor, v: torch.Tensor, prec: str) -> torch.Tensor:
    """Σ_{i≠j} softplus(s_ij − s_ii) / (B(B−1)), s = U Vᵀ."""
    b = u.shape[0]
    s = matmul(u, v.T, prec)
    x = s - s.diagonal()[:, None]
    sp = x.clamp(min=0) + torch.log1p(torch.exp(-x.abs()))
    off = 1.0 - torch.eye(b, device=u.device)
    return (sp * off).sum() / (b * (b - 1))


def bias_corrections(t: int):
    """optax's 1 − b^t of f32 params, computed in float32 as optax computes
    it (b rounded to float32 first: 1 − f32(0.999) is 1.3e-5 off 0.001)."""
    f32 = np.float32
    return tuple(float(f32(1) - f32(b) ** f32(t)) for b in (B1, B2))


class Reference:
    """The reference's state over three steps.

    ``params``: name → tensor (the rank's table shards and the dense
    weights), taken as given; ``genres``: the genre table; ``redraw(name)``
    yields the initial ``name`` again as (block, first row, end row), for
    the change over the steps."""

    def __init__(self, params: Dict[str, torch.Tensor], genres: torch.Tensor, cfg: dict,
                 gen: torch.Generator, redraw: Callable, prec: str = "f32",
                 shard: int = 0, group=None):
        self.shard, self.group = shard, group
        self.p = params
        self.genres = genres
        self.cfg = cfg
        self.gen = gen
        self.redraw = redraw
        self.prec = prec
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0
        self.tables = ("user_embed", "item_embed")

    def loss_and_grads(self, users: torch.Tensor, items: torch.Tensor):
        cfg, p = self.cfg, self.p
        rate = float(cfg["dropout"])
        uniq_u, inv_u = torch.unique(users, return_inverse=True)
        uniq_i, inv_i = torch.unique(items, return_inverse=True)
        ur = self._rows("user_embed", uniq_u).requires_grad_(True)
        ir = self._rows("item_embed", uniq_i).requires_grad_(True)
        dense = {k: v.detach().clone().requires_grad_(True) for k, v in p.items()
                 if k not in self.tables}
        ue = _tower(ur[inv_u], dense["user_w1"], dense["user_b1"], dense["user_w2"],
                    dense["user_b2"], rate, self.gen, self.prec)
        x = torch.cat([ir[inv_i], self.genres[items]], dim=-1)
        ie = _tower(x, dense["item_w1"], dense["item_b1"], dense["item_w2"],
                    dense["item_b2"], rate, self.gen, self.prec)
        loss = bpr_loss(ue, ie, self.prec)
        leaves = [ur, ir] + list(dense.values())
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        g = {k: (torch.zeros_like(v) if gr is None else gr)
             for k, v, gr in zip(dense, dense.values(), grads[2:])}
        g["user_embed"] = (uniq_u, grads[0])
        g["item_embed"] = (uniq_i, grads[1])
        return float(loss.detach()), g

    def _local(self, name: str, ids: torch.Tensor) -> torch.Tensor:
        """Global row ids as rows of this rank's shard (out of range where
        another shard holds them)."""
        return ids - self.shard * self.p[name].shape[0]

    def _rows(self, name: str, ids: torch.Tensor) -> torch.Tensor:
        """The rows of ``ids``: this shard's, summed over the group."""
        t = self.p[name]
        local = self._local(name, ids)
        ok = (local >= 0) & (local < t.shape[0])
        rows = t[local.clamp(0, t.shape[0] - 1)] * ok[:, None]
        if self.group is not None:
            import torch.distributed as dist

            dist.all_reduce(rows, group=self.group)
        return rows

    def step(self, users: torch.Tensor, items: torch.Tensor):
        """One step; → (loss, the clipped gradient's norm per leaf)."""
        cfg = self.cfg
        loss, g = self.loss_and_grads(users, items)

        def sq(k):
            v = g[k][1] if k in self.tables else g[k]
            return float(torch.linalg.vector_norm(v)) ** 2

        norms = {k: math.sqrt(sq(k)) for k in g}
        total = math.sqrt(sum(n * n for n in norms.values()))
        clip = float(cfg["clip_norm"])
        scale = 1.0 if total < clip else clip / total
        lr, wd = float(cfg["lr"]), float(cfg["weight_decay"])
        self.t += 1
        bc1, bc2 = bias_corrections(self.t)
        with torch.no_grad():
            for k, p in self.p.items():
                if k in self.tables:
                    ids, gr = g[k]
                    rows = self._local(k, ids)
                    for a in range(0, p.shape[0], ROW_BLOCK):
                        b = min(p.shape[0], a + ROW_BLOCK)
                        blk = torch.zeros((b - a, p.shape[1]), device=p.device)
                        sel = (rows >= a) & (rows < b)
                        blk[rows[sel] - a] = gr[sel] * scale
                        self._adamw(p[a:b], blk, self.mu[k][a:b], self.nu[k][a:b],
                                    lr, wd, bc1, bc2)
                else:
                    self._adamw(p, g[k] * scale, self.mu[k], self.nu[k], lr, wd, bc1, bc2)
        return loss, {k: v * scale for k, v in norms.items()}

    @staticmethod
    def _adamw(p, g, mu, nu, lr, wd, bc1, bc2):
        mu.mul_(B1).add_(g * (1.0 - B1))
        nu.mul_(B2).add_(g * g * (1.0 - B2))
        u = (mu / bc1) / (torch.sqrt(nu / bc2) + EPS)
        p.sub_(lr * (u + wd * p))

    def delta_norms(self) -> Dict[str, float]:
        return delta_norms(self.p, self.redraw, self.group, self.tables)


@torch.no_grad()
def delta_norms(params: Dict[str, torch.Tensor], redraw: Callable, group=None,
                sharded=()) -> Dict[str, float]:
    """‖p − p0‖ per leaf, p0 drawn again block by block by ``redraw``; the
    leaves named in ``sharded`` summed over ``group``."""
    return {k: math.sqrt(v) for k, v in group_sum(
        {k: sum(float(torch.linalg.vector_norm(p[a:b] - blk)) ** 2 for blk, a, b in redraw(k))
         for k, p in params.items()}, group, sharded).items()}


def group_sum(values: Dict[str, float], group, keys) -> Dict[str, float]:
    """``values`` with those under ``keys`` summed over ``group`` (every
    rank of it calls this with the same keys)."""
    if group is None or not keys:
        return values
    import torch.distributed as dist

    names = [k for k in values if k in keys]
    dev = "cuda" if dist.get_backend(group) == "nccl" else "cpu"
    t = torch.tensor([values[k] for k in names], dtype=torch.float64, device=dev)
    dist.all_reduce(t, group=group)
    return {**values, **dict(zip(names, t.tolist()))}


def run(ref: Reference, batches: List[dict], steps: int = 3) -> dict:
    """The reference's readings over the first ``steps`` batches."""
    losses, grad_norms = [], None
    for k in range(steps):
        loss, norms = ref.step(batches[k]["user"], batches[k]["item"])
        losses.append(loss)
        if grad_norms is None:
            grad_norms = norms
    return {"losses": losses, "grad_norms": grad_norms, "delta_norms": ref.delta_norms()}
