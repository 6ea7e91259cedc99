"""The DLRM-DCNv2 training system under test: the port's published recipe
(``training/train_ctr.dcn_step`` on a ``DCNState``, ``models/ctr.py``'s
``CTRArch``) on one card, over the rows that card holds of a row-wise
sharded deployment (the configuration's ``vocab_sizes``; its
``deployment`` says which).

Set-up draws the params and the mix's pool of batches on the card from the
seed (``perfbench/ctr_inputs.py``), builds the program's state over them
and drives its first three steps on batches 0-2 (the window's own call),
reading the program's loss each step, the dense params' gradients of step
1, and after step 3 the table and its accumulator at every row the three
steps touched (copied to the host). The window goes on from batch 3 of
the pool. After it the program's state is freed and the plain reference
(``perfbench/reference/dlrm_dcnv2_train.py``) follows the same three steps
from the same params, drawn again.

The compared numbers (:func:`numbers`), each with its limit in the
configuration's ``checks``:

* ``loss_err`` — the largest of the three steps' |loss − reference| over
  the reference's loss;
* ``grad_gap`` — over the dense params, the largest ‖g − g_ref‖ over the
  larger of ‖g_ref‖ and the median param's ‖g_ref‖ (step 1);
* ``table_delta_gap`` — over the touched rows, ‖w − w_ref‖ over the
  reference's change ‖w_ref − w0‖ after step 3;
* ``accum_gap`` — over the touched rows, ‖acc − acc_ref‖ / ‖acc_ref‖
  after step 3.
"""
from __future__ import annotations

import gc
import math
from typing import Dict

import torch

from perfbench import ctr_inputs
from perfbench.reference import dlrm_dcnv2_train as ref

WARM_STEPS = 3
INF = float("inf")


def _median(xs):
    s = sorted(xs)
    n = len(s)
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


def _rel_gap(a_host: torch.Tensor, b_host: torch.Tensor, base_host: torch.Tensor,
             device) -> float:
    """‖a − b‖ / ‖b − base‖ (base None: / ‖b‖), over host tensors taken to
    ``device`` in blocks of rows."""
    num = den = 0.0
    for s in range(0, a_host.shape[0], ref.ROW_BLOCK):
        a = a_host[s:s + ref.ROW_BLOCK].to(device)
        b = b_host[s:s + ref.ROW_BLOCK].to(device)
        base = 0.0 if base_host is None else base_host[s:s + ref.ROW_BLOCK].to(device)
        num += float(torch.linalg.vector_norm(a - b)) ** 2
        den += float(torch.linalg.vector_norm(b - base)) ** 2
    return math.sqrt(num) / math.sqrt(den) if den > 0 else (0.0 if num == 0 else INF)


def numbers(prog: dict, want: dict, w0: torch.Tensor, device) -> Dict[str, float]:
    """``prog`` and ``want``: {"losses": [3], "dense_grads": {name: tensor},
    "w", "acc": the touched rows on the host}; ``w0`` those rows at the
    start."""
    losses = list(zip(prog["losses"], want["losses"]))
    loss_err = max(abs(a - b) / abs(b) if b else abs(a - b) for a, b in losses)
    if len(prog["losses"]) != len(want["losses"]) or any(
            not math.isfinite(x) for x in prog["losses"]):
        loss_err = INF
    norms = {k: float(torch.linalg.vector_norm(g)) for k, g in want["dense_grads"].items()}
    med = _median(list(norms.values()))
    grad_gap = max(float(torch.linalg.vector_norm(prog["dense_grads"][k].to(device)
                                                  - want["dense_grads"][k].to(device)))
                   / max(norms[k], med) for k in norms)
    return {"loss_err": loss_err, "grad_gap": grad_gap,
            "table_delta_gap": _rel_gap(prog["w"], want["w"], w0, device),
            "accum_gap": _rel_gap(prog["acc"], want["acc"], None, device)}


def reference(cfg: dict, seed: int, device, prec: str = "f32",
              cls=ref.Reference) -> ref.Reference:
    """The plain reference over the params drawn again."""
    return cls(ctr_inputs.params(cfg, seed, device), cfg["bag_sizes"], float(cfg["lr"]),
               float(cfg["eps"]), prec)


def arch_of(cfg: dict):
    """The program's arch for the configuration's widths and held rows."""
    from recommendit_tpu_torch.models.ctr import CTRArch

    return CTRArch(vocab_sizes=tuple(int(v) for v in cfg["vocab_sizes"]),
                   embed_dim=int(cfg["embed_dim"]),
                   bag_sizes=tuple(int(k) for k in cfg["bag_sizes"]),
                   cross_layers=int(cfg["cross_layers"]), cross_rank=int(cfg["cross_rank"]),
                   bottom=tuple(int(w) for w in cfg["bottom"]),
                   top=tuple(int(w) for w in cfg["top"]), n_dense=int(cfg["dense_in"]))


class Session:
    def __init__(self, cell, seed: int, device):
        # the program first: a checkout without it stops here, before any draw
        from recommendit_tpu_torch.training.train_ctr import (
            AdagradRecipe,
            DCNState,
            dcn_step,
        )

        self.cfg = cfg = cell.config
        self.mix = cell.traffic
        self.seed = seed
        self.limits = cfg["checks"]
        self.marker = cfg["trace_marker"]
        self.batch = int(self.mix["batch"])
        self.rows = self.batch
        self.sizes: Dict[str, int] = {}
        dev = torch.device(device)
        self.device = torch.device("cuda", torch.cuda.current_device()) \
            if dev.type == "cuda" else torch.device("cpu")
        self.arch = arch_of(cfg)
        self._step = dcn_step
        self.state = DCNState(ctr_inputs.params(cfg, seed, self.device), self.arch,
                              AdagradRecipe(lr=float(cfg["lr"]), eps=float(cfg["eps"])))
        self.pool = ctr_inputs.batches(cfg, self.mix, seed, self.device)
        self.unique_rows = [int(torch.unique(ids).numel()) for _, ids, _ in self.pool]
        self._index = {}
        self._ranges = False
        self.prog = None

    # --- the timed path ---------------------------------------------------- #

    def call(self, batch):
        return self._step(self.state, *self.pool[self._index[id(batch)]])

    finish = None

    def drain(self) -> None:
        self.sync()

    def on_result(self, i: int, out, host) -> None:
        pass

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warm(self, batches) -> int:
        """The first three steps on batches 0-2, with the program's
        readings; the window starts at the next batch."""
        if len(batches) != len(self.pool):
            raise ValueError(f"{len(batches)} batches for a pool of {len(self.pool)}")
        self._index = {id(b): k for k, b in enumerate(batches)}
        losses, keep = [], {}
        for k in range(WARM_STEPS):
            losses.append(float(self._step(self.state, *self.pool[k],
                                           keep=keep if k == 0 else None)))
            if k == 0:
                grads = {n: g.detach().clone() for n, g in zip(
                    [n for n in self.state.params if n != "embed"], keep["dense_grads"])}
        self.touched = ctr_inputs.touched_rows(self.pool, WARM_STEPS)
        self.prog = {"losses": losses, "dense_grads": grads,
                     "w": ref.rows_at(self.state.table, self.touched),
                     "acc": ref.rows_at(self.state.table_acc, self.touched)}
        return WARM_STEPS

    def layer_ranges(self, on: bool) -> None:
        self._ranges = on

    def busy(self, summary=None) -> tuple:
        return (summary.busy_s, summary.window_s) if summary is not None else (0.0, 0.0)

    def memory_peak_bytes(self) -> int:
        if self.device.type != "cuda":
            return 0
        return int(torch.cuda.max_memory_allocated(self.device))

    def facts(self) -> dict:
        return {"batch": self.batch,
                "unique_rows": sum(self.unique_rows) / len(self.unique_rows),
                "rows_updated": int(self.state.rows_updated),
                "numel": sum(p.numel() for p in self.state.params.values())}

    def release(self) -> None:
        self.state = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # --- the check --------------------------------------------------------- #

    def numbers(self, batches) -> dict:
        r = reference(self.cfg, self.seed, self.device)
        w0 = ref.rows_at(r.p["embed"], self.touched)
        want = ref.run(r, self.pool, self.touched, WARM_STEPS)
        del r
        return numbers(self.prog, want, w0, self.device)
