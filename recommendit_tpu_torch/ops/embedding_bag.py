"""Pooled multi-hot lookups and the table's exact Adagrad update — the
wrapper of ``csrc/embedding_bag.cu``.

The JAX package has no counterpart: its CTR model looks up one id a field
and updates the stacked table row-wise (``ops/sparse_embed.py``). The
port's DLRM-DCNv2 (``models/ctr.py``'s ``CTRArch``) reads a bag of
ids a field, from one table that stacks every field's rows at static
offsets, and sums each bag; the table trains with FBGEMM's exact Adagrad,
one accumulator an element, on the rows the step touches:

    g_r = Σ over every slot (b, s) whose id is r of  dL/dpooled[b, field(s)]
    acc_r <- acc_r + g_r²;   w_r <- w_r − lr · (g_r / (√acc_r + eps))

duplicates within a bag and across bags summed first. A :class:`BagLayout`
holds the static shape of an id block: each field's rows and bag size, so
the (B, S) block of stacked row ids (S = Σ bag sizes) has field f's bag in
the slots ``[bag_start[f], bag_start[f + 1])``.

:func:`pool_bags` and :func:`bag_adagrad_` choose by device alone, as
``ops/adamw.py`` does: CUDA tensors take the kernels (``bag_fwd_kernel``
one launch a step; the update sorts the ids with ``torch.sort`` at their
fixed size, then ``bag_update_kernel`` and ``bag_update_carry_kernel``), so
the step never waits for the host; CPU tensors take the plain versions
(:func:`pool_bags_plain`, :func:`bag_adagrad_plain_`), which define the
results. A CUDA tensor the kernels cannot take raises ValueError: there is
no fallback on the card. Ids must lie in the table: nothing checks them on
the device (a check would stop the step for a host read).
"""
from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from recommendit_tpu_torch.ops._build import count_launch

__all__ = ["BagLayout", "pool_bags", "bag_adagrad_", "pool_bags_plain",
           "bag_adagrad_plain_", "LAUNCHES"]

# Kernel launches since the last reset; only the CUDA wrappers add to them
# (one ``bag_update`` is its two kernels).
LAUNCHES = {"bag_fwd": 0, "bag_update": 0}
MAX_DIM = 512          # the kernels hold a row in at most four float4s a lane


@dataclass(frozen=True)
class BagLayout:
    """The static shape of a multi-hot id block: ``vocab_sizes[f]`` rows
    and a bag of ``bag_sizes[f]`` ids for each field f."""
    vocab_sizes: Tuple[int, ...]
    bag_sizes: Tuple[int, ...]

    def __post_init__(self):
        if len(self.vocab_sizes) != len(self.bag_sizes) or not self.bag_sizes:
            raise ValueError(f"{len(self.vocab_sizes)} fields' rows against "
                             f"{len(self.bag_sizes)} bag sizes")
        if min(self.bag_sizes) < 1 or min(self.vocab_sizes) < 1:
            raise ValueError("every field needs a row and a bag of at least one id")

    @property
    def n_fields(self) -> int:
        return len(self.bag_sizes)

    @property
    def slots(self) -> int:
        """Ids an example."""
        return int(sum(self.bag_sizes))

    @property
    def rows(self) -> int:
        return int(sum(self.vocab_sizes))

    @property
    def offsets(self) -> np.ndarray:
        """Each field's first row in the stacked table."""
        return np.concatenate([[0], np.cumsum(self.vocab_sizes)[:-1]]).astype(np.int64)

    @property
    def bag_start(self) -> np.ndarray:
        """(F + 1,) slot boundaries: field f's bag is ``[start[f], start[f + 1])``."""
        return np.concatenate([[0], np.cumsum(self.bag_sizes)]).astype(np.int64)

    @property
    def slot_field(self) -> np.ndarray:
        """(S,) each slot's field."""
        return np.repeat(np.arange(self.n_fields), self.bag_sizes).astype(np.int64)

    def stack(self, ids) -> np.ndarray:
        """Field-local (N, S) ids → rows of the stacked table (int64).
        Raises ValueError for an id outside its field's rows."""
        ids = np.asarray(ids, np.int64)
        vocab = np.asarray(self.vocab_sizes, np.int64)[self.slot_field]
        bad = (ids < 0) | (ids >= vocab[None, :])
        if bad.any():
            row, slot = np.argwhere(bad)[0]
            raise ValueError(f"id {int(ids[row, slot])} at row {row}, slot {slot} is "
                             f"outside its field's {int(vocab[slot])} rows")
        return ids + self.offsets[self.slot_field][None, :]

    def device_tensors(self, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """(bag_start, slot_field) as int32 tensors on ``device``, made once."""
        return _device_tensors(self, torch.device(device))


@functools.lru_cache(maxsize=16)
def _device_tensors(layout: BagLayout, device: torch.device):
    return (torch.as_tensor(layout.bag_start.astype(np.int32), device=device),
            torch.as_tensor(layout.slot_field.astype(np.int32), device=device))


# --- the plain versions: the definitions, on the CPU ---------------------- #

def pool_bags_plain(table: torch.Tensor, ids: torch.Tensor,
                    layout: BagLayout) -> torch.Tensor:
    """(B, F, D): each field's bag summed, row by row in slot order from
    zeros (the kernel's order)."""
    b, s = ids.shape
    rows = table.index_select(0, ids.reshape(-1).long()).reshape(b, s, -1)
    out = torch.zeros((b, layout.n_fields, table.shape[1]), dtype=table.dtype,
                      device=table.device)
    for f, (a, e) in enumerate(zip(layout.bag_start[:-1], layout.bag_start[1:])):
        for j in range(int(a), int(e)):
            out[:, f] += rows[:, j]
    return out


@torch.no_grad()
def bag_adagrad_plain_(table: torch.Tensor, acc: torch.Tensor, ids: torch.Tensor,
                       grad: torch.Tensor, layout: BagLayout, lr: float, eps: float,
                       counter: Optional[torch.Tensor] = None) -> None:
    """Exact Adagrad of the rows ``ids`` touch, in place: each distinct
    row's gradient summed over its slots in sorted order, then
    ``acc += g²; w -= lr · (g / (√acc + eps))``; ``counter`` (if given)
    adds the rows updated."""
    b, s = ids.shape
    d = table.shape[1]
    keys, perm = torch.sort(ids.reshape(-1).long(), stable=True)
    fields = torch.as_tensor(layout.slot_field, device=ids.device)
    grow = (perm // s) * layout.n_fields + fields[perm % s]
    uniq, inv = torch.unique_consecutive(keys, return_inverse=True)
    g = torch.zeros((uniq.numel(), d), dtype=table.dtype, device=table.device)
    g.index_add_(0, inv, grad.reshape(-1, d).index_select(0, grow))
    a = acc[uniq] + g * g
    acc[uniq] = a
    table[uniq] = table[uniq] - lr * (g / (torch.sqrt(a) + eps))
    if counter is not None:
        counter += uniq.numel()


# --- the kernels ----------------------------------------------------------- #

def _lib():
    from recommendit_tpu_torch.ops._build import load_library

    lib = load_library("embedding_bag")
    vp, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.bag_update_chunk.restype = i
    lib.bag_update_chunk.argtypes = []
    lib.bag_fwd_launch.restype = i
    lib.bag_fwd_launch.argtypes = [vp, vp, vp, i, i, ll, i, vp, vp]
    lib.bag_update_launch.restype = i
    lib.bag_update_launch.argtypes = ([vp, vp, vp, ll, vp, i, ll, i] + [vp] * 7
                                      + [f, f, vp])
    return lib


def _rows_contiguous(t) -> bool:
    """Each index of the first dim a contiguous block, the blocks 16-byte
    aligned apart (a slice of a wider row, as autograd hands the pooled
    gradient back)."""
    st = t.stride()
    return (all(st[i] == math.prod(t.shape[i + 1:]) for i in range(1, len(st)))
            and st[0] % 4 == 0)


def _check(named: Sequence[Tuple[str, torch.Tensor, torch.dtype, tuple]]) -> bool:
    """Whether tensors of these roles take the kernels: True where they are
    on a CUDA device, False where none is. Where any is on the card, each
    must be on that card, of its dtype, contiguous (the gradient ``grad``:
    contiguous but for its first dim's stride), 16-byte aligned and of its
    shape (a None in the shape: any size), else ValueError naming it."""
    cuda = [t.device for _, t, _, _ in named if t.device.type == "cuda"]
    if not cuda:
        return False
    for name, t, dtype, shape in named:
        packed = _rows_contiguous(t) if name == "grad" else t.is_contiguous()
        why = ("on " + str(t.device) if t.device != cuda[0] else
               str(t.dtype) if t.dtype != dtype else
               "not contiguous" if not packed else
               "not 16-byte aligned" if t.data_ptr() % 16 else
               f"of shape {tuple(t.shape)}, not {shape}"
               if len(t.shape) != len(shape) or any(
                   w is not None and w != n for w, n in zip(shape, t.shape)) else None)
        if why:
            raise ValueError(f"the embedding-bag kernels take contiguous tensors on "
                             f"{cuda[0]}: {name} is {why}")
    return True


def _dim(table: torch.Tensor) -> int:
    d = table.shape[1] if table.dim() == 2 else 0
    if d < 4 or d % 4 or d > MAX_DIM:
        raise ValueError(f"the embedding-bag kernels take rows of 4 to {MAX_DIM} "
                         f"floats, a multiple of 4: the table's are {d}")
    return d


def pool_bags(table: torch.Tensor, ids: torch.Tensor, layout: BagLayout) -> torch.Tensor:
    """(B, F, D) bag sums of the (B, S) stacked row ids ``ids`` over the
    (rows, D) f32 ``table``: ``bag_fwd_kernel`` on the card (int32 ids),
    :func:`pool_bags_plain` on the CPU."""
    if ids.dim() != 2 or ids.shape[1] != layout.slots:
        raise ValueError(f"ids of shape {tuple(ids.shape)} for {layout.slots} slots")
    if not _check([("table", table, torch.float32, (None, None)),
                   ("ids", ids, torch.int32, tuple(ids.shape))]):
        return pool_bags_plain(table, ids, layout)
    d = _dim(table)
    b = ids.shape[0]
    out = torch.empty((b, layout.n_fields, d), dtype=torch.float32, device=table.device)
    bag_start, _ = layout.device_tensors(table.device)
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        rc = _lib().bag_fwd_launch(table.data_ptr(), ids.data_ptr(), bag_start.data_ptr(),
                                   layout.n_fields, layout.slots, b, d, out.data_ptr(),
                                   stream)
    if rc != 0:
        raise RuntimeError(f"bag_fwd launch failed: CUDA error {rc}")
    count_launch(LAUNCHES, "bag_fwd")
    return out


@torch.no_grad()
def bag_adagrad_(table: torch.Tensor, acc: torch.Tensor, ids: torch.Tensor,
                 grad: torch.Tensor, layout: BagLayout, lr: float, eps: float,
                 counter: Optional[torch.Tensor] = None) -> None:
    """Exact Adagrad of the rows the (B, S) ids touch, from the (B, F, D)
    pooled gradient ``grad``, in place on ``table`` and ``acc`` (both
    (rows, D) f32). On the card: the ids sorted by ``torch.sort`` (stable,
    at their fixed size), then the update kernels, which read ``grad``
    where it lies (each example's (F, D) block contiguous, at any 16-byte
    stride: a slice of the interaction's input gradient is not copied);
    ``counter`` (one int64
    on the card) adds the rows updated there, and is read only where the
    caller reads it. On the CPU: :func:`bag_adagrad_plain_`."""
    b = ids.shape[0]
    if ids.dim() != 2 or ids.shape[1] != layout.slots:
        raise ValueError(f"ids of shape {tuple(ids.shape)} for {layout.slots} slots")
    roles = [("table", table, torch.float32, (None, None)),
             ("acc", acc, torch.float32, tuple(table.shape)),
             ("ids", ids, torch.int32, tuple(ids.shape)),
             ("grad", grad, torch.float32, (b, layout.n_fields, table.shape[1]))]
    if counter is not None:
        roles.append(("counter", counter, torch.int64, tuple(counter.shape)))
    if not _check(roles):
        if tuple(acc.shape) != tuple(table.shape) or tuple(grad.shape) != (
                b, layout.n_fields, table.shape[1]):
            raise ValueError(f"acc {tuple(acc.shape)} and grad {tuple(grad.shape)} for a "
                             f"table {tuple(table.shape)} and {b} examples")
        bag_adagrad_plain_(table, acc, ids, grad, layout, lr, eps, counter)
        return
    if counter is not None and counter.numel() != 1:
        raise ValueError("the counter is one int64")
    d = _dim(table)
    n = ids.numel()
    if n == 0:
        return
    lib = _lib()
    keys, perm = torch.sort(ids.reshape(-1), stable=True)
    n_chunks = -(-n // lib.bag_update_chunk())
    dev = table.device
    parts = torch.empty((2, n_chunks, d), dtype=torch.float32, device=dev)
    flags = torch.empty((2, n_chunks), dtype=torch.int32, device=dev)
    _, slot_field = layout.device_tensors(dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.bag_update_launch(
            keys.data_ptr(), perm.data_ptr(), grad.data_ptr(), grad.stride(0),
            slot_field.data_ptr(), layout.slots, n, d, table.data_ptr(), acc.data_ptr(),
            parts[0].data_ptr(), parts[1].data_ptr(), flags[0].data_ptr(),
            flags[1].data_ptr(), None if counter is None else counter.data_ptr(),
            float(lr), float(eps), stream)
    if rc != 0:
        raise RuntimeError(f"bag_update launch failed: CUDA error {rc}")
    count_launch(LAUNCHES, "bag_update")
