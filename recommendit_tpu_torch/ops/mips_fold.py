"""Fold MIPS top-k — torch port of ``pallas_mips.mips_topk_fused`` and its
Pallas ``_fold_kernel`` (exported as ``recommendit_tpu.ops.mips_topk_fused``).

Per block of ``bn = min(block_items, next_pow2(N))`` corpus rows the scores
are folded by halving to ``bn / R`` bins: bin p holds rows p + j·(bn/R),
j < R, and keeps the largest score and its row; the exact top-k runs over
the ``n_blocks · bn/R`` candidates. Three rules of the JAX kernel that the
port keeps (ROADMAP C):

* **ties**: the fold halves with ``left >= right``, a tournament, so among
  tied maxima it keeps the j with the smallest bit-reversed j — not the
  first occurrence;
* **unrounded queries**: the f32 queries multiply the corpus widened to f32
  (the window kernels round them to the corpus dtype first);
* **the bias column**: when N % bn != 0 JAX appends a coordinate (query 1,
  real rows 0, pad rows −3e38 in the corpus dtype), so a pad row scores
  exactly ``-3e38`` in that dtype and bins holding only pad rows are
  candidates too (the ``k > n_cand`` guard counts them).

* :func:`fold_candidates` — (Q, n_cand) bin values and int32 global row ids:
  ``csrc/fold_mips.cu`` on the card (its tensor-core body for a bf16 corpus
  where :func:`fold_body` says so: the f32 queries split exactly into three
  bf16 pieces, :func:`split_queries`; its CUDA-core body otherwise),
  :func:`fold_candidates_ref` on the CPU.
* :func:`mips_topk_fused` — the candidates plus the exact top-k;
  :func:`mips_topk_fused_ref` is its plain twin on any device.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from recommendit_tpu_torch.ops._build import count_launch
from recommendit_tpu_torch.ops.mips_window import pad_columns
from recommendit_tpu_torch.ops.topk import fast_topk, full_f32_matmul

# Kernel launches since the last reset, by kernel name. Only the CUDA
# wrappers add to them, once per launch: "fold_mips" once per fold call,
# whichever body runs; "fold_split" once per query split (the tensor-core
# body's first step).
LAUNCHES = {"fold_mips": 0, "fold_split": 0}
# The body of csrc/fold_mips.cu ("tensor_cores" or "cuda_cores") that its
# last launch took; None until one. Only the CUDA wrapper sets it.
LAST_BODY = {"fold_mips": None}

# The tensor-core body: bf16 rows of at most 144 columns (their three
# resident query pieces leave room for two ring stages), blocks of at least
# one 128-row tile, and bins that are a multiple of 8 columns and fit the
# registers.
FOLD_TC_MAX_DIM = 144
_TC_MIN_BLOCK = 128
_TC_OUTS = (8, 16, 32, 64)
_ROW_ALIGN = 8     # the tensor-core body reads rows 16 bytes at a time

_PAD = np.float32(-3e38)
_REF_QUERY_CHUNK = 256   # bounds the twin's live (Q, N) score slab


def fold_shape(n: int, k: int, block_items: int = 2048,
               reduction: int = 32) -> Tuple[int, int, int]:
    """(bn, bins per block, blocks) by JAX's rules, with its two guards and
    their messages (pallas_mips.py:105-136). The halving needs a
    power-of-two block and bin count, which JAX leaves to its kernel trace;
    here it raises ``ValueError`` too."""
    if k > n:
        raise ValueError(f"k={k} exceeds corpus size {n}")
    bn = min(block_items, 1 << (n - 1).bit_length())
    out = max(1, bn // reduction)
    n_blocks = -(-n // bn)
    n_cand = n_blocks * out
    if k > n_cand:
        raise ValueError(
            f"k={k} exceeds candidate count {n_cand}; lower `reduction` "
            f"(N/R must be >= k)"
        )
    if bn & (bn - 1) or out & (out - 1):
        raise ValueError(
            f"the fold needs a power-of-two block and bin count, got "
            f"block {bn} and {out} bins")
    return bn, out, n_blocks


def pad_score(dtype: torch.dtype) -> float:
    """The score of a pad row: -3e38 stored in the corpus dtype, widened."""
    return float(torch.tensor(_PAD).to(dtype).float())


def fold_candidates_ref(queries: torch.Tensor, items: torch.Tensor,
                        block_items: int = 2048, reduction: int = 32):
    """Plain twin of the kernel: (Q, n_cand) f32 bin maxima and int32
    global row ids, by the JAX halving itself (``left >= right``, offsets
    carried), over f32 scores of the f32 queries and the widened corpus
    (TF32 off). Works in query chunks so the score slab stays bounded."""
    n = items.shape[0]
    bn, out, n_blocks = fold_shape(n, 1, block_items, reduction)
    pad = n_blocks * bn - n
    it = items.float()
    base = (torch.arange(n_blocks, dtype=torch.int32, device=items.device)[:, None]
            * bn + torch.arange(out, dtype=torch.int32, device=items.device))
    vals, ids = [], []
    for s in range(0, queries.shape[0], _REF_QUERY_CHUNK):
        with full_f32_matmul():
            scores = queries[s:s + _REF_QUERY_CHUNK].float() @ it.T
        if pad:
            scores = torch.nn.functional.pad(scores, (0, pad),
                                             value=pad_score(items.dtype))
        scores = scores.view(scores.shape[0], n_blocks, bn)
        off = torch.zeros_like(scores, dtype=torch.int32)
        w = bn
        while w > out:
            h = w // 2
            left, right = scores[..., :h], scores[..., h:w]
            take_left = left >= right
            scores = torch.where(take_left, left, right)
            off = torch.where(take_left, off[..., :h], off[..., h:w] + h)
            w = h
        vals.append(scores.reshape(scores.shape[0], -1))
        ids.append((base + off).reshape(off.shape[0], -1))
    return torch.cat(vals), torch.cat(ids)


def fold_body(dtype: torch.dtype, d: int, bn: int, out: int) -> str:
    """The body of ``csrc/fold_mips.cu`` that folds a ``d``-column corpus of
    ``dtype`` in blocks of ``bn`` rows into ``out`` bins each:
    "tensor_cores" (TMA + wgmma over the three bf16 pieces of the queries)
    for bf16 rows of at most ``FOLD_TC_MAX_DIM`` columns (after zero-padding
    to a multiple of 8), ``bn`` >= 128 and ``out`` in {8, 16, 32, 64};
    "cuda_cores" (f32 FMAs) for an f32 corpus and every other shape."""
    if (dtype == torch.bfloat16 and d + (-d % _ROW_ALIGN) <= FOLD_TC_MAX_DIM
            and bn >= _TC_MIN_BLOCK and out in _TC_OUTS):
        return "tensor_cores"
    return "cuda_cores"


def split_bf16x3(q: torch.Tensor) -> torch.Tensor:
    """Plain twin of the split kernel: (3, *q.shape) bf16 pieces hi =
    bf16(q), mid = bf16(q − hi), lo = bf16(q − hi − mid) of f32 ``q``.
    Each difference is exact in f32 and three 8-bit significands cover
    f32's 24, so hi + mid + lo == q exactly (outside bf16's subnormal
    range)."""
    q = q.float()
    hi = q.to(torch.bfloat16)
    rest = q - hi.float()
    mid = rest.to(torch.bfloat16)
    return torch.stack([hi, mid, (rest - mid.float()).to(torch.bfloat16)])


def _split_queries_cuda(q: torch.Tensor) -> torch.Tensor:
    from recommendit_tpu_torch.ops._build import load_library

    q = q.float().contiguous()
    pieces = torch.empty((3, *q.shape), dtype=torch.bfloat16, device=q.device)
    fn = load_library("fold_mips").fold_split_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_void_p]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), pieces.data_ptr(), q.numel(), stream)
    if rc != 0:
        raise RuntimeError(f"fold_split launch failed: CUDA error {rc}")
    count_launch(LAUNCHES, "fold_split")
    return pieces


def split_queries(q: torch.Tensor) -> torch.Tensor:
    """The three bf16 pieces of f32 queries, (3, *q.shape): the split
    kernel (``csrc/fold_mips.cu``) for queries on the card, the plain twin
    :func:`split_bf16x3` for queries on the CPU."""
    if q.device.type == "cpu":
        return split_bf16x3(q)
    if q.device.type != "cuda":
        raise ValueError(f"no split kernel for device {q.device}")
    return _split_queries_cuda(q)


def _fold_candidates_cuda(queries: torch.Tensor, items: torch.Tensor,
                          block_items: int, reduction: int, body=None):
    """Launch ``csrc/fold_mips.cu`` on the current stream, through the
    entry of ``body``: by default the one :func:`fold_body` picks (the other
    only to compare the two)."""
    from recommendit_tpu_torch.ops._build import load_library

    if items.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"corpus dtype must be float32 or bfloat16, got {items.dtype}")
    if queries.device != items.device:
        raise ValueError("queries and corpus must be on the same device")
    if not items.is_contiguous():
        raise ValueError("corpus must be contiguous")
    n, d = items.shape
    if queries.shape[0] == 0 or queries.shape[0] >= 2 ** 31 or n * d >= 2 ** 62:
        raise ValueError("unsupported query or corpus size")
    bn, out, n_blocks = fold_shape(n, 1, block_items, reduction)
    if n_blocks * bn >= 2 ** 31:
        raise ValueError(f"corpus of {n} rows exceeds the kernel's int32 ids")

    body = body or fold_body(items.dtype, d, bn, out)
    lib = load_library("fold_mips")
    q = queries.float().contiguous()
    n_q = q.shape[0]
    vals = torch.empty((n_q, n_blocks * out), dtype=torch.float32,
                       device=items.device)
    ids = torch.empty((n_q, n_blocks * out), dtype=torch.int32,
                      device=items.device)
    if body == "tensor_cores":
        if items.dtype != torch.bfloat16 or n_q >= 2 ** 31 // 3:
            raise ValueError("the tensor-core body takes a bf16 corpus and "
                             "fewer than 2**31 / 3 queries")
        # zero columns change no score
        q, items = pad_columns(q, _ROW_ALIGN), pad_columns(items, _ROW_ALIGN)
        if items.data_ptr() % 16:
            raise ValueError("corpus must start 16-byte aligned")
        pieces = split_queries(q)
        fn = lib.fold_mips_bf16_launch
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
            ctypes.c_float, ctypes.c_void_p]
        head = (pieces.data_ptr(), items.data_ptr())
    else:
        fn = lib.fold_mips_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int] + [
            ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [ctypes.c_float,
                                                       ctypes.c_void_p]
        head = (q.data_ptr(), items.data_ptr(),
                int(items.dtype == torch.bfloat16))
    fn.restype = ctypes.c_int
    with torch.cuda.device(items.device):
        stream = torch.cuda.current_stream(items.device).cuda_stream
        rc = fn(*head, vals.data_ptr(), ids.data_ptr(), n_q, n,
                items.shape[1], bn, out, pad_score(items.dtype), stream)
    if rc != 0:
        raise RuntimeError(f"fold_mips launch failed: CUDA error {rc}")
    count_launch(LAUNCHES, "fold_mips")
    LAST_BODY["fold_mips"] = body
    return vals, ids


def fold_candidates(queries: torch.Tensor, items: torch.Tensor,
                    block_items: int = 2048, reduction: int = 32):
    """Bin maxima and global row ids, (Q, n_cand) each: the CUDA kernel for
    a corpus on the card, the plain twin for one on the CPU."""
    if queries.dim() != 2 or items.dim() != 2 or queries.shape[1] != items.shape[1]:
        raise ValueError(
            f"shape mismatch: queries {tuple(queries.shape)}, corpus {tuple(items.shape)}")
    if items.device.type == "cpu":
        return fold_candidates_ref(queries, items, block_items, reduction)
    if items.device.type != "cuda":
        raise ValueError(f"no fold kernel for device {items.device}")
    return _fold_candidates_cuda(queries, items, block_items, reduction)


def _select(cand_vals: torch.Tensor, cand_ids: torch.Tensor,
            k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    vals, sel = fast_topk(cand_vals, k)
    return vals, torch.gather(cand_ids, 1, sel).long()


def mips_topk_fused(queries: torch.Tensor, item_embs: torch.Tensor, k: int,
                    block_items: int = 2048,
                    reduction: int = 32) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold MIPS top-k → (values (Q, k) f32, global row ids (Q, k) int64),
    sorted descending (``k <= n_blocks · bn/R``). The kernel on the card,
    its twin on the CPU."""
    fold_shape(item_embs.shape[0], k, block_items, reduction)
    return _select(*fold_candidates(queries, item_embs, block_items,
                                    reduction), k)


def mips_topk_fused_ref(queries: torch.Tensor, item_embs: torch.Tensor,
                        k: int, block_items: int = 2048,
                        reduction: int = 32) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of :func:`mips_topk_fused` on any device."""
    fold_shape(item_embs.shape[0], k, block_items, reduction)
    return _select(*fold_candidates_ref(queries, item_embs, block_items,
                                        reduction), k)
