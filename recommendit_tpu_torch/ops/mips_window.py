"""Window-segment MIPS top-k — the CUDA kernel, its plain twin and the router.

Counterpart of ``recommendit_tpu/ops/pallas_mips.py`` for the path the fused
index serves through:

* :func:`window_candidates` — per window of ``window`` consecutive corpus
  rows, the max score and its first-occurrence position, items-major
  (n_cand, Q). On a CUDA tensor it launches ``csrc/window_mips.cu`` (the
  port of the Pallas ``_window_kernel_im``); on a CPU tensor it runs the
  plain twin :func:`window_candidates_ref`.
* :func:`mips_topk_window_im` — the candidates plus the exact top-k over
  the window maxima (outside the kernel, as in JAX).
  :func:`mips_topk_window_im_ref` is its plain twin on any device.
* :func:`mips_topk_fused_auto` — the production router: same batch and
  window rules as the JAX function.

Recall model of the window scheme (approx_max_k's bin argument):
1 − (k−1)·W/(2N); ``window=1`` is exact.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from recommendit_tpu_torch.ops.topk import (
    fast_topk,
    round_queries,
    score_matrix,
)

# Router constants, kept at the JAX package's values (measured on a TPU
# v5e, pallas_mips.py:208,665); both are to be re-measured on the H100.
_KERNEL_MIN_Q = 384      # batches below this take the dense scan ...
_SCAN_MIN_N = 65536      # ... on corpora larger than this
_TARGET_CAND = 16384     # window maxima the tail top-k should see

_MASKED = -3e38
_REF_QUERY_CHUNK = 256   # bounds the twin's live (Q, N) score slab

# Kernel launches since the last reset, by kernel name. Only the CUDA
# wrapper adds to it, once per launch.
LAUNCHES = {"window_mips": 0}


def _check_window_args(n: int, k: int, block_items: int, window: int,
                       n_valid: Optional[int]) -> int:
    """The guards of ``mips_topk_window_im`` (pallas_mips.py:407-432), with
    the same messages. Returns ``n_valid``."""
    if n_valid is None:
        n_valid = n
    elif not (0 < n_valid <= n):
        raise ValueError(f"n_valid={n_valid} out of range for N={n}")
    if k > n_valid:
        raise ValueError(f"k={k} exceeds corpus size {n_valid}")
    if block_items % window:
        raise ValueError("block_items must be a multiple of window")
    n_valid_cand = -(-n_valid // window)
    if k > n_valid_cand:
        raise ValueError(
            f"k={k} exceeds valid candidate count {n_valid_cand} "
            f"(n_valid={n_valid}, window={window}); lower `window` "
            f"(n_valid/window must be >= k)"
        )
    return n_valid


def window_candidates_ref(queries: torch.Tensor, items: torch.Tensor,
                          window: int, n_valid: Optional[int] = None,
                          precision: str = "default"):
    """Plain twin of the kernel: (n_cand, Q) f32 window maxima and int32
    first-occurrence positions, n_cand = ceil(N / window).

    Scores are f32 sums of the ``ops.topk.mm_operands`` products (never rounded
    to bf16); rows >= ``n_valid`` score -3e38. Works in query chunks so the
    (Q, N) score slab stays bounded."""
    n = items.shape[0]
    n_valid = n if n_valid is None else n_valid
    n_cand = -(-n // window)
    pad = n_cand * window - n
    lane = torch.arange(window, dtype=torch.int32, device=items.device)
    vals, args = [], []
    for s in range(0, queries.shape[0], _REF_QUERY_CHUNK):
        scores = score_matrix(queries[s:s + _REF_QUERY_CHUNK], items, precision)
        scores[:, n_valid:] = _MASKED
        if pad:
            scores = torch.nn.functional.pad(scores, (0, pad), value=_MASKED)
        s3 = scores.view(scores.shape[0], n_cand, window)
        smax = s3.amax(dim=-1)
        # first-occurrence argmax: the smallest lane attaining the max
        arg = torch.where(s3 >= smax[..., None], lane, window).amin(dim=-1)
        vals.append(smax)
        args.append(arg.to(torch.int32))
    return torch.cat(vals).T.contiguous(), torch.cat(args).T.contiguous()


def _window_candidates_cuda(queries: torch.Tensor, items: torch.Tensor,
                            window: int, n_valid: int, precision: str):
    """Launch ``csrc/window_mips.cu`` on the current stream."""
    from recommendit_tpu_torch.ops._build import load_library

    if items.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"corpus dtype must be float32 or bfloat16, got {items.dtype}")
    if queries.device != items.device:
        raise ValueError("queries and corpus must be on the same device")
    if queries.dim() != 2 or items.dim() != 2 or queries.shape[1] != items.shape[1]:
        raise ValueError(
            f"shape mismatch: queries {tuple(queries.shape)}, corpus {tuple(items.shape)}")
    if not items.is_contiguous():
        raise ValueError("corpus must be contiguous")
    n, d = items.shape
    if d % 8:
        raise ValueError(f"feature dim {d} must be a multiple of 8 (pad the corpus)")
    if window & (window - 1):
        raise ValueError(f"window={window} must be a power of two")
    if queries.shape[0] == 0 or queries.shape[0] >= 2 ** 31 or n * d >= 2 ** 62:
        raise ValueError("unsupported query or corpus size")

    lib = load_library("window_mips")
    fn = lib.window_mips_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    q = round_queries(queries, items.dtype, precision).contiguous()
    n_q = q.shape[0]
    n_cand = -(-n // window)
    vals = torch.empty((n_cand, n_q), dtype=torch.float32, device=items.device)
    args = torch.empty((n_cand, n_q), dtype=torch.int32, device=items.device)
    with torch.cuda.device(items.device):
        stream = torch.cuda.current_stream(items.device).cuda_stream
        rc = fn(q.data_ptr(), items.data_ptr(),
                int(items.dtype == torch.bfloat16), vals.data_ptr(),
                args.data_ptr(), n_q, n, d, n_valid, window, stream)
    if rc != 0:
        raise RuntimeError(f"window_mips launch failed: CUDA error {rc}")
    LAUNCHES["window_mips"] += 1
    return vals, args


def window_candidates(queries: torch.Tensor, items: torch.Tensor, window: int,
                      n_valid: Optional[int] = None, precision: str = "default"):
    """Window maxima and positions, (n_cand, Q) each: the CUDA kernel for
    a corpus on the card, the plain twin for one on the CPU."""
    n_valid = items.shape[0] if n_valid is None else n_valid
    if items.device.type == "cpu":
        return window_candidates_ref(queries, items, window, n_valid, precision)
    if items.device.type != "cuda":
        raise ValueError(f"no window kernel for device {items.device}")
    return _window_candidates_cuda(queries, items, window, n_valid, precision)


def _select(cand_vals: torch.Tensor, cand_args: torch.Tensor, k: int,
            window: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over (n_cand, Q) window maxima → (Q, k) values and
    global positions (window id · W + position in the window)."""
    vals, sel = fast_topk(cand_vals.T, k)
    idx = sel * window + torch.gather(cand_args.T, 1, sel).long()
    return vals, idx


def mips_topk_window_im(
    queries: torch.Tensor,
    item_embs: torch.Tensor,
    k: int,
    block_items: int = 2048,
    window: int = 64,
    precision: str = "default",
    n_valid: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Window-segment fused MIPS top-k → (values (Q, k) f32, positions
    (Q, k) int64), sorted descending. The kernel on the card, its twin on
    the CPU. ``block_items`` only keeps the JAX guard: the kernel's windows
    do not depend on how the corpus is blocked."""
    n_valid = _check_window_args(item_embs.shape[0], k, block_items, window,
                                 n_valid)
    cv, ca = window_candidates(queries, item_embs, window, n_valid, precision)
    return _select(cv, ca, k, window)


def mips_topk_window_im_ref(
    queries: torch.Tensor,
    item_embs: torch.Tensor,
    k: int,
    block_items: int = 2048,
    window: int = 64,
    precision: str = "default",
    n_valid: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of :func:`mips_topk_window_im` on any device."""
    n_valid = _check_window_args(item_embs.shape[0], k, block_items, window,
                                 n_valid)
    cv, ca = window_candidates_ref(queries, item_embs, window, n_valid,
                                   precision)
    return _select(cv, ca, k, window)


def fused_window(n: int, k: int) -> int:
    """The JAX window rule (pallas_mips.py:665-677): about n/16384 rounded
    up to a power of two, clamped to [8, 512], halved while
    n // W < max(k, 4W). A result below 8 means the exact scan."""
    ratio = -(-n // _TARGET_CAND)
    window = 1 << max(0, ratio - 1).bit_length()
    window = max(8, min(512, window))
    while window > 1 and n // window < max(k, 4 * window):
        window //= 2
    return window


def fused_route(q_batch: int, n: int, k: int) -> Tuple[str, int]:
    """("scan" | "exact" | "kernel", window) for a batch of ``q_batch``
    queries over ``n`` real corpus rows — the routing of
    ``mips_topk_fused_auto`` (pallas_mips.py:642-693)."""
    if q_batch < _KERNEL_MIN_Q and n > _SCAN_MIN_N:
        return "scan", 0
    window = fused_window(n, k)
    if window < 8:
        return "exact", window
    return "kernel", window


def mips_topk_fused_auto(
    queries: torch.Tensor,
    item_embs: torch.Tensor,
    k: int,
    block_items: int = 4096,
    precision: str = "default",
    n_valid: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Production entry for the fused index: small batches over large
    corpora and small corpora take a dense scan (matmul + exact top-k over
    the valid rows), everything else the window kernel. ``precision``
    applies on every route (the JAX scan route drops it)."""
    n = item_embs.shape[0] if n_valid is None else n_valid
    route, window = fused_route(queries.shape[0], n, k)
    if route != "kernel":
        if k > n:
            raise ValueError(f"k={k} exceeds corpus size {n}")
        return fast_topk(score_matrix(queries, item_embs[:n], precision), k)
    bn = max(window, block_items - block_items % window)
    return mips_topk_window_im(queries, item_embs, k, bn, window, precision,
                               n_valid)
