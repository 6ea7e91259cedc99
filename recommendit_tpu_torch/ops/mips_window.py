"""Window-segment MIPS top-k — the CUDA kernel, its plain twin and the router.

Counterpart of ``recommendit_tpu/ops/pallas_mips.py`` for the path the fused
index serves through:

* :func:`window_candidates` — per window of ``window`` consecutive corpus
  rows, the max score and its first-occurrence position, items-major
  (n_cand, Q). On a CUDA tensor it launches ``csrc/window_mips.cu`` (the
  port of the Pallas ``_window_kernel_im``): its tensor-core body for a
  bf16 corpus at "default" precision, its CUDA-core body otherwise
  (:func:`window_body`); on a CPU tensor it runs the plain twin
  :func:`window_candidates_ref`.
* :func:`mips_topk_window_im` — the candidates plus the exact top-k over
  the window maxima (outside the kernel, as in JAX).
  :func:`mips_topk_window_im_ref` is its plain twin on any device.
* :func:`window_candidates_qm` / :func:`mips_topk_window` — the same
  maxima and positions queries-major, (Q, n_cand): the port of the Pallas
  ``_window_kernel`` and its wrapper (JAX defaults: block 16384, W=128),
  the queries-major entry of ``csrc/window_mips.cu`` on the card,
  :func:`window_candidates_qm_ref` on the CPU.
* :func:`window_candidates_i8` / :func:`mips_topk_window_im_int8` — the
  same over an int8 corpus with per-row scales: ``csrc/window_mips_i8.cu``
  (the port of ``_window_kernel_im_i8``) on the card (its tensor-core body
  for rows of up to 384 columns, its dp4a body for wider ones:
  :func:`int8_window_body`), :func:`window_candidates_i8_ref` on the CPU.
  Window maxima of (q_i8 · e_i8) · s_item, masked after the scale; the
  per-query scale multiplies the values after the selection.
* :func:`mips_topk_fused_auto` — the production router: same batch and
  window rules as the JAX function, over f32/bf16 or (with ``scales``)
  int8 corpora.

Recall model of the window scheme (approx_max_k's bin argument):
1 − (k−1)·W/(2N); ``window=1`` is exact.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from recommendit_tpu_torch.ops._build import count_launch
from recommendit_tpu_torch.ops.topk import (
    INT8_MAX_DIM,
    INT8_ROW_ALIGN,
    fast_topk,
    int8_dot,
    mips_topk,
    mips_topk_int8,
    quantize_queries,
    round_queries,
    score_matrix,
)
from recommendit_tpu_torch.utils.profiling import span

# Router constants, kept at the JAX package's values (measured on a TPU
# v5e, pallas_mips.py:208,665); both are to be re-measured on the H100.
_KERNEL_MIN_Q = 384      # batches below this take the dense scan ...
_SCAN_MIN_N = 65536      # ... on corpora larger than this
_TARGET_CAND = 16384     # window maxima the tail top-k should see

_TC_MAX_DIM = 192        # widest row the tensor-core body's query tile holds
INT8_TC_MAX_DIM = 384    # ... and the int8 one: the same 384-byte rows
_MASKED = -3e38
_REF_QUERY_CHUNK = 256   # bounds the twin's live (Q, N) score slab
_REF_SCORE_BUDGET = 1 << 27   # score elements per int8 twin chunk (512 MB)

# Kernel launches since the last reset, by kernel name. Only the CUDA
# wrappers add to it, once per launch.
LAUNCHES = {"window_mips": 0, "window_mips_qm": 0, "window_mips_i8": 0}
# The body of csrc/window_mips.cu (items-major entry) and of
# csrc/window_mips_i8.cu ("tensor_cores" or "cuda_cores") that its last
# launch took; None until one. Only the CUDA wrappers set it.
LAST_BODY = {"window_mips": None, "window_mips_i8": None}


def _check_window_args(n: int, k: int, block_items: int, window: int,
                       n_valid: Optional[int]) -> int:
    """The guards of ``mips_topk_window_im`` and ``mips_topk_window``
    (pallas_mips.py:407-432, :294-321), with the same messages. Returns
    ``n_valid``."""
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


def window_candidates_qm_ref(queries: torch.Tensor, items: torch.Tensor,
                             window: int, n_valid: Optional[int] = None,
                             precision: str = "default"):
    """Plain twin of the kernel: (Q, n_cand) f32 window maxima and int32
    first-occurrence positions, n_cand = ceil(N / window).

    Scores are f32 sums of the ``ops.topk.mm_operands`` products (never rounded
    to bf16); rows >= ``n_valid`` score -3e38. Works in query chunks so the
    (Q, N) score slab stays bounded."""
    n = items.shape[0]
    n_valid = n if n_valid is None else n_valid
    pad = -n % window
    vals, args = [], []
    for s in range(0, queries.shape[0], _REF_QUERY_CHUNK):
        scores = score_matrix(queries[s:s + _REF_QUERY_CHUNK], items, precision)
        scores[:, n_valid:] = _MASKED
        if pad:
            scores = torch.nn.functional.pad(scores, (0, pad), value=_MASKED)
        smax, arg = _window_max(scores, window)
        vals.append(smax)
        args.append(arg)
    return torch.cat(vals), torch.cat(args)


def window_candidates_ref(queries: torch.Tensor, items: torch.Tensor,
                          window: int, n_valid: Optional[int] = None,
                          precision: str = "default"):
    """:func:`window_candidates_qm_ref` items-major, (n_cand, Q)."""
    vals, args = window_candidates_qm_ref(queries, items, window, n_valid,
                                          precision)
    return vals.T.contiguous(), args.T.contiguous()


def pad_columns(x: torch.Tensor, align: int) -> torch.Tensor:
    """``x`` with zero columns appended up to a multiple of ``align`` (``x``
    itself when it is one already). Zero columns change no score."""
    pad = -x.shape[1] % align
    return torch.nn.functional.pad(x, (0, pad)) if pad else x


def window_body(dtype: torch.dtype, precision: str, d: int) -> str:
    """The body of ``csrc/window_mips.cu`` that serves a ``d``-column corpus
    of ``dtype`` at ``precision``: "tensor_cores" (TMA + wgmma) for bf16 at
    "default" — the queries are rounded to bf16, so the bf16 × bf16
    products are exact and sum in f32 — while the 256-query tile fits in
    shared memory (d ≤ 192); "cuda_cores" (f32 FMAs) for f32 queries
    ("highest") or an f32 corpus, and for wider bf16 rows."""
    if dtype == torch.bfloat16 and precision == "default" and d <= _TC_MAX_DIM:
        return "tensor_cores"
    return "cuda_cores"


def _window_candidates_cuda(queries: torch.Tensor, items: torch.Tensor,
                            window: int, n_valid: int, precision: str,
                            queries_major: bool = False):
    """Launch ``csrc/window_mips.cu`` on the current stream, items-major
    (n_cand, Q) or queries-major (Q, n_cand), through the entry of the body
    :func:`window_body` picks."""
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
    # the kernel reads 8 columns at a time: other widths are zero-padded
    queries, items = pad_columns(queries, 8), pad_columns(items, 8)
    n, d = items.shape
    if window & (window - 1):
        raise ValueError(f"window={window} must be a power of two")
    if queries.shape[0] == 0 or queries.shape[0] >= 2 ** 31 or n >= 2 ** 31:
        raise ValueError("unsupported query or corpus size")

    q = round_queries(queries, items.dtype, precision)
    lib = load_library("window_mips")
    body = window_body(items.dtype, precision, d)
    if body == "tensor_cores":
        if items.data_ptr() % 16:
            raise ValueError("corpus must start 16-byte aligned")
        q = q.to(torch.bfloat16)     # exact: already rounded to bf16
        fn = lib.window_mips_bf16_qm_launch if queries_major else lib.window_mips_bf16_launch
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        extra = ()
    else:
        fn = lib.window_mips_qm_launch if queries_major else lib.window_mips_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int] + \
            [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        extra = (int(items.dtype == torch.bfloat16),)
    fn.restype = ctypes.c_int
    q = q.contiguous()
    n_q = q.shape[0]
    n_cand = -(-n // window)
    shape = (n_q, n_cand) if queries_major else (n_cand, n_q)
    vals = torch.empty(shape, dtype=torch.float32, device=items.device)
    args = torch.empty(shape, dtype=torch.int32, device=items.device)
    with torch.cuda.device(items.device):
        stream = torch.cuda.current_stream(items.device).cuda_stream
        rc = fn(q.data_ptr(), items.data_ptr(), *extra, vals.data_ptr(),
                args.data_ptr(), n_q, n, d, n_valid, window, stream)
    name = "window_mips_qm" if queries_major else "window_mips"
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    count_launch(LAUNCHES, name)
    if not queries_major:
        LAST_BODY["window_mips"] = body
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


def window_candidates_qm(queries: torch.Tensor, items: torch.Tensor,
                         window: int, n_valid: Optional[int] = None,
                         precision: str = "default"):
    """Window maxima and positions queries-major, (Q, n_cand) each: the
    kernel's queries-major launch for a corpus on the card, the plain twin
    for one on the CPU."""
    n_valid = items.shape[0] if n_valid is None else n_valid
    if items.device.type == "cpu":
        return window_candidates_qm_ref(queries, items, window, n_valid,
                                        precision)
    if items.device.type != "cuda":
        raise ValueError(f"no window kernel for device {items.device}")
    return _window_candidates_cuda(queries, items, window, n_valid, precision,
                                   queries_major=True)


def _window_max(scores: torch.Tensor, window: int):
    """(Q, R) scores, R a multiple of ``window`` → (Q, R/W) maxima and
    int32 first-occurrence positions (the smallest lane attaining the
    max)."""
    s3 = scores.view(scores.shape[0], -1, window)
    smax = s3.amax(dim=-1)
    lane = torch.arange(window, dtype=torch.int32, device=scores.device)
    arg = torch.where(s3 >= smax[..., None], lane, window).amin(dim=-1)
    return smax, arg.to(torch.int32)


def window_candidates_i8_ref(q_i8: torch.Tensor, items_i8: torch.Tensor,
                             item_scales: torch.Tensor, window: int,
                             n_valid: Optional[int] = None):
    """Plain twin of kernel 3: (n_cand, Q) f32 window maxima of
    (q_i8 · e_i8) · item_scale and int32 first-occurrence positions,
    n_cand = ceil(N / window). The dot is exact (``ops.topk.int8_dot``),
    the scale is one f32 multiply, and rows >= ``n_valid`` score -3e38 after
    it, so the kernel must agree bit for bit. Works in query chunks and
    window-aligned row chunks, so neither the (Q, N) score slab nor a
    widened corpus is ever live whole."""
    n = items_i8.shape[0]
    n_valid = n if n_valid is None else n_valid
    n_cand = -(-n // window)
    n_pad = n_cand * window
    n_qc = min(_REF_QUERY_CHUNK, q_i8.shape[0])
    rows = max(window, _REF_SCORE_BUDGET // n_qc // window * window)
    vals = torch.empty((n_cand, q_i8.shape[0]), dtype=torch.float32,
                       device=items_i8.device)
    args = torch.empty((n_cand, q_i8.shape[0]), dtype=torch.int32,
                       device=items_i8.device)
    for r0 in range(0, n_pad, rows):
        r1 = min(n_pad, r0 + rows)
        blk, sc = items_i8[r0:r1], item_scales[r0:r1]
        for q0 in range(0, q_i8.shape[0], n_qc):
            scores = int8_dot(q_i8[q0:q0 + n_qc], blk) * sc[None, :]
            scores[:, max(0, n_valid - r0):] = _MASKED
            if scores.shape[1] < r1 - r0:    # the last window's missing rows
                scores = torch.nn.functional.pad(
                    scores, (0, r1 - r0 - scores.shape[1]), value=_MASKED)
            smax, arg = _window_max(scores, window)
            vals[r0 // window:r1 // window, q0:q0 + n_qc] = smax.T
            args[r0 // window:r1 // window, q0:q0 + n_qc] = arg.T
    return vals, args


def _check_int8_operands(q_i8: torch.Tensor, items_i8: torch.Tensor,
                         item_scales: torch.Tensor) -> None:
    if q_i8.dtype != torch.int8 or items_i8.dtype != torch.int8:
        raise TypeError(
            f"queries and corpus must be int8, got {q_i8.dtype}, {items_i8.dtype}")
    if item_scales.dtype != torch.float32:
        raise TypeError(f"item scales must be float32, got {item_scales.dtype}")
    if q_i8.dim() != 2 or items_i8.dim() != 2 or q_i8.shape[1] != items_i8.shape[1]:
        raise ValueError(
            f"shape mismatch: queries {tuple(q_i8.shape)}, corpus {tuple(items_i8.shape)}")
    if item_scales.shape != (items_i8.shape[0],):
        raise ValueError("item_scales length mismatch")


def int8_window_body(d: int) -> str:
    """The body of ``csrc/window_mips_i8.cu`` that serves ``d``-column int8
    rows (zero-padded to ``INT8_ROW_ALIGN`` first): "tensor_cores" (TMA +
    wgmma s8) while the 256-query tile fits in shared memory (d ≤ 384, the
    bf16 body's 384 bytes a row); "cuda_cores" (dp4a) for wider rows, up to
    ``INT8_MAX_DIM``."""
    if d + (-d % INT8_ROW_ALIGN) <= INT8_TC_MAX_DIM:
        return "tensor_cores"
    return "cuda_cores"


def _window_candidates_i8_cuda(q_i8: torch.Tensor, items_i8: torch.Tensor,
                               item_scales: torch.Tensor, window: int,
                               n_valid: int, body: Optional[str] = None):
    """Launch ``csrc/window_mips_i8.cu`` on the current stream, through the
    entry of ``body``: by default the one :func:`int8_window_body` picks (the
    other only to compare the two)."""
    from recommendit_tpu_torch.ops._build import load_library

    if not (q_i8.device == items_i8.device == item_scales.device):
        raise ValueError("queries, corpus and scales must be on the same device")
    if not (items_i8.is_contiguous() and item_scales.is_contiguous()):
        raise ValueError("corpus and scales must be contiguous")
    if items_i8.shape[1] > INT8_MAX_DIM:
        raise ValueError(
            f"feature dim {items_i8.shape[1]} must be at most {INT8_MAX_DIM}")
    # the kernel reads rows INT8_ROW_ALIGN bytes at a time: other widths are
    # zero-padded
    q_i8 = pad_columns(q_i8, INT8_ROW_ALIGN)
    items_i8 = pad_columns(items_i8, INT8_ROW_ALIGN)
    n, d = items_i8.shape
    if window & (window - 1):
        raise ValueError(f"window={window} must be a power of two")
    if q_i8.shape[0] == 0 or q_i8.shape[0] >= 2 ** 31 or n >= 2 ** 31:
        raise ValueError("unsupported query or corpus size")
    q_i8 = q_i8.contiguous()
    if (q_i8.data_ptr() | items_i8.data_ptr()) % 16:
        raise ValueError("queries and corpus must start 16-byte aligned")

    lib = load_library("window_mips_i8")
    body = body or int8_window_body(d)
    if body == "tensor_cores":
        fn = lib.window_mips_i8_tc_launch
        if item_scales.data_ptr() % 16:
            # TMA reads the scales from a 16-byte aligned start: a fresh copy
            # (the caching allocator aligns every block) of n * 4 bytes
            item_scales = item_scales.clone()
    else:
        fn = lib.window_mips_i8_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    n_q = q_i8.shape[0]
    n_cand = -(-n // window)
    vals = torch.empty((n_cand, n_q), dtype=torch.float32, device=items_i8.device)
    args = torch.empty((n_cand, n_q), dtype=torch.int32, device=items_i8.device)
    with torch.cuda.device(items_i8.device):
        stream = torch.cuda.current_stream(items_i8.device).cuda_stream
        rc = fn(q_i8.data_ptr(), items_i8.data_ptr(), item_scales.data_ptr(),
                vals.data_ptr(), args.data_ptr(), n_q, n, d, n_valid, window,
                stream)
    if rc != 0:
        raise RuntimeError(f"window_mips_i8 launch failed: CUDA error {rc}")
    count_launch(LAUNCHES, "window_mips_i8")
    LAST_BODY["window_mips_i8"] = body
    return vals, args


def window_candidates_i8(q_i8: torch.Tensor, items_i8: torch.Tensor,
                         item_scales: torch.Tensor, window: int,
                         n_valid: Optional[int] = None):
    """Int8 window maxima and positions, (n_cand, Q) each: the CUDA kernel
    for a corpus on the card, the plain twin for one on the CPU."""
    _check_int8_operands(q_i8, items_i8, item_scales)
    n_valid = items_i8.shape[0] if n_valid is None else n_valid
    if items_i8.device.type == "cpu":
        return window_candidates_i8_ref(q_i8, items_i8, item_scales, window,
                                        n_valid)
    if items_i8.device.type != "cuda":
        raise ValueError(f"no window kernel for device {items_i8.device}")
    return _window_candidates_i8_cuda(q_i8, items_i8, item_scales, window,
                                      n_valid)


def _select_qm(cand_vals: torch.Tensor, cand_args: torch.Tensor, k: int,
               window: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over (Q, n_cand) window maxima → (Q, k) values and
    global positions (window id · W + position in the window)."""
    vals, sel = fast_topk(cand_vals, k)
    idx = sel * window + torch.gather(cand_args, 1, sel).long()
    return vals, idx


def _select(cand_vals: torch.Tensor, cand_args: torch.Tensor, k: int,
            window: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`_select_qm` over items-major (n_cand, Q) window maxima."""
    return _select_qm(cand_vals.T, cand_args.T, k, window)


def mips_topk_window(
    queries: torch.Tensor,
    item_embs: torch.Tensor,
    k: int,
    block_items: int = 16384,
    window: int = 128,
    precision: str = "default",
    n_valid: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Queries-major window-segment MIPS top-k (``pallas_mips.
    mips_topk_window``) → (values (Q, k) f32, positions (Q, k) int64),
    sorted descending. The same windows, maxima and recall model as
    :func:`mips_topk_window_im`; the kernel stores (Q, n_cand). The kernel
    on the card, its twin on the CPU. ``block_items`` only keeps the JAX
    guard."""
    n_valid = _check_window_args(item_embs.shape[0], k, block_items, window,
                                 n_valid)
    cv, ca = window_candidates_qm(queries, item_embs, window, n_valid, precision)
    return _select_qm(cv, ca, k, window)


def mips_topk_window_ref(
    queries: torch.Tensor,
    item_embs: torch.Tensor,
    k: int,
    block_items: int = 16384,
    window: int = 128,
    precision: str = "default",
    n_valid: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of :func:`mips_topk_window` on any device."""
    n_valid = _check_window_args(item_embs.shape[0], k, block_items, window,
                                 n_valid)
    cv, ca = window_candidates_qm_ref(queries, item_embs, window, n_valid,
                                      precision)
    return _select_qm(cv, ca, k, window)


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
    with span("retrieve.score"):
        cv, ca = window_candidates(queries, item_embs, window, n_valid, precision)
    with span("retrieve.select"):
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


def _int8_window_topk(candidates, queries, items_i8, item_scales, k,
                      block_items, window, n_valid):
    """The body of ``mips_topk_window_im_int8`` (pallas_mips.py:538-605)
    with ``candidates`` the kernel or its twin."""
    if item_scales.shape[0] != items_i8.shape[0]:
        raise ValueError("item_scales length mismatch")
    n_valid = _check_window_args(items_i8.shape[0], k, block_items, window,
                                 n_valid)
    with span("retrieve.score"):
        q_i8, q_scale = quantize_queries(queries.float())
        cv, ca = candidates(q_i8, items_i8, item_scales, window, n_valid)
    with span("retrieve.select"):
        vals, idx = _select(cv, ca, k, window)
        # the per-query scale is positive and uniform along a row: applied
        # after the selection, it cannot change any order
        return vals * q_scale[:, None], idx


def mips_topk_window_im_int8(
    queries: torch.Tensor,
    items_i8: torch.Tensor,
    item_scales: torch.Tensor,
    k: int,
    block_items: int = 2048,
    window: int = 64,
    n_valid: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Int8-corpus window-segment MIPS top-k → (values (Q, k) f32,
    positions (Q, k) int64), sorted descending. f32 queries are quantised
    per row (round to nearest); the kernel ranks (q_i8 · e_i8) · s_item.
    Padded rows carry scale 0 and are masked by ``n_valid``. The kernel on
    the card, its twin on the CPU."""
    return _int8_window_topk(window_candidates_i8, queries, items_i8,
                             item_scales, k, block_items, window, n_valid)


def mips_topk_window_im_int8_ref(
    queries: torch.Tensor,
    items_i8: torch.Tensor,
    item_scales: torch.Tensor,
    k: int,
    block_items: int = 2048,
    window: int = 64,
    n_valid: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of :func:`mips_topk_window_im_int8` on any
    device."""
    return _int8_window_topk(window_candidates_i8_ref, queries, items_i8,
                             item_scales, k, block_items, window, n_valid)


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
    scales: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Production entry for the fused index: small batches over large
    corpora and small corpora take a dense scan (matmul + exact top-k over
    the valid rows), everything else the window kernel. ``precision``
    applies on the scan and kernel routes of an f32/bf16 corpus (the JAX
    scan route drops it); the small-corpus exact route scores at "highest",
    as JAX's does. With ``scales`` the corpus is int8 and the same routes
    take the int8 engines: ``mips_topk_int8`` (scan: "approx", tiny:
    "exact") and the int8 window kernel."""
    n = item_embs.shape[0] if n_valid is None else n_valid
    route, window = fused_route(queries.shape[0], n, k)
    return mips_topk_fused_route(route, window, queries, item_embs, k,
                                 block_items, precision, n_valid, scales)


def mips_topk_fused_route(
    route: str,
    window: int,
    queries: torch.Tensor,
    item_embs: torch.Tensor,
    k: int,
    block_items: int = 4096,
    precision: str = "default",
    n_valid: Optional[int] = None,
    scales: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One route of :func:`mips_topk_fused_auto` (``route`` and ``window``
    as :func:`fused_route` gives them), run as the router runs it — so the
    routes can be timed against each other at any batch size."""
    n = item_embs.shape[0] if n_valid is None else n_valid
    if route != "kernel":
        if k > n:
            raise ValueError(f"k={k} exceeds corpus size {n}")
        if scales is not None:
            mode = "approx" if route == "scan" else "exact"
            return mips_topk_int8(queries, item_embs[:n], scales[:n], k, mode)
        if route == "exact":   # f32 queries at "highest", as in JAX
            return mips_topk(queries, item_embs[:n], k, mode="exact")
        with span("retrieve.score"):
            scores = score_matrix(queries, item_embs[:n], precision)
        with span("retrieve.select"):
            return fast_topk(scores, k)
    bn = max(window, block_items - block_items % window)
    if scales is not None:
        return mips_topk_window_im_int8(queries, item_embs, scales, k, bn,
                                        window, n_valid)
    return mips_topk_window_im(queries, item_embs, k, bn, window, precision,
                               n_valid)
