"""Int8 corpus quantization — torch port of ``recommendit_tpu/ops/quantize.py``.

Two quantizers, each the counterpart of one JAX function, bit for bit:

* :func:`quantize_int8` — ``quantize_int8_jnp(x, jax.random.PRNGKey(seed))``,
  the quantizer the int8 index is built with. Its stochastic rounding draws
  ``jax.random.uniform``, which (threefry-2x32, partitionable bits, JAX's
  default) is a pure counter function of the key and the flat element
  index; :func:`threefry_uniform` computes it in plain torch, so the port
  builds the same int8 corpus as JAX for the same seed, on any device.
* :func:`quantize_int8_hash` — ``quantize_int8_pallas(x, seed)`` (the Pallas
  ``_quantize_kernel``): the same per-row scales, with an xorshift-multiply
  counter hash for the uniform draw. On a CUDA tensor it launches
  ``csrc/quantize_i8.cu``; on a CPU tensor it runs the plain twin
  :func:`quantize_int8_hash_ref`.

One rule both must follow (ROADMAP C): under ``jit`` XLA folds the scale's
constant divide ``absmax / 127.0`` into ``absmax * float32(1/127)``, which
differs from the true quotient in the last bit for ~5 % of rows. The scales
here are that product; ``x / scale`` stays a true division.

Unsigned 32-bit words are held in int64 tensors and masked after every
operation that can carry past bit 31 (torch's uint32 shifts are partial).
Work runs in row chunks, so no int64 temporary of the corpus' full size is
ever live.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from recommendit_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

_M32 = 0xFFFFFFFF
_INV127 = float(np.float32(1.0) / np.float32(127.0))   # XLA's folded 1/127
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_CHUNK_ELEMS = 1 << 24   # elements per chunk: each int64 temporary ≤ 128 MB

# Kernel launches since the last reset. Only the CUDA wrapper adds to it.
LAUNCHES = {"quantize_i8": 0}


def _key_words(seed: int) -> Tuple[int, int]:
    """``jax.random.key_data(jax.random.PRNGKey(seed))`` with 64-bit mode
    off: the seed is an int32, its high word (a logical shift by 32) is 0
    and its low word is the seed modulo 2^32."""
    seed = int(seed)
    if not -(1 << 31) <= seed < (1 << 31):
        raise ValueError(f"seed {seed} does not fit an int32")
    return 0, seed & _M32


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & _M32


def threefry2x32(k1: int, k2: int, x0: torch.Tensor, x1: torch.Tensor):
    """Threefry-2x32, 20 rounds (JAX's ``threefry2x32_p``), on int64 tensors
    holding uint32 words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def threefry_uniform(seed: int, n: int, offset: int = 0,
                     device=DEFAULT_DEVICE) -> torch.Tensor:
    """Elements ``offset … offset + n − 1`` of the flat f32 array
    ``jax.random.uniform(jax.random.PRNGKey(seed), shape)`` for any shape
    with at least ``offset + n`` elements: the counter is the flat index
    (high word, low word), the bits are the xor of threefry's two outputs,
    and the top 23 bits become the mantissa of a float in [1, 2), minus 1."""
    k1, k2 = _key_words(seed)
    i = torch.arange(offset, offset + n, dtype=torch.int64,
                     device=resolve_device(device))
    b0, b1 = threefry2x32(k1, k2, i >> 32, i & _M32)
    return ((b0 ^ b1) >> 9).to(torch.float32) * (1.0 / (1 << 23))


def row_scales(x: torch.Tensor) -> torch.Tensor:
    """Per-row symmetric scale so that x / scale fits in [-127, 127]."""
    return x.abs().amax(dim=-1).clamp(min=1e-12) * _INV127


def _rows_per_chunk(d: int) -> int:
    return max(1, _CHUNK_ELEMS // max(1, d))


def _check_2d_float(x: torch.Tensor) -> None:
    if x.dim() != 2:
        raise ValueError(f"expected an (N, D) array, got shape {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"expected float32, got {x.dtype}")


def quantize_int8(x: torch.Tensor, seed: int = 0, stochastic: bool = True,
                  row_offset: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, D) f32 → ((N, D) int8, (N,) f32 per-row scales), equal to
    ``quantize_int8_jnp(x, PRNGKey(seed), stochastic)``.

    ``stochastic=True`` floors ``x/scale + u`` with u the threefry uniform
    of each element (unbiased); ``False`` rounds half to even. ``row_offset``
    names the first row of ``x`` inside a larger (R, D) array, so that a
    corpus quantised chunk by chunk equals the corpus quantised at once."""
    _check_2d_float(x)
    n, d = x.shape
    scales = row_scales(x)
    out = torch.empty((n, d), dtype=torch.int8, device=x.device)
    step = _rows_per_chunk(d)
    for r0 in range(0, n, step):
        r1 = min(n, r0 + step)
        scaled = x[r0:r1] / scales[r0:r1, None]
        if stochastic:
            u = threefry_uniform(seed, (r1 - r0) * d, (row_offset + r0) * d,
                                 x.device).view(r1 - r0, d)
            q = torch.floor(scaled + u)
        else:
            q = torch.round(scaled)
        out[r0:r1] = q.clamp_(-127.0, 127.0).to(torch.int8)
    return out, scales


def dequantize_int8(vals: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    return vals.to(torch.float32) * scales[..., None]


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h · c) mod 2^32 for uint32 words in int64, in two 16-bit halves of
    ``c`` so that no product passes 2^63."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _hash_uniform(idx: torch.Tensor, seed: int) -> torch.Tensor:
    """The ``_quantize_kernel`` draw (quantize.py:77-84): u in [0, 1) from
    the top 24 bits of an xorshift-multiply hash of the element's uint32
    index and the seed."""
    h = idx ^ (((seed & _M32) * 0x9E3779B9) & _M32)
    h = _mul32(h ^ (h >> 16), 0x7FEB352D)
    h = _mul32(h ^ (h >> 15), 0x846CA68B)
    h = h ^ (h >> 16)
    return (h >> 8).to(torch.float32) * (1.0 / (1 << 24))


def quantize_int8_hash_ref(x: torch.Tensor,
                           seed: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of kernel 7 on any device: ``quantize_int8_pallas(x,
    seed)`` for any row block — the element index is ``row·D + col`` over
    the unpadded rows, modulo 2^32."""
    _check_2d_float(x)
    _key_words(seed)   # the JAX wrapper passes the seed as an int32
    n, d = x.shape
    scales = row_scales(x)
    out = torch.empty((n, d), dtype=torch.int8, device=x.device)
    step = _rows_per_chunk(d)
    for r0 in range(0, n, step):
        r1 = min(n, r0 + step)
        idx = torch.arange(r0 * d, r1 * d, dtype=torch.int64,
                           device=x.device) & _M32
        u = _hash_uniform(idx, seed).view(r1 - r0, d)
        q = torch.floor(x[r0:r1] / scales[r0:r1, None] + u)
        out[r0:r1] = q.clamp_(-127.0, 127.0).to(torch.int8)
    return out, scales


def _quantize_hash_cuda(x: torch.Tensor, seed: int):
    """Launch ``csrc/quantize_i8.cu`` on the current stream."""
    from recommendit_tpu_torch.ops._build import load_library

    if not x.is_contiguous():
        raise ValueError("input must be contiguous")
    n, d = x.shape
    if n == 0 or d == 0 or n >= 2 ** 31 or d >= 2 ** 31:
        raise ValueError(f"unsupported shape {tuple(x.shape)}")
    lib = load_library("quantize_i8")
    fn = lib.quantize_i8_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_uint32, ctypes.c_void_p]
    vals = torch.empty((n, d), dtype=torch.int8, device=x.device)
    scales = torch.empty((n,), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), vals.data_ptr(), scales.data_ptr(), n, d,
                seed & _M32, stream)
    if rc != 0:
        raise RuntimeError(f"quantize_i8 launch failed: CUDA error {rc}")
    LAUNCHES["quantize_i8"] += 1
    return vals, scales


def quantize_int8_hash(x: torch.Tensor,
                       seed: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, D) f32 → ((N, D) int8, (N,) f32 scales), the counterpart of
    ``quantize_int8_pallas(x, seed)``: the CUDA kernel for a tensor on the
    card, the plain twin for one on the CPU."""
    _check_2d_float(x)
    _key_words(seed)
    if x.device.type == "cpu":
        return quantize_int8_hash_ref(x, seed)
    if x.device.type != "cuda":
        raise ValueError(f"no quantize kernel for device {x.device}")
    return _quantize_hash_cuda(x, seed)
