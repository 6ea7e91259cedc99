"""Row gather — torch port of ``recommendit_tpu/ops/gather.py``.

* :func:`gather_rows` — ``table[clamp(idx, 0, N-1)]`` for an (N, D) table
  of any dtype and an integer index of any shape (0-d included), shape
  ``idx.shape + (D,)``: ``jnp.take(table, idx, axis=0, mode="clip")``. On a
  CUDA tensor it launches ``csrc/gather_rows.cu`` (the port of the Pallas
  ``_gather_kernel``); on a CPU tensor it runs the plain twin
  :func:`gather_rows_ref`.
* :func:`take_rows` — the same call (the JAX function routes between the
  Pallas gather and ``jnp.take`` by backend; here the tensor's device does).

The JAX arguments ``block``, ``lag`` and ``interpret`` only size or emulate
the TPU's DMA queue, and the padding of rows to 128 columns is a Mosaic
rule; the port has none of them. As in JAX, nothing in the serve path calls
this op: serving gathers the packed feature rows with plain indexing.
"""
from __future__ import annotations

import ctypes

import torch

from recommendit_tpu_torch.ops._build import count_launch

# Kernel launches since the last reset. Only the CUDA wrapper adds to it.
LAUNCHES = {"gather_rows": 0}

_INDEX_DTYPES = (torch.int32, torch.int64)


def _check(table: torch.Tensor, idx: torch.Tensor) -> None:
    if table.dim() != 2:
        raise ValueError(f"table must be (N, D), got shape {tuple(table.shape)}")
    if table.shape[0] == 0:
        raise ValueError("cannot gather from an empty table")
    if idx.dtype == torch.bool or idx.is_floating_point() or idx.is_complex():
        raise TypeError(f"indices must be integers, got {idx.dtype}")


def gather_rows_ref(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain twin of the kernel on any device: ``table[idx.clamp(0, N-1)]``."""
    _check(table, idx)
    return table[idx.long().clamp(0, table.shape[0] - 1)]


def _gather_rows_cuda(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/gather_rows.cu`` on the current stream."""
    from recommendit_tpu_torch.ops._build import load_library

    if idx.device != table.device:
        raise ValueError("table and indices must be on the same device")
    if not table.is_contiguous():
        raise ValueError("table must be contiguous")
    if idx.dtype not in _INDEX_DTYPES:
        idx = idx.long()
    flat = idx.contiguous().view(-1)
    out = torch.empty(tuple(idx.shape) + (table.shape[1],), dtype=table.dtype,
                      device=table.device)
    if flat.numel() == 0 or table.shape[1] == 0:
        return out
    lib = load_library("gather_rows")
    fn = lib.gather_rows_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_longlong, ctypes.c_void_p]
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        rc = fn(table.data_ptr(), flat.data_ptr(),
                int(flat.dtype == torch.int64), out.data_ptr(), flat.numel(),
                table.shape[0], table.shape[1] * table.element_size(), stream)
    if rc != 0:
        raise RuntimeError(f"gather_rows launch failed: CUDA error {rc}")
    count_launch(LAUNCHES, "gather_rows")
    return out


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` with out-of-range indices clamped to the table, shape
    ``idx.shape + (D,)``: the CUDA kernel for a table on the card, the
    plain twin for one on the CPU."""
    if table.device.type == "cpu":
        return gather_rows_ref(table, idx)
    if table.device.type != "cuda":
        raise ValueError(f"no gather kernel for device {table.device}")
    _check(table, idx)
    return _gather_rows_cuda(table, idx)


def take_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``jnp.take(table, idx, axis=0, mode="clip")``: :func:`gather_rows`."""
    return gather_rows(table, idx)
