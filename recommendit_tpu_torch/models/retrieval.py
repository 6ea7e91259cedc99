"""MIPS retrieval index — torch port.

Counterpart of ``recommendit_tpu/models/retrieval.py`` for the modes
``exact``, ``verified``, ``approx`` and ``fused`` over f32, bf16 and int8
corpora (``verified`` not over int8, as in JAX), with the same npz +
``.meta.json`` file format.

Device layout: rows are L2-normalised, the optional per-item bias becomes
one more column (the score ``q·e + b`` is one dot against ``[q, 1]``), and
then the columns are zero-padded to ``COL_ALIGN`` (129 → 136 for f32/bf16,
129 → 144 for int8) so every row starts 16-byte aligned for the window
kernels. The zero columns change no score, and :meth:`save` strips them, so
the file is the JAX one. An int8 corpus is quantised from the unpadded
(N, D) rows with ``quantize_int8`` (the same threefry stream as JAX's
``quantize_int8_jnp`` for ``quant_seed``), so it equals the JAX corpus byte
for byte. In ``fused`` mode the rows are zero-padded to a ``block_size``
multiple at build time (int8: after quantising, with scale 0), as in JAX;
searches mask them by ``n_valid``.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from recommendit_tpu_torch.ops.mips_window import mips_topk_fused_auto
from recommendit_tpu_torch.ops.quantize import quantize_int8
from recommendit_tpu_torch.ops.topk import (
    INT8_ROW_ALIGN,
    mips_topk,
    mips_topk_certified,
    mips_topk_int8,
)
from recommendit_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

COL_ALIGN = {"float32": 8, "bfloat16": 8, "int8": INT8_ROW_ALIGN}
_DEV_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _l2_normalize_np(x: np.ndarray) -> np.ndarray:
    norms = np.linalg.norm(x, axis=-1, keepdims=True)
    return x / np.maximum(norms, 1e-12)


def _pad_cols(x: torch.Tensor, align: int) -> torch.Tensor:
    pad = -x.shape[1] % align
    return torch.nn.functional.pad(x, (0, pad)) if pad else x


class MIPSIndex:
    """Maximum-inner-product index over a corpus held on ``device``."""

    def __init__(self, embedding_dim: int = 64, block_size: int = 4096,
                 mode: str = "exact", dtype: str = "float32",
                 quant_seed: int = 0, device=DEFAULT_DEVICE):
        if dtype not in COL_ALIGN:
            raise ValueError(f"unsupported corpus dtype: {dtype!r}")
        if mode not in ("exact", "verified", "approx", "fused"):
            raise ValueError(
                f"unsupported index mode: {mode!r} "
                "(exact | verified | approx | fused)")
        if dtype == "int8" and mode == "verified":
            raise ValueError(
                "mode='verified' is not available for the int8 corpus "
                "path (the exactness certificate is defined on f32 "
                "scores; use exact, approx or fused)")
        self.embedding_dim = embedding_dim
        self.block_size = block_size
        self.mode = mode
        self.dtype = dtype
        self.quant_seed = quant_seed
        self.device = resolve_device(device)
        self.item_ids: Optional[np.ndarray] = None       # (N,) int64
        self._embs: Optional[torch.Tensor] = None         # (N_pad, D_dev)
        self._scales: Optional[torch.Tensor] = None       # (N_pad,) f32, int8
        self._ids_dev: Optional[torch.Tensor] = None      # (N,) int64
        self._bias_np: Optional[np.ndarray] = None        # (N,) f32

    # --- build ---------------------------------------------------------- #

    def build(self, embeddings: np.ndarray, item_ids: np.ndarray,
              bias: Optional[np.ndarray] = None) -> None:
        """Normalise, append the bias column, quantise (int8), pad, and
        place on device."""
        if embeddings.ndim != 2 or embeddings.shape[1] != self.embedding_dim:
            raise ValueError(
                f"embeddings must be (N, {self.embedding_dim}), "
                f"got {embeddings.shape}")
        if len(item_ids) != len(embeddings):
            raise ValueError("item_ids and embeddings length mismatch")
        embs = _l2_normalize_np(np.asarray(embeddings, np.float32))
        if bias is not None:
            if len(bias) != len(embs):
                raise ValueError("bias and embeddings length mismatch")
            self._bias_np = np.asarray(bias, np.float32)
            embs = np.concatenate([embs, self._bias_np[:, None]], axis=1)
        else:
            self._bias_np = None
        self.item_ids = np.asarray(item_ids, np.int64)
        rows = torch.from_numpy(embs).to(self.device)
        if self.dtype == "int8":
            rows, scales = quantize_int8(rows, self.quant_seed)
        else:
            rows, scales = rows.to(_DEV_DTYPE[self.dtype]), None
        self._place(rows, scales)

    # JAX's alias of the reference's method name
    build_ivf_index = build

    def _place(self, rows: torch.Tensor, scales: Optional[torch.Tensor]) -> None:
        """Pad the corpus (rows to a ``block_size`` multiple in fused mode,
        columns to ``COL_ALIGN``) and keep it with its scales and ids."""
        pad = -rows.shape[0] % self.block_size if self.mode == "fused" else 0
        if pad:
            rows = torch.nn.functional.pad(rows, (0, 0, 0, pad))
            if scales is not None:
                scales = torch.nn.functional.pad(scales, (0, pad))
        self._embs = _pad_cols(rows, COL_ALIGN[self.dtype]).contiguous()
        self._scales = scales
        self._ids_dev = torch.as_tensor(self.item_ids, device=self.device)

    @property
    def n_total(self) -> int:
        return 0 if self.item_ids is None else len(self.item_ids)

    @property
    def has_bias(self) -> bool:
        return self._bias_np is not None

    @property
    def _width(self) -> int:
        """Columns of the stored rows: the embedding and the bias column."""
        return self.embedding_dim + int(self.has_bias)

    # --- search --------------------------------------------------------- #

    def search(self, query: np.ndarray, k: int = 500) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k for one query vector → (scores (k,), item_ids (k,))."""
        scores, ids = self.batch_search(np.asarray(query).reshape(1, -1), k)
        return scores[0], ids[0]

    def batch_search(self, queries: np.ndarray, k: int = 500) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k for (Q, D) queries → (scores (Q, k), item_ids (Q, k))."""
        if self._embs is None:
            raise RuntimeError("Index not built. Call build() first.")
        k = min(k, self.n_total)
        q = _l2_normalize_np(np.asarray(queries, np.float32))
        vals, ids = self.search_device(torch.as_tensor(q, device=self.device), k)
        return vals.cpu().numpy(), ids.cpu().numpy()

    def _augment(self, queries: torch.Tensor) -> torch.Tensor:
        """[q, 1 (bias column), 0 … (pad columns)] to the device width; an
        already augmented query passes unchanged."""
        d_dev = self._embs.shape[1]
        if queries.shape[-1] == d_dev:
            return queries
        if queries.shape[-1] != self.embedding_dim:
            raise ValueError(
                f"query dim {queries.shape[-1]}, expected {self.embedding_dim}")
        extra = torch.zeros(queries.shape[:-1] + (d_dev - self.embedding_dim,),
                            dtype=queries.dtype, device=queries.device)
        if self.has_bias:
            extra[..., 0] = 1.0
        return torch.cat([queries, extra], dim=-1)

    def make_device_searcher(self, k: int):
        """(Q, D) queries on the device → (scores (Q, k), positions (Q, k)).
        Exact mode scores f32 corpora in full f32; verified mode is the
        certified-exact ``mips_topk_certified`` (full f32, values equal to
        exact mode's); approx and fused modes at the corpus dtype
        (``precision="default"``); an int8 corpus scores int8 queries
        (round to nearest) against its int8 rows."""
        embs, scales, block = self._embs, self._scales, self.block_size
        mode, n_valid, aug = self.mode, self.n_total, self._augment
        if mode == "fused":
            return lambda q: mips_topk_fused_auto(aug(q), embs, k, block,
                                                  n_valid=n_valid,
                                                  scales=scales)
        if scales is not None:
            return lambda q: mips_topk_int8(aug(q), embs, scales, k, mode)
        if mode == "verified":
            return lambda q: mips_topk_certified(aug(q), embs, k, block)
        return lambda q: mips_topk(aug(q), embs, k, mode=mode, n_valid=n_valid)

    def search_device(self, queries: torch.Tensor, k: int):
        """Device-to-device search (nothing copied to the host) → (scores,
        item ids), both on the device."""
        vals, pos = self.search_device_positions(queries, k)
        return vals, self._ids_dev[pos]

    def search_device_positions(self, queries: torch.Tensor, k: int):
        """Like :meth:`search_device`, but → (scores, corpus positions)."""
        return self.make_device_searcher(k)(queries)

    # --- persistence (the JAX npz + meta format) ------------------------ #

    def save(self, path: str) -> None:
        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        extras = {"bias": self._bias_np} if self._bias_np is not None else {}
        if self.dtype == "int8":
            # the quantised corpus as JAX keeps it: fused mode's padding
            # rows included, the device's padding columns not
            arrays = {
                "embeddings_i8": self._embs[:, : self._width].cpu().numpy(),
                "scales": self._scales.cpu().numpy(),
            }
        else:
            arrays = {"embeddings": self._embs[: self.n_total, : self.embedding_dim]
                      .float().cpu().numpy()}
        np.savez(p, **arrays, item_ids=self.item_ids, **extras)
        meta = {
            "embedding_dim": self.embedding_dim,
            "block_size": self.block_size,
            "mode": self.mode,
            "dtype": self.dtype,
            "quant_seed": self.quant_seed,
            "n_total": self.n_total,
        }
        Path(str(p) + ".meta.json").write_text(json.dumps(meta))

    @classmethod
    def load(cls, path: str, device=DEFAULT_DEVICE) -> "MIPSIndex":
        p = Path(path)
        if not p.exists():
            raise FileNotFoundError(f"Index not found: {p}")
        meta = json.loads(Path(str(p) + ".meta.json").read_text())
        idx = cls(embedding_dim=meta["embedding_dim"],
                  block_size=meta["block_size"], mode=meta["mode"],
                  dtype=meta.get("dtype", "float32"),
                  quant_seed=meta.get("quant_seed", 0), device=device)
        with np.load(p) as data:
            bias = data["bias"] if "bias" in data.files else None
            if "embeddings_i8" not in data.files:
                idx.build(data["embeddings"], data["item_ids"], bias=bias)
                return idx
            idx.item_ids = np.asarray(data["item_ids"], np.int64)
            idx._bias_np = None if bias is None else np.asarray(bias, np.float32)
            rows = torch.as_tensor(np.asarray(data["embeddings_i8"], np.int8))
            scales = torch.as_tensor(np.asarray(data["scales"], np.float32))
        if rows.shape[1] != idx._width or len(scales) != len(rows):
            raise ValueError(
                f"embeddings_i8 {tuple(rows.shape)} and scales {tuple(scales.shape)} "
                f"do not fit dim {idx._width}")
        # a fused-mode file already carries JAX's block padding
        idx._place(rows.to(idx.device), scales.to(idx.device))
        return idx

    # --- introspection --------------------------------------------------- #

    def stats(self) -> dict:
        """The JAX index's ``stats()`` keys. ``recall`` is 1.0 for an exact
        f32/bf16 index and None otherwise (int8, approx, fused)."""
        return {
            "index_type": "exact-mips",
            "n_total": self.n_total,
            "embedding_dim": self.embedding_dim,
            "block_size": self.block_size,
            "mode": self.mode,
            "dtype": self.dtype,
            "has_bias": self.has_bias,
            "recall": 1.0
            if self.mode in ("exact", "verified") and self.dtype != "int8"
            else None,
        }
