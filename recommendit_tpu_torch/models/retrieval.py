"""MIPS retrieval index — torch port.

Counterpart of ``recommendit_tpu/models/retrieval.py`` for the modes
``exact``, ``approx`` and ``fused`` over f32 and bf16 corpora, with the same
npz + ``.meta.json`` file format.

Device layout: rows are L2-normalised, the optional per-item bias becomes
one more column (the score ``q·e + b`` is one dot against ``[q, 1]``), and
then the columns are zero-padded to a multiple of 8 (129 → 136 at dim 128)
so every row starts 16-byte aligned for the window kernel. The zero columns
change no score, and :meth:`save` strips them, so the file is the JAX one.
In ``fused`` mode the rows are zero-padded to a ``block_size`` multiple at
build time, as in JAX; searches mask them by ``n_valid``.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from recommendit_tpu_torch.ops.mips_window import mips_topk_fused_auto
from recommendit_tpu_torch.ops.topk import mips_topk

_ROADMAP_INT8 = ("the int8 corpus waits for the int8 window kernel "
                 "(ROADMAP.md, queue B, kernel 3)")
_ROADMAP_VERIFIED = ("mode='verified' waits for the certified top-k engines "
                     "(ROADMAP.md, queue A, ops/topk.py remaining engines)")
COL_ALIGN = 8


def _l2_normalize_np(x: np.ndarray) -> np.ndarray:
    norms = np.linalg.norm(x, axis=-1, keepdims=True)
    return x / np.maximum(norms, 1e-12)


class MIPSIndex:
    """Maximum-inner-product index over a corpus held on ``device``."""

    def __init__(self, embedding_dim: int = 64, block_size: int = 4096,
                 mode: str = "exact", dtype: str = "float32", device="cpu"):
        if dtype == "int8":
            raise NotImplementedError(_ROADMAP_INT8)
        if dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unsupported corpus dtype: {dtype!r}")
        if mode == "verified":
            raise NotImplementedError(_ROADMAP_VERIFIED)
        if mode not in ("exact", "approx", "fused"):
            raise ValueError(
                f"unsupported index mode: {mode!r} (exact | approx | fused)")
        self.embedding_dim = embedding_dim
        self.block_size = block_size
        self.mode = mode
        self.dtype = dtype
        self.device = torch.device(device)
        self.item_ids: Optional[np.ndarray] = None       # (N,) int64
        self._embs: Optional[torch.Tensor] = None         # (N_pad, D_dev)
        self._ids_dev: Optional[torch.Tensor] = None      # (N,) int64
        self._bias_np: Optional[np.ndarray] = None        # (N,) f32

    # --- build ---------------------------------------------------------- #

    def build(self, embeddings: np.ndarray, item_ids: np.ndarray,
              bias: Optional[np.ndarray] = None) -> None:
        """Normalise, append the bias column, pad, and place on device."""
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
        n, d = embs.shape
        rows = n + ((-n) % self.block_size if self.mode == "fused" else 0)
        dev_dtype = torch.bfloat16 if self.dtype == "bfloat16" else torch.float32
        dev = torch.zeros((rows, d + (-d) % COL_ALIGN), dtype=dev_dtype,
                          device=self.device)
        dev[:n, :d] = torch.from_numpy(embs).to(self.device)
        self._embs = dev
        self._ids_dev = torch.as_tensor(self.item_ids, device=self.device)

    @property
    def n_total(self) -> int:
        return 0 if self.item_ids is None else len(self.item_ids)

    @property
    def has_bias(self) -> bool:
        return self._bias_np is not None

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
        vals, pos = self.search_device_positions(
            torch.as_tensor(q, device=self.device), k)
        return vals.cpu().numpy(), self._ids_dev[pos].cpu().numpy()

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
        Exact mode scores in full f32; approx and fused modes at the corpus
        dtype (``precision="default"``)."""
        embs, block, n_valid = self._embs, self.block_size, self.n_total
        aug = self._augment
        if self.mode == "fused":
            return lambda q: mips_topk_fused_auto(aug(q), embs, k, block,
                                                  n_valid=n_valid)
        mode = self.mode
        return lambda q: mips_topk(aug(q), embs, k, mode, n_valid=n_valid)

    def search_device_positions(self, queries: torch.Tensor, k: int):
        """Device-to-device search → (scores, corpus positions)."""
        return self.make_device_searcher(k)(queries)

    # --- persistence (the JAX npz + meta format) ------------------------ #

    def save(self, path: str) -> None:
        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        extras = {"bias": self._bias_np} if self._bias_np is not None else {}
        np.savez(
            p,
            embeddings=self._embs[: self.n_total, : self.embedding_dim]
            .float().cpu().numpy(),
            item_ids=self.item_ids,
            **extras,
        )
        meta = {
            "embedding_dim": self.embedding_dim,
            "block_size": self.block_size,
            "mode": self.mode,
            "dtype": self.dtype,
            "quant_seed": 0,
            "n_total": self.n_total,
        }
        Path(str(p) + ".meta.json").write_text(json.dumps(meta))

    @classmethod
    def load(cls, path: str, device="cpu") -> "MIPSIndex":
        p = Path(path)
        if not p.exists():
            raise FileNotFoundError(f"Index not found: {p}")
        meta = json.loads(Path(str(p) + ".meta.json").read_text())
        idx = cls(embedding_dim=meta["embedding_dim"],
                  block_size=meta["block_size"], mode=meta["mode"],
                  dtype=meta.get("dtype", "float32"), device=device)
        with np.load(p) as data:
            if "embeddings_i8" in data.files:
                raise NotImplementedError(_ROADMAP_INT8)
            idx.build(data["embeddings"], data["item_ids"],
                      bias=data["bias"] if "bias" in data.files else None)
        return idx
