"""Two-tower embedding model — torch port, inference.

Counterpart of ``recommendit_tpu/models/two_tower.py``: user tower =
embedding → MLP → L2-normalise; item tower = embedding ⊕ 18-d genre vector
→ MLP → L2-normalise; a learned per-item score bias. Parameters keep the
JAX names, and :meth:`TwoTower.load` / :meth:`TwoTower.save` read and write
the JAX npz + ``.meta.json`` format, so one checkpoint serves both.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict

import numpy as np
import torch
from torch import nn

from recommendit_tpu_torch.features.schema import N_GENRES

PARAM_NAMES = (
    "user_embed", "item_embed", "user_w1", "user_b1", "user_w2", "user_b2",
    "item_w1", "item_b1", "item_w2", "item_b2", "item_bias",
)


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """x · rsqrt(Σx² + eps) over the last axis (the JAX formula)."""
    return x * torch.rsqrt((x * x).sum(dim=-1, keepdim=True) + eps)


def _mlp(x, w1, b1, w2, b2):
    return torch.relu(x @ w1 + b1) @ w2 + b2


class TwoTower(nn.Module):
    """Both towers and the item bias, with the JAX parameter names."""

    def __init__(self, n_users: int, n_items: int, embed_dim: int = 64,
                 hidden_dim: int = 128, dropout: float = 0.2,
                 device="cpu"):
        super().__init__()
        self.n_users = n_users
        self.n_items = n_items
        self.embed_dim = embed_dim
        self.hidden_dim = hidden_dim
        self.dropout = dropout
        shapes = {
            "user_embed": (n_users + 1, embed_dim),
            "item_embed": (n_items + 1, embed_dim),
            "user_w1": (embed_dim, hidden_dim), "user_b1": (hidden_dim,),
            "user_w2": (hidden_dim, embed_dim), "user_b2": (embed_dim,),
            "item_w1": (embed_dim + N_GENRES, hidden_dim),
            "item_b1": (hidden_dim,),
            "item_w2": (hidden_dim, embed_dim), "item_b2": (embed_dim,),
            "item_bias": (n_items + 1,),
        }
        for name in PARAM_NAMES:
            self.register_parameter(name, nn.Parameter(
                torch.zeros(shapes[name], device=device), requires_grad=False))

    @classmethod
    def from_numpy(cls, params: Dict[str, np.ndarray], n_users: int,
                   n_items: int, embed_dim: int = 64, hidden_dim: int = 128,
                   dropout: float = 0.2, device="cpu") -> "TwoTower":
        """Model holding the given JAX-named parameter arrays (a missing
        ``item_bias`` — pre-bias checkpoints — becomes zeros)."""
        model = cls(n_users, n_items, embed_dim, hidden_dim, dropout, device)
        for name in PARAM_NAMES:
            if name not in params and name == "item_bias":
                continue
            arr = np.array(params[name], np.float32)
            p = getattr(model, name)
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(
                    f"{name}: shape {arr.shape}, expected {tuple(p.shape)}")
            p.data.copy_(torch.from_numpy(arr))
        return model

    @torch.no_grad()
    def user_tower(self, user_ids: torch.Tensor) -> torch.Tensor:
        """(B,) int ids → (B, D) L2-normalised user embeddings."""
        emb = self.user_embed[user_ids.long()]
        return l2_normalize(_mlp(emb, self.user_w1, self.user_b1,
                                 self.user_w2, self.user_b2))

    @torch.no_grad()
    def item_tower(self, item_ids: torch.Tensor,
                   genre_vecs: torch.Tensor) -> torch.Tensor:
        """(B,) int ids + (B, 18) genre multi-hot → (B, D) normalised."""
        x = torch.cat([self.item_embed[item_ids.long()],
                       genre_vecs.to(self.item_embed.dtype)], dim=-1)
        return l2_normalize(_mlp(x, self.item_w1, self.item_b1,
                                 self.item_w2, self.item_b2))

    @property
    def device(self) -> torch.device:
        return self.user_embed.device

    def get_item_embeddings(self, item_ids: np.ndarray, genre_matrix: np.ndarray,
                            batch_size: int = 65536) -> np.ndarray:
        """Batched catalog embedding → (N, D) float32 numpy."""
        out = []
        for s in range(0, len(item_ids), batch_size):
            ids = torch.as_tensor(item_ids[s:s + batch_size], device=self.device)
            g = torch.as_tensor(genre_matrix[s:s + batch_size],
                                dtype=torch.float32, device=self.device)
            out.append(self.item_tower(ids, g).cpu().numpy())
        if not out:
            return np.zeros((0, self.embed_dim), np.float32)
        return np.concatenate(out, axis=0)

    def item_bias_np(self, item_ids: np.ndarray) -> np.ndarray:
        """Learned per-item score bias for the given ids."""
        ids = torch.as_tensor(np.asarray(item_ids), device=self.device).long()
        return self.item_bias.detach()[ids].cpu().numpy().astype(np.float32)

    # --- persistence (the JAX npz + meta sidecar format) --------------- #

    def save(self, path: str) -> None:
        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        np.savez(p, **{n: getattr(self, n).detach().cpu().numpy()
                       for n in PARAM_NAMES})
        meta = {
            "n_users": self.n_users, "n_items": self.n_items,
            "embed_dim": self.embed_dim, "hidden_dim": self.hidden_dim,
            "dropout": self.dropout,
        }
        Path(str(p) + ".meta.json").write_text(json.dumps(meta))

    @classmethod
    def load(cls, path: str, device="cpu") -> "TwoTower":
        p = Path(path)
        if not p.exists():
            raise FileNotFoundError(f"Two-tower checkpoint not found: {p}")
        meta = json.loads(Path(str(p) + ".meta.json").read_text())
        with np.load(p) as data:
            params = {k: data[k] for k in data.files}
        return cls.from_numpy(params, device=device, **meta)
