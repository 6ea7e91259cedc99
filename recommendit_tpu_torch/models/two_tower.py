"""Two-tower embedding model — torch port.

Counterpart of ``recommendit_tpu/models/two_tower.py``: user tower =
embedding → MLP → L2-normalise; item tower = embedding ⊕ 18-d genre vector
→ MLP → L2-normalise; a learned per-item score bias. Parameters keep the
JAX names, and :meth:`TwoTower.load` / :meth:`TwoTower.save` read and write
the JAX npz + ``.meta.json`` format, so one checkpoint serves both.

Two surfaces:

* :class:`TwoTower` — the inference model the serve path loads (no grad).
* the functions :func:`init_params`, :func:`user_tower`, :func:`item_tower`
  (and their ``*_from_embed`` heads) — pure functions over a dict of
  JAX-named tensors, differentiable, with dropout from an explicit
  ``torch.Generator`` and an optional reduced-precision compute dtype, as
  the JAX trainer uses them. :func:`from_jax_params` carries the JAX
  package's params (numpy arrays) into a :class:`TwoTower`, and
  :func:`dense_from_jax_params` a host-table run's dense params.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from recommendit_tpu_torch.features.schema import N_GENRES
from recommendit_tpu_torch.ops.bpr import in_batch_bpr_loss, pairwise_bpr_loss
from recommendit_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

PARAM_NAMES = (
    "user_embed", "item_embed", "user_w1", "user_b1", "user_w2", "user_b2",
    "item_w1", "item_b1", "item_w2", "item_b2", "item_bias",
)
TABLE_NAMES = ("user_embed", "item_embed")


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """x · rsqrt(Σx² + eps) over the last axis (the JAX formula)."""
    return x * torch.rsqrt((x * x).sum(dim=-1, keepdim=True) + eps)


def _mlp(x, w1, b1, w2, b2, dropout_rate: float = 0.0,
         rng: Optional[torch.Generator] = None, compute_dtype=None):
    """MLP head. ``compute_dtype`` (e.g. ``torch.bfloat16``) casts the input
    and weights, computes, and returns f32 before normalisation; dropout
    draws its keep mask from ``rng`` and scales the kept units by
    1 / (1 − rate), as the JAX ``_mlp`` does."""
    if compute_dtype is not None:
        x = x.to(compute_dtype)
        w1, b1 = w1.to(compute_dtype), b1.to(compute_dtype)
        w2, b2 = w2.to(compute_dtype), b2.to(compute_dtype)
    h = torch.relu(x @ w1 + b1)
    if dropout_rate > 0.0 and rng is not None:
        keep = torch.rand(h.shape, generator=rng, device=h.device) < 1.0 - dropout_rate
        h = torch.where(keep, h / (1.0 - dropout_rate), torch.zeros_like(h))
    return (h @ w2 + b2).float()


Params = Dict[str, torch.Tensor]


def init_params(rng: torch.Generator, n_users: int, n_items: int,
                embed_dim: int = 64, hidden_dim: int = 128,
                device=DEFAULT_DEVICE) -> Params:
    """Fresh two-tower params with the JAX initialisers: embeddings
    N(0, 0.1²) with a zero padding row 0, Glorot-uniform weights, zero biases
    and item bias. ``rng`` is a CPU generator; ``jax.random`` streams cannot
    be replayed, so parity with JAX runs through :func:`from_jax_params`."""
    def glorot(shape):
        limit = float(np.sqrt(6.0 / (shape[0] + shape[-1])))
        return (torch.rand(shape, generator=rng) * 2 - 1) * limit

    params = {
        "user_embed": 0.1 * torch.randn((n_users + 1, embed_dim), generator=rng),
        "item_embed": 0.1 * torch.randn((n_items + 1, embed_dim), generator=rng),
        "user_w1": glorot((embed_dim, hidden_dim)),
        "user_b1": torch.zeros(hidden_dim),
        "user_w2": glorot((hidden_dim, embed_dim)),
        "user_b2": torch.zeros(embed_dim),
        "item_w1": glorot((embed_dim + N_GENRES, hidden_dim)),
        "item_b1": torch.zeros(hidden_dim),
        "item_w2": glorot((hidden_dim, embed_dim)),
        "item_b2": torch.zeros(embed_dim),
        "item_bias": torch.zeros(n_items + 1),
    }
    params["user_embed"][0] = 0.0
    params["item_embed"][0] = 0.0
    device = resolve_device(device)
    return {k: v.to(device) for k, v in params.items()}


def user_tower_from_embed(params: Params, emb: torch.Tensor,
                          dropout_rate: float = 0.0,
                          rng: Optional[torch.Generator] = None,
                          compute_dtype=None) -> torch.Tensor:
    """MLP head over gathered user embedding rows → (B, D) normalised."""
    return l2_normalize(_mlp(emb, params["user_w1"], params["user_b1"],
                             params["user_w2"], params["user_b2"],
                             dropout_rate, rng, compute_dtype))


def item_tower_from_embed(params: Params, emb: torch.Tensor,
                          genre_vecs: torch.Tensor, dropout_rate: float = 0.0,
                          rng: Optional[torch.Generator] = None,
                          compute_dtype=None) -> torch.Tensor:
    """MLP head over gathered item embedding rows ⊕ genre vector."""
    x = torch.cat([emb, genre_vecs.to(emb.dtype)], dim=-1)
    return l2_normalize(_mlp(x, params["item_w1"], params["item_b1"],
                             params["item_w2"], params["item_b2"],
                             dropout_rate, rng, compute_dtype))


def user_tower(params: Params, user_ids: torch.Tensor,
               dropout_rate: float = 0.0, rng: Optional[torch.Generator] = None,
               compute_dtype=None) -> torch.Tensor:
    """(B,) int ids → (B, D) L2-normalised user embeddings (differentiable;
    the gather's gradient is dense, as JAX's is)."""
    emb = params["user_embed"][user_ids.long()]
    return user_tower_from_embed(params, emb, dropout_rate, rng, compute_dtype)


def item_tower(params: Params, item_ids: torch.Tensor, genre_vecs: torch.Tensor,
               dropout_rate: float = 0.0, rng: Optional[torch.Generator] = None,
               compute_dtype=None) -> torch.Tensor:
    """(B,) int ids + (B, 18) genre multi-hot → (B, D) normalised."""
    emb = params["item_embed"][item_ids.long()]
    return item_tower_from_embed(params, emb, genre_vecs, dropout_rate, rng,
                                 compute_dtype)


class TwoTower(nn.Module):
    """Both towers and the item bias, with the JAX parameter names."""

    def __init__(self, n_users: int, n_items: int, embed_dim: int = 64,
                 hidden_dim: int = 128, dropout: float = 0.2,
                 device=DEFAULT_DEVICE):
        super().__init__()
        device = resolve_device(device)
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
        self._item_embeddings: Optional[np.ndarray] = None
        self._item_ids: Optional[np.ndarray] = None

    @classmethod
    def from_numpy(cls, params: Dict[str, np.ndarray], n_users: int,
                   n_items: int, embed_dim: int = 64, hidden_dim: int = 128,
                   dropout: float = 0.2, device=DEFAULT_DEVICE) -> "TwoTower":
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

    # --- losses (JAX's parity surface) ---------------------------------- #

    @staticmethod
    def bpr_loss(user_emb: torch.Tensor, pos_item_emb: torch.Tensor,
                 neg_item_emb: torch.Tensor) -> torch.Tensor:
        return pairwise_bpr_loss(user_emb, pos_item_emb, neg_item_emb)

    @staticmethod
    def in_batch_bpr_loss(user_emb: torch.Tensor, item_emb: torch.Tensor) -> torch.Tensor:
        """:class:`~recommendit_tpu_torch.ops.bpr.InBatchBPR`: on CUDA
        tensors the forward and backward kernels."""
        return in_batch_bpr_loss(user_emb, item_emb)

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

    def get_user_embedding(self, user_id: int) -> np.ndarray:
        """One user's normalised embedding, (D,) float32; ids outside
        [0, n_users] raise ``ValueError``, as in JAX."""
        if not (0 <= user_id <= self.n_users):
            raise ValueError(f"user_id {user_id} out of range [0, {self.n_users}]")
        emb = self.user_tower(torch.as_tensor([user_id], device=self.device))
        return emb[0].cpu().numpy().astype(np.float32)

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

    def precompute_item_embeddings(self, item_ids: np.ndarray,
                                   genre_matrix: np.ndarray) -> np.ndarray:
        """Compute and keep the whole catalog's embeddings."""
        self._item_embeddings = self.get_item_embeddings(item_ids, genre_matrix)
        self._item_ids = np.asarray(item_ids)
        return self._item_embeddings

    def params(self) -> Params:
        """The parameters as a dict of detached tensors, by JAX name."""
        return {n: getattr(self, n).detach() for n in PARAM_NAMES}

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
    def load(cls, path: str, device=DEFAULT_DEVICE) -> "TwoTower":
        p = Path(path)
        if not p.exists():
            raise FileNotFoundError(f"Two-tower checkpoint not found: {p}")
        meta = json.loads(Path(str(p) + ".meta.json").read_text())
        with np.load(p) as data:
            params = {k: data[k] for k in data.files}
        return cls.from_numpy(params, device=device, **meta)


def from_jax_params(params: Mapping[str, np.ndarray], dropout: float = 0.2,
                    device=DEFAULT_DEVICE) -> TwoTower:
    """The JAX package's two-tower params (numpy arrays, JAX names) as a
    :class:`TwoTower`; the sizes are read from the shapes. The trainer takes
    the result as its initial state (``EmbeddingTrainer.train(init_params=)``),
    so the JAX trainer and the port can start from identical weights."""
    n_users = params["user_embed"].shape[0] - 1
    n_items = params["item_embed"].shape[0] - 1
    embed_dim, hidden_dim = params["user_w1"].shape
    return TwoTower.from_numpy({k: np.asarray(v) for k, v in params.items()},
                               n_users, n_items, embed_dim, hidden_dim,
                               dropout, device)


def dense_from_jax_params(params: Mapping[str, np.ndarray],
                          device=DEFAULT_DEVICE) -> Params:
    """A host-table run's dense params from the JAX package's (numpy arrays,
    JAX names; ``host_train._init_dense``: the MLP heads, and ``item_bias``
    in softmax mode) as f32 tensors; the two tables, where present, are
    dropped (they live on the host). ``HostTableEmbeddingTrainer.train``
    takes the result as ``init_dense``."""
    device = resolve_device(device)
    return {k: torch.tensor(np.asarray(v, np.float32), device=device)
            for k, v in params.items() if k not in TABLE_NAMES}
