"""Criteo-style CTR model — DLRM-shaped, with joint retrieval towers — torch
port.

Counterpart of ``recommendit_tpu/models/ctr.py`` (BASELINE config #5).
All 26 categorical fields share ONE stacked embedding table addressed by
static per-field offsets, so the sparse side is a single (B·26)-row
gather. The dense features go through a bottom MLP to one more D-vector;
the pairwise dots of the 27 vectors (one batched product, its strictly
upper triangle taken by a static index, 351 values) feed the top MLP.
Joint two-stage: the same table feeds two retrieval towers (mean-pooled
user-field and item-field embeddings → MLP → L2-normalise), whose dot is
an explicit top-MLP feature, trained in one optimisation with
loss = BCE(click) + λ · click-weighted in-batch softmax.

The functions take a dict of tensors under JAX's names (``embed``,
``bot_w1`` …, ``ut_*``, ``it_*``, ``top_w{i}``) in JAX's (in, out)
layouts and are differentiable. Where JAX's gradient at a tie differs
from torch's own, the port computes JAX's (ROADMAP C.49): the ReLUs are
``torch.maximum(x, 0)``, whose gradient at 0 is ½ as ``jnp.maximum``'s
is (``torch.relu``'s is 0), and ``bce_loss`` takes ``|x|`` as
``where(x >= 0, x, −x)``, whose gradient at 0 is 1 as ``jnp.abs``'s is
(``torch.abs``'s is 0). So at a logit of exactly 0 the BCE gradient is
−y, as in JAX, not σ(0) − y.

f32 products run in full f32 on the card: every entry point and the
trainer's step run inside ``ops/topk.full_f32_matmul`` (TF32 off, whatever
the caller set; the flag is a process-wide switch). ``compute_dtype``
(bf16) casts where JAX casts: the bottom MLP, the interaction operands
(their products summed in f32) and each top-MLP layer, whose output is
rounded to bf16 and carried in f32; the towers stay f32.

:class:`CTRModel` holds the params on an explicit device and reads and
writes JAX's ``.npz`` + ``.meta.json`` files. Its own init draws JAX's
distributions (normal × 0.05 for ``embed``, Glorot-uniform weights, zero
biases) from a ``torch.Generator`` seeded with ``seed``; ``jax.random``
streams cannot be replayed, so parity with JAX starts from JAX's params
(:func:`from_jax_params`).
"""
from __future__ import annotations

import functools
import json
from pathlib import Path
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from recommendit_tpu_torch.data.ctr import N_DENSE, N_SPARSE, N_USER_FIELDS
from recommendit_tpu_torch.ops.topk import full_f32_matmul
from recommendit_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device
from recommendit_tpu_torch.utils.profiling import span

Params = Dict[str, torch.Tensor]


def field_offsets(vocab_sizes: Sequence[int]) -> np.ndarray:
    """Static per-field base offsets into the stacked embedding table."""
    return np.concatenate([[0], np.cumsum(vocab_sizes)[:-1]]).astype(np.int32)


def total_vocab(vocab_sizes: Sequence[int]) -> int:
    return int(np.sum(vocab_sizes))


def _interaction_indices(n_vectors: int) -> Tuple[np.ndarray, np.ndarray]:
    """Static (row, col) indices of the strictly-upper triangle."""
    iu, ig = np.triu_indices(n_vectors, k=1)
    return iu.astype(np.int32), ig.astype(np.int32)


@functools.lru_cache(maxsize=8)
def _triu_flat(n_vectors: int, device: torch.device) -> torch.Tensor:
    """The strictly-upper triangle's positions in a flattened (n, n) block,
    on ``device`` (made once, so a step copies nothing from the host)."""
    iu, ig = _interaction_indices(n_vectors)
    return torch.as_tensor(iu.astype(np.int64) * n_vectors + ig, device=device)


def init_ctr_params(
    rng: torch.Generator,
    vocab_sizes: Sequence[int],
    embed_dim: int = 16,
    bottom_hidden: int = 64,
    top_hidden: Tuple[int, ...] = (256, 128),
    retrieval_dim: int = 32,
    n_dense: int = N_DENSE,
    n_sparse: int = N_SPARSE,
    pad_rows_to: int = 1,
    device=DEFAULT_DEVICE,
) -> Params:
    """The DLRM + tower params with JAX's initialisers, drawn on the host
    from ``rng`` (a CPU generator) and moved to ``device``.

    ``pad_rows_to``: round the stacked table's row count up to a multiple.
    """
    def glorot(shape):
        limit = float(np.sqrt(6.0 / (shape[0] + shape[-1])))
        return (torch.rand(shape, generator=rng) * 2 - 1) * limit

    rows = total_vocab(vocab_sizes)
    rows = rows + ((-rows) % pad_rows_to)
    n_inter = (n_sparse + 1) * n_sparse // 2  # F+1 vectors incl. dense
    top_in = embed_dim + n_inter
    r = retrieval_dim
    params = {
        "embed": 0.05 * torch.randn((rows, embed_dim), generator=rng),
        "bot_w1": glorot((n_dense, bottom_hidden)),
        "bot_b1": torch.zeros(bottom_hidden),
        "bot_w2": glorot((bottom_hidden, embed_dim)),
        "bot_b2": torch.zeros(embed_dim),
        "ut_w1": glorot((embed_dim, 2 * r)),
        "ut_b1": torch.zeros(2 * r),
        "ut_w2": glorot((2 * r, r)),
        "ut_b2": torch.zeros(r),
        "it_w1": glorot((embed_dim, 2 * r)),
        "it_b1": torch.zeros(2 * r),
        "it_w2": glorot((2 * r, r)),
        "it_b2": torch.zeros(r),
    }
    # top MLP: (D + n_inter + 1 joint similarity) -> hidden... -> 1
    dims = (top_in + 1,) + tuple(top_hidden) + (1,)
    for li in range(len(dims) - 1):
        params[f"top_w{li + 1}"] = glorot((dims[li], dims[li + 1]))
        params[f"top_b{li + 1}"] = torch.zeros(dims[li + 1])
    device = resolve_device(device)
    return {k: v.to(device) for k, v in params.items()}


def from_jax_params(params: Mapping[str, np.ndarray], device=DEFAULT_DEVICE) -> Params:
    """The JAX package's CTR params (numpy arrays, JAX names and layouts) as
    f32 tensors on ``device``: ``CTRModel(params=…)`` and
    ``CTRTrainer.train(init_params=…)`` take the result, so the two
    packages can start from identical weights."""
    device = resolve_device(device)
    return {k: torch.tensor(np.asarray(v, np.float32), device=device)
            for k, v in params.items()}


def _n_top_layers(params: Params) -> int:
    n = 0
    while f"top_w{n + 1}" in params:
        n += 1
    return n


def _relu(x: torch.Tensor) -> torch.Tensor:
    """``jnp.maximum(x, 0.0)``: gradient ½ at 0 (C.49)."""
    return torch.maximum(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _mlp2(x, w1, b1, w2, b2):
    h = _relu(x @ w1 + b1)
    return h @ w2 + b2


def _l2norm(x, eps=1e-12):
    return x * torch.rsqrt((x * x).sum(dim=-1, keepdim=True) + eps)


def embed_fields(params: Params, stacked_ids: torch.Tensor,
                 compute_dtype=None) -> torch.Tensor:
    """(B, F) globally-offset ids -> (B, F, D) embedding rows, one gather."""
    with span("ctr::gather"):
        b, f = stacked_ids.shape
        emb = params["embed"].index_select(0, stacked_ids.reshape(-1).long())
        emb = emb.reshape(b, f, -1)
        if compute_dtype is not None:
            emb = emb.to(compute_dtype)
        return emb


def _tower(params: Params, field_emb: torch.Tensor, side: str) -> torch.Tensor:
    with span("ctr::towers"):
        pooled = field_emb.mean(dim=1).float()
        out = _mlp2(pooled, params[f"{side}_w1"], params[f"{side}_b1"],
                    params[f"{side}_w2"], params[f"{side}_b2"])
        return _l2norm(out)


def user_tower_ctr(params: Params, field_emb: torch.Tensor) -> torch.Tensor:
    """(B, U, D) user-field embeddings -> (B, R) L2-normalized query."""
    return _tower(params, field_emb, "ut")


def item_tower_ctr(params: Params, field_emb: torch.Tensor) -> torch.Tensor:
    """(B, I, D) item-field embeddings -> (B, R) L2-normalized corpus vec."""
    return _tower(params, field_emb, "it")


def ctr_forward_from_embed(
    params: Params,
    dense: torch.Tensor,
    field_emb: torch.Tensor,
    similarity: Optional[torch.Tensor] = None,
    compute_dtype=None,
) -> torch.Tensor:
    """DLRM forward given pre-gathered field embeddings.

    dense: (B, 13); field_emb: (B, 26, D); similarity: optional (B,) tower
    dot product fed as an explicit top-MLP feature. Returns (B,) logits.
    """
    cdt = compute_dtype or torch.float32
    with span("ctr::mlp"):
        d = _mlp2(dense.to(cdt),
                  params["bot_w1"].to(cdt), params["bot_b1"].to(cdt),
                  params["bot_w2"].to(cdt), params["bot_b2"].to(cdt))  # (B, D)
    with span("ctr::interaction"):
        z = torch.cat([d[:, None, :], field_emb.to(cdt)], dim=1).float()
        # products of bf16 operands are exact in f32: JAX's bf16 einsum
        # with f32 accumulation
        s = torch.bmm(z, z.transpose(1, 2))  # (B, F+1, F+1)
        n = z.shape[1]
        inter = s.reshape(s.shape[0], n * n).index_select(
            1, _triu_flat(n, s.device))  # (B, n_inter) static gather
        sim = (torch.zeros(dense.shape[0], dtype=torch.float32, device=dense.device)
               if similarity is None else similarity.float())
        x = torch.cat([d.float(), inter, sim[:, None]], dim=1)
    with span("ctr::mlp"):
        n_layers = _n_top_layers(params)
        for li in range(1, n_layers + 1):
            w = params[f"top_w{li}"].to(cdt)
            b = params[f"top_b{li}"].to(cdt)
            x = x.to(cdt) @ w + b
            if li < n_layers:
                x = _relu(x)
            x = x.float()
        return x[:, 0]


def ctr_forward(
    params: Params,
    dense: torch.Tensor,
    stacked_ids: torch.Tensor,
    joint: bool = False,
    compute_dtype=None,
    n_user_fields: int = N_USER_FIELDS,
):
    """Full forward from globally-offset sparse ids.

    joint=False -> (B,) CTR logits (similarity feature = 0).
    joint=True  -> (logits, user_emb, item_emb): the towers' similarity is
    wired into the top MLP, so ranking and retrieval co-train end-to-end.
    """
    emb = embed_fields(params, stacked_ids, compute_dtype)
    if not joint:
        return ctr_forward_from_embed(params, dense, emb, compute_dtype=compute_dtype)
    ue = user_tower_ctr(params, emb[:, :n_user_fields])
    ie = item_tower_ctr(params, emb[:, n_user_fields:])
    sim = (ue * ie).sum(dim=-1)
    logits = ctr_forward_from_embed(params, dense, emb, sim, compute_dtype)
    return logits, ue, ie


def bce_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean sigmoid binary cross-entropy (the Criteo objective), with
    JAX's gradients at a logit of 0 (C.49)."""
    with span("ctr::loss"):
        abs_logits = torch.where(logits >= 0, logits, -logits)
        return (_relu(logits) - logits * labels
                + torch.log1p(torch.exp(-abs_logits))).mean()


def weighted_in_batch_softmax(
    user_emb: torch.Tensor,
    item_emb: torch.Tensor,
    weights: torch.Tensor,
    log_q: Optional[torch.Tensor] = None,
    temperature: float = 0.1,
) -> torch.Tensor:
    """In-batch sampled softmax where only weighted rows (clicks) are
    positives; non-clicked impressions still serve as negatives for other
    rows. logQ-corrected as ``ops/bpr.in_batch_softmax_loss`` is."""
    with span("ctr::softmax"):
        scores = (user_emb @ item_emb.T) / temperature
        if log_q is not None:
            scores = scores - log_q[None, :]
        diag = torch.log_softmax(scores, dim=1).diagonal()
        denom = torch.clamp(weights.sum(), min=1.0)
        return -(weights * diag).sum() / denom


class CTRModel:
    """Params + vocab metadata + persistence on one device (the counterpart
    of JAX's host-side ``CTRModel``)."""

    def __init__(
        self,
        vocab_sizes: Sequence[int],
        embed_dim: int = 16,
        retrieval_dim: int = 32,
        top_hidden: Tuple[int, ...] = (256, 128),
        n_user_fields: int = N_USER_FIELDS,
        params: Optional[Mapping[str, object]] = None,
        seed: int = 0,
        pad_rows_to: int = 1,
        device=DEFAULT_DEVICE,
    ):
        self.device = resolve_device(device)
        self.vocab_sizes = tuple(int(v) for v in vocab_sizes)
        self.embed_dim = embed_dim
        self.retrieval_dim = retrieval_dim
        self.top_hidden = tuple(top_hidden)
        self.n_user_fields = n_user_fields
        self.offsets = field_offsets(self.vocab_sizes)
        if params is None:
            self.params = init_ctr_params(
                torch.Generator().manual_seed(seed), self.vocab_sizes, embed_dim,
                top_hidden=self.top_hidden, retrieval_dim=retrieval_dim,
                pad_rows_to=pad_rows_to, device=self.device)
        else:
            self.params = {k: torch.as_tensor(v).to(self.device, torch.float32)
                           for k, v in params.items()}

    def stack_ids(self, sparse: np.ndarray, fields: slice = slice(None)) -> np.ndarray:
        """Field-local (N, F) ids of ``fields`` (all 26 by default) ->
        globally-offset ids for the table. Raises ValueError for an id
        outside its field's vocabulary (C.50: JAX's gather would read NaN
        and its update drop it)."""
        sparse = np.asarray(sparse)
        vocab = np.asarray(self.vocab_sizes)[fields]
        bad = (sparse < 0) | (sparse >= vocab[None, :])
        if bad.any():
            row, field = np.argwhere(bad)[0]
            raise ValueError(
                f"sparse id {int(sparse[row, field])} at row {row}, field {field} "
                f"is outside its vocabulary of {int(vocab[field])}")
        return (sparse.astype(np.int64) + self.offsets[fields][None, :]).astype(np.int32)

    def _batches(self, fn, arrays, batch_size: int):
        """``fn`` over row batches of ``arrays`` on the device, in full f32,
        the outputs concatenated on the host."""
        out = []
        n = len(arrays[0])
        with torch.no_grad(), full_f32_matmul():
            for s in range(0, n, batch_size):
                args = [torch.as_tensor(a[s:s + batch_size], device=self.device)
                        for a in arrays]
                out.append(fn(*args).cpu().numpy())
        return out

    def predict_proba(self, dense: np.ndarray, sparse: np.ndarray,
                      batch_size: int = 16384, joint: bool = False) -> np.ndarray:
        """Batched click probabilities."""
        def fn(d, s):
            r = ctr_forward(self.params, d, s, joint=joint,
                            n_user_fields=self.n_user_fields)
            return torch.sigmoid(r[0] if joint else r)

        out = self._batches(fn, (np.asarray(dense, np.float32),
                                 self.stack_ids(sparse)), batch_size)
        return np.concatenate(out) if out else np.zeros((0,), np.float32)

    def item_corpus_embeddings(self, item_field_values: np.ndarray,
                               batch_size: int = 16384) -> np.ndarray:
        """(n_items, 18) field-local catalog -> (n_items, R) tower corpus."""
        ids = self.stack_ids(item_field_values, slice(self.n_user_fields, None))
        out = self._batches(
            lambda s: item_tower_ctr(self.params, embed_fields(self.params, s)),
            (ids,), batch_size)
        return np.concatenate(out) if out else np.zeros((0, self.retrieval_dim))

    def user_query_embeddings(self, user_field_values: np.ndarray,
                              batch_size: int = 16384) -> np.ndarray:
        ids = self.stack_ids(user_field_values, slice(0, self.n_user_fields))
        out = self._batches(
            lambda s: user_tower_ctr(self.params, embed_fields(self.params, s)),
            (ids,), batch_size)
        return np.concatenate(out) if out else np.zeros((0, self.retrieval_dim))

    # --- persistence ---------------------------------------------------- #

    def save(self, path: str) -> None:
        """JAX's format: the params under their names in ``<path>.npz``
        ('.npz' appended when absent) and the sizes in ``.npz.meta.json``."""
        p = Path(path)
        if p.suffix != ".npz":
            p = Path(str(p) + ".npz")
        p.parent.mkdir(parents=True, exist_ok=True)
        np.savez(p, **{k: v.detach().cpu().numpy() for k, v in self.params.items()})
        meta = {
            "vocab_sizes": list(self.vocab_sizes),
            "embed_dim": self.embed_dim,
            "retrieval_dim": self.retrieval_dim,
            "top_hidden": list(self.top_hidden),
            "n_user_fields": self.n_user_fields,
        }
        Path(str(p) + ".meta.json").write_text(json.dumps(meta))

    @classmethod
    def load(cls, path: str, device=DEFAULT_DEVICE) -> "CTRModel":
        p = Path(path)
        if p.suffix != ".npz":
            p = Path(str(p) + ".npz")
        if not p.exists():
            raise FileNotFoundError(f"CTR checkpoint not found: {p}")
        meta = json.loads(Path(str(p) + ".meta.json").read_text())
        with np.load(p) as data:
            params = {k: data[k] for k in data.files}
        return cls(
            vocab_sizes=meta["vocab_sizes"],
            embed_dim=meta["embed_dim"],
            retrieval_dim=meta["retrieval_dim"],
            top_hidden=tuple(meta["top_hidden"]),
            n_user_fields=meta["n_user_fields"],
            params=params,
            device=device,
        )
