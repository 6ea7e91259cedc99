"""Joint two-stage CTR training (BASELINE config #5) — torch port.

Counterpart of ``recommendit_tpu/training/train_ctr.py``: trains the
DLRM-shaped CTR model (``models/ctr.py``) on the synthetic Criteo-style
impression log, optionally jointly with the retrieval towers that share
its stacked embedding table:

    loss = BCE(click logits)  +  λ · click-weighted in-batch softmax

Two table modes (``CTR_TABLE_UPDATE``), as in JAX:

* ``"sparse"`` (the default): the gradient stops at the gathered rows; the
  dense params take clipping and AdamW, the table row-wise adagrad at the
  constant ``CTR_TABLE_LR`` (``ops/sparse_embed.py``) with no schedule, no
  clipping and no weight decay (C.51). ``COMPUTE_DTYPE`` is not read (JAX's
  sparse epoch never passes it);
* ``"dense"``: autodiff through the gather; clipping and AdamW over every
  param, the table's (rows, D) gradient included; ``COMPUTE_DTYPE=bfloat16``
  casts as ``models/ctr.py`` says.

The step follows JAX's: the cosine schedule over ``epochs × n_batches``
(``train_embeddings.cosine_lr``), ``optax.clip_by_global_norm`` then
``optax.adamw`` with weight decay on every param it updates
(``clip_factors`` handed to ``OptaxAdamW.step``), a zero gradient for a param the
loss does not reach (the towers in plain mode), the batches from the same
numpy generator (permutation, remainder dropped). JAX scans an epoch in one
jitted call; here a Python loop keeps the per-step losses on the device and
reads their mean once an epoch, so no step waits for the host. Matmuls run
in full f32 (``ops/topk.full_f32_matmul``).

DLRM-DCNv2 (``models/ctr.py``'s :class:`CTRArch`, :data:`DLRM_DCNV2`) trains by
its published recipe, :func:`dcn_step` on a :class:`DCNState`, on device
batches (no ``CTRDataset``): Adagrad everywhere at a constant rate
(:class:`AdagradRecipe`: lr 0.005, eps 1e-8, accumulators from 0, no weight
decay, clipping, warm-up or decay), as torchrec maps ``torch.optim.Adagrad``:
the dense params by :func:`adagrad_` (torch's Adagrad, its foreach ops), the
table by FBGEMM's exact sparse Adagrad on the rows the step touches
(``ops/embedding_bag.bag_adagrad_``: the pooled gradient's rows summed per
distinct id, one accumulator an element). The gradient stops at the pooled
bags, so no table-shaped gradient exists.
"""
from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from recommendit_tpu_torch.config import Settings, settings as default_settings
from recommendit_tpu_torch.data.ctr import CTRDataset
from recommendit_tpu_torch.evaluation.metrics import binary_auc, binary_logloss
from recommendit_tpu_torch.models.ctr import (
    CTRArch,
    CTRModel,
    bce_loss,
    bce_with_logits,
    ctr_forward_from_embed,
    dcn_forward_from_pooled,
    embed_fields,
    item_tower_ctr,
    pool_fields,
    user_tower_ctr,
    weighted_in_batch_softmax,
)
from recommendit_tpu_torch.ops.embedding_bag import bag_adagrad_
from recommendit_tpu_torch.ops.sparse_embed import (
    sparse_adagrad_init,
    sparse_table_update,
)
from recommendit_tpu_torch.ops.topk import fast_topk, full_f32_matmul
from recommendit_tpu_torch.training.train_embeddings import (
    OptaxAdamW,
    clip_factors,
    cosine_lr,
    global_norm,
)
from recommendit_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device
from recommendit_tpu_torch.utils.profiling import span

logger = logging.getLogger(__name__)


class CTRState:
    """What a CTR training run carries from step to step: the params (the
    model's own tensors, updated in place), the AdamW state over the dense
    params (or all, in dense mode), the table's adagrad accumulator (sparse
    mode); the AdamW step count is the schedule's update count."""

    def __init__(self, params: Dict[str, torch.Tensor], sparse: bool,
                 weight_decay: float):
        self.params = params
        self.sparse = sparse
        self.train = [p.requires_grad_(True) for k, p in params.items()
                      if not (sparse and k == "embed")]
        self.opt = OptaxAdamW(self.train, [True] * len(self.train), weight_decay)
        self.accum = (sparse_adagrad_init(params["embed"].shape[0],
                                          params["embed"].device)
                      if sparse else None)


class CTRTrainer:
    """Trains :class:`CTRModel` on a :class:`CTRDataset`."""

    def __init__(
        self,
        data: CTRDataset,
        cfg: Optional[Settings] = None,
        joint: Optional[bool] = None,
        test_frac: float = 0.1,
        model_output_path: Optional[str] = None,
        device=DEFAULT_DEVICE,
    ):
        self.cfg = cfg or default_settings
        self.device = resolve_device(device)
        self.joint = self.cfg.CTR_JOINT if joint is None else joint
        self.model_output_path = model_output_path
        self.train_data, self.test_data = data.split(test_frac)
        self.data = data
        self.model = CTRModel(
            vocab_sizes=data.vocab_sizes,
            embed_dim=self.cfg.CTR_EMBED_DIM,
            retrieval_dim=self.cfg.CTR_RETRIEVAL_DIM,
            top_hidden=self.cfg.CTR_TOP_HIDDEN,
            n_user_fields=data.n_user_fields,
            seed=self.cfg.SEED,
            device=self.device,
        )
        # checked once here (C.50), so no step reads an id back
        self._train_ids = self.model.stack_ids(self.train_data.sparse)
        self.history: List[Dict] = []
        logger.info(
            "CTRTrainer: %d train / %d test impressions, CTR=%.3f, joint=%s",
            len(self.train_data.labels), len(self.test_data.labels),
            float(data.labels.mean()), self.joint,
        )

    # ------------------------------------------------------------------ #

    def _log_q(self) -> np.ndarray:
        """(n_items,) log empirical impression probability per item (logQ
        correction for the in-batch softmax; items enter batches by
        popularity)."""
        counts = np.bincount(self.train_data.item_ids,
                             minlength=self.data.n_items)
        p = counts / max(1, counts.sum())
        return np.log(np.maximum(p, 1e-12)).astype(np.float32)

    def batch_size(self) -> int:
        """``CTR_BATCH_SIZE`` clamped to the train split as JAX clamps it:
        with n_train < 8 the floor of 8 would take more rows than exist."""
        n_train = len(self.train_data.labels)
        return max(1, min(self.cfg.CTR_BATCH_SIZE, max(8, n_train // 2), n_train))

    def epoch_batches(self, rng: np.random.Generator, batch_size: int):
        """One epoch's (dense, ids, labels, item_ids) on the device, each
        (n_batches, B, ...): the generator's permutation of the train split,
        the remainder dropped."""
        d = self.train_data
        n = len(d.labels)
        perm = rng.permutation(n)
        n_batches = max(1, n // batch_size)
        idx = perm[:n_batches * batch_size].reshape(n_batches, batch_size)
        dense, ids, labels, items = (torch.as_tensor(a[idx], device=self.device)
                                     for a in (d.dense, self._train_ids, d.labels,
                                               d.item_ids))
        return dense, ids.long(), labels, items.long()

    def start(self, init_params: Optional[Mapping[str, object]] = None) -> CTRState:
        """The train state at step 0: the model's params (``init_params``,
        e.g. ``models.ctr.from_jax_params`` of JAX's ``init_ctr_params``,
        copied onto the device, or the model's own seeded init), fresh
        AdamW moments and, in sparse mode, a zero accumulator."""
        cfg = self.cfg
        if init_params is not None:
            want = {k: tuple(v.shape) for k, v in self.model.params.items()}
            got = {k: tuple(v.shape) for k, v in init_params.items()}
            if got != want:
                raise ValueError(f"init_params shapes {got}, expected {want}")
            self.model.params = {
                k: torch.as_tensor(v).to(self.device, torch.float32, copy=True)
                for k, v in init_params.items()}
        sparse = cfg.CTR_TABLE_UPDATE == "sparse"
        if not sparse and cfg.CTR_TABLE_UPDATE != "dense":
            raise ValueError(f"unknown CTR_TABLE_UPDATE {cfg.CTR_TABLE_UPDATE!r} "
                             "(sparse | dense)")
        self._log_q_table = torch.as_tensor(self._log_q(), device=self.device)
        return CTRState(self.model.params, sparse, cfg.WEIGHT_DECAY)

    def _loss(self, params, rows, batch, cdt):
        """The loss from gathered rows: JAX's ``loss_from_rows`` (sparse
        mode) or, with the table among ``params``, its ``loss_fn``."""
        cfg = self.cfg
        dense, _, labels, item_ids = batch
        nu = self.data.n_user_fields
        if not self.joint:
            return bce_loss(ctr_forward_from_embed(params, dense, rows,
                                                   compute_dtype=cdt), labels)
        ue = user_tower_ctr(params, rows[:, :nu])
        ie = item_tower_ctr(params, rows[:, nu:])
        sim = (ue * ie).sum(dim=-1)
        logits = ctr_forward_from_embed(params, dense, rows, sim, cdt)
        ret = weighted_in_batch_softmax(
            ue, ie, labels, self._log_q_table[item_ids],
            cfg.CTR_SOFTMAX_TEMPERATURE)
        return bce_loss(logits, labels) + cfg.CTR_RETRIEVAL_WEIGHT * ret

    def step(self, state: CTRState, batch, decay_steps: int) -> torch.Tensor:
        """One update of ``state`` from ``batch`` (one row of
        :meth:`epoch_batches`); returns the loss, on the device."""
        cfg = self.cfg
        ids = batch[1]
        with full_f32_matmul():
            if state.sparse:
                rows = embed_fields(state.params, ids).detach().requires_grad_(True)
                loss = self._loss(state.params, rows, batch, None)
                wrt = state.train + [rows]
            else:
                cdt = torch.bfloat16 if cfg.COMPUTE_DTYPE == "bfloat16" else None
                rows = embed_fields(state.params, ids, cdt)
                loss = self._loss(state.params, rows, batch, cdt)
                wrt = state.train
            grads = torch.autograd.grad(loss, wrt, allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g
                     for p, g in zip(wrt, grads)]
            with span("ctr::adamw"):
                dense_grads = grads[:len(state.train)]
                state.opt.step(dense_grads, cosine_lr(cfg.CTR_LEARNING_RATE,
                                                      state.opt.count, decay_steps),
                               clip=clip_factors(global_norm(dense_grads),
                                                 cfg.GRAD_CLIP_NORM))
            if state.sparse:
                with span("ctr::sparse_update"):
                    sparse_table_update(
                        state.params["embed"], state.accum, ids, grads[-1],
                        self.model.vocab_sizes, lr=cfg.CTR_TABLE_LR,
                        small_threshold=cfg.CTR_SMALL_VOCAB_THRESHOLD)
        return loss.detach()

    # ------------------------------------------------------------------ #

    def train(self, epochs: Optional[int] = None,
              init_params: Optional[Mapping[str, object]] = None) -> CTRModel:
        """Train from ``init_params`` (see :meth:`start`) for ``epochs``
        (default ``CTR_EPOCHS``); saves to ``model_output_path`` if set."""
        cfg = self.cfg
        epochs = epochs or cfg.CTR_EPOCHS
        batch_size = self.batch_size()
        n_batches = max(1, len(self.train_data.labels) // batch_size)
        decay_steps = max(1, epochs * n_batches)
        state = self.start(init_params)
        host_rng = np.random.default_rng(cfg.SEED)

        t0 = time.time()
        total = 0
        for epoch in range(1, epochs + 1):
            te = time.time()
            batches = self.epoch_batches(host_rng, batch_size)
            losses = [self.step(state, [b[s] for b in batches], decay_steps)
                      for s in range(batches[0].shape[0])]
            loss = float(torch.stack(losses).mean())
            dt = time.time() - te
            n_ex = batches[2].numel()
            total += n_ex
            self.history.append({"epoch": epoch, "loss": loss, "seconds": dt,
                                 "examples_per_s": n_ex / dt})
            logger.info("ctr epoch %d/%d | loss %.4f | %.2fs | %.0f ex/s",
                        epoch, epochs, loss, dt, n_ex / dt)
        self.examples_per_s = total / (time.time() - t0)
        if self.model_output_path:
            self.model.save(self.model_output_path)
        return self.model

    # ------------------------------------------------------------------ #

    def evaluate(self, recall_ks: Tuple[int, ...] = (10, 50)) -> Dict[str, float]:
        """Held-out CTR quality (AUC, logloss) and — in joint mode — full
        catalog retrieval Recall@K of the true item for clicked test
        impressions (exact top-k of the f32 scores)."""
        d = self.test_data
        probs = self.model.predict_proba(d.dense, d.sparse, joint=self.joint)
        out = {
            "auc": binary_auc(d.labels, probs),
            "logloss": binary_logloss(d.labels, probs),
            "ctr": float(d.labels.mean()),
        }
        if self.joint:
            corpus = self.model.item_corpus_embeddings(self.data.item_field_values)
            clicked = d.labels > 0.5
            users = d.user_ids[clicked]
            true_items = d.item_ids[clicked]
            queries = self.model.user_query_embeddings(
                self.data.user_field_values[users])
            kmax = max(recall_ks)
            with torch.no_grad(), full_f32_matmul():
                q = torch.as_tensor(queries, device=self.device)
                c = torch.as_tensor(corpus, device=self.device)
                _, top_idx = fast_topk(q @ c.T, kmax)
            top_idx = top_idx.cpu().numpy()
            for k in recall_ks:
                hits = (top_idx[:, :k] == true_items[:, None]).any(axis=1)
                out[f"recall@{k}"] = float(hits.mean())
        return out


# --- DLRM-DCNv2: the published recipe ------------------------------------- #

@dataclass(frozen=True)
class AdagradRecipe:
    """The DLRM-DCNv2 run line's optimizer: Adagrad on every param at a
    constant ``lr``, ``eps`` beside the root, accumulators from 0."""
    lr: float = 0.005
    eps: float = 1e-8


@torch.no_grad()
def adagrad_(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
             accs: Sequence[torch.Tensor], lr: float, eps: float) -> None:
    """``torch.optim.Adagrad``'s step with no lr decay and no weight decay,
    in place: ``acc += g²; p -= lr · (g / (√acc + eps))``, each operation
    rounded once, as ``bag_adagrad_`` rounds the table's."""
    params, grads, accs = list(params), list(grads), list(accs)
    torch._foreach_add_(accs, torch._foreach_mul(grads, grads))
    den = torch._foreach_sqrt(accs)
    torch._foreach_add_(den, eps)
    upd = torch._foreach_div(grads, den)
    torch._foreach_mul_(upd, lr)
    torch._foreach_sub_(params, upd)


class DCNState:
    """A DLRM-DCNv2 run's state: the params (the caller's tensors, updated
    in place; ``embed`` the stacked table), an Adagrad accumulator beside
    each, and ``rows_updated``, the table rows updated so far, counted on
    the device (read it only where the host may wait)."""

    def __init__(self, params: Dict[str, torch.Tensor], arch: CTRArch,
                 recipe: AdagradRecipe = AdagradRecipe()):
        self.arch, self.recipe, self.layout = arch, recipe, arch.layout
        self.params = params
        self.table = params["embed"]
        if tuple(self.table.shape) != (self.layout.rows, arch.embed_dim):
            raise ValueError(f"a table of {tuple(self.table.shape)} for "
                             f"{self.layout.rows} rows of {arch.embed_dim}")
        self.dense = [p.requires_grad_(True) for k, p in params.items() if k != "embed"]
        self.dense_acc = [torch.zeros_like(p) for p in self.dense]
        self.table_acc = torch.zeros_like(self.table)
        self.rows_updated = torch.zeros((), dtype=torch.int64, device=self.table.device)


def dcn_step(state: DCNState, dense: torch.Tensor, ids: torch.Tensor, labels: torch.Tensor,
             keep: Optional[dict] = None) -> torch.Tensor:
    """One step of the published recipe on a device batch: (B, 13) dense
    features, (B, S) stacked row ids (int32 on the card), (B,) labels.
    Returns the loss, on the device; nothing waits for the host. ``keep``,
    where given, receives the dense params' gradients (``"dense_grads"``)."""
    r = state.recipe
    with full_f32_matmul():
        pooled = pool_fields(state.params, ids, state.layout).requires_grad_(True)
        logits = dcn_forward_from_pooled(state.params, state.arch, dense, pooled)
        loss = bce_with_logits(logits, labels)
        grads = torch.autograd.grad(loss, state.dense + [pooled])
        if keep is not None:
            keep["dense_grads"] = grads[:-1]
        with span("ctr::adagrad"):
            adagrad_(state.dense, grads[:-1], state.dense_acc, r.lr, r.eps)
        with span("ctr::sparse_update"):
            bag_adagrad_(state.table, state.table_acc, ids, grads[-1], state.layout, r.lr,
                         r.eps, counter=state.rows_updated)
    return loss.detach()
