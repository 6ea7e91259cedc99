"""Two-tower training with host-resident (larger-than-HBM) embedding tables —
torch port.

Counterpart of ``recommendit_tpu/training/host_train.py``: the objectives of
:class:`~recommendit_tpu_torch.training.train_embeddings.EmbeddingTrainer`
(``softmax``, ``in_batch``, ``pairwise``; AdamW under a cosine schedule on
the MLP heads, the per-item bias in softmax mode), but the user and item
tables live on the host in :class:`HostEmbeddingTable` (RAM or a memmap)
and only the current batch's rows go to the card:

    host: gather rows for batch ids  ──►  device: towers fwd/bwd + dense update
    host: sparse adagrad row update  ◄──  device: d(loss)/d(rows), loss

With ``LOSS_MODE=in_batch`` the loss is ``ops/bpr.in_batch_bpr_loss``: the
in-batch BPR kernels (``csrc/bpr.cu``) on CUDA tensors, their twins on CPU
tensors (JAX gates its Pallas kernel on the TPU platform; the port on the
tensors' device, as ``train_embeddings.py`` does).

Per step the row grads come back to the host in one copy (which waits for
the device step) and are applied to the user table, then the item table;
in pairwise mode the positive and negative items in one call, so an item
in both accumulates once. With ``HOST_TABLE_PREFETCH`` > 0 a
:class:`PrefetchIterator` gathers and ships up to that many batches ahead
of the updates (bounded staleness, as in JAX); at 0 every gather sees every
earlier update (the parity tests run so).

Dropout masks come from one ``torch.Generator`` seeded with ``SEED + 1``,
drawn as ``EmbeddingTrainer`` draws them (JAX splits ``PRNGKey(SEED + 1 +
epoch)`` per step), so with dropout on, parity with JAX is statistical.
Each epoch's history holds the host-clock seconds of the step's parts:
``gather`` (host row gathers, in the prefetch thread when there is one),
``wait`` (the consumer waiting for a batch), ``step`` (enqueuing the
device step), ``d2h`` (the row grads' copy, which waits for the step) and
``apply_grad``.
"""
from __future__ import annotations

import logging
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from recommendit_tpu_torch.config import Settings, settings as default_settings
from recommendit_tpu_torch.data.movielens import MovieLensData
from recommendit_tpu_torch.models.two_tower import (
    PARAM_NAMES,
    TABLE_NAMES,
    TwoTower,
    init_params as fresh_params,
    item_tower_from_embed,
    user_tower_from_embed,
)
from recommendit_tpu_torch.ops.bpr import (
    in_batch_bpr_loss,
    in_batch_softmax_loss,
    pairwise_bpr_loss,
)
from recommendit_tpu_torch.ops.seen import SeenSet
from recommendit_tpu_torch.training.host_table import (
    DenseAdamW,
    HostEmbeddingTable,
    PrefetchIterator,
    make_host_offload_step,
    to_device,
)
from recommendit_tpu_torch.training.train_embeddings import (
    build_genre_table,
    cosine_lr,
    warm_start_item_bias,
)
from recommendit_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

logger = logging.getLogger(__name__)

STEP_PARTS = ("gather", "wait", "step", "d2h", "apply_grad")


class HostTableEmbeddingTrainer:
    """Trains the two-tower model with host-offloaded embedding tables; the
    pipeline selects it with ``Settings.HOST_TABLE``."""

    def __init__(self, data: MovieLensData, cfg: Optional[Settings] = None,
                 loss_mode: Optional[str] = None,
                 model_output_path: Optional[str] = None,
                 table_dir: Optional[str] = None, device=DEFAULT_DEVICE):
        self.cfg = cfg or default_settings
        cfg = self.cfg
        self.data = data
        self.loss_mode = loss_mode or cfg.LOSS_MODE
        if self.loss_mode not in ("in_batch", "softmax", "pairwise"):
            raise ValueError(f"unknown loss mode {self.loss_mode!r}")
        # None -> config default; '' -> saving disabled (a 100M-user model
        # write is ~50 GB)
        self.model_output_path = (cfg.EMBEDDING_MODEL_PATH if model_output_path is None
                                  else model_output_path)
        self.device = resolve_device(device)
        self.history: List[Dict] = []

        self.n_users = data.n_users
        self.n_items = data.n_items
        # rating >= 4 in the ratings' row order (a pandas boolean mask)
        pos = data.rating >= 4
        self.pos_users = data.user_id[pos].astype(np.int32)
        self.pos_items = data.item_id[pos].astype(np.int32)
        self.genre_table = build_genre_table(data.item_ids, data.genres, self.n_items)

        tdir = table_dir if table_dir is not None else (cfg.HOST_TABLE_DIR or None)
        upath = str(Path(tdir) / "user_table.npy") if tdir else None
        ipath = str(Path(tdir) / "item_table.npy") if tdir else None
        # init_scale 0.1 as init_params' 0.1·normal
        self.user_table = HostEmbeddingTable(
            self.n_users + 1, cfg.EMBEDDING_DIM, optimizer=cfg.HOST_TABLE_OPTIMIZER,
            lr=cfg.HOST_TABLE_LR, init_scale=0.1, seed=cfg.SEED, path=upath)
        self.item_table = HostEmbeddingTable(
            self.n_items + 1, cfg.EMBEDDING_DIM, optimizer=cfg.HOST_TABLE_OPTIMIZER,
            lr=cfg.HOST_TABLE_LR, init_scale=0.1, seed=cfg.SEED + 1, path=ipath)
        # padding row 0 is zero; batch ids are >= 1, so no update touches it
        self.user_table.table[0] = 0.0
        self.item_table.table[0] = 0.0

        if self.loss_mode == "pairwise":
            self._rated = SeenSet(data.user_id, data.item_id, self.n_items)
        self._log_q = self._log_q_table()
        self._gather_s = 0.0
        self._dense: Optional[Dict[str, torch.Tensor]] = None
        gb = (self.user_table.table.nbytes + self.item_table.table.nbytes) / 2**30
        logger.info("HostTableTrainer: %d positives, tables (%d+%d) x %d = %.2f GiB "
                    "host-side (%s), loss=%s, device=%s", len(self.pos_users),
                    self.n_users + 1, self.n_items + 1, cfg.EMBEDDING_DIM, gb,
                    "memmap" if tdir else "RAM", self.loss_mode, self.device)

    # ------------------------------------------------------------------ #

    def _log_q_table(self) -> np.ndarray:
        counts = np.bincount(self.pos_items, minlength=self.n_items + 1)
        p = counts / max(1, counts.sum())
        return np.log(np.maximum(p, 1e-12)).astype(np.float32)

    def dense_names(self) -> List[str]:
        """The dense params' names: the MLP heads, and ``item_bias`` only in
        softmax mode (the other losses do not read it; JAX keeps
        ``init_params``' (2,) bias there and writes a NaN bias column,
        ROADMAP C.46)."""
        return sorted(k for k in PARAM_NAMES if k not in TABLE_NAMES
                      and (k != "item_bias" or self.loss_mode == "softmax"))

    def _init_dense(self) -> Dict[str, torch.Tensor]:
        """Fresh dense params drawn from ``SEED`` (``jax.random`` streams
        cannot be replayed; parity runs carry JAX's across with
        ``models/two_tower.dense_from_jax_params``), the item bias
        warm-started."""
        cfg = self.cfg
        params = fresh_params(torch.Generator().manual_seed(cfg.SEED), 1, 1,
                              cfg.EMBEDDING_DIM, cfg.HIDDEN_DIM, device="cpu")
        params["item_bias"] = torch.from_numpy(
            warm_start_item_bias(self.pos_items, self.n_items))
        return {k: params[k] for k in self.dense_names()}

    def _loss_fn(self, gen: torch.Generator):
        cfg = self.cfg
        mode, rate = self.loss_mode, cfg.DROPOUT
        cdt = torch.bfloat16 if cfg.COMPUTE_DTYPE == "bfloat16" else None

        def loss_from_rows(dense, rows, batch):
            ue = user_tower_from_embed(dense, rows["u"], rate, gen, cdt)
            if mode == "pairwise":
                state = gen.get_state()
                ie = item_tower_from_embed(dense, rows["i"], batch["genre_i"], rate,
                                           gen, cdt)
                gen.set_state(state)  # the negatives' tower draws the same mask
                ne = item_tower_from_embed(dense, rows["n"], batch["genre_n"], rate,
                                           gen, cdt)
                return pairwise_bpr_loss(ue, ie, ne)
            ie = item_tower_from_embed(dense, rows["i"], batch["genre_i"], rate, gen, cdt)
            if mode == "softmax":
                return in_batch_softmax_loss(
                    ue, ie, batch["log_q"], cfg.SOFTMAX_TEMPERATURE,
                    item_bias=dense["item_bias"][batch["i_ids"].long()])
            return in_batch_bpr_loss(ue, ie, cfg.USE_PALLAS)

        return loss_from_rows

    def _epoch_stream(self, rng: np.random.Generator, batch_size: int):
        """(host ids, rows, batch) triples of one epoch: the positives
        permuted, the tail dropped, pairwise negatives resampled up to four
        rounds. Runs inside the prefetch thread when there is one."""
        n = len(self.pos_users)
        perm = rng.permutation(n)
        n_batches = n // batch_size
        take = n_batches * batch_size
        us = self.pos_users[perm[:take]].reshape(n_batches, batch_size)
        is_ = self.pos_items[perm[:take]].reshape(n_batches, batch_size)
        pairwise = self.loss_mode == "pairwise"
        if pairwise:
            neg = rng.integers(1, self.n_items + 1, size=(n_batches, batch_size))
            for _ in range(4):
                bad = self._rated.contains(us, neg)
                if not bad.any():
                    break
                neg[bad] = rng.integers(1, self.n_items + 1, size=int(bad.sum()))
            neg = neg.astype(np.int32)
        for b in range(n_batches):
            u_ids, i_ids = us[b], is_[b]
            t0 = time.perf_counter()
            rows = {"u": self.user_table.gather(u_ids),
                    "i": self.item_table.gather(i_ids)}
            batch = {"i_ids": i_ids, "genre_i": self.genre_table[i_ids],
                     "log_q": self._log_q[i_ids]}
            ids = {"u": u_ids, "i": i_ids}
            if pairwise:
                n_ids = neg[b]
                rows["n"] = self.item_table.gather(n_ids)
                batch["genre_n"] = self.genre_table[n_ids]
                ids["n"] = n_ids
            self._gather_s += time.perf_counter() - t0
            yield ids, rows, batch

    def _apply_row_grads(self, ids: Dict[str, np.ndarray],
                         row_g: Dict[str, torch.Tensor], parts: Dict[str, float]) -> None:
        """One device-to-host copy of the row grads, then the user and item
        table updates (pairwise: positives and negatives in one call)."""
        t0 = time.perf_counter()
        keys = list(row_g)
        flat = torch.cat([row_g[k] for k in keys]).cpu().numpy()
        g = dict(zip(keys, np.split(flat, len(keys))))
        t1 = time.perf_counter()
        self.user_table.apply_grad(ids["u"], g["u"])
        if "n" in g:
            self.item_table.apply_grad(np.concatenate([ids["i"], ids["n"]]),
                                       np.concatenate([g["i"], g["n"]]))
        else:
            self.item_table.apply_grad(ids["i"], g["i"])
        parts["d2h"] += t1 - t0
        parts["apply_grad"] += time.perf_counter() - t1

    # ------------------------------------------------------------------ #

    def train(self, epochs: Optional[int] = None,
              init_dense: Optional[Dict[str, torch.Tensor]] = None) -> Optional[TwoTower]:
        """Train; return the in-HBM model (saved unless
        ``model_output_path`` is ''), or None where the tables exceed
        :meth:`to_model`'s budget. ``init_dense`` sets the dense params
        (e.g. JAX's, through ``dense_from_jax_params``)."""
        cfg = self.cfg
        dev = self.device
        epochs = epochs or cfg.TRAIN_EPOCHS
        batch_size = min(cfg.BATCH_SIZE, max(8, len(self.pos_users) // 2))
        n_batches = max(1, len(self.pos_users) // batch_size)

        dense = self._init_dense() if init_dense is None else dict(init_dense)
        if sorted(dense) != self.dense_names():
            raise ValueError(f"dense params {sorted(dense)}, expected "
                             f"{self.dense_names()}")
        dense = {k: dense[k].to(dev, torch.float32, copy=True)
                 for k in self.dense_names()}
        decay_steps = max(1, epochs * n_batches)
        # no weight decay on the item bias
        tx = DenseAdamW(lambda c: cosine_lr(cfg.LEARNING_RATE, c, decay_steps),
                        cfg.GRAD_CLIP_NORM, cfg.WEIGHT_DECAY,
                        lambda k: k != "item_bias")
        opt_state = tx.init(dense)
        gen = torch.Generator(device=dev).manual_seed(cfg.SEED + 1)
        step = make_host_offload_step(self._loss_fn(gen), tx=tx)

        host_rng = np.random.default_rng(cfg.SEED)
        total_examples = 0
        t_train = time.time()
        logger.info("Host-table training: %d epochs x %d batches x %d batch (%s, "
                    "prefetch=%d, device=%s)", epochs, n_batches, batch_size,
                    self.loss_mode, cfg.HOST_TABLE_PREFETCH, dev)
        for epoch in range(1, epochs + 1):
            t0 = time.time()
            self._gather_s = 0.0
            parts = dict.fromkeys(STEP_PARTS, 0.0)
            stream = self._epoch_stream(host_rng, batch_size)
            if cfg.HOST_TABLE_PREFETCH > 0:
                # the host ids stay on the host (position 0 of each item)
                stream = PrefetchIterator(stream, depth=cfg.HOST_TABLE_PREFETCH,
                                          device=dev, keep=(0,))
            else:
                stream = (to_device(item, dev, keep=(0,)) for item in stream)
            losses = []
            t_wait = time.perf_counter()
            for ids, rows, batch in stream:
                t1 = time.perf_counter()
                parts["wait"] += t1 - t_wait
                dense, opt_state, loss, row_g = step(dense, opt_state, rows, batch)
                parts["step"] += time.perf_counter() - t1
                self._apply_row_grads(ids, row_g, parts)
                losses.append(loss)
                t_wait = time.perf_counter()
            if cfg.HOST_TABLE_PREFETCH == 0:
                parts["wait"] -= self._gather_s   # the gathers ran inline
            parts["gather"] = self._gather_s
            loss = float(np.mean(torch.stack(losses).cpu().numpy().astype(np.float64)))
            dt = time.time() - t0
            n_ex = n_batches * batch_size
            total_examples += n_ex
            self.history.append({"epoch": epoch, "loss": loss, "seconds": dt,
                                 "steps": len(losses), "examples_per_s": n_ex / dt,
                                 "parts_s": parts})
            logger.info("epoch %d/%d | loss %.4f | %.2fs | %.0f ex/s", epoch,
                        epochs, loss, dt, n_ex / dt)

        elapsed = time.time() - t_train
        self.examples_per_s = total_examples / max(elapsed, 1e-9)
        self._dense = dense
        logger.info("Host-table training done in %.1fs (%.0f examples/s)",
                    elapsed, self.examples_per_s)
        model = self.to_model()
        if model is not None and self.model_output_path:
            model.save(self.model_output_path)
        return model

    # ------------------------------------------------------------------ #

    def to_model(self, max_elements: int = 200_000_000) -> Optional[TwoTower]:
        """The in-HBM :class:`TwoTower` (catalog embedded) where the tables
        fit ``max_elements``; None above it — stream through
        :meth:`embed_catalog` / :meth:`embed_users` instead."""
        cfg = self.cfg
        n_el = (self.n_users + self.n_items + 2) * cfg.EMBEDDING_DIM
        if n_el > max_elements:
            logger.warning("to_model(): %d table elements exceed the %d budget — "
                           "returning None (stream via embed_catalog)", n_el,
                           max_elements)
            return None
        params = {k: v.detach().cpu().numpy() for k, v in self._dense.items()}
        if "item_bias" not in params:   # non-softmax runs train without one
            params["item_bias"] = np.zeros(self.n_items + 1, np.float32)
        params["user_embed"] = np.asarray(self.user_table.table)
        params["item_embed"] = np.asarray(self.item_table.table)
        model = TwoTower.from_numpy(params, self.n_users, self.n_items,
                                    cfg.EMBEDDING_DIM, cfg.HIDDEN_DIM, cfg.DROPOUT,
                                    device=self.device)
        item_ids = np.arange(1, self.n_items + 1, dtype=np.int32)
        model.precompute_item_embeddings(item_ids, self.genre_table[1:])
        return model

    @torch.no_grad()
    def embed_catalog(self, batch_size: int = 8192) -> np.ndarray:
        """(n_items, D) normalised catalog embeddings (1-based item order),
        the host rows streamed through the item head in chunks; the table
        never goes to the device whole. Feeds ``IndexBuilder`` at scale."""
        out = []
        for s in range(1, self.n_items + 1, batch_size):
            ids = np.arange(s, min(s + batch_size, self.n_items + 1))
            rows, genre = to_device((self.item_table.gather(ids),
                                     self.genre_table[ids]), self.device)
            out.append(item_tower_from_embed(self._dense, rows, genre).cpu().numpy())
        return np.concatenate(out, axis=0)

    @torch.no_grad()
    def embed_users(self, user_ids: np.ndarray, batch_size: int = 8192) -> np.ndarray:
        """(B, D) normalised user embeddings from the host rows."""
        out = []
        for s in range(0, len(user_ids), batch_size):
            ids = np.asarray(user_ids[s: s + batch_size])
            rows = to_device(self.user_table.gather(ids), self.device)
            out.append(user_tower_from_embed(self._dense, rows).cpu().numpy())
        return np.concatenate(out, axis=0)
