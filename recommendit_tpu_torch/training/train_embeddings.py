"""Two-tower embedding training — torch port.

Counterpart of ``recommendit_tpu/training/train_embeddings.py``: positives
are ratings >= 4; one of three losses — ``in_batch`` (the in-batch BPR of
``ops/bpr.py``, whose kernels run on the card), ``softmax`` (logQ-corrected
in-batch softmax with a learned, warm-started item bias) or ``pairwise``
(one sampled negative per positive); AdamW under a cosine schedule with
global-norm clipping; the best epoch's params kept; the catalog embedded
and the model saved in the JAX npz + ``.meta.json`` format.

The step matches the JAX one (optax) operation for operation:

* the schedule is ``optax.cosine_decay_schedule(lr, epochs * n_batches)``
  evaluated in f32 at update counts 0, 1, … and handed to each step;
* clipping is ``optax.clip_by_global_norm``: the gradients are divided by
  the global norm and multiplied by the limit only when the norm is at
  least the limit (``torch.nn.utils.clip_grad_norm_`` scales by
  limit / (norm + 1e-6) instead);
* the optimizer is :class:`OptaxAdamW`, the update of ``optax.adamw`` (b1
  0.9, b2 0.999, eps 1e-8 added to sqrt(v̂), weight decay masked off
  ``item_bias``) in optax's order of operations, so it rounds as optax
  does. ``torch.optim.AdamW`` computes the same update in exact arithmetic
  but decays first, p·(1 − lr·wd), and at lr 1e-3, wd 1e-5 that factor
  rounds to 1 in f32: the decay is lost and the params drift from JAX's
  step by step;
* gradients are dense: a parameter the loss does not reach gets a zero
  gradient, so every row's moments decay on every step, as in JAX;
* the batches and the pairwise negatives come from the same numpy
  generator in the same order, so they are identical to JAX's.

Dropout masks come from one ``torch.Generator`` seeded with ``SEED + 1``
(the user tower's mask first, then the item tower's); in pairwise mode the
negative item tower replays the positive tower's generator state, so both
get one mask, as JAX gives both towers the key ``k2``. The loss is read
back once per epoch.

``TRAIN_JIT_SCOPE`` and ``TRAIN_CHUNK_BATCHES`` choose how JAX compiles an
epoch and have no meaning here: they are ignored. ``USE_PALLAS`` keeps its
meaning: on CUDA tensors ``True`` launches the BPR kernels and ``False``
takes the plain twin.

With ``ckpt_dir`` the train state (params, the AdamW moments and step
count, epoch, loss) is saved to ``ckpt_dir/best`` at every best epoch
(``utils/checkpoint.py``: a ``torch.save`` file, not JAX's Orbax
directory); ``train(resume_from=…)`` restores one and goes on with the
next epoch, the schedule at the restored count. As in JAX, the batch
generator and the dropout generator restart from their seeds, so a
resumed run is not the run it continues would have been.
"""
from __future__ import annotations

import logging
import math
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from recommendit_tpu_torch.config import Settings, settings as default_settings
from recommendit_tpu_torch.data.movielens import MovieLensData
from recommendit_tpu_torch.models.two_tower import (
    PARAM_NAMES,
    TwoTower,
    init_params as fresh_params,
    item_tower,
    user_tower,
)
from recommendit_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device
from recommendit_tpu_torch.ops.adamw import adamw_fused_, on_card
from recommendit_tpu_torch.ops.bpr import (
    in_batch_bpr_loss,
    in_batch_softmax_loss,
    pairwise_bpr_loss,
)
from recommendit_tpu_torch.ops.seen import SeenSet
from recommendit_tpu_torch.utils.checkpoint import load_train_state, save_train_state

logger = logging.getLogger(__name__)


def build_genre_table(item_ids: np.ndarray, genres: np.ndarray,
                      n_items: int) -> np.ndarray:
    """(n_items+1, 18) genre multi-hot lookup, row 0 = padding; catalog ids
    outside [1, n_items] are dropped."""
    table = np.zeros((n_items + 1, genres.shape[1]), dtype=np.float32)
    ids = np.asarray(item_ids).astype(np.int64)
    ok = (ids >= 1) & (ids <= n_items)
    table[ids[ok]] = genres[ok]
    return table


def warm_start_item_bias(pos_items: np.ndarray, n_items: int) -> np.ndarray:
    """(n_items+1,) initial item bias: the centred empirical
    log-popularity of the positives (unseen items at the rarest seen
    item's value; row 0, the padding, at 0)."""
    counts = np.bincount(pos_items, minlength=n_items + 1)
    p = counts / max(1, counts.sum())
    log_q = np.log(np.maximum(p, 1e-12)).astype(np.float32)
    seen = counts > 0
    floor = log_q[seen].min() if seen.any() else 0.0
    b0 = np.where(seen, log_q, floor)
    b0 = b0 - b0[1:].mean()
    b0[0] = 0.0
    return b0.astype(np.float32)


def cosine_lr(lr: float, count: int, decay_steps: int) -> float:
    """``optax.cosine_decay_schedule(lr, decay_steps)(count)`` (alpha 0),
    computed in f32 as JAX computes it (numpy's f32 cosine may differ from
    XLA's in the last bit)."""
    f32 = np.float32
    c = f32(min(count, decay_steps))
    decay = f32(0.5) * (f32(1.0) + np.cos(f32(np.pi) * c / f32(decay_steps)))
    return float(f32(lr) * decay)


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """The L2 norm of all of ``grads`` together, a device scalar."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))


def clip_factors(norm: torch.Tensor, max_norm: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """``optax.clip_by_global_norm``'s scale for the global norm ``norm``
    as two device scalars (d, c), applied as g ← (g / d) · c, two roundings
    as optax's ``g / norm * max_norm``: (norm, max_norm) when norm >=
    max_norm, else (1, 1). The choice is made on the device, so the step
    never waits for the norm."""
    keep = norm < max_norm
    one = torch.ones_like(norm)
    return torch.where(keep, one, norm), torch.where(keep, one, one * max_norm)


def clip_(grads: List[torch.Tensor], clip: Tuple[torch.Tensor, torch.Tensor]) -> None:
    """g ← (g / d) · c in place for (d, c) = ``clip`` (:func:`clip_factors`)."""
    torch._foreach_div_(grads, clip[0])
    torch._foreach_mul_(grads, clip[1])


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float) -> None:
    """``optax.clip_by_global_norm`` in place: g ← g / norm · max_norm when
    norm >= max_norm, else g unchanged."""
    clip_(grads, clip_factors(global_norm(grads), max_norm))


# optax.adamw's defaults, which the JAX trainer uses
ADAM_B1 = 0.9
ADAM_B2 = 0.999
ADAM_EPS = 1e-8
# elements of one chunk of the optimizer step (256 MiB of f32): a step's
# temporaries are at most two chunks, whatever the params' sizes
ADAM_CHUNK = 1 << 26


def _adamw_update(params, grads, mu, nu, decayed, weight_decay, s) -> None:
    """``optax.adamw``'s update of ``params``, ``mu``, ``nu`` in place, given
    ``grads`` and the step's f32 host scalars ``s``; ``decayed`` indexes the
    params with weight decay. Elementwise: on views of the tensors it
    computes what it computes on the whole, bit for bit."""
    torch._foreach_mul_(mu, s["b1"])
    torch._foreach_add_(mu, torch._foreach_mul(grads, s["1-b1"]))
    sq = torch._foreach_mul(grads, grads)
    torch._foreach_mul_(sq, s["1-b2"])
    torch._foreach_mul_(nu, s["b2"])
    torch._foreach_add_(nu, sq)
    del sq
    den = torch._foreach_div(nu, s["bc2"])
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, ADAM_EPS)
    upd = torch._foreach_div(mu, s["bc1"])
    torch._foreach_div_(upd, den)
    del den
    if weight_decay and decayed:
        torch._foreach_add_([upd[i] for i in decayed],
                            torch._foreach_mul([params[i] for i in decayed],
                                               weight_decay))
    torch._foreach_mul_(upd, s["-lr"])
    torch._foreach_add_(params, upd)


def chunk_groups(shapes, chunk: int = ADAM_CHUNK):
    """Cut tensors of ``shapes`` into row ranges and pack them, in order,
    into groups of at most ``chunk`` elements → a list of groups, each a
    list of ``(tensor index, first row, end row, whole)``; ``whole`` marks
    a range that is its whole tensor. A row longer than ``chunk`` is a
    group alone; empty tensors are left out (an update of nothing)."""
    groups, group, room = [], [], chunk
    for i, shape in enumerate(shapes):
        n = shape[0] if len(shape) else 1
        row = math.prod(shape[1:]) if len(shape) else 1
        a = 0
        while a < n and row:
            take = min(n - a, room // row)
            if not take and group:
                groups.append(group)
                group, room = [], chunk
                continue
            take = max(take, 1)
            group.append((i, a, a + take, take == n))
            room -= take * row
            a += take
            if room <= 0:
                groups.append(group)
                group, room = [], chunk
    if group:
        groups.append(group)
    return groups


class OptaxAdamW:
    """``optax.adamw(lr, weight_decay=…, mask=…)`` at optax's default b1, b2
    and eps, on a list of f32 params, operation for operation:

    * ``scale_by_adam``: mu ← (1−b1)·g + b1·mu, nu ← (1−b2)·g² + b2·nu,
      u = (mu / (1 − b1^t)) / (sqrt(nu / (1 − b2^t)) + eps);
    * ``add_decayed_weights``: u ← u + wd·p on the params with ``decay``;
    * ``scale_by_learning_rate``: u ← u · (−lr);
    * ``apply_updates``: p ← p + u.

    Every scalar is an f32 value computed on the host from the step count
    (numpy's f32 power equals XLA's for the bias corrections), so a step
    never waits for the device. ``step(grads, lr, clip=(d, c))`` also
    applies ``optax.clip_by_global_norm``'s scale, g ← (g / d) · c, with
    the device scalars of :func:`clip_factors`.

    The step takes one of two paths, by device, with bit-equal results.
    On a CUDA device one launch of ``csrc/adamw.cu``
    (``ops/adamw.adamw_fused_``) updates each element in one pass, with the
    clip's scale in registers; it allocates nothing and leaves the
    gradients as they were. Every param, gradient, moment and clip factor
    must then be a contiguous f32 tensor on that device, or the step raises
    ValueError (``ops/adamw.on_card``). On the CPU every tensor operation is
    a ``torch._foreach_*`` call over row ranges of the params, their
    gradients and moments, packed into groups of at most ``chunk``
    elements (:func:`chunk_groups`), one group after another, each group's
    gradients clipped in place just before its update: its temporaries are
    a group's size, so a step's peak is params + grads + two moments plus
    two chunks, as XLA's in-place (donated) update of JAX's step. The
    operations are elementwise, so both paths are bit-equal to
    :meth:`_step_unchunked` (the one-pass foreach step, with full-size
    temporaries). Gradients must have their params' shapes; the moments
    are updated in place (restore them with ``copy_``)."""

    def __init__(self, params: List[torch.Tensor], decay: List[bool],
                 weight_decay: float, chunk: int = ADAM_CHUNK):
        self.params = list(params)
        self.decay = [bool(d) for d in decay]
        self.decayed = [i for i, d in enumerate(decay) if d]
        self.weight_decay = weight_decay
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0
        self.groups = chunk_groups([p.shape for p in self.params], chunk)
        self._group_decayed = [[j for j, (i, *_) in enumerate(g) if decay[i]]
                               for g in self.groups]

    def _scalars(self, lr: float) -> dict:
        """The step's f32 host scalars (the step count advanced)."""
        f32 = np.float32
        self.count += 1
        return {"b1": float(f32(ADAM_B1)), "b2": float(f32(ADAM_B2)),
                "1-b1": float(f32(1 - ADAM_B1)), "1-b2": float(f32(1 - ADAM_B2)),
                "bc1": float(f32(1) - f32(ADAM_B1) ** f32(self.count)),
                "bc2": float(f32(1) - f32(ADAM_B2) ** f32(self.count)),
                "-lr": -float(f32(lr))}

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor], lr: float,
             clip: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> None:
        if on_card({"param": self.params, "gradient": grads, "mu": self.mu,
                    "nu": self.nu, "clip factor": clip or ()}):
            adamw_fused_(self.params, grads, self.mu, self.nu, self.decay,
                         self._scalars(lr), self.weight_decay, ADAM_EPS, clip)
        else:
            self._step_foreach(grads, lr, clip)

    @torch.no_grad()
    def _step_foreach(self, grads: List[torch.Tensor], lr: float,
                      clip: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> None:
        """The step's foreach path, by chunk groups (the class docstring);
        ``chip_smoke.py`` times it beside the kernel on the card."""
        s = self._scalars(lr)
        for group, decayed in zip(self.groups, self._group_decayed):
            p, g, m, v = ([t[i] if whole else t[i][a:b] for i, a, b, whole in group]
                          for t in (self.params, grads, self.mu, self.nu))
            if clip is not None:
                clip_(g, clip)
            _adamw_update(p, g, m, v, decayed, self.weight_decay, s)

    @torch.no_grad()
    def _step_unchunked(self, grads: List[torch.Tensor], lr: float,
                        clip: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> None:
        """The step as it was before it ran by chunks: the gradients
        clipped in place, then one pass over the whole lists, every
        temporary a full-size copy of the params (the squares, the
        denominators and the update alive together). The reference both
        paths of :meth:`step` equal bit for bit, on the CPU and on the card;
        only the tests, ``chip_smoke.py`` and ``tools/shard_memory.py`` call
        it."""
        if clip is not None:
            clip_(grads, clip)
        s = self._scalars(lr)
        torch._foreach_mul_(self.mu, s["b1"])
        torch._foreach_add_(self.mu, torch._foreach_mul(grads, s["1-b1"]))
        sq = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(sq, s["1-b2"])
        torch._foreach_mul_(self.nu, s["b2"])
        torch._foreach_add_(self.nu, sq)
        den = torch._foreach_div(self.nu, s["bc2"])
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, ADAM_EPS)
        upd = torch._foreach_div(self.mu, s["bc1"])
        torch._foreach_div_(upd, den)
        if self.weight_decay:
            torch._foreach_add_(
                [upd[i] for i in self.decayed],
                torch._foreach_mul([self.params[i] for i in self.decayed],
                                   self.weight_decay))
        torch._foreach_mul_(upd, s["-lr"])
        torch._foreach_add_(self.params, upd)


class EmbeddingTrainer:
    """Trains the two-tower model on (user, positive-item) interactions."""

    def __init__(self, data: MovieLensData, cfg: Optional[Settings] = None,
                 loss_mode: Optional[str] = None,
                 model_output_path: Optional[str] = None,
                 ckpt_dir: Optional[str] = None,
                 device=DEFAULT_DEVICE):
        self.cfg = cfg or default_settings
        self.data = data
        self.loss_mode = loss_mode or self.cfg.LOSS_MODE
        if self.loss_mode not in ("in_batch", "softmax", "pairwise"):
            raise ValueError(f"unknown loss mode {self.loss_mode!r}")
        # None -> config default; '' -> saving explicitly disabled
        self.model_output_path = (
            self.cfg.EMBEDDING_MODEL_PATH if model_output_path is None
            else model_output_path)
        self.device = resolve_device(device)
        self.ckpt_dir = ckpt_dir
        self.history: List[Dict] = []

        self.n_users = data.n_users
        self.n_items = data.n_items
        pos = data.rating >= 4
        self.pos_users = data.user_id[pos].astype(np.int32)
        self.pos_items = data.item_id[pos].astype(np.int32)
        self.genre_table = build_genre_table(data.item_ids, data.genres,
                                             self.n_items)
        self._rated = SeenSet(data.user_id, data.item_id, self.n_items)
        logger.info("Trainer: %d positives, %d users, %d items, loss=%s",
                    len(self.pos_users), self.n_users, self.n_items,
                    self.loss_mode)

    def _log_q_table(self) -> np.ndarray:
        """(n_items+1,) log empirical sampling probability of each item in
        the positive stream (the logQ correction of the sampled softmax)."""
        counts = np.bincount(self.pos_items, minlength=self.n_items + 1)
        p = counts / max(1, counts.sum())
        return np.log(np.maximum(p, 1e-12)).astype(np.float32)

    def _epoch_batches(self, rng: np.random.Generator, batch_size: int):
        """Shuffle the positives, drop the remainder, sample negatives in
        pairwise mode (uniform, a few rounds of rejecting rated items)."""
        n = len(self.pos_users)
        perm = rng.permutation(n)
        n_batches = n // batch_size
        take = n_batches * batch_size
        u = self.pos_users[perm[:take]].reshape(n_batches, batch_size)
        i = self.pos_items[perm[:take]].reshape(n_batches, batch_size)
        if self.loss_mode == "pairwise":
            neg = rng.integers(1, self.n_items + 1, size=(n_batches, batch_size))
            for _ in range(4):
                bad = self._rated.contains(u, neg)
                if not bad.any():
                    break
                neg[bad] = rng.integers(1, self.n_items + 1, size=int(bad.sum()))
            neg = neg.astype(np.int32)
        else:
            neg = np.zeros_like(u)
        return u, i, neg

    def _initial_params(self, init_params: Optional[TwoTower]) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        if init_params is None:
            params = fresh_params(torch.Generator().manual_seed(cfg.SEED),
                                  self.n_users, self.n_items,
                                  cfg.EMBEDDING_DIM, cfg.HIDDEN_DIM,
                                  device="cpu")   # drawn on the host, moved below
        else:
            want = (self.n_users, self.n_items, cfg.EMBEDDING_DIM, cfg.HIDDEN_DIM)
            got = (init_params.n_users, init_params.n_items,
                   init_params.embed_dim, init_params.hidden_dim)
            if got != want:
                raise ValueError(
                    f"init_params sizes (users, items, dim, hidden) {got}, "
                    f"expected {want}")
            params = init_params.params()
        if self.loss_mode == "softmax":
            params["item_bias"] = torch.from_numpy(
                warm_start_item_bias(self.pos_items, self.n_items))
        return {k: params[k].to(self.device, torch.float32, copy=True)
                .requires_grad_(True) for k in PARAM_NAMES}

    def _loss(self, params, u, i, n, gen, tables, use_kernel, cdt):
        cfg = self.cfg
        genre_table, log_q_table = tables
        rate = cfg.DROPOUT
        ue = user_tower(params, u, rate, gen, cdt)
        if self.loss_mode == "pairwise":
            state = gen.get_state()
            ie = item_tower(params, i, genre_table[i], rate, gen, cdt)
            gen.set_state(state)  # the negatives' tower draws the same mask
            ne = item_tower(params, n, genre_table[n], rate, gen, cdt)
            return pairwise_bpr_loss(ue, ie, ne)
        ie = item_tower(params, i, genre_table[i], rate, gen, cdt)
        if self.loss_mode == "softmax":
            return in_batch_softmax_loss(
                ue, ie, log_q_table[i], cfg.SOFTMAX_TEMPERATURE,
                item_bias=params["item_bias"][i])
        return in_batch_bpr_loss(ue, ie, use_kernel)

    @torch.no_grad()
    def _restore(self, path: str, params: Dict[str, torch.Tensor],
                 opt: OptaxAdamW) -> int:
        """Load the train state at ``path`` into ``params`` and ``opt``;
        returns its epoch."""
        state = load_train_state(path, device=self.device)
        saved = state["params"]
        shapes = {k: tuple(v.shape) for k, v in saved.items()}
        want = {k: tuple(params[k].shape) for k in PARAM_NAMES}
        if shapes != want:
            raise ValueError(f"checkpoint {path}: param shapes {shapes}, "
                             f"expected {want}")
        for i, k in enumerate(PARAM_NAMES):
            params[k].copy_(saved[k])
            opt.mu[i].copy_(state["opt_state"]["mu"][k])
            opt.nu[i].copy_(state["opt_state"]["nu"][k])
        opt.count = int(state["opt_state"]["count"])
        epoch = int(state["epoch"])
        logger.info("Resumed from %s at epoch %d (loss %.4f)", path, epoch,
                    float(state["loss"]))
        return epoch

    def train(self, epochs: Optional[int] = None,
              resume_from: Optional[str] = None,
              init_params: Optional[TwoTower] = None) -> TwoTower:
        """Train and return the best epoch's model (catalog embedded, saved
        unless ``model_output_path`` is ''). ``init_params`` sets the
        initial weights (e.g. :func:`~recommendit_tpu_torch.models.two_tower.from_jax_params`
        of the JAX package's ``init_params``); by default they are drawn
        from ``SEED``. In softmax mode the item bias is warm-started either
        way, as in JAX. ``resume_from`` restores a train state saved by
        ``ckpt_dir`` and trains from the epoch after its own."""
        cfg = self.cfg
        dev = self.device
        epochs = epochs or cfg.TRAIN_EPOCHS
        batch_size = min(cfg.BATCH_SIZE, max(8, len(self.pos_users) // 2))
        n_batches = max(1, len(self.pos_users) // batch_size)
        decay_steps = max(1, epochs * n_batches)
        cdt = torch.bfloat16 if cfg.COMPUTE_DTYPE == "bfloat16" else None

        params = self._initial_params(init_params)
        plist = [params[k] for k in PARAM_NAMES]
        # no weight decay on the item bias: decay would pull the popularity
        # prior toward 0
        opt = OptaxAdamW(plist, [k != "item_bias" for k in PARAM_NAMES],
                         cfg.WEIGHT_DECAY)
        tables = (torch.as_tensor(self.genre_table, device=dev),
                  torch.as_tensor(self._log_q_table(), device=dev))
        start_epoch = 1
        if resume_from:
            start_epoch = self._restore(resume_from, params, opt) + 1

        host_rng = np.random.default_rng(cfg.SEED)
        gen = torch.Generator(device=dev).manual_seed(cfg.SEED + 1)
        best_loss = float("inf")
        best = {k: p.detach().clone() for k, p in params.items()}
        total_examples = 0
        count = opt.count
        t_train = time.time()
        logger.info("Training: %d epochs x %d batches x %d batch (%s, "
                    "kernels=%s, device=%s)", epochs, n_batches, batch_size,
                    self.loss_mode, cfg.USE_PALLAS, dev)
        for epoch in range(start_epoch, epochs + 1):
            t0 = time.time()
            u, i, neg = self._epoch_batches(host_rng, batch_size)
            ub, ib, nb = (torch.as_tensor(a, device=dev).long()
                          for a in (u, i, neg))
            losses = []
            for s in range(ub.shape[0]):
                for p in plist:
                    p.grad = None
                loss = self._loss(params, ub[s], ib[s], nb[s], gen, tables,
                                  cfg.USE_PALLAS, cdt)
                loss.backward()
                grads = [torch.zeros_like(p) if p.grad is None else p.grad
                         for p in plist]
                opt.step(grads, cosine_lr(cfg.LEARNING_RATE, count, decay_steps),
                         clip=clip_factors(global_norm(grads), cfg.GRAD_CLIP_NORM))
                losses.append(loss.detach())
                count += 1
            loss = float(torch.stack(losses).mean()) if losses else float("nan")
            dt = time.time() - t0
            n_ex = u.size
            total_examples += n_ex
            self.history.append({"epoch": epoch, "loss": loss, "seconds": dt,
                                 "steps": len(losses),
                                 "examples_per_s": n_ex / dt})
            logger.info("epoch %d/%d | loss %.4f | %.2fs | %.0f ex/s",
                        epoch, epochs, loss, dt, n_ex / dt)
            if loss < best_loss:
                best_loss = loss
                best = {k: p.detach().clone() for k, p in params.items()}
                if self.ckpt_dir:
                    save_train_state(str(Path(self.ckpt_dir) / "best"), {
                        "params": params,
                        "opt_state": {"mu": dict(zip(PARAM_NAMES, opt.mu)),
                                      "nu": dict(zip(PARAM_NAMES, opt.nu)),
                                      "count": torch.tensor(opt.count)},
                        "epoch": torch.tensor(epoch), "loss": torch.tensor(loss)})

        elapsed = time.time() - t_train
        self.examples_per_s = total_examples / elapsed
        logger.info("Training done in %.1fs (best loss %.4f, %.0f examples/s)",
                    elapsed, best_loss, self.examples_per_s)

        model = TwoTower.from_numpy(
            {k: v.cpu().numpy() for k, v in best.items()}, self.n_users,
            self.n_items, cfg.EMBEDDING_DIM, cfg.HIDDEN_DIM, cfg.DROPOUT,
            device=dev)
        item_ids = np.arange(1, self.n_items + 1, dtype=np.int32)
        model.precompute_item_embeddings(item_ids, self.genre_table[1:])
        if self.model_output_path:
            model.save(self.model_output_path)
        return model
