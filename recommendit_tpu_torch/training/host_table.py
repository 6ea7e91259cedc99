"""Host-resident embedding tables for larger-than-HBM training — torch port.

Counterpart of ``recommendit_tpu/training/host_table.py``. A 100M-user x
dim-128 f32 table is ~51 GB, beyond one card's memory. The table stays in
host RAM (or a disk-backed numpy memmap) and only the current batch's rows
go to the device:

    host: gather rows for batch ids  ──►  device: fwd/bwd on rows
    host: sparse adagrad/sgd row update  ◄──  device: d(loss)/d(rows)

* :class:`HostEmbeddingTable` is numpy only: a copy of the JAX class,
  pinned to it by ``tests/test_torch_host_table.py`` (its syntax tree, and
  its tables and updates bit for bit).
* :class:`PrefetchIterator` runs the host gathers in a worker thread, copies
  the rows into pinned staging buffers (``depth + 1`` slots; the table is
  never pinned) and ships them on a side CUDA stream, one event per batch.
  The consumer's stream waits on that event, and each shipped tensor is
  recorded on the consumer's stream, so the caching allocator does not
  recycle it while the consumer still reads it. On the CPU a batch is its
  arrays as tensors.
* :func:`make_host_offload_step` is the device half of a step: one
  ``backward`` through leaf copies of the dense params and the gathered
  rows; with ``tx`` (:class:`DenseAdamW`) the dense params are updated in
  place. Only the dense grads are clipped and go through AdamW; the row
  grads come back raw, as in JAX.
"""
from __future__ import annotations

import itertools
import queue
import threading
from pathlib import Path
from typing import Callable, Dict, Iterable, Iterator, Mapping, Optional, Sequence

import numpy as np
import torch

from recommendit_tpu_torch.training.train_embeddings import (
    OptaxAdamW,
    clip_factors,
    global_norm,
)
from recommendit_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

__all__ = ["DenseAdamW", "HostEmbeddingTable", "PrefetchIterator",
           "make_host_offload_step", "prefetch_to_device", "to_device"]


class HostEmbeddingTable:
    """A host-RAM (or disk-memmapped) embedding table with sparse updates.

    Parameters
    ----------
    n_rows, dim : table shape.
    optimizer : 'adagrad' (default — the standard choice for sparse
        embedding updates: per-row adaptive scaling without dense moments)
        or 'sgd'.
    lr : learning rate.
    path : optional ``.npy`` path — the table is a disk-backed memmap, so
        tables larger than host RAM stream through the page cache.
    """

    def __init__(
        self,
        n_rows: int,
        dim: int,
        optimizer: str = "adagrad",
        lr: float = 0.05,
        init_scale: float = 0.05,
        seed: int = 0,
        path: Optional[str] = None,
        eps: float = 1e-8,
    ):
        self.n_rows, self.dim = int(n_rows), int(dim)
        if optimizer not in ("adagrad", "sgd"):
            raise ValueError(f"unknown optimizer {optimizer!r}")
        self.optimizer = optimizer
        self.lr = float(lr)
        self.eps = float(eps)
        # SFC64: ~14x PCG64's f32-normal fill rate on shared vCPUs — table
        # init is the startup cost at 10^10-element scale
        rng = np.random.Generator(np.random.SFC64(seed))
        if path is not None:
            p = Path(path)
            p.parent.mkdir(parents=True, exist_ok=True)
            self.table = np.lib.format.open_memmap(
                str(p), mode="w+", dtype=np.float32,
                shape=(self.n_rows, self.dim),
            )
        else:
            self.table = np.empty((self.n_rows, self.dim), np.float32)
        # chunked f32 init: no f64 intermediate, peak extra RAM bounded —
        # a 100M x 128 table would otherwise allocate a 102 GB f64 temp
        chunk = max(1, min(self.n_rows, 1 << 20))
        for s in range(0, self.n_rows, chunk):
            e = min(self.n_rows, s + chunk)
            rng.standard_normal((e - s, self.dim), dtype=np.float32,
                                out=self.table[s:e])
            self.table[s:e] *= init_scale
        # adagrad accumulator: one scalar per row (row-wise variant — the
        # memory-frugal form used for embedding tables)
        self._accum = (
            np.zeros((self.n_rows,), np.float32)
            if optimizer == "adagrad" else None
        )
        # gather vs apply_grad can race when a PrefetchIterator thread
        # gathers ahead of the consumer's updates; the lock guarantees a
        # prefetched gather sees a CONSISTENT (possibly `depth`-stale) row
        # version, never a torn half-written one. Uncontended cost is ~100ns
        # per call — noise next to the row copies themselves.
        self._lock = threading.Lock()

    def gather(self, ids: np.ndarray) -> np.ndarray:
        """(B,) ids -> (B, D) rows (a copy — safe to ship to device)."""
        with self._lock:
            return np.ascontiguousarray(self.table[ids])

    def apply_grad(self, ids: np.ndarray, grad: np.ndarray) -> None:
        """Sparse row update. Duplicate ids within the batch accumulate
        (matching autodiff-through-gather scatter-add semantics) and each
        unique row is updated ONCE."""
        ids = np.asarray(ids)
        grad = np.asarray(grad, np.float32)
        uniq, inv = np.unique(ids, return_inverse=True)
        g = np.zeros((len(uniq), self.dim), np.float32)
        np.add.at(g, inv, grad)
        with self._lock:
            if self.optimizer == "adagrad":
                self._accum[uniq] += np.mean(g * g, axis=1)
                scale = self.lr / (np.sqrt(self._accum[uniq]) + self.eps)
                self.table[uniq] -= scale[:, None] * g
            else:
                self.table[uniq] -= self.lr * g

    # --- persistence ---------------------------------------------------- #

    def save(self, path: str) -> None:
        # np.save appends '.npy' when absent; normalize so save/load_state
        # agree for any path.
        p = Path(path)
        if p.suffix != ".npy":
            p = Path(str(p) + ".npy")
        p.parent.mkdir(parents=True, exist_ok=True)
        np.save(p, np.asarray(self.table))
        if self._accum is not None:
            np.save(str(p) + ".accum.npy", self._accum)

    def load_state(self, path: str) -> None:
        p = Path(path)
        if p.suffix != ".npy":
            p = Path(str(p) + ".npy")
        self.table[:] = np.load(p, mmap_mode="r")
        accum = Path(str(p) + ".accum.npy")
        if self._accum is not None and accum.exists():
            self._accum[:] = np.load(accum)

def _tree_map(fn: Callable, tree, keep: Sequence[int] = ()):
    """``fn`` over the numpy leaves of nested dicts, lists and tuples; other
    leaves (and the top-level tuple positions in ``keep``) as they are."""
    if isinstance(tree, np.ndarray):
        return fn(tree)
    if isinstance(tree, Mapping):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [v if i in keep else _tree_map(fn, v) for i, v in enumerate(tree)]
        return type(tree)(out)
    return tree


def _tensors(tree) -> Iterator[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, Mapping):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def to_device(tree, device, keep: Sequence[int] = ()):
    """The numpy leaves of ``tree`` as tensors on ``device``, copied on the
    current stream (the synchronous form of :class:`PrefetchIterator`)."""
    device = torch.device(device)
    return _tree_map(lambda a: torch.from_numpy(a).to(device), tree, keep)


class _StagingSlot:
    """Pinned host buffers for one batch in flight, reused once the copy
    recorded in ``event`` has completed."""

    def __init__(self):
        self.buffers: Dict[tuple, torch.Tensor] = {}
        self.event: Optional[torch.cuda.Event] = None

    def stage(self, n: int, a: np.ndarray) -> torch.Tensor:
        """The ``n``-th array of the batch copied into a pinned buffer of its
        shape and dtype (allocated on first use)."""
        key = (n, a.shape, a.dtype.str)
        buf = self.buffers.get(key)
        if buf is None:
            buf = torch.empty(a.shape, dtype=torch.from_numpy(a[:0]).dtype,
                              pin_memory=True)
            self.buffers[key] = buf
        buf.numpy()[...] = a
        return buf


class PrefetchIterator:
    """Host→device prefetcher: a worker thread stays ``depth`` batches
    ahead, running the host work of the source iterator (table gathers,
    batch assembly) and the H2D copies while the device runs the current
    step. Items are pytrees of numpy arrays; their arrays arrive as device
    tensors, except under the top-level tuple positions in ``keep`` (host
    ids the caller needs on the host). Exceptions from the source re-raise
    on the consumer's side.

    On the card each array is copied into one of ``depth + 1`` pinned
    staging slots and shipped with ``non_blocking`` copies on a side stream;
    an event recorded after a batch's copies is what the consumer's stream
    waits on, and what the worker waits on before it refills that slot.
    """

    _END = object()

    def __init__(self, source: Iterable, depth: int = 2, device=DEFAULT_DEVICE,
                 keep: Sequence[int] = ()):
        self._q: queue.Queue = queue.Queue(maxsize=max(1, depth))
        self._device = resolve_device(device)
        self._keep = tuple(keep)
        self._cuda = self._device.type == "cuda"
        if self._cuda:
            self._stream = torch.cuda.Stream(self._device)
            self._slots = [_StagingSlot() for _ in range(max(1, depth) + 1)]
        self._thread = threading.Thread(target=self._worker, args=(iter(source),),
                                        daemon=True)
        self._thread.start()

    def _ship(self, item, n: int):
        """(item on the device, the event its copies complete at)."""
        if not self._cuda:
            return to_device(item, self._device, self._keep), None
        slot = self._slots[n % len(self._slots)]
        if slot.event is not None:
            slot.event.synchronize()        # the slot's last copy has landed
        leaf = itertools.count()
        with torch.cuda.device(self._device), torch.cuda.stream(self._stream):
            shipped = _tree_map(lambda a: slot.stage(next(leaf), a).to(
                self._device, non_blocking=True), item, self._keep)
            slot.event = torch.cuda.Event()
            slot.event.record(self._stream)
        return shipped, slot.event

    def _worker(self, it: Iterator) -> None:
        try:
            for n, item in enumerate(it):
                self._q.put(self._ship(item, n))
            self._q.put(self._END)
        except BaseException as exc:  # noqa: BLE001 — re-raised on consumer
            self._q.put(exc)

    def __iter__(self):
        return self

    def __next__(self):
        got = self._q.get()
        if got is self._END:
            raise StopIteration
        if isinstance(got, BaseException):
            raise got
        item, event = got
        if event is not None:
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(event)
            for t in _tensors(item):
                t.record_stream(stream)
        return item


def prefetch_to_device(source: Iterable, depth: int = 2, device=DEFAULT_DEVICE):
    """``for batch in prefetch_to_device(gen()): ...``"""
    return PrefetchIterator(source, depth=depth, device=device)


class DenseAdamW:
    """The dense half's optimizer, ``optax.chain(clip_by_global_norm(
    max_norm), adamw(schedule, weight_decay=…, mask=…))``, on a dict of f32
    tensors updated in place: the port's ``clip_factors`` and
    :class:`~recommendit_tpu_torch.training.train_embeddings.OptaxAdamW`
    (optax's order of operations, C.12). ``schedule`` maps the update count
    (0, 1, …) to the learning rate; ``decay`` maps a param name to whether
    weight decay applies."""

    def __init__(self, schedule: Callable[[int], float], max_norm: float,
                 weight_decay: float, decay: Callable[[str], bool]):
        self.schedule = schedule
        self.max_norm = max_norm
        self.weight_decay = weight_decay
        self.decay = decay

    def init(self, dense: Dict[str, torch.Tensor]) -> OptaxAdamW:
        names = list(dense)
        return OptaxAdamW([dense[k] for k in names], [self.decay(k) for k in names],
                          self.weight_decay)

    def update(self, grads: Dict[str, torch.Tensor], state: OptaxAdamW,
               dense: Dict[str, torch.Tensor]) -> None:
        g = [grads[k] for k in dense]
        state.step(g, self.schedule(state.count),
                   clip=clip_factors(global_norm(g), self.max_norm))


def _leaves(tree: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().requires_grad_(True) for k, v in tree.items()}


def make_host_offload_step(loss_from_rows: Callable, tx: Optional[DenseAdamW] = None
                           ) -> Callable:
    """The device half of a host-table step.

    ``loss_from_rows(dense_params, row_inputs, batch) -> loss`` with
    ``row_inputs`` a dict of (B, D) gathered-row tensors.

    Without ``tx``: ``step(dense_params, row_inputs, batch) -> (loss,
    row_grads, dense_grads)``; the caller applies ``dense_grads`` and routes
    ``row_grads`` to :meth:`HostEmbeddingTable.apply_grad`.

    With ``tx``: ``step(dense_params, opt_state, row_inputs, batch) ->
    (dense_params, opt_state, loss, row_grads)``, the dense params updated
    in place (``opt_state`` from ``tx.init(dense_params)``). A param or row
    the loss does not reach gets a zero gradient, as under ``jax.grad``.
    """
    def grads(dense, rows, batch):
        dp, rp = _leaves(dense), _leaves(rows)
        loss = loss_from_rows(dp, rp, batch)
        loss.backward()

        def g(t):
            return torch.zeros_like(t) if t.grad is None else t.grad

        return (loss.detach(), {k: g(v) for k, v in rp.items()},
                {k: g(v) for k, v in dp.items()})

    if tx is None:
        return grads

    def fused_step(dense, opt_state, rows, batch):
        loss, row_g, dense_g = grads(dense, rows, batch)
        tx.update(dense_g, opt_state, dense)
        return dense, opt_state, loss, row_g

    return fused_step
