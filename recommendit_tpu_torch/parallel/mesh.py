"""Process group, device mesh and shard placement — torch port of
``recommendit_tpu/parallel/mesh.py``.

JAX drives every device of a mesh from one controller; here each device is
driven by a process of its own (a rank), the PyTorch idiom. The ranks join
one ``torch.distributed`` process group — NCCL on the card (one card a
rank), gloo on the CPU — and a ``DeviceMesh`` with the axes
``('data', 'model')`` over it. The mesh's per-axis process groups
(``mesh.get_group("model")``) take the place of JAX's named axes, and the
bodies of JAX's ``shard_map`` regions are written out as explicit
collectives over them (``parallel/embedding.py``, ``parallel/retrieval.py``).

Axis semantics, as in JAX:
* ``data``  — batch (data parallel); dense gradients are summed over it.
* ``model`` — rows of the embedding tables and of the item corpus.

Ranks are laid out row-major, ``rank = data_index * model_size +
model_index``, as JAX reshapes its device list: the ``model`` groups are
runs of consecutive ranks.

A rank holds each tensor either whole (:func:`replicated`) or as its slice
along the first dimension (:func:`row_sharded`, :func:`batch_sharded`); a
:class:`Sharding` says which and cuts that slice from a global array.
"""
from __future__ import annotations

import logging
import math
import os
from dataclasses import dataclass
from datetime import timedelta
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from recommendit_tpu_torch.training.train_embeddings import OptaxAdamW, clip_, clip_factors
from recommendit_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device
from recommendit_tpu_torch.utils.profiling import span

logger = logging.getLogger(__name__)

DATA_AXIS = "data"
MODEL_AXIS = "model"
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}
GROUP_TIMEOUT = timedelta(seconds=600)   # a collective that waits longer fails


def distributed_init(init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None,
                     device=DEFAULT_DEVICE) -> torch.device:
    """Join the process group → this rank's device.

    The counterpart of JAX's ``distributed_init(coordinator_address,
    num_processes, process_id)``: ``init_method`` (``tcp://host:port`` or
    ``file:///path``), ``world_size`` and ``rank``; each left out is read
    from torchrun's variables (``env://`` with ``MASTER_ADDR`` /
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``). Unlike JAX's, a world of
    one process still makes a group, since the mesh's collectives need one.

    ``device="cuda"`` uses NCCL and one card a rank: the card of index
    ``LOCAL_RANK`` (else ``rank``), which must exist — with no card, or
    fewer cards than local ranks, this raises; nothing falls back to gloo.
    ``device="cpu"`` uses gloo.
    """
    dev_type = resolve_device(device).type
    if dev_type not in BACKENDS:
        raise ValueError(f"no process-group backend for device {device!r}")
    env = os.environ
    world_size = int(env.get("WORLD_SIZE", 1)) if world_size is None else world_size
    rank = int(env.get("RANK", 0)) if rank is None else rank
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} outside a world of {world_size}")
    if dev_type == "cuda":
        local = int(env.get("LOCAL_RANK", rank))
        n_cards = torch.cuda.device_count()
        if local >= n_cards:
            raise RuntimeError(
                f"rank {rank} (local rank {local}) needs card {local}, but "
                f"only {n_cards} card(s) are visible: one card a rank")
        torch.cuda.set_device(local)
        dev = torch.device("cuda", local)
    else:
        dev = torch.device("cpu")
    if not dist.is_initialized():
        dist.init_process_group(
            BACKENDS[dev_type], init_method=init_method or "env://",
            world_size=world_size, rank=rank,
            timeout=GROUP_TIMEOUT)
    elif (dist.get_world_size(), dist.get_rank()) != (world_size, rank):
        raise RuntimeError("a process group of another shape is already up")
    logger.info("process group: rank %d/%d on %s (%s)", rank, world_size,
                dev, dist.get_backend())
    return dev


def _factor_2d(n: int, prefer_model: int) -> Tuple[int, int]:
    """Split n devices into (data, model) with model as close to
    ``prefer_model`` as divisibility allows."""
    model = math.gcd(n, prefer_model) if prefer_model > 0 else 1
    for m in range(min(prefer_model, n), 0, -1):
        if n % m == 0:
            model = m
            break
    return n // model, model


def create_mesh(shape: Optional[Tuple[int, int]] = None,
                axis_names: Sequence[str] = (DATA_AXIS, MODEL_AXIS),
                prefer_model: int = 1):
    """A 2-D ``('data', 'model')`` ``DeviceMesh`` over every rank of the
    process group (:func:`distributed_init` first), on the group's device
    type."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("create_mesh needs a process group: call "
                           "distributed_init first")
    n = dist.get_world_size()
    if shape is None:
        shape = _factor_2d(n, prefer_model)
    shape = tuple(int(s) for s in shape)
    if shape[0] * shape[1] != n:
        raise ValueError(f"mesh shape {shape} != {n} devices")
    dev_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    mesh = init_device_mesh(dev_type, shape, mesh_dim_names=tuple(axis_names))
    logger.info("Mesh %s over %d %s ranks", dict(zip(axis_names, shape)), n,
                dev_type)
    return mesh


def mesh_device(mesh) -> torch.device:
    """This rank's device in ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def axis_size(mesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis`` (``jax.lax.axis_index``)."""
    return mesh.get_local_rank(axis)


def axis_ranks(mesh, axis: str) -> List[int]:
    """The global ranks of this rank's group along ``axis``, in axis order."""
    return dist.get_process_group_ranks(mesh.get_group(axis))


@dataclass(frozen=True)
class Sharding:
    """How a rank holds one tensor: whole (``axis`` None) or as its slice of
    rows along the mesh axis ``axis`` (JAX's ``NamedSharding(mesh, P())`` /
    ``P(axis)``)."""
    mesh: object
    axis: Optional[str] = None

    def shard(self, x) -> torch.Tensor:
        """This rank's part of the global array ``x`` (numpy or tensor), a
        contiguous copy on the rank's device; the first dimension must
        divide the axis size."""
        t = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x)
        if self.axis is not None:
            n = axis_size(self.mesh, self.axis)
            if t.shape[0] % n:
                raise ValueError(
                    f"dimension {t.shape[0]} must divide mesh axis "
                    f"{self.axis!r} of size {n}; pad with "
                    "parallel.mesh.pad_to_multiple")
            rows = t.shape[0] // n
            i = axis_index(self.mesh, self.axis)
            t = t[i * rows:(i + 1) * rows]
        return t.to(mesh_device(self.mesh), copy=True).contiguous()


def replicated(mesh) -> Sharding:
    return Sharding(mesh)


def row_sharded(mesh, axis: str = MODEL_AXIS) -> Sharding:
    """First-dimension (row) sharding — embedding tables / item corpus."""
    return Sharding(mesh, axis)


def batch_sharded(mesh, axis: str = DATA_AXIS) -> Sharding:
    return Sharding(mesh, axis)


def params_shardings(params: dict, mesh) -> Dict[str, Sharding]:
    """Sharding of each two-tower param: embedding tables row-sharded on
    'model', dense MLP weights replicated (they are tiny; DP handles them)."""
    return {k: row_sharded(mesh) if k.endswith("_embed") else replicated(mesh)
            for k in params}


def shard_tree(params: dict, shardings: Dict[str, Sharding]) -> dict:
    """Each rank's params: its shard of each global array, on its device, as
    leaves that take gradients."""
    return {k: shardings[k].shard(v).float().requires_grad_(True)
            for k, v in params.items()}


@dataclass(frozen=True)
class AdamW:
    """The optimizer of the sharded steps:
    ``optax.chain(optax.clip_by_global_norm(clip_norm), optax.adamw(lr,
    weight_decay=weight_decay))`` — ``optax.adam(lr)`` with the defaults
    (no decay, no clipping). Every param is decayed, as optax's ``adamw``
    without a mask does. The JAX steps take any optax transformation; the
    port's trainers use this family only."""
    lr: float
    weight_decay: float = 0.0
    clip_norm: Optional[float] = None


class ShardedOptState:
    """Each rank's optimizer state: AdamW moments over its own params — the
    shards of the row-sharded ones — so the moments have the shard's shape
    (JAX has to pin them to the params' shardings, ``init_opt_sharded``;
    built from local tensors they cannot land elsewhere)."""

    def __init__(self, tx: AdamW, params: dict, mesh):
        self.tx = tx
        self.names = list(params)
        self.model_group = mesh.get_group(MODEL_AXIS)
        self.adam = OptaxAdamW([params[k] for k in self.names],
                               [True] * len(self.names), tx.weight_decay)
        # the Sharding of each leaf of state_dict(), set by init_opt_sharded
        self.shardings: dict = {}

    @property
    def sharded(self) -> List[bool]:
        """Per param, whether its moments (and gradient) are row shards."""
        return [self.shardings["mu"][k].axis is not None for k in self.names]

    @torch.no_grad()
    def apply_(self, grads: List[torch.Tensor]) -> None:
        """Clip (over the global norm of every shard) and step in place:
        the norm and the clip's factors first (``train.clip``), then the
        step with the clip's scale applied inside it (``train.adamw``; on
        the card one launch of ``csrc/adamw.cu``, which leaves the
        gradients as they were; elsewhere they are left clipped). Nothing
        reads the gradients afterwards."""
        with span("train.optim"):
            clip = None
            if self.tx.clip_norm is not None:
                with span("train.clip"):
                    clip = clip_factors(
                        sharded_global_norm(grads, self.sharded, self.model_group),
                        self.tx.clip_norm)
            with span("train.adamw"):
                self.adam.step(grads, self.tx.lr, clip=clip)

    def state_dict(self) -> dict:
        return {"mu": dict(zip(self.names, self.adam.mu)),
                "nu": dict(zip(self.names, self.adam.nu)),
                "count": torch.tensor(self.adam.count)}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        for i, k in enumerate(self.names):
            self.adam.mu[i].copy_(state["mu"][k])
            self.adam.nu[i].copy_(state["nu"][k])
        self.adam.count = int(state["count"])


def sharded_global_norm(grads: List[torch.Tensor], sharded: List[bool],
                        model_group) -> torch.Tensor:
    """The global norm of gradients of which some are row shards, a device
    scalar: the squared norm counts each replicated grad once and the
    shards' squares summed over the ``model`` group, so every rank reads
    the norm of the whole (global) gradient. Summing replicated grads over
    the group would count them once a model rank."""
    def sum_sq(gs):
        if not gs:
            return grads[0].new_zeros(())
        return torch.stack(torch._foreach_norm(gs)).square().sum()

    shard_sq = sum_sq([g for g, s in zip(grads, sharded) if s])
    dist.all_reduce(shard_sq, group=model_group)
    return torch.sqrt(sum_sq([g for g, s in zip(grads, sharded) if not s]) + shard_sq)


def clip_by_global_norm_sharded_(grads: List[torch.Tensor], sharded: List[bool],
                                 max_norm: float, model_group) -> None:
    """``optax.clip_by_global_norm`` over params of which some are row
    shards, in place, by :func:`sharded_global_norm`."""
    clip_(grads, clip_factors(sharded_global_norm(grads, sharded, model_group), max_norm))


def opt_shardings_like(params: dict, opt_state, mesh,
                       shardings: Optional[Dict[str, Sharding]] = None):
    """Sharding tree of an optimizer state (a :class:`ShardedOptState`'s
    ``state_dict()``, or any tree of dicts, lists and tuples): a dict that
    mirrors the param dict (AdamW's ``mu`` and ``nu``) takes the params'
    shardings key by key; every other leaf (the step count) is replicated.
    ``shardings`` defaults to :func:`params_shardings`."""
    pshard = params_shardings(params, mesh) if shardings is None else shardings
    rep = replicated(mesh)

    def rec(node):
        if isinstance(node, dict):
            if node.keys() == params.keys():
                return {k: pshard[k] for k in node}
            return {k: rec(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(rec(c) for c in node)
        return rep

    return rec(opt_state)


def init_opt_sharded(tx: AdamW, params: dict, mesh,
                     shardings: Optional[Dict[str, Sharding]] = None) -> ShardedOptState:
    """The optimizer state over this rank's params (already sharded), with
    the Sharding of each of its leaves (:func:`opt_shardings_like`)."""
    state = ShardedOptState(tx, params, mesh)
    state.shardings = opt_shardings_like(params, state.state_dict(), mesh, shardings)
    return state


def pad_to_multiple(x: np.ndarray, multiple: int, axis: int = 0) -> np.ndarray:
    """Pad a table so its sharded dimension divides the mesh axis."""
    n = x.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return x
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, rem)
    return np.pad(x, pad)
