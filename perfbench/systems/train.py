"""The training system under test: the port's sharded two-tower step
(``parallel.train.make_sharded_train_step`` over ``init_opt_sharded``) on
the ranks of a ``('data', 'model')`` mesh, one card a rank.

A configuration with ``"mesh": [1, 1]`` and ``"of_shards": 4`` runs one
rank of a four-rank deployment on one card: the rank holds exactly the rows
that rank holds (its shard of each table, the item bias and genre table
whole), and the batch's ids are drawn among them; no collective crosses a
wire. With ``"mesh": [1, 4]`` the session is rank 0 of four: it starts
ranks 1–3 as processes of their own (:func:`_follow`), each with its own
session, and has each of them make every call it makes, in its order, so
that their collectives meet.

Set-up draws each rank's params on its card from the seed, builds the step,
and drives it through its first three steps on three different batches
(the window's own call), reading the program's loss each step, the first
gradient's norm per leaf from the optimizer's first moment after step 1,
and each leaf's change after step 3. The window goes on from batch 3.
After the window the program's state is freed and the plain reference
follows the same three steps.
"""
from __future__ import annotations

import contextlib
import gc
import math
import socket
from types import SimpleNamespace

import torch

from perfbench import inputs, judge
from perfbench.reference import twotower_train as ref
from perfbench.seeds import derive

B1_F32 = 0.10000000149011612     # float32(1 - 0.9): the factor of the first moment
WARM_STEPS = 3
TABLES = ("user_embed", "item_embed")
FOLLOWER_JOIN_S = 120


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dropout_generator(seed: int, device) -> torch.Generator:
    """The generator of the dropout masks, the program's and the reference's
    (the same on every rank: the mesh's data axis is 1)."""
    return torch.Generator(device=device).manual_seed(derive(seed, "dropout"))


def reference(cfg: dict, seed: int, shard: int, device, prec: str = "f32",
              group=None) -> ref.Reference:
    """The plain reference of shard ``shard``, its params drawn again."""
    return ref.Reference(inputs.train_params(cfg, seed, shard, device),
                         inputs.genre_table(cfg, seed, device), cfg,
                         dropout_generator(seed, device),
                         lambda name: inputs.train_redraw(cfg, seed, shard, name, device), prec,
                         shard, group)


def _follow(rank: int, world: int, port: int, config: dict, traffic: dict, seed: int,
            device: str, conn) -> None:
    """Rank ``rank``'s process: a session of its own, making each call that
    rank 0 sends, in order, until ``None``."""
    from perfbench.traffic import make_batches

    cell = SimpleNamespace(config=config, traffic=traffic)
    sess = Session(cell, seed, device, rank=rank, world=world, port=port)
    batches = make_batches(traffic, seed, sess.sizes, sess.device)
    while True:
        msg = conn.recv()
        if msg is None:
            break
        name, args = msg
        if name == "call":
            args = (batches[args[0]],)
        elif name in ("warm", "numbers"):
            args = (batches,)
        getattr(sess, name)(*args)
    conn.close()


class Session:
    def __init__(self, cell, seed: int, device, rank: int = 0, world: int = 0,
                 port: int = 0):
        import torch.distributed as dist

        from recommendit_tpu_torch.parallel.mesh import (
            MODEL_AXIS,
            AdamW,
            axis_index,
            create_mesh,
            distributed_init,
            init_opt_sharded,
        )
        from recommendit_tpu_torch.parallel.train import make_sharded_train_step

        self.cfg = cfg = cell.config
        self.seed = seed
        self.limits = cfg["checks"]
        self.marker = cfg["trace_marker"]
        self.batch = int(cell.traffic["batch"])
        self.rows = self.batch
        self.rank, self.world = rank, world or math.prod(cfg["mesh"])
        self._peers = []
        dev_type = torch.device(device).type
        if self.world > 1 and rank == 0:
            port = _free_port()
            self._start_peers(cell, seed, port, dev_type)
        if not dist.is_initialized():
            distributed_init(init_method=f"tcp://127.0.0.1:{port or _free_port()}",
                             world_size=self.world, rank=rank, device=dev_type)
        self.device = torch.device("cuda", torch.cuda.current_device()) \
            if dev_type == "cuda" else torch.device("cpu")
        self.mesh = create_mesh(shape=tuple(cfg["mesh"]))
        self.group = dist.group.WORLD if self.world > 1 else None
        self.shard = axis_index(self.mesh, MODEL_AXIS)
        self.sizes = inputs.train_sizes(cfg)
        params = inputs.train_params(cfg, seed, self.shard, self.device)
        self.params = {k: v.requires_grad_(True) for k, v in params.items()}
        tx = AdamW(float(cfg["lr"]), weight_decay=float(cfg["weight_decay"]),
                   clip_norm=float(cfg["clip_norm"]))
        self.step = make_sharded_train_step(self.mesh, tx,
                                            inputs.genre_table(cfg, seed, self.device),
                                            dropout_rate=float(cfg["dropout"]))
        self.state = init_opt_sharded(tx, self.params, self.mesh)
        self.gen = dropout_generator(seed, self.device)
        self.numel = sum(p.numel() for p in self.params.values())
        self._index = {}
        self._trace = None
        self._busy = (0.0, 0.0)

        # the optimizer, wrapped to open its layer range in a traced run
        self._ranges = False
        apply = self.state.apply_

        def apply_(grads):
            with (torch.profiler.record_function("perfbench.optim") if self._ranges
                  else contextlib.nullcontext()):
                apply(grads)

        self.state.apply_ = apply_
        self.prog = None

    # --- ranks 1 … of a world: processes that make rank 0's calls ----------- #

    def _start_peers(self, cell, seed: int, port: int, device: str) -> None:
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        for r in range(1, self.world):
            ours, theirs = ctx.Pipe()
            proc = ctx.Process(target=_follow, daemon=True,
                               args=(r, self.world, port, dict(cell.config),
                                     dict(cell.traffic), seed, device, theirs))
            proc.start()
            theirs.close()
            self._peers.append((proc, ours))

    def _tell(self, name: str, *args) -> None:
        for _, conn in self._peers:
            conn.send((name, args))

    def _stop_peers(self) -> None:
        for _, conn in self._peers:
            conn.send(None)
            conn.close()
        for proc, _ in self._peers:
            proc.join(FOLLOWER_JOIN_S)
            if proc.is_alive():
                proc.kill()
                proc.join()
                raise RuntimeError(f"rank process {proc.pid} did not end")
            if proc.exitcode:
                raise RuntimeError(f"rank process {proc.pid} exited {proc.exitcode}")
        self._peers = []

    # --- the timed path ---------------------------------------------------- #

    def call(self, batch):
        self._tell("call", self._index.get(id(batch)))
        return self._step(batch)

    def _step(self, batch):
        with (torch.profiler.record_function("perfbench.batch") if self._trace is not None
              else contextlib.nullcontext()):
            self.params, self.state, loss = self.step(
                self.params, self.state, (batch["user"], batch["item"]), self.gen)
        return loss

    finish = None

    def drain(self) -> None:
        self.sync()

    def on_result(self, i: int, out, host) -> None:
        pass

    def sync(self) -> None:
        self._tell("sync")
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warm(self, batches) -> int:
        """The first three steps on batches 0-2, with the program's
        readings (the tables' norms summed over the ranks); the window
        starts at batch 3."""
        self._index = {id(b): k for k, b in enumerate(batches)}
        self._tell("warm")
        losses = []
        for k in range(WARM_STEPS):
            losses.append(float(self._step(batches[k])))
            if k == 0:
                mu = self.state.state_dict()["mu"]
                sq = ref.group_sum({n: float(torch.linalg.vector_norm(mu[n])) ** 2
                                    for n in mu}, self.group, TABLES)
                grad_norms = {n: math.sqrt(v) / B1_F32 for n, v in sq.items()}
        redraw = lambda name: inputs.train_redraw(self.cfg, self.seed, self.shard,  # noqa: E731
                                                  name, self.device)
        self.prog = {"losses": losses, "grad_norms": grad_norms,
                     "delta_norms": ref.delta_norms(self.params, redraw, self.group, TABLES)}
        return WARM_STEPS

    def layer_ranges(self, on: bool) -> None:
        """Open the layer ranges; ranks 1 … also profile the same span (rank
        0's profiler is the harness's)."""
        self._tell("layer_ranges", on)
        self._ranges = on
        if self.rank == 0:
            return
        from perfbench.trace import capture, summarize

        if on:
            self._trace = capture(lambda: None)
            self._events = self._trace.__enter__()
            self._window = torch.profiler.record_function("perfbench.window")
            self._window.__enter__()
        else:
            self.sync()
            self._window.__exit__(None, None, None)
            self._trace.__exit__(None, None, None)
            s = summarize(self._events["events"])
            self._busy = (s.busy_s, s.window_s)
            self._trace = self._events = self._window = None

    def busy(self, summary=None) -> tuple:
        """(busy_s, window_s) of the traced window, averaged over the ranks."""
        self._tell("busy")
        if summary is not None:
            self._busy = (summary.busy_s, summary.window_s)
        if self.group is None:
            return self._busy
        import torch.distributed as dist

        t = torch.tensor(self._busy, dtype=torch.float64, device=self.device)
        dist.all_reduce(t, group=self.group)
        return tuple((t / self.world).tolist())

    def memory_peak_bytes(self) -> int:
        """The largest ``max_memory_allocated`` over the ranks."""
        self._tell("memory_peak_bytes")
        if self.device.type != "cuda":
            return 0
        peak = torch.cuda.max_memory_allocated(self.device)
        if self.group is None:
            return int(peak)
        import torch.distributed as dist

        t = torch.tensor([peak], dtype=torch.float64, device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return int(t)

    def facts(self) -> dict:
        return {"batch": self.batch, "numel": self.numel}

    def release(self) -> None:
        self._tell("release")
        self.params = self.state = self.step = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # --- the check --------------------------------------------------------- #

    def numbers(self, batches) -> dict:
        """The reference's readings against the program's, on every rank in
        step; then ranks 1 … end and the process group is closed."""
        import torch.distributed as dist

        self._tell("numbers")
        want = ref.run(reference(self.cfg, self.seed, self.shard, self.device,
                                 group=self.group), batches, WARM_STEPS)
        out = judge.train_numbers(self.prog, want)
        dist.destroy_process_group()       # on every rank, before any ends
        if self._peers:
            self._stop_peers()
        return out
