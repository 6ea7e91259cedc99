"""The port's host-table module (``recommendit_tpu_torch/training/
host_table.py``) against the JAX package's.

* :class:`HostEmbeddingTable` is a copy: its class is pinned to the
  original by syntax tree, and its tables are bit for bit JAX's — the SFC64
  init in 1M-row f32 chunks, adagrad and sgd ``apply_grad`` with duplicate
  ids, the memmap backing, ``save`` / ``load_state`` with the
  ``.accum.npy`` file, read across packages.
* :class:`PrefetchIterator` (CPU tensors here): order and content at depth
  0, 1 and 2 as JAX's, the kept host positions untouched, exceptions
  re-raised; under a short switch interval no gathered row is torn by a
  concurrent ``apply_grad``.
* :func:`make_host_offload_step`: the loss, the row grads and the dense
  grads of the two towers and the in-batch BPR loss, and the dense params
  after one clipped AdamW step, against JAX's within 1e-6 (f32 sums in
  other orders over a few hundred terms).
"""
import ast
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from recommendit_tpu.models.two_tower import init_params as jax_init
from recommendit_tpu.models.two_tower import item_tower_from_embed as j_item
from recommendit_tpu.models.two_tower import user_tower_from_embed as j_user
from recommendit_tpu.ops.bpr import in_batch_bpr_loss_xla
from recommendit_tpu.training import host_table as jht
from recommendit_tpu_torch.models.two_tower import dense_from_jax_params
from recommendit_tpu_torch.models.two_tower import item_tower_from_embed as t_item
from recommendit_tpu_torch.models.two_tower import user_tower_from_embed as t_user
from recommendit_tpu_torch.ops.bpr import in_batch_bpr_loss
from recommendit_tpu_torch.training import host_table as tht
from recommendit_tpu_torch.training.train_embeddings import cosine_lr

ROOT = Path(__file__).resolve().parent.parent
MODULES = {"jax": jht, "port": tht}


def _class_ast(path: Path, name: str) -> str:
    tree = ast.parse(path.read_text())
    node = next(n for n in tree.body if isinstance(n, ast.ClassDef) and n.name == name)
    return ast.dump(node)


def test_table_class_is_the_jax_code():
    assert _class_ast(ROOT / "recommendit_tpu_torch/training/host_table.py",
                      "HostEmbeddingTable") == _class_ast(
        ROOT / "recommendit_tpu/training/host_table.py", "HostEmbeddingTable")


@pytest.mark.parametrize("n_rows,dim,scale,seed", [(10, 4, 0.05, 0), (257, 16, 0.1, 3),
                                                   ((1 << 20) + 5, 2, 0.1, 9)])
def test_init_is_bit_equal(n_rows, dim, scale, seed):
    """The SFC64 normal fill in 1M-row chunks (the last row past a chunk
    too), scaled in f32."""
    a = jht.HostEmbeddingTable(n_rows, dim, init_scale=scale, seed=seed)
    b = tht.HostEmbeddingTable(n_rows, dim, init_scale=scale, seed=seed)
    assert a.table.dtype == b.table.dtype == np.float32
    np.testing.assert_array_equal(a.table, b.table)


@pytest.mark.parametrize("optimizer", ["adagrad", "sgd"])
def test_apply_grad_is_bit_equal(optimizer):
    """Five steps of duplicate-heavy batches: the unique + ``np.add.at``
    accumulation, the row-wise adagrad accumulator, sgd."""
    rng = np.random.default_rng(1)
    tabs = [m.HostEmbeddingTable(50, 8, optimizer=optimizer, lr=0.3, seed=2)
            for m in (jht, tht)]
    for _ in range(5):
        ids = rng.integers(1, 12, size=64)
        grad = rng.normal(size=(64, 8)).astype(np.float32)
        for t in tabs:
            t.apply_grad(ids, grad)
    np.testing.assert_array_equal(tabs[0].table, tabs[1].table)
    if optimizer == "adagrad":
        np.testing.assert_array_equal(tabs[0]._accum, tabs[1]._accum)
    else:
        assert tabs[0]._accum is tabs[1]._accum is None


def test_duplicate_ids_accumulate_as_a_gather_gradient():
    """sgd ``apply_grad`` equals one sgd step on the dense gradient of a
    gather (duplicate ids summed), the JAX test's case through torch
    autograd."""
    t = tht.HostEmbeddingTable(10, 4, optimizer="sgd", lr=0.1, seed=0)
    table0 = torch.tensor(t.table.copy(), requires_grad=True)
    ids = np.array([2, 5, 2, 7])
    coeff = np.arange(16, dtype=np.float32).reshape(4, 4)
    (table0[torch.as_tensor(ids)] * torch.as_tensor(coeff)).sum().backward()
    t.apply_grad(ids, coeff)
    np.testing.assert_allclose(t.table, (table0 - 0.1 * table0.grad).detach().numpy(),
                               atol=1e-6)


def test_memmap_save_and_load_state_across_packages(tmp_path):
    """Memmap-backed tables; each package's ``save`` (``.npy`` appended,
    the accumulator beside it) read by the other's ``load_state``."""
    tabs = {}
    for name, m in MODULES.items():
        t = m.HostEmbeddingTable(100, 8, path=str(tmp_path / name / "t.npy"), seed=3)
        assert isinstance(t.table, np.memmap)
        t.apply_grad(np.array([0, 99, 99]), np.ones((3, 8), np.float32))
        t.save(str(tmp_path / name / "ckpt"))
        assert (tmp_path / name / "ckpt.npy.accum.npy").exists()
        tabs[name] = t
    np.testing.assert_array_equal(tabs["jax"].table, tabs["port"].table)
    for src, dst in (("jax", tht), ("port", jht)):
        back = dst.HostEmbeddingTable(100, 8, seed=9)
        back.load_state(str(tmp_path / src / "ckpt"))
        np.testing.assert_array_equal(back.table, tabs[src].table)
        np.testing.assert_array_equal(back._accum, tabs[src]._accum)


def test_bad_optimizer_raises():
    with pytest.raises(ValueError, match="unknown optimizer"):
        tht.HostEmbeddingTable(4, 2, optimizer="adamw")


def test_gather_is_a_copy():
    t = tht.HostEmbeddingTable(5, 2, seed=4)
    rows = t.gather(np.array([1, 1]))
    rows[:] = 7.0
    assert not np.any(t.table == 7.0)


def _batches():
    return [{"x": np.full((2, 3), i, np.float32), "i": np.array([i])} for i in range(7)]


@pytest.mark.parametrize("depth", [0, 1, 2])
def test_prefetch_order_and_content(depth):
    out = list(tht.PrefetchIterator(iter(_batches()), depth=depth, device="cpu"))
    want = list(jht.PrefetchIterator(iter(_batches()), depth=max(depth, 1)))
    assert len(out) == len(want) == 7
    for n, (b, w) in enumerate(zip(out, want)):
        assert isinstance(b["x"], torch.Tensor) and b["x"].device.type == "cpu"
        np.testing.assert_array_equal(b["x"].numpy(), np.asarray(w["x"]))
        assert int(b["i"][0]) == int(w["i"][0]) == n


def test_prefetch_keeps_host_positions():
    src = [(np.array([n, n]), {"r": np.full((2, 2), n, np.float32)}, None)
           for n in range(3)]
    for n, (ids, rows, extra) in enumerate(tht.PrefetchIterator(iter(src), depth=2,
                                                                device="cpu", keep=(0,))):
        assert isinstance(ids, np.ndarray) and ids.tolist() == [n, n]
        assert isinstance(rows["r"], torch.Tensor) and extra is None
    shipped = tht.to_device(src[0], "cpu", keep=(0,))
    assert isinstance(shipped[0], np.ndarray) and isinstance(shipped[1]["r"], torch.Tensor)


@pytest.mark.parametrize("depth", [0, 1, 2])
def test_prefetch_reraises_on_the_consumer(depth):
    def gen():
        yield np.zeros(2)
        raise RuntimeError("boom")

    it = tht.prefetch_to_device(gen(), depth=depth, device="cpu")
    assert torch.equal(next(it), torch.zeros(2, dtype=torch.float64))
    with pytest.raises(RuntimeError, match="boom"):
        next(it)


def test_prefetched_gathers_see_no_torn_row():
    """A prefetch thread gathers rows while the consumer updates them: every
    gathered row is one whole version (its elements all equal), at a switch
    interval short enough to interleave mid-update."""
    t = tht.HostEmbeddingTable(64, 256, optimizer="sgd", lr=1.0, seed=0)
    t.table[:] = 0.0
    rng = np.random.default_rng(0)
    ids = [rng.integers(0, 64, size=32) for _ in range(300)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        it = tht.PrefetchIterator((t.gather(i) for i in ids), depth=2, device="cpu")
        n = 0
        for rows in it:
            t.apply_grad(ids[n], -np.ones((32, 256), np.float32))
            assert (rows == rows[:, :1]).all()
            n += 1
    finally:
        sys.setswitchinterval(old)
    assert n == 300
    assert t.table.sum() == 300 * 32 * 256


def test_prefetch_worker_ends_with_its_source():
    it = tht.PrefetchIterator(iter(_batches()), depth=2, device="cpu")
    assert len(list(it)) == 7
    it._thread.join(timeout=10)
    assert not it._thread.is_alive()


# --- make_host_offload_step against JAX's ---------------------------------- #

B, D, H = 32, 16, 24


def _step_inputs(seed=0):
    rng = np.random.default_rng(seed)
    dense = {k: np.asarray(v) for k, v in jax_init(jax.random.PRNGKey(seed), 1, 1, D, H).items()
             if k not in ("user_embed", "item_embed", "item_bias")}
    rows = {"u": (0.1 * rng.normal(size=(B, D))).astype(np.float32),
            "i": (0.1 * rng.normal(size=(B, D))).astype(np.float32)}
    genre = (rng.random(size=(B, 18)) < 0.2).astype(np.float32)
    return dense, rows, genre


def _jax_loss(dense, rows, batch):
    ue = j_user(dense, rows["u"])
    ie = j_item(dense, rows["i"], batch["genre"])
    return in_batch_bpr_loss_xla(ue, ie)


def _port_loss(dense, rows, batch):
    ue = t_user(dense, rows["u"])
    ie = t_item(dense, rows["i"], batch["genre"])
    return in_batch_bpr_loss(ue, ie)


def _close(got, want, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=atol)


def test_offload_step_grads_match_jax():
    dense, rows, genre = _step_inputs()
    jl, jrow, jdense = jht.make_host_offload_step(_jax_loss)(
        dense, rows, {"genre": jnp.asarray(genre)})
    tl, trow, tdense = tht.make_host_offload_step(_port_loss)(
        dense_from_jax_params(dense, device="cpu"),
        {k: torch.as_tensor(v) for k, v in rows.items()},
        {"genre": torch.as_tensor(genre)})
    _close(tl, jl)
    assert sorted(trow) == sorted(jrow) and sorted(tdense) == sorted(jdense)
    for k in jrow:
        _close(trow[k], jrow[k], atol=1e-7)
    for k in jdense:
        _close(tdense[k], jdense[k])


def test_a_parameter_the_loss_does_not_reach_gets_a_zero_grad():
    dense, rows, genre = _step_inputs()
    dense["unused"] = np.ones(3, np.float32)
    step = tht.make_host_offload_step(_port_loss)
    _, _, g = step(dense_from_jax_params(dense, device="cpu"),
                   {k: torch.as_tensor(v) for k, v in rows.items()},
                   {"genre": torch.as_tensor(genre)})
    assert torch.equal(g["unused"], torch.zeros(3))


def test_fused_adamw_step_matches_optax():
    """One fused step: the dense params after ``clip_by_global_norm`` and
    AdamW (a tiny clip norm so the clip acts, weight decay on), the row
    grads raw."""
    dense, rows, genre = _step_inputs(seed=1)
    lr, wd, clip = 1e-2, 1e-2, 0.05
    sched = optax.cosine_decay_schedule(lr, decay_steps=10)
    tx = optax.chain(optax.clip_by_global_norm(clip),
                     optax.adamw(sched, weight_decay=wd,
                                 mask={k: True for k in dense}))
    jdense = {k: jnp.asarray(v) for k, v in dense.items()}
    jstep = jht.make_host_offload_step(_jax_loss, tx=tx)
    jd, _, jl, jrow = jstep(jdense, tx.init(jdense), rows, {"genre": jnp.asarray(genre)})

    ttx = tht.DenseAdamW(lambda c: cosine_lr(lr, c, 10), clip, wd, lambda k: True)
    td = dense_from_jax_params(dense, device="cpu")
    state = ttx.init(td)
    tstep = tht.make_host_offload_step(_port_loss, tx=ttx)
    td2, state2, tl, trow = tstep(td, state, {k: torch.as_tensor(v) for k, v in rows.items()},
                                  {"genre": torch.as_tensor(genre)})
    assert td2 is td and state2 is state and state.count == 1
    _close(tl, jl)
    for k in jrow:
        _close(trow[k], jrow[k], atol=1e-7)
    for k in jd:
        assert not np.array_equal(td[k].numpy(), dense[k]) or not np.any(dense[k])
        _close(td[k], jd[k])


def test_pinned_staging_slot_reuses_its_buffers(monkeypatch):
    """The staging slot keys its pinned buffers by position, shape and
    dtype, so a steady stream allocates once (the CUDA path's layout,
    checked without a card: ``pin_memory`` needs one)."""
    slot = tht._StagingSlot()
    calls = []
    real = torch.empty

    def fake_empty(*args, **kw):
        calls.append(kw.pop("pin_memory", False))
        return real(*args, **kw)

    monkeypatch.setattr(torch, "empty", fake_empty)
    for n in range(3):
        a = slot.stage(0, np.full((2, 3), n, np.float32))
        b = slot.stage(1, np.arange(4, dtype=np.int32) + n)
    assert calls == [True, True]
    assert a.tolist() == [[2.0] * 3] * 2 and b.tolist() == [2, 3, 4, 5]
    assert b.dtype == torch.int32
