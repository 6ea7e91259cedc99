"""The port's trainer and index builder against the JAX ones.

Both trainers start from the same weights (JAX's ``init_params`` carried
across with ``from_jax_params``) and see the same batches (the same numpy
generator), and the port's AdamW rounds as optax's does. With dropout off
nothing else is random, so two epochs must agree step for step: per-epoch
losses within 1e-6 relative, final params and catalog embeddings within
1e-6 absolute (f32 sums in other orders, through 12 AdamW steps; the
largest differences seen are 2.6e-7 relative on a loss and 3.4e-7 on a
param of size ~0.3, where ``torch.optim.AdamW`` left 1.3e-6).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from recommendit_tpu.config import Settings
from recommendit_tpu.data.synthetic import make_synthetic_movielens as jax_synth
from recommendit_tpu.models.two_tower import TwoTowerModel
from recommendit_tpu.models.two_tower import init_params as jax_init
from recommendit_tpu.training import train_embeddings as jte
from recommendit_tpu.training.build_index import IndexBuilder as JaxIndexBuilder
from recommendit_tpu_torch.data.synthetic import make_synthetic_movielens
from recommendit_tpu_torch.models.two_tower import from_jax_params
from recommendit_tpu_torch.training import EmbeddingTrainer, IndexBuilder
from recommendit_tpu_torch.training import train_embeddings as tte

DATA = dict(n_users=120, n_items=90, n_ratings=4000, seed=1)
DIM, HIDDEN = 16, 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The training loops here run many tiny ops. With several test workers
    on one machine, torch's default pool of one spinning thread per core
    oversubscribes it (a 3 s rehearsal took 110 s); one thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    return jax_synth(**DATA), make_synthetic_movielens(**DATA)


def _cfg(**kw):
    base = dict(DROPOUT=0.0, BATCH_SIZE=256, EMBEDDING_DIM=DIM, HIDDEN_DIM=HIDDEN)
    base.update(kw)
    return Settings(**base)


def _carried_init(trainer, seed):
    params = jax_init(jax.random.PRNGKey(seed), trainer.n_users,
                      trainer.n_items, DIM, HIDDEN)
    return from_jax_params({k: np.asarray(v) for k, v in params.items()}, device="cpu")


def _train_both(data, mode, epochs=2, **cfg_kw):
    jd, td = data
    cfg = _cfg(**cfg_kw)
    jt = jte.EmbeddingTrainer(jd, cfg, loss_mode=mode, model_output_path="")
    jm = jt.train(epochs=epochs)
    tt = EmbeddingTrainer(td, cfg, loss_mode=mode, model_output_path="", device="cpu")
    tm = tt.train(epochs=epochs, init_params=_carried_init(jt, cfg.SEED))
    return jt, jm, tt, tm


@pytest.mark.parametrize("mode", ["in_batch", "softmax", "pairwise"])
def test_trainer_matches_jax_step_for_step(data, mode):
    jt, jm, tt, tm = _train_both(data, mode)
    jl = [h["loss"] for h in jt.history]
    tl = [h["loss"] for h in tt.history]
    np.testing.assert_allclose(tl, jl, rtol=1e-6, atol=0)
    assert [h["epoch"] for h in tt.history] == [1, 2]
    assert all(h["examples_per_s"] > 0 for h in tt.history)
    for name, v in jm.params.items():
        np.testing.assert_allclose(getattr(tm, name).detach().numpy(),
                                   np.asarray(v), rtol=0, atol=1e-6,
                                   err_msg=name)
    np.testing.assert_allclose(tm._item_embeddings, jm._item_embeddings,
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tm._item_ids, jm._item_ids)


def test_dropout_losses_lie_in_the_seed_band(data):
    """Dropout 0.2: the two frameworks draw different masks, so only the
    statistics can agree. Band = the spread (max − min) of JAX's final
    losses over seeds 0, 1, 2 (0.0047 when written). The mean of the port's
    final losses must lie within one band of JAX's mean, and each seed's
    pair within two bands. Dropout must also change the port's losses."""
    jax_final, port_final = [], []
    for seed in range(3):
        jt, _, tt, _ = _train_both(data, "in_batch", DROPOUT=0.2, SEED=seed)
        jax_final.append(jt.history[-1]["loss"])
        port_final.append(tt.history[-1]["loss"])
    band = max(jax_final) - min(jax_final)
    assert band > 0
    assert abs(np.mean(port_final) - np.mean(jax_final)) <= band
    assert np.max(np.abs(np.subtract(port_final, jax_final))) <= 2 * band
    off = EmbeddingTrainer(data[1], _cfg(SEED=0), loss_mode="in_batch",
                           model_output_path="", device="cpu")
    off.train(epochs=2, init_params=_carried_init(off, 0))
    assert off.history[-1]["loss"] != port_final[0]


def test_helpers_equal_jax_bit_for_bit(data):
    jd, td = data
    jt = jte.EmbeddingTrainer(jd, _cfg(), loss_mode="softmax",
                              model_output_path="")
    tt = EmbeddingTrainer(td, _cfg(), loss_mode="softmax", model_output_path="", device="cpu")
    np.testing.assert_array_equal(tt.pos_users, jt.pos_users)
    np.testing.assert_array_equal(tt.pos_items, jt.pos_items)
    np.testing.assert_array_equal(tt.genre_table, jt.genre_table)
    np.testing.assert_array_equal(
        tte.build_genre_table(td.item_ids, td.genres, 60),
        jte.build_genre_table(jd.movies, 60))
    np.testing.assert_array_equal(
        tte.warm_start_item_bias(tt.pos_items, tt.n_items),
        jte.warm_start_item_bias(jt.pos_items, jt.n_items))
    np.testing.assert_array_equal(tt._log_q_table(), jt._log_q_table())


@pytest.mark.parametrize("mode", ["in_batch", "pairwise"])
def test_epoch_batches_equal_jax(data, mode):
    jd, td = data
    jt = jte.EmbeddingTrainer(jd, _cfg(), loss_mode=mode, model_output_path="")
    tt = EmbeddingTrainer(td, _cfg(), loss_mode=mode, model_output_path="", device="cpu")
    jr, tr = np.random.default_rng(9), np.random.default_rng(9)
    for _ in range(2):
        for a, b in zip(tt._epoch_batches(tr, 100), jt._epoch_batches(jr, 100)):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype


def test_cosine_schedule_equals_optax():
    """Within 2 f32 ulps: numpy's and XLA's f32 cosines may round the last
    bit differently."""
    sched = optax.cosine_decay_schedule(1e-3, decay_steps=37)
    counts = range(0, 40)
    got = [tte.cosine_lr(1e-3, c, 37) for c in counts]
    want = [float(sched(jnp.asarray(c, jnp.int32))) for c in counts]
    np.testing.assert_allclose(got, want, rtol=2.4e-7, atol=0)
    assert got[0] == float(np.float32(1e-3)) and got[37:] == [0.0, 0.0, 0.0]


@pytest.mark.parametrize("scale", [0.1, 10.0])
def test_clip_by_global_norm_equals_optax(scale):
    rng = np.random.default_rng(4)
    grads = [scale * rng.normal(size=s).astype(np.float32)
             for s in [(7, 3), (5,), (2, 2, 2)]]
    want, _ = optax.clip_by_global_norm(1.0).update(
        [jnp.asarray(g) for g in grads], None)
    got = [torch.tensor(g) for g in grads]
    tte.clip_by_global_norm_(got, 1.0)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=0)
    if scale < 1:
        assert all(torch.equal(a, torch.tensor(g)) for a, g in zip(got, grads))


@pytest.mark.parametrize("mode", ["softmax", "in_batch"])
def test_index_builder_saves_the_jax_index(data, mode, tmp_path):
    """Same params → same saved index: embeddings, ids, the bias scaled by
    the temperature, and no bias at all for a bias-free checkpoint."""
    jd, td = data
    cfg = _cfg(INDEX_MODE="exact")
    jt = jte.EmbeddingTrainer(jd, cfg, loss_mode=mode, model_output_path="")
    params = jax_init(jax.random.PRNGKey(0), jt.n_users, jt.n_items, DIM, HIDDEN)
    if mode == "softmax":
        params["item_bias"] = jnp.asarray(
            jte.warm_start_item_bias(jt.pos_items, jt.n_items))
    jm = TwoTowerModel(jt.n_users, jt.n_items, DIM, HIDDEN, params=params)
    tm = from_jax_params({k: np.asarray(v) for k, v in params.items()}, device="cpu")
    JaxIndexBuilder(jd, cfg, index_output_path=str(tmp_path / "j.npz")).build(model=jm)
    index = IndexBuilder(td, cfg, index_output_path=str(tmp_path / "t.npz"), device="cpu").build(model=tm)
    with np.load(tmp_path / "j.npz") as want, np.load(tmp_path / "t.npz") as got:
        assert sorted(got.files) == sorted(want.files)
        np.testing.assert_array_equal(got["item_ids"], want["item_ids"])
        np.testing.assert_allclose(got["embeddings"], want["embeddings"],
                                   atol=1e-5, rtol=0)
        if mode == "softmax":
            np.testing.assert_array_equal(got["bias"], want["bias"])
        else:
            assert "bias" not in got.files
    assert index.has_bias == (mode == "softmax")


def test_trained_model_saves_in_the_jax_format(data, tmp_path):
    path = str(tmp_path / "tt.npz")
    tt = EmbeddingTrainer(data[1], _cfg(), loss_mode="in_batch",
                          model_output_path=path, device="cpu")
    tm = tt.train(epochs=1)
    back = TwoTowerModel.load(path)
    for name, v in back.params.items():
        np.testing.assert_array_equal(np.asarray(v), getattr(tm, name).detach().numpy())
    built = IndexBuilder(data[1], _cfg(), model_path=path,
                         index_output_path=str(tmp_path / "i.npz"), device="cpu").build()
    assert built.n_total == tt.n_items


def test_unported_options_raise(data, tmp_path):
    """Building from streamed embeddings is ported (a host-table run's
    index; ``tests/test_torch_host_train.py`` holds it to JAX's files): the
    rows 1-based, the raw bias scaled by the temperature."""
    td = data[1]
    embs = np.random.default_rng(0).normal(size=(3, DIM)).astype(np.float32)
    index = IndexBuilder(td, _cfg(), index_output_path=str(tmp_path / "e.npz"),
                         device="cpu").build(embeddings=embs, bias=np.ones(3, np.float32))
    assert index.n_total == 3 and index.item_ids.tolist() == [1, 2, 3]
    np.testing.assert_allclose(index._bias_np, _cfg().SOFTMAX_TEMPERATURE)


def test_checkpoint_resume_matches_jax(data, tmp_path):
    """2 epochs with checkpoints, then a resume to epoch 3, on each side
    from the same init, dropout off: the epoch-3 loss within 1e-6 relative
    and the final towers within 1e-6, as the uninterrupted parity. As in
    JAX, the resumed run's batches restart from the seed, so it is not the
    uninterrupted 3-epoch run."""
    jd, td = data
    cfg = _cfg()
    jt = jte.EmbeddingTrainer(jd, cfg, loss_mode="in_batch", model_output_path="",
                              ckpt_dir=str(tmp_path / "jax"))
    jt.train(epochs=2)
    jr = jte.EmbeddingTrainer(jd, cfg, loss_mode="in_batch", model_output_path="")
    jm = jr.train(epochs=3, resume_from=str(tmp_path / "jax" / "best"))
    tt = EmbeddingTrainer(td, cfg, loss_mode="in_batch", model_output_path="",
                          ckpt_dir=str(tmp_path / "port"), device="cpu")
    tt.train(epochs=2, init_params=_carried_init(tt, cfg.SEED))
    assert (tmp_path / "port" / "best").is_file()
    tr = EmbeddingTrainer(td, cfg, loss_mode="in_batch", model_output_path="",
                          ckpt_dir=str(tmp_path / "port2"), device="cpu")
    tm = tr.train(epochs=3, resume_from=str(tmp_path / "port" / "best"))
    assert [h["epoch"] for h in tr.history] == [h["epoch"] for h in jr.history] == [3]
    np.testing.assert_allclose(tr.history[0]["loss"], jr.history[0]["loss"], rtol=1e-6)
    for name, v in jm.params.items():
        np.testing.assert_allclose(getattr(tm, name).detach().numpy(), np.asarray(v),
                                   rtol=0, atol=1e-6, err_msg=name)
    # the state holds the AdamW moments and count, and the epoch
    from recommendit_tpu_torch.utils.checkpoint import load_train_state

    state = load_train_state(str(tmp_path / "port2" / "best"))
    assert int(state["epoch"]) == 3
    assert int(state["opt_state"]["count"]) == 3 * tr.history[0]["steps"]
    assert sorted(state["opt_state"]["mu"]) == sorted(state["params"]) == sorted(jm.params)


def test_bad_arguments_raise(data):
    td = data[1]
    with pytest.raises(ValueError, match="loss mode"):
        EmbeddingTrainer(td, _cfg(), loss_mode="listwise", device="cpu")
    tt = EmbeddingTrainer(td, _cfg(EMBEDDING_DIM=8), model_output_path="", device="cpu")
    with pytest.raises(ValueError, match="init_params sizes"):
        tt.train(epochs=1, init_params=_carried_init(tt, 0))


def _adamw_gaps(lr, wd, torch_adamw=False, steps=50):
    """Max |port − optax| over a 256 x 64 decayed matrix and a 256 bias
    vector without decay, after each of ``steps`` updates with seeded
    gradients (optax's update jitted, as the JAX trainer runs it), and the
    f32 ulp of the largest initial param."""
    rng = np.random.default_rng(11)
    p0 = {"w": (0.3 * rng.normal(size=(256, 64))).astype(np.float32),
          "b": (0.3 * rng.normal(size=256)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32) for k, v in p0.items()}
             for _ in range(steps)]
    tx = optax.adamw(lr, weight_decay=wd, mask={"w": True, "b": False})
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(jp)

    @jax.jit
    def jstep(params, state, g):
        upd, state = tx.update(g, state, params)
        return optax.apply_updates(params, upd), state

    w, b = (torch.tensor(p0[k]) for k in ("w", "b"))
    if torch_adamw:
        opt = torch.optim.AdamW([{"params": [w], "weight_decay": wd},
                                 {"params": [b], "weight_decay": 0.0}],
                                lr=lr, betas=(tte.ADAM_B1, tte.ADAM_B2),
                                eps=tte.ADAM_EPS)
    else:
        opt = tte.OptaxAdamW([w, b], [True, False], wd)
    gaps = []
    for g in grads:
        jp, state = jstep(jp, state, {k: jnp.asarray(v) for k, v in g.items()})
        gw, gb = torch.tensor(g["w"]), torch.tensor(g["b"])
        if torch_adamw:
            w.grad, b.grad = gw, gb
            opt.step()
        else:
            opt.step([gw, gb], lr)
        gaps.append(max(float(np.abs(w.numpy() - np.asarray(jp["w"])).max()),
                        float(np.abs(b.numpy() - np.asarray(jp["b"])).max())))
    ulp = float(np.spacing(max(np.abs(v).max() for v in p0.values())))
    return np.asarray(gaps), ulp


@pytest.mark.parametrize("lr,wd", [(1e-3, 1e-5), (1e-2, 0.1)])
def test_adamw_rounds_as_optax(lr, wd):
    """The port's update stays as close to optax's after 50 steps as after
    the first, within 2 ulps of the largest param: no rounding difference
    accumulates (measured: 1 ulp at most, flat from step 5 on)."""
    gaps, ulp = _adamw_gaps(lr, wd)
    assert gaps.max() <= gaps[0] + 2 * ulp, (gaps[[0, 19, 49]], ulp)


@pytest.mark.parametrize("lr,wd", [(1e-3, 1e-5), (1e-2, 0.1)])
def test_torch_adamw_drifts_from_optax(lr, wd):
    """The same comparison fails for ``torch.optim.AdamW``: its decay
    factor (1 − lr·wd) rounds differently (to 1 at the defaults), and the
    gap grows with the steps (measured: 7 and 23 ulps at step 50)."""
    gaps, ulp = _adamw_gaps(lr, wd, torch_adamw=True)
    assert gaps[-1] > gaps[0] + 2 * ulp, (gaps[[0, 19, 49]], ulp)
