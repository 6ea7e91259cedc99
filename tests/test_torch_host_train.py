"""The port's host-table trainer (``recommendit_tpu_torch/training/
host_train.py``) and its pipeline hooks against the JAX package's.

Both trainers start from the same host tables (the same SFC64 arrays: the
table class is a copy) and the same dense params (JAX's ``_init_dense``
carried across with ``dense_from_jax_params``), and see the same batches
(the same numpy generator). With dropout off and prefetch 0 nothing else is
random, so two epochs agree step for step in every loss mode and for both
row optimizers: per-epoch losses within 1e-5 relative, both tables within
1e-5 absolute after 2 epochs (f32 sums in other orders through ~120 dense
AdamW steps and row updates; JAX runs its in-batch loss as XLA, the port
its twin). With prefetch 2 the gathers run ahead of the updates, as in
JAX: the loss falls and the padding rows stay zero.
"""
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from recommendit_tpu.config import Settings
from recommendit_tpu.data.synthetic import make_synthetic_movielens as jax_synth
from recommendit_tpu.models.retrieval import MIPSIndex as JaxIndex
from recommendit_tpu.models.two_tower import TwoTowerModel
from recommendit_tpu.training.build_index import IndexBuilder as JaxIndexBuilder
from recommendit_tpu.training.host_train import HostTableEmbeddingTrainer as JaxTrainer
from recommendit_tpu.training.train_embeddings import build_genre_table as jax_build_genre_table
from recommendit_tpu_torch.data.synthetic import make_synthetic_movielens
from recommendit_tpu_torch.models import MIPSIndex
from recommendit_tpu_torch.models.two_tower import dense_from_jax_params
from recommendit_tpu_torch.pipelines import PipelineOrchestrator
from recommendit_tpu_torch.scripts import host_table_scale
from recommendit_tpu_torch.training import IndexBuilder
from recommendit_tpu_torch.training.host_train import STEP_PARTS, HostTableEmbeddingTrainer
from recommendit_tpu_torch.training.train_embeddings import build_genre_table

DATA = dict(n_users=80, n_items=60, n_ratings=4000, seed=1)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many tiny ops: one torch thread per test worker (see
    ``tests/test_torch_training.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    return jax_synth(**DATA), make_synthetic_movielens(**DATA)


def _cfg(**kw):
    base = dict(EMBEDDING_DIM=16, HIDDEN_DIM=24, BATCH_SIZE=64, TRAIN_EPOCHS=2,
                DROPOUT=0.0, LOSS_MODE="in_batch", HOST_TABLE=True,
                HOST_TABLE_OPTIMIZER="sgd", HOST_TABLE_LR=0.1,
                HOST_TABLE_PREFETCH=0, USE_PALLAS=False, SEED=3)
    base.update(kw)
    return Settings(**base)


def _jax_dense(jt, params):
    """JAX's dense params as the port keeps them: outside softmax mode JAX
    keeps ``init_params(…, 1, 1, …)``'s (2,) item bias, which no loss reads
    (C.46); the port carries none."""
    return {k: np.asarray(v) for k, v in params.items()
            if k != "item_bias" or jt.loss_mode == "softmax"}


def _train_both(data, **cfg_kw):
    jd, td = data
    cfg = _cfg(**cfg_kw)
    jt = JaxTrainer(jd, cfg, model_output_path="")
    dense = _jax_dense(jt, jt._init_dense())
    jm = jt.train()
    tt = HostTableEmbeddingTrainer(td, cfg, model_output_path="", device="cpu")
    tm = tt.train(init_dense=dense_from_jax_params(dense, device="cpu"))
    return jt, jm, tt, tm


@pytest.mark.parametrize("optimizer", ["sgd", "adagrad"])
@pytest.mark.parametrize("mode", ["in_batch", "softmax", "pairwise"])
def test_trainer_matches_jax_step_for_step(data, mode, optimizer):
    jt, jm, tt, tm = _train_both(data, LOSS_MODE=mode, HOST_TABLE_OPTIMIZER=optimizer)
    np.testing.assert_array_equal(tt.pos_users, jt.pos_users)
    np.testing.assert_array_equal(tt.pos_items, jt.pos_items)
    np.testing.assert_allclose([h["loss"] for h in tt.history],
                               [h["loss"] for h in jt.history], rtol=1e-5, atol=0)
    for side in ("user_table", "item_table"):
        np.testing.assert_allclose(getattr(tt, side).table, getattr(jt, side).table,
                                   rtol=0, atol=1e-5)
        np.testing.assert_array_equal(getattr(tt, side).table[0], 0.0)
    jdense = _jax_dense(jt, jt._dense)
    assert sorted(tt._dense) == sorted(jdense)
    for k, v in jdense.items():
        np.testing.assert_allclose(tt._dense[k].numpy(), np.asarray(v), rtol=0, atol=1e-5)
    # the assembled models' catalogs
    np.testing.assert_allclose(tm._item_embeddings, jm._item_embeddings, rtol=0, atol=1e-5)
    h = tt.history[-1]
    assert h["steps"] == len(tt.pos_users) // 64 and set(h["parts_s"]) == set(STEP_PARTS)
    assert all(v >= 0 for v in h["parts_s"].values()) and h["examples_per_s"] > 0


def test_tables_start_as_jax_tables(data):
    jd, td = data
    cfg = _cfg(HOST_TABLE_OPTIMIZER="adagrad")
    jt = JaxTrainer(jd, cfg, model_output_path="")
    tt = HostTableEmbeddingTrainer(td, cfg, model_output_path="", device="cpu")
    for side in ("user_table", "item_table"):
        np.testing.assert_array_equal(getattr(tt, side).table, getattr(jt, side).table)
    np.testing.assert_array_equal(tt._log_q, jt._log_q)
    np.testing.assert_array_equal(tt.genre_table, jt.genre_table)
    assert tt.dense_names() == sorted(_jax_dense(jt, jt._init_dense()))


def test_no_item_bias_outside_softmax_mode(data, tmp_path):
    """C.46: JAX's in-batch run keeps a (2,) item bias, so its model's
    ``item_bias_np`` reads NaN past id 1 and its index gets a NaN bias
    column; the port's model has the (n_items+1,) zero bias of an in-batch
    checkpoint and its index no bias column."""
    jd, td = data
    cfg = _cfg(TRAIN_EPOCHS=1, INDEX_PATH=str(tmp_path / "i.npz"))
    jt = JaxTrainer(jd, cfg, model_output_path="")
    assert np.asarray(jt._init_dense()["item_bias"]).shape == (2,)
    assert np.isnan(jt.train().item_bias_np(np.arange(1, 5))[1:]).all()
    tt = HostTableEmbeddingTrainer(td, cfg, model_output_path="", device="cpu")
    tm = tt.train()
    assert "item_bias" not in tt._dense
    np.testing.assert_array_equal(tm.item_bias_np(np.arange(1, 61)), 0.0)
    assert not IndexBuilder(td, cfg, device="cpu").build(model=tm).has_bias


def test_epoch_stream_is_the_jax_stream(data):
    """The same ids, rows and batch arrays from the same generator (JAX's
    per-batch dropout keys are not part of the port's batch), pairwise
    negatives included."""
    jd, td = data
    cfg = _cfg(LOSS_MODE="pairwise")
    jt = JaxTrainer(jd, cfg, model_output_path="")
    tt = HostTableEmbeddingTrainer(td, cfg, model_output_path="", device="cpu")
    keys = np.zeros((len(jt.pos_users) // 32 + 1, 2), np.uint32)
    js = list(jt._epoch_stream(np.random.default_rng(5), 32, keys))
    ts = list(tt._epoch_stream(np.random.default_rng(5), 32))
    assert len(js) == len(ts) > 0
    for (ji, jr, jb), (ti, tr, tb) in zip(js, ts):
        for a, b in ((ji, ti), (jr, tr)):
            assert sorted(a) == sorted(b)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
        assert sorted(tb) == sorted(k for k in jb if k != "key")
        for k in tb:
            np.testing.assert_array_equal(tb[k], jb[k])


@pytest.mark.parametrize("mode", ["softmax", "in_batch"])
def test_prefetched_training_learns_and_keeps_padding(data, mode, tmp_path):
    _, td = data
    cfg = _cfg(LOSS_MODE=mode, HOST_TABLE_OPTIMIZER="adagrad", HOST_TABLE_PREFETCH=2,
               TRAIN_EPOCHS=5, EMBEDDING_MODEL_PATH=str(tmp_path / "m.npz"))
    tt = HostTableEmbeddingTrainer(td, cfg, device="cpu")
    model = tt.train()
    losses = [h["loss"] for h in tt.history]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    np.testing.assert_array_equal(tt.user_table.table[0], 0.0)
    np.testing.assert_array_equal(tt.item_table.table[0], 0.0)
    # the streamed catalog and users equal the assembled model's
    ids = np.arange(1, td.n_items + 1)
    np.testing.assert_allclose(tt.embed_catalog(batch_size=17),
                               model.get_item_embeddings(ids, tt.genre_table[1:]),
                               rtol=0, atol=1e-6)
    us = tt.embed_users(np.array([1, 2, 3]), batch_size=2)
    for j, uid in enumerate([1, 2, 3]):
        np.testing.assert_allclose(us[j], model.get_user_embedding(uid), rtol=0, atol=1e-6)
    # the saved model is JAX's format, read by the JAX package
    back = TwoTowerModel.load(str(tmp_path / "m.npz"))
    np.testing.assert_array_equal(np.asarray(back.params["item_embed"]),
                                  tt.item_table.table)
    assert np.asarray(back.params["item_bias"]).any() == (mode == "softmax")


def test_to_model_budget_and_no_save(data, tmp_path):
    _, td = data
    tt = HostTableEmbeddingTrainer(td, _cfg(TRAIN_EPOCHS=1), model_output_path="",
                                   device="cpu")
    assert tt.train() is not None
    assert tt.to_model(max_elements=10) is None
    assert not list(tmp_path.iterdir())
    with pytest.raises(ValueError, match="dense params"):
        tt.train(init_dense={"user_w1": torch.zeros(16, 24)})


def test_memmap_tables(data, tmp_path):
    _, td = data
    cfg = _cfg(TRAIN_EPOCHS=1)
    tt = HostTableEmbeddingTrainer(td, cfg, model_output_path="",
                                   table_dir=str(tmp_path / "tables"), device="cpu")
    assert (tmp_path / "tables" / "user_table.npy").exists()
    tt.train()
    on_disk = np.load(tmp_path / "tables" / "item_table.npy", mmap_mode="r")
    np.testing.assert_array_equal(on_disk, tt.item_table.table)
    assert not np.allclose(on_disk[1:], 0.0)


def test_index_from_streamed_embeddings_matches_jax(data, tmp_path):
    """``IndexBuilder.build(embeddings=…, bias=…)``: the raw bias scaled by
    the temperature, an all-zero bias giving no bias column, the same saved
    files as JAX's."""
    jd, td = data
    rng = np.random.default_rng(0)
    embs = rng.normal(size=(60, 16)).astype(np.float32)
    bias = (0.1 * rng.normal(size=60)).astype(np.float32)
    for b, name in ((bias, "b"), (np.zeros(60, np.float32), "z"), (None, "n")):
        cfg = _cfg(INDEX_PATH=str(tmp_path / f"j{name}.npz"))
        JaxIndexBuilder(jd, cfg).build(embeddings=embs, bias=b)
        idx = IndexBuilder(td, cfg, index_output_path=str(tmp_path / f"t{name}.npz"),
                           device="cpu").build(embeddings=embs, bias=b)
        assert idx.has_bias == (name == "b")
        with np.load(tmp_path / f"j{name}.npz") as j, np.load(tmp_path / f"t{name}.npz") as t:
            assert sorted(j.files) == sorted(t.files)
            for k in j.files:
                np.testing.assert_allclose(t[k], j[k], rtol=0, atol=1e-7)
        assert json.loads((tmp_path / f"t{name}.npz.meta.json").read_text()) == \
            json.loads((tmp_path / f"j{name}.npz.meta.json").read_text())


def _pipeline_cfg(tmp_path, **kw):
    base = dict(DATA_DIR=str(tmp_path / "nodata"), HOST_TABLE=True, HOST_TABLE_PREFETCH=0,
                EMBEDDING_DIM=8, HIDDEN_DIM=12, TRAIN_EPOCHS=1, BATCH_SIZE=32,
                SYNTH_USERS=60, SYNTH_ITEMS=40, SYNTH_RATINGS=2000)
    base.update(kw)
    return Settings(**base)


def test_pipeline_embeddings_stage_uses_host_path(tmp_path):
    """``tests/test_host_train.py``'s dispatch case: the embeddings stage
    trains with host tables and writes the model."""
    orch = PipelineOrchestrator(_pipeline_cfg(tmp_path), synthetic=True,
                                data_dir=str(tmp_path / "ml"),
                                models_dir=str(tmp_path / "models"), device="cpu")
    orch.run_stage("data")
    hist = orch.run_stage("embeddings")
    assert len(hist) == 1 and "parts_s" in hist[0]
    assert (tmp_path / "models" / "two_tower.npz").exists()
    assert getattr(orch, "_host_trainer", None) is None
    orch.run_stage("index")
    assert MIPSIndex.load(str(tmp_path / "models" / "mips.index.npz"),
                          device="cpu").n_total == 40


def test_index_stage_streams_catalog_at_hbm_scale(tmp_path, monkeypatch):
    """Where the tables exceed the in-HBM budget (``to_model()`` → None)
    no model is written and the index stage streams the catalog through
    ``embed_catalog``, with the softmax run's bias column."""
    monkeypatch.setattr(HostTableEmbeddingTrainer, "to_model",
                        lambda self, max_elements=0: None)
    orch = PipelineOrchestrator(_pipeline_cfg(tmp_path, LOSS_MODE="softmax"),
                                synthetic=True, data_dir=str(tmp_path / "ml"),
                                models_dir=str(tmp_path / "models"), device="cpu")
    orch.run_stage("data")
    orch.run_stage("embeddings")
    assert not (tmp_path / "models" / "two_tower.npz").exists()
    orch.run_stage("index")
    path = str(tmp_path / "models" / "mips.index.npz")
    idx = MIPSIndex.load(path, device="cpu")
    assert idx.n_total == orch._host_trainer.n_items and idx.has_bias
    streamed = orch._host_trainer.embed_catalog()
    with np.load(path) as z:
        np.testing.assert_allclose(
            z["embeddings"], streamed / np.linalg.norm(streamed, axis=1, keepdims=True),
            rtol=0, atol=1e-6)
        bias = orch._host_trainer._dense["item_bias"][1:].numpy()
        np.testing.assert_allclose(z["bias"], 0.05 * bias, rtol=1e-6)
    # the JAX package reads the port's index
    assert JaxIndex.load(path).n_total == idx.n_total


def test_verified_index_through_the_pipeline(tmp_path):
    """``INDEX_MODE=verified`` after a host-table run: the index saved in
    that mode, its lists equal to an exact index's of the same file and to
    JAX's verified index's."""
    orch = PipelineOrchestrator(_pipeline_cfg(tmp_path, INDEX_MODE="verified"),
                                synthetic=True, data_dir=str(tmp_path / "ml"),
                                models_dir=str(tmp_path / "models"), device="cpu")
    orch.run_stage("data")
    orch.run_stage("embeddings")
    orch.run_stage("index")
    path = tmp_path / "models" / "mips.index.npz"
    ver = MIPSIndex.load(str(path), device="cpu")
    jver = JaxIndex.load(str(path))
    assert ver.mode == jver.mode == "verified"
    meta = json.loads((tmp_path / "models" / "mips.index.npz.meta.json").read_text())
    meta["mode"] = "exact"
    (tmp_path / "models" / "mips.index.npz.meta.json").write_text(json.dumps(meta))
    ex = MIPSIndex.load(str(path), device="cpu")
    q = np.random.default_rng(0).normal(size=(5, 8)).astype(np.float32)
    (vv, vi), (ev, ei) = ver.batch_search(q, 10), ex.batch_search(q, 10)
    jv, ji = jver.batch_search(q, 10)
    for v, i in ((ev, ei), (jv, ji)):
        np.testing.assert_allclose(vv, v, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(vi, i)


def _jax_script():
    path = Path(__file__).resolve().parent.parent / "scripts" / "host_table_scale.py"
    spec = importlib.util.spec_from_file_location("jax_host_table_scale", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_scale_script_stream_and_configs_are_the_jax_ones():
    """``sparse_synthetic`` without pandas: JAX's ratings, users and catalog
    row for row; the configurations unchanged."""
    jax_script = _jax_script()
    assert host_table_scale.CONFIGS == jax_script.CONFIGS
    j = jax_script.sparse_synthetic(5000, 700, 3000, seed=4)
    t = host_table_scale.sparse_synthetic(5000, 700, 3000, seed=4)
    np.testing.assert_array_equal(t.user_id, j.ratings["user_id"].values)
    np.testing.assert_array_equal(t.item_id, j.ratings["item_id"].values)
    np.testing.assert_array_equal(t.rating, j.ratings["rating"].values)
    np.testing.assert_array_equal(
        t.timestamp, j.ratings["timestamp"].values.astype("datetime64[s]").astype(np.int64))
    assert (t.n_users, t.n_items) == (j.n_users, j.n_items) == (5000, 700)
    np.testing.assert_array_equal(
        build_genre_table(t.item_ids, t.genres, 700),
        jax_build_genre_table(j.movies, 700))


def test_scale_script_prints_the_jax_line(capsys):
    """``--mode both`` on the CPU at a tiny size: the JAX line's keys (and
    each trainer's history), losses finite."""
    assert host_table_scale.main(
        ["--config", "ml1m", "--ratings", "3000", "--epochs", "2", "--batch", "64",
         "--dim", "8", "--mode", "both", "--prefetch", "2", "--loss-mode", "in_batch",
         "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert {"config", "platform", "table_gib", "batch", "dim", "host_ex_per_s",
            "host_losses", "hbm_ex_per_s", "hbm_losses"} <= set(out)
    assert out["platform"] == "cpu" and (out["batch"], out["dim"]) == (64, 8)
    assert len(out["host_losses"]) == len(out["hbm_losses"]) == 2
    assert np.isfinite(out["host_losses"] + out["hbm_losses"]).all()
    assert out["host_history"][0]["steps"] == 3000 // 64
