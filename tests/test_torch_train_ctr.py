"""The port's CTR trainer (``recommendit_tpu_torch/training/train_ctr.py``)
against JAX's, step for step, on the CPU.

Both trainers start from JAX's ``init_ctr_params`` (the port's through
``train(init_params=from_jax_params(…))``) and see the same batches (the
same numpy generator), at ``tests/test_ctr.py``'s fixture size (12,000
impressions over 300 users x 150 items; embed 8, retrieval 16, top (64,),
batch 1,024: 10 steps an epoch), for 2 epochs in {sparse, dense} x
{joint, plain}. Nothing else is random, so they must agree step for step:

* per-epoch losses within 1e-6 relative (1.1e-7 seen);
* final params within 2e-5 absolute (f32 sums in other orders through 20
  AdamW and adagrad steps, both of which divide by a root of the squared
  gradients; largest seen 7.8e-6, a dense-mode table entry);
* ``evaluate``: AUC within 1e-4 and logloss within 1e-6 relative (3.7e-6
  and 6e-9 seen), ``ctr`` equal, and in joint mode recall@10 and recall@50
  equal — a hit that differs must be a tie within 1e-6 at the k-th score.
"""
import jax
import numpy as np
import pytest
import torch

from recommendit_tpu.config import settings as jax_settings
from recommendit_tpu.data.ctr import make_ctr_dataset as jax_make
from recommendit_tpu.models.ctr import CTRModel as JaxModel
from recommendit_tpu.training.train_ctr import CTRTrainer as JaxTrainer
from recommendit_tpu_torch.config import settings
from recommendit_tpu_torch.data.ctr import make_ctr_dataset
from recommendit_tpu_torch.models.ctr import CTRModel, from_jax_params
from recommendit_tpu_torch.training.train_ctr import CTRTrainer

DATA = dict(n_examples=12000, n_users=300, n_items=150, seed=7)
CFG = dict(CTR_EPOCHS=2, CTR_BATCH_SIZE=1024, CTR_EMBED_DIM=8,
           CTR_RETRIEVAL_DIM=16, CTR_TOP_HIDDEN=(64,))
PARAM_TOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many tiny ops; one torch thread per test worker (see
    tests/test_torch_training.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    return jax_make(**DATA), make_ctr_dataset(**DATA)


def _train_both(data, joint, **kw):
    jd, td = data
    cfg = dict(CFG, **kw)
    jt = JaxTrainer(jd, cfg=jax_settings.replace(**cfg), joint=joint)
    init = {k: np.asarray(v) for k, v in jt.model.params.items()}
    jt.train()
    tt = CTRTrainer(td, cfg=settings.replace(**cfg), joint=joint, device="cpu")
    tt.train(init_params=from_jax_params(init, "cpu"))
    return jt, tt


def _recall_tie_aware(jt, tt, k):
    """Indices of clicked test impressions whose hit at k differs between
    the packages, and for each whether the true item's score ties the k-th
    within 1e-6 in the port's scores."""
    d = tt.test_data
    clicked = d.labels > 0.5
    q = tt.model.user_query_embeddings(tt.data.user_field_values[d.user_ids[clicked]])
    c = tt.model.item_corpus_embeddings(tt.data.item_field_values)
    scores = q.astype(np.float64) @ c.T.astype(np.float64)
    kth = -np.sort(-scores, axis=1)[:, k - 1]
    true = scores[np.arange(len(q)), d.item_ids[clicked]]
    return np.abs(true - kth) <= 1e-6


@pytest.mark.parametrize("joint", [True, False])
@pytest.mark.parametrize("mode", ["sparse", "dense"])
def test_trainer_matches_jax_step_for_step(data, mode, joint):
    jt, tt = _train_both(data, joint, CTR_TABLE_UPDATE=mode)
    jl = [h["loss"] for h in jt.history]
    tl = [h["loss"] for h in tt.history]
    np.testing.assert_allclose(tl, jl, rtol=1e-6, atol=0)
    assert [h["epoch"] for h in tt.history] == [1, 2]
    assert set(tt.history[0]) == set(jt.history[0])
    assert all(h["examples_per_s"] > 0 and h["seconds"] > 0 for h in tt.history)
    assert tt.examples_per_s > 0
    assert set(tt.model.params) == set(jt.model.params)
    for name, v in jt.model.params.items():
        np.testing.assert_allclose(tt.model.params[name].detach().numpy(), np.asarray(v),
                                   rtol=0, atol=PARAM_TOL, err_msg=name)
    jr, tr = jt.evaluate(), tt.evaluate()
    assert set(tr) == set(jr)
    assert abs(tr["auc"] - jr["auc"]) <= 1e-4
    np.testing.assert_allclose(tr["logloss"], jr["logloss"], rtol=1e-6)
    assert tr["ctr"] == jr["ctr"]
    if joint:
        for k in (10, 50):
            n = int((tt.test_data.labels > 0.5).sum())
            diff = round(abs(tr[f"recall@{k}"] - jr[f"recall@{k}"]) * n)
            assert diff <= int(_recall_tie_aware(jt, tt, k).sum()), (k, tr, jr)
    else:
        assert "recall@10" not in tr


def test_sparse_mode_leaves_unseen_rows_and_reads_no_schedule(data):
    """Sparse mode: table rows no train id touches stay at their initial
    values (no weight decay, no clipping of the rows), and the accumulator
    is zero there."""
    _, td = data
    tt = CTRTrainer(td, cfg=settings.replace(**CFG), joint=True, device="cpu")
    init = {k: v.clone() for k, v in tt.model.params.items()}
    state = tt.start()
    batches = tt.epoch_batches(np.random.default_rng(0), tt.batch_size())
    for s in range(3):
        tt.step(state, [b[s] for b in batches], decay_steps=20)
    seen = np.zeros(len(init["embed"]), bool)
    seen[batches[1][:3].reshape(-1).numpy()] = True
    table = state.params["embed"].detach()
    assert torch.equal(table[~seen], init["embed"][~seen])
    assert not state.accum[~seen].any() and (state.accum[seen] > 0).all()
    assert not torch.equal(table[seen], init["embed"][seen])
    assert state.opt.count == 3
    assert all(not torch.equal(state.params[k], init[k]) for k in ("bot_w1", "top_w1"))


def test_epoch_batches_and_clamp_are_jax(data):
    jd, td = data
    jt = JaxTrainer(jd, cfg=jax_settings.replace(**CFG))
    tt = CTRTrainer(td, cfg=settings.replace(**CFG), device="cpu")
    want = jt._epoch_batches(np.random.default_rng(3), 1024)
    got = tt.epoch_batches(np.random.default_rng(3), 1024)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[0].shape == (10, 1024, 13) and got[1].dtype == torch.int64
    # the batch-size clamp: JAX's expression in train()
    for n in (5, 9, 300, 12000):
        small = jax_make(n_examples=n, n_users=20, n_items=10, seed=1)
        t = CTRTrainer(make_ctr_dataset(n_examples=n, n_users=20, n_items=10, seed=1),
                       cfg=settings.replace(**CFG), device="cpu")
        n_train = len(small.split()[0].labels)
        assert t.batch_size() == max(1, min(1024, max(8, n_train // 2), n_train))


def test_tiny_log_trains_like_jax(data):
    """Fewer than 8 train rows: one batch of all of them, as JAX clamps."""
    kw = dict(n_examples=8, n_users=20, n_items=10, seed=2)
    jd, td = jax_make(**kw), make_ctr_dataset(**kw)
    jt, tt = _train_both((jd, td), True, CTR_TABLE_UPDATE="sparse")
    np.testing.assert_allclose([h["loss"] for h in tt.history],
                               [h["loss"] for h in jt.history], rtol=1e-6)


def test_init_params_must_match_the_model(data):
    _, td = data
    tt = CTRTrainer(td, cfg=settings.replace(**CFG), device="cpu")
    params = {k: v.clone() for k, v in tt.model.params.items()}
    params["top_w1"] = params["top_w1"][:, :3]
    with pytest.raises(ValueError, match="init_params shapes"):
        tt.train(init_params=params)
    with pytest.raises(ValueError, match="CTR_TABLE_UPDATE"):
        CTRTrainer(td, cfg=settings.replace(**CFG, CTR_TABLE_UPDATE="rows"),
                   device="cpu").train()


def test_saved_model_loads_in_jax(data, tmp_path):
    jd, td = data
    path = str(tmp_path / "ctr.npz")
    tt = CTRTrainer(td, cfg=settings.replace(**{**CFG, "CTR_EPOCHS": 1}), joint=True,
                    model_output_path=path, device="cpu")
    model = tt.train()
    back = JaxModel.load(path)
    np.testing.assert_allclose(
        back.predict_proba(jd.dense[:500], jd.sparse[:500], joint=True),
        model.predict_proba(td.dense[:500], td.sparse[:500], joint=True),
        rtol=0, atol=1e-6)
    assert CTRModel.load(path, device="cpu").vocab_sizes == tuple(jd.vocab_sizes)
