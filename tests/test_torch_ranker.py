"""The port's ranker training half (``models/ranker.py``) against the JAX one.

Group losses, their gradients and NDCG@k on the same (B, G) inputs, with
masked padding, tied scores and groups without a usable pair: values and
``autograd`` gradients within rtol 1e-5 of ``jax.value_and_grad`` (f32 sums
in other orders). The host side bit for bit: ``pack_groups``, and
``per_query_normalize`` against JAX's function given the same first-row
shift (ROADMAP C.8). Training from one carried-over init, 3 epochs:
per-epoch losses and valid NDCG@10 within rtol 1e-4, the same best epoch,
final params within 1e-5, ``predict`` within 1e-5. Files both ways.

The output bias ``b2`` is the exception. Every group loss is invariant to
adding one constant to all scores, so ∂L/∂b2 is 0 in exact arithmetic and
each framework's gradient is its own f32 rounding residue (~1e-9), which
Adam divides by its own root mean square and turns into steps of up to the
learning rate. JAX's ``b2`` is that noise too. So ``b2`` is held to the
bound Adam puts on its steps, lr per step, and ``predict`` is compared
without it (the scores up to that constant, and their order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import recommendit_tpu.models.ranker as jr
from recommendit_tpu_torch.models import ranker as tr
from recommendit_tpu_torch.models import LambdaRankScorer, load_ranker

LOSSES = ["lambdarank", "lambdaloss", "softmax"]
N_FEAT = 12
HIDDEN = (16, 8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _groups(seed=0, b=9, g=16):
    """(B, G) scores, gains, masks: ragged masks, integer scores (ties),
    a group with all gains equal, one with no positive, one of one item."""
    rng = np.random.default_rng(seed)
    scores = rng.integers(-3, 4, (b, g)).astype(np.float32)
    scores[::2] += rng.normal(size=(len(scores[::2]), g)).astype(np.float32)
    gains = np.asarray(jr.DEFAULT_LABEL_GAIN, np.float32)[rng.integers(0, 5, (b, g))]
    gains[rng.random((b, g)) < 0.5] = 0.0
    lengths = rng.integers(1, g + 1, b)
    lengths[:3] = (g, g, 1)
    mask = (np.arange(g)[None, :] < lengths[:, None]).astype(np.float32)
    gains[1] = 3.0          # all equal: no pair
    gains[2] = 0.0
    gains[3] = 0.0          # no positive at all
    return scores, gains, mask


@pytest.mark.parametrize("loss_type", LOSSES)
def test_group_losses_and_grads_match_jax(loss_type):
    s, g, m = _groups()
    jfn = jr.GROUP_LOSSES[loss_type]
    want, jgrad = jax.value_and_grad(
        lambda x: jax.vmap(jfn)(x, jnp.asarray(g), jnp.asarray(m)).sum())(jnp.asarray(s))
    per_group = np.asarray(jax.vmap(jfn)(jnp.asarray(s), jnp.asarray(g), jnp.asarray(m)))
    x = torch.tensor(s, requires_grad=True)
    losses = tr.GROUP_LOSSES[loss_type](x, torch.tensor(g), torch.tensor(m))
    losses.sum().backward()
    np.testing.assert_allclose(losses.detach().numpy(), per_group, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(float(losses.detach().sum()), float(want), rtol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgrad), rtol=1e-5, atol=1e-7)
    assert per_group[3] == 0.0 and losses[3] == 0.0   # nothing to rank against
    assert np.isfinite(x.grad.numpy()).all()


def _mlp_params(seed=0, n_features=N_FEAT, hidden=HIDDEN):
    params = jr.init_mlp(jax.random.PRNGKey(seed), n_features, hidden)
    return {k: np.asarray(v) for k, v in params.items()}


@pytest.mark.parametrize("loss_type", LOSSES)
def test_batched_group_loss_matches_jax(loss_type):
    rng = np.random.default_rng(1)
    _, g, m = _groups(seed=2)
    x = rng.normal(size=g.shape + (N_FEAT,)).astype(np.float32)
    p = _mlp_params()
    want, jgrad = jax.value_and_grad(jr.batched_group_loss)(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), jnp.asarray(g),
        jnp.asarray(m), loss_type)
    tp = {k: v.requires_grad_(True) for k, v in tr.from_jax_params(p, "cpu").items()}
    loss = tr.batched_group_loss(tp, torch.tensor(x), torch.tensor(g),
                                 torch.tensor(m), loss_type)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    for k, v in tp.items():
        np.testing.assert_allclose(v.grad.numpy(), np.asarray(jgrad[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)


@pytest.mark.parametrize("k", [1, 5, 10])
def test_group_ndcg_matches_jax(k):
    s, g, m = _groups(seed=3)
    want, wvalid = jax.vmap(lambda a, b, c: jr.group_ndcg_at_k(a, b, c, k))(
        jnp.asarray(s), jnp.asarray(g), jnp.asarray(m))
    got, valid = tr.group_ndcg_at_k(torch.tensor(s), torch.tensor(g), torch.tensor(m), k)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(wvalid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-7)


def _frame(seed, n_queries, n_features=N_FEAT):
    """Ragged queries (1–90 rows) with graded labels and one column
    constant within each query, as the user features are."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, 91, n_queries)
    q = np.repeat(rng.permutation(np.arange(100, 100 + 3 * n_queries, 3)), sizes)
    x = rng.normal(size=(len(q), n_features)).astype(np.float32)
    x[:, 0] = (q % 7).astype(np.float32) * 0.37
    y = rng.integers(0, 5, len(q))
    y[rng.random(len(q)) < 0.7] = 0
    cols = [f"f{i}" for i in range(n_features)]
    frame = {c: x[:, j] for j, c in enumerate(cols)}
    frame.update(label=y.astype(np.int64), query_id=q.astype(np.int64))
    return frame, cols


def test_pack_groups_bit_identical():
    frame, cols = _frame(4, 30)
    x = tr.feature_matrix(frame, cols)
    _, q = np.unique(frame["query_id"], return_inverse=True)
    want = jr.pack_groups(x, frame["label"], q, 16, rng=np.random.default_rng(5))
    got = tr.pack_groups(x, frame["label"], q, 16, rng=np.random.default_rng(5))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert got[0].shape[1:] == (16, N_FEAT) and len(got[0]) > 30


def test_per_query_normalize_is_jax_on_shifted_input():
    frame, cols = _frame(6, 25)
    x = tr.feature_matrix(frame, cols)
    _, q = np.unique(frame["query_id"], return_inverse=True)
    _, first = np.unique(q, return_index=True)
    shifted = x - x[first][q]
    np.testing.assert_array_equal(tr.per_query_normalize(x, q),
                                  jr.per_query_normalize(shifted, q))


def test_constant_columns_standardise_to_zero():
    """C.8's training half: JAX's unshifted standardisation turns a column
    that is constant over the query into rounding noise; the port's gives
    exact zeros."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(210, 4)).astype(np.float32)
    x[:, 1] = np.float32(0.7130001)
    x[:, 3] = np.float32(-2.3456789)
    q = np.zeros(210, np.int64)
    assert np.abs(jr.per_query_normalize(x, q)[:, [1, 3]]).max() > 0.01
    got = tr.per_query_normalize(x, q)
    assert not got[:, [1, 3]].any()
    assert np.abs(got[:, [0, 2]]).max() > 1.0


def _split(frame, n_valid=5):
    qs = np.unique(frame["query_id"])
    valid = np.isin(frame["query_id"], qs[:n_valid])
    return ({c: a[~valid] for c, a in frame.items()},
            {c: a[valid] for c, a in frame.items()})


def _shifted_pqn(x, q):
    _, first = np.unique(q, return_index=True)
    return _ORIG_PQN(x - x[first][q], q)


_ORIG_PQN = jr.per_query_normalize


@pytest.fixture(scope="module", params=[("lambdarank", True), ("lambdaloss", False),
                                        ("softmax", True)], ids=lambda p: p[0])
def trained(request):
    loss_type, query_norm = request.param
    frame, cols = _frame(8, 40)
    fit, valid = _split(frame)
    p = _mlp_params(seed=9)
    kw = dict(hidden_dims=HIDDEN, epochs=3, group_size=16, batch_groups=8, seed=3,
              loss_type=loss_type, query_norm=query_norm, early_stop_rounds=2)
    jranker = jr.LambdaRankScorer(**kw)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jr, "init_mlp", lambda *a: {k: jnp.asarray(v) for k, v in p.items()})
        mp.setattr(jr, "per_query_normalize", _shifted_pqn)
        jranker.train(pd.DataFrame(fit), cols, valid_df=pd.DataFrame(valid))
        jpred = jranker.predict(pd.DataFrame(valid))
        jpred_set = jranker.predict(tr.feature_matrix(valid, cols))
    tranker = LambdaRankScorer(**kw, device="cpu")
    tranker.train(fit, cols, valid_df=valid, init_params=tr.from_jax_params(p, "cpu"))
    n_chunks = len(tr.pack_groups(tr.feature_matrix(fit, cols), fit["label"],
                                  np.unique(fit["query_id"], return_inverse=True)[1],
                                  16)[0])
    return dict(j=jranker, t=tranker, valid=valid, cols=cols, jpred=jpred,
                jpred_set=jpred_set, fit=fit, steps_per_epoch=n_chunks // 8)


def test_training_matches_jax_epoch_for_epoch(trained):
    j, t = trained["j"], trained["t"]
    np.testing.assert_array_equal(t.feat_mean, j.feat_mean)
    np.testing.assert_array_equal(t.feat_std, j.feat_std)
    assert list(t.evals_result) == list(j.evals_result)
    for key, want in j.evals_result.items():
        assert len(t.evals_result[key]) == len(want) == 3
        np.testing.assert_allclose(t.evals_result[key], want, rtol=1e-4, err_msg=key)
    assert t.best_iteration == j.best_iteration >= 1
    out_bias = f"b{len(HIDDEN)}"
    for k, v in j.params.items():
        if k != out_bias:
            np.testing.assert_allclose(t.params[k].numpy(), np.asarray(v), rtol=0,
                                       atol=1e-5, err_msg=k)
    steps = t.best_iteration * trained["steps_per_epoch"]
    gap = abs(float(t.params[out_bias][0]) - float(j.params[out_bias][0]))
    assert gap <= 3e-3 * steps, gap


def test_output_bias_gradient_is_rounding_noise(trained):
    """The premise of the ``b2`` exception: its gradient is ~1e-9 of the
    others', in both frameworks."""
    fit, cols = trained["fit"], trained["cols"]
    t = trained["t"]
    xs, gs, ms = tr.pack_groups(t._standardize(*t._extract(fit, cols, "label",
                                                           "query_id")[::2]),
                                fit["label"], np.unique(fit["query_id"],
                                                        return_inverse=True)[1], 16)
    params = {k: v.clone().requires_grad_(True) for k, v in t.params.items()}
    loss = tr.batched_group_loss(params, torch.tensor(xs[:8]), torch.tensor(gs[:8]),
                                 torch.tensor(ms[:8]), t.loss_type)
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    jg = jax.grad(jr.batched_group_loss)(
        {k: jnp.asarray(v.detach().numpy()) for k, v in params.items()},
        jnp.asarray(xs[:8]), jnp.asarray(gs[:8]), jnp.asarray(ms[:8]), t.loss_type)
    out_bias = f"b{len(HIDDEN)}"
    for g in (grads[out_bias].abs().item(), abs(float(jg[out_bias][0]))):
        assert g < 1e-5 * grads["w0"].abs().max().item(), g


def _without_out_bias(scores, ranker):
    return np.asarray(scores) - float(np.asarray(ranker.params[f"b{len(HIDDEN)}"])[0])


def test_predict_matches_jax(trained):
    t, j = trained["t"], trained["j"]
    for got, want in ((t.predict(trained["valid"]), trained["jpred"]),
                      (t.predict(tr.feature_matrix(trained["valid"], trained["cols"])),
                       trained["jpred_set"])):
        np.testing.assert_allclose(_without_out_bias(got, t), _without_out_bias(want, j),
                                   rtol=0, atol=1e-5)
        np.testing.assert_array_equal(np.argsort(-got, kind="stable"),
                                      np.argsort(-want, kind="stable"))


def test_ranker_files_load_both_ways(trained, tmp_path):
    j, t, valid = trained["j"], trained["t"], trained["valid"]
    t.save(str(tmp_path / "port.npz"))
    back = jr.LambdaRankScorer.load(str(tmp_path / "port.npz"))
    assert back.best_iteration == t.best_iteration and back.query_norm == t.query_norm
    x = tr.feature_matrix(valid, trained["cols"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jr, "per_query_normalize", _shifted_pqn)
        np.testing.assert_allclose(back.predict(x), t.predict(x), rtol=0, atol=1e-5)
        j.save(str(tmp_path / "jax.npz"))
        want = j.predict(x)
    again = load_ranker(str(tmp_path / "jax.npz"), device="cpu")
    assert again.best_iteration == j.best_iteration
    np.testing.assert_allclose(again.predict(x), want, rtol=0, atol=1e-5)


def test_feature_importance_and_model_info(trained):
    t = trained["t"]
    x = torch.randn((512, N_FEAT), generator=torch.Generator().manual_seed(0))
    jp = {k: jnp.asarray(v.numpy()) for k, v in t.params.items()}
    grads = jax.vmap(jax.grad(lambda xi: jr.mlp_score(jp, xi)))(jnp.asarray(x.numpy()))
    want = np.abs(np.asarray(grads)).mean(axis=0)
    imp = t.feature_importance()
    assert list(imp) == trained["cols"]
    np.testing.assert_allclose(list(imp.values()), want, rtol=1e-5, atol=1e-8)
    top = t.top_features(3)
    assert [v for _, v in top] == sorted(imp.values(), reverse=True)[:3]
    info = t.model_info()
    assert info["trained"] and info["n_features"] == N_FEAT
    assert info["n_parameters"] == N_FEAT * 16 + 16 + 16 * 8 + 8 + 8 + 1
    assert info["best_iteration"] == t.best_iteration
    assert len(info["top_features"]) == 10
    assert LambdaRankScorer(device="cpu").model_info() == {"trained": False}


def test_device_scoring_matches_predict(trained):
    t, valid, cols = trained["t"], trained["valid"], trained["cols"]
    q = valid["query_id"] == valid["query_id"][0]
    one = tr.feature_matrix({c: a[q] for c, a in valid.items()}, cols)
    via_predict = t.predict(one)
    score = t.make_device_scorer()(torch.as_tensor(one))
    np.testing.assert_allclose(score.numpy(), via_predict, rtol=0, atol=1e-5)
    if not t.query_norm:
        dev = t.predict_device(t.standardize_device(torch.as_tensor(one)))
        np.testing.assert_allclose(dev.detach().numpy(), via_predict, rtol=0, atol=1e-6)


def test_init_mlp_draws_glorot_from_the_generator():
    a = tr.init_mlp(torch.Generator().manual_seed(1), 52, (128, 64))
    b = tr.init_mlp(torch.Generator().manual_seed(1), 52, (128, 64))
    assert list(a) == ["w0", "b0", "w1", "b1", "w2", "b2"]
    assert a["w0"].shape == (52, 128) and a["w2"].shape == (64, 1)
    for k in a:
        assert torch.equal(a[k], b[k])
    limit = np.sqrt(6.0 / (52 + 128))
    assert a["w0"].abs().max() <= limit and a["w0"].abs().max() > 0.9 * limit
    assert not a["b1"].any()


def test_untrained_and_bad_arguments_raise():
    with pytest.raises(ValueError, match="loss_type"):
        LambdaRankScorer(loss_type="pointwise", device="cpu")
    r = LambdaRankScorer(feature_names=["a"], device="cpu")
    with pytest.raises(RuntimeError, match="not trained"):
        r.predict(np.zeros((2, 1), np.float32))
    with pytest.raises(RuntimeError, match="not trained"):
        r.feature_importance()
