"""The port's histogram GBDT (``recommendit_tpu_torch/models/gbdt.py``)
against the JAX package's (``recommendit_tpu/models/gbdt.py``).

Same numpy inputs from a seed on both sides, at ``tests/test_gbdt.py``'s
size: 40 queries x 30 rows, depth 4, 32 bins, 25 trees. Tolerances:

* packed-group gradients and hessians (ties and padded slots): f32 within
  rtol 1e-6 / atol 1e-7 (``jnp.log2`` and ``sigmoid`` in two frameworks);
* the numpy copies (``lambdarank_grad_hess``, ``pack_group_indices``,
  ``_grow_tree``, ``_tree_from_levels``, ``predict``): bit for bit;
* the device grower: bit for bit on dyadic grad and hess (every sum exact
  in any order); on random inputs the same trees, leaf values within 1e-6
  relative and gains within 1e-5 relative (XLA's cumulative sum is a scan
  tree, torch's runs in order);
* ``jax.random.split`` / ``bernoulli`` replayed bit for bit;
* ``train`` on either backend: the same trees, ``best_iteration`` and
  validation NDCG@10 sequence, leaf values within 1e-6 absolute, gains
  within 1e-6 of the tree's largest gain;
* ``make_device_scorer`` against JAX's: within the f32 summation bound of
  ROADMAP C.22 over the trees, plus a rounding of the final product.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import recommendit_tpu.models.gbdt as jg
import recommendit_tpu_torch.models.gbdt as tg
from recommendit_tpu_torch.ops import quantize as qz
from tests.test_ranker import FEATURES, make_ranker_data

N_BINS, DEPTH, TREES = 32, 4, 25
TREE_ATTRS = ("feature", "bin_threshold", "left", "right")
KW = dict(n_estimators=TREES, learning_rate=0.2, max_depth=DEPTH,
          n_bins=N_BINS, early_stop_rounds=25, seed=0)


def _columns(df):
    return {c: df[c].values for c in df.columns}


@pytest.fixture(scope="module")
def frames():
    return make_ranker_data(n_queries=40, group=30), make_ranker_data(n_queries=10, seed=1)


@pytest.fixture(scope="module", params=["numpy", "device"])
def trained(request, frames):
    df, valid = frames
    jr = jg.HistGBDTRanker(backend=request.param, **KW)
    jev = jr.train(df, FEATURES, valid_df=valid, verbose_eval=100)
    tr = tg.HistGBDTRanker(backend=request.param, device="cpu", **KW)
    tev = tr.train(_columns(df), FEATURES, valid_df=_columns(valid), verbose_eval=100)
    return jr, jev, tr, tev


def _assert_same_trees(jtrees, ttrees, value_atol=1e-6, gain_rel=1e-6):
    """The same splits; leaf values within ``value_atol``; gains within
    ``gain_rel`` of the tree's largest (a gain is a difference of three
    ratios of sums: summation order moves it relative to the parent's
    score, not to itself)."""
    assert len(jtrees) == len(ttrees)
    for a, b in zip(jtrees, ttrees):
        for attr in TREE_ATTRS:
            np.testing.assert_array_equal(getattr(b, attr), getattr(a, attr), err_msg=attr)
        np.testing.assert_allclose(b.value, a.value, rtol=0, atol=value_atol)
        np.testing.assert_allclose(b.gain, a.gain, rtol=0,
                                   atol=gain_rel * np.abs(a.gain).max())


# --- gradients --------------------------------------------------------- #

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_group_grad_hess_matches_jax(seed):
    rng = np.random.default_rng(seed)
    n_groups, gsz = 60, 64
    s = rng.normal(size=(n_groups, gsz)).astype(np.float32)
    s[:, 8:20] = s[:, 8:9]                        # tied scores
    s[:5] = 0.0                                    # groups tied throughout
    m = (rng.random((n_groups, gsz)) < 0.75).astype(np.float32)
    m[-3:, 40:] = 0.0                              # short groups
    g = (np.asarray(tg.DEFAULT_LABEL_GAIN, np.float32)[
        rng.integers(0, 5, (n_groups, gsz))] * m)
    g[6] = 0.0                                     # a group with no pair
    want = jg._make_grad_fn()(jnp.asarray(s), jnp.asarray(g), jnp.asarray(m))
    got = tg.group_grad_hess(torch.as_tensor(s), torch.as_tensor(g), torch.as_tensor(m))
    for w, t in zip(want, got):
        assert t.dtype == torch.float32 and t.shape == (n_groups, gsz)
        np.testing.assert_allclose(t.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)
    assert not got[0][6].any() and got[1][:, 0].abs().sum() > 0


def test_ranks_use_a_stable_sort():
    """Tied and padded scores rank in slot order, as ``jnp.argsort`` does:
    an unstable sort would move the tied slots' discounts."""
    s = torch.zeros(1, 8)
    m = torch.tensor([[1, 1, 1, 1, 1, 1, 0, 0]], dtype=torch.float32)
    g = torch.tensor([[0, 1, 0, 3, 0, 7, 0, 0]], dtype=torch.float32)
    want = jg._make_grad_fn()(jnp.zeros((1, 8)), jnp.asarray(g.numpy()),
                              jnp.asarray(m.numpy()))
    got = tg.group_grad_hess(s, g, m)
    for w, t in zip(want, got):
        np.testing.assert_allclose(t.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)


def test_lambdarank_grad_hess_is_jax_bit_for_bit():
    rng = np.random.default_rng(3)
    offs = np.concatenate([[0], np.cumsum(rng.integers(1, 40, 30))])
    scores = rng.normal(size=offs[-1])
    scores[:10] = 0.5
    gains = np.asarray(tg.DEFAULT_LABEL_GAIN)[rng.integers(0, 5, offs[-1])]
    want = jg.lambdarank_grad_hess(scores, gains, offs)
    got = tg.lambdarank_grad_hess(scores, gains, offs)
    for w, t in zip(want, got):
        np.testing.assert_array_equal(t, w)


def test_pack_group_indices_is_jax_bit_for_bit():
    offs = np.array([0, 5, 90, 91, 200, 264, 330])
    want = jg.pack_group_indices(offs, 64, np.random.default_rng(4))
    got = tg.pack_group_indices(offs, 64, np.random.default_rng(4))
    for w, t in zip(want, got):
        assert t.dtype == w.dtype
        np.testing.assert_array_equal(t, w)


# --- the growers ---------------------------------------------------------- #

def _grow_inputs(seed, dyadic, n=3000, n_feat=6):
    rng = np.random.default_rng(seed)
    binned = rng.integers(0, N_BINS, (n, n_feat)).astype(np.uint8)
    binned[:, 2] = rng.integers(0, 3, n)          # a feature of few bins
    if dyadic:
        grad = (rng.integers(-64, 65, n) / 64).astype(np.float32)
        hess = (rng.integers(0, 65, n) / 64).astype(np.float32)
    else:
        grad = rng.normal(size=n).astype(np.float32)
        hess = rng.random(n).astype(np.float32)
    row_mask = (rng.random(n) < 0.8).astype(np.float32)
    feat_mask = np.ones(n_feat, bool)
    feat_mask[rng.integers(0, n_feat)] = False
    return binned, grad, hess, row_mask, feat_mask


def _grow_both(binned, grad, hess, row_mask, feat_mask, min_child=20):
    n_feat = binned.shape[1]
    jfn = jg._make_grow_tree_device(n_feat, N_BINS, DEPTH, min_child, 0.1)
    jl, jrv = jfn(jnp.asarray(binned.T), jnp.asarray(grad), jnp.asarray(hess),
                  jnp.asarray(row_mask), jnp.asarray(feat_mask))
    tfn = tg._make_grow_tree_device(n_feat, N_BINS, DEPTH, min_child, 0.1)
    tl, trv = tfn(torch.as_tensor(np.ascontiguousarray(binned.T)), torch.as_tensor(grad),
                  torch.as_tensor(hess), torch.as_tensor(row_mask),
                  torch.as_tensor(feat_mask))
    return ([{k: np.asarray(v) for k, v in lv.items()} for lv in jl], np.asarray(jrv),
            [{k: v.numpy() for k, v in lv.items()} for lv in tl], trv.numpy())


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("min_child", [1, 20, 400])
def test_device_grower_dyadic_bit_for_bit(seed, min_child):
    jl, jrv, tl, trv = _grow_both(*_grow_inputs(seed, dyadic=True), min_child=min_child)
    assert len(tl) == len(jl) == DEPTH + 1
    for j, t in zip(jl, tl):
        assert set(t) == set(j)
        for key in j:
            assert t[key].dtype == j[key].dtype, key
            np.testing.assert_array_equal(t[key], j[key], err_msg=key)
    np.testing.assert_array_equal(trv, jrv)
    assert any(lv["do_split"].any() for lv in tl[1:])


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_device_grower_random_same_trees(seed):
    jl, jrv, tl, trv = _grow_both(*_grow_inputs(seed, dyadic=False))
    for j, t in zip(jl, tl):
        for key in ("best_f", "best_b", "do_split"):
            np.testing.assert_array_equal(t[key], j[key], err_msg=key)
        np.testing.assert_allclose(t["leaf_value"], j["leaf_value"], rtol=1e-6, atol=0)
        np.testing.assert_allclose(t["gain"], j["gain"], rtol=1e-5, atol=0)
    np.testing.assert_allclose(trv, jrv, rtol=1e-6, atol=0)
    _assert_same_trees([jg._tree_from_levels(jl, DEPTH)],
                       [tg._tree_from_levels(tl, DEPTH)])


def test_tree_from_levels_is_jax_bit_for_bit():
    jl, _, _, _ = _grow_both(*_grow_inputs(5, dyadic=False))
    want = jg._tree_from_levels(jl, DEPTH)
    got = tg._tree_from_levels([{k: torch.tensor(v) for k, v in lv.items()}
                                for lv in jl], DEPTH)
    for attr in TREE_ATTRS + ("value", "gain"):
        np.testing.assert_array_equal(getattr(got, attr), getattr(want, attr))


def test_numpy_grower_is_jax_bit_for_bit():
    binned, grad, hess, _, _ = _grow_inputs(6, dyadic=False)
    rng = np.random.default_rng(6)
    rows = rng.choice(len(grad), 2000, replace=False)
    feats = rng.choice(6, 4, replace=False)
    args = (binned, grad.astype(np.float64), hess.astype(np.float64), rows,
            N_BINS, DEPTH, 20, 0.1, feats)
    want, got = jg._grow_tree(*args), tg._grow_tree(*args)
    for attr in TREE_ATTRS + ("value", "gain"):
        np.testing.assert_array_equal(getattr(got, attr), getattr(want, attr))


# --- the jax.random replay ------------------------------------------------ #

@pytest.mark.parametrize("seed", [0, 1, 42, -7, 2 ** 31 - 1])
def test_split_and_bernoulli_replay_jax(seed):
    key, port_key = jax.random.PRNGKey(seed), qz.prng_key(seed)
    for n in (1, 3, 999, 4097):
        key, k1 = jax.random.split(key)
        port_key, port_k1 = qz.threefry_split(port_key)
        assert port_key == tuple(np.asarray(jax.random.key_data(key)).tolist())
        assert port_k1 == tuple(np.asarray(jax.random.key_data(k1)).tolist())
        want = np.asarray(jax.random.bernoulli(k1, 0.8, (n,)))
        got = qz.threefry_bernoulli(port_k1, 0.8, n, device="cpu")
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(), want)


# --- training ----------------------------------------------------------- #

def test_train_matches_jax(trained):
    jr, jev, tr, tev = trained
    assert tr.backend_used == jr.backend
    assert tr.best_iteration == jr.best_iteration >= 1
    assert tev["valid_ndcg@10"] == jev["valid_ndcg@10"]
    assert tev["train_ndcg@10"] == jev["train_ndcg@10"]
    assert tr.evals_result is tev and max(tev["valid_ndcg@10"]) > 0.5
    np.testing.assert_array_equal(tr.bin_edges, jr.bin_edges)
    _assert_same_trees(jr.trees, tr.trees)


def test_grad_slices_change_nothing(frames, monkeypatch):
    """The device backend's gradients computed 7 groups at a time equal
    those of one slice, bit for bit (each row is written once)."""
    df, _ = frames
    cols = _columns(df)
    one = tg.HistGBDTRanker(backend="device", device="cpu", n_estimators=3,
                            max_depth=DEPTH, n_bins=N_BINS)
    one.train(cols, FEATURES)
    monkeypatch.setattr(tg, "GRAD_SLICE_GROUPS", 7)
    many = tg.HistGBDTRanker(backend="device", device="cpu", n_estimators=3,
                             max_depth=DEPTH, n_bins=N_BINS)
    many.train(cols, FEATURES)
    for a, b in zip(one.trees, many.trees):
        for attr in TREE_ATTRS + ("value", "gain"):
            np.testing.assert_array_equal(getattr(a, attr), getattr(b, attr))


def test_auto_takes_numpy_on_the_cpu(frames):
    df, _ = frames
    r = tg.HistGBDTRanker(n_estimators=2, max_depth=2, n_bins=8, device="cpu")
    r.train(_columns(df), FEATURES)
    assert r.backend == "auto" and r.backend_used == "numpy"


def test_bad_arguments_raise():
    with pytest.raises(ValueError, match="backend"):
        tg.HistGBDTRanker(backend="gpu", device="cpu")
    with pytest.raises(ValueError, match="uint8"):
        tg.HistGBDTRanker(n_bins=300, device="cpu")
    with pytest.raises(RuntimeError, match="not trained"):
        tg.HistGBDTRanker(device="cpu").predict(np.zeros((2, 3), np.float32))


# --- inference and files ------------------------------------------------- #

def _rows_with_specials(n_feat, seed=8):
    x = np.random.default_rng(seed).normal(size=(3, 40, n_feat)).astype(np.float32)
    x[0, 0, :] = np.nan
    x[0, 1, :] = np.inf
    x[0, 2, :] = -np.inf
    x[1, :5, 0] = np.nan
    x[2, 3, 1] = np.inf
    return x


def _c22_bound(ranker):
    """Two f32 sums of the same T leaf values in different orders differ by
    at most 2(T−1)·2⁻²⁴·Σ|v| (C.22), Σ|v| at most the sum of each tree's
    largest leaf; times the learning rate, plus a rounding of each side's
    product."""
    mag = sum(float(np.abs(t.value).max()) for t in ranker.trees)
    n = len(ranker.trees)
    return ranker.learning_rate * mag * (2 * (n - 1) + 2) * 2.0 ** -24


def test_jax_saved_model_in_the_port(trained, tmp_path):
    jr, _, _, _ = trained
    jr.save(str(tmp_path / "g.npz"))
    tr = tg.HistGBDTRanker.load(str(tmp_path / "g.npz"), device="cpu")
    x = _rows_with_specials(len(FEATURES))
    flat = x.reshape(-1, len(FEATURES))
    np.testing.assert_array_equal(tr.predict(flat), jr.predict(flat))
    frame = {c: flat[:, j] for j, c in enumerate(FEATURES)}
    np.testing.assert_array_equal(tr.predict(frame), jr.predict(flat))
    want = np.asarray(jr.make_device_scorer()(jnp.asarray(x)))
    got = tr.make_device_scorer()(torch.as_tensor(x))
    assert got.shape == (3, 40) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=_c22_bound(tr))
    np.testing.assert_allclose(tr.predict_device(torch.as_tensor(x)).numpy(), want,
                               rtol=0, atol=_c22_bound(tr))


def test_descent_in_tree_chunks(trained, monkeypatch):
    """Chunks of 3 trees (``SCORE_CHUNK_PAIRS``) score as one chunk, within
    the C.22 bound."""
    _, _, tr, _ = trained
    x = torch.as_tensor(_rows_with_specials(len(FEATURES), seed=9))
    whole = tr.make_device_scorer()(x)
    monkeypatch.setattr(tg, "SCORE_CHUNK_PAIRS", 3 * 120)
    chunked = tr.make_device_scorer()(x)
    np.testing.assert_allclose(chunked.numpy(), whole.numpy(), rtol=0,
                               atol=_c22_bound(tr))


def test_nan_bins_keep_each_paths_rule(trained):
    """Host ``_bin`` puts NaN in the last bin (as +inf), the device scorer
    in bin 0 (as −inf), in both packages (C.44)."""
    jr, _, tr, _ = trained
    x = np.random.default_rng(10).normal(size=(50, len(FEATURES))).astype(np.float32)
    x[::3, 0] = np.nan
    x[1::5, 1] = np.nan
    hi, lo = x.copy(), x.copy()
    hi[np.isnan(x)] = np.inf
    lo[np.isnan(x)] = -np.inf
    np.testing.assert_array_equal(tr.predict(x), tr.predict(hi))
    np.testing.assert_array_equal(jr.predict(x), jr.predict(hi))
    scorer = tr.make_device_scorer()
    assert torch.equal(scorer(torch.as_tensor(x)), scorer(torch.as_tensor(lo)))
    jscore = jr.make_device_scorer()
    np.testing.assert_array_equal(np.asarray(jscore(jnp.asarray(x))),
                                  np.asarray(jscore(jnp.asarray(lo))))
    assert not np.array_equal(tr.predict(x), tr.predict(lo))


def test_port_saved_model_in_jax(trained, tmp_path):
    jr, _, tr, _ = trained
    tr.save(str(tmp_path / "port.npz"))
    jr.save(str(tmp_path / "jax.npz"))
    back = jg.HistGBDTRanker.load(str(tmp_path / "port.npz"))
    x = _rows_with_specials(len(FEATURES)).reshape(-1, len(FEATURES))
    np.testing.assert_array_equal(back.predict(x), tr.predict(x))
    assert back.feature_names == tr.feature_names
    assert back.best_iteration == tr.best_iteration
    port_meta = json.loads((tmp_path / "port.npz.meta.json").read_text())
    jax_meta = json.loads((tmp_path / "jax.npz.meta.json").read_text())
    assert port_meta == jax_meta
    with np.load(tmp_path / "port.npz") as a, np.load(tmp_path / "jax.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k


def test_export_arrays_equal(trained):
    jr, _, tr, _ = trained
    want, got = jr.export_arrays(), tr.export_arrays()
    assert set(got) == set(want)
    for k in ("feature", "bin_threshold", "left", "right", "bin_edges",
              "max_depth", "n_trees", "learning_rate"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k


def test_importance_and_model_info_equal(tmp_path, trained):
    jr, _, _, _ = trained
    jr.save(str(tmp_path / "g.npz"))
    tr = tg.HistGBDTRanker.load(str(tmp_path / "g.npz"), device="cpu")
    assert tr.feature_importance() == jr.feature_importance()
    assert tr.top_features(5) == jr.top_features(5)
    assert tr.model_info() == jr.model_info()
    assert tg.HistGBDTRanker(device="cpu").model_info() == \
        jg.HistGBDTRanker().model_info() == {"trained": False}
