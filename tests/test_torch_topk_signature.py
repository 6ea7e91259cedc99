"""``mips_topk`` and the sharded retrieval with JAX's signatures (ROADMAP
C.58), against the JAX package on the CPU.

* JAX's call forms — ``mips_topk(q, it, k, 4096)`` (``bench.py``,
  ``scripts/quality_at_scale.py``), ``(…, 4096, "approx")`` and
  ``(…, 4096, "exact", True, n_valid)`` — run on the port and equal JAX's
  after ``canonical_tie_order``: ids equal, values within 1e-5.
* Exact mode scores in column chunks: with ``_SCORE_BUDGET`` patched small
  in the port's module only, a wrapped ``score_matrix`` sees several calls,
  none above the budget, and the result equals JAX's unpatched call.
* Below ``_WINDOWED_MIN_Q`` queries within one chunk exact mode makes one
  product and one top-k, and the windowed path from it on; both equal
  JAX's.
* The approx branch past the dense limit streams blocks (``_scan_topk``).
* The sharded merges take ``block_size`` in JAX's position
  (``fn(q, shard, k, mesh, 4096)``) and the serve function takes
  ``block_size=``: 4 gloo ranks against JAX's sharded functions on the
  virtual (2, 4) mesh.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recommendit_tpu.models.ranker import init_mlp, mlp_score
from recommendit_tpu.models.two_tower import init_params
from recommendit_tpu.ops import topk as jtopk
from recommendit_tpu.parallel import create_mesh as jax_create_mesh
from recommendit_tpu.parallel import sharded_mips_topk as jax_merge
from recommendit_tpu.parallel import sharded_mips_topk_ring as jax_ring
from recommendit_tpu.parallel.mesh import row_sharded as jax_row_sharded
from recommendit_tpu.parallel.serve import make_sharded_serve_fn as jax_serve_fn
from recommendit_tpu_torch.ops import topk
from recommendit_tpu_torch.parallel.launch import spawn
from recommendit_tpu_torch.parallel.parity import run_block_size_cases

VAL_TOL = 1e-5


def _data(n_q, n, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n_q, d)).astype(np.float32),
            rng.normal(size=(n, d)).astype(np.float32))


def _canon(v, i):
    cv, ci = topk.canonical_tie_order(torch.as_tensor(np.array(v)),
                                      torch.as_tensor(np.array(i)).long())
    return cv.numpy(), ci.numpy()


def _same(got, want):
    gv, gi = _canon(*got)
    wv, wi = _canon(*want)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_allclose(gv, wv, rtol=0, atol=VAL_TOL)


CALL_FORMS = {
    "block": lambda f, q, it, k, nv: f(q, it, k, 4096),
    "block_approx": lambda f, q, it, k, nv: f(q, it, k, 4096, "approx"),
    "exact_canonical_n_valid": lambda f, q, it, k, nv: f(q, it, k, 4096, "exact",
                                                         True, nv),
}


@pytest.mark.parametrize("form", list(CALL_FORMS))
def test_jax_call_forms_run_and_match(form):
    qs, items = _data(6, 5000, 16, seed=1)
    call = CALL_FORMS[form]
    want = call(jtopk.mips_topk, jnp.asarray(qs), jnp.asarray(items), 50, 4800)
    got = call(topk.mips_topk, torch.as_tensor(qs), torch.as_tensor(items), 50, 4800)
    _same(tuple(t.numpy() for t in got), tuple(np.asarray(a) for a in want))
    if form == "exact_canonical_n_valid":
        # canonical lists come back already in (value desc, index asc) order
        cv, ci = _canon(got[0].numpy(), got[1].numpy())
        np.testing.assert_array_equal(got[1].numpy(), ci)
        assert int(got[1].max()) < 4800


def test_unknown_mode_raises():
    qs, items = _data(2, 100, 8, seed=2)
    with pytest.raises(ValueError, match="unknown mips_topk mode"):
        topk.mips_topk(torch.as_tensor(qs), torch.as_tensor(items), 5, 4096,
                       "verified")


def test_exact_mode_scores_within_the_budget(monkeypatch):
    n_q, n = 8, 50_000
    qs, items = _data(n_q, n, 8, seed=3)
    budget = n_q * topk._REDUCE_CHUNK          # chunks of 16,384 columns
    monkeypatch.setattr(topk, "_SCORE_BUDGET", budget)
    sizes = []
    real = topk.score_matrix

    def spy(q, it, precision="highest"):
        sizes.append(q.shape[0] * it.shape[0])
        return real(q, it, precision)

    monkeypatch.setattr(topk, "score_matrix", spy)
    got = topk.mips_topk(torch.as_tensor(qs), torch.as_tensor(items), 300, 4096)
    assert len(sizes) == -(-n // topk._REDUCE_CHUNK) == 4
    assert max(sizes) <= budget
    want = jtopk.mips_topk(jnp.asarray(qs), jnp.asarray(items), 300, 4096)
    _same(tuple(t.numpy() for t in got), tuple(np.asarray(a) for a in want))


@pytest.mark.parametrize("n_q", [1, 8, 31, 32, 70])
def test_exact_mode_takes_one_product_only_for_few_queries(monkeypatch, n_q):
    """Below ``_WINDOWED_MIN_Q`` queries within one chunk, exact mode makes
    one product and one top-k; from it on, the windowed ``_exact_topk``.
    Both equal JAX's exact mode, which always takes the windowed path."""
    qs, items = _data(n_q, 150_000, 8, seed=7)
    paths = []
    real = topk._exact_topk

    def spy(*a, **k):
        paths.append("windowed")
        return real(*a, **k)

    monkeypatch.setattr(topk, "_exact_topk", spy)
    got = topk.mips_topk(torch.as_tensor(qs), torch.as_tensor(items), 200, 4096)
    assert paths == ([] if n_q < topk._WINDOWED_MIN_Q else ["windowed"])
    want = jtopk.mips_topk(jnp.asarray(qs), jnp.asarray(items), 200, 4096)
    _same(tuple(t.numpy() for t in got), tuple(np.asarray(a) for a in want))


def test_approx_past_the_dense_limit_streams_blocks(monkeypatch):
    qs, items = _data(4, 9000, 12, seed=4)
    calls = []
    real = topk._scan_topk

    def spy(*args):
        calls.append(args[3])
        return real(*args)

    monkeypatch.setattr(topk, "_APPROX_DENSE_LIMIT", 4 * 1000)
    monkeypatch.setattr(topk, "_scan_topk", spy)
    got = topk.mips_topk(torch.as_tensor(qs), torch.as_tensor(items), 40, 2048,
                         "approx", n_valid=8500)
    assert calls == [2048]
    # JAX's own streamed branch (Q·N past its 512M limit only at scale):
    # its _scan_topk with the same block and mask
    want = jtopk._scan_topk(jnp.asarray(qs), jnp.asarray(items), 40, 2048, 0.95,
                            None, 8500)
    _same(tuple(t.numpy() for t in got), tuple(np.asarray(a) for a in want))
    assert int(got[1].max()) < 8500


def _inputs():
    rng = np.random.default_rng(5)
    serve_users, serve_items = 64, 128
    return {
        "retrieval": {"q": rng.normal(size=(8, 16)).astype(np.float32),
                      "items": rng.normal(size=(512, 16)).astype(np.float32),
                      "k": 20, "block_size": 4096},
        "serve": {"params": {k: np.asarray(v) for k, v in init_params(
                      jax.random.PRNGKey(0), serve_users - 1, serve_items - 1,
                      16, 32).items()},
                  "corpus": rng.normal(size=(serve_items, 16)).astype(np.float32),
                  "item_ids": np.arange(1, serve_items + 1),
                  "user_packed": rng.normal(size=(serve_users, 24)).astype(np.float32),
                  "item_packed": rng.normal(size=(serve_items + 1, 23)).astype(np.float32),
                  "ranker": {k: np.asarray(v) for k, v in init_mlp(
                      jax.random.PRNGKey(1), 50, (16,)).items()},
                  "user_ids": rng.integers(1, serve_users, size=16),
                  "n_candidates": 32, "k_out": 8, "block_size": 32},
    }


@pytest.fixture(scope="module")
def block_size_runs():
    inputs = _inputs()
    ranks = spawn(run_block_size_cases, 4, ((2, 2), inputs), device="cpu",
                  timeout=240)
    mesh = jax_create_mesh(shape=(2, 4))
    c = inputs["retrieval"]
    q, items = jnp.asarray(c["q"]), jnp.asarray(c["items"])
    ref = {name: fn(q, jax.device_put(items, jax_row_sharded(mesh)), c["k"], mesh,
                    c["block_size"])
           for name, fn in (("allgather", jax_merge), ("ring", jax_ring))}
    ref["single"] = jtopk.mips_topk(q, items, c["k"], c["block_size"])
    s = inputs["serve"]
    rparams = {k: jnp.asarray(v) for k, v in s["ranker"].items()}
    serve = jax_serve_fn(
        mesh, {k: jnp.asarray(v) for k, v in s["params"].items()},
        jax.device_put(jnp.asarray(s["corpus"]), jax_row_sharded(mesh)),
        jnp.asarray(s["item_ids"], jnp.int32), jnp.asarray(s["user_packed"]),
        jnp.asarray(s["item_packed"]), lambda f: mlp_score(rparams, f),
        s["n_candidates"], s["k_out"], s["block_size"])
    ref["serve"] = tuple(np.asarray(x) for x in
                         serve(jnp.asarray(s["user_ids"], jnp.int32)))
    return ranks, ref


@pytest.mark.parametrize("merge", ["allgather", "ring"])
def test_sharded_merges_take_the_block_positionally(block_size_runs, merge):
    ranks, ref = block_size_runs
    want = tuple(np.asarray(a) for a in ref[merge])
    for r in ranks:
        _same(r[merge], want)
        _same(r[merge], tuple(np.asarray(a) for a in ref["single"]))


def test_sharded_serve_takes_block_size(block_size_runs):
    ranks, ref = block_size_runs
    want_ids, want_scores, want_rvals = ref["serve"]
    for r in ranks:
        ids, scores, rvals = r["serve"]
        np.testing.assert_array_equal(ids, want_ids)
        np.testing.assert_allclose(scores, want_scores, rtol=0, atol=VAL_TOL)
        np.testing.assert_allclose(rvals, want_rvals, rtol=0, atol=VAL_TOL)


def test_fast_topk_takes_jax_signature_and_stays_exact():
    """``fast_topk(scores, k, recall_target=1.0)`` as JAX's
    (``ops/topk.py:51``); at every target the exact top-k (C.4), equal to
    JAX's exact selection."""
    import inspect

    want = inspect.signature(jtopk.fast_topk).parameters
    got = inspect.signature(topk.fast_topk).parameters
    assert list(got) == list(want)
    assert got["recall_target"].default == want["recall_target"].default == 1.0
    scores = np.random.default_rng(7).normal(size=(6, 3000)).astype(np.float32)
    wv, wi = jtopk.fast_topk(jnp.asarray(scores), 40)
    for target in (1.0, 0.99, 0.95, 0.8):
        v, i = topk.fast_topk(torch.as_tensor(scores), 40, target)
        np.testing.assert_array_equal(v.numpy(), np.asarray(wv))
        np.testing.assert_array_equal(i.numpy(), np.asarray(wi))
        v, i = topk.fast_topk(torch.as_tensor(scores), 40, recall_target=target)
        np.testing.assert_array_equal(i.numpy(), np.asarray(wi))
