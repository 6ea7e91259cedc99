"""The port's differentiable towers (``models/two_tower.py`` functions)
against the JAX towers on params carried across with ``from_jax_params``.

Tolerances: f32 towers and their gradients 1e-5 (two small matmuls and a
normalisation, summed in other orders); the bfloat16 compute path 2e-2
absolute on unit-norm outputs — both sides round the matmul results and
the hidden layer to bf16 (8 bits of mantissa), at places that differ.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recommendit_tpu.models import two_tower as jtt
from recommendit_tpu_torch.models import two_tower as ttt

N_USERS, N_ITEMS, DIM, HIDDEN = 40, 70, 16, 32


@pytest.fixture(scope="module")
def carried():
    params = jtt.init_params(jax.random.PRNGKey(3), N_USERS, N_ITEMS, DIM, HIDDEN)
    params["item_bias"] = jnp.asarray(
        np.random.default_rng(0).normal(size=N_ITEMS + 1), jnp.float32)
    np_params = {k: np.asarray(v) for k, v in params.items()}
    model = ttt.from_jax_params(np_params, device="cpu")
    return params, model


def _inputs(seed=1, b=50):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, N_USERS + 1, b), rng.integers(0, N_ITEMS + 1, b),
            rng.integers(0, 2, (b, 18)).astype(np.float32))


def test_from_jax_params_reads_sizes_and_values(carried):
    params, model = carried
    assert (model.n_users, model.n_items, model.embed_dim, model.hidden_dim) == (
        N_USERS, N_ITEMS, DIM, HIDDEN)
    for k, v in model.params().items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(params[k]))


def test_towers_match_jax(carried):
    params, model = carried
    u, i, g = _inputs()
    tp = model.params()
    np.testing.assert_allclose(
        ttt.user_tower(tp, torch.as_tensor(u)).numpy(),
        np.asarray(jtt.user_tower(params, jnp.asarray(u))), atol=1e-5, rtol=0)
    np.testing.assert_allclose(
        ttt.item_tower(tp, torch.as_tensor(i), torch.as_tensor(g)).numpy(),
        np.asarray(jtt.item_tower(params, jnp.asarray(i), jnp.asarray(g))),
        atol=1e-5, rtol=0)


def test_from_embed_heads_match_jax(carried):
    params, model = carried
    rng = np.random.default_rng(2)
    emb = rng.normal(size=(30, DIM)).astype(np.float32)
    g = rng.integers(0, 2, (30, 18)).astype(np.float32)
    tp = model.params()
    np.testing.assert_allclose(
        ttt.user_tower_from_embed(tp, torch.as_tensor(emb)).numpy(),
        np.asarray(jtt.user_tower_from_embed(params, jnp.asarray(emb))),
        atol=1e-5, rtol=0)
    np.testing.assert_allclose(
        ttt.item_tower_from_embed(tp, torch.as_tensor(emb), torch.as_tensor(g)).numpy(),
        np.asarray(jtt.item_tower_from_embed(params, jnp.asarray(emb), jnp.asarray(g))),
        atol=1e-5, rtol=0)


def test_tower_gradients_match_jax(carried):
    """d/dparams of Σ w ⊙ (user tower ⊙ item tower), dense over the
    embedding tables as in JAX."""
    params, model = carried
    u, i, g = _inputs(seed=4)
    w = np.random.default_rng(5).normal(size=(len(u), DIM)).astype(np.float32)

    def jf(p):
        return jnp.sum(jnp.asarray(w) * jtt.user_tower(p, jnp.asarray(u))
                       * jtt.item_tower(p, jnp.asarray(i), jnp.asarray(g)))

    want = jax.grad(jf)(params)
    tp = {k: v.clone().requires_grad_() for k, v in model.params().items()}
    out = (torch.as_tensor(w) * ttt.user_tower(tp, torch.as_tensor(u))
           * ttt.item_tower(tp, torch.as_tensor(i), torch.as_tensor(g))).sum()
    out.backward()
    for k, p in tp.items():
        if k == "item_bias":
            assert p.grad is None
            continue
        assert p.grad.layout == torch.strided and p.grad.shape == p.shape
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(want[k]),
                                   atol=1e-5, rtol=0)


def test_function_towers_equal_the_inference_methods(carried):
    _, model = carried
    u, i, g = _inputs(seed=6)
    tp = model.params()
    assert torch.equal(ttt.user_tower(tp, torch.as_tensor(u)),
                       model.user_tower(torch.as_tensor(u)))
    assert torch.equal(ttt.item_tower(tp, torch.as_tensor(i), torch.as_tensor(g)),
                       model.item_tower(torch.as_tensor(i), torch.as_tensor(g)))


def test_bfloat16_compute_matches_jax(carried):
    params, model = carried
    u, i, g = _inputs(seed=7)
    tp = model.params()
    got_u = ttt.user_tower(tp, torch.as_tensor(u), compute_dtype=torch.bfloat16)
    got_i = ttt.item_tower(tp, torch.as_tensor(i), torch.as_tensor(g),
                           compute_dtype=torch.bfloat16)
    assert got_u.dtype == got_i.dtype == torch.float32
    want_u = jtt.user_tower(params, jnp.asarray(u), compute_dtype=jnp.bfloat16)
    want_i = jtt.item_tower(params, jnp.asarray(i), jnp.asarray(g),
                            compute_dtype=jnp.bfloat16)
    np.testing.assert_allclose(got_u.numpy(), np.asarray(want_u), atol=2e-2, rtol=0)
    np.testing.assert_allclose(got_i.numpy(), np.asarray(want_i), atol=2e-2, rtol=0)
    # and it is a rounding of the f32 towers, not another function
    np.testing.assert_allclose(
        got_u.numpy(), ttt.user_tower(tp, torch.as_tensor(u)).numpy(),
        atol=3e-2, rtol=0)


@pytest.mark.parametrize("rate", [0.2, 0.5])
def test_dropout_keep_rate_and_scale(rate):
    """h = relu(x + 1) > 0 through identity weights: the output is the
    dropout of h itself. The keep share over 4096 x 128 units must lie
    within 5 standard deviations of 1 − rate, and every kept unit is
    h / (1 − rate)."""
    x = torch.rand(4096, 128, generator=torch.Generator().manual_seed(0))
    eye, ones, zeros = torch.eye(128), torch.ones(128), torch.zeros(128)
    h = torch.relu(x + ones)
    out = ttt._mlp(x, eye, ones, eye, zeros, rate,
                   torch.Generator().manual_seed(1))
    kept = out != 0
    n = kept.numel()
    sd = np.sqrt(rate * (1 - rate) / n)
    assert abs(float(kept.float().mean()) - (1 - rate)) <= 5 * sd
    assert torch.equal(out[kept], h[kept] / (1.0 - rate))


def test_dropout_replays_from_the_generator_state():
    """Two towers run from one generator state draw one mask (the pairwise
    positive and negative towers, as JAX's shared key k2 gives them)."""
    x = torch.rand(64, 8, generator=torch.Generator().manual_seed(2))
    w1, b1 = torch.randn(8, 16), torch.zeros(16)
    w2, b2 = torch.randn(16, 4), torch.zeros(4)
    gen = torch.Generator().manual_seed(3)
    state = gen.get_state()
    a = ttt._mlp(x, w1, b1, w2, b2, 0.3, gen)
    gen.set_state(state)
    b = ttt._mlp(x, w1, b1, w2, b2, 0.3, gen)
    c = ttt._mlp(x, w1, b1, w2, b2, 0.3, gen)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(ttt._mlp(x, w1, b1, w2, b2, 0.3, None),
                       ttt._mlp(x, w1, b1, w2, b2))


def test_init_params_follow_the_jax_initialisers():
    p = ttt.init_params(torch.Generator().manual_seed(0), 300, 400, 64, 128, device="cpu")
    want = jtt.init_params(jax.random.PRNGKey(0), 300, 400, 64, 128)
    for k, v in want.items():
        assert tuple(p[k].shape) == v.shape and p[k].dtype == torch.float32
    assert not p["user_embed"][0].any() and not p["item_embed"][0].any()
    assert not p["item_bias"].any() and not p["user_b1"].any()
    assert abs(float(p["user_embed"][1:].std()) - 0.1) < 0.005
    limit = np.sqrt(6.0 / (64 + 18 + 128))
    assert float(p["item_w1"].abs().max()) <= limit
    assert float(p["item_w1"].abs().max()) > 0.95 * limit


def test_precompute_item_embeddings_keeps_the_catalog(carried):
    _, model = carried
    ids = np.arange(1, N_ITEMS + 1)
    g = np.random.default_rng(8).integers(0, 2, (N_ITEMS, 18)).astype(np.float32)
    out = model.precompute_item_embeddings(ids, g)
    assert out.shape == (N_ITEMS, DIM) and model._item_embeddings is out
    np.testing.assert_array_equal(model._item_ids, ids)
