"""The port's sparse table update (``recommendit_tpu_torch/ops/sparse_embed.py``)
against JAX's (``recommendit_tpu/ops/sparse_embed.py``) on the CPU.

Inputs come from a seeded numpy generator, with duplicate ids in small and
large fields and vocabularies on both sides of the 4,096 threshold. A
touched row's sums run in another order than JAX's (one ``index_add_`` in
place of a one-hot product), so the table and the accumulator are held to
C.22's bound over each row's terms: for a row hit k times, the table entry
x - scale·Σg is a sum of k + 1 terms with one more rounding in the scale,
so |port − JAX| <= 2(k+1)·2⁻²⁴·(|x| + scale·Σ|g_i|), and the accumulator
a + Σ mean(g_i²) (large fields) or a + mean((Σg)²) (small) likewise over
a + 2·mean((Σ|g_i|)²). Rows no id touches are bit-equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recommendit_tpu.ops import sparse_embed as jse
from recommendit_tpu_torch.ops import sparse_embed as tse

EPS32 = 2.0 ** -24
VOCABS = ((5000, 300, 7, 4097), (50, 7, 3000), (4096, 4097), (9000,), (11, 3, 600))


def _inputs(vocab, seed, b=256, d=8, threshold=4096):
    rng = np.random.default_rng(seed)
    rows = sum(vocab)
    offs = np.concatenate([[0], np.cumsum(vocab)[:-1]])
    raw = np.stack([rng.integers(0, v, size=b) for v in vocab], 1)
    raw[1:9] = raw[0]                      # duplicates in every field
    for f, v in enumerate(vocab):          # ... and a few ids hit 3-5 times
        raw[20:25, f] = rng.integers(0, v)
    table = rng.standard_normal((rows, d)).astype(np.float32)
    accum = (rng.random(rows) * 0.5).astype(np.float32)
    accum[: rows // 3] = 0.0               # fresh rows too
    ids = (raw + offs[None, :]).astype(np.int32)
    grads = rng.standard_normal((b, len(vocab), d)).astype(np.float32)
    return table, accum, ids, grads


def _jax_update(table, accum, ids, grads, vocab, **kw):
    t, a = jax.jit(lambda t, a, i, g: jse.sparse_table_update(t, a, i, g, vocab, **kw))(
        jnp.asarray(table), jnp.asarray(accum), jnp.asarray(ids), jnp.asarray(grads))
    return np.asarray(t), np.asarray(a)


def _port_update(table, accum, ids, grads, vocab, **kw):
    t, a = torch.tensor(table), torch.tensor(accum)
    out = tse.sparse_table_update(t, a, torch.tensor(ids), torch.tensor(grads), vocab, **kw)
    assert out[0] is t and out[1] is a     # in place
    return t.numpy(), a.numpy()


def _c22_bounds(table, accum, ids, grads, want_accum, lr, eps=1e-8):
    """Per-row bounds of the table and the accumulator (module docstring)."""
    rows, d = table.shape
    k = np.zeros(rows)
    g_abs = np.zeros((rows, d))
    sq = np.zeros(rows)
    flat_ids = ids.reshape(-1)
    flat_g = grads.reshape(-1, d).astype(np.float64)
    np.add.at(k, flat_ids, 1)
    np.add.at(g_abs, flat_ids, np.abs(flat_g))
    np.add.at(sq, flat_ids, (flat_g ** 2).mean(axis=1))
    scale = lr / (np.sqrt(want_accum.astype(np.float64)) + eps)
    t_tol = 2 * (k + 1)[:, None] * EPS32 * (np.abs(table) + scale[:, None] * g_abs)
    a_tol = 2 * (k + 1) * EPS32 * (accum + sq + 2 * (g_abs ** 2).mean(axis=1))
    return t_tol, a_tol, k > 0


@pytest.mark.parametrize("threshold", [4096, 100])
@pytest.mark.parametrize("vocab", VOCABS)
def test_matches_jax_within_c22(vocab, threshold):
    table, accum, ids, grads = _inputs(vocab, seed=sum(vocab) + threshold)
    kw = dict(lr=0.05, small_threshold=threshold)
    jt, ja = _jax_update(table, accum, ids, grads, vocab, **kw)
    pt, pa = _port_update(table, accum, ids, grads, vocab, **kw)
    t_tol, a_tol, touched = _c22_bounds(table, accum, ids, grads, ja, lr=0.05)
    assert (np.abs(pt - jt) <= t_tol).all(), np.abs(pt - jt).max()
    assert (np.abs(pa - ja) <= a_tol).all(), np.abs(pa - ja).max()
    # rows no id touches: bit-equal to JAX's and to the input
    np.testing.assert_array_equal(pt[~touched], jt[~touched])
    np.testing.assert_array_equal(pt[~touched], table[~touched])
    np.testing.assert_array_equal(pa[~touched], accum[~touched])
    assert touched.sum() < len(touched) and (pt[touched] != table[touched]).any()


def test_duplicate_id_semantics_by_field_kind():
    """The JAX docstring's rule, by a numpy loop over fields: the table moves
    by -scale·Σg in both kinds; the accumulator adds mean((Σg)²) in small
    fields and Σ mean(g_i²) in large ones (f64 reference, rtol 1e-5)."""
    vocab = (50, 7, 3000)
    table, accum, ids, grads = _inputs(vocab, seed=0, b=16, d=4)
    pt, pa = _port_update(table, accum, ids, grads, vocab, small_threshold=100)
    t_ref, a_ref = table.astype(np.float64), accum.astype(np.float64)
    for f, v in enumerate(vocab):
        uniq, inv = np.unique(ids[:, f], return_inverse=True)
        g = np.zeros((len(uniq), 4))
        np.add.at(g, inv, grads[:, f, :])
        if v <= 100:
            a_ref[uniq] += np.mean(g * g, axis=1)
        else:
            per_ex = np.zeros(len(uniq))
            np.add.at(per_ex, inv, np.mean(grads[:, f, :].astype(np.float64) ** 2, axis=1))
            a_ref[uniq] += per_ex
        t_ref[uniq] -= (0.05 / (np.sqrt(a_ref[uniq]) + 1e-8))[:, None] * g
    np.testing.assert_allclose(pt, t_ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(pa, a_ref, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("vocab", [(5000, 300, 7, 4097), (3, 5)])
def test_field_split_is_jax(vocab):
    assert tse.field_split(vocab) == jse.field_split(vocab)
    assert tse.field_split(vocab, 6) == jse.field_split(vocab, 6)
    assert tse.DEFAULT_SMALL_VOCAB == jse.DEFAULT_SMALL_VOCAB


def test_adagrad_init():
    a = tse.sparse_adagrad_init(26_660, device="cpu")
    assert a.dtype == torch.float32 and a.shape == (26_660,) and not a.any()
    np.testing.assert_array_equal(a.numpy(), np.asarray(jse.sparse_adagrad_init(26_660)))


def test_adagrad_init_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs an NVIDIA GPU"):
        tse.sparse_adagrad_init(8)


@pytest.mark.parametrize("bad", [-1, 9_404])   # the table holds 9,404 rows
def test_out_of_range_id_raises_on_the_cpu(bad):
    """C.50: ids are checked where they enter (``CTRModel.stack_ids``); an
    unchecked out-of-range id reaching the op raises here (JAX drops it)."""
    vocab = (5000, 300, 7, 4097)
    table, accum, ids, grads = _inputs(vocab, seed=1)
    ids[3, 3] = bad
    with pytest.raises((IndexError, RuntimeError)):
        _port_update(table, accum, ids, grads, vocab)
