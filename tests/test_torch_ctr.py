"""The port's CTR family (``recommendit_tpu_torch/{data,models}/ctr.py`` and the
scripts) against the JAX package's on the CPU.

* The data module is a copy, pinned by syntax tree; its datasets equal
  JAX's at two seeds.
* From JAX's ``init_ctr_params`` (carried across with ``from_jax_params``)
  the forward agrees in f32 within 1e-5 (sums of ~350 products in another
  order; 3.6e-7 seen) and, with ``compute_dtype`` bf16, within one bf16
  ulp of the largest logit, 2⁻⁸·max|logit| (bit-equal seen). The
  ``CTRModel`` surfaces (``predict_proba``, the two tower embeddings) agree
  within 1e-6.
* ``bce_loss``, ``weighted_in_batch_softmax`` and the trainer's loss from
  rows agree with JAX's in value (rtol 1e-6) and gradient (atol 1e-6 ·
  the largest entry + 1e-9), also at exact zeros, where JAX's tie
  gradients (½ for ``maximum``, 1 for ``abs``) differ from torch's own
  (C.49).
* Files move both ways; ids outside a field's vocabulary raise (C.50);
  the entry points default to the card.
* The scripts at a tiny size with ``--device cpu`` print JAX's keys.
"""
import ast
import json
import runpy
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recommendit_tpu.config import settings as jax_settings
from recommendit_tpu.data import ctr as jdata
from recommendit_tpu.models import ctr as jctr
from recommendit_tpu.training.train_ctr import CTRTrainer as JaxTrainer
from recommendit_tpu_torch.config import settings
from recommendit_tpu_torch.data import ctr as tdata
from recommendit_tpu_torch.models import ctr as tctr
from recommendit_tpu_torch.training.train_ctr import CTRTrainer

ROOT = Path(__file__).resolve().parent.parent
DATA = dict(n_examples=2000, n_users=300, n_items=150, seed=7)
WIDTHS = dict(embed_dim=8, top_hidden=(64, 32), retrieval_dim=16)
F32_TOL = 1e-5


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
    return tdata.make_ctr_dataset(**DATA)


@pytest.fixture(scope="module")
def jax_params(data):
    p = jctr.init_ctr_params(jax.random.PRNGKey(0), data.vocab_sizes, **WIDTHS)
    return {k: np.asarray(v) for k, v in p.items()}


@pytest.fixture(scope="module")
def batch(data):
    ids = jctr.CTRModel(data.vocab_sizes, embed_dim=8).stack_ids(data.sparse[:512])
    return data.dense[:512], ids, data.labels[:512], data.item_ids[:512]


def _grad_close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max() + 1e-9)


# ------------------------------------------------------------------ #
# Data                                                                 #
# ------------------------------------------------------------------ #


def _body(path: Path) -> str:
    tree = ast.parse(path.read_text())
    body = tree.body
    if (body and isinstance(body[0], ast.Expr)
            and isinstance(body[0].value, ast.Constant)
            and isinstance(body[0].value.value, str)):
        body = body[1:]
    return ast.dump(ast.Module(body=body, type_ignores=[]))


def test_data_code_is_the_jax_code():
    assert _body(ROOT / "recommendit_tpu_torch/data/ctr.py") == _body(
        ROOT / "recommendit_tpu/data/ctr.py")


@pytest.mark.parametrize("seed", [0, 3])
def test_datasets_equal_jax(seed):
    kw = dict(n_examples=3000, n_users=120, n_items=70, seed=seed)
    a, b = jdata.make_ctr_dataset(**kw), tdata.make_ctr_dataset(**kw)
    assert a.vocab_sizes == b.vocab_sizes and a.n_user_fields == b.n_user_fields
    for x, y in [(a, b), *zip(a.split(0.1), b.split(0.1))]:
        for name in ("dense", "sparse", "labels", "user_ids", "item_ids",
                     "user_field_values", "item_field_values"):
            np.testing.assert_array_equal(getattr(y, name), getattr(x, name))
            assert getattr(y, name).dtype == getattr(x, name).dtype


# ------------------------------------------------------------------ #
# Model                                                                #
# ------------------------------------------------------------------ #


def test_offsets_and_interaction_indices_are_jax(data):
    np.testing.assert_array_equal(tctr.field_offsets(data.vocab_sizes),
                                  jctr.field_offsets(data.vocab_sizes))
    assert tctr.total_vocab(data.vocab_sizes) == jctr.total_vocab(data.vocab_sizes)
    iu, ig = tctr._interaction_indices(27)
    assert len(iu) == 351
    for a, b in zip((iu, ig), jctr._interaction_indices(27)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("pad", [1, 8])
def test_init_draws_jax_distributions(data, pad):
    """Keys, shapes and dtypes as JAX's; normal × 0.05 for the table,
    Glorot-uniform weights, zero biases (moments within 3 %); one seed, one
    draw."""
    want = jctr.init_ctr_params(jax.random.PRNGKey(0), data.vocab_sizes,
                                pad_rows_to=pad)
    got = tctr.init_ctr_params(torch.Generator().manual_seed(0), data.vocab_sizes,
                               pad_rows_to=pad, device="cpu")
    assert {k: (v.shape, np.float32) for k, v in want.items()} == {
        k: (tuple(v.shape), np.float32) for k, v in got.items()}
    assert got["embed"].shape[0] % pad == 0
    assert abs(float(got["embed"].std()) / 0.05 - 1) < 0.03
    for k, v in got.items():
        if "_b" in k:
            assert not v.any()
        elif k != "embed":
            limit = float(np.sqrt(6.0 / (v.shape[0] + v.shape[-1])))
            assert float(v.abs().max()) <= limit
            if v.numel() > 2000:
                assert abs(float(v.std()) / (limit / np.sqrt(3)) - 1) < 0.03
    again = tctr.init_ctr_params(torch.Generator().manual_seed(0), data.vocab_sizes,
                                 pad_rows_to=pad, device="cpu")
    assert all(torch.equal(got[k], again[k]) for k in got)


@pytest.mark.parametrize("joint", [False, True])
def test_forward_matches_jax_f32(jax_params, batch, joint):
    dense, ids, _, _ = batch
    want = jctr.ctr_forward({k: jnp.asarray(v) for k, v in jax_params.items()},
                            jnp.asarray(dense), jnp.asarray(ids), joint=joint)
    got = tctr.ctr_forward(tctr.from_jax_params(jax_params, "cpu"),
                           torch.tensor(dense), torch.tensor(ids), joint=joint)
    want, got = (want, got) if joint else ((want,), (got,))
    for w, g in zip(want, got):         # logits, then ue and ie
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=F32_TOL)
    if joint:
        np.testing.assert_allclose(np.linalg.norm(got[1].numpy(), axis=1), 1.0,
                                   atol=1e-5)


@pytest.mark.parametrize("joint", [False, True])
def test_forward_matches_jax_bf16(jax_params, batch, joint):
    dense, ids, _, _ = batch
    want = jctr.ctr_forward({k: jnp.asarray(v) for k, v in jax_params.items()},
                            jnp.asarray(dense), jnp.asarray(ids), joint=joint,
                            compute_dtype=jnp.bfloat16)
    got = tctr.ctr_forward(tctr.from_jax_params(jax_params, "cpu"),
                           torch.tensor(dense), torch.tensor(ids), joint=joint,
                           compute_dtype=torch.bfloat16)
    w, g = (want[0], got[0]) if joint else (want, got)
    assert g.dtype == torch.float32
    w = np.asarray(w, np.float32)
    np.testing.assert_allclose(g.numpy(), w, rtol=0,
                               atol=2.0 ** -8 * np.abs(w).max())
    f32 = tctr.ctr_forward(tctr.from_jax_params(jax_params, "cpu"),
                           torch.tensor(dense), torch.tensor(ids), joint=joint)
    f32 = f32[0] if joint else f32
    assert not torch.equal(g, f32)      # the casts took effect


def test_model_surfaces_match_jax(data, jax_params):
    jm = jctr.CTRModel(data.vocab_sizes, params={k: jnp.asarray(v) for k, v in
                                                 jax_params.items()}, **WIDTHS)
    tm = tctr.CTRModel(data.vocab_sizes, params=tctr.from_jax_params(jax_params, "cpu"),
                       device="cpu", **WIDTHS)
    np.testing.assert_array_equal(tm.stack_ids(data.sparse), jm.stack_ids(data.sparse))
    for joint in (False, True):
        got = tm.predict_proba(data.dense, data.sparse, batch_size=700, joint=joint)
        want = jm.predict_proba(data.dense, data.sparse, batch_size=700, joint=joint)
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tm.item_corpus_embeddings(data.item_field_values, 64),
                               jm.item_corpus_embeddings(data.item_field_values, 64),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(tm.user_query_embeddings(data.user_field_values, 64),
                               jm.user_query_embeddings(data.user_field_values, 64),
                               rtol=0, atol=1e-6)


def _jax_bce_softmax_inputs(seed, n=256, zeros=0):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal(n).astype(np.float32)
    logits[:zeros] = 0.0
    labels = (rng.random(n) < 0.3).astype(np.float32)
    return logits, labels


@pytest.mark.parametrize("zeros", [0, 40])
def test_bce_loss_value_and_grad(zeros):
    logits, labels = _jax_bce_softmax_inputs(zeros, zeros=zeros)
    jl, jg = jax.value_and_grad(jctr.bce_loss)(jnp.asarray(logits), jnp.asarray(labels))
    x = torch.tensor(logits, requires_grad=True)
    tl = tctr.bce_loss(x, torch.tensor(labels))
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-6)
    _grad_close(x.grad.numpy(), jg)


def test_tie_gradients_are_jax_c49():
    """At a logit of exactly 0 JAX's BCE gradient is −y/N (``maximum``
    gives ½ and ``abs`` 1 there), not (σ(0) − y)/N as torch's own ops
    give; a ReLU at an exact 0 passes ½ of its gradient."""
    n = 8
    labels = np.array([1, 0, 1, 0, 1, 1, 0, 0], np.float32)
    x = torch.zeros(n, requires_grad=True)
    tctr.bce_loss(x, torch.tensor(labels)).backward()
    np.testing.assert_array_equal(x.grad.numpy(), -labels / n)
    jg = jax.grad(jctr.bce_loss)(jnp.zeros(n), jnp.asarray(labels))
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(jg))
    y = torch.zeros(n, requires_grad=True)
    torch.nn.functional.binary_cross_entropy_with_logits(y, torch.tensor(labels)).backward()
    assert not torch.equal(y.grad, x.grad)   # torch's own form differs at ties

    # the MLP ReLUs: pre-activations exactly 0 (zero inputs and biases)
    rng = np.random.default_rng(0)
    w1, w2 = (rng.standard_normal(s).astype(np.float32) for s in ((5, 6), (6, 3)))
    args = [np.zeros((4, 5), np.float32), w1, np.zeros(6, np.float32), w2,
            np.zeros(3, np.float32)]
    jgrads = jax.grad(lambda *a: jctr._mlp2(*a).sum(), argnums=(0, 1, 2, 3, 4))(
        *map(jnp.asarray, args))
    targs = [torch.tensor(a, requires_grad=True) for a in args]
    tctr._mlp2(*targs).sum().backward()
    for t, j in zip(targs, jgrads):
        _grad_close(t.grad.numpy(), j)
    np.testing.assert_allclose(targs[2].grad.numpy(), 0.5 * 4 * w2.sum(axis=1),
                               rtol=1e-6)


def test_top_mlp_tie_gradients_are_jax(jax_params, batch):
    """The top MLP's hidden ReLU at exact zeros (its first layer zeroed)."""
    dense, ids, _, _ = batch
    p = dict(jax_params)
    p["top_w1"] = np.zeros_like(p["top_w1"])
    rows = np.asarray(jctr.embed_fields({k: jnp.asarray(v) for k, v in p.items()},
                                        jnp.asarray(ids[:64])))
    names = ["top_w1", "top_b1", "top_w2", "top_b2", "bot_w1"]
    sub = {k: v for k, v in p.items() if k not in names}

    def jloss(params):
        return jctr.ctr_forward_from_embed({**sub, **params}, jnp.asarray(dense[:64]),
                                           jnp.asarray(rows)).sum()

    jg = jax.grad(jloss)({k: jnp.asarray(p[k]) for k in names})
    tp = {k: torch.tensor(p[k], requires_grad=k in names) for k in p}
    tctr.ctr_forward_from_embed(tp, torch.tensor(dense[:64]), torch.tensor(rows)).sum().backward()
    assert float(np.abs(np.asarray(jg["top_b1"])).max()) > 0
    for k in names:
        _grad_close(tp[k].grad.numpy(), jg[k])


@pytest.mark.parametrize("with_log_q", [False, True])
def test_weighted_softmax_value_and_grad(with_log_q):
    rng = np.random.default_rng(int(with_log_q))
    u = rng.standard_normal((64, 16)).astype(np.float32)
    v = rng.standard_normal((64, 16)).astype(np.float32)
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    w = (rng.random(64) < 0.3).astype(np.float32)
    lq = np.log(rng.random(64).astype(np.float32)) if with_log_q else None
    jl, jg = jax.value_and_grad(jctr.weighted_in_batch_softmax, argnums=(0, 1))(
        jnp.asarray(u), jnp.asarray(v), jnp.asarray(w),
        None if lq is None else jnp.asarray(lq), 0.1)
    tu, tv = (torch.tensor(a, requires_grad=True) for a in (u, v))
    tl = tctr.weighted_in_batch_softmax(tu, tv, torch.tensor(w),
                                        None if lq is None else torch.tensor(lq), 0.1)
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-6)
    _grad_close(tu.grad.numpy(), jg[0])
    _grad_close(tv.grad.numpy(), jg[1])
    # no click: the denominator's floor of 1 and a zero loss
    zero = tctr.weighted_in_batch_softmax(tu, tv, torch.zeros(64))
    assert float(zero.detach()) == 0.0


@pytest.mark.parametrize("joint", [False, True])
def test_loss_from_rows_matches_jax(data, jax_params, joint):
    """The trainer's sparse-mode loss (JAX's ``loss_from_rows``): value, and
    gradients for every dense param and the gathered rows."""
    cfg = dict(CTR_EMBED_DIM=8, CTR_RETRIEVAL_DIM=16, CTR_TOP_HIDDEN=(64, 32))
    jt = JaxTrainer(data, cfg=jax_settings.replace(**cfg), joint=joint)
    tt = CTRTrainer(data, cfg=settings.replace(**cfg), joint=joint, device="cpu")
    tt.start(tctr.from_jax_params(jax_params, "cpu"))
    log_q = jnp.asarray(jt._log_q())
    np.testing.assert_array_equal(tt._log_q(), np.asarray(log_q))
    bs = tt.batch_size()
    batches = tt.epoch_batches(np.random.default_rng(0), bs)
    batch = [b[0] for b in batches]
    dense, ids, labels, items = (b.numpy() for b in batch)
    jp = {k: jnp.asarray(v) for k, v in jax_params.items()}
    rows = np.asarray(jctr.embed_fields(jp, jnp.asarray(ids)))
    dense_p = {k: v for k, v in jp.items() if k != "embed"}
    nu = data.n_user_fields

    def loss_from_rows(dp, r):
        if not joint:
            return jctr.bce_loss(jctr.ctr_forward_from_embed(dp, jnp.asarray(dense), r),
                                 jnp.asarray(labels))
        ue = jctr.user_tower_ctr(dp, r[:, :nu])
        ie = jctr.item_tower_ctr(dp, r[:, nu:])
        logits = jctr.ctr_forward_from_embed(dp, jnp.asarray(dense), r,
                                             jnp.sum(ue * ie, axis=-1))
        ret = jctr.weighted_in_batch_softmax(ue, ie, jnp.asarray(labels),
                                             jnp.take(log_q, jnp.asarray(items)), 0.1)
        return jctr.bce_loss(logits, jnp.asarray(labels)) + 0.5 * ret

    jl, (jdg, jrg) = jax.value_and_grad(loss_from_rows, argnums=(0, 1))(
        dense_p, jnp.asarray(rows))
    tp = {k: torch.tensor(jax_params[k], requires_grad=True) for k in dense_p}
    tr = torch.tensor(rows, requires_grad=True)
    tl = tt._loss(tp, tr, batch, None)
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-6)
    _grad_close(tr.grad.numpy(), jrg)
    for k in dense_p:
        if k.startswith(("ut_", "it_")) and not joint:
            assert tp[k].grad is None and not np.asarray(jdg[k]).any()
            continue
        _grad_close(tp[k].grad.numpy(), jdg[k])


def test_save_load_both_ways(data, jax_params, tmp_path):
    jm = jctr.CTRModel(data.vocab_sizes, params={k: jnp.asarray(v) for k, v in
                                                 jax_params.items()}, **WIDTHS)
    jm.save(str(tmp_path / "jax_ctr"))               # '.npz' appended
    tm = tctr.CTRModel.load(str(tmp_path / "jax_ctr"), device="cpu")
    assert (tm.vocab_sizes, tm.embed_dim, tm.retrieval_dim, tm.top_hidden,
            tm.n_user_fields) == (jm.vocab_sizes, 8, 16, (64, 32), 8)
    tm.save(str(tmp_path / "port_ctr.npz"))
    back = jctr.CTRModel.load(str(tmp_path / "port_ctr.npz"))
    assert (json.loads((tmp_path / "port_ctr.npz.meta.json").read_text())
            == json.loads((tmp_path / "jax_ctr.npz.meta.json").read_text()))
    with np.load(tmp_path / "port_ctr.npz") as a, np.load(tmp_path / "jax_ctr.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
            assert a[k].dtype == np.float32
    want = jm.predict_proba(data.dense[:300], data.sparse[:300], joint=True)
    np.testing.assert_array_equal(back.predict_proba(data.dense[:300], data.sparse[:300],
                                                     joint=True), want)
    np.testing.assert_allclose(tm.predict_proba(data.dense[:300], data.sparse[:300],
                                                joint=True), want, rtol=0, atol=1e-6)
    with pytest.raises(FileNotFoundError):
        tctr.CTRModel.load(str(tmp_path / "missing"), device="cpu")


@pytest.mark.parametrize("bad", [-1, 97])      # C2's vocabulary is 97
def test_out_of_range_ids_raise_c50(data, jax_params, bad):
    """JAX's gather reads NaN for an id outside the table and its update
    drops it; the port refuses such ids where they enter."""
    sparse = data.sparse[:16].copy()
    sparse[5, 1] = bad
    tm = tctr.CTRModel(data.vocab_sizes, params=tctr.from_jax_params(jax_params, "cpu"),
                       device="cpu", **WIDTHS)
    with pytest.raises(ValueError, match="outside its vocabulary of 97"):
        tm.stack_ids(sparse)
    with pytest.raises(ValueError, match="vocabulary"):
        tm.predict_proba(data.dense[:16], sparse)
    bad_data = tdata.CTRDataset(**{**data.__dict__, "sparse": np.vstack([sparse, data.sparse[16:]])})
    with pytest.raises(ValueError, match="vocabulary"):
        CTRTrainer(bad_data, cfg=settings.replace(CTR_EMBED_DIM=8), device="cpu")
    jp = {k: jnp.asarray(v) for k, v in jax_params.items()}
    far = np.full((1, 26), sum(data.vocab_sizes) + 3, np.int32)
    assert np.isnan(np.asarray(jctr.embed_fields(jp, jnp.asarray(far)))).all()


def test_entry_points_default_to_the_card(data, tmp_path, monkeypatch):
    tctr.CTRModel(data.vocab_sizes, embed_dim=8, device="cpu").save(str(tmp_path / "m"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: tctr.CTRModel(data.vocab_sizes, embed_dim=8),
                 lambda: tctr.CTRModel.load(str(tmp_path / "m")),
                 lambda: CTRTrainer(data, cfg=settings.replace(CTR_EMBED_DIM=8)),
                 lambda: tctr.from_jax_params({"embed": np.zeros((3, 2))})):
        with pytest.raises(RuntimeError, match="needs an NVIDIA GPU"):
            call()


# ------------------------------------------------------------------ #
# Scripts                                                              #
# ------------------------------------------------------------------ #

TINY = ["--examples", "2500", "--users", "80", "--items", "60", "--epochs", "1"]


def _last_json(text: str):
    return json.loads(text.strip().splitlines()[-1])


def _jax_script(name, argv, capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", [name, *argv])
    runpy.run_path(str(ROOT / "scripts" / name), run_name="__main__")
    return capsys.readouterr().out


@pytest.mark.parametrize("joint", [True, False])
def test_ctr_train_prints_jax_keys(capsys, monkeypatch, joint, tmp_path):
    from recommendit_tpu_torch.scripts import ctr_train

    argv = TINY + ["--batch-size", "256"] + ([] if joint else ["--no-joint"])
    want = _last_json(_jax_script("ctr_train.py", argv, capsys, monkeypatch))
    assert ctr_train.main(argv + ["--device", "cpu", "--save",
                                  str(tmp_path / "ctr")]) == 0
    got = _last_json(capsys.readouterr().out)
    assert set(got) == set(want) and got["joint"] is joint
    assert got["ctr"] == want["ctr"] and got["examples_per_s"] > 0
    assert ("recall@50" in got) is joint
    back = tctr.CTRModel.load(str(tmp_path / "ctr"), device="cpu")
    assert back.vocab_sizes == tuple(tdata.make_ctr_dataset(
        n_examples=2500, n_users=80, n_items=60, seed=0).vocab_sizes)


def test_ctr_train_defaults_to_the_card(monkeypatch):
    from recommendit_tpu_torch.scripts import ctr_train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert ctr_train.parse_args([]).device == "cuda"
    with pytest.raises(RuntimeError, match="needs an NVIDIA GPU"):
        ctr_train.main(TINY)


def test_ctr_variance_writes_jax_rows(capsys, monkeypatch, tmp_path):
    from recommendit_tpu_torch.scripts import ctr_variance

    argv = ["--seeds", "1", *TINY]
    _jax_script("ctr_variance.py", argv + ["--out", str(tmp_path / "jax.json")],
                capsys, monkeypatch)
    assert ctr_variance.main(argv + ["--out", str(tmp_path / "port.json"),
                                     "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    want = json.loads((tmp_path / "jax.json").read_text())
    got = json.loads((tmp_path / "port.json").read_text())
    assert [set(r) for r in got["rows"]] == [set(r) for r in want["rows"]]
    assert [(r["seed"], r["joint"]) for r in got["rows"]] == [(0, False), (0, True)]
    assert {k: set(v) for k, v in got["agg"].items()} == {
        k: set(v) for k, v in want["agg"].items()}
    assert set(got["wins"]) == set(want["wins"])
    assert "joint vs plain (n=1 seeds)" in out
    assert [json.loads(line) for line in out.splitlines()[:2]] == got["rows"]
