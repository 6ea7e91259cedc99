"""The port's multi-device layer (``recommendit_tpu_torch/parallel/``)
against the JAX package's, on the CPU.

The JAX side runs here, on ``conftest.py``'s virtual 8-device mesh at
``create_mesh(shape=(2, 4))`` (as ``tests/test_parallel.py``) and on one
device. The port side runs 4 gloo ranks, spawned once per mesh shape
(4, 1), (1, 4) and (2, 2) by a module-scoped fixture; the rank bodies are
the port's own (``parallel/parity.py``: no jax in the children) and return
numpy. Inputs come from numpy seeds, and weights cross over from JAX's
initialisers as numpy arrays. Cases mirror ``tests/test_parallel.py``:

* lookups (masked all-reduce, ring, dual) bit-equal to a dense take, and
  the table's gradient equal to the dense one (ROADMAP C.54: the
  all-reduce's backward passes the cotangent through);
* both merges' ids equal to JAX's and to single-device ``mips_topk``
  after ``canonical_tie_order``, with ties across shards and k larger than
  a shard;
* the two-tower step: the first step's gradients equal to the dense
  single-device gradient (C.54, C.55: the global in-batch loss), the first
  loss within 1e-5 of JAX's and the params after 3 steps within f32
  rounding of JAX's sharded step, under ``optax.adam`` and under
  ``clip_by_global_norm`` + ``adamw`` with clipping active (C.56: the norm
  over shards); the optimizer state of the shard's shape;
* the serve ids equal to JAX's; the CTR losses (plain and joint) within
  1e-5 of JAX's for 3 steps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from recommendit_tpu.models.ctr import field_offsets, init_ctr_params
from recommendit_tpu.models.ranker import init_mlp, mlp_score
from recommendit_tpu.models.two_tower import init_params, item_tower, user_tower
from recommendit_tpu.ops.bpr import in_batch_bpr_loss_xla
from recommendit_tpu.ops.topk import mips_topk_numpy
from recommendit_tpu.parallel import (
    bucketed_embedding_lookup as jax_bucketed,
    create_mesh as jax_create_mesh,
    init_sharded_state as jax_init_state,
    make_sharded_train_step as jax_make_step,
    sharded_embedding_lookup as jax_lookup,
    sharded_mips_topk as jax_merge,
    sharded_mips_topk_ring as jax_ring,
)
from recommendit_tpu.parallel.ctr import (
    init_ctr_sharded_state as jax_init_ctr,
    make_ctr_sharded_train_step as jax_make_ctr_step,
)
from recommendit_tpu.parallel.mesh import (
    _factor_2d as jax_factor_2d,
    pad_to_multiple as jax_pad,
    row_sharded as jax_row_sharded,
)
from recommendit_tpu.parallel.serve import make_sharded_serve_fn as jax_serve_fn
from recommendit_tpu_torch.ops.topk import canonical_tie_order, mips_topk
from recommendit_tpu_torch.parallel import mesh as port_mesh
from recommendit_tpu_torch.parallel.embedding import local_rows
from recommendit_tpu_torch.parallel.launch import spawn
from recommendit_tpu_torch.parallel.parity import run_cases

SHAPES = [(4, 1), (1, 4), (2, 2)]
N_RANKS = 4
SPAWN_TIMEOUT_S = 240
TRAIN_LR, WEIGHT_DECAY, CLIP_NORM = 1e-2, 1e-4, 0.01
LOSS_TOL = 1e-5            # tests/test_parallel.py:139
# params after 3 AdamW steps: f32 sums in other orders. The Adam update
# divides by the root of the squared gradient, so an entry whose gradient
# is a near-cancelling sum moves by more than its own rounding (largest
# seen 1.04e-6, an item-table entry under clipping to 0.01)
PARAM_TOL = 1e-5
GRAD_TOL = 1e-6
CTR_STEPS, CTR_LR = 3, 1e-3
CTR_VOCAB = [8, 4, 4, 8, 4, 4, 8, 4] + [8, 4] * 9       # 26 fields, 156 rows


def _f32(x):
    return np.asarray(x, np.float32)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    n_users = n_items = 64
    d, h, b = 16, 32, 32
    train_params = {k: np.asarray(v) for k, v in init_params(
        jax.random.PRNGKey(0), n_users - 1, n_items - 1, d, h).items()}
    # ties: 64 rows each 8 times, shuffled over the shards
    tie_items = np.repeat(rng.normal(size=(64, 16)).astype(np.float32), 8, axis=0)
    tie_items = tie_items[rng.permutation(512)]
    serve_users, serve_items = 64, 128
    ctr_params = init_ctr_params(jax.random.PRNGKey(1), CTR_VOCAB, embed_dim=8,
                                 bottom_hidden=16, top_hidden=(32,),
                                 retrieval_dim=8, pad_rows_to=N_RANKS)
    offs = field_offsets(CTR_VOCAB)
    ctr_batches = []
    for _ in range(CTR_STEPS):
        raw = np.stack([rng.integers(0, v, size=16) for v in CTR_VOCAB], axis=1)
        ctr_batches.append((
            rng.normal(size=(16, 13)).astype(np.float32),
            (raw + offs[None, :]).astype(np.int64),
            (rng.random(16) < 0.4).astype(np.float32),
            (rng.normal(size=16) - 3.0).astype(np.float32)))
    return {
        "lookup": {"table": _f32(rng.normal(size=(64, 16))),
                   "ids": rng.integers(0, 64, size=32)},
        "dual": {"user_table": _f32(rng.normal(size=(64, 8))),
                 "item_table": _f32(rng.normal(size=(32, 8))),
                 "user_ids": rng.integers(0, 64, size=16),
                 "item_ids": rng.integers(0, 32, size=16)},
        "lookup_grad": {"table": _f32(rng.normal(size=(32, 8))),
                        "ids": rng.integers(0, 32, size=16),
                        "cot": _f32(rng.normal(size=(16, 8)))},
        "retrieval": {"q": _f32(rng.normal(size=(8, 16))),
                      "items": _f32(rng.normal(size=(512, 16))), "k": 20,
                      "canonical": False},
        "ties": {"q": _f32(rng.normal(size=(8, 16))), "items": tie_items,
                 "k": 24, "canonical": True},
        # 16 rows a shard at model 4, 32 at model 2: k = 40 exceeds both
        "k_big": {"q": _f32(rng.normal(size=(4, 8))),
                  "items": _f32(rng.normal(size=(64, 8))), "k": 40,
                  "canonical": False},
        "train": {"params": train_params,
                  "genre": (rng.random((n_items, 18)) < 0.2).astype(np.float32),
                  "u": rng.integers(1, n_users, size=b),
                  "i": rng.integers(1, n_items, size=b), "steps": 3,
                  "lr": TRAIN_LR, "weight_decay": WEIGHT_DECAY,
                  "clip_norm": CLIP_NORM},
        "serve": {"params": {k: np.asarray(v) for k, v in init_params(
                      jax.random.PRNGKey(0), serve_users - 1, serve_items - 1,
                      16, 32).items()},
                  "corpus": _f32(rng.normal(size=(serve_items, 16))),
                  "item_ids": np.arange(1, serve_items + 1),
                  "user_packed": _f32(rng.normal(size=(serve_users, 24))),
                  "item_packed": _f32(rng.normal(size=(serve_items + 1, 23))),
                  "ranker": {k: np.asarray(v) for k, v in init_mlp(
                      jax.random.PRNGKey(1), 50, (16,)).items()},
                  "user_ids": rng.integers(1, serve_users, size=16),
                  "n_candidates": 32, "k_out": 8},
        "ctr": {"params": {k: np.asarray(v) for k, v in ctr_params.items()},
                "batches": ctr_batches, "n_user_fields": 8, "lr": CTR_LR},
    }


@pytest.fixture(scope="module")
def jax_mesh():
    assert jax.device_count() == 8, "tests expect the virtual 8-device mesh"
    return jax_create_mesh(shape=(2, 4))


def _jax_train(mesh, c, tx):
    params = {k: jnp.asarray(v) for k, v in c["params"].items()}
    step = jax_make_step(mesh, tx, jnp.asarray(c["genre"]), dropout_rate=0.0)
    sp, so = jax_init_state(mesh, tx, params)
    batch = (jnp.asarray(c["u"], jnp.int32), jnp.asarray(c["i"], jnp.int32))
    losses = []
    for s in range(c["steps"]):
        sp, so, loss = step(sp, so, batch, jax.random.PRNGKey(s))
        losses.append(float(loss))
    return {"losses": losses, "params": {k: np.asarray(v) for k, v in sp.items()}}


def _jax_ctr(mesh, c, joint):
    tx = optax.adam(c["lr"])
    params = {k: jnp.asarray(v) for k, v in c["params"].items()}
    step = jax_make_ctr_step(mesh, tx, n_user_fields=c["n_user_fields"], joint=joint)
    cp, co = jax_init_ctr(mesh, tx, params)
    losses = []
    for batch in c["batches"]:
        dense, ids, labels, log_q = batch
        cp, co, loss = step(cp, co, (jnp.asarray(dense), jnp.asarray(ids, jnp.int32),
                                     jnp.asarray(labels), jnp.asarray(log_q)))
        losses.append(float(loss))
    return {"losses": losses, "embed": np.asarray(cp["embed"])}


@pytest.fixture(scope="module")
def jax_ref(inputs, jax_mesh):
    """The JAX package's sharded functions on the (2, 4) mesh, and the
    single-device references, on the same inputs."""
    mesh = jax_mesh
    out = {}
    c = inputs["lookup"]
    t = jax.device_put(jnp.asarray(c["table"]), jax_row_sharded(mesh))
    out["lookup"] = np.asarray(jax_lookup(t, jnp.asarray(c["ids"]), mesh))
    out["ring_replicated"] = np.asarray(
        jax_bucketed(t, jnp.asarray(c["ids"]), mesh, replicate_out=True))
    for case in ("retrieval", "ties", "k_big"):
        c = inputs[case]
        items = jax.device_put(jnp.asarray(c["items"]), jax_row_sharded(mesh))
        for name, fn in (("allgather", jax_merge), ("ring", jax_ring)):
            v, i = fn(jnp.asarray(c["q"]), items, c["k"], mesh, block_size=16,
                      canonical=c["canonical"])
            out[f"{case}_{name}"] = (np.asarray(v), np.asarray(i))
    c = inputs["train"]
    params = {k: jnp.asarray(v) for k, v in c["params"].items()}
    genre = jnp.asarray(c["genre"])
    u, i = jnp.asarray(c["u"]), jnp.asarray(c["i"])

    def ref_loss(p):
        return in_batch_bpr_loss_xla(user_tower(p, u),
                                     item_tower(p, i, jnp.take(genre, i, axis=0)))

    loss, grads = jax.value_and_grad(ref_loss)(params)
    out["ref_loss"] = float(loss)
    out["ref_grads"] = {k: np.asarray(g) for k, g in grads.items()}
    out["adam"] = _jax_train(mesh, c, optax.adam(TRAIN_LR))
    out["clip_adamw"] = _jax_train(mesh, c, optax.chain(
        optax.clip_by_global_norm(CLIP_NORM),
        optax.adamw(TRAIN_LR, weight_decay=WEIGHT_DECAY)))
    out["ref_grad_norm"] = float(optax.global_norm(grads))
    c = inputs["serve"]
    rparams = {k: jnp.asarray(v) for k, v in c["ranker"].items()}
    serve = jax_serve_fn(
        mesh, {k: jnp.asarray(v) for k, v in c["params"].items()},
        jax.device_put(jnp.asarray(c["corpus"]), jax_row_sharded(mesh)),
        jnp.asarray(c["item_ids"], jnp.int32), jnp.asarray(c["user_packed"]),
        jnp.asarray(c["item_packed"]), lambda f: mlp_score(rparams, f),
        n_candidates=c["n_candidates"], k_out=c["k_out"], block_size=32)
    out["serve"] = tuple(np.asarray(x) for x in
                         serve(jnp.asarray(c["user_ids"], jnp.int32)))
    for joint in (False, True):
        out["joint" if joint else "plain"] = _jax_ctr(mesh, inputs["ctr"], joint)
    return out


@pytest.fixture(scope="module", params=SHAPES, ids=lambda s: f"mesh{s[0]}x{s[1]}")
def ranks(request, inputs):
    """The 4 ranks' results at one mesh shape."""
    return spawn(run_cases, N_RANKS, (request.param, inputs), device="cpu",
                 timeout=SPAWN_TIMEOUT_S)


def _canonical(v, i):
    cv, ci = canonical_tie_order(torch.from_numpy(np.array(v)),
                                 torch.from_numpy(np.array(i)).long())
    return cv.numpy(), ci.numpy()


# ------------------------------------------------------------------ #
# Mesh helpers (no ranks)                                              #
# ------------------------------------------------------------------ #

def test_factor_2d_is_jax():
    for n in range(1, 17):
        for prefer in range(0, 9):
            assert port_mesh._factor_2d(n, prefer) == jax_factor_2d(n, prefer)


def test_pad_to_multiple_is_jax():
    table = np.arange(30 * 4, dtype=np.float32).reshape(30, 4)
    for m in (1, 4, 7):
        np.testing.assert_array_equal(port_mesh.pad_to_multiple(table, m),
                                      jax_pad(table, m))
    assert port_mesh.pad_to_multiple(table, 4).shape == (32, 4)


def test_local_rows_raises_on_indivisible_tables():
    assert local_rows(64, 4) == 16
    with pytest.raises(ValueError, match="divide"):
        local_rows(30, 4)


def test_cuda_request_without_card_raises():
    """A CUDA request needs a card a rank: without one everything raises,
    and nothing falls back to gloo or to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    from recommendit_tpu_torch.parallel.dryrun import dryrun_multichip

    with pytest.raises(RuntimeError, match="GPU"):
        port_mesh.distributed_init("file:///nonexistent", 1, 0, device="cuda")
    with pytest.raises(RuntimeError):
        spawn(run_cases, 2, ((1, 2), {}), device="cuda")
    with pytest.raises(RuntimeError):
        dryrun_multichip(2, device="cuda")


# ------------------------------------------------------------------ #
# Lookups                                                              #
# ------------------------------------------------------------------ #

def test_lookup_bit_equal_to_dense_take(ranks, inputs, jax_ref):
    c = inputs["lookup"]
    want = c["table"][c["ids"]]
    for r in ranks:
        np.testing.assert_array_equal(r["lookup"], want)
        np.testing.assert_array_equal(r["ring_replicated"], want)
    np.testing.assert_array_equal(ranks[0]["lookup"], jax_ref["lookup"])
    np.testing.assert_array_equal(ranks[0]["ring_replicated"],
                                  jax_ref["ring_replicated"])


def test_ring_packet_is_own_slice(ranks, inputs):
    c = inputs["lookup"]
    want = c["table"][c["ids"]]
    for r in ranks:
        m = r["coordinate"][1]
        n = len(want) // r["ring_packet"].shape[0]
        b = len(want) // n
        np.testing.assert_array_equal(r["ring_packet"], want[m * b:(m + 1) * b])


def test_dual_lookup_bit_equal(ranks, inputs):
    c = inputs["dual"]
    for r in ranks:
        ue, ie = r["dual"]
        np.testing.assert_array_equal(ue, c["user_table"][c["user_ids"]])
        np.testing.assert_array_equal(ie, c["item_table"][c["item_ids"]])


@pytest.mark.parametrize("lookup", ["masked", "ring"])
def test_lookup_gradient_equals_dense(ranks, inputs, lookup):
    c = inputs["lookup_grad"]
    table = jnp.asarray(c["table"])
    ids, cot = jnp.asarray(c["ids"]), jnp.asarray(c["cot"])
    want = np.asarray(jax.grad(lambda t: (jnp.take(t, ids, axis=0) * cot).sum())(table))
    for r in ranks:
        np.testing.assert_allclose(r[f"grad_{lookup}"], want, rtol=0, atol=1e-6)


def test_indivisible_batches_and_rows_raise(ranks):
    n_model = max(r["coordinate"][1] for r in ranks) + 1
    for r in ranks:
        # 31 ids / 31 rows divide a model axis of 1 only
        assert r["ring_indivisible_raises"] == (n_model > 1)
        assert r["rows_indivisible_raises"] == (n_model > 1)


# ------------------------------------------------------------------ #
# Retrieval                                                            #
# ------------------------------------------------------------------ #

def _assert_same_ids(got, want, scores, tol):
    """``got`` and ``want`` (Q, k) ids equal, except where the two ids'
    scores (``scores``, f64) are tied within ``tol``: another f32 rounding
    of a near tie may order it the other way."""
    rows, cols = np.nonzero(got != want)
    gap = np.abs(scores[rows, got[rows, cols]] - scores[rows, want[rows, cols]])
    assert (gap <= tol).all(), (rows, cols, gap)


@pytest.mark.parametrize("merge", ["allgather", "ring"])
@pytest.mark.parametrize("case", ["retrieval", "ties", "k_big"])
def test_merge_ids_match_jax_and_single_device(ranks, inputs, jax_ref, case, merge):
    """Exactly the port's single-device ``mips_topk`` (the same f32 scores);
    JAX's and the f64 numpy reference's up to near ties within f32
    rounding of a 16-term dot (2⁻²² of the largest score)."""
    c = inputs[case]
    single_v, single_i = _canonical(*mips_topk(
        torch.as_tensor(c["q"]), torch.as_tensor(c["items"]), c["k"]))
    _, numpy_i = mips_topk_numpy(c["q"], c["items"], c["k"])
    jax_v, jax_i = _canonical(*jax_ref[f"{case}_{merge}"])
    scores = c["q"].astype(np.float64) @ c["items"].astype(np.float64).T
    tol = 2.0 ** -22 * np.abs(scores).max()
    for r in ranks:
        v, i = _canonical(*r[f"{case}_{merge}"])
        np.testing.assert_array_equal(i, single_i)
        np.testing.assert_array_equal(v, single_v)
        _assert_same_ids(i, jax_i, scores, tol)
        _assert_same_ids(i, numpy_i, scores, tol)
        np.testing.assert_allclose(v, jax_v, rtol=0, atol=tol)


# ------------------------------------------------------------------ #
# The two-tower step                                                   #
# ------------------------------------------------------------------ #

def test_first_step_gradients_equal_dense(ranks, jax_ref):
    """The gradient summed over data equals the single-device dense one:
    the all-reduce's and the gather's backwards each pass the cotangent
    once (a sum over the group would scale it by the group's size)."""
    for r in ranks:
        for k, want in jax_ref["ref_grads"].items():
            np.testing.assert_allclose(r["grads"][k], want, rtol=0, atol=GRAD_TOL,
                                       err_msg=k)


def test_clipping_uses_the_global_norm_over_shards(ranks, jax_ref):
    """``clip_by_global_norm`` over row shards: each replicated gradient
    counted once, the shards' squares summed over ``model``. (Adam's update
    is nearly blind to a uniform rescale, so the steps alone would not
    show a wrong norm.)"""
    want, _ = optax.clip_by_global_norm(CLIP_NORM).update(
        {k: jnp.asarray(v) for k, v in jax_ref["ref_grads"].items()}, None)
    assert jax_ref["ref_grad_norm"] > 10 * CLIP_NORM
    for r in ranks:
        for k, g in want.items():
            np.testing.assert_allclose(r["clipped_grads"][k], np.asarray(g),
                                       rtol=0, atol=GRAD_TOL * CLIP_NORM, err_msg=k)


@pytest.mark.parametrize("tx", ["adam", "clip_adamw"])
def test_first_loss_matches_jax(ranks, jax_ref, tx):
    for r in ranks:
        assert r[tx]["losses"][0] == pytest.approx(jax_ref["ref_loss"], abs=LOSS_TOL)
        assert r[tx]["losses"][0] == pytest.approx(jax_ref[tx]["losses"][0],
                                                   abs=LOSS_TOL)


@pytest.mark.parametrize("tx", ["adam", "clip_adamw"])
def test_params_after_three_steps_match_jax(ranks, jax_ref, tx):
    if tx == "clip_adamw":   # the clip must be active for the check to bite
        assert jax_ref["ref_grad_norm"] > 10 * CLIP_NORM
    want = jax_ref[tx]
    for r in ranks:
        np.testing.assert_allclose(r[tx]["losses"], want["losses"], rtol=0,
                                   atol=LOSS_TOL)
        for k, p in want["params"].items():
            np.testing.assert_allclose(r[tx]["params"][k], p, rtol=0,
                                       atol=PARAM_TOL, err_msg=k)
    assert want["losses"][-1] < want["losses"][0]


def test_optimizer_state_has_the_shard_shape(ranks, inputs):
    n_model = max(r["coordinate"][1] for r in ranks) + 1
    for r in ranks:
        for tx in ("adam", "clip_adamw"):
            assert r[tx]["mu_shapes"] == r[tx]["local_shapes"]
            for k, v in inputs["train"]["params"].items():
                rows = v.shape[0] // n_model if k.endswith("_embed") else v.shape[0]
                assert r[tx]["local_shapes"][k] == (rows,) + v.shape[1:]


def test_batch_below_two_raises(ranks):
    assert all(r["b1_raises"] for r in ranks)


def test_ranks_agree(ranks):
    for r in ranks[1:]:
        for tx in ("adam", "clip_adamw"):
            assert r[tx]["losses"] == ranks[0][tx]["losses"]
        for mode in ("plain", "joint"):
            assert r[mode]["losses"] == ranks[0][mode]["losses"]
        for a, b in zip(r["serve"], ranks[0]["serve"]):
            np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------------ #
# Serve and CTR                                                        #
# ------------------------------------------------------------------ #

def test_serve_matches_jax(ranks, jax_ref):
    want_ids, want_scores, want_rvals = jax_ref["serve"]
    ids, scores, rvals = ranks[0]["serve"]
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_allclose(scores, want_scores, rtol=0, atol=1e-5)
    np.testing.assert_allclose(rvals, want_rvals, rtol=0, atol=1e-5)


@pytest.mark.parametrize("mode", ["plain", "joint"])
def test_ctr_steps_match_jax(ranks, jax_ref, mode):
    want = jax_ref[mode]
    for r in ranks:
        np.testing.assert_allclose(r[mode]["losses"], want["losses"], rtol=0,
                                   atol=LOSS_TOL)
        np.testing.assert_allclose(r[mode]["embed"], want["embed"], rtol=0,
                                   atol=PARAM_TOL)
