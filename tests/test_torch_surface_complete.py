"""Nothing of the JAX package's public surface is missing from the port.

An AST walk of every module of ``recommendit_tpu/`` collects its public
module-level functions, classes and assignments and each public class's
methods (class-level aliases included); each must have a counterpart of the
same name in the port's module of the same path. The exceptions are the
explicit :data:`RENAMED` map (the port's names for JAX's Pallas / XLA
pairs, and one module split in two) and :data:`NOT_PORTED` (each with its
reason); ``logger`` is ignored.

Then the names this check found missing are held against JAX's on the same
numpy inputs: ``TwoTower.bpr_loss`` / ``in_batch_bpr_loss`` and their
gradients (f32: the loss within rtol 1e-6, gradients within atol 1e-7 —
sums in another order), ``MIPSIndex.search_device`` (ids equal after
``canonical_tie_order``, values within 1e-5; the fused bf16 index at
Q = 384 takes the window kernel's route, the JAX side the Pallas kernel in
interpret mode), ``FeatureEngineer(data_dir=…).load_data()`` and
``get_feature_columns()``, ``SeenSet.nnz`` / ``nbytes()``,
``RecommendationPipeline.faiss_index`` and ``opt_shardings_like`` (equal
shardings leaf by leaf).
"""
import ast
import importlib
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
JAX_PKG = ROOT / "recommendit_tpu"
GOLDEN = ROOT / "tests" / "fixtures" / "ml1m_golden"

# JAX module -> the port's modules that hold its names between them
MODULE_SPLITS = {"ops.pallas_mips": ("ops.mips_window", "ops.mips_fold")}
# (JAX module, JAX name) -> the port's name in the same module
RENAMED = {
    ("models.two_tower", "TwoTowerModel"): "TwoTower",
    ("ops.quantize", "quantize_int8_jnp"): "quantize_int8_hash_ref",
    ("ops.quantize", "quantize_int8_pallas"): "quantize_int8_hash",
    ("ops.bpr", "in_batch_bpr_loss_xla"): "in_batch_bpr_loss_ref",
    ("ops.bpr", "in_batch_bpr_pallas"): "InBatchBPR",
    # the port picks kernel or twin by the tensor's device, not the platform
    ("ops.bpr", "on_tpu"): "_device_type",
    ("ops.seen", "seen_mask_jnp"): "seen_mask",
    ("features.schema", "assemble_packed_jnp"): "assemble_packed",
}
# (JAX module, JAX name) -> why the port has no counterpart
NOT_PORTED = {
    ("data.movielens", "download_movielens"):
        "a download; neither machine may reach the network, the files are "
        "placed by hand",
    ("data.movielens", "MOVIELENS_1M_URL"): "the download's address",
}
IGNORED = {"logger"}


def _public(names):
    return {n for n in names if not n.startswith("_")} - IGNORED


def public_surface(path: Path):
    """(module-level public names, {class: its public methods and aliases})
    of one source file."""
    names, methods = set(), {}
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            names.add(node.name)
        elif isinstance(node, ast.ClassDef):
            names.add(node.name)
            members = set()
            for item in node.body:
                if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    members.add(item.name)
                elif isinstance(item, ast.Assign):
                    members.update(t.id for t in item.targets if isinstance(t, ast.Name))
            methods[node.name] = _public(members)
        elif isinstance(node, ast.Assign):
            for target in node.targets:
                elts = target.elts if isinstance(target, ast.Tuple) else [target]
                names.update(e.id for e in elts if isinstance(e, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.add(node.target.id)
    return _public(names), methods


def _module_key(path: Path) -> str:
    rel = path.relative_to(JAX_PKG).with_suffix("")
    parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
    return ".".join(parts)


JAX_MODULES = sorted(_module_key(p) for p in JAX_PKG.rglob("*.py"))


def _port_modules(key: str):
    return [importlib.import_module("recommendit_tpu_torch" + (f".{m}" if m else ""))
            for m in MODULE_SPLITS.get(key, (key,))]


def _jax_path(key: str) -> Path:
    base = JAX_PKG.joinpath(*key.split(".")) if key else JAX_PKG
    return base / "__init__.py" if base.is_dir() else base.with_suffix(".py")


@pytest.mark.parametrize("key", JAX_MODULES, ids=lambda k: k or "__init__")
def test_every_public_name_has_a_counterpart(key):
    names, methods = public_surface(_jax_path(key))
    ports = _port_modules(key)
    gaps = []
    for name in sorted(names):
        if (key, name) in NOT_PORTED:
            continue
        port_name = RENAMED.get((key, name), name)
        owner = next((m for m in ports if hasattr(m, port_name)), None)
        if owner is None:
            gaps.append(name)
            continue
        for method in sorted(methods.get(name, ())):
            if not hasattr(getattr(owner, port_name), method):
                gaps.append(f"{name}.{method}")
    assert not gaps, f"recommendit_tpu.{key}: no counterpart in the port for {gaps}"


def test_exception_lists_name_real_jax_names():
    """Each rename and exclusion still names a JAX name the port lacks, and
    each rename's target exists: the lists cannot hide a gap."""
    for (key, name), port_name in [*RENAMED.items(), *((k, None) for k in NOT_PORTED)]:
        names, _ = public_surface(_jax_path(key))
        assert name in names, (key, name)
        ports = _port_modules(key)
        assert not any(hasattr(m, name) for m in ports), (key, name)
        if port_name is not None:
            assert any(hasattr(m, port_name) for m in ports), (key, port_name)
    assert set(MODULE_SPLITS) <= set(JAX_MODULES)
    assert {n for _, n in NOT_PORTED} == {"download_movielens", "MOVIELENS_1M_URL"}


def test_the_walk_sees_methods_and_aliases():
    names, methods = public_surface(JAX_PKG / "models" / "retrieval.py")
    assert "MIPSIndex" in names
    assert {"search_device", "build_ivf_index", "n_total"} <= methods["MIPSIndex"]
    names, methods = public_surface(JAX_PKG / "features" / "store.py")
    assert {"RedisFeatureStore", "REDIS_AVAILABLE", "MSGPACK_AVAILABLE"} <= names
    assert "is_redis_available" in methods["FeatureStore"]


# --- the names added to close the gaps, against JAX's --------------------- #

def _unit_rows(rng, b, d):
    x = rng.normal(size=(b, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.mark.parametrize("b,d", [(64, 16), (37, 8)])
def test_two_tower_bpr_losses_match_jax(b, d):
    from recommendit_tpu.models.two_tower import TwoTowerModel
    from recommendit_tpu_torch.models.two_tower import TwoTower

    rng = np.random.default_rng(b + d)
    u, pos, neg = (_unit_rows(rng, b, d) for _ in range(3))
    cases = [("bpr_loss", (u, pos, neg)), ("in_batch_bpr_loss", (u, pos))]
    for name, arrays in cases:
        jfn = getattr(TwoTowerModel, name)
        jloss, jgrads = jax.value_and_grad(
            lambda *a: jfn(*a), argnums=tuple(range(len(arrays))))(
                *(jnp.asarray(a) for a in arrays))
        ts = [torch.tensor(a, requires_grad=True) for a in arrays]
        loss = getattr(TwoTower, name)(*ts)
        loss.backward()
        np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-6)
        for t, g in zip(ts, jgrads):
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=0, atol=1e-7)
    # the in-batch loss is the autograd function that launches kernels 5, 6
    ts = [torch.tensor(a, requires_grad=True) for a in (u, pos)]
    assert type(TwoTower.in_batch_bpr_loss(*ts).grad_fn).__name__ == "InBatchBPRBackward"


@pytest.mark.parametrize("mode,dtype,n_q", [("exact", "float32", 40),
                                            ("fused", "bfloat16", 384)])
def test_search_device_matches_jax(mode, dtype, n_q):
    from recommendit_tpu.models.retrieval import MIPSIndex as JaxIndex
    from recommendit_tpu.ops.topk import canonical_tie_order as jax_canonical
    from recommendit_tpu_torch.models.retrieval import MIPSIndex, _l2_normalize_np
    from recommendit_tpu_torch.ops.mips_window import fused_route
    from recommendit_tpu_torch.ops.topk import canonical_tie_order

    rng = np.random.default_rng(21)
    n, d, k = 3000, 16, 100
    embs = rng.normal(size=(n, d)).astype(np.float32)
    ids = np.arange(1, n + 1) * 3
    bias = (0.05 * rng.normal(size=n)).astype(np.float32)
    raw = rng.normal(size=(n_q, d)).astype(np.float32)
    queries = _l2_normalize_np(raw)     # as batch_search normalises them
    ji = JaxIndex(d, block_size=1024, mode=mode, dtype=dtype)
    ti = MIPSIndex(d, block_size=1024, mode=mode, dtype=dtype, device="cpu")
    for index in (ji, ti):
        index.build(embs, ids, bias=bias)
    if mode == "fused":
        assert fused_route(n_q, n, k)[0] == "kernel"
    jv, jid = jax_canonical(*ji.search_device(jnp.asarray(queries), k))
    tq = torch.as_tensor(queries)
    got = ti.search_device(tq, k)
    assert all(isinstance(t, torch.Tensor) and t.device == tq.device for t in got)
    tv, tid = canonical_tie_order(*got)
    np.testing.assert_array_equal(tid.numpy(), np.asarray(jid))
    np.testing.assert_allclose(tv.float().numpy(), np.asarray(jv), atol=1e-5, rtol=0)
    # batch_search is search_device on the normalised queries, copied out
    bv, bid = ti.batch_search(raw, k)
    np.testing.assert_array_equal(bid, got[1].numpy())
    np.testing.assert_array_equal(bv, got[0].numpy())


def test_feature_engineer_load_data_matches_jax():
    from recommendit_tpu.data.movielens import MovieLensData as JaxData
    from recommendit_tpu.features.engineering import FeatureEngineer as JaxFE
    from recommendit_tpu_torch.features.engineering import FeatureEngineer
    from tests.test_torch_features import _assert_data_equal

    jfe, tfe = JaxFE(data_dir=str(GOLDEN)), FeatureEngineer(data_dir=str(GOLDEN))
    assert (tfe.data_dir, tfe.seed) == (jfe.data_dir, jfe.seed) == (GOLDEN, 0)
    assert FeatureEngineer().data_dir == JaxFE().data_dir
    jfe.load_data()
    tfe.load_data()
    # the three tables JAX's load_data set, as one container
    _assert_data_equal(tfe.data, JaxData(jfe.ratings_df, jfe.users_df, jfe.movies_df))
    assert len(tfe.data) > 0
    assert FeatureEngineer.get_feature_columns() == JaxFE.get_feature_columns()


@pytest.mark.parametrize("n_pairs", [0, 1, 500])
def test_seen_set_size_matches_jax(n_pairs):
    from recommendit_tpu.ops.seen import SeenSet as JaxSeenSet
    from recommendit_tpu_torch.ops.seen import SeenSet

    rng = np.random.default_rng(n_pairs)
    u, i = rng.integers(1, 40, n_pairs), rng.integers(1, 90, n_pairs)
    got, want = SeenSet(u, i, 90), JaxSeenSet(u, i, 90)
    assert got.nnz == want.nnz == len(set(zip(u.tolist(), i.tolist())))
    assert got.nbytes() == want.nbytes()


def test_faiss_index_is_the_index():
    from recommendit_tpu.serving.recommender import RecommendationPipeline as JaxPipeline
    from recommendit_tpu_torch.models.retrieval import MIPSIndex
    from recommendit_tpu_torch.serving.recommender import RecommendationPipeline

    pipe, jpipe = RecommendationPipeline(device="cpu"), JaxPipeline()
    assert pipe.faiss_index is None and jpipe.faiss_index is None
    pipe.index = MIPSIndex(8, device="cpu")
    assert pipe.faiss_index is pipe.index


_PORT_SHARDINGS = """
import json, sys
import torch
from recommendit_tpu_torch.models.two_tower import init_params
from recommendit_tpu_torch.parallel import mesh as pm
pm.distributed_init("file://" + sys.argv[1], 1, 0, device="cpu")
mesh = pm.create_mesh((1, 1))
params = init_params(torch.Generator().manual_seed(0), 30, 20, 8, 16, device="cpu")
params = pm.shard_tree(params, pm.params_shardings(params, mesh))
state = pm.init_opt_sharded(pm.AdamW(1e-3, 1e-4, 1.0), params, mesh)
tree = state.shardings
nested = pm.opt_shardings_like(params, [state.state_dict(), (params, 3)], mesh)
axis = lambda s: s.axis
print(json.dumps({
    "mu": {k: axis(s) for k, s in tree["mu"].items()},
    "nu": {k: axis(s) for k, s in tree["nu"].items()},
    "count": axis(tree["count"]),
    "sharded": dict(zip(state.names, state.sharded)),
    "same_mesh": all(s.mesh is mesh for s in [*tree["mu"].values(), tree["count"]]),
    "nested": [nested[0] == tree, {k: axis(s) for k, s in nested[1][0].items()},
               axis(nested[1][1])],
}))
"""


def test_opt_shardings_like_matches_jax(tmp_path):
    """One process: the port's tree (gloo, a (1, 1) mesh) against JAX's
    ``opt_shardings_like`` for ``optax.adamw`` over the same two-tower
    params on a one-device mesh: mu and nu take each param's sharding, the
    step count is replicated."""
    import optax
    from recommendit_tpu.models.two_tower import init_params as jax_init
    from recommendit_tpu.parallel import mesh as jm

    proc = subprocess.run([sys.executable, "-c", _PORT_SHARDINGS, str(tmp_path / "store")],
                          cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    port = json.loads(proc.stdout.strip().splitlines()[-1])

    mesh = jm.create_mesh((1, 1), devices=jax.devices()[:1])
    params = jax_init(jax.random.PRNGKey(0), 30, 20, 8, 16)
    params = jax.device_put(params, jm.params_shardings(params, mesh))
    tx = optax.adamw(1e-3, weight_decay=1e-4)
    tree = jm.opt_shardings_like(params, jax.eval_shape(tx.init, params), mesh)
    adam = next(s for s in jax.tree_util.tree_leaves(
        tree, is_leaf=lambda x: hasattr(x, "mu")) if hasattr(s, "mu"))

    def axis(sharding):
        spec = tuple(sharding.spec)
        return spec[0] if spec else None

    assert set(port["mu"]) == set(params)
    for key in params:
        assert port["mu"][key] == port["nu"][key] == axis(adam.mu[key]) == axis(adam.nu[key])
        assert port["sharded"][key] == (axis(adam.mu[key]) is not None)
    assert port["mu"]["user_embed"] == "model" and port["mu"]["user_w1"] is None
    assert port["count"] is None and axis(adam.count) is None
    assert port["same_mesh"]
    assert port["nested"] == [True, port["mu"], None]
