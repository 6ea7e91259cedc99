"""The quality scripts of the port (``recommendit_tpu_torch/scripts/
quality_at_scale.py`` and ``ranker_ab.py``) against the JAX package's
(``scripts/quality_at_scale.py``) on the CPU.

One tiny run (300 users x 200 items x 6,000 ratings, 1 epoch, 50
evaluation users) goes through both ``quality_at_scale`` scripts, each in
its own work-dir, with ``RANKER_QUERY_NORM=false`` through the scripts'
own ``--cfg`` (C.8: with the query norm JAX's serve path turns constant
columns into rounding noise, so only without it do the two packages rank
one ranker's candidates alike). Then:

* the generated ``.dat`` files are bit-equal, the report keys are equal,
  and the popularity row (no training) is equal;
* JAX's ``features`` stage on the port's data and JAX's ``evaluate`` stage
  over the port's models directory give the port's ladder within 1e-6;
* the port's sharded block ran on 4 gloo ranks and matched the single
  device (JAX's script runs its block on one device: on the virtual
  mesh its own assertion fails at this size, C.59);
* C.60: on 4 gloo ranks the sharded check's reference, which scores the
  corpus in shard-shaped blocks, equals both merges bit for bit, at a
  shape where one product over the whole corpus may round otherwise; the
  reference's products are the shard products a rank's ``mips_topk``
  takes (a spy on ``score_matrix``);
* ``ranker_ab`` over the port's work-dir at two β values writes the
  variant's ranker at its own path and appends one line to ``--log``, and
  JAX's ``evaluate`` on that ranker equals the port's rows within 1e-6.
"""
import json
import runpy
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from recommendit_tpu.config import Settings as JaxSettings
from recommendit_tpu_torch.ops import topk
from recommendit_tpu_torch.parallel.launch import spawn
from recommendit_tpu_torch.scripts import quality_at_scale, ranker_ab

ROOT = Path(__file__).resolve().parents[1]
ARGS = ["--users", "300", "--items", "200", "--ratings", "6000", "--epochs", "1",
        "--eval-users", "50", "--cfg", "RANKER_QUERY_NORM=false"]
EVAL_USERS = 50
TOL = 1e-6
LADDER_OF = {"popularity_ndcg@10": "popularity_ndcg@10",
             "retrieval_only_ndcg@10": "retrieval_only_ndcg@10",
             "full_ndcg@10": "ndcg@10",
             "popularity_recall@20": "popularity_recall@20",
             "retrieval_only_recall@20": "retrieval_only_recall@20",
             "full_recall@20": "recall@20", "mrr": "mrr"}
AB_ROWS = {"full_ndcg@10": "ndcg@10", "full_recall@20": "recall@20",
           "full_mrr": "mrr", "retrieval_only_ndcg@10": "retrieval_only_ndcg@10",
           "retrieval_only_recall@20": "retrieval_only_recall@20",
           "retrieval_only_mrr": "retrieval_only_mrr",
           "paired_diff": "paired_ndcg10_full_minus_retrieval",
           "paired_t": "paired_ndcg10_t"}


def _jax_evaluate(work: Path, features_dir: Path, **cfg):
    """JAX's ``features`` stage on ``work``'s data (once) and its
    ``evaluate`` over ``work``'s models directory."""
    import recommendit_tpu.pipelines.run_pipeline as jrp

    orch = jrp.PipelineOrchestrator(
        cfg=JaxSettings(SEED=0, RANKER_QUERY_NORM=False, **cfg),
        data_dir=str(work / "ml"), models_dir=str(work / "models"),
        features_dir=str(features_dir), synthetic=False, eval_users=EVAL_USERS,
        respect_cfg_paths=bool(cfg))
    if not (features_dir / "user_features.parquet").exists():
        orch.run_stage("features")
    return orch.run_stage("evaluate")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("qscale")
    port_dir, jax_dir = tmp / "port", tmp / "jax"
    report = quality_at_scale.run(quality_at_scale.parse_args(
        ARGS + ["--work-dir", str(port_dir), "--device", "cpu", "--nproc", "4"]))
    with pytest.MonkeyPatch.context() as mp:
        # JAX's script on one device of the virtual mesh: on 4 or 8 its own
        # identity assertion fails at this size (its CPU f32 products differ
        # in the last bits with the shard's shape; ROADMAP C.59)
        devices = jax.devices
        mp.setattr(jax, "devices", lambda *a, **k: devices(*a, **k)[:1])
        mp.setattr(sys, "argv", ["quality_at_scale.py", *ARGS, "--work-dir",
                                 str(jax_dir), "--out", str(jax_dir / "report.json")])
        runpy.run_path(str(ROOT / "scripts" / "quality_at_scale.py"),
                       run_name="__main__")
    jax_report = json.loads((jax_dir / "report.json").read_text())
    jax_eval = _jax_evaluate(port_dir, tmp / "jax_features")
    return dict(report=report, jax_report=jax_report, jax_eval=jax_eval,
                port_dir=port_dir, jax_dir=jax_dir, tmp=tmp)


@pytest.mark.parametrize("name", ["ratings.dat", "users.dat", "movies.dat", "README"])
def test_generated_files_are_bit_equal(runs, name):
    port = (runs["port_dir"] / "ml" / name).read_bytes()
    assert port == (runs["jax_dir"] / "ml" / name).read_bytes()
    assert len(port) > 0


def test_report_keys_and_popularity_row_equal(runs):
    got, want = runs["report"], runs["jax_report"]
    assert list(got) == list(want)
    for block in ("config", "ladder", "sharded_retrieval"):
        assert list(got[block]) == list(want[block]), block
    assert list(got["stage_seconds"]) == list(want["stage_seconds"])
    for key in ("popularity_ndcg@10", "popularity_recall@20"):
        assert got["ladder"][key] == want["ladder"][key]
    assert json.loads((runs["port_dir"] / "report.json").read_text()) == \
        json.loads(json.dumps(got, default=float))


def test_jax_evaluate_reproduces_the_ladder(runs):
    ladder, rep = runs["report"]["ladder"], runs["jax_eval"]
    for key, jax_key in LADDER_OF.items():
        np.testing.assert_allclose(ladder[key], rep[jax_key], rtol=0, atol=TOL,
                                   err_msg=key)
    assert all(np.isfinite(v) for v in ladder.values())


def test_sharded_block_on_four_gloo_ranks(runs):
    sr = runs["report"]["sharded_retrieval"]
    assert sr["n_devices"] == 4 and sr["platform"] == "cpu"
    assert sr["corpus"] % 4 == 0 and sr["k"] == min(500, 200 // 2)
    for name in ("allgather", "ring"):
        assert sr[name]["identical_to_single_device"]
        assert sr[name]["batch_ms"] > 0


@pytest.fixture(scope="module")
def ab_run(runs):
    work = runs["port_dir"]
    log = runs["tmp"] / "ab.jsonl"
    args = ranker_ab.parse_args(["--name", "small", "--work-dir", str(work),
                                 "--eval-users", str(EVAL_USERS), "--betas", "1,2",
                                 "--cfg", "RANKER_QUERY_NORM=false",
                                 "--cfg", "RANKER_EPOCHS=2",
                                 "--log", str(log), "--device", "cpu"])
    result = ranker_ab.run(args)
    path = work / "models" / "ranker_small.npz"
    jax_rows = [_jax_evaluate(work, runs["tmp"] / "jax_features",
                              RANKER_EPOCHS=2, RANKER_BLEND_RETRIEVAL=b,
                              RANKER_MODEL_PATH=str(path))
                for b in (1.0, 2.0)]
    return dict(result=result, log=log, path=path, jax_rows=jax_rows)


def test_ranker_ab_writes_its_ranker_and_one_log_line(ab_run):
    assert ab_run["path"].exists()
    assert Path(str(ab_run["path"]) + ".meta.json").exists()
    lines = ab_run["log"].read_text().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line == json.loads(json.dumps(ab_run["result"], default=float))
    assert list(line) == ["name", "seed", "cfg", "ranker_train_s", "inner_holdout",
                          "serving", "eval_users"]
    assert [r["beta"] for r in line["serving"]] == [1.0, 2.0]
    # the port reports the ranker stage's holdout dict (JAX's is always {})
    assert line["inner_holdout"]["n_queries"] > 0


def test_jax_evaluate_on_the_variant_equals_the_rows(ab_run):
    for row, rep in zip(ab_run["result"]["serving"], ab_run["jax_rows"]):
        for key, jax_key in AB_ROWS.items():
            np.testing.assert_allclose(row[key], rep[jax_key], rtol=0, atol=TOL,
                                       err_msg=f"beta {row['beta']} {key}")


def _c60_inputs(n=200, d=65, n_q=256, seed=0):
    """A corpus where, on an f32 CPU GEMM, the whole-corpus product may
    round otherwise than the four 50-row shard products (C.60)."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n_q, d)).astype(np.float32),
            rng.normal(size=(n, d)).astype(np.float32))


def test_c60_reference_equals_both_merges_bit_for_bit():
    q, embs = _c60_inputs()
    k = 100
    ranks = spawn(quality_at_scale.sharded_rank, 4, (q, embs, k), device="cpu",
                  timeout=240)
    rv, ri = quality_at_scale._canon(*ranks[0]["reference"])
    for name in ("allgather", "ring"):
        for r in ranks:
            v, i = quality_at_scale._canon(*r[name][:2])
            np.testing.assert_array_equal(v, rv, err_msg=name)   # bit for bit
            np.testing.assert_array_equal(i, ri, err_msg=name)


def _spy_products(monkeypatch):
    shapes = []
    inner = topk.score_matrix

    def spy(queries, items, precision="highest"):
        shapes.append((tuple(queries.shape), tuple(items.shape), precision))
        return inner(queries, items, precision)

    monkeypatch.setattr(topk, "score_matrix", spy)
    return shapes


@pytest.mark.parametrize("n_q", [8, 256])
def test_c60_reference_scores_in_shard_shaped_blocks(monkeypatch, n_q):
    q, embs = _c60_inputs(n_q=n_q)
    qt, et = torch.as_tensor(q), torch.as_tensor(embs)
    shapes = _spy_products(monkeypatch)
    v, i = quality_at_scale.shard_blocked_topk(qt, et, 100, 4)
    assert shapes == [((n_q, 65), (50, 65), "highest")] * 4
    # the products a rank's exact search takes over its shard
    del shapes[:]
    topk.mips_topk(qt, et[50:100].clone(), 50, 4096)
    assert shapes == [((n_q, 65), (50, 65), "highest")]
    # one exact top-k over the blocks' scores
    want = torch.cat([qt @ et[r * 50:(r + 1) * 50].clone().T for r in range(4)], dim=1)
    wv, wi = torch.topk(want, 100)
    assert torch.equal(v, wv) and torch.equal(i, wi)


def test_exact_score_blocks_are_the_chunks_exact_mode_scores(monkeypatch):
    """Past one chunk exact mode scores ``_score_chunk(q)`` columns a
    product; ``exact_scores`` takes the same products."""
    monkeypatch.setattr(topk, "_SCORE_BUDGET", 8 * topk._REDUCE_CHUNK)
    q, embs = _c60_inputs(n=3 * topk._REDUCE_CHUNK + 100, d=8, n_q=40, seed=2)
    qt, et = torch.as_tensor(q), torch.as_tensor(embs)
    blocks = topk.exact_score_blocks(40, et.shape[0])
    assert len(blocks) == 4 and blocks[-1][1] == et.shape[0]
    shapes = _spy_products(monkeypatch)
    topk.mips_topk(qt, et, 30)
    searched = list(shapes)
    del shapes[:]
    scores = topk.exact_scores(qt, et)
    assert shapes == searched == [((40, 8), (e - s, 8), "highest") for s, e in blocks]
    assert scores.shape == (40, et.shape[0])
