"""The port's ``ranker_headroom`` (``recommendit_tpu_torch/scripts/
ranker_headroom.py``) against JAX's (``scripts/ranker_headroom.py``) on the
CPU, over one tiny models directory the port trained (200 users x 150
items x 8,000 ratings under non-default ``SynthWeights``, towers 16/32, 2
epochs, in-batch BPR).

JAX's own ``main`` runs on the port's models directory and prints its
lines; the port's ``main`` prints the same. The fitted-M line is equal
(numpy on bit-equal latents), and the six orderings' rows are equal at
JAX's printed 4 decimals (the towers' f32 rounding differs between the
packages far below that). The fitted M's expected presents lie within
1 % of the realized ratings.
"""
import json
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from recommendit_tpu_torch.config import Settings
from recommendit_tpu_torch.data.movielens import save_movielens
from recommendit_tpu_torch.data.synthetic import make_synthetic_movielens
from recommendit_tpu_torch.pipelines.run_pipeline import PipelineOrchestrator
from recommendit_tpu_torch.scripts import ranker_headroom

ROOT = Path(__file__).resolve().parents[1]
WEIGHTS = {"exposure_quality": 0.2, "latent": 1.1}
SIZE = ["--n-users", "200", "--n-items", "150", "--n-ratings", "8000",
        "--eval-users", "60", "--candidates", "80", "--weights", json.dumps(WEIGHTS)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("headroom")
    save_movielens(make_synthetic_movielens(200, 150, 8000, 0, weights=WEIGHTS),
                   str(tmp / "ml"))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    cfg = Settings(SEED=0, EMBEDDING_DIM=16, HIDDEN_DIM=32, BATCH_SIZE=128,
                   TRAIN_EPOCHS=2, LOSS_MODE="in_batch")
    orch = PipelineOrchestrator(cfg=cfg, data_dir=str(tmp / "ml"),
                                models_dir=str(tmp / "models"),
                                features_dir=str(tmp / "features"), device="cpu")
    orch.run_stage("embeddings")
    args = SIZE + ["--models-dir", str(tmp / "models")]
    out = ranker_headroom.run(ranker_headroom.parse_args(args + ["--device", "cpu"]))
    torch.set_num_threads(n)
    return dict(out=out, args=args)


def _printed(capsys, fn):
    capsys.readouterr()
    fn()
    return capsys.readouterr().out.splitlines()


def test_jax_main_prints_the_port_s_lines(runs, capsys):
    args = runs["args"]
    port = _printed(capsys, lambda: ranker_headroom.main(args + ["--device", "cpu"]))

    def jax_main():
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(sys, "argv", ["ranker_headroom.py", *args])
            runpy.run_path(str(ROOT / "scripts" / "ranker_headroom.py"),
                           run_name="__main__")

    jax = _printed(capsys, jax_main)
    assert len(port) == len(jax) == 8
    assert port[0] == jax[0] and port[0].startswith("fitted effective draws M = ")
    assert port[1:] == jax[1:]
    assert [line.split()[0] for line in port[2:]] == list(ranker_headroom.ORDERINGS)


def test_fit_and_rows(runs):
    out = runs["out"]
    assert abs(out["expected_presents"] - out["realized"]) <= 0.01 * out["realized"]
    assert list(out["rows"]) == list(ranker_headroom.ORDERINGS)
    for name, rep in out["rows"].items():
        assert all(np.isfinite(rep[k]) for k in ("ndcg@10", "recall@20", "mrr")), name
    assert out["rows"]["oracle_unseen"]["ndcg@10"] >= out["rows"]["cosine"]["ndcg@10"]


def test_norm_sf_and_fit_draws():
    np.testing.assert_allclose(ranker_headroom.norm_sf([0.0, 1.0, -1.0]),
                               [0.5, 0.15865525393145707, 0.8413447460685429], rtol=1e-12)
    q = np.full((10, 10), 1e-3)
    m = ranker_headroom.fit_draws(q, 50)
    np.testing.assert_allclose(np.sum(1 - np.exp(-m * q)), 50, rtol=1e-9)
