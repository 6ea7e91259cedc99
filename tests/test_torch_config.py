"""The port's copies of the JAX package's framework-free modules, pinned to
the originals, and the port's device rule: every entry point runs on the
card unless the caller names the CPU, and without a card a call that names
no device raises (nothing falls back to the CPU)."""
import dataclasses
import inspect

import numpy as np
import pytest
import torch

from recommendit_tpu import config as jax_config
from recommendit_tpu.utils.latency import LatencyTracker as JaxTracker
from recommendit_tpu_torch import config
from recommendit_tpu_torch.data.synthetic import make_synthetic_movielens
from recommendit_tpu_torch.models import LambdaRankScorer, MIPSIndex, TwoTower, load_ranker
from recommendit_tpu_torch.models import two_tower
from recommendit_tpu_torch.ops import quantize
from recommendit_tpu_torch.pipelines import PipelineOrchestrator
from recommendit_tpu_torch.serving.recommender import RecommendationPipeline
from recommendit_tpu_torch.training import EmbeddingTrainer, IndexBuilder
from recommendit_tpu_torch.utils.device import resolve_device
from recommendit_tpu_torch.utils.latency import LatencyTracker


def _fields(cls):
    return [(f.name, f.type, f.default) for f in dataclasses.fields(cls)]


def test_settings_fields_and_defaults_are_the_jax_ones():
    assert _fields(config.Settings) == _fields(jax_config.Settings)
    assert dataclasses.asdict(config.Settings()) == dataclasses.asdict(
        jax_config.Settings())


ENV = {
    "TOP_K_CANDIDATES": "123", "FILTER_SEEN": "off", "LEARNING_RATE": "0.01",
    "RANKER_HIDDEN_DIMS": "64,32", "RANKER_LABEL_GAIN": "0,1.5,3",
    "INDEX_MODE": "fused", "MICRO_BATCH": "yes",
}


def test_env_parsing_is_the_jax_one(tmp_path, monkeypatch):
    env_file = tmp_path / ".env"
    env_file.write_text('# a comment\nINDEX_DTYPE="int8"\nSEED=7\nBATCH_SIZE=64\n')
    for k, v in ENV.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("BATCH_SIZE", "128")      # the env beats the file
    got = config.Settings.from_env(str(env_file), TOP_K_RESULTS=9)
    want = jax_config.Settings.from_env(str(env_file), TOP_K_RESULTS=9)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.TOP_K_CANDIDATES, got.FILTER_SEEN, got.RANKER_HIDDEN_DIMS,
            got.INDEX_DTYPE, got.SEED, got.BATCH_SIZE) == (
        123, False, (64, 32), "int8", 7, 128)
    assert got.replace(SEED=3).SEED == 3


def test_latency_tracker_matches_the_jax_one():
    samples = np.random.default_rng(0).exponential(5.0, size=2500)
    ours, theirs = LatencyTracker(1000), JaxTracker(1000)
    assert ours.p50 == theirs.p50 == 0.0
    for n, x in enumerate(samples, 1):
        ours.record(float(x))
        theirs.record(float(x))
        if n in (1, 999, 1000, 1001, 2500):
            assert ours.count == theirs.count
            for p in (50, 90, 99, 99.9):
                assert ours.percentile(p) == theirs.percentile(p)
            assert (ours.p50, ours.p99) == (theirs.p50, theirs.p99)


ENTRY_POINTS = {
    "RecommendationPipeline": RecommendationPipeline.__init__,
    "MIPSIndex": MIPSIndex.__init__,
    "MIPSIndex.load": MIPSIndex.load,
    "LambdaRankScorer": LambdaRankScorer.__init__,
    "LambdaRankScorer.load": LambdaRankScorer.load,
    "load_ranker": load_ranker,
    "init_params": two_tower.init_params,
    "TwoTower": TwoTower.__init__,
    "TwoTower.from_numpy": TwoTower.from_numpy,
    "TwoTower.load": TwoTower.load,
    "from_jax_params": two_tower.from_jax_params,
    "IndexBuilder": IndexBuilder.__init__,
    "EmbeddingTrainer": EmbeddingTrainer.__init__,
    "threefry_uniform": quantize.threefry_uniform,
    "PipelineOrchestrator": PipelineOrchestrator.__init__,
}


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_points_default_to_the_card(name):
    param = inspect.signature(ENTRY_POINTS[name]).parameters["device"]
    assert param.default == "cuda"


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a GPU")


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """A small two-tower, ranker and index saved from the CPU."""
    tmp = tmp_path_factory.mktemp("saved")
    rng = torch.Generator().manual_seed(0)
    params = two_tower.init_params(rng, 20, 30, 8, 8, device="cpu")
    model = TwoTower.from_numpy({k: v.numpy() for k, v in params.items()},
                                20, 30, 8, 8, device="cpu")
    model.save(str(tmp / "tt.npz"))
    index = MIPSIndex(8, device="cpu")
    index.build(np.eye(30, 8, dtype=np.float32), np.arange(1, 31))
    index.save(str(tmp / "i.npz"))
    ranker = LambdaRankScorer(feature_names=["a", "b"], hidden_dims=(4,),
                              device="cpu")
    ranker.params = {"w0": torch.zeros(2, 4), "b0": torch.zeros(4),
                     "w1": torch.zeros(4, 1), "b1": torch.zeros(1)}
    ranker.feat_mean = np.zeros(2, np.float32)
    ranker.feat_std = np.ones(2, np.float32)
    ranker.save(str(tmp / "r.npz"))
    return tmp, {k: v.numpy() for k, v in params.items()}


def _calls(tmp, params):
    data = make_synthetic_movielens(20, 30, 300, seed=0)
    return {
        "RecommendationPipeline": lambda: RecommendationPipeline(),
        "MIPSIndex": lambda: MIPSIndex(8),
        "MIPSIndex.load": lambda: MIPSIndex.load(str(tmp / "i.npz")),
        "LambdaRankScorer": lambda: LambdaRankScorer(),
        "LambdaRankScorer.load": lambda: LambdaRankScorer.load(str(tmp / "r.npz")),
        "load_ranker": lambda: load_ranker(str(tmp / "r.npz")),
        "init_params": lambda: two_tower.init_params(torch.Generator(), 3, 4, 4, 4),
        "TwoTower": lambda: TwoTower(3, 4, 4, 4),
        "TwoTower.from_numpy": lambda: TwoTower.from_numpy(params, 20, 30, 8, 8),
        "TwoTower.load": lambda: TwoTower.load(str(tmp / "tt.npz")),
        "from_jax_params": lambda: two_tower.from_jax_params(params),
        "IndexBuilder": lambda: IndexBuilder(data),
        "EmbeddingTrainer": lambda: EmbeddingTrainer(data, model_output_path=""),
        "threefry_uniform": lambda: quantize.threefry_uniform(0, 4),
        "PipelineOrchestrator": lambda: PipelineOrchestrator(),
    }


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_no_device_without_a_card_raises(no_card, saved, name):
    call = _calls(*saved)[name]
    with pytest.raises(RuntimeError, match="needs an NVIDIA GPU"):
        call()


def test_resolve_device(no_card):
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        resolve_device("cuda:0")
