"""recommendit_tpu_torch — the PyTorch / CUDA port of ``recommendit_tpu``.

Mirrors the JAX package's layout and module names. Plain tensor code is
PyTorch; each Pallas kernel of the JAX package becomes a kernel written by
hand for Hopper (``csrc/``), with its plain PyTorch twin beside the wrapper.
Imports ``torch`` and never ``jax``, and nothing of the JAX package: what it
needs of the JAX package's framework-free modules it keeps as copies
(``config.py``, ``utils/latency.py``), pinned to the originals by tests.
Entry points run on the card (``device="cuda"``) unless the caller names
the CPU; without a card a call that names no device raises.
"""

__version__ = "0.1.0"

from recommendit_tpu_torch.config import Settings, settings  # noqa: F401,E402

# the lazy top-level names, JAX's with the port's own classes (``TwoTower``
# where JAX has ``TwoTowerModel``)
EXPORTS = {
    "FeatureEngineer": "recommendit_tpu_torch.features.engineering",
    "FeatureStore": "recommendit_tpu_torch.features.store",
    "TwoTower": "recommendit_tpu_torch.models.two_tower",
    "MIPSIndex": "recommendit_tpu_torch.models.retrieval",
    "LambdaRankScorer": "recommendit_tpu_torch.models.ranker",
    "HistGBDTRanker": "recommendit_tpu_torch.models.gbdt",
    "load_ranker": "recommendit_tpu_torch.models",
    "EmbeddingTrainer": "recommendit_tpu_torch.training.train_embeddings",
    "IndexBuilder": "recommendit_tpu_torch.training.build_index",
    "RankerTrainer": "recommendit_tpu_torch.training.train_ranker",
    "RecommendationPipeline": "recommendit_tpu_torch.serving.recommender",
    "PipelineOrchestrator": "recommendit_tpu_torch.pipelines.run_pipeline",
    "create_app": "recommendit_tpu_torch.serving.app",
    "make_synthetic_movielens": "recommendit_tpu_torch.data.synthetic",
    "load_movielens": "recommendit_tpu_torch.data.movielens",
    "CTRModel": "recommendit_tpu_torch.models.ctr",
    "CTRTrainer": "recommendit_tpu_torch.training.train_ctr",
    "make_ctr_dataset": "recommendit_tpu_torch.data.ctr",
}


def __getattr__(name):
    """Lazy top-level names, as the JAX package's (importing the package
    loads nothing but its settings)."""
    from importlib import import_module

    if name in EXPORTS:
        return getattr(import_module(EXPORTS[name]), name)
    raise AttributeError(f"module 'recommendit_tpu_torch' has no attribute {name!r}")
