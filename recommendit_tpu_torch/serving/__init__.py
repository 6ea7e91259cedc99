"""Serving (torch port): the pipeline, the HTTP app and its servers."""
from recommendit_tpu_torch.serving.app import RecommendItApp, create_app, serve  # noqa: F401
from recommendit_tpu_torch.serving.recommender import (  # noqa: F401
    RecommendationPipeline,
    RecommendationResult,
)
