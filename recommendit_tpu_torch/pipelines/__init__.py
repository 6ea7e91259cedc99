"""The torch port's pipeline orchestrator (``run_pipeline``)."""
from recommendit_tpu_torch.pipelines.run_pipeline import (  # noqa: F401
    STAGES,
    PipelineOrchestrator,
)
