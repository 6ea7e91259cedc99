"""Framework-free helpers of the port (copies of the JAX package's where
they exist there) and its device rule."""
from recommendit_tpu_torch.utils.latency import LatencyTracker  # noqa: F401
from recommendit_tpu_torch.utils.logging import get_logger, setup_logging  # noqa: F401
