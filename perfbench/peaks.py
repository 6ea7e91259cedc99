"""Published peaks of one NVIDIA H100 SXM (dense, 700 W) and the bound rule.

The bound of a piece of work is the larger of its bytes, each moved once,
over the HBM rate and its operations over the peak rate of their type.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12, "tf32": 495e12}
# the peak by which a configuration's stated precision is judged
PRECISION_PEAK = {"bfloat16": "bf16", "float32": "f32", "int8": "int8"}


def bound_s(n_bytes: float, ops: float = 0.0, kind: str = "f32") -> float:
    """The least seconds the card could take for ``ops`` operations of
    ``kind`` and ``n_bytes`` moved once."""
    return max(n_bytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[kind])


def share(bound: float, seconds: float):
    """``bound`` as a percentage of the measured ``seconds``; ``None`` when
    nothing was measured."""
    if seconds <= 0:
        return None
    return 100.0 * bound / seconds
