"""serve.batch_p95_ms: the 95th percentile, over the traced window's calls,
of the host time from the call into ``serve_batch`` to its ids and scores
on the host (under the profiler). The tail of a cell whose closed loop runs
at the system's capacity: host jitter sets it, so it is no end-to-end
metric there."""
import numpy as np


def read(ctx):
    calls = ctx.window.calls
    if ctx.trace is None or not calls:
        return None
    return float(np.percentile([(c.t_done - c.t_call) * 1e3 for c in calls], 95))
