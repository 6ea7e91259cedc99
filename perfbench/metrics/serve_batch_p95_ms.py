"""serve_batch_p95_ms: the 95th percentile, over every call of the window,
of the host time from the call into ``serve_batch`` to its ids and scores
on the host (numpy's linear interpolation between order statistics)."""
import numpy as np


def p95_ms(calls):
    return float(np.percentile([(c.t_done - c.t_call) * 1e3 for c in calls], 95))


def read(ctx):
    return p95_ms(ctx.window.calls) if ctx.window.calls else None
