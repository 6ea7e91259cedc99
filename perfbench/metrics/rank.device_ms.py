"""rank.device_ms: device milliseconds a batch of ``serve_batch``'s
operations outside the ``perfbench.retrieve`` range (user tower, feature
assembly, ranker, blend, seen mask, final top-k) and of the copy of the
results, over the batches whose kernels the trace holds."""


def read(ctx):
    if ctx.trace is None or not ctx.whole:
        return None
    return 1e3 * ctx.trace.layer_s(None) / ctx.whole
