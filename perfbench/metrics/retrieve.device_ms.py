"""retrieve.device_ms: device milliseconds a batch of the operations
launched inside the ``perfbench.retrieve`` range (the pipeline's searcher:
kernel 1 and its top-k, or the exact engine), over the batches whose
kernels the trace holds."""


def read(ctx):
    if ctx.trace is None or not ctx.whole:
        return None
    return 1e3 * ctx.trace.layer_s("retrieve") / ctx.whole
