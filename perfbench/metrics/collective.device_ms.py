"""collective.device_ms: device milliseconds a step of the NCCL kernels on
rank 0 (the lookups' all-reduce over ``model``, the clipping's sum of the
shards' squares), over the steps whose kernels the trace holds."""

KERNELS = r"(?i)nccl"


def read(ctx):
    t = ctx.trace
    if t is None or not ctx.whole:
        return None
    seconds = t.kernel_s(KERNELS)
    return 1e3 * seconds / ctx.whole if seconds > 0 else None
