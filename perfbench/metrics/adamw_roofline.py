"""adamw_roofline: the sharded step's optimizer (``ShardedOptState.apply_``:
clipping and the chunked AdamW, inside the ``perfbench.optim`` range)
against the bytes AdamW must move, in %: each f32 element of every param
read once with its gradient and both moments, and the param and both
moments written once (7 · 4 bytes an element), over 3.35 TB/s, over the
device time of the range a step, for the steps whose kernels the trace
holds."""
from perfbench.peaks import bound_s, share


def n_bytes(numel: int) -> float:
    return 7.0 * 4 * numel


def read(ctx):
    t = ctx.trace
    if t is None or not ctx.whole:
        return None
    seconds = t.layer_s("optim") / ctx.whole
    if seconds <= 0:
        return None
    return share(bound_s(n_bytes(ctx.facts["numel"])), seconds)
