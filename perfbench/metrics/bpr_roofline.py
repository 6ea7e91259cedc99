"""bpr_roofline: kernels 5 and 6 (``csrc/bpr.cu``: the in-batch BPR
forward and backward, tile and finishing launches) against their bound at
the step's (B, D), in %. Only the products count (forward: the B × B
scores, 2·B²·D; backward: those, W·V and Wᵀ·U, 6·B²·D) at the f32 peak,
or the bytes (forward: U, V; backward: U, V, dU, dV, f32) at the HBM rate,
whichever is larger; the bound of the steps whose kernels the trace holds
over the kernels' summed device time."""
from perfbench.peaks import bound_s, share

KERNELS = r"bpr_(fwd|bwd)_(tile|finish)_kernel"


def bound(b: int, d: int) -> float:
    fwd = bound_s(2 * b * d * 4 + 4, 2.0 * b * b * d, "f32")
    bwd = bound_s(4 * b * d * 4 + 4, 6.0 * b * b * d, "f32")
    return fwd + bwd


def read(ctx):
    t = ctx.trace
    if t is None or not ctx.whole:
        return None
    seconds = t.kernel_s(KERNELS)
    if seconds <= 0:
        return None
    return share(ctx.whole * bound(ctx.facts["batch"], ctx.config["embedding_dim"]), seconds)
