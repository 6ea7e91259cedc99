"""bag_fwd_roofline: ``bag_fwd_kernel`` (``csrc/embedding_bag.cu``: every
field's bags of a step pooled from the stacked table) against the bytes it
must move, in %: each distinct (field, row) the step looks up read once
(D f32), the (B, S) int32 ids read once and the (B, F, D) f32 output
written once, over 3.35 TB/s, for the steps whose kernels the trace holds,
over the kernel's device time. The distinct rows are the harness's own
count over its pool of batches at set-up (their mean a batch), so rows
read again from L2 cannot push the share over 100 %."""
from perfbench.peaks import bound_s, share

KERNEL = r"bag_fwd_kernel"


def n_bytes(cfg: dict, batch: int, unique_rows: float) -> float:
    d = int(cfg["embed_dim"])
    slots = sum(int(k) for k in cfg["bag_sizes"])
    return 4.0 * (unique_rows * d + batch * slots + batch * len(cfg["bag_sizes"]) * d)


def read(ctx):
    t = ctx.trace
    if t is None or not ctx.whole:
        return None
    seconds = t.kernel_s(KERNEL)
    if seconds <= 0:
        return None
    f = ctx.facts
    return share(ctx.whole * bound_s(n_bytes(ctx.config, f["batch"], f["unique_rows"])),
                 seconds)
