"""bag_update_roofline: the table's update kernels (``csrc/embedding_bag.cu``:
``bag_update_kernel`` and ``bag_update_carry_kernel``, the pooling's
backward fused with exact Adagrad) against the bytes the update must move,
in %: the (B, F, D) f32 pooled gradient and the (B, S) int32 ids read
once, and each distinct row's weights and accumulator (D f32 each) read
and written once, over 3.35 TB/s, for the steps whose kernels the trace
holds, over the two kernels' device time. The sort of the ids that comes
before them (``torch.sort``) is not in the time. The distinct rows are the
harness's own count at set-up (their mean a batch)."""
from perfbench.peaks import bound_s, share

KERNELS = r"bag_update(_carry)?_kernel"


def n_bytes(cfg: dict, batch: int, unique_rows: float) -> float:
    d = int(cfg["embed_dim"])
    slots = sum(int(k) for k in cfg["bag_sizes"])
    return 4.0 * (batch * len(cfg["bag_sizes"]) * d + batch * slots + 4 * unique_rows * d)


def read(ctx):
    t = ctx.trace
    if t is None or not ctx.whole:
        return None
    seconds = t.kernel_s(KERNELS)
    if seconds <= 0:
        return None
    f = ctx.facts
    return share(ctx.whole * bound_s(n_bytes(ctx.config, f["batch"], f["unique_rows"])),
                 seconds)
