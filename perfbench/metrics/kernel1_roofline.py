"""kernel1_roofline: kernel 1 (``csrc/window_mips.cu``, its tensor-core
body ``window_tc_kernel``) against its bound, in %: the bound of every
launch in the traced window over their summed device time.

A launch at (Q queries, N rows, window W) over a bf16 corpus moves at
least the valid rows (N · d · 2 bytes), the f32 queries (Q · d · 4) and
the (N/W, Q) window maxima and positions (8 bytes each), and does 2·Q·N·d
bf16 operations, d being the function's width: the embedding and the bias
column (129), not the card's zero-padded 136."""
from perfbench.peaks import bound_s, share

KERNEL = r"window_tc_kernel"


def n_bytes(q: int, n: int, d: int, window: int) -> float:
    n_cand = -(-n // window)
    return n * d * 2 + q * d * 4 + n_cand * q * 8


def ops(q: int, n: int, d: int) -> float:
    return 2.0 * q * n * d


def bound(q: int, n: int, d: int, window: int) -> float:
    return bound_s(n_bytes(q, n, d, window), ops(q, n, d), "bf16")


def read(ctx):
    if ctx.trace is None or ctx.facts.get("route") != "window":
        return None
    launches = ctx.trace.count(KERNEL)
    seconds = ctx.trace.kernel_s(KERNEL)
    if not launches or seconds <= 0:
        return None
    cfg = ctx.config
    d = cfg["embedding_dim"] + 1
    return share(launches * bound(ctx.facts["batch"], cfg["n_items"], d,
                                  ctx.facts["window"]), seconds)
