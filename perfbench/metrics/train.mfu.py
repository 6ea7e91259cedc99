"""train.mfu: the training step's share of the f32 peak (67 TFLOP/s; the
step runs its products in full f32), in %: the products of every step of
the traced window, counted from the shapes, over the window's seconds.

A step of B examples: both towers forward and backward (3 · 2·B·(in·H +
H·D) each, the item tower's input D + genres wide) and the in-batch BPR
loss (2·B²·D forward, 6·B²·D backward)."""
from perfbench.peaks import PEAK_OPS_PER_S


def ops(b: int, cfg: dict) -> float:
    d, h, g = cfg["embedding_dim"], cfg["hidden_dim"], cfg["genres"]
    towers = 6.0 * b * (d * h + h * d) + 6.0 * b * ((d + g) * h + h * d)
    return towers + 8.0 * b * b * d


def read(ctx):
    t = ctx.trace
    if t is None or t.window_s <= 0 or not t.n_calls:
        return None
    return 100.0 * t.n_calls * ops(ctx.facts["batch"], ctx.config) / t.window_s \
        / PEAK_OPS_PER_S["f32"]
