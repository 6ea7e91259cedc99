"""dlrm.mfu: the DLRM-DCNv2 training step's share of the f32 peak (67
TFLOP/s; the step runs its products in full f32), in %: the products of
every step of the traced window, counted from the configuration's widths,
over the window's seconds.

A step of B examples makes 6·B·M operations, M the multiply-adds an
example's forward makes (2 an add forward, twice as many backward): the
bottom MLP (13 → 512 → 256 → 128), the cross net's two low-rank products
a layer (3,456 × 512 and back, three layers) and the over MLP (3,456 →
1,024 → 1,024 → 512 → 256 → 1): M = 16,030,464 at the published widths."""
from perfbench.peaks import PEAK_OPS_PER_S


def macs(cfg: dict) -> int:
    """Multiply-adds of one example's forward."""
    d = int(cfg["embed_dim"])
    w = d * (len(cfg["vocab_sizes"]) + 1)
    bottom = [int(cfg["dense_in"])] + [int(x) for x in cfg["bottom"]] + [d]
    top = [w] + [int(x) for x in cfg["top"]] + [1]
    mlp = sum(a * b for a, b in zip(bottom, bottom[1:])) + sum(a * b for a, b in zip(top, top[1:]))
    return mlp + int(cfg["cross_layers"]) * 2 * w * int(cfg["cross_rank"])


def read(ctx):
    t = ctx.trace
    if t is None or t.window_s <= 0 or not t.n_calls:
        return None
    return 100.0 * t.n_calls * 6.0 * ctx.facts["batch"] * macs(ctx.config) / t.window_s \
        / PEAK_OPS_PER_S["f32"]
