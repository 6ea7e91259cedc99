"""serve.mfu: the serve step's share of the card's peak, in %: the
operations of every call of the traced window, counted from the shapes,
over the window's seconds, over the dense peak of the configuration's
index precision (bf16 989 TFLOP/s, f32 67 TFLOP/s).

A batch of B users: the user tower (2·B·(D·H + H·D)), the scoring of
every catalog row (2·B·N·(D + 1)) and the ranker MLP over B·C candidates
(2·B·C·Σ in·out of its layers)."""
from perfbench.peaks import PEAK_OPS_PER_S, PRECISION_PEAK


def ops(b: int, cfg: dict) -> float:
    d, h, n, c = cfg["embedding_dim"], cfg["hidden_dim"], cfg["n_items"], cfg["top_k_candidates"]
    dims = [cfg["n_features"], *cfg["ranker_hidden"], 1]
    ranker = sum(a * o for a, o in zip(dims[:-1], dims[1:]))
    return 2.0 * b * (d * h + h * d) + 2.0 * b * n * (d + 1) + 2.0 * b * c * ranker


def read(ctx):
    t = ctx.trace
    if t is None or t.window_s <= 0 or not t.n_calls:
        return None
    cfg = ctx.config
    peak = PEAK_OPS_PER_S[PRECISION_PEAK[cfg["index_dtype"]]]
    return 100.0 * t.n_calls * ops(ctx.facts["batch"], cfg) / t.window_s / peak
