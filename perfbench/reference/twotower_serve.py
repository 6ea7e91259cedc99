"""Plain reference of the two-stage serve path, in plain PyTorch (and NumPy
for the corpus rows): user tower → retrieval of the top C catalog rows →
the 50 features and the two retrieval columns → the ranker MLP with
per-query normalisation → blend with the retrieval score → seen mask →
the top ``max_k``. It imports nothing of the program and takes only the
benchmark's inputs (``perfbench.inputs.ServeInputs``), working out again
what the program's set-up derives from them (the normalised corpus with
its bias column, the padded feature rows, the seen set).

Retrieval follows the configuration's index: ``exact`` scores in full f32
and takes the exact top C; ``fused`` scores bf16 queries against bf16 rows
with f32 sums and, for batches of at least ``KERNEL_MIN_Q`` queries, takes
the top C of the maxima of consecutive windows of W rows (the window
scheme's documented rule, :func:`fused_window`); smaller batches over
large corpora scan exactly. ``prec`` lowers every product to another
precision (the control)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from perfbench.reference.precision import matmul

KERNEL_MIN_Q = 384           # the fused index's smallest batch for windows ...
SCAN_MIN_N = 65536           # ... over corpora larger than this
TARGET_CAND = 16384          # window maxima the window rule aims at
USER_BLOCK = 256             # queries scored at a time


def fused_window(n: int, k: int) -> int:
    """About n/16384 rounded up to a power of two, clamped to [8, 512],
    halved while n // W < max(k, 4W); below 8 the corpus is scanned."""
    ratio = -(-n // TARGET_CAND)
    window = 1 << max(0, ratio - 1).bit_length()
    window = max(8, min(512, window))
    while window > 1 and n // window < max(k, 4 * window):
        window //= 2
    return window


def retrieval_rule(cfg: dict, batch: int):
    """("exact" | "scan" | "window", W, index precision) of the
    configuration's index for a serving batch of ``batch`` queries."""
    n, c = cfg["n_items"], cfg["top_k_candidates"]
    if cfg["index_mode"] == "exact":
        return "exact", 1, "f32"
    if cfg["index_mode"] != "fused" or cfg["index_dtype"] != "bfloat16":
        raise ValueError("the reference covers exact f32 and fused bf16 indexes")
    if batch < KERNEL_MIN_Q and n > SCAN_MIN_N:
        return "scan", 1, "bf16"
    w = fused_window(n, c)
    return ("exact", 1, "f32") if w < 8 else ("window", w, "bf16")


def l2_normalize(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt((x * x).sum(-1, keepdim=True) + 1e-12)


def user_queries(tower: dict, users: torch.Tensor, prec: str = "f32") -> torch.Tensor:
    """(Q,) user ids → (Q, D) unit queries: embedding → ReLU MLP → L2."""
    e = tower["user_embed"][users]
    h = torch.relu(matmul(e, tower["user_w1"], prec) + tower["user_b1"])
    return l2_normalize(matmul(h, tower["user_w2"], prec) + tower["user_b2"])


def corpus_rows(item_vecs: torch.Tensor, item_bias: torch.Tensor) -> torch.Tensor:
    """(N, D + 1) f32: each item vector over its L2 norm (at least 1e-12),
    computed in float32 by NumPy, then its bias as one more column."""
    x = item_vecs.float().cpu().numpy()
    unit = x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), np.float32(1e-12))
    rows = torch.from_numpy(np.ascontiguousarray(unit, np.float32)).to(item_vecs.device)
    return torch.cat([rows, item_bias.float()[:, None]], dim=1)


@dataclass
class Retrieved:
    pos: torch.Tensor        # (Q, C) corpus positions, best first
    vals: torch.Tensor       # (Q, C) their scores
    top: torch.Tensor        # (Q, C) the reference's own best C values


def retrieve(q: torch.Tensor, rows: torch.Tensor, cfg: dict, batch: int,
             prec: Optional[str] = None, at: Optional[torch.Tensor] = None) -> Retrieved:
    """Top C of the rows for each query under the configuration's rule;
    ``prec`` overrides the index precision. With ``at`` (Q, C) positions,
    ``vals`` are the scores of those positions instead, and ``pos`` is
    ``at``."""
    route, w, iprec = retrieval_rule(cfg, batch)
    prec = prec or iprec
    c = cfg["top_k_candidates"]
    n = rows.shape[0]
    q_aug = torch.cat([q, torch.ones_like(q[:, :1])], dim=1)
    out_pos, out_vals, out_top = [], [], []
    for s in range(0, q.shape[0], USER_BLOCK):
        scores = matmul(q_aug[s:s + USER_BLOCK], rows.T, prec)       # (q, N)
        if route == "window":
            n_win = -(-n // w)
            pad = n_win * w - n
            sw = torch.nn.functional.pad(scores, (0, pad), value=float("-inf"))
            mx, arg = sw.view(scores.shape[0], n_win, w).max(dim=2)
            top, win = torch.topk(mx, c, dim=1)
            pos = win * w + torch.gather(arg, 1, win)
        else:
            top, pos = torch.topk(scores, c, dim=1)
        if at is not None:
            pos = at[s:s + USER_BLOCK]
        out_pos.append(pos)
        out_vals.append(torch.gather(scores, 1, pos))
        out_top.append(top)
        del scores
    return Retrieved(torch.cat(out_pos), torch.cat(out_vals), torch.cat(out_top))


class SeenRef:
    """Membership of (user, item) pairs in the ratings, by a sorted key
    list."""

    def __init__(self, users: torch.Tensor, items: torch.Tensor, n_items: int):
        self.stride = n_items + 1
        self.keys = torch.unique(users.long() * self.stride + items.long())

    def contains(self, users: torch.Tensor, items: torch.Tensor) -> torch.Tensor:
        q = users.long() * self.stride + items.long()
        i = torch.searchsorted(self.keys, q).clamp(max=self.keys.numel() - 1)
        return self.keys[i] == q


def features(user_feats, item_feats, users, cand_ids, cfg: dict) -> torch.Tensor:
    """(Q, C, 50) in the feature schema's order: user scalars, item scalars,
    rating difference, popularity ratio, genre affinity, user genres, item
    genres."""
    nu, ni, ng = cfg["user_scalars"], cfg["item_scalars"], cfg["genres"]
    u = user_feats[users]                       # (Q, nu + ng)
    it = item_feats[cand_ids]                   # (Q, C, ni + ng)
    us, ug = u[:, :nu], u[:, nu:nu + ng]
    is_, ig = it[..., :ni], it[..., ni:ni + ng]
    c = cand_ids.shape[1]
    inter = torch.stack([us[:, None, 0] - is_[..., 0],
                         us[:, None, 1] / (is_[..., 1] + 1e-8),
                         (ig * ug[:, None, :]).sum(-1)], dim=-1)
    return torch.cat([us[:, None, :].expand(-1, c, -1), is_, inter,
                      ug[:, None, :].expand(-1, c, -1), ig], dim=-1)


def _zscore(x, m, cnt):
    mu = (x * m).sum(-1, keepdim=True) / cnt
    var = (((x - mu) ** 2) * m).sum(-1, keepdim=True) / cnt
    return (x - mu) * torch.rsqrt(var + 1e-9)


def final_scores(inp, cfg: dict, users: torch.Tensor, cand_pos: torch.Tensor,
                 rvals: torch.Tensor, seen: SeenRef, prec: str = "f32") -> torch.Tensor:
    """(Q, C) final scores of the candidates (in their given order), -inf
    where the user has seen the item: the ranker over the 50 features, the
    retrieval score and the log of the position among the unseen
    candidates; each column standardised globally, then over the
    candidates (each shifted by the first candidate's value, so a column
    constant over them is exactly 0), the MLP, then z(ranker) + β ·
    z(retrieval) over the unseen candidates."""
    cand_ids = cand_pos + 1
    is_seen = seen.contains(users[:, None].expand_as(cand_ids), cand_ids)
    unseen = ~is_seen
    rank = torch.log1p((torch.cumsum(unseen.float(), dim=1) - 1.0).clamp(min=0.0))
    x = torch.cat([features(inp.user_feats, inp.item_feats, users, cand_ids, cfg),
                   rvals[..., None], rank[..., None]], dim=-1)
    h = (x - inp.feat_mean) / inp.feat_std
    h = h - h[:, :1, :]
    h = (h - h.mean(dim=1, keepdim=True)) / (h.std(dim=1, keepdim=True, correction=0) + 1e-6)
    n_layers = len(inp.ranker) // 2
    for i in range(n_layers):
        h = matmul(h, inp.ranker[f"w{i}"], prec) + inp.ranker[f"b{i}"]
        if i < n_layers - 1:
            h = torch.relu(h)
    score = h[..., 0]
    beta = float(cfg["blend_retrieval"])
    if beta > 0:
        m = unseen.float()
        cnt = m.sum(-1, keepdim=True).clamp(min=1.0)
        score = _zscore(score, m, cnt) + beta * _zscore(rvals, m, cnt)
    return score.masked_fill(is_seen, float("-inf"))
