"""The comparison that decides ``correct``: what the timed path produced,
held against the plain reference, as a few numbers each with its limit.

Serving (``serve_numbers``), for a sample of the served users:

* ``retr_gap`` — the widest gap by which the reference's score of the
  program's j-th retrieved candidate lies below the reference's own j-th
  best (over the configuration's rule: exact, or the window maxima);
* ``retr_err`` — the widest difference between a candidate's retrieval
  score as the program returned it and the reference's score of that row;
* ``rank_gap`` — the widest gap by which the reference's final score of
  the program's j-th served item lies below the reference's j-th best,
  the reference ranking the program's candidates with the program's
  retrieval scores (the retrieval stage is held by the two numbers above);
* ``score_err`` — the widest difference between a served score and the
  reference's final score of that item;
* ``dups`` — users with a candidate row (exact) or window (window scheme)
  twice, or a served item twice.

A served item outside its user's candidates, or one served with a finite
score that the reference masks (or the other way round), reads infinite.

Training (``train_numbers``): each of the first three steps' loss against
the reference's (``loss_err``, relative); by the worst leaf, the norm of
the first gradient as the optimizer got it (``grad_gap``: the gap between
the program's norm and the reference's, over the larger of the reference's
norm of that leaf and of the median leaf); and the norm of the params'
change over the three steps, all counted leaves together
(``delta_total_gap``, relative). The change is not taken by the worst
leaf: a small bias leaf's change swings by rounding (an element whose
later gradient is near zero takes Adam's sign-like step either way).
Leaves whose reference gradient is under a thousandth of the median
leaf's move by round-off alone and are not counted.
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch

from perfbench.reference import twotower_serve as ref

USER_BLOCK = 512
INF = float("inf")


def _served(fin: torch.Tensor, cand_ids: torch.Tensor, ids: torch.Tensor,
            scores: torch.Tensor):
    """(rank gap, score error, duplicate rows) of one block of users."""
    k = ids.shape[1]
    top, _ = torch.topk(fin, k, dim=1)
    match = ids[:, :, None] == cand_ids[:, None, :]
    found = match.any(-1)
    at = torch.gather(fin, 1, match.float().argmax(-1))
    at = torch.where(found, at, torch.full_like(at, -INF))
    both_masked = torch.isinf(top) & torch.isinf(at)
    gap = torch.where(both_masked, torch.zeros_like(at), top - at)
    gap = torch.where(found, gap, torch.full_like(gap, INF))
    fin_s, fin_a = torch.isfinite(scores), torch.isfinite(at)
    err = torch.where(fin_s & fin_a, (scores - at).abs(), torch.zeros_like(at))
    err = torch.where(fin_s != fin_a, torch.full_like(err, INF), err)
    err = torch.where(found, err, torch.full_like(err, INF))
    srt = torch.sort(torch.where(fin_s, ids, -1 - torch.arange(k, device=ids.device)), dim=1)[0]
    dups = int((srt[:, 1:] == srt[:, :-1]).any(1).sum())
    return float(gap.max()), float(err.max()), dups


def serve_numbers(inp, cfg: dict, batch: int, users: torch.Tensor, pos: torch.Tensor,
                  rvals: torch.Tensor, ids: torch.Tensor, scores: torch.Tensor,
                  rows=None, seen=None) -> Dict[str, float]:
    """The serve numbers of the sampled ``users`` (Q,) given what the
    program made for them: candidate positions and retrieval scores (Q, C)
    and served ids and scores (Q, k); all on one device. Outputs of other
    shapes read infinite."""
    n, c, k = users.shape[0], int(cfg["top_k_candidates"]), int(cfg["max_k"])
    if (tuple(pos.shape) != (n, c) or tuple(rvals.shape) != (n, c)
            or tuple(ids.shape) != (n, k) or tuple(scores.shape) != (n, k)):
        return {"retr_gap": INF, "retr_err": INF, "rank_gap": INF, "score_err": INF,
                "dups": n}
    rows = ref.corpus_rows(inp.item_vecs, inp.item_bias) if rows is None else rows
    seen = ref.SeenRef(inp.ratings_user, inp.ratings_item,
                       cfg["n_items"]) if seen is None else seen
    route, w, _ = ref.retrieval_rule(cfg, batch)
    out = {"retr_gap": -INF, "retr_err": 0.0, "rank_gap": -INF, "score_err": 0.0,
           "dups": 0}
    for s in range(0, n, USER_BLOCK):
        sl = slice(s, s + USER_BLOCK)
        u, p, rv = users[sl], pos[sl].long(), rvals[sl].float()
        q = ref.user_queries(inp.tower, u)
        got = ref.retrieve(q, rows, cfg, batch, at=p)
        out["retr_gap"] = max(out["retr_gap"], float((got.top - got.vals).max()))
        out["retr_err"] = max(out["retr_err"], float((rv - got.vals).abs().max()))
        keys = torch.sort(p // w if route == "window" else p, dim=1)[0]
        out["dups"] += int((keys[:, 1:] == keys[:, :-1]).any(1).sum())
        fin = ref.final_scores(inp, cfg, u, p, rv, seen)
        gap, err, dups = _served(fin, p + 1, ids[sl].long(), scores[sl].float())
        out["rank_gap"] = max(out["rank_gap"], gap)
        out["score_err"] = max(out["score_err"], err)
        out["dups"] += dups
    return out


def _median(xs: List[float]) -> float:
    s = sorted(xs)
    n = len(s)
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


def norm_gap(prog: Dict[str, float], want: Dict[str, float], leaves) -> float:
    """max over ``leaves`` of |prog − want| / max(want[leaf], median of want)."""
    med = _median([want[k] for k in want])
    gaps = [abs(prog[k] - want[k]) / max(want[k], med) for k in leaves]
    return max(gaps) if gaps else 0.0


def train_numbers(prog: dict, want: dict) -> Dict[str, float]:
    """``prog`` and ``want``: {"losses": [3], "grad_norms": {leaf: norm},
    "delta_norms": {leaf: norm}}, the program's and the reference's."""
    loss_err = max(abs(a - b) / abs(b) if b else abs(a - b)
                   for a, b in zip(prog["losses"], want["losses"]))
    if len(prog["losses"]) != len(want["losses"]) or any(
            not math.isfinite(x) for x in prog["losses"]):
        loss_err = INF
    g_med = _median(list(want["grad_norms"].values()))
    moving = [k for k, g in want["grad_norms"].items() if g >= 1e-3 * g_med]

    def total(norms):
        return math.sqrt(sum(norms[k] ** 2 for k in moving))

    return {"loss_err": loss_err,
            "grad_gap": norm_gap(prog["grad_norms"], want["grad_norms"], want["grad_norms"]),
            "delta_total_gap": abs(total(prog["delta_norms"]) - total(want["delta_norms"]))
            / total(want["delta_norms"])}


def checks(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """{name: {"value", "limit"}} of every number that has a limit; a
    number without one, or a limit without its number, raises."""
    if set(numbers) != set(limits):
        raise KeyError(f"numbers {sorted(numbers)} against limits {sorted(limits)}")
    return {k: {"value": float(numbers[k]), "limit": float(limits[k])} for k in limits}


def passed(chk: Dict[str, dict]) -> bool:
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in chk.values())
