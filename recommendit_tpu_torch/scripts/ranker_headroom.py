"""Oracle-ceiling diagnostic for the two-stage synthetic benchmark — torch
port of ``scripts/ranker_headroom.py``.

Re-orders each evaluated user's top-C tower candidates by the true
generative hit probability (exposure x relevance, rebuilt from the
generator's latents, ``return_latents=True``) and reports the NDCG@10,
Recall@20 and MRR a perfect re-ranker could reach on this data, beside
the tower's own cosine order. If the oracle barely beats the cosine order
no ranker can show lift; if it clearly wins, the gap is the ranker's to
close.

Exposure saturates (a pair drawn k ≥ 1 times appears once), so the chance
a pair is present is 1 − exp(−M·q), q the one-draw acceptance rate; the
effective draw count M is fitted by bisection so that the expected
presents equal the realized ratings. Six orderings: ``cosine``,
``oracle`` (exposure x relevance), ``oracle_rel``, ``oracle_exp`` and the
two with the user's train-time items dropped (``cosine_unseen``,
``oracle_unseen``).

The towers run in torch (on the card unless ``--device cpu``), the rest in
numpy. ``--data-dir`` is kept for JAX's flags: the data is regenerated
from the sizes, ``--seed`` and ``--weights``, which must be those the
models were trained on.

Usage:
  python -m recommendit_tpu_torch.scripts.ranker_headroom \\
      --models-dir /tmp/q2/models [--seed 0] [--weights '{...}']
"""
from __future__ import annotations

import argparse
import json
import math
import os
import tempfile

import numpy as np

from recommendit_tpu_torch.utils.device import DEFAULT_DEVICE

ORDERINGS = ("cosine", "oracle", "oracle_rel", "oracle_exp",
             "cosine_unseen", "oracle_unseen")

_erfc = np.vectorize(math.erfc)


def norm_sf(x):
    """Standard-normal survival function P(Z >= x), vectorized."""
    return 0.5 * _erfc(np.asarray(x, dtype=np.float64) / math.sqrt(2.0))


def fit_draws(q_all: np.ndarray, n_ratings: int, rounds: int = 60) -> float:
    """The effective draw count M with sum(1 − exp(−M·q)) = ``n_ratings``,
    by bisection in log space over [1, 1e9]."""
    lo_m, hi_m = 1.0, 1e9
    for _ in range(rounds):
        mid = math.sqrt(lo_m * hi_m)
        tot = np.sum(1.0 - np.exp(-mid * q_all))
        if tot < n_ratings:
            lo_m = mid
        else:
            hi_m = mid
    return math.sqrt(lo_m * hi_m)


def parse_args(argv=None):
    tmp = os.path.join(tempfile.gettempdir(), "q2")
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data-dir", default=f"{tmp}/ml")
    ap.add_argument("--models-dir", default=f"{tmp}/models")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n-users", type=int, default=1500)
    ap.add_argument("--n-items", type=int, default=1200)
    ap.add_argument("--n-ratings", type=int, default=150_000)
    ap.add_argument("--eval-users", type=int, default=150)
    ap.add_argument("--candidates", type=int, default=500)
    ap.add_argument("--weights", default=None,
                    help="JSON dict of SynthWeights field overrides")
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    return ap.parse_args(argv)


def run(args) -> dict:
    """→ {"M": the fitted draw count, "expected_presents", "realized",
    "rows": {ordering: evaluate_model's report}} at full precision."""
    import torch

    from recommendit_tpu_torch.data import synthetic as syn
    from recommendit_tpu_torch.evaluation.metrics import evaluate_model
    from recommendit_tpu_torch.models import TwoTower
    from recommendit_tpu_torch.pipelines.run_pipeline import temporal_split
    from recommendit_tpu_torch.training.train_embeddings import build_genre_table

    data, lat = syn.make_synthetic_movielens(
        n_users=args.n_users, n_items=args.n_items, n_ratings=args.n_ratings,
        seed=args.seed, return_latents=True,
        weights=json.loads(args.weights) if args.weights else None,
    )
    # JAX's script keeps every train-time item, FILTER_SEEN or not
    split = temporal_split(data, args.eval_users, filter_seen=True)
    truth, users, rated_train = split.truth, split.users, split.seen_train

    model = TwoTower.load(f"{args.models_dir}/two_tower.npz", device=args.device)
    genre_table = build_genre_table(data.item_ids, data.genres, model.n_items)
    item_ids = np.arange(1, model.n_items + 1, dtype=np.int64)
    item_embs = model.get_item_embeddings(item_ids, genre_table[1:])
    user_embs = model.user_tower(torch.arange(model.n_users + 1, device=model.device)
                                 ).cpu().numpy()

    ss = lat["score_stats"]
    w = lat["weights"]
    taste_all, igu = lat["taste"], lat["item_genre_unit"]
    act, p_item = lat["activity"], lat["item_pop"] / lat["item_pop"].sum()
    match_all = taste_all @ igu.T                      # (U, I)
    latent_all = lat["user_latent"] @ lat["item_latent"].T
    tilt_all = (
        w.exposure_gamma * match_all / (ss["match_sd_exposure"] + 1e-12)
        + w.exposure_latent * latent_all / (ss["latent_sd"] + 1e-12)
        + w.exposure_quality * lat["item_quality"][None, :]
    )
    q_all = act[:, None] * p_item[None, :] / (1.0 + np.exp(-tilt_all))
    m_eff = fit_draws(q_all, len(data))
    expected = float(np.sum(1.0 - np.exp(-m_eff * q_all)))
    thresh4 = lat["rating_edges"][2]  # score >= this → rating >= 4
    qual = lat["item_quality"]
    c = args.candidates

    orders = {k: {} for k in ORDERINGS}
    for u in users:
        if u > model.n_users:
            continue
        scores = item_embs @ user_embs[u]
        top = np.argsort(-scores)[:c]
        cand0 = top                      # 0-based item index
        cand = top + 1                   # 1-based item id
        match = lat["item_genre_unit"][cand0] @ lat["taste"][u - 1]
        gz = (match - ss["genre_mu"]) / (ss["genre_sd"] + 1e-12)
        latz = (
            lat["item_latent"][cand0] @ lat["user_latent"][u - 1]
            - ss["latent_mu"]
        ) / (ss["latent_sd"] + 1e-12)
        mu = (
            w.latent * latz
            + w.genre * gz
            + w.quality * qual[cand0]
            + w.loyalty * (gz > w.loyalty_tau)
            + w.user_bias * lat["user_bias"][u - 1]
        )
        p_rel = norm_sf((thresh4 - mu) / w.noise)
        p_exp = 1.0 - np.exp(-m_eff * q_all[u - 1, cand0])

        def topk(v, k=20):
            sel = np.argsort(-v)[:k]
            return [int(cand[s]) for s in sel]

        orders["cosine"][u] = topk(scores[top])
        orders["oracle"][u] = topk(p_exp * p_rel)
        orders["oracle_rel"][u] = topk(p_rel)
        orders["oracle_exp"][u] = topk(p_exp)
        # a (u, i) pair occurs at most once in the data, so items rated in
        # train can never be test hits — the true Bayes order knows it
        seen = np.array([x in rated_train.get(u, ()) for x in cand])
        orders["cosine_unseen"][u] = topk(np.where(seen, -np.inf, scores[top]))
        orders["oracle_unseen"][u] = topk(np.where(seen, -np.inf, p_exp * p_rel))

    rows = {name: evaluate_model(recs, truth, k_values=[10, 20])
            for name, recs in orders.items()}
    return {"M": m_eff, "expected_presents": expected, "realized": len(data),
            "rows": rows}


def main(argv=None) -> int:
    out = run(parse_args(argv))
    print(f"fitted effective draws M = {out['M']:,.0f} "
          f"(expected presents {out['expected_presents']:,.0f} "
          f"vs realized {out['realized']:,d})")
    print(f"{'ordering':<12} {'ndcg@10':>8} {'recall@20':>10} {'mrr':>8}")
    for name, rep in out["rows"].items():
        print(f"{name:<12} {rep['ndcg@10']:>8.4f} {rep['recall@20']:>10.4f} "
              f"{rep['mrr']:>8.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
