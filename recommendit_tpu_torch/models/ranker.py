"""LambdaRank MLP re-ranker — torch port, inference.

Counterpart of the inference half of ``recommendit_tpu/models/ranker.py``:
the npz + ``.meta.json`` format (``load`` / ``save``), :func:`mlp_score`
and the device scorer of the fused serve path (global standardisation,
then, when trained with ``query_norm``, standardisation over the candidate
axis). Training is not ported yet (ROADMAP).
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch


def mlp_score(params: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """(…, F) standardised features → (…,) scores; layers ``w0/b0 …``."""
    n_layers = len(params) // 2
    h = x
    for i in range(n_layers - 1):
        h = torch.relu(h @ params[f"w{i}"] + params[f"b{i}"])
    out = h @ params[f"w{n_layers - 1}"] + params[f"b{n_layers - 1}"]
    return out[..., 0]


class LambdaRankScorer:
    """MLP scorer over the 50-feature contract (plus any retrieval
    features named in ``feature_names``)."""

    def __init__(self, feature_names: Optional[List[str]] = None,
                 hidden_dims: Sequence[int] = (128, 64),
                 label_gain: Sequence[float] = (0.0, 1.0, 3.0, 7.0, 15.0),
                 eval_at: Sequence[int] = (5, 10, 20), group_size: int = 64,
                 loss_type: str = "lambdarank", query_norm: bool = False,
                 device="cpu"):
        self.feature_names = feature_names
        self.hidden_dims = tuple(hidden_dims)
        self.label_gain = tuple(label_gain)
        self.eval_at = tuple(eval_at)
        self.group_size = group_size
        self.loss_type = loss_type
        self.query_norm = query_norm
        self.device = torch.device(device)
        self.params: Optional[Dict[str, torch.Tensor]] = None
        self.feat_mean: Optional[np.ndarray] = None
        self.feat_std: Optional[np.ndarray] = None
        self.best_iteration = 0

    def make_device_scorer(self):
        """Raw (…, C, F) candidate features → (…, C) scores on the device.

        With ``query_norm`` each feature is standardised over the candidate
        axis: (h − mean) / (std + 1e-6), std the population one (ddof 0, as
        ``jnp.std``). The values are first shifted by the first candidate's
        row — the same standardisation in exact arithmetic — so a column
        that is constant over the candidates (every user feature) becomes
        exactly 0. Unshifted, as in ``ranker.py:508-510``, its mean differs
        from the value by rounding, and that ~1e-7 residue divided by
        ~1e-6 feeds O(0.1) noise into the MLP (ROADMAP, queue C)."""
        params = self.params
        mean = torch.as_tensor(self.feat_mean, dtype=torch.float32, device=self.device)
        std = torch.as_tensor(self.feat_std, dtype=torch.float32, device=self.device)
        qn = self.query_norm

        def score(x: torch.Tensor) -> torch.Tensor:
            h = (x - mean) / std
            if qn:
                h = h - h[..., :1, :]
                m = h.mean(dim=-2, keepdim=True)
                s = h.std(dim=-2, keepdim=True, correction=0) + 1e-6
                h = (h - m) / s
            return mlp_score(params, h)

        return score

    def save(self, path: str) -> None:
        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        np.savez(p, feat_mean=self.feat_mean, feat_std=self.feat_std,
                 **{k: v.detach().cpu().numpy() for k, v in self.params.items()})
        meta = {
            "feature_names": self.feature_names,
            "hidden_dims": list(self.hidden_dims),
            "label_gain": list(self.label_gain),
            "eval_at": list(self.eval_at),
            "group_size": self.group_size,
            "best_iteration": self.best_iteration,
            "loss_type": self.loss_type,
            "query_norm": self.query_norm,
        }
        Path(str(p) + ".meta.json").write_text(json.dumps(meta))

    @classmethod
    def load(cls, path: str, device="cpu") -> "LambdaRankScorer":
        p = Path(path)
        if not p.exists():
            raise FileNotFoundError(f"Ranker not found: {p}")
        meta = json.loads(Path(str(p) + ".meta.json").read_text())
        scorer = cls(
            feature_names=meta["feature_names"],
            hidden_dims=meta["hidden_dims"],
            label_gain=meta["label_gain"],
            eval_at=meta["eval_at"],
            group_size=meta["group_size"],
            loss_type=meta.get("loss_type", "lambdarank"),
            query_norm=meta.get("query_norm", False),
            device=device,
        )
        with np.load(p) as data:
            scorer.feat_mean = np.asarray(data["feat_mean"], np.float32)
            scorer.feat_std = np.asarray(data["feat_std"], np.float32)
            scorer.params = {
                k: torch.as_tensor(data[k], dtype=torch.float32, device=device)
                for k in data.files if k not in ("feat_mean", "feat_std")
            }
        scorer.best_iteration = meta.get("best_iteration", 0)
        return scorer
