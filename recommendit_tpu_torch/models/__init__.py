"""Models of the serve path (torch port): towers, MIPS index, ranker."""
import json
from pathlib import Path

from recommendit_tpu_torch.models.ranker import LambdaRankScorer
from recommendit_tpu_torch.models.retrieval import MIPSIndex
from recommendit_tpu_torch.models.two_tower import TwoTower

__all__ = ["LambdaRankScorer", "MIPSIndex", "TwoTower", "load_ranker"]


def load_ranker(path: str, device="cpu") -> LambdaRankScorer:
    """Load the ranker saved at ``path``, dispatching on its meta sidecar.
    Only the MLP LambdaRank ranker is ported; a GBDT checkpoint raises."""
    meta_path = Path(str(path) + ".meta.json")
    if not meta_path.exists():
        raise FileNotFoundError(f"Ranker meta not found: {meta_path}")
    meta = json.loads(meta_path.read_text())
    if "n_trees" in meta:
        raise NotImplementedError(
            "GBDT rankers are not ported yet (ROADMAP.md, queue A, "
            "models/gbdt.py device backend)")
    return LambdaRankScorer.load(path, device=device)
