"""Models of the torch port: towers, MIPS index, rankers, the CTR model."""
import json
from pathlib import Path
from typing import Union

from recommendit_tpu_torch.models.ctr import CTRModel
from recommendit_tpu_torch.models.gbdt import HistGBDTRanker
from recommendit_tpu_torch.models.ranker import LambdaRankScorer
from recommendit_tpu_torch.models.retrieval import MIPSIndex
from recommendit_tpu_torch.models.two_tower import (
    TwoTower,
    init_params,
    item_tower,
    l2_normalize,
    user_tower,
)
from recommendit_tpu_torch.utils.device import DEFAULT_DEVICE

__all__ = ["CTRModel", "HistGBDTRanker", "LambdaRankScorer", "MIPSIndex", "TwoTower",
           "init_params", "item_tower", "l2_normalize", "load_ranker", "user_tower"]


def load_ranker(path: str, device=DEFAULT_DEVICE) -> Union[LambdaRankScorer,
                                                           HistGBDTRanker]:
    """Load the ranker saved at ``path`` (the MLP LambdaRank scorer or the
    histogram GBDT), dispatching on its meta sidecar as JAX's does: a GBDT
    meta holds ``n_trees``."""
    meta_path = Path(str(path) + ".meta.json")
    if not meta_path.exists():
        raise FileNotFoundError(f"Ranker meta not found: {meta_path}")
    meta = json.loads(meta_path.read_text())
    if "n_trees" in meta:
        return HistGBDTRanker.load(path, device=device)
    return LambdaRankScorer.load(path, device=device)
