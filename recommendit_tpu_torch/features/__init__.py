"""Feature contract and online store (torch port)."""
from recommendit_tpu_torch.features.engineering import FeatureEngineer  # noqa: F401
from recommendit_tpu_torch.features.schema import (  # noqa: F401
    FEATURE_COLUMNS,
    GENRE_TO_IDX,
    GENRES,
    N_FEATURES,
    N_GENRES,
    feature_columns,
)
from recommendit_tpu_torch.features.store import FeatureStore, RedisFeatureStore  # noqa: F401
