"""Data of the torch port: MovieLens-format arrays and the ML-1M download,
the synthetic generator and the synthetic Criteo-style CTR log."""
from recommendit_tpu_torch.data.ctr import CTRDataset, make_ctr_dataset  # noqa: F401
from recommendit_tpu_torch.data.movielens import (  # noqa: F401
    MovieLensData,
    download_movielens,
    load_movielens,
    verify_dataset,
)
from recommendit_tpu_torch.data.synthetic import make_synthetic_movielens  # noqa: F401
