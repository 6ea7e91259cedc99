"""Data of the torch port: MovieLens-format arrays, the synthetic generator
and the synthetic Criteo-style CTR log."""
from recommendit_tpu_torch.data.ctr import CTRDataset, make_ctr_dataset  # noqa: F401
