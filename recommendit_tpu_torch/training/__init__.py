"""Training stages of the torch port: the two-tower trainer and the index
builder."""
from recommendit_tpu_torch.training.build_index import IndexBuilder
from recommendit_tpu_torch.training.train_embeddings import EmbeddingTrainer

__all__ = ["EmbeddingTrainer", "IndexBuilder"]
