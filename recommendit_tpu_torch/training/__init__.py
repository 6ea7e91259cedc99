"""Training stages of the torch port: the two-tower trainer, the index
builder and the ranker trainer."""
from recommendit_tpu_torch.training.build_index import IndexBuilder
from recommendit_tpu_torch.training.train_embeddings import EmbeddingTrainer
from recommendit_tpu_torch.training.train_ranker import RankerTrainer

__all__ = ["EmbeddingTrainer", "IndexBuilder", "RankerTrainer"]
