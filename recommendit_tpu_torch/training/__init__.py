"""Training stages of the torch port: the two-tower trainer (in-HBM and
host-table), the index builder and the ranker trainer."""
from recommendit_tpu_torch.training.build_index import IndexBuilder
from recommendit_tpu_torch.training.host_table import (
    HostEmbeddingTable,
    PrefetchIterator,
    make_host_offload_step,
    prefetch_to_device,
)
from recommendit_tpu_torch.training.train_embeddings import EmbeddingTrainer
from recommendit_tpu_torch.training.train_ranker import RankerTrainer

__all__ = ["EmbeddingTrainer", "HostEmbeddingTable", "IndexBuilder",
           "PrefetchIterator", "RankerTrainer", "make_host_offload_step",
           "prefetch_to_device"]
