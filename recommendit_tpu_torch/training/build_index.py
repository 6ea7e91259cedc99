"""Index building stage — torch port.

Counterpart of ``recommendit_tpu/training/build_index.py::IndexBuilder``:
embed the catalog with the trained towers (or take a host-table run's
streamed catalog), scale the learned item bias by the softmax temperature
(so the MIPS score q·e + T·b is monotone in the training logit cos/T + b),
build the port's :class:`MIPSIndex` and save it in the JAX npz +
``.meta.json`` format.
"""
from __future__ import annotations

import logging
from typing import Optional

import numpy as np

from recommendit_tpu_torch.config import Settings, settings as default_settings
from recommendit_tpu_torch.data.movielens import MovieLensData
from recommendit_tpu_torch.models.retrieval import MIPSIndex
from recommendit_tpu_torch.models.two_tower import TwoTower
from recommendit_tpu_torch.training.train_embeddings import build_genre_table
from recommendit_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

logger = logging.getLogger(__name__)

class IndexBuilder:
    def __init__(self, data: MovieLensData, cfg: Optional[Settings] = None,
                 model_path: Optional[str] = None,
                 index_output_path: Optional[str] = None,
                 device=DEFAULT_DEVICE):
        self.cfg = cfg or default_settings
        self.data = data
        self.model_path = model_path or self.cfg.EMBEDDING_MODEL_PATH
        self.index_output_path = index_output_path or self.cfg.INDEX_PATH
        self.device = resolve_device(device)

    def build(self, model: Optional[TwoTower] = None,
              embeddings: Optional[np.ndarray] = None,
              bias: Optional[np.ndarray] = None) -> MIPSIndex:
        """Build and save the index, from ``model`` (loaded from
        ``model_path`` when not given) or, for a host-table run with no
        in-HBM model, from the streamed catalog ``embeddings`` (1-based item
        order, ``HostTableEmbeddingTrainer.embed_catalog``) and an optional
        raw (n_items,) ``bias`` (before the temperature). A bias-free model
        (the in-batch and pairwise modes) gives an index without the bias
        column."""
        if embeddings is None:
            if model is None:
                model = TwoTower.load(self.model_path, device=self.device)
            n_items = model.n_items
            genre_table = build_genre_table(self.data.item_ids, self.data.genres,
                                            n_items)
            item_ids = np.arange(1, n_items + 1, dtype=np.int64)
            embs = model.get_item_embeddings(item_ids, genre_table[1:],
                                             batch_size=8192)
            embed_dim = model.embed_dim
            raw_bias = model.item_bias_np(item_ids)
        else:
            embs = np.asarray(embeddings, np.float32)
            item_ids = np.arange(1, len(embs) + 1, dtype=np.int64)
            embed_dim = embs.shape[1]
            raw_bias = (np.asarray(bias, np.float32) if bias is not None
                        else np.zeros(len(embs), np.float32))
        norms = np.linalg.norm(embs, axis=1)
        logger.info("Catalog embedded: %d items, norm mean=%.4f min=%.4f "
                    "max=%.4f", len(item_ids), norms.mean(), norms.min(),
                    norms.max())

        cfg = self.cfg
        index = MIPSIndex(embedding_dim=embed_dim,
                          block_size=cfg.RETRIEVAL_BLOCK_ITEMS,
                          mode=cfg.INDEX_MODE, dtype=cfg.INDEX_DTYPE,
                          quant_seed=cfg.SEED, device=self.device)
        scaled = cfg.SOFTMAX_TEMPERATURE * raw_bias
        if not np.any(scaled):
            scaled = None
        index.build(embs, item_ids, bias=scaled)
        index.save(self.index_output_path)
        return index
