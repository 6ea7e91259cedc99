"""The multi-device layer of the torch port — counterpart of
``recommendit_tpu.parallel``, on ``torch.distributed`` with one process a
rank (NCCL on the card, gloo on the CPU). Importing it starts nothing."""
from recommendit_tpu_torch.parallel.embedding import (  # noqa: F401
    bucketed_embedding_lookup,
    sharded_dual_lookup,
    sharded_embedding_lookup,
)
from recommendit_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    AdamW,
    batch_sharded,
    create_mesh,
    distributed_init,
    pad_to_multiple,
    params_shardings,
    replicated,
    row_sharded,
)
from recommendit_tpu_torch.parallel.retrieval import (  # noqa: F401
    sharded_mips_topk,
    sharded_mips_topk_ring,
)
from recommendit_tpu_torch.parallel.train import (  # noqa: F401
    init_sharded_state,
    make_sharded_train_step,
    shard_params,
)
from recommendit_tpu_torch.parallel.serve import make_sharded_serve_fn  # noqa: F401,E402
from recommendit_tpu_torch.parallel.ctr import (  # noqa: F401
    init_ctr_sharded_state,
    make_ctr_sharded_train_step,
    shard_ctr_params,
)
