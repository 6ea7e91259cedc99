"""Retrieval, top-k, loss, quantization and gather ops (torch port, with
Hopper kernels).

The counterparts of ``recommendit_tpu.ops``'s exports that the port has,
under the port's names where they differ (``quantize_int8`` is
``quantize_int8_jnp``, ``quantize_int8_hash`` is ``quantize_int8_pallas``),
plus the row gather of ``recommendit_tpu.ops.gather`` and the CTR table's
sparse row-adagrad update of ``recommendit_tpu.ops.sparse_embed``. Importing this
package compiles nothing: each kernel is built on its first launch.
"""
from recommendit_tpu_torch.ops.bpr import (  # noqa: F401
    in_batch_bpr_loss,
    in_batch_softmax_loss,
    pairwise_bpr_loss,
)
from recommendit_tpu_torch.ops.gather import gather_rows, take_rows  # noqa: F401
from recommendit_tpu_torch.ops.mips_fold import mips_topk_fused  # noqa: F401
from recommendit_tpu_torch.ops.quantize import (  # noqa: F401
    dequantize_int8,
    quantize_int8,
    quantize_int8_hash,
)
from recommendit_tpu_torch.ops.sparse_embed import (  # noqa: F401
    sparse_adagrad_init,
    sparse_table_update,
)
from recommendit_tpu_torch.ops.topk import (  # noqa: F401
    fast_topk,
    mips_topk,
    mips_topk_bound_verified,
    mips_topk_certified,
    mips_topk_dense,
    mips_topk_int8,
    mips_topk_numpy,
    mips_topk_verified,
)
