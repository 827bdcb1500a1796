"""Block-sparse attention (port of ``deepspeed_tpu/ops/sparse_attention/``):
pattern configs + ``BlockSparseAttention`` over the CUDA kernels."""

from .sparsity_config import (  # noqa: F401
    SparsityConfig,
    DenseSparsityConfig,
    FixedSparsityConfig,
    BigBirdSparsityConfig,
    BSLongformerSparsityConfig,
    VariableSparsityConfig,
)
from .block_sparse_attention import BlockSparseAttention  # noqa: F401

# ``TransformerConfig.sparse_pattern`` names
PATTERNS = {
    "dense": DenseSparsityConfig,
    "fixed": FixedSparsityConfig,
    "bigbird": BigBirdSparsityConfig,
    "bslongformer": BSLongformerSparsityConfig,
    "variable": VariableSparsityConfig,
}
