"""Memory-efficient attention dispatch (port of ``deepspeed_tpu/ops/flash_attention.py``).

``flash_attention`` is online-softmax attention that never materializes the
[batch, heads, q, kv] score matrix: on CUDA tensors the hand-written kernel
(``ops/cuda/flash_attention.py``), on CPU tensors its plain chunked version.
The JAX dispatch also gates its TPU kernel on 128-aligned lengths, a TPU
tiling rule; the CUDA kernel masks any length, so there is no such gate.

Inputs q: [batch, seq, heads, head_dim], k/v: [batch, seq, kv_heads,
head_dim] (kv_heads dividing heads); returns q's layout and dtype.
"""

from .cuda.flash_attention import flash_attention_fwd


def flash_attention(q, k, v, causal=True, scale=None, block_size=512):
    """Flash attention forward. ``block_size`` is the kv chunk of the plain
    version, which CPU tensors take; the CUDA kernel's tiles are fixed."""
    return flash_attention_fwd(q, k, v, causal=causal, scale=scale, block_size=block_size)
