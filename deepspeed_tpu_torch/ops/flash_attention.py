"""Memory-efficient attention dispatch (port of ``deepspeed_tpu/ops/flash_attention.py``).

``flash_attention`` is online-softmax attention that never materializes the
[batch, heads, q, kv] score matrix: on CUDA tensors the hand-written kernels
(``ops/cuda/flash_attention.py``), on CPU tensors their plain chunked
versions. With grad on it runs through ``FlashAttention``, whose forward
saves (q, k, v, o, lse) and whose backward is the flash backward kernel, as
the JAX package's ``pallas_flash_attention`` custom vjp does. The JAX
dispatch also gates its TPU kernel on 128-aligned lengths, a TPU tiling rule;
the CUDA kernels mask any length, so there is no such gate.

Inputs q: [batch, seq, heads, head_dim], k/v: [batch, seq, kv_heads,
head_dim] (kv_heads dividing heads); returns q's layout and dtype.
"""

import torch

from .cuda.flash_attention import flash_attention_bwd, flash_attention_fwd


class FlashAttention(torch.autograd.Function):
    """Flash attention with the flash backward as its gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, block_size):
        out, lse = flash_attention_fwd(q, k, v, causal=causal, scale=scale,
                                       block_size=block_size, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale, ctx.block_size = causal, scale, block_size
        return out

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, grad_out.contiguous(),
                                         causal=ctx.causal, scale=ctx.scale,
                                         block_size=ctx.block_size)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, causal=True, scale=None, block_size=512):
    """Flash attention. ``block_size`` is the kv chunk of the plain versions,
    which CPU tensors take; the CUDA kernels' tiles are fixed."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, scale, block_size)
    return flash_attention_fwd(q, k, v, causal=causal, scale=scale, block_size=block_size)
