"""Blockwise int8 quantizers (port of three functions of
``deepspeed_tpu/comm/collectives.py``: ``_effective_block``,
``quantize_blockwise``, ``dequantize_blockwise``).

They are the int8 paged KV pool's quantizer: with ``block = head_dim`` one
fp32 scale per (token, head) (``models/decoding.py``). The rounding is
bitwise the JAX package's: an fp32 divide by ``max(scale, 1e-30)``, round
half to even, clip to [-127, 127]. The collectives of that module (the
quantized gathers and reductions of ZeRO++ and 1-bit Adam) are ROADMAP A.7.
"""

import torch


def _effective_block(n, block):
    """``block`` when it divides n, else the whole row (one scale)."""
    return block if (block > 0 and n % block == 0) else n


def quantize_blockwise(x, block=256):
    """Symmetric int8 with per-block fp32 scales along the last axis:
    ``x [..., n] -> (q int8 [..., n], scale fp32 [..., n // b])``, ``b`` =
    ``block`` or ``n`` when ``block`` does not divide ``n``."""
    n = x.shape[-1]
    b = _effective_block(n, block)
    g = x.reshape(*x.shape[:-1], n // b, b).float()
    scale = g.abs().amax(dim=-1, keepdim=True) / 127.0
    safe = torch.clamp(scale, min=1e-30)
    q = torch.clamp(torch.round(g / safe), -127, 127).to(torch.int8)
    return q.reshape(x.shape), scale[..., 0]


def dequantize_blockwise(q, scale, dtype=torch.float32):
    """Inverse of ``quantize_blockwise`` (the block size from the shapes):
    the fp32 product, then ``dtype``."""
    n = q.shape[-1]
    blocks = scale.shape[-1]
    g = q.reshape(*q.shape[:-1], blocks, n // blocks).float()
    return (g * scale[..., None]).reshape(q.shape).to(dtype)
