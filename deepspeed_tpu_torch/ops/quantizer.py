"""Groupwise quantization ops (port of ``deepspeed_tpu/ops/quantizer.py``).

Symmetric groupwise int8/int4 (de)quantization on tensors. The rounding is
bitwise the JAX package's: both frameworks divide in fp32 and round half to
even (``torch.round`` as ``jnp.round``), a zero scale divides by 1, and the
result is clipped to [-qmax - 1, qmax]. The weight-only serving path uses
``quantize_per_channel`` (``inference/engine.py _quantize_weights``) and
``pack_int4``; ``ops/cuda/quantized_matmul.py`` reads what they produce.
"""

import torch


def _group_reshape(x, group_size):
    flat = x.reshape(-1)
    n = flat.shape[0]
    if group_size <= 0 or n % group_size:
        # a group size that does not divide the tensor: one group
        group_size = n
    return flat.reshape(n // group_size, group_size), x.shape, group_size


def quantize(x, bits=8, group_size=64):
    """Symmetric groupwise quantization of the flattened tensor.

    Returns (q int8, scale fp32 [groups, 1], meta) with
    ``dequantize(q, scale, meta)`` restoring the original shape."""
    grouped, shape, group_size = _group_reshape(torch.as_tensor(x).float(), group_size)
    qmax = float(2 ** (bits - 1) - 1)
    absmax = grouped.abs().amax(dim=1, keepdim=True)
    scale = absmax / qmax
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(grouped / safe), -qmax - 1, qmax).to(torch.int8)
    meta = {"shape": tuple(shape), "bits": bits, "group_size": group_size}
    return q, scale.float(), meta


def dequantize(q, scale, meta):
    return (q.float() * scale).reshape(meta["shape"])


class _FakeQuantize(torch.autograd.Function):
    """Quantize-dequantize forward, straight-through (identity) gradient."""

    @staticmethod
    def forward(ctx, x, bits, group_size):
        q, scale, meta = quantize(x, bits=bits, group_size=group_size)
        return dequantize(q, scale, meta).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def fake_quantize(x, bits=8, group_size=64):
    """Quantize-dequantize in one op (the training-time MoQ forward), with a
    straight-through estimator for the gradient."""
    return _FakeQuantize.apply(x, bits, group_size)


def quantization_error(x, bits=8, group_size=64):
    """Mean squared quantization error."""
    q, scale, meta = quantize(x, bits=bits, group_size=group_size)
    return ((dequantize(q, scale, meta) - torch.as_tensor(x).float()) ** 2).mean()


def quantize_per_channel(w, bits=8, group_size=0):
    """Weight-only serving quantization: symmetric per-output-channel, sub-
    grouped along the input dim.

    w: [..., in, out] -> (q int8 same shape, scale fp32 [..., groups, 1, out]).
    ``group_size``: granularity along the in-dim; 0, >= in, or a size that
    does not divide in means one group (plain per-channel)."""
    in_dim = w.shape[-2]
    if group_size <= 0 or group_size >= in_dim or in_dim % group_size:
        group_size = in_dim
    groups = in_dim // group_size
    lead = tuple(w.shape[:-2])
    wg = w.float().reshape(lead + (groups, group_size, w.shape[-1]))
    qmax = float(2 ** (bits - 1) - 1)
    absmax = wg.abs().amax(dim=-2, keepdim=True)
    scale = absmax / qmax
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(wg / safe), -qmax - 1, qmax).to(torch.int8)
    return q.reshape(w.shape), scale.float()


def dequantize_per_channel(q, scale, dtype):
    """Inverse of ``quantize_per_channel`` in the consuming dtype (payload
    and scale cast to ``dtype`` first, the product in ``dtype``)."""
    groups = scale.shape[-3]
    lead = tuple(q.shape[:-2])
    in_dim, out = q.shape[-2], q.shape[-1]
    qg = q.to(dtype).reshape(lead + (groups, in_dim // groups, out))
    return (qg * scale.to(dtype)).reshape(q.shape)


def pack_int4(q):
    """int4 values (int8 storage in [-8, 7], [..., in, out], even in-dim) ->
    one uint8 per PAIR of in-dim rows ([..., in/2, out]): packed row p holds
    row 2p in its low nibble and row 2p+1 in its high nibble, each + 8."""
    if q.shape[-2] % 2:
        raise ValueError(f"int4 packing needs an even in-dim, got {tuple(q.shape)}")
    u = (q.to(torch.int16) + 8).to(torch.uint8)    # [0, 15]
    lo = u[..., 0::2, :]
    hi = u[..., 1::2, :]
    return (hi << 4) | lo


def unpack_int4(packed):
    """[..., in/2, out] uint8 -> int4-valued int8 [..., in, out]."""
    lo = (packed & 0xF).to(torch.int8) - 8
    hi = (packed >> 4).to(torch.int8) - 8
    pairs = torch.stack([lo, hi], dim=-2)            # [..., in/2, 2, out]
    return pairs.reshape(tuple(packed.shape[:-2]) + (packed.shape[-2] * 2, packed.shape[-1]))
