"""Core layers as plain functions on tensors (port of ``deepspeed_tpu/models/layers.py``).

Parameters are nested dicts of tensors keyed like the JAX package's pytree
(``{"kernel": [in, out], "bias": [out]}`` for a linear, used as
``x @ kernel``), so one set of weights means the same thing on both sides.
``ParamTree`` registers such a tree on an ``nn.Module``: ``state_dict()``
keys are then the JAX pytree paths with ``.`` for ``/``.

Numerics follow the JAX functions: norms compute in fp32 and cast back,
``gelu`` is the tanh approximation (``jax.nn.gelu``'s default), attention
logits and softmax are fp32, rotary angles are fp32 and the tables are cast
to the input dtype before rotating.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn


# ---------------------------------------------------------------------------------
# Parameter trees
# ---------------------------------------------------------------------------------
def tree_map(fn, tree):
    """Apply ``fn`` to every leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def flatten_tree(tree, prefix=""):
    """{"a/b/c": leaf} for a nested dict (the JAX pytree path of each leaf)."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flatten_tree(v, path))
        else:
            out[path] = v
    return out


def unflatten_tree(flat):
    tree = {}
    for path, leaf in flat.items():
        node = tree
        *parents, last = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf
    return tree


class ParamTree(nn.Module):
    """An ``nn.Module`` holding a nested dict of tensors as parameters:
    inference weights with ``requires_grad=False``, the training engine's
    fp32 masters with ``requires_grad=True``."""

    def set_tree(self, tree, requires_grad=False):
        for name in list(self._parameters):
            del self._parameters[name]
        for name in list(self._modules):
            del self._modules[name]
        for k, v in tree.items():
            if isinstance(v, dict):
                child = ParamTree()
                child.set_tree(v, requires_grad=requires_grad)
                self.add_module(k, child)
            else:
                self.register_parameter(k, nn.Parameter(v, requires_grad=requires_grad))

    def tree(self):
        out = {k: m.tree() for k, m in self._modules.items()}
        out.update(self._parameters)
        return out


# ---------------------------------------------------------------------------------
# Initializers (same distributions as the JAX package, drawn from a torch.Generator)
# ---------------------------------------------------------------------------------
def normal_init(gen, shape, stddev=0.02, dtype=torch.float32, device="cpu"):
    t = torch.empty(shape, dtype=dtype, device=device)
    if t.device.type != "meta":
        t.normal_(0.0, stddev, generator=gen)
    return t


def zeros_init(shape, dtype=torch.float32, device="cpu"):
    return torch.zeros(shape, dtype=dtype, device=device)


def ones_init(shape, dtype=torch.float32, device="cpu"):
    return torch.ones(shape, dtype=dtype, device=device)


def linear_init(gen, in_dim, out_dim, bias=True, stddev=0.02, lead=(), **kw):
    """``lead``: leading dims (the stacked layer axis of block params)."""
    p = {"kernel": normal_init(gen, (*lead, in_dim, out_dim), stddev, **kw)}
    if bias:
        p["bias"] = zeros_init((*lead, out_dim), **kw)
    return p


def embedding_init(gen, vocab_size, embed_dim, stddev=0.02, **kw):
    return {"weight": normal_init(gen, (vocab_size, embed_dim), stddev, **kw)}


def layernorm_init(dim, lead=(), **kw):
    return {"scale": ones_init((*lead, dim), **kw), "bias": zeros_init((*lead, dim), **kw)}


def rmsnorm_init(dim, lead=(), **kw):
    return {"scale": ones_init((*lead, dim), **kw)}


def attention_init(gen, embed_dim, n_heads, n_kv_heads=None, bias=True, stddev=0.02,
                   out_stddev=None, head_dim=None, lead=(), **kw):
    n_kv_heads = n_kv_heads or n_heads
    head_dim = head_dim or embed_dim // n_heads
    q_dim = n_heads * head_dim
    kv_dim = n_kv_heads * head_dim
    return {
        "q": linear_init(gen, embed_dim, q_dim, bias, stddev, lead, **kw),
        "k": linear_init(gen, embed_dim, kv_dim, bias, stddev, lead, **kw),
        "v": linear_init(gen, embed_dim, kv_dim, bias, stddev, lead, **kw),
        "o": linear_init(gen, q_dim, embed_dim, bias, out_stddev or stddev, lead, **kw),
    }


# ---------------------------------------------------------------------------------
# Linear / embedding / norms
# ---------------------------------------------------------------------------------
def linear_apply(p, x, compute_dtype=None):
    """``x @ kernel (+ bias)``. A weight-only quantized linear holds
    ``kernel_q`` (int8 [in, out], which also stores the 4-bit values of an
    odd in-dim) or ``kernel_q4`` (nibble-packed uint8 [in/2, out]) beside
    ``kernel_scale`` [groups, 1, out]: it goes through the dequant-matmul
    (the CUDA kernel on the card, whatever the token count; its plain
    version on the CPU) with the scale in x's dtype, and the bias is added
    after, in y's dtype."""
    if "kernel_q4" in p or "kernel_q" in p:
        from ..ops.cuda.quantized_matmul import quantized_matmul

        bits = 4 if "kernel_q4" in p else 8
        if compute_dtype is not None:
            x = x.to(compute_dtype)
        q = p["kernel_q4"] if bits == 4 else p["kernel_q"]
        y = quantized_matmul(x.reshape(-1, x.shape[-1]).contiguous(), q,
                             p["kernel_scale"].to(x.dtype), bits=bits)
        y = y.reshape(*x.shape[:-1], q.shape[-1])
        if "bias" in p:
            y = y + p["bias"].to(y.dtype)
        return y
    kernel = p["kernel"]
    if compute_dtype is not None:
        kernel = kernel.to(compute_dtype)
        x = x.to(compute_dtype)
    y = x @ kernel
    if "bias" in p:
        b = p["bias"].to(y.dtype) if compute_dtype is not None else p["bias"]
        y = y + b
    return y


def embedding_apply(p, ids, compute_dtype=None):
    w = p["weight"]
    if compute_dtype is not None:
        w = w.to(compute_dtype)
    return w[ids]


def embedding_attend(p, x):
    """Tied LM head: logits = x @ E^T."""
    return x @ p["weight"].to(x.dtype).T


def layernorm_apply(p, x, eps=1e-5):
    """LayerNorm in fp32 whatever the compute dtype, cast back."""
    dtype = x.dtype
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * p["scale"] + p["bias"]).to(dtype)


def rmsnorm_apply(p, x, eps=1e-6):
    dtype = x.dtype
    x32 = x.float()
    y = x32 * torch.rsqrt(x32.square().mean(dim=-1, keepdim=True) + eps)
    return (y * p["scale"]).to(dtype)


# ---------------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------------
ACTIVATIONS = {
    # jax.nn.gelu defaults to the tanh approximation: "gelu" is tanh here too
    # (torch's default is the exact erf form, "gelu_exact")
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "gelu_exact": lambda x: F.gelu(x, approximate="none"),
    "gelu_new": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
    "silu": F.silu,
    "quick_gelu": lambda x: x * torch.sigmoid(1.702 * x),
    "swiglu": None,  # handled structurally in the MLP
}


# ---------------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------------
def _repeat_kv(x, n_rep):
    if n_rep == 1:
        return x
    b, s, h, d = x.shape
    return x[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(b, s, h * n_rep, d)


def dot_product_attention(q, k, v, mask=None, scale=None, alibi_bias=None,
                          logits_dtype=None):
    """Plain attention: softmax(q k^T * scale) v with fp32 logits and softmax.
    q, k, v: [batch, seq, heads, head_dim].

    ``logits_dtype=torch.bfloat16`` keeps the [b, h, q, kv] logits/probs in
    bf16 with a max-subtracted exp and an fp32 normalization sum."""
    head_dim = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(head_dim)
    ldt = torch.float32 if logits_dtype is None else logits_dtype
    if ldt == torch.float32:
        # the JAX einsum accumulates into fp32 (preferred_element_type)
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    else:
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k).to(ldt)
    # the scale rounded to the logits dtype first, as jnp.asarray(scale, ldt)
    logits = logits * torch.tensor(scale, dtype=ldt).item()
    if alibi_bias is not None:
        logits = logits + alibi_bias.to(ldt)
    if mask is not None:
        logits = torch.where(mask, logits, torch.finfo(ldt).min)
    if ldt == torch.float32:
        probs = torch.softmax(logits, dim=-1)
    else:
        m = logits.amax(dim=-1, keepdim=True)
        e = torch.exp(logits - m)
        denom = e.float().sum(dim=-1, keepdim=True)
        probs = e * (1.0 / denom).to(ldt)
    probs = probs.to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def causal_mask(q_len, kv_len, device=None):
    """[1, 1, q, kv] lower-triangular bool mask aligned to the end of the kv window."""
    q_idx = torch.arange(q_len, device=device)[:, None]
    kv_idx = torch.arange(kv_len, device=device)[None, :]
    return (kv_idx <= q_idx + (kv_len - q_len))[None, None]


def rotary_embedding(positions, head_dim, base=10000.0):
    """RoPE cos/sin tables in fp32: [..., head_dim / 2]."""
    inv_freq = 1.0 / (base ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                            device=positions.device) / head_dim))
    angles = positions.float()[..., None] * inv_freq
    return torch.cos(angles), torch.sin(angles)


def apply_rotary(x, cos, sin, rotary_dim=None, interleaved=False):
    """x: [batch, seq, heads, head_dim]; cos/sin: [batch, seq, rd/2].

    ``rotary_dim``: rotate only the first rd dims of each head (partial
    rotary), pass the rest through. ``interleaved``: rotate (x0,x1),(x2,x3)
    pairs (GPT-J) instead of the half-split (x_i, x_{i+d/2}) pairs."""
    if rotary_dim is not None and rotary_dim < x.shape[-1]:
        x_rot, x_pass = x[..., :rotary_dim], x[..., rotary_dim:]
        return torch.cat([apply_rotary(x_rot, cos, sin, interleaved=interleaved), x_pass],
                         dim=-1)
    cos = cos[:, :, None, :].to(x.dtype)
    sin = sin[:, :, None, :].to(x.dtype)
    if interleaved:
        x1 = x[..., 0::2]
        x2 = x[..., 1::2]
        return torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).reshape(x.shape)
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def alibi_slopes(n_heads, device=None):
    def pow2slopes(n):
        start = 2.0 ** (-(2.0 ** -(math.log2(n) - 3)))
        return [start * (start ** i) for i in range(n)]

    if math.log2(n_heads).is_integer():
        slopes = pow2slopes(n_heads)
    else:
        closest = 2 ** math.floor(math.log2(n_heads))
        slopes = pow2slopes(closest) + pow2slopes(2 * closest)[0::2][: n_heads - closest]
    return torch.tensor(slopes, dtype=torch.float32, device=device)


def alibi_bias(n_heads, q_len, kv_len, device=None, q_start=None):
    """[1, heads, q, kv] fp32 additive bias for queries at the end of the kv
    window, or at ``[q_start, q_start + q_len)`` when given."""
    slopes = alibi_slopes(n_heads, device)
    start = (kv_len - q_len) if q_start is None else q_start
    kv_idx = torch.arange(kv_len, device=device)[None, :]
    q_idx = torch.arange(q_len, device=device)[:, None] + start
    dist = kv_idx - q_idx  # <= 0 within the causal window
    return (slopes[:, None, None] * dist[None, :, :])[None].float()
