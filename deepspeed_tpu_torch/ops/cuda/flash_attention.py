"""Flash-attention forward: the CUDA kernel's wrapper and its plain version.

``flash_attention_fwd`` is the port of the Pallas TPU forward kernels
(``deepspeed_tpu/ops/pallas/flash_attention.py``: ``_flash_fwd_single`` and
``_flash_fwd``) as one hand-written CUDA kernel,
``deepspeed_tpu_torch/csrc/flash_attention_fwd.cu``. Layout ``[b, s, h, d]``
in and out; k/v may carry fewer (GQA) heads than q; causal masking is aligned
to the bottom right (query i sees key j <= i + s_kv - s_q).

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU tensor
it computes ``flash_attention_reference``, the plain fp32 chunked
online-softmax math, which the tests hold against the TPU kernel and
``chip_smoke.py`` holds the CUDA kernel against on the card.
"""

import math

import torch

from . import LAUNCH_COUNTS

NEG_INF = -1e30

_KERNEL_DTYPES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
_KERNEL_HEAD_DIMS = (64, 128)


def _check_shapes(q, k, v, causal):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash attention takes [b, s, h, d] tensors")
    b, s_q, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k/v shape {tuple(k.shape)}/{tuple(v.shape)} does not match q {tuple(q.shape)}")
    if h % k.shape[2]:
        raise ValueError(f"q heads {h} are not a multiple of kv heads {k.shape[2]}")
    if causal and s_q > k.shape[1]:
        # bottom-right alignment needs s_q <= s_kv (the TPU kernel refuses too)
        raise ValueError(
            f"causal flash attention requires s_q <= s_kv, got s_q={s_q} "
            f"s_kv={k.shape[1]}")


def _repeat_kv(x, n_rep):
    if n_rep == 1:
        return x
    b, s, h, d = x.shape
    return x[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(b, s, h * n_rep, d)


def flash_attention_reference(q, k, v, causal=True, scale=None, block_size=512):
    """Plain version: fp32 online softmax over kv chunks of ``block_size``
    (one chunk when it does not divide s_kv), mirroring
    ``deepspeed_tpu/ops/flash_attention.py:_chunked_attention``."""
    _check_shapes(q, k, v, causal)
    b, s_q, h, d = q.shape
    s_kv = k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    n_rep = h // k.shape[2]
    k = _repeat_kv(k, n_rep)
    v = _repeat_kv(v, n_rep)
    block = min(block_size, s_kv)
    if s_kv % block:
        block = s_kv
    n_blocks = s_kv // block

    qf = (q.float() * scale).transpose(1, 2)  # [b, h, q, d]
    kf = k.float().transpose(1, 2)
    vf = v.float().transpose(1, 2)
    q_idx = torch.arange(s_q, device=q.device)[:, None] + (s_kv - s_q)

    m = torch.full((b, h, s_q), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, s_q), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, s_q, d), dtype=torch.float32, device=q.device)
    for blk in range(n_blocks):
        kb = kf[:, :, blk * block:(blk + 1) * block]
        vb = vf[:, :, blk * block:(blk + 1) * block]
        logits = torch.einsum("bhqd,bhkd->bhqk", qf, kb)
        if causal:
            kv_idx = blk * block + torch.arange(block, device=q.device)[None, :]
            logits = torch.where(kv_idx <= q_idx, logits, NEG_INF)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        p = torch.exp(logits - m_new[..., None])
        correction = torch.exp(m - m_new)
        l = l * correction + p.sum(dim=-1)
        acc = acc * correction[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, vb)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)


_UNIT_ROUNDOFF = {torch.bfloat16: 2.0 ** -8, torch.float16: 2.0 ** -11}


def rounding_bound(q, k, v, ref, causal=True, scale=None):
    """Per-element bound on |kernel - plain| that rounding to q's 16-bit
    dtype explains, or None for fp32 inputs. The kernel rounds P to that
    dtype before P.V, an error of at most u * sum_j p_j |v_j| / l (u the
    dtype's unit roundoff), and rounds its output; ``ref``, the plain
    version's output, is rounded too: at most u |o| each."""
    u = _UNIT_ROUNDOFF.get(q.dtype)
    if u is None:
        return None
    weighted_abs_v = flash_attention_reference(q.float(), k.float(), v.float().abs(),
                                               causal=causal, scale=scale)
    return u * (weighted_abs_v + 2 * ref.float().abs())


def _check_kernel_inputs(q, k, v):
    if not (k.device == q.device and v.device == q.device):
        raise ValueError(f"q/k/v on different devices: {q.device}, {k.device}, {v.device}")
    if q.dtype not in _KERNEL_DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash kernel takes fp32/fp16/bf16 q, k, v of one dtype; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.shape[3] not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"flash kernel supports head_dim {_KERNEL_HEAD_DIMS}, got {q.shape[3]}")
    vec = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"flash kernel needs a contiguous last dim; {name} strides {t.stride()}")
        # rows are copied 16 bytes at a time
        if t.data_ptr() % 16 or any(s % vec for s in t.stride()[:3]):
            raise ValueError(f"flash kernel needs 16-byte aligned rows; {name} strides "
                             f"{t.stride()} at offset {t.data_ptr() % 16}")
    if (torch.is_grad_enabled()
            and (q.requires_grad or k.requires_grad or v.requires_grad)):
        raise NotImplementedError(
            "the flash kernel is forward-only; its backward is ROADMAP.md A.6")


def flash_attention_fwd(q, k, v, causal=True, scale=None, block_size=512):
    """softmax(scale q k^T) v for ``[b, s, h, d]`` tensors.

    CPU tensors take ``flash_attention_reference`` (kv chunks of
    ``block_size``; the kernel's tiles are fixed). CUDA tensors launch the
    kernel on the current stream (no synchronisation) or raise on what it
    does not take: dtypes other than fp32/fp16/bf16, head_dim outside
    {64, 128}, a non-contiguous last dim or rows not 16-byte aligned."""
    _check_shapes(q, k, v, causal)
    if q.device.type == "cpu" and k.device.type == "cpu" and v.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal=causal, scale=scale,
                                         block_size=block_size)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on CUDA or CPU tensors, got {q.device}")
    _check_kernel_inputs(q, k, v)
    b, s_q, h, d = q.shape
    s_kv, kvh = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    out = torch.empty((b, s_q, h, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    from ..op_builder import load_op

    lib = load_op("flash_attention_fwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.ds_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _KERNEL_DTYPES[q.dtype], b, h, kvh, s_q, s_kv, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
            float(scale), int(bool(causal)), stream)
    if err:
        raise RuntimeError(f"flash_attention_fwd launch failed: cudaError_t {err}")
    LAUNCH_COUNTS["flash_attention_fwd"] += 1
    return out
