"""Flash attention, forward and backward: the CUDA kernels' wrappers and their plain versions.

``flash_attention_fwd`` is the port of the Pallas TPU forward kernels
(``deepspeed_tpu/ops/pallas/flash_attention.py``: ``_flash_fwd_single`` and
``_flash_fwd``) as hand-written CUDA in
``deepspeed_tpu_torch/csrc/flash_attention_fwd.cu``; with ``return_lse`` it
also returns the per-row ``lse = m + log(l)`` the backward needs.
``flash_attention_bwd`` is the port of the TPU backward (``_flash_bwd``: the
dQ kernels ``_dq_kernel_single``/``_dq_kernel`` and the dK/dV kernels
``_dkv_kernel_single``/``_dkv_kernel``) as
``deepspeed_tpu_torch/csrc/flash_attention_bwd.cu``. Layout ``[b, s, h, d]``
in and out; k/v may carry fewer (GQA) heads than q; causal masking is aligned
to the bottom right (query i sees key j <= i + s_kv - s_q).

Each source has two routes, fixed by ``attention_route(dtype, head_dim)``
before the launch: ``wgmma`` (bf16 and fp16 at head_dim 64 and 128, the
widths of every main path: TMA loads through an mbarrier ring, wgmma, the
softmax and every accumulator in registers) and ``wmma`` (everything else
the kernels take: fp32, and 16-bit at head_dim 32, 80, 96 and 256; warp-level
wmma or fp32 FMAs through shared memory). A failed build or launch of either
raises; neither falls back to the other.

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU tensor
it computes the plain version (``flash_attention_reference``,
``flash_attention_bwd_reference``: fp32 chunked math of the same recurrence),
which the tests hold against the TPU kernels and ``chip_smoke.py`` holds the
CUDA kernels against on the card.
"""

import ctypes
import math

import torch

from . import LAUNCH_COUNTS, resolve_route

NEG_INF = -1e30

_KERNEL_DTYPES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
# every head_dim of the model registry's presets (each a multiple of 16)
_KERNEL_HEAD_DIMS = (32, 64, 80, 96, 128, 256)


# the routes: the TMA + wgmma kernels take 16-bit types at these head dims
_WGMMA_DTYPES = (torch.bfloat16, torch.float16)
_WGMMA_HEAD_DIMS = (64, 128)
_WGMMA_BWD_PAD = 128    # the wgmma backward's lse/delta rows: s_q rounded up to this


def attention_route(dtype, head_dim):
    """The route the flash kernels take for ``dtype`` and ``head_dim``: a
    pure function of the two, decided before the launch. ``"wgmma"`` for
    bf16/fp16 at head_dim 64 and 128, ``"wmma"`` for every other dtype and
    head_dim the kernels take; None where no route does."""
    if dtype not in _KERNEL_DTYPES or head_dim not in _KERNEL_HEAD_DIMS:
        return None
    if dtype in _WGMMA_DTYPES and head_dim in _WGMMA_HEAD_DIMS:
        return "wgmma"
    return "wmma"


def _pick_route(q, route):
    """``attention_route`` for q, or the route ``route`` forces
    (``resolve_route``)."""
    return resolve_route("flash attention", attention_route(q.dtype, q.shape[3]), route,
                         f"{q.dtype} at head_dim {q.shape[3]}")


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


def flash_attention_reference(q, k, v, causal=True, scale=None, block_size=512,
                              return_lse=False):
    """Plain version: fp32 online softmax over kv chunks of ``block_size``
    (one chunk when it does not divide s_kv), mirroring
    ``deepspeed_tpu/ops/flash_attention.py:_chunked_attention``. With
    ``return_lse`` also the fp32 ``[b, h, s_q]`` row logsumexp."""
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
    l = torch.clamp(l, min=1e-30)
    out = (acc / l[..., None]).transpose(1, 2).to(q.dtype)
    if return_lse:
        return out, m + torch.log(l)
    return out


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


def _on_cpu(*tensors):
    return all(t.device.type == "cpu" for t in tensors)


def flash_attention_fwd(q, k, v, causal=True, scale=None, block_size=512, return_lse=False,
                        _route=None):
    """softmax(scale q k^T) v for ``[b, s, h, d]`` tensors (and, with
    ``return_lse``, the fp32 ``[b, h, s_q]`` row logsumexp).

    CPU tensors take ``flash_attention_reference`` (kv chunks of
    ``block_size``; the kernel's tiles are fixed). CUDA tensors launch the
    kernel of ``attention_route`` on the current stream (no synchronisation)
    or raise on what it does not take: dtypes other than fp32/fp16/bf16,
    head_dim outside ``_KERNEL_HEAD_DIMS`` (32, 64, 80, 96, 128, 256), a
    non-contiguous last dim or rows not 16-byte aligned. ``_route`` forces a
    route, for timing one against the other (``_pick_route``)."""
    _check_shapes(q, k, v, causal)
    route = _pick_route(q, _route)
    if _on_cpu(q, k, v):
        return flash_attention_reference(q, k, v, causal=causal, scale=scale,
                                         block_size=block_size, return_lse=return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on CUDA or CPU tensors, got {q.device}")
    _check_kernel_inputs(q, k, v)
    b, s_q, h, d = q.shape
    s_kv, kvh = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    out = torch.empty((b, s_q, h, d), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, h, s_q), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if out.numel() == 0:
        return (out, lse) if return_lse else out
    from ..op_builder import load_op

    lib = load_op("flash_attention_fwd")
    entry = lib.ds_flash_attention_fwd_wgmma if route == "wgmma" else lib.ds_flash_attention_fwd
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = entry(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _KERNEL_DTYPES[q.dtype], b, h, kvh, s_q, s_kv, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
            float(scale), int(bool(causal)), lse.data_ptr() if return_lse else None, stream)
    if err:
        raise RuntimeError(f"flash_attention_fwd launch failed ({route} route): cudaError_t {err}")
    LAUNCH_COUNTS["flash_attention_fwd"] += 1
    if route == "wgmma":
        LAUNCH_COUNTS["flash_attention_fwd_wgmma"] += 1
    return (out, lse) if return_lse else out


# ---------------------------------------------------------------------------------
# backward
# ---------------------------------------------------------------------------------
def _bwd_sums(q, k, v, o, lse, do, causal, scale, block_size, absolute):
    """The FA2 backward recurrence in fp32 over kv chunks of ``block_size``:
    P = exp(scale q.k - lse) recomputed, delta = rowsum(dO * O),
    dS = P (dP - delta) scale; dV = P^T dO, dK = dS^T Q, dQ = dS K, on q's
    heads, then summed over each kv head's query heads (GQA). With
    ``absolute`` the same sums of |terms| (P |dO|, |dS| |Q|, |dS| |K|), which
    size the kernel's rounding error."""
    b, s_q, h, d = q.shape
    s_kv = k.shape[1]
    n_rep = h // k.shape[2]
    f = lambda t: t.float().transpose(1, 2)  # [b, h, s, d]
    qf, kf, vf, dof = f(q), f(_repeat_kv(k, n_rep)), f(_repeat_kv(v, n_rep)), f(do)
    delta = (o.float() * do.float()).sum(-1).transpose(1, 2)  # [b, h, s_q]
    # the right-hand factors of dQ, dK, dV (their magnitudes for the bound)
    rq, rk, rdo = (qf.abs(), kf.abs(), dof.abs()) if absolute else (qf, kf, dof)
    q_idx = torch.arange(s_q, device=q.device)[:, None] + (s_kv - s_q)
    dq, dk, dv = torch.zeros_like(qf), torch.zeros_like(kf), torch.zeros_like(vf)
    for c0 in range(0, s_kv, min(block_size, s_kv)):
        sl = slice(c0, min(c0 + block_size, s_kv))
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kf[:, :, sl]) * scale
        p = torch.exp(s - lse[..., None])
        if causal:
            kv_idx = torch.arange(sl.start, sl.stop, device=q.device)[None, :]
            p = torch.where(kv_idx <= q_idx, p, 0.0)
        dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf[:, :, sl])
        ds = p * (dp - delta[..., None]) * scale
        if absolute:
            ds = ds.abs()
        dv[:, :, sl] = torch.einsum("bhqk,bhqd->bhkd", p, rdo)
        dk[:, :, sl] = torch.einsum("bhqk,bhqd->bhkd", ds, rq)
        dq += torch.einsum("bhqk,bhkd->bhqd", ds, rk[:, :, sl])
    fold = lambda t: t.reshape(b, h // n_rep, n_rep, s_kv, d).sum(2)
    return dq.transpose(1, 2), fold(dk).transpose(1, 2), fold(dv).transpose(1, 2)


def flash_attention_bwd_reference(q, k, v, o, lse, do, causal=True, scale=None,
                                  block_size=512):
    """Plain version of the backward: ``_bwd_sums`` in fp32, each gradient
    rounded once to its input's dtype. ``lse`` is the forward's fp32
    ``[b, h, s_q]``; returns (dq, dk, dv) in q's, k's and v's layouts."""
    _check_shapes(q, k, v, causal)
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[3])
    dq, dk, dv = _bwd_sums(q, k, v, o, lse.float(), do, causal, scale, block_size, False)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def bwd_rounding_bound(q, k, v, o, lse, do, refs, causal=True, scale=None):
    """Per-element bounds on |kernel - plain| for (dq, dk, dv) that rounding
    to q's 16-bit dtype explains, or None for fp32 inputs. The kernel rounds
    P to the dtype before P^T dO (at most u sum_i P |dO|) and dS before dS^T Q
    and dS K (u sum |dS| |Q|, u sum |dS| |K|); both sides round each output
    (u |g| each, ``refs`` being the plain version's outputs)."""
    u = _UNIT_ROUNDOFF.get(q.dtype)
    if u is None:
        return None
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[3])
    sums = _bwd_sums(q, k, v, o, lse.float(), do, causal, scale, 512, True)
    return tuple(u * (s + 2 * r.float().abs()) for s, r in zip(sums, refs))


def _check_bwd_inputs(q, k, v, o, lse, do):
    _check_kernel_inputs(q, k, v)
    b, s_q, h, d = q.shape
    for name, t in (("o", o), ("do", do)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"flash backward: {name} {tuple(t.shape)} {t.dtype} on {t.device} "
                             f"does not match q {tuple(q.shape)} {q.dtype}")
    _check_kernel_inputs(o, do, do)
    if (lse.dtype != torch.float32 or tuple(lse.shape) != (b, h, s_q)
            or not lse.is_contiguous() or lse.device != q.device):
        raise ValueError(f"flash backward needs a contiguous fp32 lse of shape {(b, h, s_q)} "
                         f"on {q.device}; got {lse.dtype} {tuple(lse.shape)}")


def flash_attention_bwd(q, k, v, o, lse, do, causal=True, scale=None, block_size=512,
                        _route=None):
    """(dq, dk, dv) of ``o = flash_attention_fwd(q, k, v)`` for the upstream
    gradient ``do``, from the forward's ``lse``; dk and dv have k's (kv) heads.

    CPU tensors take ``flash_attention_bwd_reference``. CUDA tensors launch
    the kernels of ``attention_route`` (a delta pass, the dQ kernel and the
    dK/dV kernel, counted as one launch) on the current stream, or raise on
    what they do not take: the forward's restrictions, o/do unlike q, or a
    missing lse. ``_route`` forces a route, as in ``flash_attention_fwd``."""
    _check_shapes(q, k, v, causal)
    route = _pick_route(q, _route)
    if lse is None:
        raise ValueError("flash backward needs the forward's lse (flash_attention_fwd(..., "
                         "return_lse=True))")
    if _on_cpu(q, k, v, o, do, lse):
        return flash_attention_bwd_reference(q, k, v, o, lse, do, causal=causal, scale=scale,
                                             block_size=block_size)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on CUDA or CPU tensors, got {q.device}")
    _check_bwd_inputs(q, k, v, o, lse, do)
    b, s_q, h, d = q.shape
    s_kv, kvh = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    if route == "wgmma":
        # lse * log2(e) and delta rows, s_q padded to the dQ kernel's q tile
        s_pad = -(-s_q // _WGMMA_BWD_PAD) * _WGMMA_BWD_PAD
        scratch = torch.empty((2, b * h, s_pad), dtype=torch.float32, device=q.device)
    else:
        scratch = torch.empty((b, h, s_q), dtype=torch.float32, device=q.device)   # delta
    from ..op_builder import load_op

    strides = [s for t in (q, k, v, o, do, dq, dk, dv) for s in t.stride()[:3]]
    lib = load_op("flash_attention_bwd")
    entry = lib.ds_flash_attention_bwd_wgmma if route == "wgmma" else lib.ds_flash_attention_bwd
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = entry(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            lse.data_ptr(), scratch.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            _KERNEL_DTYPES[q.dtype], b, h, kvh, s_q, s_kv, d,
            (ctypes.c_longlong * 24)(*strides), float(scale), int(bool(causal)), stream)
    if err:
        raise RuntimeError(f"flash_attention_bwd launch failed ({route} route): cudaError_t {err}")
    LAUNCH_COUNTS["flash_attention_bwd"] += 1
    if route == "wgmma":
        LAUNCH_COUNTS["flash_attention_bwd_wgmma"] += 1
    return dq, dk, dv
