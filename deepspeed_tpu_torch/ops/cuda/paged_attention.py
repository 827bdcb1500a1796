"""Paged flash-decode: the CUDA kernel's wrapper and its plain version.

``paged_flash_decode`` is the port of the Pallas TPU kernel of
``deepspeed_tpu/ops/pallas/paged_attention.py`` (``_decode_kernel`` in
``paged_flash_decode``) and the combine after it, as hand-written CUDA,
``deepspeed_tpu_torch/csrc/paged_flash_decode.cu``: one query row per slot
against a paged KV pool, the block table walked inside the kernel, plus the
current token's fresh k/v row. The pool holds the compute dtype, or int8
with one fp32 scale per (token, head) (``kv_pool.kv_dtype="int8"``), which
the kernel dequantizes on its staged tile.

On CUDA tensors the wrapper launches the kernel or raises; on CPU tensors it
computes ``paged_flash_decode_reference``, the plain split-KV math in fp32,
which the tests hold against the TPU kernel in interpret mode and
``chip_smoke.py`` holds the CUDA kernel against on the card.
"""

import functools
import math

import torch

from . import LAUNCH_COUNTS
from ...comm.collectives import dequantize_blockwise

NEG_INF = -1e30

_KERNEL_DTYPES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
_KERNEL_HEAD_DIMS = (64, 128)
_TILE = 32                 # tokens the kernel stages per step (csrc TILE)
_SMEM_NO_OPT_IN = 48 * 1024  # shared memory any block gets without opting in


def _device_index(device):
    device = torch.device(device)
    return torch.cuda.current_device() if device.index is None else device.index


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _smem_optin(index):
    """Bytes of shared memory one block of CUDA device ``index`` may opt in
    to, as the CUDA runtime reports it."""
    from ..op_builder import load_op

    n_bytes = load_op("paged_flash_decode").ds_paged_decode_smem_optin(index)
    if n_bytes < 0:
        raise RuntimeError(f"CUDA device {index} did not report its shared memory limit")
    return n_bytes


def _fit_splits(requested, n_columns):
    """Largest split count in [1, requested] dividing ``n_columns`` (the
    block-table width) — a non-dividing request degrades, never crashes."""
    s = max(1, min(int(requested), n_columns))
    while n_columns % s:
        s -= 1
    return s


def kernel_splits(n_slots, kv_heads, n_columns, device):
    """The kernel's split count when the caller names none: enough
    (split, kv head, slot) blocks to give each SM of CUDA ``device`` about
    four, as a power of two that divides the table width, at most 16."""
    want = max(1, math.ceil(4 * _sm_count(_device_index(device)) / max(n_slots * kv_heads, 1)))
    want = min(1 << (want - 1).bit_length(), 16)
    return _fit_splits(want, n_columns)


def _split_smem_bytes(hq, head_dim, itemsize):
    return itemsize * 2 * _TILE * head_dim + 4 * (2 * hq * head_dim + hq * _TILE + 3 * hq)


def fused_decode_supported(cfg, block_size, device="cuda", dtype=None):
    """Capability probe for the fused backend: ``(ok, reason)``.

    Refused everywhere, as in the JAX package: banded local-attention layers
    (no in-kernel band mask) and ``n_heads`` not a multiple of ``kv_heads``.
    On a CUDA device also what the kernel does not take: a head_dim other
    than 64 or 128, a pool dtype other than fp32/fp16/bf16 or int8 (an int8
    pool with a 16-bit or fp32 compute dtype), and a GQA group too large for
    one block's shared memory. On the CPU everything else is admitted (the
    plain version runs there, as JAX's interpret mode). The JAX probe refuses
    int8 pools on the TPU until that kernel is validated on a chip; the CUDA
    kernel's int8 pool is held against its plain version by ``chip_smoke.py``,
    so this probe admits it."""
    if cfg.local_attention_window > 0:
        return False, ("local_attention_window > 0: banded layer masks are "
                       "not implemented in the fused kernel")
    if cfg.n_heads % cfg.kv_heads:
        return False, f"n_heads {cfg.n_heads} not a multiple of kv_heads {cfg.kv_heads}"
    if torch.device(device).type != "cuda":
        return True, ""
    if cfg.head_dim not in _KERNEL_HEAD_DIMS:
        return False, f"head_dim {cfg.head_dim} not in {_KERNEL_HEAD_DIMS} (CUDA kernel)"
    dtype = dtype or cfg.compute_dtype
    if dtype == torch.int8:
        # the kernel stages the dequantized rows in the compute dtype
        dtype = cfg.compute_dtype
        if dtype not in _KERNEL_DTYPES:
            return False, f"int8 pool with compute dtype {dtype} (CUDA kernel: fp32/fp16/bf16)"
    if dtype not in _KERNEL_DTYPES:
        return False, f"pool dtype {dtype} is not fp32/fp16/bf16 or int8 (CUDA kernel)"
    hq = cfg.n_heads // cfg.kv_heads
    need = _split_smem_bytes(hq, cfg.head_dim, torch.tensor([], dtype=dtype).element_size())
    # only a need past the no-opt-in size asks the device for its limit
    if need > _SMEM_NO_OPT_IN and need > _smem_optin(_device_index(device)):
        return False, f"{hq} query heads per kv head exceed one block's shared memory"
    return True, ""


def _check_shapes(q, k_new, v_new, kc, vc, table, pos, k_scale=None, v_scale=None):
    if q.dim() != 3 or kc.dim() != 4:
        raise ValueError("paged_flash_decode takes q [S, nh, dh] and a pool [n_blocks, bs, kvh, dh]")
    s_dim, n_heads, dh = q.shape
    _, _, kvh, _ = kc.shape
    if vc.shape != kc.shape or kc.shape[3] != dh:
        raise ValueError(f"pool shapes {tuple(kc.shape)}/{tuple(vc.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if k_new.shape != (s_dim, kvh, dh) or v_new.shape != (s_dim, kvh, dh):
        raise ValueError(f"fresh rows {tuple(k_new.shape)}/{tuple(v_new.shape)}, expected "
                         f"{(s_dim, kvh, dh)}")
    if n_heads % kvh:
        raise ValueError(f"q heads {n_heads} are not a multiple of kv heads {kvh}")
    if table.dim() != 2 or table.shape[0] != s_dim or pos.shape != (s_dim,):
        raise ValueError(f"table {tuple(table.shape)} / pos {tuple(pos.shape)} do not match "
                         f"{s_dim} slots")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("an int8 pool takes both k_scale and v_scale")
    if k_scale is not None:
        want = tuple(kc.shape[:3]) + (1,)
        if tuple(k_scale.shape) != want or tuple(v_scale.shape) != want:
            raise ValueError(f"pool scales {tuple(k_scale.shape)}/{tuple(v_scale.shape)}, "
                             f"expected {want}")
        if kc.dtype != torch.int8 or vc.dtype != torch.int8:
            raise TypeError(f"scales come with an int8 pool, got {kc.dtype}/{vc.dtype}")
        if k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32:
            raise TypeError(f"pool scales are fp32, got {k_scale.dtype}/{v_scale.dtype}")
    elif kc.dtype == torch.int8 or vc.dtype == torch.int8:
        raise ValueError("an int8 pool needs k_scale and v_scale")


def paged_flash_decode_reference(q, k_new, v_new, kc, vc, table, pos, *, k_scale=None,
                                 v_scale=None, scale=None, alibi_slopes=None, kv_splits=4):
    """Plain version: the split-KV partials in fp32, then the combine
    (JAX ``paged_attention.py:309-331``). Split ``sp`` covers table columns
    ``[sp*bps, (sp+1)*bps)``; its partial (m, l, acc) is the exact softmax
    statistics of its positions below the cursor — P stays fp32 here (the
    kernel rounds it to the input type before P.V, see ``rounding_bound``).
    A split with no valid position gives (-1e30, 0, 0). An int8 pool is
    dequantized to q's dtype first, float(q) * scale rounded as the kernel
    stages it (the TPU kernel's ``(k.astype(f32) * ks).astype(q.dtype)``).
    Returns
    [S, nh, dh] in q's dtype."""
    _check_shapes(q, k_new, v_new, kc, vc, table, pos, k_scale, v_scale)
    s_dim, n_heads, dh = q.shape
    _, bs, kvh, _ = kc.shape
    nb_cols = table.shape[1]
    hq = n_heads // kvh
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    splits = _fit_splits(kv_splits, nb_cols)
    span = nb_cols // splits * bs                      # positions per split
    qf = q.float().reshape(s_dim, kvh, hq, dh)
    idx = table.long()
    keys, vals = kc[idx], vc[idx]
    if k_scale is not None:
        keys = dequantize_blockwise(keys, k_scale[idx], q.dtype)
        vals = dequantize_blockwise(vals, v_scale[idx], q.dtype)
    keys = keys.float().reshape(s_dim, splits, span, kvh, dh)
    vals = vals.float().reshape(s_dim, splits, span, kvh, dh)
    sc = torch.einsum("sghd,sptgd->sgpht", qf, keys) * scale      # [S, kvh, sp, hq, T]
    at = torch.arange(splits * span, device=q.device).reshape(splits, span)
    dist = at[None] - pos.long()[:, None, None]                     # [S, sp, T]
    if alibi_slopes is not None:
        slopes = alibi_slopes.float().to(q.device).reshape(kvh, hq)
        sc = sc + slopes[None, :, None, :, None] * dist.float()[:, None, :, None, :]
    valid = (dist < 0)[:, None, :, None, :]
    sc = torch.where(valid, sc, NEG_INF)
    m_p = sc.amax(dim=-1)                                           # [S, kvh, sp, hq]
    p = torch.where(valid, torch.exp(sc - m_p[..., None]), 0.0)
    l_p = p.sum(dim=-1)
    acc = torch.einsum("sgpht,sptgd->sgphd", p, vals)              # [S, kvh, sp, hq, dh]

    # combine across the splits, then fold the fresh row at distance 0
    m_c = m_p.amax(dim=2)
    w = torch.exp(m_p - m_c[:, :, None])
    l_c = (l_p * w).sum(dim=2)
    acc_c = (acc * w[..., None]).sum(dim=2)                        # [S, kvh, hq, dh]
    s_new = (qf * k_new.float()[:, :, None, :]).sum(dim=-1) * scale
    m_t = torch.maximum(m_c, s_new)
    corr = torch.exp(m_c - m_t)
    w_new = torch.exp(s_new - m_t)
    l_t = l_c * corr + w_new
    acc_t = acc_c * corr[..., None] + w_new[..., None] * v_new.float()[:, :, None, :]
    out = acc_t / torch.clamp(l_t, min=1e-30)[..., None]
    return out.reshape(s_dim, n_heads, dh).to(q.dtype)


_UNIT_ROUNDOFF = {torch.bfloat16: 2.0 ** -8, torch.float16: 2.0 ** -11}


def rounding_bound(q, k_new, v_new, kc, vc, table, pos, ref, *, k_scale=None, v_scale=None,
                   scale=None, alibi_slopes=None):
    """Per-element bound on |kernel - plain| that rounding to q's 16-bit dtype
    explains, or None for fp32 inputs. The kernel rounds each pool row's P
    to that dtype before P.V, an error of at most u * sum_j p_j |v_j| / l
    (u the dtype's unit roundoff; the fresh row's weight is not rounded, so
    counting it too only loosens the bound by u * p_new |v_new| / l), and
    rounds its output; ``ref``, the plain version's output, is rounded too:
    at most u |o| each. So u * (sum_j p_j |v_j| / l + 2 |o|). An int8 pool
    is taken on its dequantized values, which both sides stage alike."""
    u = _UNIT_ROUNDOFF.get(q.dtype)
    if u is None:
        return None
    if k_scale is not None:
        kc = dequantize_blockwise(kc, k_scale, q.dtype)
        vc = dequantize_blockwise(vc, v_scale, q.dtype)
    weighted_abs_v = paged_flash_decode_reference(
        q.float(), k_new.float(), v_new.float().abs(), kc.float(), vc.float().abs(), table,
        pos, scale=scale, alibi_slopes=alibi_slopes)
    return u * (weighted_abs_v + 2 * ref.float().abs())


def _check_kernel_inputs(q, k_new, v_new, kc, vc, table, pos, alibi_slopes, k_scale, v_scale):
    dev = q.device
    int8 = k_scale is not None
    tensors = (("k_new", k_new), ("v_new", v_new), ("kc", kc), ("vc", vc),
               ("table", table), ("pos", pos))
    if int8:
        tensors += (("k_scale", k_scale), ("v_scale", v_scale))
    for name, t in tensors:
        if t.device != dev:
            raise ValueError(f"paged_flash_decode: {name} on {t.device}, q on {dev}")
    pool_dtype = torch.int8 if int8 else q.dtype
    if (q.dtype not in _KERNEL_DTYPES or any(t.dtype != q.dtype for t in (k_new, v_new))
            or any(t.dtype != pool_dtype for t in (kc, vc))):
        raise TypeError(f"paged decode kernel takes fp32/fp16/bf16 q and k/v rows of one dtype "
                        f"and a pool of that dtype or int8 with scales; got {q.dtype}, "
                        f"{k_new.dtype}, {v_new.dtype}, {kc.dtype}, {vc.dtype}")
    if int8 and not (k_scale.is_contiguous() and v_scale.is_contiguous()):
        raise ValueError(f"paged decode kernel needs contiguous pool scales; strides "
                         f"{k_scale.stride()} / {v_scale.stride()}")
    if table.dtype != torch.int32 or pos.dtype != torch.int32:
        raise TypeError(f"paged decode kernel takes int32 table and pos, got {table.dtype}, "
                        f"{pos.dtype}")
    if not (table.stride(1) == 1 and pos.is_contiguous()):
        raise ValueError("paged decode kernel needs a row-contiguous table and contiguous pos")
    if q.shape[2] not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"paged decode kernel supports head_dim {_KERNEL_HEAD_DIMS}, "
                         f"got {q.shape[2]}")
    for name, t in (("q", q), ("k_new", k_new), ("v_new", v_new), ("kc", kc), ("vc", vc)):
        if t.stride(-1) != 1:
            raise ValueError(f"paged decode kernel needs a contiguous last dim; {name} "
                             f"strides {t.stride()}")
    if kc.stride() != vc.stride():
        raise ValueError(f"k and v pools must share strides: {kc.stride()} vs {vc.stride()}")
    vec = 16 // kc.element_size()
    for name, t in (("kc", kc), ("vc", vc)):
        # pool rows are staged 16 bytes at a time
        if t.data_ptr() % 16 or any(s % vec for s in t.stride()[:3]):
            raise ValueError(f"paged decode kernel needs 16-byte aligned pool rows; {name} "
                             f"strides {t.stride()} at offset {t.data_ptr() % 16}")
    if alibi_slopes is not None and (alibi_slopes.device != dev
                                     or alibi_slopes.dtype != torch.float32
                                     or alibi_slopes.shape != (q.shape[1],)):
        raise ValueError("alibi slopes must be fp32 [n_heads] on q's device")


def paged_flash_decode(q, k_new, v_new, kc, vc, table, pos, *, k_scale=None, v_scale=None,
                       scale=None, alibi_slopes=None, kv_splits=None):
    """Paged decode attention: softmax(q·K/√d)·V for ONE query row per slot,
    where K/V live in the paged pool and the block table is walked for them.

    - ``q``: [S, n_heads, dh] (compute dtype) — this step's query rows;
    - ``k_new``/``v_new``: [S, kvh, dh] — the current token's fresh k/v, NOT
      yet in the pool, logically at position ``pos[s]``;
    - ``kc``/``vc``: [n_blocks, block_size, kvh, dh] — one layer of the pool,
      in q's dtype, or int8 with ``k_scale``/``v_scale`` fp32
      [n_blocks, block_size, kvh, 1] (one scale per token and head);
    - ``table``: [S, NB] int32 physical block ids; ``pos``: [S] int32 cursors.
      Pool positions [0, pos) are attended; everything past the cursor
      (ragged block tails, garbage-block columns) is never read.
    - ``kv_splits``: the split-KV count; None takes ``kernel_splits`` on the
      card and 4 (the JAX default) on the CPU.

    CPU tensors take ``paged_flash_decode_reference``. CUDA tensors launch
    the kernel on the current stream (no synchronisation) or raise on what it
    does not take; an int8 pool counts its launches as
    ``paged_flash_decode_int8``, the others as ``paged_flash_decode``.
    Returns [S, n_heads, dh] in q's dtype."""
    _check_shapes(q, k_new, v_new, kc, vc, table, pos, k_scale, v_scale)
    int8 = k_scale is not None
    tensors = (q, k_new, v_new, kc, vc, table, pos) + ((k_scale, v_scale) if int8 else ())
    if all(t.device.type == "cpu" for t in tensors):
        return paged_flash_decode_reference(q, k_new, v_new, kc, vc, table, pos,
                                            k_scale=k_scale, v_scale=v_scale, scale=scale,
                                            alibi_slopes=alibi_slopes,
                                            kv_splits=4 if kv_splits is None else kv_splits)
    if q.device.type != "cuda":
        raise ValueError(f"paged_flash_decode runs on CUDA or CPU tensors, got {q.device}")
    _check_kernel_inputs(q, k_new, v_new, kc, vc, table, pos, alibi_slopes, k_scale, v_scale)
    s_dim, n_heads, dh = q.shape
    _, bs, kvh, _ = kc.shape
    nb_cols = table.shape[1]
    hq = n_heads // kvh
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    splits = (kernel_splits(s_dim, kvh, nb_cols, q.device) if kv_splits is None
              else _fit_splits(kv_splits, nb_cols))
    out = torch.empty((s_dim, n_heads, dh), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    acc = torch.empty((s_dim, kvh, splits, hq, dh), dtype=torch.float32, device=q.device)
    stats = torch.empty((2, s_dim, kvh, splits, hq), dtype=torch.float32, device=q.device)
    from ..op_builder import load_op

    lib = load_op("paged_flash_decode")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        s_strides = k_scale.stride()[:3] if int8 else (0, 0, 0)
        err = lib.ds_paged_flash_decode(
            q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), kc.data_ptr(), vc.data_ptr(),
            k_scale.data_ptr() if int8 else None, v_scale.data_ptr() if int8 else None,
            table.data_ptr(), pos.data_ptr(),
            alibi_slopes.data_ptr() if alibi_slopes is not None else None,
            acc.data_ptr(), stats[0].data_ptr(), stats[1].data_ptr(), out.data_ptr(),
            _KERNEL_DTYPES[q.dtype], int(int8), s_dim, n_heads, kvh, dh, bs, nb_cols, splits,
            q.stride(0), q.stride(1), k_new.stride(0), k_new.stride(1),
            v_new.stride(0), v_new.stride(1), kc.stride(0), kc.stride(1), kc.stride(2),
            *s_strides, table.stride(0), out.stride(0), out.stride(1), float(scale), stream)
    if err:
        raise RuntimeError(f"paged_flash_decode launch failed: cudaError_t {err}")
    LAUNCH_COUNTS["paged_flash_decode_int8" if int8 else "paged_flash_decode"] += 1
    return out
