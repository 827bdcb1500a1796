"""Block-sparse flash attention, forward and backward: the CUDA kernels' wrappers and their plain versions.

``block_sparse_attention_fwd`` is the port of the Pallas TPU forward
(``deepspeed_tpu/ops/pallas/block_sparse_attention.py``:
``BlockSparseAttention._forward``, ``_fwd_kernel``) and
``block_sparse_attention_bwd`` of its backward (``_backward``: ``_dq_kernel``
and ``_dkv_kernel``), both in one hand-written CUDA source,
``deepspeed_tpu_torch/csrc/block_sparse_attention.cu``. A ``SparseLayout``
holds a block layout (``ops/sparse_attention/sparsity_config.py``) with its
per-q-block active kv lists and the transposed lists, on one device, built
once; every call reads them there.

Both have two routes, fixed by ``block_sparse_route(dtype, head_dim,
block, kernel)`` before the launch: ``wgmma`` (bf16 and fp16 at head_dim 64,
80, 96, 128 and 256 with a block that is a multiple of 64: the flash
forward's and backward's TMA + wgmma kernels walking the layout's lists by
tile, ``TileLists``, the grid in heavy-first order) and ``wmma``
(everything else the kernels take: warp-level wmma or fp32 FMAs through
shared memory). A failed build or launch raises; neither route falls back
to the other.

Layout ``[b, s, h, d]`` in and out, one head count for q, k and v (the model
repeats GQA kv heads before the call, as the JAX package does); causal
masking is aligned to the bottom right (query i sees key j <= i + s_kv -
s_q). On a CUDA tensor each wrapper launches its kernel or raises; on a CPU
tensor it computes the plain version (``block_sparse_attention_fwd_reference``,
``block_sparse_attention_bwd_reference``: fp32 math that gathers the same
active blocks in the same order and runs the same online softmax and the
same dQ / dK·dV sums), which the tests hold against the TPU kernels in
interpret mode and ``chip_smoke.py`` holds the CUDA kernels against on the
card.
"""

import ctypes
import math

import numpy as np
import torch

from . import LAUNCH_COUNTS, resolve_route
from .flash_attention import (_KERNEL_DTYPES, _KERNEL_HEAD_DIMS,  # noqa: F401 (the gate)
                              _UNIT_ROUNDOFF, _WGMMA_DTYPES, _check_kernel_inputs, _on_cpu)

NEG_INF = -1e30

# the TMA + wgmma route takes 16-bit types at these head dims, the
# forward's and the backward's, when each 64-row half of its tiles lies in
# one layout block
_WGMMA_HEAD_DIMS = {"fwd": (64, 80, 96, 128, 256), "bwd": (64, 80, 96, 128, 256)}
_WGMMA_BLOCK = 64
# the rows of the wgmma kernels' grid tiles: the forward's and dQ's q tile,
# the dK/dV kernel's kv tile (64 at head_dim 256, csrc/flash_bwd_sm90.cuh
# DkvCfg); each is one or two 64-row halves
_Q_TILE = 128


def _kv_tile(head_dim):
    return 64 if head_dim > 128 else 128


def block_sparse_route(dtype, head_dim, block, kernel):
    """The route the block-sparse ``kernel`` (``"fwd"`` or ``"bwd"``) takes
    for ``dtype``, ``head_dim`` and the layout's ``block``: a pure function
    of the four, decided before the launch. ``"wgmma"`` for bf16/fp16 at the
    kernel's ``_WGMMA_HEAD_DIMS`` with a block that is a multiple of 64,
    ``"wmma"`` for every other shape the kernels take (fp32/fp16/bf16,
    head_dim in ``_KERNEL_HEAD_DIMS``, a block that is a multiple of 16);
    None where no route does."""
    if kernel not in _WGMMA_HEAD_DIMS:
        raise ValueError(f"block_sparse_route: kernel {kernel!r} is not 'fwd' or 'bwd'")
    if dtype not in _KERNEL_DTYPES or head_dim not in _KERNEL_HEAD_DIMS or block <= 0 \
            or block % 16:
        return None
    if (dtype in _WGMMA_DTYPES and head_dim in _WGMMA_HEAD_DIMS[kernel]
            and block % _WGMMA_BLOCK == 0):
        return "wgmma"
    return "wmma"


def _pick_route(kernel, q, block, route):
    """``block_sparse_route`` of ``kernel`` (``"fwd"`` or ``"bwd"``) for q at
    ``block``, or the route ``route`` forces (``resolve_route``)."""
    name = {"fwd": "block-sparse forward", "bwd": "block-sparse backward"}[kernel]
    return resolve_route(name, block_sparse_route(q.dtype, q.shape[3], block, kernel), route,
                         f"{q.dtype} at head_dim {q.shape[3]} and block {block}")


def heavy_first(counts):
    """The order in which the wgmma kernels' grids take a layout's rows:
    the longest lists first, ties in row order (a stable sort), so that the
    rows with the most tiles start in the first wave."""
    return np.argsort(-np.asarray(counts, np.int64), kind="stable").astype(np.int32)


def _active_lists(layout):
    """bool [nq, nkv] -> (idx [nq, max_a] int32 padded w/ last, counts [nq])
    (a copy of the JAX package's host-side preprocessing)."""
    nq, _ = layout.shape
    lists = [np.nonzero(layout[j])[0] for j in range(nq)]
    counts = np.asarray([len(l) for l in lists], np.int32)
    max_a = max(1, int(counts.max()))
    idx = np.zeros((nq, max_a), np.int32)
    for j, l in enumerate(lists):
        if len(l) == 0:
            continue
        idx[j, :len(l)] = l
        idx[j, len(l):] = l[-1]
    return idx, counts, max_a


class TileLists:
    """A layout's lists by the wgmma kernels' grid tiles of ``rows`` rows (128
    or 64; the block a multiple of 64, so each 64-row half of a tile lies in
    one block): ``idx`` ``[tiles, max_a]`` int32 holds, for each tile, the
    ascending union of its halves' lists, each entry ``(block << 2) |
    owners`` (bit h set when half h's block lists it; padded with zeros),
    ``cnt`` the union's length and ``order`` the grid's order of the tiles
    (``heavy_first`` of ``cnt``). ``walked`` / ``needed`` count (64-row
    half, listed block) pairs: the halves a union makes walk, against those
    their own lists hold (equal when the two halves of every tile share a
    list, as at blocks of 128 and more)."""

    def __init__(self, layout, block, rows, to):
        n_rows = layout.shape[0] * block
        n_tiles = -(-n_rows // rows)
        unions, walked, needed = [], 0, 0
        for t in range(n_tiles):
            own = np.zeros(layout.shape[1], np.int32)
            halves = range(t * rows, min((t + 1) * rows, n_rows), 64)
            for h, r0 in enumerate(halves):
                own |= layout[r0 // block].astype(np.int32) << h
            listed = np.nonzero(own)[0]
            unions.append((listed << 2) | own[listed])
            walked += len(listed) * len(halves)
            needed += int(sum(bin(int(o)).count("1") for o in own[listed]))
        cnt = np.asarray([len(u) for u in unions], np.int32)
        self.max_a = max(1, int(cnt.max()))
        idx = np.zeros((n_tiles, self.max_a), np.int32)
        for t, u in enumerate(unions):
            idx[t, :len(u)] = u
        self.walked, self.needed = walked, needed
        self.idx, self.cnt, self.order = to(idx), to(cnt), to(heavy_first(cnt))


class SparseLayout:
    """A ``[n_q_blocks, n_kv_blocks]`` block layout of ``block``-token blocks
    and its active lists on ``device``: ``fwd_idx``/``fwd_cnt`` (the kv
    blocks each q block attends, ascending, padded with the last) and
    ``bwd_idx``/``bwd_cnt`` (the same of the transposed layout: the q blocks
    attending each kv block), int32, copied to the device once; and, for a
    block that is a multiple of 64, the wgmma kernels' lists by tile
    (``TileLists``): ``q_tiles`` over the forward lists by 128-row q tile,
    ``kv_tiles[rows]`` over the transposed ones by 128- and 64-row kv tile."""

    def __init__(self, layout, block, device="cpu"):
        self.layout = np.asarray(layout, bool)
        self.block = int(block)
        fidx, fcnt, self.max_a = _active_lists(self.layout)
        bidx, bcnt, self.max_aq = _active_lists(self.layout.T)
        to = lambda a: torch.as_tensor(a, dtype=torch.int32).to(device)
        self.fwd_idx, self.fwd_cnt = to(fidx), to(fcnt)
        self.bwd_idx, self.bwd_cnt = to(bidx), to(bcnt)
        self.q_tiles, self.kv_tiles = None, {}
        if self.block % _WGMMA_BLOCK == 0:
            self.q_tiles = TileLists(self.layout, self.block, _Q_TILE, to)
            self.kv_tiles = {rows: TileLists(self.layout.T, self.block, rows, to)
                             for rows in (128, 64)}
        self.device = self.fwd_idx.device  # "cuda" resolved to its index


def _check_shapes(q, k, v, lists, causal):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("block-sparse attention takes [b, s, h, d] tensors")
    b, s_q, h, d = q.shape
    if k.shape != v.shape or (k.shape[0], k.shape[2], k.shape[3]) != (b, h, d):
        raise ValueError(f"k/v shape {tuple(k.shape)}/{tuple(v.shape)} does not match q "
                         f"{tuple(q.shape)} (one head count: repeat GQA kv heads first)")
    nq, nkv = lists.layout.shape
    if (s_q, k.shape[1]) != (nq * lists.block, nkv * lists.block):
        raise ValueError(f"sequence lengths ({s_q}, {k.shape[1]}) do not match the layout's "
                         f"{nq} x {nkv} blocks of {lists.block}")
    if causal and s_q > k.shape[1]:
        # bottom-right alignment leaves the first rows with no key at all
        raise ValueError(f"causal block-sparse attention requires s_q <= s_kv, got s_q={s_q} "
                         f"s_kv={k.shape[1]}")


def _blocks(t, blk):
    """[b, s, h, d] -> fp32 [b, h, s / blk, blk, d]."""
    b, s, h, d = t.shape
    return t.float().transpose(1, 2).reshape(b, h, s // blk, blk, d)


def _unblocks(t):
    """fp32 [b, h, n, blk, d] -> [b, n * blk, h, d]."""
    b, h, n, blk, d = t.shape
    return t.reshape(b, h, n * blk, d).transpose(1, 2)


def _visible(lists, a, rows_fwd, causal, s_q, s_kv, device):
    """[n, blk, blk] (query row x key column) mask of list slot ``a``: the
    slot is live (a < cnt) and, when causal, the key is not past the query.
    ``rows_fwd``: the forward lists (n = q blocks, column blocks from the
    list) or the transposed ones (n = kv blocks, row blocks from the list)."""
    blk = lists.block
    idx = (lists.fwd_idx if rows_fwd else lists.bwd_idx).to(device).long()[:, a]
    cnt = (lists.fwd_cnt if rows_fwd else lists.bwd_cnt).to(device)
    ok = (a < cnt)[:, None, None]
    if causal:
        own = torch.arange(idx.numel(), device=device)
        qb, kb = (own, idx) if rows_fwd else (idx, own)
        ar = torch.arange(blk, device=device)
        q_pos = qb[:, None, None] * blk + ar[None, :, None] + (s_kv - s_q)
        k_pos = kb[:, None, None] * blk + ar[None, None, :]
        ok = ok & (k_pos <= q_pos)
    return idx, ok


def block_sparse_attention_fwd_reference(q, k, v, lists, causal=True, scale=None,
                                         return_lse=False):
    """Plain version of the forward, in fp32: for every q block (all at once)
    the online softmax over its active kv blocks, one list slot at a time in
    the list's order, as the TPU kernel's grid axis runs. With
    ``return_lse`` also the fp32 ``[b, h, s_q]`` row logsumexp."""
    _check_shapes(q, k, v, lists, causal)
    b, s_q, h, d = q.shape
    s_kv = k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    blk = lists.block
    qf = _blocks(q, blk) * scale
    kf, vf = _blocks(k, blk), _blocks(v, blk)
    nq = qf.shape[2]
    m = torch.full((b, h, nq, blk), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, nq, blk), dtype=torch.float32, device=q.device)
    acc = torch.zeros_like(qf)
    for a in range(lists.max_a):
        kb, ok = _visible(lists, a, True, causal, s_q, s_kv, q.device)
        logits = torch.where(ok, torch.einsum("bhjqd,bhjkd->bhjqk", qf, kf[:, :, kb]), NEG_INF)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        p = torch.where(ok, torch.exp(logits - m_new[..., None]), 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhjqk,bhjkd->bhjqd", p, vf[:, :, kb])
        m = m_new
    l = torch.clamp(l, min=1e-30)
    out = _unblocks(acc / l[..., None]).to(q.dtype)
    if return_lse:
        return out, (m + torch.log(l)).reshape(b, h, s_q)
    return out


def _bwd_sums(q, k, v, o, lse, do, lists, causal, scale, absolute):
    """The backward's sums in fp32: dQ over the forward lists, dK and dV over
    the transposed lists, with P = exp(scale q.k - lse) recomputed, delta =
    rowsum(dO * O), dS = P (dP - delta) scale; dV = P^T dO, dK = dS^T Q,
    dQ = dS K. With ``absolute`` the same sums of |terms| (P |dO|, |dS| |Q|,
    |dS| |K|), which size the kernel's rounding error."""
    b, s_q, h, d = q.shape
    s_kv = k.shape[1]
    blk = lists.block
    qf, kf, vf, dof = (_blocks(t, blk) for t in (q, k, v, do))
    nq = qf.shape[2]
    lse_b = lse.float().reshape(b, h, nq, blk)
    delta = (o.float() * do.float()).sum(-1).transpose(1, 2).reshape(b, h, nq, blk)
    # the right-hand factors of dQ, dK, dV (their magnitudes for the bound)
    rq, rk, rdo = (qf.abs(), kf.abs(), dof.abs()) if absolute else (qf, kf, dof)

    def ds_and_p(qs, ks, vs, dos, lse_r, delta_r, ok):
        s = torch.einsum("bhjqd,bhjkd->bhjqk", qs, ks) * scale
        p = torch.where(ok, torch.exp(s - lse_r[..., None]), 0.0)
        dp = torch.einsum("bhjqd,bhjkd->bhjqk", dos, vs)
        ds = p * (dp - delta_r[..., None]) * scale
        return (ds.abs() if absolute else ds), p

    dq = torch.zeros_like(qf)
    for a in range(lists.max_a):
        kb, ok = _visible(lists, a, True, causal, s_q, s_kv, q.device)
        ds, _ = ds_and_p(qf, kf[:, :, kb], vf[:, :, kb], dof, lse_b, delta, ok)
        dq += torch.einsum("bhjqk,bhjkd->bhjqd", ds, rk[:, :, kb])
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    for a in range(lists.max_aq):
        qb, ok = _visible(lists, a, False, causal, s_q, s_kv, q.device)
        ds, p = ds_and_p(qf[:, :, qb], kf, vf, dof[:, :, qb], lse_b[:, :, qb], delta[:, :, qb],
                         ok)
        dv += torch.einsum("bhjqk,bhjqd->bhjkd", p, rdo[:, :, qb])
        dk += torch.einsum("bhjqk,bhjqd->bhjkd", ds, rq[:, :, qb])
    return _unblocks(dq), _unblocks(dk), _unblocks(dv)


def block_sparse_attention_bwd_reference(q, k, v, o, lse, do, lists, causal=True, scale=None):
    """Plain version of the backward: ``_bwd_sums`` in fp32, each gradient
    rounded once to its input's dtype. ``lse`` is the forward's fp32
    ``[b, h, s_q]``; returns (dq, dk, dv) in q's, k's and v's layouts."""
    _check_shapes(q, k, v, lists, causal)
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[3])
    dq, dk, dv = _bwd_sums(q, k, v, o, lse, do, lists, causal, scale, False)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def rounding_bound(q, k, v, ref, lists, causal=True, scale=None):
    """Per-element bound on |kernel - plain| of the forward's output that
    rounding to q's 16-bit dtype explains, or None for fp32 inputs: the
    kernel rounds P before P.V (at most u sum_j p_j |v_j| / l) and its
    output, and the plain output ``ref`` is rounded too (u |o| each)."""
    u = _UNIT_ROUNDOFF.get(q.dtype)
    if u is None:
        return None
    weighted_abs_v = block_sparse_attention_fwd_reference(q.float(), k.float(), v.float().abs(),
                                                          lists, causal=causal, scale=scale)
    return u * (weighted_abs_v + 2 * ref.float().abs())


def bwd_rounding_bound(q, k, v, o, lse, do, refs, lists, causal=True, scale=None):
    """Per-element bounds on |kernel - plain| for (dq, dk, dv) that rounding
    to q's 16-bit dtype explains, or None for fp32 inputs: P rounded before
    P^T dO (u sum P |dO|), dS before dS^T Q and dS K (u sum |dS| |Q|,
    u sum |dS| |K|), and each output rounded on both sides (u |g| each,
    ``refs`` being the plain version's outputs)."""
    u = _UNIT_ROUNDOFF.get(q.dtype)
    if u is None:
        return None
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[3])
    sums = _bwd_sums(q, k, v, o, lse, do, lists, causal, scale, True)
    return tuple(u * (s + 2 * r.float().abs()) for s, r in zip(sums, refs))


def _check_cuda_inputs(q, k, v, lists):
    if q.device.type != "cuda":
        raise ValueError(f"block-sparse attention runs on CUDA or CPU tensors, got {q.device}")
    _check_kernel_inputs(q, k, v)
    if lists.block % 16:
        raise ValueError(f"the block-sparse kernel needs a block that is a multiple of 16, got "
                         f"{lists.block}")
    if lists.device != q.device:
        raise ValueError(f"the layout's lists are on {lists.device}, the tensors on {q.device}")


def block_sparse_attention_fwd(q, k, v, lists, causal=True, scale=None, return_lse=False,
                               _route=None):
    """Block-sparse softmax(scale q k^T) v over ``lists`` (a ``SparseLayout``)
    for ``[b, s, h, d]`` tensors (and, with ``return_lse``, the fp32
    ``[b, h, s_q]`` row logsumexp).

    CPU tensors take ``block_sparse_attention_fwd_reference``. CUDA tensors
    launch the kernel of ``block_sparse_route(..., "fwd")`` on the current
    stream (no synchronisation) or raise on what it does not take: dtypes
    other than fp32/fp16/bf16, head_dim outside ``_KERNEL_HEAD_DIMS`` (the
    flash kernels' set: 32, 64, 80, 96, 128, 256), a block that is not a
    multiple of 16, lists on another device, a non-contiguous last dim or
    rows not 16-byte aligned. ``_route`` forces a route, for timing one
    against the other (``_pick_route``)."""
    _check_shapes(q, k, v, lists, causal)
    route = _pick_route("fwd", q, lists.block, _route)
    if _on_cpu(q, k, v):
        return block_sparse_attention_fwd_reference(q, k, v, lists, causal=causal, scale=scale,
                                                    return_lse=return_lse)
    _check_cuda_inputs(q, k, v, lists)
    b, s_q, h, d = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    out = torch.empty((b, s_q, h, d), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, h, s_q), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if out.numel() == 0:
        return (out, lse) if return_lse else out
    from ..op_builder import load_op

    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    lib = load_op("block_sparse_attention")
    tensors = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
               lse.data_ptr() if return_lse else None)
    shape = (_KERNEL_DTYPES[q.dtype], b, h, s_q, k.shape[1], d, lists.block,
             (ctypes.c_longlong * 12)(*strides), float(scale), int(bool(causal)))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if route == "wgmma":
            t = lists.q_tiles
            err = lib.ds_block_sparse_attention_fwd_wgmma(
                *tensors, t.idx.data_ptr(), t.cnt.data_ptr(), t.order.data_ptr(), t.max_a,
                *shape, stream)
        else:
            err = lib.ds_block_sparse_attention_fwd(*tensors, lists.fwd_idx.data_ptr(),
                                                    lists.fwd_cnt.data_ptr(), lists.max_a,
                                                    *shape, stream)
    if err:
        raise RuntimeError(f"block_sparse_attention_fwd launch failed ({route} route): "
                           f"cudaError_t {err}")
    LAUNCH_COUNTS["block_sparse_attention_fwd"] += 1
    if route == "wgmma":
        LAUNCH_COUNTS["block_sparse_attention_fwd_wgmma"] += 1
    return (out, lse) if return_lse else out


def block_sparse_attention_bwd(q, k, v, o, lse, do, lists, causal=True, scale=None,
                               _route=None):
    """(dq, dk, dv) of ``o = block_sparse_attention_fwd(q, k, v, lists)`` for
    the upstream gradient ``do``, from the forward's ``lse``.

    CPU tensors take ``block_sparse_attention_bwd_reference``. CUDA tensors
    launch the kernels of ``block_sparse_route(..., "bwd")`` (wmma: the dQ
    kernel, which also computes delta = rowsum(o * dO), and the dK/dV
    kernel; wgmma: a delta pass, the dQ and the dK/dV kernel), counted as
    one launch, on the current stream, or raise on what they do not take:
    the forward's restrictions, o/do unlike q, or a missing lse. ``_route``
    forces a route, for timing one against the other (``_pick_route``)."""
    _check_shapes(q, k, v, lists, causal)
    route = _pick_route("bwd", q, lists.block, _route)
    if lse is None:
        raise ValueError("block-sparse backward needs the forward's lse "
                         "(block_sparse_attention_fwd(..., return_lse=True))")
    if _on_cpu(q, k, v, o, do, lse):
        return block_sparse_attention_bwd_reference(q, k, v, o, lse, do, lists, causal=causal,
                                                    scale=scale)
    _check_cuda_inputs(q, k, v, lists)
    b, s_q, h, d = q.shape
    for name, t in (("o", o), ("do", do)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"block-sparse backward: {name} {tuple(t.shape)} {t.dtype} on "
                             f"{t.device} does not match q {tuple(q.shape)} {q.dtype}")
    _check_kernel_inputs(o, do, do)
    if (lse.dtype != torch.float32 or tuple(lse.shape) != (b, h, s_q)
            or not lse.is_contiguous() or lse.device != q.device):
        raise ValueError(f"block-sparse backward needs a contiguous fp32 lse of shape "
                         f"{(b, h, s_q)} on {q.device}; got {lse.dtype} {tuple(lse.shape)}")
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    if q.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    from ..op_builder import load_op

    strides = [s for t in (q, k, v, o, do, dq, dk, dv) for s in t.stride()[:3]]
    lib = load_op("block_sparse_attention")
    tensors = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
               lse.data_ptr())
    grads = (dq.data_ptr(), dk.data_ptr(), dv.data_ptr())
    shape = (_KERNEL_DTYPES[q.dtype], b, h, s_q, k.shape[1], d, lists.block,
             (ctypes.c_longlong * 24)(*strides), float(scale), int(bool(causal)))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if route == "wgmma":
            # lse * log2(e) rows, then delta rows, each s_q padded to the q tile
            s_pad = -(-s_q // _Q_TILE) * _Q_TILE
            scratch = torch.empty((2, b * h, s_pad), dtype=torch.float32, device=q.device)
            qt, kt = lists.q_tiles, lists.kv_tiles[_kv_tile(d)]
            err = lib.ds_block_sparse_attention_bwd_wgmma(
                *tensors, scratch.data_ptr(), *grads, qt.idx.data_ptr(), qt.cnt.data_ptr(),
                kt.idx.data_ptr(), kt.cnt.data_ptr(), qt.order.data_ptr(), kt.order.data_ptr(),
                qt.max_a, kt.max_a, *shape, stream)
        else:
            delta = torch.empty((b, h, s_q), dtype=torch.float32, device=q.device)
            err = lib.ds_block_sparse_attention_bwd(
                *tensors, delta.data_ptr(), *grads, lists.fwd_idx.data_ptr(),
                lists.fwd_cnt.data_ptr(), lists.bwd_idx.data_ptr(), lists.bwd_cnt.data_ptr(),
                lists.max_a, lists.max_aq, *shape, stream)
    if err:
        raise RuntimeError(f"block_sparse_attention_bwd launch failed ({route} route): "
                           f"cudaError_t {err}")
    LAUNCH_COUNTS["block_sparse_attention_bwd"] += 1
    if route == "wgmma":
        LAUNCH_COUNTS["block_sparse_attention_bwd_wgmma"] += 1
    return dq, dk, dv
