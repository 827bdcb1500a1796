"""Fused (vocab-chunked) softmax cross-entropy (port of ``deepspeed_tpu/ops/cross_entropy.py``).

The LM head's matmul and the softmax cross-entropy are one op whose
[tokens, vocab] logit matrix never exists whole. The forward takes an
online logsumexp over the vocabulary: ``impl="pallas"`` through the
streaming CE kernel (``ops/cuda/cross_entropy.py``; its plain version on CPU
tensors), ``impl="xla"`` as uniform padded vocab chunks of torch matmuls,
as the JAX package's ``impl="xla"`` scans them. The backward is the JAX
package's chunked recompute (``_ce_vjp_bwd``) either way: each chunk's
logits are recomputed, ``dlogits = (softmax - onehot) g / n_valid`` in fp32
is rounded to x's dtype and streamed into ``dx += dlogits @ E_c`` and
``dE_c = dlogits^T x``, all with fp32 accumulation; dx comes back in x's
dtype, dE in emb's, dbias in bias's.

API as in JAX: x [tokens, d] (compute dtype), emb [V, d] (the tied ``wte``
layout), labels [tokens] int with ``ignore_index`` entries masked out,
optional fp32 logit bias [V]; returns the scalar fp32 token-mean loss.
"""

import torch

from .cuda.cross_entropy import fused_ce_forward


def _chunking(vocab, n_chunks):
    """(n_chunks, chunk, padded_vocab): uniform chunks via padding. A
    divisor search would fall back to ONE chunk for a prime vocab (GPT-2's
    50257) and build the full logit matrix."""
    nc = max(1, min(n_chunks, vocab))
    chunk = -(-vocab // nc)  # ceil
    return nc, chunk, nc * chunk


def _matmul_f32(a, b):
    """``a @ b`` with fp32 accumulation and an fp32 result, the JAX
    ``dot_general(..., preferred_element_type=f32)`` of the CE's GEMMs:
    cuBLAS with an fp32 output for 16-bit CUDA tensors, fp32 operands
    otherwise (16-bit values are exact in fp32, so the products agree)."""
    if a.device.type == "cuda" and a.dtype in (torch.float16, torch.bfloat16):
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def _chunks(emb, bias, vocab, n_chunks):
    """(start, end, emb rows, bias or None) of each vocab chunk. The padded
    tail of the last chunk is never materialized: its columns are the ones
    JAX pads and masks out."""
    nc, chunk, _ = _chunking(vocab, n_chunks)
    for c in range(nc):
        c0, c1 = c * chunk, min((c + 1) * chunk, vocab)
        if c0 < c1:
            yield c0, c1, emb[c0:c1], None if bias is None else bias[c0:c1]


def _xla_forward(x, emb, safe_labels, bias, n_chunks):
    """(lse, label_logit) by the chunked online logsumexp of JAX's impl='xla'."""
    tokens = x.shape[0]
    m = torch.full((tokens,), float("-inf"), dtype=torch.float32, device=x.device)
    s = torch.zeros((tokens,), dtype=torch.float32, device=x.device)
    lab = torch.zeros((tokens,), dtype=torch.float32, device=x.device)
    rows = torch.arange(tokens, device=x.device)
    for c0, c1, e_c, b_c in _chunks(emb, bias, emb.shape[0], n_chunks):
        logits = _matmul_f32(x, e_c.to(x.dtype).T)
        if b_c is not None:
            logits = logits + b_c.float()[None, :]
        m_new = torch.maximum(m, logits.amax(dim=-1))
        s = s * torch.exp(m - m_new) + torch.exp(logits - m_new[:, None]).sum(dim=-1)
        m = m_new
        in_chunk = (safe_labels >= c0) & (safe_labels < c1)
        picked = logits[rows, (safe_labels - c0).clamp(0, c1 - c0 - 1)]
        lab = torch.where(in_chunk, picked, lab)
    return m + torch.log(s), lab


class FusedCrossEntropy(torch.autograd.Function):
    """Token-mean CE of ``softmax(x @ emb^T + bias)`` with the chunked
    recompute backward."""

    @staticmethod
    def forward(ctx, x, emb, labels, bias, ignore_index, n_chunks, impl):
        if impl not in ("xla", "pallas"):
            raise ValueError(f"fused_cross_entropy impl must be 'xla' or 'pallas', "
                             f"got {impl!r}")
        valid = labels != ignore_index
        safe_labels = torch.where(valid, labels, 0).long()
        if impl == "pallas":
            lse, lab = fused_ce_forward(x, emb, safe_labels, bias)
        else:
            lse, lab = _xla_forward(x, emb, safe_labels, bias, n_chunks)
        n_valid = valid.sum().clamp(min=1)
        loss = ((lse - lab) * valid).sum() / n_valid
        ctx.save_for_backward(x, emb, safe_labels, valid, bias, lse, n_valid)
        ctx.n_chunks = n_chunks
        return loss

    @staticmethod
    def backward(ctx, g):
        x, emb, safe_labels, valid, bias, lse, n_valid = ctx.saved_tensors
        vocab = emb.shape[0]
        coef = (g.float() / n_valid.float()) * valid.float()  # [tokens]
        dx = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        de = torch.empty(emb.shape, dtype=emb.dtype, device=emb.device)
        db = None if bias is None else torch.empty_like(bias)
        for c0, c1, e_c, b_c in _chunks(emb, bias, vocab, ctx.n_chunks):
            e16 = e_c.to(x.dtype)
            logits = _matmul_f32(x, e16.T)
            if b_c is not None:
                logits = logits + b_c.float()[None, :]
            p = torch.exp(logits - lse[:, None])
            in_chunk = (safe_labels >= c0) & (safe_labels < c1)
            idx = (safe_labels - c0).clamp(0, c1 - c0 - 1)
            onehot = torch.zeros_like(p)
            onehot[torch.arange(p.shape[0], device=p.device), idx] = in_chunk.float()
            dlogits = (p - onehot) * coef[:, None]  # fp32
            dl16 = dlogits.to(x.dtype)
            dx += _matmul_f32(dl16, e16)
            de[c0:c1] = _matmul_f32(dl16.T, x).to(emb.dtype)
            if db is not None:
                db[c0:c1] = dlogits.sum(dim=0).to(bias.dtype)
        return dx.to(x.dtype), de, None, db, None, None, None


def fused_cross_entropy(x, emb, labels, bias=None, ignore_index=-100, n_chunks=8, impl="xla"):
    """Token-mean CE of ``softmax(x @ emb^T + bias)`` against ``labels``
    (``ignore_index`` entries masked out); a scalar fp32 loss.

    ``impl="pallas"``: the forward is the streaming CE kernel on CUDA tensors
    and its plain version on CPU tensors. ``impl="xla"``: chunked torch
    matmuls. The backward is the chunked recompute either way."""
    return FusedCrossEntropy.apply(x, emb, labels, bias, ignore_index, n_chunks, impl)
