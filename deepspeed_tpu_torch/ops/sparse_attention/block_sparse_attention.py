"""``BlockSparseAttention``: block-sparse attention for a fixed (seq, pattern,
block) shape (port of the host-side class of
``deepspeed_tpu/ops/pallas/block_sparse_attention.py``, the reference's
``SparseSelfAttention`` role).

The layout and its active lists are built once, at construction, and copied
to the device then; a call only launches kernels. With grad on, the call runs
through ``_BlockSparseAttentionFn``, whose forward saves (q, k, v, o, lse) and
whose backward is the dQ and dK/dV kernels, as the JAX class's custom vjp
does; without grad only the forward kernel runs, with no lse.
"""

import torch

from ..cuda.block_sparse_attention import (SparseLayout, block_sparse_attention_bwd,
                                           block_sparse_attention_fwd)


class _BlockSparseAttentionFn(torch.autograd.Function):
    """Block-sparse attention with the block-sparse backward as its gradient."""

    @staticmethod
    def forward(ctx, q, k, v, lists, causal, scale):
        out, lse = block_sparse_attention_fwd(q, k, v, lists, causal=causal, scale=scale,
                                              return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.lists, ctx.causal, ctx.scale = lists, causal, scale
        return out

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = block_sparse_attention_bwd(q, k, v, out, lse, grad_out.contiguous(),
                                                ctx.lists, causal=ctx.causal, scale=ctx.scale)
        return dq, dk, dv, None, None, None


class BlockSparseAttention:
    """Callable sparse attention for one (seq, pattern, block) shape on one
    device. ``config`` is a ``SparsityConfig``; ``layout``, ``density`` and
    ``lists`` (a ``SparseLayout``: the forward and transposed active lists,
    on ``device``) are fixed at construction. A sequence that does not divide
    the block, or a layout that leaves a query block nothing to attend,
    raises ``ValueError`` there."""

    def __init__(self, config, seq_q, seq_kv=None, causal=True, scale=None, device="cpu"):
        seq_kv = seq_kv or seq_q
        self.block = config.block
        self.causal = causal
        self.scale = scale
        self.layout = config.layout_for(seq_q, seq_kv, causal=causal)
        self.density = float(self.layout.mean())
        self.lists = SparseLayout(self.layout, config.block, device)
        self.seq_q, self.seq_kv = seq_q, seq_kv

    def __call__(self, q, k, v):
        """q: [b, s_q, h, d]; k/v: [b, s_kv, h, d] -> [b, s_q, h, d]."""
        s_q, s_kv = q.shape[1], k.shape[1]
        assert s_q == self.seq_q and s_kv == self.seq_kv, \
            (s_q, s_kv, self.seq_q, self.seq_kv)
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
            return _BlockSparseAttentionFn.apply(q, k, v, self.lists, self.causal, self.scale)
        return block_sparse_attention_fwd(q, k, v, self.lists, causal=self.causal,
                                          scale=self.scale)
