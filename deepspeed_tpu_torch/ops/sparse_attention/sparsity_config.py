"""Block-sparsity patterns for sparse attention (a copy of
``deepspeed_tpu/ops/sparse_attention/sparsity_config.py``; layouts are
bitwise the JAX package's).

Reference: ``deepspeed/ops/sparse_attention/sparsity_config.py`` — the
Dense/Fixed/Variable/BigBird/BSLongformer pattern family (``:63/:95/:239/:411/
:546``). A pattern is pure data — a numpy block mask
``[n_q_blocks, n_kv_blocks]`` — turned once into the per-block active lists
the CUDA kernels walk (``ops/cuda/block_sparse_attention.py``). Patterns
follow the published semantics (Sparse Transformers fixed pattern, BigBird,
Longformer), re-derived from the papers.
"""

import dataclasses

import numpy as np


@dataclasses.dataclass
class SparsityConfig:
    """Base: block size in tokens; subclasses fill ``make_layout``."""

    block: int = 128

    def make_layout(self, n_q_blocks, n_kv_blocks):
        raise NotImplementedError

    def layout_for(self, seq_q, seq_kv, causal=True):
        if seq_q % self.block or seq_kv % self.block:
            raise ValueError(
                f"sequence ({seq_q},{seq_kv}) must divide block {self.block}")
        nq, nkv = seq_q // self.block, seq_kv // self.block
        layout = self.make_layout(nq, nkv).astype(bool)
        if causal:
            # block-level causal reachability (block diag aligned to kv end)
            off = nkv - nq
            q_idx = np.arange(nq)[:, None]
            kv_idx = np.arange(nkv)[None, :]
            layout &= kv_idx <= q_idx + off
            # the diagonal block is always attendable (self-attention)
            layout[q_idx[:, 0], np.clip(q_idx[:, 0] + off, 0, nkv - 1)] = True
        if not layout.any(axis=1).all():
            raise ValueError("sparsity layout leaves a query block with no "
                             "attendable kv block")
        return layout


@dataclasses.dataclass
class DenseSparsityConfig(SparsityConfig):
    """All blocks attend all blocks (reference ``Dense:63``)."""

    def make_layout(self, nq, nkv):
        return np.ones((nq, nkv), bool)


@dataclasses.dataclass
class FixedSparsityConfig(SparsityConfig):
    """Sparse-Transformers fixed pattern (reference ``Fixed:95``): blocks are
    grouped in local stretches of ``num_local_blocks``; a query attends its own
    stretch plus the last ``num_global_blocks`` ("summary") blocks of every
    earlier stretch."""

    num_local_blocks: int = 4
    num_global_blocks: int = 1

    def make_layout(self, nq, nkv):
        layout = np.zeros((nq, nkv), bool)
        off = nkv - nq
        for qb in range(nq):
            pos = qb + off  # this block's index on the kv axis
            stretch = pos // self.num_local_blocks
            lo = stretch * self.num_local_blocks
            hi = min(lo + self.num_local_blocks, nkv)
            layout[qb, lo:hi] = True
            for s in range(stretch):
                end = (s + 1) * self.num_local_blocks
                layout[qb, max(0, end - self.num_global_blocks):end] = True
        return layout


@dataclasses.dataclass
class BigBirdSparsityConfig(SparsityConfig):
    """BigBird (reference ``BigBird:411``): sliding window + global first
    blocks (rows and columns) + per-row random blocks."""

    num_sliding_window_blocks: int = 3
    num_global_blocks: int = 1
    num_random_blocks: int = 1
    seed: int = 0

    def make_layout(self, nq, nkv):
        layout = np.zeros((nq, nkv), bool)
        off = nkv - nq
        w = self.num_sliding_window_blocks // 2
        rng = np.random.RandomState(self.seed)
        for qb in range(nq):
            pos = qb + off
            layout[qb, max(0, pos - w):min(nkv, pos + w + 1)] = True
            layout[qb, :self.num_global_blocks] = True  # global columns
            if self.num_random_blocks and nkv > 1:
                picks = rng.choice(nkv, size=min(self.num_random_blocks, nkv),
                                   replace=False)
                layout[qb, picks] = True
        layout[:self.num_global_blocks, :] = True  # global rows attend all
        return layout


@dataclasses.dataclass
class BSLongformerSparsityConfig(SparsityConfig):
    """Block-sparse Longformer (reference ``BSLongformer:546``): sliding window
    + designated global block indices that attend/are attended everywhere."""

    num_sliding_window_blocks: int = 3
    global_block_indices: tuple = (0,)

    def make_layout(self, nq, nkv):
        layout = np.zeros((nq, nkv), bool)
        off = nkv - nq
        w = self.num_sliding_window_blocks // 2
        for qb in range(nq):
            pos = qb + off
            layout[qb, max(0, pos - w):min(nkv, pos + w + 1)] = True
        for g in self.global_block_indices:
            if g < nkv:
                layout[:, g] = True
            if g < nq:
                layout[g, :] = True
        return layout


@dataclasses.dataclass
class VariableSparsityConfig(SparsityConfig):
    """Reference ``Variable:239``: custom local window sizes (a list of block
    counts, cycled over stretches) plus global first blocks."""

    local_window_blocks: tuple = (4,)
    num_global_blocks: int = 1

    def make_layout(self, nq, nkv):
        layout = np.zeros((nq, nkv), bool)
        off = nkv - nq
        # stretch boundaries from the cycled window sizes
        bounds = [0]
        i = 0
        while bounds[-1] < nkv:
            bounds.append(bounds[-1]
                          + self.local_window_blocks[i % len(self.local_window_blocks)])
            i += 1
        for qb in range(nq):
            pos = qb + off
            for lo, hi in zip(bounds[:-1], bounds[1:]):
                if lo <= pos < hi:
                    layout[qb, lo:min(hi, nkv)] = True
                    break
        layout[:, :self.num_global_blocks] = True
        return layout
