"""KV-cache decoding (port of ``deepspeed_tpu/models/decoding.py``).

The dense cache is ``{"k", "v"}`` of ``[layers, batch, max_len, kv_heads,
head_dim]``. The JAX package rebuilds it functionally inside a jitted step
and lets XLA alias the update through buffer donation; here it is updated IN
PLACE (each layer writes its new rows into a view of the stacked tensor),
which is what the donation bought there: one cache, never a copy per step.

A cursor ``pos`` is a Python int (the whole batch at one position: prefill
and ``generate()``'s decode) or a ``[b]`` tensor (the serving slot pool,
each row at its own position).

Prefill (``prefill=True``, scalar cursor 0, more than one query row) sends
attention through the flash-attention forward: the CUDA kernel when the
tensors are on the card, its plain version on the CPU. Dense decode steps
attend with plain PyTorch over the cache, as the JAX decode does outside any
Pallas kernel. The JAX decode loop is a compiled ``scan``; this one is an
eager Python loop (CUDA graphs are later work).

The paged half (``init_paged_cache`` .. ``gather_slot_cache``) keeps the
serving pool as ``[layers, n_blocks, block_size, kv_heads, head_dim]``
physical blocks plus a per-slot block table. A decode step reads it through
a gathered dense view (``attention_backend="gather"``) or through the paged
flash-decode kernel, which walks the table itself (``"fused"``). An int8
pool (``kv_dtype="int8"``) adds ``k_scale``/``v_scale`` [layers, n_blocks,
block_size, kv_heads, 1] fp32, one scale per (token, head): rows are
quantized with ``comm/collectives.py quantize_blockwise`` as they are
written, and dequantized to the compute dtype as they are read (the gather
view, the prefix seed) or inside the kernel (fused). Speculative verify is
ROADMAP A.3.
"""

import torch

from . import layers as L
from .transformer import _mlp_apply, _norm_apply, layer_params
from ..comm.collectives import dequantize_blockwise, quantize_blockwise
from ..utils import not_ported


def init_cache(cfg, batch_size, max_len, dtype=None, device="cpu"):
    """The KV cache: k/v stacked over layers, like the stacked block params."""
    dtype = dtype or cfg.compute_dtype
    shape = (cfg.n_layers, batch_size, max_len, cfg.kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def insert_slot_kv(pool, slot_cache, slot):
    """Write one request's freshly-prefilled cache into batch slot ``slot`` of
    a slot-pool cache, in place (continuous batching: a queued request joins
    the running decode batch without draining it).

    pool: {"k","v"} [L, n_slots, max_len, kvh, dh]; slot_cache: the same with
    a batch dim of 1. The whole [max_len] row is overwritten, so nothing from
    the slot's previous occupant survives. The row is a copy: the slot cache
    is not aliased."""
    for name in ("k", "v"):
        pool[name][:, slot] = slot_cache[name][:, 0].to(pool[name].dtype)
    return pool


def reset_slot_kv(pool, slot):
    """Zero batch slot ``slot`` of a slot-pool cache, in place (optional
    hygiene when a request frees its slot; the causal mask already keeps
    stale rows out of every later request's window, and ``insert_slot_kv``
    overwrites the full row)."""
    for name in ("k", "v"):
        pool[name][:, slot] = 0
    return pool


# ---------------------------------------------------------------------------
# paged (block) KV cache: fixed pool of token blocks + per-slot block table
# ---------------------------------------------------------------------------

def init_paged_cache(cfg, n_blocks, block_size, dtype=None, kv_dtype=None, device="cpu"):
    """The paged KV pool: ``n_blocks`` physical blocks of ``block_size``
    tokens, stacked over layers (a physical block id addresses the same
    block row in EVERY layer, so host allocation is one decision per token
    block, not per layer). k/v: [L, n_blocks, block_size, kvh, dh] in
    ``dtype``; with ``kv_dtype="int8"`` int8, plus k_scale/v_scale
    [L, n_blocks, block_size, kvh, 1] fp32."""
    dtype = dtype or cfg.compute_dtype
    shape = (cfg.n_layers, n_blocks, block_size, cfg.kv_heads, cfg.head_dim)
    if kv_dtype == "int8":
        zeros = lambda shp, dt: torch.zeros(shp, dtype=dt, device=device)
        return {"k": zeros(shape, torch.int8), "v": zeros(shape, torch.int8),
                "k_scale": zeros(shape[:-1] + (1,), torch.float32),
                "v_scale": zeros(shape[:-1] + (1,), torch.float32)}
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _paged_view(kc, table, sc=None, dtype=None):
    """A slot-major dense view of one layer of the pool through the block
    table: kc [n_blocks, bs, kvh, dh], table [S, NB] -> [S, NB * bs, kvh, dh]
    (row s holds slot s's KV window in position order: block j covers
    positions [j*bs, (j+1)*bs)), the dense cache layout, so the attention
    downstream is the dense per-row path. The view is a gathered copy; an
    int8 layer (scales ``sc``) is dequantized to ``dtype``."""
    s_dim, per_slot = table.shape
    _, bs, kvh, dh = kc.shape
    idx = table.long()
    g = kc[idx]
    if sc is not None:
        g = dequantize_blockwise(g, sc[idx], dtype)
    return g.reshape(s_dim, per_slot * bs, kvh, dh)


def _paged_writeback_rows(kc, rows, table, pos, block_size, sc=None):
    """Write each slot's fresh [S, kvh, dh] row into the pool at (table[s,
    pos // bs], pos % bs), in place; an int8 layer (scales ``sc``) stores
    ``quantize_blockwise(rows, block=dh)``. Freed slots carry an all-
    garbage-block table row, so their dead writes land in the reserved
    garbage block instead of a reallocated one."""
    pos = pos.long()
    j = torch.clamp(pos // block_size, 0, table.shape[1] - 1)
    bi = table.long().gather(1, j[:, None])[:, 0]
    off = pos % block_size
    if sc is not None:
        q, scale = quantize_blockwise(rows, block=rows.shape[-1])
        kc[bi, off] = q
        sc[bi, off] = scale
        return
    kc[bi, off] = rows.to(kc.dtype)


def _paged_writeback(kc, view, table, pos, block_size, sc=None):
    """``_paged_writeback_rows`` of the row each slot just wrote into the
    dense ``view`` at its cursor."""
    rows = view[torch.arange(view.shape[0], device=view.device), pos.long()]
    _paged_writeback_rows(kc, rows, table, pos, block_size, sc)


def _attn_paged_fused(cfg, p_attn, h, kc, vc, ks, vs, table, pos, rope=None):
    """The fused-backend twin of ``_attn_with_cache`` for paged decode
    (q_len == 1): project q/k/v for the current token, then attend straight
    against the POOL through the paged flash-decode kernel, which walks the
    block table itself, so no dense per-slot view is ever materialized.
    Returns ``(out [S, 1, d], (k_row, v_row))`` with the fresh [S, kvh, dh]
    rows for the caller's pool writeback (the kernel folds them into the
    softmax in compute dtype, the value the gather path attends at the
    cursor). ``ks``/``vs``: the int8 layer's scales, else None."""
    from ..ops.cuda.paged_attention import paged_flash_decode

    b, q_len, _ = h.shape
    q, k, v = _project_qkv(cfg, p_attn, h, rope=rope)
    slopes = L.alibi_slopes(cfg.n_heads, h.device) \
        if cfg.position_embedding == "alibi" else None
    out = paged_flash_decode(q[:, 0], k[:, 0], v[:, 0], kc, vc, table, pos, k_scale=ks,
                             v_scale=vs, scale=cfg.attn_scale, alibi_slopes=slopes)
    out = L.linear_apply(p_attn["o"], out.reshape(b, q_len, -1))
    return out, (k[:, 0], v[:, 0])


def forward_with_paged_cache(model, params, input_ids, pool, table, pos, block_size,
                             draft_len=None, attention_backend="gather", layers=None):
    """One decode step ([S, 1] tokens) reading and writing KV through the
    block table — the paged twin of ``forward_with_cache``'s per-row decode.
    ``pool``: {"k", "v"} [L, n_blocks, bs, kvh, dh] (int8 pools also
    "k_scale", "v_scale" [L, n_blocks, bs, kvh, 1]), updated in place;
    ``table``: [S, NB] int32 block ids; ``pos``: [S] int32 cursors.

    ``"gather"``: per layer, gather the slot-major dense view through
    ``table``, run the dense per-row attention on it (``_block_cached``),
    then write each slot's new row back into the pool. ``"fused"``: the
    paged flash-decode kernel attends to the pool's [0, pos) plus the fresh
    row, which is written back after attention, so the kernel never reads
    the pool row at ``pos``. On an int8 pool the gather view is dequantized
    to the compute dtype and the fresh row attends unquantized on both
    backends; the row is quantized as it is written back. Returns logits
    [S, 1, vocab].

    ``draft_len`` (speculative verify) is ROADMAP A.3."""
    cfg = model.config
    b, q_len = input_ids.shape
    if draft_len is not None:
        raise not_ported("speculative verify on the paged pool (draft_len)", "A.3")
    if q_len != 1:
        raise ValueError(f"forward_with_paged_cache decodes one token per slot, got {q_len}")
    fused = attention_backend == "fused"
    if attention_backend not in ("gather", "fused"):
        raise ValueError(f"unknown attention_backend {attention_backend!r}")
    if fused and cfg.local_attention_window > 0:
        raise ValueError(
            "attention_backend='fused' does not implement banded local-"
            "attention masks (fused_decode_supported gates this)")
    if cfg.local_attention_window > 0:
        raise not_ported("banded local attention", "A.9")
    kv_len = table.shape[1] * block_size
    positions = pos.long()[:, None]
    x, rope = _embed(model, params, input_ids, positions)
    if layers is None:
        layers = unstack_layers(params, cfg.n_layers)
    int8 = "k_scale" in pool
    for i, p_i in enumerate(layers):
        kc, vc = pool["k"][i], pool["v"][i]
        ks, vs = (pool["k_scale"][i], pool["v_scale"][i]) if int8 else (None, None)
        if fused:
            def attn_impl(p_attn, hh, kc=kc, vc=vc, ks=ks, vs=vs):
                return _attn_paged_fused(cfg, p_attn, hh, kc, vc, ks, vs, table, pos,
                                         rope=rope)

            x, (k_row, v_row) = _block_cached(cfg, p_i, x, None, None, pos, kv_len,
                                              rope=rope, attn_impl=attn_impl)
            _paged_writeback_rows(kc, k_row, table, pos, block_size, ks)
            _paged_writeback_rows(vc, v_row, table, pos, block_size, vs)
            continue
        kview = _paged_view(kc, table, ks, cfg.compute_dtype)
        vview = _paged_view(vc, table, vs, cfg.compute_dtype)
        x, _ = _block_cached(cfg, p_i, x, kview, vview, pos, kv_len, rope=rope)
        _paged_writeback(kc, kview, table, pos, block_size, ks)
        _paged_writeback(vc, vview, table, pos, block_size, vs)
    return _head(model, params, x)


def insert_block_kv(pool, dense_cache, block_ids, src_start, block_size):
    """Copy consecutive token blocks of a freshly-prefilled dense cache into
    the pool, in place: rows [src_start + i*bs, src_start + (i+1)*bs) of
    ``dense_cache`` ({"k","v"} [L, 1, max_len, kvh, dh]) land in physical
    block ``block_ids[i]``. One index_put per tensor for all the blocks (the
    JAX package copies one block per call). Each block is overwritten
    whole, so nothing from its previous occupant survives. An int8 pool
    stores ``quantize_blockwise(rows, block=dh)`` and its scales."""
    ids = torch.as_tensor(block_ids, dtype=torch.long).reshape(-1)
    n = ids.numel()
    for name in ("k", "v"):
        src = dense_cache[name][:, 0, src_start:src_start + n * block_size]
        lead, _, kvh, dh = src.shape
        rows = src.reshape(lead, n, block_size, kvh, dh)
        idx = ids.to(src.device)
        if name + "_scale" in pool:
            q, scale = quantize_blockwise(rows, block=dh)
            pool[name][:, idx] = q
            pool[name + "_scale"][:, idx] = scale
        else:
            pool[name][:, idx] = rows.to(pool[name].dtype)
    return pool


def reset_block_kv(pool, block_id):
    """Zero physical block ``block_id`` of the pool, in place (the block-
    granularity hygiene scrub; an int8 pool's scales are zeroed too, so a
    dequantized read is exactly 0)."""
    for a in pool.values():
        a[:, block_id] = 0
    return pool


def gather_slot_cache(cfg, pool, table_row, dtype):
    """One slot's dense [L, 1, NB*bs, kvh, dh] cache view from its block-
    table row — a COPY, never aliasing the pool. It seeds the suffix prefill
    on a shared-prefix hit: positions below the shared length hold the
    canonical prefix KV, everything above is garbage the suffix prefill
    overwrites or the causal mask hides. An int8 pool is dequantized to
    ``dtype``."""
    out = {}
    for name in ("k", "v"):
        idx = torch.as_tensor(table_row, dtype=torch.long, device=pool[name].device)
        g = pool[name][:, idx]
        if name + "_scale" in pool:
            g = dequantize_blockwise(g, pool[name + "_scale"][:, idx], dtype)
        lead, nb, bs, kvh, dh = g.shape
        out[name] = g.reshape(lead, 1, nb * bs, kvh, dh).to(dtype)
    return out


def _project_qkv(cfg, p_attn, h, rope=None):
    """q/k/v projection + rotary, shared by every cached attention path."""
    b, q_len, _ = h.shape
    q = L.linear_apply(p_attn["q"], h).reshape(b, q_len, cfg.n_heads, cfg.head_dim)
    k = L.linear_apply(p_attn["k"], h).reshape(b, q_len, cfg.kv_heads, cfg.head_dim)
    v = L.linear_apply(p_attn["v"], h).reshape(b, q_len, cfg.kv_heads, cfg.head_dim)
    if rope is not None:
        cos, sin = rope
        q = L.apply_rotary(q, cos, sin, cfg.rotary_dim, cfg.rotary_interleaved)
        k = L.apply_rotary(k, cos, sin, cfg.rotary_dim, cfg.rotary_interleaved)
    return q, k, v


def _alibi_slice(cfg, q_len, kv_len, pos, device):
    """ALiBi bias for queries at global positions [pos, pos+q) vs keys [0, kv)."""
    return L.alibi_bias(cfg.n_heads, q_len, kv_len, device=device, q_start=pos)


def _attn_with_cache(cfg, p_attn, h, k_cache, v_cache, pos, kv_len, rope=None,
                     prefill=False):
    """Attention for the q block [b, q, d] against cache[:, :kv_len] after
    writing the new k/v at ``pos`` (in place). Returns out [b, q, d].

    k_cache/v_cache: [b, max_len, kvh, dh] views of the stacked cache. ``pos``:
    a Python int (the whole batch at one cursor), or a [b] integer tensor of
    per-row cursors (the serving slot pool, JAX ``decoding.py:467-482``). A
    scalar write past max_len raises; per-row cursors are the caller's to
    keep inside the window (the serving engine checks them on the host)."""
    per_row = isinstance(pos, torch.Tensor)
    if not per_row and not isinstance(pos, int):
        raise TypeError(f"cache cursor must be an int or a [b] tensor, got {type(pos)}")
    b, q_len, _ = h.shape
    q, k, v = _project_qkv(cfg, p_attn, h, rope=rope)
    if per_row:
        # each row writes its q block at its OWN cursor (one index_put per
        # tensor, the counterpart of the vmapped dynamic_update_slice)
        rows = torch.arange(b, device=h.device)[:, None]
        cols = pos.long()[:, None] + torch.arange(q_len, device=h.device)[None, :]
        k_cache[rows, cols] = k.to(k_cache.dtype)
        v_cache[rows, cols] = v.to(v_cache.dtype)
    else:
        if pos + q_len > k_cache.shape[1]:
            raise ValueError(
                f"cache write [{pos}, {pos + q_len}) overruns max_len {k_cache.shape[1]}")
        k_cache[:, pos:pos + q_len] = k.to(k_cache.dtype)
        v_cache[:, pos:pos + q_len] = v.to(v_cache.dtype)

    # Prefill is plain causal attention over the just-written prompt rows:
    # cache slot j >= q_len is in the causal future of every query, so the
    # [q, max_len] window never needs to exist. The flash path attends on the
    # fresh k/v cast through the cache dtype (the dense path's numerics); the
    # kernel reads the unrepeated GQA heads itself.
    flash_wanted = cfg.prefill_flash
    if flash_wanted is None:
        flash_wanted = h.device.type == "cuda"
    if (flash_wanted and prefill and not per_row and q_len > 1
            and cfg.position_embedding != "alibi"):
        from ..ops.flash_attention import flash_attention

        out = flash_attention(q, k.to(k_cache.dtype), v.to(v_cache.dtype),
                              causal=True, scale=cfg.attn_scale)
        return L.linear_apply(p_attn["o"], out.reshape(b, q_len, -1))

    n_rep = cfg.n_heads // cfg.kv_heads
    k_full = L._repeat_kv(k_cache[:, :kv_len], n_rep)
    v_full = L._repeat_kv(v_cache[:, :kv_len], n_rep)
    # causal vs the cache: query i (global pos+i) sees cache slots <= pos+i
    if per_row:
        kv_idx = torch.arange(kv_len, device=h.device)[None, None, :]       # [1, 1, kv]
        q_idx = (pos.long()[:, None, None]
                 + torch.arange(q_len, device=h.device)[None, :, None])     # [b, q, 1]
        mask = (kv_idx <= q_idx)[:, None]                                   # [b, 1, q, kv]
    else:
        kv_idx = torch.arange(kv_len, device=h.device)[None, :]
        q_idx = pos + torch.arange(q_len, device=h.device)[:, None]
        mask = (kv_idx <= q_idx)[None, None]
    alibi = None
    if cfg.position_embedding == "alibi":
        if per_row:
            # slopes * (kv - q) per row — the int difference, then the fp32
            # multiply, as the scalar-cursor path at the same positions
            dist = (kv_idx - q_idx).float()                                 # [b, q, kv]
            alibi = L.alibi_slopes(cfg.n_heads, h.device)[None, :, None, None] * dist[:, None]
        else:
            alibi = _alibi_slice(cfg, q_len, kv_len, pos, h.device)
    out = L.dot_product_attention(q, k_full, v_full, mask=mask, scale=cfg.attn_scale,
                                  alibi_bias=alibi, logits_dtype=cfg.attn_logits_torch_dtype)
    # -1, not d: head-pruned models have attention width n_heads*head_dim < d
    return L.linear_apply(p_attn["o"], out.reshape(b, q_len, -1))


def _mlp(cfg, p, h):
    mp = L.tree_map(lambda a: a.to(h.dtype) if a.is_floating_point() else a, p["mlp"])
    return _mlp_apply(cfg, mp, h)


def _block_cached(cfg, p, x, k_cache, v_cache, pos, kv_len, rope=None, prefill=False,
                  attn_impl=None):
    """One block with cache. x: [b, q, d] compute dtype. Returns (x, aux).

    ``attn_impl(p_attn_cast, h) -> (out, aux)`` replaces the dense
    ``_attn_with_cache`` (aux None): the fused paged backend routes the
    flash-decode kernel through here, so the norm/residual/MLP structure, and
    with it parity with the gather path, is shared by construction; its aux
    is the fresh (k_row, v_row) for the pool writeback."""
    cast = lambda a: a.to(cfg.compute_dtype) if a.is_floating_point() else a
    p_attn = L.tree_map(cast, p["attn"])

    def attn(h):
        if attn_impl is not None:
            return attn_impl(p_attn, h)
        return _attn_with_cache(cfg, p_attn, h, k_cache, v_cache, pos, kv_len,
                                rope=rope, prefill=prefill), None

    if cfg.parallel_attn_mlp:
        h = _norm_apply(cfg, p["ln_1"], x)
        h_mlp = _norm_apply(cfg, p["ln_2"], x) if cfg.parallel_norm_split else h
        a, aux = attn(h)
        return x + a + _mlp(cfg, p, h_mlp), aux
    if cfg.prenorm:
        a, aux = attn(_norm_apply(cfg, p["ln_1"], x))
        x = x + a
        return x + _mlp(cfg, p, _norm_apply(cfg, p["ln_2"], x)), aux
    a, aux = attn(x)
    x = _norm_apply(cfg, p["ln_1"], x + a)
    return _norm_apply(cfg, p["ln_2"], x + _mlp(cfg, p, x)), aux


def unstack_layers(params, n_layers):
    """Per-layer views of the stacked block params (built once per request,
    not once per decode step)."""
    return [layer_params(params["blocks"], i) for i in range(n_layers)]


def _embed(model, params, input_ids, positions, check_len=None):
    """Token (+ learned position) embedding and the rope tables at
    ``positions`` [b, q]. ``check_len``: the last position + 1 when the
    caller knows it on the host (the learned table's bound is checked)."""
    cfg = model.config
    x = L.embedding_apply(params["wte"], input_ids, cfg.compute_dtype)
    if cfg.position_embedding == "learned":
        wpe = params["wpe"]["weight"]
        if check_len is not None and check_len > wpe.shape[0]:
            raise ValueError(f"positions up to {check_len} exceed max_seq_len {wpe.shape[0]}")
        x = x + wpe.to(cfg.compute_dtype)[positions]
    rope = None
    if cfg.position_embedding == "rope":
        rope = L.rotary_embedding(positions, cfg.rotary_dim or cfg.head_dim, cfg.rope_base)
    return x, rope


def _head(model, params, x):
    cfg = model.config
    x = _norm_apply(cfg, params["ln_f"], x)
    if cfg.tie_embeddings:
        return L.embedding_attend(params["wte"], x)
    return L.linear_apply(params["lm_head"], x)


def forward_with_cache(model, params, input_ids, cache, pos, kv_len, prefill=False,
                       layers=None):
    """Run the model on ``input_ids`` [b, q] writing k/v into ``cache`` at ``pos``.

    Prefill (q = prompt length, pos = 0) and decode (q = 1, pos = cursor).
    ``pos`` is an int, or a [b] tensor of per-row cursors (the serving slot
    pool: every row at its own position). Returns logits [b, q, vocab]; the
    cache is updated in place.
    ``prefill=True`` is the caller's promise that pos == 0 and the whole
    visible window is this q block — it unlocks the flash path.
    ``layers``: ``unstack_layers(params, n_layers)``, when the caller has it.

    As in the JAX package, the embedding LayerNorm (``embed_layernorm``,
    BLOOM) is not applied on this path."""
    cfg = model.config
    b, q_len = input_ids.shape
    dev = input_ids.device
    steps = torch.arange(q_len, device=dev)[None, :]
    if isinstance(pos, torch.Tensor):
        positions, check_len = pos.long()[:, None] + steps, None
    else:
        positions, check_len = (pos + steps).expand(b, q_len), pos + q_len
    x, rope = _embed(model, params, input_ids, positions, check_len)
    if layers is None:
        layers = unstack_layers(params, cfg.n_layers)
    for i, p_i in enumerate(layers):
        x, _ = _block_cached(cfg, p_i, x, cache["k"][i], cache["v"][i], pos, kv_len,
                             rope=rope, prefill=prefill)
    return _head(model, params, x)


def sample_token(logits, generator=None, *, temperature=1.0, top_k=0, top_p=1.0,
                 greedy=False):
    """logits: [b, vocab] -> [b] int64.

    Greedy (or ``temperature == 0``) is the argmax, the first index winning
    ties. Otherwise one draw per row from softmax(logits / temperature) after
    the top-k / top-p filters, using ``generator`` (the JAX package's
    threefry stream cannot be reproduced; the same generator state gives the
    same tokens)."""
    logits = logits.float()
    if greedy or temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits / max(float(temperature), 1e-6)
    if top_k and top_k > 0:
        kth = torch.sort(logits, dim=-1).values[:, -top_k][:, None]
        logits = torch.where(logits < kth, -1e30, logits)
    if 0.0 < top_p < 1.0:
        logits = _apply_top_p(logits, torch.full((logits.shape[0],), top_p,
                                                  dtype=torch.float32, device=logits.device))
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def _apply_top_p(logits, top_p, sorted_desc=None):
    """Nucleus filter: per row keep the smallest prefix of descending-prob
    tokens whose cumulative probability reaches ``top_p`` (the crossing token
    included, the top token always kept); rows with top_p >= 1 pass through."""
    if sorted_desc is None:
        sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_desc, dim=-1)
    prefix = torch.cumsum(probs, dim=-1) - probs
    keep = prefix < top_p[:, None]
    keep[:, 0] = True
    cutoff = torch.where(keep, sorted_desc, torch.inf).amin(dim=-1, keepdim=True)
    filtered = torch.where(logits < cutoff, -1e30, logits)
    return torch.where(top_p[:, None] >= 1.0, logits, filtered)


# Per-slot sampling streams. JAX keys every slot's stream with threefry and
# splits it once per decode step; threefry's bits are not reproduced here. A
# slot's stream is instead a (key, counter) pair of 32-bit integers: each draw
# hashes (key, counter, vocab index) to one uniform per logit (a fixed
# integer hash, the same on the CPU and the card) and takes the Gumbel-max
# sample, which is a draw from softmax(logits). A stream is thus a function of
# its own pair and its own logits alone: co-batched rows never share it, and
# saving the pair at preemption resumes it exactly.
_M32 = 0xFFFFFFFF


def _mix32(x):
    """A 32-bit integer hash (xor-shift-multiply) of x in [0, 2^32), on Python
    ints or int64 tensors; products wrap, and only their low 32 bits are
    kept."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x846CA68B) & _M32
    return x ^ (x >> 16)


def rng_key(*data):
    """A 32-bit stream key from integers (seeds, request ids, stream tags):
    each is folded in 32 bits at a time, as ``jax.random.fold_in``."""
    key = 0x243F6A88
    for d in data:
        d = int(d)
        chunks = [d & _M32, (d >> 32) & _M32] if 0 <= d < 1 << 64 else [hash(d) & _M32]
        for c in chunks:
            key = _mix32(key ^ _mix32(c))
    return key


def _uniforms(rng, n):
    """[b, n] float32 uniforms in (0, 1) of the streams ``rng`` [b, 2]
    (key, counter) at their current counters. 23 bits per draw: (m + 0.5)
    / 2^23 is exact in fp32 for m < 2^23, so the largest draw is 1 - 2^-24
    and never rounds up to 1 (where the Gumbel noise would be +inf)."""
    row = _mix32(rng[:, 0] ^ _mix32(rng[:, 1] & _M32))
    j = torch.arange(n, device=rng.device, dtype=torch.int64)
    return _unit_interval(_mix32(_mix32(row[:, None] ^ j[None, :]) ^ 0x5BD1E995))


def _unit_interval(bits):
    """32-bit integers (int64 tensor) -> float32 in (0, 1), strictly."""
    return ((bits >> 9).float() + 0.5) * (1.0 / (1 << 23))


def sample_token_per_request(logits, rng, *, temperature, top_k, top_p):
    """Per-request sampling for a slot pool: logits [b, vocab]; rng [b, 2]
    int64 (key, counter) — one stream per row, never shared; temperature,
    top_k, top_p [b] tensors. Rows with temperature <= 0 take the exact
    argmax (the first index wins ties, as the scalar greedy path). The
    top-k/top-p filters are JAX ``decoding.py:743``'s. Returns [b] int64;
    advancing the counters is the caller's (one draw per decode step)."""
    logits = logits.float()
    vocab = logits.shape[-1]
    greedy_tok = torch.argmax(logits, dim=-1)
    sampled_rows = temperature > 0.0
    scaled = logits / torch.clamp(temperature.float(), min=1e-6)[:, None]
    # per-row top-k: threshold at the k-th largest (k <= 0 disables)
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    k = torch.clamp(top_k.long(), 0, vocab)
    kth = sorted_desc.gather(1, torch.clamp(k - 1, 0, vocab - 1)[:, None])
    on = k[:, None] > 0
    scaled = torch.where(on & (scaled < kth), -1e30, scaled)
    # masking the same tail in the sorted array keeps it sorted: one sort
    sorted_masked = torch.where(on & (sorted_desc < kth), -1e30, sorted_desc)
    scaled = _apply_top_p(scaled, top_p.float(), sorted_desc=sorted_masked)
    gumbel = -torch.log(-torch.log(_uniforms(rng, vocab)))
    sampled = torch.argmax(scaled + gumbel, dim=-1)
    return torch.where(sampled_rows, sampled, greedy_tok)


def prefill_and_first_token(model, params, ids, generator, temperature, *, max_len,
                            greedy, top_k, dtype, true_len=None):
    """Prefill the KV cache with the prompt and sample the first new token.

    ``true_len`` supports right-padded bucketed prompts: the first token is
    sampled at column ``true_len - 1``. Pad slots past ``true_len`` hold
    garbage k/v but sit in the causally-masked future of every real query,
    and the decode loop overwrites each one when its position enters the
    window. Returns (tok [b], cache)."""
    b, prompt_len = ids.shape
    cache = init_cache(model.config, b, max_len, dtype, device=ids.device)
    logits = forward_with_cache(model, params, ids, cache, 0, max_len, prefill=True)
    last = logits[:, (prompt_len if true_len is None else true_len) - 1]
    tok = sample_token(last, generator, temperature=temperature, top_k=top_k, greedy=greedy)
    return tok, cache


def decode_tokens(model, params, cache, tok, generator, temperature, *, prompt_len,
                  max_len, steps, greedy, top_k):
    """``steps`` single-token decode iterations. Returns (toks [steps, b], cache)."""
    layers = unstack_layers(params, model.config.n_layers)
    out = []
    for i in range(steps):
        logits = forward_with_cache(model, params, tok[:, None], cache, prompt_len + i,
                                    max_len, layers=layers)
        tok = sample_token(logits[:, 0], generator, temperature=temperature,
                           top_k=top_k, greedy=greedy)
        out.append(tok)
    toks = torch.stack(out) if out else tok.new_empty((0, tok.shape[0]))
    return toks, cache


def decode_tokens_until(model, params, cache, tok, generator, temperature, *,
                        prompt_len, max_len, steps, greedy, top_k, eos_token_id):
    """Early-stopping decode: exits once EVERY row has emitted
    ``eos_token_id``; finished rows keep emitting eos. Returns
    (out [steps, b], cache) with positions past a row's eos filled with eos.
    Checking for the exit reads one flag from the device per step."""
    layers = unstack_layers(params, model.config.n_layers)
    out = torch.full((steps, tok.shape[0]), eos_token_id, dtype=tok.dtype, device=tok.device)
    done = tok == eos_token_id
    for i in range(steps):
        if bool(done.all()):
            break
        logits = forward_with_cache(model, params, tok[:, None], cache, prompt_len + i,
                                    max_len, layers=layers)
        nxt = sample_token(logits[:, 0], generator, temperature=temperature,
                           top_k=top_k, greedy=greedy)
        nxt = torch.where(done, torch.full_like(nxt, eos_token_id), nxt)
        out[i] = nxt
        done = done | (nxt == eos_token_id)
        tok = nxt
    return out, cache
