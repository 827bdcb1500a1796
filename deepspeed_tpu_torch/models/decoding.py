"""KV-cache decoding, dense cache (port of the dense half of ``deepspeed_tpu/models/decoding.py``).

The cache is ``{"k", "v"}`` of ``[layers, batch, max_len, kv_heads, head_dim]``.
The JAX package rebuilds it functionally inside a jitted step and lets XLA
alias the update through buffer donation; here it is updated IN PLACE (each
layer writes its new rows into a view of the stacked tensor), which is what
the donation bought there: one cache, never a copy per step.

Prefill (``prefill=True``, scalar cursor 0, more than one query row) sends
attention through the flash-attention forward: the CUDA kernel when the
tensors are on the card, its plain version on the CPU. Decode steps attend
with plain PyTorch over the dense cache, as the JAX decode does outside any
Pallas kernel. The JAX decode loop is a compiled ``scan``; this one is an
eager Python loop (CUDA graphs are later work).
"""

import torch

from . import layers as L
from .transformer import _mlp_apply, _norm_apply, layer_params
from ..utils import not_ported


def init_cache(cfg, batch_size, max_len, dtype=None, device="cpu"):
    """The KV cache: k/v stacked over layers, like the stacked block params."""
    dtype = dtype or cfg.compute_dtype
    shape = (cfg.n_layers, batch_size, max_len, cfg.kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


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

    k_cache/v_cache: [b, max_len, kvh, dh] views of the stacked cache; pos: a
    Python int (per-row cursors are the serving slice's, ROADMAP A.2)."""
    if not isinstance(pos, int):
        raise not_ported("per-row cache cursors (slot-pool decode)", "A.2")
    b, q_len, _ = h.shape
    q, k, v = _project_qkv(cfg, p_attn, h, rope=rope)
    if pos + q_len > k_cache.shape[1]:
        raise ValueError(f"cache write [{pos}, {pos + q_len}) overruns max_len {k_cache.shape[1]}")
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
    if flash_wanted and prefill and q_len > 1 and cfg.position_embedding != "alibi":
        from ..ops.flash_attention import flash_attention

        out = flash_attention(q, k.to(k_cache.dtype), v.to(v_cache.dtype),
                              causal=True, scale=cfg.attn_scale)
        return L.linear_apply(p_attn["o"], out.reshape(b, q_len, -1))

    n_rep = cfg.n_heads // cfg.kv_heads
    k_full = L._repeat_kv(k_cache[:, :kv_len], n_rep)
    v_full = L._repeat_kv(v_cache[:, :kv_len], n_rep)
    # causal vs the cache: query i (global pos+i) sees cache slots <= pos+i
    kv_idx = torch.arange(kv_len, device=h.device)[None, :]
    q_idx = pos + torch.arange(q_len, device=h.device)[:, None]
    mask = (kv_idx <= q_idx)[None, None]
    alibi = None
    if cfg.position_embedding == "alibi":
        alibi = _alibi_slice(cfg, q_len, kv_len, pos, h.device)
    out = L.dot_product_attention(q, k_full, v_full, mask=mask, scale=cfg.attn_scale,
                                  alibi_bias=alibi, logits_dtype=cfg.attn_logits_torch_dtype)
    # -1, not d: head-pruned models have attention width n_heads*head_dim < d
    return L.linear_apply(p_attn["o"], out.reshape(b, q_len, -1))


def _mlp(cfg, p, h):
    mp = L.tree_map(lambda a: a.to(h.dtype) if a.is_floating_point() else a, p["mlp"])
    return _mlp_apply(cfg, mp, h)


def _block_cached(cfg, p, x, k_cache, v_cache, pos, kv_len, rope=None, prefill=False):
    """One block with cache. x: [b, q, d] compute dtype."""
    cast = lambda a: a.to(cfg.compute_dtype) if a.is_floating_point() else a
    p_attn = L.tree_map(cast, p["attn"])

    def attn(h):
        return _attn_with_cache(cfg, p_attn, h, k_cache, v_cache, pos, kv_len,
                                rope=rope, prefill=prefill)

    if cfg.parallel_attn_mlp:
        h = _norm_apply(cfg, p["ln_1"], x)
        h_mlp = _norm_apply(cfg, p["ln_2"], x) if cfg.parallel_norm_split else h
        return x + attn(h) + _mlp(cfg, p, h_mlp)
    if cfg.prenorm:
        x = x + attn(_norm_apply(cfg, p["ln_1"], x))
        return x + _mlp(cfg, p, _norm_apply(cfg, p["ln_2"], x))
    x = _norm_apply(cfg, p["ln_1"], x + attn(x))
    return _norm_apply(cfg, p["ln_2"], x + _mlp(cfg, p, x))


def unstack_layers(params, n_layers):
    """Per-layer views of the stacked block params (built once per request,
    not once per decode step)."""
    return [layer_params(params["blocks"], i) for i in range(n_layers)]


def forward_with_cache(model, params, input_ids, cache, pos, kv_len, prefill=False,
                       layers=None):
    """Run the model on ``input_ids`` [b, q] writing k/v into ``cache`` at ``pos``.

    Prefill (q = prompt length, pos = 0) and decode (q = 1, pos = cursor).
    Returns logits [b, q, vocab]; the cache is updated in place.
    ``prefill=True`` is the caller's promise that pos == 0 and the whole
    visible window is this q block — it unlocks the flash path.
    ``layers``: ``unstack_layers(params, n_layers)``, when the caller has it.

    As in the JAX package, the embedding LayerNorm (``embed_layernorm``,
    BLOOM) is not applied on this path."""
    cfg = model.config
    b, q_len = input_ids.shape
    dev = input_ids.device
    positions = (pos + torch.arange(q_len, device=dev))[None, :].expand(b, q_len)

    x = L.embedding_apply(params["wte"], input_ids, cfg.compute_dtype)
    if cfg.position_embedding == "learned":
        wpe = params["wpe"]["weight"]
        if pos + q_len > wpe.shape[0]:
            raise ValueError(f"positions up to {pos + q_len} exceed max_seq_len {wpe.shape[0]}")
        x = x + wpe.to(cfg.compute_dtype)[positions]
    rope = None
    if cfg.position_embedding == "rope":
        rope = L.rotary_embedding(positions, cfg.rotary_dim or cfg.head_dim, cfg.rope_base)

    if layers is None:
        layers = unstack_layers(params, cfg.n_layers)
    for i, p_i in enumerate(layers):
        x = _block_cached(cfg, p_i, x, cache["k"][i], cache["v"][i], pos, kv_len,
                          rope=rope, prefill=prefill)
    x = _norm_apply(cfg, params["ln_f"], x)
    if cfg.tie_embeddings:
        return L.embedding_attend(params["wte"], x)
    return L.linear_apply(params["lm_head"], x)


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
