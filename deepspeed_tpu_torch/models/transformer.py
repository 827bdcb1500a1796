"""Transformer backbone and causal LM (port of ``deepspeed_tpu/models/transformer.py``).

The block covers the dense decoder variants: pre/post-norm, learned / rotary
(full, partial, interleaved) / ALiBi positions, MHA with optional GQA, gelu
MLP or SwiGLU, parallel attention + MLP (GPT-J, GPT-NeoX). Block params are
stacked along a leading layer axis, as the JAX package stacks them for its
layer scan; the port runs the layers in a Python loop over one unbind of
each stacked leaf, so a backward stacks each leaf's per-layer grads once.
Attention is dense (``attention_impl="xla"``), flash or block-sparse (a
``sparse_pattern`` layout of ``sparse_block``-token blocks); the last two
run the CUDA kernels forward and backward, and fall to the dense path under
a padding mask or ALiBi, as in the JAX package.

Training: ``CausalLM.loss`` (shifted next-token labels, the fused
vocab-chunked cross-entropy or the materialized-logits one) and per-block
rematerialisation (``remat_policy="nothing_saveable"``). Other remat
policies, dropout in a training forward, pipeline, ZeRO, sequence
parallelism, MoE and banded local attention raise ``NotImplementedError``
naming the ROADMAP item that ports them.
"""

import dataclasses
import typing

import torch
import torch.utils.checkpoint

from . import layers as L
from ..utils import not_ported


@dataclasses.dataclass
class TransformerConfig:
    vocab_size: int = 50257
    max_seq_len: int = 1024
    n_layers: int = 12
    n_heads: int = 12
    d_model: int = 768
    d_ff: int = 3072
    n_kv_heads: typing.Optional[int] = None
    activation: str = "gelu_new"
    norm: str = "layernorm"  # layernorm | rmsnorm
    position_embedding: str = "learned"  # learned | rope | alibi | none
    rope_base: float = 10000.0
    # partial rotary: rope the first ``rotary_dim`` dims of each head. None = full.
    rotary_dim: typing.Optional[int] = None
    rotary_interleaved: bool = False  # GPT-J rotate-every-two pairing
    tie_embeddings: bool = True
    head_bias: bool = False  # untied LM head with bias (GPT-J)
    mlp_bias: typing.Optional[bool] = None  # None -> use_bias
    embed_layernorm: bool = False  # LN right after the embedding (BLOOM)
    causal: bool = True
    type_vocab_size: int = 0
    final_layernorm: bool = True
    local_attention_window: int = 0
    attention_layers: tuple = ()
    attn_scale: typing.Optional[float] = None  # None = 1/sqrt(head_dim)
    use_bias: bool = True
    prenorm: bool = True
    parallel_attn_mlp: bool = False
    parallel_norm_split: bool = False
    dropout: float = 0.0
    attn_dropout: float = 0.0
    layernorm_eps: float = 1e-5
    initializer_range: float = 0.02
    scan_layers: bool = True
    # loss-side knobs (CausalLM.head_ce); fused_ce_impl "pallas" is the CUDA
    # CE forward kernel, "xla" the chunked torch matmuls
    fused_ce: bool = True
    fused_ce_chunks: int = 8
    fused_ce_impl: str = "xla"
    remat: bool = False
    remat_policy: str = "nothing_saveable"
    compute_dtype: typing.Any = torch.bfloat16
    # xla | flash | block_sparse (the CUDA kernels, forward and backward)
    attention_impl: str = "xla"
    attention_logits_dtype: str = "fp32"
    # block_sparse: pattern name (dense|fixed|bigbird|bslongformer|variable),
    # block size in tokens and the pattern's kwargs
    sparse_pattern: str = "fixed"
    sparse_block: int = 128
    sparse_pattern_config: typing.Any = None
    attention_interpret: bool = False  # the TPU kernels' interpret mode; not read
    # q/k/v as one matmul in the JAX package; the port runs three, which is
    # the same function per output column
    fused_qkv: bool = True
    # The TPU kernel's tile sizes. Accepted so the same config resolves;
    # the CUDA kernel's tiles are fixed (64 x 64) and these are not read.
    flash_block_q: typing.Any = None
    flash_block_kv: typing.Any = None
    flash_block_q_bwd: typing.Any = None
    flash_block_kv_bwd: typing.Any = None
    pipeline_stages: int = 1
    pipeline_microbatches: int = 1
    mesh: typing.Any = None
    zero3_per_layer_gather: bool = False
    zero3_gather_specs: typing.Any = None
    zero3_gather_impl: str = "constraint"
    zero3_sharded_specs: typing.Any = None
    zero3_gather_dtype: str = "compute"
    zero3_gather_block: int = 256
    zero3_toplevel_gather_specs: typing.Any = None
    sequence_parallel: bool = False
    ring_inner_block: typing.Optional[int] = None
    # Serving: route the prefill (q_len == kv_len) through the flash kernel.
    # None = when the tensors are on CUDA (the kernel); True on the CPU = the
    # kernel's plain version; False = the dense cached path everywhere.
    prefill_flash: typing.Optional[bool] = None
    activation_quant_bits: int = 0
    activation_quant_group: int = 64
    head_dim_override: typing.Optional[int] = None
    n_experts: int = 0
    moe_top_k: int = 1
    moe_capacity_factor: float = 1.25
    moe_eval_capacity_factor: float = 0.0
    moe_min_capacity: int = 4
    moe_aux_loss_weight: float = 0.01
    moe_noise_std: float = 0.0
    moe_noisy_gate_policy: str = ""
    moe_use_rts: bool = False
    moe_use_residual: bool = False

    def __post_init__(self):
        alias = {"bfloat16": "bf16", "float32": "fp32", "f32": "fp32"}
        self.attention_logits_dtype = alias.get(
            str(self.attention_logits_dtype).lower(),
            str(self.attention_logits_dtype).lower())
        if self.attention_logits_dtype not in ("fp32", "bf16"):
            raise ValueError(
                f"attention_logits_dtype must be 'fp32' or 'bf16', got "
                f"{self.attention_logits_dtype!r}")
        if self.attention_impl not in ("xla", "flash", "jax_flash", "block_sparse"):
            raise ValueError(
                f"attention_impl must be one of xla|flash|jax_flash|"
                f"block_sparse, got {self.attention_impl!r}")
        if self.attention_impl == "jax_flash":
            raise not_ported("attention_impl='jax_flash'", "A.9")
        if self.n_experts > 0:
            raise not_ported("mixture-of-experts layers (n_experts > 0)", "A.7")
        if self.local_attention_window > 0:
            raise not_ported("banded local attention (local_attention_window > 0)", "A.9")
        if self.sequence_parallel or self.pipeline_stages > 1:
            raise not_ported("sequence / pipeline parallelism", "A.7")
        if self.remat and self.remat_policy != "nothing_saveable":
            raise not_ported(f"remat_policy={self.remat_policy!r} (the port rematerialises "
                             f"whole blocks: nothing_saveable)", "A.9")
        if self.activation_quant_bits:
            raise not_ported("activation quantization", "A.9")

    @property
    def attn_logits_torch_dtype(self):
        """None (exact fp32) or the low-precision logits dtype."""
        return torch.bfloat16 if self.attention_logits_dtype == "bf16" else None

    @property
    def head_dim(self):
        return self.head_dim_override or self.d_model // self.n_heads

    @property
    def kv_heads(self):
        return self.n_kv_heads or self.n_heads

    def num_params(self):
        """Analytic parameter count (embedding + blocks + final norm)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        q_dim = self.n_heads * self.head_dim
        kv_dim = self.kv_heads * self.head_dim
        per_block = d * q_dim + 2 * d * kv_dim + q_dim * d
        per_block += 3 * d * f if self.activation == "swiglu" else 2 * d * f
        per_block += 4 * d if self.use_bias else 0
        per_block += 2 * d
        total = self.n_layers * per_block + v * d
        if self.position_embedding == "learned":
            total += self.max_seq_len * d
        if not self.tie_embeddings:
            total += v * d
        return int(total)


def _norm_init(cfg, **kw):
    if cfg.norm == "layernorm":
        return L.layernorm_init(cfg.d_model, **kw)
    return L.rmsnorm_init(cfg.d_model, **kw)


def _norm_apply(cfg, p, x):
    if cfg.norm == "layernorm":
        return L.layernorm_apply(p, x, eps=cfg.layernorm_eps)
    return L.rmsnorm_apply(p, x, eps=cfg.layernorm_eps)


def _mlp_init(gen, cfg, **kw):
    std = cfg.initializer_range
    # GPT-2 scales residual-projection init by 1/sqrt(2L)
    out_std = std / (2.0 * cfg.n_layers) ** 0.5
    bias = cfg.use_bias if cfg.mlp_bias is None else cfg.mlp_bias
    if cfg.activation == "swiglu":
        return {
            "gate": L.linear_init(gen, cfg.d_model, cfg.d_ff, bias, std, **kw),
            "up": L.linear_init(gen, cfg.d_model, cfg.d_ff, bias, std, **kw),
            "down": L.linear_init(gen, cfg.d_ff, cfg.d_model, bias, out_std, **kw),
        }
    return {
        "fc": L.linear_init(gen, cfg.d_model, cfg.d_ff, bias, std, **kw),
        "proj": L.linear_init(gen, cfg.d_ff, cfg.d_model, bias, out_std, **kw),
    }


def _mlp_apply(cfg, p, x):
    if cfg.activation == "swiglu":
        gate = L.linear_apply(p["gate"], x)
        up = L.linear_apply(p["up"], x)
        return L.linear_apply(p["down"], torch.nn.functional.silu(gate) * up)
    act = L.ACTIVATIONS[cfg.activation]
    return L.linear_apply(p["proj"], act(L.linear_apply(p["fc"], x)))


def block_init(gen, cfg, **kw):
    """One block's params; ``lead=(n_layers,)`` in ``kw`` stacks all blocks."""
    out_std = cfg.initializer_range / (2.0 * cfg.n_layers) ** 0.5
    return {
        "ln_1": _norm_init(cfg, **kw),
        "attn": L.attention_init(
            gen, cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.use_bias,
            cfg.initializer_range, out_stddev=out_std, head_dim=cfg.head_dim, **kw),
        "ln_2": _norm_init(cfg, **kw),
        "mlp": _mlp_init(gen, cfg, **kw),
    }


def stack_init(gen, cfg, **kw):
    """All blocks stacked along a leading layer dim (the JAX ``stack_init`` layout)."""
    return block_init(gen, cfg, lead=(cfg.n_layers,), **kw)


# the leaves a weight-only quantized linear holds instead of its "kernel"
_QUANTIZED_LEAVES = ("kernel_q", "kernel_q4", "kernel_scale")


def layer_params(stacked, i):
    """Views of layer ``i`` of the stacked block params (quantized leaves
    included: ``kernel_scale`` [L, groups, 1, out] gives [groups, 1, out])."""
    return L.tree_map(lambda a: a[i], stacked)


def _cast_block_params(cfg, p):
    """Matmul weights to the compute dtype; norm params stay as stored.
    Only floating leaves are cast, as in the JAX package: the int8/uint8
    payloads of a quantized linear stay, and its fp32 ``kernel_scale`` goes
    to the compute dtype (in bf16 serving the dequant sees a bf16 scale on
    both sides)."""
    cast = lambda a: a.to(cfg.compute_dtype) if a.is_floating_point() else a
    return {"ln_1": p["ln_1"], "ln_2": p["ln_2"],
            "attn": L.tree_map(cast, p["attn"]), "mlp": L.tree_map(cast, p["mlp"])}


def block_apply(cfg, p, x, mask=None, rope=None, alibi=None):
    """One transformer block (inference). x: [batch, seq, d_model]."""
    x = x.to(cfg.compute_dtype)
    p = _cast_block_params(cfg, p)
    b, s, _ = x.shape

    def attn(h):
        pa = p["attn"]
        q = L.linear_apply(pa["q"], h)
        k = L.linear_apply(pa["k"], h)
        v = L.linear_apply(pa["v"], h)
        q = q.reshape(b, s, -1, cfg.head_dim)
        k = k.reshape(b, s, -1, cfg.head_dim)
        v = v.reshape(b, s, -1, cfg.head_dim)
        if rope is not None:
            cos, sin = rope
            q = L.apply_rotary(q, cos, sin, cfg.rotary_dim, cfg.rotary_interleaved)
            k = L.apply_rotary(k, cos, sin, cfg.rotary_dim, cfg.rotary_interleaved)
        if cfg.attention_impl == "block_sparse" and alibi is None and mask is None:
            # the block-sparse kernels take one head count, as in JAX
            n_rep = cfg.n_heads // cfg.kv_heads
            out = _block_sparse_attn(cfg, s, q.device)(q, L._repeat_kv(k, n_rep),
                                                       L._repeat_kv(v, n_rep))
        elif cfg.attention_impl == "flash" and alibi is None and mask is None:
            from ..ops.flash_attention import flash_attention

            # the kernel reads the unrepeated GQA kv heads itself
            out = flash_attention(q, k, v, causal=cfg.causal, scale=cfg.attn_scale)
        else:
            n_rep = cfg.n_heads // cfg.kv_heads
            dense_mask = mask if mask is not None else (
                L.causal_mask(s, s, device=x.device) if cfg.causal else None)
            out = L.dot_product_attention(
                q, L._repeat_kv(k, n_rep), L._repeat_kv(v, n_rep), mask=dense_mask,
                scale=cfg.attn_scale, alibi_bias=alibi,
                logits_dtype=cfg.attn_logits_torch_dtype)
        return L.linear_apply(pa["o"], out.reshape(b, s, -1))

    def mlp(h):
        return _mlp_apply(cfg, p["mlp"], h)

    if cfg.parallel_attn_mlp:
        h = _norm_apply(cfg, p["ln_1"], x)
        h_mlp = _norm_apply(cfg, p["ln_2"], x) if cfg.parallel_norm_split else h
        return x + attn(h) + mlp(h_mlp)
    if cfg.prenorm:
        x = x + attn(_norm_apply(cfg, p["ln_1"], x))
        return x + mlp(_norm_apply(cfg, p["ln_2"], x))
    x = _norm_apply(cfg, p["ln_1"], x + attn(x))
    return _norm_apply(cfg, p["ln_2"], x + mlp(x))


_SPARSE_ATTN_CACHE = {}


def _block_sparse_attn(cfg, seq, device):
    """The config's ``BlockSparseAttention``, cached per pattern, shape and
    device (its layout and active lists are built once and live on the
    device), as the JAX package's ``_block_sparse_attn`` caches per shape."""
    from ..ops import sparse_attention as SA

    key = (cfg.sparse_pattern, cfg.sparse_block, repr(cfg.sparse_pattern_config), seq,
           cfg.causal, cfg.attn_scale, str(device))
    if key not in _SPARSE_ATTN_CACHE:
        sp = SA.PATTERNS[cfg.sparse_pattern](block=cfg.sparse_block,
                                             **dict(cfg.sparse_pattern_config or {}))
        _SPARSE_ATTN_CACHE[key] = SA.BlockSparseAttention(
            sp, seq, causal=cfg.causal, scale=cfg.attn_scale, device=device)
    return _SPARSE_ATTN_CACHE[key]


def unstack_layers(cfg, stacked_params):
    """Every layer's params from ONE cast and ONE unbind per stacked leaf:
    the matmul weights go to the compute dtype (norm params stay as stored,
    as ``_cast_block_params`` keeps them), so a backward casts and stacks
    each leaf's per-layer grads once instead of scattering each layer's
    grad into a zero copy of the whole stack. As ``_cast_block_params``,
    only floating leaves are cast: quantized payloads stay int8/uint8 and
    ``kernel_scale`` goes to the compute dtype."""
    parts = {}
    for path, leaf in L.flatten_tree(stacked_params).items():
        if path.split("/")[0] in ("attn", "mlp") and leaf.is_floating_point():
            leaf = leaf.to(cfg.compute_dtype)
        parts[path] = leaf.unbind(0)
    return [L.unflatten_tree({path: p[i] for path, p in parts.items()})
            for i in range(cfg.n_layers)]


def stack_apply(cfg, stacked_params, x, mask=None, rope=None, alibi=None):
    """The blocks in order. With ``remat`` and grad on, each block is
    rematerialised in the backward (``nothing_saveable``: only its input is
    kept)."""
    remat = cfg.remat and torch.is_grad_enabled()
    for p in unstack_layers(cfg, stacked_params):
        if remat:
            x = torch.utils.checkpoint.checkpoint(block_apply, cfg, p, x, mask, rope, alibi,
                                                  use_reentrant=False)
        else:
            x = block_apply(cfg, p, x, mask=mask, rope=rope, alibi=alibi)
    return x


class CausalLM(L.ParamTree):
    """Decoder-only LM over the generic backbone. The model families are
    ``TransformerConfig`` presets (``models/registry.py``).

    The module holds its weights as a parameter tree keyed like the JAX
    params pytree (``wte.weight``, ``blocks.attn.q.kernel``, ...); the
    functional ``apply(params, ids)`` takes any such tree, as the JAX
    ``CausalLM.apply`` does, and ``forward(ids)`` runs the module's own."""

    def __init__(self, config: TransformerConfig):
        super().__init__()
        self.config = config

    # -- params ---------------------------------------------------------------------
    def init(self, generator=None, dtype=torch.float32, device="cpu"):
        """A fresh params tree, drawn from ``generator`` with the JAX package's
        distributions (not its values: torch and JAX draw different numbers),
        directly in ``dtype`` on ``device``. ``device="meta"`` gives shapes only."""
        cfg = self.config
        kw = dict(dtype=dtype, device=device)
        params = {
            "wte": L.embedding_init(generator, cfg.vocab_size, cfg.d_model,
                                    cfg.initializer_range, **kw),
            "blocks": stack_init(generator, cfg, **kw),
        }
        if cfg.final_layernorm:
            params["ln_f"] = _norm_init(cfg, **kw)
        if cfg.position_embedding == "learned":
            params["wpe"] = {"weight": L.normal_init(
                generator, (cfg.max_seq_len, cfg.d_model), cfg.initializer_range, **kw)}
        if cfg.type_vocab_size:
            params["wtt"] = {"weight": L.normal_init(
                generator, (cfg.type_vocab_size, cfg.d_model), cfg.initializer_range, **kw)}
        if cfg.embed_layernorm:
            params["ln_emb"] = _norm_init(cfg, **kw)
        if not cfg.tie_embeddings:
            params["lm_head"] = L.linear_init(
                generator, cfg.d_model, cfg.vocab_size, bias=cfg.head_bias,
                stddev=cfg.initializer_range, **kw)
        return params

    def param_shapes(self, like=None):
        """{pytree path: shape} of every parameter this config has.

        ``like`` (a flat {path: leaf} tree of tensors or numpy arrays): a
        weight-only quantized kernel in it (``inference/engine.py
        _quantize_weights``) takes the place of its float ``kernel``:
        ``kernel_q`` [..., in, out], ``kernel_q4`` [..., in/2, out] and
        ``kernel_scale`` [..., groups, 1, out], with the group count read from
        ``like`` (it must divide in)."""
        dense = {k: tuple(v.shape) for k, v in
                 L.flatten_tree(self.init(device="meta")).items()}
        shapes = dict(dense)
        for path, leaf in (like or {}).items():
            base, _, name = path.rpartition("/")
            kernel = f"{base}/kernel"
            if name not in _QUANTIZED_LEAVES or kernel not in dense:
                continue
            shapes.pop(kernel, None)
            *lead, d_in, d_out = dense[kernel]
            if name == "kernel_q":
                shapes[path] = (*lead, d_in, d_out)
            elif name == "kernel_q4":
                shapes[path] = (*lead, d_in // 2 if d_in % 2 == 0 else -1, d_out)
            else:
                groups = leaf.shape[-3] if len(leaf.shape) >= 3 else 0
                ok = groups > 0 and d_in % groups == 0
                shapes[path] = (*lead, groups if ok else -1, 1, d_out)
        return shapes

    def load_params(self, params, requires_grad=False):
        """Register ``params`` (a tree of tensors) as this module's weights
        (trainable with ``requires_grad``); missing or extra keys and shape
        mismatches raise. Weight-only quantized kernels are taken in place of
        their float kernels (``param_shapes(like=...)``)."""
        flat = L.flatten_tree(params)
        expected = self.param_shapes(like=flat)
        missing = sorted(set(expected) - set(flat))
        extra = sorted(set(flat) - set(expected))
        if missing or extra:
            raise ValueError(f"params do not match the model config: missing {missing}, "
                             f"unexpected {extra}")
        bad = {k: (tuple(v.shape), expected[k]) for k, v in flat.items()
               if tuple(v.shape) != expected[k]}
        if bad:
            raise ValueError(f"param shapes (got, expected) do not match the config: {bad}")
        self.set_tree(params, requires_grad=requires_grad)

    @property
    def params(self):
        return self.tree()

    # -- forward ------------------------------------------------------------------
    def backbone(self, params, input_ids, positions=None, attention_mask=None,
                 token_type_ids=None):
        """Embedding + blocks + final norm -> [batch, seq, d_model]."""
        cfg = self.config
        b, s = input_ids.shape
        dev = input_ids.device
        if positions is None:
            positions = torch.arange(s, device=dev)[None, :].expand(b, s)

        x = L.embedding_apply(params["wte"], input_ids, cfg.compute_dtype)
        if cfg.position_embedding == "learned":
            x = x + params["wpe"]["weight"].to(cfg.compute_dtype)[positions]
        if cfg.type_vocab_size and token_type_ids is not None:
            x = x + params["wtt"]["weight"].to(cfg.compute_dtype)[token_type_ids]
        if cfg.embed_layernorm:
            x = _norm_apply(cfg, params["ln_emb"], x)

        mask = None
        if attention_mask is not None:
            pad = attention_mask[:, None, None, :].bool()
            mask = (L.causal_mask(s, s, device=dev) & pad) if cfg.causal else \
                pad.expand(b, 1, s, s)
        rope = None
        if cfg.position_embedding == "rope":
            rope = L.rotary_embedding(positions, cfg.rotary_dim or cfg.head_dim, cfg.rope_base)
        alibi = None
        if cfg.position_embedding == "alibi":
            alibi = L.alibi_bias(cfg.n_heads, s, s, device=dev)

        x = stack_apply(cfg, params["blocks"], x, mask=mask, rope=rope, alibi=alibi)
        if cfg.final_layernorm:
            x = _norm_apply(cfg, params["ln_f"], x)
        return x

    def head(self, params, x):
        """Hidden states -> logits [batch, seq, vocab] (compute dtype)."""
        if self.config.tie_embeddings:
            return L.embedding_attend(params["wte"], x)
        return L.linear_apply(params["lm_head"], x)

    def apply(self, params, input_ids, positions=None, attention_mask=None):
        """input_ids: [batch, seq] -> logits [batch, seq, vocab]."""
        x = self.backbone(params, input_ids, positions=positions,
                          attention_mask=attention_mask)
        return self.head(params, x)

    def forward(self, input_ids, positions=None, attention_mask=None):
        return self.apply(self.params, input_ids, positions=positions,
                          attention_mask=attention_mask)

    def head_ce(self, params, x, labels):
        """Cross entropy from post-final-norm hidden states: the fused
        vocab-chunked op (``fused_ce``) or the materialized-logits one."""
        cfg = self.config
        if cfg.fused_ce:
            from ..ops.cross_entropy import fused_cross_entropy

            if cfg.tie_embeddings:
                emb, bias = params["wte"]["weight"], None
            else:
                emb = params["lm_head"]["kernel"].T
                bias = params["lm_head"].get("bias")  # GPT-J biased head
            return fused_cross_entropy(x.reshape(-1, cfg.d_model), emb, labels.reshape(-1),
                                       bias, n_chunks=cfg.fused_ce_chunks,
                                       impl=cfg.fused_ce_impl)
        return cross_entropy_loss(self.head(params, x), labels)

    def loss(self, params, batch, deterministic=True):
        """Next-token cross entropy. batch: {input_ids, labels?,
        attention_mask?, position_ids?}; labels default to input_ids shifted
        left with -100 (ignored) at the last position. ``deterministic=False``
        is a training forward, which would apply dropout: a config with
        dropout raises (ROADMAP A.9)."""
        cfg = self.config
        if not deterministic and (cfg.dropout > 0 or cfg.attn_dropout > 0):
            raise not_ported("dropout in a training forward (dropout / attn_dropout > 0)",
                             "A.9")
        input_ids = batch["input_ids"]
        labels = batch.get("labels")
        if labels is None:
            labels = torch.cat([input_ids[:, 1:], torch.full_like(input_ids[:, :1], -100)],
                               dim=1)
        x = self.backbone(params, input_ids, positions=batch.get("position_ids"),
                          attention_mask=batch.get("attention_mask"))
        return self.head_ce(params, x, labels)


def cross_entropy_loss(logits, labels, ignore_index=-100):
    """Token-mean cross entropy in fp32; ``ignore_index`` labels masked out."""
    logits = logits.float()
    valid = labels != ignore_index
    safe_labels = torch.where(valid, labels, 0)
    logz = torch.logsumexp(logits, dim=-1)
    token_ll = torch.gather(logits, -1, safe_labels[..., None].long())[..., 0]
    nll = (logz - token_ll) * valid
    return nll.sum() / valid.sum().clamp(min=1)
