"""Transformer backbone and causal LM (port of ``deepspeed_tpu/models/transformer.py``).

The block covers the dense decoder variants: pre/post-norm, learned / rotary
(full, partial, interleaved) / ALiBi positions, MHA with optional GQA, gelu
MLP or SwiGLU, parallel attention + MLP (GPT-J, GPT-NeoX). Block params are
stacked along a leading layer axis, as the JAX package stacks them for its
layer scan; the port runs the layers in a Python loop over views.

Inference forward only: loss, remat, pipeline, ZeRO, sequence parallelism,
MoE and banded local attention raise ``NotImplementedError`` naming the
ROADMAP item that ports them.
"""

import dataclasses
import typing

import torch

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
    # loss-side knobs: parsed for config parity, read by the loss (ROADMAP A.6)
    fused_ce: bool = True
    fused_ce_chunks: int = 8
    fused_ce_impl: str = "xla"
    remat: bool = False
    remat_policy: str = "nothing_saveable"
    compute_dtype: typing.Any = torch.bfloat16
    attention_impl: str = "xla"  # xla | flash (the CUDA kernel; forward only)
    attention_logits_dtype: str = "fp32"
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
        if self.attention_impl in ("jax_flash", "block_sparse"):
            raise not_ported(f"attention_impl={self.attention_impl!r}", "A.9")
        if self.n_experts > 0:
            raise not_ported("mixture-of-experts layers (n_experts > 0)", "A.7")
        if self.local_attention_window > 0:
            raise not_ported("banded local attention (local_attention_window > 0)", "A.9")
        if self.sequence_parallel or self.pipeline_stages > 1:
            raise not_ported("sequence / pipeline parallelism", "A.7")
        if self.remat:
            raise not_ported("activation rematerialisation (remat)", "A.6")
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


def layer_params(stacked, i):
    """Views of layer ``i`` of the stacked block params."""
    return L.tree_map(lambda a: a[i], stacked)


def _cast_block_params(cfg, p):
    """Matmul weights to the compute dtype; norm params stay as stored."""
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
        if cfg.attention_impl == "flash" and alibi is None and mask is None:
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


def stack_apply(cfg, stacked_params, x, mask=None, rope=None, alibi=None):
    for i in range(cfg.n_layers):
        x = block_apply(cfg, layer_params(stacked_params, i), x, mask=mask,
                        rope=rope, alibi=alibi)
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

    def param_shapes(self):
        """{pytree path: shape} of every parameter this config has."""
        return {k: tuple(v.shape) for k, v in
                L.flatten_tree(self.init(device="meta")).items()}

    def load_params(self, params):
        """Register ``params`` (a tree of tensors) as this module's weights;
        missing or extra keys and shape mismatches raise."""
        expected = self.param_shapes()
        flat = L.flatten_tree(params)
        missing = sorted(set(expected) - set(flat))
        extra = sorted(set(flat) - set(expected))
        if missing or extra:
            raise ValueError(f"params do not match the model config: missing {missing}, "
                             f"unexpected {extra}")
        bad = {k: (tuple(v.shape), expected[k]) for k, v in flat.items()
               if tuple(v.shape) != expected[k]}
        if bad:
            raise ValueError(f"param shapes (got, expected) do not match the config: {bad}")
        self.set_tree(params)

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

    def loss(self, *args, **kwargs):
        raise not_ported("CausalLM.loss (training)", "A.6")
