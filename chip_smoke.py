#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (``deepspeed_tpu_torch``) on one NVIDIA GPU and check it.

    python3 chip_smoke.py        # from the root of a checkout; one CUDA card, nvcc

Phases, in order; any failed check raises and the script exits non-zero:
  0. the card's name and power limit (nvidia-smi);
  1. build every kernel from ``deepspeed_tpu_torch/csrc`` (one nvcc per source,
     all started together);
  2. each kernel against its plain PyTorch version on the card, at the main
     paths' shapes and a few more, with its time, the plain version's time,
     the least time the card could take (the bound) and one PyTorch library
     call computing the same function as a yardstick (never used by the port);
     the flash forward and backward at the main paths' shapes on their TMA +
     wgmma route (bf16 at head_dim 128 and 64), the CE forward and the
     block-sparse backward on theirs, each case also held and timed through
     the old wmma route in turns (``_route="wmma"``); the
     quantized matmul (int8, int4) at Llama-7B's linears for every token
     count phase 7 runs (a TMA + wgmma route case also through the old wmma
     route, in turns), and the paged decode on an int8 pool; the attention
     kernels (flash forward with lse, flash backward, block-sparse forward
     and backward) at head_dim 32, 80, 96 and 256;
  3. the card against the CPU port: Llama-7B width with 2 layers in fp32, the
     same seeded weights on both; prefill logits and 8 greedy tokens, then
     ``serve()`` of a few staggered requests: the card's ``fused`` streams
     against the CPU port's ``gather`` streams and the card's ``generate()``;
     then training at GPT-2-medium width with 2 layers in fp32: one step's
     loss and grads, and the losses of 3 ``train_batch`` steps; then int8
     and int4 weights quantized on the card against the CPU port on the same
     quantized tree, and one decode step on an int8 pool (fused on the card
     against gather on the card and on the CPU);
  4. the generate path: ``init_inference`` on full Llama-7B (32 layers, bf16,
     random weights from a seed) answering requests through ``generate()``,
     with every kernel's launch count read around it (phases 4-7: every
     flash launch on the wgmma route);
  5. the serving path: the same engine's ``serve()`` (8 slots, a paged KV
     pool of 2048-token windows, the ``fused`` decode backend) answering 16
     staggered requests on the wall clock, twice, with the launch counts
     read around the first run, a fused-against-gather decode step and a
     profile of a decode stretch;
  6. the training path: ``initialize`` on full GPT-2 medium at bench.py's
     shape and config (seq 1024, batch 12, bf16, AdamW, ZeRO 0, flash
     attention, the CE forward kernel), 2 warm-up and 8 timed ``train_batch``
     steps on one fixed batch, with the launch counts read around every step
     (every flash and CE launch on the wgmma route) and one more step under
     the profiler;
  7. the quantized serving path: ``init_inference`` on full Llama-7B with
     ``quant`` int8 (group 64) and an int8 paged pool with the ``fused``
     backend, ``generate()`` over a subset of phase 4's requests and
     ``serve()`` of phase 5's traffic as phase 5 runs it; then ``quant`` int4
     with ``generate()`` over the same requests. Each forward launches 7
     quantized matmuls per layer (a prefill's through the TMA + wgmma route,
     counted by route), each decode step one int8 paged decode per layer and
     none of the 16-bit pool's; a quantized matmul shape that phase 2 did not
     check fails the run;
  8. the block-sparse training path: phase 6's model and config with
     ``attention_impl="block_sparse"`` (the fixed pattern of 128-token blocks,
     4 local and 1 global), 2 warm-up and 8 timed ``train_batch`` steps and
     one ``eval_batch``, with the launch counts read around every step (24
     block-sparse forward, 24 backward and 1 CE launch, the backward and CE
     on their wgmma routes, no flash launch) and
     one more step under the profiler. Phase 2 holds the block-sparse
     forward and backward against their plain versions at its layers, at
     the same tokens as b 3 x s 4096 (beside the dense flash kernels) and at
     every pattern, block 16-128 and dtype at small sizes; phase 3 trains 2
     layers of it at GPT-2-medium width on the card against the CPU port;
  9. the head dims beside 64 and 128: OPT-2.7B (80), GPT-NeoX-20B (96) and
     GPT-J-6B (256) at full width with 2 layers, fp32, the same seeded
     weights on the card and on the CPU port: ``generate()`` on a 128-token
     prompt (prefill logits, 8 greedy tokens), and one ``train_batch`` step
     at b 1 x s 128 (its loss and every grad) with flash attention, and at
     GPT-J's 256 with block-sparse attention too.
The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

H100_BF16_FLOPS = 989e12   # dense tensor-core peak, bf16/fp16 (H100 SXM data sheet)
H100_FP32_FLOPS = 67e12    # fp32 without tensor cores
H100_BYTES = 3.35e12       # HBM3 bytes/s

# |kernel - plain| per element: bf16 within ATOL_16 + rounding_bound (what
# rounding P and the outputs to bf16 explains, ops/cuda/flash_attention.py);
# fp32, which differs only in summation order, within 2e-5 + 2e-5 |plain|
ATOL_16 = 1e-5
TOL_FP32 = (2e-5, 2e-5)

# the engine config of phases 4 and 5 (its serving block is phase 5's slot
# pool); phase 4's requests: (name, (batch, prompt length)), MAX_NEW tokens each
MAIN_CONFIG = {"dtype": "bfloat16", "max_tokens": 2048, "seed": 0,
               "serving": {"n_slots": 8, "max_len": 2048,
                           "kv_pool": {"enabled": True, "block_size": 16,
                                       "attention_backend": "fused", "prefix_cache": True}}}
MAX_NEW = 64
REQUESTS = (("single-57", (1, 57)), ("single-300", (1, 300)), ("single-900", (1, 900)),
            ("single-1700", (1, 1700)), ("batch4x512", (4, 512)))
SAMPLED = ((1, 300), 16)  # a sampled request: (batch, prompt length), new tokens

# phase 5's traffic: SERVE_N requests SERVE_GAP s apart, prompt lengths
# cycling SERVE_PROMPTS, MAX_NEW tokens each; request SHARED[1] repeats the
# first SHARED_PREFIX tokens of request SHARED[0]; request SAMPLED_REQ samples
SERVE_PROMPTS = (57, 300, 900, 1700)
SERVE_N, SERVE_GAP = 16, 0.05
SHARED, SHARED_PREFIX = (2, 6), 512
PROFILED_STEPS = 16        # decode steps of run 2 under the profiler
SAMPLED_REQ = (5, {"temperature": 0.8, "top_k": 40, "seed": 7})

# phase 7: the quantized engines answer this subset of phase 4's requests
# (the shortest, the longest single and the batch) and phase 5's traffic;
# Llama-7B's linear shapes (k, n): q/k/v/o, gate/up, down
QUANT_REQUESTS = ("single-57", "single-1700", "batch4x512")
LLAMA_LINEARS = ((4096, 4096), (4096, 11008), (11008, 4096))

# phase 6: bench.py's training shape and engine config (bench.py:264-311)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_VOCAB = 12, 1024, 50304
TRAIN_WARMUP, TRAIN_STEPS = 2, 8
TRAIN_CONFIG = {"train_batch_size": TRAIN_BATCH, "bf16": {"enabled": True},
                "optimizer": {"type": "adamw", "params": {"lr": 1e-4, "weight_decay": 0.01}},
                "zero_optimization": {"stage": 0}, "gradient_clipping": 1.0,
                "steps_per_print": 1000000}
# phase 8: phase 6's model and config with block-sparse attention, the JAX
# package's default pattern (sparsity_config.py:56-77): fixed, 128-token
# blocks, 4 local and 1 global (24 of the 36 causal blocks at seq 1024)
SPARSE_ATTENTION = {"attention_impl": "block_sparse", "sparse_pattern": "fixed",
                    "sparse_block": 128,
                    "sparse_pattern_config": {"num_local_blocks": 4, "num_global_blocks": 1}}


def log(msg):
    print(msg, flush=True)


def time_ms(fn, iters):
    """Mean device time of ``fn`` over ``iters`` back-to-back calls (CUDA events)."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def route_turns(kernel, old, iters):
    """The kernel's time and the old route's, in turns (old, new, new, old),
    each the mean of its two turns: one card, one call, drift cancelled."""
    t = [time_ms(f, iters) for f in (old, kernel, kernel, old)]
    return (t[1] + t[2]) / 2, (t[0] + t[3]) / 2


def attention_flops(b, s_q, s_kv, h, d, causal):
    """Operations the attention forward needs: 4 * b * h * d per allowed
    (query, key) pair (two products of d multiply-adds each)."""
    if causal:
        off = s_kv - s_q
        pairs = s_q * (off + 1) + s_q * (s_q - 1) // 2
    else:
        pairs = s_q * s_kv
    return 4 * b * h * d * pairs


def main_path_prefill_shapes():
    """The (batch, prompt bucket) of every flash prefill phases 4 and 5 run,
    by the engine's own bucket rules on its own config: ``generate()``
    buckets against ``max_tokens - max_new_tokens``, serving against the
    slot window ``serving.max_len``."""
    from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig
    from deepspeed_tpu_torch.inference.engine import bucket_prompt_len

    cfg = DeepSpeedInferenceConfig.from_dict(MAIN_CONFIG)
    reqs = [(shape, MAX_NEW) for _, shape in REQUESTS] + [SAMPLED]
    shapes = {(b, bucket_prompt_len(cfg, n, cfg.max_tokens - new)) for (b, n), new in reqs}
    shapes |= {(1, bucket_prompt_len(cfg, n, cfg.serving.max_len)) for n in SERVE_PROMPTS}
    return sorted(shapes)


def serving_traffic(vocab):
    """Phase 5's requests as dicts (``Request`` fields), from seed 0."""
    import numpy as np

    rng = np.random.RandomState(0)
    out = []
    for i in range(SERVE_N):
        prompt = rng.randint(0, vocab, SERVE_PROMPTS[i % len(SERVE_PROMPTS)])
        if i == SHARED[1]:
            prompt[:SHARED_PREFIX] = out[SHARED[0]]["prompt"][:SHARED_PREFIX]
        req = {"prompt": prompt, "max_new_tokens": MAX_NEW, "arrival_time": i * SERVE_GAP}
        if i == SAMPLED_REQ[0]:
            req["sampling"] = dict(SAMPLED_REQ[1])
        out.append(req)
    return out


def decode_cursors():
    """The ragged cursors phase 5's decode reaches: each prompt length at
    its first decode step and at its last."""
    return [n for n in SERVE_PROMPTS] + [n + MAX_NEW - 2 for n in SERVE_PROMPTS]


def phase_kernels(torch, F, main_shapes):
    from deepspeed_tpu_torch.ops.cuda.flash_attention import (attention_route,
                                                              flash_attention_fwd,
                                                              flash_attention_reference,
                                                              rounding_bound)

    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        # Llama-7B attention (h 32, d 128) at every prefill shape of phase 4
        for b, s in main_shapes:
            cases.append((f"main-b{b}-s{s}", b, s, s, 32, 32, 128, True, dtype))
        cases += [
            ("llama7b-s128", 1, 128, 128, 32, 32, 128, True, dtype),
            ("gpt2-medium", 2, 512, 512, 16, 16, 64, True, dtype),
            ("noncausal", 1, 1024, 1024, 32, 32, 128, False, dtype),
            ("sq256<skv1024", 1, 256, 1024, 32, 32, 128, True, dtype),
            ("gqa-32/8", 1, 1024, 1024, 32, 8, 128, True, dtype),
        ]
    results = []
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, b, s_q, s_kv, h, kvh, d, causal, dtype in cases:
        q = torch.randn(b, s_q, h, d, generator=gen, device="cuda").to(dtype)
        k = torch.randn(b, s_kv, kvh, d, generator=gen, device="cuda").to(dtype)
        v = torch.randn(b, s_kv, kvh, d, generator=gen, device="cuda").to(dtype)
        scale = 1.0 / math.sqrt(d)
        out = flash_attention_fwd(q, k, v, causal=causal, scale=scale)
        ref = flash_attention_reference(q, k, v, causal=causal, scale=scale)
        torch.cuda.synchronize()
        diff = (out.float() - ref.float()).abs()
        err = diff.max().item()
        if dtype == torch.float32:
            tol = f"{TOL_FP32[0]:g} + {TOL_FP32[1]:g}|plain|"
            limit = TOL_FP32[0] + TOL_FP32[1] * ref.float().abs()
        else:
            tol = f"{ATOL_16:g} + rounding bound"
            limit = ATOL_16 + rounding_bound(q, k, v, ref, causal=causal, scale=scale)
        # share of the limit used: above 1 is a miss
        limit_use = (diff / limit).max().item()
        if not limit_use <= 1.0:
            raise AssertionError(f"flash kernel {name} {dtype}: |kernel - plain| exceeds "
                                 f"{tol} (max abs err {err}, {limit_use:.2f} of the limit)")
        # rows past the first kv tile, where the online softmax rescales
        late_err = diff[:, 64:].max().item() if s_q > 64 else 0.0
        late_mean_abs = ref[:, 64:].float().abs().mean().item() if s_q > 64 else 0.0

        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        mask = None
        if causal and s_q != s_kv:  # bottom-right aligned, as the kernel
            mask = (torch.arange(s_kv, device="cuda")[None, :]
                    <= torch.arange(s_q, device="cuda")[:, None] + (s_kv - s_q))
        lib = lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None, scale=scale,
            enable_gqa=kvh != h)
        route = attention_route(dtype, d)
        kernel = lambda: flash_attention_fwd(q, k, v, causal=causal, scale=scale)
        old_route_ms = None
        if route == "wgmma":
            # the wmma kernel at the same shape: it holds the plain version too
            old_out = flash_attention_fwd(q, k, v, causal=causal, scale=scale, _route="wmma")
            torch.cuda.synchronize()
            check_limit(f"flash kernel {name} {dtype} (wmma route)",
                        (old_out.float() - ref.float()).abs(), limit, tol)
            del old_out
            kernel_ms, old_route_ms = route_turns(
                kernel, lambda: flash_attention_fwd(q, k, v, causal=causal, scale=scale,
                                                    _route="wmma"), 20)
        else:
            kernel_ms = time_ms(kernel, 20)
        plain_ms = time_ms(lambda: flash_attention_reference(q, k, v, causal=causal,
                                                             scale=scale), 5)
        library_ms = time_ms(lib, 20)
        # the bound: the larger of the operations at the input type's peak
        # rate and the bytes (q, k, v read once, o written once) at HBM rate
        flops = attention_flops(b, s_q, s_kv, h, d, causal)
        t_ops = flops / (H100_FP32_FLOPS if dtype == torch.float32 else H100_BF16_FLOPS)
        n_bytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        t_bytes = n_bytes / H100_BYTES
        bound_ms = max(t_ops, t_bytes) * 1e3
        r = dict(case=name, dtype=str(dtype).split(".")[1], b=b, s_q=s_q, s_kv=s_kv, h=h,
                 kv_heads=kvh, d=d, causal=causal, main_path=name.startswith("main-"),
                 max_abs_err=err, tolerance=tol, limit_use=limit_use,
                 late_rows_max_abs_err=late_err, late_rows_mean_abs_plain=late_mean_abs,
                 kernel_route=route, ms=kernel_ms, old_route_ms=old_route_ms,
                 plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                 bound_by="operations" if t_ops >= t_bytes else "bytes", flops=flops,
                 bytes=n_bytes, tflops=flops / kernel_ms / 1e9)
        was = "" if old_route_ms is None else f" (wmma route {old_route_ms:.4f} ms)"
        log(f"  flash {name:14s} {r['dtype']:8s} err {err:.2e} ({limit_use:.2f} of the limit; "
            f"rows>=64 err {late_err:.2e} at mean |plain| "
            f"{late_mean_abs:.3f})  {route} "
            f"{kernel_ms:.4f} ms{was}  plain {plain_ms:.4f} ms  sdpa {library_ms:.4f} ms  bound "
            f"{bound_ms:.4f} ms ({r['bound_by']})  {r['tflops']:.1f} TFLOP/s")
        results.append(r)
        del q, k, v, out, ref, diff, limit
    return results


def paged_inputs(torch, gen, s_dim, n_heads, kvh, dh, bs, nb_cols, cursors, dtype):
    """A paged pool of ``s_dim * nb_cols + 1`` blocks whose garbage block 0
    is poisoned with 1e4, each slot's blocks drawn without replacement for
    [0, cursor) and every other column on the garbage block."""
    n_blocks = s_dim * nb_cols + 1
    rnd = lambda *shape: torch.randn(*shape, generator=gen, device="cuda").to(dtype)
    kc, vc = rnd(n_blocks, bs, kvh, dh), rnd(n_blocks, bs, kvh, dh)
    kc[0] = 1e4
    vc[0] = 1e4
    ids = torch.randperm(n_blocks - 1, generator=gen, device="cuda") + 1
    table = torch.zeros((s_dim, nb_cols), dtype=torch.int32, device="cuda")
    for s, c in enumerate(cursors):
        used = -(-c // bs)
        table[s, :used] = ids[s * nb_cols:s * nb_cols + used].int()
    pos = torch.tensor(cursors, dtype=torch.int32, device="cuda")
    return (rnd(s_dim, n_heads, dh), rnd(s_dim, kvh, dh), rnd(s_dim, kvh, dh), kc, vc, table,
            pos)


def phase_paged_kernels(torch, F):
    """``paged_flash_decode`` against its plain version at phase 5's decode
    geometry (8 slots, Llama-7B heads, 16-token blocks, 2048-token windows,
    the cursors phase 5 reaches) and a few more."""
    from deepspeed_tpu_torch.ops.cuda.paged_attention import (kernel_splits,
                                                              paged_flash_decode,
                                                              paged_flash_decode_reference,
                                                              rounding_bound)

    serving = MAIN_CONFIG["serving"]
    s_dim, bs = serving["n_slots"], serving["kv_pool"]["block_size"]
    nb_cols = serving["max_len"] // bs
    cursors = decode_cursors()
    main_splits = kernel_splits(s_dim, 32, nb_cols, "cuda")
    results = []
    gen = torch.Generator(device="cuda").manual_seed(1)
    for dtype in (torch.bfloat16, torch.float32):
        cases = [("main", 32, 32, False, None), ("main-splits1", 32, 32, False, 1),
                 ("main-splits4", 32, 32, False, 4), ("gqa-32/8", 32, 8, False, None),
                 ("alibi", 32, 32, True, None)]
        for name, n_heads, kvh, alibi, splits in cases:
            args = paged_inputs(torch, gen, s_dim, n_heads, kvh, 128, bs, nb_cols, cursors, dtype)
            q, k_new, v_new, kc, vc, table, pos = args
            slopes = (0.5 ** torch.arange(1, n_heads + 1, dtype=torch.float32, device="cuda")
                      if alibi else None)
            used = splits or kernel_splits(s_dim, kvh, nb_cols, "cuda")
            kern = lambda: paged_flash_decode(*args, alibi_slopes=slopes, kv_splits=used)
            plain = lambda: paged_flash_decode_reference(*args, alibi_slopes=slopes,
                                                          kv_splits=used)
            out, ref = kern(), plain()
            torch.cuda.synchronize()
            diff = (out.float() - ref.float()).abs()
            err = diff.max().item()
            if dtype == torch.float32:
                tol = f"{TOL_FP32[0]:g} + {TOL_FP32[1]:g}|plain|"
                limit = TOL_FP32[0] + TOL_FP32[1] * ref.float().abs()
            else:
                tol = f"{ATOL_16:g} + rounding bound"
                limit = ATOL_16 + rounding_bound(*args, ref, alibi_slopes=slopes)
            limit_use = (diff / limit).max().item()
            if not limit_use <= 1.0:
                raise AssertionError(f"paged kernel {name} {dtype}: |kernel - plain| exceeds "
                                     f"{tol} (max abs err {err}, {limit_use:.2f} of the limit)")
            if not bool(torch.isfinite(out).all()) or out.float().abs().max().item() > 100:
                raise AssertionError(f"paged kernel {name}: the garbage block leaked in")

            # the yardstick: gather the dense view through the table, put the
            # fresh row at the cursor, and one SDPA call with the cursor mask
            # (the mask, and the alibi bias, are built outside the timing)
            t_len = nb_cols * bs
            rows = torch.arange(s_dim, device="cuda")
            at = torch.arange(t_len, device="cuda")
            mask = (at[None, :] <= pos.long()[:, None])[:, None, None, :]
            if alibi:
                dist = (at[None, :] - pos.long()[:, None]).float()
                mask = torch.where(mask, slopes[None, :, None, None] * dist[:, None, None, :],
                                   float("-inf")).to(dtype)

            def lib():
                kd = kc[table.long()].reshape(s_dim, t_len, kvh, 128)
                vd = vc[table.long()].reshape(s_dim, t_len, kvh, 128)
                kd[rows, pos.long()] = k_new
                vd[rows, pos.long()] = v_new
                return F.scaled_dot_product_attention(
                    q[:, :, None], kd.transpose(1, 2), vd.transpose(1, 2), attn_mask=mask,
                    enable_gqa=kvh != n_heads)

            lib_err = (lib()[:, :, 0].float() - ref.float()).abs().max().item()
            kernel_ms = time_ms(kern, 20)
            plain_ms = time_ms(plain, 5)
            library_ms = time_ms(lib, 20)
            # the bound: the valid K/V windows, q, the fresh rows, the out,
            # the table and the cursors, each moved once at HBM rate; and
            # 4 * n_heads * dh operations per attended position
            attended = sum(cursors) + s_dim
            n_bytes = (2 * sum(cursors) * kvh * 128 + 2 * s_dim * n_heads * 128
                       + 2 * s_dim * kvh * 128) * q.element_size() + 4 * (table.numel() + s_dim)
            flops = 4 * n_heads * 128 * attended
            t_bytes = n_bytes / H100_BYTES
            t_ops = flops / (H100_FP32_FLOPS if dtype == torch.float32 else H100_BF16_FLOPS)
            bound_ms = max(t_bytes, t_ops) * 1e3
            r = dict(case=name, dtype=str(dtype).split(".")[1], slots=s_dim, n_heads=n_heads,
                     kv_heads=kvh, head_dim=128, block_size=bs, window=t_len, cursors=cursors,
                     splits=used, alibi=alibi, main_path=name == "main" and splits is None,
                     max_abs_err=err, tolerance=tol, limit_use=limit_use,
                     library_max_abs_err=lib_err, ms=kernel_ms, plain_ms=plain_ms,
                     library_ms=library_ms, bound_ms=bound_ms,
                     bound_by="operations" if t_ops >= t_bytes else "bytes", bytes=n_bytes,
                     flops=flops, gb_per_s=n_bytes / kernel_ms / 1e6)
            log(f"  paged {name:13s} {r['dtype']:8s} splits {used} err {err:.2e} "
                f"({limit_use:.2f} of the limit)  kernel {kernel_ms:.4f} ms  plain "
                f"{plain_ms:.4f} ms  gather+sdpa {library_ms:.4f} ms  bound {bound_ms:.4f} ms "
                f"({r['bound_by']})  {r['gb_per_s']:.0f} GB/s")
            results.append(r)
            del args, q, k_new, v_new, kc, vc, out, ref, diff, limit, mask
    if not any(r["main_path"] and r["splits"] == main_splits for r in results):
        raise AssertionError("the main path's decode geometry was not checked")
    return results


def phase_card_vs_cpu(torch):
    import numpy as np

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.inference import DeepSpeedInferenceConfig, InferenceEngine
    from deepspeed_tpu_torch.models import CausalLM, llama_config
    from deepspeed_tpu_torch.models.decoding import forward_with_cache, init_cache
    from deepspeed_tpu_torch.models.layers import tree_map

    config = {"dtype": "float32", "max_tokens": 256, "seed": 1}
    card = deepspeed_tpu_torch.init_inference(CausalLM(llama_config("7b", n_layers=2)), config)
    cpu = InferenceEngine(CausalLM(llama_config("7b", n_layers=2)),
                          DeepSpeedInferenceConfig.from_dict(config), device="cpu",
                          model_parameters=tree_map(lambda t: t.detach().cpu(), card.params))
    ids = torch.tensor(np.random.RandomState(1).randint(0, 32000, (1, 100)))
    padded = torch.nn.functional.pad(ids, (0, 28))  # the 128 prompt bucket
    logits = {}
    for name, eng in (("card", card), ("cpu", cpu)):
        with torch.inference_mode():
            cache = init_cache(eng.module.config, 1, 136, torch.float32, device=eng.device)
            logits[name] = forward_with_cache(eng.module, eng.params, padded.to(eng.device),
                                              cache, 0, 136, prefill=True).cpu()
    err = (logits["card"] - logits["cpu"]).abs().max().item()
    scale = logits["cpu"].abs().max().item()
    # fp32 on both sides (TF32 off): matmuls over d=4096/11008 summed in another order
    if not err <= 2e-4 * max(1.0, scale):
        raise AssertionError(f"card vs CPU prefill logits: max abs err {err} (|logits| {scale})")
    toks = {name: eng.generate(ids.numpy(), max_new_tokens=8).cpu()
            for name, eng in (("card", card), ("cpu", cpu))}
    if not torch.equal(toks["card"], toks["cpu"]):
        raise AssertionError(f"greedy streams differ: card {toks['card'][0, 100:].tolist()} "
                             f"cpu {toks['cpu'][0, 100:].tolist()}")
    log(f"  prefill logits max abs err {err:.3e} (|logits| max {scale:.2f}); 8 greedy "
        f"tokens equal: {toks['card'][0, 100:].tolist()}")

    # serve(): the card's fused backend against the CPU port's gather
    # backend, 3 staggered greedy requests through 2 slots (virtual clock,
    # so both sides run the same schedule), and against the card's generate()
    from deepspeed_tpu_torch.config import ServingConfig
    from deepspeed_tpu_torch.ops.cuda import LAUNCH_COUNTS
    from deepspeed_tpu_torch.serving import Request, ServingEngine, VirtualClock

    rng = np.random.RandomState(2)
    prompts = [rng.randint(0, 32000, n) for n in (40, 100, 150)]
    streams = {}
    for name, eng, backend in (("card", card, "fused"), ("cpu", cpu, "gather")):
        sv = ServingEngine(eng, serving_config=ServingConfig.from_dict(
            {"n_slots": 2, "virtual_clock": True,
             "kv_pool": {"enabled": True, "block_size": 16, "attention_backend": backend}}),
            clock=VirtualClock())
        before = LAUNCH_COUNTS["paged_flash_decode"]
        reqs = [Request(prompt=p, max_new_tokens=8, arrival_time=float(i))
                for i, p in enumerate(prompts)]
        list(sv.serve(reqs))
        launched = LAUNCH_COUNTS["paged_flash_decode"] - before
        if sv.attn_backend != backend or (backend == "fused") != (launched > 0):
            raise AssertionError(f"{name} serve ran backend {sv.attn_backend} with {launched} "
                                 "paged kernel launches")
        streams[name] = [r.tokens for r in reqs]
        sv.destroy()
    generated = [card.generate(p[None], max_new_tokens=8).cpu()[0, len(p):].tolist()
                 for p in prompts]
    if not streams["card"] == streams["cpu"] == generated:
        raise AssertionError(f"serve streams differ: card fused {streams['card']}, cpu gather "
                             f"{streams['cpu']}, card generate {generated}")
    log(f"  serve(): card fused == CPU gather == card generate() on 3 staggered requests: "
        f"{streams['card']}")
    card.destroy()
    cpu.destroy()
    return err


def phase_main_path(torch, checked_shapes):
    import numpy as np

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import CausalLM, llama_config
    from deepspeed_tpu_torch.ops.cuda import LAUNCH_COUNTS, reset_launch_counts

    cfg = llama_config("7b")
    n_layers, vocab = cfg.n_layers, cfg.vocab_size
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    eng = deepspeed_tpu_torch.init_inference(CausalLM(cfg), dict(MAIN_CONFIG))
    torch.cuda.synchronize()
    log(f"  init Llama-7B ({cfg.num_params() / 1e9:.2f} B params, bf16) in "
        f"{time.perf_counter() - t0:.3f} s")
    rng = np.random.RandomState(0)
    n_calls = 0
    requests = []
    prompts = {}

    def run(name, ids, max_new=MAX_NEW):
        nonlocal n_calls
        b, n = ids.shape
        bucket = eng._bucket_prompt_len(n, eng.config.max_tokens - max_new)
        if (b, bucket) not in checked_shapes:
            raise AssertionError(f"{name}: prefill shape {(b, bucket)} was not held against "
                                 f"the plain version in phase 2 ({checked_shapes})")
        before = LAUNCH_COUNTS["flash_attention_fwd"]
        t = time.perf_counter()
        out = eng.generate(ids, max_new_tokens=max_new, greedy=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        n_calls += 1
        launched = LAUNCH_COUNTS["flash_attention_fwd"] - before
        if launched != n_layers:
            raise AssertionError(f"{name}: {launched} flash launches, expected {n_layers}")
        out = out.cpu()
        if out.shape != (b, n + max_new):
            raise AssertionError(f"{name}: output shape {tuple(out.shape)}")
        if not torch.equal(out[:, :n], torch.as_tensor(ids, dtype=torch.int32)):
            raise AssertionError(f"{name}: prompt not preserved")
        if int(out.min()) < 0 or int(out.max()) >= vocab:
            raise AssertionError(f"{name}: token outside the vocab")
        sec = eng.last_timing.seconds()
        r = dict(request=name, batch=b, prompt=n, bucket=bucket, new_tokens=max_new,
                 prefill_ms=sec["prefill"] * 1e3,
                 decode_ms_per_token=sec["decode"] * 1e3 / (max_new - 1), wall_s=wall)
        log(f"  {name:16s} b={b} prompt {n:4d} (bucket {r['bucket']:4d})  prefill "
            f"{r['prefill_ms']:.2f} ms  decode {r['decode_ms_per_token']:.3f} ms/token  "
            f"wall {wall:.2f} s")
        requests.append(r)
        return out

    # each request twice: the first call of a shape also grows the allocator
    # and picks cuBLAS algorithms ("cold"); the second is the measurement and
    # must give the identical greedy stream
    for name, shape in REQUESTS:
        ids = rng.randint(0, vocab, shape)
        cold = run(name + "/cold", ids)
        if not torch.equal(run(name, ids), cold):
            raise AssertionError(f"{name}: repeated greedy request gave a different stream")
        prompts[name] = ids
    # sampling on the card: an explicit generator reproduces the stream
    (shape, new) = SAMPLED
    ids = rng.randint(0, vocab, shape)
    streams = [eng.generate(ids, max_new_tokens=new, greedy=False, temperature=0.8, top_k=40,
                            generator=torch.Generator(device="cuda").manual_seed(7)).cpu()
               for _ in range(2)]
    if not torch.equal(*streams) or int(streams[0].max()) >= vocab:
        raise AssertionError("seeded sampled streams differ or leave the vocab")
    warm_1700 = next(r for r in requests if r["request"] == "single-1700")
    profile = profile_request(torch, eng, prompts["single-1700"], warm_1700["wall_s"] * 1e3)
    n_calls += 3
    launches = dict(LAUNCH_COUNTS)
    if launches["flash_attention_fwd"] != n_layers * n_calls:
        raise AssertionError(f"flash launches {launches} != {n_layers} x {n_calls} calls")
    if launches["flash_attention_fwd"] == 0:
        raise AssertionError("the flash kernel was never launched on the generate path")
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"  launches on the generate path: {launches} over {n_calls} generate calls; "
        f"peak device memory {peak:.2f} GiB")
    return eng, launches, requests, peak, profile


def phase_serving(torch, eng, checked_shapes, paged_kernel="paged_flash_decode",
                  qmm_kernel=None):
    """Phase 5: ``serve()`` on the phase-4 engine (its config's serving
    block: 8 slots, a paged pool of 2048-token windows, the fused backend)
    under the wall clock. Run 1 serves the traffic and nothing else: its
    launch counts, metrics and decode step times are the ones reported. Run 2
    (a fresh slot pool) must repeat every stream; it also takes one
    fused-against-gather decode step when all 8 slots are busy, and profiles
    the first 16 decode steps after the last admission. Phase 7 runs it on
    its quantized engine: an int8 pool (``paged_kernel``
    "paged_flash_decode_int8", and then no launch of the 16-bit pool's
    kernel) and 7 quantized matmuls per layer and forward (``qmm_kernel``)."""
    from deepspeed_tpu_torch.inference.engine import bucket_prompt_len
    from deepspeed_tpu_torch.models.decoding import forward_with_paged_cache
    from deepspeed_tpu_torch.ops.cuda import LAUNCH_COUNTS, reset_launch_counts
    from deepspeed_tpu_torch.serving import Request, ServingEngine

    cfg = eng.module.config
    n_layers, vocab = cfg.n_layers, cfg.vocab_size
    traffic = serving_traffic(vocab)
    for spec in traffic:
        bucket = bucket_prompt_len(eng.config, len(spec["prompt"]), eng.config.serving.max_len)
        if (1, bucket) not in checked_shapes:
            raise AssertionError(f"serving prefill shape {(1, bucket)} was not held against the "
                                 f"plain version in phase 2 ({checked_shapes})")
    torch.cuda.reset_peak_memory_stats()

    def run(sv, label, on_decode, entry):
        """Serve the traffic; returns the requests, the wall seconds and, per
        decode step, (start, end, after the last admission)."""
        steps = []
        inner = sv._decode_once

        def timed(events):
            after = drained(sv)
            on_decode(sv)
            t = time.perf_counter()
            inner(events)   # ends in the host read of the sampled tokens
            steps.append((t, time.perf_counter(), after))

        sv._decode_once = timed
        reqs = [Request(**spec) for spec in traffic]
        t = time.perf_counter()
        events = list(entry(reqs))
        wall = time.perf_counter() - t
        torch.cuda.synchronize()
        for r in reqs:
            if r.state.name != "FINISHED" or len(r.tokens) != MAX_NEW:
                raise AssertionError(f"{label}: request {r.request_id} ended {r.state.name} "
                                     f"with {len(r.tokens)} tokens")
            if min(r.tokens) < 0 or max(r.tokens) >= vocab:
                raise AssertionError(f"{label}: token outside the vocab")
        if len(events) != SERVE_N * MAX_NEW:
            raise AssertionError(f"{label}: {len(events)} events")
        return reqs, wall, steps

    def drained(sv):
        return sv.metrics.submitted == SERVE_N and not sv.queue.depth and not sv._prefill_jobs

    sv = eng.serving
    if sv.attn_backend != "fused":
        raise AssertionError(f"serving backend is {sv.attn_backend}, not fused")
    reset_launch_counts()
    reqs1, wall1, steps1 = run(sv, "run 1", lambda sv: None, eng.serve)
    launches = dict(LAUNCH_COUNTS)
    snap = sv.metrics.snapshot()
    dispatches = sv.metrics.decode_dispatches
    hits = snap["kv_pool"]["prefix_hit_requests"]
    if snap["kv_pool"]["attention_backend"] != "fused" or hits < 1:
        raise AssertionError(f"kv_pool {snap['kv_pool']}: not fused, or no prefix hit")
    if launches[paged_kernel] != n_layers * dispatches:
        raise AssertionError(f"{paged_kernel} launches {launches[paged_kernel]} != {n_layers} x "
                             f"{dispatches} decode steps")
    if paged_kernel != "paged_flash_decode" and launches["paged_flash_decode"]:
        raise AssertionError(f"{launches['paged_flash_decode']} launches of the 16-bit pool's "
                             f"kernel on an int8 pool")
    if qmm_kernel is not None and launches[qmm_kernel] != 7 * n_layers * (dispatches + SERVE_N):
        raise AssertionError(f"{qmm_kernel} launches {launches[qmm_kernel]} != 7 x {n_layers} x "
                             f"({dispatches} decode steps + {SERVE_N} prefills)")
    # every prefill linear (m > 16) takes the TMA + wgmma route, no decode step's
    if qmm_kernel is not None and launches[f"{qmm_kernel}_wgmma"] != 7 * n_layers * SERVE_N:
        raise AssertionError(f"{qmm_kernel}_wgmma launches {launches[f'{qmm_kernel}_wgmma']} "
                             f"!= 7 x {n_layers} x {SERVE_N} prefills")
    if launches["flash_attention_fwd"] != n_layers * (SERVE_N - hits):
        raise AssertionError(f"flash launches {launches['flash_attention_fwd']} != {n_layers} x "
                             f"{SERVE_N - hits} full prefills")
    if reqs1[SHARED[1]].prefix_saved_tokens != SHARED_PREFIX:
        raise AssertionError(f"the shared prefix saved {reqs1[SHARED[1]].prefix_saved_tokens}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    pool_bytes = sum(t.numel() * t.element_size() for t in sv._pool().values())
    sv.destroy()

    check, prof_box = {}, {}

    def fused_vs_gather(sv):
        """One decode step from the live pool state through both backends
        (neither advances a cursor; both write only the rows at the
        cursors, which the real step rewrites), outside the profiled stretch."""
        if check or len(sv._slots) < sv.n_slots or "prof" in prof_box:
            return
        st, bs = sv._state, sv.pool_mgr.block_size
        with torch.no_grad():
            logits = {b: forward_with_paged_cache(
                eng.module, eng.params, st["tok"][:, None], sv._pool(),
                st["table"], st["pos"], bs, attention_backend=b)[:, 0].float()
                for b in ("fused", "gather")}
        delta = (logits["fused"] - logits["gather"]).abs().max().item()
        top2 = logits["gather"].topk(2, dim=-1).values
        decided = (top2[:, 0] - top2[:, 1]) > 2 * delta
        same = logits["fused"].argmax(-1) == logits["gather"].argmax(-1)
        if not bool(same[decided].all()):
            raise AssertionError(f"fused and gather argmax differ on a slot whose top-2 gap "
                                 f"exceeds 2 x max |dlogits| {delta}")
        check.update(max_abs_dlogits=delta, slots_decided=int(decided.sum()),
                     slots_same_argmax=int(same.sum()), slots=sv.n_slots,
                     at_cursors=st["pos"].tolist())
        log(f"  fused vs gather (run 2), one decode step at cursors {check['at_cursors']}: max "
            f"|dlogits| {delta:.4f}; argmax equal on {check['slots_same_argmax']} of 8 slots, "
            f"{check['slots_decided']} with a top-2 gap over 2x that")

    def profile_stretch(sv2, steps=PROFILED_STEPS):
        """Profile the first ``steps`` decode steps after the last admission."""
        from torch.profiler import ProfilerActivity, profile

        if "prof" not in prof_box and drained(sv2):
            prof_box["prof"] = profile(activities=[ProfilerActivity.CPU,
                                                   ProfilerActivity.CUDA])
            prof_box["prof"].start()
            prof_box["steps"] = 0
        elif prof_box.get("steps") is not None:
            prof_box["steps"] += 1
            if prof_box["steps"] == steps:
                torch.cuda.synchronize()
                prof_box["prof"].stop()
                prof_box["steps"] = None

    def run2_hook(sv2):
        fused_vs_gather(sv2)
        profile_stretch(sv2)

    sv2 = ServingEngine(eng)
    reqs2, wall2, steps2 = run(sv2, "run 2", run2_hook, sv2.serve)
    if prof_box.get("steps") is not None:
        torch.cuda.synchronize()
        prof_box["prof"].stop()
    if not check:
        raise AssertionError("all 8 slots were never busy at once: no fused-vs-gather check")
    for a, b in zip(reqs1, reqs2):
        if a.tokens != b.tokens:
            raise AssertionError(f"request {a.request_id}: run 2 gave a different stream")
    sv2.destroy()

    mean = lambda xs: sum(xs) / len(xs) if xs else None
    step_ms = lambda steps, after=None: [(e - s) * 1e3 for s, e, a in steps
                                         if after is None or a == after]
    profile = stretch_profile(torch, prof_box.get("prof"), stretch_wall_ms(steps2),
                              stretch_wall_ms(steps1))
    out = {"requests": SERVE_N, "prompts": list(SERVE_PROMPTS), "new_tokens": MAX_NEW,
           "arrival_gap_s": SERVE_GAP, "wall_s": [wall1, wall2],
           "wall_s_note": "run 2 also takes the fused-vs-gather step and the profiled stretch",
           "tokens_per_s": snap["tokens_per_s"], "ttft_ms": snap["ttft_ms"],
           "tpot_ms": snap["tpot_ms"], "decode_steps": dispatches,
           "decode_ms_per_step_mean": mean(step_ms(steps1)),
           "decode_ms_per_step_after_last_admission": mean(step_ms(steps1, True)),
           "prefix_hit_requests": hits, "kv_pool": snap["kv_pool"], "pool_bytes": pool_bytes,
           "launches": launches, "peak_gib": peak, "fused_vs_gather": check,
           "profile": profile}
    log(f"  run 1: {SERVE_N} requests in {wall1:.2f} s ({wall2:.2f} s for run 2); tokens/s "
        f"{snap['tokens_per_s']}; TTFT ms p50/p99 {snap['ttft_ms']['p50']:.1f}/"
        f"{snap['ttft_ms']['p99']:.1f}; TPOT ms p50/p99 {snap['tpot_ms']['p50']:.2f}/"
        f"{snap['tpot_ms']['p99']:.2f}; {dispatches} decode steps at "
        f"{out['decode_ms_per_step_mean']:.2f} ms mean; peak device memory {peak:.2f} GiB")
    log(f"  launches on the serving path: {launches} ({n_layers} x {dispatches} decode steps, "
        f"{n_layers} x {SERVE_N - hits} full prefills; {hits} prefix hit); pool "
        f"{pool_bytes / 2**30:.3f} GiB")
    return out


def stretch_wall_ms(steps, n=PROFILED_STEPS):
    """Wall ms from the start of the first to the end of the ``n``-th decode
    step after the last admission (each step ends in a host read of its
    tokens, so the device is done with it)."""
    after = [(s, e) for s, e, a in steps if a][:n]
    if len(after) < n:
        raise AssertionError(f"only {len(after)} decode steps after the last admission")
    return (after[-1][1] - after[0][0]) * 1e3


def stretch_profile(torch, prof, wall_ms, run1_wall_ms):
    """Device kernel time of run 2's profiled stretch (the first
    ``PROFILED_STEPS`` decode steps after the last admission), by kernel
    name, and the device's idle share of that stretch's own wall time. The
    profiler's host cost lengthens that wall, so the idle share against run
    1's unprofiled wall of the same stretch (the same steps of the same
    traffic) is given beside it."""
    from torch.autograd import DeviceType

    if prof is None:
        raise AssertionError("the decode stretch was never profiled")
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.device_time_total > 0]
    busy_ms = sum(e.device_time_total for e in kernels) / 1e3
    if busy_ms <= 0:
        log("  profile: the trace shows no device time (not measured)")
        return {"device_busy_ms": None}
    top = sorted(kernels, key=lambda e: e.device_time_total, reverse=True)[:10]
    out = {"stretch": f"run 2, the first {PROFILED_STEPS} decode steps after the last admission",
           "wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "device_idle_share": 1 - busy_ms / wall_ms,
           "run1_unprofiled_wall_ms": run1_wall_ms,
           "device_idle_share_vs_run1_unprofiled": 1 - busy_ms / run1_wall_ms,
           "top_kernels": [{"name": e.key[:100], "ms": e.device_time_total / 1e3,
                            "count": e.count} for e in top]}
    log(f"  profile: device busy {busy_ms:.1f} ms over the {PROFILED_STEPS} profiled decode steps "
        f"of {wall_ms:.1f} ms wall (idle share {out['device_idle_share']:.3f}); the same "
        f"steps of run 1 took {run1_wall_ms:.1f} ms unprofiled (idle share "
        f"{out['device_idle_share_vs_run1_unprofiled']:.3f})")
    for k in out["top_kernels"]:
        log(f"    {k['ms']:9.3f} ms  x{k['count']:<6d} {k['name']}")
    return out


def profile_request(torch, eng, ids, wall_ms):
    """Where one request's time goes on the card: a torch.profiler trace of a
    generate() call (prefill + 63 decode steps), device kernel time summed by
    kernel name, and the device's idle share of ``wall_ms``, the same
    request's wall time measured without the profiler (whose host-side cost
    would inflate the wall)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        eng.generate(ids, max_new_tokens=64, greedy=True)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.device_time_total > 0]
    busy_ms = sum(e.device_time_total for e in kernels) / 1e3
    if busy_ms <= 0:
        log("  profile: the trace shows no device time (not measured)")
        return {"wall_ms": wall_ms, "device_busy_ms": None}
    top = sorted(kernels, key=lambda e: e.device_time_total, reverse=True)[:10]
    out = {"request": f"b=1 prompt {ids.shape[1]} + 64 new tokens", "wall_ms": wall_ms,
           "device_busy_ms": busy_ms, "device_idle_share": 1 - busy_ms / wall_ms,
           "top_kernels": [{"name": e.key[:100], "ms": e.device_time_total / 1e3,
                            "count": e.count} for e in top]}
    log(f"  profile: device busy {busy_ms:.1f} ms of the unprofiled {wall_ms:.1f} ms wall; "
        f"idle share {out['device_idle_share']:.3f}")
    for k in out["top_kernels"]:
        log(f"    {k['ms']:9.3f} ms  x{k['count']:<6d} {k['name']}")
    return out


def train_model_config():
    """Phase 6's model: GPT-2 medium as bench.py builds it (vocab padded to
    50304), with bench_defaults.json's flash attention and no remat, and the
    CE forward through its kernel (fused_ce_impl "pallas")."""
    from deepspeed_tpu_torch.models import gpt2_config

    return gpt2_config("medium", vocab_size=TRAIN_VOCAB, attention_impl="flash", remat=False,
                       fused_ce=True, fused_ce_impl="pallas")


def train_sparse_model_config():
    """Phase 8's model: phase 6's GPT-2 medium with block-sparse attention in
    the JAX package's default pattern (``SPARSE_ATTENTION``)."""
    from deepspeed_tpu_torch.models import gpt2_config

    return gpt2_config("medium", vocab_size=TRAIN_VOCAB, remat=False, fused_ce=True,
                       fused_ce_impl="pallas", **SPARSE_ATTENTION)


def check_limit(name, diff, limit, tol):
    """Share of the limit used (above 1 is a miss); raises on a miss."""
    use = (diff / limit).max().item()
    if not use <= 1.0:
        raise AssertionError(f"{name}: |kernel - plain| exceeds {tol} (max abs err "
                             f"{diff.max().item()}, {use:.2f} of the limit)")
    return use


def phase_train_kernels(torch, F):
    """The training kernels against their plain versions at phase 6's shapes
    (the flash forward with its lse, the flash backward, the CE forward) and
    a few more, each timed beside its bound, its plain version and a
    PyTorch yardstick: SDPA's forward and backward for the flash kernels,
    ``F.linear`` + ``logsumexp`` + ``gather`` for the CE forward."""
    from deepspeed_tpu_torch.ops.cuda.cross_entropy import (accumulation_bound, ce_route,
                                                            fused_ce_forward,
                                                            fused_ce_forward_reference)
    from deepspeed_tpu_torch.ops.cuda.flash_attention import (attention_route,
                                                              bwd_rounding_bound,
                                                              flash_attention_bwd,
                                                              flash_attention_bwd_reference,
                                                              flash_attention_fwd,
                                                              flash_attention_reference,
                                                              rounding_bound)

    b, s, h, d = TRAIN_BATCH, TRAIN_SEQ, 16, 64
    gen = torch.Generator(device="cuda").manual_seed(3)
    rnd = lambda *shape: torch.randn(*shape, generator=gen, device="cuda")
    out = {"flash_fwd_lse": [], "flash_bwd": [], "ce": []}

    # -- the forward with lse, at the training shape ---------------------------------
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = (rnd(b, s, h, d).to(dtype) for _ in range(3))
        o, lse = flash_attention_fwd(q, k, v, causal=True, return_lse=True)
        ref, ref_lse = flash_attention_reference(q, k, v, causal=True, return_lse=True)
        torch.cuda.synchronize()
        if dtype == torch.float32:
            tol, limit = "2e-05 + 2e-05|plain|", TOL_FP32[0] + TOL_FP32[1] * ref.float().abs()
        else:
            tol, limit = f"{ATOL_16:g} + rounding bound", ATOL_16 + rounding_bound(q, k, v, ref)
        use = check_limit(f"flash fwd train {dtype}", (o.float() - ref.float()).abs(), limit, tol)
        lse_use = check_limit(f"flash lse train {dtype}", (lse - ref_lse).abs(),
                              1e-5 + 1e-5 * ref_lse.abs(), "1e-05 + 1e-05|plain lse|")
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        route = attention_route(dtype, d)
        kernel = lambda: flash_attention_fwd(q, k, v, causal=True, return_lse=True)
        old_route_ms = None
        if route == "wgmma":
            old_o, old_lse = flash_attention_fwd(q, k, v, causal=True, return_lse=True,
                                                 _route="wmma")
            torch.cuda.synchronize()
            check_limit(f"flash fwd train {dtype} (wmma route)", (old_o.float() - ref.float()).abs(),
                        limit, tol)
            check_limit(f"flash lse train {dtype} (wmma route)", (old_lse - ref_lse).abs(),
                        1e-5 + 1e-5 * ref_lse.abs(), "1e-05 + 1e-05|plain lse|")
            del old_o, old_lse
            kernel_ms, old_route_ms = route_turns(
                kernel, lambda: flash_attention_fwd(q, k, v, causal=True, return_lse=True,
                                                    _route="wmma"), 20)
        else:
            kernel_ms = time_ms(kernel, 20)
        plain_ms = time_ms(lambda: flash_attention_reference(q, k, v, causal=True,
                                                             return_lse=True), 5)
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True),
                             20)
        flops = attention_flops(b, s, s, h, d, True)
        t_ops = flops / (H100_FP32_FLOPS if dtype == torch.float32 else H100_BF16_FLOPS)
        n_bytes = 4 * q.numel() * q.element_size() + lse.numel() * 4
        bound_ms = max(t_ops, n_bytes / H100_BYTES) * 1e3
        r = dict(case="train", dtype=str(dtype).split(".")[1], b=b, s=s, h=h, kv_heads=h, d=d,
                 causal=True, max_abs_err=(o.float() - ref.float()).abs().max().item(),
                 lse_max_abs_err=(lse - ref_lse).abs().max().item(), tolerance=tol,
                 limit_use=use, lse_limit_use=lse_use, kernel_route=route, ms=kernel_ms,
                 old_route_ms=old_route_ms, plain_ms=plain_ms,
                 library_ms=library_ms, bound_ms=bound_ms,
                 bound_by="operations" if t_ops * H100_BYTES >= n_bytes else "bytes",
                 flops=flops, bytes=n_bytes)
        was = "" if old_route_ms is None else f" (wmma route {old_route_ms:.4f} ms)"
        log(f"  flash fwd+lse train {r['dtype']:8s} err {r['max_abs_err']:.2e} ({use:.2f} of the "
            f"limit), lse err {r['lse_max_abs_err']:.2e} ({lse_use:.2f})  {route} {kernel_ms:.4f} "
            f"ms{was}  plain {plain_ms:.4f} ms  sdpa {library_ms:.4f} ms  bound {bound_ms:.4f} ms "
            f"({r['bound_by']})")
        out["flash_fwd_lse"].append(r)
        del q, k, v, o, lse, ref, ref_lse, limit

    # -- the backward -----------------------------------------------------------------
    cases = [("train", b, s, s, h, h, True, torch.bfloat16),
             ("train", b, s, s, h, h, True, torch.float32),
             ("gqa-16/4", 2, s, s, h, 4, True, torch.bfloat16),
             ("noncausal", 2, s, s, h, h, False, torch.bfloat16),
             ("sq512<skv1024", 2, 512, s, h, h, True, torch.bfloat16)]
    for name, bb, s_q, s_kv, hq, kvh, causal, dtype in cases:
        q = rnd(bb, s_q, hq, d).to(dtype)
        k, v = rnd(bb, s_kv, kvh, d).to(dtype), rnd(bb, s_kv, kvh, d).to(dtype)
        o, lse = flash_attention_reference(q, k, v, causal=causal, return_lse=True)
        do = rnd(bb, s_q, hq, d).to(dtype)
        args = (q, k, v, o, lse, do)
        route = attention_route(dtype, d)
        grads = flash_attention_bwd(*args, causal=causal)
        refs = flash_attention_bwd_reference(*args, causal=causal)
        # the wmma kernels at the same shape hold the plain version too
        old_grads = (flash_attention_bwd(*args, causal=causal, _route="wmma")
                     if route == "wgmma" else None)
        torch.cuda.synchronize()
        bounds = bwd_rounding_bound(*args, refs, causal=causal)
        errs, uses = {}, {}
        for i, gname in enumerate(("dq", "dk", "dv")):
            diff = (grads[i].float() - refs[i].float()).abs()
            if bounds is None:
                tol, limit = "2e-05 + 2e-05|plain|", TOL_FP32[0] + TOL_FP32[1] * refs[i].float().abs()
            else:
                tol, limit = f"{ATOL_16:g} + bwd rounding bound", ATOL_16 + bounds[i]
            uses[gname] = check_limit(f"flash bwd {name} {dtype} {gname}", diff, limit, tol)
            errs[gname] = diff.max().item()
            if old_grads is not None:
                check_limit(f"flash bwd {name} {dtype} {gname} (wmma route)",
                            (old_grads[i].float() - refs[i].float()).abs(), limit, tol)
        del bounds, limit, diff, old_grads
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
        mask = None
        if causal and s_q != s_kv:
            mask = (torch.arange(s_kv, device="cuda")[None, :]
                    <= torch.arange(s_q, device="cuda")[:, None] + (s_kv - s_q))
        sdpa = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                              is_causal=causal and mask is None,
                                              enable_gqa=kvh != hq)
        gt = do.transpose(1, 2)
        kernel = lambda: flash_attention_bwd(*args, causal=causal)
        old_route_ms = None
        if route == "wgmma":
            kernel_ms, old_route_ms = route_turns(
                kernel, lambda: flash_attention_bwd(*args, causal=causal, _route="wmma"), 20)
        else:
            kernel_ms = time_ms(kernel, 20)
        plain_ms = time_ms(lambda: flash_attention_bwd_reference(*args, causal=causal), 3)
        library_ms = time_ms(lambda: torch.autograd.grad(sdpa, (qt, kt, vt), gt,
                                                         retain_graph=True), 20)
        # 10 d operations per allowed (query, key) pair: S and dP recomputed,
        # dQ, dK and dV; bytes: q, k, v, o, dO, lse read, dq, dk, dv written
        flops = attention_flops(bb, s_q, s_kv, hq, d, causal) // 4 * 10
        t_ops = flops / (H100_FP32_FLOPS if dtype == torch.float32 else H100_BF16_FLOPS)
        n_bytes = (2 * (q.numel() + k.numel() + v.numel()) + o.numel() + do.numel()) \
            * q.element_size() + lse.numel() * 4
        bound_ms = max(t_ops, n_bytes / H100_BYTES) * 1e3
        r = dict(case=name, dtype=str(dtype).split(".")[1], b=bb, s_q=s_q, s_kv=s_kv, h=hq,
                 kv_heads=kvh, d=d, causal=causal, max_abs_err=max(errs.values()),
                 max_abs_err_by_grad=errs, limit_use=max(uses.values()),
                 limit_use_by_grad=uses, tolerance=tol, kernel_route=route, ms=kernel_ms,
                 old_route_ms=old_route_ms, plain_ms=plain_ms,
                 library_ms=library_ms, bound_ms=bound_ms,
                 bound_by="operations" if t_ops * H100_BYTES >= n_bytes else "bytes",
                 flops=flops, bytes=n_bytes, tflops=flops / kernel_ms / 1e9)
        was = "" if old_route_ms is None else f" (wmma route {old_route_ms:.4f} ms)"
        log(f"  flash bwd {name:14s} {r['dtype']:8s} err dq/dk/dv {errs['dq']:.2e}/"
            f"{errs['dk']:.2e}/{errs['dv']:.2e} ({r['limit_use']:.2f} of the limit)  {route} "
            f"{kernel_ms:.4f} ms{was}  plain {plain_ms:.4f} ms  sdpa bwd {library_ms:.4f} ms  bound "
            f"{bound_ms:.4f} ms ({r['bound_by']})  {r['tflops']:.1f} TFLOP/s")
        out["flash_bwd"].append(r)
        del q, k, v, o, lse, do, args, grads, refs, qt, kt, vt, sdpa, gt

    # -- the CE forward ---------------------------------------------------------------
    tokens = b * s
    for name, t, vocab, n_ignored, bias in (("train", tokens, TRAIN_VOCAB, 0, False),
                                            ("vocab50257-ignored", tokens, 50257, 1000, False),
                                            ("bias", 4096, TRAIN_VOCAB, 0, True)):
        x = rnd(t, 1024).to(torch.bfloat16)
        emb = (0.02 * rnd(vocab, 1024)).to(torch.bfloat16)
        labels = torch.randint(0, vocab, (t,), generator=gen, device="cuda")
        labels[:n_ignored] = -100
        safe = torch.where(labels != -100, labels, 0)   # as fused_cross_entropy passes them
        bvec = rnd(vocab) if bias else None
        route = ce_route(x.dtype, x.shape[1])
        lse, lab = fused_ce_forward(x, emb, safe, bvec)
        ref_lse, ref_lab = fused_ce_forward_reference(x, emb, safe, bvec)
        # the wmma kernel at the same shape holds the plain version too
        old = fused_ce_forward(x, emb, safe, bvec, _route="wmma") if route == "wgmma" else None
        torch.cuda.synchronize()
        tol = f"{ATOL_16:g} + fp32 accumulation bound"
        limit = ATOL_16 + accumulation_bound(x, emb, ref_lse)
        use = max(check_limit(f"ce {name} lse", (lse - ref_lse).abs(), limit, tol),
                  check_limit(f"ce {name} label logit", (lab - ref_lab).abs(), limit, tol))
        err = max((lse - ref_lse).abs().max().item(), (lab - ref_lab).abs().max().item())
        if old is not None:
            check_limit(f"ce {name} lse (wmma route)", (old[0] - ref_lse).abs(), limit, tol)
            check_limit(f"ce {name} label logit (wmma route)", (old[1] - ref_lab).abs(), limit,
                        tol)
        del old

        def lib():
            logits = F.linear(x, emb, bvec.to(torch.bfloat16) if bias else None).float()
            return torch.logsumexp(logits, -1), logits.gather(1, safe[:, None])

        kernel = lambda: fused_ce_forward(x, emb, safe, bvec)
        old_route_ms = None
        if route == "wgmma":
            kernel_ms, old_route_ms = route_turns(
                kernel, lambda: fused_ce_forward(x, emb, safe, bvec, _route="wmma"), 10)
        else:
            kernel_ms = time_ms(kernel, 10)
        plain_ms = time_ms(lambda: fused_ce_forward_reference(x, emb, safe, bvec), 3)
        library_ms = time_ms(lib, 10)
        flops = 2 * t * vocab * 1024
        n_bytes = (x.numel() + emb.numel()) * 2 + t * 4 + (vocab * 4 if bias else 0) + t * 8
        t_ops = flops / H100_BF16_FLOPS
        bound_ms = max(t_ops, n_bytes / H100_BYTES) * 1e3
        r = dict(case=name, dtype="bfloat16", tokens=t, d=1024, vocab=vocab, ignored=n_ignored,
                 bias=bias, max_abs_err=err, tolerance=tol, limit_use=use, kernel_route=route,
                 ms=kernel_ms, old_route_ms=old_route_ms, plain_ms=plain_ms,
                 library_ms=library_ms, bound_ms=bound_ms,
                 bound_by="operations" if t_ops * H100_BYTES >= n_bytes else "bytes",
                 flops=flops, bytes=n_bytes, tflops=flops / kernel_ms / 1e9)
        was = "" if old_route_ms is None else f" (wmma route {old_route_ms:.4f} ms)"
        log(f"  ce fwd {name:18s} err {err:.2e} ({use:.2f} of the limit)  {route} "
            f"{kernel_ms:.4f} ms{was}  plain {plain_ms:.4f} ms  linear+logsumexp "
            f"{library_ms:.4f} ms  bound {bound_ms:.4f} ms ({r['bound_by']})  "
            f"{r['tflops']:.1f} TFLOP/s")
        out["ce"].append(r)
        del x, emb, labels, safe, bvec, lse, lab, ref_lse, ref_lab, limit
    torch.cuda.empty_cache()
    return out


# the registry's head dims beside Llama-7B's 128 and GPT-2's 64, with the
# head counts of a preset at each: (head_dim, heads, preset)
WIDTHS = ((32, 4, "llama tiny"), (80, 32, "opt 2.7b"), (96, 64, "gpt-neox 20b"),
          (256, 16, "gpt-j 6b"))
# phase 9: full-width presets at those head dims, cut to WIDTH_LAYERS layers
WIDTH_MODELS = (("opt", "2.7b"), ("gpt_neox", "20b"), ("gptj", "6b"))
WIDTH_LAYERS = 2
WIDTH_SPARSE = {"attention_impl": "block_sparse", "sparse_pattern": "fixed", "sparse_block": 32,
                "sparse_pattern_config": {"num_local_blocks": 2, "num_global_blocks": 1}}


def phase_width_kernels(torch, F):
    """The flash forward (with lse), the flash backward and the block-sparse
    forward and backward against their plain versions at head_dim 32, 80, 96
    and 256 (``WIDTHS``, each at a preset's head count): bf16 and fp32,
    fp16 at one shape; the flash forward causal at s 2048, with GQA and with
    s_q < s_kv; the backward causal at s 1024 and with GQA and s_q < s_kv;
    the block-sparse kernels at s 1024 with the fixed pattern of 64-token
    blocks (and, at head_dim 256, phase 9's 32-token blocks). Each case is
    timed beside its plain version, its bound and SDPA (for the block-sparse
    kernels: with the layout's token mask)."""
    import numpy as np

    from deepspeed_tpu_torch.ops import sparse_attention as SA
    from deepspeed_tpu_torch.ops.cuda.block_sparse_attention import (
        block_sparse_attention_bwd, block_sparse_attention_bwd_reference,
        block_sparse_attention_fwd, block_sparse_attention_fwd_reference)
    from deepspeed_tpu_torch.ops.cuda.block_sparse_attention import (
        bwd_rounding_bound as bs_bwd_bound)
    from deepspeed_tpu_torch.ops.cuda.block_sparse_attention import rounding_bound as bs_bound
    from deepspeed_tpu_torch.ops.cuda.flash_attention import (attention_route,
                                                              bwd_rounding_bound,
                                                              flash_attention_bwd,
                                                              flash_attention_bwd_reference,
                                                              flash_attention_fwd,
                                                              flash_attention_reference,
                                                              rounding_bound)

    gen = torch.Generator(device="cuda").manual_seed(11)
    rnd = lambda *shape: torch.randn(*shape, generator=gen, device="cuda")
    out = {"flash_fwd": [], "flash_bwd": [], "block_sparse_fwd": [], "block_sparse_bwd": []}

    def limits(dtype, refs, bounds):
        if dtype == torch.float32:
            return (f"{TOL_FP32[0]:g} + {TOL_FP32[1]:g}|plain|",
                    [TOL_FP32[0] + TOL_FP32[1] * r.float().abs() for r in refs])
        return f"{ATOL_16:g} + rounding bound", [ATOL_16 + b for b in bounds]

    def record(kind, r, flops, n_bytes, kernel, plain, library, iters=10):
        peak = H100_FP32_FLOPS if r["dtype"] == "float32" else H100_BF16_FLOPS
        t_ops, t_bytes = flops / peak, n_bytes / H100_BYTES
        r.update(ms=time_ms(kernel, iters), plain_ms=time_ms(plain, 2),
                 library_ms=time_ms(library, iters), bound_ms=max(t_ops, t_bytes) * 1e3,
                 bound_by="operations" if t_ops >= t_bytes else "bytes", flops=flops,
                 bytes=n_bytes)
        r["tflops"] = flops / r["ms"] / 1e9
        log(f"  {kind} {r['case']:22s} {r['dtype']:8s} err {r['max_abs_err']:.2e} "
            f"({r['limit_use']:.2f} of the limit)  kernel {r['ms']:.4f} ms  plain "
            f"{r['plain_ms']:.4f} ms  sdpa {r['library_ms']:.4f} ms  bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']})  {r['tflops']:.1f} TFLOP/s")
        out[kind].append(r)

    def sdpa_mask(s_q, s_kv):
        return (torch.arange(s_kv, device="cuda")[None, :]
                <= torch.arange(s_q, device="cuda")[:, None] + (s_kv - s_q))

    for d, h, preset in WIDTHS:
        dtypes = [torch.bfloat16, torch.float32] + ([torch.float16] if d == 80 else [])
        for dtype in dtypes:
            tag = lambda name: f"d{d}-{name}"
            # -- flash forward with lse -------------------------------------------
            fwd_cases = [("causal-s2048", 1, 2048, 2048, h, h, True)]
            if dtype != torch.float16:
                fwd_cases += [("gqa-s1024", 1, 1024, 1024, h, max(1, h // 4), True),
                              ("sq256<skv1024", 1, 256, 1024, h, h, True)]
            for name, b, s_q, s_kv, hq, kvh, causal in fwd_cases:
                q = rnd(b, s_q, hq, d).to(dtype)
                k, v = rnd(b, s_kv, kvh, d).to(dtype), rnd(b, s_kv, kvh, d).to(dtype)
                o, lse = flash_attention_fwd(q, k, v, causal=causal, return_lse=True)
                ref, ref_lse = flash_attention_reference(q, k, v, causal=causal, return_lse=True)
                torch.cuda.synchronize()
                bound = None if dtype == torch.float32 else rounding_bound(q, k, v, ref, causal)
                tol, (limit,) = limits(dtype, [ref], [bound])
                diff = (o.float() - ref.float()).abs()
                label = f"flash fwd {tag(name)} {dtype}"
                use = check_limit(label, diff, limit, tol)
                lse_use = check_limit(f"{label} lse", (lse - ref_lse).abs(),
                                      1e-5 + 1e-5 * ref_lse.abs(), "1e-05 + 1e-05|plain lse|")
                qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
                mask = sdpa_mask(s_q, s_kv) if s_q != s_kv else None
                r = dict(case=tag(name), preset=preset, dtype=str(dtype).split(".")[1], b=b,
                         s_q=s_q, s_kv=s_kv, h=hq, kv_heads=kvh, d=d, causal=causal,
                         kernel_route=attention_route(dtype, d),
                         max_abs_err=diff.max().item(), limit_use=use,
                         lse_max_abs_err=(lse - ref_lse).abs().max().item(),
                         lse_limit_use=lse_use, tolerance=tol)
                del diff, limit, bound, ref, ref_lse
                record("flash_fwd", r, attention_flops(b, s_q, s_kv, hq, d, causal),
                       (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
                       + lse.numel() * 4,
                       lambda: flash_attention_fwd(q, k, v, causal=causal, return_lse=True),
                       lambda: flash_attention_reference(q, k, v, causal=causal,
                                                         return_lse=True),
                       lambda: F.scaled_dot_product_attention(
                           qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None,
                           enable_gqa=kvh != hq))
                del q, k, v, o, lse, qt, kt, vt

            # -- flash backward ---------------------------------------------------
            bwd_cases = [("causal-s1024", 1, 1024, 1024, h, h, True)]
            if dtype != torch.float16:
                bwd_cases.append(("gqa-sq256<skv512", 1, 256, 512, h, max(1, h // 4), True))
            for name, b, s_q, s_kv, hq, kvh, causal in bwd_cases:
                q = rnd(b, s_q, hq, d).to(dtype)
                k, v = rnd(b, s_kv, kvh, d).to(dtype), rnd(b, s_kv, kvh, d).to(dtype)
                o, lse = flash_attention_reference(q, k, v, causal=causal, return_lse=True)
                do = rnd(b, s_q, hq, d).to(dtype)
                args = (q, k, v, o, lse, do)
                grads = flash_attention_bwd(*args, causal=causal)
                refs = flash_attention_bwd_reference(*args, causal=causal)
                torch.cuda.synchronize()
                bounds = bwd_rounding_bound(*args, refs, causal=causal)
                tol, lims = limits(dtype, refs, bounds or [None] * 3)
                uses = {g: check_limit(f"flash bwd {tag(name)} {dtype} {g}",
                                       (grads[i].float() - refs[i].float()).abs(), lims[i], tol)
                        for i, g in enumerate(("dq", "dk", "dv"))}
                errs = {g: (grads[i].float() - refs[i].float()).abs().max().item()
                        for i, g in enumerate(("dq", "dk", "dv"))}
                del bounds, lims, refs, grads
                qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
                mask = sdpa_mask(s_q, s_kv) if s_q != s_kv else None
                sdpa = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                      is_causal=causal and mask is None,
                                                      enable_gqa=kvh != hq)
                gt = do.transpose(1, 2)
                r = dict(case=tag(name), preset=preset, dtype=str(dtype).split(".")[1], b=b,
                         s_q=s_q, s_kv=s_kv, h=hq, kv_heads=kvh, d=d, causal=causal,
                         kernel_route=attention_route(dtype, d),
                         max_abs_err=max(errs.values()), max_abs_err_by_grad=errs,
                         limit_use=max(uses.values()), limit_use_by_grad=uses, tolerance=tol)
                record("flash_bwd", r, attention_flops(b, s_q, s_kv, hq, d, causal) // 4 * 10,
                       (2 * (q.numel() + k.numel() + v.numel()) + o.numel() + do.numel())
                       * q.element_size() + lse.numel() * 4,
                       lambda: flash_attention_bwd(*args, causal=causal),
                       lambda: flash_attention_bwd_reference(*args, causal=causal),
                       lambda: torch.autograd.grad(sdpa, (qt, kt, vt), gt, retain_graph=True))
                del q, k, v, o, lse, do, args, qt, kt, vt, sdpa, gt

            # -- block-sparse forward and backward --------------------------------
            blocks = [64] + ([WIDTH_SPARSE["sparse_block"]] if d == 256 else [])
            if dtype == torch.float16:
                blocks = [64]
            for block in blocks:
                s, b = 1024, 1
                kwargs = WIDTH_SPARSE["sparse_pattern_config"]
                attn = SA.BlockSparseAttention(SA.PATTERNS["fixed"](block=block, **kwargs), s,
                                               causal=True, device="cuda")
                lists = attn.lists
                q, k, v, do = (rnd(b, s, h, d).to(dtype) for _ in range(4))
                o, lse = block_sparse_attention_fwd(q, k, v, lists, causal=True,
                                                    return_lse=True)
                ref, ref_lse = block_sparse_attention_fwd_reference(q, k, v, lists, causal=True,
                                                                    return_lse=True)
                grads = block_sparse_attention_bwd(q, k, v, ref, ref_lse, do, lists,
                                                   causal=True)
                refs = block_sparse_attention_bwd_reference(q, k, v, ref, ref_lse, do, lists,
                                                            causal=True)
                torch.cuda.synchronize()
                name = f"fixed{block}-s{s}"
                label = f"block-sparse {tag(name)} {dtype}"
                f_bound = None if dtype == torch.float32 else bs_bound(q, k, v, ref, lists)
                g_bounds = (None if dtype == torch.float32 else
                            bs_bwd_bound(q, k, v, ref, ref_lse, do, refs, lists))
                tol, (f_lim,) = limits(dtype, [ref], [f_bound])
                _, g_lims = limits(dtype, refs, g_bounds or [None] * 3)
                f_diff = (o.float() - ref.float()).abs()
                f_use = check_limit(f"{label} fwd", f_diff, f_lim, tol)
                lse_use = check_limit(f"{label} lse", (lse - ref_lse).abs(),
                                      1e-5 + 1e-5 * ref_lse.abs(), "1e-05 + 1e-05|plain lse|")
                uses = {g: check_limit(f"{label} {g}", (grads[i].float() - refs[i].float()).abs(),
                                       g_lims[i], tol)
                        for i, g in enumerate(("dq", "dk", "dv"))}
                errs = {g: (grads[i].float() - refs[i].float()).abs().max().item()
                        for i, g in enumerate(("dq", "dk", "dv"))}
                common = dict(preset=preset, dtype=str(dtype).split(".")[1], b=b, s=s, h=h, d=d,
                              pattern="fixed", block=block, causal=True,
                              kept_blocks=int(attn.layout.sum()), tolerance=tol)
                fr = dict(common, case=tag(name), max_abs_err=f_diff.max().item(),
                          limit_use=f_use, lse_limit_use=lse_use)
                gr = dict(common, case=tag(name), max_abs_err=max(errs.values()),
                          max_abs_err_by_grad=errs, limit_use=max(uses.values()),
                          limit_use_by_grad=uses)
                del f_diff, f_lim, g_lims, f_bound, g_bounds, grads, refs
                kept = kept_pairs(attn.layout, block, s, s, True)
                size = q.numel() * q.element_size()
                mask = np.kron(attn.layout, np.ones((block, block), bool))
                mask = torch.as_tensor(mask & np.tril(np.ones((s, s), bool)), device="cuda")
                qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
                record("block_sparse_fwd", fr, 4 * d * kept * b * h, 4 * size + lse.numel() * 4,
                       lambda: block_sparse_attention_fwd(q, k, v, lists, causal=True,
                                                          return_lse=True),
                       lambda: block_sparse_attention_fwd_reference(q, k, v, lists, causal=True,
                                                                    return_lse=True),
                       lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask))
                sdpa = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
                gt = do.transpose(1, 2)
                record("block_sparse_bwd", gr, 10 * d * kept * b * h, 8 * size + lse.numel() * 4,
                       lambda: block_sparse_attention_bwd(q, k, v, o, lse, do, lists,
                                                          causal=True),
                       lambda: block_sparse_attention_bwd_reference(q, k, v, o, lse, do, lists,
                                                                    causal=True),
                       lambda: torch.autograd.grad(sdpa, (qt, kt, vt), gt, retain_graph=True))
                del q, k, v, do, o, lse, ref, ref_lse, mask, qt, kt, vt, sdpa, gt
    worst = max(r["limit_use"] for rs in out.values() for r in rs)
    log(f"  head dims {[w[0] for w in WIDTHS]}: {sum(len(v) for v in out.values())} cases, "
        f"each within its limit (worst {worst:.2f} of a limit)")
    torch.cuda.empty_cache()
    return out


def phase_widths(torch):
    """Phase 9: ``init_inference(...).generate()`` and training at the full
    width of presets whose head_dim is neither 64 nor 128 (``WIDTH_MODELS``:
    OPT-2.7B at 80, GPT-NeoX-20B at 96, GPT-J-6B at 256), cut to
    ``WIDTH_LAYERS`` layers, in fp32 with the same seeded weights on the card
    and on the CPU port, batch 1: the prefill logits of a 128-token prompt
    and 8 greedy tokens; one ``train_batch`` step at seq 128 with flash
    attention, taken apart so that its loss and every grad are held against
    the CPU port's before the card's optimizer step (the first AdamW update
    is about lr sign(g), which grad noise flips, so it is not compared); at
    GPT-J-6B's head_dim 256 the same with block-sparse attention (fixed
    pattern, 32-token blocks). The card's runs must launch the attention
    kernels; the CPU port's launch none."""
    import numpy as np

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.inference import DeepSpeedInferenceConfig, InferenceEngine
    from deepspeed_tpu_torch.models import CausalLM
    from deepspeed_tpu_torch.models.decoding import forward_with_cache, init_cache
    from deepspeed_tpu_torch.models.layers import flatten_tree, tree_map
    from deepspeed_tpu_torch.models.registry import MODEL_CONFIGS
    from deepspeed_tpu_torch.ops.cuda import LAUNCH_COUNTS

    out = {}
    rng = np.random.RandomState(9)
    for family, size in WIDTH_MODELS:
        make = lambda **kw: MODEL_CONFIGS[family](size, n_layers=WIDTH_LAYERS, **kw)
        cfg = make()
        label = f"{family} {size} (d_model {cfg.d_model}, {cfg.n_heads} heads of {cfg.head_dim})"
        res = {"head_dim": cfg.head_dim, "d_model": cfg.d_model, "n_layers": WIDTH_LAYERS}
        t0 = time.perf_counter()
        # -- generate --------------------------------------------------------------
        config = {"dtype": "float32", "max_tokens": 256, "seed": 3}
        card = deepspeed_tpu_torch.init_inference(CausalLM(make()), config)
        cpu = InferenceEngine(CausalLM(make()), DeepSpeedInferenceConfig.from_dict(config),
                              device="cpu",
                              model_parameters=tree_map(lambda t: t.detach().cpu(), card.params))
        ids = torch.tensor(rng.randint(0, cfg.vocab_size, (1, 128)))
        logits = {}
        before = LAUNCH_COUNTS["flash_attention_fwd"]
        for name, eng in (("card", card), ("cpu", cpu)):
            with torch.inference_mode():
                cache = init_cache(eng.module.config, 1, 136, torch.float32, device=eng.device)
                logits[name] = forward_with_cache(eng.module, eng.params, ids.to(eng.device),
                                                  cache, 0, 136, prefill=True).cpu()
        if LAUNCH_COUNTS["flash_attention_fwd"] - before != WIDTH_LAYERS:
            raise AssertionError(f"{label}: the card's prefill launched "
                                 f"{LAUNCH_COUNTS['flash_attention_fwd'] - before} flash "
                                 f"forwards, expected {WIDTH_LAYERS}")
        err = (logits["card"] - logits["cpu"]).abs().max().item()
        scale = logits["cpu"].abs().max().item()
        # phase 3's tolerance: fp32 on both sides (TF32 off), sums in another order
        if not err <= 2e-4 * max(1.0, scale):
            raise AssertionError(f"{label}: card vs CPU prefill logits max abs err {err} "
                                 f"(|logits| {scale})")
        toks = {name: eng.generate(ids.numpy(), max_new_tokens=8).cpu()
                for name, eng in (("card", card), ("cpu", cpu))}
        if not torch.equal(toks["card"], toks["cpu"]):
            raise AssertionError(f"{label}: greedy streams differ: card "
                                 f"{toks['card'][0, 128:].tolist()} cpu "
                                 f"{toks['cpu'][0, 128:].tolist()}")
        res["generate"] = {"prefill_logits_max_abs_err": err, "logits_abs_max": scale,
                           "greedy_tokens": toks["card"][0, 128:].tolist()}
        log(f"  {label}: prefill logits max abs err {err:.3e} (|logits| max {scale:.2f}); 8 "
            f"greedy tokens equal: {res['generate']['greedy_tokens']}")
        card.destroy()
        cpu.destroy()
        del card, cpu
        torch.cuda.empty_cache()
        # -- training --------------------------------------------------------------
        impls = [("flash", {"attention_impl": "flash"})]
        if cfg.head_dim == 256:
            impls.append(("block_sparse", WIDTH_SPARSE))
        for impl, attention in impls:
            kernels = ((f"{impl}_attention_fwd", f"{impl}_attention_bwd") if impl == "flash"
                       else ("block_sparse_attention_fwd", "block_sparse_attention_bwd"))
            ds = {"train_batch_size": 1, "seed": 5, "gradient_clipping": 1.0,
                  "optimizer": {"type": "adamw", "params": {"lr": 1e-4, "weight_decay": 0.01}}}
            card, *_ = deepspeed_tpu_torch.initialize(model=CausalLM(make(**attention)),
                                                      config=ds)
            cpu, *_ = deepspeed_tpu_torch.initialize(
                model=CausalLM(make(**attention)), config=ds, device="cpu",
                model_parameters=tree_map(lambda t: t.detach().cpu(), card.params))
            batch = {"input_ids": rng.randint(0, cfg.vocab_size, (1, 128))}
            losses = {}
            for name, eng in (("card", card), ("cpu", cpu)):
                before = {k: LAUNCH_COUNTS[k] for k in kernels}
                losses[name] = eng.forward(batch).item()
                eng.backward()
                launched = {k: LAUNCH_COUNTS[k] - before[k] for k in kernels}
                want = WIDTH_LAYERS if name == "card" else 0
                if launched != {k: want for k in kernels}:
                    raise AssertionError(f"{label} {impl} {name}: launches {launched}, "
                                         f"expected {want} of each")
            grads = {}
            flat_card, flat_cpu = flatten_tree(card.params), flatten_tree(cpu.params)
            for key in sorted(flat_cpu):
                if flat_cpu[key].grad is None:
                    continue
                g_card, g_cpu = flat_card[key].grad.cpu(), flat_cpu[key].grad
                gerr, gscale = (g_card - g_cpu).abs().max().item(), g_cpu.abs().max().item()
                # phase 3's tolerance: fp32 on both sides, sums in another order
                if not gerr <= 1e-4 * gscale + 1e-8:
                    raise AssertionError(f"{label} {impl} grad {key}: card vs CPU max abs err "
                                         f"{gerr} (|grad| max {gscale})")
                grads[key] = {"max_abs_err": gerr, "max_abs": gscale}
            # phase 3's tolerance on the loss
            if not abs(losses["card"] - losses["cpu"]) <= 1e-4 * abs(losses["cpu"]):
                raise AssertionError(f"{label} {impl}: card vs CPU losses {losses}")
            card.step()  # the rest of the card's train_batch step (the update is not compared)
            worst = max(grads.values(), key=lambda g: g["max_abs_err"] / max(g["max_abs"], 1e-30))
            res[f"train_{impl}"] = {"losses": losses, "grads_checked": len(grads),
                                    "worst_grad": worst}
            log(f"  {label} {impl} training step: loss card {losses['card']:.6f} cpu "
                f"{losses['cpu']:.6f}; {len(grads)} grads within 1e-4 relative (worst "
                f"{worst['max_abs_err']:.2e} at |g| {worst['max_abs']:.2e})")
            card.destroy()
            cpu.destroy()
            del card, cpu
            torch.cuda.empty_cache()
        res["seconds"] = time.perf_counter() - t0
        out[f"{family}-{size}"] = res
    return out


def kept_pairs(layout, block, s_q, s_kv, causal):
    """The (query, key) score elements a block layout keeps: every element of
    each kept block, less those past the causal diagonal (a diagonal
    128-block keeps 128 * 129 / 2)."""
    import numpy as np

    qb, kb = np.nonzero(layout)
    if not causal:
        return int(len(qb)) * block * block
    r = np.arange(block)
    # per kept block: sum over its rows of the columns at or below the diagonal
    first = kb[:, None] * block - (qb[:, None] * block + r[None, :] + (s_kv - s_q))
    return int(np.clip(1 - first, 0, block).sum())


def phase_sparse_kernels(torch, F):
    """The block-sparse forward (with lse) and backward against their plain
    versions: at phase 8's layers (b 12, s 1024, h 16, d 64, the fixed
    pattern of 128-token blocks, 4 local and 1 global, causal, bf16; and
    fp32), at the same tokens as one long sequence (b 3, s 4096, where the
    port's dense flash kernels are timed beside them) and, untimed, every
    pattern causal and not at blocks 16/32/64/128 in bf16, fp16 and fp32 at
    small sizes. The timed cases carry the plain versions' time, the bound
    (the kept score elements' operations against the bytes) and SDPA
    forward and backward with the layout's token mask as the yardstick."""
    import itertools

    import numpy as np

    from deepspeed_tpu_torch.ops import sparse_attention as SA
    from deepspeed_tpu_torch.ops.cuda.block_sparse_attention import (
        block_sparse_attention_bwd, block_sparse_attention_bwd_reference,
        block_sparse_attention_fwd, block_sparse_attention_fwd_reference, block_sparse_route,
        bwd_rounding_bound, rounding_bound)
    from deepspeed_tpu_torch.ops.cuda.flash_attention import (flash_attention_bwd,
                                                              flash_attention_fwd)

    h, d = 16, 64
    timed = [("main", TRAIN_BATCH, TRAIN_SEQ, h, d, "fixed", 128, True, torch.bfloat16),
             ("main", TRAIN_BATCH, TRAIN_SEQ, h, d, "fixed", 128, True, torch.float32),
             ("long-s4096", TRAIN_BATCH * TRAIN_SEQ // 4096, 4096, h, d, "fixed", 128, True,
              torch.bfloat16)]
    # head_dim alternates 64 / 128 over the cases
    breadth = [(f"{pat}-b{blk}-{'causal' if causal else 'noncausal'}", 1, 256, 2,
                (64, 128)[i % 2], pat, blk, causal, dtype)
               for i, (pat, blk, causal, dtype) in enumerate(itertools.product(
                   SA.PATTERNS, (16, 32, 64, 128), (True, False),
                   (torch.bfloat16, torch.float16, torch.float32)))]
    gen = torch.Generator(device="cuda").manual_seed(7)
    rnd = lambda *shape: torch.randn(*shape, generator=gen, device="cuda")
    fwd_out, bwd_out = [], []
    checked = set()
    for name, b, s, hh, dd, pattern, block, causal, dtype in timed + breadth:
        kwargs = SPARSE_ATTENTION["sparse_pattern_config"] if (name, dtype) in {
            (t[0], t[-1]) for t in timed} else {}
        attn = SA.BlockSparseAttention(SA.PATTERNS[pattern](block=block, **kwargs), s,
                                       causal=causal, device="cuda")
        lists = attn.lists
        if name == "main" and dtype == torch.bfloat16:
            checked.add((b, s, hh, hh, dd, attn.layout.tobytes()))
        q, k, v, do = (rnd(b, s, hh, dd).to(dtype) for _ in range(4))
        o, lse = block_sparse_attention_fwd(q, k, v, lists, causal=causal, return_lse=True)
        ref, ref_lse = block_sparse_attention_fwd_reference(q, k, v, lists, causal=causal,
                                                            return_lse=True)
        route = block_sparse_route(dtype, dd, block)
        grads = block_sparse_attention_bwd(q, k, v, ref, ref_lse, do, lists, causal=causal)
        refs = block_sparse_attention_bwd_reference(q, k, v, ref, ref_lse, do, lists,
                                                    causal=causal)
        # the wmma kernels at the same shape hold the plain version too
        old_grads = (block_sparse_attention_bwd(q, k, v, ref, ref_lse, do, lists, causal=causal,
                                                _route="wmma") if route == "wgmma" else None)
        torch.cuda.synchronize()
        label = f"block-sparse {name} {dtype}"
        if dtype == torch.float32:
            tol = f"{TOL_FP32[0]:g} + {TOL_FP32[1]:g}|plain|"
            limit = TOL_FP32[0] + TOL_FP32[1] * ref.float().abs()
            limits = [TOL_FP32[0] + TOL_FP32[1] * r.float().abs() for r in refs]
        else:
            tol = f"{ATOL_16:g} + rounding bound"
            limit = ATOL_16 + rounding_bound(q, k, v, ref, lists, causal=causal)
            limits = [ATOL_16 + x for x in bwd_rounding_bound(q, k, v, ref, ref_lse, do, refs,
                                                              lists, causal=causal)]
        use = check_limit(f"{label} fwd", (o.float() - ref.float()).abs(), limit, tol)
        lse_use = check_limit(f"{label} lse", (lse - ref_lse).abs(),
                              1e-5 + 1e-5 * ref_lse.abs(), "1e-05 + 1e-05|plain lse|")
        errs, uses = {}, {}
        for i, gname in enumerate(("dq", "dk", "dv")):
            diff = (grads[i].float() - refs[i].float()).abs()
            uses[gname] = check_limit(f"{label} {gname}", diff, limits[i], tol)
            errs[gname] = diff.max().item()
            if old_grads is not None:
                check_limit(f"{label} {gname} (wmma route)",
                            (old_grads[i].float() - refs[i].float()).abs(), limits[i], tol)
        common = dict(case=name, dtype=str(dtype).split(".")[1], b=b, s=s, h=hh, d=dd,
                      pattern=pattern, block=block, causal=causal,
                      main_path=name == "main" and dtype == torch.bfloat16,
                      kept_blocks=int(attn.layout.sum()), max_active=lists.max_a,
                      density=attn.density, tolerance=tol)
        f = dict(common, max_abs_err=(o.float() - ref.float()).abs().max().item(),
                 lse_max_abs_err=(lse - ref_lse).abs().max().item(), limit_use=use,
                 lse_limit_use=lse_use)
        g = dict(common, max_abs_err=max(errs.values()), max_abs_err_by_grad=errs,
                 limit_use=max(uses.values()), limit_use_by_grad=uses, kernel_route=route,
                 old_route_ms=None)
        del limit, limits, grads, refs, old_grads
        if (name, dtype) in {(t[0], t[-1]) for t in timed}:
            kept = kept_pairs(attn.layout, block, s, s, causal)
            peak = H100_FP32_FLOPS if dtype == torch.float32 else H100_BF16_FLOPS
            size = q.numel() * q.element_size()
            # forward: 2 products of 2 d per kept element; q, k, v read, o and lse
            # written. backward: 5 products; q, k, v, o, dO, lse read, dq, dk, dv written
            for r, flops, n_bytes in ((f, 4 * dd * kept * b * hh, 4 * size + lse.numel() * 4),
                                      (g, 10 * dd * kept * b * hh, 8 * size + lse.numel() * 4)):
                t_ops, t_bytes = flops / peak, n_bytes / H100_BYTES
                r.update(kept_elements_per_head=kept, flops=flops, bytes=n_bytes,
                         bound_ms=max(t_ops, t_bytes) * 1e3,
                         bound_by="operations" if t_ops >= t_bytes else "bytes")
            f["ms"] = time_ms(lambda: block_sparse_attention_fwd(q, k, v, lists, causal=causal,
                                                                 return_lse=True), 20)
            f["plain_ms"] = time_ms(lambda: block_sparse_attention_fwd_reference(
                q, k, v, lists, causal=causal, return_lse=True), 3)
            kernel = lambda: block_sparse_attention_bwd(q, k, v, o, lse, do, lists,
                                                        causal=causal)
            if route == "wgmma":
                g["ms"], g["old_route_ms"] = route_turns(
                    kernel, lambda: block_sparse_attention_bwd(q, k, v, o, lse, do, lists,
                                                               causal=causal, _route="wmma"), 20)
            else:
                g["ms"] = time_ms(kernel, 20)
            g["plain_ms"] = time_ms(lambda: block_sparse_attention_bwd_reference(
                q, k, v, o, lse, do, lists, causal=causal), 3)
            # the yardstick: SDPA with the token-level mask of (layout AND causal)
            mask = np.kron(attn.layout, np.ones((block, block), bool))
            if causal:
                mask &= np.tril(np.ones((s, s), bool))
            mask = torch.as_tensor(mask, device="cuda")
            qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
            f["library_ms"] = time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask), 20)
            sdpa = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
            gt = do.transpose(1, 2)
            g["library_ms"] = time_ms(lambda: torch.autograd.grad(sdpa, (qt, kt, vt), gt,
                                                                  retain_graph=True), 20)
            if name.startswith("long"):
                # the port's dense flash kernels on the same tensors: what sparsity buys
                fo, flse = flash_attention_fwd(q, k, v, causal=True, return_lse=True)
                f["flash_ms"] = time_ms(lambda: flash_attention_fwd(q, k, v, causal=True,
                                                                    return_lse=True), 10)
                g["flash_ms"] = time_ms(lambda: flash_attention_bwd(q, k, v, fo, flse, do,
                                                                    causal=True), 10)
                del fo, flse
            for r, part in ((f, "fwd"), (g, "bwd")):
                r["tflops"] = r["flops"] / r["ms"] / 1e9
                extra = f"  dense flash {r['flash_ms']:.4f} ms" if "flash_ms" in r else ""
                was = (f" (wmma route {r['old_route_ms']:.4f} ms)"
                       if r.get("old_route_ms") is not None else "")
                log(f"  block-sparse {part} {name:10s} {r['dtype']:8s} err {r['max_abs_err']:.2e} "
                    f"({r['limit_use']:.2f} of the limit)  {r.get('kernel_route', 'wmma')} "
                    f"{r['ms']:.4f} ms{was}  plain "
                    f"{r['plain_ms']:.4f} ms  sdpa+mask {r['library_ms']:.4f} ms  bound "
                    f"{r['bound_ms']:.4f} ms ({r['bound_by']})  {r['tflops']:.1f} TFLOP/s"
                    f"{extra}")
            del mask, qt, kt, vt, sdpa, gt
        fwd_out.append(f)
        bwd_out.append(g)
        del q, k, v, do, o, lse, ref, ref_lse
    worst = max(max(r["limit_use"] for r in fwd_out), max(r["limit_use"] for r in bwd_out))
    n_wgmma = sum(r["kernel_route"] == "wgmma" for r in bwd_out)
    log(f"  block-sparse breadth: {len(breadth)} cases (5 patterns x blocks 16/32/64/128 x "
        f"causal/non-causal x bf16/fp16/fp32), forward, lse, dq, dk, dv each within its "
        f"limit (worst {worst:.2f} of a limit); {n_wgmma} backward cases on the wgmma route, "
        f"each also held on the wmma route")
    torch.cuda.empty_cache()
    return {"fwd": fwd_out, "bwd": bwd_out}, checked


def phase_train_card_vs_cpu(torch, sparse=False):
    """Training on the card against the CPU port: GPT-2-medium width (d 1024,
    16 heads, vocab 50304) with 2 layers in fp32, the same seeded weights on
    both, batch 2 x seq 256 (flash attention) or, with ``sparse``, batch 1 x
    seq 1024 with phase 8's block-sparse layout (the fixed pattern, 128-token
    blocks, 24 of 36 causal blocks kept). One forward/backward: the loss and
    the grads of wte, a block kernel and ln_f; then the losses of 3
    ``train_batch`` steps."""
    import numpy as np

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import CausalLM, gpt2_config
    from deepspeed_tpu_torch.models.layers import flatten_tree, tree_map
    from deepspeed_tpu_torch.ops.cuda import LAUNCH_COUNTS

    attention = dict(SPARSE_ATTENTION) if sparse else {"attention_impl": "flash"}
    batch, seq = (1, TRAIN_SEQ) if sparse else (2, 256)
    kernel = "block_sparse_attention_fwd" if sparse else "flash_attention_fwd"
    cfg = lambda: gpt2_config("medium", vocab_size=TRAIN_VOCAB, n_layers=2,
                              fused_ce_impl="pallas", **attention)
    ds = {"train_batch_size": batch, "seed": 5, "gradient_clipping": 1.0,
          "optimizer": {"type": "adamw", "params": {"lr": 1e-4, "weight_decay": 0.01}}}
    card, *_ = deepspeed_tpu_torch.initialize(model=CausalLM(cfg()), config=ds)
    cpu, *_ = deepspeed_tpu_torch.initialize(
        model=CausalLM(cfg()), config=ds, device="cpu",
        model_parameters=tree_map(lambda t: t.detach().cpu(), card.params))
    rng = np.random.RandomState(6)
    batches = [{"input_ids": rng.randint(0, TRAIN_VOCAB, (batch, seq))} for _ in range(4)]
    losses = {}
    for name, eng in (("card", card), ("cpu", cpu)):
        before = LAUNCH_COUNTS[kernel]
        losses[name] = [eng.forward(batches[0]).item()]
        eng.backward()
        if (LAUNCH_COUNTS[kernel] - before > 0) != (name == "card"):
            raise AssertionError(f"{name}: {LAUNCH_COUNTS[kernel] - before} {kernel} launches")
    grads = {}
    for key in ("wte/weight", "blocks/mlp/fc/kernel", "ln_f/scale"):
        g_card = flatten_tree(card.params)[key].grad.cpu()
        g_cpu = flatten_tree(cpu.params)[key].grad
        err, scale = (g_card - g_cpu).abs().max().item(), g_cpu.abs().max().item()
        # fp32 on both sides (TF32 off): sums in another order
        if not err <= 1e-4 * scale + 1e-8:
            raise AssertionError(f"grad {key}: card vs CPU max abs err {err} (|grad| max {scale})")
        grads[key] = {"max_abs_err": err, "max_abs": scale}
    for eng in (card, cpu):
        eng.step()
    for name, eng in (("card", card), ("cpu", cpu)):
        losses[name] += [float(eng.train_batch(batch=bt)) for bt in batches[1:]]
    for a, b_ in zip(losses["card"], losses["cpu"]):
        if not abs(a - b_) <= 1e-4 * abs(b_):
            raise AssertionError(f"card vs CPU training losses {losses}")
    log(f"  loss card {losses['card'][0]:.6f} cpu {losses['cpu'][0]:.6f}; grads max abs err "
        + ", ".join(f"{k} {v['max_abs_err']:.2e} (|g| {v['max_abs']:.2e})"
                    for k, v in grads.items()))
    log(f"  3 train_batch steps: card {losses['card'][1:]} cpu {losses['cpu'][1:]}")
    card.destroy()
    cpu.destroy()
    return {"losses": losses, "grads": grads}


def model_flops_per_step(cfg, tokens, seq, pairs=None):
    """6 N T (forward 2, backward 4 operations per parameter and token, the
    tied head's GEMM included) plus the attention's 12 L d h pairs (QK^T and
    PV: 4 d per allowed pair forward, twice that backward); ``pairs`` are
    the causal pairs of a sequence unless given (a sparse layout's kept
    elements)."""
    if pairs is None:
        pairs = seq * (seq + 1) // 2
    return (6 * cfg.num_params() * tokens
            + 12 * cfg.n_layers * cfg.head_dim * cfg.n_heads * pairs * (tokens // seq))


def phase_training(torch, checked, sparse=False):
    """Phase 6 (or, with ``sparse``, phase 8): ``initialize`` ->
    ``train_batch`` on full GPT-2 medium at bench.py's shape and config (phase
    8: with block-sparse attention), on one fixed batch drawn from seed 0:
    TRAIN_WARMUP warm-up steps, then TRAIN_STEPS timed steps, each ended by
    a host read of its loss; the launch counts read around every step; one
    more step under torch.profiler. Phase 8 also takes one ``eval_batch``
    (forward kernels only). The attention and CE shapes must have been held
    against the plain versions in phase 2."""
    import numpy as np

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import CausalLM
    from deepspeed_tpu_torch.models.transformer import _block_sparse_attn
    from deepspeed_tpu_torch.ops.cuda import LAUNCH_COUNTS, reset_launch_counts

    cfg = train_sparse_model_config() if sparse else train_model_config()
    L = cfg.n_layers
    shape = (TRAIN_BATCH, TRAIN_SEQ, cfg.n_heads, cfg.kv_heads, cfg.head_dim)
    pairs = None
    if sparse:
        layout = _block_sparse_attn(cfg, TRAIN_SEQ, torch.device("cuda")).layout
        pairs = kept_pairs(layout, cfg.sparse_block, TRAIN_SEQ, TRAIN_SEQ, cfg.causal)
        shape = shape + (layout.tobytes(),)
    if shape not in checked["block_sparse" if sparse else "flash"] or (
            TRAIN_BATCH * TRAIN_SEQ, cfg.d_model, cfg.vocab_size) not in checked["ce"]:
        raise AssertionError(f"phase {8 if sparse else 6}'s shapes {shape[:5]} were not held "
                             f"against the plain versions in phase 2")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine, _, _, _ = deepspeed_tpu_torch.initialize(model=CausalLM(cfg), config=TRAIN_CONFIG)
    torch.cuda.synchronize()
    log(f"  init GPT-2 medium ({cfg.num_params() / 1e6:.1f} M params, fp32 masters, bf16 "
        f"compute) in {time.perf_counter() - t0:.3f} s")
    batch = {"input_ids": np.random.RandomState(0).randint(0, cfg.vocab_size,
                                                            (TRAIN_BATCH, TRAIN_SEQ))}
    # every CE launch, flash launch and block-sparse backward launch of the
    # step on the TMA + wgmma route
    if sparse:
        expected = {"block_sparse_attention_fwd": L, "block_sparse_attention_bwd": L,
                    "block_sparse_attention_bwd_wgmma": L, "fused_ce_forward": 1,
                    "fused_ce_forward_wgmma": 1, "flash_attention_fwd": 0,
                    "flash_attention_bwd": 0}
    else:
        expected = {"flash_attention_fwd": L, "flash_attention_bwd": L, "fused_ce_forward": 1,
                    "fused_ce_forward_wgmma": 1, "flash_attention_fwd_wgmma": L,
                    "flash_attention_bwd_wgmma": L}
    reset_launch_counts()
    losses, step_ms = [], []
    for step in range(TRAIN_WARMUP + TRAIN_STEPS):
        before = dict(LAUNCH_COUNTS)
        t = time.perf_counter()
        loss = float(engine.train_batch(batch=batch))   # the host read ends the step
        step_ms.append((time.perf_counter() - t) * 1e3)
        delta = {k: LAUNCH_COUNTS[k] - before[k] for k in expected}
        if delta != expected:
            raise AssertionError(f"step {step}: launches {delta}, expected {expected}")
        losses.append(loss)
        log(f"  step {step}: loss {loss:.6f}  {step_ms[-1]:.1f} ms")
    eval_loss = None
    if sparse:
        before = dict(LAUNCH_COUNTS)
        eval_loss = float(engine.eval_batch(batch=batch))
        delta = {k: LAUNCH_COUNTS[k] - before[k] for k in expected}
        want = dict(expected, block_sparse_attention_bwd=0, block_sparse_attention_bwd_wgmma=0)
        if delta != want or not math.isfinite(eval_loss):
            raise AssertionError(f"eval_batch: loss {eval_loss}, launches {delta}, expected "
                                 f"{want}")
        log(f"  eval_batch: loss {eval_loss:.6f}; launches {delta}")
    launches = dict(LAUNCH_COUNTS)
    peak = torch.cuda.max_memory_allocated() / 2**30
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"training losses not finite or not falling: {losses}")
    timed = sorted(step_ms[TRAIN_WARMUP:])
    median_ms = timed[len(timed) // 2] if len(timed) % 2 else \
        (timed[len(timed) // 2 - 1] + timed[len(timed) // 2]) / 2
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = model_flops_per_step(cfg, tokens, TRAIN_SEQ, pairs)
    if sparse:
        model = ("gpt2-medium (bench.py: vocab 50304, no remat, fused CE pallas) with "
                 "block-sparse attention: fixed, block 128, 4 local, 1 global")
        formula = "6 N T + 12 L d_head h (the layout's kept pairs) (T / seq)"
    else:
        model = "gpt2-medium (bench.py: vocab 50304, flash, no remat, fused CE pallas)"
        formula = "6 N T + 12 L d_head h (causal pairs) (T / seq)"
    out = {"model": model, "params": cfg.num_params(), "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
           "config": TRAIN_CONFIG, "losses": losses, "step_ms": step_ms,
           "warmup_steps": TRAIN_WARMUP, "step_ms_median": median_ms,
           "tokens_per_s": tokens / median_ms * 1e3, "peak_gib": peak,
           "launches": launches, "launches_per_step": expected,
           "model_flops_per_step": flops, "model_flops_formula": formula,
           "mfu_vs_989_tflops": flops / (median_ms / 1e3) / H100_BF16_FLOPS}
    if sparse:
        out.update(eval_loss=eval_loss, attention_pairs_per_head=pairs,
                   causal_pairs_per_head=TRAIN_SEQ * (TRAIN_SEQ + 1) // 2)
    log(f"  step ms median {median_ms:.1f} over {TRAIN_STEPS} steps; tokens/s "
        f"{out['tokens_per_s']:.0f}; model FLOPs/step ({out['model_flops_formula']}) "
        f"{flops / 1e12:.2f} T = {out['mfu_vs_989_tflops']:.3f} of 989 TFLOP/s; peak device "
        f"memory {peak:.2f} GiB; launches per step {expected}")
    out["profile"] = profile_train_step(torch, engine, batch, median_ms)
    engine.destroy()
    return out


def profile_train_step(torch, engine, batch, wall_ms):
    """One more ``train_batch`` under torch.profiler: device kernel time by
    name, and the device's busy and idle share of the median unprofiled step
    wall (the profiler's host cost would inflate the profiled wall)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        float(engine.train_batch(batch=batch))
        profiled_ms = (time.perf_counter() - t) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.device_time_total > 0]
    busy_ms = sum(e.device_time_total for e in kernels) / 1e3
    if busy_ms <= 0:
        log("  profile: the trace shows no device time (not measured)")
        return {"wall_ms": wall_ms, "device_busy_ms": None}
    top = sorted(kernels, key=lambda e: e.device_time_total, reverse=True)[:12]
    out = {"step_wall_ms": wall_ms, "profiled_wall_ms": profiled_ms, "device_busy_ms": busy_ms,
           "device_idle_share": 1 - busy_ms / wall_ms,
           "top_kernels": [{"name": e.key[:100], "ms": e.device_time_total / 1e3,
                            "count": e.count} for e in top]}
    log(f"  profile: device busy {busy_ms:.1f} ms of the median {wall_ms:.1f} ms step (idle "
        f"share {out['device_idle_share']:.3f}; the profiled step took {profiled_ms:.1f} ms)")
    for k in out["top_kernels"]:
        log(f"    {k['ms']:9.3f} ms  x{k['count']:<6d} {k['name']}")
    return out


def qmm_main_ms():
    """Every token count m the quantized linears of phase 7 run: the decode
    batches (1 and 4 rows of ``generate()``, the 8 serving slots) and every
    prefill (batch x bucket of phase 4's requests, phase 5's prompt buckets
    and its shared-prefix suffix bucket)."""
    from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig
    from deepspeed_tpu_torch.inference.engine import bucket_prompt_len

    cfg = DeepSpeedInferenceConfig.from_dict(MAIN_CONFIG)
    ms = {b * s for b, s in main_path_prefill_shapes()}
    ms |= {b for name, (b, _) in REQUESTS if name in QUANT_REQUESTS}
    ms.add(MAIN_CONFIG["serving"]["n_slots"])
    suffix = SERVE_PROMPTS[SHARED[1] % len(SERVE_PROMPTS)] - SHARED_PREFIX
    ms.add(bucket_prompt_len(cfg, suffix, cfg.serving.max_len - SHARED_PREFIX))
    return sorted(ms)


def phase_qmm_kernels(torch, main_ms):
    """``quantized_matmul`` (int8 and int4) against its plain version: bf16 at
    Llama-7B's linears (k, n) for every m phase 7 runs, group 64; fp16 and
    fp32 at (4096, 11008) m 8; a ragged case (m not a multiple of 16, n not
    of 128, an odd group). Each case has the kernel's time, the plain
    version's, the bound and ``torch.matmul`` on the weight dequantized
    beforehand (the unquantized model's GEMM) as the yardstick; a case of
    the TMA + wgmma route is also timed through the old wmma route, in
    turns (old, new, new, old), and its time is the mean of its two turns."""
    from deepspeed_tpu_torch.ops.cuda.quantized_matmul import (dequantized_weight,
                                                               kernel_route,
                                                               quantized_matmul,
                                                               quantized_matmul_reference,
                                                               rounding_bound)
    from deepspeed_tpu_torch.ops.quantizer import pack_int4, quantize_per_channel

    cases = [(m, k, n, 64, torch.bfloat16) for k, n in LLAMA_LINEARS for m in main_ms]
    cases += [(8, 4096, 11008, 64, torch.float16), (8, 4096, 11008, 64, torch.float32),
              (37, 4094, 4000, 23, torch.bfloat16)]
    gen = torch.Generator(device="cuda").manual_seed(4)
    weights = {}
    results = []
    for bits in (8, 4):
        quantized = {}
        for m, k, n, group, dtype in cases:
            if (k, n) not in weights:
                weights[(k, n)] = (torch.randn(k, n, generator=gen, device="cuda")
                                   * 0.02).to(torch.bfloat16)
            if (k, n, group) not in quantized:
                q, s32 = quantize_per_channel(weights[(k, n)], bits=bits, group_size=group)
                quantized[(k, n, group)] = (pack_int4(q) if bits == 4 else q, s32)
            q, scale32 = quantized[(k, n, group)]
            scale = scale32.to(dtype)     # the model hands the scale over in x's dtype
            x = torch.randn(m, k, generator=gen, device="cuda").to(dtype)
            kern = lambda: quantized_matmul(x, q, scale, bits=bits)
            plain = lambda: quantized_matmul_reference(x, q, scale, bits=bits)
            y, ref = kern(), plain()
            torch.cuda.synchronize()
            diff = (y.float() - ref.float()).abs()
            if dtype == torch.float32:
                tol, limit = "2e-05 + 2e-05|plain|", TOL_FP32[0] + TOL_FP32[1] * ref.float().abs()
            else:
                tol = "1e-05 + 2u|plain| + 2k 2^-24 |x||w|"
                limit = rounding_bound(x, q, scale, ref, bits=bits)
            name = f"qmm int{bits} m{m} k{k} n{n} g{group} {dtype}"
            use = check_limit(name, diff, limit, tol)
            w_deq = dequantized_weight(q, scale, bits).to(dtype)
            route = kernel_route(m, n, k, group, dtype, bits)
            old_route_ms = None
            if route == "wgmma":
                kernel_ms, old_route_ms = route_turns(
                    kern, lambda: quantized_matmul(x, q, scale, bits=bits, route="wmma"), 20)
            else:
                kernel_ms = time_ms(kern, 20)
            plain_ms = time_ms(plain, 3)
            library_ms = time_ms(lambda: torch.matmul(x, w_deq), 20)
            # the bound: x, q, the scales and y moved once; 2 m n k operations
            n_bytes = (x.numel() * x.element_size() + q.numel() + scale.numel()
                       * scale.element_size() + m * n * x.element_size())
            flops = 2 * m * n * k
            t_bytes = n_bytes / H100_BYTES
            t_ops = flops / (H100_FP32_FLOPS if dtype == torch.float32 else H100_BF16_FLOPS)
            r = dict(case=f"m{m}-k{k}-n{n}-g{group}", bits=bits, dtype=str(dtype).split(".")[1],
                     m=m, k=k, n=n, group=group, main_path=(k, n) in LLAMA_LINEARS
                     and dtype == torch.bfloat16 and group == 64,
                     route=route, max_abs_err=diff.max().item(), tolerance=tol,
                     limit_use=use, ms=kernel_ms, old_route_ms=old_route_ms,
                     plain_ms=plain_ms, library_ms=library_ms,
                     bound_ms=max(t_bytes, t_ops) * 1e3,
                     bound_by="operations" if t_ops >= t_bytes else "bytes", bytes=n_bytes,
                     flops=flops, gb_per_s=n_bytes / kernel_ms / 1e6,
                     tflops=flops / kernel_ms / 1e9)
            was = "" if old_route_ms is None else f" (wmma route {old_route_ms:.4f} ms)"
            log(f"  {name:44s} err {r['max_abs_err']:.2e} ({use:.2f} of the limit)  {route} "
                f"{kernel_ms:.4f} ms{was}  plain {plain_ms:.4f} ms  matmul {library_ms:.4f} ms  "
                f"bound "
                f"{r['bound_ms']:.4f} ms ({r['bound_by']})  {r['gb_per_s']:.0f} GB/s "
                f"{r['tflops']:.1f} TFLOP/s")
            results.append(r)
            del x, y, ref, diff, limit, w_deq
    return results


def phase_paged_int8_kernels(torch, F):
    """``paged_flash_decode`` on an int8 pool against its plain version at
    phase 5's decode geometry, plus a GQA case; the yardstick is the gather
    + masked SDPA on the pool dequantized beforehand."""
    from deepspeed_tpu_torch.comm.collectives import dequantize_blockwise, quantize_blockwise
    from deepspeed_tpu_torch.ops.cuda.paged_attention import (kernel_splits,
                                                              paged_flash_decode,
                                                              paged_flash_decode_reference,
                                                              rounding_bound)

    serving = MAIN_CONFIG["serving"]
    s_dim, bs = serving["n_slots"], serving["kv_pool"]["block_size"]
    nb_cols = serving["max_len"] // bs
    cursors = decode_cursors()
    gen = torch.Generator(device="cuda").manual_seed(5)
    results = []
    for dtype in (torch.bfloat16, torch.float32):
        for name, n_heads, kvh in (("main", 32, 32), ("gqa-32/8", 32, 8)):
            q, k_new, v_new, kc, vc, table, pos = paged_inputs(
                torch, gen, s_dim, n_heads, kvh, 128, bs, nb_cols, cursors, torch.float32)
            q, k_new, v_new = q.to(dtype), k_new.to(dtype), v_new.to(dtype)
            kq, ks = quantize_blockwise(kc, block=128)
            vq, vs = quantize_blockwise(vc, block=128)
            del kc, vc
            args = (q, k_new, v_new, kq, vq, table, pos)
            scales = dict(k_scale=ks, v_scale=vs)
            splits = kernel_splits(s_dim, kvh, nb_cols, "cuda")
            kern = lambda: paged_flash_decode(*args, **scales, kv_splits=splits)
            plain = lambda: paged_flash_decode_reference(*args, **scales, kv_splits=splits)
            out, ref = kern(), plain()
            torch.cuda.synchronize()
            diff = (out.float() - ref.float()).abs()
            if dtype == torch.float32:
                tol, limit = "2e-05 + 2e-05|plain|", TOL_FP32[0] + TOL_FP32[1] * ref.float().abs()
            else:
                tol = f"{ATOL_16:g} + rounding bound (on the dequantized pool)"
                limit = ATOL_16 + rounding_bound(*args, ref, **scales)
            use = check_limit(f"paged int8 {name} {dtype}", diff, limit, tol)
            if not bool(torch.isfinite(out).all()) or out.float().abs().max().item() > 100:
                raise AssertionError(f"paged int8 {name}: the garbage block leaked in")
            kd_all = dequantize_blockwise(kq, ks, dtype)
            vd_all = dequantize_blockwise(vq, vs, dtype)
            t_len = nb_cols * bs
            rows = torch.arange(s_dim, device="cuda")
            at = torch.arange(t_len, device="cuda")
            mask = (at[None, :] <= pos.long()[:, None])[:, None, None, :]

            def lib():
                kd = kd_all[table.long()].reshape(s_dim, t_len, kvh, 128)
                vd = vd_all[table.long()].reshape(s_dim, t_len, kvh, 128)
                kd[rows, pos.long()] = k_new
                vd[rows, pos.long()] = v_new
                return F.scaled_dot_product_attention(
                    q[:, :, None], kd.transpose(1, 2), vd.transpose(1, 2), attn_mask=mask,
                    enable_gqa=kvh != n_heads)

            lib_err = (lib()[:, :, 0].float() - ref.float()).abs().max().item()
            kernel_ms = time_ms(kern, 20)
            plain_ms = time_ms(plain, 5)
            library_ms = time_ms(lib, 20)
            # the bound: the valid int8 K/V rows with their fp32 scales, q, the
            # fresh rows, the out, the table and cursors moved once; and
            # 4 * n_heads * dh operations per attended position
            attended = sum(cursors) + s_dim
            n_bytes = (2 * sum(cursors) * kvh * (128 + 4)
                       + (2 * s_dim * n_heads * 128 + 2 * s_dim * kvh * 128) * q.element_size()
                       + 4 * (table.numel() + s_dim))
            flops = 4 * n_heads * 128 * attended
            t_bytes = n_bytes / H100_BYTES
            t_ops = flops / (H100_FP32_FLOPS if dtype == torch.float32 else H100_BF16_FLOPS)
            r = dict(case=name, dtype=str(dtype).split(".")[1], slots=s_dim, n_heads=n_heads,
                     kv_heads=kvh, head_dim=128, block_size=bs, window=t_len, cursors=cursors,
                     splits=splits, main_path=name == "main", max_abs_err=diff.max().item(),
                     tolerance=tol, limit_use=use, library_max_abs_err=lib_err, ms=kernel_ms,
                     plain_ms=plain_ms, library_ms=library_ms,
                     bound_ms=max(t_bytes, t_ops) * 1e3,
                     bound_by="operations" if t_ops >= t_bytes else "bytes", bytes=n_bytes,
                     flops=flops, gb_per_s=n_bytes / kernel_ms / 1e6)
            log(f"  paged int8 {name:9s} {r['dtype']:8s} splits {splits} err "
                f"{r['max_abs_err']:.2e} ({use:.2f} of the limit)  kernel {kernel_ms:.4f} ms  "
                f"plain {plain_ms:.4f} ms  gather+sdpa {library_ms:.4f} ms  bound "
                f"{r['bound_ms']:.4f} ms ({r['bound_by']})  {r['gb_per_s']:.0f} GB/s")
            results.append(r)
            del args, scales, q, kq, vq, ks, vs, kd_all, vd_all, out, ref, diff, limit, mask
    return results


def phase_quant_card_vs_cpu(torch):
    """Llama-7B width, 2 layers, fp32: int8 and int4 weights quantized on the
    card, the same quantized tree on the CPU port: prefill logits and 8
    greedy tokens; then one decode step on an int8 pool, the card's fused
    step against its gather step and the CPU port's gather step."""
    import numpy as np

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.inference import DeepSpeedInferenceConfig, InferenceEngine
    from deepspeed_tpu_torch.models import CausalLM, llama_config
    from deepspeed_tpu_torch.models import decoding as dec
    from deepspeed_tpu_torch.models.layers import tree_map
    from deepspeed_tpu_torch.ops.cuda import LAUNCH_COUNTS

    out = {}
    ids = torch.tensor(np.random.RandomState(1).randint(0, 32000, (2, 100)))
    padded = torch.nn.functional.pad(ids, (0, 28))  # the 128 prompt bucket
    for bits in (8, 4):
        config = {"dtype": "float32", "max_tokens": 256, "seed": 1}
        card = deepspeed_tpu_torch.init_inference(
            CausalLM(llama_config("7b", n_layers=2)),
            {**config, "quant": {"enabled": True, "bits": bits, "group_size": 64}})
        cpu = InferenceEngine(CausalLM(llama_config("7b", n_layers=2)),
                              DeepSpeedInferenceConfig.from_dict(config), device="cpu",
                              model_parameters=tree_map(lambda t: t.detach().cpu(), card.params))
        key = "kernel_q4" if bits == 4 else "kernel_q"
        if key not in cpu.params["blocks"]["mlp"]["up"]:
            raise AssertionError(f"int{bits}: the CPU port did not receive the quantized tree")
        logits, caches = {}, {}
        before = LAUNCH_COUNTS[f"quantized_matmul_int{bits}"]
        for name, eng in (("card", card), ("cpu", cpu)):
            with torch.inference_mode():
                cache = dec.init_cache(eng.module.config, 2, 136, torch.float32,
                                       device=eng.device)
                logits[name] = dec.forward_with_cache(eng.module, eng.params,
                                                      padded.to(eng.device), cache, 0, 136,
                                                      prefill=True).cpu()
                caches[name] = cache
        if LAUNCH_COUNTS[f"quantized_matmul_int{bits}"] - before != 7 * 2:
            raise AssertionError(f"int{bits}: the card's prefill did not launch 14 "
                                 f"quantized matmuls")
        err = (logits["card"] - logits["cpu"]).abs().max().item()
        scale = logits["cpu"].abs().max().item()
        if not err <= 2e-4 * max(1.0, scale):
            raise AssertionError(f"int{bits} card vs CPU prefill logits: max abs err {err} "
                                 f"(|logits| {scale})")
        toks = {name: eng.generate(ids[:1].numpy(), max_new_tokens=8).cpu()
                for name, eng in (("card", card), ("cpu", cpu))}
        if not torch.equal(toks["card"], toks["cpu"]):
            raise AssertionError(f"int{bits} greedy streams differ: card "
                                 f"{toks['card'][0, 100:].tolist()} cpu "
                                 f"{toks['cpu'][0, 100:].tolist()}")
        r = {"prefill_logits_max_abs_err": err, "logits_abs_max": scale,
             "greedy_tokens": toks["card"][0, 100:].tolist()}
        log(f"  int{bits} weights: prefill logits max abs err {err:.3e} (|logits| max "
            f"{scale:.2f}); 8 greedy tokens equal: {r['greedy_tokens']}")
        if bits == 8:
            # one decode step on the same int8 pool on each side: the CPU
            # port's prefill quantized into it, copied to the card (pools
            # quantized from two prefills that differ in their last bits can
            # differ by one int8 step, which the comparison would then see)
            pool0 = dec.init_paged_cache(cpu.module.config, 17, 16, torch.float32, "int8")
            for s in range(2):
                dec.insert_block_kv(pool0, {k: v[:, s:s + 1] for k, v in caches["cpu"].items()},
                                    list(range(1 + 8 * s, 9 + 8 * s)), 0, 16)
            step = {}
            for name, eng, backend in (("card-fused", card, "fused"),
                                       ("card-gather", card, "gather"),
                                       ("cpu-gather", cpu, "gather")):
                dev = eng.device
                pool = {k: v.to(dev) for k, v in pool0.items()}
                table = torch.arange(1, 17, dtype=torch.int32, device=dev).reshape(2, 8)
                pos = torch.tensor([100, 90], dtype=torch.int32, device=dev)
                tok = torch.tensor([[7], [11]], device=dev)
                before = LAUNCH_COUNTS["paged_flash_decode_int8"]
                with torch.inference_mode():
                    step[name] = dec.forward_with_paged_cache(
                        eng.module, eng.params, tok, pool, table, pos, 16,
                        attention_backend=backend)[:, 0].float().cpu()
                launched = LAUNCH_COUNTS["paged_flash_decode_int8"] - before
                if launched != (2 if name == "card-fused" else 0):
                    raise AssertionError(f"{name}: {launched} int8 paged kernel launches")
            scale = step["cpu-gather"].abs().max().item()
            errs = {k: (step["card-fused"] - step[k]).abs().max().item()
                    for k in ("card-gather", "cpu-gather")}
            # JAX's pin between the int8 fused and gather paths, 2e-4, on
            # logits of unit scale
            for k, e in errs.items():
                if not e <= 2e-4 * max(1.0, scale):
                    raise AssertionError(f"int8 pool decode step: fused vs {k} max abs err {e}")
            r["int8_pool_step"] = {"fused_vs_card_gather": errs["card-gather"],
                                   "fused_vs_cpu_gather": errs["cpu-gather"],
                                   "logits_abs_max": scale}
            log(f"  int8 pool, one decode step: card fused vs card gather "
                f"{errs['card-gather']:.3e}, vs CPU gather {errs['cpu-gather']:.3e} "
                f"(|logits| max {scale:.2f})")
        out[f"int{bits}"] = r
        card.destroy()
        cpu.destroy()
        torch.cuda.empty_cache()
    return out


def phase_quant_path(torch, checked_qmm, bf16_pool_bytes):
    """Phase 7: the quantized serving path at full Llama-7B, bf16. (a) int8
    weights (group 64) on an int8 paged pool with the fused backend:
    ``generate()`` over phase 4's requests in ``QUANT_REQUESTS`` and
    ``serve()`` of phase 5's traffic (run 1 measured, run 2 with a fused-vs-
    gather step and a profiled stretch); (b) int4 weights, ``generate()``
    over the same requests. Every quantized matmul shape must have been held
    against the plain version in phase 2, and each forward launches 7
    quantized matmuls per layer."""
    import numpy as np

    import deepspeed_tpu_torch
    import deepspeed_tpu_torch.ops.cuda.quantized_matmul as qmm_mod
    from deepspeed_tpu_torch.inference.engine import bucket_prompt_len
    from deepspeed_tpu_torch.models import CausalLM, llama_config
    from deepspeed_tpu_torch.ops.cuda import LAUNCH_COUNTS, reset_launch_counts

    cfg = llama_config("7b")
    n_layers, vocab = cfg.n_layers, cfg.vocab_size
    per_forward = 7 * n_layers
    seen = set()
    real = qmm_mod.quantized_matmul

    forced = {"route": None}   # "wmma": the prefill linears through the old route

    def recording(x, q, scale, bits):
        seen.add((x.shape[0], x.shape[1], q.shape[1], bits, x.dtype))
        return real(x, q, scale, bits=bits, route=forced["route"] if x.shape[0] > 16 else None)

    qmm_mod.quantized_matmul = recording
    out = {}
    try:
        for bits in (8, 4):
            label = f"int{bits}"
            config = json.loads(json.dumps(MAIN_CONFIG))
            config["quant"] = {"enabled": True, "bits": bits, "group_size": 64}
            config["serving"]["kv_pool"]["kv_dtype"] = "int8"
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            eng = deepspeed_tpu_torch.init_inference(CausalLM(cfg), config)
            torch.cuda.synchronize()
            init_s = time.perf_counter() - t0
            weight_bytes = sum(p.numel() * p.element_size() for p in eng.module.parameters())
            scale_bytes_bf16 = sum(p.numel() * 2 for n, p in eng.module.named_parameters()
                                   if n.endswith("kernel_scale"))
            stored = {str(p.dtype) for n, p in eng.module.named_parameters()
                      if "blocks" in n and ("kernel_q" in n)}
            log(f"  {label}: init + quantize in {init_s:.2f} s; stored weights "
                f"{weight_bytes / 1e9:.3f} GB ({stored}); peak "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
            rng = np.random.RandomState(0)
            requests = []
            reset_launch_counts()
            n_forwards = 0
            prompts = {}
            for name, shape in REQUESTS:
                ids = rng.randint(0, vocab, shape)
                if name not in QUANT_REQUESTS:
                    continue
                prompts[name] = ids
                streams = []
                for attempt in ("cold", "warm"):
                    before = dict(LAUNCH_COUNTS)
                    t = time.perf_counter()
                    o = eng.generate(ids, max_new_tokens=MAX_NEW, greedy=True)
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t
                    o = o.cpu()
                    launched = LAUNCH_COUNTS[f"quantized_matmul_{label}"] - before[
                        f"quantized_matmul_{label}"]
                    if launched != per_forward * MAX_NEW:
                        raise AssertionError(f"{label} {name}: {launched} quantized matmul "
                                             f"launches, expected {per_forward} x {MAX_NEW}")
                    n_forwards += MAX_NEW
                    if int(o.min()) < 0 or int(o.max()) >= vocab:
                        raise AssertionError(f"{label} {name}: token outside the vocab")
                    streams.append(o)
                    sec = eng.last_timing.seconds()
                    r = dict(request=f"{name}/{attempt}", batch=shape[0], prompt=shape[1],
                             prefill_ms=sec["prefill"] * 1e3,
                             decode_ms_per_token=sec["decode"] * 1e3 / (MAX_NEW - 1),
                             wall_s=wall)
                    log(f"  {label} {r['request']:18s} prefill {r['prefill_ms']:.2f} ms  "
                        f"decode {r['decode_ms_per_token']:.3f} ms/token  wall {wall:.2f} s")
                    requests.append(r)
                if not torch.equal(*streams):
                    raise AssertionError(f"{label} {name}: repeated greedy request differs")
            gen_launches = dict(LAUNCH_COUNTS)
            if gen_launches[f"quantized_matmul_{label}"] != per_forward * n_forwards:
                raise AssertionError(f"{label}: generate launches {gen_launches}")
            # each generate() runs one prefill forward (m = batch x bucket > 16):
            # its linears, and only they, take the TMA + wgmma route
            if gen_launches[f"quantized_matmul_{label}_wgmma"] != per_forward * len(requests):
                raise AssertionError(f"{label}: {gen_launches[f'quantized_matmul_{label}_wgmma']} "
                                     f"wgmma-route launches, expected {per_forward} x "
                                     f"{len(requests)} prefills")
            # the same prefills with the linears through the old wmma route,
            # in turns (old, new, new, old; 2 new tokens, prefill ms read)
            # (2 new tokens where the prompt bucket stays the one MAX_NEW gives,
            # else MAX_NEW: the bucket caps at max_tokens - new tokens)
            routes = {}
            for name, ids in prompts.items():
                bucket = lambda new: bucket_prompt_len(eng.config, ids.shape[1],
                                                       eng.config.max_tokens - new)
                new = 2 if bucket(2) == bucket(MAX_NEW) else MAX_NEW
                turns = {"wmma": [], "wgmma": []}
                for route in ("wmma", "wgmma", "wgmma", "wmma"):
                    forced["route"] = None if route == "wgmma" else route
                    eng.generate(ids, max_new_tokens=new, greedy=True)
                    torch.cuda.synchronize()
                    turns[route].append(eng.last_timing.seconds()["prefill"] * 1e3)
                forced["route"] = None
                routes[name] = {"prefill_ms": sum(turns["wgmma"]) / 2,
                                "prefill_ms_wmma_route": sum(turns["wmma"]) / 2, "turns": turns}
                log(f"  {label} {name:18s} prefill {routes[name]['prefill_ms']:.2f} ms with the "
                    f"TMA + wgmma route, {routes[name]['prefill_ms_wmma_route']:.2f} ms with the "
                    f"old wmma route (turns old, new, new, old)")
            # data-sheet floor of a decode step: every weight read once
            head_bytes = eng.params["lm_head"]["kernel"].numel() * 2 \
                if "lm_head" in eng.params else 0
            block_q = sum(p.numel() * p.element_size() for n, p in eng.module.named_parameters()
                          if "kernel_q" in n)
            floor_ms = (block_q + scale_bytes_bf16 + head_bytes) / H100_BYTES * 1e3
            res = {"requests": requests, "launches_generate": gen_launches,
                   "prefill_by_route": routes,
                   "init_s": init_s, "stored_weight_gb": weight_bytes / 1e9,
                   "decode_weight_bytes": block_q + scale_bytes_bf16 + head_bytes,
                   "decode_floor_ms": floor_ms}
            log(f"  {label}: weight bytes read per decode step "
                f"{res['decode_weight_bytes'] / 1e9:.3f} GB -> floor {floor_ms:.3f} ms at 3.35 TB/s")
            if bits == 8:
                serving = phase_serving(torch, eng, set(main_path_prefill_shapes()),
                                        paged_kernel="paged_flash_decode_int8",
                                        qmm_kernel=f"quantized_matmul_{label}")
                serving["pool_bytes_vs_bf16"] = serving["pool_bytes"] / bf16_pool_bytes
                log(f"  int8 pool {serving['pool_bytes'] / 2**30:.3f} GiB against the bf16 "
                    f"pool's {bf16_pool_bytes / 2**30:.3f} GiB "
                    f"({serving['pool_bytes_vs_bf16']:.3f})")
                res["serving"] = serving
            out[label] = res
            eng.destroy()
            del eng
            torch.cuda.empty_cache()
    finally:
        qmm_mod.quantized_matmul = real
    unchecked = sorted(s for s in seen if (s[0], s[1], s[2], s[3], s[4]) not in checked_qmm)
    if unchecked:
        raise AssertionError(f"phase 7 ran quantized matmul shapes phase 2 did not check: "
                             f"{unchecked}")
    out["qmm_shapes"] = sorted(f"m{m} k{k} n{n} int{b}" for m, k, n, b, _ in seen)
    return out


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on an NVIDIA GPU",
              file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(HERE, "deepspeed_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository (deepspeed_tpu_torch/ "
              "missing)", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import torch.nn.functional as F

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_all = time.perf_counter()

    log("phase 0: card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        raise RuntimeError(f"nvidia-smi gave no card name and power limit (rc "
                           f"{smi.returncode}): {smi.stderr.strip()}")
    card_line = smi.stdout.strip().splitlines()[0]
    print(card_line, flush=True)

    log("phase 1: build kernels")
    from deepspeed_tpu_torch.ops.op_builder import build_all

    t = time.perf_counter()
    builders = build_all()
    build_s = time.perf_counter() - t
    for b in builders:
        regs = [l.strip() for l in b.build_log.splitlines()
                if "registers" in l or "spill" in l or "Performance" in l]
        log(f"  {b.NAME}: nvcc {b.build_seconds:.1f} s; ptxas: {' | '.join(regs)}")
    log(f"  build phase {build_s:.1f} s")

    log("phase 2: kernels against their plain versions")
    main_shapes = main_path_prefill_shapes()
    log(f"  phases 4 and 5's prefill shapes (batch, bucket): {main_shapes}")
    cases = phase_kernels(torch, F, main_shapes)
    paged_cases = phase_paged_kernels(torch, F)
    torch.cuda.empty_cache()
    qmm_ms = qmm_main_ms()
    log(f"  phase 7's quantized matmul token counts m: {qmm_ms}")
    qmm_cases = phase_qmm_kernels(torch, qmm_ms)
    checked_qmm = {(c["m"], c["k"], c["n"], c["bits"], torch.bfloat16)
                   for c in qmm_cases if c["main_path"]}
    paged_int8_cases = phase_paged_int8_kernels(torch, F)
    torch.cuda.empty_cache()
    train_cases = phase_train_kernels(torch, F)
    sparse_cases, sparse_checked = phase_sparse_kernels(torch, F)
    width_cases = phase_width_kernels(torch, F)
    checked = {"flash": {(c["b"], c["s_q"], c["h"], c["kv_heads"], c["d"])
                         for c in train_cases["flash_bwd"] if c["s_q"] == c["s_kv"]},
               "ce": {(c["tokens"], c["d"], c["vocab"]) for c in train_cases["ce"]},
               "block_sparse": sparse_checked}

    log("phase 3: card against the CPU port (Llama-7B width, 2 layers, fp32)")
    parity_err = phase_card_vs_cpu(torch)
    torch.cuda.empty_cache()
    log("phase 3: training on the card against the CPU port (GPT-2-medium width, 2 layers, "
        "fp32)")
    train_parity = phase_train_card_vs_cpu(torch)
    torch.cuda.empty_cache()
    log("phase 3: block-sparse training on the card against the CPU port (GPT-2-medium width, "
        "2 layers, fp32, seq 1024)")
    sparse_parity = phase_train_card_vs_cpu(torch, sparse=True)
    torch.cuda.empty_cache()
    log("phase 3: quantized weights and the int8 pool on the card against the CPU port "
        "(Llama-7B width, 2 layers, fp32)")
    quant_parity = phase_quant_card_vs_cpu(torch)
    torch.cuda.empty_cache()

    log("phase 4: generate path (init_inference + generate, Llama-7B, bf16)")
    eng, launches, requests, peak, profile = phase_main_path(torch, main_shapes)

    log("phase 5: serving path (serve(), 8 slots, paged pool, fused decode, Llama-7B, bf16)")
    serving = phase_serving(torch, eng, main_shapes)
    eng.destroy()
    del eng
    torch.cuda.empty_cache()

    log("phase 6: training path (initialize + train_batch, GPT-2 medium, b12 x s1024, bf16)")
    training = phase_training(torch, checked)
    torch.cuda.empty_cache()

    log("phase 7: quantized serving path (int8 / int4 weights, int8 paged pool, fused decode, "
        "Llama-7B, bf16)")
    quant = phase_quant_path(torch, checked_qmm, serving["pool_bytes"])
    torch.cuda.empty_cache()

    log("phase 8: block-sparse training path (initialize + train_batch, GPT-2 medium, fixed "
        "pattern, block 128, b12 x s1024, bf16)")
    sparse_training = phase_training(torch, checked, sparse=True)
    torch.cuda.empty_cache()

    log(f"phase 9: head dims {sorted({w[0] for w in WIDTHS})} at full width "
        f"({', '.join(' '.join(m) for m in WIDTH_MODELS)}, {WIDTH_LAYERS} layers, fp32) on the "
        f"card against the CPU port")
    from deepspeed_tpu_torch.ops.cuda import LAUNCH_COUNTS, reset_launch_counts

    reset_launch_counts()
    widths = phase_widths(torch)
    widths_launches = dict(LAUNCH_COUNTS)
    by_path = {"generate": launches, "serve": serving["launches"],
               "train": training["launches"],
               "quant_generate_int8": quant["int8"]["launches_generate"],
               "quant_serve_int8": quant["int8"]["serving"]["launches"],
               "quant_generate_int4": quant["int4"]["launches_generate"],
               "train_block_sparse": sparse_training["launches"],
               "widths": widths_launches}
    path_kernels = {"generate": ("flash_attention_fwd",),
                    "serve": ("flash_attention_fwd", "paged_flash_decode"),
                    "train": ("flash_attention_fwd", "flash_attention_bwd", "fused_ce_forward"),
                    "quant_generate_int8": ("flash_attention_fwd", "quantized_matmul_int8"),
                    "quant_serve_int8": ("flash_attention_fwd", "paged_flash_decode_int8",
                                         "quantized_matmul_int8"),
                    "quant_generate_int4": ("flash_attention_fwd", "quantized_matmul_int4"),
                    "train_block_sparse": ("block_sparse_attention_fwd",
                                           "block_sparse_attention_bwd", "fused_ce_forward"),
                    "widths": ("flash_attention_fwd", "flash_attention_bwd",
                               "block_sparse_attention_fwd", "block_sparse_attention_bwd")}
    for path, names in path_kernels.items():
        for name in names:
            if by_path[path][name] == 0:
                raise AssertionError(f"kernel {name} was never launched on the {path} path")
    # phases 4-7 run 16-bit attention at head_dim 128 and 64: every flash
    # launch there takes the TMA + wgmma route
    for path in ("generate", "serve", "train", "quant_generate_int8", "quant_serve_int8",
                 "quant_generate_int4"):
        for name in ("flash_attention_fwd", "flash_attention_bwd"):
            if by_path[path][f"{name}_wgmma"] != by_path[path][name]:
                raise AssertionError(f"{path}: {by_path[path][f'{name}_wgmma']} of "
                                     f"{by_path[path][name]} {name} launches on the wgmma route")
    # phases 6 and 8: every CE launch, and every block-sparse backward launch,
    # on the TMA + wgmma route
    for path, name in (("train", "fused_ce_forward"), ("train_block_sparse", "fused_ce_forward"),
                       ("train_block_sparse", "block_sparse_attention_bwd")):
        if by_path[path][f"{name}_wgmma"] != by_path[path][name]:
            raise AssertionError(f"{path}: {by_path[path][f'{name}_wgmma']} of "
                                 f"{by_path[path][name]} {name} launches on the wgmma route")

    # the headline is the longest prefill of phases 4 and 5; "cases" holds every shape
    b_main, s_main = max(main_shapes, key=lambda bs: bs[1])
    main_case = next(c for c in cases
                     if c["case"] == f"main-b{b_main}-s{s_main}" and c["dtype"] == "bfloat16")
    paged_main = next(c for c in paged_cases if c["main_path"] and c["dtype"] == "bfloat16")
    bwd_main = next(c for c in train_cases["flash_bwd"]
                    if c["case"] == "train" and c["dtype"] == "bfloat16")
    fwd_train = next(c for c in train_cases["flash_fwd_lse"] if c["dtype"] == "bfloat16")

    def by_route(name):
        wgmma = sum(c[f"{name}_wgmma"] for c in by_path.values())
        return {"wgmma": wgmma, "wmma": sum(c[name] for c in by_path.values()) - wgmma}

    ce_main = next(c for c in train_cases["ce"] if c["case"] == "train")
    # the quantized matmul's headline: the serving decode's widest linear
    # (m 8 slots, k 4096, n 11008, bf16); "cases" holds every shape
    qmm_main = {bits: next(c for c in qmm_cases if c["bits"] == bits and c["main_path"]
                           and (c["m"], c["k"], c["n"]) == (8, 4096, 11008))
                for bits in (8, 4)}
    qmm_prefill = {bits: next(c for c in qmm_cases if c["bits"] == bits and c["main_path"]
                              and (c["m"], c["k"], c["n"]) == (2048, 4096, 11008))
                   for bits in (8, 4)}
    paged_int8_main = next(c for c in paged_int8_cases
                           if c["main_path"] and c["dtype"] == "bfloat16")
    sparse_main = {part: next(c for c in sparse_cases[part] if c["main_path"])
                   for part in ("fwd", "bwd")}
    long_bwd = next(c for c in sparse_cases["bwd"]
                    if c["case"] == "long-s4096" and c["dtype"] == "bfloat16")
    kernels = [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "deepspeed_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "deepspeed_tpu/ops/pallas/flash_attention.py:173",
        "also_replaces": "deepspeed_tpu/ops/pallas/flash_attention.py:255",
        "launches": sum(c["flash_attention_fwd"] for c in by_path.values()),
        "launches_by_path": {p: c["flash_attention_fwd"] for p, c in by_path.items()},
        "launches_by_route": by_route("flash_attention_fwd"),
        "max_abs_err": main_case["max_abs_err"],
        "ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
        "shape": f"b={b_main} s={s_main} h=32 d=128 causal bf16 (the longest prefill of "
                 f"the main paths)",
        "kernel_route": main_case["kernel_route"],
        "old_route_ms": main_case["old_route_ms"],
        "routes": "wgmma: TMA + wgmma, bf16/fp16 at head_dim 64 and 128; wmma: the rest "
                  "(fp32, head_dim 32/80/96/256); old_route_ms: the wmma kernel forced at the "
                  "same shape, in turns",
        "training_shape": f"b={TRAIN_BATCH} s={TRAIN_SEQ} h=16 d=64 causal bf16 with lse",
        "training_ms": fwd_train["ms"],
        "training_old_route_ms": fwd_train["old_route_ms"],
        "training_library_ms": fwd_train["library_ms"],
        "training_bound_ms": fwd_train["bound_ms"],
        "cases": cases,
        "width_cases": width_cases["flash_fwd"],
    }, {
        "name": "paged_flash_decode",
        "route": "cuda",
        "source": "deepspeed_tpu_torch/csrc/paged_flash_decode.cu",
        "replaces": "deepspeed_tpu/ops/pallas/paged_attention.py:289",
        "launches": serving["launches"]["paged_flash_decode"],
        "launches_by_path": {p: c["paged_flash_decode"] for p, c in by_path.items()},
        "max_abs_err": paged_main["max_abs_err"],
        "ms": paged_main["ms"],
        "plain_ms": paged_main["plain_ms"],
        "bound_ms": paged_main["bound_ms"],
        "bound_by": paged_main["bound_by"],
        "library_ms": paged_main["library_ms"],
        "shape": f"{paged_main['slots']} slots, 32 heads, head_dim 128, blocks of "
                 f"{paged_main['block_size']}, {paged_main['window']}-token windows, cursors "
                 f"{paged_main['cursors']}, {paged_main['splits']} splits, bf16 (phase 5's "
                 f"decode)",
        "cases": paged_cases,
    }, {
        "name": "flash_attention_bwd",
        "route": "cuda",
        "source": "deepspeed_tpu_torch/csrc/flash_attention_bwd.cu",
        "replaces": "deepspeed_tpu/ops/pallas/flash_attention.py:517",
        "also_replaces": ["deepspeed_tpu/ops/pallas/flash_attention.py:538",
                          "deepspeed_tpu/ops/pallas/flash_attention.py:565",
                          "deepspeed_tpu/ops/pallas/flash_attention.py:591"],
        "launches": training["launches"]["flash_attention_bwd"],
        "launches_by_path": {p: c["flash_attention_bwd"] for p, c in by_path.items()},
        "launches_by_route": by_route("flash_attention_bwd"),
        "kernel_route": bwd_main["kernel_route"],
        "old_route_ms": bwd_main["old_route_ms"],
        "max_abs_err": bwd_main["max_abs_err"],
        "ms": bwd_main["ms"],
        "plain_ms": bwd_main["plain_ms"],
        "bound_ms": bwd_main["bound_ms"],
        "bound_by": bwd_main["bound_by"],
        "library_ms": bwd_main["library_ms"],
        "shape": f"b={TRAIN_BATCH} s={TRAIN_SEQ} h=16 d=64 causal bf16 (phase 6's layers)",
        "cases": train_cases["flash_bwd"],
        "forward_lse_cases": train_cases["flash_fwd_lse"],
        "width_cases": width_cases["flash_bwd"],
    }, {
        "name": "fused_ce_forward",
        "route": "cuda",
        "source": "deepspeed_tpu_torch/csrc/fused_ce_fwd.cu",
        "replaces": "deepspeed_tpu/ops/pallas/cross_entropy.py:108",
        "launches": sum(c["fused_ce_forward"] for c in by_path.values()),
        "launches_by_path": {p: c["fused_ce_forward"] for p, c in by_path.items()},
        "launches_by_route": by_route("fused_ce_forward"),
        "kernel_route": ce_main["kernel_route"],
        "old_route_ms": ce_main["old_route_ms"],
        "routes": "wgmma: TMA + wgmma, bf16/fp16 with d a multiple of 64; wmma: the rest "
                  "(fp32); old_route_ms: the wmma kernel forced at the same shape, in turns",
        "max_abs_err": ce_main["max_abs_err"],
        "ms": ce_main["ms"],
        "plain_ms": ce_main["plain_ms"],
        "bound_ms": ce_main["bound_ms"],
        "bound_by": ce_main["bound_by"],
        "library_ms": ce_main["library_ms"],
        "shape": f"T={TRAIN_BATCH * TRAIN_SEQ} d=1024 V={TRAIN_VOCAB} bf16 (phase 6's head)",
        "cases": train_cases["ce"],
    }] + [{
        "name": f"quantized_matmul_int{bits}",
        "route": "cuda",
        "source": "deepspeed_tpu_torch/csrc/quantized_matmul.cu",
        "replaces": "deepspeed_tpu/ops/pallas/quantized_matmul.py:"
                    + ("161" if bits == 8 else "176"),
        "launches": sum(c[f"quantized_matmul_int{bits}"] for c in by_path.values()),
        "launches_by_path": {p: c[f"quantized_matmul_int{bits}"] for p, c in by_path.items()},
        "launches_by_route": {
            "wgmma": sum(c[f"quantized_matmul_int{bits}_wgmma"] for c in by_path.values()),
            "gemv_and_wmma": sum(c[f"quantized_matmul_int{bits}"]
                                 - c[f"quantized_matmul_int{bits}_wgmma"]
                                 for c in by_path.values())},
        "max_abs_err": qmm_main[bits]["max_abs_err"],
        "ms": qmm_main[bits]["ms"],
        "plain_ms": qmm_main[bits]["plain_ms"],
        "bound_ms": qmm_main[bits]["bound_ms"],
        "bound_by": qmm_main[bits]["bound_by"],
        "library_ms": qmm_main[bits]["library_ms"],
        "shape": "m=8 k=4096 n=11008 group 64 bf16 (the serving decode's gate/up "
                 "projection); library: torch.matmul on the weight dequantized to bf16",
        "prefill_shape": "m=2048 k=4096 n=11008 group 64 bf16 (the 2048-token prefill's "
                         "gate/up projection), TMA + wgmma route; old route: the wmma kernel",
        "prefill_ms": qmm_prefill[bits]["ms"],
        "prefill_library_ms": qmm_prefill[bits]["library_ms"],
        "prefill_bound_ms": qmm_prefill[bits]["bound_ms"],
        "prefill_old_route_ms": qmm_prefill[bits]["old_route_ms"],
        "prefill_max_abs_err": qmm_prefill[bits]["max_abs_err"],
        "cases": [c for c in qmm_cases if c["bits"] == bits],
    } for bits in (8, 4)] + [{
        "name": "paged_flash_decode_int8",
        "route": "cuda",
        "source": "deepspeed_tpu_torch/csrc/paged_flash_decode.cu",
        "replaces": "deepspeed_tpu/ops/pallas/paged_attention.py:289 (its int8 branch, "
                    ":165-170)",
        "launches": sum(c["paged_flash_decode_int8"] for c in by_path.values()),
        "launches_by_path": {p: c["paged_flash_decode_int8"] for p, c in by_path.items()},
        "max_abs_err": paged_int8_main["max_abs_err"],
        "ms": paged_int8_main["ms"],
        "plain_ms": paged_int8_main["plain_ms"],
        "bound_ms": paged_int8_main["bound_ms"],
        "bound_by": paged_int8_main["bound_by"],
        "library_ms": paged_int8_main["library_ms"],
        "shape": f"{paged_int8_main['slots']} slots, 32 heads, head_dim 128, blocks of "
                 f"{paged_int8_main['block_size']}, cursors {paged_int8_main['cursors']}, "
                 f"{paged_int8_main['splits']} splits, int8 pool, bf16 (phase 7's decode); "
                 f"library: gather + masked SDPA on the pool dequantized beforehand",
        "cases": paged_int8_cases,
    }] + [{
        "name": f"block_sparse_attention_{part}",
        "route": "cuda",
        "source": "deepspeed_tpu_torch/csrc/block_sparse_attention.cu",
        "replaces": "deepspeed_tpu/ops/pallas/block_sparse_attention.py:"
                    + ("335" if part == "fwd" else "363"),
        **({} if part == "fwd" else
           {"also_replaces": "deepspeed_tpu/ops/pallas/block_sparse_attention.py:403",
            "launches_by_route": by_route("block_sparse_attention_bwd"),
            "kernel_route": head["kernel_route"], "old_route_ms": head["old_route_ms"],
            "routes": "wgmma: the flash backward's TMA + wgmma kernels over the layout's "
                      "lists, bf16/fp16 at head_dim 64 and 128 with blocks a multiple of 128; "
                      "wmma: the rest; old_route_ms: the wmma kernels forced at the same shape, "
                      "in turns",
            "long_s4096": {k: long_bwd[k] for k in ("ms", "old_route_ms", "library_ms",
                                                    "flash_ms", "bound_ms", "max_abs_err")}}),
        "launches": sum(c[f"block_sparse_attention_{part}"] for c in by_path.values()),
        "launches_by_path": {p: c[f"block_sparse_attention_{part}"] for p, c in by_path.items()},
        "max_abs_err": head["max_abs_err"],
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "shape": f"b={TRAIN_BATCH} s={TRAIN_SEQ} h=16 d=64 causal bf16, fixed pattern of "
                 f"128-token blocks (4 local, 1 global: {head['kept_blocks']} of 36 causal "
                 f"blocks) (phase 8's layers); library: SDPA with the layout's token mask",
        "cases": sparse_cases[part],
        "width_cases": width_cases[f"block_sparse_{part}"],
    } for part, head in sparse_main.items()]
    log(f"summary: card {card_line}; build {build_s:.1f} s; card-vs-CPU logits err "
        f"{parity_err:.3e}; peak {peak:.2f} GiB (generate), {serving['peak_gib']:.2f} GiB "
        f"(serve), {training['peak_gib']:.2f} GiB (train), {sparse_training['peak_gib']:.2f} "
        f"GiB (block-sparse train); train step {training['step_ms_median']:.1f} ms, "
        f"block-sparse {sparse_training['step_ms_median']:.1f} ms; phase 9 "
        f"{sum(r['seconds'] for r in widths.values()):.1f} s; total "
        f"{time.perf_counter() - t_all:.1f} s")
    log(json.dumps({"requests": requests}))
    log(json.dumps({"profile": profile}))
    log(json.dumps({"serving": serving}))
    log(json.dumps({"training": training, "train_card_vs_cpu": train_parity}))
    log(json.dumps({"quantized": quant, "quant_card_vs_cpu": quant_parity}))
    log(json.dumps({"training_block_sparse": sparse_training,
                    "train_block_sparse_card_vs_cpu": sparse_parity}))
    log(json.dumps({"widths": widths, "widths_launches": widths_launches}))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
