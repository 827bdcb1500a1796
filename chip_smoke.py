#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (``deepspeed_tpu_torch``) on one NVIDIA GPU and check it.

    python3 chip_smoke.py        # from the root of a checkout; one CUDA card, nvcc

Phases, in order; any failed check raises and the script exits non-zero:
  0. the card's name and power limit (nvidia-smi);
  1. build every kernel from ``deepspeed_tpu_torch/csrc`` (one nvcc per source,
     all started together);
  2. each kernel against its plain PyTorch version on the card, at the main
     path's shapes and a few more, with its time, the plain version's time,
     the least time the card could take (the bound) and one PyTorch library
     call computing the same function as a yardstick (never used by the port);
  3. the card against the CPU port: Llama-7B width with 2 layers in fp32, the
     same seeded weights on both; prefill logits and 8 greedy tokens;
  4. the main path: ``init_inference`` on full Llama-7B (32 layers, bf16,
     random weights from a seed) answering requests through ``generate()``,
     with every kernel's launch count read around it.
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

# phase 4's requests: (name, (batch, prompt length)), max_new_tokens each
MAIN_CONFIG = {"dtype": "bfloat16", "max_tokens": 2048, "seed": 0}
MAX_NEW = 64
REQUESTS = (("single-57", (1, 57)), ("single-300", (1, 300)), ("single-900", (1, 900)),
            ("single-1700", (1, 1700)), ("batch4x512", (4, 512)))
SAMPLED = ((1, 300), 16)  # a sampled request: (batch, prompt length), new tokens


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
    """The (batch, prompt bucket) of every prefill phase 4 runs, by the
    engine's own bucket rule on its own config."""
    from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig
    from deepspeed_tpu_torch.inference.engine import bucket_prompt_len

    cfg = DeepSpeedInferenceConfig.from_dict(MAIN_CONFIG)
    reqs = [(shape, MAX_NEW) for _, shape in REQUESTS] + [SAMPLED]
    return sorted({(b, bucket_prompt_len(cfg, n, cfg.max_tokens - new))
                   for (b, n), new in reqs})


def phase_kernels(torch, F, main_shapes):
    from deepspeed_tpu_torch.ops.cuda.flash_attention import (flash_attention_fwd,
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
        kernel_ms = time_ms(lambda: flash_attention_fwd(q, k, v, causal=causal, scale=scale), 20)
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
                 ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                 bound_by="operations" if t_ops >= t_bytes else "bytes", flops=flops,
                 bytes=n_bytes, tflops=flops / kernel_ms / 1e9)
        log(f"  flash {name:14s} {r['dtype']:8s} err {err:.2e} ({limit_use:.2f} of the limit; "
            f"rows>=64 err {late_err:.2e} at mean |plain| "
            f"{late_mean_abs:.3f})  kernel "
            f"{kernel_ms:.4f} ms  plain {plain_ms:.4f} ms  sdpa {library_ms:.4f} ms  bound "
            f"{bound_ms:.4f} ms ({r['bound_by']})  {r['tflops']:.1f} TFLOP/s")
        results.append(r)
        del q, k, v, out, ref, diff, limit
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
    for name, count in launches.items():
        if count == 0:
            raise AssertionError(f"kernel {name} was never launched on the main path")
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"  launches on the main path: {launches} over {n_calls} generate calls; "
        f"peak device memory {peak:.2f} GiB")
    eng.destroy()
    return launches, requests, peak, profile


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
                if "registers" in l or "spill" in l]
        log(f"  {b.NAME}: nvcc {b.build_seconds:.1f} s; ptxas: {' | '.join(regs)}")
    log(f"  build phase {build_s:.1f} s")

    log("phase 2: kernels against their plain versions")
    main_shapes = main_path_prefill_shapes()
    log(f"  phase 4's prefill shapes (batch, bucket): {main_shapes}")
    cases = phase_kernels(torch, F, main_shapes)

    log("phase 3: card against the CPU port (Llama-7B width, 2 layers, fp32)")
    parity_err = phase_card_vs_cpu(torch)
    torch.cuda.empty_cache()

    log("phase 4: main path (init_inference + generate, Llama-7B, bf16)")
    launches, requests, peak, profile = phase_main_path(torch, main_shapes)

    # the headline is the longest prefill of phase 4; "cases" holds every shape
    b_main, s_main = max(main_shapes, key=lambda bs: bs[1])
    main_case = next(c for c in cases
                     if c["case"] == f"main-b{b_main}-s{s_main}" and c["dtype"] == "bfloat16")
    kernels = [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "deepspeed_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "deepspeed_tpu/ops/pallas/flash_attention.py:173",
        "also_replaces": "deepspeed_tpu/ops/pallas/flash_attention.py:255",
        "launches": launches["flash_attention_fwd"],
        "max_abs_err": main_case["max_abs_err"],
        "ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
        "shape": f"b={b_main} s={s_main} h=32 d=128 causal bf16 (the longest prefill of "
                 f"the main path)",
        "cases": cases,
    }]
    log(f"summary: card {card_line}; build {build_s:.1f} s; card-vs-CPU logits err "
        f"{parity_err:.3e}; peak {peak:.2f} GiB; total {time.perf_counter() - t_all:.1f} s")
    log(json.dumps({"requests": requests}))
    log(json.dumps({"profile": profile}))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
