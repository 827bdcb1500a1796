#!/usr/bin/env python3
"""Two checkouts of the PyTorch/CUDA port on one GPU, end to end, in turns.

    python3 tools/chip_ab.py BASE CHANGE      # two checkout roots, e.g. git archive copies

Runs the generate path (``chip_smoke.py`` phase 4: full Llama-7B bf16,
``generate()`` over its requests), both training paths (phase 6: full
GPT-2 medium, b12 x s1024 bf16, ``train_batch()`` with flash attention;
phase 8: the same with block-sparse attention, fixed pattern of 128-token
blocks) and phase 7's int8 ``generate()`` (full Llama-7B with int8 weights,
group 64, over phase 7's requests, cold and warm) of each root through that
root's own ``chip_smoke.py`` constants and functions and its own package and
kernels, one process per run, in the order BASE, CHANGE, CHANGE, BASE, so
that drift of the card cancels. Each run builds only the kernels these paths
launch (the flash forward and backward, the CE forward, the block-sparse
kernels and the quantized matmul), from its root's sources. Prints one JSON
line per run, then a summary line: each root's warm prefill ms per request,
median step ms of each training path and warm int8 decode ms per token per
request (each the mean of its two runs) and CHANGE less BASE.

    python3 tools/chip_ab.py --measure ROOT   # one run (what the driver starts)
    python3 tools/chip_ab.py --qmm-sweep      # variants of the mma decode kernel in turns
    python3 tools/chip_ab.py --widths BASE CHANGE

``--widths`` runs the head dims 80 and 256 on their bf16 paths in the same
turns: full GPT-J-6B (28 layers, 16 heads of 256) ``generate()`` over
``chip_smoke.py`` phase 10's requests, cold and warm, full OPT-2.7B (32
heads of 80) ``train_batch()`` at phase 10's batch and sequence, and
GPT-J-6B at full width cut to phase 10's depth ``train_batch()`` with flash
and with block-sparse attention (phase 8's pattern), and full GPT-2 medium
at phase 8's batch and sequence ``train_batch()`` with phase 8's twin of
64-token blocks, each 2 warm-up and 8 timed steps. The shapes and configs
are this checkout's ``chip_smoke.py`` constants (``WIDTH_PATH_*``,
``WIDTH_TRAIN_*``, ``GPTJ_TRAIN_*``, ``SPARSE_ATTENTION``,
``SPARSE_ATTENTION_64``, ``TRAIN_*``), loaded by path; the loops are this
file's own, so a root whose ``chip_smoke.py`` has no phase 10 runs too. Each run builds the
flash, CE and block-sparse kernels of its root. Prints one JSON line per
run, then a summary: each root's warm prefill ms per request, median step
ms of each training step, their launches by route and peaks (means of two
runs) and CHANGE less BASE.

Needs one CUDA card and nvcc; fails without them.
"""

import importlib.util
import json
import math
import os
import shutil
import subprocess
import sys
import time


def int8_generate(torch, cs):
    """Phase 7's int8 ``generate()``: ``init_inference`` on full Llama-7B
    with ``quant`` int8 (group 64) and an int8 pool, then each of
    ``cs.QUANT_REQUESTS`` (the same seeded prompts as phase 7) cold and
    warm, MAX_NEW greedy tokens. Returns the decode ms per token of each
    (``last_timing``, CUDA events) and the launch counts."""
    import numpy as np

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import CausalLM, llama_config
    from deepspeed_tpu_torch.ops.cuda import LAUNCH_COUNTS, reset_launch_counts

    cfg = llama_config("7b")
    config = json.loads(json.dumps(cs.MAIN_CONFIG))
    config["quant"] = {"enabled": True, "bits": 8, "group_size": 64}
    config["serving"]["kv_pool"]["kv_dtype"] = "int8"
    eng = deepspeed_tpu_torch.init_inference(CausalLM(cfg), config)
    rng = np.random.RandomState(0)
    reset_launch_counts()
    out = {}
    for name, shape in cs.REQUESTS:
        ids = rng.randint(0, cfg.vocab_size, shape)
        if name not in cs.QUANT_REQUESTS:
            continue
        for attempt in ("cold", "warm"):
            eng.generate(ids, max_new_tokens=cs.MAX_NEW, greedy=True)
            torch.cuda.synchronize()
            out[f"{name}/{attempt}"] = eng.last_timing.seconds()["decode"] * 1e3 / (cs.MAX_NEW - 1)
    launches = dict(LAUNCH_COUNTS)
    eng.destroy()
    return out, launches


def measure(root):
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_ab: no CUDA device")
    import chip_smoke as cs
    from deepspeed_tpu_torch.ops.op_builder import ALL_OPS

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from deepspeed_tpu_torch.models.transformer import _block_sparse_attn

    builders = [ALL_OPS[n]() for n in ("flash_attention_fwd", "flash_attention_bwd",
                                       "fused_ce_forward", "block_sparse_attention",
                                       "quantized_matmul")]
    for b, started in [(b, b.start()) for b in builders]:
        b.finish(started)

    shapes = cs.main_path_prefill_shapes()
    eng, launches, requests, _, _ = cs.phase_main_path(torch, shapes)
    eng.destroy()
    del eng
    torch.cuda.empty_cache()
    cfg = cs.train_model_config()
    sparse_cfg = cs.train_sparse_model_config()
    layout = _block_sparse_attn(sparse_cfg, cs.TRAIN_SEQ, torch.device("cuda")).layout
    shape = (cs.TRAIN_BATCH, cs.TRAIN_SEQ, cfg.n_heads, cfg.kv_heads, cfg.head_dim)
    checked = {"flash": {shape}, "block_sparse": {shape + (layout.tobytes(),)},
               "ce": {(cs.TRAIN_BATCH * cs.TRAIN_SEQ, cfg.d_model, cfg.vocab_size)}}
    training = cs.phase_training(torch, checked)
    torch.cuda.empty_cache()
    sparse = cs.phase_training(torch, checked, sparse=True)
    torch.cuda.empty_cache()
    quant_decode, quant_launches = int8_generate(torch, cs)
    return {"root": root, "card": torch.cuda.get_device_name(0),
            "int8_decode_ms_per_token": quant_decode, "int8_generate_launches": quant_launches,
            "prefill_ms": {r["request"]: r["prefill_ms"] for r in requests},
            "generate_launches": launches, "step_ms": training["step_ms"],
            "step_ms_median": training["step_ms_median"],
            "train_launches": training["launches"],
            "sparse_step_ms": sparse["step_ms"],
            "sparse_step_ms_median": sparse["step_ms_median"],
            "sparse_train_launches": sparse["launches"]}


ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def own_chip_smoke():
    """This checkout's ``chip_smoke.py`` (the root above tools/), loaded by
    path under its own name, so its constants drive either root's package."""
    spec = importlib.util.spec_from_file_location("chip_smoke_of_chip_ab",
                                                  os.path.join(ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


ATTENTION_LAUNCHES = ("flash_attention_fwd", "flash_attention_fwd_wgmma", "flash_attention_bwd",
                      "flash_attention_bwd_wgmma", "block_sparse_attention_fwd",
                      "block_sparse_attention_fwd_wgmma", "block_sparse_attention_bwd",
                      "block_sparse_attention_bwd_wgmma")


def train_steps(torch, cs, cfg, n_batch, seq, config):
    """``train_batch()`` of a fresh engine on ``cfg``: TRAIN_WARMUP + TRAIN_STEPS
    steps on one batch from seed 0; the step ms (host clock, ended by the
    loss's host read), their median over the timed steps, the attention
    kernels' launches by route and the peak GiB."""
    import numpy as np

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import CausalLM
    from deepspeed_tpu_torch.ops.cuda import LAUNCH_COUNTS, reset_launch_counts

    engine, _, _, _ = deepspeed_tpu_torch.initialize(model=CausalLM(cfg), config=dict(config))
    batch = {"input_ids": np.random.RandomState(0).randint(0, cfg.vocab_size, (n_batch, seq))}
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    step_ms = []
    for _ in range(cs.TRAIN_WARMUP + cs.TRAIN_STEPS):
        t = time.perf_counter()
        float(engine.train_batch(batch=batch))
        step_ms.append((time.perf_counter() - t) * 1e3)
    launches = {k: LAUNCH_COUNTS[k] for k in ATTENTION_LAUNCHES}
    timed = sorted(step_ms[cs.TRAIN_WARMUP:])
    median = (timed[(len(timed) - 1) // 2] + timed[len(timed) // 2]) / 2
    peak = torch.cuda.max_memory_allocated() / 2**30
    engine.destroy()
    del engine
    torch.cuda.empty_cache()
    return {"step_ms": step_ms, "step_ms_median": median, "launches": launches,
            "peak_gib": peak}


def widths_measure(root):
    """One ``--widths`` run in ``root``: GPT-J-6B bf16 ``generate()`` (warm
    prefill ms per request from ``last_timing``), OPT-2.7B bf16
    ``train_batch()``, GPT-J-6B's two training steps and GPT-2 medium's step
    at 64-token blocks (``train_steps``), with the attention launches by
    route."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_ab: no CUDA device")
    cs = own_chip_smoke()
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import CausalLM, gpt2_config, gptj_config, opt_config
    from deepspeed_tpu_torch.ops.cuda import LAUNCH_COUNTS, reset_launch_counts
    from deepspeed_tpu_torch.ops.op_builder import ALL_OPS

    torch.backends.cuda.matmul.allow_tf32 = False
    builders = [ALL_OPS[n]() for n in ("flash_attention_fwd", "flash_attention_bwd",
                                       "fused_ce_forward", "block_sparse_attention")]
    for b, started in [(b, b.start()) for b in builders]:
        b.finish(started)

    cfg = gptj_config("6b")
    eng = deepspeed_tpu_torch.init_inference(CausalLM(cfg), dict(cs.WIDTH_PATH_CONFIG))
    rng = np.random.RandomState(10)
    reset_launch_counts()
    prefill = {}
    for name, shape in cs.WIDTH_PATH_REQUESTS:
        ids = rng.randint(0, cfg.vocab_size, shape)
        for attempt in ("cold", "warm"):
            eng.generate(ids, max_new_tokens=cs.WIDTH_PATH_NEW, greedy=True)
            torch.cuda.synchronize()
            prefill[f"{name}/{attempt}"] = eng.last_timing.seconds()["prefill"] * 1e3
    generate_launches = {k: LAUNCH_COUNTS[k] for k in ATTENTION_LAUNCHES}
    eng.destroy()
    del eng
    torch.cuda.empty_cache()

    tcfg = opt_config("2.7b", attention_impl="flash", remat=False, fused_ce=True,
                      fused_ce_impl="pallas")
    opt = train_steps(torch, cs, tcfg, cs.WIDTH_TRAIN_BATCH, cs.WIDTH_TRAIN_SEQ,
                      cs.WIDTH_TRAIN_CONFIG)
    gptj = {}
    for name, attention in (("flash", {"attention_impl": "flash"}),
                            ("block_sparse", cs.SPARSE_ATTENTION)):
        jcfg = gptj_config("6b", n_layers=cs.GPTJ_TRAIN_LAYERS, remat=False, fused_ce=True,
                           fused_ce_impl="pallas", **attention)
        gptj[name] = train_steps(torch, cs, jcfg, cs.GPTJ_TRAIN_BATCH, cs.GPTJ_TRAIN_SEQ,
                                 cs.GPTJ_TRAIN_CONFIG)
    gcfg = gpt2_config("medium", vocab_size=cs.TRAIN_VOCAB, remat=False, fused_ce=True,
                       fused_ce_impl="pallas", **cs.SPARSE_ATTENTION_64)
    gpt2 = train_steps(torch, cs, gcfg, cs.TRAIN_BATCH, cs.TRAIN_SEQ, cs.TRAIN_CONFIG)
    return {"root": root, "card": torch.cuda.get_device_name(0), "gptj_prefill_ms": prefill,
            "gptj_generate_launches": generate_launches, "opt_step_ms": opt["step_ms"],
            "opt_step_ms_median": opt["step_ms_median"], "opt_train_launches": opt["launches"],
            "opt_peak_gib": opt["peak_gib"], "gptj_train": gptj, "gpt2_sparse64_train": gpt2}


def widths_ab(base, change, smi):
    """``--widths``: widths_measure of each root in turns (base, change,
    change, base), one process per run."""
    runs = []
    for label, root in (("base", base), ("change", change), ("change", change), ("base", base)):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--widths-measure",
                               root], capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            raise SystemExit(f"chip_ab --widths: the {label} run failed (exit {proc.returncode})")
        run = json.loads(proc.stdout.strip().splitlines()[-1])
        run["label"] = label
        print(json.dumps(run), flush=True)
        runs.append(run)

    def mean(label, get):
        vals = [get(r) for r in runs if r["label"] == label]
        return sum(vals) / len(vals)

    summary = {"card": smi, "order": [r["label"] for r in runs]}
    steps = ("flash", "block_sparse")
    for label in ("base", "change"):
        summary[label] = {
            "gptj_train": {step: {
                "step_ms_median": mean(
                    label, lambda r, s=step: r["gptj_train"][s]["step_ms_median"]),
                "step_ms_medians": [r["gptj_train"][step]["step_ms_median"] for r in runs
                                    if r["label"] == label],
                "peak_gib": mean(label, lambda r, s=step: r["gptj_train"][s]["peak_gib"]),
                "launches": next(r["gptj_train"][step]["launches"] for r in runs
                                 if r["label"] == label)} for step in steps},
            "gpt2_sparse64_train": {
                "step_ms_median": mean(
                    label, lambda r: r["gpt2_sparse64_train"]["step_ms_median"]),
                "step_ms_medians": [r["gpt2_sparse64_train"]["step_ms_median"] for r in runs
                                    if r["label"] == label],
                "launches": next(r["gpt2_sparse64_train"]["launches"] for r in runs
                                 if r["label"] == label)},
            "opt_step_ms_median": mean(label, lambda r: r["opt_step_ms_median"]),
            "opt_step_ms_medians": [r["opt_step_ms_median"] for r in runs if r["label"] == label],
            "gptj_prefill_ms": {q: mean(label, lambda r, q=q: r["gptj_prefill_ms"][q])
                                for q in runs[0]["gptj_prefill_ms"] if q.endswith("/warm")},
            "gptj_generate_launches": next(r["gptj_generate_launches"] for r in runs
                                           if r["label"] == label),
            "opt_train_launches": next(r["opt_train_launches"] for r in runs
                                       if r["label"] == label)}
    summary["change_less_base"] = {
        "opt_step_ms_median": (summary["change"]["opt_step_ms_median"]
                               - summary["base"]["opt_step_ms_median"]),
        "gptj_train_step_ms_median": {
            step: (summary["change"]["gptj_train"][step]["step_ms_median"]
                   - summary["base"]["gptj_train"][step]["step_ms_median"]) for step in steps},
        "gpt2_sparse64_train_step_ms_median": (
            summary["change"]["gpt2_sparse64_train"]["step_ms_median"]
            - summary["base"]["gpt2_sparse64_train"]["step_ms_median"]),
        "gptj_prefill_ms": {q: summary["change"]["gptj_prefill_ms"][q]
                            - summary["base"]["gptj_prefill_ms"][q]
                            for q in summary["base"]["gptj_prefill_ms"]}}
    print(json.dumps({"widths_ab_summary": summary}), flush=True)
    return 0
SOURCE = os.path.join("deepspeed_tpu_torch", "csrc", "quantized_matmul.cu")
HINT = "cp.async.cg.shared.global.L2::128B"
SET_SMEM = "cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);\n"


def sweep_variants(text):
    """{name: source text}: the source and one change each."""
    for needle in (HINT, SET_SMEM, "constexpr int MMA_STAGES = 4;", "constexpr int MMA_WARPS = 4;",
                   "MT == 8 ? 4 : 3)"):
        if needle not in text:
            raise SystemExit(f"chip_ab --qmm-sweep: {needle!r} not in {SOURCE}")
    carveout = SET_SMEM + ("  if (err != cudaSuccess) return err;\n  err = cudaFuncSetAttribute("
                           "kernel, cudaFuncAttributePreferredSharedMemoryCarveout, "
                           "cudaSharedmemCarveoutMaxShared);\n")
    return {"as-built": text,
            "no-l2-hint": text.replace(HINT, "cp.async.cg.shared.global"),
            "l2-256B": text.replace(HINT, "cp.async.cg.shared.global.L2::256B"),
            "stages-6": text.replace("constexpr int MMA_STAGES = 4;",
                                     "constexpr int MMA_STAGES = 6;"),
            "warps-8": text.replace("constexpr int MMA_WARPS = 4;", "constexpr int MMA_WARPS = 8;")
                           .replace("MT == 8 ? 4 : 3)", "MT == 8 ? 2 : 1)"),
            "max-carveout": text.replace(SET_SMEM, carveout, 1)}


def operands(torch, bits, k, n, m, gen):
    from deepspeed_tpu_torch.ops.quantizer import pack_int4, quantize_per_channel

    q, scale = quantize_per_channel(torch.randn(k, n, generator=gen, device="cuda") * 0.02,
                                    bits=bits, group_size=64)
    x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
    return x, pack_int4(q) if bits == 4 else q, scale.to(torch.bfloat16)


def sweep_measure(tree, sweep_splits):
    """One process in one tree: {case: ms}."""
    sys.path.insert(0, tree)
    import torch

    import chip_smoke as cs
    import deepspeed_tpu_torch.ops.cuda.quantized_matmul as qmm

    gen = torch.Generator(device="cuda").manual_seed(0)
    own = qmm.mma_splits
    out = {}

    def timed(x, q, s, bits):
        y = qmm.quantized_matmul(x, q, s, bits=bits)
        ref = qmm.quantized_matmul(x, q, s, bits=bits, route="gemv")
        if (y.float() - ref.float()).abs().max().item() > 0.1:
            raise AssertionError("the mma route disagrees with the GEMV")
        return cs.time_ms(lambda: qmm.quantized_matmul(x, q, s, bits=bits), 50)

    for bits in (8, 4):
        for k, n in cs.LLAMA_LINEARS:
            for m in (1, 8):
                x, q, s = operands(torch, bits, k, n, m, gen)
                if not sweep_splits:
                    out[f"int{bits} m{m} k{k} n{n}"] = timed(x, q, s, bits)
                elif m == 8:
                    for r in (1, 2, 3, 4):
                        qmm.mma_splits = lambda n_, k_, sms, r=r: max(
                            1, min(r * sms // math.ceil(n_ / qmm._MMA_COLS), k_ // 64))
                        splits = qmm.mma_splits(n, k, 132)
                        out[f"int{bits} m8 k{k} n{n} {r} blocks/SM ({splits} splits)"] = timed(
                            x, q, s, bits)
                    qmm.mma_splits = own
        if sweep_splits:
            for k, n in ((64, 4096), (128, 4096), (64, 11008), (512, 11008)):
                x, q, s = operands(torch, bits, k, n, 8, gen)
                splits = own(n, k, torch.cuda.get_device_properties(0).multi_processor_count)
                out[f"int{bits} m8 k{k} n{n} ({splits} splits)"] = timed(x, q, s, bits)
    return out


def sweep_run(tree, sweep_splits):
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--qmm-measure", tree,
                           "splits" if sweep_splits else "variant"], capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"chip_ab --qmm-sweep: {tree} failed:\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def qmm_sweep():
    """``--qmm-sweep``: what limits the quantized matmul's mma decode kernel.
    Two sweeps of ``csrc/quantized_matmul.cu``'s ``mma`` route (bf16 x, group
    64) at Llama-7B's linears, int8 and int4: (1) variants of the kernel,
    each a copy of the package under ``build/qmm_sweep/<name>/`` with one
    textual change to the source (no L2 prefetch hint, a 256-byte hint, a
    6-stage ring, 8-warp blocks, the largest shared-memory carveout), built
    together and timed in turns (every variant, then every variant in
    reverse) at m 1 and m 8; (2) the source as it is at the k splits that
    make 1-4 blocks an SM (``mma_splits`` replaced in turn), at m 8, and at
    linears of one or two 64-row chunks of k (the fixed cost of a launch and
    of a split). ``chip_smoke.time_ms`` (CUDA events behind a sleep kernel),
    means of 50 launches, each result first checked against the GEMV."""
    import torch

    if not torch.cuda.is_available():
        print("chip_ab --qmm-sweep: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    with open(os.path.join(ROOT, SOURCE), encoding="utf-8") as f:
        texts = sweep_variants(f.read())
    trees = {}
    for name, text in texts.items():
        tree = os.path.join(ROOT, "build", "qmm_sweep", name)
        shutil.rmtree(tree, ignore_errors=True)
        shutil.copytree(os.path.join(ROOT, "deepspeed_tpu_torch"),
                        os.path.join(tree, "deepspeed_tpu_torch"),
                        ignore=shutil.ignore_patterns("__pycache__"))
        shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tree)
        with open(os.path.join(tree, SOURCE), "w", encoding="utf-8") as f:
            f.write(text)
        trees[name] = tree
    builds = [subprocess.Popen([sys.executable, "-c",
                                "import sys; sys.path.insert(0, sys.argv[1]); "
                                "from deepspeed_tpu_torch.ops.op_builder import ALL_OPS; "
                                "ALL_OPS['quantized_matmul']().build()", tree])
              for tree in trees.values()]
    if any([b.wait() for b in builds]):
        raise SystemExit("chip_ab --qmm-sweep: a variant failed to build")
    by_case = {}
    for name in list(trees) + list(reversed(trees)):
        for case, ms in sweep_run(trees[name], False).items():
            by_case.setdefault(case, {}).setdefault(name, []).append(ms)
    print("variants, ms (mean of two turns):", flush=True)
    for case, by in by_case.items():
        print(f"  {case:22s} " + "  ".join(f"{n} {sum(v) / len(v):.4f}" for n, v in by.items()))
    print("k splits of the source as it is, ms:", flush=True)
    splits = sweep_run(trees["as-built"], True)
    for case, ms in splits.items():
        print(f"  {case:48s} {ms:.4f}")
    print(json.dumps({"card": smi.stdout.strip(), "variants": by_case, "splits": splits}))
    return 0


def main(argv):
    if argv[:1] == ["--qmm-sweep"]:
        return qmm_sweep()
    if len(argv) == 3 and argv[0] == "--qmm-measure":
        print(json.dumps(sweep_measure(argv[1], argv[2] == "splits")), flush=True)
        return 0
    if len(argv) == 2 and argv[0] == "--measure":
        print(json.dumps(measure(argv[1])), flush=True)
        return 0
    if len(argv) == 2 and argv[0] == "--widths-measure":
        print(json.dumps(widths_measure(argv[1])), flush=True)
        return 0
    if len(argv) not in (2, 3) or (len(argv) == 3 and argv[0] != "--widths"):
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    if argv[0] == "--widths":
        return widths_ab(argv[1], argv[2], smi.stdout.strip())
    base, change = argv
    runs = []
    for label, root in (("base", base), ("change", change), ("change", change), ("base", base)):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--measure", root],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            raise SystemExit(f"chip_ab: the {label} run failed (exit {proc.returncode})")
        run = json.loads(proc.stdout.strip().splitlines()[-1])
        run["label"] = label
        print(json.dumps(run), flush=True)
        runs.append(run)

    def mean(label, get):
        vals = [get(r) for r in runs if r["label"] == label]
        return sum(vals) / len(vals)

    summary = {"card": smi.stdout.strip(), "order": [r["label"] for r in runs]}
    steps = ("step_ms_median", "sparse_step_ms_median")
    for label in ("base", "change"):
        summary[label] = {
            **{k: mean(label, lambda r, k=k: r[k]) for k in steps},
            **{k.replace("median", "medians"): [r[k] for r in runs if r["label"] == label]
               for k in steps},
            "prefill_ms": {req: mean(label, lambda r, q=req: r["prefill_ms"][q])
                           for req in runs[0]["prefill_ms"]},
            "int8_decode_ms_per_token": {
                req: mean(label, lambda r, q=req: r["int8_decode_ms_per_token"][q])
                for req in runs[0]["int8_decode_ms_per_token"] if req.endswith("/warm")}}
    summary["change_less_base"] = {
        **{k: summary["change"][k] - summary["base"][k] for k in steps},
        **{part: {q: summary["change"][part][q] - summary["base"][part][q]
                  for q in summary["base"][part]}
           for part in ("prefill_ms", "int8_decode_ms_per_token")}}
    print(json.dumps({"ab_summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
