#!/usr/bin/env python3
"""Two checkouts of the PyTorch/CUDA port on one GPU, end to end, in turns.

    python3 tools/chip_ab.py BASE CHANGE      # two checkout roots, e.g. git archive copies

Runs the generate path (``chip_smoke.py`` phase 4: full Llama-7B bf16,
``generate()`` over its requests) and the training path (phase 6: full GPT-2
medium, b12 x s1024 bf16, ``train_batch()``) of each root through that
root's own ``chip_smoke.py`` functions and kernels, one process per run, in
the order BASE, CHANGE, CHANGE, BASE, so that drift of the card cancels. Each
run builds only the kernels these paths launch (the flash forward and
backward and the CE forward), from its root's sources. Prints one JSON line
per run, then a summary line: each root's warm prefill ms per request and
median step ms (the mean of its two runs) and CHANGE less BASE.

    python3 tools/chip_ab.py --measure ROOT   # one run (what the driver starts)

Needs one CUDA card and nvcc; fails without them.
"""

import json
import os
import subprocess
import sys


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
    builders = [ALL_OPS[n]() for n in ("flash_attention_fwd", "flash_attention_bwd",
                                       "fused_ce_forward")]
    for b, started in [(b, b.start()) for b in builders]:
        b.finish(started)

    shapes = cs.main_path_prefill_shapes()
    eng, launches, requests, _, _ = cs.phase_main_path(torch, shapes)
    eng.destroy()
    del eng
    torch.cuda.empty_cache()
    cfg = cs.train_model_config()
    checked = {"flash": {(cs.TRAIN_BATCH, cs.TRAIN_SEQ, cfg.n_heads, cfg.kv_heads, cfg.head_dim)},
               "ce": {(cs.TRAIN_BATCH * cs.TRAIN_SEQ, cfg.d_model, cfg.vocab_size)},
               "block_sparse": set()}
    training = cs.phase_training(torch, checked)
    return {"root": root, "card": torch.cuda.get_device_name(0),
            "prefill_ms": {r["request"]: r["prefill_ms"] for r in requests},
            "generate_launches": launches, "step_ms": training["step_ms"],
            "step_ms_median": training["step_ms_median"],
            "train_launches": training["launches"]}


def main(argv):
    if len(argv) == 2 and argv[0] == "--measure":
        print(json.dumps(measure(argv[1])), flush=True)
        return 0
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
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
    for label in ("base", "change"):
        summary[label] = {
            "step_ms_median": mean(label, lambda r: r["step_ms_median"]),
            "step_ms_medians": [r["step_ms_median"] for r in runs if r["label"] == label],
            "prefill_ms": {req: mean(label, lambda r, q=req: r["prefill_ms"][q])
                           for req in runs[0]["prefill_ms"]}}
    summary["change_less_base"] = {
        "step_ms_median": summary["change"]["step_ms_median"] - summary["base"]["step_ms_median"],
        "prefill_ms": {q: summary["change"]["prefill_ms"][q] - summary["base"]["prefill_ms"][q]
                       for q in summary["base"]["prefill_ms"]}}
    print(json.dumps({"ab_summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
