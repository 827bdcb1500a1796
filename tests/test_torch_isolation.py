"""``deepspeed_tpu_torch`` stands alone: it imports neither ``jax`` nor
``deepspeed_tpu``, and its entry points never fall back to the CPU."""

import ast
import os
import subprocess
import sys

import pytest
import torch

import deepspeed_tpu_torch

PKG = os.path.dirname(deepspeed_tpu_torch.__file__)
REPO = os.path.dirname(PKG)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def test_cpu_generate_in_a_fresh_process_loads_no_jax():
    """generate() and a paged serve() in a fresh process import no JAX."""
    code = """
import sys
import numpy as np
import torch
import deepspeed_tpu_torch
from deepspeed_tpu_torch.models import get_model

torch.set_num_threads(1)
model = get_model("llama", "tiny", compute_dtype=torch.float32)
eng = deepspeed_tpu_torch.init_inference(model, dtype="float32", max_tokens=64, device="cpu")
out = eng.generate(np.random.RandomState(0).randint(0, 1024, (1, 9)), max_new_tokens=3)
assert out.shape == (1, 12)
from deepspeed_tpu_torch.serving import Request, VirtualClock
srv = deepspeed_tpu_torch.init_inference(
    get_model("llama", "tiny", compute_dtype=torch.float32), dtype="float32", max_tokens=64,
    device="cpu", serving={"n_slots": 2, "virtual_clock": True,
                           "kv_pool": {"enabled": True, "attention_backend": "fused"}})
reqs = [Request(prompt=np.arange(5 + i), max_new_tokens=4) for i in range(3)]
events = list(srv.serve(reqs))
assert all(len(r.tokens) == 4 for r in reqs) and sum(e.done for e in events) == 3
assert srv.serving.metrics.snapshot()["kv_pool"]["attention_backend"] == "fused"
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib", "deepspeed_tpu."))
             or m == "deepspeed_tpu")
assert not bad, bad
print("clean")
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=REPO, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "clean" in res.stdout


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_module_of_the_package_imports_jax_or_the_jax_package():
    files = [os.path.join(d, f) for d, _, fs in os.walk(PKG) for f in fs if f.endswith(".py")]
    files.append(os.path.join(REPO, "chip_smoke.py"))
    assert len(files) > 15
    bad = [(os.path.relpath(f, REPO), m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "deepspeed_tpu", "flax")]
    assert not bad, bad


def test_entry_point_without_device_raises_without_cuda(monkeypatch):
    from deepspeed_tpu_torch.models import get_model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = get_model("gpt2", "tiny", vocab_size=128, compute_dtype=torch.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        deepspeed_tpu_torch.init_inference(model, dtype="float32")
    with pytest.raises(RuntimeError, match="no cuda device"):
        deepspeed_tpu_torch.init_inference(model, dtype="float32", device="cuda")
