"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU and nvcc; elsewhere each one skips. On
a machine with a card (which need not have JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.ops.cuda import LAUNCH_COUNTS
from deepspeed_tpu_torch.ops.cuda.flash_attention import (
    flash_attention_fwd, flash_attention_reference, rounding_bound)

pytestmark = pytest.mark.cuda


def _assert_matches_plain(out, q, k, v, causal):
    """bf16/fp16: within 1e-5 + ``rounding_bound`` (the kernel rounds P and
    its output to the input type; the plain version keeps P in fp32 and
    rounds its output). fp32: summation order only, rtol/atol 2e-5."""
    ref = flash_attention_reference(q, k, v, causal=causal)
    assert out.dtype == q.dtype and out.shape == q.shape
    diff = (out.float() - ref.float()).abs()
    if q.dtype == torch.float32:
        limit = 2e-5 + 2e-5 * ref.abs()
    else:
        limit = 1e-5 + rounding_bound(q, k, v, ref, causal=causal)
    worst = (diff / limit).max().item()
    assert worst <= 1.0, f"max abs err {diff.max().item()}, {worst:.2f} of the limit"


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _qkv(b, s_q, s_kv, h, kvh, d, dtype, device, seed=0):
    r = np.random.RandomState(seed)
    mk = lambda s, n: torch.tensor(r.randn(b, s, n, d), dtype=torch.float32).to(device, dtype)
    return mk(s_q, h), mk(s_kv, kvh), mk(s_kv, kvh)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32],
                         ids=["bf16", "fp16", "fp32"])
@pytest.mark.parametrize("shape", [
    (1, 64, 64, 2, 2, 64, True),       # one tile
    (2, 200, 200, 4, 4, 128, True),    # ragged tail, several tiles
    (1, 77, 300, 4, 2, 64, True),      # s_q < s_kv, GQA
    (1, 130, 90, 2, 1, 128, False),    # non-causal, s_q > s_kv, MQA
], ids=["one-tile", "ragged", "sq<skv-gqa", "noncausal-mqa"])
def test_kernel_matches_plain(cuda, dtype, shape):
    b, s_q, s_kv, h, kvh, d, causal = shape
    q, k, v = _qkv(b, s_q, s_kv, h, kvh, d, dtype, cuda)
    before = LAUNCH_COUNTS["flash_attention_fwd"]
    out = flash_attention_fwd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert LAUNCH_COUNTS["flash_attention_fwd"] == before + 1
    _assert_matches_plain(out, q, k, v, causal)


def test_kernel_reads_strided_views(cuda):
    """q/k/v as views of one fused [b, s, 3, h, d] projection: no copies."""
    r = np.random.RandomState(3)
    qkv = torch.tensor(r.randn(2, 96, 3, 4, 128), dtype=torch.float32).to(cuda, torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    out = flash_attention_fwd(q, k, v, causal=True)
    _assert_matches_plain(out, q.contiguous(), k.contiguous(), v.contiguous(), causal=True)


def test_kernel_refuses_what_it_does_not_take(cuda):
    q, k, v = _qkv(1, 64, 64, 2, 2, 32, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention_fwd(q, k, v)
    q, k, v = _qkv(1, 128, 64, 2, 2, 64, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="s_q <= s_kv"):
        flash_attention_fwd(q, k, v, causal=True)
    q, k, v = _qkv(1, 64, 64, 2, 2, 64, torch.float64, cuda)
    with pytest.raises(TypeError):
        flash_attention_fwd(q, k, v)
