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


# -- paged flash-decode --------------------------------------------------------

def _paged_inputs(s_dim, n_heads, kvh, dh, bs, nb_cols, dtype, device, seed=0):
    """A paged pool with a poisoned garbage block 0, each slot's blocks
    drawn without replacement, ragged cursors (one at 0) and unbound
    columns on the garbage block."""
    from deepspeed_tpu_torch.serving.kv_pool import GARBAGE_BLOCK

    r = np.random.RandomState(seed)
    n_blocks = s_dim * nb_cols + 1
    t = lambda *shape: torch.tensor(r.randn(*shape), dtype=torch.float32)
    kc, vc = t(n_blocks, bs, kvh, dh), t(n_blocks, bs, kvh, dh)
    kc[GARBAGE_BLOCK] = 1e4
    vc[GARBAGE_BLOCK] = 1e4
    pos = r.randint(1, nb_cols * bs, s_dim)
    pos[0] = 0
    table = np.full((s_dim, nb_cols), GARBAGE_BLOCK, np.int32)
    ids = r.permutation(np.arange(1, n_blocks))
    for s in range(s_dim):
        used = -(-int(pos[s]) // bs)
        table[s, :used] = ids[s * nb_cols:s * nb_cols + used]
    to = lambda x: x.to(device, dtype)
    return (to(t(s_dim, n_heads, dh)), to(t(s_dim, kvh, dh)), to(t(s_dim, kvh, dh)), to(kc),
            to(vc), torch.tensor(table, device=device), torch.tensor(pos, dtype=torch.int32,
                                                                      device=device))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32],
                         ids=["bf16", "fp16", "fp32"])
@pytest.mark.parametrize("shape", [
    (8, 32, 32, 128, 16, 128, False, None),   # Llama-7B decode, the kernel's own splits
    (4, 32, 8, 128, 16, 32, True, 4),         # GQA 32/8, alibi, 4 splits
    (3, 6, 2, 64, 8, 8, True, 1),             # hq 3, one split, small blocks
    (2, 32, 1, 128, 16, 8, False, 2),         # hq 32: over 48 KB of shared memory
], ids=["llama7b", "gqa-alibi", "hq3-one-split", "hq32-opt-in"])
def test_paged_kernel_matches_plain(cuda, dtype, shape):
    from deepspeed_tpu_torch.ops.cuda.paged_attention import (
        paged_flash_decode, paged_flash_decode_reference, rounding_bound)

    s_dim, n_heads, kvh, dh, bs, nb_cols, alibi, splits = shape
    args = _paged_inputs(s_dim, n_heads, kvh, dh, bs, nb_cols, dtype, cuda)
    slopes = (0.5 ** torch.arange(1, n_heads + 1, dtype=torch.float32, device=cuda)
              if alibi else None)
    before = LAUNCH_COUNTS["paged_flash_decode"]
    out = paged_flash_decode(*args, alibi_slopes=slopes, kv_splits=splits)
    torch.cuda.synchronize()
    assert LAUNCH_COUNTS["paged_flash_decode"] == before + 1
    ref = paged_flash_decode_reference(*args, alibi_slopes=slopes, kv_splits=splits or 4)
    assert out.dtype == dtype and out.shape == ref.shape
    diff = (out.float() - ref.float()).abs()
    if dtype == torch.float32:
        limit = 2e-5 + 2e-5 * ref.float().abs()
    else:
        limit = 1e-5 + rounding_bound(*args, ref, alibi_slopes=slopes)
    worst = (diff / limit).max().item()
    assert worst <= 1.0, f"max abs err {diff.max().item()}, {worst:.2f} of the limit"


def test_fused_decode_supported_asks_the_device(cuda):
    """A GQA group whose blocks need more than 48 KB of shared memory is
    admitted up to the device's opt-in limit and refused past it."""
    import types

    from deepspeed_tpu_torch.ops.cuda.paged_attention import fused_decode_supported

    geo = lambda kvh: types.SimpleNamespace(local_attention_window=0, n_heads=256,
                                            kv_heads=kvh, head_dim=128,
                                            compute_dtype=torch.float32)
    assert fused_decode_supported(geo(8), 16, device=cuda)[0]      # hq 32: 70 KB
    ok, reason = fused_decode_supported(geo(1), 16, device=cuda)   # hq 256: 323 KB
    assert not ok and "shared memory" in reason


def test_paged_kernel_refuses_what_it_does_not_take(cuda):
    from deepspeed_tpu_torch.ops.cuda.paged_attention import paged_flash_decode

    args = list(_paged_inputs(2, 4, 4, 32, 8, 4, torch.bfloat16, cuda))
    with pytest.raises(ValueError, match="head_dim"):
        paged_flash_decode(*args)
    args = list(_paged_inputs(2, 4, 4, 64, 8, 4, torch.bfloat16, cuda))
    with pytest.raises(TypeError, match="int32"):
        paged_flash_decode(*args[:5], args[5].long(), args[6])
    with pytest.raises(TypeError):
        paged_flash_decode(args[0].float(), *args[1:])
    with pytest.raises(ValueError, match="aligned"):
        kc = torch.empty(args[3].numel() + 1, dtype=args[3].dtype, device=cuda)[1:]
        paged_flash_decode(*args[:3], kc.view(args[3].shape), *args[4:])
