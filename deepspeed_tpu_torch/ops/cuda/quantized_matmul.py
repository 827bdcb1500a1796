"""Weight-only int8/int4 dequant-matmul: the CUDA kernel's wrapper and its plain version.

``quantized_matmul`` is the port of the Pallas TPU kernels ``_int8_kernel``
and ``_int4_kernel`` of ``deepspeed_tpu/ops/pallas/quantized_matmul.py`` as
the hand-written CUDA kernel ``deepspeed_tpu_torch/csrc/quantized_matmul.cu``:
``x [m, k] @ dequant(q, scale) [k, n]`` with the weight read at 8 or 4 bits
and dequantized inside the kernel.

The source has four routes, and ``kernel_route`` picks one as a pure
function of the shape. For bf16 x with k a multiple of 64, n of 16 and a
group that 64 divides or that divides 64 and is a multiple of 8 (every
Llama-7B linear): the mma decode kernel for m <= 16 (weights streamed 16
bytes a thread, dequantized in registers, the products on ``mma.sync``) and
the TMA + wgmma kernel for m > 16. Every other shape: the split-k GEMV for
m <= 16 (fp16/fp32 x, ragged shapes, odd groups) and the wmma / FMA tiled
kernel for m > 16. On a CUDA tensor the
wrapper launches the route's kernel or raises, whatever m and whatever the
shape: the kernels tile m themselves and mask ragged tails, so the TPU
kernel's m <= 2048 and 128-lane tiling gates have no counterpart. On a CPU
tensor it computes ``quantized_matmul_reference``, which the tests hold
against the TPU kernel in interpret mode and ``chip_smoke.py`` holds the
CUDA kernel against on the card.
"""

import functools
import math

import torch

from . import LAUNCH_COUNTS
from ..quantizer import unpack_int4

_KERNEL_DTYPES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
_UNIT_ROUNDOFF = {torch.bfloat16: 2.0 ** -8, torch.float16: 2.0 ** -11}


def _check_shapes(x, q, scale, bits):
    if bits not in (8, 4):
        raise ValueError(f"quantized_matmul takes bits 8 or 4, got {bits}")
    if x.dim() != 2 or q.dim() != 2:
        raise ValueError(f"quantized_matmul takes x [m, k] and q [k, n] (int4: [k/2, n]); got "
                         f"{tuple(x.shape)}, {tuple(q.shape)}")
    k, n = x.shape[1], q.shape[1]
    if q.shape[0] * (2 if bits == 4 else 1) != k:
        raise ValueError(f"q {tuple(q.shape)} does not hold {k} input rows at {bits} bits")
    if scale.dim() != 3 or scale.shape[1] != 1 or scale.shape[2] != n or k % scale.shape[0]:
        raise ValueError(f"scale {tuple(scale.shape)} is not [groups, 1, {n}] with groups "
                         f"dividing {k}")
    want = torch.uint8 if bits == 4 else torch.int8
    if q.dtype != want:
        raise TypeError(f"{bits}-bit weights are {want}, got {q.dtype}")


def dequantized_weight(q, scale, bits):
    """The fp32 weight [k, n]: float(q) * float(scale[row // g]), rows
    unpacked from nibbles for bits 4."""
    qk = unpack_int4(q) if bits == 4 else q
    k, n = qk.shape
    groups = scale.shape[0]
    w = qk.float().reshape(groups, k // groups, n) * scale.float().reshape(groups, 1, n)
    return w.reshape(k, n)


def quantized_matmul_reference(x, q, scale, *, bits):
    """Plain version: x [m, k] @ the dequantized weight [k, n], with the
    kernel's arithmetic: the weight rounded to bf16 for bf16 x and kept in
    fp32 for fp16/fp32 x, fp32 products and sums, the result cast to x's
    dtype."""
    _check_shapes(x, q, scale, bits)
    w = dequantized_weight(q, scale, bits)
    if x.dtype == torch.bfloat16:
        w = w.to(torch.bfloat16).float()
    return (x.float() @ w).to(x.dtype)


def rounding_bound(x, q, scale, ref, *, bits):
    """Per-element bound on |kernel - plain| for 16-bit x, or None for fp32:
    the weights are the same values on both sides (the products are exact in
    fp32), so the fp32 sums differ only by their order, at most
    k * 2^-24 * sum|x||w| each, and each side rounds its result once, at
    most one unit roundoff u of |ref| each: 1e-5 + 2u|ref| + 2k 2^-24 |x||w|."""
    u = _UNIT_ROUNDOFF.get(x.dtype)
    if u is None:
        return None
    w = dequantized_weight(q, scale, bits)
    if x.dtype == torch.bfloat16:
        w = w.to(torch.bfloat16).float()
    k = x.shape[1]
    return 1e-5 + 2 * u * ref.float().abs() + 2 * k * 2.0 ** -24 * (x.float().abs() @ w.abs())


_GEMV_MAX_M = 16      # m at or below takes the kernel's split-k GEMV (csrc)
_GEMV_COLS = 128      # columns per GEMV block
_GEMV_ROWS = 128      # rows of a GEMV block's k chunk
_TILES = {torch.bfloat16: 128, torch.float16: 64, torch.float32: 64}  # wmma kernel's m, n tile
_TILE_SPLIT_ROWS = 256  # the least k range a split of a tiled kernel sweeps
_WG_ROWS = (128, 256)  # the wgmma kernel's block rows (n: 128 columns)
_WG_COLS = 128
_WG_BK = 64           # the wgmma kernel's k step
_MMA_COLS = 128       # the mma decode kernel's columns per block
_MMA_SPLIT_ROWS = 64  # its k split: a multiple of this many rows
# the C entry point's route argument
ROUTES = {"gemv": 0, "wmma": 1, "wgmma": 2, "mma": 3}
# a forced route may replace the one kernel_route names by the older kernel
# of the same m: the tiled kernel for wgmma, the split-k GEMV for mma
OLD_ROUTES = {"wgmma": "wmma", "mma": "gemv"}


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def kernel_route(m, n, k, group, dtype, bits):
    """The kernel that computes a product of this shape. For bf16 x with k
    a multiple of 64 (the wgmma kernel's step, the mma kernel's split), n a
    multiple of 16 (the int8 rows stay 16-byte aligned for TMA and 16-byte
    loads) and a group that is a multiple of 64 or one of 8, 16, 32 (the 4
    rows a thread of the mma kernel reads per chunk, and a wgmma step's 8,
    share one scale row): ``"mma"`` (the decode kernel) for m <= 16,
    ``"wgmma"`` (TMA + wgmma, the prefill kernel) above. Every other shape:
    ``"gemv"`` for m <= 16, ``"wmma"`` above. The same for both ``bits``: 64
    even rows pack into whole int4 bytes."""
    del bits
    hopper = (dtype == torch.bfloat16 and k % _WG_BK == 0 and n % 16 == 0 and group % 8 == 0
              and (group % _WG_BK == 0 or _WG_BK % group == 0))
    if m <= _GEMV_MAX_M:
        return "mma" if hopper else "gemv"
    return "wgmma" if hopper else "wmma"


def _device_sms(device):
    device = torch.device(device)
    return _sm_count(torch.cuda.current_device() if device.index is None else device.index)


def wgmma_block_rows(m, n, device):
    """The wgmma kernel's rows of x per block on CUDA ``device``: 256 (each
    warpgroup two 64-row tiles, the dequantized weight tile shared by twice
    the rows) when those blocks fill three quarters of the SMs or more, else
    128 (twice the blocks for a short prefill)."""
    wide = math.ceil(m / _WG_ROWS[1]) * math.ceil(n / _WG_COLS)
    return _WG_ROWS[1] if 4 * wide >= 3 * _device_sms(device) else _WG_ROWS[0]


def mma_splits(n, k, sms):
    """The mma decode kernel's k splits on a card of ``sms`` SMs: as many as
    make two (128-column strip, split) blocks an SM, at least one and at
    most one a 64-row chunk of k. Each split adds a tail to the launch (its
    partial written, the strip's last block adding them), and on an H100
    2 blocks an SM ran as fast as 3 or 4, or faster, at every Llama-7B
    linear and m 1-16 (PERF.md §6)."""
    strips = math.ceil(n / _MMA_COLS)
    return max(1, min(2 * sms // strips, k // _MMA_SPLIT_ROWS))


def kernel_splits(route, m, n, k, dtype, device):
    """The kernel's k splits on CUDA ``device``. The mma decode kernel:
    ``mma_splits``. The GEMV (m <= 16): enough
    (strip, split) blocks for about four per SM (each block's loads in
    flight cover only part of the memory latency), a split at least one
    128-row chunk. The wgmma kernel (one block an SM): 1 when its blocks
    fill half the SMs, else enough splits to fill them all. The wmma kernel
    (128 x 128 tiles for bf16, 64 x 64 else): 1 when its tiles give every
    SM two blocks, else enough splits for that. A split of a tiled kernel is
    at least 256 rows deep."""
    sms = _device_sms(device)
    if route == "mma":
        return mma_splits(n, k, sms)
    if route == "gemv":
        want = math.ceil(4 * sms / math.ceil(n / _GEMV_COLS))
        return max(1, min(want, math.ceil(k / _GEMV_ROWS)))
    if route == "wgmma":
        tiles = math.ceil(m / wgmma_block_rows(m, n, device)) * math.ceil(n / _WG_COLS)
        if 2 * tiles >= sms:
            return 1
        return max(1, min(math.ceil(sms / tiles), k // _TILE_SPLIT_ROWS))
    tiles = math.ceil(n / _TILES[dtype]) * math.ceil(m / _TILES[dtype])
    if tiles >= 2 * sms:
        return 1
    return max(1, min(math.ceil(2 * sms / tiles), k // _TILE_SPLIT_ROWS))


def _check_kernel_inputs(x, q, scale):
    for name, t in (("q", q), ("scale", scale)):
        if t.device != x.device:
            raise ValueError(f"quantized_matmul: {name} on {t.device}, x on {x.device}")
    if x.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"quantized_matmul kernel takes fp32/fp16/bf16 x, got {x.dtype}")
    if scale.dtype != x.dtype:
        raise TypeError(f"quantized_matmul kernel takes the scale in x's dtype {x.dtype}, got "
                        f"{scale.dtype}")
    for name, t in (("x", x), ("q", q), ("scale", scale)):
        if not t.is_contiguous():
            raise ValueError(f"quantized_matmul kernel needs a contiguous {name}; strides "
                             f"{t.stride()}")


# the mma kernel's tickets: one int per 128-column strip, zero between
# launches (the last block of a strip resets its own), per device and stream
_TICKETS = {}


def _mma_tickets(device, stream, strips):
    key = (device, stream)
    t = _TICKETS.get(key)
    if t is None or t.numel() < strips:
        t = _TICKETS[key] = torch.zeros(strips, dtype=torch.int32, device=device)
    return t


def quantized_matmul(x, q, scale, *, bits, route=None):
    """``x [m, k] @ dequant(q, scale) [k, n] -> [m, n]`` in x's dtype. For
    m <= 16, and for a few output tiles, the kernel splits k and adds fp32
    partials ([splits, m, n], allocated here): the mma route in the same
    kernel (its last block of each column strip), the others in a second
    kernel of the same launch.

    ``q``: int8 [k, n] for bits 8, or the nibble-packed uint8 [k/2, n] of
    ``ops/quantizer.py pack_int4`` for bits 4; ``scale``: [groups, 1, n], the
    ``quantize_per_channel`` layout, in x's dtype on the card. ``route``:
    None takes ``kernel_route``; a name forces that route (to time one route
    against another: ``"wmma"`` where ``"wgmma"`` is picked, ``"gemv"`` where
    ``"mma"`` is), and one that cannot take the shape raises. CPU tensors
    take the plain version; CUDA tensors launch the kernel on the current
    stream (no synchronisation) or raise on what it does not take."""
    _check_shapes(x, q, scale, bits)
    m, k = x.shape
    n = q.shape[1]
    group = k // scale.shape[0]
    auto = kernel_route(m, n, k, group, x.dtype, bits)
    route = auto if route is None else route
    if route != auto and OLD_ROUTES.get(auto) != route:
        raise ValueError(f"quantized_matmul: route {route!r} does not take m {m}, k {k}, n {n}, "
                         f"group {group}, {x.dtype} (its route is {auto!r})")
    if all(t.device.type == "cpu" for t in (x, q, scale)):
        return quantized_matmul_reference(x, q, scale, bits=bits)
    if x.device.type != "cuda":
        raise ValueError(f"quantized_matmul runs on CUDA or CPU tensors, got {x.device}")
    _check_kernel_inputs(x, q, scale)
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0:
        return y
    if route in ("wgmma", "mma"):
        if q.data_ptr() % 16 or scale.data_ptr() % 16:
            raise ValueError(f"quantized_matmul's {route} route reads q and scale 16 bytes at a "
                             f"time: they must start 16-byte aligned")
        if x.data_ptr() % 16:
            x = x.clone()  # TMA and 16-byte copies read from 16-byte aligned addresses
    splits = kernel_splits(route, m, n, k, x.dtype, x.device)
    rows = wgmma_block_rows(m, n, x.device) if route == "wgmma" else 0
    work = None
    if route == "gemv" or splits > 1:
        work = torch.empty((splits, m, n), dtype=torch.float32, device=x.device)
    from ..op_builder import load_op

    lib = load_op("quantized_matmul")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        tickets = None
        if route == "mma" and splits > 1:
            tickets = _mma_tickets(x.device, stream, math.ceil(n / _MMA_COLS)).data_ptr()
        err = lib.ds_quantized_matmul(x.data_ptr(), q.data_ptr(), scale.data_ptr(), y.data_ptr(),
                                      None if work is None else work.data_ptr(), tickets,
                                      _KERNEL_DTYPES[x.dtype], bits, m, n, k, group, splits,
                                      ROUTES[route], rows, stream)
    if err:
        raise RuntimeError(f"quantized_matmul launch failed ({route} route): cudaError_t {err}")
    LAUNCH_COUNTS[f"quantized_matmul_int{bits}"] += 1
    if route in ("wgmma", "mma"):
        LAUNCH_COUNTS[f"quantized_matmul_int{bits}_{route}"] += 1
    return y
