"""Build the port's CUDA kernels at first use (port of ``deepspeed_tpu/ops/op_builder/builder.py``).

Each kernel library is one or more ``csrc/*.cu`` sources with a plain C
interface. ``nvcc`` compiles them straight into a shared library for Hopper
(``sm_90a``), keyed by a hash of the sources, the ``csrc`` headers they
include (``#include "x.cuh"``, followed through headers too) and the flags, under
``build/torch_kernels/`` of the checkout; ``ctypes`` loads it. No PyTorch
headers are compiled, which keeps a cold build to seconds. A failed build
raises with nvcc's stderr.
"""

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time

from ...utils.logging import logger

_PKG_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
_DEFAULT_BUILD_DIR = os.environ.get(
    "DS_TORCH_BUILD_DIR",
    os.path.join(os.path.dirname(_PKG_ROOT), "build", "torch_kernels"))

_INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def find_nvcc():
    """nvcc on PATH, else under ``$CUDA_HOME`` (default ``/usr/local/cuda``)."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found (put it on PATH or set CUDA_HOME); "
                       "the port's CUDA kernels are built from source at first use")


class CUDAOpBuilder:
    """Compile-and-load for one kernel library."""

    NAME = None
    SOURCES = ()          # paths relative to the package's csrc/

    def __init__(self):
        self.build_dir = _DEFAULT_BUILD_DIR
        self.csrc_dir = os.path.join(_PKG_ROOT, "csrc")
        self.build_log = ""  # nvcc's stderr of the last build (ptxas register/spill report)
        self.build_seconds = 0.0

    def sources(self):
        return [os.path.join(self.csrc_dir, s) for s in self.SOURCES]

    def headers(self):
        """The local headers the sources include, directly or through other
        headers, in the order first met (a quoted include that names no file
        beside its includer is a system header and is skipped)."""
        found, todo = [], list(self.sources())
        while todo:
            with open(todo.pop(0), encoding="utf-8") as f:
                text = f.read()
            for name in _INCLUDE.findall(text):
                path = os.path.join(self.csrc_dir, name)
                if path not in found and os.path.isfile(path):
                    found.append(path)
                    todo.append(path)
        return found

    def _signature(self):
        h = hashlib.sha256()
        for path in self.sources() + self.headers():
            h.update(os.path.basename(path).encode())
            with open(path, "rb") as f:
                h.update(f.read())
        h.update(" ".join(NVCC_FLAGS).encode())
        return h.hexdigest()[:16]

    def lib_path(self):
        return os.path.join(self.build_dir, f"{self.NAME}_{self._signature()}.so")

    def start(self):
        """Start nvcc in the background; None when the library is built already."""
        path = self.lib_path()
        if os.path.exists(path):
            return None
        os.makedirs(self.build_dir, exist_ok=True)
        # per-process temp name so concurrent builders never interleave
        # writes; os.replace publishes atomically
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [find_nvcc(), *NVCC_FLAGS, *self.sources(), "-o", tmp]
        logger.info(f"Building CUDA op {self.NAME}: {' '.join(cmd)}")
        self._t0 = time.perf_counter()
        return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                text=True), tmp

    def finish(self, started):
        """Wait for a build from ``start`` and publish the library."""
        path = self.lib_path()
        if started is None:
            return path
        proc, tmp = started
        out, err = proc.communicate()
        self.build_seconds = time.perf_counter() - self._t0
        self.build_log = (out or "") + (err or "")
        try:
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed building {self.NAME} (exit {proc.returncode}):\n{err}")
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        return path

    def build(self):
        return self.finish(self.start())

    def bind(self, lib):
        """Set ``argtypes``/``restype`` of the library's C entry points."""

    def load(self):
        lib = ctypes.CDLL(self.build())
        self.bind(lib)
        return lib


class FlashAttentionBuilder(CUDAOpBuilder):
    """``csrc/flash_attention_fwd.cu``: the flash-attention forward, both
    routes (``ds_flash_attention_fwd``: wmma/FMA; ``..._wgmma``: TMA + wgmma)."""

    NAME = "flash_attention_fwd"
    SOURCES = ("flash_attention_fwd.cu",)

    def bind(self, lib):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        for fn in (lib.ds_flash_attention_fwd, lib.ds_flash_attention_fwd_wgmma):
            fn.argtypes = ([p] * 4 + [i] * 7 + [ll] * 12
                           + [ctypes.c_float, i, p, p])
            fn.restype = ctypes.c_int


class FlashAttentionBwdBuilder(CUDAOpBuilder):
    """``csrc/flash_attention_bwd.cu``: the flash-attention backward (delta,
    dQ and dK/dV kernels, one call), both routes."""

    NAME = "flash_attention_bwd"
    SOURCES = ("flash_attention_bwd.cu",)

    def bind(self, lib):
        p, i = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.ds_flash_attention_bwd, lib.ds_flash_attention_bwd_wgmma):
            fn.argtypes = ([p] * 10 + [i] * 7
                           + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, i, p])
            fn.restype = ctypes.c_int


class FusedCEForwardBuilder(CUDAOpBuilder):
    """``csrc/fused_ce_fwd.cu``: the streaming LM-head cross-entropy forward,
    both routes (``ds_fused_ce_fwd``: wmma/FMA; ``..._wgmma``: TMA + wgmma)."""

    NAME = "fused_ce_forward"
    SOURCES = ("fused_ce_fwd.cu",)

    def bind(self, lib):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn = lib.ds_fused_ce_fwd
        fn.argtypes = [p] * 6 + [i] * 4 + [ll] * 2 + [p]
        fn.restype = ctypes.c_int
        fn = lib.ds_fused_ce_fwd_wgmma
        fn.argtypes = [p] * 7 + [i] * 4 + [ll] * 2 + [i, p]
        fn.restype = ctypes.c_int


class PagedFlashDecodeBuilder(CUDAOpBuilder):
    """``csrc/paged_flash_decode.cu``: split-KV decode attention over the paged pool."""

    NAME = "paged_flash_decode"
    SOURCES = ("paged_flash_decode.cu",)

    def bind(self, lib):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn = lib.ds_paged_flash_decode
        fn.argtypes = [p] * 14 + [i] * 9 + [ll] * 15 + [ctypes.c_float, p]
        fn.restype = ctypes.c_int
        lib.ds_paged_decode_smem_optin.argtypes = [i]
        lib.ds_paged_decode_smem_optin.restype = ctypes.c_int


class QuantizedMatmulBuilder(CUDAOpBuilder):
    """``csrc/quantized_matmul.cu``: the weight-only int8/int4 dequant-matmul."""

    NAME = "quantized_matmul"
    SOURCES = ("quantized_matmul.cu",)

    def bind(self, lib):
        p, i = ctypes.c_void_p, ctypes.c_int
        fn = lib.ds_quantized_matmul
        fn.argtypes = [p] * 5 + [i] * 9 + [p]
        fn.restype = ctypes.c_int


class BlockSparseAttentionBuilder(CUDAOpBuilder):
    """``csrc/block_sparse_attention.cu``: the block-sparse forward, and the
    backward (dQ and dK/dV kernels, one call), both routes
    (``ds_block_sparse_attention_bwd``: wmma/FMA; ``..._wgmma``: TMA + wgmma)."""

    NAME = "block_sparse_attention"
    SOURCES = ("block_sparse_attention.cu",)

    def bind(self, lib):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        strides = ctypes.POINTER(ctypes.c_longlong)
        fwd = lib.ds_block_sparse_attention_fwd
        fwd.argtypes = [p] * 7 + [i] * 8 + [strides, f, i, p]
        fwd.restype = ctypes.c_int
        bwd = lib.ds_block_sparse_attention_bwd
        bwd.argtypes = [p] * 14 + [i] * 9 + [strides, f, i, p]
        bwd.restype = ctypes.c_int
        bwd = lib.ds_block_sparse_attention_bwd_wgmma
        bwd.argtypes = [p] * 16 + [i] * 9 + [strides, f, i, p]
        bwd.restype = ctypes.c_int
