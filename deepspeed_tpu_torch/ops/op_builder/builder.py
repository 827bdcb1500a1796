"""Build the port's CUDA kernels at first use (port of ``deepspeed_tpu/ops/op_builder/builder.py``).

Each kernel library is one or more ``csrc/*.cu`` sources with a plain C
interface. ``nvcc`` compiles them straight into a shared library for Hopper
(``sm_90a``), keyed by a hash of the sources and the flags, under
``build/torch_kernels/`` of the checkout; ``ctypes`` loads it. No PyTorch
headers are compiled, which keeps a cold build to seconds. A failed build
raises with nvcc's stderr.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

from ...utils.logging import logger

_PKG_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
_DEFAULT_BUILD_DIR = os.environ.get(
    "DS_TORCH_BUILD_DIR",
    os.path.join(os.path.dirname(_PKG_ROOT), "build", "torch_kernels"))

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
        self.build_log = ""  # nvcc's stderr of the last build (ptxas register/spill report)
        self.build_seconds = 0.0

    def sources(self):
        return [os.path.join(_PKG_ROOT, "csrc", s) for s in self.SOURCES]

    def _signature(self):
        h = hashlib.sha256()
        for src in self.sources():
            with open(src, "rb") as f:
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
    """``csrc/flash_attention_fwd.cu``: the flash-attention forward kernel."""

    NAME = "flash_attention_fwd"
    SOURCES = ("flash_attention_fwd.cu",)

    def bind(self, lib):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn = lib.ds_flash_attention_fwd
        fn.argtypes = ([p] * 4 + [i] * 7 + [ll] * 12
                       + [ctypes.c_float, i, p])
        fn.restype = ctypes.c_int
