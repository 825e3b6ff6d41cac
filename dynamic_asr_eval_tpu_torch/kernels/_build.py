"""Build one CUDA source of the port into a shared library, and bind it.

Every kernel module keeps its source under ``csrc/`` and one
:class:`CudaLibrary` for it.  The library is compiled with ``nvcc`` for
``sm_90a`` at first use (never on import: the CPU tests import every module),
named by the source's hash under ``build/torch_kernels/`` so that an edited
source rebuilds, and loaded with ``ctypes``.  Each C entry point returns a
``cudaError_t`` code, and :meth:`CudaLibrary.check` raises on a non-zero one.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable

BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the port's CUDA kernels cannot be built")
    return path


class CudaLibrary:
    """One ``csrc/*.cu`` file.  ``bind(lib)`` declares the ``argtypes`` and
    ``restype`` of its entry points; every source also exports
    ``dae_cuda_error_string``.  ``build_seconds`` and ``build_log`` (nvcc's
    ``-Xptxas -v`` report: registers, spills) describe this process's build
    and stay ``None`` / empty when the library was already built."""

    def __init__(self, source: Path, bind: Callable[[ctypes.CDLL], None]):
        self.source = Path(source)
        self._bind = bind
        self._lib = None
        self._lock = threading.Lock()
        self.build_seconds = None
        self.build_log = ""

    def build(self) -> Path:
        """Compile the source unless its hash is built already.  Raises on
        failure."""
        digest = hashlib.sha256(self.source.read_bytes()).hexdigest()[:12]
        out = BUILD_DIR / f"libdae_{self.source.stem}_{digest}.so"
        if out.exists():
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        t0 = time.time()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {self.source.name} ({proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)
        self.build_seconds = time.time() - t0
        self.build_log = proc.stderr
        return out

    def load(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self.build()))
                lib.dae_cuda_error_string.restype = ctypes.c_char_p
                lib.dae_cuda_error_string.argtypes = [ctypes.c_int]
                self._bind(lib)
                self._lib = lib
            return self._lib

    def check(self, code: int, what: str) -> None:
        if code != 0:
            msg = self.load().dae_cuda_error_string(code).decode()
            raise RuntimeError(f"{what} kernel failed: {msg} ({code})")
