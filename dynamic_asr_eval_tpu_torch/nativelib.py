"""Build and bind the repository's native (C++) host libraries.

Counterpart of the JAX package's ``nativelib.py``: each source under
``native/`` (read as it is) is compiled at first use with ``g++ -O3
-std=c++17 -fPIC -shared`` into ``build/native/`` (named by the source's
hash, so an edited source rebuilds; written to a temp name and renamed, so a
concurrent process never loads a half-written file) and bound with
``ctypes``.  Unlike the JAX package's loader, a failed build raises with the
compiler's error instead of returning ``None``: no caller falls back
silently.  Nothing is built on import.
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
from typing import Callable, Optional, Sequence

REPO_ROOT = Path(__file__).resolve().parents[1]
NATIVE_DIR = REPO_ROOT / "native"
BUILD_DIR = REPO_ROOT / "build" / "native"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")


def compiler() -> Optional[str]:
    """The C++ compiler's path, or ``None`` when ``g++`` is not installed."""
    return shutil.which("g++")


class NativeLibrary:
    """One C++ source bound with ``ctypes``.  ``bind(lib)`` declares the
    ``argtypes`` and ``restype`` of its entry points.  ``build_seconds`` is
    this process's compile time (``None`` when the library was built
    already)."""

    def __init__(self, source: Path, bind: Callable[[ctypes.CDLL], None],
                 libs: Sequence[str] = (), build_dir: Path = BUILD_DIR):
        self.source = Path(source)
        self.libs = tuple(libs)
        self.build_dir = Path(build_dir)
        self._bind = bind
        self._lib = None
        self._lock = threading.Lock()
        self.build_seconds = None

    def build(self) -> Path:
        """Compile the source unless its hash is built already.  Raises
        ``RuntimeError`` with the compiler's output on failure."""
        digest = hashlib.sha256(self.source.read_bytes()).hexdigest()[:12]
        out = self.build_dir / f"lib{self.source.stem}_{digest}.so"
        if out.exists():
            return out
        cxx = compiler()
        if cxx is None:
            raise RuntimeError(f"g++ not found: {self.source.name} cannot be built")
        self.build_dir.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(self.source)] + [f"-l{l}" for l in self.libs]
        t0 = time.time()
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed on {self.source.name} ({proc.returncode}):\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, out)
        finally:
            if tmp.exists():
                tmp.unlink()
        self.build_seconds = time.time() - t0
        return out

    def load(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self.build()))
                self._bind(lib)
                self._lib = lib
            return self._lib
