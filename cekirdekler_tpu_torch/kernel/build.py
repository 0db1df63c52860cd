"""Build CUDA C++ sources into shared libraries and bind them with ctypes.

The idiom of ``cekirdekler_tpu/native/build.py`` (compile with the system
toolchain, load with ``ctypes``), for the port's kernels: ``nvcc`` builds
a ``.cu`` source with a plain C interface into ``lib<name>-<hash>.so``
under :data:`BUILD_DIR` (listed in ``.gitignore``), once per distinct
source text and flag set — the content hash is the cache key, so a
rebuilt checkout or a changed kernel never loads a stale library.

``-fmad=false`` is part of the contract, not a tuning choice: an FMA
contraction changes mandelbrot escape counts at pixels on the set's
boundary (``docs/KERNEL_LANGUAGE.md``), so the kernels round every product
like the plain PyTorch versions do.  ``--use_fast_math`` is never used.

The same entry point builds a source with ``g++`` (``compiler="g++"``);
the tests use that to compile the kernel-language emitter's host variant
with ``-ffp-contract=off``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

from ..errors import KernelCompileError

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "HOST_FLAGS", "nvcc_path", "build_library",
           "LaunchCounter"]

BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC")
HOST_FLAGS = ("-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC")

_locks: dict[str, threading.Lock] = {}
_locks_mu = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


class LaunchCounter:
    """A plain launch count: a kernel wrapper adds one where it launches
    its kernel, and nowhere else (``by_key`` splits it per kernel name)."""

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self.count = 0
        self.by_key: dict[str, int] = {}

    def add(self, key: str | None = None) -> None:
        with self._mu:
            self.count += 1
            if key is not None:
                self.by_key[key] = self.by_key.get(key, 0) + 1

    def reset(self) -> None:
        with self._mu:
            self.count = 0
            self.by_key.clear()


def nvcc_path() -> str | None:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``nvcc`` on PATH, or
    ``/usr/local/cuda/bin/nvcc``; None when there is none."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    return None


def _key_lock(key: str) -> threading.Lock:
    with _locks_mu:
        return _locks.setdefault(key, threading.Lock())


def build_library(source: str, name: str, compiler: str = "nvcc") -> ctypes.CDLL:
    """Compile ``source`` (unless a library of the same content hash is
    already built) and load it.  Raises :class:`KernelCompileError` naming
    the missing compiler or carrying the compiler's output; there is no
    fallback.  The flags are :data:`NVCC_FLAGS` or :data:`HOST_FLAGS`
    exactly: nothing can add ``--use_fast_math`` or drop ``-fmad=false``."""
    if compiler == "nvcc":
        exe = nvcc_path()
        flags = NVCC_FLAGS
        suffix = ".cu"
    else:
        exe = shutil.which(compiler)
        flags = HOST_FLAGS
        suffix = ".cpp"
    if exe is None:
        raise KernelCompileError(
            f"{compiler} not found: the CUDA kernels of cekirdekler_tpu_torch "
            f"build only where the CUDA toolkit is installed ({name})")
    digest = hashlib.sha256(
        "\0".join((compiler, " ".join(flags), source)).encode()).hexdigest()[:16]
    key = f"{name}-{digest}"
    with _key_lock(key):
        lib = _loaded.get(key)
        if lib is not None:
            return lib
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        so = BUILD_DIR / f"lib{key}.so"
        if not so.exists():
            # each build compiles its own copy of the source: processes that
            # build one source at once (test workers) never read a half-written one
            tag = f"{os.getpid()}.{threading.get_ident()}"
            src = BUILD_DIR / f"{key}.{tag}{suffix}"
            src.write_text(source)
            tmp = BUILD_DIR / f"lib{key}.{tag}.tmp"
            proc = subprocess.run(
                [exe, *flags, "-o", str(tmp), str(src)],
                capture_output=True, text=True)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                src.unlink(missing_ok=True)
                raise KernelCompileError(
                    f"{compiler} failed to build {name}:\n{proc.stderr[-4000:]}")
            os.replace(src, BUILD_DIR / f"{key}{suffix}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        _loaded[key] = lib
        return lib
