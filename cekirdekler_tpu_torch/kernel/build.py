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

With ``CK_COMPILE_CACHE=<dir>`` set (read at every build, so arming needs
no global), the libraries live in ``<dir>/lib`` instead, the compile
cache's library layer (``core/compilecache.py``): a process on a fresh
host finds there what another process built and loads it without running
a compiler.  A cached library that fails to load is the named miss
``lib-unloadable``: the file is removed and built again from the source.
:data:`BUILDS` counts compiler runs (``"compile"``) and the first load of
each library in this process (``"load"``).
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

from ..errors import KernelCompileError

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "HOST_FLAGS", "CACHE_ENV", "LIB_FILE", "nvcc_path",
           "build_library", "lib_dir", "LaunchCounter", "BuildCounter", "BUILDS", "tally",
           "tallied", "add_tally"]

BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"

#: the compile cache's root (``core/compilecache.py``); unset or empty, the
#: libraries stay in :data:`BUILD_DIR`
CACHE_ENV = "CK_COMPILE_CACHE"

#: a finished library or its kept source (``lib<name>-<hash>.so``,
#: ``<name>-<hash>.cu``); a build's temporaries carry a process tag after
#: the hash and never match
LIB_FILE = re.compile(r"-[0-9a-f]{16}\.(so|cu|cpp)$")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC")
HOST_FLAGS = ("-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC")

_locks: dict[str, threading.Lock] = {}
_locks_mu = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


class LaunchCounter:
    """A plain launch count: a kernel wrapper adds one where it launches
    its kernel, and nowhere else (``by_key`` splits it per kernel name).

    While the calling thread captures a CUDA graph (:func:`tally`), an add
    goes into the capture's tally instead: a captured launch runs only when
    the graph is replayed, and ``kernel/graphs.py`` adds the tally once per
    replay."""

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self.count = 0
        self.by_key: dict[str, int] = {}

    def add(self, key: str | None = None, n: int = 1) -> None:
        if tallied(self, key, n):
            return
        with self._mu:
            self.count += n
            if key is not None:
                self.by_key[key] = self.by_key.get(key, 0) + n

    def reset(self) -> None:
        with self._mu:
            self.count = 0
            self.by_key.clear()


class BuildCounter(LaunchCounter):
    """Compiler runs and first library loads by kind (``by_key``).  A build
    is host work, not a launch: it is never tallied into a graph capture."""

    def add(self, key: str | None = None, n: int = 1) -> None:
        with self._mu:
            self.count += n
            if key is not None:
                self.by_key[key] = self.by_key.get(key, 0) + n


#: ``"compile"``: a compiler ran; ``"load"``: a library was loaded for the
#: first time in this process
BUILDS = BuildCounter()

_tallies = threading.local()


def tallied(counter, key, n: int) -> bool:
    """Record ``n`` launches of ``counter`` (anything with ``add(key, n)``)
    into the calling thread's open :func:`tally`; False when none is open."""
    t = getattr(_tallies, "open", None)
    if t is None:
        return False
    _, seen = t.get((id(counter), key), (counter, 0))
    t[(id(counter), key)] = (counter, seen + n)
    return True


@contextlib.contextmanager
def tally():
    """Collect the launches the calling thread counts inside the block as
    ``{(id(counter), key): (counter, n)}`` instead of counting them."""
    prev = getattr(_tallies, "open", None)
    _tallies.open = t = {}
    try:
        yield t
    finally:
        _tallies.open = prev


def add_tally(t: dict) -> None:
    """Count a :func:`tally`'s launches once (one replay of a graph)."""
    for (_, key), (counter, n) in t.items():
        counter.add(key, n)


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


def lib_dir() -> Path:
    """Where :func:`build_library` keeps its libraries now: ``<root>/lib``
    under ``CK_COMPILE_CACHE``, else :data:`BUILD_DIR`."""
    root = os.environ.get(CACHE_ENV, "").strip()
    return Path(root) / "lib" if root else BUILD_DIR


def build_library(source: str, name: str, compiler: str = "nvcc") -> ctypes.CDLL:
    """Compile ``source`` (unless a library of the same content hash is
    already built) and load it.  Raises :class:`KernelCompileError` naming
    the missing compiler or carrying the compiler's output; there is no
    fallback.  The flags are :data:`NVCC_FLAGS` or :data:`HOST_FLAGS`
    exactly: nothing can add ``--use_fast_math`` or drop ``-fmad=false``.
    The library is kept in :func:`lib_dir`."""
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
        out = lib_dir()
        cached = out != BUILD_DIR
        out.mkdir(parents=True, exist_ok=True)
        so = out / f"lib{key}.so"
        lib = None
        if cached and so.exists():
            try:
                lib = ctypes.CDLL(str(so))
            except OSError:
                # a torn or foreign file: a named miss, rebuilt from the source below
                from ..core.compilecache import CACHE

                CACHE.note_miss("lib-unloadable", key)
                so.unlink(missing_ok=True)
        if lib is None:
            if not so.exists():
                # each build compiles its own copy of the source: processes that
                # build one source at once (test workers) never read a half-written one
                tag = f"{os.getpid()}.{threading.get_ident()}"
                src = out / f"{key}.{tag}{suffix}"
                src.write_text(source)
                tmp = out / f"lib{key}.{tag}.tmp"
                BUILDS.add("compile")
                proc = subprocess.run(
                    [exe, *flags, "-o", str(tmp), str(src)],
                    capture_output=True, text=True)
                if proc.returncode != 0:
                    tmp.unlink(missing_ok=True)
                    src.unlink(missing_ok=True)
                    raise KernelCompileError(
                        f"{compiler} failed to build {name}:\n{proc.stderr[-4000:]}")
                os.replace(src, out / f"{key}{suffix}")
                os.replace(tmp, so)
            lib = ctypes.CDLL(str(so))
        BUILDS.add("load")
        _loaded[key] = lib
        return lib
