"""Kernel program registry: parse once, build per launch geometry, cache.

Counterpart of ``cekirdekler_tpu/kernel/registry.py``: a
:class:`KernelProgram` parses a C-subset source once and caches one launch
function per ``(name, chunk, local size, global size, platform)`` — the
reference's cache key.  ``@kernel`` registers Python kernels written in
torch.

Routing, decided statically when a launcher is built (never by catching a
failed build or launch): a C-subset kernel inside the CUDA emitter's
subset (``cuda_backend.unsupported_reason`` is None) launches the
emitted kernel on a CUDA lane; any other C-subset kernel, a host lane, and
a launch over ``float16`` or ``bfloat16`` arrays (checked per launch by
``cuda_backend.takes_storage``; the reference's TPU kernel sends ``float16``
to XLA the same way) get the torch lowering (``codegen``).  :data:`launch_counts`
counts launches per route (``"cuda"``, ``"torch"``, ``"python"``) so a run
can show which path it took.

:meth:`KernelProgram.fused_launcher` runs a whole ladder, as the
reference's fused and sequence launchers do on the device: the kernel
sequence over a predicated ladder, with the offset, the units and the
iteration count as run-time arguments and an optional sync kernel between
two iterations.  It serves the fused-iteration window and ``repeat_count``
alike, one callable per key that makes the same launches as the per-call
path, in the same order; on CPU tensors it is a host loop, and on a GPU
lane ``kernel/graphs.py`` captures one call of it into a CUDA graph and
replays that.

:meth:`KernelProgram.summaries` and :meth:`KernelProgram.verify` are the
reference's partition-safety hooks (``analysis/``): one access summary per
C kernel, built at the first verify, and one cached verdict per launch
shape, which ``Cores.compute``'s verify gate reads on every call.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Sequence

from ..errors import KernelCompileError
from . import build, codegen, cuda_backend, lang

__all__ = ["KernelProgram", "kernel", "PythonKernel", "launch_counts",
           "reset_launch_counts", "inflight"]


class _RouteCounts(dict):
    """Launches per route; counted into a graph capture's tally while the
    calling thread captures one (:func:`build.tally`)."""

    def __init__(self) -> None:
        super().__init__(cuda=0, torch=0, python=0)
        self._mu = threading.Lock()

    def add(self, route: str, n: int = 1) -> None:
        if build.tallied(self, route, n):
            return
        with self._mu:
            self[route] += n

    def reset(self) -> None:
        with self._mu:
            for k in self:
                self[k] = 0


#: launches per route since the last reset
launch_counts = _RouteCounts()
_inflight = threading.local()


def reset_launch_counts() -> None:
    launch_counts.reset()


def inflight() -> str | None:
    """The kernel the calling thread's last ladder launcher was launching."""
    return getattr(_inflight, "name", None)


@dataclass
class PythonKernel:
    """A kernel authored as a Python function on torch tensors.

    The function receives ``gid`` — the ``range`` of global work-item ids
    of the launch chunk (``torch.arange(gid.start, gid.stop)`` gives the
    ids as a tensor) — and the full array arguments (1-D tensors on the
    lane's device), and returns the updated arrays (tuple, same order; a
    shorter tuple leaves the rest unchanged).  Value arguments arrive as
    keyword scalars.
    """

    fn: Callable
    name: str
    array_params: list[str]
    value_params: list[str] = field(default_factory=list)


def kernel(fn: Callable | None = None, *, name: str | None = None):
    """Decorator: register a Python/torch function as a kernel.

    >>> @kernel
    ... def scale(gid, a, factor=2.0):
    ...     a[gid.start:gid.stop] *= factor
    ...     return (a,)
    """

    def deco(f: Callable) -> PythonKernel:
        import inspect

        params = list(inspect.signature(f).parameters.values())
        if not params or params[0].name != "gid":
            raise KernelCompileError(
                f"@kernel function {f.__name__!r} must take 'gid' as its first parameter")
        arrays = [p.name for p in params[1:] if p.default is inspect.Parameter.empty]
        values = [p.name for p in params[1:] if p.default is not inspect.Parameter.empty]
        return PythonKernel(fn=f, name=name or f.__name__, array_params=arrays,
                            value_params=values)

    return deco(fn) if fn is not None else deco


class KernelProgram:
    """A kernel source: name -> AST, plus the launch-function cache.

    Accepts a C-subset source string, a :class:`PythonKernel`, or a mixed
    sequence of both."""

    def __init__(self, source: str | PythonKernel | Sequence):
        self.source = source if isinstance(source, str) else ""
        self._c_kernels: dict[str, lang.KernelDef] = {}
        self._py_kernels: dict[str, PythonKernel] = {}
        self._cache: dict[tuple, tuple[Callable, Any]] = {}
        self._routes: dict[str, str] = {}
        self._lock = threading.Lock()
        # the partition-safety analysis (analysis/): one summary per kernel,
        # built at the first verify, and one verdict per launch shape
        self._analysis_summaries: dict | None = None
        self._verdict_cache: dict[tuple, Any] = {}
        items = [source] if isinstance(source, (str, PythonKernel)) else list(source)
        for item in items:
            if isinstance(item, str):
                for kdef in lang.parse_kernels(item):
                    self._c_kernels[kdef.name] = kdef
            elif isinstance(item, PythonKernel):
                self._py_kernels[item.name] = item
            else:
                raise KernelCompileError(f"unsupported kernel source: {type(item).__name__}")
        if not self._c_kernels and not self._py_kernels:
            raise KernelCompileError("no kernels found in source")

    @property
    def kernel_names(self) -> list[str]:
        return list(self._c_kernels) + list(self._py_kernels)

    @property
    def compiled_count(self) -> int:
        """Distinct launchers in the cache (launch geometries and fused
        ladders) — the binary ladder keeps this O(log(range/step))
        whatever splits the balancer produces."""
        with self._lock:
            return len(self._cache)

    @property
    def fused_compiled_count(self) -> int:
        """Distinct fused ladders in the cache (:meth:`fused_launcher`, for
        windows and repeats).  Their key holds no range-table row and no
        iteration count, so this moves only with the kernel sequence, the
        sync kernel, the step and range geometry, the values or the
        platform."""
        with self._lock:
            return sum(1 for k in self._cache if len(k) == 9 and k[0] == "fused")

    def __contains__(self, name: str) -> bool:
        return name in self._c_kernels or name in self._py_kernels

    def array_param_count(self, name: str) -> int:
        if name in self._c_kernels:
            return sum(1 for p in self._c_kernels[name].params if p.is_pointer)
        return len(self._py_kernels[name].array_params)

    def value_param_names(self, name: str) -> list[str]:
        if name in self._c_kernels:
            return [p.name for p in self._c_kernels[name].params if not p.is_pointer]
        return list(self._py_kernels[name].value_params)

    # -- partition-safety verification (analysis/) ---------------------------
    def summaries(self) -> dict:
        """Per-kernel access summaries, built once per program (one
        abstract interpretation per C kernel).  Python kernels, the hand
        kernels that plug into ``compute()`` among them
        (``workloads.mandelbrot_cuda_kernel``), map to ``None``: outside
        the analyzable surface.  An analysis bail-out on one kernel
        degrades that kernel to unverifiable, never breaks the build."""
        out = self._analysis_summaries
        if out is None:
            from .. import analysis

            out = {}
            for name, kdef in self._c_kernels.items():
                try:
                    out[name] = analysis.summarize_kernel(kdef)
                except Exception:  # noqa: BLE001 - degrade, never break
                    out[name] = None
            for name in self._py_kernels:
                out[name] = None
            self._analysis_summaries = out
        return out

    def verify(self, kernel_names, flag_rows, window: bool = False):
        """Cached :class:`~..analysis.LaunchVerdict` for one launch
        shape.  ``flag_rows`` is a tuple of :func:`~..analysis.flag_row`
        tuples (positional, the call's parameter order).  Verification
        runs once per distinct (kernel sequence, flags, window); every
        later call is one dict lookup."""
        key = (tuple(kernel_names), tuple(flag_rows), bool(window))
        v = self._verdict_cache.get(key)
        if v is None:
            from .. import analysis

            try:
                v = analysis.verify_launch(
                    self.summaries(), key[0], key[1], window=key[2])
            except Exception:  # noqa: BLE001 - the verifier never sinks a
                # compute: an empty verdict is "nothing proven"
                v = analysis.LaunchVerdict(findings=())
            self._verdict_cache[key] = v
        return v

    def route(self, name: str) -> str:
        """``"cuda"`` (emitter subset), ``"torch"`` (torch lowering) or
        ``"python"`` — the static routing decision for one kernel."""
        r = self._routes.get(name)
        if r is None:
            if name in self._py_kernels:
                r = "python"
            elif name in self._c_kernels:
                r = ("cuda" if cuda_backend.unsupported_reason(self._c_kernels[name]) is None
                     else "torch")
            else:
                raise KernelCompileError(
                    f"kernel {name!r} not found; available: {self.kernel_names}")
            self._routes[name] = r
        return r

    def capturable(self, names, bufs: tuple, out: tuple) -> bool:
        """True when a ladder of the kernels ``names`` over ``bufs`` (tensors
        on the card) that returned ``out`` can be captured into a CUDA graph,
        which bakes the buffers' addresses: every kernel is written by hand
        (the emitted kernel over storage types it takes, or a ``@kernel``;
        the torch lowering syncs on a loop's condition), and ``out`` holds
        the input tensors themselves."""
        if not bufs or bufs[0].device.type != "cuda":
            return False
        if len(out) != len(bufs) or any(o is not b for o, b in zip(out, bufs)):
            return False
        for name in names:
            route = self.route(name)
            if route == "torch" or (route == "cuda" and not cuda_backend.takes_storage(
                    bufs[:self.array_param_count(name)])):
                return False
        return True

    def _ladder_fns(self, names, chunks, local_size: int, global_size: int, value_args,
                    platform: str | None) -> list[tuple]:
        """Per kernel name: (name, array count, values, launch fn per chunk)."""
        out = []
        for name in names:
            va = tuple(value_args.get(name, ()) if isinstance(value_args, dict)
                       else value_args)
            fns = [self.launcher(name, c, local_size, global_size, platform)[0] for c in chunks]
            out.append((name, self.array_param_count(name), va, fns))
        return out

    @staticmethod
    def _values_key(names, value_args) -> tuple:
        if isinstance(value_args, dict):
            return tuple(sorted((n, tuple(value_args.get(n, ()))) for n in set(names)))
        return tuple(value_args)

    def fused_launcher(self, names: tuple, step: int, total_range: int, local_size: int,
                       global_size: int, value_args, platform: str | None = None,
                       sync_kernel: str | None = None) -> Callable | None:
        """``fn(offset, units, iters, bufs) -> bufs``: ``iters`` times the
        kernel sequence over ``units * step`` work items from ``offset``,
        with ``sync_kernel`` over the same items between two iterations,
        where the offset, the units and the iteration count are run-time
        arguments.  It is the fused-iteration window's dispatch
        (``core/cores.py``) and a call's ``repeat_count`` repeats (the
        reference's computeRepeated / computeRepeatedWithSyncKernel).

        The ladder is predicated, as the reference's: it holds every chunk
        ``step * 2^k`` up to ``total_range`` and launches chunk ``k`` iff
        bit ``k`` of ``units`` is set, in descending order, so it makes the
        per-call path's launches exactly.  Every chunk's launcher is built
        here, once: a rebalance or another window size then builds nothing
        (``compiled_count`` and :attr:`fused_compiled_count` stay flat).
        Returns None when the values are unhashable."""
        every = tuple(names) + ((sync_kernel,) if sync_kernel else ())
        try:
            key = ("fused", tuple(names), step, total_range, local_size, global_size,
                   self._values_key(every, value_args), platform, sync_kernel)
            with self._lock:
                hit = self._cache.get(key)
        except TypeError:
            return None
        if hit is not None:
            return hit[0]
        bits = tuple(reversed(range(max(1, (total_range // step).bit_length()))))
        chunks = tuple(step << k for k in bits)
        steps = self._ladder_fns(names, chunks, local_size, global_size, value_args, platform)
        sync = (self._ladder_fns((sync_kernel,), chunks, local_size, global_size, value_args,
                                 platform) if sync_kernel else [])

        def ladder(seq, offset: int, units: int, bufs: tuple) -> tuple:
            for name, n_arr, va, fns in seq:
                _inflight.name = name
                off = offset
                for k, launch in zip(bits, fns):
                    if (units >> k) & 1:
                        out = launch(off, bufs[:n_arr], va)
                        bufs = tuple(out) + bufs[n_arr:]
                        off += step << k
            return bufs

        def fn(offset: int, units: int, iters: int, bufs: tuple) -> tuple:
            bufs = tuple(bufs)
            for i in range(iters):
                if i:
                    bufs = ladder(sync, offset, units, bufs)
                bufs = ladder(steps, offset, units, bufs)
            return bufs

        info = codegen.KernelBuildInfo(name="fused:" + "+".join(every), array_params=[],
                                       value_params=[], array_ctypes={}, stored_params=[])
        with self._lock:
            self._cache[key] = (fn, info)
        return fn

    def launcher(self, name: str, chunk: int, local_size: int, global_size: int,
                 platform: str | None = None) -> tuple[Callable, Any]:
        """Get (building if needed) the launch function for one geometry:
        ``fn(offset, arrays_tuple, values_tuple) -> arrays tuple``, updating
        the arrays (tensors on the lane's device) in place."""
        key = (name, chunk, local_size, global_size, platform)
        with self._lock:
            hit = self._cache.get(key)
        if hit is not None:
            return hit
        route = self.route(name)
        if route == "python":
            pk = self._py_kernels[name]

            def fn(offset, arrays: tuple, values: tuple = (), _pk=pk):
                launch_counts.add("python")
                out = _pk.fn(range(int(offset), int(offset) + chunk), *arrays,
                             **dict(zip(_pk.value_params, values)))
                if not isinstance(out, tuple):
                    out = (out,)
                return tuple(out) + tuple(arrays[len(out):])

            info = codegen.KernelBuildInfo(
                name=name, array_params=list(pk.array_params),
                value_params=list(pk.value_params), array_ctypes={},
                stored_params=list(pk.array_params))
        else:
            kdef = self._c_kernels[name]
            lowered, info = codegen.build_kernel_fn(kdef, chunk, local_size, global_size)
            emitted = None
            if route == "cuda":
                emitted, _ = cuda_backend.build_kernel_fn_cuda(kdef, chunk, local_size,
                                                              global_size)

            def fn(offset, arrays: tuple, values: tuple = (), _emitted=emitted,
                   _lowered=lowered):
                # the emitted kernel takes the launch when the arrays are on
                # the card in a storage type it has (no float16/bfloat16)
                if (_emitted is not None and arrays and arrays[0].device.type == "cuda"
                        and cuda_backend.takes_storage(arrays)):
                    launch_counts.add("cuda")
                    return _emitted(offset, arrays, values)
                launch_counts.add("torch")
                return _lowered(offset, arrays, values)

        with self._lock:
            self._cache[key] = (fn, info)
        return fn, info
