"""CUDA-graph capture and replay of a lane's ladders.

The reference runs a fused window's iterations, and ``repeat_count``'s
repeats, as one XLA dispatch (``lax.fori_loop`` over a predicated ladder).
On a GPU lane the port captures the same launches into a CUDA graph: one
call of the ladder launcher ``KernelProgram.fused_launcher``, captured once
per key on a side stream of the lane, then replayed on the lane's stream
with ``CUDAGraph.replay()``.  The
kernels in the graph are the port's own: the emitted kernels and the
``@kernel`` wrappers over ``csrc/``: a key is captured only when its
ladder's kernels are such kernels and its first run wrote its buffers in
place (``KernelProgram.capturable``), a fact recorded from that run, never
from a capture that failed.

A graph bakes its kernels' arguments: the buffers' addresses, the offsets,
chunks and values.  So the key carries the ladder launcher (which holds
the geometry and the values), the offset, the units and iteration count
where the launcher takes them, and each buffer's address, length and
dtype; an entry holds its buffers, so no address in a graph is freed while
the graph can run.  A capture and its instantiation cost the host up to
a few milliseconds, more than a window of launches one by one
(``tools/fused_windows.py``), so a lane captures a key the second time it
runs it, never the first: the first time, the ladder runs launch by launch
on the lane's stream and records whether the key can be captured.  A lane keeps at most
:data:`MAX_GRAPHS` graphs and remembers :data:`MAX_SEEN` keys, the least
recently used going first, and frees them all in ``Worker.dispose``.

Launch counts: a wrapper counts its launch when it is called, which during
a capture is when the launch is recorded, not run.  The capture collects
those counts in a tally (``build.tally``) instead of counting them, and
every replay adds the tally once, so every count stays the number of
kernels that ran.  :data:`GRAPHS` counts captures, replays, and the ladders
a GPU lane ran launch by launch, the first time it ran their key or
because the key cannot be captured (``"capture"``, ``"replay"``,
``"ladder"``).

A capture runs in ``"thread_local"`` error mode, so another thread's CUDA
calls (another lane's, or the caller's fence) cannot break it.  A capture
that fails raises :class:`KernelCompileError` naming the kernel; nothing
falls back to the plain versions.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable

from ..errors import KernelCompileError
from . import build, registry

__all__ = ["GRAPHS", "MAX_GRAPHS", "MAX_SEEN", "LaneGraphs", "buffers_key"]

#: captures, replays, and ladders run launch by launch on a GPU lane
GRAPHS = build.LaunchCounter()
#: graphs a lane keeps
MAX_GRAPHS = 32
#: keys a lane remembers having run once
MAX_SEEN = 4 * MAX_GRAPHS


def buffers_key(bufs: tuple) -> tuple:
    """What a graph bakes of its buffers: address, length and dtype."""
    return tuple((b.data_ptr(), b.numel(), b.dtype) for b in bufs)


class LaneGraphs:
    """One GPU lane's graphs, keyed as the module says."""

    def __init__(self, device):
        self.device = device
        self._graphs: OrderedDict[tuple, tuple] = OrderedDict()
        # key run once, not captured -> whether it can be captured
        self._seen: OrderedDict[tuple, bool] = OrderedDict()
        self._side = None

    def __len__(self) -> int:
        return len(self._graphs)

    def run(self, key: tuple, fn: Callable[[], tuple], bufs: tuple, stream,
            capturable: Callable[[tuple], bool]) -> tuple:
        """Run ``fn()``, a ladder over ``bufs``, on ``stream`` and return its
        buffers: launch by launch at the first run of ``key``; the second
        captures the graph, and it and every later run replay it.
        ``capturable(out)`` says whether a run that returned ``out`` can be
        captured; a key whose first run could not be is never captured."""
        import torch

        hit = self._graphs.get(key)
        if hit is None:
            seen = self._seen.pop(key, None)
            if not seen:  # the first run, or one that cannot be captured
                with torch.cuda.stream(stream):
                    out = fn()
                self._seen[key] = seen is None and capturable(out)
                while len(self._seen) > MAX_SEEN:
                    self._seen.popitem(last=False)
                GRAPHS.add("ladder")
                return out
            hit = self._capture(fn, bufs)
            self._graphs[key] = hit
            while len(self._graphs) > MAX_GRAPHS:
                self._graphs.popitem(last=False)
        else:
            self._graphs.move_to_end(key)
        graph, counts, _ = hit
        with torch.cuda.stream(stream):
            graph.replay()
        build.add_tally(counts)
        GRAPHS.add("replay")
        return bufs

    def _capture(self, fn: Callable[[], tuple], bufs: tuple) -> tuple:
        import torch

        if self._side is None:
            self._side = torch.cuda.Stream(self.device)
        graph = torch.cuda.CUDAGraph()
        # a capture runs nothing, so it need not wait for the lane's stream;
        # each graph gets a memory pool of its own (pool=None)
        with build.tally() as counts, torch.cuda.stream(self._side):
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                out = fn()
            except BaseException as e:
                try:
                    graph.capture_end()
                except Exception:  # noqa: BLE001 - the launch's own error is the cause
                    pass
                raise _capture_error(e) from e
            try:
                graph.capture_end()
            except Exception as e:
                raise _capture_error(e) from e
        if len(out) != len(bufs) or any(o is not b for o, b in zip(out, bufs)):
            raise KernelCompileError(
                f"CUDA graph of kernel {registry.inflight()!r}: a launch replaced its "
                "buffers instead of writing them in place")
        GRAPHS.add("capture")
        return graph, counts, bufs

    def clear(self) -> None:
        self._graphs.clear()
        self._seen.clear()
        self._side = None


def _capture_error(e: BaseException) -> KernelCompileError:
    return KernelCompileError(
        f"CUDA graph capture of kernel {registry.inflight()!r} failed: "
        f"{type(e).__name__}: {e}")
