"""NumberCruncher — the user-facing facade over :class:`Cores`.

Counterpart of ``cekirdekler_tpu/core/cruncher.py``: construct from an
:class:`AcceleratorType` flag or an explicit :class:`Devices` selection
plus a kernel source (C-subset string, ``@kernel`` Python functions, or a
mix).  ``AcceleratorType.GPU`` selects the CUDA devices and raises
:class:`DeviceSelectionError` where there is none.  The reference's
runtime toggles are ported with its defaults: ``repeat_count``,
``enqueue_mode`` (with ``flush`` and ``barrier``), the fused tier
(``fused_dispatch``, ``fused_batch``, ``fused_stats``), streamed transfers
(``streamed_transfers`` True, ``stream_chunks`` 0 = the tuner's choice,
``stream_queue_depth`` 2, ``transfer_tuner``), the balancer
(``normalized_compute_powers_of_devices`` None, ``adaptive_load_balancer``
True, ``smooth_load_balancer`` True), ``no_compute_mode`` False,
``performance_feed`` False with ``performance_history`` and
``last_compute_performance_report``, and ``enqueue_mode_async_enable``
(stored; a lane's enqueued work is always asynchronous),
``fence_split`` False and ``pipeline_lookahead`` 2,
:meth:`health_report` and :meth:`serve_debug` (the debug endpoints; also
started by ``CK_DEBUG_PORT``).  Not ported: ``fine_grained_queue_control``
(queue markers, ROADMAP Queue A 4), which reads False and raises
:class:`NotPortedError` when set True, and ``dispatch_gate``.
"""

from __future__ import annotations

from typing import Sequence

from ..errors import CekirdeklerError, NotPortedError
from ..hardware import AcceleratorType, Devices, devices_for_type
from ..kernel.registry import KernelProgram, PythonKernel
from .cores import Cores

__all__ = ["NumberCruncher"]


class NumberCruncher:
    """Build kernels for the selected lanes and treat them as one device."""

    def __init__(self, devices_or_type: Devices | AcceleratorType,
                 kernels: str | PythonKernel | Sequence, max_devices: int = 0):
        if isinstance(devices_or_type, AcceleratorType):
            devices = devices_for_type(devices_or_type, max_devices)
        else:
            devices = devices_or_type
            if max_devices > 0:
                devices = devices.subset(max_devices)
        self.number_of_errors_happened = 0
        try:
            self.program = KernelProgram(kernels)
            self.cores = Cores(devices, self.program)
        except Exception:
            self.number_of_errors_happened += 1
            raise
        self._disposed = False
        self._async_enable = True

    @property
    def devices(self) -> Devices:
        return self.cores.devices

    @property
    def num_devices(self) -> int:
        return self.cores.num_devices

    @property
    def kernel_names(self) -> list[str]:
        return self.program.kernel_names

    @property
    def repeat_count(self) -> int:
        return self.cores.repeat_count

    @repeat_count.setter
    def repeat_count(self, v: int) -> None:
        self.cores.repeat_count = max(1, int(v))

    @property
    def repeat_kernel_name(self) -> str | None:
        """A kernel run between two repeats of ``repeat_count`` (reference:
        computeRepeatedWithSyncKernel)."""
        return self.cores.repeat_sync_kernel

    @repeat_kernel_name.setter
    def repeat_kernel_name(self, name: str | None) -> None:
        self.cores.repeat_sync_kernel = name

    @property
    def fence_split(self) -> bool:
        """Per-compute-id fence splitting at enqueue-mode barriers: marginal
        per-id benches from completion-order probes instead of one
        whole-window fence time charged to every id of a mixed window.
        Costs one more probe per id per barrier; off by default."""
        return self.cores.fence_split

    @fence_split.setter
    def fence_split(self, v: bool) -> None:
        self.cores.fence_split = bool(v)

    @property
    def enqueue_mode(self) -> bool:
        """Dispatch without waiting; readbacks wait for :meth:`flush`, and
        ranges move only after a :meth:`barrier`.  Leaving enqueue mode
        flushes."""
        return self.cores.enqueue_mode

    @enqueue_mode.setter
    def enqueue_mode(self, v: bool) -> None:
        was = self.cores.enqueue_mode
        self.cores.enqueue_mode = bool(v)
        if was and not v:
            self.cores.flush()  # leaving enqueue mode syncs results to host

    def flush(self) -> None:
        """Join deferred enqueue-mode work (reference:
        flushLastUsedCommandQueue): every deferred readback lands."""
        self.cores.flush()

    def barrier(self) -> None:
        """Wait for all device work without host readback; in enqueue mode
        its fence times arm the next call's rebalance."""
        self.cores.barrier()

    @property
    def fused_dispatch(self) -> bool:
        """Fused-iteration dispatch (default True): an enqueue window that
        repeats one call defers its later calls and dispatches them in
        batches as one ladder per lane (a CUDA graph on a GPU lane).
        Results are the per-call path's bit for bit; refusals are counted by
        reason in :attr:`fused_stats`.  Turning it off closes the window."""
        return self.cores.fused_dispatch

    @fused_dispatch.setter
    def fused_dispatch(self, v: bool) -> None:
        if not v and self.cores.fused_dispatch:
            self.cores._fused_close()
        self.cores.fused_dispatch = bool(v)

    @property
    def fused_batch(self) -> int:
        """Iterations one fused dispatch carries at most (default 16)."""
        return self.cores.fused_batch

    @fused_batch.setter
    def fused_batch(self, v: int) -> None:
        self.cores.fused_batch = max(1, int(v))

    @property
    def fused_stats(self) -> dict:
        """Fused windows dispatched, iterations fused and deferred, and the
        disengages by reason."""
        return self.cores.fused_stats

    @property
    def streamed_transfers(self) -> bool:
        """Streamed partition transfers (default True): a lane's uploads and
        downloads move in chunks that overlap other chunks' kernels (copy
        streams on a GPU lane), chunk counts chosen by
        :attr:`transfer_tuner` unless :attr:`stream_chunks` pins them;
        results are the monolithic path's bit for bit."""
        return self.cores.streamed_transfers

    @streamed_transfers.setter
    def streamed_transfers(self, v: bool) -> None:
        self.cores.streamed_transfers = bool(v)

    @property
    def stream_chunks(self) -> int:
        """Pinned chunk count of streamed transfers (0 = the tuner's
        choice, 1 = monolithic)."""
        return self.cores.stream_chunks

    @stream_chunks.setter
    def stream_chunks(self, v: int) -> None:
        self.cores.stream_chunks = max(0, int(v))

    @property
    def stream_queue_depth(self) -> int:
        """Chunks staged ahead of the dispatched one (default 2), and the
        page-locked staging slots of a pageable array."""
        return self.cores.stream_queue_depth

    @stream_queue_depth.setter
    def stream_queue_depth(self, v: int) -> None:
        self.cores.stream_queue_depth = max(1, int(v))

    @property
    def pipeline_lookahead(self) -> int:
        """The EVENT engine's read lookahead: blobs staged ahead of the
        blob computing (default 2; 1 is the reference's three-queue
        wavefront)."""
        return self.cores.pipeline_lookahead

    @pipeline_lookahead.setter
    def pipeline_lookahead(self, v: int) -> None:
        self.cores.pipeline_lookahead = max(1, int(v))

    @property
    def transfer_tuner(self):
        """The chunk-count tuner (``core/stream.TransferTuner``): seed it
        with ``seed_link`` or let the lanes' runs teach it."""
        return self.cores.transfer_tuner

    @property
    def no_compute_mode(self) -> bool:
        """I/O only (reference noComputeMode): a call uploads and reads
        back as usual and launches no kernel."""
        return self.cores.no_compute_mode

    @no_compute_mode.setter
    def no_compute_mode(self, v: bool) -> None:
        self.cores.no_compute_mode = bool(v)

    @property
    def performance_feed(self) -> bool:
        """Print each call's performance report (default False)."""
        return self.cores.performance_feed

    @performance_feed.setter
    def performance_feed(self, v: bool) -> None:
        self.cores.performance_feed = bool(v)

    @property
    def last_compute_performance_report(self) -> str:
        """The last call's per-lane report (reference
        lastComputePerformanceReport)."""
        return self.cores.performance_report()

    def performance_history(self, compute_id: int):
        """The last 64 :class:`ComputePerf` reports of ``compute_id``."""
        return self.cores.performance_history(compute_id)

    @property
    def smooth_load_balancer(self) -> bool:
        """Smooth the balancer's shares over its history (default True)."""
        return self.cores.smooth_load_balancer

    @smooth_load_balancer.setter
    def smooth_load_balancer(self, v: bool) -> None:
        self.cores.smooth_load_balancer = bool(v)

    @property
    def adaptive_load_balancer(self) -> bool:
        """Adaptive per-lane damping (default True); False is the
        reference's fixed 0.3 damping.  Toggling clears the balancer's
        state."""
        return self.cores.adaptive_load_balancer

    @adaptive_load_balancer.setter
    def adaptive_load_balancer(self, v: bool) -> None:
        self.cores.adaptive_load_balancer = bool(v)

    @property
    def normalized_compute_powers_of_devices(self) -> list[float] | None:
        """Fixed shares per lane (normalized to sum 1), or None: the split
        is then the balancer's."""
        return self.cores.fixed_compute_powers

    @normalized_compute_powers_of_devices.setter
    def normalized_compute_powers_of_devices(self, powers: Sequence[float] | None) -> None:
        if powers is None:
            self.cores.fixed_compute_powers = None
            return
        powers = [float(p) for p in powers]
        if len(powers) != self.num_devices:
            raise CekirdeklerError(f"need {self.num_devices} compute powers, got {len(powers)}")
        s = sum(powers)
        self.cores.fixed_compute_powers = [p / s for p in powers]

    @property
    def enqueue_mode_async_enable(self) -> bool:
        """Kept for the reference's API (enqueueModeAsyncEnable): a lane's
        enqueued work is always asynchronous on its stream, so the flag is
        stored and read back, and changes nothing."""
        return self._async_enable

    @enqueue_mode_async_enable.setter
    def enqueue_mode_async_enable(self, v: bool) -> None:
        self._async_enable = bool(v)

    @property
    def fine_grained_queue_control(self) -> bool:
        return False

    @fine_grained_queue_control.setter
    def fine_grained_queue_control(self, v: bool) -> None:
        if v:
            _not_ported("fine_grained_queue_control=True (queue markers)")

    def reset_errors(self) -> None:
        """Re-arm a cruncher after a compute failure."""
        self.number_of_errors_happened = 0

    def performance_report(self, compute_id: int | None = None) -> str:
        return self.cores.performance_report(compute_id)

    def benchmarks_of(self, compute_id: int) -> list[float]:
        return self.cores.benchmarks_of(compute_id)

    def ranges_of(self, compute_id: int) -> list[int]:
        return self.cores.ranges_of(compute_id)

    def serve_debug(self, port: int = 0, host: str = "127.0.0.1"):
        """Start the debug HTTP endpoints (``obs/debugserver.py``) over
        this cruncher's scheduler on a daemon thread.  ``port=0`` is an
        ephemeral port: read ``server.port``.  Also started by
        ``CK_DEBUG_PORT``; closed by :meth:`dispose`."""
        return self.cores.serve_debug(port=port, host=host)

    def health_report(self) -> dict:
        """Per-lane health verdicts (``obs/health.py``), as
        :meth:`Cores.health_report`."""
        return self.cores.health_report()

    def dispose(self) -> None:
        if not self._disposed:
            self.cores.dispose()
            self._disposed = True

    def __enter__(self) -> "NumberCruncher":
        return self

    def __exit__(self, *exc) -> None:
        self.dispose()


def _not_ported(what: str) -> None:
    raise NotPortedError(f"{what} is not ported to cekirdekler_tpu_torch yet "
                         "(ROADMAP.md Queue A 4)")
