"""NumberCruncher — the user-facing facade over the plain :class:`Cores`.

Counterpart of ``cekirdekler_tpu/core/cruncher.py``: construct from an
:class:`AcceleratorType` flag or an explicit :class:`Devices` selection
plus a kernel source (C-subset string, ``@kernel`` Python functions, or a
mix).  ``AcceleratorType.GPU`` selects the CUDA devices and raises
:class:`DeviceSelectionError` where there is none.  Of the reference's
runtime toggles ``repeat_count`` and ``enqueue_mode`` (with ``flush`` and
``barrier``) are ported; the balancer runs as the reference's default
(adaptive, smoothed).  Enqueue mode runs as the reference's with
``fused_dispatch=False``: the toggles of tiers that are not ported
(``fused_dispatch``, ``fused_batch``, ``enqueue_mode_async_enable``,
``fine_grained_queue_control``) read their value and raise
:class:`NotPortedError` when set to another.
"""

from __future__ import annotations

from typing import Sequence

from ..errors import NotPortedError
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
