"""Device pipelines: a linear graph of stages on successive data generations.

Counterpart of ``cekirdekler_tpu/pipeline/device_pipeline.py`` (the
reference's ``ClPipeline``/``ClPipelineStage``, ClPipeline.cs:29-2356, and
``SingleGPUPipeline.DevicePipeline``, ClPipeline.cs:2357-3240): every stage
runs its kernels on its current values at each ``push``, all stages at
once, and then each stage's results move on to the next stage.  Data
pushed at push ``t`` is computed by stage 0 at ``t`` and reaches stage
``k`` at push ``t + k``; with S stages ``push`` returns True (results valid)
from push S on.

A single-device stage keeps its values as tensors on its lane (a GPU
lane's stage runs its kernels on a CUDA stream of its own, so stages on
one card overlap).  The port's launcher writes a stage's buffers in place,
where the JAX package's arrays are immutable values.  So the handoff
cannot be the reference's value move: stage ``k``'s next generation would
overwrite the tensor stage ``k + 1`` still reads.  Each consuming slot
holds a buffer of its own, as the C# duplicate buffers did
(ClPipeline.cs:87-111), and the handoff copies into it: on a GPU, on the
consumer's stream after an event behind the producer's kernels, with the
producer's next kernels ordered after the copy.  A stage over several lanes
(``devices=``) runs through a ``Cores`` of its own and publishes its host
arrays, which a consumer takes as a snapshot.
"""

from __future__ import annotations

import enum
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import nullcontext
from dataclasses import dataclass
from typing import Any, Sequence

import numpy as np
import torch

from ..arrays.clarray import ClArray, wrap
from ..errors import CekirdeklerError, ComputeValidationError
from ..hardware import Device, Devices
from ..kernel.registry import KernelProgram
from ..metrics.registry import REGISTRY
from ..obs.flight import record_crash
from ..trace.spans import TRACER

__all__ = ["ArrayRole", "ClPipeline", "DevicePipeline", "PipelineStage"]


class ArrayRole(enum.Enum):
    """A single-device pipeline's array semantics (reference:
    DevicePipelineArrayType, ClPipeline.cs:3171-3206): ``INPUT`` is fed
    from the host each feed, ``OUTPUT`` read back each feed, ``INTERNAL``
    stays on the device, ``TRANSITION`` is written by its stage and read by
    the next stage one generation later."""

    INPUT = "input"
    OUTPUT = "output"
    INTERNAL = "internal"
    TRANSITION = "transition"


@dataclass
class _Slot:
    """A logical array bound to a stage (reference: ClPipelineStageBuffer):
    its value is the stage's tensor on a single-device stage, the host data
    handed to a multi-lane stage, or None."""

    arr: ClArray
    role: str
    value: Any = None


def _as_list(x) -> list:
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _host_of(d) -> np.ndarray:
    return d.host() if isinstance(d, ClArray) else np.asarray(d)


class PipelineStage:
    """One stage: kernels, a lane (or lanes) and its input, hidden and
    output arrays (reference: ClPipelineStage).  A kernel's arguments are
    the inputs, then the hiddens, the outputs and the transitions."""

    def __init__(self, kernel_source, kernels: str | Sequence[str], global_range: int,
                 local_range: int = 256, values: Sequence | dict = (),
                 init_kernels: str | Sequence[str] = (), devices=None):
        self.program = KernelProgram(kernel_source)
        self.kernels = kernels.split() if isinstance(kernels, str) else list(kernels)
        self.init_kernels = (init_kernels.split() if isinstance(init_kernels, str)
                             else list(init_kernels))
        self.global_range = global_range
        self.local_range = local_range
        self.values = values
        self.inputs: list[_Slot] = []
        self.hiddens: list[_Slot] = []
        self.outputs: list[_Slot] = []
        self.transitions: list[_Slot] = []
        self.device: Device | None = None
        # a stage over several lanes runs through a Cores of its own (the
        # reference's per-stage cruncher); an empty selection is unassigned
        self.devices = devices if devices is not None and len(devices) > 0 else None
        self._cores = None
        # a GPU lane's single-device stage launches on a stream of its own
        self.stream = None
        self.prev: PipelineStage | None = None
        self.next: PipelineStage | None = None
        self.elapsed_ms = 0.0
        self._transition_links: list[tuple[_Slot, _Slot]] = []

    # -- binding (reference: addInput/Hidden/OutputBuffers) ------------------
    def add_input(self, *arrays, **flags) -> "PipelineStage":
        self.inputs.extend(_Slot(wrap(a, **flags), "input") for a in arrays)
        return self

    def add_hidden(self, *arrays, **flags) -> "PipelineStage":
        self.hiddens.extend(_Slot(wrap(a, **flags), "hidden") for a in arrays)
        return self

    def add_output(self, *arrays, **flags) -> "PipelineStage":
        self.outputs.extend(_Slot(wrap(a, **flags), "output") for a in arrays)
        return self

    def add_transition(self, *arrays, **flags) -> "PipelineStage":
        """Arrays this stage writes and the next stage reads one generation
        later; the next stage binds the same array as an input or hidden."""
        self.transitions.extend(_Slot(wrap(a, **flags), "transition") for a in arrays)
        return self

    def add_array(self, arr, role: ArrayRole, **flags) -> "PipelineStage":
        """Binding by role (the reference's API shape)."""
        if role is ArrayRole.INPUT:
            return self.add_input(arr, **flags)
        if role is ArrayRole.OUTPUT:
            return self.add_output(arr, **flags)
        if role is ArrayRole.INTERNAL:
            return self.add_hidden(arr, **flags)
        return self.add_transition(arr, **flags)

    # -- graph (reference: prependToStage/appendToStage) ---------------------
    def append_to(self, prev: "PipelineStage") -> "PipelineStage":
        prev.next, self.prev = self, prev
        return self

    def prepend_to(self, nxt: "PipelineStage") -> "PipelineStage":
        nxt.prev, self.next = self, nxt
        return self

    # -- execution -----------------------------------------------------------
    def _slots(self) -> list[_Slot]:
        return self.inputs + self.hiddens + self.outputs + self.transitions

    def _on_stream(self):
        return torch.cuda.stream(self.stream) if self.stream is not None else nullcontext()

    def _bind(self, device: Device) -> None:
        """Give every slot a tensor of its own on the stage's lane, holding
        the array's host data."""
        dev = device.torch_device
        if dev.type == "cuda":
            self.stream = torch.cuda.Stream(dev)
        with self._on_stream():
            for s in self._slots():
                if s.value is None:
                    s.value = torch.from_numpy(s.arr.host()).to(dev, copy=True)

    def _set(self, slot: _Slot, host: np.ndarray) -> None:
        """Write host data into a slot: a single-device stage's tensor, on
        its stream; a multi-lane stage's host array."""
        if self._cores is not None:
            np.copyto(slot.arr.host(), host, casting="unsafe")
            slot.value = None
            return
        with self._on_stream():
            slot.value.copy_(torch.as_tensor(np.ascontiguousarray(host)))

    def _read(self, slot: _Slot, target: np.ndarray) -> None:
        """Copy a slot's value into a host array, after the stage's work."""
        v = slot.value
        if isinstance(v, torch.Tensor):
            with self._on_stream():
                v = v.to("cpu", copy=True).numpy()
        np.copyto(target, np.asarray(v), casting="unsafe")

    def _run(self, kernel_names: list[str]) -> None:
        """Launch the kernel sequence over the stage's values (one launch a
        kernel over the whole range, on the stage's stream)."""
        if self._cores is not None:
            self._run_multi(kernel_names)
            return
        _tt = TRACER.t0()
        t0 = time.perf_counter()
        slots = self._slots()
        bufs = tuple(s.value for s in slots)
        platform = self.device.torch_device.type if self.device is not None else None
        with self._on_stream():
            for name in kernel_names:
                va = (self.values.get(name, ()) if isinstance(self.values, dict)
                      else tuple(self.values))
                fn, _ = self.program.launcher(name, self.global_range, self.local_range,
                                              self.global_range, platform=platform)
                n_arr = self.program.array_param_count(name)
                out = fn(0, bufs[:n_arr], tuple(va))
                bufs = tuple(out) + bufs[n_arr:]
        for s, b in zip(slots, bufs):
            s.value = b
        self.elapsed_ms = (time.perf_counter() - t0) * 1000.0
        REGISTRY.counter("ck_pipeline_stages_total", "stage bodies executed",
                         engine="single").inc()
        TRACER.record("pipeline-stage", _tt,
                      tag=f"{self.device.name if self.device else '?'}:{'+'.join(kernel_names)}")

    def _run_multi(self, kernel_names: list[str]) -> None:
        """A multi-lane stage: the values handed to it land in its host
        arrays, its own ``Cores`` computes over its lanes (a full H2D,
        compute, D2H, as the reference's stage), and its outputs are its
        host arrays."""
        _tt = TRACER.t0()
        t0 = time.perf_counter()
        slots = self._slots()
        for s in slots:
            if s.value is not None and s.value is not s.arr.host():
                np.copyto(s.arr.host(), np.asarray(s.value), casting="unsafe")
                s.value = None
        self._cores.compute(kernel_names, [s.arr for s in slots], 1, self.global_range,
                            self.local_range, value_args=self.values)
        for s in self.outputs + self.transitions:
            s.value = s.arr.host()
        self.elapsed_ms = (time.perf_counter() - t0) * 1000.0
        REGISTRY.counter("ck_pipeline_stages_total", "stage bodies executed",
                         engine="multi").inc()
        TRACER.record("pipeline-stage", _tt,
                      tag=f"multi[{len(self.devices) if self.devices else 0}]:"
                          f"{'+'.join(kernel_names)}")


def _handoff(src: PipelineStage, v, dst: PipelineStage, slot: _Slot) -> None:
    """Hand a producer's value to a consumer's slot as a snapshot the
    producer's next generation cannot touch."""
    if dst._cores is not None:
        # a multi-lane consumer takes host data (its compute uploads per-lane
        # ranges from it)
        if isinstance(v, torch.Tensor):
            with src._on_stream():
                slot.value = v.to("cpu", copy=True).numpy()
        else:
            slot.value = np.array(v)  # a multi-lane producer's live host array
        return
    if not isinstance(v, torch.Tensor):
        dst._set(slot, np.asarray(v))
        return
    if src.stream is not None and dst.stream is not None:
        # on the consumer's stream after the producer's kernels; the
        # producer's next kernels after the copy
        ready = torch.cuda.Event()
        ready.record(src.stream)
        dst.stream.wait_event(ready)
        with torch.cuda.stream(dst.stream):
            slot.value.copy_(v, non_blocking=True)
            copied = torch.cuda.Event()
            copied.record(dst.stream)
        src.stream.wait_event(copied)
    else:
        # a host lane on one side: the copy returns when it is made, in
        # the order of the GPU side's stream
        with (src if src.stream is not None else dst)._on_stream():
            slot.value.copy_(v)


class ClPipeline:
    """A linear pipeline of stages, one lane each (reference: ClPipeline);
    a stage with ``devices`` spans its own lanes.  Build it with
    :meth:`make`."""

    def __init__(self, stages: list[PipelineStage]):
        self.stages = stages
        self.push_count = 0
        self._pool = ThreadPoolExecutor(max_workers=max(2, len(stages)),
                                        thread_name_prefix="ck-pipeline")

    @classmethod
    def make(cls, stages: Sequence[PipelineStage], devices: Sequence[Device]) -> "ClPipeline":
        """Wire the stages onto lanes, link the transitions and run the
        initializer kernels (reference: makePipeline)."""
        from ..core.cores import Cores  # local: core imports arrays

        stages = list(stages)
        if not stages:
            raise CekirdeklerError("pipeline needs at least one stage")
        devices = list(devices)
        unassigned = [st for st in stages if st.devices is None]
        if len(devices) == 1:
            devices = devices * len(unassigned)  # every unassigned stage on the one lane
        if len(devices) < len(unassigned):
            raise CekirdeklerError(
                f"{len(unassigned)} stages need {len(unassigned)} devices (or exactly 1 for a "
                f"single-device pipeline); got {len(devices)}")
        dev_iter = iter(devices)
        for i, st in enumerate(stages):
            if i > 0:
                st.prev, stages[i - 1].next = stages[i - 1], st
            if st.devices is not None:
                st._cores = Cores(Devices(st.devices), st.program)
                st.device = st.devices[0]
            else:
                st.device = next(dev_iter)
                st._bind(st.device)
            for s in st._slots():
                if s.arr.size < st.global_range:
                    raise ComputeValidationError(
                        f"stage {i} array '{s.arr.name}' smaller than global range")
        # a transition slot feeds the next stage's slot of the same array
        for i, st in enumerate(stages):
            st._transition_links = []
            for t in st.transitions:
                if st.next is None:
                    raise ComputeValidationError(
                        f"stage {i} declares transition '{t.arr.name}' but has no next stage")
                target = next((s for s in st.next._slots() if s.arr is t.arr), None)
                if target is None:
                    raise ComputeValidationError(
                        f"transition '{t.arr.name}' of stage {i} is not bound on stage {i + 1} "
                        "(declare it there as input/internal)")
                st._transition_links.append((t, target))
        for st in stages:
            if st.init_kernels:
                st._run(st.init_kernels)
        return cls(stages)

    def _feed(self, data) -> None:
        first = self.stages[0]
        datas = _as_list(data)
        if len(datas) != len(first.inputs):
            raise ComputeValidationError(
                f"push data count {len(datas)} != stage-0 inputs {len(first.inputs)}")
        for slot, d in zip(first.inputs, datas):
            first._set(slot, _host_of(d))

    def _results(self, results) -> None:
        last = self.stages[-1]
        outs = _as_list(results)
        if len(outs) != len(last.outputs):
            raise ComputeValidationError(
                f"results count {len(outs)} != last-stage outputs {len(last.outputs)}")
        for slot, r in zip(last.outputs, outs):
            last._read(slot, r.host() if isinstance(r, ClArray) else r)

    def push(self, data: Sequence | None = None, results: Sequence | None = None) -> bool:
        """Advance one generation (reference: pushData): ``data`` feeds
        stage 0's inputs, every stage runs at once, ``results`` receives the
        last stage's outputs, and the links move on.  True once results are
        valid (``push_count`` >= the number of stages)."""
        if data is not None:
            self._feed(data)
        futures = [self._pool.submit(st._run, st.kernels) for st in self.stages]
        errs = []
        for f in futures:
            try:
                f.result()
            except Exception as e:  # noqa: BLE001 - the first error surfaces
                errs.append(e)
        if errs:
            record_crash("pipeline.push", errs[0], lanes={
                "stages": len(self.stages), "push_count": self.push_count})
            raise errs[0]
        if results is not None:
            self._results(results)
        self._switch()
        self.push_count += 1
        return self.push_count >= len(self.stages)

    def _switch(self) -> None:
        """Move every link one generation on (the reference's switchBuffers
        and forwardResults): a stage's transitions to the next stage's
        slots, else its outputs to the next stage's inputs by index."""
        for st in self.stages[:-1]:
            nxt = st.next
            links = st._transition_links or list(zip(st.outputs, nxt.inputs))
            for src, dst in links:
                _handoff(st, src.value, nxt, dst)

    @property
    def streamed_transfers(self) -> bool:
        """Streamed partition transfers inside multi-lane stages (each
        stage's own ``Cores``); True iff every multi-lane stage has them
        on."""
        cores = [st._cores for st in self.stages if st._cores is not None]
        return bool(cores) and all(c.streamed_transfers for c in cores)

    @streamed_transfers.setter
    def streamed_transfers(self, v: bool) -> None:
        for st in self.stages:
            if st._cores is not None:
                st._cores.streamed_transfers = bool(v)

    @property
    def stream_chunks(self) -> int:
        """The multi-lane stages' pinned chunk count (0: each stage's
        tuner chooses)."""
        for st in self.stages:
            if st._cores is not None:
                return st._cores.stream_chunks
        return 0

    @stream_chunks.setter
    def stream_chunks(self, v: int) -> None:
        for st in self.stages:
            if st._cores is not None:
                st._cores.stream_chunks = max(0, int(v))

    def performance_report(self) -> str:
        lines = ["pipeline stages:"]
        for i, st in enumerate(self.stages):
            lines.append(f"  stage {i} [{st.device.name if st.device else '?'}]: "
                         f"{st.elapsed_ms:8.3f} ms  kernels={' '.join(st.kernels)}")
        return "\n".join(lines)

    def dispose(self) -> None:
        """Stop the stage threads, dispose the multi-lane stages' lanes and
        drop every value."""
        self._pool.shutdown(wait=True)
        for st in self.stages:
            if st.stream is not None:
                st.stream.synchronize()
            if st._cores is not None:
                st._cores.dispose()
                st._cores = None
            for s in st._slots():
                s.value = None


class DevicePipeline(ClPipeline):
    """Every stage on one lane (reference: SingleGPUPipeline.DevicePipeline),
    with the same generations.  On a GPU the stages' streams overlap on the
    card; :meth:`feed_async_begin` / :meth:`feed_async_end` run a
    generation on a background thread while the caller prepares the next
    feed (reference feedAsync)."""

    def __init__(self, stages: list[PipelineStage]):
        super().__init__(stages)
        self._async_future = None

    @classmethod
    def make(cls, stages: Sequence[PipelineStage], device: Device) -> "DevicePipeline":
        return super().make(stages, [device])

    def feed(self, data=None, results=None) -> bool:
        """One generation, synchronously (reference: feed)."""
        return self.push(data, results)

    def _generation(self, snaps) -> None:
        first = self.stages[0]
        if snaps is not None:
            for slot, host in zip(first.inputs, snaps):
                first._set(slot, host)
        for st in self.stages:
            st._run(st.kernels)
        self._switch()

    def feed_async_begin(self, data=None) -> None:
        """Start this generation on a background thread and return; the
        input data is copied now, so the caller may change it at once."""
        if self._async_future is not None:
            raise CekirdeklerError("feed_async_begin called again before feed_async_end")
        snaps = None
        if data is not None:
            datas = _as_list(data)
            if len(datas) != len(self.stages[0].inputs):
                raise ComputeValidationError(
                    f"push data count {len(datas)} != stage-0 inputs "
                    f"{len(self.stages[0].inputs)}")
            snaps = [np.array(_host_of(d)) for d in datas]
        self._async_future = self._pool.submit(self._generation, snaps)

    def feed_async_end(self, results=None) -> bool:
        """Wait for the generation and read the last stage's outputs back.
        True once results are valid."""
        if self._async_future is None:
            raise CekirdeklerError("feed_async_end without feed_async_begin")
        fut, self._async_future = self._async_future, None
        fut.result()
        if results is not None:
            self._results(results)
        self.push_count += 1
        return self.push_count >= len(self.stages)

    def feed_async(self, data=None, results=None) -> bool:
        """``feed_async_begin`` then ``feed_async_end`` (reference: feedAsync)."""
        self.feed_async_begin(data)
        return self.feed_async_end(results)
