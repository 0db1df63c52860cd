"""Benchmark/validation workloads: mandelbrot, n-body, streaming vector add,
saxpy as a ``@kernel`` over the elementwise kernel, and the flagship
transformer's forward pass and train step.

Counterpart of the main-path subset of ``cekirdekler_tpu/workloads.py``:
the kernel sources, the host references for self-checking, and the
runners that feed the two BASELINE metrics (Mpixels/s, per iteration with
the image read back or, in enqueue mode, with one readback at the end;
and load-balance convergence iterations).  Runners default to
``all_devices().gpus()`` and raise :class:`DeviceSelectionError` where
there is no CUDA device; host
lanes run only when the caller selects them.  :func:`run_transformer_forward`
is the counterpart of ``__graft_entry__.entry()``'s forward step,
:func:`run_transformer_train` of its dry run's train steps, and
:func:`run_ring_attention` of the reference's long-context ring run
(``tests/test_parallel.py``, T = 16384 over sp = 8).  :func:`measure_rtt`
and :func:`dispatch_floor_sweep` measure what a call costs the host, the
fused-iteration dispatch's reason to be (``tools/dispatch_floor.py``).
:func:`nbody_e2e` is the reference's n-body loop end to end (n = 8192, 150
balanced iterations in enqueue windows).  :func:`measure_stream_overlap`,
:func:`overlap_chunk_sweep` and :func:`duplex_ceiling` measure the streamed
transfers: the overlap they realize against the link's own duplex ceiling,
and the tuner's chunk count against a sweep (``tools/overlap_sweep.py``).
:func:`marker_overhead` is the host cost of queue markers per dispatch.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from dataclasses import dataclass, field

import numpy as np

from .arrays.clarray import ClArray
from .core.cores import PIPELINE_EVENT
from .core.cruncher import NumberCruncher
from .hardware import Devices, all_devices
from .kernel.registry import kernel

__all__ = [
    "MANDELBROT_SRC",
    "NBODY_SRC",
    "STREAM_SRC",
    "mandelbrot_host",
    "nbody_host_step",
    "mandelbrot_cuda_kernel",
    "saxpy_kernel",
    "MandelbrotResult",
    "run_mandelbrot",
    "run_nbody",
    "run_stream",
    "convergence_iterations",
    "run_transformer_forward",
    "run_transformer_train",
    "run_ring_attention",
    "REQUEST_BATCHES",
    "measure_rtt",
    "dispatch_floor_sweep",
    "STREAM_HEAVY_SRC",
    "nbody_e2e",
    "measure_stream_overlap",
    "overlap_chunk_sweep",
    "duplex_ceiling",
    "marker_overhead",
]

# One pixel per work item; escape-iteration count written as float.
MANDELBROT_SRC = """
__kernel void mandelbrot(__global float* out,
                         float x0, float y0, float dx, float dy,
                         int width, int maxIter) {
    int i = get_global_id(0);
    float cx = x0 + dx * (float)(i % width);
    float cy = y0 + dy * (float)(i / width);
    float zx = 0.0f;
    float zy = 0.0f;
    int it = 0;
    while (zx*zx + zy*zy < 4.0f && it < maxIter) {
        float t = zx*zx - zy*zy + cx;
        zy = 2.0f*zx*zy + cy;
        zx = t;
        it++;
    }
    out[i] = (float)it;
}
"""

# Direct O(n^2) gravity step: positions are read whole on every lane;
# velocities are updated only for the lane's own range slice.
NBODY_SRC = """
__kernel void nBody(__global float* x, __global float* y, __global float* z,
                    __global float* vx, __global float* vy, __global float* vz,
                    int n, float dt) {
    int i = get_global_id(0);
    float ax = 0.0f;
    float ay = 0.0f;
    float az = 0.0f;
    float xi = x[i];
    float yi = y[i];
    float zi = z[i];
    for (int j = 0; j < n; j++) {
        float ddx = x[j] - xi;
        float ddy = y[j] - yi;
        float ddz = z[j] - zi;
        float r2 = ddx*ddx + ddy*ddy + ddz*ddz + 0.0001f;
        float inv = 1.0f / (r2 * sqrt(r2));
        ax += ddx * inv;
        ay += ddy * inv;
        az += ddz * inv;
    }
    vx[i] += ax * dt;
    vy[i] += ay * dt;
    vz[i] += az * dt;
}
"""

# Streaming c = a + b.
STREAM_SRC = """
__kernel void streamAdd(__global float* a, __global float* b, __global float* c) {
    int i = get_global_id(0);
    c[i] = a[i] + b[i];
}
"""


# Streaming with a per-element loop: compute commensurate with transfer
# (the overlap measurements' heavy kernel).
STREAM_HEAVY_SRC = """
__kernel void streamHeavy(__global float* a, __global float* b, __global float* c,
                          int iters) {
    int i = get_global_id(0);
    float acc = a[i];
    for (int k = 0; k < iters; k++) {
        acc = acc + b[i] * 0.25f;
    }
    c[i] = acc;
}
"""


def mandelbrot_cuda_kernel():
    """The mandelbrot workload as the hand-written CUDA kernel
    (``ops/mandelbrot.py``) behind a :class:`PythonKernel` of the same
    name — the counterpart of the reference's
    ``mandelbrot_pallas_kernel``.  The kernel writes the chunk's counts in
    place into the lane's whole output buffer, so there is no update pass;
    on a host lane it runs the plain version."""
    from .ops.mandelbrot import mandelbrot as mandel

    @kernel(name="mandelbrot")
    def mandelbrot(gid, out, x0=0.0, y0=0.0, dx=0.0, dy=0.0, width=0, maxIter=0):
        return (mandel(out, gid.start, len(gid), x0, y0, dx, dy, width, maxIter),)

    return mandelbrot


def saxpy_kernel():
    """``y = y + a·x`` over each launch chunk as a :class:`PythonKernel`
    whose body is ``ops.elementwise.saxpy``, written in place into the
    lane's ``y`` buffer: the counterpart of the reference's pattern of a
    Pallas op plugged into ``compute()`` (``mandelbrot_pallas_kernel``).
    ``a`` is folded into the elementwise kernel as a constant; on a host
    lane the plain version runs."""
    from .ops.elementwise import saxpy

    @kernel(name="saxpy")
    def saxpy_k(gid, x, y, a=0.0):
        s = slice(gid.start, gid.stop)
        saxpy(a, x[s], y[s], out=y[s])
        return (x, y)

    return saxpy_k


def _host_parts(n: int, fn) -> None:
    """Run ``fn(lo, hi)`` over ``n`` items in contiguous parts on host
    threads (numpy leaves the interpreter lock in its array loops)."""
    from concurrent.futures import ThreadPoolExecutor

    parts = max(1, min(8, os.cpu_count() or 1, n // 4096))
    bounds = [n * k // parts for k in range(parts + 1)]
    with ThreadPoolExecutor(max_workers=parts) as pool:
        for f in [pool.submit(fn, lo, hi) for lo, hi in zip(bounds, bounds[1:])]:
            f.result()


def mandelbrot_host(width: int, height: int, x0: float, y0: float, dx: float,
                    dy: float, max_iter: int) -> np.ndarray:
    """Host reference implementation (vectorized numpy) for self-checking:
    each pass runs on the pixels still inside the radius only, with the
    kernel's f32 arithmetic per pixel, over parts of the image on host
    threads."""
    it = np.zeros(width * height, dtype=np.int32)

    def part(lo: int, hi: int) -> None:
        px = np.arange(lo, hi, dtype=np.int64)
        cx = np.float32(x0) + np.float32(dx) * (px % width).astype(np.float32)
        cy = np.float32(y0) + np.float32(dy) * (px // width).astype(np.float32)
        live_px, zx, zy = px, np.zeros_like(cx), np.zeros_like(cy)
        for _ in range(max_iter):
            zx2 = zx * zx
            zy2 = zy * zy
            live = zx2 + zy2 < 4.0
            if not live.all():
                live_px, zx, zy, zx2, zy2, cx, cy = (
                    a[live] for a in (live_px, zx, zy, zx2, zy2, cx, cy))
                if live_px.size == 0:
                    break
            t = zx2 - zy2 + cx
            zy = 2.0 * zx * zy + cy
            zx = t
            it[live_px] += 1

    _host_parts(width * height, part)
    return it.astype(np.float32)


def nbody_host_step(x, y, z, vx, vy, vz, dt: float, rows: int = 256):
    """Host reference for one nBody velocity update (numpy O(n^2) in f64),
    ``rows`` bodies at a time on host threads (each body's sum is over all
    bodies, so the blocks change no bit)."""
    xs, ys, zs = (a.astype(np.float64) for a in (x, y, z))
    acc = [np.empty(xs.size, np.float64) for _ in range(3)]

    def part(first: int, last: int) -> None:
        for lo in range(first, last, rows):
            sl = slice(lo, min(lo + rows, last))
            ddx = xs[None, :] - xs[sl, None]
            ddy = ys[None, :] - ys[sl, None]
            ddz = zs[None, :] - zs[sl, None]
            r2 = ddx * ddx + ddy * ddy + ddz * ddz + 0.0001
            inv = 1.0 / (r2 * np.sqrt(r2))
            for a, d in zip(acc, (ddx, ddy, ddz)):
                a[sl] = (d * inv).sum(axis=1)

    _host_parts(xs.size, part)
    return tuple(v + a.astype(np.float32) * dt for v, a in zip((vx, vy, vz), acc))


@dataclass
class MandelbrotResult:
    mpixels_per_sec: float
    per_iter_ms: list[float] = field(default_factory=list)
    ranges_per_iter: list[list[int]] = field(default_factory=list)
    # each lane's measured wall (ms) per call: the balancer's input
    benches_per_iter: list[list[float]] = field(default_factory=list)
    convergence_iters: int | None = None
    image: np.ndarray | None = None


def _default_devices(devices: Devices | None) -> Devices:
    return devices if devices is not None else all_devices().gpus()


def run_mandelbrot(devices: Devices | None = None, width: int = 2048, height: int = 2048,
                   max_iter: int = 256, iters: int = 12, warmup: int = 2,
                   pipeline: bool = False, pipeline_blobs: int = 8,
                   local_range: int = 256, keep_image: bool = False,
                   use_cuda_kernel: bool = False, readback: str = "every",
                   sync_every: int = 1,
                   cruncher: NumberCruncher | None = None) -> MandelbrotResult:
    """Timed, load-balanced mandelbrot over the selected lanes.

    ``use_cuda_kernel`` swaps the kernel-language program for the
    hand-written CUDA kernel (same name, same compute path).
    ``readback="every"`` reads the whole image back in every iteration;
    ``"final"`` runs in enqueue mode: the image stays on the lanes,
    iterations sync to a barrier every ``sync_every`` calls (where the
    balancer may move ranges), and one flush at the end writes the host
    image (the device-throughput view).  ``pipeline`` runs each call through
    the pipelined engine, ``pipeline_blobs`` blobs a lane (the balancer's
    step is then ``local_range * pipeline_blobs``).  Warm-up dispatches are fenced
    outside the timed window.  A caller's ``cruncher`` (built from the
    mandelbrot source) is used as it is and never left in enqueue mode.
    Returns Mpixels/s over the timed iterations, per-iteration walls and
    the balancer's range trajectory (for the convergence metric)."""
    if readback not in ("every", "final"):
        raise ValueError(f"readback must be 'every' or 'final', got {readback!r}")
    own = cruncher is None
    if own:
        source = mandelbrot_cuda_kernel() if use_cuda_kernel else MANDELBROT_SRC
        cruncher = NumberCruncher(_default_devices(devices), source)
    cr = cruncher
    n = width * height
    out = ClArray(n, np.float32, name="mandel_out", read=False, write=True, fast=True)
    vals = (-2.0, -1.25, 2.5 / width, 2.5 / height, width, max_iter)
    per_iter: list[float] = []
    ranges: list[list[int]] = []
    benches: list[list[float]] = []
    final = readback == "final"
    try:
        if final:
            cr.enqueue_mode = True
        for k in range(warmup + iters):
            t0 = time.perf_counter()
            out.compute(cr, 7001, "mandelbrot", n, local_range, pipeline=pipeline,
                        pipeline_blobs=pipeline_blobs, values=vals)
            if final and ((k + 1) % sync_every == 0 or k == warmup + iters - 1):
                cr.barrier()
            dt_ms = (time.perf_counter() - t0) * 1000.0
            ranges.append(cr.ranges_of(7001))
            benches.append(cr.benchmarks_of(7001))
            if k >= warmup:
                per_iter.append(dt_ms)
            elif final and k == warmup - 1:
                cr.barrier()  # warm-up work retires outside the timed window
        if final:
            cr.enqueue_mode = False  # the flush: one readback of the image
        mpix = (n * len(per_iter)) / (sum(per_iter) / 1000.0) / 1e6
        return MandelbrotResult(
            mpixels_per_sec=mpix,
            per_iter_ms=per_iter,
            ranges_per_iter=ranges,
            benches_per_iter=benches,
            convergence_iters=_converged_at(
                ranges, local_range * (pipeline_blobs if pipeline else 1)),
            image=out.host().reshape(height, width).copy() if keep_image else None,
        )
    finally:
        if cr.enqueue_mode:
            cr.enqueue_mode = False
        if own:
            cr.dispose()


def _converged_at(ranges: list[list[int]], step: int) -> int | None:
    """First iteration index after which every later re-balance moves no
    share by more than ``step`` (BASELINE.md convergence metric)."""
    for k in range(1, len(ranges)):
        if all(max(abs(a - b) for a, b in zip(ranges[j], ranges[j - 1])) <= step
               for j in range(k, len(ranges))):
            return k
    return None


def run_nbody(devices: Devices | None = None, n: int = 8192, iters: int = 10,
              dt: float = 0.0001, local_range: int = 256, check: bool = True,
              tolerance: float = 0.01) -> dict:
    """Load-balanced n-body velocity updates; self-checks the first step
    against the host O(n^2) reference within ``tolerance`` (the
    reference's ±0.01f pattern)."""
    rng = np.random.default_rng(42)
    pos = (rng.random((3, n), dtype=np.float32) - 0.5) * 2.0
    x = ClArray(pos[0].copy(), name="x", read_only=True)
    y = ClArray(pos[1].copy(), name="y", read_only=True)
    z = ClArray(pos[2].copy(), name="z", read_only=True)
    vel = [ClArray(n, np.float32, name=f"v{c}", partial_read=True) for c in "xyz"]
    expected = None
    if check:
        zeros = np.zeros(n, np.float32)
        expected = nbody_host_step(pos[0], pos[1], pos[2], zeros, zeros, zeros, dt)
    cr = NumberCruncher(_default_devices(devices), NBODY_SRC)
    group = x.next_param(y, z, *vel)
    times: list[float] = []
    max_err = None
    try:
        for k in range(iters):
            t0 = time.perf_counter()
            group.compute(cr, 7002, "nBody", n, local_range, values=(n, dt))
            times.append((time.perf_counter() - t0) * 1000.0)
            if k == 0 and expected is not None:
                max_err = max(float(np.abs(got.host() - want).max())
                              for got, want in zip(vel, expected))
                if max_err > tolerance:
                    raise AssertionError(f"nBody mismatch: max err {max_err} > {tolerance}")
        pairs_per_sec = n * n * len(times[1:]) / (sum(times[1:]) / 1000.0 + 1e-12)
        return {"n": n, "per_iter_ms": times, "gpairs_per_sec": pairs_per_sec / 1e9,
                "checked": bool(check), "host_check_max_err": max_err}
    finally:
        cr.dispose()


def _nbody_rig(n: int, prefix: str):
    """The n-body arrays from seed 42: positions read whole, velocities
    partial-read (one construction for every n-body run)."""
    rng = np.random.default_rng(42)
    pos = (rng.random((3, n), dtype=np.float32) - 0.5) * 2.0
    xyz = [ClArray(pos[i].copy(), name=f"{prefix}{c}", read_only=True)
           for i, c in enumerate("xyz")]
    vel = [ClArray(n, np.float32, name=f"{prefix}v{c}", partial_read=True) for c in "xyz"]
    return pos, xyz, vel


def nbody_e2e(devices: Devices | None = None, n: int = 8192, iters: int = 150,
              window: int = 50, dt: float = 0.0001, local_range: int = 256,
              tolerance: float = 0.01, attribution: bool = False,
              probe_iters: int | None = None, device_timeline_dir: str | None = None,
              fused: bool = True) -> dict:
    """The reference's n-body loop end to end (``workloads.nbody_e2e``):
    n = 8192, ``iters`` load-balanced iterations through ``compute()`` in
    enqueue windows of ``window`` calls (a barrier each), after a
    synchronous first step checked against the host O(n^2) step within
    ``tolerance``.  The GPUs of ``devices`` (default: every CUDA device)
    are the lanes; a single card is split into 2 partition lanes, so the
    balancer moves shares on one device.  With ``fused`` (the default) the
    fused windows dispatch the repeated calls; three untimed calls warm
    the fused ladder first.  Returns Gpairs/s over the timed loop, its
    wall, the host check's error, the first and last ranges, the
    convergence iteration and the loop's fused-window counts.

    ``attribution=True`` records the timed loop through the span tracer
    and names each factor of the wall with a measurement in the result's
    ``attribution`` key (:func:`_nbody_attribution`): window RTT (the
    barriers' fence spans), ladder launch, upload and download, the
    scheduler's residue inside the enqueue spans, fused dispatch, the
    unattributed host gap, and lane interference (a short single-lane
    probe after the loop: multi-lane per-iteration time x lanes over the
    single lane's; about ``lanes`` on the partition lanes of one card).
    ``device_timeline_dir`` also runs a short separate enqueue window after
    the loop under ``trace.device.DeviceCapture`` and merges its report
    (per-kernel device time, coverage, busy share of the window's wall, a
    roofline row; ``{"absent": reason}`` without a card) as
    ``kernel_profile`` (:func:`_nbody_device_profile`).  The timed loop
    itself never runs under the profiler."""
    devs = _default_devices(devices)
    if len(devs.gpus()):
        devs = devs.gpus()
    lanes = len(devs)
    probe_devs = devs.subset(1)  # not partitioned: the single-lane probe
    single_card_partitions = lanes == 1
    if single_card_partitions:
        devs = devs[0].as_partitions(2)
        lanes = 2
    pos, (x, y, z), vel = _nbody_rig(n, "e")
    zeros = np.zeros(n, np.float32)
    expected = nbody_host_step(pos[0], pos[1], pos[2], zeros, zeros, zeros, dt)
    cid = 7010
    cr = NumberCruncher(devs, NBODY_SRC)
    cr.fused_dispatch = fused
    group = x.next_param(y, z, *vel)
    try:
        group.compute(cr, cid, "nBody", n, local_range, values=(n, dt))
        max_err = max(float(np.abs(got.host() - want).max())
                      for got, want in zip(vel, expected))
        if max_err > tolerance:
            raise AssertionError(f"nBody e2e mismatch: max err {max_err} > {tolerance}")
        if fused:
            # the window engages on the first repeat: call 3 is deferred, and
            # the barrier dispatches it, building the fused ladder untimed
            cr.enqueue_mode = True
            for _ in range(3):
                group.compute(cr, cid, "nBody", n, local_range, values=(n, dt))
            cr.barrier()
        stats0 = {k: cr.fused_stats[k] for k in ("windows", "fused_iters", "deferred_iters")}
        stats0["disengaged"] = dict(cr.fused_stats["disengaged"])
        from .trace.spans import TRACER

        was_tracing = TRACER.enabled
        if attribution and not was_tracing:
            TRACER.enable(clear=True)
        traj: list[list[int]] = []
        cr.enqueue_mode = True
        t0 = time.perf_counter()
        try:
            for k in range(iters):
                group.compute(cr, cid, "nBody", n, local_range, values=(n, dt))
                traj.append(cr.ranges_of(cid))
                if (k + 1) % window == 0:
                    cr.barrier()
            cr.enqueue_mode = False  # the flush
            wall = time.perf_counter() - t0
            t_end = time.perf_counter()
        finally:
            # a failed loop must not leave the global tracer on
            if attribution and not was_tracing:
                TRACER.disable()
        fstats = cr.fused_stats
        out = {
            "n": n, "iters": iters, "lanes": lanes, "window": window,
            "gpairs_per_sec": round(n * n * iters / wall / 1e9, 3),
            "wall_ms": round(wall * 1e3, 1),
            "checked": True,
            "host_check_max_err": round(max_err, 5),
            "ranges_first": traj[0],
            "ranges_final": traj[-1],
            "convergence_iters": _converged_at(traj, local_range),
            "fused": {
                "enabled": bool(fused),
                "windows": fstats["windows"] - stats0["windows"],
                "fused_iters": fstats["fused_iters"] - stats0["fused_iters"],
                "deferred_iters": fstats["deferred_iters"] - stats0["deferred_iters"],
                "disengaged": {k: v - stats0["disengaged"].get(k, 0)
                               for k, v in fstats["disengaged"].items()
                               if v - stats0["disengaged"].get(k, 0) > 0},
            },
        }
        if attribution:
            out["attribution"] = _nbody_attribution(
                TRACER.spans_between(t0, t_end), t0, t_end, wall, iters, lanes, probe_devs,
                n, dt, local_range, window, probe_iters,
                ring_wrapped=TRACER.total_recorded > TRACER.capacity,
                dropped_spans=TRACER.dropped_spans,
                single_chip_partitions=single_card_partitions, fused=fused,
                lane_kinds=list(cr.cores.lane_kinds))
            if device_timeline_dir:
                out["attribution"].update(_nbody_device_profile(
                    cr, group, cid, n, dt, local_range, window, iters, device_timeline_dir))
        return out
    finally:
        if cr.enqueue_mode:
            try:
                cr.enqueue_mode = False
            except Exception:  # noqa: BLE001 - the loop's own error is the one raised
                pass
        cr.dispose()


def _nbody_device_profile(cr, group, cid: int, n: int, dt: float, local_range: int,
                          window: int, iters: int, trace_dir: str) -> dict:
    """The profiled device/host split of :func:`nbody_e2e`, from a short
    separate enqueue window after the timed loop (the loop's wall never
    runs under the profiler).  Returns the keys merged into the
    attribution block; ``kernel_profile`` is ``{"absent": reason}`` where
    the trace holds no kernel record."""
    from .core.stream import plan_signature
    from .trace.device import STORE, DeviceCapture, roofline_row

    probe_iters = max(2, min(iters, window))
    cap = DeviceCapture(trace_dir)
    with cap:
        cr.enqueue_mode = True
        for _ in range(probe_iters):
            group.compute(cr, cid, "nBody", n, local_range, values=(n, dt))
        cr.barrier()
        cr.enqueue_mode = False
    rep = cap.report
    out: dict = {
        "device_events": rep.n_ops,
        "device_busy_ms": round(rep.device_busy_ms, 3),
        "device_busy_frac_of_wall": (
            round(rep.device_busy_ms / rep.wall_ms, 4)
            if rep.wall_ms > 0 and rep.absent is None else None),
        "kernel_profile": (
            {"absent": rep.absent} if rep.absent is not None
            else {**rep.to_dict(), "profiled_iters": probe_iters,
                  "note": ("profiled in a separate short window after the timed loop "
                           "— the headline wall ran unprofiled")}),
    }
    if rep.absent is None:
        # the emitted kernels' records are named ck_kernel: the n-body
        # profile is the one attributed to the nBody launches
        nb_prof = rep.kernel("nBody")
        if nb_prof is not None and nb_prof.device_ms > 0:
            # ~20 operations a pair interaction; 9 array passes of 4 bytes
            # an element an iteration (x, y, z read, vx, vy, vz read and
            # written)
            rl = roofline_row(20.0 * float(n) * float(n) * probe_iters,
                              9.0 * float(n) * 4 * probe_iters, nb_prof.device_ms)
            out["kernel_profile"]["roofline"] = rl
            ranges = [r for r in cr.ranges_of(cid) if r > 0]
            STORE.put("nBody", (n,), (plan_signature(ranges), local_range),
                      {"device_ms": round(nb_prof.device_ms, 3),
                       "op_count": nb_prof.op_count, "launches": nb_prof.launches,
                       "mfu": rl["mfu"], "bound": rl["bound"],
                       "probe_wall_ms": round(rep.wall_ms, 3),
                       "probe_iters": probe_iters, "window": window})
    return out


def _nbody_attribution(spans, t0, t_end, wall, iters, lanes, probe_devs, n, dt,
                       local_range, window, probe_iters, ring_wrapped=False,
                       dropped_spans=0, single_chip_partitions=False, fused=True,
                       lane_kinds=None) -> dict:
    """Name each factor of the nbody_e2e wall with a measurement.  Fractions
    are of the wall and need not sum to 1 (launches and transfers overlap
    device work by design; lane interference is a ratio, not a share)."""
    from .trace.attribution import union_ms, window_report

    rep = window_report(spans, t0, t_end, ring_wrapped=ring_wrapped,
                        dropped_spans=dropped_spans, lane_kinds=lane_kinds)

    def _kind(kind):
        v = rep.per_kind.get(kind, {"ms": 0.0, "count": 0})
        return v["ms"], v["count"]

    def _tagged_fence(tag_prefix):
        sub = window_report(
            [s for s in spans if s.kind == "fence" and (s.tag or "").startswith(tag_prefix)],
            t0, t_end).per_kind.get("fence", {"ms": 0.0, "count": 0})
        return sub["ms"], sub["count"]

    wall_ms = wall * 1000.0
    fence_ms, n_barriers = _tagged_fence("barrier")
    launch_ms, n_launches = _kind("launch")
    upload_ms, n_uploads = _kind("upload")
    download_ms, n_downloads = _kind("download")
    up_chunk_ms, n_up_chunks = _kind("upload-chunk")
    down_chunk_ms, n_down_chunks = _kind("download-chunk")
    fused_ms, n_fused = _kind("fused")
    # the scheduler's residue: each enqueue span's wall less the union of
    # the phases inside it (raw sums double-count concurrent lanes)
    phases = [s for s in spans
              if s.kind in ("launch", "upload", "download", "upload-chunk", "download-chunk")]
    sched_ms = 0.0
    for e in spans:
        if e.kind != "enqueue":
            continue
        inner = [(max(s.t0, e.t0), min(s.t1, e.t1)) for s in phases
                 if s.t1 > e.t0 and s.t0 < e.t1]
        sched_ms += max(e.dur_ms - union_ms(inner), 0.0)

    def factor(ms, count=None):
        d = {"ms": round(ms, 3), "frac": round(ms / wall_ms, 4) if wall_ms else None}
        if count is not None:
            d["count"] = count
        return d

    out = {
        "wall_ms": round(wall_ms, 3),
        "factors": {
            "window_rtt": factor(fence_ms, n_barriers),
            "ladder_launch": factor(launch_ms, n_launches),
            "upload": factor(upload_ms, n_uploads),
            "download_flush": factor(download_ms, n_downloads),
            "upload_chunks": factor(up_chunk_ms, n_up_chunks),
            "download_chunks": factor(down_chunk_ms, n_down_chunks),
            "scheduler_dispatch": factor(sched_ms),
            "fused_dispatch": factor(fused_ms, n_fused),
            "host_gap": factor(rep.gap_ms),
        },
        "per_kind_ms": {k: round(v["ms"], 3) for k, v in rep.per_kind.items()},
        "per_lane_kind_ms": {k: {"ms": round(v["ms"], 3), "count": v["count"],
                                 "lanes": sorted(v["lanes"])}
                             for k, v in rep.per_lane_kind.items()},
        "ring_wrapped": ring_wrapped,
        "dropped_spans": dropped_spans,
        "note": (
            "fracs are of e2e wall and overlap device time by design; "
            "window_rtt = barrier fences (sync cost per enqueue window), "
            "ladder_launch = host-side kernel dispatch, fused_dispatch = "
            "fused-window ladder flushes, host_gap = wall no span "
            "explains; lane_interference is a ratio (1.0 = lanes split "
            "the work perfectly, lanes_count = fully serialized)"
            + ("; FUSED path: iteration work dispatches in batches, so "
               "barrier fences absorb device-drain wait the "
               "per-iteration path hid inside its dispatch stream — "
               "judge window_rtt+ladder_launch+scheduler_dispatch "
               "against wall, not the fence alone" if fused else "")),
    }
    # lane interference: a short single-lane probe on the device before
    # partitioning; perfect scaling gives multi-lane per-iteration time =
    # single-lane per-iteration time / lanes
    p_iters = probe_iters if probe_iters is not None else max(
        window, min(iters // 3, 2 * window))
    try:
        _, (x1, y1, z1), vel1 = _nbody_rig(n, "pe")
        cr1 = NumberCruncher(probe_devs, NBODY_SRC)
        cr1.fused_dispatch = fused
        g1 = x1.next_param(y1, z1, *vel1)
        try:
            g1.compute(cr1, 7011, "nBody", n, local_range, values=(n, dt))
            cr1.enqueue_mode = True
            if fused:
                for _ in range(3):
                    g1.compute(cr1, 7011, "nBody", n, local_range, values=(n, dt))
                cr1.barrier()
            t1 = time.perf_counter()
            for k in range(p_iters):
                g1.compute(cr1, 7011, "nBody", n, local_range, values=(n, dt))
                if (k + 1) % window == 0:
                    cr1.barrier()
            cr1.enqueue_mode = False
            single_wall = time.perf_counter() - t1
        finally:
            if cr1.enqueue_mode:
                cr1.enqueue_mode = False
            cr1.dispose()
        per_iter_multi = wall_ms / iters
        per_iter_single = single_wall * 1000.0 / p_iters
        out["lane_interference"] = {
            "factor": round(per_iter_multi * lanes / max(per_iter_single, 1e-9), 3),
            "per_iter_ms_multi": round(per_iter_multi, 3),
            "per_iter_ms_single_lane": round(per_iter_single, 3),
            "lanes": lanes,
            "probe_iters": p_iters,
            "single_chip_partitions": single_chip_partitions,
        }
        if single_chip_partitions:
            out["lane_interference"]["note"] = (
                f"single-card partition lanes: both runs share one card, "
                f"factor ≈ {lanes} is the expected floor; read the excess "
                f"over {lanes}, not the absolute value")
    except Exception as e:  # noqa: BLE001 - a probe failure must not kill the run
        out["lane_interference"] = {"error": f"{type(e).__name__}: {e}"[:200]}
    return out


def run_stream(devices: Devices | None = None, n: int = 1 << 20, reps: int = 10,
               blobs: int = 8, local_range: int = 256) -> dict:
    """Streaming ``c = a + b`` through the pipelined engine, ``blobs`` blobs
    a lane (reference: Tester.cs:7806-7843, 1M floats, 8 blobs, 10 reps,
    page-locked inputs)."""
    a = ClArray(n, np.float32, name="a", fast=True, partial_read=True, read_only=True)
    b = ClArray(n, np.float32, name="b", fast=True, partial_read=True, read_only=True)
    c = ClArray(n, np.float32, name="c", fast=True, write_only=True)
    a.host()[:] = np.arange(n, dtype=np.float32) % 97
    b.host()[:] = np.arange(n, dtype=np.float32) % 89
    cr = NumberCruncher(_default_devices(devices), STREAM_SRC)
    group = a.next_param(b, c)
    times: list[float] = []
    try:
        for _ in range(reps):
            t0 = time.perf_counter()
            group.compute(cr, 7003, "streamAdd", n, local_range, pipeline=True,
                          pipeline_blobs=blobs)
            times.append((time.perf_counter() - t0) * 1000.0)
        if not np.array_equal(c.host(), a.host() + b.host()):
            raise AssertionError("stream add mismatch")
        best = min(times)
        return {"n": n, "per_rep_ms": times, "gb_per_sec": (3 * 4 * n) / (best / 1000.0) / 1e9}
    finally:
        cr.dispose()
        for arr in (a, b, c):
            arr.dispose()


def measure_rtt(reps: int = 5, device=None) -> float:
    """Best of ``reps`` round trips, in seconds: one tiny op on ``device``
    (default: the first CUDA device) and a 4-byte D2H of its result."""
    import torch

    dev = (torch.device(device) if device is not None
           else _default_devices(None).require_nonempty("a CUDA device")[0].torch_device)
    t = torch.zeros(8, device=dev)
    (t + 1.0)[:1].cpu()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        (t + 1.0)[:1].cpu()
        best = min(best, time.perf_counter() - t0)
    return best


def dispatch_floor_sweep(devices: Devices | None = None, ks=(1, 8, 32, 128),
                         n: int = 1 << 14, local_range: int = 256, reps: int = 3,
                         modes=(False, True)) -> dict:
    """What an enqueued call costs the host, per window size K, per call and
    fused (reference ``workloads.dispatch_floor_sweep``).

    A light kernel (``x[i] + 1``, device work negligible next to a call's
    host cost) runs windows of K enqueued calls and one barrier on the
    first lane of ``devices`` (default: the first CUDA device), after a
    warm window outside the timing.  Per row, the best of ``reps``
    windows: ``per_dispatch_ms`` = (window wall - barrier wall) / K, the
    host cost of one call (the fused rows' barrier holds the dispatch of
    the window's deferred calls, and the fence); ``barrier_ms``;
    ``launches`` (kernel launches counted, ``registry.launch_counts``),
    ``graph_replays`` (``graphs.GRAPHS``), and the fused windows and
    iterations (``fused_stats``) of that window: the evidence of how the
    calls were dispatched.  ``rtt_ms`` is the lane's round trip
    (:func:`measure_rtt`), the least a barrier can cost.  The result is
    checked exact."""
    from .kernel.graphs import GRAPHS
    from .kernel.registry import launch_counts

    src = """
    __kernel void light(__global float* x) {
        int i = get_global_id(0);
        x[i] = x[i] + 1.0f;
    }
    """
    devs = _default_devices(devices).require_nonempty("a CUDA device").subset(1)
    out: dict = {"n": n, "reps": reps, "device": devs[0].torch_device.type,
                 "device_name": devs[0].name,
                 "rtt_ms": measure_rtt(device=devs[0].torch_device) * 1e3, "rows": []}
    for fused in modes:
        cr = NumberCruncher(devs, src)
        cr.fused_dispatch = fused
        x = ClArray(np.zeros(n, np.float32), name="df", partial_read=True)
        calls = 0
        try:
            cr.enqueue_mode = True
            for _ in range(3):  # warm: the per-call and the fused launchers
                x.compute(cr, 551, "light", n, local_range)
            calls += 3
            cr.barrier()
            for K in ks:
                best = None
                for _ in range(max(1, reps)):
                    stats0 = dict(cr.fused_stats)
                    launches0 = sum(launch_counts.values())
                    replays0 = GRAPHS.by_key.get("replay", 0)
                    t0 = time.perf_counter()
                    for _ in range(K):
                        x.compute(cr, 551, "light", n, local_range)
                    t1 = time.perf_counter()
                    cr.barrier()
                    t2 = time.perf_counter()
                    calls += K
                    row = {
                        "fused": bool(fused), "K": K, "wall_ms": (t2 - t0) * 1e3,
                        "barrier_ms": (t2 - t1) * 1e3, "per_dispatch_ms": (t1 - t0) * 1e3 / K,
                        "launches": sum(launch_counts.values()) - launches0,
                        "graph_replays": GRAPHS.by_key.get("replay", 0) - replays0,
                        "fused_windows": cr.fused_stats["windows"] - stats0["windows"],
                        "fused_iters": cr.fused_stats["fused_iters"] - stats0["fused_iters"],
                    }
                    if best is None or row["per_dispatch_ms"] < best["per_dispatch_ms"]:
                        best = row
                out["rows"].append(best)
            cr.enqueue_mode = False
            if not np.array_equal(x.host(), np.full(n, calls, np.float32)):
                raise AssertionError(f"dispatch floor sweep: x is not {calls} everywhere")
        finally:
            if cr.enqueue_mode:
                cr.enqueue_mode = False
            cr.dispose()
    per = {(r["fused"], r["K"]): r["per_dispatch_ms"] for r in out["rows"]}
    k_max = max(ks)
    if (False, k_max) in per and (True, k_max) in per:
        out["floor_collapse_at_kmax"] = per[(False, k_max)] / max(per[(True, k_max)], 1e-9)
    return out


def marker_overhead(n: int = 4096, dispatches: int = 200) -> dict:
    """Per-dispatch host time with queue markers off and on (reference
    ``workloads.marker_overhead``; the reference's C# puts the cost of a
    light kernel's markers at 2-3 -> 150-200 µs, ClNumberCruncher.cs:79).

    A light kernel (a saxpy, ``x`` read only at ``[i]``, so partial reads)
    is called ``dispatches`` times in enqueue mode on the CUDA devices, or
    on one host lane where there is none; only the dispatch loop is timed,
    and one barrier closes each loop.  Per toggle: 8 warm calls and a
    barrier, then the best of 3 loops, per dispatch."""
    src = """
    __kernel void light(__global float* x, __global float* y, float a) {
        int i = get_global_id(0);
        y[i] = a * x[i] + y[i];
    }
    """
    devs = all_devices().gpus()
    if len(devs) == 0:
        devs = all_devices().cpus(1)
    x = ClArray(np.arange(n, dtype=np.float32), name="mx", partial_read=True, read_only=True)
    y = ClArray(n, np.float32, name="my", partial_read=True)
    cr = NumberCruncher(devs, src)
    out: dict = {"dispatches": dispatches}
    try:
        cr.enqueue_mode = True
        for label, markers in (("markers_off", False), ("markers_on", True)):
            cr.fine_grained_queue_control = markers
            for _ in range(8):  # warm: launchers, windows, caches
                x.next_param(y).compute(cr, 501, "light", n, 256, values=(1.0,))
            cr.barrier()
            best = float("inf")
            for _ in range(3):
                t0 = time.perf_counter()
                for _ in range(dispatches):
                    x.next_param(y).compute(cr, 501, "light", n, 256, values=(1.0,))
                dt = (time.perf_counter() - t0) / dispatches
                cr.barrier()
                best = min(best, dt)
            out[label + "_us"] = round(best * 1e6, 1)
            if markers:
                cr.count_markers_remaining()  # the query path, once
        out["marker_cost_us"] = round(out["markers_on_us"] - out["markers_off_us"], 1)
        out["reference_claim_us"] = "light-kernel gap 2-3 -> 150-200 (ClNumberCruncher.cs:79)"
    finally:
        cr.enqueue_mode = False
        cr.dispose()
    return out


def convergence_iterations(devices: Devices | None = None, max_iter: int = 192,
                           width: int = 1024, height: int = 1024) -> int | None:
    """Load-balance convergence on the mandelbrot workload (BASELINE.md:
    'iterations until max share delta < step')."""
    res = run_mandelbrot(devices, width=width, height=height, max_iter=max_iter,
                         iters=16, warmup=0)
    return res.convergence_iters


# (B, T) token batches a transformer smoke run answers: two long-context
# batches, a short one, and T=96, which admits no 128-wide flash tile and so
# takes the dense fallback
REQUEST_BATCHES = ((4, 2048), (8, 1024), (16, 256), (4, 96))


def run_transformer_forward(model, batches, keep: str = "logits") -> dict:
    """Answer token batches with ``model`` (a ``models.Transformer``).

    ``batches`` is a list of ``[B, T]`` int32 token arrays.  ``keep`` is
    ``"logits"`` (f32 ``[B, T, vocab]`` on the model's device) or
    ``"argmax"`` (``[B, T]`` token ids).  Returns the kept outputs, each
    batch's seconds and tokens/s, and the launch counts of the run: flash
    kernel launches, plain flash runs by device type, and the flash
    routes (``tiled`` or the ``dense`` fallback).  On the card a batch is
    timed by CUDA events, on the CPU by the host clock; ``device`` names
    which.  The forwards run under ``torch.inference_mode()``: serving
    keeps no activations for a backward.  Where the model has experts,
    ``experts`` holds each batch's routing (:func:`_experts_summary`)."""
    import torch

    from .ops import flash_attention as fa

    if keep not in ("logits", "argmax"):
        raise ValueError(f"keep must be 'logits' or 'argmax', got {keep!r}")
    dev = model.device
    before = (fa.LAUNCHES.count, dict(fa.PLAIN_RUNS.by_key), dict(fa.ROUTES.by_key))
    outputs, seconds, tokens_per_s, logs = [], [], [], []
    with torch.inference_mode():
        for tokens in batches:
            tokens = torch.as_tensor(tokens, device=dev)
            with _routing(model) as log:
                logits, sec = _timed(dev, lambda: model(tokens))
            logs.append(log)
            seconds.append(sec)
            tokens_per_s.append(tokens.numel() / sec)
            outputs.append(logits if keep == "logits" else logits.argmax(dim=-1))
    plain = {k: v - before[1].get(k, 0) for k, v in fa.PLAIN_RUNS.by_key.items()}
    routes = {k: v - before[2].get(k, 0) for k, v in fa.ROUTES.by_key.items()}
    out = {"outputs": outputs, "seconds": seconds, "tokens_per_s": tokens_per_s,
           "device": str(dev),
           "launches": {"flash_attention": fa.LAUNCHES.count - before[0],
                        "plain_flash": {k: v for k, v in plain.items() if v},
                        "routes": {k: v for k, v in routes.items() if v}}}
    if model.config.n_experts > 0:
        out["experts"] = [_experts_summary(log) for log in logs]
    return out


def _routing(model):
    """``moe.record_routing()`` for a model with experts, else a null log."""
    from .models.moe import record_routing

    return record_routing() if model.config.n_experts > 0 else contextlib.nullcontext()


def _experts_summary(log) -> dict:
    """One run's routing: tokens routed to each expert and tokens dropped,
    summed over the experts layers (a token counts once in each), and each
    layer's routed and kept counts and capacity (None: dense)."""
    return {**log.summary(), "layers": log.counts()}


def _timed(dev, fn):
    """``(fn(), seconds)``: CUDA events on the card, the host clock on the CPU."""
    import torch

    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def run_transformer_train(model, optimizer, batch, steps: int, remat: bool | None = None) -> dict:
    """Take ``steps`` train steps of ``model`` (a ``models.Transformer``) on
    one batch (``{"tokens": [B, T+1]}``) with ``optimizer``, through
    ``model.make_train_step``.

    ``remat`` overrides the model's ``config.remat`` for these steps.
    Returns each step's loss, seconds and tokens/s (B*T over the step's
    time: CUDA events on the card, the host clock on the CPU), and the
    launch counts of the run: forward kernel launches, backward kernel
    launches by kernel (``dq``, ``dkv``), plain forward and backward runs
    by device type, and the flash routes.  Where the model has experts,
    ``experts`` holds each step's routing (:func:`_experts_summary`; a
    remat recompute is not counted again)."""
    from .ops import flash_attention as fa

    dev = model.device
    tokens = batch["tokens"]
    n_tokens = tokens.shape[0] * (tokens.shape[1] - 1)
    counters = (fa.LAUNCHES, fa.BWD_LAUNCHES, fa.PLAIN_RUNS, fa.PLAIN_BWD_RUNS, fa.ROUTES)
    before = [(c.count, dict(c.by_key)) for c in counters]
    config = model.config
    if remat is not None:
        model.config = dataclasses.replace(config, remat=remat)
    try:
        step = model.make_train_step(optimizer)
        losses, seconds, logs = [], [], []
        for _ in range(steps):
            with _routing(model) as log:
                loss, sec = _timed(dev, lambda: step(batch))
            logs.append(log)
            losses.append(float(loss))
            seconds.append(sec)
    finally:
        model.config = config

    def delta(i: int) -> dict:
        now, (_, was) = counters[i].by_key, before[i]
        return {k: v - was.get(k, 0) for k, v in now.items() if v != was.get(k, 0)}

    out = {"losses": losses, "seconds": seconds,
           "tokens_per_s": [n_tokens / sec for sec in seconds], "device": str(dev),
           "launches": {"flash_attention": fa.LAUNCHES.count - before[0][0],
                        "flash_attention_bwd": delta(1), "plain_flash": delta(2),
                        "plain_flash_bwd": delta(3), "routes": delta(4)}}
    if config.n_experts > 0:
        out["experts"] = [_experts_summary(log) for log in logs]
    return out


def run_ring_attention(mesh, B: int, T: int, H: int, D: int, dtype, causal: bool = True,
                       flash: bool = True, grad: bool = True, seed: int = 0) -> dict:
    """Ring attention over the ``sp`` axis of ``mesh`` on seeded q/k/v
    [B, T, H, D] (random normal draws from a CPU ``torch.Generator``,
    cast to ``dtype``, on the axis' first device), through
    ``parallel.ring_attention_sharded``; with ``grad``, the gradients of
    the loss ``sum(out**2)`` (in f32) by ``torch.autograd.grad``.

    The forward and the forward + backward are one run, timed by CUDA
    events on the card (the host clock on the CPU): the forward's time
    ends where its output is ready.  Returns q/k/v, the output, the
    gradients (None without ``grad``), the seconds and tokens/s (B*T over
    the time) of the forward and of the forward + backward, the device,
    and the run's launch counts: parts kernel launches by kernel
    (``fwd``, ``dq``, ``dkv``), those of them on a wholly masked block,
    and plain forward and backward runs by device type."""
    import torch

    from .ops import flash_attention as fa
    from .parallel import ring_attention_sharded

    dev = mesh.axis_devices("sp")[0]
    gen = torch.Generator(device="cpu").manual_seed(seed)
    q, k, v = (torch.randn(B, T, H, D, generator=gen).to(dtype).to(dev).requires_grad_(grad)
               for _ in range(3))
    counters = (fa.PARTS_LAUNCHES, fa.PARTS_DEAD, fa.PLAIN_RUNS, fa.PLAIN_BWD_RUNS)
    before = [dict(c.by_key) for c in counters]
    on_card = dev.type == "cuda"
    if on_card:
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        marks[0].record()
    t0 = time.perf_counter()
    with torch.set_grad_enabled(grad):
        out = ring_attention_sharded(mesh, q, k, v, causal=causal, flash=flash)
    if on_card:
        marks[1].record()
    t1 = time.perf_counter()
    grads = None
    if grad:
        grads = torch.autograd.grad(out.float().pow(2).sum(), (q, k, v))
    if on_card:
        marks[2].record()
        marks[2].synchronize()
        fwd, both = (marks[0].elapsed_time(marks[i]) / 1e3 for i in (1, 2))
    else:
        fwd, both = t1 - t0, time.perf_counter() - t0

    def delta(i: int) -> dict:
        now, was = counters[i].by_key, before[i]
        return {k: v - was.get(k, 0) for k, v in now.items() if v != was.get(k, 0)}

    return {"q": q.detach(), "k": k.detach(), "v": v.detach(), "out": out.detach(),
            "grads": grads, "device": str(dev),
            "seconds": {"forward": fwd, "forward_backward": both if grad else None},
            "tokens_per_s": {"forward": B * T / fwd,
                             "forward_backward": B * T / both if grad else None},
            "launches": {"parts": delta(0), "dead": delta(1), "plain_flash": delta(2),
                         "plain_flash_bwd": delta(3)}}


class _LinkProbe:
    """Fresh payloads of ``n`` floats each way between the host (page-locked
    where CUDA is present) and ``dev``, so no transfer can be skipped, with
    the H2D, D2H and simultaneous (two streams) copies the duplex ceiling
    compares.  Each ``t_*`` returns the copy's host wall in seconds."""

    def __init__(self, dev, n: int):
        import torch

        self.dev = torch.device(dev)
        self.cuda = self.dev.type == "cuda"
        pin = self.cuda
        self.host_src = torch.arange(n, dtype=torch.float32).pin_memory() if pin else \
            torch.arange(n, dtype=torch.float32)
        self.host_dst = torch.empty(n, dtype=torch.float32, pin_memory=pin)
        self.dev_dst = torch.empty(n, dtype=torch.float32, device=self.dev)
        self.base = torch.zeros(n, dtype=torch.float32, device=self.dev)
        self.streams = ((torch.cuda.Stream(self.dev), torch.cuda.Stream(self.dev))
                        if self.cuda else (None, None))
        self.k = 0

    def _sync(self) -> None:
        if self.cuda:
            import torch

            torch.cuda.synchronize(self.dev)

    def _fresh(self):
        self.k += 1
        self.host_src[0] = self.k
        y = self.base + float(self.k)
        self._sync()
        return y

    def _on(self, stream):
        import contextlib

        import torch

        return torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()

    def t_h2d(self) -> float:
        self._fresh()
        t0 = time.perf_counter()
        with self._on(self.streams[0]):
            self.dev_dst.copy_(self.host_src, non_blocking=True)
        self._sync()
        return time.perf_counter() - t0

    def t_d2h(self) -> float:
        y = self._fresh()
        t0 = time.perf_counter()
        with self._on(self.streams[1]):
            self.host_dst.copy_(y, non_blocking=True)
        self._sync()
        return time.perf_counter() - t0

    def t_duplex(self) -> float:
        y = self._fresh()
        t0 = time.perf_counter()
        with self._on(self.streams[0]):
            self.dev_dst.copy_(self.host_src, non_blocking=True)
        with self._on(self.streams[1]):
            self.host_dst.copy_(y, non_blocking=True)
        self._sync()
        return time.perf_counter() - t0


def measure_stream_overlap(devices: Devices | None = None, n: int = 1 << 22, blobs: int = 8,
                           local_range: int = 256, pipeline_type: int = PIPELINE_EVENT,
                           reps: int = 3, heavy_iters: int | str = 0,
                           compute_factor: float = 1.0, duplex_probe: bool = False,
                           streamed: bool = False) -> dict:
    """The read/compute/write overlap a pipelined engine or the streamed
    path realizes on the first lane of ``devices`` (reference
    ``measure_stream_overlap``): ``reps`` interleaved rounds each time a
    read phase (the partition uploads of ``a`` and ``b``, ``blobs``
    slices), a compute phase (the kernel over the resident data), a write
    phase (the D2H of ``c``) and a pipelined ``compute()`` of all three;
    per phase the median.  ``overlap_fraction`` = (r + c + w - p) / (r + c + w -
    max(r, c, w)), raw: 1 is perfect overlap, 0 serial.  ``heavy_iters``
    swaps streamAdd for a kernel looping that many times per element
    (``"auto"`` calibrates it so compute is ``compute_factor`` times read +
    write).  ``duplex_probe`` adds pure H2D, D2H and simultaneous copies
    to every round and reports the per-round overlap ceiling
    (``trace/ceiling.py``).  With ``streamed=False`` (the default) the
    pipelined phase is ``compute(pipeline=True, pipeline_blobs=blobs)`` by
    the engine ``pipeline_type`` names, and the ceiling's
    fill and drain count ``blobs``.  With ``streamed=True`` it is a plain
    ``compute()`` through the stream engine: the duplex probe seeds the
    tuner first, two untimed settle runs (the tuner's measuring run and its
    first chunked run) come before the rounds, and the result adds
    ``transfer_path``, ``stream_chunks`` and ``autotuner_retunes``."""
    devs = _default_devices(devices).require_nonempty("a CUDA device").subset(1)
    kname = "streamHeavy" if heavy_iters else "streamAdd"
    auto_balance = heavy_iters == "auto"
    if auto_balance:
        heavy_iters = 1000  # placeholder until calibrated below
    kvals = (heavy_iters,) if heavy_iters else ()
    cr = NumberCruncher(devs, STREAM_HEAVY_SRC if heavy_iters else STREAM_SRC)
    w = cr.cores.workers[0]
    a = ClArray(n, np.float32, name="ov_a", partial_read=True, read_only=True)
    b = ClArray(n, np.float32, name="ov_b", partial_read=True, read_only=True)
    c = ClArray(n, np.float32, name="ov_c", write_only=True)
    a.host()[:] = np.arange(n, dtype=np.float32) % 97
    b.host()[:] = np.arange(n, dtype=np.float32) % 89
    blob = n // blobs

    def fence() -> None:
        cr.barrier()

    def phase_read() -> None:
        for arr in (a, b):
            w.invalidate(arr)
        with w.on_stream():
            for k in range(blobs):
                for arr in (a, b):
                    w.upload(arr, k * blob, blob, False)

    def compute_at(vals) -> None:
        with w.on_stream():
            w.ensure_resident(c)
            for k in range(blobs):
                w.launch(cr.program, [kname], [a, b, c], vals, k * blob, blob, local_range, n,
                         local_range)

    def phase_write() -> None:
        from .core.worker import Worker

        handles = [w.download_async(c, k * blob, blob, False) for k in range(blobs)]
        for h in handles:
            Worker.finish_download(h)

    def phase_streamed() -> None:
        for arr in (a, b, c):
            w.invalidate(arr)
        a.next_param(b, c).compute(cr, 7004, kname, n, local_range, values=kvals)

    def phase_pipelined() -> None:
        for arr in (a, b, c):
            w.invalidate(arr)
        a.next_param(b, c).compute(cr, 7004, kname, n, local_range, pipeline=True,
                                   pipeline_blobs=blobs, pipeline_type=pipeline_type,
                                   values=kvals)

    phase_pipe = phase_streamed if streamed else phase_pipelined

    def timed(fn, needs_fence: bool, rtt: float) -> float:
        t0 = time.perf_counter()
        fn()
        if needs_fence:
            fence()
        total = (time.perf_counter() - t0) * 1000.0
        if needs_fence:
            total -= rtt
        return max(total, 1e-6)

    def rtt_now() -> float:
        t0 = time.perf_counter()
        fence()
        return (time.perf_counter() - t0) * 1000.0

    try:
        # warm: every path once
        phase_read()
        compute_at(kvals)
        fence()
        phase_write()
        phase_pipe()
        if auto_balance:
            rtt0 = rtt_now()

            def t_read_once() -> float:
                t0 = time.perf_counter()
                phase_read()
                fence()
                return (time.perf_counter() - t0) * 1000.0 - rtt0

            t_r0 = max(min(t_read_once(), t_read_once()), 1e-3)

            def t_compute_at(iters: int) -> float:
                t0 = time.perf_counter()
                compute_at((iters,))
                fence()
                return (time.perf_counter() - t0) * 1000.0 - rtt0

            c1 = min(t_compute_at(2000), t_compute_at(2000))
            c2 = min(t_compute_at(6000), t_compute_at(6000))
            if c2 - c1 <= 0:
                heavy_iters = 30000
            else:
                slope = (c2 - c1) / 4000.0
                intercept = max(c1 - 2000.0 * slope, 0.0)
                # capped so the exactness check's quarter-integer sums stay exact
                heavy_iters = int(min(max((compute_factor * 2.0 * t_r0 - intercept) / slope,
                                          1000), 150_000))
            kvals = (heavy_iters,)
        samples: dict[str, list[float]] = {k: [] for k in
                                           ("r", "c", "w", "p", "rtt", "h2d", "d2h", "dup")}
        probe = None
        if duplex_probe:
            probe = _LinkProbe(devs[0].torch_device, n)

            def probe_duplex(rtt: float, into: dict | None = None) -> None:
                dst = samples if into is None else into
                for key, t in (("h2d", probe.t_h2d), ("d2h", probe.t_d2h),
                               ("dup", probe.t_duplex)):
                    wall = t() * 1000.0
                    dst[key].append(max(wall - rtt, wall * 0.05))

            if streamed:
                # seed the tuner from one probe under the rounds' link weather
                scratch: dict = {"h2d": [], "d2h": [], "dup": []}
                probe_duplex(rtt_now(), into=scratch)
                mib = (4.0 * n) / float(1 << 20)
                cr.transfer_tuner.seed_link(w.index, scratch["h2d"][0] / mib,
                                            scratch["d2h"][0] / mib)
        if streamed:
            # the warm run's measuring run saw the pre-calibration workload
            cr.transfer_tuner.on_repartition()
            retunes0 = cr.transfer_tuner.retunes
            # untimed settle: the measuring run, then the first chunked run
            phase_streamed()
            phase_streamed()
        for _ in range(reps):
            rtt = rtt_now()
            samples["rtt"].append(rtt)
            samples["r"].append(timed(phase_read, True, rtt))
            samples["c"].append(timed(lambda: compute_at(kvals), True, rtt))
            samples["w"].append(timed(phase_write, False, rtt))
            samples["p"].append(timed(phase_pipe, False, rtt))
            if duplex_probe:
                probe_duplex(rtt)

        def med(key: str) -> float:
            vals = sorted(samples[key])
            return vals[len(vals) // 2]

        t_r, t_c, t_w, t_p = med("r"), med("c"), med("w"), med("p")
        serial = t_r + t_c + t_w
        ideal = serial - max(t_r, t_c, t_w)
        overlap = (serial - t_p) / ideal if ideal > 1e-9 else 0.0
        spread = max((max(samples[k]) - min(samples[k])) / max(med(k), 1e-9)
                     for k in ("r", "w", "p"))
        chunks = cr.cores.last_stream_chunks.get(w.index, 1) if streamed else blobs
        ceiling_keys: dict = {}
        if duplex_probe:
            from .trace.ceiling import RepSample, ceiling_report

            reps_full = [RepSample(r=samples["r"][i], c=samples["c"][i], w=samples["w"][i],
                                   p=samples["p"][i], h2d=samples["h2d"][i],
                                   d2h=samples["d2h"][i], dup=samples["dup"][i])
                         for i in range(len(samples["p"])) if i < len(samples["dup"])]
            ceiling_keys = {
                "duplex_h2d_ms": round(med("h2d"), 3),
                "duplex_d2h_ms": round(med("d2h"), 3),
                "duplex_ms": round(med("dup"), 3),
                "compute_transfer_ratio": round(t_c / max(t_r + t_w, 1e-9), 2),
                **ceiling_report(reps_full, max(chunks, 1)),
            }
        if heavy_iters:
            want = a.host() + heavy_iters * 0.25 * b.host()
            np.testing.assert_allclose(c.host(), want, rtol=1e-6)
        else:
            np.testing.assert_allclose(c.host(), a.host() + b.host())
        stream_keys = {"transfer_path": "streamed-ladder", "stream_chunks": chunks,
                       "autotuner_retunes": cr.transfer_tuner.retunes - retunes0} if streamed else {}
        return {
            "t_read_ms": t_r, "t_compute_ms": t_c, "t_write_ms": t_w, "t_pipelined_ms": t_p,
            "t_serial_ms": serial, "rtt_ms": med("rtt"),
            "overlap_fraction": overlap,  # raw
            "sample_spread": spread,
            "n": n, "blobs": blobs, "reps": reps,
            "heavy_iters": int(heavy_iters) if heavy_iters else 0,
            **stream_keys,
            **ceiling_keys,
        }
    finally:
        cr.dispose()


def overlap_chunk_sweep(devices: Devices | None = None,
                        ns: tuple[int, ...] = (1 << 20, 1 << 22),
                        chunk_counts: tuple[int, ...] = (1, 2, 4, 8, 16, 32),
                        local_range: int = 256, reps: int = 3, heavy_iters: int = 400) -> dict:
    """Chunk count x array size sweep of the streamed path on the first lane
    of ``devices`` (reference ``overlap_chunk_sweep``): per size the
    streamed ``compute()``'s median wall with the chunk count pinned at
    each candidate, then the tuner's own choice after the sweep taught it
    the lane, and its wall against the sweep's best
    (``choice_vs_optimum``, 1.0 = the tuner found the measured optimum)."""
    devs = _default_devices(devices).require_nonempty("a CUDA device").subset(1)
    kname = "streamHeavy" if heavy_iters else "streamAdd"
    kvals = (heavy_iters,) if heavy_iters else ()
    bad = [n for n in ns if n < local_range or n % local_range]
    if bad:
        raise ValueError(f"sweep sizes {bad} are not multiples of local_range {local_range} "
                         "— compute() would reject them; pass --local")
    # one chunk (the monolithic path) is always swept
    chunk_counts = tuple(sorted({1, *(int(c) for c in chunk_counts)}))
    sizes_out: list[dict] = []
    for n in ns:
        cr = NumberCruncher(devs, STREAM_HEAVY_SRC if heavy_iters else STREAM_SRC)
        w = cr.cores.workers[0]
        a = ClArray(n, np.float32, name="sw_a", partial_read=True, read_only=True)
        b = ClArray(n, np.float32, name="sw_b", partial_read=True, read_only=True)
        c = ClArray(n, np.float32, name="sw_c", write_only=True)
        a.host()[:] = np.arange(n, dtype=np.float32) % 97
        b.host()[:] = np.arange(n, dtype=np.float32) % 89

        def run_once() -> float:
            for arr in (a, b, c):
                w.invalidate(arr)
            t0 = time.perf_counter()
            a.next_param(b, c).compute(cr, 7104, kname, n, local_range, values=kvals)
            return (time.perf_counter() - t0) * 1000.0

        try:
            rows: list[dict] = []
            max_chunks = max(1, n // local_range)
            for cc in chunk_counts:
                if cc > max_chunks:
                    continue
                cr.stream_chunks = cc
                run_once()  # warm: launchers and the tuner's observation
                rows.append({"chunks": cc,
                             "wall_ms": round(float(np.median([run_once()
                                                                for _ in range(reps)])), 3)})
            best = min(rows, key=lambda r: r["wall_ms"])
            cr.stream_chunks = 0
            run_once()
            auto_wall = float(np.median([run_once() for _ in range(reps)]))
            chosen = cr.cores.last_stream_chunks.get(w.index, 1)
            sizes_out.append({
                "n": n, "mib": round((3 * 4 * n) / float(1 << 20), 1), "rows": rows,
                "sweep_best_chunks": best["chunks"], "sweep_best_ms": best["wall_ms"],
                "autotuner_chunks": chosen, "autotuner_ms": round(auto_wall, 3),
                "choice_vs_optimum": round(auto_wall / max(best["wall_ms"], 1e-9), 3),
            })
        finally:
            cr.dispose()
            for arr in (a, b, c):
                arr.dispose()
    return {"note": ("streamed-path walls (ms, median of reps) per pinned chunk count; "
                     "autotuner row = the count Cores.transfer_tuner chooses after the sweep "
                     "taught it this lane's link"),
            "heavy_iters": heavy_iters, "local_range": local_range, "reps": reps,
            "sizes": sizes_out}


def duplex_ceiling(n: int = 1 << 22, reps: int = 3, device=None) -> dict:
    """The host link's duplex capacity on ``device`` (default: the first
    CUDA device): page-locked H2D and D2H of ``n`` floats at once on two
    streams against each alone, best of ``reps``, RTT subtracted (floored
    at 5% of the wall).  ``ceiling`` = (h2d + d2h - duplex) / (h2d + d2h -
    max(h2d, d2h)): 1.0 both directions at full rate together, 0.0 a
    serial link; the bound an overlap of reads and writes is judged
    against."""
    dev = (device if device is not None
           else _default_devices(None).require_nonempty("a CUDA device")[0].torch_device)
    probe = _LinkProbe(dev, n)
    rtt = measure_rtt(device=dev) if probe.cuda else 0.0

    def sub_rtt(wall: float) -> float:
        return max(wall - rtt, wall * 0.05)

    h2d = min(sub_rtt(probe.t_h2d()) for _ in range(reps))
    d2h = min(sub_rtt(probe.t_d2h()) for _ in range(reps))
    dup = min(sub_rtt(probe.t_duplex()) for _ in range(reps))
    denom = h2d + d2h - max(h2d, d2h)
    ceiling = (h2d + d2h - dup) / denom if denom > 0 else 0.0
    ceiling = min(max(ceiling, 0.0), 1.0)
    gb = n * 4 / 1e9
    return {"h2d_ms": round(h2d * 1e3, 3), "d2h_ms": round(d2h * 1e3, 3),
            "duplex_ms": round(dup * 1e3, 3), "h2d_gbps": round(gb / max(h2d, 1e-9), 3),
            "d2h_gbps": round(gb / max(d2h, 1e-9), 3), "ceiling": round(ceiling, 3),
            "rtt_ms": round(rtt * 1e3, 3), "bytes": n * 4}
