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
(``tests/test_parallel.py``, T = 16384 over sp = 8).
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field

import numpy as np

from .arrays.clarray import ClArray
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


def mandelbrot_host(width: int, height: int, x0: float, y0: float, dx: float,
                    dy: float, max_iter: int) -> np.ndarray:
    """Host reference implementation (vectorized numpy) for self-checking."""
    px = np.arange(width * height, dtype=np.int64)
    cx = np.float32(x0) + np.float32(dx) * (px % width).astype(np.float32)
    cy = np.float32(y0) + np.float32(dy) * (px // width).astype(np.float32)
    zx = np.zeros_like(cx)
    zy = np.zeros_like(cy)
    it = np.zeros(width * height, dtype=np.int32)
    active = np.ones(width * height, dtype=bool)
    for _ in range(max_iter):
        zx2 = zx * zx
        zy2 = zy * zy
        active = active & (zx2 + zy2 < 4.0)
        if not active.any():
            break
        t = zx2 - zy2 + cx
        zy = np.where(active, 2.0 * zx * zy + cy, zy)
        zx = np.where(active, t, zx)
        it = it + active.astype(np.int32)
    return it.astype(np.float32)


def nbody_host_step(x, y, z, vx, vy, vz, dt: float):
    """Host reference for one nBody velocity update (numpy O(n^2))."""
    xs, ys, zs = (a.astype(np.float64) for a in (x, y, z))
    ddx = xs[None, :] - xs[:, None]
    ddy = ys[None, :] - ys[:, None]
    ddz = zs[None, :] - zs[:, None]
    r2 = ddx * ddx + ddy * ddy + ddz * ddz + 0.0001
    inv = 1.0 / (r2 * np.sqrt(r2))
    vx2 = vx + (ddx * inv).sum(axis=1).astype(np.float32) * dt
    vy2 = vy + (ddy * inv).sum(axis=1).astype(np.float32) * dt
    vz2 = vz + (ddz * inv).sum(axis=1).astype(np.float32) * dt
    return vx2, vy2, vz2


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
    image (the device-throughput view).  Warm-up dispatches are fenced
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
            out.compute(cr, 7001, "mandelbrot", n, local_range, values=vals)
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
            convergence_iters=_converged_at(ranges, local_range),
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


def run_stream(devices: Devices | None = None, n: int = 1 << 20, reps: int = 10,
               local_range: int = 256) -> dict:
    """Streaming ``c = a + b`` (reference: 1M floats, 10 reps), on the plain
    path: the reference's pipelined blobs wait for the pipeline slice."""
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
            group.compute(cr, 7003, "streamAdd", n, local_range)
            times.append((time.perf_counter() - t0) * 1000.0)
        if not np.array_equal(c.host(), a.host() + b.host()):
            raise AssertionError("stream add mismatch")
        best = min(times)
        return {"n": n, "per_rep_ms": times, "gb_per_sec": (3 * 4 * n) / (best / 1000.0) / 1e9}
    finally:
        cr.dispose()
        for arr in (a, b, c):
            arr.dispose()


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
    keeps no activations for a backward."""
    import torch

    from .ops import flash_attention as fa

    if keep not in ("logits", "argmax"):
        raise ValueError(f"keep must be 'logits' or 'argmax', got {keep!r}")
    dev = model.device
    before = (fa.LAUNCHES.count, dict(fa.PLAIN_RUNS.by_key), dict(fa.ROUTES.by_key))
    outputs, seconds, tokens_per_s = [], [], []
    with torch.inference_mode():
        for tokens in batches:
            tokens = torch.as_tensor(tokens, device=dev)
            logits, sec = _timed(dev, lambda: model(tokens))
            seconds.append(sec)
            tokens_per_s.append(tokens.numel() / sec)
            outputs.append(logits if keep == "logits" else logits.argmax(dim=-1))
    plain = {k: v - before[1].get(k, 0) for k, v in fa.PLAIN_RUNS.by_key.items()}
    routes = {k: v - before[2].get(k, 0) for k, v in fa.ROUTES.by_key.items()}
    return {"outputs": outputs, "seconds": seconds, "tokens_per_s": tokens_per_s,
            "device": str(dev),
            "launches": {"flash_attention": fa.LAUNCHES.count - before[0],
                         "plain_flash": {k: v for k, v in plain.items() if v},
                         "routes": {k: v for k, v in routes.items() if v}}}


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
    by device type, and the flash routes."""
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
        losses, seconds = [], []
        for _ in range(steps):
            loss, sec = _timed(dev, lambda: step(batch))
            losses.append(float(loss))
            seconds.append(sec)
    finally:
        model.config = config

    def delta(i: int) -> dict:
        now, (_, was) = counters[i].by_key, before[i]
        return {k: v - was.get(k, 0) for k, v in now.items() if v != was.get(k, 0)}

    return {"losses": losses, "seconds": seconds,
            "tokens_per_s": [n_tokens / sec for sec in seconds], "device": str(dev),
            "launches": {"flash_attention": fa.LAUNCHES.count - before[0][0],
                         "flash_attention_bwd": delta(1), "plain_flash": delta(2),
                         "plain_flash_bwd": delta(3), "routes": delta(4)}}


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
