"""The port's main path, end to end on host-CPU lanes, against the JAX package.

``ClArray.compute`` through the port's ``NumberCruncher`` on 1, 2 and 4
host lanes, and through the JAX package's ``NumberCruncher`` on as many of
its virtual CPU devices, with the same numpy-seeded inputs: vector-add,
streamAdd and mandelbrot must agree bit for bit; n-body within rtol 1e-5
(XLA:CPU contracts the inner loop's ``acc + d*inv`` into an FMA, the port
rounds the product as the CUDA kernel does under ``-fmad=false``) and
within ±0.01 of the host O(n²) reference, the reference's own check.
Range tables must sum to the global range in multiples of the step, and
selection without a CUDA device must raise instead of falling back.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest

import cekirdekler_tpu
import cekirdekler_tpu_torch as ck
from cekirdekler_tpu import workloads as ref_wl
from cekirdekler_tpu.core import worker as ref_worker
from cekirdekler_tpu.core.cruncher import NumberCruncher as RefCruncher
from cekirdekler_tpu.hardware import all_devices as ref_devices
from cekirdekler_tpu_torch import hardware, workloads as wl
from cekirdekler_tpu_torch.core.balance import prior_split
from cekirdekler_tpu_torch.core.worker import _ladder

VADD_SRC = """
__kernel void vadd(__global float* a, __global float* b, __global float* c) {
    int i = get_global_id(0);
    c[i] = a[i] + b[i];
}
"""
LANES = (1, 2, 4)
ref_ck = SimpleNamespace(NumberCruncher=RefCruncher, ClArray=cekirdekler_tpu.ClArray,
                         TransferFlags=cekirdekler_tpu.TransferFlags)


def _both(lanes: int, src):
    return (ck.NumberCruncher(ck.all_devices().cpus(lanes), src),
            ref_ck.NumberCruncher(ref_devices().subset(lanes), src))


def _check_ranges(cr, cid, total, step):
    ranges = cr.ranges_of(cid)
    assert len(ranges) == cr.num_devices
    assert sum(ranges) == total
    assert all(r >= 0 and r % step == 0 for r in ranges)


@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("name,src", [("vadd", VADD_SRC), ("streamAdd", wl.STREAM_SRC)],
                         ids=["vadd", "streamAdd"])
def test_elementwise_add_matches_reference(name, src, lanes):
    n, step = 4096, 64
    rng = np.random.default_rng(lanes)
    a = rng.uniform(-10, 10, n).astype(np.float32)
    b = rng.uniform(-10, 10, n).astype(np.float32)
    port_cr, ref_cr = _both(lanes, src)
    try:
        outs = []
        for cr, mod in ((port_cr, ck), (ref_cr, ref_ck)):
            xa = mod.ClArray(a.copy(), name="a", partial_read=True, read_only=True)
            xb = mod.ClArray(b.copy(), name="b", partial_read=True, read_only=True)
            xc = mod.ClArray(n, np.float32, name="c", write_only=True)
            for _ in range(3):
                xa.next_param(xb, xc).compute(cr, 11, name, n, step)
                _check_ranges(cr, 11, n, step)
            outs.append(np.asarray(xc).copy())
        np.testing.assert_array_equal(outs[0], outs[1])
        np.testing.assert_array_equal(outs[0], a + b)
    finally:
        port_cr.dispose()
        ref_cr.dispose()


@pytest.mark.parametrize("lanes", LANES)
def test_mandelbrot_matches_reference(lanes):
    w, h, iters = 64, 32, 48
    port = wl.run_mandelbrot(ck.all_devices().cpus(lanes), w, h, iters, iters=2, warmup=1,
                             local_range=64, keep_image=True)
    ref = ref_wl.run_mandelbrot(ref_devices().subset(lanes), w, h, iters, iters=2, warmup=1,
                                local_range=64, keep_image=True)
    np.testing.assert_array_equal(port.image, ref.image)
    np.testing.assert_array_equal(
        port.image.ravel(), wl.mandelbrot_host(w, h, -2.0, -1.25, 2.5 / w, 2.5 / h, iters))
    for ranges in port.ranges_per_iter:
        assert sum(ranges) == w * h and all(r % 64 == 0 for r in ranges)


@pytest.mark.parametrize("lanes", LANES)
def test_nbody_matches_reference(lanes):
    n, step = 256, 64
    rng = np.random.default_rng(42)
    pos = (rng.random((3, n), dtype=np.float32) - 0.5) * 2.0
    vel0 = rng.uniform(-0.1, 0.1, (3, n)).astype(np.float32)
    port_cr, ref_cr = _both(lanes, wl.NBODY_SRC)
    try:
        outs = []
        for cr, mod in ((port_cr, ck), (ref_cr, ref_ck)):
            xyz = [mod.ClArray(pos[k].copy(), name=f"p{k}", read_only=True) for k in range(3)]
            vel = [mod.ClArray(vel0[k].copy(), name=f"v{k}", partial_read=True)
                   for k in range(3)]
            xyz[0].next_param(*xyz[1:], *vel).compute(cr, 12, "nBody", n, step,
                                                      values=(n, 0.001))
            _check_ranges(cr, 12, n, step)
            outs.append([np.asarray(v).copy() for v in vel])
        want = wl.nbody_host_step(*pos, *vel0, 0.001)
        for got, r, host in zip(outs[0], outs[1], want):
            np.testing.assert_allclose(got, r, rtol=1e-5, atol=1e-6)
            assert np.abs(got - host).max() <= 0.01
    finally:
        port_cr.dispose()
        ref_cr.dispose()


def test_run_nbody_and_run_stream_self_checks_pass_on_host_lanes():
    res = wl.run_nbody(ck.all_devices().cpus(2), n=256, iters=2, local_range=64)
    assert res["checked"] and res["host_check_max_err"] <= 0.01
    st = wl.run_stream(ck.all_devices().cpus(2), n=1 << 14, reps=2)
    assert st["n"] == 1 << 14 and st["gb_per_sec"] > 0


def test_write_all_repeat_and_kernel_sequences_match_reference():
    src = """
    __kernel void inc(__global float* a, __global float* total) {
        int i = get_global_id(0);
        a[i] = a[i] + 1.0f;
        total[i] = total[i] + a[i];
    }
    __kernel void scale(__global float* a, __global float* total, float s) {
        int i = get_global_id(0);
        a[i] = a[i] * s;
    }"""
    n, step = 1024, 64
    outs = []
    for mod, devs in ((ck, ck.all_devices().cpus(3)), (ref_ck, ref_devices().subset(3))):
        cr = mod.NumberCruncher(devs, src)
        try:
            cr.repeat_count = 3
            a = mod.ClArray(np.arange(n, dtype=np.float32), name="a")
            t = mod.ClArray(np.zeros(n, np.float32), name="t", partial_read=True)
            a.next_param(t).compute(cr, 13, "inc scale", n, step,
                                    values={"inc": (), "scale": (0.5,)})
            cr.repeat_count = 1
            w = mod.ClArray(np.zeros(n, np.float32), name="w", write_all=True)
            w.next_param(t).compute(cr, 14, "inc", n, step)
            outs.append([np.asarray(x).copy() for x in (a, t, w)])
        finally:
            cr.dispose()
    for got, want in zip(*outs):
        np.testing.assert_array_equal(got, want)


def test_python_kernel_through_compute():
    @ck.kernel
    def axpb(gid, x, a=1.0, b=0.0):
        x[gid.start:gid.stop] = x[gid.start:gid.stop] * a + b
        return (x,)

    x = ck.ClArray(np.arange(512, dtype=np.float32), name="x", partial_read=True)
    with ck.NumberCruncher(ck.all_devices().cpus(2), axpb) as cr:
        x.compute(cr, 15, "axpb", 512, 64, values=(2.0, 1.0))
        _check_ranges(cr, 15, 512, 64)
    np.testing.assert_array_equal(np.asarray(x), np.arange(512, dtype=np.float32) * 2 + 1)


def test_validation_errors_and_error_gate():
    x = ck.ClArray(np.zeros(100, np.float32), name="x")
    with ck.NumberCruncher(ck.all_devices().cpus(1), wl.STREAM_SRC) as cr:
        with pytest.raises(ck.ComputeValidationError, match="divisible"):
            x.compute(cr, 1, "streamAdd", 100, 64)
        with pytest.raises(ck.ComputeValidationError, match="needs >= 128"):
            x.compute(cr, 1, "streamAdd", 128, 64)
        y = ck.ClArray(np.zeros(128, np.float32))
        with pytest.raises(ck.ComputeValidationError, match="not in program"):
            y.compute(cr, 1, "nope", 128, 64)
        with pytest.raises(ck.ComputeValidationError, match="previous error"):
            y.next_param(y, y).compute(cr, 1, "streamAdd", 128, 64)
        cr.reset_errors()
        z = ck.ClArray(np.arange(512, dtype=np.float32))
        with pytest.raises(ck.ComputeValidationError, match="divisible by pipeline_blobs"):
            z.next_param(z, z).compute(cr, 1, "streamAdd", 512, 64, pipeline=True,
                                       pipeline_blobs=3)
        cr.reset_errors()
        z.next_param(z, z).compute(cr, 1, "streamAdd", 512, 64, pipeline=True)
        np.testing.assert_array_equal(z.host(), 2 * np.arange(512, dtype=np.float32))


def test_selection_without_a_card_raises():
    """No CUDA device and no explicit host selection: the entry points
    raise, they never carry on quietly on the CPU."""
    assert len(ck.all_devices()) == 0
    with pytest.raises(ck.DeviceSelectionError):
        ck.NumberCruncher(ck.AcceleratorType.GPU, wl.STREAM_SRC)
    with pytest.raises(ck.DeviceSelectionError):
        ck.devices_for_type(ck.AcceleratorType.TPU | ck.AcceleratorType.ACC)
    with pytest.raises(ck.DeviceSelectionError):
        wl.run_mandelbrot(width=64, height=32, max_iter=8, iters=1, warmup=0)
    with pytest.raises(ck.DeviceSelectionError):
        wl.run_nbody(n=128, iters=1)
    with pytest.raises(ck.DeviceSelectionError):
        ck.NumberCruncher(ck.all_devices().gpus(), wl.STREAM_SRC)
    sel = ck.devices_for_type(ck.AcceleratorType.ALL, cpu_lanes=2)
    assert [d.platform for d in sel] == ["cpu", "cpu"]


def test_host_lane_selection():
    two = ck.all_devices().cpus(2)
    three = two + ck.all_devices().cpus(1)
    assert [d.lane_id for d in three] == [0, 1, 2]
    assert len({d.name for d in three}) == 3
    assert len(three.subset(2)) == 2 and list(three.cpus()) == list(three)
    with pytest.raises(ValueError):
        hardware.cpus(0)


def test_rate_table():
    h100 = "NVIDIA H100 80GB HBM3"
    tf, gb, kind = hardware.device_peaks(h100)
    assert (tf, gb, kind) == (989.0, 3350.0, h100)
    assert hardware.rate_prior(h100) == pytest.approx(3350.0 / 50.0)
    assert hardware.rate_prior("cpu") == 1.0
    assert hardware.rate_prior("some host cpu") == 1.0
    tf2, gb2, kind2 = hardware.device_peaks("NVIDIA Mystery GPU")
    assert (tf2, gb2) == (989.0, 3350.0) and "fallback for NVIDIA Mystery GPU" in kind2
    assert hardware.rate_prior("NVIDIA Mystery GPU") == hardware.rate_prior(h100)
    assert hardware.device_rank(h100) == 0
    assert hardware.device_rank("cpu") > hardware.device_rank(h100)


def test_prior_seeded_first_split_on_a_mixed_fleet():
    """A fleet of unequal lane kinds starts from ``prior_split`` of the
    rate table (here two host lanes posing as a card and a host)."""
    with ck.NumberCruncher(ck.all_devices().cpus(2), wl.STREAM_SRC) as cr:
        cr.cores.lane_kinds = ["NVIDIA H100 80GB HBM3", "cpu"]
        cr.cores.rate_priors = [hardware.rate_prior(k) for k in cr.cores.lane_kinds]
        n = 1 << 16
        a, b, c = (ck.ClArray(np.ones(n, np.float32)) for _ in range(3))
        a.next_param(b, c).compute(cr, 16, "streamAdd", n, 256)
        assert cr.ranges_of(16) == prior_split(n, 256, cr.cores.rate_priors)
        np.testing.assert_array_equal(np.asarray(c), np.full(n, 2.0, np.float32))
        report = cr.performance_report(16).splitlines()
        assert report[0].startswith("compute id 16: total")
        items = [int(line.split("workitems")[0].split()[-1]) for line in report[1:]]
        assert items == cr.ranges_of(16)


@pytest.mark.parametrize("size,step", [(0, 64), (64, 64), (640, 64), (4096, 256), (2304, 256)])
def test_launch_ladder_matches_reference(size, step):
    assert _ladder(size, step) == ref_worker._ladder(size, step)
    assert sum(_ladder(size, step)) == size


def test_transfer_flags_and_arrays_match_reference():
    for kw in ({}, {"partial_read": True}, {"read_only": True}, {"write_only": True},
               {"write_all": True, "zero_copy": True}, {"elements_per_work_item": 3}):
        assert (ck.TransferFlags(**kw).read_write_string()
                == ref_ck.TransferFlags(**kw).read_write_string())
    for bad in ({"read_only": True, "write_only": True}, {"elements_per_work_item": 0},
                {"alignment_bytes": 3000}):
        with pytest.raises(ck.ComputeValidationError):
            ck.TransferFlags(**bad).validate()
    fa = ck.ClArray(1000, np.float64, fast=True)
    assert fa.fast_arr and fa.host().ctypes.data % 4096 == 0 and fa.size == 1000
    fa[3] = 2.5
    fa.fast_arr = False
    assert not fa.fast_arr and fa[3] == 2.5
    fa.resize(10)
    assert fa.size == 10 and fa[3] == 2.5
    with pytest.raises(ck.ComputeValidationError):
        ck.ClArray(16, np.float64, alignment_bytes=4)


class _TimedEvent:
    """A stand-in for a timing CUDA event: ``at`` ms on the device clock."""

    def __init__(self, at: float, done: bool = True):
        self.at, self.done = at, done

    def query(self) -> bool:
        return self.done

    def elapsed_time(self, end: "_TimedEvent") -> float:
        return end.at - self.at


@pytest.mark.parametrize("end", ["complete", "incomplete", "unmarked"])
def test_a_lane_bench_is_its_device_span_once_the_issue_end_is_marked(end):
    """``Worker.end_bench`` takes the device span from the phase's start
    event to the event ``end_issue`` records once that event has completed,
    and the phase's wall otherwise (a host lane marks no span)."""
    import time

    import torch

    from cekirdekler_tpu_torch.core.worker import Worker

    w = Worker(torch.device("cpu"), 0)
    t0 = time.perf_counter()
    w.start_bench(7)
    assert 7 not in w._bench_span
    w.end_issue(7)  # a host lane: no span, no waiting host lanes
    w._bench_span[7] = [_TimedEvent(1000.0),
                        None if end == "unmarked" else _TimedEvent(1002.5, end == "complete")]
    w.end_bench(7)
    wall_ms = (time.perf_counter() - t0) * 1000.0
    assert w.benchmarks[7] == (2.5 if end == "complete" else pytest.approx(wall_ms, abs=wall_ms))
    assert 7 not in w._bench_span


def test_end_issue_lets_the_waiting_host_lanes_start():
    """``Worker.end_issue`` sets the call's ``issued`` event (the host lanes
    of a mixed call wait for it); with no event it does nothing."""
    import threading

    import torch

    from cekirdekler_tpu_torch.core.worker import Worker

    w = Worker(torch.device("cpu"), 0)
    w.end_issue(1)
    w.issued = threading.Event()
    w.start_bench(1)
    w.end_issue(1)
    assert w.issued.is_set()
    w.end_bench(1)


def test_lane_issue_tool_records_gpu_lane_phases_only(monkeypatch):
    """``tools/lane_issue.py``'s wrappers keep a host lane's phases as they
    were (same results, same benches taken) and record GPU-lane phases
    only, so on host lanes the record list stays empty."""
    import torch

    from cekirdekler_tpu_torch.core import worker as wk
    from cekirdekler_tpu_torch.tools import lane_issue

    for name in ("start_bench", "fence", "end_bench"):
        monkeypatch.setattr(wk.Worker, name, getattr(wk.Worker, name))
    records = lane_issue.instrument(wk, torch)
    n = 4096
    a = np.arange(n, dtype=np.float32)
    b = np.ones(n, np.float32)
    ca, cb, cc = (ck.ClArray(x.copy(), name=nm) for x, nm in ((a, "a"), (b, "b"), (b * 0, "c")))
    with ck.NumberCruncher(ck.all_devices().cpus(2), VADD_SRC) as cr:
        ca.next_param(cb, cc).compute(cr, 1, "vadd", n, 256)
        assert all(x > 0.0 for x in cr.benchmarks_of(1))
    np.testing.assert_array_equal(cc.host(), a + b)
    assert records == []
