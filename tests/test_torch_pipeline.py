"""The pipelined compute engines and the device pipelines of the port
against the JAX package's, on host-CPU lanes.

Pipelined compute: the reference's ``tests/test_core.py`` scenarios
(``test_vadd_pipelined``, the multi-kernel engines test, the lookahead
depths) and more run through both packages' ``NumberCruncher`` (``Pair`` of
``tests/test_torch_enqueue.py``) on the same inputs, made by numpy from a
seed: both engines, ``pipeline_lookahead`` 1, 2 and 4, ``pipeline_blobs``
2-8, enqueue mode on and off, the transfer flags, ``elements_per_work_item``
2 and a kernel sequence.  Integer-valued kernels must agree bit for bit,
mandelbrot exactly with ``mandelbrot_host``, n-body within 1e-6 of the
largest velocity (XLA:CPU contracts multiply-adds, ROADMAP Queue C reference
state 4), and ``fused_stats`` exactly, the ``pipeline`` reason included.  A
host lane runs each engine's order on its own thread; the GPU lane's streams
are ``tests/test_torch_card.py``'s.

Device pipelines: the scenarios of the reference's ``tests/test_pipeline.py``
through both packages, results and stage counters compared, and the
snapshot handoff the port's in-place launcher needs (a bare alias of the
producer's tensor hands the consumer the next generation).
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest

import cekirdekler_tpu
import cekirdekler_tpu_torch as ck
from cekirdekler_tpu.core.cores import PIPELINE_DRIVER as REF_DRIVER
from cekirdekler_tpu.core.cores import PIPELINE_EVENT as REF_EVENT
from cekirdekler_tpu.hardware import platforms as ref_platforms
from cekirdekler_tpu.metrics.registry import REGISTRY as REF_REGISTRY
from cekirdekler_tpu.pipeline import device_pipeline as ref_dp
from cekirdekler_tpu.workloads import NBODY_SRC as REF_NBODY_SRC
from cekirdekler_tpu.workloads import measure_stream_overlap as ref_overlap
from cekirdekler_tpu_torch import workloads as wl
from cekirdekler_tpu_torch.core import cores as port_cores
from cekirdekler_tpu_torch.errors import ComputeValidationError
from cekirdekler_tpu_torch.metrics.registry import REGISTRY
from cekirdekler_tpu_torch.pipeline import device_pipeline as port_dp
from cekirdekler_tpu_torch.trace.spans import TRACER
from tests.test_torch_enqueue import Pair

VADD = """
__kernel void vadd(__global float* a, __global float* b, __global float* c) {
    int i = get_global_id(0);
    c[i] = a[i] + b[i];
}
__kernel void scale2(__global float* a, __global float* b, __global float* c) {
    int i = get_global_id(0);
    c[i] = c[i] * 2.0f;
}
__kernel void inc(__global float* a) {
    int i = get_global_id(0);
    a[i] = a[i] + 1.0f;
}
__kernel void pairs(__global float* a, __global float* b) {
    int i = get_global_id(0);
    b[2 * i] = a[2 * i] + a[2 * i + 1];
    b[2 * i + 1] = a[2 * i] - a[2 * i + 1];
}
__kernel void rev(__global float* a, __global float* b, int n) {
    int i = get_global_id(0);
    b[i] = a[n - 1 - i];
}
__kernel void total(__global float* a, __global float* s) {
    int i = get_global_id(0);
    if (i == 0) {
        float t = 0.0f;
        for (int k = 0; k < 64; k++) { t = t + a[k]; }
        s[0] = t;
    }
    s[i + 64] = a[i];
}
"""

ENGINES = pytest.mark.parametrize("engine", ["EVENT", "DRIVER"])


def _ptype(engine: str, pkg: str) -> int:
    if pkg == "port":
        return ck.PIPELINE_EVENT if engine == "EVENT" else ck.PIPELINE_DRIVER
    return REF_EVENT if engine == "EVENT" else REF_DRIVER


def _run(pair: Pair, fn) -> dict:
    """``fn(cr, CA, pkg)`` for each package; its results by package."""
    out = {}
    for pkg, (cr, CA) in zip(("port", "ref"), pair.both()):
        out[pkg] = fn(cr, CA, pkg)
    return out


def _equal(out: dict) -> None:
    for a, b in zip(out["port"], out["ref"]):
        np.testing.assert_array_equal(a, b)


def _ab(n: int, seed: int) -> tuple:
    """Integer-valued float inputs: every sum and product below is exact."""
    rng = np.random.default_rng(seed)
    return tuple(rng.integers(-1000, 1000, n).astype(np.float32) for _ in range(2))


def _abc(CA, n: int, seed: int):
    av, bv = _ab(n, seed)
    a = CA(av, name="a", partial_read=True)
    b = CA(bv, name="b", partial_read=True)
    c = CA(np.zeros(n, np.float32), name="c")
    return a, b, c


# -- pipelined compute ----------------------------------------------------------

@ENGINES
@pytest.mark.parametrize("lanes", [1, 3])
@pytest.mark.parametrize("blobs", [2, 8])
@pytest.mark.parametrize("enqueue", [False, True])
def test_pipelined_vadd_equals_the_reference(engine, lanes, blobs, enqueue):
    """The reference's ``test_vadd_pipelined`` on 1 and 3 lanes, 2 and 8
    blobs, per call and in enqueue mode (three calls, then the flush)."""
    n = 64 * blobs * 6
    pair = Pair(VADD, lanes)
    try:
        def run(cr, CA, pkg):
            a, b, c = _abc(CA, n, 1)
            cr.enqueue_mode = enqueue
            for _ in range(3):
                a.next_param(b, c).compute(cr, 1, "vadd", n, 64, pipeline=True,
                                           pipeline_blobs=blobs,
                                           pipeline_type=_ptype(engine, pkg))
            cr.enqueue_mode = False
            assert sum(cr.ranges_of(1)) == n
            assert all(r % (64 * blobs) == 0 for r in cr.ranges_of(1))
            return [np.asarray(c).copy(), np.asarray(a).copy()]

        out = _run(pair, run)
        _equal(out)
        a, b = _ab(n, 1)
        np.testing.assert_array_equal(out["port"][0], a + b)
    finally:
        pair.dispose()


@ENGINES
@pytest.mark.parametrize("enqueue", [False, True])
def test_both_engines_run_a_kernel_sequence_over_many_blobs(engine, enqueue):
    """The reference's ``test_pipeline_engines_multi_blob_multi_kernel``:
    "vadd scale2" over 8 blobs on 2 lanes, partial reads and writes."""
    n = 8192
    pair = Pair(VADD, 2)
    try:
        def run(cr, CA, pkg):
            a, b, c = _abc(CA, n, 2)
            cr.enqueue_mode = enqueue
            a.next_param(b, c).compute(cr, 1, "vadd scale2", n, 64, pipeline=True,
                                       pipeline_blobs=8, pipeline_type=_ptype(engine, pkg))
            cr.enqueue_mode = False
            return [np.asarray(c).copy()]

        out = _run(pair, run)
        _equal(out)
        a, b = _ab(n, 2)
        np.testing.assert_array_equal(out["port"][0], (a + b) * 2)
    finally:
        pair.dispose()


@pytest.mark.parametrize("look", [1, 2, 4])
@pytest.mark.parametrize("enqueue", [False, True])
def test_the_event_engine_is_exact_at_every_lookahead(look, enqueue):
    """The reference's lookahead test: read-only partial inputs, a
    write-only output, ``pipeline_lookahead`` 1, 2 and 4."""
    n = 4096
    src = """
__kernel void sa(__global float* a, __global float* b, __global float* c) {
    int i = get_global_id(0);
    c[i] = a[i] + 2.0f * b[i];
}
"""
    av = np.arange(n, dtype=np.float32)
    bv = np.arange(n, dtype=np.float32) % 13
    pair = Pair(src, 2)
    try:
        def run(cr, CA, pkg):
            cr.pipeline_lookahead = look
            assert cr.pipeline_lookahead == look
            a = CA(av.copy(), name="la", partial_read=True, read_only=True)
            b = CA(bv.copy(), name="lb", partial_read=True, read_only=True)
            c = CA(n, np.float32, name="lc", write_only=True)
            cr.enqueue_mode = enqueue
            a.next_param(b, c).compute(cr, 601 + look, "sa", n, 128, pipeline=True,
                                       pipeline_blobs=8)
            cr.enqueue_mode = False
            return [np.asarray(c).copy()]

        out = _run(pair, run)
        _equal(out)
        np.testing.assert_array_equal(out["port"][0], av + 2.0 * bv)
    finally:
        pair.dispose()


def _flag_case(case: str, CA, seed: int):
    """(kernel, arrays, range, values) of one transfer-flag case."""
    rng = np.random.default_rng(seed)
    n = 2048
    if case == "full-read":      # every lane reads the whole input
        a = CA(rng.integers(0, 100, n).astype(np.float32), name="a")
        return "rev", [a, CA(n, np.float32, name="b")], n, (n,)
    if case == "read-only":
        a = CA(rng.integers(0, 100, n).astype(np.float32), name="a", partial_read=True,
               read_only=True)
        return "inc", [a], n, ()
    if case == "write-all":      # one owning lane reads the whole array back
        a = CA(rng.integers(0, 100, n).astype(np.float32), name="a", partial_read=True)
        s = CA(np.zeros(n + 64, np.float32), name="s", write_all=True)
        return "total", [a, s], n, ()
    # two elements a work item: each lane's range covers twice its items
    a = CA(rng.integers(0, 100, 2 * n).astype(np.float32), name="a", partial_read=True,
           elements_per_work_item=2)
    b = CA(np.zeros(2 * n, np.float32), name="b", elements_per_work_item=2)
    return "pairs", [a, b], n, ()


@ENGINES
@pytest.mark.parametrize("case", ["full-read", "read-only", "write-all", "epw2"])
@pytest.mark.parametrize("enqueue", [False, True])
def test_the_transfer_flags_hold_in_both_engines(engine, case, enqueue):
    pair = Pair(VADD, 2)
    try:
        def run(cr, CA, pkg):
            name, arrays, n, vals = _flag_case(case, CA, 3)
            group = arrays[0].next_param(*arrays[1:]) if len(arrays) > 1 else arrays[0]
            # the split pinned alike in both: what write_all reads back
            # depends on which lane owns the array and what it computed
            cr.normalized_compute_powers_of_devices = [1.0, 1.0]
            cr.enqueue_mode = enqueue
            for _ in range(2):
                group.compute(cr, 5, name, n, 64, pipeline=True, pipeline_blobs=4,
                              pipeline_type=_ptype(engine, pkg), values=vals)
            cr.enqueue_mode = False
            return [np.asarray(x).copy() for x in arrays]

        _equal(_run(pair, run))
    finally:
        pair.dispose()


@ENGINES
def test_repeat_count_and_no_compute_mode_in_both_engines(engine):
    """``repeat_count`` repeats each blob's sequence; ``no_compute_mode``
    moves the data and launches nothing."""
    n = 2048
    pair = Pair(VADD, 2)
    try:
        def run(cr, CA, pkg):
            x = CA(np.zeros(n, np.float32), name="x", partial_read=True)
            cr.repeat_count = 3
            x.compute(cr, 6, "inc", n, 64, pipeline=True, pipeline_blobs=4,
                      pipeline_type=_ptype(engine, pkg))
            cr.repeat_count = 1
            cr.no_compute_mode = True
            x.compute(cr, 6, "inc", n, 64, pipeline=True, pipeline_blobs=4,
                      pipeline_type=_ptype(engine, pkg))
            cr.no_compute_mode = False
            return [np.asarray(x).copy()]

        out = _run(pair, run)
        _equal(out)
        np.testing.assert_array_equal(out["port"][0], np.full(n, 3.0, np.float32))
    finally:
        pair.dispose()


@ENGINES
def test_mandelbrot_through_the_engines_is_exact(engine):
    w = h = 64
    n = w * h
    vals = (-2.0, -1.25, 2.5 / w, 2.5 / h, w, 48)
    pair = Pair(wl.MANDELBROT_SRC, 2)
    try:
        def run(cr, CA, pkg):
            out = CA(n, np.float32, name="m", read=False, write=True)
            out.compute(cr, 31, "mandelbrot", n, 64, pipeline=True, pipeline_blobs=8,
                        pipeline_type=_ptype(engine, pkg), values=vals)
            return [np.asarray(out).copy()]

        out = _run(pair, run)
        _equal(out)
        np.testing.assert_array_equal(out["port"][0],
                                      wl.mandelbrot_host(w, h, *vals[:4], vals[5]))
    finally:
        pair.dispose()


def test_run_mandelbrot_pipelined_equals_the_plain_run():
    """``run_mandelbrot(pipeline=True)``: the image of the plain path."""
    kw = dict(width=64, height=32, max_iter=24, iters=2, warmup=1, local_range=64,
              keep_image=True)
    lanes = ck.all_devices().cpus(2)
    piped = wl.run_mandelbrot(lanes, pipeline=True, pipeline_blobs=4, **kw)
    plain = wl.run_mandelbrot(lanes, **kw)
    np.testing.assert_array_equal(piped.image, plain.image)
    assert all(sum(r) == 64 * 32 and r[0] % 256 == 0 for r in piped.ranges_per_iter)


@ENGINES
def test_nbody_through_the_engines_is_within_1e6_of_the_reference(engine):
    """One n-body step: the positions upload whole, the velocities by blob;
    the port's pipelined velocities equal its plain ones bit for bit."""
    n, dt = 512, 1e-4
    rng = np.random.default_rng(7)
    pos = (rng.random((3, n), dtype=np.float32) - 0.5) * 2.0
    pair = Pair(wl.NBODY_SRC, 2, ref_src=REF_NBODY_SRC)
    try:
        def run(cr, CA, pkg, pipeline=True):
            x, y, z = (CA(pos[k].copy(), name=f"p{k}", read_only=True) for k in range(3))
            vel = [CA(np.zeros(n, np.float32), name=f"v{c}", partial_read=True) for c in "xyz"]
            x.next_param(y, z, *vel).compute(cr, 32, "nBody", n, 64, pipeline=pipeline,
                                             pipeline_blobs=4,
                                             pipeline_type=_ptype(engine, pkg),
                                             values=(n, dt))
            return [np.asarray(v).copy() for v in vel]

        out = _run(pair, run)
        plain = run(pair.port, ck.ClArray, "port", pipeline=False)
    finally:
        pair.dispose()
    for a, b in zip(out["port"], plain):
        np.testing.assert_array_equal(a, b)
    top = max(float(np.abs(v).max()) for v in out["ref"])
    for a, b in zip(out["port"], out["ref"]):
        assert float(np.abs(a - b).max()) <= 1e-6 * top


@ENGINES
def test_a_pipelined_call_breaks_a_fused_window_as_the_reference_does(engine):
    """Enqueue mode, fused windows on: two calls open a window, a third
    defers, then a pipelined call closes it with the reason ``pipeline`` and
    opens none; ``fused_stats`` equal the reference's."""
    n = 1024
    pair = Pair(VADD, 2, fused=True)
    try:
        def run(cr, CA, pkg):
            x = CA(np.zeros(n, np.float32), name="x", partial_read=True)
            cr.enqueue_mode = True
            for _ in range(3):
                x.compute(cr, 1, "inc", n, 64)
            for _ in range(3):
                x.compute(cr, 1, "inc", n, 64, pipeline=True, pipeline_blobs=4,
                          pipeline_type=_ptype(engine, pkg))
            cr.enqueue_mode = False
            return [np.asarray(x).copy()]

        out = _run(pair, run)
        _equal(out)
        np.testing.assert_array_equal(out["port"][0], np.full(n, 6.0, np.float32))
        stats = pair.port.fused_stats
        assert stats == pair.ref.fused_stats
        assert stats["disengaged"].get("pipeline") == 1 and stats["fused_iters"] == 1
    finally:
        pair.dispose()


@ENGINES
def test_a_rebalance_between_pipelined_enqueue_windows_loses_no_update(engine, monkeypatch):
    """Enqueue mode on two lanes whose lane 0 retires late at each barrier
    (the modelled clock of ``tests/test_torch_enqueue.py``): ranges move
    after barriers, by whole blobs, exactly as the reference's, and every
    update lands (the coverage snapshot is taken before any upload)."""
    n = 64 * 4 * 16
    pair = Pair(VADD, 2, monkeypatch)
    pair.lag(lane0=0.25, lane1=0.01)
    try:
        def run(cr, CA, pkg):
            x = CA(np.zeros(n, np.float32), name="x", partial_read=True)
            cr.enqueue_mode = True
            ranges = []
            for k in range(12):
                x.compute(cr, 9, "inc", n, 64, pipeline=True, pipeline_blobs=4,
                          pipeline_type=_ptype(engine, pkg))
                ranges.append(cr.ranges_of(9))
                if k % 4 == 3:
                    cr.barrier()
            cr.enqueue_mode = False
            return [np.asarray(x).copy(), np.asarray(ranges, dtype=np.float32)]

        out = _run(pair, run)
        _equal(out)
        np.testing.assert_array_equal(out["port"][0], np.full(n, 12.0, np.float32))
        assert len({tuple(r) for r in out["port"][1]}) > 1  # the ranges moved
    finally:
        pair.dispose()


def test_a_held_split_the_blob_step_does_not_divide_is_split_afresh():
    """ROADMAP Queue C 13: a split pinned at shares 0.3 / 0.7 holds [320,
    704] at step 64; a pipelined call of 4 blobs has step 256, and a lane's
    blob of 80 or 176 items covers only its whole 64-item steps.  The
    reference keeps the table and skips 256 items (they stay at 1.0); the
    port splits afresh, [256, 768], and every item runs."""
    pair = Pair(VADD, 2)
    try:
        def run(cr, CA, pkg):
            x = CA(np.zeros(1024, np.float32), name="x", partial_read=True)
            cr.normalized_compute_powers_of_devices = [0.3, 0.7]
            x.compute(cr, 1, "inc", 1024, 64)
            held = cr.ranges_of(1)
            x.compute(cr, 1, "inc", 1024, 64, pipeline=True, pipeline_blobs=4)
            return [np.asarray(x).copy(), held, cr.ranges_of(1)]

        out = _run(pair, run)
    finally:
        pair.dispose()
    assert out["port"][1] == out["ref"][1] == [320, 704]
    assert out["port"][2] == [256, 768] and out["ref"][2] == [320, 704]
    np.testing.assert_array_equal(out["port"][0], np.full(1024, 2.0, np.float32))
    assert int((out["ref"][0] == 1.0).sum()) == 256


def test_validation_refuses_what_the_reference_refuses():
    pair = Pair(VADD, 1)
    try:
        for cr, CA in pair.both():
            x = CA(np.zeros(1024, np.float32), name="x")
            with pytest.raises(Exception, match="at least 2 blobs"):
                x.compute(cr, 1, "inc", 1024, 64, pipeline=True, pipeline_blobs=1)
            cr.reset_errors()
            with pytest.raises(Exception, match="divisible by pipeline_blobs"):
                x.compute(cr, 1, "inc", 1024, 64, pipeline=True, pipeline_blobs=3)
            cr.reset_errors()
    finally:
        pair.dispose()
    with ck.NumberCruncher(ck.all_devices().cpus(1), VADD) as cr:
        with pytest.raises(ComputeValidationError, match="at least 2 blobs"):
            ck.ClArray(np.zeros(64, np.float32)).compute(cr, 1, "inc", 64, 64,
                                                         pipeline=True, pipeline_blobs=1)


@ENGINES
def test_each_engine_counts_its_phases_and_records_its_span(engine):
    """``ck_pipeline_stages_total{engine}`` counts a lane phase, as the
    reference's; the port's series also names the lane's device type, and
    a host lane's phase never counts on the ``cuda`` one; each phase
    records a ``pipeline-stage`` span with the reference's tag; no phase
    takes the stream engine."""
    n = 4096
    counter = REGISTRY.counter("ck_pipeline_stages_total", "stage bodies executed",
                               engine=engine, device="cpu")
    card = REGISTRY.counter("ck_pipeline_stages_total", "stage bodies executed",
                            engine=engine, device="cuda")
    ref_counter = REF_REGISTRY.counter("ck_pipeline_stages_total", "stage bodies executed",
                                       engine=engine)
    before = (counter.value, ref_counter.value, card.value)
    port_cores.STREAMED.reset()
    TRACER.enable()
    pair = Pair(VADD, 2)
    try:
        def run(cr, CA, pkg):
            cr.pipeline_lookahead = 1
            a, b, c = _abc(CA, n, 4)
            for _ in range(2):
                a.next_param(b, c).compute(cr, 1, "vadd", n, 64, pipeline=True,
                                           pipeline_blobs=4, pipeline_type=_ptype(engine, pkg))
            return [np.asarray(c).copy()]

        _equal(_run(pair, run))
        spans = [s.tag for s in TRACER.snapshot() if s.kind == "pipeline-stage"]
    finally:
        pair.dispose()
        TRACER.disable()
        TRACER.clear()
    assert counter.value - before[0] == ref_counter.value - before[1] == 4
    assert card.value == before[2]
    assert not port_cores.STREAMED.by_key
    want = "EVENT x4 look1" if engine == "EVENT" else "DRIVER x4"
    assert spans == [want] * 4


@pytest.mark.parametrize("engine", [None, "DRIVER"])
def test_measure_stream_overlap_of_an_engine_returns_the_reference_s_keys(engine):
    devs = ck.all_devices().cpus(1)
    kw = dict(n=1 << 13, reps=2, duplex_probe=True)
    got = wl.measure_stream_overlap(
        devs, **kw, **({} if engine is None else {"pipeline_type": ck.PIPELINE_DRIVER}))
    want = ref_overlap(cekirdekler_tpu.hardware.platforms().cpus().subset(1),
                       pipeline_type=None if engine is None else REF_DRIVER, **kw)
    assert set(got) == set(want)
    assert "transfer_path" not in got and got["blobs"] == 8 and got["t_pipelined_ms"] > 0
    plain = wl.measure_stream_overlap(devs, n=1 << 12, reps=1, heavy_iters=3)
    assert plain["heavy_iters"] == 3 and "duplex_ms" not in plain


# -- device pipelines ------------------------------------------------------------

N = 256
S1 = """
__kernel void addOne(__global float* a, __global float* b) {
    int i = get_global_id(0);
    b[i] = a[i] + 1.0f;
}
"""
S2 = """
__kernel void timesTwo(__global float* a, __global float* b) {
    int i = get_global_id(0);
    b[i] = a[i] * 2.0f;
}
"""
S3 = """
__kernel void addHidden(__global float* a, __global float* h, __global float* b) {
    int i = get_global_id(0);
    b[i] = a[i] + h[i];
}
__kernel void initHidden(__global float* a, __global float* h, __global float* b) {
    int i = get_global_id(0);
    h[i] = 3.0f;
}
"""

PKGS = {"port": (port_dp, ck.ClArray), "ref": (ref_dp, cekirdekler_tpu.ClArray)}


def _lanes(pkg: str, n: int):
    return ck.all_devices().cpus(n) if pkg == "port" else ref_platforms().cpus().subset(n)


def _stage(dp, CA, src, kernels, **kw):
    st = dp.PipelineStage(src, kernels, global_range=N, local_range=64, **kw)
    st.add_input(CA(N, np.float32))
    st.add_output(CA(N, np.float32))
    return st


def _joined(pipe) -> None:
    """``dispose`` stopped the pipeline's threads."""
    for t in list(pipe._pool._threads):
        t.join(timeout=10.0)
        assert not t.is_alive()


def _generations(pipe, gens: int, feed=None) -> list:
    result = np.zeros(N, np.float32)
    outs = []
    feed = feed or pipe.push
    for g in range(gens):
        data = np.full(N, float(g), np.float32)
        if feed(data, result):
            outs.append(result.copy())
    return outs


def scenario_three_stages(pkg):
    dp, CA = PKGS[pkg]
    s1, s2 = _stage(dp, CA, S1, "addOne"), _stage(dp, CA, S2, "timesTwo")
    s3 = dp.PipelineStage(S3, "addHidden", global_range=N, local_range=64,
                          init_kernels="initHidden")
    s3.add_input(CA(N, np.float32))
    s3.add_hidden(CA(N, np.float32))
    s3.add_output(CA(N, np.float32))
    pipe = dp.ClPipeline.make([s1, s2, s3], list(_lanes(pkg, 3)))
    try:
        outs = _generations(pipe, 8)
        assert len(outs) == 6
        return outs, [(j + 1.0) * 2.0 + 3.0 for j in range(len(outs))], pipe
    finally:
        pipe.dispose()


def scenario_single_device(pkg):
    dp, CA = PKGS[pkg]
    pipe = dp.DevicePipeline.make([_stage(dp, CA, S1, "addOne"), _stage(dp, CA, S2, "timesTwo")],
                                  _lanes(pkg, 1)[0])
    try:
        outs = _generations(pipe, 5, pipe.feed)
        return outs, [(j + 1.0) * 2.0 for j in range(len(outs))], pipe
    finally:
        pipe.dispose()


def scenario_feed_async(pkg):
    """The caller changes its data right after ``feed_async_begin``: the
    feed took a copy."""
    dp, CA = PKGS[pkg]
    pipe = dp.DevicePipeline.make([_stage(dp, CA, S1, "addOne"), _stage(dp, CA, S2, "timesTwo")],
                                  _lanes(pkg, 1)[0])
    try:
        result = np.zeros(N, np.float32)
        outs = []
        for g in range(6):
            data = np.full(N, float(g), np.float32)
            pipe.feed_async_begin(data)
            data += 1000.0
            if pipe.feed_async_end(result):
                outs.append(result.copy())
        with pytest.raises(Exception, match="without feed_async_begin"):
            pipe.feed_async_end(result)
        assert pipe.feed_async(np.full(N, 6.0, np.float32), result)
        outs.append(result.copy())
        return outs, [(j + 1.0) * 2.0 for j in range(len(outs))], pipe
    finally:
        pipe.dispose()


def scenario_transition(pkg):
    dp, CA = PKGS[pkg]
    trans = CA(N, np.float32)
    s1 = dp.PipelineStage(S1, "addOne", global_range=N, local_range=64)
    s1.add_input(CA(N, np.float32))
    s1.add_array(trans, dp.ArrayRole.TRANSITION)
    s2 = dp.PipelineStage(S2, "timesTwo", global_range=N, local_range=64)
    s2.add_array(trans, dp.ArrayRole.INPUT)
    s2.add_array(CA(N, np.float32), dp.ArrayRole.OUTPUT)
    pipe = dp.DevicePipeline.make([s1, s2], _lanes(pkg, 1)[0])
    try:
        outs = _generations(pipe, 5, pipe.feed)
        return outs, [(j + 1.0) * 2.0 for j in range(len(outs))], pipe
    finally:
        pipe.dispose()


def scenario_multi_lane_first(pkg):
    dp, CA = PKGS[pkg]
    s1 = dp.PipelineStage(S1, "addOne", global_range=N, local_range=64, devices=_lanes(pkg, 3))
    s1.add_input(CA(N, np.float32, partial_read=True))
    s1.add_output(CA(N, np.float32))
    s2 = _stage(dp, CA, S2, "timesTwo")
    pipe = dp.ClPipeline.make([s1, s2], list(_lanes(pkg, 1)))
    try:
        assert s1._cores is not None and s1._cores.num_devices == 3 and s2._cores is None
        outs = _generations(pipe, 6)
        r = s1._cores.ranges_of(1)
        assert len(r) == 3 and sum(r) == N
        return outs, [(j + 1.0) * 2.0 for j in range(len(outs))], pipe
    finally:
        pipe.dispose()


def scenario_multi_lane_last(pkg):
    dp, CA = PKGS[pkg]
    s1 = _stage(dp, CA, S1, "addOne")
    s2 = dp.PipelineStage(S2, "timesTwo", global_range=N, local_range=64, devices=_lanes(pkg, 2))
    s2.add_input(CA(N, np.float32, partial_read=True))
    s2.add_output(CA(N, np.float32))
    pipe = dp.ClPipeline.make([s1, s2], list(_lanes(pkg, 1)))
    try:
        outs = _generations(pipe, 5)
        return outs, [(j + 1.0) * 2.0 for j in range(len(outs))], pipe
    finally:
        pipe.dispose()


def scenario_multi_to_multi(pkg):
    dp, CA = PKGS[pkg]
    stages = []
    for src, k in ((S1, "addOne"), (S2, "timesTwo")):
        st = dp.PipelineStage(src, k, global_range=N, local_range=64, devices=_lanes(pkg, 2))
        st.add_input(CA(N, np.float32, partial_read=True))
        st.add_output(CA(N, np.float32))
        stages.append(st)
    pipe = dp.ClPipeline.make(stages, [])
    try:
        outs = _generations(pipe, 6)
        return outs, [(j + 1.0) * 2.0 for j in range(len(outs))], pipe
    finally:
        pipe.dispose()


def scenario_empty_devices(pkg):
    dp, CA = PKGS[pkg]
    s1 = dp.PipelineStage(S1, "addOne", global_range=N, local_range=64, devices=[])
    s1.add_input(CA(N, np.float32))
    s1.add_output(CA(N, np.float32))
    pipe = dp.ClPipeline.make([s1], list(_lanes(pkg, 1)))
    try:
        assert s1._cores is None and s1.device is not None
        outs = _generations(pipe, 2)
        return outs[-1:], [2.0], pipe
    finally:
        pipe.dispose()


def scenario_report(pkg):
    dp, CA = PKGS[pkg]
    pipe = dp.ClPipeline.make([_stage(dp, CA, S1, "addOne")], list(_lanes(pkg, 1)))
    try:
        result = np.zeros(N, np.float32)
        pipe.push(np.zeros(N, np.float32), result)
        report = pipe.performance_report()
        assert "stage 0" in report and "addOne" in report
        return [result.copy()], [1.0], pipe
    finally:
        pipe.dispose()


SCENARIOS = {f.__name__[len("scenario_"):]: f for f in (
    scenario_three_stages, scenario_single_device, scenario_feed_async, scenario_transition,
    scenario_multi_lane_first, scenario_multi_lane_last, scenario_multi_to_multi,
    scenario_empty_devices, scenario_report)}


def _stage_counts() -> tuple:
    return tuple(reg.counter("ck_pipeline_stages_total", "stage bodies executed",
                             engine=e).value
                 for reg in (REGISTRY, REF_REGISTRY) for e in ("single", "multi"))


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_pipeline_scenario_equals_the_reference(name):
    """Each scenario's valid generations hold the expected values in both
    packages, and both count the same stage bodies by kind."""
    before = _stage_counts()
    got, want, pipe = SCENARIOS[name]("port")
    _joined(pipe)
    ref, ref_want, _ = SCENARIOS[name]("ref")
    after = _stage_counts()
    assert want == ref_want and len(got) == len(ref) == len(want)
    for out, r, v in zip(got, ref, want):
        np.testing.assert_array_equal(out, np.full(N, v, np.float32))
        np.testing.assert_array_equal(out, r)
    deltas = [b - a for a, b in zip(before, after)]
    assert deltas[:2] == deltas[2:], deltas


def test_a_transition_must_be_bound_on_the_next_stage():
    for dp, CA in PKGS.values():
        s1 = dp.PipelineStage(S1, "addOne", global_range=N, local_range=64)
        s1.add_input(CA(N, np.float32))
        s1.add_array(CA(N, np.float32), dp.ArrayRole.TRANSITION)
        s2 = _stage(dp, CA, S2, "timesTwo")
        lane = ck.all_devices().cpus(1)[0] if dp is port_dp else ref_platforms().cpus()[0]
        with pytest.raises(Exception, match="not bound"):
            dp.DevicePipeline.make([s1, s2], lane)


def _bare_alias(src, v, dst, slot) -> None:
    """The reference's value move, on the port's tensors: the consumer
    holds the producer's own tensor."""
    slot.value = v


@pytest.mark.parametrize("handoff", ["snapshot", "bare-alias"])
def test_the_handoff_is_a_snapshot_the_producer_cannot_overwrite(handoff, monkeypatch):
    """Stage 0 writes its output in place (the port's launcher) while stage
    1 still has to read the last generation: run the stages in order, as
    ``feed_async`` does.  With a bare alias of stage 0's tensor, stage 1
    reads stage 0's next generation, one generation early; the port's
    handoff copies into stage 1's own buffer, and every generation is
    right."""
    if handoff == "bare-alias":
        monkeypatch.setattr(port_dp, "_handoff", _bare_alias)
    pipe = port_dp.DevicePipeline.make(
        [_stage(port_dp, ck.ClArray, S1, "addOne"), _stage(port_dp, ck.ClArray, S2, "timesTwo")],
        ck.all_devices().cpus(1)[0])
    try:
        outs = _generations(pipe, 6, pipe.feed_async)
    finally:
        pipe.dispose()
    _joined(pipe)
    snapshot = [np.full(N, (j + 1.0) * 2.0, np.float32) for j in range(5)]
    if handoff == "snapshot":
        for out, want in zip(outs, snapshot):
            np.testing.assert_array_equal(out, want)
    else:
        assert [float(o[0]) for o in outs] == [(j + 2.0) * 2.0 for j in range(5)]


def test_concurrent_pushes_of_two_pipelines_stay_exact():
    """Two pipelines on host lanes pushed from two threads at once, with a
    short switch interval: each generation is its own pipeline's."""
    import sys

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    errors: list = []
    pipes = []
    try:
        for _ in range(2):
            pipes.append(port_dp.ClPipeline.make(
                [_stage(port_dp, ck.ClArray, S1, "addOne"),
                 _stage(port_dp, ck.ClArray, S2, "timesTwo")],
                list(ck.all_devices().cpus(2))))

        def drive(pipe, base: float) -> None:
            try:
                result = np.zeros(N, np.float32)
                for g in range(20):
                    if pipe.push(np.full(N, base + g, np.float32), result):
                        np.testing.assert_array_equal(
                            result, np.full(N, (base + g - 1 + 1.0) * 2.0, np.float32))
            except Exception as e:  # noqa: BLE001 - asserted below
                errors.append(e)

        threads = [threading.Thread(target=drive, args=(p, 100.0 * k))
                   for k, p in enumerate(pipes)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60.0)
            assert not t.is_alive()
        assert time.perf_counter() - t0 < 60.0
    finally:
        sys.setswitchinterval(interval)
        for p in pipes:
            p.dispose()
    assert not errors, errors


# -- tools/pipeline_trace.py's pure parts ------------------------------------------

@pytest.mark.parametrize("intervals, want_ms", [
    ([], 0.0),
    ([("k", 0.0, 100.0), ("c", 50.0, 300.0)], 0.3),        # overlap counted once
    ([("c", 400.0, 500.0), ("k", 0.0, 100.0)], 0.2),       # a gap, out of order
    ([("k", 0.0, 1000.0), ("c", 100.0, 200.0)], 1.0),      # one inside another
])
def test_pipeline_trace_union_counts_overlaps_once(intervals, want_ms):
    from cekirdekler_tpu_torch.tools import pipeline_trace

    assert pipeline_trace.union_ms(intervals) == pytest.approx(want_ms)


def test_pipeline_trace_host_functions_reads_a_pipelined_call():
    """The cProfile reader over a pipelined call on a host lane: the
    engine's functions under ``_run_pipelined``, once a call."""
    from cekirdekler_tpu_torch.tools import pipeline_trace

    n = 4096
    with ck.NumberCruncher(ck.all_devices().cpus(1), VADD) as cr:
        a, b, c = _abc(ck.ClArray, n, 4)
        out = pipeline_trace.host_functions(
            lambda: a.next_param(b, c).compute(cr, 1, "vadd", n, 64, pipeline=True,
                                               pipeline_blobs=4), 2, 40)
    names = {r["function"].rsplit(":", 1)[1]: r for r in out["by_cum"]}
    assert names["_run_pipelined"]["calls"] == 1.0
    assert names["_event_blobs"]["cum_ms"] <= names["_run_pipelined"]["cum_ms"]
    assert len(out["by_self"]) == 40
