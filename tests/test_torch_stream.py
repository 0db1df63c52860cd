"""Streamed partition transfers of the port (``core/stream.py``,
``Cores._run_streamed``, the ``Worker`` chunk primitives) against the JAX
package's, on host-CPU lanes.

The planning half is pure Python and must make the reference's choices
exactly: ``chunk_plan`` over a grid, and ``TransferTuner`` fed the same
observation sequences (hypothesis-generated) in both packages.  The
execution half runs the reference's ``tests/test_stream.py`` scenarios on
the port with ``stream_chunks`` pinned (on the CPU the tuner rightly keeps
one chunk): streamed outputs equal the monolithic path's bit for bit, plain
and enqueue mode, fused on and off, on one and two lanes, and equal the
reference's bit for bit where both backends round alike (integer-valued
kernels); the reference's XLA CPU rounds mandelbrot and n-body otherwise
than the exact host step (a couple of mandelbrot pixels), so there the
port matches ``mandelbrot_host`` exactly and the reference's n-body
within 1e-6.  The card's side (copy streams, a chunk's D2H beside a
later chunk's kernel in a trace) is ``chip_smoke.py``'s and
``tests/test_torch_card.py``'s.
"""

from __future__ import annotations

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import cekirdekler_tpu
import cekirdekler_tpu_torch as ck
from cekirdekler_tpu.core import stream as ref_stream
from cekirdekler_tpu.core.cruncher import NumberCruncher as RefCruncher
from cekirdekler_tpu.workloads import measure_stream_overlap as ref_overlap
from cekirdekler_tpu_torch import workloads as wl
from cekirdekler_tpu_torch.core import stream
from cekirdekler_tpu_torch.core.cores import STREAMED
from cekirdekler_tpu_torch.errors import NotPortedError
from tests.test_torch_enqueue import Pair

LANES = pytest.mark.parametrize("lanes", [1, 2])
FUSED = pytest.mark.parametrize("fused", [False, True])


# -- planning ------------------------------------------------------------------

def test_constants_are_the_reference_s():
    for name in ("CHUNK_CANDIDATES", "BOOTSTRAP_BYTES", "BOOTSTRAP_CHUNKS", "REMEASURE_AFTER",
                 "PER_CHUNK_OVERHEAD_MS"):
        assert getattr(stream, name) == getattr(ref_stream, name), name


@pytest.mark.parametrize("step", [1, 8, 64, 256])
def test_chunk_plan_equals_the_reference(step):
    for units in list(range(1, 70)) + [127, 128, 255, 1000, 4096]:
        size = units * step
        for target in (0, 1, 2, 3, 4, 5, 8, 16, 33):
            plan = stream.chunk_plan(size, step, target)
            assert plan == ref_stream.chunk_plan(size, step, target), (size, step, target)
            assert stream.plan_signature(plan) == ref_stream.plan_signature(plan)
            off = 0
            for o, s in plan:
                assert o == off and s % step == 0 and ((s // step) & (s // step - 1)) == 0
                off += s
            assert off == size


@pytest.mark.parametrize("size, step", [(100, 64), (0, 64), (64, 0), (65, 64)])
def test_chunk_plan_refuses_what_the_reference_refuses(size, step):
    with pytest.raises(ValueError):
        ref_stream.chunk_plan(size, step, 4)
    with pytest.raises(ValueError):
        stream.chunk_plan(size, step, 4)


_ms = st.floats(min_value=0.0, max_value=200.0, allow_nan=False)
_ops = st.lists(st.one_of(
    st.tuples(st.just("seed"), st.integers(0, 1), _ms, _ms),
    st.tuples(st.just("observe"), st.integers(0, 1), st.sampled_from([("k",), ("k", 2)]),
              st.sampled_from([1 << 10, 3 << 18, 1 << 22, 5 << 22]), _ms, _ms, _ms,
              st.sampled_from([1, 1, 2, 4, 8, 16]), st.one_of(st.none(), _ms), st.booleans()),
    st.tuples(st.just("repartition"), st.one_of(st.none(), st.integers(0, 1))),
    st.tuples(st.just("choose"), st.integers(0, 1), st.sampled_from([("k",), ("k", 2), "flush"]),
              st.sampled_from([1 << 10, 3 << 18, 1 << 22, 5 << 22]), st.integers(1, 64),
              st.booleans()),
), min_size=1, max_size=40)


@settings(max_examples=200, deadline=None)
@given(ops=_ops, overhead=st.sampled_from([0.15, 0.01, 2.0]), ema=st.sampled_from([0.5, 0.25]))
def test_tuner_makes_the_reference_s_choices(ops, overhead, ema):
    """The same observations, seeds, re-partitions and choices into both
    packages' tuners: every choice, estimate and learned overhead equal."""
    port = stream.TransferTuner(overhead_ms=overhead, ema=ema)
    ref = ref_stream.TransferTuner(overhead_ms=overhead, ema=ema)
    for op in ops:
        kind, args = op[0], op[1:]
        if kind == "seed":
            port.seed_link(*args)
            ref.seed_link(*args)
        elif kind == "observe":
            lane, key, nbytes, u, c, d, chunks, wall, fenced = args
            for t in (port, ref):
                t.observe(lane, key, nbytes, u, c, d, chunks=chunks, wall_ms=wall, fenced=fenced)
        elif kind == "repartition":
            port.on_repartition(args[0])
            ref.on_repartition(args[0])
        else:
            lane, key, nbytes, cap, has_compute = args
            assert port.choose(lane, key, nbytes, cap, has_compute) == ref.choose(
                lane, key, nbytes, cap, has_compute)
            assert port.estimate(lane, key, nbytes) == ref.estimate(lane, key, nbytes)
            assert port.has_obs(lane, key, nbytes) == ref.has_obs(lane, key, nbytes)
        for lane in (0, 1):
            assert port.lane_overhead_ms(lane) == ref.lane_overhead_ms(lane)
    assert port.retunes == ref.retunes


# -- execution: streamed == monolithic == reference -----------------------------

def _mandel(CA, cr, n, vals, name):
    out = CA(n, np.float32, name=name, read=False, write=True)
    for _ in range(3):
        out.compute(cr, 81, "mandelbrot", n, 256, values=vals)
    return np.asarray(out).copy()


@LANES
def test_streamed_mandelbrot_image_is_the_monolithic_one(lanes):
    """The reference's ``test_streamed_bit_identical_mandelbrot_image``:
    write-side streaming (a chunk's D2H behind its launch) gives the
    monolithic image bit for bit, and the reference's."""
    w = h = 128
    n = w * h
    vals = (-2.0, -1.25, 2.5 / w, 2.5 / h, w, 64)
    images = {}
    for streamed in (False, True):
        pair = Pair(wl.MANDELBROT_SRC, lanes)
        try:
            for cr, CA in pair.both():
                cr.streamed_transfers = streamed
                cr.stream_chunks = 8 if streamed else 0
                STREAMED.reset()
                images[streamed, cr is pair.port] = _mand = _mandel(CA, cr, n, vals,
                                                                  f"s{streamed}")
                if streamed:
                    assert any(c > 1 for c in cr.cores.last_stream_chunks.values())
                if cr is pair.port:
                    assert (STREAMED.count > 0) == streamed
                    copies = sum(wk.chunk_transfers["d2h", f"s{streamed}"]
                                 for wk in cr.cores.workers)
                    assert copies == (3 * 8 * lanes if streamed else 0)
                    assert [wk.transfers["d2h", f"s{streamed}"] for wk in cr.cores.workers] \
                        == [3] * lanes
                assert _mand.shape == (n,)
        finally:
            pair.dispose()
    want = wl.mandelbrot_host(w, h, *vals[:4], 64)
    np.testing.assert_array_equal(images[False, True], want)
    np.testing.assert_array_equal(images[True, True], want)
    np.testing.assert_array_equal(images[True, False], images[False, False])


def _nbody(pkg_wl, CA, cr, n, iters, prefix):
    rng = np.random.default_rng(42)
    pos = (rng.random((3, n), dtype=np.float32) - 0.5) * 2.0
    xyz = [CA(pos[i].copy(), name=f"{prefix}{c}", read_only=True) for i, c in enumerate("xyz")]
    vel = [CA(n, np.float32, name=f"{prefix}v{c}", partial_read=True) for c in "xyz"]
    g = xyz[0].next_param(xyz[1], xyz[2], *vel)
    cr.enqueue_mode = True
    for _ in range(iters):
        g.compute(cr, 82, "nBody", n, 64, values=(n, 1e-4))
    cr.enqueue_mode = False
    return [np.asarray(v).copy() for v in vel]


@LANES
@FUSED
def test_streamed_accumulating_nbody_is_the_monolithic_one(lanes, fused):
    """The reference's ``test_streamed_bit_identical_accumulating_nbody``:
    enqueue mode, read-side chunks of the partial-read velocities and the
    chunked flush drain, fused on and off: the velocities equal the
    monolithic run's and the reference's bit for bit."""
    n, iters = 512, 6
    results = {}
    for streamed in (False, True):
        pair = Pair(wl.NBODY_SRC, lanes, fused=fused)
        try:
            for cr, CA in pair.both():
                cr.streamed_transfers = streamed
                cr.stream_chunks = 4 if streamed else 0
                results[streamed, cr is pair.port] = _nbody(None, CA, cr, n, iters,
                                                            f"s{int(streamed)}")
                if streamed and cr is pair.port:
                    h2d = sum(wk.chunk_transfers["h2d", "s1vx"] for wk in cr.cores.workers)
                    d2h = sum(wk.chunk_transfers["d2h", "s1vx"] for wk in cr.cores.workers)
                    assert h2d == 4 * lanes and d2h == 4 * lanes
            assert pair.port.fused_stats == pair.ref.fused_stats
        finally:
            pair.dispose()
    for a, b in zip(results[True, True], results[False, True]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(results[True, False], results[False, False]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(results[True, True], results[True, False]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


@LANES
def test_streamed_read_and_write_wavefronts_on_the_plain_path(lanes):
    """A partial-read input and a written output both stream (uploads
    interleaved with the first kernel's chunks, downloads with the
    last's); a two-kernel sequence runs the middle over the whole range;
    results equal the monolithic run's and the reference's."""
    src = """
    __kernel void tri(__global float* a, __global float* o) {
        int i = get_global_id(0);
        o[i] = a[i] * 3.0f;
    }
    __kernel void inc2(__global float* a, __global float* o) {
        int i = get_global_id(0);
        o[i] = o[i] + 1.0f;
    }"""
    n = 4096
    outs = {}
    for streamed in (False, True):
        pair = Pair(src, lanes)
        try:
            for cr, CA in pair.both():
                cr.streamed_transfers = streamed
                cr.stream_chunks = 4 if streamed else 0
                a = CA(np.arange(n, dtype=np.float32), name="ta", partial_read=True,
                       read_only=True)
                o = CA(n, np.float32, name="to", write_only=True)
                for names in (["tri"], ["tri", "inc2"], ["tri", "inc2", "inc2"]):
                    a.next_param(o).compute(cr, 83, names, n, 64)
                    outs[streamed, cr is pair.port, len(names)] = np.asarray(o).copy()
        finally:
            pair.dispose()
    for k in (1, 2, 3):
        want = np.arange(n, dtype=np.float32) * 3.0 + (k - 1)
        for streamed in (False, True):
            for port in (False, True):
                np.testing.assert_array_equal(outs[streamed, port, k], want)


ACC = """
__kernel void acc(__global float* b, __global float* a) {
    int i = get_global_id(0);
    a[i] = a[i] * 2.0f + b[i] - 3.0f;
}
"""


@LANES
@FUSED
def test_streamed_enqueue_equals_the_reference_bit_for_bit(lanes, fused):
    """Integer-valued arithmetic, which both backends round alike: enqueued
    calls with a barrier in the middle (so a rebalance may re-split and
    re-upload), streamed at 4 chunks, give the monolithic run's values and
    the reference's, bit for bit, with equal ``fused_stats``."""
    n = 4096
    outs = {}
    for streamed in (False, True):
        pair = Pair(ACC, lanes, fused=fused)
        try:
            for cr, CA in pair.both():
                cr.streamed_transfers = streamed
                cr.stream_chunks = 4 if streamed else 0
                b = CA((np.arange(n) % 7).astype(np.float32), name="b", read_only=True,
                       partial_read=True)
                a = CA((np.arange(n) % 5).astype(np.float32), name="a", partial_read=True)
                cr.enqueue_mode = True
                for k in range(8):
                    b.next_param(a).compute(cr, 14, "acc", n, 64)
                    if k == 3:
                        cr.barrier()
                cr.enqueue_mode = False
                outs[streamed, cr is pair.port] = np.asarray(a).copy()
            assert pair.port.fused_stats == pair.ref.fused_stats
        finally:
            pair.dispose()
    want = (np.arange(n) % 5).astype(np.float32)
    for _ in range(8):
        want = want * 2.0 + (np.arange(n) % 7) - 3.0
    for got in outs.values():
        np.testing.assert_array_equal(got, want.astype(np.float32))


def test_the_tuner_measures_then_engages_then_remeasures_after_a_repartition():
    """The reference's ``test_streamed_autotune_defaults_to_measuring_run_then_engages``
    on the port: call 1 warms the key and teaches nothing, call 2 is the
    monolithic measuring run; taught an expensive link, call 3 streams; a
    re-partition sends call 4 back to a measuring run."""
    src = """
    __kernel void cp(__global float* a, __global float* o) {
        int i = get_global_id(0);
        o[i] = a[i] + 1.0f;
    }"""
    n = 1 << 16
    with ck.NumberCruncher(ck.all_devices().cpus(1), src) as cr:
        t = cr.transfer_tuner
        t.seed_link(0, 50.0, 50.0)
        a = ck.ClArray(np.zeros(n, np.float32), name="ca", partial_read=True, read_only=True)
        o = ck.ClArray(n, np.float32, name="co", write_only=True)
        g = a.next_param(o)
        key = (("cp",), ())
        g.compute(cr, 84, "cp", n, 64)
        assert cr.cores.last_stream_chunks.get(0) == 1
        assert not t.has_obs(0, key, 8 * n)  # the key's first call warms it
        g.compute(cr, 84, "cp", n, 64)
        assert cr.cores.last_stream_chunks.get(0) == 1
        assert t.has_obs(0, key, 8 * n)  # the measuring run taught it
        t.observe(0, key, 8 * n, 40.0, 1.0, 40.0, chunks=1, fenced=True)
        g.compute(cr, 84, "cp", n, 64)
        assert cr.cores.last_stream_chunks.get(0, 1) > 1
        before = t.retunes
        t.on_repartition()
        assert t.retunes == before + 1
        g.compute(cr, 84, "cp", n, 64)
        assert cr.cores.last_stream_chunks.get(0) == 1
        np.testing.assert_array_equal(o.host(), 1.0)


def test_a_moved_split_retunes_the_tuner():
    pair = Pair("__kernel void f(__global float* a){ int i=get_global_id(0); a[i]+=1.0f; }", 2)
    try:
        for cr, CA in pair.both():
            x = CA(np.zeros(4096, np.float32), name="x")
            x.partial_read = True
            x.compute(cr, 3, "f", 4096, 64)
            x.compute(cr, 3, "f", 4096, 64)
            before = cr.transfer_tuner.retunes
            # pinned shares and a stale table: the next call re-splits, many steps away
            cr.normalized_compute_powers_of_devices = [1, 3]
            cr.cores.global_ranges[3] = [2048, 2047]
            x.compute(cr, 3, "f", 4096, 64)
            assert cr.ranges_of(3) == [1024, 3072]
            assert cr.transfer_tuner.retunes == before + 1
            x.compute(cr, 3, "f", 4096, 64)  # held: no retune
            assert cr.transfer_tuner.retunes == before + 1
            np.testing.assert_array_equal(np.asarray(x), 4.0)
    finally:
        pair.dispose()


def test_tuner_key_matches_between_choose_and_observe():
    """The reference's regression: one byte formula for ``choose`` and
    ``observe`` (a read+write partition array counts twice), and dict
    values key on their items."""
    src = """
    __kernel void bump(__global float* a) {
        int i = get_global_id(0);
        a[i] = a[i] + 1.0f;
    }"""
    n = 1 << 14
    with ck.NumberCruncher(ck.all_devices().cpus(1), src) as cr:
        t = cr.transfer_tuner
        a = ck.ClArray(np.zeros(n, np.float32), name="rw", partial_read=True)
        a.compute(cr, 85, "bump", n, 64)  # warms the key
        assert not t._obs
        a.compute(cr, 85, "bump", n, 64)  # the measuring run
        w = cr.cores.workers[0]
        expect = cr.cores._stream_key_bytes(w, [a], 0, n, True)
        assert expect == 2 * n * 4
        kk = cr.cores._tuner_kernel_key(("bump",), ())
        assert list(t._obs) == [(0, kk, t.bytes_bucket(expect))]
        k1 = cr.cores._tuner_kernel_key(("bump",), {"bump": (1000,)})
        k2 = cr.cores._tuner_kernel_key(("bump",), {"bump": (10,)})
        assert k1 != k2
        assert cr.cores._tuner_kernel_key(("bump",), {"bump": np.zeros(4)}) == (("bump",), None)
        np.testing.assert_array_equal(a.host(), 2.0)


def test_an_enqueued_measuring_run_teaches_the_tuner_without_a_fence(monkeypatch):
    """In enqueue mode the measuring run (a key's second contact, after
    the call that warms it) is timed where its work runs (a host lane's
    thread): no call waits, and the tuner holds the key's observation
    after the barrier."""
    src = "__kernel void f(__global float* x, __global float* y){ int i=get_global_id(0); " \
          "y[i] = x[i] + 1.0f; }"
    with ck.NumberCruncher(ck.all_devices().cpus(1), src) as cr:
        w = cr.cores.workers[0]
        fences = []
        orig = w.fence
        monkeypatch.setattr(w, "fence", lambda: (fences.append(1), orig()))
        y = ck.ClArray(1 << 14, np.float32, name="y", write_only=True)
        cr.enqueue_mode = True
        for _ in range(2):  # a new x each call: each call uploads
            x = ck.ClArray(np.ones(1 << 14, np.float32), name="x", partial_read=True,
                           read_only=True)
            x.next_param(y).compute(cr, 4, "f", 1 << 14, 64)
        assert fences == []
        cr.barrier()
        assert cr.transfer_tuner.has_obs(0, (("f",), ()), 4 << 14)
        cr.enqueue_mode = False
        np.testing.assert_array_equal(y.host(), 2.0)


def test_flush_drain_feeds_transfer_benchmarks_and_chunks():
    """The reference's ``test_flush_drain_feeds_transfer_benchmarks``: the
    flush drain times each lane's D2H per iteration into
    ``transfer_benchmarks``, zero-transfer phases do not clobber it; with
    ``stream_chunks`` pinned the drain reads each record in chunks, one
    transfer each."""
    src = "__kernel void put(__global float* a){ int i=get_global_id(0); a[i]=a[i]+2.0f; }"
    n = 1 << 14
    pair = Pair(src, 2)
    try:
        for cr, CA in pair.both():
            cr.stream_chunks = 4
            a = CA(np.zeros(n, np.float32), name="fa")
            a.partial_read = True
            cr.enqueue_mode = True
            for _ in range(3):
                a.compute(cr, 86, "put", n, 64)
            assert cr.cores._flush_iters.get(86) == 3
            cr.enqueue_mode = False
            assert cr.cores._flush_iters == {}
            for w in cr.cores.workers[:2]:
                assert w.transfer_benchmarks.get(86, 0.0) > 0.0
            cr.enqueue_mode = True
            for _ in range(2):
                a.compute(cr, 86, "put", n, 64)
            for w in cr.cores.workers[:2]:
                assert w.transfer_benchmarks.get(86, 0.0) > 0.0
            cr.enqueue_mode = False
            np.testing.assert_array_equal(np.asarray(a), 10.0)
        for w in pair.port.cores.workers:
            assert w.transfers["d2h", "fa"] == 2
            assert w.chunk_transfers["d2h", "fa"] == 2 * 4  # two drains of 4 chunks
    finally:
        pair.dispose()


def test_streaming_is_refused_by_the_reference_s_rules():
    """No chunk runs with streamed transfers off, in ``no_compute_mode``,
    with ``repeat_count`` > 1, under one step of range, or with nothing
    partial to move; ``last_stream_chunks`` shows a candidate's count."""
    src = "__kernel void f(__global float* a){ int i=get_global_id(0); a[i]+=1.0f; }"
    with ck.NumberCruncher(ck.all_devices().cpus(1), src) as cr:
        cr.stream_chunks = 4
        x = ck.ClArray(np.zeros(4096, np.float32), name="x", partial_read=True)
        # read whole and never read back: nothing partial to move
        whole = ck.ClArray(np.zeros(4096, np.float32), name="w", read_only=True)
        for setup, arr, rng in (
                (lambda: setattr(cr, "streamed_transfers", False), x, 4096),
                (lambda: setattr(cr, "no_compute_mode", True), x, 4096),
                (lambda: setattr(cr, "repeat_count", 3), x, 4096),
                (lambda: None, x, 64),
                (lambda: None, whole, 4096)):
            cr.streamed_transfers, cr.no_compute_mode, cr.repeat_count = True, False, 1
            setup()
            STREAMED.reset()
            arr.compute(cr, 9, "f", rng, 64)
            assert STREAMED.count == 0
        cr.streamed_transfers, cr.no_compute_mode, cr.repeat_count = True, False, 1
        x.compute(cr, 9, "f", 4096, 64)
        assert STREAMED.count == 1 and cr.cores.last_stream_chunks[0] == 4
        config = cr.cores._lane_config()  # the reference's report of the lanes
        assert config["streamed_transfers"] and config["stream_chunks"] == {0: 4}
        assert config["ranges"] == {"9": [4096]} and config["devices"] == ["cpu #0"]
        # 1 (streaming off) + 0 (no compute) + 3 (repeats) + 1 (first 64 only) + 1
        np.testing.assert_array_equal(x.host()[:64], 6.0)
        np.testing.assert_array_equal(x.host()[64:], 5.0)


def test_the_cruncher_toggles_read_the_reference_s_defaults():
    with ck.NumberCruncher(ck.all_devices().cpus(1), "__kernel void f(__global float* a){}") as cr:
        ref = RefCruncher(cekirdekler_tpu.hardware.platforms().cpus().subset(1),
                          "__kernel void f(__global float* a){}")
        try:
            for name in ("streamed_transfers", "stream_chunks", "stream_queue_depth",
                         "no_compute_mode", "performance_feed", "smooth_load_balancer",
                         "adaptive_load_balancer", "normalized_compute_powers_of_devices"):
                assert getattr(cr, name) == getattr(ref, name), name
            cr.stream_chunks, ref.stream_chunks = -3, -3
            cr.stream_queue_depth, ref.stream_queue_depth = 0, 0
            assert (cr.stream_chunks, cr.stream_queue_depth) == (
                ref.stream_chunks, ref.stream_queue_depth) == (0, 1)
            assert isinstance(cr.transfer_tuner, stream.TransferTuner)
        finally:
            ref.dispose()


def test_measure_stream_overlap_returns_the_reference_s_keys():
    devs = ck.all_devices().cpus(1)
    got = wl.measure_stream_overlap(devs, n=1 << 14, reps=2, streamed=True, duplex_probe=True)
    want = ref_overlap(cekirdekler_tpu.hardware.platforms().cpus().subset(1), n=1 << 14,
                       reps=2, streamed=True, duplex_probe=True)
    assert set(got) == set(want)
    assert got["transfer_path"] == want["transfer_path"] == "streamed-ladder"
    assert got["stream_chunks"] >= 1 and got["t_pipelined_ms"] > 0
    plain = wl.measure_stream_overlap(devs, n=1 << 12, reps=1, streamed=True, heavy_iters=3)
    assert plain["heavy_iters"] == 3 and "duplex_ms" not in plain
    for kw in ({"streamed": False}, {"streamed": True, "pipeline_type": 1}):
        with pytest.raises(NotPortedError, match="A 6"):
            wl.measure_stream_overlap(devs, n=1 << 12, **kw)


def test_overlap_sweep_and_duplex_ceiling_run_on_a_host_lane():
    sweep = wl.overlap_chunk_sweep(ck.all_devices().cpus(1), ns=(1 << 12,),
                                   chunk_counts=(2, 4), local_range=64, reps=1, heavy_iters=2)
    size = sweep["sizes"][0]
    assert [r["chunks"] for r in size["rows"]] == [1, 2, 4]
    assert size["autotuner_chunks"] >= 1 and size["choice_vs_optimum"] > 0
    with pytest.raises(ValueError, match="local_range"):
        wl.overlap_chunk_sweep(ck.all_devices().cpus(1), ns=(100,), local_range=64)
    dc = wl.duplex_ceiling(n=1 << 12, reps=2, device="cpu")
    assert 0.0 <= dc["ceiling"] <= 1.0 and dc["bytes"] == 4 << 12
