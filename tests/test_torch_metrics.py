"""The port's metrics registry against the reference's, and the counters the
port's lanes keep.

- The same sequence of counter, gauge and histogram operations (drawn with
  numpy from a seed) on a fresh registry of each package gives equal JSON
  snapshots and byte-equal Prometheus text (exact).
- A scripted run on host lanes registers only ``ck_*`` series the
  reference's run of the same script registers, and the lanes' upload and
  download byte counters equal the bytes the calls moved, counted from the
  arrays (exact).
- With the registry disabled, a ``compute()`` moves no counter.

Every test runs between :func:`save_planes` and :func:`restore_planes`
(the fixture below; the other ``test_torch_*`` files of the hooks use the
same pair): both packages' tracer, flight ring, decision log and fault
plane are cleared, disarmed and set back to their flags after each test,
so nothing leaks into a JAX-package test that runs next in the worker.
"""

from __future__ import annotations

import numpy as np
import pytest

import cekirdekler_tpu
import cekirdekler_tpu_torch as ck
from cekirdekler_tpu import metrics as ref_metrics
from cekirdekler_tpu.core.cruncher import NumberCruncher as RefCruncher
from cekirdekler_tpu.hardware import platforms as ref_platforms
from cekirdekler_tpu.metrics.registry import REGISTRY as REF_REGISTRY
from cekirdekler_tpu.obs.decisions import DECISIONS as REF_DECISIONS
from cekirdekler_tpu.obs.flight import FLIGHT as REF_FLIGHT
from cekirdekler_tpu.trace.spans import TRACER as REF_TRACER
from cekirdekler_tpu.utils.faultinject import FAULTS as REF_FAULTS
from cekirdekler_tpu_torch import metrics as port_metrics
from cekirdekler_tpu_torch.metrics.registry import REGISTRY
from cekirdekler_tpu_torch.obs.decisions import DECISIONS
from cekirdekler_tpu_torch.obs.flight import FLIGHT
from cekirdekler_tpu_torch.trace.spans import TRACER
from cekirdekler_tpu_torch.utils.faultinject import FAULTS

INC = """
__kernel void inc(__global float* a) {
    int i = get_global_id(0);
    a[i] = a[i] + 1.0f;
}
"""

_PLANES = ((TRACER, FLIGHT, DECISIONS, FAULTS, REGISTRY),
           (REF_TRACER, REF_FLIGHT, REF_DECISIONS, REF_FAULTS, REF_REGISTRY))


def save_planes() -> list:
    """The flags of both packages' planes, and the armed fault plans."""
    return [(t.enabled, f.enabled, d.enabled, q.plan if q.enabled else None, r.enabled)
            for t, f, d, q, r in _PLANES]


def restore_planes(saved: list) -> None:
    """Clear the rings, disarm the fault planes (re-arming a plan that was
    armed before) and set every flag back."""
    for (t, f, d, q, r), (te, fe, de, plan, re_) in zip(_PLANES, saved):
        t.disable()
        t.clear()
        f.clear()
        d.clear()
        q.disarm()
        if plan:
            q.arm(plan)
        t.enabled, f.enabled, d.enabled, r.enabled = te, fe, de, re_


@pytest.fixture(autouse=True)
def _planes():
    saved = save_planes()
    yield
    restore_planes(saved)


def _ops(seed: int, n: int = 60) -> list[tuple]:
    """A seeded sequence of registry operations."""
    rng = np.random.default_rng(seed)
    names = ["ck_a_total", "ck_b_total", "ck_depth", "ck_wait_seconds"]
    out = []
    for _ in range(n):
        k = int(rng.integers(0, 4))
        lane = int(rng.integers(0, 3))
        if k == 0:
            out.append(("counter", names[int(rng.integers(0, 2))], lane,
                        int(rng.integers(1, 1000))))
        elif k == 1:
            out.append(("gauge", names[2], lane, float(rng.normal())))
        elif k == 2:
            out.append(("histogram", names[3], lane, float(rng.exponential(0.01))))
        else:
            out.append(("gauge-inc", names[2], lane, float(rng.integers(1, 5))))
    return out


def _apply(reg, ops) -> None:
    for kind, name, lane, v in ops:
        if kind == "counter":
            reg.counter(name, "help text", lane=lane).inc(v)
        elif kind == "gauge":
            reg.gauge(name, "help text", lane=lane).set(v)
        elif kind == "gauge-inc":
            reg.gauge(name, "help text", lane=lane).inc(v)
        else:
            reg.histogram(name, "help text", lane=lane).observe(v)


def test_the_registry_modules_export_the_reference_s_names():
    assert port_metrics.__all__ == ref_metrics.__all__
    assert port_metrics.DEFAULT_BUCKETS == ref_metrics.DEFAULT_BUCKETS


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_the_same_operations_give_equal_snapshots_and_text(seed):
    ops = _ops(seed)
    port, ref = port_metrics.MetricsRegistry(), ref_metrics.MetricsRegistry()
    _apply(port, ops)
    _apply(ref, ops)
    assert port_metrics.json_snapshot(port) == ref_metrics.json_snapshot(ref)
    text = port_metrics.prometheus_text(port)
    assert text == ref_metrics.prometheus_text(ref)
    assert port_metrics.parse_prometheus_text(text) == ref_metrics.parse_prometheus_text(text)


def test_a_disabled_registry_moves_nothing():
    reg = port_metrics.MetricsRegistry()
    reg.enabled = False
    _apply(reg, _ops(5))
    snap = port_metrics.json_snapshot(reg)
    assert all(v == 0 for v in snap["counters"].values())
    assert all(v == 0.0 for v in snap["gauges"].values())


def _script(cr, CA, lanes: int) -> None:
    """Plain calls, enqueue calls, a barrier and a flush, split pinned."""
    cr.normalized_compute_powers_of_devices = [1.0 / lanes] * lanes
    cr.stream_chunks = 2
    a = CA(np.zeros(4096, np.float32), name="a", partial_read=True)
    for _ in range(2):
        a.compute(cr, 7, "inc", 4096, 64)
    cr.enqueue_mode = True
    for _ in range(3):
        a.compute(cr, 7, "inc", 4096, 64)
    cr.barrier()
    cr.enqueue_mode = False


def _moved(before: dict, after: dict) -> set[str]:
    """Names of the series a run registered or moved (the registries are
    process-global: earlier tests' series stay)."""
    return {s.split("{")[0] for kind, series in after.items() for s, v in series.items()
            if before[kind].get(s) != v}


def test_the_port_registers_only_the_reference_s_series():
    """Every series the port's run of the script registered or moved is
    one the reference's registry holds after its run of the same script."""
    p0 = REGISTRY.snapshot()
    port = ck.NumberCruncher(ck.all_devices().cpus(2), INC)
    ref = RefCruncher(ref_platforms().cpus().subset(2), INC)
    try:
        _script(port, ck.ClArray, 2)
        _script(ref, cekirdekler_tpu.ClArray, 2)
        mine = _moved(p0, REGISTRY.snapshot())
        theirs = {s.split("{")[0] for kind in REF_REGISTRY.snapshot().values() for s in kind}
    finally:
        port.dispose()
        ref.dispose()
    names = {n for n in mine if n.startswith("ck_")}
    assert names and names <= theirs, names - theirs
    for n in ("ck_upload_bytes_total", "ck_download_bytes_total", "ck_stream_chunks_total",
              "ck_fused_windows_total", "ck_barriers_total", "ck_barrier_seconds"):
        assert n in names


@pytest.mark.parametrize("streamed", [False, True])
def test_byte_counters_equal_the_bytes_the_calls_moved(streamed):
    """Two lanes, a pinned even split: every call uploads each lane's half of
    ``a`` (partial read) and all of ``b``, and downloads each lane's half of
    ``a``."""
    n, calls = 4096, 3
    cr = ck.NumberCruncher(ck.all_devices().cpus(2), """
__kernel void addb(__global float* a, __global float* b) {
    int i = get_global_id(0);
    a[i] = a[i] + b[i];
}
""")
    try:
        cr.normalized_compute_powers_of_devices = [0.5, 0.5]
        cr.stream_chunks = 2 if streamed else 1
        rng = np.random.default_rng(11)
        a = ck.ClArray(rng.standard_normal(n).astype(np.float32), name="a", partial_read=True)
        b = ck.ClArray(rng.standard_normal(n).astype(np.float32), name="b", read_only=True)
        before = [(REGISTRY.counter("ck_upload_bytes_total", lane=i).value,
                   REGISTRY.counter("ck_download_bytes_total", lane=i).value) for i in range(2)]
        for _ in range(calls):
            (a.next_param(b)).compute(cr, 3, "addb", n, 64)
        for i in range(2):
            up = REGISTRY.counter("ck_upload_bytes_total", lane=i).value - before[i][0]
            down = REGISTRY.counter("ck_download_bytes_total", lane=i).value - before[i][1]
            assert up == calls * (n // 2 * 4 + n * 4)
            assert down == calls * (n // 2 * 4)
    finally:
        cr.dispose()


def test_disabled_registry_keeps_the_lanes_counters_still():
    cr = ck.NumberCruncher(ck.all_devices().cpus(2), INC)
    try:
        a = ck.ClArray(np.zeros(1024, np.float32), name="a")
        a.compute(cr, 1, "inc", 1024, 64)
        before = REGISTRY.snapshot()
        REGISTRY.enabled = False
        a.compute(cr, 1, "inc", 1024, 64)
        after = REGISTRY.snapshot()
        for kind, series in after.items():
            for name, v in series.items():
                # a get-or-create may register a series; none moves
                assert v == before[kind].get(name, v if kind == "histograms" else 0), name
        np.testing.assert_array_equal(a.host(), np.full(1024, 2.0, np.float32))
    finally:
        cr.dispose()
