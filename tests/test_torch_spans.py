"""The port's span tracer and fence split against the reference's.

- ``SPAN_KINDS`` is the reference's.
- A scripted sequence of ``compute()`` calls on 2-3 host lanes (plain
  calls, an enqueue window that fuses, a barrier, a plain call), its split
  pinned by ``normalized_compute_powers_of_devices`` and its chunks by
  ``stream_chunks``, records per lane the reference's sequence of span
  kinds, and the same lane-less spans (``enqueue``, ``split``, ``fused``,
  ``fence``) in the same order.  Monolithic phases (one chunk) are held
  exactly; in a streamed phase a host lane stages the next chunk while its
  queue runs the last one's launch, so there each phase's kinds are held as
  a multiset, in the same phases.
- ``split_fence_benches`` gives the reference's per-cid benches for the
  same completions; ``Cores.fence_split`` on host lanes probes each compute
  id of a mixed window (``Worker.fence_cid``) and feeds the balancer
  marginal times.
- Disabled, the tracer records nothing through a ``compute()``.
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import pytest

import cekirdekler_tpu
import cekirdekler_tpu_torch as ck
from cekirdekler_tpu.core.cruncher import NumberCruncher as RefCruncher
from cekirdekler_tpu.hardware import platforms as ref_platforms
from cekirdekler_tpu.trace import attribution as ref_attribution
from cekirdekler_tpu.trace import spans as ref_spans
from cekirdekler_tpu.trace.spans import TRACER as REF_TRACER
from cekirdekler_tpu_torch.trace import attribution, spans
from cekirdekler_tpu_torch.trace.spans import TRACER
from tests.test_torch_metrics import INC, restore_planes, save_planes


@pytest.fixture(autouse=True)
def _planes():
    saved = save_planes()
    yield
    restore_planes(saved)


def script(cr, CA, lanes: int, chunks: int) -> np.ndarray:
    """Three plain calls, four enqueued ones (a fused window opens at the
    second), a barrier, one plain call."""
    cr.normalized_compute_powers_of_devices = [1.0 / lanes] * lanes
    cr.stream_chunks = chunks
    a = CA(np.zeros(4096, np.float32), name="a", partial_read=True)
    for _ in range(3):
        a.compute(cr, 1, "inc", 4096, 64)
    cr.enqueue_mode = True
    for _ in range(4):
        a.compute(cr, 1, "inc", 4096, 64)
    cr.barrier()
    cr.enqueue_mode = False
    a.compute(cr, 1, "inc", 4096, 64)
    return np.array(a.host())


def traced(tracer, cr, CA, lanes, chunks):
    tracer.enable()
    try:
        out = script(cr, CA, lanes, chunks)
    finally:
        tracer.disable()
        cr.dispose()
    per: dict = {}
    for s in tracer.snapshot():
        per.setdefault(s.lane, []).append(s.kind)
    return per, out


def _phases(kinds: list[str]) -> list:
    """A lane's kinds cut at each ``pipeline-stage`` (a streamed phase's
    opening span): each phase as a multiset."""
    out: list = []
    for k in kinds:
        if k == "pipeline-stage" or not out:
            out.append(Counter())
        out[-1][k] += 1
    return out


def test_span_kinds_are_the_reference_s():
    assert spans.SPAN_KINDS == ref_spans.SPAN_KINDS
    assert spans.Span._fields == ref_spans.Span._fields


@pytest.mark.parametrize("lanes", [2, 3])
@pytest.mark.parametrize("chunks", [1, 2])
def test_a_scripted_run_records_the_reference_s_spans_per_lane(lanes, chunks):
    port, p_out = traced(TRACER, ck.NumberCruncher(ck.all_devices().cpus(lanes), INC),
                         ck.ClArray, lanes, chunks)
    ref, r_out = traced(REF_TRACER, RefCruncher(ref_platforms().cpus().subset(lanes), INC),
                        cekirdekler_tpu.ClArray, lanes, chunks)
    np.testing.assert_array_equal(p_out, r_out)
    assert set(port) == set(ref) == set(range(lanes)) | {None}
    assert port[None] == ref[None]
    assert port[None].count("fused") == 1 and "fence" in port[None]
    for lane in range(lanes):
        if chunks == 1:
            assert port[lane] == ref[lane], lane
        else:
            assert _phases(port[lane]) == _phases(ref[lane]), lane


def test_disabled_tracer_records_nothing_through_compute():
    cr = ck.NumberCruncher(ck.all_devices().cpus(2), INC)
    try:
        script(cr, ck.ClArray, 2, 2)
    finally:
        cr.dispose()
    assert TRACER.total_recorded == 0 and TRACER.snapshot() == []


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split_fence_benches_is_the_reference_s(seed):
    rng = np.random.default_rng(seed)
    t_open = float(rng.uniform(0, 10))
    times = t_open + np.cumsum(rng.exponential(0.003, 6)) - 0.001
    completions = [(int(c), float(t)) for c, t in zip(rng.permutation(6), times)]
    assert (attribution.split_fence_benches(completions, t_open)
            == ref_attribution.split_fence_benches(completions, t_open))
    iv = [(float(a), float(a + b)) for a, b in zip(rng.uniform(0, 1, 8), rng.uniform(0, .2, 8))]
    assert attribution.union_ms(list(iv)) == ref_attribution.union_ms(list(iv))


TWO = INC + """
__kernel void inc2(__global float* a) {
    int i = get_global_id(0);
    a[i] = a[i] + 2.0f;
}
"""


def test_fence_split_probes_each_compute_id_on_host_lanes():
    """A mixed window of two compute ids: each lane fences each id's work
    in last-dispatch order (``cid-split`` fence spans), and each id's bench
    is its marginal; with the split off no probe is kept."""
    cr = ck.NumberCruncher(ck.all_devices().cpus(2), TWO)
    try:
        cr.fence_split = True
        assert all(w.track_cid_outputs for w in cr.cores.workers)
        cr.stream_chunks = 1
        a = ck.ClArray(np.zeros(2048, np.float32), name="a")
        b = ck.ClArray(np.zeros(2048, np.float32), name="b")
        cr.enqueue_mode = True
        TRACER.enable()
        a.compute(cr, 1, "inc", 2048, 64)
        b.compute(cr, 2, "inc2", 2048, 64)
        a.compute(cr, 1, "inc", 2048, 64)
        cr.barrier()
        TRACER.disable()
        probes = [(s.lane, s.cid) for s in TRACER.snapshot()
                  if s.kind == "fence" and s.tag == "cid-split"]
        assert sorted(probes) == [(0, 1), (0, 2), (1, 1), (1, 2)]
        for w in cr.cores.workers:
            assert w.fence_cid(1) and w.fence_cid(2) and not w.fence_cid(99)
            assert w.benchmarks[1] > 0.0 and w.benchmarks[2] >= 0.0
        cr.flush()
        np.testing.assert_array_equal(a.host(), np.full(2048, 2.0, np.float32))
        np.testing.assert_array_equal(b.host(), np.full(2048, 2.0, np.float32))
        cr.fence_split = False
        assert all(not w._cid_last_out for w in cr.cores.workers)
    finally:
        cr.dispose()


def test_fence_split_defaults_off_as_in_the_reference():
    port = ck.NumberCruncher(ck.all_devices().cpus(1), INC)
    ref = RefCruncher(ref_platforms().cpus().subset(1), INC)
    try:
        assert port.fence_split is ref.fence_split is False
    finally:
        port.dispose()
        ref.dispose()
