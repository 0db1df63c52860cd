"""Device selection of the port (``cekirdekler_tpu_torch/hardware.py``)
against the JAX package's, on host-CPU lanes.

The reference's fleet here is the test rig's virtual CPU devices
(``platforms().cpus()``); the port's is ``all_devices().cpus(n)``.  Each
selector must pick the same lanes, by position, from analogous fleets:
plain host lanes, partitions of one lane, and partitions beside plain
lanes.  Partitions are distinct lanes that ``+`` keeps, and ``compute()``
over four of them is exact and equals the reference's.  The n-body
microbenchmark returns a positive time on a host lane and ranks every
device once.  The card's side (free memory against
``torch.cuda.mem_get_info``, the card ranked first, two partition lanes'
streams) is ``chip_smoke.py``'s and ``tests/test_torch_card.py``'s.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest

import cekirdekler_tpu
import cekirdekler_tpu_torch as ck
from cekirdekler_tpu.core.cruncher import NumberCruncher as RefCruncher
from cekirdekler_tpu.hardware import Devices as RefDevices
from cekirdekler_tpu.hardware import Platform as RefPlatform
from cekirdekler_tpu.hardware import Platforms as RefPlatforms
from cekirdekler_tpu.hardware import platforms as ref_platforms
from cekirdekler_tpu_torch.hardware import Devices, Platform, Platforms
from cekirdekler_tpu_torch.ops import nbody

TWICE = """
__kernel void twice(__global float* x) {
    int i = get_global_id(0);
    x[i] = x[i] * 2.0f;
}"""

SELECTORS = ("accelerators", "gpus", "tpus", "cpus", "with_dedicated_memory",
             "with_host_memory_sharing", "with_most_compute_units",
             "with_highest_memory_available")


def _fleets():
    """(label, port selection, reference selection) of analogous fleets."""
    ref = ref_platforms().cpus()
    port = ck.all_devices().cpus(4)
    return [
        ("host lanes", port, ref.subset(4)),
        ("partitions of one lane", port[0].as_partitions(4), ref[0].as_partitions(4)),
        ("partitions beside lanes", port[0].as_partitions(2) + port[1:3],
         ref[0].as_partitions(2) + ref[1:3]),
    ]


def _positions(picked, fleet) -> list[int]:
    return [list(fleet).index(d) for d in picked]


@pytest.mark.parametrize("selector", SELECTORS)
@pytest.mark.parametrize("fleet", [0, 1, 2], ids=["lanes", "partitions", "mixed"])
def test_each_selector_picks_what_the_reference_picks(selector, fleet):
    label, port, ref = _fleets()[fleet]
    got = getattr(port, selector)()
    want = getattr(ref, selector)()
    assert isinstance(got, Devices) and isinstance(want, RefDevices)
    assert _positions(got, port) == _positions(want, ref), (label, selector)


@pytest.mark.parametrize("fleet", [0, 1, 2], ids=["lanes", "partitions", "mixed"])
def test_lane_properties_match_the_reference(fleet):
    label, port, ref = _fleets()[fleet]
    for p, r in zip(port, ref):
        assert (p.is_partition, p.partition_id, p.partition_cores, p.compute_units,
                p.dedicated_memory, p.memory_available_bytes, p.is_gpu, p.is_cpu) == (
            r.is_partition, r.partition_id, r.partition_cores, r.compute_units,
            r.dedicated_memory, r.memory_available_bytes, r.is_tpu, r.is_cpu), label
        assert p.copy() == p and p.copy() is not p


def test_partitions_are_distinct_lanes_that_plus_keeps():
    """The reference's ``test_device_partition_lanes`` on the port: four
    lanes of one host lane, distinct names, ``+`` of the selection with
    itself still four, and beside a second selection of host lanes the
    partitions keep their ids while the new lanes are numbered after."""
    parts = ck.all_devices().cpus(1)[0].as_partitions(4)
    ref_parts = ref_platforms().cpus()[0].as_partitions(4)
    assert len(parts) == len(ref_parts) == 4
    assert all(p.is_partition for p in parts)
    assert len({p.name for p in parts}) == len({p.name for p in ref_parts}) == 4
    assert len(parts + parts) == len(ref_parts + ref_parts) == 4
    assert [p.name for p in parts] == [f"cpu #0/p{i}" for i in range(4)]
    more = parts + ck.all_devices().cpus(2)
    assert [d.name for d in more] == [f"cpu #0/p{i}" for i in range(4)] + ["cpu #1", "cpu #2"]
    with pytest.raises(ValueError):
        parts[0].as_partitions(0)


def test_compute_over_four_partitions_is_exact_and_equals_the_reference():
    data = np.arange(1024, dtype=np.float32)
    outs = []
    for cr in (ck.NumberCruncher(ck.all_devices().cpus(1)[0].as_partitions(4), TWICE),
               RefCruncher(ref_platforms().cpus()[0].as_partitions(4), TWICE)):
        CA = ck.ClArray if isinstance(cr, ck.NumberCruncher) else cekirdekler_tpu.ClArray
        try:
            x = CA(data.copy(), name="x", partial_read=True)
            for _ in range(3):
                x.compute(cr, 41, "twice", 1024, 64)
            assert len(cr.ranges_of(41)) == 4 and sum(cr.ranges_of(41)) == 1024
            outs.append(np.asarray(x).copy())
        finally:
            cr.dispose()
    np.testing.assert_array_equal(outs[0], data * 8.0)
    np.testing.assert_array_equal(outs[0], outs[1])


def test_partition_lanes_have_their_own_workers():
    with ck.NumberCruncher(ck.all_devices().cpus(1)[0].as_partitions(2), TWICE) as cr:
        w0, w1 = cr.cores.workers
        assert w0 is not w1 and w0.index == 0 and w1.index == 1
        assert cr.cores.device_names() == ["cpu #0/p0", "cpu #0/p1"]


def test_microbenchmark_is_a_positive_time_on_a_host_lane():
    sec = nbody.microbenchmark("cpu", n=128, iters=2)
    assert sec > 0.0


@pytest.mark.parametrize("fleet", [0, 1, 2], ids=["lanes", "partitions", "mixed"])
def test_nbody_ranking_returns_every_device_once(fleet):
    label, port, ref = _fleets()[fleet]
    ranked = port.with_highest_nbody_performance(n=64, iters=1)
    ref_ranked = ref.with_highest_nbody_performance(n=64, iters=1)
    assert sorted(_positions(ranked, port)) == list(range(len(port))), label
    assert len(ranked) == len(ref_ranked) == len(port)


def test_platform_counts_and_platform_selectors_match_the_reference():
    """Two platforms each side, host ones with 6 lanes and 2 others: the
    counts, ``with_most_devices`` and the platform-wide selections
    agree."""
    cpu = jax.devices("cpu")
    lanes = ck.all_devices().cpus(8)
    ref = RefPlatforms([RefPlatform("cpu", tuple(cpu[:6])), RefPlatform("cpu2", tuple(cpu[6:8]))])
    port = Platforms([Platform("cpu", tuple(lanes[:6])), Platform("cpu2", tuple(lanes[6:8]))])
    for p, r in zip(port, ref):
        assert (p.num_cpus(), p.num_accelerators(), p.num_gpus()) == (
            r.num_cpus(), r.num_accelerators(), r.num_tpus())
    assert [p.name for p in port.with_most_devices()] == [
        p.name for p in ref.with_most_devices()] == ["cpu"]
    assert len(port.accelerators()) == len(ref.accelerators()) == 0
    assert len(port.cpus()) == len(ref.cpus()) == 8
    assert len(Platforms([]).with_most_devices()) == len(RefPlatforms([]).with_most_devices()) == 0


def test_empty_selections_select_nothing():
    empty = Devices()
    assert len(empty.with_most_compute_units()) == len(RefDevices().with_most_compute_units()) == 0
    assert len(empty.with_highest_memory_available()) == 0
    assert len(empty.with_highest_nbody_performance()) == 0
