"""The port's public names against the reference's.

- ``Devices.__add__`` keeps a lane once: ``s + s``, ``s + s.cpus()`` and an
  overlap of two slices of one selection give the reference's lane counts
  (ROADMAP Queue C 11), while a new ``cpus(n)`` selection still adds lanes,
  numbered after the ones held.
- The typed host arrays have the reference's dtypes and item sizes, and
  ``type_code_for_dtype`` its codes; ``BFloat16Arr`` refuses, naming
  ``ml_dtypes``, where that package is missing.
- ``__all__`` of the package holds every name of the reference's (the
  idiom mappings ROADMAP lists are not top-level names), and of
  ``metrics``, ``obs`` and ``trace`` only names the reference's modules
  export (the port adds ``union_ms`` to ``trace``).
"""

from __future__ import annotations

import sys

import numpy as np
import pytest

import cekirdekler_tpu
import cekirdekler_tpu.arrays as ref_arrays
import cekirdekler_tpu_torch as ck
from cekirdekler_tpu.arrays import fastarr as ref_fastarr
from cekirdekler_tpu.hardware import platforms as ref_platforms
from cekirdekler_tpu_torch.arrays import fastarr
from tests.test_torch_metrics import restore_planes, save_planes

TYPED = ("FloatArr", "DoubleArr", "IntArr", "UIntArr", "LongArr", "ByteArr", "HalfArr",
         "BFloat16Arr")


@pytest.fixture(autouse=True)
def _planes():
    saved = save_planes()
    yield
    restore_planes(saved)


def _port_cases():
    s = ck.all_devices().cpus(2)
    s3 = ck.all_devices().cpus(3)
    return {"s+s": s + s, "s+s.cpus()": s + s.cpus(), "overlap": s3[0:2] + s3[1:3]}


def _ref_cases():
    s = ref_platforms().cpus().subset(2)
    s3 = ref_platforms().cpus().subset(3)
    return {"s+s": s + s, "s+s.cpus()": s + s.cpus(), "overlap": s3[0:2] + s3[1:3]}


@pytest.mark.parametrize("case", ["s+s", "s+s.cpus()", "overlap"])
def test_a_lane_added_again_is_kept_once(case):
    port, ref = _port_cases()[case], _ref_cases()[case]
    assert len(port) == len(ref) == (3 if case == "overlap" else 2)
    assert len({d.name for d in port}) == len(port)


def test_a_new_selection_still_adds_lanes():
    two = ck.all_devices().cpus(2)
    one = ck.all_devices().cpus(1)
    three = two + one
    assert [d.lane_id for d in three] == [0, 1, 2]
    assert len(three + one) == 3 and len(three + two) == 3
    assert len(two + ck.all_devices().cpus(2)) == 4


def test_a_cruncher_over_a_self_sum_runs_on_the_reference_s_lanes():
    s = ck.all_devices().cpus(2)
    cr = ck.NumberCruncher(s + s, """
__kernel void inc(__global float* a) { int i = get_global_id(0); a[i] = a[i] + 1.0f; }
""")
    try:
        assert cr.cores.num_devices == 2
        a = ck.ClArray(np.zeros(256, np.float32), name="a")
        a.compute(cr, 1, "inc", 256, 64)
        np.testing.assert_array_equal(a.host(), np.ones(256, np.float32))
    finally:
        cr.dispose()


@pytest.mark.parametrize("name", TYPED)
def test_typed_arrays_have_the_reference_s_dtypes(name):
    mine = getattr(ck, name)(17)
    ref = getattr(ref_arrays, name)(17)
    try:
        assert mine.dtype == ref.dtype
        assert mine.numpy().itemsize == ref.numpy().itemsize
        assert len(mine) == len(ref) == 17
        assert mine.address() % fastarr.ALIGNMENT == 0
        assert isinstance(mine, ck.FastArr)
    finally:
        ref.dispose()


@pytest.mark.parametrize("dtype", ["float32", "float64", "int32", "int64", "uint32", "uint8",
                                   "uint16", "bool"])
def test_type_codes_are_the_reference_s(dtype):
    assert ck.type_code_for_dtype(np.dtype(dtype)) == ref_fastarr.type_code_for_dtype(dtype)


def test_type_codes_refuse_what_the_reference_refuses():
    import ml_dtypes

    assert ck.type_code_for_dtype(ml_dtypes.bfloat16) == ref_fastarr.type_code_for_dtype(
        ml_dtypes.bfloat16)
    for bad in ("float16", "complex64"):
        with pytest.raises(TypeError):
            ref_fastarr.type_code_for_dtype(bad)
        with pytest.raises(TypeError):
            ck.type_code_for_dtype(bad)


def test_bfloat16_arr_names_ml_dtypes_where_it_is_missing(monkeypatch):
    monkeypatch.setitem(sys.modules, "ml_dtypes", None)
    with pytest.raises(ImportError, match="ml_dtypes"):
        ck.BFloat16Arr(4)


def test_the_package_exports_the_reference_s_names():
    assert set(cekirdekler_tpu.__all__) <= set(ck.__all__)
    for name in ("Platform", "Platforms", "platforms", "metrics", "obs", "trace",
                 "type_code_for_dtype") + TYPED:
        assert name in ck.__all__ and getattr(ck, name) is not None
    assert isinstance(ck.platforms(), ck.Platforms)
    assert set(ref_arrays.__all__) <= set(ck.arrays.__all__)


@pytest.mark.parametrize("sub", ["metrics", "obs", "trace"])
def test_the_observability_packages_export_only_reference_names(sub):
    mine = set(getattr(ck, sub).__all__)
    ref = set(getattr(cekirdekler_tpu, sub).__all__)
    extra = {"union_ms"} if sub == "trace" else set()
    assert mine - extra <= ref, mine - ref
    for name in mine:
        assert getattr(getattr(ck, sub), name) is not None
