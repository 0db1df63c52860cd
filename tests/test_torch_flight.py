"""The port's flight recorder and postmortem against the reference's.

- The event-kind vocabulary, the schema tag and the postmortem's keys are
  the reference's; only its versions block differs (torch, its CUDA and
  the card in place of jax).
- ``record_crash`` writes a black box only under ``CK_POSTMORTEM_DIR``
  (armed through ``monkeypatch``, never ``os.environ``); a failing
  ``compute()`` leaves one there, with its ``crash`` event.
- A scripted run on host lanes records the reference's sequence of flight
  event kinds from the caller's thread (the split pinned), and a barrier's
  event carries each lane's fence time.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

import cekirdekler_tpu
import cekirdekler_tpu_torch as ck
from cekirdekler_tpu.core.cruncher import NumberCruncher as RefCruncher
from cekirdekler_tpu.hardware import platforms as ref_platforms
from cekirdekler_tpu.obs import flight as ref_flight
from cekirdekler_tpu.obs.flight import FLIGHT as REF_FLIGHT
from cekirdekler_tpu_torch.obs import flight
from cekirdekler_tpu_torch.obs.flight import FLIGHT
from tests.test_torch_metrics import INC, restore_planes, save_planes
from tests.test_torch_spans import script


@pytest.fixture(autouse=True)
def _planes():
    saved = save_planes()
    yield
    restore_planes(saved)


def test_the_vocabulary_is_the_reference_s():
    assert flight.EVENT_KINDS == ref_flight.EVENT_KINDS
    assert flight.SCHEMA == ref_flight.SCHEMA
    assert flight.POSTMORTEM_DIR_ENV == ref_flight.POSTMORTEM_DIR_ENV


def test_the_postmortem_has_the_reference_s_keys(tmp_path):
    for fr in (FLIGHT, REF_FLIGHT):
        fr.event("rebalance", cid=1, ranges=[64, 64], old=[])
    p = flight.dump_postmortem(str(tmp_path / "port.json"), exc=ValueError("x"),
                               lanes={"devices": ["cpu #0"]})
    r = ref_flight.dump_postmortem(str(tmp_path / "ref.json"), exc=ValueError("x"),
                                   lanes={"devices": ["cpu #0"]})
    mine, ref = flight.load_postmortem(p), ref_flight.load_postmortem(r)
    assert mine.keys() == ref.keys()
    for key in mine:
        if isinstance(mine[key], dict) and key != "versions":
            assert mine[key].keys() == ref[key].keys(), key
    assert {"python", "torch", "cuda", "device", "cekirdekler_tpu_torch"} <= set(
        mine["versions"])
    assert "jax" not in mine["versions"]
    assert [e["kind"] for e in mine["events"]] == [e["kind"] for e in ref["events"]]
    json.loads((tmp_path / "port.json").read_text())  # strict JSON


def test_record_crash_dumps_only_when_armed(tmp_path, monkeypatch):
    monkeypatch.delenv(flight.POSTMORTEM_DIR_ENV, raising=False)
    assert flight.record_crash("here", RuntimeError("boom")) is None
    assert FLIGHT.snapshot()[-1].kind == "crash"
    monkeypatch.setenv(flight.POSTMORTEM_DIR_ENV, str(tmp_path / "pm"))
    path = flight.record_crash("here", RuntimeError("boom"))
    assert path is not None and flight.load_postmortem(path)["exc"]["type"] == "RuntimeError"


def test_a_failed_compute_leaves_a_black_box(tmp_path, monkeypatch):
    monkeypatch.setenv(flight.POSTMORTEM_DIR_ENV, str(tmp_path))
    cr = ck.NumberCruncher(ck.all_devices().cpus(2), INC)
    try:
        a = ck.ClArray(np.zeros(1024, np.float32), name="a")
        a.compute(cr, 1, "inc", 1024, 64)

        def broken(*_a, **_k):
            raise RuntimeError("lane failure")

        monkeypatch.setattr(cr.cores.workers[1], "launch", broken)
        with pytest.raises(RuntimeError, match="lane failure"):
            a.compute(cr, 1, "inc", 1024, 64)
    finally:
        cr.dispose()
    dumps = list(tmp_path.glob("*.json"))
    assert len(dumps) == 1
    pm = flight.load_postmortem(str(dumps[0]))
    assert pm["events"][-1]["kind"] == "crash" and pm["events"][-1]["where"] == "cores.compute"
    assert pm["lanes"]["devices"] == ["cpu #0", "cpu #1"]


@pytest.mark.parametrize("lanes", [2, 3])
def test_a_scripted_run_records_the_reference_s_flight_events(lanes):
    kinds = []
    for fr, cr, CA in ((FLIGHT, ck.NumberCruncher(ck.all_devices().cpus(lanes), INC), ck.ClArray),
                       (REF_FLIGHT, RefCruncher(ref_platforms().cpus().subset(lanes), INC),
                        cekirdekler_tpu.ClArray)):
        fr.clear()
        try:
            script(cr, CA, lanes, 2)
        finally:
            cr.dispose()
        events = fr.snapshot()
        kinds.append([e.kind for e in events if e.kind != "metrics-sample"])
        barrier = [e for e in events if e.kind == "barrier"]
        assert len(barrier) == 1 and sorted(barrier[0].fields["lanes"]) == list(range(lanes))
    assert kinds[0] == kinds[1]
    assert {"rebalance", "stream-choice", "fused-engage", "fused-window", "barrier"} <= set(kinds[0])


def test_a_disabled_recorder_records_nothing_through_compute():
    FLIGHT.enabled = False
    cr = ck.NumberCruncher(ck.all_devices().cpus(2), INC)
    try:
        script(cr, ck.ClArray, 2, 2)
    finally:
        cr.dispose()
    assert FLIGHT.snapshot() == []
