"""The port's debug server (``obs/debugserver.py``): the reference's
endpoints over the port's planes, on host lanes.

Every endpoint answers during a live enqueue workload (``/metrics`` parses
as Prometheus text, ``/statusz`` lists the lanes and their shares,
``/tracez`` the spans, ``/flightz`` the flight ring, ``/profilez`` the
last capture, ``/decisionz`` the decision rows, ``/reqz`` the reference's
``reqz_payload``); ``/healthz`` answers 503 once a lane degrades;
``/servez`` answers the serving tier's ``servez_payload`` with a live
frontend's row;
``CK_DEBUG_PORT`` starts one server per process on a fixed port and
refuses port 0.  Every server binds 127.0.0.1 on a port the test chose
free, every fetch has a timeout, and every server is closed at teardown.
"""

from __future__ import annotations

import json
import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from cekirdekler_tpu.obs import reqtrace as ref_rt
import cekirdekler_tpu_torch as ck
from cekirdekler_tpu_torch.metrics.export import parse_prometheus_text
from cekirdekler_tpu_torch.obs import debugserver
from cekirdekler_tpu_torch.obs.flight import FLIGHT
from cekirdekler_tpu_torch.obs.reqtrace import REQTRACE
from cekirdekler_tpu_torch.trace.spans import TRACER
from tests.test_torch_metrics import INC, restore_planes, save_planes


@pytest.fixture(autouse=True)
def _planes(monkeypatch):
    monkeypatch.delenv("CK_DEBUG_PORT", raising=False)
    saved = save_planes()
    REQTRACE.clear()
    yield
    REQTRACE.clear()
    restore_planes(saved)


@pytest.fixture
def cruncher():
    crs = []

    def make(lanes: int = 2, src: str = INC):
        cr = ck.NumberCruncher(ck.all_devices().cpus(lanes), src)
        crs.append(cr)
        return cr

    yield make
    for cr in crs:
        cr.dispose()


def _get(url: str, timeout: float = 10.0):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.status, r.read().decode()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_every_endpoint_during_a_live_workload(cruncher):
    cr = cruncher()
    srv = cr.serve_debug(port=0)
    assert srv is cr.serve_debug(port=0) and srv.host == "127.0.0.1"
    n = 4096
    a = ck.ClArray(np.zeros(n, np.float32), name="obs_a", partial_read=True)
    stop = threading.Event()
    errs: list = []
    iters = [0]

    def drive():
        try:
            cr.enqueue_mode = True
            while not stop.is_set():
                for _ in range(8):
                    a.compute(cr, 901, "inc", n, 64)
                    iters[0] += 1
                cr.barrier()
            cr.enqueue_mode = False
        except Exception as e:  # noqa: BLE001 - surfaced below
            errs.append(e)

    TRACER.enable(clear=True)
    t = threading.Thread(target=drive)
    t.start()
    try:
        deadline = time.time() + 30.0
        while time.time() < deadline and cr.cores.fused_stats["windows"] < 1:
            time.sleep(0.05)
        code, text = _get(srv.url + "/metrics")
        parsed = parse_prometheus_text(text)
        assert code == 200 and any(k.startswith("ck_") for k in parsed["series"])
        assert parsed["types"].get("ck_upload_bytes_total") == "counter"
        code, body = _get(srv.url + "/statusz")
        st = json.loads(body)
        assert code == 200 and len(st["lanes"]) == 2 and "901" in st["shares"]
        assert st["fused"]["deferred_iters"] >= 0 and st["enqueue_window"]["enqueue_mode"]
        code, body = _get(srv.url + "/tracez")
        tz = json.loads(body)
        assert code == 200 and tz["enabled"] is True and tz["total_recorded"] > 0
        assert "dropped_spans" in tz and tz["spans"]
        code, body = _get(srv.url + "/tracez?chrome=1")
        assert any(e.get("ph") == "X" for e in json.loads(body)["traceEvents"])
        code, body = _get(srv.url + "/healthz")
        assert code == 200 and json.loads(body)["healthy"] is True
        code, body = _get(srv.url + "/flightz")
        fz = json.loads(body)
        assert code == 200 and fz["total_recorded"] > 0
        assert "fused-engage" in {e["kind"] for e in fz["events"]}
        code, body = _get(srv.url + "/profilez")
        pz = json.loads(body)
        assert code == 200 and set(pz) == {"last_capture", "marks", "store"}
        code, body = _get(srv.url + "/decisionz?n=16")
        dz = json.loads(body)
        assert code == 200 and dz["shown"] <= 16 and "counts" in dz
        code, body = _get(srv.url + "/")
        idx = json.loads(body)
        assert code == 200 and "/reqz" in idx["endpoints"] and "/servez" in idx["endpoints"]
        with pytest.raises(urllib.error.HTTPError) as info:
            _get(srv.url + "/nope")
        assert info.value.code == 404
    finally:
        stop.set()
        t.join(timeout=60)
        TRACER.disable()
    assert not errs, errs
    # the workload survived the scraping bit-exactly: inc adds exactly 1.0f
    assert float(a.host()[0]) == float(a.host()[-1]) > 0


def test_servez_serves_the_payload_of_the_live_frontends(cruncher):
    from cekirdekler_tpu_torch.serve import ServeFrontend, ServeJob, servez_payload

    cr = cruncher(2)
    srv = cr.serve_debug(port=0)
    a = ck.ClArray(np.zeros(512, np.float32), name="sz")
    a.partial_read = True
    job = ServeJob(params=[a], kernels=["inc"], compute_id=931, global_range=512,
                   local_range=64)
    fe = ServeFrontend(cr, autostart=False, name="servez-debug")
    try:
        futs = [fe.submit("tS", job) for _ in range(3)]
        fe.step()
        for f in futs:
            f.result(timeout=30)
        fe.submit("tS", job)  # one left queued: the page shows it
        code, body = _get(srv.url + "/servez")
        doc = json.loads(body)
        assert code == 200 and doc["count"] == len(doc["frontends"])
        mine = [f for f in doc["frontends"] if f["name"] == "servez-debug"]
        assert mine and mine[0]["queue_depth"] == 1 and mine[0]["requests_done"] == 3
        assert mine[0]["tenants"]["tS"] == {
            "inflight": 1, "requests": 4, "admitted": 4, "rejected": 0,
            "completed": 3, "failed": 0, "deadline_missed": 0}
        local = [f for f in servez_payload()["frontends"] if f["name"] == "servez-debug"]
        assert json.loads(json.dumps(local[0]))["tenants"] == mine[0]["tenants"]
    finally:
        fe.close()
    assert float(a.host()[0]) == 4.0  # close drained the queued request


def test_reqz_serves_the_reference_s_payload(cruncher):
    srv = cruncher(1).serve_debug(port=0)
    rng = np.random.default_rng(0)
    for k in range(6):
        rid = REQTRACE.mint()
        REQTRACE.event(rid, "admitted", tenant="ab"[k % 2], wait_s=float(rng.uniform(0, 1e-3)))
        REQTRACE.event(rid, "queued")
        REQTRACE.event(rid, "device")
        REQTRACE.event(rid, "resolved", latency_s=float(rng.uniform(1e-3, 1e-2)))
    code, body = _get(srv.url + "/reqz?slow=2&n=3")
    got = json.loads(body)
    evs = [tuple(e) for e in REQTRACE.snapshot()]
    want = ref_rt.reqz_payload(evs, n_slow=2, n_recent=3)
    want.update(capacity=REQTRACE.capacity, total_recorded=REQTRACE.total_recorded)
    assert code == 200 and got == json.loads(json.dumps(want))
    assert len(got["recent"]) == 3 and len(got["slowest"]) == 2 and got["requests"] == 6


def _feed_window(hm, lane, values):
    for v in values:
        hm.observe(lane, "fence", v)


def test_healthz_returns_503_when_a_lane_degrades(cruncher):
    cr = cruncher()
    srv = cr.serve_debug(port=0)
    hm = cr.cores.health
    steady = [0.010] * hm.window
    for _ in range(hm.min_history + 1):
        _feed_window(hm, 0, steady)
        _feed_window(hm, 1, steady)
    for _ in range(hm.confirm):
        _feed_window(hm, 1, [0.05] * hm.window)
    assert cr.health_report()[1]["verdict"] == "degraded"
    with pytest.raises(urllib.error.HTTPError) as info:
        _get(srv.url + "/healthz")
    assert info.value.code == 503
    body = json.loads(info.value.read().decode())
    assert body["healthy"] is False and body["suggest_drain"] == [1]
    assert body["lanes"]["1"]["verdict"] == "degraded"


def test_env_autostart_on_a_fixed_port_one_plane_per_process(cruncher, monkeypatch):
    port = _free_port()
    monkeypatch.setenv("CK_DEBUG_PORT", str(port))
    FLIGHT.clear()
    cr = cruncher(1)
    srv = cr.cores._debug_server
    assert srv is not None and srv.port == port
    assert _get(srv.url + "/")[0] == 200
    cr2 = cruncher(1)
    assert cr2.cores._debug_server is None
    skipped = [e for e in FLIGHT.snapshot() if e.kind == "debug-port-skipped"]
    assert len(skipped) == 1 and skipped[0].fields["port"] == str(port)
    assert "debug-server" in {e.kind for e in FLIGHT.snapshot()}
    cr.dispose()
    assert cr.cores._debug_server is None
    with pytest.raises((urllib.error.URLError, ConnectionError, OSError)):
        _get(f"http://127.0.0.1:{port}/", timeout=5.0)


@pytest.mark.parametrize("value", ["0", "-3", "not-a-port"])
def test_env_refuses_port_zero_and_bad_values(cruncher, monkeypatch, value):
    monkeypatch.setenv("CK_DEBUG_PORT", value)
    FLIGHT.clear()
    cr = cruncher(1)
    assert cr.cores._debug_server is None
    (ev,) = [e for e in FLIGHT.snapshot() if e.kind == "debug-port-skipped"]
    assert ev.fields["port"] == value and "ValueError" in ev.fields["reason"]


def test_a_server_without_cores_serves_the_process_planes():
    srv = debugserver.serve_debug(None, port=0)
    try:
        assert srv.host == "127.0.0.1"
        st = json.loads(_get(srv.url + "/statusz")[1])
        assert "lanes" not in st and st["uptime_s"] >= 0
        # the process registry's lane-health gauges decide (other crunchers
        # of the process may have set them): the status follows the body
        try:
            code, body = _get(srv.url + "/healthz")
        except urllib.error.HTTPError as e:
            code, body = e.code, e.read().decode()
        hz = json.loads(body)
        assert (code == 200) == hz["healthy"] and (code == 503) == bool(hz["suggest_drain"])
    finally:
        srv.close()
    with pytest.raises((urllib.error.URLError, ConnectionError, OSError)):
        _get(srv.url + "/", timeout=5.0)


def test_payloads_are_strict_json_even_with_inf_gauges(cruncher):
    from cekirdekler_tpu_torch.metrics.registry import REGISTRY

    srv = cruncher(1).serve_debug(port=0)
    REGISTRY.gauge("ck_test_inf_gauge", "a gauge set to inf").set(float("inf"))
    body = _get(srv.url + "/flightz")[1]
    json.loads(body, parse_constant=lambda c: pytest.fail(f"non-strict JSON constant {c}"))
