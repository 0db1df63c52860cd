"""Debug HTTP endpoints: what is this process doing RIGHT NOW?

A copy of the reference's ``obs/debugserver.py`` over the port's planes,
with the reference's endpoints and lock discipline, ``/servez`` serving
the port's ``serve.frontend.servez_payload``.  The server binds ``127.0.0.1``
unless the caller names another host.  The text below is the
reference's.

A stdlib-only (``http.server``) introspection plane served from a
daemon thread — no dependency, no framework, safe to leave on in
production the way ``/statusz``-family pages are.  Start it with
``Cores.serve_debug(port=0)`` (ephemeral port, returned on the server
object) or export ``CK_DEBUG_PORT=<port>`` before constructing the
first ``Cores`` (subsequent ``Cores`` in the same process skip the
busy port silently — one debug plane per process).

Endpoints (all GET, all JSON unless noted):

- ``/metrics`` — the live registry in Prometheus exposition format
  (``metrics/export.prometheus_text``; ``text/plain; version=0.0.4``).
- ``/statusz`` — process uptime, the lane table (device names, per-cid
  balancer shares, compute/transfer benches, driver/stream queue
  depths, stream chunk choices), fused-window state + stats, transfer
  tuner state, and the active enqueue window.
- ``/tracez`` — tracer state (enabled, total recorded, capacity,
  **dropped span count** — the ring-wrap loss that used to be silent)
  plus the most recent spans as rows; ``?chrome=1`` downloads the full
  Chrome-trace JSON for Perfetto.
- ``/healthz`` — the lane health report (``obs/health.py``): HTTP 200
  while no lane is degraded, 503 otherwise — a load-balancer-pluggable
  liveness gate.
- ``/flightz`` — the flight recorder's event ring + a registry
  snapshot: the black box, readable before the crash.
- ``/profilez`` — the last device-timeline capture's reconciled
  per-kernel report (``trace/device.py``; a NAMED absence on rigs
  whose backend exposes no device tracks), mark-plane state, and the
  persistent kernel-profile store's index.
- ``/decisionz`` — the decision-provenance plane (``obs/decisions.py``):
  ring state, per-kind decision counts, the most recent records, and
  the latest split's per-lane causality table per compute id (the live
  ``explain``; ``tools/ckreplay.py explain`` renders the same thing
  from a spilled log).
- ``/servez`` — the serving tier (``serve/frontend.py``): every live
  frontend's queue depth, signature-group table (pending + starvation
  streaks), per-tenant accounting, admission configuration, and the
  windowed (last-N) latency snapshot next to the cumulative tenant
  stats.
- ``/reqz`` — request-lifecycle tracing (``obs/reqtrace.py``): recent
  requests, the slowest-N with per-phase breakdowns, per-tenant phase
  percentiles, and the p50/p95/p99 tail anatomy with its coverage
  fraction (``?slow=N`` / ``?n=N`` size the views).

Lock discipline (the hot-path contract): every endpoint reads
SNAPSHOTS — ``REGISTRY.snapshot()`` copies under the registry lock,
``TRACER.snapshot()``/``FLIGHT.snapshot()`` are one-slice ring copies,
the health report copies under the monitor lock, and the ``Cores``
scheduler lock is held only long enough to copy the small enqueue-window
sets.  No endpoint ever blocks a worker thread for longer than one of
those copies, and no endpoint mutates runtime state.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from ..metrics.export import prometheus_text
from ..metrics.registry import REGISTRY
from ..trace.spans import TRACER
from ..utils.jsonsafe import json_safe
from .flight import FLIGHT

__all__ = ["DebugServer", "serve_debug", "DEBUG_PORT_ENV"]

DEBUG_PORT_ENV = "CK_DEBUG_PORT"

#: /tracez row cap — the full ring downloads via ?chrome=1.
TRACEZ_ROWS = 256


def _json_bytes(obj) -> bytes:
    # json_safe: a float('inf') ANYWHERE in a payload (a gauge a caller
    # set, a weird tag) must degrade to null, never serialize as the
    # RFC-8259-invalid bare `Infinity` every strict scraper rejects —
    # the /healthz rule, applied to every payload
    return json.dumps(json_safe(obj), allow_nan=False).encode()


def _copy_dict(d: dict) -> dict:
    """Racy-read dict copy: worker bench dicts gain first-ever keys on
    pool threads with no lock a reader may take (the phase lock can be
    held for a whole phase — a scraper must not queue behind it).  A
    resize mid-copy raises RuntimeError; retry a few times and degrade
    to empty rather than answering 500 (same race class the registry
    iterator locks against — these dicts have no such lock by design)."""
    for _ in range(8):
        try:
            return dict(d)
        except RuntimeError:
            continue
    return {}


class DebugServer:
    """The introspection daemon.  ``cores`` is duck-typed (anything with
    ``workers``/``global_ranges``/``fused_stats``/``health`` enriches
    ``/statusz`` and ``/healthz``) and may be None — the metrics/trace/
    flight endpoints are process-global either way."""

    def __init__(self, cores=None, port: int = 0, host: str = "127.0.0.1"):
        self.cores = cores
        self._t0 = time.time()
        server = self  # captured by the handler class below

        class Handler(BaseHTTPRequestHandler):
            # silence per-request stderr lines — a scraper at 1 Hz must
            # not spam the owning process's logs
            def log_message(self, fmt, *args):  # noqa: D102
                pass

            def do_GET(self):  # noqa: N802 - http.server API
                try:
                    server._route(self)
                except BrokenPipeError:
                    pass  # client went away mid-reply; nothing to save
                except Exception as e:  # noqa: BLE001 - reply, don't die
                    try:
                        body = _json_bytes(
                            {"error": f"{type(e).__name__}: {e}"})
                        self.send_response(500)
                        self.send_header(
                            "Content-Type", "application/json")
                        self.send_header(
                            "Content-Length", str(len(body)))
                        self.end_headers()
                        self.wfile.write(body)
                    except Exception:  # noqa: BLE001
                        pass

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.host = host
        self.port = int(self._httpd.server_address[1])
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="ck-debug-http",
            daemon=True,
        )
        self._thread.start()

    # -- routing -------------------------------------------------------------
    def _route(self, h: BaseHTTPRequestHandler) -> None:
        url = urlparse(h.path)
        q = parse_qs(url.query)
        route = {
            "/": self._index,
            "/metrics": self._metrics,
            "/statusz": self._statusz,
            "/tracez": self._tracez,
            "/healthz": self._healthz,
            "/flightz": self._flightz,
            "/profilez": self._profilez,
            "/decisionz": self._decisionz,
            "/servez": self._servez,
            "/reqz": self._reqz,
        }.get(url.path)
        if route is None:
            self._reply(h, 404, _json_bytes(
                {"error": f"no such endpoint: {url.path}"}))
            return
        route(h, q)

    @staticmethod
    def _reply(h, code: int, body: bytes,
               ctype: str = "application/json") -> None:
        h.send_response(code)
        h.send_header("Content-Type", ctype)
        h.send_header("Content-Length", str(len(body)))
        h.end_headers()
        h.wfile.write(body)

    # -- endpoints -----------------------------------------------------------
    def _index(self, h, q) -> None:
        self._reply(h, 200, _json_bytes({
            "endpoints": ["/metrics", "/statusz", "/tracez", "/healthz",
                          "/flightz", "/profilez", "/decisionz", "/servez",
                          "/reqz"],
            "uptime_s": round(time.time() - self._t0, 3),
        }))

    def _metrics(self, h, q) -> None:
        self._reply(
            h, 200, prometheus_text().encode(),
            ctype="text/plain; version=0.0.4; charset=utf-8",
        )

    def _statusz(self, h, q) -> None:
        doc: dict = {
            "uptime_s": round(time.time() - self._t0, 3),
            "time": time.time(),
        }
        cores = self.cores
        if cores is not None:
            with cores._lock:
                enq = {
                    "enqueue_mode": cores.enqueue_mode,
                    "active_cids": sorted(cores._enqueue_cids),
                    "cid_order": list(cores._enqueue_cid_order),
                    "iters": dict(cores._enqueue_iters),
                    "window_age_s": (
                        round(time.perf_counter() - cores._enqueue_t0, 6)
                        if cores._enqueue_t0 is not None else None
                    ),
                    "fused_window_open": cores._fused_sig is not None,
                    "fused_pending": cores._fused_pending,
                }
                shares = {
                    cid: list(r) for cid, r in cores.global_ranges.items()
                }
                fused = {
                    "windows": cores.fused_stats["windows"],
                    "fused_iters": cores.fused_stats["fused_iters"],
                    "deferred_iters": cores.fused_stats["deferred_iters"],
                    "disengaged": dict(cores.fused_stats["disengaged"]),
                }
            lanes = []
            for w in cores.workers:
                lanes.append({
                    "lane": w.index,
                    "device": str(w.device),
                    "benchmarks_ms": {
                        str(c): round(v, 4)
                        for c, v in _copy_dict(w.benchmarks).items()
                    },
                    "transfer_benchmarks_ms": {
                        str(c): round(v, 4)
                        for c, v in _copy_dict(w.transfer_benchmarks).items()
                    },
                    "driver_queue_depth": w._m_driver_depth.value,
                    "stream_queue_depth": w._m_stream_depth.value,
                    "stream_chunks": cores.last_stream_chunks.get(w.index),
                })
            doc.update({
                "devices": cores.device_names(),
                "lanes": lanes,
                "shares": {str(c): r for c, r in shares.items()},
                "enqueue_window": enq,
                "fused": fused,
                "stream_tuner": {
                    "retunes": cores.transfer_tuner.retunes,
                    "lane_overhead_ms": {
                        str(w.index): round(
                            cores.transfer_tuner.lane_overhead_ms(w.index), 4)
                        for w in cores.workers
                    },
                },
            })
        self._reply(h, 200, _json_bytes(doc))

    def _tracez(self, h, q) -> None:
        spans = TRACER.snapshot()
        if q.get("chrome"):
            from ..trace.export import to_chrome_trace

            body = _json_bytes(to_chrome_trace(spans))
            self._reply(h, 200, body)
            return
        rows = [
            {"kind": s.kind, "t0": s.t0, "dur_ms": round(s.dur_ms, 4),
             "cid": s.cid, "lane": s.lane, "tag": s.tag}
            for s in spans[-TRACEZ_ROWS:]
        ]
        self._reply(h, 200, _json_bytes({
            "enabled": TRACER.enabled,
            "total_recorded": TRACER.total_recorded,
            "capacity": TRACER.capacity,
            "dropped_spans": TRACER.dropped_spans,
            "spans": rows,
            "shown": len(rows),
        }))

    def _healthz(self, h, q) -> None:
        cores = self.cores
        if cores is not None and getattr(cores, "health", None) is not None:
            report = cores.health.report()
        else:
            from .health import registry_health_summary

            report = registry_health_summary()["lanes"]
        # verdict, gate, and drain list all derive from the ONE report
        # snapshot — separate monitor calls could disagree if a window
        # closed in between, making the 200/503 contradict the payload
        # exactly at flip time
        drain = [
            lane for lane, rec in report.items()
            if rec["verdict"] == "degraded"
        ]
        healthy = not drain
        self._reply(h, 200 if healthy else 503, _json_bytes({
            "healthy": healthy,
            "lanes": {str(k): v for k, v in report.items()},
            "suggest_drain": drain,
        }))

    def _flightz(self, h, q) -> None:
        self._reply(h, 200, _json_bytes({
            "total_recorded": FLIGHT.total_recorded,
            "capacity": FLIGHT.capacity,
            "events": [e.to_row() for e in FLIGHT.snapshot()],
            "metrics": REGISTRY.snapshot(),
        }))

    def _profilez(self, h, q) -> None:
        # profilez_payload reads the last-report slot under its own
        # lock and lists store FILENAMES only (no row bodies) — the
        # same snapshot-copy discipline as every other endpoint
        from ..trace.device import profilez_payload

        self._reply(h, 200, _json_bytes(profilez_payload()))

    def _decisionz(self, h, q) -> None:
        # decisionz_payload reads ONE ring snapshot and formats the
        # latest splits' causality tables from the records' own stored
        # outputs — no controller state is touched, nothing re-derives
        from .replay import decisionz_payload

        recent = 64
        if q.get("n"):
            try:
                recent = max(1, min(4096, int(q["n"][0])))
            except ValueError:
                pass
        self._reply(h, 200, _json_bytes(decisionz_payload(recent=recent)))

    def _servez(self, h, q) -> None:
        # servez_payload copies each frontend's small state under its
        # own lock (stats()) — the same snapshot discipline as every
        # other endpoint; no submit is blocked for longer than the copy
        from ..serve.frontend import servez_payload

        self._reply(h, 200, _json_bytes(servez_payload()))

    def _reqz(self, h, q) -> None:
        # reqz_payload folds ONE recorder snapshot (the flight-ring
        # copy discipline) — no serving state is touched, nothing
        # blocks a submit
        from .reqtrace import reqz_payload

        n_slow, n_recent = 10, 50
        if q.get("slow"):
            try:
                n_slow = max(1, min(1024, int(q["slow"][0])))
            except ValueError:
                pass
        if q.get("n"):
            try:
                n_recent = max(1, min(4096, int(q["n"][0])))
            except ValueError:
                pass
        self._reply(h, 200, _json_bytes(
            reqz_payload(n_slow=n_slow, n_recent=n_recent)))

    # -- lifecycle -----------------------------------------------------------
    def close(self) -> None:
        try:
            self._httpd.shutdown()
            self._httpd.server_close()
        except Exception:  # noqa: BLE001 - dispose must not raise
            pass

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"


def serve_debug(cores=None, port: int = 0,
                host: str = "127.0.0.1") -> DebugServer:
    """Start the introspection daemon (ephemeral port with ``port=0``;
    read it back from ``server.port``)."""
    return DebugServer(cores=cores, port=port, host=host)
