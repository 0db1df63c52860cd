"""``cekirdekler_tpu_torch.obs`` — the introspection plane, as far as it
is ported.

- :mod:`.decisions` — decision provenance: the event-sourced log of every
  controller decision with inputs sufficient to reproduce it
  (``DECISIONS``; spilled as jsonl under ``CK_DECISION_LOG``).
- :mod:`.replay` — replay-verify, what-if and explain over such a log,
  behind ``cekirdekler_tpu_torch/tools/ckreplay.py``.
- :mod:`.flight` — the always-on flight recorder (``FLIGHT``) and the
  postmortem black box (``CK_POSTMORTEM_DIR``).
- :mod:`.health` — rolling per-lane baselines over fence, transfer and
  stream-stall walls with an N×-threshold + hysteresis degradation
  detector (``HealthMonitor``, ``Cores.health``).
- :mod:`.drain` — the barrier-time actuator over those verdicts
  (``DrainController``, ``apply_quarantine``, ``Cores.drain``).
- :mod:`.reqtrace` — request-lifecycle tracing (``REQTRACE``) and its pure
  folds (``fold_phases``, ``tail_anatomy``); its producers are the serving
  tier (ROADMAP Queue A 8).
- :mod:`.debugserver` — the stdlib HTTP debug endpoints over a ``Cores``
  (``/metrics``, ``/statusz``, ``/tracez``, ``/healthz``, ``/flightz``,
  ``/profilez``, ``/decisionz``, ``/reqz``), started by
  ``Cores.serve_debug`` or ``CK_DEBUG_PORT`` (``DEBUG_PORT_ENV``).

Copies of the reference's modules.  Nothing here imports torch at module
level.
"""

from .decisions import (
    DECISION_KINDS,
    DECISION_LOG_ENV,
    DECISIONS,
    REPLAYABLE_KINDS,
    DecisionLog,
    DecisionRecord,
    load_decision_log,
)
from .debugserver import DEBUG_PORT_ENV, DebugServer, serve_debug
from .flight import (
    FLIGHT,
    POSTMORTEM_DIR_ENV,
    FlightEvent,
    FlightRecorder,
    dump_postmortem,
    load_postmortem,
    postmortem_spans,
    record_crash,
)
from .health import (
    VERDICTS,
    HealthMonitor,
    cluster_health_table,
    evaluate_window,
    registry_health_summary,
)
from .reqtrace import (
    REQ_EVENT_KINDS,
    REQTRACE,
    ReqEvent,
    ReqTrace,
    fold_phases,
    request_chrome_events,
    reqz_payload,
    tail_anatomy,
)

__all__ = [
    "DEBUG_PORT_ENV",
    "DECISIONS",
    "DECISION_KINDS",
    "DECISION_LOG_ENV",
    "DebugServer",
    "DecisionLog",
    "DecisionRecord",
    "FLIGHT",
    "FlightEvent",
    "FlightRecorder",
    "HealthMonitor",
    "POSTMORTEM_DIR_ENV",
    "REPLAYABLE_KINDS",
    "REQTRACE",
    "REQ_EVENT_KINDS",
    "ReqEvent",
    "ReqTrace",
    "VERDICTS",
    "cluster_health_table",
    "dump_postmortem",
    "evaluate_window",
    "fold_phases",
    "load_decision_log",
    "load_postmortem",
    "postmortem_spans",
    "record_crash",
    "registry_health_summary",
    "request_chrome_events",
    "reqz_payload",
    "serve_debug",
    "tail_anatomy",
]
