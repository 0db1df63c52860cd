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

Copies of the reference's modules; its debug server (``DEBUG_PORT_ENV``,
``serve_debug``) and request tracing (``obs/reqtrace.py``) are ROADMAP
Queue A 5's third part.  Nothing here imports torch at module level.
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

__all__ = [
    "DECISIONS",
    "DECISION_KINDS",
    "DECISION_LOG_ENV",
    "DecisionLog",
    "DecisionRecord",
    "FLIGHT",
    "FlightEvent",
    "FlightRecorder",
    "HealthMonitor",
    "POSTMORTEM_DIR_ENV",
    "REPLAYABLE_KINDS",
    "VERDICTS",
    "cluster_health_table",
    "dump_postmortem",
    "evaluate_window",
    "load_decision_log",
    "load_postmortem",
    "postmortem_spans",
    "record_crash",
    "registry_health_summary",
]
