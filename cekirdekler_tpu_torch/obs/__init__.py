"""``cekirdekler_tpu_torch.obs`` — the introspection plane, as far as it
is ported.

- :mod:`.decisions` — decision provenance: the event-sourced log of every
  controller decision with inputs sufficient to reproduce it
  (``DECISIONS``; spilled as jsonl under ``CK_DECISION_LOG``).
- :mod:`.replay` — replay-verify, what-if and explain over such a log,
  behind ``cekirdekler_tpu_torch/tools/ckreplay.py``.
- :mod:`.flight` — the always-on flight recorder (``FLIGHT``) and the
  postmortem black box (``CK_POSTMORTEM_DIR``).

Copies of the reference's modules; its health, drain, debug server and
request tracing are ROADMAP Queue A 5's second half.  Nothing here
imports torch at module level.
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

__all__ = [
    "DECISIONS",
    "DECISION_KINDS",
    "DECISION_LOG_ENV",
    "DecisionLog",
    "DecisionRecord",
    "FLIGHT",
    "FlightEvent",
    "FlightRecorder",
    "POSTMORTEM_DIR_ENV",
    "REPLAYABLE_KINDS",
    "dump_postmortem",
    "load_decision_log",
    "load_postmortem",
    "postmortem_spans",
    "record_crash",
]
