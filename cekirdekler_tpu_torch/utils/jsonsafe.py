"""RFC-8259-safe JSON export: the one sanitizer every export path uses.

A copy of ``cekirdekler_tpu/utils/jsonsafe.py`` kept in the port (which never
imports the JAX package); the text below is the reference's.

Python's ``json.dumps`` serializes ``float('inf')`` / ``nan`` as the
bare tokens ``Infinity`` / ``NaN`` — NOT valid JSON per RFC 8259 —
so every strict consumer (browsers, jq, Go/Rust services, the bench
driver's parser) rejects the whole body.  The debug server hit this on
``/healthz`` (a zero-baseline health ratio) and fixed it at the source;
numpy scalars are the sibling failure (``TypeError`` mid-export kills
the artifact at the moment it matters).  This module generalizes both
fixes into one helper, and ``tools/ckcheck``'s invariant pass enforces
its use: a ``json.dumps`` on an export path must either wrap its
payload in :func:`json_safe` or pass ``allow_nan=False`` (fail loudly,
never emit invalid JSON).

Rules, applied recursively:

- non-finite floats → ``None`` (the convention: absence over an
  unparseable token; consumers already handle null ratios);
- numpy scalars/0-d arrays → native Python via ``.item()`` (then the
  float rule re-applies — ``np.float64('inf')`` becomes ``None`` too);
- numpy ndarrays → lists (element-wise sanitized);
- dict keys → strings (JSON object keys are strings; numpy ints appear
  as lane/cid keys in health tables);
- sets/tuples → lists;
- anything else non-JSON-native → ``str(obj)`` (the postmortem dump's
  ``default=str`` contract: a weird value must never suppress a black
  box).
"""

from __future__ import annotations

import json
import math

__all__ = ["json_safe", "dumps_safe"]

_ATOMS = (str, int, bool, type(None))


def json_safe(obj):
    """A deep copy of ``obj`` that ``json.dumps(..., allow_nan=False)``
    is guaranteed to accept.  Cycles are broken with a placeholder
    rather than recursing forever (a postmortem ``extra`` dict may be
    arbitrarily weird)."""
    return _safe(obj, _seen=set())


def _safe(obj, _seen):
    if isinstance(obj, bool) or obj is None or isinstance(obj, (str, int)):
        return obj
    if isinstance(obj, float):
        return obj if math.isfinite(obj) else None
    # numpy scalars / 0-d arrays expose .item(); ndarrays expose .tolist()
    item = getattr(obj, "item", None)
    if item is not None and getattr(obj, "shape", None) in ((), None):
        try:
            return _safe(item(), _seen)
        except Exception:  # noqa: BLE001 - fall through to str()
            pass
    tolist = getattr(obj, "tolist", None)
    if tolist is not None:
        try:
            return _safe(tolist(), _seen)
        except Exception:  # noqa: BLE001 - fall through to str()
            pass
    if isinstance(obj, dict):
        oid = id(obj)
        if oid in _seen:
            return "<cycle>"
        _seen.add(oid)
        out = {}
        for k, v in obj.items():
            if not isinstance(k, str):
                k = _safe(k, _seen)
                k = "null" if k is None else str(k)
            out[k] = _safe(v, _seen)
        _seen.discard(oid)
        return out
    if isinstance(obj, (list, tuple, set, frozenset)):
        oid = id(obj)
        if oid in _seen:
            return ["<cycle>"]
        _seen.add(oid)
        out = [_safe(v, _seen) for v in obj]
        _seen.discard(oid)
        return out
    return str(obj)


def dumps_safe(obj, **kw) -> str:
    """``json.dumps(json_safe(obj), allow_nan=False, **kw)`` — the
    convenience every in-package export path calls.  ``allow_nan=False``
    stays on even after sanitizing: if a future edit routes an unsafe
    value around :func:`json_safe`, the export raises loudly instead of
    emitting an RFC-invalid body."""
    kw.setdefault("allow_nan", False)
    return json.dumps(json_safe(obj), **kw)
