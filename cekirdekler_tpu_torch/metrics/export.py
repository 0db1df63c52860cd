"""Metric exports: Prometheus text format, JSON snapshot, and Perfetto
counter-track events for the Chrome-trace merge.

A copy of ``cekirdekler_tpu/metrics/export.py`` kept in the port (which never
imports the JAX package); the text below is the reference's.

Three consumers, three formats, one source of truth (the registry):

- ``prometheus_text()`` — the ``text/plain; version=0.0.4`` exposition
  format every Prometheus-compatible scraper parses.  Counters render as
  one line per series, histograms as cumulative ``_bucket{le=...}``
  lines plus ``_sum``/``_count`` (standard ``le`` semantics).
- ``json_snapshot()`` — the deterministic dict `MetricsRegistry.snapshot`
  produces, ready to embed in bench artifacts (bench.py does).
- ``chrome_counter_events()`` — Chrome-trace ``ph: "C"`` counter events
  from sampled series, merged into the span export by
  ``trace.export.to_chrome_trace(..., counters=...)`` so balancer
  shares / queue depths / byte counters ride the SAME Perfetto timeline
  as the spans that explain them.
"""

from __future__ import annotations

from typing import Mapping, Sequence

from .registry import REGISTRY, MetricsRegistry

__all__ = [
    "prometheus_text",
    "prometheus_from_snapshot",
    "parse_prometheus_text",
    "json_snapshot",
    "chrome_counter_events",
]


def _fmt(v: float) -> str:
    if isinstance(v, float):
        # Prometheus exposition spells non-finite values +Inf/-Inf/NaN;
        # int(inf) raises, which used to 500 the whole /metrics page
        # over one inf gauge
        if v != v:
            return "NaN"
        if v in (float("inf"), float("-inf")):
            return "+Inf" if v > 0 else "-Inf"
        if v == int(v) and abs(v) < 1e15:
            return str(int(v))
        return repr(v)
    return str(v)


def _split_series(series: str) -> tuple[str, str]:
    """``name{labels}`` → (name, labels-without-braces)."""
    if "{" in series:
        name, rest = series.split("{", 1)
        return name, rest.rstrip("}")
    return series, ""


def _with_labels(name: str, labels: str, extra: str = "") -> str:
    inner = ",".join(x for x in (labels, extra) if x)
    return f"{name}{{{inner}}}" if inner else name


def prometheus_from_snapshot(snapshot: dict,
                             help_map: dict | None = None) -> str:
    """A :meth:`MetricsRegistry.snapshot` dict in Prometheus exposition
    format — THE renderer (``prometheus_text`` and the artifact replay
    in tools/metrics_dump.py both use it, so a live scrape and an
    artifact re-render are label-for-label identical).  Sorted, so
    equal snapshots produce byte-equal output."""
    help_map = help_map or {}
    lines: list[str] = []
    seen: set[str] = set()

    def header(name: str, kind: str) -> None:
        if name not in seen:
            seen.add(name)
            if help_map.get(name):
                lines.append(f"# HELP {name} {help_map[name]}")
            lines.append(f"# TYPE {name} {kind}")

    for kind_key, kind in (("counters", "counter"), ("gauges", "gauge")):
        block = snapshot.get(kind_key) or {}
        for series in sorted(block):
            name, labels = _split_series(series)
            header(name, kind)
            lines.append(f"{_with_labels(name, labels)} {_fmt(block[series])}")
    for series in sorted(snapshot.get("histograms") or {}):
        v = snapshot["histograms"][series]
        name, labels = _split_series(series)
        header(name, "histogram")
        cum = 0
        for ub, c in zip(v["buckets"], v["counts"]):
            cum += c
            le = 'le="%s"' % _fmt(ub)
            lines.append(f"{_with_labels(name + '_bucket', labels, le)} {cum}")
        cum += v["counts"][-1]
        le_inf = 'le="+Inf"'
        lines.append(
            f"{_with_labels(name + '_bucket', labels, le_inf)} {cum}")
        lines.append(f"{_with_labels(name + '_sum', labels)} {v['sum']}")
        lines.append(f"{_with_labels(name + '_count', labels)} {v['count']}")
    return "\n".join(lines) + ("\n" if lines else "")


def parse_prometheus_text(text: str) -> dict:
    """The exposition format back into ``{"types": {name: kind},
    "series": {series: value}}`` — the inverse the HTTP consumers need
    (``tools/metrics_dump.py --watch`` polling a live ``/metrics``
    endpoint, and the debug-server integration test's "parses as
    Prometheus text" gate).  Histogram ``_bucket``/``_sum``/``_count``
    lines ride as plain series.  Raises ``ValueError`` on a line that
    is neither a comment nor a ``series value`` pair — a scrape that
    half-parses must fail loudly, not render a half-table."""
    types: dict[str, str] = {}
    series: dict[str, float] = {}
    for lineno, line in enumerate(text.splitlines(), 1):
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split()
            if len(parts) >= 4 and parts[1] == "TYPE":
                types[parts[2]] = parts[3]
            continue
        # the series name ends at the close of its label block (or the
        # first bare space for label-less series — label VALUES may
        # contain spaces, so brace depth decides, not split()); what
        # follows is `value [timestamp]` per the exposition spec —
        # splitting at the LAST space would eat the optional timestamp
        # as the value and fold the real value into the series key
        depth = 0
        end = -1
        for i, ch in enumerate(line):
            if ch == "{":
                depth += 1
            elif ch == "}":
                depth -= 1
                if depth == 0:
                    end = i + 1
                    break
            elif ch == " " and depth == 0:
                end = i
                break
        if end < 0:
            raise ValueError(f"unparseable exposition line {lineno}: {line!r}")
        name = line[:end]
        rest = line[end:].split()
        if not rest or len(rest) > 2:  # value + optional timestamp only
            raise ValueError(f"unparseable exposition line {lineno}: {line!r}")
        try:
            series[name] = float(rest[0])
        except ValueError as e:
            raise ValueError(
                f"non-numeric sample on line {lineno}: {line!r}") from e
    return {"types": types, "series": series}


def prometheus_text(registry: MetricsRegistry | None = None) -> str:
    """The live registry in Prometheus exposition format (the snapshot
    renderer plus the registry's help strings)."""
    reg = registry if registry is not None else REGISTRY
    return prometheus_from_snapshot(
        reg.snapshot(), help_map={m.name: m.help for m in reg if m.help})


def json_snapshot(registry: MetricsRegistry | None = None) -> dict:
    """Deterministic JSON-able snapshot (bench artifacts embed this)."""
    reg = registry if registry is not None else REGISTRY
    return reg.snapshot()


def chrome_counter_events(
    series: Mapping[str, Sequence[tuple[float, float]]],
    t_base: float,
    pid: int = 1,
) -> list[dict]:
    """Chrome-trace counter events (``ph: "C"``) from sampled series.

    ``series`` is ``MetricsRegistry.counter_series()`` output; ``t_base``
    the perf_counter origin the span export used, so counter samples and
    spans land on one timeline.  Samples before ``t_base`` are dropped
    (they predate the window being exported)."""
    events: list[dict] = []
    for name in sorted(series):
        for t, v in series[name]:
            if t < t_base:
                continue
            events.append({
                "ph": "C",
                "name": name,
                "pid": pid,
                "ts": (t - t_base) * 1e6,
                "args": {"value": v},
            })
    return events
