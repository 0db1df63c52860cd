"""The overlap ceiling, re-derived per rep — a ruler that bounds from
above.

A copy of ``cekirdekler_tpu/trace/ceiling.py`` (pure arithmetic; the port
never imports the JAX package), read by
``workloads.measure_stream_overlap(duplex_probe=True)``.  The text below is
the reference's.

VERDICT r5 #4: the round-5 artifact reported
``overlap_compute_bound_vs_ceiling: 1.15`` — achieved overlap EXCEEDED
the "ceiling", so the ceiling wasn't one.  Root causes, both fixed here:

1. **Cross-rep mixing.**  The old model computed one ceiling from the
   per-phase MEDIANS across all reps while the achieved overlap came
   from the same medians of DIFFERENT samples — on a link whose
   bandwidth drifts 2× within a measurement, the ceiling's duplex
   capacity and the achieved pipelined time were measured under
   different weather.  Here every rep carries its OWN complete sample
   (r, c, w, pipelined, h2d, d2h, duplex — all from the same
   interleaved round), the ratio is computed per rep, and the artifact
   reports the median WITH the per-rep spread.

2. **No witness clamp.**  A measured pipelined run is an existence
   proof: the best reachable pipelined time cannot exceed a time that
   was actually reached in the same rep.  The model's
   ``p_model = max(c, rw_eff) + (r + w)/blobs`` is a prediction built
   from probe measurements; when the engine beats it (duplex capacity
   probed low, fill/drain edge over-charged), the truth is that the
   model under-predicted — so the per-rep ceiling is
   ``p_best = min(p_model, p_measured)``.  This pins
   ``achieved_vs_ceiling ≤ 1.0`` STRUCTURALLY (a broken model shows up
   as the ratio saturating at 1.0 with ``model_beaten`` flagged, never
   as a ratio above 1), while a genuinely under-achieving engine still
   reads < 1 — the clamp only moves the ceiling DOWN to witnessed
   reality, never the achievement up.

Model terms (same physics as before, now same-rep): compute rides the
chip and overlaps transfers freely; reads and writes share the host
link and overlap each other only to the measured duplex degree
``dc = (h2d + d2h − duplex) / min(h2d, d2h)`` (clamped to [0, 1]); and
every blob schedule pays the fill/drain edge — the first blob's upload
runs before any compute and the last blob's download after its compute,
one blob's worth of r and of w that no schedule hides.
"""

from __future__ import annotations

from dataclasses import dataclass
from statistics import median as _median

__all__ = ["RepSample", "rep_ceiling", "ceiling_report"]


@dataclass
class RepSample:
    """One interleaved round's complete measurement (milliseconds)."""

    r: float          # read (H2D) phase
    c: float          # compute phase
    w: float          # write (D2H) phase
    p: float          # pipelined total
    h2d: float        # pure-H2D duplex probe
    d2h: float        # pure-D2H duplex probe
    dup: float        # simultaneous H2D ∥ D2H probe


def rep_ceiling(s: RepSample, blobs: int) -> dict:
    """One rep's ceiling + achieved + ratio, from that rep alone."""
    serial = s.r + s.c + s.w
    ideal = serial - max(s.r, s.c, s.w)
    dd = s.h2d + s.d2h - max(s.h2d, s.d2h)   # = min(h2d, d2h)
    dc = (s.h2d + s.d2h - s.dup) / dd if dd > 1e-9 else 0.0
    dc = min(max(dc, 0.0), 1.0)
    rw_eff = s.r + s.w - dc * min(s.r, s.w)
    p_model = max(s.c, rw_eff) + (s.r + s.w) / max(blobs, 1)
    p_best = min(p_model, s.p)  # witness clamp — see module docstring
    achieved = (serial - s.p) / ideal if ideal > 1e-9 else 0.0
    # the ratio divides by the RAW ceiling: p_best <= p makes
    # ceil_raw >= achieved, so achieved/ceil_raw <= 1 structurally even
    # when within-rep noise pushes both above 1 (the display value is
    # clamped to [0, 1], the ratio's denominator is not — clamping the
    # denominator first is exactly how a >1 "vs ceiling" escapes again).
    # The achieved NUMERATOR is floored at 0: a rep where pipelining ran
    # slower than serial (contention noise) achieved none of the
    # ceiling, and letting its negative ratio into the median would turn
    # "fraction of ceiling" into an unbounded-below quantity — the raw
    # achieved_overlap is returned alongside, and ceiling_report counts
    # such reps (negative_overlap_reps) so they are visible, not hidden
    ceil_raw = (serial - p_best) / ideal if ideal > 1e-9 else 0.0
    ratio = max(achieved, 0.0) / ceil_raw if ceil_raw > 1e-9 else None
    return {
        "duplex_capacity": dc,
        "p_model_ms": p_model,
        "p_best_ms": p_best,
        "model_beaten": s.p < p_model,   # the clamp fired this rep
        "achieved_overlap": achieved,
        "overlap_ceiling": min(max(ceil_raw, 0.0), 1.0),
        "achieved_vs_ceiling": ratio,
    }


def ceiling_report(samples: list[RepSample], blobs: int) -> dict:
    """Per-rep ceilings reduced to the artifact keys.

    ``achieved_vs_ceiling`` is the MEDIAN of the per-rep ratios (each
    structurally ≤ 1.0), ``achieved_vs_ceiling_spread`` the max−min of
    the per-rep ratios — the honesty channel: a large spread says the
    link drifted and the median should be read loosely."""
    reps = [rep_ceiling(s, blobs) for s in samples]
    if not reps:
        # degrade like the empty-ratios tail below, not a stdlib
        # StatisticsError from the first median
        return {
            "duplex_capacity": None, "overlap_ceiling": None,
            "model_beaten_reps": 0, "negative_overlap_reps": 0,
            "n_reps": 0, "per_rep_achieved_vs_ceiling": [],
            "achieved_vs_ceiling": None,
            "achieved_vs_ceiling_spread": None,
        }
    ratios = [r["achieved_vs_ceiling"] for r in reps
              if r["achieved_vs_ceiling"] is not None]
    out: dict = {
        "duplex_capacity": round(_median([r["duplex_capacity"] for r in reps]), 3),
        "overlap_ceiling": round(_median([r["overlap_ceiling"] for r in reps]), 4),
        "model_beaten_reps": sum(1 for r in reps if r["model_beaten"]),
        "negative_overlap_reps": sum(
            1 for r in reps if r["achieved_overlap"] < 0
        ),
        "n_reps": len(reps),
        "per_rep_achieved_vs_ceiling": [
            round(x, 3) for x in ratios
        ],
    }
    if ratios:
        out["achieved_vs_ceiling"] = round(_median(ratios), 3)
        out["achieved_vs_ceiling_spread"] = round(max(ratios) - min(ratios), 3)
    else:
        out["achieved_vs_ceiling"] = None
        out["achieved_vs_ceiling_spread"] = None
    return out
