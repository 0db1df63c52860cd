"""Verdicts: kernel access summaries × declared transfer flags.

A copy of the reference's ``analysis/verdict.py``: the same vocabulary,
fingerprints and suppressions, over the port's ``TransferFlags``
(``arrays/clarray.py``, the same fields).  The text below is the
reference's.

:func:`verify_launch` takes the flag-independent per-kernel summaries
(``interp.summarize_kernel``) plus the launch's declared
:class:`TransferFlags` rows and produces named findings in two
severities:

- **errors** — the launch is provably (or unprovably-and-therefore-
  presumed) unsafe to split: running it partitioned across lanes can
  produce results that differ from the unsplit run, or reads data the
  declared flags never upload.  ``CK_KERNEL_VERIFY=strict`` turns
  these into raised :class:`KernelVerifyError` / serve rejections.
- **advisories** — the launch is correct but wasteful (an over-broad
  full read on a gid-confined access pays H2D bytes every call), or
  outside the analyzable surface (``@kernel`` Python kernels).

The kind vocabulary is :data:`VERDICT_KINDS`; the table in
``docs/STATIC_ANALYSIS.md`` is cross-checked against it by test (the
``lint_obs`` two-way discipline).  Findings on lines carrying a
``// ckprove: ok`` comment (or directly below one) are suppressed —
annotation is documentation, not a mute button: say why.
"""

from __future__ import annotations

import hashlib
import math
from collections import namedtuple
from dataclasses import dataclass

from .interp import AV, KernelSummary

__all__ = [
    "VERDICT_KINDS", "ERROR_KINDS", "ADVISORY_KINDS",
    "Finding", "LaunchVerdict", "FlagRow",
    "classify", "flag_row", "structural_findings", "suppressed_lines",
    "verify_launch",
]

#: The declared verdict vocabulary (the ``DECISION_KINDS`` contract,
#: applied to kernel verification).  docs/STATIC_ANALYSIS.md carries
#: the human table; a drift between the two fails tier-1.
VERDICT_KINDS = (
    "off-partition-write",   # error: write provably outside the lane's slice
    "scatter-write",         # error: write at an unprovable (gathered) index
    "write-all-clipped",     # error: write_all discards non-owner partitions
    "partial-read-halo",     # error: partial_read but reads leave the window
    "partial-read-gather",   # error: partial_read but reads gather/roam
    "write-only-read",       # error: write_only but read-before-write
    "window-raw",            # error: cross-lane RAW hazard across the window
    "partial-safe",          # advisory: full read, provably gid-confined
    "unread-upload",         # advisory: read flag, never read
    "unwritten-writeback",   # advisory: write flag, never written
    "unverifiable",          # advisory: kernel outside the analyzable surface
)

ERROR_KINDS = VERDICT_KINDS[:7]
ADVISORY_KINDS = VERDICT_KINDS[7:]


@dataclass(frozen=True)
class Finding:
    """One verdict finding.  The fingerprint excludes the line number
    (the ckcheck ratchet rule: edits above a finding must not churn
    the baseline); ``where``+``kernel``+``param`` carry identity."""

    kind: str
    severity: str           # "error" | "advisory"
    where: str              # corpus file / "<compute>" / caller tag
    kernel: str
    param: str              # kernel parameter name ("*" = whole kernel)
    line: int               # 1-based line in the KERNEL SOURCE string
    message: str

    @property
    def fingerprint(self) -> str:
        raw = f"ckprove:{self.kind}:{self.where}:{self.kernel}:{self.param}"
        return hashlib.sha1(raw.encode()).hexdigest()[:16]

    @property
    def path(self) -> str:
        """Alias so the ckcheck baseline/ratchet machinery (which
        sorts findings by ``path``) applies unchanged."""
        return self.where

    def render(self) -> str:
        return (f"[{self.fingerprint}] {self.severity}/{self.kind} "
                f"{self.where}:{self.kernel}:{self.line}: {self.message}")

    def to_row(self) -> dict:
        return {
            "fingerprint": self.fingerprint,
            "kind": self.kind,
            "severity": self.severity,
            "path": self.where,
            "kernel": self.kernel,
            "param": self.param,
            "line": self.line,
            "message": self.message,
        }


@dataclass(frozen=True)
class LaunchVerdict:
    """All findings for one (kernel sequence, flags) launch shape."""

    findings: tuple = ()

    @property
    def errors(self) -> tuple:
        return tuple(f for f in self.findings if f.severity == "error")

    @property
    def advisories(self) -> tuple:
        return tuple(f for f in self.findings if f.severity == "advisory")

    @property
    def ok(self) -> bool:
        return not self.errors


#: The flag surface the verdict reads — a plain tuple so launch
#: verdicts cache on it and decision records serialize it.
FlagRow = namedtuple(
    "FlagRow",
    ["read", "partial_read", "write", "write_all", "read_only",
     "write_only", "epw"],
)


def flag_row(flags) -> FlagRow:
    """Project a :class:`TransferFlags` (duck-typed) into a hashable
    :class:`FlagRow`.

    Memoized on the flags instance: the runtime gate rebuilds rows on
    every per-call dispatch, which must not tax the host-dispatch
    floor the repo benchmarks.  Safe because the flag API replaces
    ``TransferFlags`` objects (``ClArray._set_flag``/``wrap`` go
    through ``dataclasses.replace``) rather than mutating them — a new
    flag combination is a new object with no cached row."""
    row = getattr(flags, "_ckprove_row", None)
    if row is None:
        row = FlagRow(
            read=bool(flags.read),
            partial_read=bool(flags.partial_read),
            write=bool(flags.write),
            write_all=bool(flags.write_all),
            read_only=bool(flags.read_only),
            write_only=bool(flags.write_only),
            epw=int(flags.elements_per_work_item),
        )
        try:
            flags._ckprove_row = row
        except Exception:  # noqa: BLE001 - frozen/slotted duck: skip
            pass
    return row


def classify(av: AV, epw: int = 1):
    """Classify one access index against the lane's per-item window.

    Returns ``(klass, halo_width)`` with klass one of

    - ``"confined"`` — ``epw·gid + [0, epw)``: lands inside the item's
      own elements for ANY split;
    - ``"halo"`` — gid-affine at the right stride but the offset leaves
      the window by a bounded ``halo_width`` elements;
    - ``"stride"`` — gid-affine at the WRONG stride (coef != epw);
    - ``"uniform"`` — identical across items (constants included):
      lane-relative position is unbounded under a split;
    - ``"gather"`` — not affine in gid (data-dependent / modular /
      unbounded offset): nothing provable.
    """
    if av.coef is None:
        return "gather", None
    if av.coef == 0:
        return "uniform", None
    if av.coef == float(epw):
        if 0 <= av.lo and av.hi <= epw - 1:
            return "confined", 0
        lo_over = max(0.0, 0 - av.lo)
        hi_over = max(0.0, av.hi - (epw - 1))
        width = max(lo_over, hi_over)
        if math.isfinite(width):
            return "halo", int(width)
        return "gather", None
    return "stride", None


def suppressed_lines(source: str) -> frozenset:
    """Re-export of the interp helper for callers that hold raw
    source (the CLI's per-file scan)."""
    from .interp import _suppressed_lines

    return _suppressed_lines(source)


def _covered_earlier(prior_sums, pos: int, epw: int) -> bool:
    """True when an EARLIER kernel in the sequence unconditionally
    writes parameter ``pos`` gid-confined — its device-local stores
    persist, so a later kernel's read-before-write is covered.  An
    unanalyzable predecessor MAY cover: stay silent (errors must be
    provable)."""
    for s in prior_sums:
        if s is None:
            return True
        if pos < len(s.array_params):
            pname = s.array_params[pos]
            for av in s.must_writes.get(pname, ()):
                if classify(av, epw)[0] == "confined":
                    return True
    return False


def _off_partition_reads(summary: KernelSummary, pname: str, epw: int):
    out = []
    for acc in summary.reads.get(pname, ()):
        klass, width = classify(acc.av, epw)
        if klass != "confined":
            out.append((acc, klass, width))
    return out


def verify_launch(
    summaries: dict,
    kernel_names,
    flag_rows,
    window: bool = False,
    where: str = "<compute>",
) -> LaunchVerdict:
    """Prove or refute split-safety and flag soundness for one launch.

    ``summaries`` maps kernel name → :class:`KernelSummary` (or None
    for kernels outside the analyzable surface — Python/Pallas
    kernels); ``flag_rows`` is the positional :class:`FlagRow` tuple of
    the call's parameter list (kernel k binds the first
    ``len(summary.array_params)`` rows, the dispatch contract).
    ``window=True`` additionally treats the kernel sequence as cyclic
    (enqueue windows / fused ladders repeat it), so a RAW hazard from
    kernel B's read back into kernel A's write across iterations is
    reported too.
    """
    findings: list[Finding] = []
    seen: set = set()

    def emit(kind, kernel, param, line, message, suppressed=frozenset()):
        if line in suppressed:
            return
        severity = "error" if kind in ERROR_KINDS else "advisory"
        key = (kind, kernel, param, line)
        if key in seen:
            return
        seen.add(key)
        findings.append(Finding(
            kind=kind, severity=severity, where=where, kernel=kernel,
            param=param, line=line, message=message))

    names = tuple(kernel_names)
    rows = tuple(flag_rows)
    sums: list[KernelSummary | None] = [summaries.get(n) for n in names]
    for ki, name in enumerate(names):
        s = sums[ki]
        if s is None:
            emit(
                "unverifiable", name, "*", 0,
                f"kernel {name!r} is outside the analyzable surface "
                "(Python/Pallas kernel or analysis bail-out) — flags "
                "and split-safety are unchecked")
            continue
        sup = s.suppressed
        for pos, pname in enumerate(s.array_params):
            if pos >= len(rows):
                break  # arg-count mismatch: compute() validation's job
            fl = rows[pos]
            epw = max(1, fl.epw)
            reads = s.reads.get(pname, ())
            writes = s.writes.get(pname, ())
            reads_flag = fl.read and not fl.write_only
            writes_back = fl.write and not fl.read_only

            if writes_back:
                for acc in writes:
                    klass, width = classify(acc.av, epw)
                    if klass == "confined":
                        if fl.write_all:
                            emit(
                                "write-all-clipped", name, pname, acc.line,
                                f"{name}: write_all on {pname!r} whose "
                                "writes are gid-confined — the owner lane "
                                "writes back the WHOLE array, discarding "
                                "every other lane's partition on any "
                                ">1-lane split", sup)
                        continue
                    if klass == "gather":
                        emit(
                            "scatter-write", name, pname, acc.line,
                            f"{name}: write to {pname}[…] at a gathered/"
                            "indirect index — cannot prove the store lands "
                            "inside the caller's partition; a split lane "
                            "drops every off-partition store at readback",
                            sup)
                    else:
                        detail = (
                            f"halo offset {width} outside the per-item "
                            f"window" if klass == "halo" else
                            f"stride {acc.av.coef:g} != elements/item "
                            f"{epw}" if klass == "stride" else
                            "uniform index (same element from every item)")
                        emit(
                            "off-partition-write", name, pname, acc.line,
                            f"{name}: write to {pname}[…] provably leaves "
                            f"the caller's partition ({detail}) — "
                            "off-partition stores are silently dropped at "
                            "the lane's sliced readback", sup)

            if reads_flag and fl.partial_read:
                for acc, klass, width in _off_partition_reads(s, pname, epw):
                    if klass == "halo":
                        emit(
                            "partial-read-halo", name, pname, acc.line,
                            f"{name}: partial_read on {pname!r} but the "
                            f"kernel reads a halo of {width} element(s) "
                            "beyond the item's window — each lane only "
                            "receives its own slice, halo elements arrive "
                            "as zeros", sup)
                    else:
                        emit(
                            "partial-read-gather", name, pname, acc.line,
                            f"{name}: partial_read on {pname!r} but the "
                            f"kernel reads it at a {klass} index — lanes "
                            "only receive their own slice; declare a full "
                            "read", sup)

            if fl.write_only and pname in s.rbw and \
                    not _covered_earlier(sums[:ki], pos, epw):
                emit(
                    "write-only-read", name, pname, s.rbw[pname],
                    f"{name}: write_only on {pname!r} but the kernel reads "
                    "it before any covering write — write_only arrays are "
                    "never uploaded, the read sees zeros, not host data",
                    sup)

    # launch-level waste advisories aggregate over the whole SEQUENCE:
    # an upload is unread only if NO kernel in the sequence reads it,
    # and a full read is partial-eligible only if EVERY kernel's reads
    # of that position are gid-confined.  Skipped when any kernel is
    # unanalyzable — it may touch the array in ways we cannot see.
    if sums and all(s is not None for s in sums):
        n_pos = min(len(rows), max(len(s.array_params) for s in sums))
        for pos in range(n_pos):
            fl = rows[pos]
            epw = max(1, fl.epw)
            users = [s for s in sums if pos < len(s.array_params)]
            if not users:
                continue
            reads_all = [
                (s, a) for s in users
                for a in s.reads.get(s.array_params[pos], ())]
            writes_all = [
                (s, a) for s in users
                for a in s.writes.get(s.array_params[pos], ())]
            reads_flag = fl.read and not fl.write_only
            writes_back = fl.write and not fl.read_only
            pname = users[0].array_params[pos]
            if reads_flag and not fl.partial_read and reads_all and all(
                    classify(a.av, epw)[0] == "confined"
                    for _s, a in reads_all):
                s0, a0 = reads_all[0]
                emit(
                    "partial-safe", s0.name, s0.array_params[pos], a0.line,
                    f"every read of {pname!r} across the sequence is "
                    "gid-confined — partial_read=True would upload only "
                    "each lane's slice (free H2D reduction)",
                    s0.suppressed)
            if reads_flag and not reads_all:
                emit(
                    "unread-upload", users[0].name, pname, users[0].line,
                    f"{pname!r} is uploaded (read flag) but no kernel in "
                    "the sequence reads it — H2D bytes wasted every call",
                    users[0].suppressed)
            if writes_back and not writes_all:
                emit(
                    "unwritten-writeback", users[0].name, pname,
                    users[0].line,
                    f"{pname!r} is written back (write flag) but no "
                    "kernel in the sequence writes it — D2H bytes wasted "
                    "every call", users[0].suppressed)

    # cross-kernel window hazards: A writes p, B reads p off-partition.
    # Device-local writes persist across the window whether or not the
    # flags write them back, so ANY write counts as a hazard source.
    writers: dict[int, list] = {}
    off_readers: dict[int, list] = {}
    for ki, (name, s) in enumerate(zip(names, sums)):
        if s is None:
            continue
        for pos, pname in enumerate(s.array_params):
            if pos >= len(rows):
                break
            epw = max(1, rows[pos].epw)
            if s.writes.get(pname):
                writers.setdefault(pos, []).append((ki, name))
            for acc, klass, width in _off_partition_reads(s, pname, epw):
                off_readers.setdefault(pos, []).append(
                    (ki, name, pname, acc.line, klass, s.suppressed))
    for pos, ws in writers.items():
        for wi, wname in ws:
            for ri, rname, pname, line, klass, sup in \
                    off_readers.get(pos, ()):
                ordered = ri >= wi  # same kernel: chunk-ladder order
                if not (ordered or window):
                    continue
                how = ("across window iterations"
                       if window and not ordered else "within the sequence")
                emit(
                    "window-raw", rname, pname, line,
                    f"{wname} writes parameter #{pos} and {rname} reads "
                    f"it {klass}-indexed ({how}) — a lane reads elements "
                    "another lane wrote, which never left that lane's "
                    "device: cross-lane RAW hazard under any >1-lane "
                    "split", sup)

    return LaunchVerdict(findings=tuple(findings))


def structural_findings(
    summary: KernelSummary, where: str, epw: int = 1,
) -> list:
    """Flag-independent findings for the CLI's repo-corpus scan, where
    no :class:`TransferFlags` exist statically: split-safety of the
    write set (assuming the default one element per work item).  Read
    classifications surface in the CLI's ``--json`` report as facts,
    not findings — whether a halo read is an error depends on flags
    only the call site knows."""
    v = verify_launch(
        {summary.name: summary}, (summary.name,),
        (FlagRow(True, False, True, False, False, False, epw),)
        * len(summary.array_params),
        window=False, where=where)
    keep = ("off-partition-write", "scatter-write")
    return [f for f in v.findings if f.kind in keep]
