"""Kernel time from a ``torch.profiler`` trace on the card, read one way
by ``chip_smoke.py`` and every tool here.

A trace on the H100 machine (torch 2.11.0+cu128) drops the record of the
first kernel launched after the profiler starts (in 94 of 108 windows of
ten calls), at times more than one, and has garbled a record's time; in
windows that first launch a short kernel and wait for it, every later
launch kept its record in 60 of 60 (``tools/trace_records.py``), but in
``chip_smoke.py`` one window lost the records of both its leads, and
three windows in a row lost a call's record after four leads.  So every window opens with :func:`open_window`,
which launches :data:`LEADS` such lead kernels in turn, and the readers
leave the leads' records out.  The per-call reader then takes records to
be lost, never added: an activity whose records fall short of a whole
number a call by at most half a call lost the rest (counted in
:data:`lost`), and its time a call is the mean of its kept records times
that number.  Each named kernel must come out so, with each record within
a factor of two of its median; a trace that fails is taken again
(:func:`traced_ms`), so neither a lost nor a garbled record reads low or
high.

It imports nothing of the package, so a tool run as a script that
imports the package from another checkout (``--root``) imports this
module from its own directory and times both checkouts the same way.
"""

from __future__ import annotations

#: the kernel of ``torch.cuda._sleep``, which :func:`open_window` launches
LEAD_KERNEL = "spin_kernel"
#: lead kernels a window opens with
LEADS = 4
#: traces :func:`traced_ms` takes of one window at most
TRIES = 5
#: what was wrong with each trace :func:`traced_ms` took again, for the caller to report
defects: list[str] = []
#: records of named kernels :func:`per_call_ms` found lost, for the caller to report
lost = 0


class TraceDefect(AssertionError):
    """A trace that lost a named kernel's record or garbled its time."""


def open_window() -> None:
    """First thing inside a profiler window: launch the lead kernel
    :data:`LEADS` times, waiting for each, so the records the trace drops
    at its start are the leads'."""
    import torch

    for _ in range(LEADS):
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()


def kernel_records(prof) -> list[tuple[str, float]]:
    """(name, device µs) of each device record of ``prof`` but the lead
    kernels'."""
    import torch

    return [(e.name, e.time_range.elapsed_us()) for e in prof.events()
            if getattr(e, "device_type", None) != torch.autograd.DeviceType.CPU
            and LEAD_KERNEL not in e.name]


def intervals(prof) -> list[tuple[str, float, float]]:
    """(name, start µs, end µs) of each device record of ``prof`` (kernels
    and copies) but the lead kernels', in the trace's own clock."""
    import torch

    out = []
    for e in prof.events():
        if getattr(e, "device_type", None) == torch.autograd.DeviceType.CPU:
            continue
        if LEAD_KERNEL in e.name:
            continue
        out.append((e.name, float(e.time_range.start), float(e.time_range.end)))
    return out


def overlapping(prof, first: str, second: str) -> list[tuple[str, str]]:
    """Pairs of device records of ``prof``, one whose name holds ``first``
    and one whose name holds ``second``, that ran at the same time."""
    recs = intervals(prof)
    a = [r for r in recs if first in r[0]]
    b = [r for r in recs if second in r[0]]
    return [(x[0], y[0]) for x in a for y in b if x[1] < y[2] and y[1] < x[2]]


def by_name(prof) -> list[tuple[str, float, int]]:
    """(name, device ms, records) of each activity in ``prof`` but the lead
    kernels, the longest first."""
    rows: dict[str, list] = {}
    for name, us in kernel_records(prof):
        row = rows.setdefault(name, [0.0, 0])
        row[0] += us / 1e3
        row[1] += 1
    return sorted(((n, ms, c) for n, (ms, c) in rows.items()), key=lambda r: -r[1])


def per_call_ms(prof, reps: int, names: tuple[str, ...] = ()) -> dict[str, float]:
    """Device ms a call, over a window of ``reps`` calls, of the kernels
    whose names hold each of ``names`` and of all device activity
    (``"total"``).  An activity whose records are short of a whole number
    a call by at most ``reps // 2`` launches that number a call and lost
    the rest: its time a call is the mean of its records times that
    number.  Any other activity's time a call is the sum of its records
    over ``reps``.  Raises :class:`TraceDefect` when a name has no record,
    or one of its kernels is not read the first way or has a record that
    is not within a factor of two of that kernel's median."""
    global lost
    records: dict[str, list[float]] = {}
    for key, us in kernel_records(prof):
        records.setdefault(key, []).append(us)
    out = dict.fromkeys((*names, "total"), 0.0)
    for key, us in records.items():
        per_call = -(-len(us) // reps)
        missing = per_call * reps - len(us)
        whole = 2 * missing <= reps
        ms = (sum(us) / len(us) * per_call if whole else sum(us) / reps) / 1e3
        out["total"] += ms
        mine = [name for name in names if name in key]
        if not mine:
            continue
        mid = sorted(us)[len(us) // 2]
        if not whole or not all(mid / 2 <= x <= mid * 2 for x in us):
            raise TraceDefect(f"the trace holds {len(us)} records of {key!r} over {reps} "
                              f"calls, {min(us)}-{max(us)} µs each")
        lost += missing
        for name in mine:
            out[name] += ms
    for name in names:
        if not any(name in key for key in records):
            raise TraceDefect(f"the trace holds no record of {name!r}")
    if out["total"] <= 0.0:
        raise TraceDefect("the trace shows no device time")
    return out


def traced_ms(fn, reps: int, names: tuple[str, ...] = ()) -> dict[str, float]:
    """:func:`per_call_ms` of a trace of ``reps`` calls of ``fn``, after one
    untraced call; a trace with a defect is taken again (counted in
    :data:`defects`), up to :data:`TRIES` traces in all."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    tries = TRIES
    while True:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            open_window()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        try:
            return per_call_ms(prof, reps, names)
        except TraceDefect as exc:
            tries -= 1
            if tries <= 0:
                raise
            defects.append(str(exc))
