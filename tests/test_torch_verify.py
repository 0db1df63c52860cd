"""The port's kernel partition-safety verifier (``analysis/``) and the
compute-time verify gate, against the reference's.

- ``verify_launch`` gives the same findings (kind, severity, kernel, param,
  line, fingerprint) in both packages on every entry of the reference's
  differential corpus (``tests/kernel_corpus.py``) and on the main path's
  launch shapes (``chip_smoke.verify_shapes``), and the reference finds
  clean exactly the shapes ``chip_smoke.VERIFY_CLEAN`` names.
- A real 2-lane split on host lanes of the port anchors each safe corpus
  entry bit for bit against the unsplit run; the planted halo entry
  differs at the partition boundary.
- The gate in ``Cores.compute``: advisory records one ``kernel-verify``
  flight event per (kernel sequence, finding), strict raises
  ``KernelVerifyError`` before any transfer, launch or window
  bookkeeping, off skips it; one verdict is cached per launch shape.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np
import pytest

from cekirdekler_tpu import analysis as ref_analysis
from cekirdekler_tpu.arrays.clarray import TransferFlags as RefFlags
from cekirdekler_tpu.kernel import lang as ref_lang
import cekirdekler_tpu_torch as ck
from cekirdekler_tpu_torch import analysis
from cekirdekler_tpu_torch import workloads as wl
from cekirdekler_tpu_torch.arrays.clarray import TransferFlags
from cekirdekler_tpu_torch.errors import KernelVerifyError
from cekirdekler_tpu_torch.kernel import lang, registry
from cekirdekler_tpu_torch.kernel.registry import KernelProgram
from cekirdekler_tpu_torch.obs.flight import FLIGHT
from tests import kernel_corpus as corpus
from tests.test_torch_metrics import restore_planes, save_planes

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


@pytest.fixture(autouse=True)
def _planes(monkeypatch):
    monkeypatch.delenv("CK_KERNEL_VERIFY", raising=False)
    saved = save_planes()
    yield
    restore_planes(saved)


def _key(v) -> list[tuple]:
    return [(f.kind, f.severity, f.kernel, f.param, f.line, f.fingerprint, f.message)
            for f in v.findings]


def _both(source: str | None, names, flags, window: bool, where: str):
    """The two packages' verdicts on one launch shape (``source`` None: a
    Python kernel, outside the analyzable surface)."""
    if source is None:
        mine_s = {n: None for n in names}
        ref_s = dict(mine_s)
    else:
        mine_s = {k.name: analysis.summarize_kernel(k) for k in lang.parse_kernels(source)}
        ref_s = {k.name: ref_analysis.summarize_kernel(k) for k in ref_lang.parse_kernels(source)}
    mine = analysis.verify_launch(mine_s, tuple(names),
                                  tuple(analysis.flag_row(TransferFlags(**f)) for f in flags),
                                  window=window, where=where)
    ref = ref_analysis.verify_launch(ref_s, tuple(names),
                                     tuple(ref_analysis.flag_row(RefFlags(**f)) for f in flags),
                                     window=window, where=where)
    return mine, ref


@pytest.mark.parametrize("entry", corpus.CORPUS, ids=lambda e: e.name)
def test_corpus_verdicts_are_the_reference_s(entry):
    names = [k.name for k in ref_lang.parse_kernels(entry.source)]
    for window in sorted({entry.window, False}):
        mine, ref = _both(entry.source, names, entry.flags, window, f"corpus:{entry.name}")
        assert _key(mine) == _key(ref)
    mine, _ = _both(entry.source, names, entry.flags, entry.window, f"corpus:{entry.name}")
    assert sorted({f.kind for f in mine.errors}) == sorted(set(entry.expect))
    assert corpus.verdict_for(entry).errors == ref.errors


@pytest.mark.parametrize("shape", chip_smoke.verify_shapes(wl),
                         ids=lambda s: s["label"])
def test_main_path_shapes_are_the_reference_s(shape):
    for window in (False, True):
        mine, ref = _both(shape["source"], shape["names"], shape["flags"], window, "<compute>")
        assert _key(mine) == _key(ref)
        assert (not ref.errors) == (shape["label"] in chip_smoke.VERIFY_CLEAN)


@pytest.mark.parametrize("full", [False, True], ids=["halo", "full-read"])
def test_planted_stencil_shapes(full):
    flags = chip_smoke.stencil_flags(full)
    mine, ref = _both(chip_smoke.STENCIL_SRC, ["stencil3"], flags, False, "<compute>")
    assert _key(mine) == _key(ref)
    kinds = {f.kind for f in mine.errors}
    assert kinds == (set() if full else {"partial-read-halo"})


def test_structural_findings_and_suppressions_are_the_reference_s():
    for entry in corpus.CORPUS:
        for mk, rk in zip(lang.parse_kernels(entry.source), ref_lang.parse_kernels(entry.source)):
            mine = analysis.structural_findings(analysis.summarize_kernel(mk), where="x")
            ref = ref_analysis.structural_findings(ref_analysis.summarize_kernel(rk), where="x")
            assert [(f.kind, f.line, f.fingerprint) for f in mine] == \
                [(f.kind, f.line, f.fingerprint) for f in ref]
    src = corpus.CORPUS[[e.name for e in corpus.CORPUS].index("shift_write")].source
    quiet = src.replace("out[i+1] = x[i];", "out[i+1] = x[i]; // ckprove: ok planted")
    for pkg, lg in ((analysis, lang), (ref_analysis, ref_lang)):
        (k,) = lg.parse_kernels(quiet)
        rows = (pkg.flag_row(TransferFlags(partial_read=True, read_only=True)),
                pkg.flag_row(TransferFlags(write_only=True)))
        v = pkg.verify_launch({k.name: pkg.summarize_kernel(k)}, (k.name,), rows)
        assert not v.errors
    assert analysis.VERDICT_KINDS == ref_analysis.VERDICT_KINDS
    assert analysis.ERROR_KINDS == ref_analysis.ERROR_KINDS
    assert analysis.ADVISORY_KINDS == ref_analysis.ADVISORY_KINDS


def _run_entry(entry, lanes: int) -> list[np.ndarray]:
    """One corpus entry through the port's compute() on ``lanes`` host
    lanes (enqueue mode over its iterations for a window entry)."""
    kdefs, flags, host = corpus.build(entry)
    arrays = [ck.ClArray(h.copy(), name=f"p{i}", **kw)
              for i, (h, kw) in enumerate(zip(host, entry.flags))]
    group = arrays[0]
    for a in arrays[1:]:
        group = group.next_param(a)
    names = " ".join(k.name for k in kdefs)
    with ck.NumberCruncher(ck.all_devices().cpus(lanes), entry.source) as cr:
        cr.enqueue_mode = entry.iters > 1
        for _ in range(entry.iters):
            group.compute(cr, 1, names, entry.global_range, entry.local_range,
                          values=entry.values)
        cr.enqueue_mode = False
    return [a.host().copy() for a in arrays]


@pytest.mark.parametrize("entry", corpus.SAFE, ids=lambda e: e.name)
def test_safe_entries_split_bit_for_bit_on_host_lanes(entry):
    one = _run_entry(entry, 1)
    two = _run_entry(entry, 2)
    assert all(a.tobytes() == b.tobytes() for a, b in zip(one, two))


def test_the_halo_entry_differs_at_the_partition_boundary():
    entry = corpus.UNSAFE[[e.name for e in corpus.UNSAFE].index("halo_partial")]
    one = _run_entry(entry, 1)
    two = _run_entry(entry, 2)
    bad = np.flatnonzero(one[1] != two[1])
    assert bad.tolist() == [entry.global_range // 2 - 1]


SRC = chip_smoke.STENCIL_SRC


def _stencil(n: int, full: bool):
    rng = np.random.default_rng(5)
    flags = chip_smoke.stencil_flags(full)
    x = ck.ClArray(rng.standard_normal(n).astype(np.float32), name="x", **flags[0])
    out = ck.ClArray(np.zeros(n, np.float32), name="out", **flags[1])
    return x, out


def _transfers(cr) -> int:
    return sum(sum(w.transfers.values()) for w in cr.cores.workers)


def test_advisory_records_one_event_per_shape_and_runs(monkeypatch):
    n = 4096
    x, out = _stencil(n, full=False)
    FLIGHT.clear()
    with ck.NumberCruncher(ck.all_devices().cpus(2), SRC) as cr:
        for _ in range(3):
            x.next_param(out).compute(cr, 1, "stencil3", n, 256, values=(n,))
        assert len(cr.cores.program._verdict_cache) == 1
    events = [e for e in FLIGHT.snapshot() if e.kind == "kernel-verify"]
    assert len(events) == 1
    ev = events[0].fields
    assert (ev["kernels"], ev["finding"], ev["kernel"], ev["param"]) == \
        ("stencil3", "partial-read-halo", "stencil3", "x")


@pytest.mark.parametrize("enqueue", [False, True], ids=["per-call", "enqueue"])
def test_strict_raises_before_any_transfer_or_launch(monkeypatch, enqueue):
    n = 4096
    x, out = _stencil(n, full=False)
    with ck.NumberCruncher(ck.all_devices().cpus(2), SRC) as cr:
        cr.enqueue_mode = enqueue
        monkeypatch.setenv("CK_KERNEL_VERIFY", "strict")
        launches = dict(registry.launch_counts)
        before = (_transfers(cr), dict(cr.cores.global_ranges), set(cr.cores._enqueue_cids),
                  dict(cr.cores._flush_iters), dict(cr.fused_stats), list(cr.cores._enqueued))
        with pytest.raises(KernelVerifyError) as info:
            x.next_param(out).compute(cr, 1, "stencil3", n, 256, values=(n,))
        after = (_transfers(cr), dict(cr.cores.global_ranges), set(cr.cores._enqueue_cids),
                 dict(cr.cores._flush_iters), dict(cr.fused_stats), list(cr.cores._enqueued))
        assert info.value.finding.kind == "partial-read-halo"
        assert dict(registry.launch_counts) == launches and after == before
        assert not [e for e in FLIGHT.snapshot() if e.kind == "kernel-verify"]
        # the refusal counts as the call's error, as any failed call does;
        # after a reset the same cruncher runs a clean shape under strict
        assert cr.number_of_errors_happened == 1
        cr.reset_errors()
        y, o2 = _stencil(n, full=True)
        y.next_param(o2).compute(cr, 2, "stencil3", n, 256, values=(n,))
        cr.enqueue_mode = False


def test_off_skips_the_gate(monkeypatch):
    n = 4096
    x, out = _stencil(n, full=False)
    monkeypatch.setenv("CK_KERNEL_VERIFY", "off")
    FLIGHT.clear()
    with ck.NumberCruncher(ck.all_devices().cpus(2), SRC) as cr:
        x.next_param(out).compute(cr, 1, "stencil3", n, 256, values=(n,))
        assert cr.cores.program._verdict_cache == {}
    assert not [e for e in FLIGHT.snapshot() if e.kind == "kernel-verify"]


def test_window_flag_follows_enqueue_and_repeat(monkeypatch):
    """The gate verifies a call as a window (the kernel sequence taken as
    cyclic) in enqueue mode and under ``repeat_count > 1``, per call
    otherwise: one cached verdict per (sequence, flags, window)."""
    entry = corpus.SAFE[[e.name for e in corpus.SAFE].index("seq_safe")]
    kdefs, _flags, host = corpus.build(entry)
    arrays = [ck.ClArray(h.copy(), name=f"p{i}", **kw)
              for i, (h, kw) in enumerate(zip(host, entry.flags))]
    group = arrays[0].next_param(arrays[1]).next_param(arrays[2])
    names = " ".join(k.name for k in kdefs)
    monkeypatch.setenv("CK_KERNEL_VERIFY", "strict")
    with ck.NumberCruncher(ck.all_devices().cpus(2), entry.source) as cr:
        cache = cr.cores.program._verdict_cache
        group.compute(cr, 1, names, entry.global_range, entry.local_range)
        assert [k[2] for k in cache] == [False]
        cr.repeat_count = 2
        group.compute(cr, 1, names, entry.global_range, entry.local_range)
        cr.repeat_count = 1
        assert sorted(k[2] for k in cache) == [False, True]
        cr.enqueue_mode = True
        for _ in range(3):
            group.compute(cr, 1, names, entry.global_range, entry.local_range)
        cr.enqueue_mode = False
        assert sorted(k[2] for k in cache) == [False, True]
        assert all(v.ok for v in cache.values())
    unsafe = corpus.UNSAFE[[e.name for e in corpus.UNSAFE].index("window_raw")]
    _k, _f, host = corpus.build(unsafe)
    arrays = [ck.ClArray(h.copy(), name=f"p{i}", **kw)
              for i, (h, kw) in enumerate(zip(host, unsafe.flags))]
    group = arrays[0].next_param(arrays[1]).next_param(arrays[2])
    with ck.NumberCruncher(ck.all_devices().cpus(2), unsafe.source) as cr:
        cr.enqueue_mode = True
        with pytest.raises(KernelVerifyError, match="window-raw"):
            group.compute(cr, 1, "wrA wrB", unsafe.global_range, unsafe.local_range)
        assert cr.cores._enqueue_cids == set() and cr.cores._enqueued == []
        cr.reset_errors()
        cr.enqueue_mode = False


def test_program_summaries_and_cache():
    prog = KernelProgram([wl.MANDELBROT_SRC, wl.saxpy_kernel()])
    sums = prog.summaries()
    assert sums["saxpy"] is None and sums["mandelbrot"] is not None
    assert prog.summaries() is sums
    rows = (analysis.flag_row(TransferFlags(read=False, write=True)),)
    v = prog.verify(("mandelbrot",), rows)
    assert prog.verify(["mandelbrot"], list(rows)) is v and v.ok
    hand = KernelProgram(wl.mandelbrot_cuda_kernel())
    vh = hand.verify(("mandelbrot",), rows)
    assert vh.ok and [f.kind for f in vh.advisories] == ["unverifiable"]


def test_a_verifier_failure_degrades_to_nothing_proven(monkeypatch):
    prog = KernelProgram(wl.STREAM_SRC)
    monkeypatch.setattr(analysis, "verify_launch",
                        lambda *a, **k: (_ for _ in ()).throw(RuntimeError("bail")))
    v = prog.verify(("streamAdd",), ())
    assert v.findings == () and v.ok


def test_flag_rows_memoize_on_the_flags_object():
    x = ck.ClArray(np.zeros(8, np.float32), name="x", partial_read=True)
    row = analysis.flag_row(x.flags)
    assert analysis.flag_row(x.flags) is row
    x.read_only = True   # the flag API replaces the flags object
    assert analysis.flag_row(x.flags) is not row and analysis.flag_row(x.flags).read_only
