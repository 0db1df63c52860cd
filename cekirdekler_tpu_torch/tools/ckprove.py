"""``python -m cekirdekler_tpu_torch.tools.ckprove`` — the kernel
partition-safety verifier over the port's sources.

A copy of the reference's ``tools/ckprove.py`` over the port's
``analysis/`` package, with its ratchet, its ``--json`` and
``--explain`` options and the ``// ckprove: ok <why>`` suppression.  It
scans ``cekirdekler_tpu_torch/`` and ``chip_smoke.py`` for embedded
kernel-language sources (string literals holding a kernel definition),
summarizes every kernel's array accesses, and ratchets the
**flag-independent split-safety errors** (``scatter-write`` /
``off-partition-write`` — a store the balancer's re-partitioning would
silently drop on any >1-lane split) against ``ckprove_baseline.json``
beside this file.  Flag-dependent verdicts (halo under
``partial_read``, read-before-write under ``write_only``) need the call
site's :class:`TransferFlags` and are enforced at run time by
``Cores.compute``; the ``--json`` report carries the per-array access
*facts* (confined / halo / gather / rbw).

Exit 0 = no findings beyond the baseline AND no stale entries;
``--update-baseline`` refuses growth without ``--allow-grow``.

Usage::

    python -m cekirdekler_tpu_torch.tools.ckprove                  # the gate
    python -m cekirdekler_tpu_torch.tools.ckprove --explain <fp>   # one finding
    python -m cekirdekler_tpu_torch.tools.ckprove --update-baseline [--allow-grow]
    python -m cekirdekler_tpu_torch.tools.ckprove --json           # facts + findings
"""

from __future__ import annotations

import argparse
import ast
import json
import os
import re
import subprocess
import sys
import time

#: A string literal is a kernel SOURCE (not a docstring mentioning the
#: keyword, not the lexer's keyword table) iff it contains an actual
#: kernel definition head.
_KERNEL_DEF_RE = re.compile(r"(?:__kernel|kernel)\s+void\s+\w+\s*\(")

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_BASELINE = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "ckprove_baseline.json")

#: What the corpus scan covers.  tests/ is deliberately EXCLUDED: the
#: differential-oracle corpus there plants unsafe kernels on purpose.
SCAN_ROOTS = ("cekirdekler_tpu_torch", "chip_smoke.py")

# -- the ratchet baseline (the reference's tools/ckcheck/baseline.py) --------
#: a finding NOT in the baseline fails the run; a baseline entry no
#: finding matches fails it too ("stale"), so the file only shrinks
SCHEMA = "ckcheck-baseline-v1"
TOOL_VERSION = 2


def _head_sha() -> str:
    """HEAD's short sha, or ``"unknown"`` outside a usable git repo."""
    try:
        out = subprocess.run(["git", "rev-parse", "--short", "HEAD"], cwd=REPO,
                             capture_output=True, text=True, timeout=10)
        sha = out.stdout.strip()
        return sha if out.returncode == 0 and sha else "unknown"
    except Exception:  # noqa: BLE001 - no git, no sha, no failure
        return "unknown"


def load_baseline_doc(path: str) -> dict:
    """The whole baseline document (a missing file is an empty doc)."""
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)


def load_baseline(path: str) -> dict:
    """fingerprint → stored row."""
    return {row["fingerprint"]: row
            for row in load_baseline_doc(path).get("findings", ())}


def save_baseline(path: str, findings, tool: str = "ckprove") -> None:
    rows = sorted((f.to_row() for f in findings), key=lambda r: r["fingerprint"])
    doc = {
        "schema": SCHEMA,
        "provenance": {
            "tool": tool, "tool_version": TOOL_VERSION, "head": _head_sha(),
            "updated_at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        },
        "findings": rows,
    }
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True, allow_nan=False)
        f.write("\n")
    os.replace(tmp, path)


def provenance_note(doc: dict) -> str:
    """One line anchoring a baseline in history."""
    prov = (doc or {}).get("provenance")
    if not prov:
        return "baseline carries no provenance header — re-burn with --update-baseline"
    return (f"baseline burned by {prov.get('tool', '?')} "
            f"v{prov.get('tool_version', '?')} at commit "
            f"{prov.get('head', 'unknown')} ({prov.get('updated_at', 'undated')})")


def ratchet(findings, baseline: dict):
    """``(new, grandfathered, stale)``."""
    current = {f.fingerprint: f for f in findings}
    new = [f for fp, f in current.items() if fp not in baseline]
    grand = [f for fp, f in current.items() if fp in baseline]
    stale = [row for fp, row in baseline.items() if fp not in current]
    new.sort(key=lambda f: (f.path, f.line))
    stale.sort(key=lambda r: (r.get("path", ""), r.get("line", 0)))
    return new, grand, stale


def _load_analysis():
    """``(lang, analysis)`` — the port's parser and verifier."""
    from cekirdekler_tpu_torch import analysis
    from cekirdekler_tpu_torch.kernel import lang

    return lang, analysis


def _json_safe(o):
    from cekirdekler_tpu_torch.utils.jsonsafe import json_safe

    return json_safe(o)


def iter_kernel_sources(root: str | None = None):
    """Yield ``(relpath, lineno, source)`` for every string literal
    containing ``__kernel`` in the scan roots — pure ``ast`` over the
    Python files, no imports of the scanned code.  f-strings cannot be
    evaluated statically and are skipped (a generated kernel is
    verified at run time by the ``Cores`` gate instead)."""
    root = root or REPO
    paths = []
    for entry in SCAN_ROOTS:
        full = os.path.join(root, entry)
        if os.path.isfile(full):
            paths.append(full)
        elif os.path.isdir(full):
            for dirpath, _dirnames, filenames in os.walk(full):
                for fn in sorted(filenames):
                    if fn.endswith(".py"):
                        paths.append(os.path.join(dirpath, fn))
    for path in sorted(paths):
        rel = os.path.relpath(path, root)
        try:
            with open(path) as f:
                tree = ast.parse(f.read())
        except (OSError, SyntaxError):
            continue
        # docstrings mentioning the language (lang.py's own docs) are
        # not kernel sources: mark every body-leading string Expr
        docstrings: set = set()
        for node in ast.walk(tree):
            if isinstance(node, (ast.Module, ast.FunctionDef,
                                 ast.AsyncFunctionDef, ast.ClassDef)):
                body = getattr(node, "body", [])
                if body and isinstance(body[0], ast.Expr) and \
                        isinstance(body[0].value, ast.Constant):
                    docstrings.add(id(body[0].value))
            elif isinstance(node, ast.JoinedStr):
                # f-string pieces: not statically evaluable — such
                # kernels are verified at run time by the Cores gate
                for part in ast.walk(node):
                    docstrings.add(id(part))
        for node in ast.walk(tree):
            if isinstance(node, ast.Constant) and \
                    isinstance(node.value, str) and \
                    id(node) not in docstrings and \
                    _KERNEL_DEF_RE.search(node.value):
                yield rel, node.lineno, node.value


def analyze_corpus(root: str | None = None):
    """``(findings, facts)`` over the repo corpus.

    ``findings`` are the ratcheted split-safety errors (plus
    ``unparsed`` for a kernel string the front end rejects — a stale
    snippet is debt too).  ``facts`` is one row per kernel with its
    per-array access classes, for ``--json`` consumers."""
    lang, analysis = _load_analysis()
    findings: list = []
    facts: list = []
    seen_sources: set = set()
    for rel, lineno, source in iter_kernel_sources(root):
        key = (rel, source)
        if key in seen_sources:
            continue
        seen_sources.add(key)
        try:
            kdefs = lang.parse_kernels(source)
        except Exception as e:  # noqa: BLE001 - unparseable = finding
            findings.append(analysis.Finding(
                kind="unparsed", severity="error", where=rel,
                kernel=f"@{lineno}", param="*", line=lineno,
                message=f"kernel string at {rel}:{lineno} does not "
                        f"parse: {type(e).__name__}: {e}"))
            continue
        for kdef in kdefs:
            try:
                summary = analysis.summarize_kernel(kdef)
            except Exception as e:  # noqa: BLE001 - analysis bail-out
                facts.append({"path": rel, "kernel": kdef.name,
                              "error": f"{type(e).__name__}: {e}"})
                continue
            findings.extend(
                analysis.structural_findings(summary, where=rel))
            row = {"path": rel, "kernel": kdef.name, "arrays": {}}
            for pname in summary.array_params:
                reads = sorted({
                    analysis.classify(a.av, 1)[0]
                    for a in summary.reads.get(pname, ())})
                writes = sorted({
                    analysis.classify(a.av, 1)[0]
                    for a in summary.writes.get(pname, ())})
                row["arrays"][pname] = {
                    "reads": reads,
                    "writes": writes,
                    "partial_eligible": bool(reads) and
                    reads == ["confined"],
                    "read_before_write": summary.rbw.get(pname),
                }
            facts.append(row)
    findings.sort(key=lambda f: (f.where, f.kernel, f.line))
    return findings, facts


RULE_DOCS = {
    "off-partition-write": (
        "The kernel stores to an index that provably leaves the "
        "calling work item's partition (a halo offset, a stride other "
        "than elements_per_work_item, or a uniform index every item "
        "hits).  Each lane writes back only its own slice, so the "
        "off-partition store is silently dropped — results differ "
        "between split and unsplit runs.  Fix: confine stores to "
        "epw*gid + [0, epw), or restructure into a separate kernel "
        "whose range covers the written region."),
    "scatter-write": (
        "The kernel stores through a gathered/indirect index (data-"
        "dependent, modular, or otherwise non-affine in "
        "get_global_id(0)).  Nothing proves the store lands inside the "
        "caller's partition, and the balancer is free to re-partition "
        "at any call.  Fix: make the store gid-affine, or suppress the "
        "line with `// ckprove: ok <why>` when out-of-partition "
        "stores are provably impossible for your data."),
    "unparsed": (
        "A string containing `__kernel` does not parse under the "
        "kernel-language front end — either a stale snippet or a "
        "construct outside the supported surface.  Fix or delete it; "
        "dead kernel strings rot into documentation lies."),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m cekirdekler_tpu_torch.tools.ckprove",
        description="kernel partition-safety & flag-soundness verifier "
                    "over the port's sources")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite the baseline from current findings "
                         "(refuses NEW findings without --allow-grow)")
    ap.add_argument("--allow-grow", action="store_true",
                    help="permit --update-baseline to add findings")
    ap.add_argument("--explain", metavar="FINGERPRINT",
                    help="print one finding with its rule documentation")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable findings + per-kernel access "
                         "facts (exit code semantics unchanged)")
    ap.add_argument("--root", default=None,
                    help="repo root to scan (default: this repo)")
    ap.add_argument("--baseline", default=DEFAULT_BASELINE,
                    help="baseline file (default: ckprove_baseline.json "
                         "beside this tool)")
    args = ap.parse_args(argv)

    if args.explain == "provenance":
        # derived solely from the baseline file — never pay the scan
        print(provenance_note(load_baseline_doc(args.baseline)))
        return 0

    findings, facts = analyze_corpus(args.root)
    baseline = load_baseline(args.baseline)
    new, grand, stale = ratchet(findings, baseline)

    if args.explain:
        for f in findings:
            if f.fingerprint.startswith(args.explain):
                print(f.render())
                print()
                print(RULE_DOCS.get(f.kind, "(no rule documentation)"))
                status = ("grandfathered in baseline"
                          if f.fingerprint in baseline else
                          "NEW (not in baseline)")
                print(f"\nstatus: {status}")
                return 0
        print(f"no finding with fingerprint {args.explain!r}",
              file=sys.stderr)
        return 1

    if args.update_baseline:
        if new and not args.allow_grow:
            print(f"ckprove: REFUSING to grow the baseline by "
                  f"{len(new)} new finding(s) (pass --allow-grow to "
                  "grandfather deliberately):")
            for f in new:
                print("  " + f.render())
            return 1
        save_baseline(args.baseline, findings, tool="ckprove")
        print(f"ckprove: baseline rewritten: {len(findings)} finding(s) "
              f"({len(new)} added, {len(stale)} removed)")
        return 0

    if args.json:
        print(json.dumps(_json_safe({
            "new": [f.to_row() for f in new],
            "grandfathered": [f.to_row() for f in grand],
            "stale_baseline": stale,
            "kernels": facts,
        }), indent=1, sort_keys=True, allow_nan=False))
        return 0 if not new and not stale else 1

    ok = True
    if new:
        ok = False
        print(f"ckprove: {len(new)} NEW finding(s) (not in baseline):")
        for f in new:
            print("  " + f.render())
        print("  (fix them, suppress `// ckprove: ok <why>` on the "
              "kernel-source line, or --update-baseline --allow-grow "
              "to grandfather)")
    if stale:
        ok = False
        print(f"ckprove: {len(stale)} STALE baseline entr"
              f"{'y' if len(stale) == 1 else 'ies'} (finding fixed but "
              "baseline not shrunk — run --update-baseline):")
        for row in stale:
            print(f"  [{row['fingerprint']}] {row.get('path')}:"
                  f"{row.get('line')} {row.get('message', '')[:80]}")
        print("  (" + provenance_note(
            load_baseline_doc(args.baseline)) + ")")
    if ok:
        n_kernels = sum(1 for r in facts if "arrays" in r)
        print(f"ckprove: clean — {n_kernels} kernel(s) verified, "
              f"{len(findings)} grandfathered finding(s) remain in the "
              "baseline (ratchet: this number only goes down)")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
