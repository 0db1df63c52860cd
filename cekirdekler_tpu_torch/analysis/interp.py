"""Abstract interpretation of kernel ASTs: index provenance tracking.

A copy of the reference's ``analysis/interp.py`` over the port's
``kernel/lang.py`` (the same parser); the text below is the reference's.

The domain is the gid-affine interval lattice

    AV(coef, lo, hi)  ≡  { coef·gid + c : c ∈ [lo, hi] }

with three distinguished shapes:

- ``coef == 0`` — **uniform**: the value is identical across work
  items (constants have ``lo == hi``; a value parameter or a loop
  counter bounded by one is uniform with an unknown interval);
- ``coef != 0`` (finite) — **gid-affine**: the value moves with the
  work-item id at a fixed stride (``a[i]`` is coef 1 offset 0;
  ``a[i+2]`` coef 1 offset 2; ``a[2*i+1]`` coef 2 offset 1);
- ``coef is None`` — **top**: gid-dependent but not affine (``i % w``,
  a value loaded from an array, ``get_local_id``) — a gather/indirect
  index when used at an access site.

Everything is deliberately *under*-approximate toward safety: any
operation the transfer rules above cannot model exactly produces TOP,
never a fabricated affine form — a missed proof surfaces as an
advisory or a named error the user can suppress, a wrong proof would
let a corrupting split through.

Loops run to an interval fixpoint (3 join rounds, then widening to
±inf on the moving bound), and access sites inside the loop are
recorded in one final pass over the stabilized environment — so
``for (j = 0; j < n; j++) acc += x[j];`` records ONE uniform read of
``x``, not a parade of transient constants.

Helper functions (scalar-only by the language contract) are inlined
abstractly at call sites, exactly as the codegen inlines them.

Pure ``lang`` + stdlib — no jax, no numpy: this module must run on
rigs where the runtime is broken (the ckcheck discipline).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

from ..kernel import lang

__all__ = ["AV", "Access", "KernelSummary", "summarize_kernel"]

INF = float("inf")

#: Work-item queries that are uniform across the chunk.
_UNIFORM_FUNCS = {
    "get_global_size", "get_local_size", "get_num_groups",
    "get_global_offset", "get_work_dim",
}
#: Work-item queries that are gid-dependent but NOT affine in gid.
_NONAFFINE_FUNCS = {"get_local_id", "get_group_id"}


@dataclass(frozen=True)
class AV:
    """One abstract value: ``coef·gid + [lo, hi]`` (see module doc)."""

    coef: float | None
    lo: float
    hi: float

    @staticmethod
    def const(v) -> "AV":
        return AV(0.0, float(v), float(v))

    @property
    def is_const(self) -> bool:
        return self.coef == 0 and self.lo == self.hi and math.isfinite(self.lo)


TOP = AV(None, -INF, INF)
UNIFORM = AV(0.0, -INF, INF)
GID = AV(1.0, 0.0, 0.0)


def _add(a: AV, b: AV) -> AV:
    if a.coef is None or b.coef is None:
        return TOP
    return AV(a.coef + b.coef, a.lo + b.lo, a.hi + b.hi)


def _neg(a: AV) -> AV:
    if a.coef is None:
        return TOP
    return AV(-a.coef, -a.hi, -a.lo)


def _scale(a: AV, k: float) -> AV:
    if a.coef is None:
        return TOP
    if k == 0:
        return AV.const(0)
    lo, hi = sorted((a.lo * k, a.hi * k))
    return AV(a.coef * k, lo, hi)


def _mul(a: AV, b: AV) -> AV:
    if a.is_const:
        return _scale(b, a.lo)
    if b.is_const:
        return _scale(a, b.lo)
    if a.coef == 0 and b.coef == 0:
        return UNIFORM
    return TOP


def _uniform_combine(a: AV, b: AV) -> AV:
    """Result of an op the domain cannot model (/, %, >>, &, |, ^,
    comparisons): uniform when both operands are, else top."""
    if a.coef == 0 and b.coef == 0:
        return UNIFORM
    return TOP


def _join(a: AV, b: AV) -> AV:
    if a == b:
        return a
    if a.coef is None or b.coef is None or a.coef != b.coef:
        if a.coef == 0 and b.coef == 0:
            return AV(0.0, min(a.lo, b.lo), max(a.hi, b.hi))
        return TOP
    return AV(a.coef, min(a.lo, b.lo), max(a.hi, b.hi))


def _widen(old: AV, new: AV) -> AV:
    if old == new:
        return old
    if old.coef is None or new.coef is None or old.coef != new.coef:
        if old.coef == 0 and new.coef == 0:
            return UNIFORM
        return TOP
    return AV(
        old.coef,
        old.lo if new.lo >= old.lo else -INF,
        old.hi if new.hi <= old.hi else INF,
    )


@dataclass(frozen=True)
class Access:
    """One recorded array access site."""

    param: str
    av: AV
    line: int
    is_write: bool
    conditional: bool


@dataclass
class KernelSummary:
    """Per-array access summary for one kernel (flag-independent —
    verdicts against declared flags are ``verdict.verify_launch``'s
    business, so one summary serves every flag combination)."""

    name: str
    array_params: tuple = ()
    value_params: tuple = ()
    reads: dict = field(default_factory=dict)    # param -> [Access]
    writes: dict = field(default_factory=dict)   # param -> [Access]
    rbw: dict = field(default_factory=dict)      # param -> first RBW line
    # param -> tuple[AV]: patterns written UNCONDITIONALLY (every work
    # item, every path) — the cross-kernel read-before-write witness
    must_writes: dict = field(default_factory=dict)
    suppressed: frozenset = frozenset()          # // ckprove: ok lines
    line: int = 0


class _Interp:
    """One abstract execution of one kernel body."""

    _INT_TYPES = {"bool", "char", "uchar", "short", "ushort", "int",
                  "uint", "long", "ulong"}

    def __init__(self, kernel: lang.KernelDef):
        self.kernel = kernel
        self.pointer_params = tuple(
            p.name for p in kernel.params if p.is_pointer)
        self.value_params = tuple(
            p.name for p in kernel.params if not p.is_pointer)
        self.env: dict[str, AV] = {
            name: UNIFORM for name in self.value_params}
        self.priv: dict[str, AV] = {}
        self.written: dict[str, list[AV]] = {}   # must-written patterns
        self.accesses: list[Access] = []
        self._seen: set = set()
        self.rbw: dict[str, int] = {}
        self.recording = True
        self.cond_depth = 0
        self.saw_return = False
        self._helper_depth = 0

    # -- access recording ----------------------------------------------------
    def _record(self, base: str, av: AV, line: int, write: bool) -> None:
        if base in self.priv:
            return  # private scratch: not a transfer surface
        if base not in self.pointer_params or not self.recording:
            return
        cond = self.cond_depth > 0 or self.saw_return
        key = (base, av, line, write, cond)
        if key not in self._seen:
            self._seen.add(key)
            self.accesses.append(Access(base, av, line, write, cond))
        if write:
            if not cond:
                self.written.setdefault(base, []).append(av)
        else:
            if base not in self.rbw and not self._covered(base, av):
                self.rbw[base] = line

    def _covered(self, base: str, av: AV) -> bool:
        if av.coef is None:
            return False
        for w in self.written.get(base, ()):
            if w.coef == av.coef and w.lo <= av.lo and av.hi <= w.hi:
                return True
        return False

    # -- expressions ---------------------------------------------------------
    def eval(self, node) -> AV:
        if node is None:
            return UNIFORM
        if isinstance(node, lang.Num):
            return AV.const(node.value)
        if isinstance(node, lang.Var):
            if node.name in self.env:
                return self.env[node.name]
            return TOP
        if isinstance(node, lang.Index):
            idx = self.eval(node.index)
            if node.base in self.priv:
                return self.priv[node.base]
            self._record(node.base, idx, node.line, write=False)
            # a value loaded from a buffer is data-dependent: using it
            # as an index later is a gather by definition
            return TOP
        if isinstance(node, lang.UnOp):
            v = self.eval(node.operand)
            if node.op == "+":
                return v
            if node.op == "-":
                return _neg(v)
            return UNIFORM if v.coef == 0 else TOP
        if isinstance(node, lang.Cast):
            v = self.eval(node.operand)
            if node.ctype in self._INT_TYPES and v.coef is not None:
                lo = math.floor(v.lo) if math.isfinite(v.lo) else v.lo
                hi = math.ceil(v.hi) if math.isfinite(v.hi) else v.hi
                return AV(v.coef, lo, hi)
            return v
        if isinstance(node, lang.Ternary):
            self.eval(node.cond)
            return _join(self.eval(node.then), self.eval(node.other))
        if isinstance(node, lang.BinOp):
            a = self.eval(node.left)
            b = self.eval(node.right)
            op = node.op
            if op == "+":
                return _add(a, b)
            if op == "-":
                return _add(a, _neg(b))
            if op == "*":
                return _mul(a, b)
            if op == "<<" and b.is_const and b.lo >= 0 and \
                    float(b.lo).is_integer():
                return _scale(a, float(1 << int(b.lo)))
            return _uniform_combine(a, b)
        if isinstance(node, lang.Call):
            return self._call(node)
        return TOP

    def _call(self, node: lang.Call) -> AV:
        name = node.name
        helpers = self.kernel.helpers or {}
        if name in helpers:
            args = [self.eval(a) for a in node.args]
            return self._inline_helper(helpers[name], args)
        if name.startswith(("native_", "half_")):
            name = name.split("_", 1)[1]
        args = [self.eval(a) for a in node.args]
        if name == "get_global_id":
            return GID
        if name in _UNIFORM_FUNCS:
            return UNIFORM
        if name in _NONAFFINE_FUNCS:
            return TOP
        # math builtins and anything unknown: uniform in -> uniform out
        if all(a.coef == 0 for a in args) and args:
            return UNIFORM
        return TOP

    def _inline_helper(self, fdef: lang.FuncDef, args: list) -> AV:
        if self._helper_depth >= 8:
            return TOP
        saved_env, saved_priv = self.env, self.priv
        self.env = {p.name: v for p, v in zip(fdef.params, args)}
        self.priv = {}
        self._helper_depth += 1
        try:
            self.exec_block(fdef.body[:-1])
            ret = fdef.body[-1]
            if isinstance(ret, lang.ReturnValue):
                return self.eval(ret.value)
            return TOP
        finally:
            self._helper_depth -= 1
            self.env, self.priv = saved_env, saved_priv

    # -- statements ----------------------------------------------------------
    def exec_block(self, stmts) -> None:
        for s in stmts:
            self.exec_stmt(s)

    def _store(self, target, value: AV) -> None:
        if isinstance(target, lang.Var):
            self.env[target.name] = value
            return
        if isinstance(target, lang.Index):
            idx = self.eval(target.index)
            if target.base in self.priv:
                self.priv[target.base] = _join(self.priv[target.base], value)
                return
            self._record(target.base, idx, target.line, write=True)

    def exec_stmt(self, s) -> None:
        if isinstance(s, lang.Decl):
            for name, init in s.names:
                if name in s.arrays:
                    self.priv[name] = AV.const(0)
                else:
                    self.env[name] = self.eval(init) if init is not None \
                        else AV.const(0)
            return
        if isinstance(s, lang.Assign):
            if s.target is None:
                self.eval(s.value)
                return
            rhs = self.eval(s.value)
            if s.op != "=":
                cur = self.eval(s.target)  # compound: records the read
                op = s.op[:-1]
                if op == "+":
                    rhs = _add(cur, rhs)
                elif op == "-":
                    rhs = _add(cur, _neg(rhs))
                elif op == "*":
                    rhs = _mul(cur, rhs)
                else:
                    rhs = _uniform_combine(cur, rhs)
            self._store(s.target, rhs)
            return
        if isinstance(s, lang.CrementStmt):
            cur = self.eval(s.target)
            one = AV.const(1) if s.op == "++" else AV.const(-1)
            self._store(s.target, _add(cur, one))
            return
        if isinstance(s, lang.If):
            self.eval(s.cond)
            if isinstance(s.cond, lang.Num) and s.cond.value == 1 \
                    and not s.other:
                # the parser's bare-block encoding: not a real branch
                self.exec_block(s.then)
                return
            env0 = dict(self.env)
            priv0 = dict(self.priv)
            self.cond_depth += 1
            try:
                self.exec_block(s.then)
                env1, priv1 = self.env, self.priv
                self.env, self.priv = env0, priv0
                self.exec_block(s.other)
            finally:
                self.cond_depth -= 1
            self.env = self._join_env(env1, self.env)
            self.priv = self._join_env(priv1, self.priv)
            return
        if isinstance(s, lang.For):
            if s.init is not None:
                self.exec_stmt(s.init)
            self._loop(s.cond, s.body, s.step)
            return
        if isinstance(s, lang.While):
            self._loop(s.cond, s.body, None)
            return
        if isinstance(s, lang.DoWhile):
            self._loop(s.cond, s.body, None)
            return
        if isinstance(s, lang.Return):
            self.saw_return = True
            return
        if isinstance(s, lang.ReturnValue):
            self.eval(s.value)
            return
        if isinstance(s, (lang.Break, lang.Continue)):
            return
        raise AssertionError(
            f"interp: unhandled statement {type(s).__name__}")

    @staticmethod
    def _join_env(a: dict, b: dict) -> dict:
        out = {}
        for k in set(a) | set(b):
            va, vb = a.get(k), b.get(k)
            out[k] = va if vb is None else vb if va is None else _join(va, vb)
        return out

    def _loop(self, cond, body, step) -> None:
        # silent fixpoint: iterate join/widen on the env without
        # recording accesses (transient first-iteration constants must
        # not masquerade as precise access sites)
        saved_recording = self.recording
        self.recording = False
        self.cond_depth += 1
        try:
            for round_ in range(4):
                pre_env = dict(self.env)
                pre_priv = dict(self.priv)
                self.eval(cond)
                self.exec_block(body)
                if step is not None:
                    self.exec_stmt(step)
                merge = _widen if round_ >= 2 else _join
                new_env = {
                    k: merge(pre_env[k], v) if k in pre_env else v
                    for k, v in self._join_env(pre_env, self.env).items()
                }
                new_priv = {
                    k: merge(pre_priv[k], v) if k in pre_priv else v
                    for k, v in self._join_env(pre_priv, self.priv).items()
                }
                stable = new_env == pre_env and new_priv == pre_priv
                self.env, self.priv = new_env, new_priv
                if stable:
                    break
            # one recording pass over the stabilized environment
            self.recording = saved_recording
            self.eval(cond)
            self.exec_block(body)
            if step is not None:
                self.exec_stmt(step)
        finally:
            self.recording = saved_recording
            self.cond_depth -= 1


def _suppressed_lines(source: str) -> frozenset:
    """1-based line numbers covered by a ``// ckprove: ok`` comment —
    the marked line and the line directly below it (annotation-above
    style), mirroring ckcheck's suppression reach."""
    out = set()
    for i, text in enumerate(source.splitlines(), 1):
        if "ckprove: ok" in text:
            out.add(i)
            out.add(i + 1)
    return frozenset(out)


def summarize_kernel(kernel: lang.KernelDef) -> KernelSummary:
    """Abstractly execute ``kernel`` and summarize every array access.

    Raises nothing by contract of the callers (they wrap); any lattice
    gap inside produces TOP values, not exceptions.
    """
    it = _Interp(kernel)
    it.exec_block(kernel.body)
    reads: dict[str, list] = {}
    writes: dict[str, list] = {}
    for acc in it.accesses:
        (writes if acc.is_write else reads).setdefault(
            acc.param, []).append(acc)
    return KernelSummary(
        name=kernel.name,
        array_params=it.pointer_params,
        value_params=it.value_params,
        reads=reads,
        writes=writes,
        rbw=dict(it.rbw),
        must_writes={k: tuple(v) for k, v in it.written.items()},
        suppressed=_suppressed_lines(kernel.source or ""),
        line=kernel.line,
    )
