"""Which values of a kernel are provably the same in every work item.

A copy of the reference's monotone-poisoning analysis
(``cekirdekler_tpu/kernel/codegen.py``: ``_uniform_vars``,
``_expr_uniform`` and the helpers they call), kept here because that
module imports JAX.  The reference uses it to serve a lane-uniform load
such as n-body's ``x[j]`` from SMEM as one scalar; the emitter's loop form
(``cuda_backend.loop_reason``) uses it to prove that a ``for`` loop's trip
sequence is the same in every thread of a CTA, so the CTA can stage the
loop's ``buf[j + c]`` reads in shared memory between barriers.
``tests/test_torch_loop_form.py`` holds it against the reference's on
the kernel corpus.
"""

from __future__ import annotations

from .codegen import PURE_CALLS
from .lang import (
    Assign,
    BinOp,
    Break,
    Call,
    Cast,
    Continue,
    CrementStmt,
    Decl,
    DoWhile,
    For,
    If,
    Index,
    Num,
    Return,
    Ternary,
    UnOp,
    Var,
    While,
)

__all__ = ["uniform_vars", "expr_uniform", "contains_return", "assigned_vars",
           "private_array_names"]

_UNIFORM_CALLS = {
    "get_global_size", "get_local_size", "get_num_groups",
    "get_global_offset", "get_work_dim",
}
_LANE_CALLS = {"get_global_id", "get_local_id", "get_group_id"}


def expr_uniform(node, uset: set[str], private: set[str] = frozenset()) -> bool:
    """True iff ``node`` provably evaluates identically in every work item."""
    if isinstance(node, Num):
        return True
    if isinstance(node, Var):
        return node.name in uset
    if isinstance(node, Index):
        # a buffer load at a uniform index yields the same element in every
        # item; a private array's rows are per item, so its loads never are
        if node.base in private:
            return False
        return expr_uniform(node.index, uset, private)
    if isinstance(node, BinOp):
        return expr_uniform(node.left, uset, private) and expr_uniform(node.right, uset, private)
    if isinstance(node, (UnOp, Cast)):
        return expr_uniform(node.operand, uset, private)
    if isinstance(node, Ternary):
        return (expr_uniform(node.cond, uset, private)
                and expr_uniform(node.then, uset, private)
                and expr_uniform(node.other, uset, private))
    if isinstance(node, Call):
        name = node.name
        if name.startswith(("native_", "half_")):
            name = name.split("_", 1)[1]
        if name in _LANE_CALLS:
            return False
        if name in _UNIFORM_CALLS:
            return True
        if name not in PURE_CALLS:
            # user helpers (and anything unrecognized) may read item state
            return False
        return all(expr_uniform(a, uset, private) for a in node.args)
    return False  # unknown node kind: be conservative


def _has_divergent_exit(stmts: list, divergent: bool, uset, private) -> bool:
    """True if a break/continue can run under an item-divergent condition
    anywhere in this loop's body (nested loops scope their own break and
    continue and are checked by their own walk)."""
    for s in stmts:
        if isinstance(s, (Break, Continue)) and divergent:
            return True
        if isinstance(s, If):
            d = divergent or not expr_uniform(s.cond, uset, private)
            if _has_divergent_exit(s.then, d, uset, private):
                return True
            if _has_divergent_exit(s.other, d, uset, private):
                return True
    return False


def contains_return(stmts: list) -> bool:
    for s in stmts:
        if isinstance(s, Return):
            return True
        if isinstance(s, If) and (contains_return(s.then) or contains_return(s.other)):
            return True
        if isinstance(s, For):
            inner = (([s.init] if s.init is not None else []) + s.body
                     + ([s.step] if s.step is not None else []))
            if contains_return(inner):
                return True
        if isinstance(s, (While, DoWhile)) and contains_return(s.body):
            return True
    return False


def private_array_names(stmts: list, out: set[str] | None = None) -> set[str]:
    if out is None:
        out = set()
    for s in stmts:
        if isinstance(s, Decl):
            out.update(s.arrays)
        elif isinstance(s, If):
            private_array_names(s.then, out)
            private_array_names(s.other, out)
        elif isinstance(s, For):
            if s.init is not None:
                private_array_names([s.init], out)
            private_array_names(s.body, out)
        elif isinstance(s, (While, DoWhile)):
            private_array_names(s.body, out)
    return out


def assigned_vars(stmts: list) -> set[str]:
    """Every name a statement declares or assigns, element stores
    included (the base of ``a[k] = ...``)."""
    out: set[str] = set()

    def walk(s):
        if isinstance(s, Decl):
            out.update(n for n, _ in s.names)
        elif isinstance(s, (Assign, CrementStmt)) and isinstance(s.target, Var):
            out.add(s.target.name)
        elif isinstance(s, (Assign, CrementStmt)) and isinstance(s.target, Index):
            out.add(s.target.base)
        elif isinstance(s, If):
            for x in s.then + s.other:
                walk(x)
        elif isinstance(s, For):
            for x in (([s.init] if s.init is not None else [])
                      + ([s.step] if s.step is not None else []) + s.body):
                walk(x)
        elif isinstance(s, (While, DoWhile)):
            for x in s.body:
                walk(x)

    for s in stmts:
        walk(s)
    return out


def uniform_vars(body: list, value_params: set[str]) -> set[str]:
    """Monotone-poisoning fixed point: start assuming every local is
    uniform; poison any variable assigned a non-uniform value or assigned
    under a non-uniform condition; repeat until stable.  Any ``return``
    disables the analysis (the empty set), as in the reference."""
    if contains_return(body):
        return set()
    private = private_array_names(body)
    uset: set[str] = (set(value_params) | assigned_vars(body)) - private

    changed = True
    while changed:
        changed = False

        def poison(name: str) -> None:
            nonlocal changed
            if name in uset:
                uset.discard(name)
                changed = True

        def walk(stmts, divergent: bool) -> None:
            for s in stmts:
                if isinstance(s, Decl):
                    for name, init in s.names:
                        if name in s.arrays:
                            poison(name)  # per-item stores make the rows diverge
                        elif init is not None and not expr_uniform(init, uset, private):
                            poison(name)
                        elif divergent and init is not None:
                            poison(name)
                elif isinstance(s, Assign) and isinstance(s.target, Var):
                    if divergent or not expr_uniform(s.value, uset, private):
                        poison(s.target.name)
                elif isinstance(s, CrementStmt) and isinstance(s.target, Var):
                    if divergent:
                        poison(s.target.name)
                elif isinstance(s, If):
                    d = divergent or not expr_uniform(s.cond, uset, private)
                    walk(s.then, d)
                    walk(s.other, d)
                elif isinstance(s, For):
                    d = divergent
                    if s.init is not None:
                        walk([s.init], d)
                    d = d or not (s.cond is None or expr_uniform(s.cond, uset, private))
                    inner = s.body + ([s.step] if s.step is not None else [])
                    # a break/continue under a divergent condition makes the
                    # trip counts differ: every assignment in the loop diverges
                    d = d or _has_divergent_exit(s.body, d, uset, private)
                    walk(inner, d)
                elif isinstance(s, (While, DoWhile)):
                    d = divergent or not expr_uniform(s.cond, uset, private)
                    d = d or _has_divergent_exit(s.body, d, uset, private)
                    walk(s.body, d)

        walk(body, False)
    return uset
