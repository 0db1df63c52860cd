"""Blockwise fused elementwise ops: the hand-written CUDA kernel and its
plain PyTorch version.

Counterpart of ``cekirdekler_tpu/ops/elementwise.py`` (``map_blocks``,
``saxpy``).  ``map_blocks(fn, *arrays)`` applies an elementwise ``fn`` over
equal-length 1-D tensors in one pass: one read of every input and one
write of the output, however many ops ``fn`` fuses.  It is the building
block a ``@kernel`` Python kernel plugs into ``compute()`` with.

On the card ``fn`` runs inside one hand-written CUDA kernel
(``csrc/elementwise.cu``).  ``fn`` is traced once per (fn, input dtypes)
with proxy objects into a small expression over the inputs, and the
expression is spliced into the kernel source as C++; the build is keyed
by the content hash of that source.  The expression is built from a fixed
table of elementwise ops (:data:`OPS`); anything else raises
:class:`KernelCompileError` naming the op, on the card and on the CPU
alike.  There is no fallback to PyTorch ops on the card.

Types: ``float32`` and ``int32`` compute in their own type; ``bfloat16``
and ``float16`` compute each op in f32 and round to the storage type
after every op, as PyTorch's eager ops do, with a Python scalar in an
arithmetic op taken at f32 and one in a comparison rounded to the storage
type first (PyTorch's CPU rules).  On the card the roundings are the
conversion instructions PyTorch's CUDA kernels use, so a NaN stores as
0x7fff; the host build rounds in software and stores a NaN as ATen's
vectorized CPU conversion does (bf16 0xffff).  Mixed input dtypes
promote as PyTorch promotes them; the result has ``arrays[0].dtype``.
Constants are printed as exact hex-float literals, and the build keeps
products unfused (``-fmad=false``), so ``y + a*x`` rounds ``a*x`` as the
plain version does.

Like ``jax.jit``, the trace is cached per function object: a global that
``fn`` reads is baked in when ``fn`` is first traced.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading
from collections import OrderedDict
from dataclasses import dataclass
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from ..errors import KernelCompileError
from ..kernel.build import LaunchCounter, build_library

__all__ = ["map_blocks", "map_blocks_plain", "saxpy", "kernel_source", "LAUNCHES",
           "PLAIN_RUNS", "OPS", "SOURCE"]

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "elementwise.cu"
_MARKER = "// @CK_ELEMENT_FUNCTION@"

_LANES = 128
_MAX_IN = 8  # CK_MAX_IN in csrc/elementwise.cu

#: kernel launches (the wrapper adds one per launch on the card)
LAUNCHES = LaunchCounter()
#: plain-version runs, by device type
PLAIN_RUNS = LaunchCounter()

#: the ops ``fn`` may use, as the error names them
OPS = ("+", "-", "*", "/", "unary -", "torch.maximum", "torch.minimum", "abs", "torch.exp",
       "torch.tanh", "torch.where", "< <= > >= == !=", "Python int and float constants")

_DTYPES = {torch.float32: "f32", torch.int32: "i32", torch.bfloat16: "bf16",
           torch.float16: "f16"}
_STORAGE_C = {"f32": "float", "i32": "int", "bf16": "unsigned short", "f16": "unsigned short"}
_COMPUTE_C = {"f32": "float", "i32": "int", "bf16": "float", "f16": "float", "bool": "bool"}
_ITEMSIZE = {"f32": 4, "i32": 4, "bf16": 2, "f16": 2}
_ROUND = {"bf16": "ck_rbf16", "f16": "ck_rf16"}
_LOAD = {"f32": "{}", "i32": "{}", "bf16": "ck_bf16_value({})", "f16": "ck_f16_value({})"}
_STORE = {"f32": "{}", "i32": "{}", "bf16": "ck_bf16_bits({})", "f16": "ck_f16_bits({})"}
_PAIR = {"bf16": "ck_bf16x2_bits", "f16": "ck_f16x2_bits"}  # two stored values, one cvt


# ---------------------------------------------------------------------------
# tracing: fn(*proxies) -> an expression DAG over the inputs
# ---------------------------------------------------------------------------

@dataclass(frozen=True, eq=False)
class _Node:
    """One value of the traced expression: ``op`` over ``args`` (nodes or
    Python scalars), of result type ``dtype`` (a storage name or
    ``"bool"``); ``index`` is the input position of an ``"arg"``."""

    op: str
    args: tuple = ()
    dtype: str = "f32"
    index: int = -1


def _refuse(op: str) -> KernelCompileError:
    return KernelCompileError(
        f"map_blocks: {op} is outside the elementwise kernel's op table ({', '.join(OPS)})")


def _category(t: str) -> int:
    return {"bool": 0, "i32": 1}.get(t, 2)


def _promote(a, b) -> str:
    """PyTorch's result type of a binary op over traced values and Python
    scalars: tensors decide within a category, a scalar only lifts the
    category (an int tensor and a float scalar give float32)."""
    ts = [x.dtype for x in (a, b) if isinstance(x, _Node)]
    if not ts:
        return "f32" if any(isinstance(x, float) for x in (a, b)) else "i32"
    best = max(ts, key=_category)
    floats = {t for t in ts if _category(t) == 2}
    if len(floats) > 1:
        best = "f32"
    scalar_cat = max((_category("f32" if isinstance(x, float) else "i32")
                      for x in (a, b) if not isinstance(x, _Node)), default=0)
    if scalar_cat > _category(best):
        best = "f32"
    return best


def _scalar(v):
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        raise _refuse(f"an operand of type {type(v).__name__}")
    if isinstance(v, int) and not -(1 << 31) <= v < (1 << 31):
        raise _refuse(f"the int constant {v} (outside int32)")
    return v


class _Traced:
    """The proxy ``fn`` receives for each input."""

    __slots__ = ("node",)

    def __init__(self, node: _Node):
        self.node = node

    @staticmethod
    def _arg(v):
        return v.node if isinstance(v, _Traced) else _scalar(v)

    @classmethod
    def _binary(cls, op: str, a, b) -> "_Traced":
        a, b = cls._arg(a), cls._arg(b)
        for x in (a, b):
            if isinstance(x, _Node) and x.dtype == "bool":
                raise _refuse(f"'{op}' on a comparison result")
        if op in ("lt", "le", "gt", "ge", "eq", "ne"):
            return cls(_Node(op, (a, b), "bool"))
        t = _promote(a, b)
        if op == "div" and t == "i32":
            t = "f32"  # true division
        return cls(_Node(op, (a, b), t))

    def __add__(self, o): return self._binary("add", self, o)
    def __radd__(self, o): return self._binary("add", o, self)
    def __sub__(self, o): return self._binary("sub", self, o)
    def __rsub__(self, o): return self._binary("sub", o, self)
    def __mul__(self, o): return self._binary("mul", self, o)
    def __rmul__(self, o): return self._binary("mul", o, self)
    def __truediv__(self, o): return self._binary("div", self, o)
    def __rtruediv__(self, o): return self._binary("div", o, self)
    def __lt__(self, o): return self._binary("lt", self, o)
    def __le__(self, o): return self._binary("le", self, o)
    def __gt__(self, o): return self._binary("gt", self, o)
    def __ge__(self, o): return self._binary("ge", self, o)
    def __eq__(self, o): return self._binary("eq", self, o)  # type: ignore[override]
    def __ne__(self, o): return self._binary("ne", self, o)  # type: ignore[override]

    __hash__ = None  # type: ignore[assignment]

    def _unary(self, op: str) -> "_Traced":
        t = self.node.dtype
        if t == "bool":
            raise _refuse(f"'{op}' on a comparison result")
        if op in ("exp", "tanh") and t == "i32":
            t = "f32"
        return _Traced(_Node(op, (self.node,), t))

    def __neg__(self): return self._unary("neg")
    def __abs__(self): return self._unary("abs")
    def abs(self): return self._unary("abs")
    def exp(self): return self._unary("exp")
    def tanh(self): return self._unary("tanh")

    def __bool__(self):
        raise _refuse("control flow on a traced value (bool())")

    def __getattr__(self, name):
        raise _refuse(f"'.{name}'")

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", repr(func))
        if kwargs:
            raise _refuse(f"torch.{name} with keyword arguments {sorted(kwargs)}")
        if func in (torch.maximum, torch.minimum) and len(args) == 2:
            a, b = (cls._arg(x) for x in args)
            if any(x.dtype == "bool" for x in (a, b)):
                raise _refuse(f"torch.{name} on a comparison result")
            op = "max" if func is torch.maximum else "min"
            return cls(_Node(op, (a, b), _promote(a, b)))
        if func in (torch.abs, torch.exp, torch.tanh) and len(args) == 1:
            return cls._unary(args[0], name)
        if func is torch.where and len(args) == 3:
            c, a, b = (cls._arg(x) for x in args)
            if not (isinstance(c, _Node) and c.dtype == "bool"):
                raise _refuse("torch.where whose condition is not a comparison")
            return cls(_Node("where", (c, a, b), _promote(a, b)))
        raise _refuse(f"torch.{name}")


def _refusing(symbol: str):
    def op(*_):
        raise _refuse(f"'{symbol}'")
    return op


for _dunder, _symbol in (("pow", "**"), ("mod", "%"), ("floordiv", "//"), ("matmul", "@"),
                         ("and", "&"), ("or", "|"), ("xor", "^"), ("lshift", "<<"),
                         ("rshift", ">>")):
    setattr(_Traced, f"__{_dunder}__", _refusing(_symbol))
    setattr(_Traced, f"__r{_dunder}__", _refusing(_symbol))
_Traced.__invert__ = _refusing("~")


def _trace(fn: Callable, dtypes: tuple[str, ...]) -> _Node:
    proxies = [_Traced(_Node("arg", (), t, i)) for i, t in enumerate(dtypes)]
    out = fn(*proxies)
    if isinstance(out, _Traced):
        return out.node
    return _Node("const", (_scalar(out),), "f32" if isinstance(out, float) else "i32")


# ---------------------------------------------------------------------------
# emission: the expression as ck_fn / ck_vec / ck_one C++
# ---------------------------------------------------------------------------

def _float_lit(v: float) -> str:
    f = float(np.float32(v))
    if math.isnan(f):
        return "(NAN)"
    if math.isinf(f):
        return "(INFINITY)" if f > 0 else "(-INFINITY)"
    return f"{f.hex()}f"


class _Emitter:
    """The expression as C++ statements, one ``const`` per node."""

    def __init__(self):
        self.lines: list[str] = []
        self.names: dict[int, str] = {}

    def value(self, x, t: str, round_const: bool = False) -> str:
        """``x`` (node or scalar) as a compute value of type ``t``; a
        constant is rounded to ``t``'s storage when ``round_const``."""
        if not isinstance(x, _Node):
            if t == "i32":
                return f"({int(x)})"
            lit = _float_lit(x)
            return f"{_ROUND[t]}({lit})" if round_const and t in _ROUND else lit
        code = self.node(x)
        src = x.dtype
        if src == t or (t == "f32" and src in ("bf16", "f16")):
            return code
        if t == "i32":
            return f"((int)({code}))"
        conv = f"((float)({code}))"  # from an int or a bool
        return f"{_ROUND[t]}({conv})" if t in _ROUND else conv

    def node(self, n: _Node, final: bool = False) -> str:
        """``n`` as a named value; ``final`` leaves out a bf16/f16 root's
        last rounding, which the store's conversion makes."""
        key = id(n)
        if key in self.names:
            return self.names[key]
        t = n.dtype
        if n.op == "arg":
            code = f"a{n.index}"
        elif n.op == "const":
            code = self.value(n.args[0], t)
        elif n.op in ("lt", "le", "gt", "ge", "eq", "ne"):
            a, b = n.args
            ct = _promote(a, b)
            sym = {"lt": "<", "le": "<=", "gt": ">", "ge": ">=", "eq": "==", "ne": "!="}[n.op]
            code = f"({self.value(a, ct, True)} {sym} {self.value(b, ct, True)})"
        elif n.op == "where":
            c, a, b = n.args
            code = f"({self.node(c)} ? {self.value(a, t, True)} : {self.value(b, t, True)})"
        else:
            args = [self.value(x, t) for x in n.args]
            if t == "i32":
                fn = {"add": "ck_iadd", "sub": "ck_isub", "mul": "ck_imul", "neg": "ck_ineg",
                      "abs": "ck_iabs", "max": "ck_imax", "min": "ck_imin"}[n.op]
                code = f"{fn}({', '.join(args)})"
            else:
                if n.op in ("add", "sub", "mul", "div"):
                    sym = {"add": "+", "sub": "-", "mul": "*", "div": "/"}[n.op]
                    code = f"({args[0]} {sym} {args[1]})"
                elif n.op == "neg":
                    code = f"(-{args[0]})"
                else:
                    fn = {"abs": "fabsf", "exp": "expf", "tanh": "tanhf", "max": "ck_fmax",
                          "min": "ck_fmin"}[n.op]
                    code = f"{fn}({', '.join(args)})"
                if t in _ROUND and n.op not in ("neg", "abs", "max", "min") and not final:
                    code = f"{_ROUND[t]}({code})"
        name = f"t{len(self.names)}"
        self.lines.append(f"  const {_COMPUTE_C[t]} {name} = {code};")
        self.names[key] = name
        return name


def _emit(root: _Node, dtypes: tuple[str, ...], out: str) -> str:
    em = _Emitter()
    # a bf16/f16 result is rounded once, by the store's conversion
    if root.dtype == out:
        result = em.node(root, final=True)
    else:
        result = em.value(root, "f32" if out in _ROUND else out)
    params = ", ".join(f"{_COMPUTE_C[t]} a{i}" for i, t in enumerate(dtypes))
    vec = 16 // max(_ITEMSIZE[t] for t in (*dtypes, out))
    so = _STORAGE_C[out]
    ptrs = [f"  const {_STORAGE_C[t]}* __restrict__ p{i} = (const {_STORAGE_C[t]}*)a.in[{i}];"
            for i, t in enumerate(dtypes)]
    regs = " ".join(f"CkVec<{_STORAGE_C[t]}, {vec}> x{i}[U];" for i, t in enumerate(dtypes))
    loads = [f"    x{i}[u] = ck_vload<{_STORAGE_C[t]}, {vec}>(p{i}, (v + u * nt) * CK_VEC);"
             for i, t in enumerate(dtypes)]

    def call(k: str) -> str:
        args = ", ".join(_LOAD[t].format(f"x{i}[u].v[{k}]") for i, t in enumerate(dtypes))
        return f"ck_fn({args})"

    if out in _PAIR:
        compute = (f"    for (int k = 0; k < {vec}; k += 2) "
                   f"{_PAIR[out]}(&r.v[k], {call('k')}, {call('k + 1')});")
    else:
        compute = f"    for (int k = 0; k < {vec}; ++k) r.v[k] = {_STORE[out].format(call('k'))};"
    call_1 = ", ".join(_LOAD[t].format(f"((const {_STORAGE_C[t]}*)a.in[{i}])[i]")
                       for i, t in enumerate(dtypes))
    return "\n".join([
        f"#define CK_VEC {vec}",
        f"CK_D {_COMPUTE_C[out]} ck_fn({params}) {{",
        *em.lines,
        f"  return {result};",
        "}",
        "template <int U>",
        "CK_D void ck_vecs(const CkArgs& a, long long v, long long nt) {",
        *ptrs,
        f"  {so}* __restrict__ po = ({so}*)a.out;",
        f"  {regs}",
        "#pragma unroll",
        "  for (int u = 0; u < U; ++u) {",
        *loads,
        "  }",
        "#pragma unroll",
        "  for (int u = 0; u < U; ++u) {",
        f"    CkVec<{so}, {vec}> r;",
        "#pragma unroll",
        compute,
        f"    ck_vstore<{so}, {vec}>(po, (v + u * nt) * CK_VEC, r);",
        "  }",
        "}",
        "CK_D void ck_one(const CkArgs& a, long long i) {",
        f"  (({so}*)a.out)[i] = {_STORE[out].format(f'ck_fn({call_1})')};",
        "}",
    ])


def kernel_source(fn: Callable, dtypes: tuple[torch.dtype, ...],
                  out_dtype: torch.dtype | None = None) -> str:
    """The CUDA C++ source of ``map_blocks(fn, ...)`` over inputs of
    ``dtypes`` (``csrc/elementwise.cu`` with the traced ``fn`` spliced in);
    the same text compiles with g++ for the host.  Raises
    :class:`KernelCompileError` for an op or a dtype outside the table."""
    names = tuple(_dtype_name(d) for d in dtypes)
    out = _dtype_name(out_dtype if out_dtype is not None else dtypes[0])
    if len(names) > _MAX_IN:
        raise KernelCompileError(
            f"map_blocks: {len(names)} inputs; the elementwise kernel takes at most {_MAX_IN}")
    body = _emit(_trace(fn, names), names, out)
    return SOURCE.read_text().replace(_MARKER, body)


def _dtype_name(d: torch.dtype) -> str:
    if d not in _DTYPES:
        raise KernelCompileError(
            f"map_blocks: dtype {d} is not one of the elementwise kernel's "
            f"(float32, int32, bfloat16, float16)")
    return _DTYPES[d]


# ---------------------------------------------------------------------------
# build, cache and launch
# ---------------------------------------------------------------------------

_CACHE_MAX = 256
_cache: OrderedDict[tuple, str] = OrderedDict()  # (fn, dtypes) -> source
_cache_mu = threading.Lock()
_launchers: dict[tuple[str, str], Callable] = {}  # (source, compiler) -> ew_launch


def _source_for(fn: Callable, dtypes: tuple[torch.dtype, ...]) -> str:
    key = (fn, dtypes)
    with _cache_mu:
        src = _cache.get(key)
        if src is not None:
            _cache.move_to_end(key)
            return src
    src = kernel_source(fn, dtypes)
    with _cache_mu:
        _cache[key] = src
        if len(_cache) > _CACHE_MAX:
            _cache.popitem(last=False)
    return src


def launcher(source: str, compiler: str = "nvcc") -> Callable:
    """``ew_launch`` of one spliced source, built once (``compiler`` is
    ``"nvcc"`` for the card or ``"g++"`` for the host build)."""
    key = (source, compiler)
    fn = _launchers.get(key)
    if fn is None:
        lib = build_library(source, "elementwise", compiler=compiler)
        fn = lib.ew_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_void_p]
        _launchers[key] = fn
    return fn


def run(launch: Callable, out: torch.Tensor, arrays, stream) -> None:
    """Launch ``ew_launch`` over ``arrays`` into ``out`` (all contiguous,
    one device, ``out.numel()`` elements): vector loads when every pointer
    is aligned to 16 bytes' worth of its widest element, else scalar."""
    tensors = (*arrays, out)
    sizes = [t.element_size() for t in tensors]
    ptrs = [t.data_ptr() for t in tensors]
    width = 16 // max(sizes)
    vec = int(all(p % (width * z) == 0 for p, z in zip(ptrs, sizes)))
    ins = (ctypes.c_void_p * max(1, len(arrays)))(*ptrs[:-1])
    rc = launch(ptrs[-1], ins, len(arrays), out.numel(), vec, stream)
    if rc != 0:
        raise KernelCompileError(f"map_blocks: elementwise kernel launch failed with error {rc}")


def _validate(arrays) -> int:
    n = arrays[0].shape[0]
    if any(tuple(a.shape) != (n,) for a in arrays):
        raise ValueError("map_blocks needs equal-length 1-D arrays")
    if n % _LANES != 0:
        raise ValueError(f"length ({n}) must be a multiple of {_LANES}")
    return n


def _overlaps(a: torch.Tensor, b: torch.Tensor) -> bool:
    a0, b0 = a.data_ptr(), b.data_ptr()
    return a0 < b0 + b.numel() * b.element_size() and b0 < a0 + a.numel() * a.element_size()


def map_blocks_plain(fn: Callable, *arrays: torch.Tensor) -> torch.Tensor:
    """The plain version: ``fn`` on the tensors, as ``arrays[0].dtype``."""
    PLAIN_RUNS.add(arrays[0].device.type)
    r = fn(*arrays)
    if not isinstance(r, torch.Tensor):
        r = torch.full_like(arrays[0], r)
    return r.to(arrays[0].dtype)


def map_blocks(fn: Callable, *arrays: torch.Tensor, block_rows: int = 256,
               out: torch.Tensor | None = None) -> torch.Tensor:
    """Apply elementwise ``fn(*blocks) -> block`` over 1-D tensors of equal
    length (a multiple of 128); the result has ``arrays[0].dtype``.

    ``out`` (optional) receives the result in place: a contiguous tensor of
    that length and dtype on the same device, which may be one of the
    inputs but may not partly overlap one.  On CUDA tensors this launches
    the elementwise kernel on the current stream or raises; on CPU tensors
    it runs :func:`map_blocks_plain`.  ``block_rows`` is the TPU kernel's
    block height, kept for the JAX package's signature: the card's kernel
    sizes its grid from the SM count instead, and the result depends on
    neither."""
    n = _validate(arrays)
    dev = arrays[0].device
    dtypes, contiguous = [], True
    for a in arrays:  # one pass over the inputs: device, dtype, layout
        if a.device != dev:
            raise KernelCompileError("map_blocks: all arrays must lie on one device")
        dtypes.append(a.dtype)
        contiguous = contiguous and a.is_contiguous()
    dtypes = tuple(dtypes)
    src = _source_for(fn, dtypes)  # the op table holds on every device
    if out is not None:
        if (tuple(out.shape) != (n,) or out.dtype != dtypes[0] or out.device != dev
                or not out.is_contiguous()):
            raise KernelCompileError(
                f"map_blocks: out must be a contiguous ({n},) {dtypes[0]} tensor on {dev}")
        if any(_overlaps(out, a) and out.data_ptr() != a.data_ptr() for a in arrays):
            raise KernelCompileError("map_blocks: out partly overlaps an input")
    if dev.type == "cpu":
        r = map_blocks_plain(fn, *arrays)
        return r if out is None else out.copy_(r)
    if dev.type != "cuda":
        raise KernelCompileError(f"map_blocks: unsupported device {dev}")
    if not contiguous:
        raise KernelCompileError("map_blocks: the kernel takes contiguous tensors")
    if out is None:
        out = torch.empty(n, dtype=dtypes[0], device=dev)
    run(launcher(src), out, arrays, torch.cuda.current_stream(dev).cuda_stream)
    LAUNCHES.add()
    return out


@functools.lru_cache(maxsize=64)
def _saxpy_fn(a: float) -> Callable:
    return lambda xb, yb: yb + a * xb


def saxpy(alpha, x: torch.Tensor, y: torch.Tensor, out: torch.Tensor | None = None,
          block_rows: int = 256) -> torch.Tensor:
    """``y + alpha·x`` in one pass; ``alpha`` (a Python scalar) is folded
    into the kernel as a constant, as the TPU version's static argument."""
    return map_blocks(_saxpy_fn(float(alpha)), x, y, block_rows=block_rows, out=out)
