"""The emitter's escape form, checked without a card.

A kernel with a ``while`` loop at the top of its body (or a ``for`` loop
there that the loop form does not take) whose condition has no side effect
and whose body stores nothing takes a fourth form
(``kernel/cuda_backend.py``): the loop runs in unrolled groups of
``ESCAPE_GROUP`` passes with a sticky flag and no branch inside a group,
the variables read after the loop kept where the flag is down; a conjunct
``counter < bound`` of the condition is tested once a group where the
counter starts uniform and rises by one a pass.

Here: which kernels take the form and the named reason of every one that
does not; and the host build (g++) of the form held bit for bit against
the host build of the item form and against the torch lowering
(``codegen.build_kernel_fn``) on mandelbrot at max_iter values around the
group, on a view whose outer pixels run on to inf and NaN, and on kernels
with several live-outs of int, float and double, a live-out assigned under
an ``if``, a loop whose first test fails, integer wraparound and clamped
reads while a thread runs on, and a condition that reads an array.
"""

from __future__ import annotations

import shutil
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from cekirdekler_tpu_torch import workloads
from cekirdekler_tpu_torch.errors import KernelCompileError
from cekirdekler_tpu_torch.kernel import codegen, cuda_backend, lang
from cekirdekler_tpu_torch.kernel.lang import CrementStmt, Var, While

K = cuda_backend.ESCAPE_GROUP
MAX_ITERS = [1, K - 1, K, K + 1, 60, 256]
NP = {"int": np.int32, "float": np.float32, "double": np.float64}

SAXPY_SRC = """
__kernel void saxpy(__global float* x, __global float* y, float a) {
    int i = get_global_id(0);
    y[i] = a * x[i] + y[i];
}"""
# live-outs of int, float and double; x runs on (not read after the loop)
MULTI_SRC = """
__kernel void multi(__global float* a, __global int* q, __global float* f,
                    __global double* d, int n) {
    int i = get_global_id(0);
    float x = a[i];
    int c = 0;
    float s = 0.0f;
    double w = 1.0;
    while (x < 40.0f && c < n) {
        x = x * 1.5f + 0.25f;
        s = s + x;
        w = w * 1.0625 + (double)x;
        c++;
    }
    q[i] = c;
    f[i] = s;
    d[i] = w;
}"""
# live-outs assigned under an if, the counter stepped with += 1
IF_SRC = """
__kernel void branchy(__global float* a, __global int* q, __global float* o, int n) {
    int i = get_global_id(0);
    float x = a[i];
    int hits = 0;
    int k = 0;
    float last = -1.0f;
    while (k < n && x > 0.001f) {
        if (x > 0.5f) {
            hits = hits + 2;
            last = x;
        } else {
            hits = hits - 1;
        }
        x = x * 0.7f;
        k += 1;
    }
    q[i] = hits * 1000 + k;
    o[i] = last;
}"""
# no counter: groups run until the flag drops; the first test fails where a[i] <= 2
FIRST_SRC = """
__kernel void first(__global float* a, __global int* q) {
    int i = get_global_id(0);
    float x = a[i];
    int c = 7;
    while (x > 2.0f) {
        x = x - 1.0f;
        c = c * 3;
    }
    q[i] = c;
}"""
# run-on: h and acc wrap, j leaves the array at both ends (the reads clamp)
WRAP_SRC = """
__kernel void wrap(__global int* t, __global int* q, __global int* r, int n) {
    int i = get_global_id(0);
    int h = t[i];
    int j = i;
    int acc = 0;
    int steps = 0;
    while ((h & 15) != 7 && steps < n) {
        h = h * 48271 + t[j];
        j = j * 3 + 1;
        acc = acc * 31 + (h >> 7) + t[j - 5];
        steps++;
    }
    q[i] = acc;
    r[i] = steps;
}"""
# the condition reads an array, past its end as j runs on
READ_SRC = """
__kernel void reads(__global float* lim, __global int* q) {
    int i = get_global_id(0);
    int j = i;
    float s = 0.0f;
    while (s < lim[j] && s < 100.0f) {
        s = s + 0.75f;
        j = j + 5;
    }
    q[i] = j;
}"""
# a for loop that the loop form does not take (no array read at buf[j + c])
FOR_SRC = """
__kernel void fsum(__global float* a, __global float* o, int n) {
    int i = get_global_id(0);
    float s = a[i];
    for (int k = 0; k < n; k++) {
        s = s * 0.5f + (float)k;
    }
    o[i] = s;
}"""
# counters that cannot be tested once a group: a start that differs per item,
# a step under an if, a float counter; each keeps its conjunct in every pass
NO_HOIST = {
    "divergent-start": MULTI_SRC.replace("int c = 0;", "int c = i % 3;"),
    "step-under-if": IF_SRC.replace("k += 1;", "if (x > 0.1f) { k += 1; } else { k += 1; }"),
    "float-counter": """
__kernel void fc(__global float* a, __global float* o, float n) {
    int i = get_global_id(0);
    float x = a[i];
    float t = 0.0f;
    while (t < n && x < 30.0f) {
        x = x * 1.25f + 0.5f;
        t += 1;
    }
    o[i] = t + x;
}""",
}
KERNELS = {"mandelbrot": workloads.MANDELBROT_SRC, "multi": MULTI_SRC, "branchy": IF_SRC,
           "first": FIRST_SRC, "wrap": WRAP_SRC, "reads": READ_SRC, "fsum": FOR_SRC,
           **NO_HOIST}


def _kdef(src: str):
    return lang.parse_kernels(src)[-1]


# ---------------------------------------------------------------------------
# which kernels take the escape form, and why the others do not
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(KERNELS))
def test_escape_kernels_take_the_form(name):
    kdef = _kdef(KERNELS[name])
    assert cuda_backend.unsupported_reason(kdef) is None
    assert cuda_backend.escape_reason(kdef) is None
    assert cuda_backend.loop_reason(kdef) is not None
    src = cuda_backend.emit_source(kdef)
    assert "ck_kernel_escape(" in src and "ck_last_form = 3;" in src
    assert f"for (int ck_u = 0; ck_u < {K}; ++ck_u)" in src
    item = cuda_backend.emit_source(kdef, escape=False)
    assert "ck_kernel_escape" not in item and "ck_in" not in item


def test_mandelbrot_tests_its_counter_once_a_group():
    """``it < maxIter`` leaves the passes: each tests only the escape, a
    group runs while ``it <= maxIter - K``, and ``it`` (read after the
    loop) is set from the passes' flags in the group where the flag
    dropped, not kept pass by pass; ``zx`` and ``zy`` run on."""
    src = cuda_backend.emit_source(_kdef(workloads.MANDELBROT_SRC))
    assert f"const long long ck_last = (long long)(v_maxIter) - {K};" in src
    assert "while (ck_in && v_it <= ck_lim)" in src
    assert ("const bool ck_ok = (((v_zx * v_zx) + (v_zy * v_zy)) < 0x1.0000000000000p+2f);"
            in src)
    assert "ck_f[ck_u] = ck_in;" in src and "v_it = ck_add(v_it, ck_n);" in src
    assert "ck_o_" not in src


@pytest.mark.parametrize("name", sorted(NO_HOIST))
def test_a_counter_that_may_not_rise_by_one_stays_in_every_pass(name):
    src = cuda_backend.emit_source(_kdef(NO_HOIST[name]))
    assert "ck_lim" not in src and "} while (ck_in);" in src


def test_live_outs_are_the_variables_read_after_the_loop():
    """``s`` and ``w`` are kept pass by pass, the counter ``c`` is set from
    the flags, and ``x`` (not read after the loop) runs on."""
    src = cuda_backend.emit_source(_kdef(MULTI_SRC))
    for name, ctype in (("s", "float"), ("w", "double")):
        assert f"const {ctype} ck_o_{name} = v_{name};" in src
    assert "v_c = ck_add(v_c, ck_n);" in src
    assert "ck_o_x" not in src and "ck_o_c" not in src
    src = cuda_backend.emit_source(_kdef(NO_HOIST["divergent-start"]))
    assert "const int ck_o_c = v_c;" in src and "ck_f[" not in src


def _body(stmts: str, cond: str = "x < 4.0f && c < n", before: str = "") -> str:
    return ("float h(float v) { float r = v; while (r > 1.0f) { r = r * 0.5f; } return r; }\n"
            "__kernel void k(__global float* a, __global float* o, int n) {"
            " int i = get_global_id(0); float x = a[i]; int c = 0; float t[2];"
            f" {before} while ({cond}) {{ {stmts} x = x * 1.5f; c++; }} o[i] = x + (float)c; }}")


REFUSALS = [
    ("store", _body("o[i] = x;"), "a store to 'o' in the loop"),
    ("break", _body("if (x > 3.0f) { break; }"), "a break in the loop"),
    ("continue", _body("if (x > 3.0f) { continue; }"), "a continue in the loop"),
    ("nested-loop", _body("for (int m = 0; m < 2; m++) { x = x + 0.5f; }"),
     "a nested loop in the loop"),
    ("private-array", _body("t[c % 2] = x;"), "the loop assigns the private array 't'"),
    ("helper-with-a-loop", _body("x = h(x);"), "the helper 'h', which holds a loop"),
    ("under-an-if",
     "__kernel void k(__global float* a, __global float* o, int n) { int i = get_global_id(0);"
     " float x = a[i]; if (n > 2) { while (x < 4.0f) { x = x * 1.5f; } } o[i] = x; }",
     "no while or for loop at the top of the kernel body"),
    ("do-while",
     "__kernel void k(__global float* a, __global float* o, int n) { int i = get_global_id(0);"
     " float x = a[i]; do { x = x * 1.5f; } while (x < 4.0f); o[i] = x; }",
     "a do ... while loop"),
    ("no-loop", SAXPY_SRC, "no while or for loop at the top of the kernel body"),
]


@pytest.mark.parametrize("src,why", [r[1:] for r in REFUSALS], ids=[r[0] for r in REFUSALS])
def test_refusals_are_named(src, why):
    kdef = _kdef(src)
    assert cuda_backend.unsupported_reason(kdef) is None
    reason = cuda_backend.escape_reason(kdef)
    assert reason is not None and why in reason, reason
    for target in ("cuda", "host"):
        assert "ck_kernel_escape" not in cuda_backend.emit_source(kdef, target=target)


def test_a_side_effect_in_the_condition_is_refused():
    """The parser takes no ``i++`` or assignment inside a condition; a
    condition built with one is named by the form's own check."""
    with pytest.raises(KernelCompileError, match="expected '\\)'"):
        _kdef(_body("", cond="c++ < n"))
    kdef = _kdef(_body(""))
    loop = next(s for s in kdef.body if isinstance(s, While))
    k = kdef.body.index(loop)
    bumped = While(cond=CrementStmt(target=Var(name="c"), op="++"), body=loop.body)
    assert cuda_backend._escape_refusal(kdef, k, bumped) == "the loop's condition has a side effect"


def test_a_return_in_the_loop_is_refused():
    """A ``return`` inside a loop is outside the emitter's subset (the torch
    lowering runs the kernel); the form's own check names it too."""
    kdef = _kdef(_body("if (x > 3.0f) { return; }"))
    assert "'return' inside a loop" in cuda_backend.unsupported_reason(kdef)
    loop = next(s for s in kdef.body if isinstance(s, While))
    assert cuda_backend._escape_refusal(kdef, kdef.body.index(loop), loop) == \
        "a return in the loop"


def test_the_other_forms_keep_their_kernels():
    """n-body stays on the loop form; streamAdd and saxpy stream."""
    nbody = _kdef(workloads.NBODY_SRC)
    assert cuda_backend.loop_reason(nbody) is None
    assert cuda_backend.escape_reason(nbody) == "the loop form takes the kernel"
    for src in (workloads.STREAM_SRC, SAXPY_SRC):
        kdef = _kdef(src)
        assert cuda_backend.stream_reason(kdef) is None
        assert "no while or for loop" in cuda_backend.escape_reason(kdef)


def test_the_form_code_names_the_escape_form():
    """``ck_form()`` is 3 after an escape-form launch, which the wrapper
    counts in ``FORMS`` as ``(name, "escape")``."""
    assert cuda_backend._FORM_NAMES == ("item", "stream", "loop", "escape")


# ---------------------------------------------------------------------------
# the host build against the item form and the torch lowering
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def host():
    """``{(name, escape): (kernel, ck_launch, ck_form)}`` of host builds,
    each built once, all in parallel."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the emitted body cannot be compiled on the host")

    def one(item):
        name, escape = item
        ck = cuda_backend._CudaKernel(_kdef(KERNELS[name]), escape=escape)
        return item, (ck, *ck.entry(tuple(p.ctype for p in ck.arrays), "host"))

    items = [(name, escape) for name in KERNELS for escape in (True, False)]
    with ThreadPoolExecutor(max_workers=4) as pool:
        return dict(pool.map(one, items))


def _run(host, key, arrays, values, offset, chunk):
    ck, launch, form = host[key]
    got = tuple(torch.from_numpy(a.copy()) for a in arrays)
    gsize = max(a.size for a in arrays)
    assert launch(*ck.args(got, values, offset, chunk, gsize, 16), None) == 0
    return got, form()


def _bits(ts) -> list[np.ndarray]:
    """Each array's bits, every NaN made the one quiet NaN."""
    out = []
    for t in ts:
        a = t.numpy()
        if a.dtype.kind == "f":
            a = np.where(np.isnan(a), np.array(np.nan, a.dtype), a)
        out.append(a.view(f"u{a.itemsize}"))
    return out


def _check(host, name, arrays, values, offset, chunk):
    """The escape form's bits equal the item form's and the torch lowering's."""
    kdef = _kdef(KERNELS[name])
    n = max(a.size for a in arrays)
    plain = tuple(torch.from_numpy(a.copy()) for a in arrays)
    codegen.build_kernel_fn(kdef, chunk, 16, n)[0](offset, plain, values)
    got, form = _run(host, (name, True), arrays, values, offset, chunk)
    item, item_form = _run(host, (name, False), arrays, values, offset, chunk)
    assert (form, item_form) == (3, 0)
    for i, (p, g, t) in enumerate(zip(_bits(plain), _bits(got), _bits(item))):
        np.testing.assert_array_equal(g, t, err_msg=f"{name} array {i} vs the item form")
        np.testing.assert_array_equal(g, p, err_msg=f"{name} array {i} vs the torch lowering")
    return got


VIEWS = {"set": (-2.0, -1.25, 2.5 / 64, 2.5 / 48), "run-on": (-40.0, -30.0, 1.0, 1.0)}


@pytest.mark.parametrize("view", sorted(VIEWS))
@pytest.mark.parametrize("max_iter", MAX_ITERS)
def test_host_mandelbrot_equals_the_item_form(host, max_iter, view):
    """64x48 pixels over the set, and over a view whose outer pixels escape
    at once and run on to inf and NaN, whole and at a chunk of 777 from
    offset 1000; the image also equals ``mandelbrot_host``."""
    w, h = 64, 48
    vals = (*VIEWS[view], w, max_iter)
    zeros = [np.zeros(w * h, np.float32)]
    got = _check(host, "mandelbrot", zeros, vals, 0, w * h)
    np.testing.assert_array_equal(got[0].numpy(),
                                  workloads.mandelbrot_host(w, h, *vals[:4], max_iter))
    _check(host, "mandelbrot", zeros, vals, 1000, 777)


def _inputs(kdef, n: int, seed: int, scale: float) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    out = []
    for p in kdef.params:
        if p.is_pointer:
            dt = NP[p.ctype]
            if np.issubdtype(dt, np.floating):
                out.append((rng.random(n) * scale).astype(dt))
            else:
                out.append(rng.integers(-(1 << 30), 1 << 30, n).astype(dt))
    return out


CASES = [  # kernel, input scale, value parameters
    ("multi", 3.0, (50,)), ("multi", 3.0, (K + 1,)), ("multi", 3.0, (0,)),
    ("branchy", 1.5, (40,)), ("branchy", 1.5, (K - 1,)),
    ("first", 1.0, ()), ("first", 6.0, ()),
    ("wrap", 1.0, (300,)), ("wrap", 1.0, (K,)),
    ("reads", 10.0, ()), ("fsum", 1.0, (37,)), ("fsum", 1.0, (K,)),
    ("divergent-start", 3.0, (50,)), ("step-under-if", 1.5, (40,)),
    ("float-counter", 3.0, (25.0,)),
]


@pytest.mark.parametrize("name,scale,values", CASES,
                         ids=[f"{c[0]}-{c[1]}-{c[2][0] if c[2] else ''}" for c in CASES])
def test_host_escape_form_equals_the_item_form(host, name, scale, values):
    """Whole arrays and a chunk of 96 from offset 64, at n = 300."""
    arrays = _inputs(_kdef(KERNELS[name]), 300, len(name) + len(values), scale)
    for offset, chunk in ((0, 300), (64, 96)):
        _check(host, name, arrays, values, offset, chunk)


def test_a_loop_whose_first_test_fails_keeps_every_value(host):
    """Every a[i] below 2: no pass runs, and c keeps its 7."""
    got = _check(host, "first", [np.linspace(-1.0, 1.9, 200, dtype=np.float32),
                                 np.zeros(200, np.int32)], (), 0, 200)
    assert (got[1].numpy() == 7).all()


def test_run_on_wraps_and_clamps(host):
    """A thread whose test fails in the first pass of a group runs on for
    the group's other passes: its h and acc overflow and j leaves the
    array at both ends; the results still equal the item form's."""
    t = np.full(64, 7, np.int32)          # (h & 15) == 7: the first test fails
    t[::3] = 0x7fff0001                   # these run several passes, overflowing h
    got = _check(host, "wrap", [t, np.zeros(64, np.int32), np.zeros(64, np.int32)],
                 (1000,), 0, 64)
    assert (got[2].numpy()[1::3] == 0).all() and (got[2].numpy()[::3] > 0).all()


def test_cpu_tensors_run_the_plain_version_and_count_no_launch():
    kdef = _kdef(workloads.MANDELBROT_SRC)
    vals = (-2.0, -1.25, 2.5 / 32, 2.5 / 16, 32, 40)
    fn, _ = cuda_backend.build_kernel_fn_cuda(kdef, 512, 16, 512)
    out = torch.zeros(512)
    launches, forms = cuda_backend.LAUNCHES.count, dict(cuda_backend.FORMS.by_key)
    fn(0, (out,), vals)
    np.testing.assert_array_equal(out.numpy(), workloads.mandelbrot_host(32, 16, *vals[:4], 40))
    assert cuda_backend.LAUNCHES.count == launches
    assert dict(cuda_backend.FORMS.by_key) == forms


def test_a_refused_escape_form_build_raises_named_error(monkeypatch):
    """With no nvcc the escape form's build raises, naming the compiler; no
    other form is tried."""
    from cekirdekler_tpu_torch.kernel import build

    monkeypatch.setattr(build, "nvcc_path", lambda: None)
    ck = cuda_backend._CudaKernel(_kdef(workloads.MANDELBROT_SRC))
    with pytest.raises(KernelCompileError, match="nvcc not found"):
        ck.entry(tuple(p.ctype for p in ck.arrays))
