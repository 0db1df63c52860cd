"""The emitter's loop form, checked without a card.

A kernel with a ``for`` loop at the top of its body whose trip sequence is
provably the same in every work item, and an array that no one stores read
in it at ``buf[j + c]``, takes a third form (``kernel/cuda_backend.py``):
each CTA stages the loop's ``buf[j + c]`` reads tile by tile in shared
memory and every thread runs the tile's iterations in j order from there;
iterations whose IEEE sqrt and reciprocal would branch to a slow path run
in groups on the fast paths, and a group that needs a slow path runs again
with the IEEE functions.

The host build (g++) emits the same form, with each CTA's threads run as
threads of their own that meet at a barrier, and is held here bit for bit
against the torch lowering (``codegen.build_kernel_fn``) and against the
host build of the item form, at sizes off the tile, at offsets, with a
bound past the arrays' ends (clamped staging) and with inputs that send the
fast paths to the slow ones.  The uniformity analysis the form rests on is
held against the reference's on every kernel source of the test suite.
"""

from __future__ import annotations

import ast
import shutil
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from cekirdekler_tpu.kernel import codegen as ref_codegen
from cekirdekler_tpu.kernel import lang as ref_lang
from cekirdekler_tpu_torch import workloads
from cekirdekler_tpu_torch.errors import KernelCompileError
from cekirdekler_tpu_torch.kernel import codegen, cuda_backend, lang, uniform

ROOT = Path(__file__).resolve().parents[1]
NP = {"char": np.int8, "int": np.int32, "long": np.int64, "float": np.float32,
      "double": np.float64}

# loop-form kernels beyond n-body: offsets j + c off both ends of the arrays,
# a negative start, continue under a divergent condition, an inner loop, a
# uniform condition, a private array, double and char staging, rsqrt, a
# carried int and double, and bodies that cannot run in groups (a store, a
# private array carried across iterations)
SHIFTED_SRC = """
__kernel void sh(__global float* a, __global float* b, __global float* o, int n) {
    int i = get_global_id(0);
    float s = 0.0f;
    for (int j = -2; j < n; j++) {
        s = s + a[j] * b[j + 3] - a[j - 1];
    }
    o[i] = s;
}"""
MIXED_SRC = """
__kernel void mx(__global double* d, __global char* c, __global float* f,
                 __global double* o, __global int* q, int n) {
    int i = get_global_id(0);
    double acc = 0.0;
    int hits = 0;
    float t[2];
    for (int j = 0; j < n; j++) {
        if (c[j] > 3) {
            hits++;
            continue;
        }
        t[j % 2] = f[j] * f[i];
        for (int k = 0; k < 2; k++) { acc = acc + t[k]; }
        if (n > 10) { acc = acc + d[j] * 0.5; }
    }
    o[i] = acc;
    q[i] = hits;
}"""
GROUP_SRC = """
__kernel void gr(__global float* x, __global float* y, __global float* o, __global int* q,
                 int n) {
    int i = get_global_id(0);
    float s = 0.0f;
    double w = 0.0;
    int m = 0;
    for (int j = 0; j < n; j++) {
        if (j == i) continue;
        float d = x[j] - x[i];
        float r = rsqrt(d * d + y[j]);
        s += d * r + 1.0f / (y[j] + 2.0f);
        w = w + (double)sqrt(fabs(x[j]));
        m = m + (r > 1.0f ? 1 : 0);
    }
    o[i] = s + (float)w;
    q[i] = m;
}"""
STORE_IN_LOOP_SRC = """
__kernel void st(__global float* x, __global float* o, int n) {
    int i = get_global_id(0);
    float s = 0.0f;
    for (int j = 0; j < n; j++) {
        s = s + sqrt(x[j]);
        o[i] = s;
    }
}"""
CARRIED_ARRAY_SRC = """
__kernel void ca(__global float* x, __global float* o, int n) {
    int i = get_global_id(0);
    float acc[2];
    for (int j = 0; j < n; j++) {
        acc[j % 2] = acc[j % 2] + 1.0f / x[j];
    }
    o[i] = acc[0] - acc[1];
}"""
LOOP_KERNELS = {"nBody": workloads.NBODY_SRC, "sh": SHIFTED_SRC, "mx": MIXED_SRC,
                "gr": GROUP_SRC, "st": STORE_IN_LOOP_SRC, "ca": CARRIED_ARRAY_SRC}


def _kdef(src: str):
    return lang.parse_kernels(src)[-1]


def _harvested_sources() -> list[tuple[str, str]]:
    """Every kernel source string of the test suite's kernel files."""
    out = []
    for rel in ("tests/test_kernel_lang.py", "tests/test_oracle_fuzz.py",
                "tests/test_pallas_backend.py", "tests/kernel_corpus.py",
                "tests/test_ckprove.py", "tests/test_core.py"):
        seen = set()
        for node in ast.walk(ast.parse((ROOT / rel).read_text())):
            if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                    and "__kernel" in node.value and node.value not in seen):
                seen.add(node.value)
                out.append((f"{Path(rel).stem}:{node.lineno}", node.value))
    return out


def _loop_corpus() -> list[tuple[str, str, str]]:
    """(id, source, kernel name) of each harvested kernel that takes the loop form."""
    out = []
    for key, src in _harvested_sources():
        try:
            kernels = lang.parse_kernels(src)
        except Exception:  # noqa: BLE001 - not a kernel source for this parser
            continue
        for k in kernels:
            if cuda_backend.unsupported_reason(k) is None and cuda_backend.loop_reason(k) is None:
                out.append((f"{key}:{k.name}", src, k.name))
    return out


LOOP_CORPUS = _loop_corpus()


# ---------------------------------------------------------------------------
# which kernels take the loop form, and why the others do not
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(LOOP_KERNELS))
def test_loop_kernels_take_the_form(name):
    kdef = _kdef(LOOP_KERNELS[name])
    assert cuda_backend.unsupported_reason(kdef) is None
    assert cuda_backend.loop_reason(kdef) is None
    assert cuda_backend.stream_reason(kdef) is not None
    src = cuda_backend.emit_source(kdef)
    assert "ck_kernel_loop(" in src and "cp.async.ca.shared.global" in src
    assert "ck_kernel(" not in src and "ck_kernel_loop" not in cuda_backend.emit_source(
        kdef, loop=False)


def test_corpus_kernels_that_take_the_form():
    """The gather loops of the suite's kernel files take the loop form: the
    corpus's full and partial gathers, the reference's dot-row and
    uniform-gather kernels."""
    names = {key.rsplit(":", 1)[1] for key, _, _ in LOOP_CORPUS}
    assert {"nb", "gp", "dotrow", "mx", "k"} <= names, names


def test_nbody_stages_x_y_z_in_one_16_byte_slot():
    src = cuda_backend.emit_source(_kdef(workloads.NBODY_SRC))
    assert "struct alignas(16) CkSlot { float s0; float s1; float s2; };" in src
    assert "v_ddx = (ck_s.s0 - v_xi);" in src
    assert "ck_sqrtf_fast(v_r2, ck_slow)" in src and "ck_rcpf_fast(" in src


def test_slot_fields_go_widest_first():
    src = cuda_backend.emit_source(_kdef(MIXED_SRC))
    assert "struct alignas(16) CkSlot { double s2; float s1; signed char s0; };" in src


@pytest.mark.parametrize("name,grouped", [("nBody", True), ("gr", True), ("sh", False),
                                          ("mx", False), ("st", False), ("ca", False)])
def test_groups_only_where_the_body_is_pure_and_takes_a_fast_path(name, grouped):
    """A group runs again from saved state, so its body may store to no
    array and carry no private array; without a float sqrt or 1.0f / x
    there is nothing to group."""
    src = cuda_backend.emit_source(_kdef(LOOP_KERNELS[name]))
    assert ("bool ck_slow = false;" in src) == grouped


REFUSALS = [
    ("divergent-bound",
     "__kernel void k(__global float* x, __global float* o) { int i = get_global_id(0);"
     " float s = 0.0f; for (int j = 0; j < i; j++) { s += x[j]; } o[i] = s; }",
     "not provably the same in every work item"),
    ("divergent-start",
     "__kernel void k(__global float* x, __global float* o, int n) { int i = get_global_id(0);"
     " float s = 0.0f; int b = 0; if (x[i] > 0.0f) { b = 1; }"
     " for (int j = b; j < n; j++) { s += x[j]; } o[i] = s; }",
     "not provably the same in every work item"),
    ("return-before",
     "__kernel void k(__global float* x, __global float* o, int n) { int i = get_global_id(0);"
     " if (x[i] < 0.0f) return; float s = 0.0f;"
     " for (int j = 0; j < n; j++) { s += x[j]; } o[i] = s; }",
     "a return before the loop"),
    ("divergent-break",
     "__kernel void k(__global float* x, __global float* o, int n) { int i = get_global_id(0);"
     " float s = 0.0f; for (int j = 0; j < n; j++) { if (x[j] > x[i]) { break; } s += x[j]; }"
     " o[i] = s; }",
     "a break out of the loop"),
    ("mandelbrot-while", workloads.MANDELBROT_SRC, "no for loop at the top of the kernel body"),
    ("loop-in-helper",
     "float h(float v, int n) { float s = 0.0f; for (int j = 0; j < n; j++) { s += v; }"
     " return s; }"
     " __kernel void k(__global float* x, __global float* o, int n) { int i = get_global_id(0);"
     " o[i] = h(x[i], n); }",
     "no for loop at the top of the kernel body"),
    ("under-an-if",
     "__kernel void k(__global float* x, __global float* o, int n) { int i = get_global_id(0);"
     " float s = 0.0f; if (n > 2) { for (int j = 0; j < n; j++) { s += x[j]; } } o[i] = s; }",
     "no for loop at the top of the kernel body"),
    ("step-two",
     "__kernel void k(__global float* x, __global float* o, int n) { int i = get_global_id(0);"
     " float s = 0.0f; for (int j = 0; j < n; j += 2) { s += x[j]; } o[i] = s; }",
     "the loop's step is not j++"),
    ("less-equal",
     "__kernel void k(__global float* x, __global float* o, int n) { int i = get_global_id(0);"
     " float s = 0.0f; for (int j = 0; j <= n; j++) { s += x[j]; } o[i] = s; }",
     "the loop's condition is not j < bound"),
    ("counter-outside",
     "__kernel void k(__global float* x, __global float* o, int n) { int i = get_global_id(0);"
     " float s = 0.0f; int j = 0; for (j = 0; j < n; j++) { s += x[j]; } o[i] = s; }",
     "does not declare one int counter"),
    ("bound-moves",
     "__kernel void k(__global float* x, __global float* o, int n) { int i = get_global_id(0);"
     " float s = 0.0f; int m = n; for (int j = 0; j < m; j++) { s += x[j]; m = m - 1; }"
     " o[i] = s; }",
     "which its bound reads"),
    ("long-bound",
     "__kernel void k(__global float* x, __global float* o, long n) { int i = get_global_id(0);"
     " float s = 0.0f; for (int j = 0; j < n; j++) { s += x[j]; } o[i] = s; }",
     "not an int comparison"),
    ("no-staged-read",
     "__kernel void k(__global float* x, __global float* o, int n) { int i = get_global_id(0);"
     " float s = 0.0f; for (int j = 0; j < n; j++) { s += x[2 * j] + x[i]; } o[i] = s; }",
     "read at buf[j + c] in the loop"),
]


@pytest.mark.parametrize("src,why", [r[1:] for r in REFUSALS], ids=[r[0] for r in REFUSALS])
def test_refusals_are_named(src, why):
    kdef = _kdef(src)
    assert cuda_backend.unsupported_reason(kdef) is None
    reason = cuda_backend.loop_reason(kdef)
    assert reason is not None and why in reason, reason
    assert "ck_kernel_loop" not in cuda_backend.emit_source(kdef)
    assert "ck_kernel_loop" not in cuda_backend.emit_source(kdef, target="host")


def test_a_staged_array_that_is_also_stored_stays_off_the_card():
    """An array stored at buf[gid] and read at buf[j]: other threads'
    stores are unordered, so the emitter refuses the kernel whole (the
    torch lowering runs it) and no form stages it."""
    kdef = _kdef("__kernel void k(__global float* x, int n) { int i = get_global_id(0);"
                 " float s = 0.0f; for (int j = 0; j < n; j++) { s += x[j]; } x[i] = s; }")
    assert "stored and read away from buf[gid]" in cuda_backend.unsupported_reason(kdef)
    with pytest.raises(cuda_backend.CudaUnsupported):
        cuda_backend.loop_reason(kdef)


def test_too_many_staged_reads_for_shared_memory_are_refused():
    reads = " + ".join(f"x[j + {c}]" for c in range(400))
    kdef = _kdef("__kernel void k(__global double* x, __global double* o, int n) {"
                 " int i = get_global_id(0); double s = 0.0;"
                 f" for (int j = 0; j < n; j++) {{ s = s + {reads}; }} o[i] = s; }}")
    assert "shared memory" in cuda_backend.loop_reason(kdef)


@pytest.mark.parametrize("chunk,sms,want", [(8192, 132, 32), (8191, 132, 32), (1 << 20, 132, 256),
                                            (132 * 64, 132, 64), (131 * 64, 132, 32),
                                            (96, 4, 32), (1000, 4, 256), (1, 132, 32)])
def test_cta_width_covers_the_sms(chunk, sms, want):
    assert cuda_backend.loop_threads(chunk, sms) == want


# ---------------------------------------------------------------------------
# the uniformity analysis against the reference's
# ---------------------------------------------------------------------------

def test_uniform_vars_match_the_reference_on_every_source():
    compared = 0
    for key, src in _harvested_sources():
        try:
            mine, ref = lang.parse_kernels(src), ref_lang.parse_kernels(src)
        except Exception:  # noqa: BLE001 - not a kernel source for the parsers
            continue
        for k, rk in zip(mine, ref):
            values = {p.name for p in k.params if not p.is_pointer}
            assert uniform.uniform_vars(k.body, values) == ref_codegen._uniform_vars(
                rk.body, values), f"{key}:{k.name}"
            compared += 1
    assert compared > 100


# ---------------------------------------------------------------------------
# the host build against the torch lowering and the item form
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def host():
    """``{(source, loop): (kernel, ck_launch, ck_form)}`` of host builds,
    each built once, all in parallel."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the emitted body cannot be compiled on the host")
    sources = [(src, name) for src, name in
               [(s, None) for s in LOOP_KERNELS.values()] + [(s, n) for _, s, n in LOOP_CORPUS]]

    def one(item):
        (src, name), loop = item
        ks = lang.parse_kernels(src)
        kdef = ks[-1] if name is None else next(k for k in ks if k.name == name)
        ck = cuda_backend._CudaKernel(kdef, loop=loop)
        return (src, name, loop), (ck, *ck.entry(tuple(p.ctype for p in ck.arrays), "host"))

    items = [(s, loop) for s in dict.fromkeys(sources) for loop in (True, False)]
    with ThreadPoolExecutor(max_workers=4) as pool:
        return dict(pool.map(one, items))


def _inputs(kdef, n: int, seed: int, special: bool = False) -> tuple[list, tuple]:
    rng = np.random.default_rng(seed)
    arrays, values = [], []
    for p in kdef.params:
        if p.is_pointer:
            dt = NP[p.ctype]
            if np.issubdtype(dt, np.floating):
                a = ((rng.random(n) - 0.5) * 2.0).astype(dt)
                if special:  # the slow paths: overflow, inf, nan, tiny, a coincident body
                    a[[5 % n, 17 % n, 40 % n, 77 % n]] = [1e30, np.inf, np.nan, 1e-30]
                    a[200 % n] = a[201 % n]
                arrays.append(a)
            else:
                arrays.append(rng.integers(0, 8, n).astype(dt))
        else:
            values.append(0.001 if p.ctype in ("float", "double") else n)
    return arrays, tuple(values)


def _run(host, key, arrays, values, offset, chunk):
    ck, launch, form = host[key]
    got = tuple(torch.from_numpy(a.copy()) for a in arrays)
    gsize = max(a.size for a in arrays)
    assert launch(*ck.args(got, values, offset, chunk, gsize, 16), None) == 0
    return got, form()


def _bits(ts) -> list[np.ndarray]:
    """Each array's bits, every NaN made the one quiet NaN (the torch
    lowering and the C build may give a NaN other sign bits)."""
    out = []
    for t in ts:
        a = t.numpy()
        if a.dtype.kind == "f":
            a = np.where(np.isnan(a), np.array(np.nan, a.dtype), a)
        out.append(a.view(f"u{a.itemsize}"))
    return out


CASES = ([(name, src, None) for name, src in LOOP_KERNELS.items()]
         + [(key, src, name) for key, src, name in LOOP_CORPUS])


@pytest.mark.parametrize("n", [256, 255, 1000])
@pytest.mark.parametrize("name,src,kname", CASES, ids=[c[0] for c in CASES])
def test_host_loop_form_matches_the_torch_lowering(host, name, src, kname, n):
    """At n off the tile, over the whole range and at a chunk of 96 from
    offset 64, and with the loop's bound past the arrays' ends (every
    value parameter n + 45: the staged reads clamp): the loop form's bits
    are the torch lowering's and the item form's."""
    ks = lang.parse_kernels(src)
    kdef = ks[-1] if kname is None else next(k for k in ks if k.name == kname)
    arrays, values = _inputs(kdef, n, n)
    longer = tuple(v + 45 if isinstance(v, int) else v for v in values)
    for vals in (values, longer):
        for chunk, offset in ((n, 0), (96, 64)):
            plain = tuple(torch.from_numpy(a.copy()) for a in arrays)
            codegen.build_kernel_fn(kdef, chunk, 16, n)[0](offset, plain, vals)
            got, form = _run(host, (src, kname, True), arrays, vals, offset, chunk)
            item, item_form = _run(host, (src, kname, False), arrays, vals, offset, chunk)
            assert (form, item_form) == (2, 0)
            for i, (p, g, t) in enumerate(zip(_bits(plain), _bits(got), _bits(item))):
                np.testing.assert_array_equal(g, p, err_msg=f"{name} array {i} {chunk}@{offset}")
                np.testing.assert_array_equal(g, t, err_msg=f"{name} array {i} vs item form")


@pytest.mark.parametrize("name", ["nBody", "gr"])
def test_host_groups_run_again_where_an_input_needs_the_slow_path(host, name):
    """Positions at 1e30 (r2 overflows to inf), inf, nan and 1e-30, and
    two coincident bodies: groups holding them run again with the IEEE
    functions, and every bit still equals the torch lowering's."""
    src = LOOP_KERNELS[name]
    kdef = _kdef(src)
    n = 300
    arrays, values = _inputs(kdef, n, 7, special=True)
    plain = tuple(torch.from_numpy(a.copy()) for a in arrays)
    codegen.build_kernel_fn(kdef, n, 16, n)[0](0, plain, values)
    got, form = _run(host, (src, None, True), arrays, values, 0, n)
    assert form == 2
    for i, (p, g) in enumerate(zip(plain, got)):
        np.testing.assert_array_equal(g.numpy(), p.numpy(), err_msg=f"array {i}")


def test_an_empty_and_a_negative_trip_count(host):
    kdef = _kdef(workloads.NBODY_SRC)
    arrays, _ = _inputs(kdef, 100, 3)
    for n_value in (0, -5):
        plain = tuple(torch.from_numpy(a.copy()) for a in arrays)
        codegen.build_kernel_fn(kdef, 100, 16, 100)[0](0, plain, (n_value, 0.5))
        got, form = _run(host, (workloads.NBODY_SRC, None, True), arrays, (n_value, 0.5), 0, 100)
        assert form == 2
        for p, g in zip(plain, got):
            assert torch.equal(p, g)


# ---------------------------------------------------------------------------
# the launch wrapper
# ---------------------------------------------------------------------------

def test_the_form_code_names_the_loop_form():
    """``ck_form()`` is 2 after a loop-form launch, which the wrapper counts
    in ``FORMS`` as ``(name, "loop")``."""
    assert cuda_backend._FORM_NAMES[:3] == ("item", "stream", "loop")


def test_cpu_tensors_run_the_plain_version_and_count_no_launch():
    kdef = _kdef(workloads.NBODY_SRC)
    fn, _ = cuda_backend.build_kernel_fn_cuda(kdef, 64, 16, 64)
    arrays, values = _inputs(kdef, 64, 11)
    got = tuple(torch.from_numpy(a.copy()) for a in arrays)
    plain = tuple(torch.from_numpy(a.copy()) for a in arrays)
    launches, forms = cuda_backend.LAUNCHES.count, dict(cuda_backend.FORMS.by_key)
    fn(0, got, values)
    codegen.build_kernel_fn(kdef, 64, 16, 64)[0](0, plain, values)
    assert all(torch.equal(a, b) for a, b in zip(got, plain))
    assert cuda_backend.LAUNCHES.count == launches
    assert dict(cuda_backend.FORMS.by_key) == forms


def test_a_host_launch_past_the_chunk_stores_nothing(host):
    """Threads past the chunk in the last CTA run the chunk's last item and
    store nothing: the items after the chunk keep their values."""
    kdef = _kdef(workloads.NBODY_SRC)
    arrays, values = _inputs(kdef, 256, 5)
    got, _ = _run(host, (workloads.NBODY_SRC, None, True), arrays, values, 100, 37)
    for before, after in zip(arrays[3:], got[3:]):
        np.testing.assert_array_equal(after.numpy()[:100], before[:100])
        np.testing.assert_array_equal(after.numpy()[137:], before[137:])
        assert not np.array_equal(after.numpy()[100:137], before[100:137])


def test_a_refused_loop_form_build_raises_named_error(monkeypatch):
    """With no nvcc the loop form's build raises, naming the compiler; no
    other form is tried."""
    from cekirdekler_tpu_torch.kernel import build

    monkeypatch.setattr(build, "nvcc_path", lambda: None)
    ck = cuda_backend._CudaKernel(_kdef(workloads.NBODY_SRC))
    with pytest.raises(KernelCompileError, match="nvcc not found"):
        ck.entry(tuple(p.ctype for p in ck.arrays))
