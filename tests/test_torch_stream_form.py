"""The emitter's streaming form, checked without a card.

A kernel whose every access is at ``buf[gid]`` and whose body has no loop
takes a second form (``kernel/cuda_backend.py``): a thread owns CK_V
consecutive items per vector, loads each array's vector whole, runs the
body per item from registers and stores each stored vector whole; the
items at a chunk's head and tail that make no whole aligned vector run the
one-thread-per-item body.  The launch takes it only where every touched
buffer is aligned and no two overlap (the same buffer twice is allowed
when neither is stored).

The host build (g++) emits the same form, with the grid's threads run one
after another, and is held here against the torch lowering
(``codegen.build_kernel_fn``) bit for bit; ``ck_form()`` says which form
the launch took.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from cekirdekler_tpu_torch import workloads
from cekirdekler_tpu_torch.kernel import codegen, cuda_backend, lang

ROOT = Path(__file__).resolve().parents[1]

SAXPY_SRC = """
__kernel void saxpy(__global float* x, __global float* y, float a) {
    int i = get_global_id(0);
    y[i] = a * x[i] + y[i];
}"""
VADD_SRC = """
__kernel void vadd(__global float* a, __global float* b, __global float* c) {
    int i = get_global_id(0);
    c[i] = a[i] + b[i];
}"""
TWICE_SRC = """
__kernel void twice(__global float* a) {
    int i = get_global_id(0);
    a[i] = a[i] * 2.0f;
}"""
COND_SRC = """
__kernel void cond(__global float* a, __global float* b) {
    int i = get_global_id(0);
    if (a[i] > 0.25f) {
        b[i] = a[i] * 3.0f;
    }
}"""
EARLY_SRC = """
__kernel void early(__global float* a, __global float* b) {
    int i = get_global_id(0);
    if (a[i] < -1.0f) return;
    b[i] = a[i] - 1.0f;
}"""
GID_SRC = """
__kernel void gidv(__global float* a, __global int* q) {
    int i = get_global_id(0);
    a[i] = a[i] + (float)i * 0.5f + (float)get_local_id(0) + (float)get_global_size(0);
    q[i] = i * 7 - get_group_id(0) + get_local_size(0);
}"""
MIXED_SRC = """
__kernel void mixed(__global char* c, __global int* k, __global float* f, __global double* d) {
    int i = get_global_id(0);
    d[i] = d[i] * 0.5 + f[i];
    f[i] = (float)k[i] + c[i];
    k[i] = k[i] * 3 + c[i];
}"""
NP = {"char": np.int8, "int": np.int32, "float": np.float32, "double": np.float64}


def _kdef(src: str):
    return lang.parse_kernels(src)[0]


@pytest.fixture(scope="module")
def host():
    """``(kernel, ck_launch, ck_form)`` of one kernel's host build, built once."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the emitted body cannot be compiled on the host")
    cache = {}

    def get(src: str):
        if src not in cache:
            ck = cuda_backend._CudaKernel(_kdef(src))
            cache[src] = (ck, *ck.entry(tuple(p.ctype for p in ck.arrays), target="host"))
        return cache[src]

    return get


def _arrays(kdef, lengths, seed: int, pad: int = 0) -> list[torch.Tensor]:
    """One tensor per array parameter, ``pad`` elements into a larger one
    (a view whose data_ptr is off by ``pad`` elements)."""
    rng = np.random.default_rng(seed)
    out = []
    for p, n in zip([p for p in kdef.params if p.is_pointer], lengths):
        dt = NP[p.ctype]
        raw = (rng.uniform(-2.0, 2.0, n + pad) if np.issubdtype(dt, np.floating)
               else rng.integers(-50, 50, n + pad))
        out.append(torch.from_numpy(raw.astype(dt))[pad:])
    return out


def _run_both(host, src, make, values, offset, chunk, local=16):
    """The torch lowering and the host build, each on the arrays a call of
    ``make()`` returns (fresh, with the same layout); returns (plain
    results, host results, form the host launch took)."""
    ck, launch, form = host(src)
    plain, got = tuple(make()), tuple(make())
    gsize = max(a.numel() for a in plain)
    fn, _ = codegen.build_kernel_fn(ck.kernel, chunk, local, gsize)
    fn(offset, plain, values)
    assert launch(*ck.args(got, values, offset, chunk, gsize, local), None) == 0
    return plain, got, form()


def _assert_equal(plain, got):
    for i, (p, g) in enumerate(zip(plain, got)):
        np.testing.assert_array_equal(g.numpy(), p.numpy(), err_msg=f"array {i}")


# ---------------------------------------------------------------------------
# which kernels take the streaming form
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("src", [workloads.STREAM_SRC, SAXPY_SRC, VADD_SRC, TWICE_SRC,
                                 COND_SRC, EARLY_SRC, GID_SRC, MIXED_SRC],
                         ids=["streamAdd", "saxpy", "vadd", "in-place", "conditional",
                              "early-return", "gid-value", "mixed"])
def test_streaming_kernels_take_the_form(src):
    kdef = _kdef(src)
    assert cuda_backend.unsupported_reason(kdef) is None
    assert cuda_backend.stream_reason(kdef) is None
    cuda = cuda_backend.emit_source(kdef)
    assert "ck_kernel_stream(" in cuda and "__restrict__" in cuda
    assert 'extern "C" __global__ void __launch_bounds__(256) ck_kernel(' in cuda


@pytest.mark.parametrize("src,why", [
    (workloads.MANDELBROT_SRC, "a loop"),
    (workloads.NBODY_SRC, "a loop"),
    ("__kernel void sh(__global float* a, __global float* b) {"
     " int i = get_global_id(0); b[i] = a[i + 1] - a[i]; }", "load(s) of ['a'] away from buf[gid]"),
    ("__kernel void g(__global float* a, __global float* b) {"
     " int i = get_global_id(0); b[i] = a[0] * b[i]; }", "load(s) of ['a'] away from buf[gid]"),
    ("float h(float x) { float s = 0.0f; for (int j = 0; j < 3; j++) { s += x; } return s; }"
     " __kernel void k(__global float* a) { int i = get_global_id(0); a[i] = h(a[i]); }",
     "a loop"),
    ("__kernel void z(__global float* a, int n) { int i = get_global_id(0); int m = n + i; }",
     "no array is read or written"),
], ids=["mandelbrot", "nBody", "shifted", "gathered", "loop-in-helper", "no-access"])
def test_item_form_kernels_are_named(src, why):
    kdef = lang.parse_kernels(src)[-1]
    assert cuda_backend.unsupported_reason(kdef) is None
    reason = cuda_backend.stream_reason(kdef)
    assert reason is not None and why in reason
    assert "ck_kernel_stream" not in cuda_backend.emit_source(kdef)
    assert "ck_kernel_stream" not in cuda_backend.emit_source(kdef, target="host")


@pytest.mark.parametrize("src,vec", [(workloads.STREAM_SRC, 4), (MIXED_SRC, 2),
                                     ("__kernel void c8(__global char* a) {"
                                      " int i = get_global_id(0); a[i] = a[i] + 1; }", 16)],
                         ids=["float", "mixed", "char"])
def test_vector_width_follows_the_widest_array(src, vec):
    assert f"#define CK_V {vec}\n" in cuda_backend.emit_source(_kdef(src))


def test_write_only_arrays_are_not_loaded_first():
    """streamAdd's c is stored on every path: its old values are not read;
    a conditional store reads the old values first, so an item the body
    does not store keeps them."""
    src = cuda_backend.emit_source(_kdef(workloads.STREAM_SRC))
    assert "x_a[u] = ck_vld(b_a + g);" in src and "x_c[u] = ck_vld" not in src
    for cond in (COND_SRC, EARLY_SRC):
        assert "x_b[u] = ck_vld(b_b + g);" in cuda_backend.emit_source(_kdef(cond))


# ---------------------------------------------------------------------------
# the host build against the torch lowering
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("offset,chunk", [(3, 990), (5, 701), (1, 6), (0, 1000), (996, 4)])
@pytest.mark.parametrize("src,values", [(workloads.STREAM_SRC, ()), (SAXPY_SRC, (1.5,))],
                         ids=["streamAdd", "saxpy"])
def test_offsets_and_chunks_off_the_vector(host, src, values, offset, chunk):
    kdef = _kdef(src)
    plain, got, form = _run_both(host, src, lambda: _arrays(kdef, [1000] * 3, offset), values,
                                 offset, chunk)
    _assert_equal(plain, got)
    assert form == 1


def test_buffers_shorter_than_the_range(host):
    """Loads past a buffer's end clamp to its last element, stores there
    are dropped: the vectors stop at the shortest buffer."""
    kdef = _kdef(VADD_SRC)
    plain, got, form = _run_both(host, VADD_SRC, lambda: _arrays(kdef, [1000, 301, 650], 1),
                                 (), 0, 1000)
    _assert_equal(plain, got)
    assert form == 1


def test_a_view_off_by_one_element_takes_the_item_form(host):
    kdef = _kdef(SAXPY_SRC)
    assert _arrays(kdef, [1000, 1000], 2, pad=1)[0].data_ptr() % 16 != 0
    plain, got, form = _run_both(host, SAXPY_SRC, lambda: _arrays(kdef, [1000, 1000], 2, pad=1),
                                 (0.75,), 2, 990)
    _assert_equal(plain, got)
    assert form == 0


@pytest.mark.parametrize("src,values", [(TWICE_SRC, ()), (COND_SRC, ()), (EARLY_SRC, ()),
                                        (GID_SRC, ()), (MIXED_SRC, ())],
                         ids=["in-place", "conditional", "early-return", "gid-value", "mixed"])
@pytest.mark.parametrize("offset,chunk", [(0, 512), (7, 437)])
def test_kernel_shapes_match_the_lowering(host, src, values, offset, chunk):
    kdef = _kdef(src)
    n_arrays = sum(p.is_pointer for p in kdef.params)
    plain, got, form = _run_both(host, src, lambda: _arrays(kdef, [512] * n_arrays, len(src)),
                                 values, offset, chunk, local=32)
    _assert_equal(plain, got)
    assert form == 1


def test_overlap_decides_the_form_at_launch(host):
    """Two read-only views of one buffer that partly overlap take the item
    form; the same read-only buffer twice, or disjoint parts of one
    buffer, take the streaming form; the same buffer read and stored
    under two names takes the item form."""
    buf = torch.from_numpy(np.random.default_rng(3).uniform(-1, 1, 2048).astype(np.float32))
    views = {"partial": (slice(0, 1000), slice(4, 1004)), "same": (slice(0, 1000),) * 2,
             "disjoint": (slice(0, 1000), slice(1024, 2024))}
    for name, want in (("partial", 0), ("same", 1), ("disjoint", 1)):
        def make(name=name):
            b = buf.clone()
            return [b[views[name][0]], b[views[name][1]], torch.zeros(1000)]

        plain, got, form = _run_both(host, VADD_SRC, make, (), 0, 1000)
        _assert_equal(plain, got)
        assert form == want, name
    a = buf[:1000].clone()
    ck, launch, form = host(VADD_SRC)
    assert launch(*ck.args((a, torch.ones(1000), a), (), 0, 1000, 1000, 16), None) == 0
    assert form() == 0
    np.testing.assert_array_equal(a.numpy(), buf[:1000].numpy() + 1.0)


@pytest.mark.parametrize("tool", ["time_stream", "sweep_stream"])
def test_timing_tools_refuse_without_a_card(tool):
    """``tools/time_stream.py`` and ``tools/sweep_stream.py`` exit non-zero
    and print no result where no CUDA device is visible."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run([sys.executable, f"cekirdekler_tpu_torch/tools/{tool}.py"],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "no CUDA device" in proc.stderr


@pytest.mark.parametrize("unroll", [2, 4])
@pytest.mark.parametrize("src", [workloads.STREAM_SRC, MIXED_SRC], ids=["float", "mixed"])
def test_unrolled_host_variants_match_the_lowering(src, unroll):
    """The shipped form loads one vector a step; the sweep's variants load
    2 or 4 before they compute.  Their host builds hold the unrolled
    loop's index arithmetic against the lowering too."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the emitted body cannot be compiled on the host")
    import ctypes

    from cekirdekler_tpu_torch.kernel import build
    from cekirdekler_tpu_torch.tools import sweep_stream

    kdef = _kdef(src)
    ck = cuda_backend._CudaKernel(kdef)
    host_src = cuda_backend.emit_source(kdef, target="host")
    lib = build.build_library(sweep_stream.emitter_variant(host_src, unroll, 512, False),
                              f"ck_{kdef.name}", compiler="g++")
    launch, form = lib.ck_launch, lib.ck_form
    launch.restype = form.restype = ctypes.c_int
    launch.argtypes = ([t for _ in ck.arrays for t in (ctypes.c_void_p, ctypes.c_longlong)]
                       + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    n_arrays = len(ck.arrays)
    for offset, chunk in ((0, 1000), (3, 990), (7, 101)):
        plain, got = (_arrays(kdef, [1000] * n_arrays, offset) for _ in range(2))
        fn, _ = codegen.build_kernel_fn(kdef, chunk, 16, 1000)
        fn(offset, tuple(plain), ())
        assert launch(*ck.args(got, (), offset, chunk, 1000, 16), None) == 0
        assert form() == 1
        _assert_equal(plain, got)


@pytest.mark.parametrize("resident", [False, True], ids=["one-step", "resident"])
def test_sweep_edits_apply_to_the_shipped_sources(resident):
    """The sweep's variants are edits of the sources as shipped: the shape
    constants are where the tool looks for them."""
    from cekirdekler_tpu_torch.ops import elementwise as ew
    from cekirdekler_tpu_torch.tools import sweep_stream

    src = sweep_stream.emitter_variant(cuda_backend.emit_source(_kdef(workloads.STREAM_SRC)),
                                       2, 256, resident)
    assert "#define CK_U 2\n" in src and "#define CK_T 256\n" in src
    assert ("cudaOccupancyMaxActiveBlocksPerMultiprocessor" in src) is resident
    src = sweep_stream.elementwise_variant(ew.kernel_source(torch.maximum, (torch.float32,) * 2),
                                           4, 256, resident)
    assert "#define CK_U 4 " in src and "#define CK_THREADS 256\n" in src
    assert ("cudaOccupancyMaxActiveBlocksPerMultiprocessor" in src) is resident
