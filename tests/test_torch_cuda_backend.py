"""The kernel-language -> CUDA C++ emitter, checked without a card.

``cekirdekler_tpu_torch/kernel/cuda_backend.py`` writes one thread per
work item.  Here: its subset decisions on the partition-safety corpus;
the emitted body compiled by ``g++ -ffp-contract=off`` under the host
prelude (the thread index serialised in a loop) and held against the
torch lowering — exact, and within 2 ulp for kernels that call
transcendentals (glibc's libm against ATen's); the nvcc build refusing
loudly where there is no CUDA toolkit; and the registry's static routing.
"""

from __future__ import annotations

import shutil
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from cekirdekler_tpu_torch import workloads
from cekirdekler_tpu_torch.errors import KernelCompileError
from cekirdekler_tpu_torch.kernel import build, codegen, cuda_backend, lang
from cekirdekler_tpu_torch.kernel.registry import KernelProgram, kernel, launch_counts
from tests import kernel_corpus
from tests.test_torch_codegen import INT_TYPES, _gen_kernel, make_inputs, max_ulp

N = 256

#: corpus kernels outside the emitter's subset: each stores away from buf[gid]
OFF_SUBSET = {"e2", "sw", "shw", "uw"}

CORPUS_KERNELS = [(e, k) for e in kernel_corpus.CORPUS for k in lang.parse_kernels(e.source)]


@pytest.mark.parametrize("entry,kdef", CORPUS_KERNELS,
                         ids=[f"{e.name}:{k.name}" for e, k in CORPUS_KERNELS])
def test_subset_decision_on_corpus(entry, kdef):
    reason = cuda_backend.unsupported_reason(kdef)
    if kdef.name in OFF_SUBSET:
        assert reason is not None and "not at buf[gid]" in reason
    else:
        assert reason is None


@pytest.mark.parametrize("src,why", [
    ("__kernel void k(__global half* a) { int i = get_global_id(0); a[i] = a[i] * 2.0f; }",
     "half"),
    ("__kernel void k(__global float* p) { int i = get_global_id(0); p[i] = p[i+1] * 2.0f; }",
     "read away from buf[gid]"),
    ("__kernel void k(__global float* p, int n) { int i = get_global_id(0);"
     " float s = 0.0f; for (int j = 0; j < n; j++) { s += p[j]; } p[i] = s; }",
     "read away from buf[gid]"),
    ("__kernel void k(__global float* p) { int i = get_global_id(0); p[2*i] = 1.0f; }",
     "not at buf[gid]"),
], ids=["half", "stored-and-shifted", "stored-and-gathered", "strided-store"])
def test_off_subset_kernels_are_named(src, why):
    reason = cuda_backend.unsupported_reason(lang.parse_kernels(src)[0])
    assert reason is not None and why in reason
    with pytest.raises(cuda_backend.CudaUnsupported):
        cuda_backend.build_kernel_fn_cuda(lang.parse_kernels(src)[0], 64, 16, 64)


def test_workload_kernels_are_in_subset():
    for src in (workloads.MANDELBROT_SRC, workloads.NBODY_SRC, workloads.STREAM_SRC):
        kdef = lang.parse_kernels(src)[0]
        assert cuda_backend.unsupported_reason(kdef) is None, kdef.name


def test_emitted_cuda_source_shape():
    kdef = lang.parse_kernels(workloads.NBODY_SRC)[0]
    src = cuda_backend.emit_source(kdef, loop=False)  # n-body's item form
    assert 'extern "C" __global__ void __launch_bounds__(256) ck_kernel(' in src
    assert 'extern "C" int ck_launch(' in src
    assert "return (int)cudaGetLastError();" in src
    assert "if (t >= ck_chunk) return;" in src
    # exact hexadecimal literals: 0.0001f must not be re-rounded by a printer
    assert "0x1.a36e2e0000000p-14f" in src
    assert "sqrtf(" in src and "ck_ld(b_x, v_j, n_x)" in src
    host = cuda_backend.emit_source(kdef, target="host", loop=False)
    assert "__global__" not in host and "for (int t = 0; t < ck_chunk; ++t)" in host
    # the loop form it takes by default reads x[j] from the staged tile
    looped = cuda_backend.emit_source(kdef)
    assert "ck_kernel_loop(" in looped and "ck_s.s0" in looped
    assert "ck_ld(b_x, v_j, n_x)" not in looped


def test_nvcc_flags_keep_products_unfused():
    assert "-fmad=false" in build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    assert not any("fast_math" in f or "fast-math" in f for f in build.NVCC_FLAGS)
    assert "-ffp-contract=off" in build.HOST_FLAGS


def test_build_without_nvcc_raises_named_error(monkeypatch):
    monkeypatch.setattr(build, "nvcc_path", lambda: None)
    with pytest.raises(KernelCompileError, match="nvcc not found"):
        build.build_library("extern \"C\" int f() { return 0; }", "probe")


def test_wrapper_raises_on_a_device_it_cannot_launch_on():
    kdef = lang.parse_kernels(workloads.STREAM_SRC)[0]
    fn, _ = cuda_backend.build_kernel_fn_cuda(kdef, 64, 16, 64)
    meta = tuple(torch.empty(64, device="meta") for _ in range(3))
    with pytest.raises(KernelCompileError, match="unsupported device"):
        fn(0, meta, ())
    with pytest.raises(KernelCompileError, match="contiguous 1-D"):
        fn(0, tuple(torch.zeros(8, 8) for _ in range(3)), ())
    before = cuda_backend.LAUNCHES.count
    cpu = tuple(torch.ones(64) for _ in range(3))
    fn(0, cpu, ())
    assert torch.equal(cpu[2], torch.full((64,), 2.0))
    assert cuda_backend.LAUNCHES.count == before  # the plain version ran


@pytest.mark.parametrize("dtype,taken", [
    (torch.float32, True), (torch.float64, True), (torch.int32, True),
    (torch.int64, True), (torch.uint8, True), (torch.bool, True),
    (torch.float16, False), (torch.bfloat16, False)])
def test_storage_check_sends_half_and_bfloat16_to_the_lowering(dtype, taken):
    """The per-launch storage check the registry routes by: float16 and
    bfloat16 buffers have no CUDA C storage type in the emitter."""
    arrays = (torch.zeros(8), torch.zeros(8, dtype=dtype))
    assert cuda_backend.takes_storage(arrays) is taken
    ck = cuda_backend._CudaKernel(lang.parse_kernels(
        "__kernel void k(__global float* a, __global float* b)"
        " { int i = get_global_id(0); b[i] = a[i]; }")[0])
    if taken:
        assert ck.storage_of(arrays)[0] == "float"
    else:
        with pytest.raises(KernelCompileError, match="no CUDA C storage type"):
            ck.storage_of(arrays)


# ---------------------------------------------------------------------------
# the emitted body, compiled for the host
# ---------------------------------------------------------------------------

def _int_src(ctype: str) -> str:
    return f"""
    __kernel void ints(__global {ctype}* a, __global {ctype}* b, __global {ctype}* c,
                       __global int* q, __global long* w, int sh) {{
        int i = get_global_id(0);
        {ctype} x = a[i];
        {ctype} y = b[i];
        c[i] = x * y - y + (x << sh) - (y >> 1) + (x ^ y) + (x & 7) + (y | 2);
        q[i] = (int)(x / y) + (int)(x % y) * 100 + (int)(~x) + get_local_id(0) * 3
               + get_group_id(0);
        w[i] = (long)x * (long)y - (long)(x / (y - y)) + (long)(x % (y - y));
    }}"""


HOST_CASES = (
    [(f"corpus:{e.name}:{k.name}", e.source, k.name, False)
     for e, k in CORPUS_KERNELS if k.name not in OFF_SUBSET]
    + [(f"workload:{n}", getattr(workloads, n), None, False)
       for n in ("MANDELBROT_SRC", "NBODY_SRC", "STREAM_SRC")]
    + [(f"ints:{t}", _int_src(t), None, False) for t in INT_TYPES]
    + [(f"random:{s}", _gen_kernel(s), None, True) for s in range(4)]
    + [("narrowing-cast", "__kernel void k(__global float* x, __global float* o) {"
        " int i = get_global_id(0); o[i] = x[(char)i] + x[(short)(i * 300)]; }", None, False)]
)


def _kdef(src, name):
    ks = lang.parse_kernels(src)
    return ks[0] if name is None else next(k for k in ks if k.name == name)


@pytest.fixture(scope="module")
def host_builds():
    """Every host case emitted and compiled once, in parallel."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the emitted body cannot be compiled on the host")

    def one(case):
        key, src, name, _ = case
        ck = cuda_backend._CudaKernel(_kdef(src, name))
        storage = tuple(p.ctype for p in ck.arrays)
        return key, (ck, ck.library(storage, target="host"))

    with ThreadPoolExecutor(max_workers=4) as pool:
        return dict(pool.map(one, HOST_CASES))


def _inputs(kdef, key):
    arrays, values = make_inputs(kdef, zlib.crc32(key.encode()), N)
    if key == "workload:MANDELBROT_SRC":
        values = (-2.0, -1.25, 2.5 / 16, 2.5 / 16, 16, 64)
    elif key == "workload:NBODY_SRC":
        values = (N, 0.001)
    elif key.startswith("ints:"):
        dt = arrays[0].dtype
        rng = np.random.default_rng(zlib.crc32(key.encode()))
        info = np.iinfo(dt)
        for a in arrays[:2]:
            a[:] = rng.integers(max(info.min, -2000), min(info.max, 2000), N, endpoint=True)
        arrays[1][::5] = 0
        arrays[0][100:102] = info.max
        arrays[0][102:104] = info.min
        values = (3,)
    return arrays, values


@pytest.mark.parametrize("case", HOST_CASES, ids=[c[0] for c in HOST_CASES])
def test_host_build_matches_torch_lowering(case, host_builds):
    key, src, name, rounding = case
    kdef = _kdef(src, name)
    ck, launch = host_builds[key]
    arrays, values = _inputs(kdef, key)
    for chunk, offset in ((N, 0), (96, 64)):
        plain = tuple(torch.from_numpy(a.copy()) for a in arrays)
        fn, _ = codegen.build_kernel_fn(kdef, chunk, 16, N)
        fn(offset, plain, values)
        host = tuple(torch.from_numpy(a.copy()) for a in arrays)
        rc = launch(*ck.args(host, values, offset, chunk, N, 16), None)
        assert rc == 0
        for i, (p, h) in enumerate(zip(plain, host)):
            p, h = p.numpy(), h.numpy()
            if rounding and p.dtype.kind == "f":
                assert max_ulp(h, p) <= 2.0, f"{key} array {i}: {max_ulp(h, p)} ulp"
            else:
                np.testing.assert_array_equal(h, p, err_msg=f"{key} array {i} {chunk}@{offset}")


# ---------------------------------------------------------------------------
# the registry's static routing
# ---------------------------------------------------------------------------

def test_registry_routes_statically_and_counts_launches():
    @kernel
    def twice(gid, a):
        a[gid.start:gid.stop] *= 2.0
        return (a,)

    src = (workloads.STREAM_SRC
           + "__kernel void strided(__global float* p) "
             "{ int i = get_global_id(0); p[2*i] = 1.0f; }")
    prog = KernelProgram([src, twice])
    assert prog.route("streamAdd") == "cuda"
    assert prog.route("strided") == "torch"
    assert prog.route("twice") == "python"
    with pytest.raises(KernelCompileError, match="not found"):
        prog.route("missing")
    before = dict(launch_counts)
    a, b, c = torch.ones(64), torch.full((64,), 2.0), torch.zeros(64)
    fn, _ = prog.launcher("streamAdd", 64, 16, 64, platform="cpu")
    fn(0, (a, b, c), ())
    fn2, _ = prog.launcher("strided", 32, 16, 32, platform="cpu")
    fn2(0, (c,), ())
    fn3, _ = prog.launcher("twice", 64, 16, 64, platform="cpu")
    fn3(0, (a,), ())
    assert torch.equal(a, torch.full((64,), 2.0))
    # a cuda-route kernel on a host lane runs its plain version: the torch lowering
    assert launch_counts["torch"] - before["torch"] == 2
    assert launch_counts["python"] - before["python"] == 1
    assert launch_counts["cuda"] == before["cuda"]
    assert prog.launcher("streamAdd", 64, 16, 64, platform="cpu")[0] is fn
    assert prog.compiled_count == 3
