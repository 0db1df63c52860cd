"""The port's elementwise op against the JAX package's, on the CPU.

``cekirdekler_tpu_torch/ops/elementwise.py`` (``map_blocks``, ``saxpy``)
against ``cekirdekler_tpu/ops/elementwise.py`` run in Pallas interpret
mode, on the same numpy-seeded inputs.  On the CPU the port runs its plain
version, ``fn`` on the tensors; the kernel's emitted source, compiled by
g++ for the host, is held against that plain version bit for bit.

Tolerances: ``saxpy`` within rtol 1e-5 on random inputs (within 1e-5 of
``|y| + |a*x|`` where the sum cancels), because XLA:CPU contracts
``y + a*x`` into an FMA (ROADMAP Queue C 4), and bit-exact on inputs where
``a*x + y`` is exact; ``maximum``, a chain whose products are
exact, and int32 bit-exact; bfloat16 within one bfloat16 ulp (the JAX
package rounds ``alpha`` to bf16 and XLA may round a fused chain once).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cekirdekler_tpu.ops import elementwise as ref
from cekirdekler_tpu_torch.errors import KernelCompileError
from cekirdekler_tpu_torch.ops import elementwise as ew
from tests.test_torch_card import conversion_inputs


def _pair(n: int, seed: int, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(n).astype(dtype) for _ in range(2)]


def _jax(fn, *arrays, **kw):
    return np.asarray(ref.map_blocks(fn, *(jnp.asarray(a) for a in arrays), interpret=True, **kw))


def _port(fn, *arrays, **kw):
    return ew.map_blocks(fn, *(torch.from_numpy(a) for a in arrays), **kw).numpy()


def _chain_jax(a, b):
    return jnp.where(a > b, jnp.maximum(a, b) * 2.0 - 1.0, -jnp.abs(b) * 0.25)


def _chain_port(a, b):
    return torch.where(a > b, torch.maximum(a, b) * 2.0 - 1.0, -torch.abs(b) * 0.25)


def test_saxpy_matches_jax_within_rtol():
    """The case ``tests/test_ops.py`` states: rtol 1e-5."""
    rng = np.random.default_rng(0)
    x, y = (rng.standard_normal(1024).astype(np.float32) for _ in range(2))
    want = np.asarray(ref.saxpy(2.5, jnp.asarray(x), jnp.asarray(y), interpret=True))
    got = ew.saxpy(2.5, torch.from_numpy(x), torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_array_equal(got, y + np.float32(2.5) * x)


@pytest.mark.parametrize("n", [128, 1024, 128 * 37])
def test_saxpy_matches_jax_within_one_rounding(n):
    """Where the sum cancels, an FMA's skipped rounding of ``a*x`` is large
    against the result but not against the terms: within 1e-5 of
    ``|y| + |a*x|``."""
    x, y = _pair(n, n)
    want = np.asarray(ref.saxpy(1.7, jnp.asarray(x), jnp.asarray(y), interpret=True))
    got = ew.saxpy(1.7, torch.from_numpy(x), torch.from_numpy(y)).numpy()
    ax = np.float32(1.7) * x
    assert np.all(np.abs(got - want) <= 1e-5 * (np.abs(y) + np.abs(ax)))
    np.testing.assert_array_equal(got, y + ax)


def test_saxpy_bit_exact_where_the_fma_cannot_differ():
    rng = np.random.default_rng(1)
    x, y = (rng.integers(-64, 64, 2048).astype(np.float32) for _ in range(2))
    want = np.asarray(ref.saxpy(0.5, jnp.asarray(x), jnp.asarray(y), interpret=True))
    got = ew.saxpy(0.5, torch.from_numpy(x), torch.from_numpy(y)).numpy()
    np.testing.assert_array_equal(got, want)


def test_maximum_bit_exact():
    x, y = _pair(4096, 2)
    np.testing.assert_array_equal(_port(torch.maximum, x, y), _jax(jnp.maximum, x, y))


def test_chain_bit_exact():
    x, y = _pair(4096, 3)
    np.testing.assert_array_equal(_port(_chain_port, x, y), _jax(_chain_jax, x, y))


def test_int32_bit_exact():
    rng = np.random.default_rng(4)
    x, y = (rng.integers(-3000, 3000, 1024).astype(np.int32) for _ in range(2))
    got = _port(lambda a, b: torch.maximum(a * b - b, -a), x, y)
    np.testing.assert_array_equal(got, _jax(lambda a, b: jnp.maximum(a * b - b, -a), x, y))
    assert got.dtype == np.int32


def _bf16_ulps(a: np.ndarray, b: np.ndarray) -> float:
    a32, b32 = a.astype(np.float32), b.astype(np.float32)
    top = np.maximum(np.maximum(np.abs(a32), np.abs(b32)), np.float32(2.0 ** -126))
    ulp = 2.0 ** (np.floor(np.log2(top)) - 7)
    return float(np.max(np.abs(a32 - b32) / ulp))


def test_bf16_saxpy_within_one_ulp():
    x, y = _pair(2048, 5)
    xb, yb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(y, jnp.bfloat16)
    want = np.asarray(ref.saxpy(1.5, xb, yb, interpret=True).astype(jnp.float32))
    got = ew.saxpy(1.5, torch.from_numpy(x).bfloat16(), torch.from_numpy(y).bfloat16())
    assert got.dtype == torch.bfloat16
    assert _bf16_ulps(got.float().numpy(), want) <= 1.0


def test_result_has_the_first_arrays_dtype():
    """bf16 and f32 inputs compute in f32 (PyTorch's promotion) and the
    result takes ``arrays[0]``'s bf16; the JAX package stores into a bf16
    block, which needs the cast written out."""
    x, y = _pair(256, 6)
    xb = torch.from_numpy(x).bfloat16()
    got = ew.map_blocks(lambda a, b: a * 0.5 + b, xb, torch.from_numpy(y))
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, (xb.float() * 0.5 + torch.from_numpy(y)).bfloat16())
    want = _jax(lambda a, b: (a.astype(jnp.float32) * 0.5 + b).astype(jnp.bfloat16),
                np.asarray(jnp.asarray(x, jnp.bfloat16)), y)
    np.testing.assert_array_equal(got.float().numpy(), want.astype(np.float32))


def test_division_by_a_constant_is_ieee_division():
    """XLA:CPU rewrites ``x / 3.0`` as ``x * (1/3)`` (ROADMAP Queue C 7);
    the port divides, as PyTorch and CUDA do."""
    x, _ = _pair(4096, 11)
    got = _port(lambda a: a / 3.0, x)
    np.testing.assert_array_equal(got, x / np.float32(3.0))
    want = _jax(lambda a: a / 3.0, x)
    np.testing.assert_array_equal(want, x * np.float32(1.0 / 3.0))
    assert np.any(got != want)
    assert np.all(np.abs(got - want) <= np.spacing(np.abs(got)))


@pytest.mark.parametrize("block_rows", [1, 3, 8, 256, 4096])
def test_result_does_not_depend_on_block_rows(block_rows):
    x, y = _pair(128 * 24, 7)
    want = _jax(jnp.maximum, x, y, block_rows=256)
    np.testing.assert_array_equal(_jax(jnp.maximum, x, y, block_rows=block_rows), want)
    np.testing.assert_array_equal(_port(torch.maximum, x, y, block_rows=block_rows), want)


@pytest.mark.parametrize("shapes, message", [
    (((100,), (100,)), "length (100) must be a multiple of 128"),
    (((256,), (128,)), "map_blocks needs equal-length 1-D arrays"),
    (((256,), (2, 128)), "map_blocks needs equal-length 1-D arrays"),
])
def test_errors_match_jax(shapes, message):
    arrays = [np.zeros(s, np.float32) for s in shapes]
    with pytest.raises(ValueError) as want:
        _jax(jnp.maximum, *arrays)
    with pytest.raises(ValueError) as got:
        _port(torch.maximum, *arrays)
    assert str(got.value) == str(want.value) == message


@pytest.mark.parametrize("fn, op", [
    (torch.sin, "torch.sin"),
    (lambda a: a ** 2, "'**'"),
    (lambda a: a % 3, "'%'"),
    (lambda a: 2 // a, "'//'"),
    (lambda a: a.sqrt(), "'.sqrt'"),
    (lambda a: a if a > 0 else -a, "control flow"),
    (lambda a: torch.add(a, a, alpha=2), "torch.add"),
    (lambda a: torch.maximum(a, torch.ones(256)), "an operand of type Tensor"),
    (lambda a: (a > 0) + 1, "on a comparison result"),
    (lambda a: a + 2 ** 40, "outside int32"),
])
def test_an_op_outside_the_table_is_named(fn, op):
    x = torch.zeros(256)
    with pytest.raises(KernelCompileError, match=op.replace("(", r"\(").replace("*", r"\*")):
        ew.map_blocks(fn, x)


def test_dtypes_outside_the_kernel_are_refused():
    with pytest.raises(KernelCompileError, match="float64"):
        ew.map_blocks(torch.maximum, torch.zeros(256, dtype=torch.float64),
                      torch.zeros(256, dtype=torch.float64))


def test_the_cpu_takes_the_plain_version():
    x, y = (torch.from_numpy(a) for a in _pair(512, 8))
    launches, plain = ew.LAUNCHES.count, ew.PLAIN_RUNS.by_key.get("cpu", 0)
    ew.saxpy(2.0, x, y)
    assert ew.LAUNCHES.count == launches
    assert ew.PLAIN_RUNS.by_key["cpu"] == plain + 1


def test_out_receives_the_result_in_place():
    x, y = (torch.from_numpy(a) for a in _pair(512, 9))
    want = y + 1.25 * x
    ew.saxpy(1.25, x, y, out=y)
    assert torch.equal(y, want)
    with pytest.raises(KernelCompileError, match="partly overlaps"):
        buf = torch.zeros(640)
        ew.saxpy(1.0, buf[:512], buf[128:], out=buf[64:576])
    with pytest.raises(KernelCompileError, match="out must be"):
        ew.saxpy(1.0, x, y, out=torch.zeros(512, dtype=torch.float64))


# -- the kernel's emitted source, built by g++ for the host ----------------

HOST_CASES = [
    ("saxpy", lambda x, y: y + 1.5 * x, torch.float32),
    ("maximum", torch.maximum, torch.float32),
    ("chain", _chain_port, torch.float32),
    ("where-consts", lambda x, y: torch.where(x > 0.1, x * 0.3, y - 7), torch.float32),
    ("saxpy-bf16", lambda x, y: y + 1.5 * x, torch.bfloat16),
    ("chain-bf16", _chain_port, torch.bfloat16),
    ("where-bf16", lambda x, y: torch.where(x > 0.1, x * 0.3, y - 7), torch.bfloat16),
    ("chain-f16", _chain_port, torch.float16),
    ("int32", lambda x, y: torch.maximum(x * y - y, -x) + x / 3, torch.int32),
]


def _host_inputs(dtype, n: int, seed: int):
    rng = np.random.default_rng(seed)
    if dtype == torch.int32:
        return [torch.from_numpy(rng.integers(-3000, 3000, n).astype(np.int32))
                for _ in range(2)]
    return [torch.from_numpy((rng.standard_normal(n) * 3).astype(np.float32)).to(dtype)
            for _ in range(2)]


@pytest.mark.parametrize("name, fn, dtype", HOST_CASES, ids=[c[0] for c in HOST_CASES])
def test_emitted_kernel_on_the_host_equals_plain(name, fn, dtype):
    """The same spliced source the card builds, compiled with g++: the
    vector path on aligned tensors and the scalar path on a view one
    element in, at a length whose vectors leave the grid's three threads
    a remainder after their steps of CK_U vectors."""
    launch = ew.launcher(ew.kernel_source(fn, (dtype, dtype)), compiler="g++")
    for n in (128 * 50, 128 * 3):
        for view in (0, 1):
            base = _host_inputs(dtype, n + view, len(name))
            x, y = (t[view:] for t in base)
            want = ew.map_blocks_plain(fn, x, y)
            out = torch.empty(n, dtype=dtype)
            ew.run(launch, out, (x, y), None)
            assert torch.equal(out, want), (n, view)


@pytest.mark.parametrize("fn", [lambda a: torch.exp(a * 0.5), torch.tanh], ids=["exp", "tanh"])
def test_emitted_transcendentals_within_two_ulp_on_the_host(fn):
    """glibc's libm against ATen's vectorized CPU kernels."""
    launch = ew.launcher(ew.kernel_source(fn, (torch.float32,)), compiler="g++")
    x, _ = _host_inputs(torch.float32, 4096, 10)
    out = torch.empty(4096)
    ew.run(launch, out, (x,), None)
    got, want = out.numpy(), ew.map_blocks_plain(fn, x).numpy()
    ulp = np.spacing(np.maximum(np.abs(got), np.abs(want)))
    assert float(np.max(np.abs(got - want) / ulp)) <= 2.0


def test_constants_are_exact_hex_literals():
    src = ew.kernel_source(lambda x: x * 0.1 + 3, (torch.float32,))
    assert f"{float(np.float32(0.1)).hex()}f" in src
    assert "(3)" not in src  # a float expression takes the constant as a float
    assert f"{float(3).hex()}f" in src


@pytest.mark.parametrize("pad", [0, 1], ids=["vector", "scalar"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
def test_host_conversions_equal_torch_to(dtype, pad):
    """The host build's f32 -> bf16 / f16 rounding (in software, in pairs
    on the vector path) equals torch's ``.to()`` on the CPU bit for bit on
    crafted values: ties to even, subnormals, +-inf, NaNs, the largest
    finite values, f16 overflow."""
    launch = ew.launcher(ew.kernel_source(lambda a: a, (torch.float32,), dtype), compiler="g++")
    x = conversion_inputs()
    xs = torch.cat([torch.zeros(pad), x])[pad:]
    out = torch.empty(x.numel() + pad, dtype=dtype)[pad:]
    ew.run(launch, out, (xs,), None)
    assert torch.equal(out.view(torch.int16), xs.to(dtype).view(torch.int16))


@pytest.mark.parametrize("k", [1, 3, 5, 37])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int32], ids=str)
def test_host_build_out_is_an_input(dtype, k):
    """``out`` exactly the first input (the kernel's pointers are
    ``__restrict__``), at lengths of 128·k with k odd, so the grid's
    threads end on partial steps of CK_U vectors."""
    launch = ew.launcher(ew.kernel_source(_chain_port, (dtype, dtype)), compiler="g++")
    x, y = _host_inputs(dtype, 128 * k, k)
    want = ew.map_blocks_plain(_chain_port, x, y)
    ew.run(launch, x, (x, y), None)
    assert torch.equal(x, want)


@pytest.mark.parametrize("unroll", [2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_unrolled_host_variants_equal_plain(dtype, unroll):
    """The sweep's variants load 2 or 4 vectors of each input before they
    compute (the shipped kernel loads one): their host builds equal the
    plain version at lengths that leave the grid's threads partial steps."""
    from cekirdekler_tpu_torch.tools import sweep_stream

    src = sweep_stream.elementwise_variant(ew.kernel_source(_chain_port, (dtype, dtype)),
                                           unroll, 256, False)
    launch = ew.launcher(src, compiler="g++")
    for k in (1, 7, 37):
        x, y = _host_inputs(dtype, 128 * k, k)
        out = torch.empty(128 * k, dtype=dtype)
        ew.run(launch, out, (x, y), None)
        assert torch.equal(out, ew.map_blocks_plain(_chain_port, x, y)), k


def test_a_bf16_result_is_rounded_once_by_the_store():
    """The root's own rounding is left to the store's conversion, which
    converts the vector's values in pairs; the ops inside still round."""
    src = ew.kernel_source(lambda x, y: y + 1.5 * x, (torch.bfloat16, torch.bfloat16))
    fn = src[src.index("ck_fn("):src.index("template <int U>")]
    assert fn.count("ck_rbf16(") == 1 and "return t3;" in fn
    assert "ck_bf16x2_bits(&r.v[k]" in src
    assert "__restrict__ p0" in src and "__restrict__ po" in src
