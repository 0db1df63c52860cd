"""The port's flash attention, forward and backward, against the JAX
package, on the CPU.

``cekirdekler_tpu_torch/ops/flash_attention.py`` holds the CUDA kernels'
wrappers and their plain PyTorch versions; on a CPU tensor the wrappers run
the plain versions with the reference's own blocks.  The same numpy-seeded
inputs go through the JAX functions (Pallas in interpret mode, as
``tests/test_flash_attention.py`` runs them, under ``jax.grad`` for the
backward) and through the port (``torch.autograd``).

Tolerances: f32 inputs at ``"highest"`` within 1e-5 abs (measured worst
3.6e-7 on the output, 4.8e-7 on the lse).  bf16 inputs or ``"default"``
within 2 bf16 ulps of the output's largest magnitude (about 2e-2 at
|o| <= 2; measured worst 9.8e-4, one bf16 rounding of an output of
magnitude below 0.25, and 2.3e-4 for f32 inputs at ``"default"``, where a
score summed in another order can round p the other way).

Gradients: f32 at ``"highest"`` within ``tests/test_flash_attention.py``'s
rtol and atol of 5e-4 (measured worst 1.2e-6 abs); bf16 inputs or
``"default"`` within 2 bf16 ulps of each gradient's largest magnitude
(measured worst half an ulp, 2.0e-3 on a dq of magnitude 2; f32 inputs at
``"default"`` 1.7e-4, where p or ds rounds to bf16 the other way).
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")
import jax  # noqa: E402

from cekirdekler_tpu.ops import flash_attention as ref  # noqa: E402
from cekirdekler_tpu.parallel.attention import attention_reference as ref_dense  # noqa: E402
from cekirdekler_tpu_torch.ops import flash_attention as port  # noqa: E402
from cekirdekler_tpu_torch.parallel.attention import attention_reference  # noqa: E402

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _qkv(B, Tq, Tk, H, D, dtype, seed=0):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal((B, t, H, D)).astype(np.float32) for t in (Tq, Tk, Tk)]
    jd, td = DTYPES[dtype]
    return ([jnp.asarray(a, jd) for a in arrays], [torch.from_numpy(a).to(td) for a in arrays])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _tol(want: np.ndarray, dtype: str, precision: str) -> float:
    if dtype == "f32" and precision == "highest":
        return 1e-5
    top = float(np.abs(want).max())
    return 2.0 * 2.0 ** (math.floor(math.log2(top)) - 7)  # 2 bf16 ulps at |o| = top


@pytest.mark.parametrize("blocks", [(128, 128), (64, 128)], ids=lambda b: f"{b[0]}x{b[1]}")
@pytest.mark.parametrize("shape", [(1, 128, 2, 16), (2, 256, 2, 64)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_flash_matches_reference(causal, precision, dtype, shape, blocks):
    B, T, H, D = shape
    (qj, kj, vj), (qt, kt, vt) = _qkv(B, T, T, H, D, dtype)
    want = ref.flash_attention(qj, kj, vj, causal, *blocks, None, precision)
    before = port.PLAIN_RUNS.by_key.get("cpu", 0)
    got = port.flash_attention(qt, kt, vt, causal, *blocks, precision)
    assert port.PLAIN_RUNS.by_key["cpu"] == before + 1
    assert got.dtype == DTYPES[dtype][1] and tuple(got.shape) == tuple(want.shape)
    want_np = _np(want)
    np.testing.assert_allclose(_np(got), want_np, rtol=0,
                               atol=_tol(want_np, dtype, precision))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_flash_forward_with_lse(causal, precision, dtype):
    (qj, kj, vj), (qt, kt, vt) = _qkv(2, 256, 256, 2, 64, dtype, seed=1)
    o_r, lse_r, (qs_r, _, _) = ref._flash_forward(qj, kj, vj, causal, 128, 128, None,
                                                  precision, with_lse=True)
    o_p, lse_p, (qs_p, ks_p, vs_p) = port._flash_forward(qt, kt, vt, causal, 128, 128,
                                                         precision, with_lse=True)
    assert tuple(lse_p.shape) == tuple(lse_r.shape) == (4, 256, 1)
    assert lse_p.dtype == torch.float32
    np.testing.assert_allclose(lse_p.numpy(), np.asarray(lse_r), rtol=0, atol=1e-5)
    want = _np(o_r)
    np.testing.assert_allclose(_np(o_p), want, rtol=0, atol=_tol(want, dtype, precision))
    # the stream-cast operands: bf16 under "default", untouched under "highest"
    cast = torch.bfloat16 if precision == "default" else DTYPES[dtype][1]
    assert qs_p.dtype == ks_p.dtype == vs_p.dtype == cast
    assert qs_r.dtype.name == str(cast).removeprefix("torch.")


@pytest.mark.parametrize("tq,tk", [(128, 256), (256, 128)])
def test_non_causal_tq_ne_tk(tq, tk):
    (qj, kj, vj), (qt, kt, vt) = _qkv(2, tq, tk, 2, 16, "f32", seed=2)
    want = ref.flash_attention(qj, kj, vj, False, 64, 128, None, "highest")
    got = port.flash_attention(qt, kt, vt, False, 64, 128, "highest")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_default_args_t96_fall_back_to_dense(causal, precision):
    """T=96 admits only 32-wide tiles: default-argument calls run dense
    attention in both packages (``ROUTES`` counts ``dense``)."""
    (qj, kj, vj), (qt, kt, vt) = _qkv(2, 96, 96, 2, 16, "f32", seed=3)
    assert ref.default_blocks(96) is None and port.default_blocks(96) is None
    want = ref.flash_attention(qj, kj, vj, causal, precision=precision)
    before = dict(port.ROUTES.by_key)
    got = port.flash_attention(qt, kt, vt, causal, precision=precision)
    assert port.ROUTES.by_key.get("dense", 0) == before.get("dense", 0) + 1
    assert port.ROUTES.by_key.get("tiled", 0) == before.get("tiled", 0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_default_args_t256_run_tiled():
    (qj, kj, vj), (qt, kt, vt) = _qkv(1, 256, 256, 2, 16, "f32", seed=4)
    want = ref.flash_attention(qj, kj, vj, True)
    before = port.ROUTES.by_key.get("tiled", 0)
    got = port.flash_attention(qt, kt, vt, True)
    assert port.ROUTES.by_key["tiled"] == before + 1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_block_policies_match_reference():
    lengths = list(range(1, 1100)) + [2048, 4096, 4104, 8192, 12288]
    for T in lengths:
        for target in (512, 256, 128):
            assert port.auto_block(T, target) == ref.auto_block(T, target), (T, target)
            assert port.default_blocks(T, target=target) == ref.default_blocks(
                T, target=target), (T, target)
        assert port.default_blocks(T, 2048) == ref.default_blocks(T, 2048), T
    for tq, tk, bq, bk in ((48, 48, 32, 32), (256, 128, 128, 64), (640, 640, 512, 512)):
        assert port._blocks_for(tq, tk, bq, bk) == ref._blocks_for(tq, tk, bq, bk)


def test_degenerate_explicit_blocks_raise():
    (qj, kj, vj), (qt, kt, vt) = _qkv(1, 36, 36, 2, 16, "f32")
    with pytest.raises(ValueError, match="degenerate"):
        ref.flash_attention(qj, kj, vj, False, 32, 32, True)
    with pytest.raises(ValueError, match="degenerate"):
        port.flash_attention(qt, kt, vt, False, 32, 32)


def test_causal_tq_ne_tk_raises():
    (qj, kj, vj), (qt, kt, vt) = _qkv(1, 128, 256, 2, 16, "f32")
    with pytest.raises(ValueError, match="Tq == Tk"):
        ref.flash_attention(qj, kj, vj, True, 128, 128, True)
    with pytest.raises(ValueError, match="Tq == Tk"):
        port.flash_attention(qt, kt, vt, True, 128, 128)


@pytest.mark.parametrize("precision", ["high", "bf16", None, "HIGHEST"])
def test_bad_precision_raises(precision):
    (qj, kj, vj), (qt, kt, vt) = _qkv(1, 128, 128, 2, 16, "f32")
    with pytest.raises(ValueError, match="precision"):
        ref.flash_attention(qj, kj, vj, False, 128, 128, True, precision)
    with pytest.raises(ValueError, match="precision"):
        port.flash_attention(qt, kt, vt, False, 128, 128, precision)


def test_grads_flow_through_the_plain_backward_on_cpu():
    """With grad enabled a tiled call is differentiable; on CPU tensors its
    backward runs the plain version once per call (no kernel launches).
    Under ``no_grad`` the same call is the plain forward alone."""
    _, (qt, kt, vt) = _qkv(1, 128, 128, 2, 16, "f32")
    qt.requires_grad_(True)
    before = (port.PLAIN_BWD_RUNS.by_key.get("cpu", 0), port.BWD_LAUNCHES.count,
              port.LAUNCHES.count)
    out = port.flash_attention(qt, kt, vt, True, 128, 128)
    assert out.requires_grad
    out.sum().backward()
    assert qt.grad is not None and qt.grad.shape == qt.shape and kt.grad is None
    assert bool(torch.isfinite(qt.grad).all())
    assert port.PLAIN_BWD_RUNS.by_key["cpu"] == before[0] + 1
    assert (port.BWD_LAUNCHES.count, port.LAUNCHES.count) == before[1:]
    with torch.no_grad():
        assert port.flash_attention(qt, kt, vt, True, 128, 128).shape == qt.shape
    assert port.PLAIN_BWD_RUNS.by_key["cpu"] == before[0] + 1


def _grads(B, Tq, Tk, H, D, causal, dtype, precision, blocks, seed=0, dtypes=None):
    """dq, dk, dv of sum(w * flash(q, k, v)) from JAX (interpret mode under
    ``jax.grad``) and from the port (autograd), on the same inputs.
    ``dtypes`` gives q/k/v their own dtypes (mixed operands)."""
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal((B, t, H, D)).astype(np.float32) for t in (Tq, Tk, Tk)]
    w = rng.standard_normal((B, Tq, H, D)).astype(np.float32)
    dtypes = dtypes or (dtype,) * 3
    qj, kj, vj = (jnp.asarray(a, DTYPES[d][0]) for a, d in zip(arrays, dtypes))
    wj = jnp.asarray(w)

    def loss(q, k, v):
        out = ref.flash_attention(q, k, v, causal, *blocks, True, precision)
        return (out.astype(jnp.float32) * wj).sum()

    want = jax.grad(loss, argnums=(0, 1, 2))(qj, kj, vj)
    qt, kt, vt = (torch.from_numpy(a).to(DTYPES[d][1]).requires_grad_(True)
                  for a, d in zip(arrays, dtypes))
    out = port.flash_attention(qt, kt, vt, causal, *blocks, precision)
    (out.float() * torch.from_numpy(w)).sum().backward()
    return want, (qt.grad, kt.grad, vt.grad)


def _assert_grads_close(want, got, dtype, precision):
    for name, a, b in zip(("dq", "dk", "dv"), want, got):
        a = _np(a)
        assert b.shape == a.shape, name
        if dtype == "f32" and precision == "highest":
            np.testing.assert_allclose(_np(b), a, rtol=5e-4, atol=5e-4, err_msg=name)
        else:
            np.testing.assert_allclose(_np(b), a, rtol=0, atol=_tol(a, "bf16", precision),
                                       err_msg=name)


@pytest.mark.parametrize("blocks", [(128, 128), (16, 32)], ids=lambda b: f"{b[0]}x{b[1]}")
@pytest.mark.parametrize("shape", [(1, 128, 2, 16), (2, 256, 2, 64)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_flash_backward_matches_reference(causal, precision, dtype, shape, blocks):
    B, T, H, D = shape
    before = port.PLAIN_BWD_RUNS.by_key.get("cpu", 0)
    want, got = _grads(B, T, T, H, D, causal, dtype, precision, blocks)
    assert port.PLAIN_BWD_RUNS.by_key["cpu"] == before + 1
    assert all(g.dtype == DTYPES[dtype][1] for g in got)
    _assert_grads_close(want, got, dtype, precision)


@pytest.mark.parametrize("dtype,precision", [("f32", "highest"), ("bf16", "default")])
@pytest.mark.parametrize("tq,tk", [(128, 256), (256, 128)])
def test_flash_backward_tq_ne_tk(tq, tk, dtype, precision):
    want, got = _grads(2, tq, tk, 2, 16, False, dtype, precision, (64, 128), seed=6)
    _assert_grads_close(want, got, dtype, precision)


def test_flash_backward_grads_keep_primal_dtypes():
    """Mixed operands under "default": every operand streams as bf16, and
    each gradient comes back in its own primal's dtype, as the reference's
    ``grad_dtypes`` gives them."""
    dtypes = ("f32", "bf16", "f32")
    want, got = _grads(1, 128, 128, 2, 16, True, "f32", "default", (64, 64), seed=7,
                       dtypes=dtypes)
    assert [g.dtype for g in got] == [DTYPES[d][1] for d in dtypes]
    assert [str(g.dtype) for g in want] == ["float32", "bfloat16", "float32"]
    _assert_grads_close(want, got, "bf16", "default")


@pytest.mark.parametrize("tq,tk,causal", [(128, 128, False), (128, 128, True),
                                          (128, 256, False), (256, 128, False)])
def test_plain_backward_matches_autograd_of_dense(tq, tk, causal):
    """The plain backward against autograd through ``attention_reference``
    (f32): within 1e-5 of each gradient's largest magnitude (measured worst
    7e-7)."""
    rng = np.random.default_rng(8)
    arrays = [rng.standard_normal((2, t, 2, 32)).astype(np.float32) for t in (tq, tk, tk)]
    do = torch.from_numpy(rng.standard_normal((2, tq, 2, 32)).astype(np.float32))
    grads = []
    for fn in (lambda q, k, v: port.flash_attention(q, k, v, causal, 64, 64),
               lambda q, k, v: attention_reference(q, k, v, causal=causal)):
        qkv = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
        (fn(*qkv) * do).sum().backward()
        grads.append([t.grad for t in qkv])
    for name, got, want in zip(("dq", "dk", "dv"), *grads):
        err = float((got - want).abs().max())
        assert err <= 1e-5 * float(want.abs().max()), (name, err)


@pytest.mark.parametrize("precision", ["highest", "default"])
def test_dense_fallback_is_differentiable(precision):
    """T=96 takes the dense route, whose gradient is plain autograd (the
    reference's ``_dense_attention``): no backward of the port runs."""
    (qj, kj, vj), (qt, kt, vt) = _qkv(1, 96, 96, 2, 16, "f32", seed=9)
    for t in (qt, kt, vt):
        t.requires_grad_(True)
    want = jax.grad(lambda q, k, v: ref.flash_attention(q, k, v, True, precision=precision).sum(),
                    argnums=(0, 1, 2))(qj, kj, vj)
    before = port.PLAIN_BWD_RUNS.count
    port.flash_attention(qt, kt, vt, True, precision=precision).sum().backward()
    assert port.PLAIN_BWD_RUNS.count == before
    for a, b in zip(want, (qt.grad, kt.grad, vt.grad)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("tq,tk,causal", [(64, 64, False), (64, 64, True), (32, 96, False),
                                          (32, 96, True), (96, 96, True)])
def test_attention_reference_matches(tq, tk, causal, dtype):
    """The dense path, including causal ``Tq != Tk`` (ends aligned)."""
    (qj, kj, vj), (qt, kt, vt) = _qkv(2, tq, tk, 2, 16, dtype, seed=5)
    want = _np(ref_dense(qj, kj, vj, causal=causal))
    got = attention_reference(qt, kt, vt, causal=causal)
    assert got.dtype == DTYPES[dtype][1]
    tol = 1e-5 if dtype == "f32" else _tol(want, dtype, "default")
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=tol)


def test_attention_reference_refuses_unknown_precision():
    _, (qt, kt, vt) = _qkv(1, 8, 8, 1, 4, "f32")
    with pytest.raises(ValueError, match="precision"):
        attention_reference(qt, kt, vt, precision="bf16")
