"""The port's flash-attention forward against the JAX package, on the CPU.

``cekirdekler_tpu_torch/ops/flash_attention.py`` holds the CUDA kernel's
wrapper and its plain PyTorch version; on a CPU tensor the wrapper runs the
plain version with the reference's own key blocks.  The same numpy-seeded
inputs go through the JAX functions (Pallas in interpret mode, as
``tests/test_flash_attention.py`` runs them) and through the port.

Tolerances: f32 inputs at ``"highest"`` within 1e-5 abs (measured worst
3.6e-7 on the output, 4.8e-7 on the lse).  bf16 inputs or ``"default"``
within 2 bf16 ulps of the output's largest magnitude (about 2e-2 at
|o| <= 2; measured worst 9.8e-4, one bf16 rounding of an output of
magnitude below 0.25, and 2.3e-4 for f32 inputs at ``"default"``, where a
score summed in another order can round p the other way).
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from cekirdekler_tpu.ops import flash_attention as ref  # noqa: E402
from cekirdekler_tpu.parallel.attention import attention_reference as ref_dense  # noqa: E402
from cekirdekler_tpu_torch.errors import NotPortedError  # noqa: E402
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


def test_requires_grad_names_the_training_slice():
    _, (qt, kt, vt) = _qkv(1, 128, 128, 2, 16, "f32")
    qt.requires_grad_(True)
    with pytest.raises(NotPortedError, match="Queue B 5"):
        port.flash_attention(qt, kt, vt, True, 128, 128)
    with torch.no_grad():
        assert port.flash_attention(qt, kt, vt, True, 128, 128).shape == qt.shape


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
