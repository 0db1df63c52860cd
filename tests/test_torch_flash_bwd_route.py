"""Which kernels the flash backward takes, and what its card gate allows.

``ops/flash_attention._bwd_route`` sends bf16 q/k/v/dO at ``"default"`` to
the tensor-core kernels (``csrc/flash_attention_bwd_tc.cu``) and every other
case to the FP32 kernels (``csrc/flash_attention_bwd.cu``).  The kernels run
only on the card (``tests/test_torch_card.py``); here, on the CPU, the
wrapper takes the plain backward and counts no kernel route.

The card holds the tensor-core kernels against ``flash_attention_bwd_plain``
within 2 bf16 ulps of each gradient's largest magnitude, where their f32
sums run in another order.  The last test shows, on the CPU, that this
gate covers a change of summation order at the same rounding points: the
plain backward at blocks 16, 32, 64 and 128 (each block's product summed on
its own, then added in order) agrees pairwise within that limit.
"""

from __future__ import annotations

import functools
import itertools

import numpy as np
import pytest
import torch

from cekirdekler_tpu_torch.ops import flash_attention as fa

BLOCKS = (16, 32, 64, 128)
GEOMETRIES = {
    # (B, Tq, Tk, H, D, causal); 200 x 328 leaves ragged tiles at every block
    "1x256x2x64-causal": (1, 256, 256, 2, 64, True),
    "200x328x2x64-full": (1, 200, 328, 2, 64, False),
}


@pytest.mark.parametrize("dtype, precision, route", [
    (torch.bfloat16, "default", "tc"),
    (torch.bfloat16, "highest", "fp32"),
    (torch.float32, "highest", "fp32"),
    (torch.float32, "default", "fp32"),
])
def test_bwd_route(dtype, precision, route):
    """bf16 at "default" takes the tensor-core kernels, the rest the FP32
    ones.  (The single-card backward stream-casts f32 to bf16 under
    "default" before it routes, so an f32 model at "default" reaches "tc".)"""
    assert fa._bwd_route(dtype, precision) == route


@pytest.mark.parametrize("dtype, precision, route", [
    (torch.float32, "default", "fp32"),
    (torch.float32, "highest", "fp32"),
    (torch.bfloat16, "default", "tc"),
    (torch.bfloat16, "highest", "fp32"),
])
def test_parts_backward_route(dtype, precision, route):
    """The parts form demotes "default" to "highest" on f32 operands (they
    are not rounded), so only bf16 at "default" reaches the tensor cores."""
    assert fa._bwd_route(dtype, fa._parts_bwd_precision(dtype, precision)) == route


def test_parts_backward_precision_refuses_unknown():
    with pytest.raises(ValueError, match="precision"):
        fa._parts_bwd_precision(torch.bfloat16, "fast")


def _views(D: int, H: int = 4, offset: int = 0) -> tuple[torch.Tensor, ...]:
    """q/k/v as the model makes them: chunks of one [B, T, 3 H D] product."""
    base = torch.zeros(2 * 16 * 3 * H * D + offset, dtype=torch.bfloat16)
    qkv = base[offset:].view(2, 16, 3 * H * D)
    return tuple(t.reshape(2, 16, H, D) for t in qkv.chunk(3, dim=-1))


@pytest.mark.parametrize("D, offset, want", [
    (64, 0, True),    # the model's views: offsets 0 / H D / 2 H D, row stride 3 H D
    (40, 0, True),    # 40 pads to 48 in shared memory; copies stay inside a row
    (20, 0, False),   # D % 8 != 0: element loads
    (64, 4, False),   # a base 8 bytes off 16-byte alignment
])
def test_vector_loads(D, offset, want):
    assert fa._vector_loads(_views(D, offset=offset), D) is want


def test_vector_loads_refuse_a_stride_off_eight_elements():
    q = torch.zeros(2, 16, 3, 72, dtype=torch.bfloat16)[:, :, :, :64]  # head stride 72
    assert fa._vector_loads((q,), 64)
    q = torch.zeros(2, 16, 3, 68, dtype=torch.bfloat16)[:, :, :, :64]  # head stride 68
    assert not fa._vector_loads((q,), 64)


def _inputs(B, Tq, Tk, H, D, seed=7):
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((B, t, H, D)).astype(np.float32))
                   .to(torch.bfloat16) for t in (Tq, Tk, Tk, Tq))
    return q, k, v, do


@pytest.mark.parametrize("parts", [False, True])
def test_cpu_backward_takes_the_plain_version(parts):
    """On CPU tensors the wrapper runs the plain backward: PLAIN_BWD_RUNS
    counts "cpu" and no kernel route or launch is counted."""
    q, k, v, do = _inputs(1, 64, 64, 2, 16)
    counts = (fa.PLAIN_BWD_RUNS.by_key.get("cpu", 0), fa.BWD_ROUTES.count,
              fa.BWD_LAUNCHES.count, fa.PARTS_LAUNCHES.count)
    if parts:
        lse = torch.zeros(1, 64, 2)
        delta = torch.zeros(1, 64, 2)
        grads = fa.flash_attention_bwd_parts(q, k, v, do, lse, delta, 0, 0, True, 32, 32,
                                             "default")
    else:
        out, lse, (qs, ks, vs) = fa._flash_forward(q, k, v, True, 32, 32, "default",
                                                   with_lse=True)
        grads = fa._flash_backward(qs, ks, vs, out, lse, do, True, 32, 32, "default")
    assert all(g.device.type == "cpu" and bool(torch.isfinite(g).all()) for g in grads)
    assert (fa.PLAIN_BWD_RUNS.by_key.get("cpu", 0), fa.BWD_ROUTES.count,
            fa.BWD_LAUNCHES.count, fa.PARTS_LAUNCHES.count) == \
        (counts[0] + 1, counts[1], counts[2], counts[3])


@functools.lru_cache(maxsize=None)
def _grads_at(geometry: str, block: int) -> tuple[torch.Tensor, ...]:
    """bf16 gradients of the plain backward at "default" with square
    blocks of ``block``, from the plain forward's lse (blocks of 64)."""
    B, Tq, Tk, H, D, causal = GEOMETRIES[geometry]
    q, k, v, do = _inputs(B, Tq, Tk, H, D)
    out, lse = fa.flash_attention_plain(q, k, v, causal, 64, "default", torch.bfloat16)
    return fa.flash_attention_bwd_plain(q, k, v, do, lse, fa._delta(out, do), causal, block,
                                        block, "default", (torch.bfloat16,) * 3)


def _bf16_ulps(want: torch.Tensor, n: float = 2.0) -> float:
    """``n`` bf16 ulps at the largest magnitude of ``want``, as the card gates
    (``chip_smoke.bf16_ulps``) take them."""
    return n * 2.0 ** (np.floor(np.log2(float(want.abs().max()))) - 7)


@pytest.mark.parametrize("pair", list(itertools.combinations(BLOCKS, 2)),
                         ids=lambda p: f"blocks{p[0]}-{p[1]}")
@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_summation_order_stays_inside_the_card_gate(geometry, pair):
    """The limit is fixed before the run: 2 bf16 ulps of each gradient's
    largest magnitude (the card's gate on the tensor-core kernels).  Blocks
    change the order of every f32 sum and keep the rounding points of p and
    ds, as the tensor cores do; every pair of blocks must agree within it."""
    a_block, b_block = pair
    for name, a, b in zip(("dq", "dk", "dv"), _grads_at(geometry, a_block),
                          _grads_at(geometry, b_block)):
        tol = _bf16_ulps(b.float())
        err = float((a.float() - b.float()).abs().max())
        assert bool(torch.isfinite(a).all()) and err <= tol, (name, err, tol)
