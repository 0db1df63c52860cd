"""Which kernel the flash forward takes, and what its card gate allows.

``ops/flash_attention._route``, the rule the backward also follows, sends
q/k/v that are bf16 after the stream cast at ``"default"`` to the
tensor-core kernel (``csrc/flash_attention_tc.cu``) and every other case
to the FP32 kernel (``csrc/flash_attention.cu``).  The kernels run only on
the card (``tests/test_torch_card.py``); here, on the CPU, the wrapper
takes the plain forward and counts no launch.

The card holds the tensor-core kernel against ``flash_attention_plain``
within 2 bf16 ulps of the output's largest magnitude and 1e-5 in the lse,
where its f32 sums run in another order (the output accumulator is
rescaled before the tensor cores add a tile's p'.v to it).  The last test
shows, on the CPU, that this gate covers a change of summation order with
p rounded to bf16 only before p.v: the plain forward at key blocks 16, 32,
64 and 128 agrees pairwise within that limit.
"""

from __future__ import annotations

import functools
import itertools

import numpy as np
import pytest
import torch

from cekirdekler_tpu_torch.errors import KernelCompileError
from cekirdekler_tpu_torch.ops import flash_attention as fa

BLOCKS = (16, 32, 64, 128)
GEOMETRIES = {
    # (B, Tq, Tk, H, D, causal); 200 x 384 and D = 40 leave ragged tiles
    "1x256x2x64-causal": (1, 256, 256, 2, 64, True),
    "200x384x2x64-full": (1, 200, 384, 2, 64, False),
    "2x200x2x40-causal": (2, 200, 200, 2, 40, True),
}


@pytest.mark.parametrize("dtype, precision, route", [
    (torch.bfloat16, "default", "tc"),
    (torch.float32, "default", "tc"),
    (torch.bfloat16, "highest", "fp32"),
    (torch.float32, "highest", "fp32"),
])
def test_fwd_route(dtype, precision, route):
    """The forward routes the operands as the kernel sees them: f32 at
    "default" is cast to bf16 first and so takes the tensor cores; bf16 at
    "highest" keeps the FP32 kernel."""
    (q,) = fa._stream_cast(precision, torch.zeros(1, 8, 1, 16, dtype=dtype))
    assert fa._route(q.dtype, precision) == route


def _inputs(B, Tq, Tk, H, D, seed=7):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal((B, t, H, D)).astype(np.float32))
                 .to(torch.bfloat16) for t in (Tq, Tk, Tk))


@pytest.mark.parametrize("with_lse", [False, True])
def test_cpu_forward_takes_the_plain_version(with_lse):
    """On CPU tensors the wrapper runs the plain forward: PLAIN_RUNS counts
    "cpu" and no launch or route is counted."""
    q, k, v = _inputs(1, 64, 64, 2, 16)
    before = (fa.PLAIN_RUNS.by_key.get("cpu", 0), fa.LAUNCHES.count, dict(fa.LAUNCHES.by_key))
    res = fa._flash_forward(q, k, v, True, 32, 32, "default", with_lse=with_lse)
    out = res[0] if with_lse else res
    assert out.device.type == "cpu" and out.dtype == torch.bfloat16
    assert bool(torch.isfinite(out.float()).all())
    assert (fa.PLAIN_RUNS.by_key.get("cpu", 0), fa.LAUNCHES.count, dict(fa.LAUNCHES.by_key)) == \
        (before[0] + 1, before[1], before[2])


def test_tc_route_refuses_f32_operands():
    """The tensor-core kernel reads bf16 only: asked to take f32 q/k/v it
    raises before it builds or launches anything."""
    q = torch.zeros(1, 64, 2, 16)
    with pytest.raises(KernelCompileError, match="must be bf16"):
        fa._launch(q, q, q, True, "default", torch.float32, False, route="tc")


@functools.lru_cache(maxsize=None)
def _forward_at(geometry: str, block: int) -> tuple[torch.Tensor, torch.Tensor]:
    """bf16 output and f32 lse of the plain forward at "default" over key
    blocks of ``block``."""
    B, Tq, Tk, H, D, causal = GEOMETRIES[geometry]
    q, k, v = _inputs(B, Tq, Tk, H, D)
    return fa.flash_attention_plain(q, k, v, causal, block, "default", torch.bfloat16)


def _bf16_ulps(want: torch.Tensor, n: float = 2.0) -> float:
    """``n`` bf16 ulps at the largest magnitude of ``want``, as the card gates
    (``chip_smoke.bf16_ulps``) take them."""
    return n * 2.0 ** (np.floor(np.log2(float(want.abs().max()))) - 7)


@pytest.mark.parametrize("pair", list(itertools.combinations(BLOCKS, 2)),
                         ids=lambda p: f"blocks{p[0]}-{p[1]}")
@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_summation_order_stays_inside_the_card_gate(geometry, pair):
    """The limits are fixed before the run: 2 bf16 ulps of the output's
    largest magnitude and 1e-5 in the lse (the card's gates on the
    tensor-core forward).  Blocks change the order of every f32 sum and
    where the running max is taken, and keep p in f32 for l and rounded to
    bf16 only before p.v; every pair of blocks must agree within them."""
    (out_a, lse_a), (out_b, lse_b) = (_forward_at(geometry, b) for b in pair)
    tol = _bf16_ulps(out_b.float())
    err = float((out_a.float() - out_b.float()).abs().max())
    assert bool(torch.isfinite(out_a.float()).all()) and err <= tol, (err, tol)
    lse_err = float((lse_a - lse_b).abs().max())
    assert lse_err <= 1e-5, lse_err
