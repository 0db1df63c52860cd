"""Mixture-of-experts FFN: top-1 routing, dense compute-all and capacity
dispatch, and the experts sharded over a mesh's ``ep`` axis.

Counterpart of ``cekirdekler_tpu/models/moe.py``, under its names:

- :func:`moe_ffn`, the dense compute-all form: every expert computes
  every token, the top-1 router gates, and the selected expert's output
  is summed in f32.  Exact, and E times the products needed.
- :func:`moe_ffn_capacity`, the Switch-style capacity dispatch: each
  expert gathers at most C = ceil(N/E * capacity_factor) of the tokens
  routed to it, in token order, into an ``[E, C, d]`` buffer, runs its
  FFN on those, and the gated results are scattered back.  Tokens over
  an expert's capacity contribute zero (dropped); a factor >= E drops
  none and gives the dense result.
- :func:`moe_ffn_sharded`, the reference's ``shard_map`` body over a
  port :class:`~cekirdekler_tpu_torch.parallel.Mesh`: one shard of E/ep
  experts per position of the axis, x and the router replicated, the
  shards' f32 outputs combined by ``parallel.collectives.psum``.  On a
  mesh of virtual shards of one device the shards run one after another.

The expert products are ``torch.einsum`` in the activation dtype, as the
reference computes them with XLA outside any Pallas kernel; the GELU is
the tanh form (``jax.nn.gelu``'s default).  Argmax routing takes the first
of tied experts, as ``jnp.argmax`` does, and is not differentiable in
either package: gradients reach the router through the gate only.

:func:`record_routing` opens a :class:`RoutingLog` of the calls made
while it is open (each call's expert per token and which tokens were
kept), which the workload runners turn into per-expert token counts and
dropped tokens.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch
import torch.nn.functional as F

from ..parallel.collectives import psum
from ..parallel.mesh import Mesh

__all__ = ["moe_ffn", "moe_ffn_capacity", "moe_ffn_sharded", "capacity",
           "RoutingLog", "record_routing", "quiet_routing"]


class RoutingLog:
    """The routing of the experts calls made while the log is open: per
    call, the expert index of every token, which tokens were kept (all of
    them in the dense form), the expert count and the capacity (None in
    the dense form).  The tensors stay where the call ran; nothing is
    read back until :meth:`counts` or :meth:`summary`."""

    def __init__(self) -> None:
        self.calls: list[tuple[torch.Tensor, torch.Tensor, int, int | None]] = []

    def counts(self) -> list[dict]:
        """Per call: tokens routed to each expert, tokens kept by each, and
        the capacity."""
        out = []
        for idx, keep, n_experts, cap in self.calls:
            routed = torch.bincount(idx, minlength=n_experts)
            kept = torch.bincount(idx[keep], minlength=n_experts)
            out.append({"routed": routed.tolist(), "kept": kept.tolist(), "capacity": cap})
        return out

    def summary(self) -> dict:
        """Tokens routed to each expert and tokens dropped, summed over the
        calls (a token counts once in each experts layer it passes)."""
        per_call = self.counts()
        if not per_call:
            return {"tokens_per_expert": [], "dropped_tokens": 0, "calls": 0}
        routed = [sum(col) for col in zip(*(c["routed"] for c in per_call))]
        dropped = sum(sum(c["routed"]) - sum(c["kept"]) for c in per_call)
        return {"tokens_per_expert": routed, "dropped_tokens": dropped, "calls": len(per_call)}


_LOGS: list[RoutingLog] = []
_QUIET = [0]


@contextlib.contextmanager
def record_routing() -> Iterator[RoutingLog]:
    """Log the routing of every experts call made inside the block."""
    log = RoutingLog()
    _LOGS.append(log)
    try:
        yield log
    finally:
        _LOGS.remove(log)


@contextlib.contextmanager
def quiet_routing() -> Iterator[None]:
    """Leave the calls made inside the block out of every open log: a
    recompute under ``torch.utils.checkpoint`` routes the same tokens a
    second time."""
    _QUIET[0] += 1
    try:
        yield
    finally:
        _QUIET[0] -= 1


def _log(idx: torch.Tensor, keep: torch.Tensor | None, n_experts: int, cap: int | None) -> None:
    if not _LOGS or _QUIET[0]:
        return
    idx = idx.detach().reshape(-1)
    keep = torch.ones_like(idx, dtype=torch.bool) if keep is None else keep.detach()
    for log in _LOGS:
        log.calls.append((idx, keep, n_experts, cap))


def capacity(n_tokens: int, n_experts: int, capacity_factor: float) -> int:
    """Tokens each expert takes: the reference's expression as it is, so the
    float floor division decides C exactly as there."""
    return int(max(1, -(-n_tokens * capacity_factor // n_experts)))


def _route(x: torch.Tensor, router: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-1 routing: (gate weight [B, T] f32, expert index [B, T]).  The
    logits are f32; ``torch.argmax`` returns the first maximal index, as
    ``jnp.argmax`` does, so tied logits go to the lowest expert."""
    logits = x.float() @ router.float()
    gate_all = torch.softmax(logits, dim=-1)
    idx = torch.argmax(logits, dim=-1)
    g = torch.gather(gate_all, -1, idx[..., None])[..., 0]
    return g, idx


def _gelu(h: torch.Tensor) -> torch.Tensor:
    return F.gelu(h, approximate="tanh")


def _dense(x: torch.Tensor, router: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
           e0: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Experts ``e0 .. e0 + len(w1) - 1`` on every token: (f32 output
    [B, T, d], expert index [B, T])."""
    dt = x.dtype
    g, idx = _route(x, router)
    h = _gelu(torch.einsum("btd,edf->ebtf", x, w1.to(dt)))
    o = torch.einsum("ebtf,efd->ebtd", h, w2.to(dt))
    local_e = torch.arange(w1.shape[0], device=x.device) + e0
    sel = (idx[None, :, :] == local_e[:, None, None]).float()
    y = torch.sum(o.float() * (sel * g[None])[..., None], dim=0)
    return y, idx


def _capacity(x: torch.Tensor, router: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
              e0: int, n_experts: int, capacity_factor: float
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]:
    """Experts ``e0 .. e0 + len(w1) - 1`` on the tokens they keep: (f32
    output [B, T, d], expert index [N], kept [N], capacity)."""
    dt = x.dtype
    B, T, d = x.shape
    El = w1.shape[0]
    N = B * T
    C = capacity(N, n_experts, capacity_factor)
    dev = x.device

    g, idx = _route(x, router)
    xf = x.reshape(N, d)
    gf = g.reshape(N)
    idxf = idx.reshape(N)

    # each token's place in its expert's queue (0-based), over the global
    # expert ids so that every shard assigns the same slots; the scan runs
    # along the tokens as the last dimension, [E, N]
    oh = F.one_hot(idxf, n_experts).T.contiguous()
    pos_t = (torch.cumsum(oh, dim=1) * oh - oh).sum(dim=0)
    keep = pos_t < C

    # tokens of other shards' experts and tokens over capacity go to the pad
    # slot El*C, which is sliced off
    local_e = idxf - e0
    mine = (local_e >= 0) & (local_e < El) & keep
    slot = torch.where(mine, local_e * C + pos_t, torch.full_like(pos_t, El * C))

    # dispatch[e*C + c] = the token in that slot (N: empty, reads the zero row)
    dispatch = torch.full((El * C + 1,), N, dtype=torch.long, device=dev)
    dispatch.index_put_((slot,), torch.arange(N, device=dev))
    dispatch = dispatch[: El * C]

    # index_select, whose backward is index_add: the empty slots all read the
    # pad row, and the sorting backward of advanced indexing serializes them
    xpad = torch.cat([xf, xf.new_zeros(1, d)])
    xe = torch.index_select(xpad, 0, dispatch).reshape(El, C, d)
    h = _gelu(torch.einsum("ecd,edf->ecf", xe, w1.to(dt)))
    o = torch.einsum("ecf,efd->ecd", h, w2.to(dt))

    # combine in f32: every real row is the target of at most one slot (top-1
    # routing), so the atomics of index_add on the card (here and in the
    # gathers' backward) add a row's one term to zero and cannot reorder a
    # sum; empty slots all add into the pad row, which is sliced off
    gpad = torch.cat([gf, gf.new_zeros(1)])
    oflat = o.reshape(El * C, d).float() * torch.index_select(gpad, 0, dispatch)[:, None]
    y = torch.zeros(N + 1, d, dtype=torch.float32, device=dev).index_add(0, dispatch, oflat)[:N]
    return y.reshape(B, T, d), idxf, keep, C


def moe_ffn(x: torch.Tensor, router: torch.Tensor, w1: torch.Tensor,
            w2: torch.Tensor) -> torch.Tensor:
    """Top-1 routed expert FFN, dense compute-all form: x [B, T, d], router
    [d, E], w1 [E, d, f], w2 [E, f, d] -> [B, T, d] in x's dtype."""
    y, idx = _dense(x, router, w1, w2, 0)
    _log(idx, None, w1.shape[0], None)
    return y.to(x.dtype)


def moe_ffn_capacity(x: torch.Tensor, router: torch.Tensor, w1: torch.Tensor,
                     w2: torch.Tensor, capacity_factor: float = 2.0) -> torch.Tensor:
    """Top-1 routed expert FFN, capacity dispatch: :func:`moe_ffn`'s
    operands and result, each expert taking at most
    ``capacity(B*T, E, capacity_factor)`` tokens in token order and
    dropping the rest.  Differentiable through the gate and the experts'
    products."""
    y, idx, keep, C = _capacity(x, router, w1, w2, 0, w1.shape[0], capacity_factor)
    _log(idx, keep, w1.shape[0], C)
    return y.to(x.dtype)


def moe_ffn_sharded(mesh: Mesh, x: torch.Tensor, router: torch.Tensor, w1: torch.Tensor,
                    w2: torch.Tensor, axis: str = "ep",
                    capacity_factor: float = 0.0) -> torch.Tensor:
    """The experts over ``axis`` of ``mesh``: w1/w2 are the global
    [E, d, f]/[E, f, d], split on dim 0 into one shard of E/n per position
    (n the axis' size); x and the router go whole to every position.  Each
    position computes its experts (capacity dispatch when
    ``capacity_factor > 0``, else dense compute-all) in f32, the outputs are
    summed over the axis by ``psum``, and the sum comes back on x's device
    in x's dtype."""
    devs = mesh.axis_devices(axis)
    n, E = len(devs), w1.shape[0]
    if E % n:
        raise ValueError(f"{E} experts do not split over {n} positions of {axis!r}")
    El = E // n
    ys = []
    for i, dev in enumerate(devs):
        a, b = w1[i * El:(i + 1) * El].to(dev), w2[i * El:(i + 1) * El].to(dev)
        xx, r = x.to(dev), router.to(dev)
        if capacity_factor > 0:
            y, idx, keep, C = _capacity(xx, r, a, b, i * El, E, capacity_factor)
        else:
            (y, idx), keep, C = _dense(xx, r, a, b, i * El), None, None
        if i == 0:  # every position routes every token alike
            _log(idx, keep, E, C)
        ys.append(y)
    return psum(ys)[0].to(x.device).to(x.dtype)
