"""Attention over one device and over a sequence-parallel mesh axis.

Counterpart of ``cekirdekler_tpu/parallel/attention.py``:

- ``attention_reference``: dense single-device attention, the dense path
  of the transformer and the fallback behind ``flash_attention``'s
  default-argument calls;
- ``ring_attention``: K/V shards rotate around the ring (``ppermute_ring``)
  while each position accumulates its queries' attention with a running
  softmax, either by einsums (``_ring_attention_einsum``) or, with
  ``flash=True``, through ``flash_attention_parts`` per step, with a
  backward that runs ``flash_attention_bwd_parts`` per step
  (:class:`_RingFlashAttention`);
- ``ulysses_attention``: ``all_to_all`` re-shards sequence to heads, each
  position attends over the whole sequence for H/n heads, and a second
  ``all_to_all`` shards it back;
- ``ring_attention_sharded`` and ``ulysses_attention_sharded``, which split
  a global [B, T, H, D] along T over a mesh axis.

The inner functions take the shard lists of the axis (``parallel/
collectives.py``), where the reference's run inside ``shard_map``; on a
mesh of virtual shards of one card each step's work runs one position
after another on that card.
"""

from __future__ import annotations

import math

import torch

from .collectives import Shards, all_to_all, ppermute_ring
from .mesh import Mesh

__all__ = [
    "attention_reference",
    "ring_attention",
    "ulysses_attention",
    "ring_attention_sharded",
    "ulysses_attention_sharded",
]

_PRECISIONS = (None, "highest", "default")


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = False, precision: str | None = None) -> torch.Tensor:
    """Dense attention with an f32 softmax.

    Shapes: q [B, Tq, H, D], k/v [B, Tk, H, D] -> [B, Tq, H, D] in q's dtype.
    ``scale`` multiplies q in f32 before the product; under ``causal`` the
    last query aligns with the last key (``qpos = arange(Tq) + Tk - Tq``)
    and masked scores are ``-inf``.

    The products are true f32 for every ``precision``: ``None`` and
    ``"highest"`` ask for it, and ``"default"`` (the reference's
    ``Precision.DEFAULT``, which the flash path's fallback passes) is
    computed the same way, as XLA computes it on the CPU.  That needs
    TF32 off on the card, PyTorch's default for matrix products.
    """
    if precision not in _PRECISIONS:
        raise ValueError(f"attention_reference precision must be one of {_PRECISIONS}, "
                         f"got {precision!r}")
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, k.float())
    if causal:
        Tq, Tk = q.shape[1], k.shape[1]
        qpos = torch.arange(Tq, device=q.device) + (Tk - Tq)
        mask = torch.arange(Tk, device=q.device)[None, :] <= qpos[:, None]
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return o.to(q.dtype)


def _block_accumulate(o: torch.Tensor, m: torch.Tensor, l: torch.Tensor, s: torch.Tensor,
                      v_blk: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One stable-softmax accumulation step.

    o [B,H,Tq,D] f32 accumulator, m/l [B,H,Tq] running max/denominator,
    s [B,H,Tq,Tk] masked scores (``-inf`` allowed), v_blk [B,Tk,H,D]."""
    m_new = torch.maximum(m, s.amax(dim=-1))
    m_safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
    p = torch.exp(s - m_safe[..., None])
    p = torch.where(torch.isneginf(s), 0.0, p)
    alpha = torch.where(torch.isneginf(m), 0.0, torch.exp(m - m_safe))
    o_new = alpha[..., None] * o + torch.einsum("bhqk,bkhd->bhqd", p, v_blk.float())
    l_new = alpha * l + p.sum(dim=-1)
    return o_new, m_new, l_new


def _check_shards(qs: Shards, ks: Shards, vs: Shards) -> int:
    n = len(qs)
    if n == 0 or len(ks) != n or len(vs) != n:
        raise ValueError(f"ring/Ulysses attention needs one q, k and v shard per position, "
                         f"got {len(qs)}/{len(ks)}/{len(vs)}")
    return n


def ring_attention(qs: Shards, ks: Shards, vs: Shards, causal: bool = False,
                   flash: bool = False) -> list[torch.Tensor]:
    """Ring attention over the axis the shards are laid on: position ``r``
    holds q/k/v [B, T/n, H, D] of positions ``[r*T/n, (r+1)*T/n)``, and
    gets its queries' output, [B, T/n, H, D] in q's dtype, on its device.

    ``flash=True`` runs each step through ``flash_attention_parts`` and
    merges the unnormalized states, where ``auto_block`` tiles both shard
    lengths; otherwise (and where it does not) the einsum ring runs, as in
    the reference.  The flash ring is differentiable through
    :class:`_RingFlashAttention`; the einsum ring through plain autograd."""
    from ..ops.flash_attention import auto_block

    _check_shards(qs, ks, vs)
    if flash and auto_block(qs[0].shape[1]) is not None \
            and auto_block(ks[0].shape[1]) is not None:
        return list(_RingFlashAttention.apply(causal, *qs, *ks, *vs))
    return _ring_attention_einsum(qs, ks, vs, causal)


def _ring_attention_einsum(qs: Shards, ks: Shards, vs: Shards,
                           causal: bool) -> list[torch.Tensor]:
    """The einsum ring: true-f32 scores per step with ``-inf`` masking and
    the ``isneginf`` guards of :func:`_block_accumulate`."""
    n = len(qs)
    B, Tq, H, D = qs[0].shape
    Tb = ks[0].shape[1]
    scale = 1.0 / math.sqrt(D)
    qf = [q.float() * scale for q in qs]
    o = [torch.zeros((B, H, Tq, D), dtype=torch.float32, device=q.device) for q in qs]
    m = [torch.full((B, H, Tq), float("-inf"), device=q.device) for q in qs]
    l = [torch.zeros((B, H, Tq), dtype=torch.float32, device=q.device) for q in qs]
    kc, vc = list(ks), list(vs)
    for i in range(n):
        for r in range(n):
            src = (r - i) % n  # ring position the current K/V block came from
            s = torch.einsum("bqhd,bkhd->bhqk", qf[r], kc[r].float())
            if causal:
                qpos = r * Tq + torch.arange(Tq, device=s.device)
                kpos = src * Tb + torch.arange(Tb, device=s.device)
                s = s.masked_fill(~(kpos[None, :] <= qpos[:, None]), float("-inf"))
            o[r], m[r], l[r] = _block_accumulate(o[r], m[r], l[r], s, vc[r])
        kc, vc = ppermute_ring(kc, 1), ppermute_ring(vc, 1)
    return [(o_r / torch.clamp_min(l_r, 1e-30)[..., None]).permute(0, 2, 1, 3).to(q.dtype)
            for o_r, l_r, q in zip(o, l, qs)]


def _ring_flash_fwd_impl(qs: Shards, ks: Shards, vs: Shards, causal: bool
                         ) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
    """The flash ring's forward: at step ``i`` position ``r`` holds the
    K/V block of position ``src = (r - i) % n`` and runs the parts kernel
    with that block's global offset, then merges with the stable-softmax
    combine (finite ``-1e30`` initial max), steps in order.  Returns
    ``(out, lse)`` per position: out in q's dtype, and the ring-global
    logsumexp [B, Tq, H] f32, the backward's residual."""
    from ..ops.flash_attention import auto_block, flash_attention_parts

    n = len(qs)
    B, Tq, H, D = qs[0].shape
    Tb = ks[0].shape[1]
    bq, bk = auto_block(Tq), auto_block(Tb)
    o = [torch.zeros((B, Tq, H, D), dtype=torch.float32, device=q.device) for q in qs]
    m = [torch.full((B, Tq, H), -1e30, dtype=torch.float32, device=q.device) for q in qs]
    l = [torch.zeros((B, Tq, H), dtype=torch.float32, device=q.device) for q in qs]
    kc, vc = list(ks), list(vs)
    for i in range(n):
        for r in range(n):
            src = (r - i) % n
            acc, ms, ls = flash_attention_parts(qs[r], kc[r], vc[r], r * Tq, src * Tb, causal,
                                                bq, bk)
            m_new = torch.maximum(m[r], ms)
            a1 = torch.exp(m[r] - m_new)
            a2 = torch.exp(ms - m_new)
            o[r] = o[r] * a1[..., None] + acc * a2[..., None]
            l[r] = l[r] * a1 + ls * a2
            m[r] = m_new
        kc, vc = ppermute_ring(kc, 1), ppermute_ring(vc, 1)
    lc = [torch.clamp_min(l_r, 1e-30) for l_r in l]
    out = [(o_r / lc_r[..., None]).to(q.dtype) for o_r, lc_r, q in zip(o, lc, qs)]
    lse = [m_r + torch.log(lc_r) for m_r, lc_r in zip(m, lc)]
    return out, lse


def _ring_flash_bwd_impl(qs: Shards, ks: Shards, vs: Shards, outs: Shards, lses: Shards,
                         dos: Shards, causal: bool
                         ) -> tuple[list[torch.Tensor], list[torch.Tensor], list[torch.Tensor]]:
    """The flash ring's backward: per step the backward parts kernels run
    off the ring-global lse and ``delta = rowsum(dO * O)`` (f32, from the
    output in q's dtype).  dq sums its partials locally in step order; the
    f32 dk/dv accumulators rotate with their K/V blocks, so block ``j``'s
    gradient sums positions ``j, j+1, ..., j+n-1`` in that order and is
    home after ``n`` steps.  One cast to the primal dtypes at the end."""
    from ..ops.flash_attention import auto_block, flash_attention_bwd_parts

    n = len(qs)
    Tq, Tb = qs[0].shape[1], ks[0].shape[1]
    bq, bk = auto_block(Tq), auto_block(Tb)
    delta = [(do.float() * out.float()).sum(dim=-1) for do, out in zip(dos, outs)]
    dq = [torch.zeros(q.shape, dtype=torch.float32, device=q.device) for q in qs]
    dkc = [torch.zeros(k.shape, dtype=torch.float32, device=k.device) for k in ks]
    dvc = [torch.zeros(v.shape, dtype=torch.float32, device=v.device) for v in vs]
    kc, vc = list(ks), list(vs)
    for i in range(n):
        for r in range(n):
            src = (r - i) % n
            dq_i, dk_i, dv_i = flash_attention_bwd_parts(
                qs[r], kc[r], vc[r], dos[r], lses[r], delta[r], r * Tq, src * Tb, causal,
                bq, bk)
            dq[r] = dq[r] + dq_i
            dkc[r] = dkc[r] + dk_i
            dvc[r] = dvc[r] + dv_i
        kc, vc = ppermute_ring(kc, 1), ppermute_ring(vc, 1)
        dkc, dvc = ppermute_ring(dkc, 1), ppermute_ring(dvc, 1)
    return ([g.to(q.dtype) for g, q in zip(dq, qs)], [g.to(k.dtype) for g, k in zip(dkc, ks)],
            [g.to(v.dtype) for g, v in zip(dvc, vs)])


class _RingFlashAttention(torch.autograd.Function):
    """The flash ring with its backward: the reference's
    ``_ring_attention_flash`` custom_vjp (``_raf_fwd`` / ``_raf_bwd``).
    Takes ``causal`` and the q, k and v shards of every position (n each);
    returns the n output shards.  It saves what ``_raf_fwd`` saves, per
    shard on its device (q, k, v, out, lse), and returns each gradient on
    its shard's device.  The cotangents come in whatever layout the loss
    gives them, so each is made contiguous for the kernels."""

    @staticmethod
    def forward(ctx, causal, *qkv):
        n = len(qkv) // 3
        qs, ks, vs = qkv[:n], qkv[n:2 * n], qkv[2 * n:]
        outs, lses = _ring_flash_fwd_impl(qs, ks, vs, causal)
        ctx.save_for_backward(*qs, *ks, *vs, *outs, *lses)
        ctx.causal = causal
        return tuple(outs)

    @staticmethod
    def backward(ctx, *dos):
        n = len(dos)
        saved = ctx.saved_tensors
        qs, ks, vs, outs, lses = (saved[j * n:(j + 1) * n] for j in range(5))
        dq, dk, dv = _ring_flash_bwd_impl(qs, ks, vs, outs, lses,
                                          [d.contiguous() for d in dos], ctx.causal)
        return (None, *dq, *dk, *dv)


def ulysses_attention(qs: Shards, ks: Shards, vs: Shards, causal: bool = False,
                      flash: bool = False) -> list[torch.Tensor]:
    """Ulysses (all-to-all) sequence parallelism over the shards' axis:
    position ``r`` holds [B, T/n, H, D] with ``H % n == 0`` and gets its
    queries' output.  After the all-to-all each position holds the whole
    sequence of H/n heads, an ordinary aligned attention problem:
    ``flash=True`` runs it through ``flash_attention`` with ``auto_block``
    blocks, and through dense attention where ``auto_block`` gives None,
    as the reference does."""
    from ..ops.flash_attention import auto_block, flash_attention

    _check_shards(qs, ks, vs)
    q2, k2, v2 = (all_to_all(t, split_axis=2, concat_axis=1) for t in (qs, ks, vs))
    blk = auto_block(q2[0].shape[1]) if flash else None
    if blk is not None:
        o2 = [flash_attention(q, k, v, causal, blk, blk) for q, k, v in zip(q2, k2, v2)]
    else:
        o2 = [attention_reference(q, k, v, causal=causal) for q, k, v in zip(q2, k2, v2)]
    return all_to_all(o2, split_axis=1, concat_axis=2)


def _split_sequence(mesh: Mesh, axis: str, *ts: torch.Tensor) -> list[list[torch.Tensor]]:
    """Each [B, T, H, D] cut along T into one shard per position of
    ``axis``, each on its position's device.  The reference's specs
    ``P(None, axis, None, None)`` replicate over the other axes, so one
    computation per position of ``axis`` gives its values."""
    devs = mesh.axis_devices(axis)
    n = len(devs)
    out = []
    for t in ts:
        if t.shape[1] % n:
            raise ValueError(f"sequence length {t.shape[1]} does not split over the "
                             f"{n} positions of mesh axis {axis!r}")
        out.append([p.to(d) for p, d in zip(t.split(t.shape[1] // n, dim=1), devs)])
    return out


def ring_attention_sharded(mesh: Mesh, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                           axis: str = "sp", causal: bool = False,
                           flash: bool = False) -> torch.Tensor:
    """:func:`ring_attention` over a mesh axis: q/k/v are global
    [B, T, H, D], split along T over ``axis``; the output is gathered onto
    q's device.  Differentiable."""
    qs, ks, vs = _split_sequence(mesh, axis, q, k, v)
    outs = ring_attention(qs, ks, vs, causal=causal, flash=flash)
    return torch.cat([o.to(q.device) for o in outs], dim=1)


def ulysses_attention_sharded(mesh: Mesh, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                              axis: str = "sp", causal: bool = False,
                              flash: bool = False) -> torch.Tensor:
    """:func:`ulysses_attention` over a mesh axis, split and gathered as
    :func:`ring_attention_sharded` does.  Differentiable."""
    qs, ks, vs = _split_sequence(mesh, axis, q, k, v)
    outs = ulysses_attention(qs, ks, vs, causal=causal, flash=flash)
    return torch.cat([o.to(q.device) for o in outs], dim=1)
