"""Dense single-device attention.

Counterpart of ``cekirdekler_tpu/parallel/attention.py::attention_reference``:
the dense path of the transformer and the dense fallback behind
``flash_attention``'s default-argument calls.  The ring and Ulysses forms
of that module need a sequence-parallel mesh of several cards and are not
ported yet (ROADMAP Queue A, attention stack).
"""

from __future__ import annotations

import math

import torch

__all__ = ["attention_reference"]

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
