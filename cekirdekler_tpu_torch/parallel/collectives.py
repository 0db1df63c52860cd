"""Collectives over a mesh axis, in list form.

Counterpart of ``cekirdekler_tpu/parallel/collectives.py``.  There each
wrapper runs inside ``shard_map`` on the shard of a named axis.  Here a
value over the axis is the list of its shards in axis order, each on its
position's device (``Mesh.axis_devices``), and each wrapper returns the
list of the result's shards, each on its position's device.  A move to
the device a tensor is already on is no copy, so on a mesh of virtual
shards of one device the ring rotation moves nothing.  Results may share
storage between positions (``psum`` gives every position the same sum on
a virtual mesh): update them out of place.
"""

from __future__ import annotations

from typing import Sequence

import torch

__all__ = [
    "psum",
    "pmean",
    "pmax",
    "all_gather",
    "reduce_scatter",
    "ppermute_ring",
    "all_to_all",
    "axis_size",
    "ring_next",
    "ring_prev",
]

Shards = Sequence[torch.Tensor]


def axis_size(xs: Shards) -> int:
    """The number of positions of the axis ``xs`` is sharded over."""
    return len(xs)


def _spread(x: torch.Tensor, xs: Shards) -> list[torch.Tensor]:
    return [x.to(s.device) for s in xs]


def _reduce(xs: Shards, op) -> torch.Tensor:
    """``op`` over the shards in axis order, on position 0's device."""
    out = xs[0]
    for x in xs[1:]:
        out = op(out, x.to(out.device))
    return out


def psum(xs: Shards) -> list[torch.Tensor]:
    return _spread(_reduce(xs, torch.add), xs)


def pmean(xs: Shards) -> list[torch.Tensor]:
    return _spread(_reduce(xs, torch.add) / len(xs), xs)


def pmax(xs: Shards) -> list[torch.Tensor]:
    return _spread(_reduce(xs, torch.maximum), xs)


def _chunks(x: torch.Tensor, n: int, dim: int, tiled: bool) -> tuple[torch.Tensor, ...]:
    """``x`` cut into ``n`` pieces along ``dim``: equal slices when
    ``tiled``, else the ``n`` entries of a dimension of size ``n``."""
    if tiled:
        if x.shape[dim] % n:
            raise ValueError(f"dimension {dim} of size {x.shape[dim]} does not split "
                             f"into {n} shards")
        return x.split(x.shape[dim] // n, dim=dim)
    if x.shape[dim] != n:
        raise ValueError(f"dimension {dim} has size {x.shape[dim]}, not the axis size {n}")
    return x.unbind(dim)


def all_gather(xs: Shards, *, gather_axis: int = 0, tiled: bool = True) -> list[torch.Tensor]:
    """Every position gets the shards concatenated (``tiled``) or stacked
    along ``gather_axis``."""
    dev = xs[0].device
    parts = [x.to(dev) for x in xs]
    out = torch.cat(parts, dim=gather_axis) if tiled else torch.stack(parts, dim=gather_axis)
    return _spread(out, xs)


def reduce_scatter(xs: Shards, *, scatter_axis: int = 0,
                   tiled: bool = True) -> list[torch.Tensor]:
    """The sum over positions, cut along ``scatter_axis``: position ``i``
    gets piece ``i``."""
    pieces = _chunks(_reduce(xs, torch.add), len(xs), scatter_axis, tiled)
    return [p.to(x.device) for p, x in zip(pieces, xs)]


def ppermute_ring(xs: Shards, shift: int = 1) -> list[torch.Tensor]:
    """Rotate shards around the ring by ``shift`` positions: the shard at
    position ``i`` moves to position ``(i + shift) % n`` and its device."""
    n = len(xs)
    out: list[torch.Tensor] = [None] * n  # type: ignore[list-item]
    for i, x in enumerate(xs):
        j = (i + shift) % n
        out[j] = x.to(xs[j].device)
    return out


def ring_next(xs: Shards) -> list[torch.Tensor]:
    return ppermute_ring(xs, 1)


def ring_prev(xs: Shards) -> list[torch.Tensor]:
    return ppermute_ring(xs, -1)


def all_to_all(xs: Shards, *, split_axis: int, concat_axis: int,
               tiled: bool = True) -> list[torch.Tensor]:
    """Transpose shard ownership between two dimensions (the Ulysses
    sequence <-> head exchange): each shard is cut into ``n`` pieces along
    ``split_axis``, and position ``j`` gets piece ``j`` of every shard,
    concatenated (``tiled``) or stacked along ``concat_axis`` in axis
    order."""
    n = len(xs)
    pieces = [_chunks(x, n, split_axis, tiled) for x in xs]
    join = torch.cat if tiled else torch.stack
    return [join([p[j].to(x.device) for p in pieces], dim=concat_axis)
            for j, x in enumerate(xs)]
