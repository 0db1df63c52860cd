"""Parallelism tier: meshes, collectives and long-context attention.

Counterpart of ``cekirdekler_tpu/parallel/``, under the reference's
names.  A mesh is a list of torch devices over the six named axes (a
device may repeat: virtual shards); the collectives and the ring and
Ulysses attention take the shard lists of one axis.
"""

from .attention import (
    attention_reference,
    ring_attention,
    ring_attention_sharded,
    ulysses_attention,
    ulysses_attention_sharded,
)
from .collectives import (
    all_gather,
    all_to_all,
    axis_size,
    pmax,
    pmean,
    ppermute_ring,
    psum,
    reduce_scatter,
    ring_next,
    ring_prev,
)
from .mesh import AXIS_NAMES, Mesh, auto_mesh, make_mesh

__all__ = [
    "AXIS_NAMES",
    "Mesh",
    "all_gather",
    "all_to_all",
    "attention_reference",
    "auto_mesh",
    "axis_size",
    "make_mesh",
    "pmax",
    "pmean",
    "ppermute_ring",
    "psum",
    "reduce_scatter",
    "ring_attention",
    "ring_attention_sharded",
    "ring_next",
    "ring_prev",
    "ulysses_attention",
    "ulysses_attention_sharded",
]
