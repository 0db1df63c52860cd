"""Device meshes over the framework's six named axes.

Counterpart of ``cekirdekler_tpu/parallel/mesh.py``: :data:`AXIS_NAMES`,
:func:`make_mesh` and :func:`auto_mesh`.  A :class:`Mesh` is an ndarray of
``torch.device`` laid out over the axes, with ``.shape`` a dict of axis
sizes and ``.axis_names``, as ``jax.sharding.Mesh`` has them.

JAX drives a mesh from one controller: one process, one device array.
The port does the same: a mesh is a list of devices, and the functions
over a mesh axis (``parallel/collectives.py``, ``parallel/attention.py``)
take one shard per position of the axis and run each on its position's
device.  A device may appear more than once.  That is the counterpart of
the CPU rig's virtual devices (``--xla_force_host_platform_device_count``):
``make_mesh([torch.device("cuda", 0)] * 8, sp=8)`` is an ``sp`` axis of
eight virtual shards on one card, whose work runs one shard after
another on that card, and ``[torch.device("cpu")] * 4`` runs the plain
versions on the host.

The GSPMD helpers (``named_sharding``, ``shard_batch``, ``replicated``,
``constrain``, ``set_mesh``, ``shard_map``) wait for the transformer's
mesh paths (ROADMAP Queue A 9).
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from ..errors import DeviceSelectionError

__all__ = ["AXIS_NAMES", "Mesh", "make_mesh", "auto_mesh"]

AXIS_NAMES = ("dp", "fsdp", "pp", "tp", "sp", "ep")


class Mesh:
    """Devices over named axes: ``devices`` is an object ndarray of
    ``torch.device`` whose dimensions are ``axis_names`` in order."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str] = AXIS_NAMES):
        if devices.ndim != len(axis_names):
            raise ValueError(f"a mesh of {devices.ndim} dimensions cannot take the axes "
                             f"{tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def axis_devices(self, axis: str) -> list[torch.device]:
        """The devices at positions 0..n-1 of ``axis``, every other axis at
        position 0: where one computation per position of ``axis`` runs when
        the operands are replicated over the others."""
        if axis not in self.axis_names:
            raise ValueError(f"unknown mesh axis {axis!r}; the axes are {self.axis_names}")
        index = [0] * len(self.axis_names)
        index[self.axis_names.index(axis)] = slice(None)
        return list(self.devices[tuple(index)])


def _default_devices() -> list[torch.device]:
    """Every CUDA device; raises where there is none (no CPU fallback)."""
    if not torch.cuda.is_available() or torch.cuda.device_count() == 0:
        raise DeviceSelectionError(
            "make_mesh: no CUDA device; pass devices=[torch.device('cpu')] * n for a mesh "
            "of host shards running the plain versions")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(devices: Sequence[torch.device | str] | None = None, *, dp: int = 1,
              fsdp: int = 1, pp: int = 1, tp: int = 1, sp: int = 1, ep: int = 1) -> Mesh:
    """A mesh in the framework's axis order.  The axis sizes must multiply
    to the device count; axes of size 1 are kept.  ``devices=None`` means
    every CUDA device, and raises :class:`DeviceSelectionError` where there
    is none.  A device may be named more than once (virtual shards)."""
    devs = _default_devices() if devices is None else [torch.device(d) for d in devices]
    sizes = {"dp": dp, "fsdp": fsdp, "pp": pp, "tp": tp, "sp": sp, "ep": ep}
    total = math.prod(sizes.values())
    if total != len(devs):
        raise ValueError(
            f"mesh axes {sizes} multiply to {total} but {len(devs)} devices given")
    arr = np.empty(len(devs), dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(tuple(sizes[a] for a in AXIS_NAMES)))


def auto_mesh(devices: Sequence[torch.device | str] | None = None, *, fsdp: int = 1,
              pp: int = 1, tp: int = 1, sp: int = 1, ep: int = 1) -> Mesh:
    """Like :func:`make_mesh`, but ``dp`` takes whatever device count the
    fixed axes leave over."""
    devs = _default_devices() if devices is None else list(devices)
    fixed = fsdp * pp * tp * sp * ep
    if len(devs) % fixed != 0:
        raise ValueError(
            f"device count {len(devs)} not divisible by fixed axes product {fixed}")
    return make_mesh(devs, dp=len(devs) // fixed, fsdp=fsdp, pp=pp, tp=tp, sp=sp, ep=ep)
