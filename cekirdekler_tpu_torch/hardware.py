"""Hardware query DSL over ``torch.cuda`` — device discovery and fluent
selection.

Counterpart of ``cekirdekler_tpu/hardware.py``.  Lanes are CUDA devices
(``torch.device("cuda", i)``) and, only when selected explicitly, host-CPU
lanes: ``cpus(n)`` makes ``n`` virtual ``torch.device("cpu")`` lanes, like
the reference's forced host device count.  ``all_devices()`` lists the
CUDA devices; on a machine without one it is empty, so a selection that
needs an accelerator raises :class:`DeviceSelectionError` instead of
carrying on quietly on the CPU.

``rate_prior``, ``device_rank`` and ``device_peaks`` read ONE table, as in
the reference: kinds are the names ``torch.cuda.get_device_name()``
reports.  An unknown CUDA kind falls back to the H100 row, named as the
fallback in the resolved kind.

The reference's selectors are kept under their names (``accelerators``,
``with_dedicated_memory``, ``with_host_memory_sharing``,
``with_most_compute_units``, ``with_highest_memory_available``,
``with_highest_nbody_performance``, ``Platforms.with_most_devices``), as
are its partitions (``Device.as_partitions``: scheduler lanes of one
device, each with its own ``Worker``, buffers and CUDA stream).  Its
TPU-only names map to the GPU names: ``Devices.tpus`` / ``gpus`` (both
kept), ``Device.is_tpu`` -> ``Device.is_gpu``, ``Platform.num_tpus`` ->
``Platform.num_gpus``.
"""

from __future__ import annotations

import dataclasses
import enum
import itertools
from dataclasses import dataclass
from typing import Iterable, Iterator, Sequence

import torch

from .errors import DeviceSelectionError

__all__ = [
    "AcceleratorType",
    "Device",
    "Devices",
    "Platform",
    "Platforms",
    "platforms",
    "all_devices",
    "cpus",
    "devices_for_type",
    "DEVICE_PEAKS",
    "device_peaks",
    "HOST_PEAKS",
    "RATE_PRIORS",
    "rate_prior",
    "device_rank",
]

#: Device kind -> (dense bf16 tensor-core TFLOP/s, HBM GB/s), from
#: NVIDIA's H100 data sheet, keyed on ``torch.cuda.get_device_name()``.
DEVICE_PEAKS: dict[str, tuple[float, float]] = {
    "NVIDIA H100 80GB HBM3": (989.0, 3350.0),
}

#: The fallback kind for CUDA devices the table does not know.
DEFAULT_PEAK_KIND = "NVIDIA H100 80GB HBM3"

#: Host-CPU peaks in the same shape: a few DDR channels' streaming
#: bandwidth, the anchor every accelerator prior is expressed against.
HOST_PEAKS: dict[str, tuple[float, float]] = {
    "cpu": (1.0, 50.0),
    "host": (1.0, 50.0),
}

HOST_PRIOR_KIND = "cpu"

#: Device kind -> relative throughput prior for bandwidth-bound work,
#: host CPU == 1.0, derived from the same table as :func:`device_peaks`.
RATE_PRIORS: dict[str, float] = {
    kind: round(gb / HOST_PEAKS["cpu"][1], 3)
    for kind, (_tf, gb) in {**DEVICE_PEAKS, **HOST_PEAKS}.items()
}


def rate_prior(device_kind: str) -> float:
    """Relative throughput prior for one device kind (host CPU == 1.0);
    CPU/host-flavored unknown kinds anchor at the host prior, any other
    unknown kind at :data:`DEFAULT_PEAK_KIND`'s."""
    kind = str(device_kind)
    if kind in RATE_PRIORS:
        return RATE_PRIORS[kind]
    low = kind.lower()
    if "cpu" in low or "host" in low:
        return RATE_PRIORS[HOST_PRIOR_KIND]
    return RATE_PRIORS[DEFAULT_PEAK_KIND]


def device_rank(device_kind: str) -> int:
    """Rank of a device kind by descending prior (0 == fastest band)."""
    p = rate_prior(device_kind)
    return sum(1 for v in set(RATE_PRIORS.values()) if v > p)


def device_peaks(device_kind: str | None = None) -> tuple[float, float, str]:
    """``(peak_tflops, peak_gbps, resolved_kind)``; ``None`` resolves the
    first CUDA device.  Unknown kinds resolve to the H100 row, named
    ``"<default> (fallback for X)"`` so a wrong roof is visibly wrong."""
    kind = device_kind
    if kind is None:
        kind = torch.cuda.get_device_name(0) if torch.cuda.is_available() else "unknown"
    if kind in DEVICE_PEAKS:
        tf, gb = DEVICE_PEAKS[kind]
        return tf, gb, kind
    if kind in HOST_PEAKS:
        tf, gb = HOST_PEAKS[kind]
        return tf, gb, kind
    tf, gb = DEVICE_PEAKS[DEFAULT_PEAK_KIND]
    return tf, gb, f"{DEFAULT_PEAK_KIND} (fallback for {kind})"


class AcceleratorType(enum.IntFlag):
    """Device-type selection flags (reference: AcceleratorType).  ``GPU``,
    ``ACC`` and ``TPU`` all select CUDA devices here; ``CPU`` selects
    host-CPU lanes (one per physical-core group; see :func:`cpus`)."""

    NONE = 0
    CPU = 1
    GPU = 2
    ACC = 4
    TPU = 8
    ALL = CPU | GPU | ACC | TPU


@dataclass(frozen=True)
class Device:
    """One lane: a CUDA device, or one virtual host-CPU lane.  A partition
    (``partition_cores`` > 0) is one of several lanes on the same device;
    its ``partition_id`` is part of its identity.  A host lane's identity
    is its ``serial``, drawn once per lane by :func:`cpus`; its
    ``lane_id`` is the number it shows, which ``+`` may renumber."""

    torch_device: torch.device
    kind: str
    lane_id: int = 0  # distinguishes virtual CPU lanes
    partition_cores: int = 0  # > 0: a lane among partitions of one device
    partition_id: int = 0
    serial: int = 0  # a host lane's process-wide identity (0: a CUDA device)

    @property
    def platform(self) -> str:
        return self.torch_device.type

    @property
    def is_gpu(self) -> bool:
        return self.torch_device.type == "cuda"

    @property
    def is_cpu(self) -> bool:
        return self.torch_device.type == "cpu"

    @property
    def name(self) -> str:
        base = f"{self.kind} #{self.torch_device.index}" if self.is_gpu else f"cpu #{self.lane_id}"
        if self.partition_cores:
            return f"{base}/p{self.partition_id}"
        return base

    @property
    def vendor(self) -> str:
        return "NVIDIA" if self.is_gpu else "host"

    @property
    def dedicated_memory(self) -> bool:
        return self.is_gpu

    @property
    def compute_units(self) -> int:
        if self.partition_cores:
            return self.partition_cores
        if self.is_gpu:
            return torch.cuda.get_device_properties(self.torch_device).multi_processor_count
        return 1

    @property
    def memory_bytes(self) -> int:
        if self.is_gpu:
            return int(torch.cuda.get_device_properties(self.torch_device).total_memory)
        return 0

    @property
    def memory_available_bytes(self) -> int:
        """Free device memory (``torch.cuda.mem_get_info``); 0 on a host
        lane, as the reference reads a device without memory stats."""
        if self.is_gpu:
            return int(torch.cuda.mem_get_info(self.torch_device)[0])
        return 0

    def copy(self) -> "Device":
        return dataclasses.replace(self)

    def as_partitions(self, num: int) -> "Devices":
        """``num`` scheduler lanes on this device (reference
        ``createDeviceAsPartition``): the balancer splits a range across
        them, and each runs on its own ``Worker`` with its own buffers and
        CUDA stream."""
        if num <= 0:
            raise ValueError("partition count must be positive")
        cores = max(1, self.compute_units // num)
        return Devices(dataclasses.replace(self, partition_cores=cores, partition_id=i)
                       for i in range(num))

    @property
    def is_partition(self) -> bool:
        return self.partition_cores > 0

    def log_info(self) -> str:
        mem = self.memory_bytes
        mem_s = f"{mem / (1 << 30):.2f} GiB" if mem else "host"
        return (f"Device: {self.name} ({self.platform}), cores={self.compute_units}, "
                f"mem={mem_s}, dedicated={self.dedicated_memory}")

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"Device({self.name!r})"


def _cuda_devices() -> list[Device]:
    if not torch.cuda.is_available():
        return []
    return [Device(torch.device("cuda", i), torch.cuda.get_device_name(i), i)
            for i in range(torch.cuda.device_count())]


_host_serials = itertools.count(1)


def cpus(n: int = 1) -> "Devices":
    """``n`` new virtual host-CPU lanes, numbered from 0, each with a
    serial of its own."""
    if n <= 0:
        raise ValueError("cpu lane count must be positive")
    return Devices(Device(torch.device("cpu"), "cpu", i, serial=next(_host_serials))
                   for i in range(n))


def _lane_key(d: Device) -> tuple:
    """What makes two entries one lane: the device, the host lane's serial
    and the partition (a renumbered ``lane_id`` does not count)."""
    return (d.torch_device, d.kind, d.serial if d.is_cpu else d.lane_id,
            d.partition_cores, d.partition_id)


class Devices(Sequence[Device]):
    """An ordered device selection; filters return new selections and
    ``+`` concatenates them (dropping exact duplicates of a lane)."""

    def __init__(self, devices: Iterable[Device] = ()):  # noqa: D107
        self._devices: list[Device] = list(devices)

    def __len__(self) -> int:
        return len(self._devices)

    def __iter__(self) -> Iterator[Device]:
        return iter(self._devices)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return Devices(self._devices[idx])
        return self._devices[idx]

    def __add__(self, other: "Devices") -> "Devices":
        out: list[Device] = []
        seen: set[tuple] = set()
        for d in list(self._devices) + list(other._devices):
            key = _lane_key(d)
            if key in seen:
                continue  # the same lane again
            seen.add(key)
            if (d.is_cpu and not d.is_partition
                    and any(o.is_cpu and o.lane_id == d.lane_id for o in out)):
                # another selection's host lane is a new lane, numbered
                # after ours; partitions are distinct lanes already and
                # keep their ids
                d = dataclasses.replace(
                    d, lane_id=1 + max(o.lane_id for o in out if o.is_cpu))
            out.append(d)
        return Devices(out)

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"Devices([{', '.join(d.name for d in self._devices)}])"

    def _filtered(self, pred) -> "Devices":
        return Devices(d for d in self._devices if pred(d))

    def gpus(self) -> "Devices":
        return self._filtered(lambda d: d.is_gpu)

    accelerators = gpus
    tpus = gpus

    def cpus(self, n: int | None = None) -> "Devices":
        """The host lanes of this selection, or — with ``n`` — ``n`` new
        virtual host-CPU lanes (the explicit CPU selection)."""
        if n is not None:
            return cpus(n)
        return Devices(d for d in self._devices if d.is_cpu)

    def with_dedicated_memory(self) -> "Devices":
        """reference: devicesWithDedicatedMemory"""
        return self._filtered(lambda d: d.dedicated_memory)

    def with_host_memory_sharing(self) -> "Devices":
        """reference: devicesWithHostMemorySharing"""
        return self._filtered(lambda d: not d.dedicated_memory)

    def with_most_compute_units(self) -> "Devices":
        """reference: devicesWithMostComputeUnits"""
        if not self._devices:
            return Devices()
        best = max(d.compute_units for d in self._devices)
        return self._filtered(lambda d: d.compute_units == best)

    def with_highest_memory_available(self) -> "Devices":
        """Every device, most free memory first (reference:
        devicesWithHighestMemoryAvailable)."""
        return Devices(sorted(self._devices, key=lambda d: d.memory_available_bytes,
                              reverse=True))

    def with_highest_nbody_performance(self, n: int = 2048, iters: int = 3) -> "Devices":
        """Every device, fastest first by ``ops.nbody.microbenchmark``
        (reference: devicesWithHighestDirectNbodyPerformance)."""
        from .ops import nbody  # local import, as the reference's

        timed = [(nbody.microbenchmark(d.torch_device, n=n, iters=iters), i, d)
                 for i, d in enumerate(self._devices)]
        timed.sort(key=lambda t: (t[0], t[1]))
        return Devices(d for _, _, d in timed)

    def subset(self, count: int) -> "Devices":
        return self[:count]

    def log_info(self) -> str:
        text = "\n".join(d.log_info() for d in self._devices) or "(no devices)"
        print(text)
        return text

    def require_nonempty(self, what: str = "selection") -> "Devices":
        if not self._devices:
            raise DeviceSelectionError(
                f"no devices matched {what} (CUDA available: "
                f"{torch.cuda.is_available()}; host lanes are selected only "
                "explicitly, e.g. all_devices().cpus(n))")
        return self


@dataclass(frozen=True)
class Platform:
    """A device family: ``cuda`` (torch's CUDA runtime)."""

    name: str
    _devices: tuple = ()

    @property
    def vendor(self) -> str:
        return "NVIDIA" if self.name == "cuda" else "host"

    def devices(self) -> Devices:
        return Devices(self._devices)

    def num_gpus(self) -> int:
        return len(self.devices().gpus())

    def num_cpus(self) -> int:
        return len(self.devices().cpus())

    def num_accelerators(self) -> int:
        return self.num_gpus()

    def log_info(self) -> str:
        return f"Platform: {self.name} (vendor={self.vendor}, devices={len(self._devices)})"


class Platforms(Sequence[Platform]):
    """Every usable platform (the CUDA devices torch sees)."""

    def __init__(self, items: Iterable[Platform]):
        self._items = list(items)

    @staticmethod
    def all() -> "Platforms":
        devs = _cuda_devices()
        return Platforms([Platform("cuda", tuple(devs))] if devs else [])

    def __len__(self) -> int:
        return len(self._items)

    def __iter__(self) -> Iterator[Platform]:
        return iter(self._items)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return Platforms(self._items[idx])
        return self._items[idx]

    def devices(self) -> Devices:
        out = Devices()
        for p in self._items:
            out = out + p.devices()
        return out

    def with_most_devices(self) -> "Platforms":
        """reference: platformsWithMostDevices"""
        if not self._items:
            return Platforms([])
        best = max(len(p._devices) for p in self._items)
        return Platforms([p for p in self._items if len(p._devices) == best])

    def gpus(self) -> Devices:
        return self.devices().gpus()

    accelerators = gpus

    def cpus(self) -> Devices:
        return self.devices().cpus()

    def log_info(self) -> str:
        text = "\n".join(p.log_info() for p in self._items) or "(no CUDA platform)"
        print(text)
        return text


def platforms() -> Platforms:
    return Platforms.all()


def all_devices() -> Devices:
    """Every CUDA device (empty without one; host lanes only by ``cpus``)."""
    return Platforms.all().devices()


def devices_for_type(flags: AcceleratorType, max_devices: int = 0,
                     cpu_lanes: int = 1) -> Devices:
    """Select lanes by AcceleratorType flags: accelerator flags select the
    CUDA devices, ``CPU`` adds ``cpu_lanes`` host lanes.  Raises
    :class:`DeviceSelectionError` when nothing matches."""
    sel = Devices()
    if flags & (AcceleratorType.GPU | AcceleratorType.ACC | AcceleratorType.TPU):
        sel = sel + all_devices()
    if flags & AcceleratorType.CPU:
        sel = sel + cpus(cpu_lanes)
    if max_devices > 0:
        sel = sel.subset(max_devices)
    return sel.require_nonempty(f"AcceleratorType {flags!r}")
