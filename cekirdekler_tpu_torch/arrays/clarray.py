"""User-facing arrays and compute binding.

Counterpart of ``cekirdekler_tpu/arrays/clarray.py``: the same
``ClArray``, ``TransferFlags``, ``ParameterGroup``, ``wrap``,
``next_param``, ``compute`` (with the pipelined engines) and ``task``
(a frozen call for ``pipeline.pool``).  ``fast=True`` arrays are backed by
a :class:`FastArr` (page-locked with CUDA).

The analogue of the reference's ``ClArray<T>`` / ``ClParameterGroup``
(ClArray.cs): arrays carry per-array transfer flags, chain into parameter
groups via ``next_param`` (ClArray.cs:219-500), and ``compute()`` validates
ranges then hands everything to the core scheduler (ClArray.cs:543-651,
1605-1736).

The reference encodes flags into a ``readWrite`` string DSL ("partial read
write all ro wo zc", built at ClArray.cs:611-629, parsed by ``Contains`` in
Worker.cs:827-835); we use a typed ``TransferFlags`` dataclass instead
(SURVEY.md §5.6 calls for exactly this) and provide ``read_write_string()``
for wire/debug parity.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Sequence

import numpy as np

from ..errors import ComputeValidationError
from .fastarr import FastArr, fast_arr_for_dtype

__all__ = ["TransferFlags", "ClArray", "ParameterGroup", "wrap"]


@dataclass
class TransferFlags:
    """Per-array transfer/access behavior (reference: IBufferOptimization
    properties, ClArray.cs:82-149).

    - ``read``: host→device before the kernel runs.
    - ``partial_read``: each chip receives only its own range slice
      (otherwise every chip receives the whole array).
    - ``write``: device→host after the kernel; each chip writes back only
      the slice covered by its range.
    - ``write_all``: write the entire array back from the owning chip.
    - ``read_only`` / ``write_only``: access hints (donation / no-readback).
    - ``zero_copy``: request pinned-host staging (the analogue of
      ``CL_MEM_USE_HOST_PTR``).
    - ``elements_per_work_item``: how many consecutive elements one work
      item covers — the range-slice multiplier (ClArray.cs:143-146).
    """

    read: bool = True
    partial_read: bool = False
    write: bool = True
    write_all: bool = False
    read_only: bool = False
    write_only: bool = False
    zero_copy: bool = False
    elements_per_work_item: int = 1
    alignment_bytes: int = 4096

    def validate(self) -> None:
        if self.read_only and self.write_only:
            raise ComputeValidationError("array cannot be read_only and write_only")
        if self.elements_per_work_item < 1:
            raise ComputeValidationError("elements_per_work_item must be >= 1")
        a = self.alignment_bytes
        if a <= 0 or (a & (a - 1)) != 0:
            raise ComputeValidationError(
                f"alignment_bytes must be a power of two, got {a}"
            )

    def read_write_string(self) -> str:
        """Reference-format descriptor (ClArray.cs:611-629) for debugging and
        the cluster wire format."""
        parts: list[str] = []
        if self.partial_read:
            parts.append("partial")
        if self.read and not self.write_only:
            parts.append("read")
        if self.write and not self.read_only:
            parts.append("write")
        if self.write_all:
            parts.append("all")
        if self.read_only:
            parts.append("ro")
        if self.write_only:
            parts.append("wo")
        if self.zero_copy:
            parts.append("zc")
        return " ".join(parts)


def _check_alignment(flags: "TransferFlags", dtype: np.dtype) -> None:
    """The one dtype-aware alignment rule, shared by the ClArray ctor,
    migration, and wrap() override paths."""
    if flags.alignment_bytes < dtype.itemsize:
        raise ComputeValidationError(
            f"alignment_bytes {flags.alignment_bytes} smaller than "
            f"dtype item size {dtype.itemsize}"
        )


class _ComputeMixin:
    """Shared compute/chaining surface (reference: ICanCompute + ICanBind,
    ClArray.cs:34-76,665-709)."""

    def parameters(self) -> list["ClArray"]:  # pragma: no cover - overridden
        raise NotImplementedError

    def next_param(self, *arrays, **flag_overrides) -> "ParameterGroup":
        """Chain further parameters (reference: nextParam overloads,
        ClArray.cs:219-500).  Accepts ClArray, numpy arrays, FastArr."""
        group = ParameterGroup(self.parameters())
        for a in arrays:
            group._params.append(wrap(a, **flag_overrides))
        return group

    def compute(
        self,
        cruncher,
        compute_id: int,
        kernels: str | Sequence[str],
        global_range: int,
        local_range: int = 256,
        global_offset: int = 0,
        pipeline: bool = False,
        pipeline_blobs: int = 4,
        pipeline_type: int = 1,  # core.cores.PIPELINE_EVENT (core imports arrays)
        values: Sequence | dict = (),
    ):
        """Run kernel(s) over ``global_range`` work items across all selected
        chips (reference: ClParameterGroup.compute → Cores.compute,
        ClArray.cs:543-651).

        ``kernels`` may be a single name, a space-separated list
        ("k1 k2 k3" runs them in sequence, reference: kernel name lists),
        or a sequence of names.  ``values`` supplies scalar (non-pointer)
        kernel arguments — a tuple applied to every kernel, or a dict
        ``{kernel_name: tuple}``.  ``pipeline=True`` cuts each lane's range
        into ``pipeline_blobs`` blobs whose transfers overlap other blobs'
        kernels, by the engine ``pipeline_type`` names (``PIPELINE_EVENT``,
        the default, or ``PIPELINE_DRIVER``).
        """
        params = self.parameters()
        names = kernels.split() if isinstance(kernels, str) else list(kernels)
        # error gate: a cruncher that has already failed refuses further
        # work until reset (reference: numberOfErrorsHappened checks,
        # ClArray.cs:1610-1623, ClNumberCruncher.cs:374-392)
        errs = getattr(cruncher, "number_of_errors_happened", 0)
        if errs:
            raise ComputeValidationError(
                f"cruncher has {errs} previous error(s); call "
                "reset_errors() before computing again"
            )
        _validate_compute(params, names, global_range, local_range, pipeline, pipeline_blobs)
        try:
            return cruncher.cores.compute(
                kernel_names=names,
                params=params,
                compute_id=compute_id,
                global_range=global_range,
                local_range=local_range,
                global_offset=global_offset,
                pipeline=pipeline,
                pipeline_blobs=pipeline_blobs,
                pipeline_type=pipeline_type,
                value_args=values,
            )
        except Exception:
            cruncher.number_of_errors_happened = errs + 1
            raise

    def task(
        self,
        compute_id: int,
        kernels: str | Sequence[str],
        global_range: int,
        local_range: int = 256,
        global_offset: int = 0,
    ):
        """Freeze this binding into a pool task (reference: ClArray.task(),
        ClArray.cs:1552-1583)."""
        from ..pipeline.pool import ClTask  # local: pool imports the cruncher

        names = kernels.split() if isinstance(kernels, str) else list(kernels)
        return ClTask(
            params=self.parameters(),
            kernel_names=names,
            compute_id=compute_id,
            global_range=global_range,
            local_range=local_range,
            global_offset=global_offset,
        )


def _validate_compute(params, names, global_range, local_range, pipeline, blobs) -> None:
    """Range/size validation (reference: ClArray.cs:1625-1679 and
    ClParameterGroup validation ClArray.cs:543-645)."""
    if not names:
        raise ComputeValidationError("no kernel names given")
    if global_range <= 0:
        raise ComputeValidationError(f"global_range must be positive, got {global_range}")
    if local_range <= 0:
        raise ComputeValidationError(f"local_range must be positive, got {local_range}")
    if global_range % local_range != 0:
        raise ComputeValidationError(
            f"global_range ({global_range}) must be divisible by local_range ({local_range})"
        )
    if pipeline:
        if blobs < 2:
            raise ComputeValidationError("pipeline needs at least 2 blobs")
        if (global_range // local_range) % blobs != 0:
            raise ComputeValidationError(
                f"global_range/local_range ({global_range // local_range}) must be divisible "
                f"by pipeline_blobs ({blobs})"
            )
    for p in params:
        p.flags.validate()
        need = global_range * p.flags.elements_per_work_item
        if p.size < need:
            raise ComputeValidationError(
                f"array '{p.name}' has {p.size} elements but needs >= {need} "
                f"(global_range {global_range} × {p.flags.elements_per_work_item}/item)"
            )


class ClArray(_ComputeMixin):
    """User array with transfer flags (reference: ClArray<T>,
    ClArray.cs:715-1906).

    Backing store is either a plain numpy array (the reference's C# ``T[]``)
    or a :class:`FastArr` aligned native allocation; ``fast_arr`` migrates
    between them in place (reference: ClArray.fastArr C#↔native migration,
    ClArray.cs:889-958).
    """

    def __init__(
        self,
        data: int | np.ndarray | FastArr | Sequence,
        dtype=np.float32,
        name: str | None = None,
        fast: bool = False,
        **flag_overrides,
    ):
        self.flags = TransferFlags(**flag_overrides)
        self.flags.validate()
        if isinstance(data, (int, np.integer)):
            # auto-allocating ctor (reference: ClArray.cs:809-846)
            n = int(data)
            if fast:
                self._check_alignment_for(np.dtype(dtype))
                self._fast: FastArr | None = fast_arr_for_dtype(
                    n, dtype, self.flags.alignment_bytes
                )
                self._np: np.ndarray | None = None
            else:
                self._fast = None
                self._np = np.zeros(n, dtype=dtype)
        elif isinstance(data, FastArr):
            self._fast = data
            self._np = None
        else:
            arr = np.asarray(data)
            if arr.dtype == np.float64 and np.dtype(dtype) == np.float32 and not isinstance(data, np.ndarray):
                arr = arr.astype(np.float32)
            self._fast = None
            self._np = np.ascontiguousarray(arr)
        self.name = name or f"arr@{id(self):x}"
        # validate against the EFFECTIVE dtype (for array data it comes from
        # the array, not the ctor's dtype parameter) so a too-small
        # alignment_bytes fails here as a user-input error, not later as a
        # raw ValueError out of a fast_arr migration
        self._check_alignment_for(self.dtype)
        # set by wrap_structs: the structured array this byte view aliases
        self._struct_source: np.ndarray | None = None

    def _check_alignment_for(self, dtype: np.dtype) -> None:
        _check_alignment(self.flags, dtype)

    @classmethod
    def wrap_structs(cls, arr: np.ndarray, name: str | None = None,
                     **flag_overrides) -> "ClArray":
        """Wrap a numpy STRUCTURED array as a byte ClArray, zero-copy
        (reference: wrapArrayOfStructs via GCHandle pinning,
        ClArray.cs:1058-1074 + HelperFunctions.cs:53-82).

        The byte view aliases the caller's array — device writes flushed to
        host appear in the original structs with no conversion.  One work
        item maps to one struct: ``elements_per_work_item`` is set to the
        struct's byte size, so compute ranges count structs while transfers
        move their bytes (the reference's numberOfElementsPerWorkItem
        pattern for struct arrays)."""
        if arr.dtype.fields is None:
            raise ValueError("wrap_structs expects a numpy structured array")
        if not arr.flags["C_CONTIGUOUS"]:
            raise ValueError("structured array must be C-contiguous to alias")
        view = arr.view(np.uint8).reshape(-1)
        flag_overrides.setdefault("elements_per_work_item", arr.dtype.itemsize)
        out = cls(view, name=name or "structs", **flag_overrides)
        out._struct_source = arr
        return out

    @property
    def struct_source(self) -> np.ndarray | None:
        """The structured array a wrap_structs ClArray aliases (or None)."""
        return self._struct_source

    # -- backing store -------------------------------------------------------
    @property
    def fast_arr(self) -> bool:
        return self._fast is not None

    @fast_arr.setter
    def fast_arr(self, want_native: bool) -> None:
        """Migrate between numpy and native aligned storage in place
        (reference: ClArray.cs:889-958)."""
        if want_native and self._fast is None:
            assert self._np is not None
            self._check_alignment_for(self._np.dtype)
            fa = fast_arr_for_dtype(
                self._np.size, self._np.dtype, self.flags.alignment_bytes
            )
            fa.copy_from(self._np)
            self._fast, self._np = fa, None
        elif not want_native and self._fast is not None:
            self._np = self._fast.to_array()
            self._fast.dispose()
            self._fast = None

    def host(self) -> np.ndarray:
        """The live host buffer (zero-copy view for FastArr backing)."""
        if self._fast is not None:
            return self._fast.numpy()
        assert self._np is not None
        return self._np

    @property
    def dtype(self):
        return self.host().dtype

    @property
    def size(self) -> int:
        return self.host().size

    def resize(self, n: int) -> None:
        """Grow/shrink preserving contents (reference: resize-on-N,
        ClArray.cs:749-800)."""
        cur = self.host()
        if n == cur.size:
            return
        if self._fast is not None:
            fa = fast_arr_for_dtype(n, cur.dtype, self._fast.alignment)
            fa.copy_from(cur[: min(n, cur.size)])
            self._fast.dispose()
            self._fast = fa
        else:
            new = np.zeros(n, dtype=cur.dtype)
            new[: min(n, cur.size)] = cur[: min(n, cur.size)]
            self._np = new

    # -- flag property sugar (mutual exclusions mirror ClArray.cs:1742-1863) --
    def _set_flag(self, **kw) -> "ClArray":
        self.flags = replace(self.flags, **kw)
        self.flags.validate()
        return self

    @property
    def read(self) -> bool:
        return self.flags.read

    @read.setter
    def read(self, v: bool) -> None:
        self._set_flag(read=v, write_only=False if v else self.flags.write_only)

    @property
    def partial_read(self) -> bool:
        return self.flags.partial_read

    @partial_read.setter
    def partial_read(self, v: bool) -> None:
        self._set_flag(partial_read=v, read=True if v else self.flags.read)

    @property
    def write(self) -> bool:
        return self.flags.write

    @write.setter
    def write(self, v: bool) -> None:
        self._set_flag(write=v, read_only=False if v else self.flags.read_only)

    @property
    def write_all(self) -> bool:
        return self.flags.write_all

    @write_all.setter
    def write_all(self, v: bool) -> None:
        self._set_flag(write_all=v, write=True if v else self.flags.write)

    @property
    def read_only(self) -> bool:
        return self.flags.read_only

    @read_only.setter
    def read_only(self, v: bool) -> None:
        kw = {"read_only": v, "write": False if v else self.flags.write}
        if v:
            kw["write_only"] = False
            kw["read"] = True
        self._set_flag(**kw)

    @property
    def write_only(self) -> bool:
        return self.flags.write_only

    @write_only.setter
    def write_only(self, v: bool) -> None:
        kw = {"write_only": v, "read": False if v else self.flags.read}
        if v:
            kw["read_only"] = False
            kw["write"] = True
        self._set_flag(**kw)

    @property
    def zero_copy(self) -> bool:
        return self.flags.zero_copy

    @zero_copy.setter
    def zero_copy(self, v: bool) -> None:
        self._set_flag(zero_copy=v)

    @property
    def elements_per_work_item(self) -> int:
        return self.flags.elements_per_work_item

    @elements_per_work_item.setter
    def elements_per_work_item(self, v: int) -> None:
        self._set_flag(elements_per_work_item=int(v))

    # -- element access (reference: IList<T> indexer, ClArray.cs:1896-1906) --
    def __len__(self) -> int:
        return self.size

    def __getitem__(self, idx):
        return self.host()[idx]

    def __setitem__(self, idx, value):
        self.host()[idx] = value

    def __array__(self, dtype=None, copy=None):
        h = self.host()
        if dtype is None or np.dtype(dtype) == h.dtype:
            return h if not copy else h.copy()
        return h.astype(dtype)

    def parameters(self) -> list["ClArray"]:
        return [self]

    def copy_from(self, src, offset: int = 0) -> None:
        src_np = np.asarray(src).ravel()
        self.host()[offset : offset + src_np.size] = src_np

    def dispose(self) -> None:
        if self._fast is not None:
            self._fast.dispose()
            self._fast = None
            self._np = np.empty(0, dtype=np.float32)

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        backing = "fast" if self.fast_arr else "numpy"
        return (
            f"ClArray(name={self.name!r}, n={self.size}, dtype={self.dtype}, "
            f"{backing}, flags='{self.flags.read_write_string()}')"
        )


class ParameterGroup(_ComputeMixin):
    """Ordered kernel-argument list (reference: ClParameterGroup,
    ClArray.cs:219-651).  Order of ``next_param`` chaining == kernel argument
    order."""

    def __init__(self, params: Sequence[ClArray] = ()):  # noqa: D107
        self._params: list[ClArray] = list(params)

    def parameters(self) -> list[ClArray]:
        return list(self._params)

    def __len__(self) -> int:
        return len(self._params)

    def __getitem__(self, i: int) -> ClArray:
        return self._params[i]

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"ParameterGroup({[p.name for p in self._params]})"


def wrap(obj: Any, **flag_overrides) -> ClArray:
    """Coerce any supported array-ish object into a ClArray (reference:
    implicit conversions, ClArray.cs:1014-1046)."""
    if isinstance(obj, ClArray):
        if flag_overrides:
            # validate the candidate BEFORE assigning: a failed override
            # must not leave the caller's (possibly still-used) array with
            # corrupted flags
            candidate = replace(obj.flags, **flag_overrides)
            candidate.validate()
            _check_alignment(candidate, obj.dtype)
            obj.flags = candidate
        return obj
    if isinstance(obj, FastArr):
        return ClArray(obj, **flag_overrides)
    return ClArray(np.asarray(obj), **flag_overrides)
