"""FastArr — aligned host arrays for fast host<->device copies.

Counterpart of ``cekirdekler_tpu/arrays/fastarr.py``.  The storage is a
torch CPU tensor exposed as a zero-copy numpy view, page-locked
(``pin_memory=True``) when CUDA is present so ``non_blocking`` copies are
true DMA transfers, and a plain host allocation otherwise.  The head is
aligned to ``alignment`` bytes in both cases.  The typed subclasses
(``FloatArr`` ... ``BFloat16Arr``) and ``type_code_for_dtype`` are the
reference's; ``BFloat16Arr`` takes numpy's bf16 dtype from ``ml_dtypes``
and refuses, naming it, where that package is missing.  The reference's
native g++ allocator is not ported.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "FastArr", "FloatArr", "DoubleArr", "IntArr", "UIntArr", "LongArr", "ByteArr",
    "HalfArr", "BFloat16Arr", "fast_arr_for_dtype", "type_code_for_dtype", "ALIGNMENT",
]

ALIGNMENT = 4096

#: the reference's dtype codes (its native tier's element types)
_TYPE_CODES: dict[str, int] = {
    "float32": 0,
    "float64": 1,
    "int32": 2,
    "int64": 3,
    "uint32": 4,
    "uint8": 5,
    "uint16": 6,   # the reference's UTF-16 char slot
    "bfloat16": 7,
    "bool": 8,
}


class FastArr:
    """Aligned (and, with CUDA, page-locked) host array."""

    def __init__(self, n: int, dtype, alignment: int = ALIGNMENT):
        self.dtype = np.dtype(dtype)
        self.n = int(n)
        alignment = int(alignment)
        if alignment <= 0 or (alignment & (alignment - 1)) != 0:
            raise ValueError(f"alignment must be a power of two, got {alignment}")
        if alignment < self.dtype.itemsize:
            raise ValueError(
                f"alignment {alignment} smaller than dtype item size {self.dtype.itemsize}")
        self.alignment = alignment
        nbytes = self.n * self.dtype.itemsize
        self._nbytes = nbytes
        self.pinned = torch.cuda.is_available()
        raw = torch.zeros(nbytes + alignment, dtype=torch.uint8, pin_memory=self.pinned)
        off = (-raw.data_ptr()) % alignment
        self._raw = raw
        self._bytes = raw[off:off + nbytes]
        self._np = self._bytes.numpy().view(self.dtype)[: self.n]

    def address(self) -> int:
        return int(self._np.ctypes.data) if self.n else 0

    @property
    def nbytes(self) -> int:
        return self._nbytes

    def numpy(self) -> np.ndarray:
        """Zero-copy numpy view of the aligned storage."""
        return self._np

    def to_array(self) -> np.ndarray:
        return self._np.copy()

    def copy_from(self, src, offset: int = 0) -> None:
        src_np = np.asarray(src, dtype=self.dtype).ravel()
        self._np[offset: offset + src_np.size] = src_np

    def fill(self, value) -> None:
        self._np[:] = value

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, idx):
        return self._np[idx]

    def __setitem__(self, idx, value):
        self._np[idx] = value

    def __array__(self, dtype=None, copy=None):
        if dtype is None or np.dtype(dtype) == self.dtype:
            return self._np if not copy else self._np.copy()
        return self._np.astype(dtype)

    def dispose(self) -> None:
        self._np = np.empty(0, dtype=self.dtype)
        self._bytes = self._raw = None

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        kind = "pinned" if self.pinned else "host"
        return f"FastArr(n={self.n}, dtype={self.dtype}, {kind})"


# typed subclasses (reference: ClFloatArray..ClCharArray)
class FloatArr(FastArr):
    def __init__(self, n: int):
        super().__init__(n, np.float32)


class DoubleArr(FastArr):
    def __init__(self, n: int):
        super().__init__(n, np.float64)


class IntArr(FastArr):
    def __init__(self, n: int):
        super().__init__(n, np.int32)


class UIntArr(FastArr):
    def __init__(self, n: int):
        super().__init__(n, np.uint32)


class LongArr(FastArr):
    def __init__(self, n: int):
        super().__init__(n, np.int64)


class ByteArr(FastArr):
    def __init__(self, n: int):
        super().__init__(n, np.uint8)


class HalfArr(FastArr):
    def __init__(self, n: int):
        super().__init__(n, np.float16)


def bfloat16_dtype():
    """numpy's bf16 dtype from ``ml_dtypes``; an ImportError naming the
    package where it is missing (no other dtype stands in for it)."""
    try:
        import ml_dtypes
    except ImportError as e:
        raise ImportError(
            "BFloat16Arr needs the ml_dtypes package for a numpy bfloat16 dtype; "
            "it is not installed") from e
    return ml_dtypes.bfloat16


class BFloat16Arr(FastArr):
    def __init__(self, n: int):
        super().__init__(n, bfloat16_dtype())


def type_code_for_dtype(dtype) -> int:
    name = np.dtype(dtype).name
    if name not in _TYPE_CODES:
        raise TypeError(f"unsupported FastArr dtype: {name}")
    return _TYPE_CODES[name]


def fast_arr_for_dtype(n: int, dtype, alignment: int = ALIGNMENT) -> FastArr:
    return FastArr(n, dtype, alignment)
