"""Host arrays and their transfer flags."""

from .clarray import ClArray, ParameterGroup, TransferFlags, wrap
from .fastarr import (
    ALIGNMENT,
    BFloat16Arr,
    ByteArr,
    DoubleArr,
    FastArr,
    FloatArr,
    HalfArr,
    IntArr,
    LongArr,
    UIntArr,
    fast_arr_for_dtype,
    type_code_for_dtype,
)

__all__ = [
    "ClArray",
    "ParameterGroup",
    "TransferFlags",
    "wrap",
    "FastArr",
    "FloatArr",
    "DoubleArr",
    "IntArr",
    "UIntArr",
    "LongArr",
    "ByteArr",
    "HalfArr",
    "BFloat16Arr",
    "fast_arr_for_dtype",
    "type_code_for_dtype",
    "ALIGNMENT",
]
