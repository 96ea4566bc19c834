"""Working precisions of the plain reference.

`FLOAT64` is the reference itself. `BFLOAT16` is its control: the same
code with every floating-point result rounded to bfloat16 (round to
nearest even from float32), which is how bfloat16 arithmetic rounds on
hardware that computes in float32. NumPy has no bfloat16 type, so the
rounding rides on an ndarray subclass whose ufuncs and array functions
round what they return.
"""

from __future__ import annotations

import numpy as np


def round_bf16(a: np.ndarray) -> np.ndarray:
    """float32 values rounded to the nearest bfloat16, ties to even
    (NaN and inf pass through)."""
    a = np.ascontiguousarray(a, np.float32)
    u = a.view(np.uint32).astype(np.uint64)
    r = ((u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000).astype(np.uint32)
    out = r.view(np.float32)
    return np.where(np.isfinite(a), out, a)


def _plain(x):
    if isinstance(x, BF16Array):
        return x.view(np.ndarray)
    if isinstance(x, (list, tuple)):
        return type(x)(_plain(v) for v in x)
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    return x


def _wrap(x):
    if isinstance(x, np.ndarray) and x.dtype.kind == "f":
        return round_bf16(x).view(BF16Array)
    if isinstance(x, np.floating):
        return round_bf16(np.asarray(x, np.float32)).view(BF16Array)
    if isinstance(x, tuple):
        return tuple(_wrap(v) for v in x)
    if isinstance(x, list):
        return [_wrap(v) for v in x]
    return x


class BF16Array(np.ndarray):
    """float32 storage holding bfloat16 values; every ufunc and array
    function result is rounded back to bfloat16."""

    def __array_ufunc__(self, ufunc, method, *inputs, **kwargs):
        if "out" in kwargs:
            raise TypeError("BF16Array does not take out=")
        return _wrap(getattr(ufunc, method)(*_plain(inputs),
                                            **_plain(kwargs)))

    def __array_function__(self, func, types, args, kwargs):
        return _wrap(func(*_plain(args), **_plain(kwargs)))


class Precision:
    """How the reference makes its float arrays."""

    def __init__(self, name: str):
        if name not in ("float64", "bfloat16"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def f(self, x) -> np.ndarray:
        if self.name == "float64":
            return np.asarray(x, np.float64)
        return round_bf16(np.asarray(x, np.float32)).view(BF16Array)

    def zeros(self, shape) -> np.ndarray:
        return self.f(np.zeros(shape))

    def ones(self, shape) -> np.ndarray:
        return self.f(np.ones(shape))


FLOAT64 = Precision("float64")
BFLOAT16 = Precision("bfloat16")
