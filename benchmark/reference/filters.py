"""Filter importance sampling in NumPy (reference src/filter.rs:12-49,
:193-235): the Blackman-Harris window, its inverse-CDF table over
(0, radius) and the map from a uniform sample to a pixel offset. The
table is built in float64 and rounded to float32, as upstream keeps it.
"""

from __future__ import annotations

import numpy as np

_BH_A = (0.35875, 0.48829, 0.14128, 0.01168)


def blackman_harris(radius: float):
    def ev(p):
        p = np.asarray(p, np.float64)
        x = np.abs(p / radius) * 0.5 + 0.5
        a0, a1, a2, a3 = _BH_A
        v = (a0 - a1 * np.cos(2 * np.pi * x) + a2 * np.cos(4 * np.pi * x)
             + a3 * np.cos(6 * np.pi * x))
        return np.where(np.abs(p) > radius, 0.0, v)
    return ev


FILTERS = {"blackman_harris": blackman_harris}


def fis_table(name: str, radius: float, size: int) -> np.ndarray:
    """[size] float32 inverse CDF of the filter's weight over (0, radius)."""
    if name not in FILTERS:
        raise ValueError(f"the reference has no filter {name!r}")
    d = np.linspace(0.0, radius, size)
    w = np.maximum(FILTERS[name](radius)(d), 0.0)
    wn = w / w.sum()
    cdf = np.cumsum(wn)
    i = size - 1
    while i >= 0:   # the tail past the last nonzero weight reads 1
        cdf[i] = 1.0
        if wn[i] > 0.0:
            break
        i -= 1
    idx = np.searchsorted(cdf, np.linspace(0.0, 1.0, size), side="left")
    return d[np.minimum(idx, size - 1)].astype(np.float32)


def fis_offset(table, u, prec):
    """Uniform u in [0, 1) -> a filter-distributed offset in
    (-radius, radius), mirrored about 0, linear between table entries."""
    n = table.shape[0]
    u2 = (prec.f(u) - 0.5) * 2.0
    mult = np.where(u2 < 0.0, -1.0, 1.0)
    ua = np.clip(np.abs(u2), 0.0, 0.99999)
    pos = ua * (n - 1)
    # a bfloat16 control can round ua up to 1; the float64 reference
    # never reaches the last entry
    i = np.minimum(np.floor(pos).astype(np.int64), n - 2)
    t = pos - i
    tab = prec.f(table)
    return mult * (tab[i] * (1.0 - t) + tab[i + 1] * t)
