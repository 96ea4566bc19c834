"""Reconstruction filter + filter importance sampling (port of
rayn_tpu.ops.filters; reference src/filter.rs, src/math.rs:136-191).

The inverse-CDF table is built on the host in float64 numpy exactly as
the JAX package builds it, then stored as float32 on the device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

_BH_A = (0.35875, 0.48829, 0.14128, 0.01168)  # reference src/filter.rs:29-32


@dataclasses.dataclass(frozen=True)
class Filter:
    name: str
    radius: float
    evaluate: Callable[[np.ndarray], np.ndarray]


def blackman_harris(radius: float = 1.5) -> Filter:
    """Reference src/filter.rs:12-49 (the default, src/main.rs:51)."""
    def ev(p):
        p = np.asarray(p, np.float64)
        x = np.abs(p / radius) * 0.5 + 0.5
        a0, a1, a2, a3 = _BH_A
        v = (a0 - a1 * np.cos(2 * np.pi * x) + a2 * np.cos(4 * np.pi * x)
             + a3 * np.cos(6 * np.pi * x))
        return np.where(np.abs(p) > radius, 0.0, v)
    return Filter("blackman_harris", radius, ev)


def build_fis_table(filt: Filter, table_size: int = 512, *,
                    device) -> torch.Tensor:
    """Inverse-CDF table over (0, radius) (reference src/filter.rs:193-218)."""
    n = table_size
    d = np.linspace(0.0, filt.radius, n)
    w = np.maximum(np.asarray(filt.evaluate(d), np.float64), 0.0)
    wn = w / w.sum()
    dens = np.cumsum(wn)
    i = n - 1
    while i >= 0:
        dens[i] = 1.0
        if wn[i] > 0.0:
            break
        i -= 1
    idx = np.searchsorted(dens, np.linspace(0.0, 1.0, n), side="left")
    inv = d[np.minimum(idx, n - 1)]
    return torch.as_tensor(inv.astype(np.float32), device=device)


def fis_sample(table: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Map uniform u in [0,1) to a filter-distributed offset in
    (-radius, radius) (reference src/filter.rs:222-235)."""
    n = table.shape[0]
    u2 = 2.0 * (u - 0.5)
    mult = torch.where(u2 < 0.0, -1.0, 1.0).to(u.dtype)
    ua = torch.clamp(torch.abs(u2), 0.0, 0.99999)
    idx_full = ua * (n - 1)
    idx = torch.floor(idx_full).to(torch.int64)
    t = idx_full - idx.to(torch.float32)
    lo = table[idx]
    hi = table[idx + 1]
    return mult * (lo * (1.0 - t) + hi * t)
