"""Reconstruction filters + filter importance sampling (port of
rayn_tpu.ops.filters; reference src/filter.rs, src/math.rs:136-191):
Blackman-Harris, Mitchell-Netravali, box and Lanczos-sinc, by name in
`FILTERS`.

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


def mitchell_netravali(radius: float = 2.0, b: float = 1.0 / 3.0,
                       c: float = 1.0 / 3.0) -> Filter:
    """Reference src/filter.rs:51-108."""
    def ev(p):
        x = np.abs(2.0 * np.asarray(p, np.float64) / radius)
        near = ((12 - 9 * b - 6 * c) * x ** 3
                + (-18 + 12 * b + 6 * c) * x ** 2 + (6 - 2 * b)) / 6.0
        far = ((-b - 6 * c) * x ** 3 + (6 * b + 30 * c) * x ** 2
               + (-12 * b - 48 * c) * x + (8 * b + 24 * c)) / 6.0
        v = np.where(x > 1.0, far, near)
        return np.where(x >= 2.0, 0.0, v)
    return Filter("mitchell_netravali", radius, ev)


def box_filter(radius: float = 0.5) -> Filter:
    """Reference src/filter.rs:110-140."""
    def ev(p):
        return np.where(np.abs(np.asarray(p, np.float64)) > radius, 0.0, 1.0)
    return Filter("box", radius, ev)


def lanczos_sinc(radius: float = 3.0, tau: float = 3.0) -> Filter:
    """Reference src/filter.rs:142-185."""
    def sinc(x):
        x = np.abs(x)
        small = x <= 1e-5
        return np.where(small, 1.0,
                        np.sin(np.pi * x) / np.where(small, 1.0, np.pi * x))

    def ev(p):
        x = np.abs(np.asarray(p, np.float64))
        return np.where(x > radius, 0.0, sinc(x) * sinc(x / tau))
    return Filter("lanczos_sinc", radius, ev)


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


FILTERS = {
    "blackman_harris": blackman_harris,
    "mitchell_netravali": mitchell_netravali,
    "box": box_filter,
    "lanczos_sinc": lanczos_sinc,
}
