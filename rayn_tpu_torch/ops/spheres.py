"""Batched analytic sphere intersection (port of rayn_tpu.ops.spheres;
reference src/sphere.rs:24-72)."""

from __future__ import annotations

import torch

from rayn_tpu_torch.utils import vecmath
from rayn_tpu_torch.utils.vecmath import sqrt as _sqrt

MISS = 3.4e38  # f32::MAX stand-in (reference src/sphere.rs:57)


def hit(origin, direction, centers, radii, t_max) -> torch.Tensor:
    """Closest valid hit t per (ray, sphere): [N, K]; MISS on a miss.
    origin/direction [N,3], centers [N,K,3], radii [K], t_max [N]."""
    oc = origin[:, None, :] - centers
    b = vecmath.dot(oc, direction[:, None, :])
    c = vecmath.length_sq(oc) - radii[None, :] ** 2
    descrim = b * b - c
    desc_pos = descrim > 0.0
    desc_sqrt = _sqrt(torch.clamp(descrim, min=0.0))
    t1 = -b - desc_sqrt
    t2 = -b + desc_sqrt
    tm = t_max[:, None]
    t1_valid = (t1 > 1e-4) & (t1 <= tm) & desc_pos
    t2_valid = (t2 > 1e-4) & (t2 <= tm) & desc_pos
    t = torch.where(t1_valid, t1, t2)
    return torch.where(t1_valid | t2_valid, t, torch.full_like(t, MISS))


def occluded(start, end, centers, radii) -> torch.Tensor:
    """Bool [N, K]: does sphere k block the segment start->end?"""
    dir_full = end - start
    dist = vecmath.length(dir_full)
    d = dir_full / dist[:, None]
    oc = start[:, None, :] - centers
    b = vecmath.dot(oc, d[:, None, :])
    c = vecmath.length_sq(oc) - radii[None, :] ** 2
    descrim = b * b - c
    desc_pos = descrim > 0.0
    desc_sqrt = _sqrt(torch.clamp(descrim, min=0.0))
    t1 = -b - desc_sqrt
    t2 = -b + desc_sqrt
    tmin = torch.minimum(t1, t2)
    return (tmin > 1e-3) & (t1 <= dist[:, None]) & desc_pos
