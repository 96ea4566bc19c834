"""Signed-distance fields: the MandelBox (port of rayn_tpu.ops.sdf).

The JAX package represents an SDF as a traced closure plus a parameter
pytree. The port's kernels are compiled CUDA, so an SDF here is a plain
value: `MandelBox` carries its iteration count and its four scalar
parameters (float32-rounded), and the CUDA kernels take them as plain
arguments. The other primitives and combinators are not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from rayn_tpu_torch.utils import vecmath
from rayn_tpu_torch.utils.vecmath import sqrt as _sqrt


def _f32(x: float) -> float:
    return float(np.float32(x))


class MandelBox(NamedTuple):
    """MandelBox distance estimator (reference src/sdf.rs:104-188)."""
    iterations: int
    scale: float          # e.g. -2.1 (reference src/setup.rs:84)
    box_l: float          # box-fold side length
    min_rad_sq: float     # sphere-fold min radius^2
    fixed_rad_sq: float   # sphere-fold fixed radius^2


def mandelbox(iterations: int, box_fold_l: float, sphere_min_rad: float,
              sphere_fixed_rad: float, scale: float) -> MandelBox:
    return MandelBox(int(iterations), _f32(scale), _f32(box_fold_l),
                     _f32(sphere_min_rad * sphere_min_rad),
                     _f32(sphere_fixed_rad * sphere_fixed_rad))


def reduced(mb: MandelBox, iterations: int) -> MandelBox:
    """The MandelBox at `iterations` iterations, or `mb` itself at 0: the
    truncated DE that JAX gives every shadow march
    (RenderSettings.shadow_de_iterations; SdfProgram.reduced and the
    MandelBox reduce_fn, rayn_tpu/ops/sdf.py:52-57, 87-117)."""
    return mb._replace(iterations=int(iterations)) if iterations else mb


def dist_c(mb: MandelBox, x: torch.Tensor, y: torch.Tensor,
           z: torch.Tensor) -> torch.Tensor:
    """Component-form DE (reference src/sdf.rs:126-141): per iteration a
    box fold, a sphere fold, then p = p*scale + p0 and dr = -dr*scale + 1;
    DE = |p| / |dr|. NaN propagates like jnp.clip/jnp.maximum."""
    ox, oy, oz = x, y, z
    dr = torch.ones_like(x)
    lo, hi = -mb.box_l, mb.box_l
    for _ in range(mb.iterations):
        x = torch.clamp(x, lo, hi) * 2.0 - x
        y = torch.clamp(y, lo, hi) * 2.0 - y
        z = torch.clamp(z, lo, hi) * 2.0 - z
        r2 = x * x + y * y + z * z
        mul = torch.clamp(vecmath.div(mb.fixed_rad_sq,
                                      torch.clamp(r2, min=mb.min_rad_sq)),
                          min=1.0)
        x, y, z = x * mul, y * mul, z * mul
        dr = dr * mul
        x = x * mb.scale + ox
        y = y * mb.scale + oy
        z = z * mb.scale + oz
        dr = -dr * mb.scale + 1.0
    return _sqrt(x * x + y * y + z * z) / torch.abs(dr)


def dist(mb: MandelBox, p: torch.Tensor) -> torch.Tensor:
    return dist_c(mb, p[..., 0], p[..., 1], p[..., 2])


# sdfu normals_fast tetrahedral tap directions (shared with the CUDA
# kernel, which unrolls the same four taps in the same order).
TETRA_TAPS = ((1.0, -1.0, -1.0), (-1.0, 1.0, -1.0),
              (-1.0, -1.0, 1.0), (1.0, 1.0, 1.0))


def tetrahedral_normal(mb: MandelBox, p: torch.Tensor,
                       eps: torch.Tensor) -> torch.Tensor:
    """4-tap tetrahedral gradient estimate, normalized (reference
    src/sdf.rs:92-96). eps: [...] per-point step size."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    g = [torch.zeros_like(x) for _ in range(3)]
    for kx, ky, kz in TETRA_TAPS:
        d = dist_c(mb, x + kx * eps, y + ky * eps, z + kz * eps)
        g = [g[0] + kx * d, g[1] + ky * d, g[2] + kz * d]
    return vecmath.normalize(torch.stack(g, dim=-1), eps=1e-20)
