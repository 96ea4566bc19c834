"""Sampling warps and Fresnel helpers (port of rayn_tpu.utils.sampling;
reference src/math.rs:61-129, :201-219)."""

from __future__ import annotations

import math

import torch

from rayn_tpu_torch.utils.vecmath import sqrt as _sqrt

PI = math.pi
TWO_PI = 2.0 * PI
FRAC_PI_4 = PI / 4.0
FRAC_PI_2 = PI / 2.0


def concentric_disk(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Concentric (Shirley) square-to-disk map with the (0,0) -> b=1e-4
    guard; returns [..., 2]."""
    a = u * 2.0 - 1.0
    b = v * 2.0 - 1.0
    zero_mask = (a == 0.0) & (b == 0.0)
    b = torch.where(zero_mask, torch.full_like(b, 1e-4), b)
    a_safe = torch.where(a == 0.0, torch.ones_like(a), a)
    phi1 = FRAC_PI_4 * b / a_safe
    phi2 = FRAC_PI_2 - FRAC_PI_4 * a / b
    take1 = (a * a) > (b * b)
    r = torch.where(take1, a, b)
    phi = torch.where(take1, phi1, phi2)
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi)], dim=-1)


def cosine_hemisphere(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Cosine-weighted direction in local z-up space; pdf = z / pi."""
    xy = concentric_disk(u, v)
    mag_sq = xy[..., 0] * xy[..., 0] + xy[..., 1] * xy[..., 1]
    z = _sqrt(1.0 - torch.clamp(mag_sq, max=1.0))
    return torch.cat([xy, z[..., None]], dim=-1)


def cosine_power_hemisphere(u, v, power, compat_phi: bool = False):
    """Phong-lobe (cos^power) direction in local z-up space."""
    a = u ** (1.0 / (power + 1.0))
    b = _sqrt(torch.clamp(1.0 - a * a, min=0.0))
    phi = (2.0 * v) if compat_phi else (TWO_PI * v)
    return torch.stack([b * torch.cos(phi), b * torch.sin(phi), a], dim=-1)


def f_schlick(cos: torch.Tensor, f0) -> torch.Tensor:
    """Schlick Fresnel (reference src/math.rs:122-124)."""
    m = 1.0 - cos
    m2 = m * m
    return f0 + (1.0 - f0) * (m2 * m2 * m)


def f0_from_ior(ior: torch.Tensor) -> torch.Tensor:
    f0 = (1.0 - ior) / (1.0 + ior)
    return f0 * f0


def power_heuristic(nf: float, f_pdf: torch.Tensor, ng: float,
                    g_pdf: torch.Tensor) -> torch.Tensor:
    """Balance-power MIS heuristic (reference src/math.rs:193-199)."""
    f = nf * f_pdf
    g = ng * g_pdf
    return f * f / (f * f + g * g)


def uniform_cone_pdf(cos_theta_max: torch.Tensor) -> torch.Tensor:
    """pdf of uniform sampling inside a cone (reference
    src/light.rs:105-107)."""
    return 1.0 / (TWO_PI * (1.0 - cos_theta_max))
