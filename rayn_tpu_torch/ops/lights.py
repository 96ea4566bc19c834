"""Sphere-light sampling (port of rayn_tpu.ops.lights; reference
src/light.rs:19-103)."""

from __future__ import annotations

import torch

from rayn_tpu_torch.utils import sampling, vecmath
from rayn_tpu_torch.utils.vecmath import sqrt as _sqrt


def sample_cone(u, light_pos, light_rad, p, emission):
    """Visible-cap sample of a sphere light seen from p: (point [N,3],
    radiance [N,3], solid-angle pdf [N]) (reference src/light.rs:38-72)."""
    dir_to_light = light_pos - p
    dist_sq = vecmath.length_sq(dir_to_light)
    dist = _sqrt(dist_sq)
    w = dir_to_light / dist[:, None]
    nor = -w
    uu, vv = vecmath.orthonormal_basis(nor)

    r2 = light_rad * light_rad
    sin_theta_max_2 = r2 / dist_sq
    cos_theta_max = _sqrt(torch.clamp(1.0 - sin_theta_max_2, min=0.0))
    cos_theta = (1.0 - u[:, 0]) + u[:, 0] * cos_theta_max
    sin_theta = _sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    phi = u[:, 1] * sampling.TWO_PI

    ds = dist * cos_theta - _sqrt(
        torch.clamp(r2 - dist_sq * sin_theta * sin_theta, min=0.0))
    cos_alpha = (dist_sq + r2 - ds * ds) / (2.0 * dist * light_rad)
    sin_alpha = _sqrt(torch.clamp(1.0 - cos_alpha * cos_alpha, min=0.0))

    offset = (uu * (sin_alpha * torch.cos(phi))[:, None]
              + vv * (sin_alpha * torch.sin(phi))[:, None]
              + nor * cos_alpha[:, None])
    point = light_pos + offset * light_rad[:, None]
    pdf = sampling.uniform_cone_pdf(cos_theta_max)
    return point, emission, pdf


def sample_equi_angular(u, light_pos, ray_o, ray_d, max_distance):
    """Equi-angular distance sample toward a light: (distance [N],
    pdf [N]) (Kulla & Fajardo; reference src/light.rs:75-102)."""
    delta = vecmath.dot(light_pos - ray_o, ray_d)
    closest = ray_o + delta[:, None] * ray_d
    d = vecmath.length(closest - light_pos)
    theta_a = torch.atan2(-delta, d)
    theta_b = torch.atan2(max_distance - delta, d)
    th = theta_a + (theta_b - theta_a) * u
    t = d * torch.tan(th)
    sample_dist = delta + t
    pdf = d / ((theta_b - theta_a) * (d * d + t * t))
    return sample_dist, pdf
