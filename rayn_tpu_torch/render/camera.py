"""Pinhole camera (port of rayn_tpu.render.camera.PinholeCamera;
reference src/camera.rs:41-119).

`half_pixel_size_at(t) = hps_abs + hps_lin * t` feeds the SDF cone-traced
hit threshold (reference src/camera.rs:116-118). ThinLens and
Orthographic cameras are not ported yet.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from rayn_tpu_torch.scene.animation import AnimChannel
from rayn_tpu_torch.utils import vecmath


def _chan(v, device) -> AnimChannel:
    if isinstance(v, AnimChannel):
        return AnimChannel(v.values.to(device), v.t0, v.t1)
    return AnimChannel.constant(v, device=device)


def _f32(x) -> float:
    return float(np.float32(x))


class PinholeCamera(NamedTuple):
    origin: AnimChannel
    at: AnimChannel
    up: AnimChannel
    half_w: float   # float32-rounded scalars
    half_h: float
    hps: float      # half-pixel size coefficient (slope in t)

    @staticmethod
    def make(resolution, vfov_degrees: float, origin, at, up,
             device="cuda") -> "PinholeCamera":
        theta = vfov_degrees * math.pi / 180.0
        half_h = math.tan(theta / 2.0)
        aspect = resolution[0] / resolution[1]
        return PinholeCamera(
            _chan(origin, device), _chan(at, device), _chan(up, device),
            _f32(aspect * half_h), _f32(half_h),
            _f32(half_h / resolution[1]))

    def generate(self, ndc: torch.Tensor, time: torch.Tensor,
                 lens_uv: torch.Tensor):
        """World rays (origin [N,3], unit direction [N,3]) for NDC [N,2]."""
        origin = self.origin.sample(time)
        at = self.at.sample(time)
        up = self.up.sample(time)
        w = vecmath.normalize(origin - at)
        u = vecmath.normalize(vecmath.cross(up, w))
        v = vecmath.cross(w, u)
        half_w, half_h = self.half_w, self.half_h
        lower_left = origin - u * half_w - v * half_h - w
        d = (lower_left
             + u * _f32(2.0 * half_w) * ndc[:, 0:1]
             + v * _f32(2.0 * half_h) * ndc[:, 1:2]
             - origin)
        return origin.contiguous(), vecmath.normalize(d)

    def half_pixel_size_coeffs(self) -> tuple[float, float]:
        """(abs, linear-in-t) terms of half_pixel_size_at."""
        return 0.0, self.hps
