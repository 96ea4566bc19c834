"""Cameras (port of rayn_tpu.render.camera; reference src/camera.rs):
pinhole, thin-lens (depth of field) and orthographic. Every animatable
input (origin, look-at, up, aperture, focus) is an AnimChannel sampled
at each ray's time, which gives camera motion blur.

`half_pixel_size_at(t) = hps_abs + hps_lin * t` feeds the SDF cone-traced
hit threshold (reference src/camera.rs:116-118, :282-284).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from rayn_tpu_torch.scene.animation import AnimChannel
from rayn_tpu_torch.utils import vecmath
from rayn_tpu_torch.utils.sampling import concentric_disk


def _chan(v, device) -> AnimChannel:
    if isinstance(v, AnimChannel):
        return AnimChannel(v.values.to(device), v.t0, v.t1)
    return AnimChannel.constant(v, device=device)


def _f32(x) -> float:
    return float(np.float32(x))


def _look_basis(origin, at, up):
    """Right-handed camera basis with w pointing backwards (reference
    src/camera.rs:94-96)."""
    w = vecmath.normalize(origin - at)
    u = vecmath.normalize(vecmath.cross(up, w))
    v = vecmath.cross(w, u)
    return u, v, w


def _frustum(resolution, vfov_degrees: float) -> tuple[float, float, float]:
    """(half_w, half_h, hps) of a perspective camera, float32-rounded."""
    theta = vfov_degrees * math.pi / 180.0
    half_h = math.tan(theta / 2.0)
    aspect = resolution[0] / resolution[1]
    return (_f32(aspect * half_h), _f32(half_h),
            _f32(half_h / resolution[1]))


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
        return PinholeCamera(
            _chan(origin, device), _chan(at, device), _chan(up, device),
            *_frustum(resolution, vfov_degrees))

    def generate(self, ndc: torch.Tensor, time: torch.Tensor,
                 lens_uv: torch.Tensor):
        """World rays (origin [N,3], unit direction [N,3]) for NDC [N,2]."""
        origin = self.origin.sample(time)
        at = self.at.sample(time)
        up = self.up.sample(time)
        u, v, w = _look_basis(origin, at, up)
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


class ThinLensCamera(NamedTuple):
    """Depth-of-field camera (reference src/camera.rs:120-213): rays
    leave a disk of radius `aperture` (concentric map of the lens
    sample) and meet at the focus distance |focus - origin|."""
    origin: AnimChannel
    at: AnimChannel
    up: AnimChannel
    aperture: AnimChannel   # [T, 1]
    focus: AnimChannel
    half_w: float
    half_h: float
    hps: float

    @staticmethod
    def make(resolution, vfov_degrees: float, aperture, origin, at, up,
             focus, device="cuda") -> "ThinLensCamera":
        return ThinLensCamera(
            _chan(origin, device), _chan(at, device), _chan(up, device),
            _chan(aperture, device), _chan(focus, device),
            *_frustum(resolution, vfov_degrees))

    def generate(self, ndc: torch.Tensor, time: torch.Tensor,
                 lens_uv: torch.Tensor):
        origin = self.origin.sample(time)
        at = self.at.sample(time)
        up = self.up.sample(time)
        focus = self.focus.sample(time)
        aperture = self.aperture.sample(time)   # [N, 1]
        focus_dist = vecmath.length(focus - origin, keepdim=True)
        u, v, w = _look_basis(origin, at, up)
        lower_left = (origin
                      - (u * self.half_w + v * self.half_h + w) * focus_dist)
        target = (lower_left
                  + u * _f32(2.0 * self.half_w) * focus_dist * ndc[:, 0:1]
                  + v * _f32(2.0 * self.half_h) * focus_dist * ndc[:, 1:2])
        rd = concentric_disk(lens_uv[:, 0], lens_uv[:, 1]) * aperture
        o = origin + (u * rd[:, 0:1] + v * rd[:, 1:2])
        return o, vecmath.normalize(target - o)

    def half_pixel_size_coeffs(self) -> tuple[float, float]:
        return 0.0, self.hps


class OrthographicCamera(NamedTuple):
    """Parallel-projection camera (reference src/camera.rs:215-285): an
    image plane `vertical_size` tall; every ray points along w."""
    origin: AnimChannel
    at: AnimChannel
    up: AnimChannel
    half_w: float
    half_h: float
    hps: float   # the constant half pixel size

    @staticmethod
    def make(resolution, vertical_size: float, origin, at, up,
             device="cuda") -> "OrthographicCamera":
        aspect = resolution[0] / resolution[1]
        return OrthographicCamera(
            _chan(origin, device), _chan(at, device), _chan(up, device),
            _f32(vertical_size * aspect / 2.0), _f32(vertical_size / 2.0),
            _f32(vertical_size / resolution[1] / 2.0))

    def generate(self, ndc: torch.Tensor, time: torch.Tensor,
                 lens_uv: torch.Tensor):
        origin = self.origin.sample(time)
        at = self.at.sample(time)
        up = self.up.sample(time)
        # the reference flips the basis here: w points forward
        # (src/camera.rs:262-264)
        w = vecmath.normalize(at - origin)
        u = vecmath.normalize(vecmath.cross(w, up))
        v = vecmath.cross(u, w)
        lower_left = origin - u * self.half_w - v * self.half_h
        o = (lower_left
             + u * _f32(2.0 * self.half_w) * ndc[:, 0:1]
             + v * _f32(2.0 * self.half_h) * ndc[:, 1:2])
        return o.contiguous(), w.expand(o.shape).contiguous()

    def half_pixel_size_coeffs(self) -> tuple[float, float]:
        """(abs, linear-in-t): a constant half pixel size."""
        return self.hps, 0.0


Camera = PinholeCamera | ThinLensCamera | OrthographicCamera
