"""Carry a rayn_tpu scene and camera across to the port.

`scene` takes the JAX `SceneData` with every leaf already a numpy array
(`jax.tree.map(np.asarray, data)`), the JAX `SceneStatic` for its plain
facts (counts, flags, SDF material, bound radius) and the MandelBox
iteration count, which the JAX package keeps inside a closure. `camera`
takes a JAX `PinholeCamera`, `ThinLensCamera` or `OrthographicCamera`
with numpy leaves. Both packages then
render the same scene. Nothing here imports JAX: the inputs are read by
attribute name. Like every entry point of the port, both place their
tensors on the CUDA card unless the caller asks for another device.
"""

from __future__ import annotations

import numpy as np
import torch

from rayn_tpu_torch.ops.sdf import MandelBox
from rayn_tpu_torch.render.camera import (Camera, OrthographicCamera,
                                          PinholeCamera, ThinLensCamera)
from rayn_tpu_torch.scene.animation import AnimChannel
from rayn_tpu_torch.scene.scene import Materials, SceneData, SceneStatic


def _f32(x) -> float:
    return float(np.asarray(x, np.float32))


def _t(a, device, dtype=torch.float32):
    return torch.as_tensor(np.array(a), dtype=dtype, device=device)


def _channel(ch, device) -> AnimChannel:
    return AnimChannel(_t(ch.values, device), _f32(ch.t0), _f32(ch.t1))


def scene(data, static, sdf_iterations: int, device="cuda"):
    """(SceneData, SceneStatic) of the port from the JAX scene."""
    if static.extra_sdfs or getattr(data, "extra_sdf_params", ()):
        raise NotImplementedError(
            "more than one SDF instance is not ported yet")
    if static.mat_param_fns:
        raise NotImplementedError("mat_param_fns are not ported yet")
    mb = None
    if static.has_sdf:
        prm = data.sdf_params
        fields = ("scale", "box_l", "min_rad_sq", "fixed_rad_sq")
        if not all(hasattr(prm, f) for f in fields):
            raise NotImplementedError("only MandelBox SDFs are ported")
        mb = MandelBox(int(sdf_iterations),
                       *(_f32(getattr(prm, f)) for f in fields))
    m = data.materials
    out = SceneData(
        sphere_centers=_channel(data.sphere_centers, device),
        sphere_radii=_t(data.sphere_radii, device),
        sphere_mats=_t(data.sphere_mats, device, torch.int32),
        materials=Materials(
            kind=_t(m.kind, device, torch.int32),
            color_a=_t(m.color_a, device), color_b=_t(m.color_b, device),
            power=_t(m.power, device), ior=_t(m.ior, device)),
        light_pos=_channel(data.light_pos, device),
        light_radii=_t(data.light_radii, device),
        light_emission=_t(data.light_emission, device),
        sdf_params=mb,
        volume_sigma_s=_f32(data.volume_sigma_s),
        volume_sigma_t=_f32(data.volume_sigma_t),
        sphere_light=_t(data.sphere_light, device, torch.int32),
        light_paired=_t(data.light_paired, device))
    st = SceneStatic(
        n_spheres=int(static.n_spheres), n_lights=int(static.n_lights),
        n_materials=int(static.n_materials), has_sdf=bool(static.has_sdf),
        sdf_mat=int(static.sdf_mat),
        has_scattering=bool(static.has_scattering),
        has_extinction=bool(static.has_extinction),
        sdf_bound_radius=float(static.sdf_bound_radius))
    return out, st


_CAMERAS = {cls.__name__: cls for cls in (PinholeCamera, ThinLensCamera,
                                           OrthographicCamera)}


def camera(cam, device="cuda") -> Camera:
    """The port's camera of the same class from the JAX one (numpy
    leaves): every channel carried over, every scalar rounded to
    float32."""
    cls = _CAMERAS.get(type(cam).__name__)
    if cls is None or tuple(getattr(cam, "_fields", ())) != cls._fields:
        raise NotImplementedError(
            f"{type(cam).__name__}: only {sorted(_CAMERAS)} are ported")
    return cls(*(_channel(v, device) if hasattr(v, "values") else _f32(v)
                 for v in cam))
