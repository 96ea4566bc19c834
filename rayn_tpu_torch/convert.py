"""Carry a rayn_tpu scene and camera across to the port.

`scene` takes the JAX `SceneData` with every leaf already a numpy array
(`jax.tree.map(np.asarray, data)`), the JAX `SceneStatic` for its plain
facts (counts, flags, each SDF instance's material and bound radius)
and the structure of each SDF instance's program, which the JAX package
keeps inside closures: the port's program of each instance (ops/sdf.py,
any parameter values, or a user-written `SdfProgram` with torch code),
whose leaves are then filled from JAX's parameter leaves in pytree
order, or for a bare MandelBox just its
iteration count. A material's albedo function is a jnp closure in the
JAX scene; `scene` takes its torch counterpart by material id
(`albedo_fns=`). `camera`
takes a JAX `PinholeCamera`, `ThinLensCamera` or `OrthographicCamera`
with numpy leaves. Both packages then
render the same scene. Nothing here imports JAX: the inputs are read by
attribute name. Like every entry point of the port, both place their
tensors on the CUDA card unless the caller asks for another device.
"""

from __future__ import annotations

import numpy as np
import torch

from rayn_tpu_torch.ops import sdf as sdf_ops
from rayn_tpu_torch.render.camera import (Camera, OrthographicCamera,
                                          PinholeCamera, ThinLensCamera)
from rayn_tpu_torch.scene.animation import AnimChannel
from rayn_tpu_torch.scene.scene import (Materials, SceneData, SceneStatic,
                                        SdfInstanceStatic)


def _f32(x) -> float:
    return float(np.asarray(x, np.float32))


def _t(a, device, dtype=torch.float32):
    return torch.as_tensor(np.array(a), dtype=dtype, device=device)


def _channel(ch, device) -> AnimChannel:
    return AnimChannel(_t(ch.values, device), _f32(ch.t0), _f32(ch.t1))


_MANDELBOX_FIELDS = ("scale", "box_l", "min_rad_sq", "fixed_rad_sq")


def _programs(data, static, sdf_iterations, programs, device) -> list:
    """The port's program of every SDF instance of the JAX scene, its
    leaves taken from JAX's parameters."""
    params = [data.sdf_params, *getattr(data, "extra_sdf_params", ())]
    if len(params) != 1 + len(static.extra_sdfs):
        raise ValueError("extra_sdf_params and extra_sdfs disagree")
    if programs is None:
        prm = data.sdf_params
        if (sdf_iterations is None or len(params) != 1
                or not all(hasattr(prm, f) for f in _MANDELBOX_FIELDS)):
            raise NotImplementedError(
                "pass the port's program of each SDF instance (programs=); "
                "sdf_iterations alone describes one bare MandelBox")
        programs = [sdf_ops.MandelBox(
            int(sdf_iterations), *(0.0 for _ in _MANDELBOX_FIELDS))]
    elif isinstance(programs, sdf_ops.PROGRAM_TYPES):
        programs = [programs]
    programs = list(programs)
    if len(programs) != len(params):
        raise ValueError(f"{len(programs)} programs for {len(params)} SDF "
                         "instances")
    return [sdf_ops.to_device(sdf_ops.with_leaves(
        sdf_ops.check(p), sdf_ops.param_leaves(prm)), device)
        for p, prm in zip(programs, params)]


def _albedo_fns(static, albedo_fns) -> tuple:
    """SceneStatic.mat_param_fns of the port: the torch function of each
    material that has a JAX albedo function, in material order."""
    want = sorted(int(mid) for mid, _fn in static.mat_param_fns)
    given = {int(mid): fn for mid, fn in (albedo_fns or {}).items()}
    missing = [mid for mid in want if mid not in given]
    if missing:
        raise ValueError(f"materials {missing} have a JAX albedo function; "
                         "pass its torch counterpart (albedo_fns=)")
    unknown = sorted(set(given) - set(want))
    if unknown:
        raise ValueError(f"albedo_fns names materials {unknown}, which have "
                         "no albedo function in the JAX scene")
    return tuple((mid, given[mid]) for mid in want)


def scene(data, static, sdf_iterations: int | None = None, device="cuda",
          programs=None, albedo_fns=None):
    """(SceneData, SceneStatic) of the port from the JAX scene.

    programs: the port's program of each SDF instance in object order
    (one program for a one-instance scene), whose parameter values are
    replaced by JAX's leaves (a user-written sdf.SdfProgram's params
    too, leaf for leaf in JAX's pytree order, its tensors on `device`);
    a leaf count that differs raises ValueError, anything that is not a
    program NotImplementedError. Without it, `sdf_iterations` gives the one bare
    MandelBox of a one-instance scene. albedo_fns: {material id: torch
    fn(point, normal) -> albedo} for every material with an albedo
    function in the JAX scene (SceneBuilder.set_albedo_fn); a material
    left out, or one the JAX scene gives no function, raises
    ValueError."""
    fns = _albedo_fns(static, albedo_fns)
    progs = (_programs(data, static, sdf_iterations, programs, device)
             if static.has_sdf else [None])
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
        sdf_params=progs[0],
        volume_sigma_s=_f32(data.volume_sigma_s),
        volume_sigma_t=_f32(data.volume_sigma_t),
        sphere_light=_t(data.sphere_light, device, torch.int32),
        light_paired=_t(data.light_paired, device),
        extra_sdf_params=tuple(progs[1:]))
    st = SceneStatic(
        n_spheres=int(static.n_spheres), n_lights=int(static.n_lights),
        n_materials=int(static.n_materials), has_sdf=bool(static.has_sdf),
        sdf_mat=int(static.sdf_mat),
        has_scattering=bool(static.has_scattering),
        has_extinction=bool(static.has_extinction),
        sdf_bound_radius=float(static.sdf_bound_radius),
        extra_sdfs=tuple(SdfInstanceStatic(int(e.mat),
                                           float(e.bound_radius))
                         for e in static.extra_sdfs),
        mat_param_fns=fns)
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
