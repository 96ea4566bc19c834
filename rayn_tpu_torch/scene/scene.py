"""Scene representation and builder (port of rayn_tpu.scene.scene).

All spheres live in one batched center store, all materials in one
tagged parameter table, all lights in one array, so every stage of the
wavefront is a dense gather instead of a virtual call per object
(reference src/world.rs:7-13, src/setup.rs:46-170).

`SceneBuilder.build(device)` returns `(SceneData, SceneStatic)`:
SceneData holds the tensors, on `device` (CUDA unless the caller asks
for another device), and the SDF programs (ops/sdf.py); SceneStatic
holds the counts, flags, each SDF instance's material and bound radius
and the materials' per-point albedo functions. Any number of SDF
instances, each any program of the SDF library or a user-written
closure (ops/sdf.py SdfProgram), as in the JAX package (`add_sdf`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from rayn_tpu_torch.ops import sdf as sdf_ops
from rayn_tpu_torch.scene.animation import (AnimChannel, sample_batched,
                                            sample_batched_at, stack_channels)

# Material kinds (reference src/material.rs: Lambertian :85, Dielectric
# :144, Sky :394, Emissive :451), plus the working Metallic/Refractive.
LAMBERT = 0
DIELECTRIC = 1
SKY = 2
EMISSIVE = 3
METALLIC = 4
REFRACTIVE = 5


class Materials(NamedTuple):
    kind: torch.Tensor      # [M] int32
    color_a: torch.Tensor   # [M, 3] albedo / F0 (metallic) / sky top
    color_b: torch.Tensor   # [M, 3] emission (emissive) or sky bottom
    power: torch.Tensor     # [M] Phong exponent
    ior: torch.Tensor       # [M] index of refraction


class SceneData(NamedTuple):
    """All per-scene tensors (on one device) and the SDF programs."""
    sphere_centers: AnimChannel   # values [K, T, 3]
    sphere_radii: torch.Tensor    # [K]
    sphere_mats: torch.Tensor     # [K] int32
    materials: Materials
    light_pos: AnimChannel        # values [L, T, 3]
    light_radii: torch.Tensor     # [L]
    light_emission: torch.Tensor  # [L, 3]
    sdf_params: Optional[tuple]   # the first SDF instance's program
    volume_sigma_s: float         # float32-rounded; 0 when disabled
    volume_sigma_t: float
    sphere_light: torch.Tensor    # [K] int32 paired light id, -1 = none
    light_paired: torch.Tensor    # [L] f32 1.0 if the light has a pair
    # programs of the SDF instances beyond the first (SceneStatic
    # .extra_sdfs holds their materials and bounds, in the same order)
    extra_sdf_params: tuple = ()

    @property
    def device(self) -> torch.device:
        return self.sphere_radii.device


@dataclasses.dataclass(frozen=True)
class SdfInstanceStatic:
    """Material and bound radius of an SDF instance past the first (the
    first's are SceneStatic's sdf_* fields)."""
    mat: int
    bound_radius: float = 0.0


@dataclasses.dataclass(frozen=True)
class SceneStatic:
    """Counts and flags of a scene."""
    n_spheres: int
    n_lights: int
    n_materials: int
    has_sdf: bool
    sdf_mat: int                 # material id of the SDF surface
    has_scattering: bool
    has_extinction: bool
    # radius of an origin-centred sphere that contains the SDF's
    # {|DE| < eps} shell; 0 = unknown (no shadow-segment clip)
    sdf_bound_radius: float = 0.0
    # SDF instances beyond the first (SdfInstanceStatic each); object ids
    # follow the spheres: instance i is object n_spheres + i
    extra_sdfs: tuple = ()
    # (material id, fn(point [N, 3], normal [N, 3]) -> albedo [N, 3]) in
    # material order: color_a of that material at each shading point
    # (SceneBuilder.set_albedo_fn)
    mat_param_fns: tuple = ()

    def sdf_instances(self, data: SceneData) -> list:
        """Every SDF instance as (program, material id, bound radius) in
        object-id order: the closest-hit and occlusion fold domain
        (reference src/hitable.rs:163-210)."""
        if not self.has_sdf:
            return []
        return [(data.sdf_params, self.sdf_mat, self.sdf_bound_radius)] + [
            (prog, inst.mat, inst.bound_radius)
            for prog, inst in zip(data.extra_sdf_params, self.extra_sdfs)]


def sphere_centers_at(data: SceneData, time: torch.Tensor) -> torch.Tensor:
    """[N, K, 3] sphere centers at each ray's time."""
    return sample_batched(data.sphere_centers, time)


def sphere_center_of(data: SceneData, obj_idx, time) -> torch.Tensor:
    """[N, 3] center of per-ray sphere obj_idx at each ray's time."""
    return sample_batched_at(data.sphere_centers, obj_idx, time)


def light_position_of(data: SceneData, light_idx, time) -> torch.Tensor:
    """[N, 3] center of per-ray light light_idx at each ray's time."""
    return sample_batched_at(data.light_pos, light_idx, time)


def light_positions_at(data: SceneData, time: torch.Tensor) -> torch.Tensor:
    """[N, L, 3] light centers at each ray's time."""
    return sample_batched(data.light_pos, time)


def _f32(x) -> float:
    return float(np.float32(x))


def _as_channel(value) -> AnimChannel:
    if isinstance(value, AnimChannel):
        return value
    # staged on the host; build() moves every channel to its device
    return AnimChannel.constant(np.asarray(value, np.float32), "cpu")


class SceneBuilder:
    """Imperative scene construction mirroring the reference `setup()`
    (src/setup.rs:46-170); `build(device)` freezes it into tensors."""

    def __init__(self):
        self._mat_kind: list[int] = []
        self._mat_a: list[np.ndarray] = []
        self._mat_b: list[np.ndarray] = []
        self._mat_power: list[float] = []
        self._mat_ior: list[float] = []
        self._sphere_centers: list[AnimChannel] = []
        self._sphere_radii: list[float] = []
        self._sphere_mats: list[int] = []
        self._light_pos: list[AnimChannel] = []
        self._light_radii: list[float] = []
        self._light_emission: list[np.ndarray] = []
        self._sdf = None
        self._sdf_mat = -1
        self._sdf_bound = 0.0
        self._extra_sdfs: list = []   # (program, material, bound radius)
        self._sigma_s: Optional[float] = None
        self._sigma_t: Optional[float] = None
        self._pairs: dict[int, int] = {}
        self._mat_fns: dict[int, Callable] = {}

    def _add_material(self, kind, a, b, power, ior=1.0) -> int:
        self._mat_kind.append(kind)
        self._mat_a.append(np.asarray(a, np.float32))
        self._mat_b.append(np.asarray(b, np.float32))
        self._mat_power.append(float(power))
        self._mat_ior.append(float(ior))
        return len(self._mat_kind) - 1

    def add_lambertian(self, albedo) -> int:
        return self._add_material(LAMBERT, albedo, np.zeros(3), 0.0)

    def add_dielectric(self, albedo, roughness: float) -> int:
        """Roughness remapped like `Dielectric::new_remap`
        (src/material.rs:166-174): power = 1 + (1-r)^4 * 300."""
        r = 1.0 - roughness
        return self._add_material(DIELECTRIC, albedo, np.zeros(3),
                                  1.0 + (r ** 4) * 300.0)

    def add_metallic(self, f0, roughness: float) -> int:
        r = 1.0 - roughness
        return self._add_material(METALLIC, f0, np.zeros(3),
                                  1.0 + (r ** 4) * 300.0)

    def add_refractive(self, refract_color, roughness: float,
                       ior: float) -> int:
        return self._add_material(REFRACTIVE, refract_color, np.zeros(3),
                                  0.0, ior)

    def add_sky(self, top, bottom) -> int:
        return self._add_material(SKY, top, bottom, 0.0)

    def add_emissive(self, emission) -> int:
        return self._add_material(EMISSIVE, np.zeros(3), emission, 0.0)

    def set_albedo_fn(self, material: int, fn: Callable) -> None:
        """Make `material`'s albedo (color_a) vary per shading point: the
        reference's `Material<G: WShadingParamGenerator>` (src/material.rs:
        75-83, read by get_bsdf_at :31-38). `fn(point [N, 3], normal
        [N, 3]) -> [N, 3]` is a torch function that works lane by lane;
        it replaces the material table's color_a wherever a lane shades
        with this material (NEE, emission, scatter, the albedo AOV), on
        every path of the integrator."""
        self._mat_fns[int(material)] = fn

    def add_sphere(self, center, radius: float, material: int) -> int:
        self._sphere_centers.append(_as_channel(center))
        self._sphere_radii.append(float(radius))
        self._sphere_mats.append(int(material))
        return len(self._sphere_radii) - 1

    def set_sdf(self, program, material: int,
                bound_radius: float = 0.0) -> None:
        """Attach THE traced SDF, replacing any added before (reference
        src/sdf.rs:12-21). `program`: any program of ops/sdf.py, of
        any depth, or a user-written sdf.SdfProgram (in the kernels
        when sdf.kernel_ready, else on the route without the fused
        kernels, as in JAX without fn_c); bound_radius: the
        radius of an origin-centred sphere that contains its hit shell
        (0 = unknown: no shadow-segment clip). Anything else raises
        NotImplementedError."""
        sdf_ops.check(program)
        self._sdf = program
        self._sdf_mat = int(material)
        self._sdf_bound = float(bound_radius)
        self._extra_sdfs = []

    def add_sdf(self, program, material: int,
                bound_radius: float = 0.0) -> int:
        """Append an SDF instance with its own material (reference
        src/hitable.rs:143-161); returns its offset in the instances
        (object id n_spheres + offset)."""
        if self._sdf is None:
            self.set_sdf(program, material, bound_radius)
            return 0
        sdf_ops.check(program)
        self._extra_sdfs.append(
            (program, int(material), float(bound_radius)))
        return len(self._extra_sdfs)

    def add_sphere_light(self, pos, radius: float, emission) -> int:
        self._light_pos.append(_as_channel(pos))
        self._light_radii.append(float(radius))
        self._light_emission.append(np.asarray(emission, np.float32))
        return len(self._light_radii) - 1

    def pair_light(self, light: int, sphere: int) -> None:
        """Declare sphere `sphere` the visible body of light `light`."""
        self._pairs[int(sphere)] = int(light)

    def set_volume(self, coeff_scattering: Optional[float],
                   coeff_extinction: Optional[float]) -> None:
        self._sigma_s = coeff_scattering
        self._sigma_t = coeff_extinction

    def _mis_pairs(self, k: int, n_lights: int):
        """Explicit pairs plus auto-detected co-located emissive
        sphere / light pairs (reference src/setup.rs:107-122)."""
        sphere_light = np.full((k,), -1, np.int32)
        for sph, lt in self._pairs.items():
            sphere_light[sph] = lt
        for sph in range(k):
            if sphere_light[sph] >= 0:
                continue
            if self._mat_kind[self._sphere_mats[sph]] != EMISSIVE:
                continue
            c = self._sphere_centers[sph]
            for lt in range(n_lights):
                p = self._light_pos[lt]
                cv = c.values.cpu().numpy()
                pv = p.values.cpu().numpy()
                if (cv.shape == pv.shape and np.allclose(cv, pv)
                        and np.allclose(c.t0, p.t0)
                        and np.allclose(c.t1, p.t1)):
                    sphere_light[sph] = lt
                    break
        light_paired = np.zeros((n_lights,), np.float32)
        light_paired[sphere_light[sphere_light >= 0]] = 1.0
        return sphere_light, light_paired

    def build(self, device="cuda") -> tuple[SceneData, SceneStatic]:
        if not self._mat_kind:
            raise ValueError("scene has no materials")

        def t(a, dtype=torch.float32):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

        def chan(chs):
            if not chs:
                return AnimChannel(t(np.zeros((0, 1, 3), np.float32)),
                                   0.0, 1.0)
            st = stack_channels(chs)
            return AnimChannel(st.values.to(device), st.t0, st.t1)

        k = len(self._sphere_radii)
        n_lights = len(self._light_radii)
        sphere_light, light_paired = self._mis_pairs(k, n_lights)
        materials = Materials(
            kind=t(self._mat_kind, torch.int32),
            color_a=t(np.stack(self._mat_a)),
            color_b=t(np.stack(self._mat_b)),
            power=t(np.asarray(self._mat_power, np.float32)),
            ior=t(np.asarray(self._mat_ior, np.float32)))
        emission = (np.stack(self._light_emission) if n_lights
                    else np.zeros((0, 3), np.float32))
        data = SceneData(
            sphere_centers=chan(self._sphere_centers),
            sphere_radii=t(np.asarray(self._sphere_radii, np.float32)),
            sphere_mats=t(np.asarray(self._sphere_mats, np.int32),
                          torch.int32),
            materials=materials,
            light_pos=chan(self._light_pos),
            light_radii=t(np.asarray(self._light_radii, np.float32)),
            light_emission=t(emission),
            sdf_params=(None if self._sdf is None
                        else sdf_ops.to_device(self._sdf, device)),
            volume_sigma_s=_f32(self._sigma_s or 0.0),
            volume_sigma_t=_f32(self._sigma_t or 0.0),
            sphere_light=t(sphere_light, torch.int32),
            light_paired=t(light_paired),
            extra_sdf_params=tuple(sdf_ops.to_device(p, device)
                                   for p, _m, _b in self._extra_sdfs))
        static = SceneStatic(
            n_spheres=k, n_lights=n_lights,
            n_materials=len(self._mat_kind),
            has_sdf=self._sdf is not None, sdf_mat=self._sdf_mat,
            has_scattering=self._sigma_s is not None,
            has_extinction=self._sigma_t is not None,
            sdf_bound_radius=self._sdf_bound,
            extra_sdfs=tuple(SdfInstanceStatic(m, b)
                             for _p, m, b in self._extra_sdfs),
            mat_param_fns=tuple(sorted(self._mat_fns.items(),
                                       key=lambda kv: kv[0])))
        return data, static
