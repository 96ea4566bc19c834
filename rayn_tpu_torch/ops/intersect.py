"""Scene-level closest hit, occlusion and shading info (port of
rayn_tpu.ops.intersect: closest_hit, test_occluded, shading_info).

Object ids: 0..K-1 = spheres in scene order, K + i = SDF instance i,
-1 = miss (reference src/hitable.rs:170-210). The spheres are plain
torch; each SDF instance marches, one a call, folded as JAX folds them,
through the kernels of ops/march_cuda.py (their plain twins for CPU
tensors) where `kernel_march_ok` holds, else with the torch march of
ops/march.py on the tensors' device, as JAX's jnp march. This unfused
path is what the segment-queue bounce runs, and the reference the fused
intersect kernel is held against.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rayn_tpu_torch.config import RenderSettings
from rayn_tpu_torch.ops import march as march_ops
from rayn_tpu_torch.ops import march_cuda
from rayn_tpu_torch.ops import sdf as sdf_ops
from rayn_tpu_torch.ops import spheres as sphere_ops
from rayn_tpu_torch.scene.scene import (SceneData, SceneStatic,
                                        sphere_center_of, sphere_centers_at)
from rayn_tpu_torch.utils import vecmath


class Hit(NamedTuple):
    t: torch.Tensor        # [N] distance (t_max or MISS-large on a miss)
    obj: torch.Tensor      # [N] int32 object id, -1 on a miss
    valid: torch.Tensor    # [N] bool


class ShadingInfo(NamedTuple):
    point: torch.Tensor      # [N, 3]
    normal: torch.Tensor     # [N, 3]
    offset_by: torch.Tensor  # [N] shadow/bounce ray origin bias
    mat: torch.Tensor        # [N] int32 material id


def kernel_march_ok(settings: RenderSettings, prog) -> bool:
    """Whether an instance of `prog` marches in a kernel: `use_pallas`
    and a program the kernels evaluate, as JAX's `_pallas_ok`
    (rayn_tpu/ops/intersect.py:33-41). Otherwise it marches in torch."""
    return settings.use_pallas and sdf_ops.kernel_ready(prog)


def kernel_occlusion_ok(settings: RenderSettings, prog) -> bool:
    """Whether an instance's shadow segments march in a kernel: also
    `use_pallas_occlusion` (rayn_tpu/ops/intersect.py:153-199)."""
    return settings.use_pallas_occlusion and kernel_march_ok(settings, prog)


def closest_hit(data: SceneData, static: SceneStatic,
                settings: RenderSettings, origin, direction, time, t_max,
                hps_abs, hps_lin, active) -> Hit:
    """Closest hit across all spheres and the SDF instances; instance i,
    in object order, is marched with the closest t so far as its t_max:
    where `kernel_march_ok`, by march_sorted with plain marching and
    `march_sort_steps` > 0 (as the JAX package routes it), else by the
    march kernel; otherwise by the torch march."""
    n = origin.shape[0]
    best_t = t_max
    best_obj = torch.full((n,), -1, dtype=torch.int32, device=origin.device)
    if static.n_spheres:
        centers = sphere_centers_at(data, time)
        ts = sphere_ops.hit(origin, direction, centers, data.sphere_radii,
                            t_max)
        sph_t, sph_id = torch.min(ts, dim=1)
        closer = sph_t < best_t
        best_t = torch.where(closer, sph_t, best_t)
        best_obj = torch.where(closer, sph_id.to(torch.int32), best_obj)
    detail = settings.sdf_detail_scale
    kw = dict(eps_const=5e-5 * detail, eps_abs=0.05 * detail * hps_abs,
              eps_lin=0.05 * detail * hps_lin,
              max_steps=settings.max_marches, active=active)
    # each instance in object order, marched up to the running closest
    # t; a tie keeps the earlier object
    for i, (prog, _mat, _bv) in enumerate(static.sdf_instances(data)):
        if not kernel_march_ok(settings, prog):
            t_sdf = march_ops.march(prog, origin, direction, best_t,
                                    relax=settings.march_relaxation, **kw)
        elif settings.march_sort_steps > 0 and settings.march_relaxation == 1:
            t_sdf = march_cuda.march_sorted(
                prog, origin, direction, best_t,
                phase1_steps=settings.march_sort_steps, **kw)
        else:
            t_sdf = march_cuda.march(prog, origin, direction, best_t,
                                     relax=settings.march_relaxation, **kw)
        closer = t_sdf < best_t
        best_t = torch.where(closer, t_sdf, best_t)
        best_obj = torch.where(closer, static.n_spheres + i, best_obj)
    return Hit(best_t, best_obj, active & (best_obj >= 0))


def test_occluded(data: SceneData, static: SceneStatic,
                  settings: RenderSettings, start, end, time, active,
                  segments: int = 1) -> torch.Tensor:
    """[M] f32 visibility (1 = visible, 0 = occluded) of shadow segments
    start -> end: the spheres first, then the SDF march of the segments
    still active and unblocked (reference src/hitable.rs:163-168).

    The SDF verdicts come from the first of these that applies, in the
    JAX package's order (rayn_tpu/ops/intersect.py:153-199):
    - an instance that fails `kernel_occlusion_ok`: the torch march
      (march_cuda.march_occlusion_plain, JAX's jnp march_occlusion, with
      the clip that `shadow_bv_clip` sets);
    - plain marching with `occl_sort_steps` > 0: march_occlusion_sorted;
    - plain marching with `occl_phase1_steps` > 0: march_occlusion_phased;
      these two march the whole segment with no bounding-sphere clip,
      whatever `shadow_bv_clip` says, as in the JAX package;
    - plain marching, `chained_shadow_march` and segments > 1 (the queue
      is `segments` equal groups concatenated segment-major, segment k of
      ray i at k * M / segments + i): march_occlusion_chained;
    - else march_occlusion.
    Both run the enqueue kernel and the refill march on the segments, so
    they give the same verdicts. The SDF instances fold as a product:
    each marches, with its own bound radius, only the segments that the
    spheres and the instances before it left unblocked. Every one marches
    its `sdf.reduced` program (a bare MandelBox truncated to
    `shadow_de_iterations` where that is set; JAX's prog.reduced,
    rayn_tpu/ops/intersect.py:151). The segment-queue bounce no longer
    calls this function (it marches its own scratch,
    integrator._queue_verdicts)."""
    s = settings
    m = start.shape[0]
    occluded = torch.zeros((m,), dtype=torch.bool, device=start.device)
    if static.n_spheres:
        occ = sphere_ops.occluded(start, end, sphere_centers_at(data, time),
                                  data.sphere_radii)
        occluded = occluded | occ.any(dim=1)
    detail = s.sdf_detail_scale * s.shadow_eps_scale
    for prog, _mat, inst_bv in static.sdf_instances(data):
        bv_r = float(inst_bv) if s.shadow_bv_clip else 0.0
        prog = sdf_ops.reduced(prog, s.shadow_de_iterations)
        m_act = active & ~occluded
        if not kernel_occlusion_ok(s, prog):
            occ_sdf = march_cuda.march_occlusion_plain(
                prog, start, end, detail, s.max_vis_marches, m_act,
                relax=s.march_relaxation, bound_radius=bv_r)
        elif s.march_relaxation == 1.0 and s.occl_sort_steps > 0:
            occ_sdf = march_cuda.march_occlusion_sorted(
                prog, start, end, detail, s.max_vis_marches,
                m_act, phase1_steps=s.occl_sort_steps)
        elif s.march_relaxation == 1.0 and s.occl_phase1_steps > 0:
            occ_sdf = march_cuda.march_occlusion_phased(
                prog, start, end, detail, s.max_vis_marches,
                m_act, phase1_steps=s.occl_phase1_steps)
        elif (1 < segments <= 30 and s.chained_shadow_march
                and s.march_relaxation == 1.0 and m % segments == 0):
            k, n = segments, m // segments
            occ_sdf = march_cuda.march_occlusion_chained(
                prog, start.reshape(k, n, 3),
                end.reshape(k, n, 3), detail, s.max_vis_marches,
                m_act.reshape(k, n), bound_radius=bv_r).reshape(m)
        else:
            occ_sdf = march_cuda.march_occlusion(
                prog, start, end, detail, s.max_vis_marches,
                m_act, relax=s.march_relaxation, bound_radius=bv_r)
        occluded = occluded | occ_sdf
    return torch.where(occluded, 0.0, 1.0)


def shading_info(data: SceneData, static: SceneStatic,
                 settings: RenderSettings, hit: Hit, origin, direction,
                 time, hps_abs, hps_lin) -> ShadingInfo:
    """Spheres: geometric normal, offset_by = 0 (reference
    src/sphere.rs:74-86). SDF: tetrahedral normal with
    eps = max(1e-4, detail * half_pixel_size_at(t)), offset_by = eps
    (reference src/sdf.rs:85-101)."""
    n = origin.shape[0]
    point = origin + hit.t[:, None] * direction
    normal = torch.zeros_like(point)
    offset_by = torch.zeros((n,), dtype=torch.float32, device=point.device)
    mat = torch.zeros((n,), dtype=torch.int32, device=point.device)
    if static.n_spheres:
        idx = torch.clamp(hit.obj, 0, static.n_spheres - 1)
        c = sphere_center_of(data, idx, time)
        sph_n = vecmath.normalize(point - c, eps=1e-20)
        is_sph = (hit.obj >= 0) & (hit.obj < static.n_spheres)
        normal = torch.where(is_sph[:, None], sph_n, normal)
        mat = torch.where(is_sph, data.sphere_mats[idx.long()], mat)
    if static.has_sdf:
        detail = settings.sdf_detail_scale
        hps = torch.clamp(detail * (hps_abs + hps_lin * hit.t), min=1e-4)
        for i, (prog, inst_mat, _bv) in enumerate(
                static.sdf_instances(data)):
            is_sdf = hit.obj == static.n_spheres + i
            sdf_n = sdf_ops.tetrahedral_normal(prog, point, hps)
            normal = torch.where(is_sdf[:, None], sdf_n, normal)
            offset_by = torch.where(is_sdf, hps, offset_by)
            mat = torch.where(is_sdf, inst_mat, mat)
    return ShadingInfo(point, normal, offset_by, mat)
