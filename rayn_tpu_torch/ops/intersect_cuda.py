"""Fused closest hit + shading info, and the pre-intersect cost key:
CUDA kernels and plain twins (csrc/intersect.cu).

- `closest_hit_shading` replaces
  `rayn_tpu.ops.intersect_pallas.closest_hit_shading`
  (`_intersect_kernel`): the sphere fold, the march of each SDF instance
  bounded by the running closest t, the tetrahedral normal of the
  instance hit and the shading selects.
  The kernel is a refill march over the wavefront: persistent lanes each
  take a ray, run it to the end (entry DE, march steps, normal taps, one
  DE per loop iteration) and write its outputs to its own slot, so the
  order in which rays are taken changes no bit.
- `intersect_cost_key` replaces the XLA ops of
  `rayn_tpu.render.integrator._intersect_cost_key`: the pre-intersect
  chunk sort's estimate of each ray's march steps.

Both take every SDF instance of the scene: one bare MandelBox launches
the kernels' MBoxOnly instantiations, anything else their Tape ones
(csrc/common.cuh tape_de). Both take each ray's time: in a scene whose
sphere centers are animated the kernels (their `_anim_kernel`
instantiations) and the twins take every center at the ray's time, the
lerp of its knots; a constant scene never reads the time.

Each wrapper launches its kernel for CUDA tensors, counts the launch in
its `launches` attribute, and raises on anything the kernel does not
take; for CPU tensors it calls its `_plain` twin, which mirrors the
kernel's arithmetic.
"""

from __future__ import annotations

import ctypes

import torch

from rayn_tpu_torch import _build
from rayn_tpu_torch._build import MBox, check, device_of
from rayn_tpu_torch.ops import march as march_ops
from rayn_tpu_torch.ops.intersect import Hit, ShadingInfo
from rayn_tpu_torch.ops import spheres as sphere_ops
from rayn_tpu_torch.ops.sdf import TETRA_TAPS, dist, dist_c
from rayn_tpu_torch.ops.spheres import MISS
from rayn_tpu_torch.scene.animation import need_time, rows_at
from rayn_tpu_torch.scene.scene import sphere_center_of
from rayn_tpu_torch.utils.vecmath import sqrt as _sqrt


def sphere_table(data) -> torch.Tensor:
    """[K, 5] sphere rows (center xyz, radius, material id) on the
    scene's device; the center is knot 0 of its channel, which is the
    center of a constant channel (animated ones are read from the knots
    at each ray's time)."""
    return torch.cat([data.sphere_centers.values[:, 0, :],
                      data.sphere_radii[:, None],
                      data.sphere_mats.to(torch.float32)[:, None]],
                     dim=-1).contiguous()


def sphere_fold(data, static, settings, origin, direction, time=None):
    """(best t, best object) of the closest-hit sphere fold: the nearest
    sphere root in (1e-4, t_max0] (object -1 and t_max0 on a miss), the
    bound of the SDF march; the centers at each ray's time."""
    t_max0 = 2.0 * settings.world_radius
    ox, oy, oz = origin.unbind(-1)
    dx, dy, dz = direction.unbind(-1)
    best_t = torch.full_like(ox, t_max0)
    best_obj = torch.full(ox.shape, -1, dtype=torch.int32,
                          device=ox.device)
    centers = rows_at(data.sphere_centers, time, "sphere_fold")
    for k in range(static.n_spheres):
        cx, cy, cz = centers[..., k, :].unbind(-1)
        rad = data.sphere_radii[k]
        ocx, ocy, ocz = ox - cx, oy - cy, oz - cz
        b = ocx * dx + ocy * dy + ocz * dz
        c = ocx * ocx + ocy * ocy + ocz * ocz - rad * rad
        descrim = b * b - c
        desc_pos = descrim > 0.0
        ds = _sqrt(torch.clamp(descrim, min=0.0))
        t1, t2 = -b - ds, -b + ds
        t1v = (t1 > 1e-4) & (t1 <= t_max0) & desc_pos
        t2v = (t2 > 1e-4) & (t2 <= t_max0) & desc_pos
        tk = torch.where(t1v, t1, t2)
        tk = torch.where(t1v | t2v, tk, torch.full_like(tk, MISS))
        closer = tk < best_t
        best_t = torch.where(closer, tk, best_t)
        best_obj = torch.where(closer, k, best_obj)
    return best_t, best_obj


def closest_hit_shading_plain(data, static, settings, origin, direction,
                              hps_abs, hps_lin, active, time=None):
    """Plain twin of the kernel (intersect_pallas._intersect_kernel body):
    the sphere fold, the march of each SDF instance in object order
    bounded by the closest t so far, the four normal taps of the instance
    hit, then `write_hit_plain`; sphere centers at each ray's `time`."""
    K = static.n_spheres
    detail = settings.sdf_detail_scale
    best_t, best_obj = sphere_fold(data, static, settings, origin, direction,
                                   time)
    hps = g = None
    insts = static.sdf_instances(data)
    for i, (prog, _mat, _bv) in enumerate(insts):
        t_sdf = march_ops.march(
            prog, origin, direction, best_t,
            eps_const=5e-5 * detail, eps_abs=0.05 * detail * hps_abs,
            eps_lin=0.05 * detail * hps_lin,
            max_steps=settings.max_marches, active=active)
        closer = t_sdf < best_t
        best_t = torch.where(closer, t_sdf, best_t)
        best_obj = torch.where(closer, K + i, best_obj)
    if insts:
        hps = torch.clamp(detail * (hps_abs + hps_lin * best_t), min=1e-4)
        p = origin + best_t[:, None] * direction
        g = torch.zeros_like(p)
        for i, (prog, _mat, _bv) in enumerate(insts):
            idx = torch.nonzero(best_obj == K + i).squeeze(1)
            px, py, pz = p[idx].unbind(-1)
            h = hps[idx]
            gx = gy = gz = torch.zeros_like(px)
            for (kx, ky, kz) in TETRA_TAPS:
                dk = dist_c(prog, px + kx * h, py + ky * h, pz + kz * h)
                gx, gy, gz = gx + kx * dk, gy + ky * dk, gz + kz * dk
            g[idx] = torch.stack([gx, gy, gz], -1)
    return write_hit_plain(data, static, origin, direction, active, best_t,
                           best_obj, hps, g, time)


def write_hit_plain(data, static, origin, direction, active, best_t,
                    best_obj, hps, g, time=None):
    """(Hit, ShadingInfo) of each ray from its closest t and object (the
    kernel's write_hit): the point; a sphere's normal (its center at the
    ray's time) and material; for SDF instance i (object K + i) the
    normalised tap gradient g [N, 3], the instance's material and the
    offset hps (g and hps None in a scene without an SDF); zeros on a
    miss."""
    K = static.n_spheres
    ox, oy, oz = origin.unbind(-1)
    dx, dy, dz = direction.unbind(-1)
    px, py, pz = ox + best_t * dx, oy + best_t * dy, oz + best_t * dz
    zero = torch.zeros_like(px)
    nx, ny, nz, off = zero, zero, zero, zero
    mat = torch.zeros_like(best_obj)
    if K:
        is_sph = (best_obj >= 0) & (best_obj < K)
        idx = torch.clamp(best_obj, 0, K - 1).long()
        row = sphere_table(data)[idx]
        if data.sphere_centers.knots > 1:
            c = sphere_center_of(data, idx, need_time(time, "write_hit"))
        else:
            c = row[:, :3]
        vx, vy, vz = px - c[:, 0], py - c[:, 1], pz - c[:, 2]
        vlen = _sqrt(vx * vx + vy * vy + vz * vz)
        vinv = 1.0 / torch.clamp(vlen, min=1e-20)
        nx = torch.where(is_sph, vx * vinv, nx)
        ny = torch.where(is_sph, vy * vinv, ny)
        nz = torch.where(is_sph, vz * vinv, nz)
        mat = torch.where(is_sph, row[:, 4].to(torch.int32), mat)
    if static.has_sdf:
        is_sdf = best_obj >= K
        gx, gy, gz = g.unbind(-1)
        glen = _sqrt(gx * gx + gy * gy + gz * gz)
        ginv = 1.0 / torch.clamp(glen, min=1e-20)
        nx = torch.where(is_sdf, gx * ginv, nx)
        ny = torch.where(is_sdf, gy * ginv, ny)
        nz = torch.where(is_sdf, gz * ginv, nz)
        for i, (_prog, inst_mat, _bv) in enumerate(
                static.sdf_instances(data)):
            mat = torch.where(best_obj == K + i, inst_mat, mat)
        off = torch.where(is_sdf, hps, off)
    hit = Hit(best_t, best_obj, active & (best_obj >= 0))
    info = ShadingInfo(torch.stack([px, py, pz], -1),
                       torch.stack([nx, ny, nz], -1), off, mat)
    return hit, info


def intersect_cost_key_plain(data, static, settings, origin, direction,
                             time, alive):
    """Plain twin of the cost-key kernel (JAX integrator.py:144-175):
    estimated primary-march steps per ray before the intersect, for each
    SDF instance the sphere-fold closest t (at most t_max0) over its
    first DE, at most max_marches, or 1 for a dead ray or a NaN first DE;
    summed over the instances from 0."""
    n = origin.shape[0]
    t_max0 = 2.0 * settings.world_radius
    full = torch.full((n,), t_max0, dtype=torch.float32,
                      device=origin.device)
    if static.n_spheres:
        ts = sphere_ops.hit(origin, direction,
                            rows_at(data.sphere_centers, time, "cost key"),
                            data.sphere_radii, full)
        bound = torch.clamp(ts.min(dim=-1).values, max=t_max0)
    else:
        bound = full
    key = torch.zeros_like(bound)
    for prog, _mat, _bv in static.sdf_instances(data):
        d0 = dist(prog, origin)
        est = torch.clamp(bound / torch.clamp(d0, min=1e-6),
                          max=float(settings.max_marches))
        ok = alive & ~torch.isnan(d0)
        key = key + torch.where(ok, est, torch.ones_like(est))
    return key


_P = ctypes.c_void_p


class _IntersectArgs(ctypes.Structure):
    _fields_ = [(name, _P) for name in (
        "origin", "direction", "hps_abs", "hps_lin", "active", "time",
        "spheres", "head", "warp_steps", "t", "obj", "point", "normal",
        "offset_by", "mat")] + [
        ("n", ctypes.c_int64), ("K", ctypes.c_int), ("has_sdf", ctypes.c_int),
        ("sdf_mat", ctypes.c_int), ("max_steps", ctypes.c_int),
        ("mb", MBox), ("t_max0", ctypes.c_float),
        ("eps_const", ctypes.c_float), ("eps_k", ctypes.c_float),
        ("detail", ctypes.c_float), ("anim", _build.Anim)]


class _CostKeyArgs(ctypes.Structure):
    _fields_ = [(name, _P) for name in (
        "origin", "direction", "alive", "time", "spheres", "key")] + [
        ("n", ctypes.c_int64), ("K", ctypes.c_int),
        ("max_steps", ctypes.c_int), ("mb", MBox),
        ("t_max0", ctypes.c_float), ("anim", _build.Anim)]


def _time_and_anim(data, static, time, n, dev, what):
    """(time pointer, Anim) of a kernel that reads sphere centers: the
    centers' track, and each ray's time where they are animated (else
    null: the constant kernels never read it)."""
    ch = data.sphere_centers
    anim = _build.Anim(lights=_build.track(None, "", 0, dev),
                       spheres=_build.track(ch, "sphere knots",
                                            static.n_spheres, dev),
                       mis=_build.track(None, "", 0, dev))
    if ch.knots == 1:
        return None, anim
    return check(need_time(time, what), "time", torch.float32, (n,),
                 dev), anim


def closest_hit_shading(data, static, settings, origin, direction, hps_abs,
                        hps_lin, active, time=None, warp_steps=None):
    """(Hit, ShadingInfo) of the closest hit along each ray; `time` [N]:
    each ray's time, which a scene with animated sphere centers needs.
    warp_steps: for measurement, a [1] int64 CUDA tensor to which the
    kernel adds the loop iterations of its warps (each iteration one DE
    per busy lane)."""
    dev = device_of("closest_hit_shading", origin)
    if dev is None:
        return closest_hit_shading_plain(data, static, settings, origin,
                                         direction, hps_abs, hps_lin, active,
                                         time)
    n = origin.shape[0]
    if n >= 2 ** 31 - 32:
        raise ValueError(f"{n} rays overflow the kernel's int32 ray ids")
    f32 = torch.float32
    spheres = sphere_table(data)
    t = torch.empty((n,), dtype=f32, device=dev)
    obj = torch.empty((n,), dtype=torch.int32, device=dev)
    point = torch.empty((n, 3), dtype=f32, device=dev)
    normal = torch.empty((n, 3), dtype=f32, device=dev)
    off = torch.empty((n,), dtype=f32, device=dev)
    mat = torch.empty((n,), dtype=torch.int32, device=dev)
    detail = settings.sdf_detail_scale
    head = torch.zeros((1,), dtype=torch.int32, device=dev)
    time_p, anim = _time_and_anim(data, static, time, n, dev,
                                  "closest_hit_shading")
    mb, sdf = _build.sdf_args(static.sdf_instances(data), dev, n)
    args = _IntersectArgs(
        origin=check(origin, "origin", f32, (n, 3), dev),
        direction=check(direction, "direction", f32, (n, 3), dev),
        hps_abs=check(hps_abs, "hps_abs", f32, (n,), dev),
        hps_lin=check(hps_lin, "hps_lin", f32, (n,), dev),
        active=check(active, "active", torch.bool, (n,), dev), time=time_p,
        spheres=check(spheres, "spheres", f32, (static.n_spheres, 5), dev),
        head=head.data_ptr(),
        warp_steps=(None if warp_steps is None else
                    check(warp_steps, "warp_steps", torch.int64, (1,), dev)),
        t=t.data_ptr(), obj=obj.data_ptr(), point=point.data_ptr(),
        normal=normal.data_ptr(), offset_by=off.data_ptr(),
        mat=mat.data_ptr(), n=n, K=static.n_spheres,
        has_sdf=int(static.has_sdf), sdf_mat=static.sdf_mat,
        max_steps=settings.max_marches, mb=mb,
        t_max0=2.0 * settings.world_radius, eps_const=5e-5 * detail,
        eps_k=0.05 * detail, detail=detail, anim=anim)
    _build.launch("rayn_closest_hit", _build.taped(args, sdf), dev)
    closest_hit_shading.launches += 1
    return (Hit(t, obj, active & (obj >= 0)),
            ShadingInfo(point, normal, off, mat))


closest_hit_shading.launches = 0


def intersect_cost_key(data, static, settings, origin, direction, time,
                       alive) -> torch.Tensor:
    """[N] f32 estimate of each ray's primary-march steps, the key of the
    pre-intersect chunk sort (scheduling only), the sphere centers at
    each ray's `time`. The scene must have an SDF."""
    dev = device_of("intersect_cost_key", origin)
    if dev is None:
        return intersect_cost_key_plain(data, static, settings, origin,
                                        direction, time, alive)
    if not static.has_sdf:
        raise NotImplementedError("intersect_cost_key needs a scene with an "
                                  "SDF")
    n = origin.shape[0]
    f32 = torch.float32
    spheres = sphere_table(data)
    key = torch.empty((n,), dtype=f32, device=dev)
    time_p, anim = _time_and_anim(data, static, time, n, dev,
                                  "intersect_cost_key")
    mb, sdf = _build.sdf_args(static.sdf_instances(data), dev, n,
                              persistent=False)
    args = _CostKeyArgs(
        origin=check(origin, "origin", f32, (n, 3), dev),
        direction=check(direction, "direction", f32, (n, 3), dev),
        alive=check(alive, "alive", torch.bool, (n,), dev), time=time_p,
        spheres=check(spheres, "spheres", f32, (static.n_spheres, 5), dev),
        key=key.data_ptr(), n=n, K=static.n_spheres,
        max_steps=settings.max_marches, mb=mb,
        t_max0=2.0 * settings.world_radius, anim=anim)
    _build.launch("rayn_cost_key", _build.taped(args, sdf), dev)
    intersect_cost_key.launches += 1
    return key


intersect_cost_key.launches = 0
