"""Fused closest hit + shading info: CUDA kernel and plain twin.

Port of `rayn_tpu.ops.intersect_pallas.closest_hit_shading`
(`_intersect_kernel`): the sphere fold, the MandelBox march bounded by
the running closest t, the tetrahedral normal and the shading selects
in one pass (csrc/intersect.cu). `closest_hit_shading` launches the
kernel for CUDA tensors, counts the launch in its `launches` attribute,
and raises on anything the kernel does not take; for CPU tensors it
calls `closest_hit_shading_plain`, which mirrors the kernel body.
"""

from __future__ import annotations

import ctypes

import torch

from rayn_tpu_torch import _build
from rayn_tpu_torch._build import MBox, check, mbox_struct
from rayn_tpu_torch.ops import march as march_ops
from rayn_tpu_torch.ops.intersect import Hit, ShadingInfo
from rayn_tpu_torch.ops.sdf import TETRA_TAPS, dist_c
from rayn_tpu_torch.ops.spheres import MISS
from rayn_tpu_torch.utils.vecmath import sqrt as _sqrt


def sphere_table(data) -> torch.Tensor:
    """[K, 5] sphere rows (center xyz, radius, material id) on the
    scene's device, from the constant (knot 0) center channel."""
    return torch.cat([data.sphere_centers.values[:, 0, :],
                      data.sphere_radii[:, None],
                      data.sphere_mats.to(torch.float32)[:, None]],
                     dim=-1).contiguous()


def closest_hit_shading_plain(data, static, settings, origin, direction,
                              hps_abs, hps_lin, active):
    """Plain twin of the kernel (intersect_pallas._intersect_kernel body)."""
    K = static.n_spheres
    t_max0 = 2.0 * settings.world_radius
    detail = settings.sdf_detail_scale
    ox, oy, oz = origin.unbind(-1)
    dx, dy, dz = direction.unbind(-1)
    best_t = torch.full_like(ox, t_max0)
    best_obj = torch.full(ox.shape, -1, dtype=torch.int32,
                          device=ox.device)
    spheres = sphere_table(data)
    for k in range(K):
        cx, cy, cz, rad, _mat = spheres[k].unbind(-1)
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
    if static.has_sdf:
        t_sdf = march_ops.march(
            data.sdf_params, origin, direction, best_t,
            eps_const=5e-5 * detail, eps_abs=0.05 * detail * hps_abs,
            eps_lin=0.05 * detail * hps_lin,
            max_steps=settings.max_marches, active=active)
        closer = t_sdf < best_t
        best_t = torch.where(closer, t_sdf, best_t)
        best_obj = torch.where(closer, K, best_obj)

    px, py, pz = ox + best_t * dx, oy + best_t * dy, oz + best_t * dz
    zero = torch.zeros_like(px)
    nx, ny, nz, off = zero, zero, zero, zero
    mat = torch.zeros_like(best_obj)
    if K:
        is_sph = (best_obj >= 0) & (best_obj < K)
        row = spheres[torch.clamp(best_obj, 0, K - 1).long()]
        vx, vy, vz = px - row[:, 0], py - row[:, 1], pz - row[:, 2]
        vlen = _sqrt(vx * vx + vy * vy + vz * vz)
        vinv = 1.0 / torch.clamp(vlen, min=1e-20)
        nx = torch.where(is_sph, vx * vinv, nx)
        ny = torch.where(is_sph, vy * vinv, ny)
        nz = torch.where(is_sph, vz * vinv, nz)
        mat = torch.where(is_sph, row[:, 4].to(torch.int32), mat)
    if static.has_sdf:
        hps = torch.clamp(detail * (hps_abs + hps_lin * best_t), min=1e-4)
        is_sdf = best_obj == K
        gx, gy, gz = zero, zero, zero
        for (kx, ky, kz) in TETRA_TAPS:
            dk = dist_c(data.sdf_params, px + kx * hps, py + ky * hps,
                        pz + kz * hps)
            gx, gy, gz = gx + kx * dk, gy + ky * dk, gz + kz * dk
        glen = _sqrt(gx * gx + gy * gy + gz * gz)
        ginv = 1.0 / torch.clamp(glen, min=1e-20)
        nx = torch.where(is_sdf, gx * ginv, nx)
        ny = torch.where(is_sdf, gy * ginv, ny)
        nz = torch.where(is_sdf, gz * ginv, nz)
        mat = torch.where(is_sdf, static.sdf_mat, mat)
        off = torch.where(is_sdf, hps, off)
    hit = Hit(best_t, best_obj, active & (best_obj >= 0))
    info = ShadingInfo(torch.stack([px, py, pz], -1),
                       torch.stack([nx, ny, nz], -1), off, mat)
    return hit, info


_P = ctypes.c_void_p


class _IntersectArgs(ctypes.Structure):
    _fields_ = [(name, _P) for name in (
        "origin", "direction", "hps_abs", "hps_lin", "active", "spheres",
        "t", "obj", "point", "normal", "offset_by", "mat")] + [
        ("n", ctypes.c_int64), ("K", ctypes.c_int), ("has_sdf", ctypes.c_int),
        ("sdf_mat", ctypes.c_int), ("max_steps", ctypes.c_int),
        ("mb", MBox), ("t_max0", ctypes.c_float),
        ("eps_const", ctypes.c_float), ("eps_k", ctypes.c_float),
        ("detail", ctypes.c_float)]


def closest_hit_shading(data, static, settings, origin, direction, hps_abs,
                        hps_lin, active):
    """(Hit, ShadingInfo) of the closest hit along each ray. Sphere
    channels must be constant (the port has no animated scenes yet)."""
    if origin.device.type == "cpu":
        return closest_hit_shading_plain(data, static, settings, origin,
                                         direction, hps_abs, hps_lin, active)
    dev = origin.device
    if dev.type != "cuda":
        raise ValueError(f"closest_hit_shading: unsupported device {dev}")
    n = origin.shape[0]
    f32 = torch.float32
    spheres = sphere_table(data)
    t = torch.empty((n,), dtype=f32, device=dev)
    obj = torch.empty((n,), dtype=torch.int32, device=dev)
    point = torch.empty((n, 3), dtype=f32, device=dev)
    normal = torch.empty((n, 3), dtype=f32, device=dev)
    off = torch.empty((n,), dtype=f32, device=dev)
    mat = torch.empty((n,), dtype=torch.int32, device=dev)
    detail = settings.sdf_detail_scale
    args = _IntersectArgs(
        origin=check(origin, "origin", f32, (n, 3), dev),
        direction=check(direction, "direction", f32, (n, 3), dev),
        hps_abs=check(hps_abs, "hps_abs", f32, (n,), dev),
        hps_lin=check(hps_lin, "hps_lin", f32, (n,), dev),
        active=check(active, "active", torch.bool, (n,), dev),
        spheres=check(spheres, "spheres", f32, (static.n_spheres, 5), dev),
        t=t.data_ptr(), obj=obj.data_ptr(), point=point.data_ptr(),
        normal=normal.data_ptr(), offset_by=off.data_ptr(),
        mat=mat.data_ptr(), n=n, K=static.n_spheres,
        has_sdf=int(static.has_sdf), sdf_mat=static.sdf_mat,
        max_steps=settings.max_marches,
        mb=mbox_struct(data.sdf_params if static.has_sdf else None),
        t_max0=2.0 * settings.world_radius, eps_const=5e-5 * detail,
        eps_k=0.05 * detail, detail=detail)
    _build.launch("rayn_closest_hit", args, dev)
    closest_hit_shading.launches += 1
    return (Hit(t, obj, active & (obj >= 0)),
            ShadingInfo(point, normal, off, mat))


closest_hit_shading.launches = 0
