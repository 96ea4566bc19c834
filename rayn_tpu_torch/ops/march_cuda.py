"""Sphere-tracing kernels of the segment-queue bounce: CUDA and plain twins.

Port of the three `rayn_tpu.ops.march_pallas` kernels that the unfused
bounce runs (csrc/march.cu):

- `march` replaces `march` (`_march_kernel`): the closest-hit march of
  the SDF along each ray, plain or over-relaxed (`relax`).
- `march_occlusion` replaces `march_occlusion` (`_occl_kernel`): one
  shadow segment per lane with the bounding-sphere clip, plain or
  over-relaxed.
- `march_occlusion_chained` replaces `march_occlusion_chained`
  (`_chained_occl_core`): K segments per ray, each with the relax-1
  verdict of `march_occlusion`.

Each wrapper launches its kernel for CUDA tensors, counts the launch in
its `launches` attribute, and raises on anything the kernel does not
take. For CPU tensors it calls its `_plain` twin, which is the plain
torch march of ops/march.py.
"""

from __future__ import annotations

import ctypes

import torch

from rayn_tpu_torch import _build
from rayn_tpu_torch._build import MBox, check, mbox_struct
from rayn_tpu_torch.ops import march as march_ops
from rayn_tpu_torch.ops.sdf import MandelBox

_P = ctypes.c_void_p


class _MarchArgs(ctypes.Structure):
    _fields_ = [(name, _P) for name in (
        "origin", "direction", "t_max", "eps_abs", "eps_lin", "active",
        "t")] + [
        ("n", ctypes.c_int64), ("max_steps", ctypes.c_int), ("mb", MBox),
        ("eps_const", ctypes.c_float), ("relax", ctypes.c_float)]


class _OcclArgs(ctypes.Structure):
    _fields_ = [(name, _P) for name in (
        "start", "end", "active", "occluded")] + [
        ("n", ctypes.c_int64), ("K", ctypes.c_int),
        ("max_steps", ctypes.c_int), ("mb", MBox),
        ("eps_c", ctypes.c_float), ("eps_l", ctypes.c_float),
        ("relax", ctypes.c_float), ("bv_r", ctypes.c_float),
        ("bv_r2", ctypes.c_float)]


def _cuda_device(t: torch.Tensor, name: str) -> torch.device:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")
    return t.device


def march_plain(mb: MandelBox, origin, direction, t_max, eps_const: float,
                eps_abs, eps_lin, max_steps: int, active,
                relax: float = 1.0) -> torch.Tensor:
    """Plain twin of the march kernel (ops/march.py march)."""
    return march_ops.march(mb, origin, direction, t_max, eps_const, eps_abs,
                           eps_lin, max_steps, active, relax)


def march(mb: MandelBox, origin, direction, t_max, eps_const: float,
          eps_abs, eps_lin, max_steps: int, active,
          relax: float = 1.0) -> torch.Tensor:
    """[N] f32 t of the closest SDF hit along each ray (>= t_max on a
    miss, t_max + 1 on an inactive lane, NaN where the first DE is)."""
    if origin.device.type == "cpu":
        return march_plain(mb, origin, direction, t_max, eps_const, eps_abs,
                           eps_lin, max_steps, active, relax)
    dev = _cuda_device(origin, "march")
    n = origin.shape[0]
    f32 = torch.float32
    t = torch.empty((n,), dtype=f32, device=dev)
    args = _MarchArgs(
        origin=check(origin, "origin", f32, (n, 3), dev),
        direction=check(direction, "direction", f32, (n, 3), dev),
        t_max=check(t_max, "t_max", f32, (n,), dev),
        eps_abs=check(eps_abs, "eps_abs", f32, (n,), dev),
        eps_lin=check(eps_lin, "eps_lin", f32, (n,), dev),
        active=check(active, "active", torch.bool, (n,), dev),
        t=t.data_ptr(), n=n, max_steps=max_steps, mb=mbox_struct(mb),
        eps_const=eps_const, relax=relax)
    _build.launch("rayn_march", args, dev)
    march.launches += 1
    return t


march.launches = 0


def _occl_args(mb, start, end, active, out, detail_scale, max_steps, relax,
               bound_radius, n, K, seg_shape, dev) -> _OcclArgs:
    if max_steps < 1:
        raise ValueError("the occlusion kernels need max_steps >= 1")
    f32 = torch.float32
    return _OcclArgs(
        start=check(start, "start", f32, seg_shape + (3,), dev),
        end=check(end, "end", f32, seg_shape + (3,), dev),
        active=check(active, "active", torch.bool, seg_shape, dev),
        occluded=out.data_ptr(), n=n, K=K, max_steps=max_steps,
        mb=mbox_struct(mb), eps_c=1e-4 * detail_scale,
        eps_l=1e-5 * detail_scale, relax=relax, bv_r=bound_radius,
        bv_r2=float(bound_radius * bound_radius))


def march_occlusion_plain(mb: MandelBox, start, end, detail_scale: float,
                          max_steps: int, active, relax: float = 1.0,
                          bound_radius: float = 0.0) -> torch.Tensor:
    """Plain twin of the occlusion kernel (ops/march.py)."""
    return march_ops.march_occlusion(mb, start, end, detail_scale, max_steps,
                                     active, bound_radius, relax)


def march_occlusion(mb: MandelBox, start, end, detail_scale: float,
                    max_steps: int, active, relax: float = 1.0,
                    bound_radius: float = 0.0) -> torch.Tensor:
    """[M] bool: True where the SDF blocks segment start -> end."""
    if start.device.type == "cpu":
        return march_occlusion_plain(mb, start, end, detail_scale, max_steps,
                                     active, relax, bound_radius)
    dev = _cuda_device(start, "march_occlusion")
    m = start.shape[0]
    out = torch.empty((m,), dtype=torch.bool, device=dev)
    args = _occl_args(mb, start, end, active, out, detail_scale, max_steps,
                      relax, bound_radius, m, 1, (m,), dev)
    _build.launch("rayn_march_occlusion", args, dev)
    march_occlusion.launches += 1
    return out


march_occlusion.launches = 0


def march_occlusion_chained_plain(mb: MandelBox, start, end,
                                  detail_scale: float, max_steps: int,
                                  active,
                                  bound_radius: float = 0.0) -> torch.Tensor:
    """Plain twin of the chained kernel (ops/march.py)."""
    return march_ops.march_occlusion_chained(mb, start, end, detail_scale,
                                             max_steps, active, bound_radius)


def march_occlusion_chained(mb: MandelBox, start, end, detail_scale: float,
                            max_steps: int, active,
                            bound_radius: float = 0.0) -> torch.Tensor:
    """[K, N] bool verdicts of K segments per ray (start/end [K, N, 3],
    active [K, N]), each that of `march_occlusion` at relax 1."""
    if start.device.type == "cpu":
        return march_occlusion_chained_plain(mb, start, end, detail_scale,
                                             max_steps, active, bound_radius)
    dev = _cuda_device(start, "march_occlusion_chained")
    k, n = start.shape[0], start.shape[1]
    out = torch.empty((k, n), dtype=torch.bool, device=dev)
    args = _occl_args(mb, start, end, active, out, detail_scale, max_steps,
                      1.0, bound_radius, n, k, (k, n), dev)
    _build.launch("rayn_march_occlusion_chained", args, dev)
    march_occlusion_chained.launches += 1
    return out


march_occlusion_chained.launches = 0
