"""Sphere tracing over the wavefront in plain torch (port of
rayn_tpu.ops.march, relax = 1).

Each lane steps until it is done or has taken `max_steps` steps; a lane
that is done keeps a frozen `t`. That is the JAX while-loop's per-lane
result, whose block-wide `all(done)` exit only decides when the loop
stops. The loop here carries the indices of the lanes still marching,
so finished lanes cost nothing. This is the plain reference path that
the CUDA kernels are held against; it is also what the plain twins of
the kernels call.

Hit thresholds are cone-traced: max(eps_const, eps_abs + eps_lin * t)
(reference src/camera.rs:116-118, src/film.rs:547-551).
"""

from __future__ import annotations

import torch

from rayn_tpu_torch.ops.sdf import MandelBox, dist_c
from rayn_tpu_torch.utils.vecmath import sqrt as _sqrt


def march(mb: MandelBox, origin, direction, t_max, eps_const: float,
          eps_abs, eps_lin, max_steps: int, active=None) -> torch.Tensor:
    """Primary-ray sphere trace; per-ray t (>= t_max on a miss). Lanes
    that are inactive return t_max + 1; a NaN DE at the origin freezes
    the lane at NaN (reference src/sdf.rs:59-83)."""
    t = dist_c(mb, origin[:, 0], origin[:, 1], origin[:, 2])
    nan_mask = torch.isnan(t)
    if active is not None:
        t = torch.where(active, t, t_max + 1.0)
        nan_mask = nan_mask & active
    live = torch.nonzero(~nan_mask & (t <= t_max)).squeeze(1)
    for _ in range(max_steps):
        if live.numel() == 0:
            break
        tl = t[live]
        o, d = origin[live], direction[live]
        dist = dist_c(mb, o[:, 0] + tl * d[:, 0], o[:, 1] + tl * d[:, 1],
                      o[:, 2] + tl * d[:, 2])
        thresh = torch.clamp(eps_abs[live] + eps_lin[live] * tl,
                             min=eps_const)
        done = (torch.abs(dist) < thresh) | (tl > t_max[live])
        step = ~done
        live = live[step]
        t[live] = tl[step] + dist[step]
    return t


def segment_entry(mb: MandelBox, bound_radius: float, start, end, act):
    """Shadow-segment entry (port of march_pallas._segment_entry):
    (unit direction [N,3], effective length md, first t0, entry-resolved
    mask, raw first DE). With bound_radius > 0 the segment is clipped to
    the origin-centred bounding sphere: lanes that miss it resolve at
    entry, the march starts at the sphere entry and ends at its exit."""
    seg = end - start
    sx, sy, sz = start[:, 0], start[:, 1], start[:, 2]
    gx, gy, gz = seg[:, 0], seg[:, 1], seg[:, 2]
    md = _sqrt(gx * gx + gy * gy + gz * gz)
    inv = 1.0 / md
    d = torch.stack([gx * inv, gy * inv, gz * inv], dim=-1)
    dist0 = dist_c(mb, sx, sy, sz)
    nan = torch.isnan(dist0) | ~act
    t0 = dist0
    if bound_radius > 0.0:
        b = sx * d[:, 0] + sy * d[:, 1] + sz * d[:, 2]
        c = sx * sx + sy * sy + sz * sz - float(bound_radius * bound_radius)
        disc = b * b - c
        sq = _sqrt(torch.clamp(disc, min=0.0))
        t_exit = -b + sq
        bv_miss = (disc <= 0.0) | (t_exit <= 0.0)
        nan = nan | bv_miss
        md = torch.minimum(md, t_exit)
        t0 = torch.maximum(dist0, torch.clamp(-b - sq, min=0.0))
    return d, md, t0, nan, dist0


def march_occlusion(mb: MandelBox, start, end, detail_scale: float,
                    max_steps: int, active, bound_radius: float = 0.0):
    """Shadow march; bool [N], True where the SDF blocks the segment.

    Per lane: from t0, test |DE| < max(eps_c, eps_l * t) and t > md at
    each step; the verdict is `hit and not past the end` at the step the
    lane resolves, and False for a lane that resolves at entry or runs
    out of steps (the verdict of the JAX chained occlusion core, which
    the fused shadow kernels use; reference src/sdf.rs:25-57)."""
    d, md, t, nan, _ = segment_entry(mb, bound_radius, start, end, active)
    eps_c = 1e-4 * detail_scale
    eps_l = 1e-5 * detail_scale
    occ = torch.zeros_like(nan)
    live = torch.nonzero(~nan).squeeze(1)
    t = t.clone()
    for step in range(max(max_steps, 1)):
        if live.numel() == 0:
            break
        tl = t[live]
        s, dl = start[live], d[live]
        gt_end = tl > md[live]
        dist = dist_c(mb, s[:, 0] + tl * dl[:, 0], s[:, 1] + tl * dl[:, 1],
                      s[:, 2] + tl * dl[:, 2])
        hit = torch.abs(dist) < torch.clamp(eps_l * tl, min=eps_c)
        done = hit | gt_end
        occ[live[hit & ~gt_end]] = True
        if step + 1 >= max_steps:
            break
        step_on = ~done
        live = live[step_on]
        t[live] = tl[step_on] + dist[step_on]
    return occ
