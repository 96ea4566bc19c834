"""Sphere tracing over the wavefront in plain torch (port of
rayn_tpu.ops.march, plain and over-relaxed).

Each lane steps until it is done or has taken `max_steps` steps; a lane
that is done keeps a frozen `t`. That is the JAX while-loop's per-lane
result, whose block-wide `all(done)` exit only decides when the loop
stops. The loop here carries the indices of the lanes still marching,
so finished lanes cost nothing, and inactive lanes never evaluate the
DE (as in the CUDA kernels). This is the plain reference path that the
CUDA kernels (ops/march_cuda.py, ops/shade_cuda.py) are held against.

Over-relaxed sphere tracing (Keinert et al., "Enhanced Sphere Tracing";
relax in (1, 2)): step by relax * DE; when the bounding spheres of two
consecutive positions no longer overlap, (t - t_prev) > |r_prev| + |r|,
the step overshot and the lane falls back to the conservative step
t_prev + r_prev. relax == 1 is the reference algorithm.

Hit thresholds are cone-traced: max(eps_const, eps_abs + eps_lin * t)
(reference src/camera.rs:116-118, src/film.rs:547-551). Every march takes
one SDF program (ops/sdf.py), as JAX's marches take one instance.

The two-phase marches (march_pallas.march_sorted, march_phased,
march_occlusion_phased, march_occlusion_sorted) split the plain march
into a step-capped phase 1 that reports which lanes resolved, and a
resume that finishes the others from phase 1's t: `march_phase1` /
`march_resume` and `occlusion_phase1` / `occlusion_resume` are the TPU
schedules of the march and the occlusion in plain torch. Each lane
takes the same steps as in one uncapped march, so the composition is
bit-identical to it; with no phase-1 step the occlusion takes JAX's
first-DE verdict, which `march_occlusion(..., first_de=True)` gives in
one march.

`occlusion_steps` counts the DEs each segment takes in the occlusion
march, plain or relaxed, `march(..., n_de=)` those of each ray in the
march kernel, and `march_steps` those of each ray's closest-hit march
in the intersect kernel: the work a schedule of the march has to pack
into warps.
"""

from __future__ import annotations

import torch

from rayn_tpu_torch.ops.sdf import dist_c
from rayn_tpu_torch.utils.vecmath import sqrt as _sqrt


def _de_at(prog, origin, direction, idx, t):
    o, d = origin[idx], direction[idx]
    return dist_c(prog, o[:, 0] + t * d[:, 0], o[:, 1] + t * d[:, 1],
                  o[:, 2] + t * d[:, 2])


def _march_steps(prog, origin, direction, t_max, eps_const: float, eps_abs,
                 eps_lin, t, live, steps: int, n_de=None):
    """At most `steps` plain (relax 1) steps of the lanes `live`, with t
    advanced in place; returns the lanes that neither met their
    threshold nor passed t_max in them. `n_de`, if given, counts in place
    the DEs each lane takes in the CUDA march, which stops a lane past
    t_max before its DE (this loop takes that DE and then stops it)."""
    for _ in range(steps):
        if live.numel() == 0:
            break
        tl = t[live]
        if n_de is not None:
            n_de[live[~(tl > t_max[live])]] += 1
        r = _de_at(prog, origin, direction, live, tl)
        thresh = torch.clamp(eps_abs[live] + eps_lin[live] * tl,
                             min=eps_const)
        step = ~((torch.abs(r) < thresh) | (tl > t_max[live]))
        live = live[step]
        t[live] = tl[step] + r[step]
    return live


def _first_de(prog, origin, t_max, act):
    """t of every lane before its first step: the DE at the origin, or
    t_max + 1 for an inactive lane."""
    t = t_max + 1.0
    o = origin[act]
    t[act] = dist_c(prog, o[:, 0], o[:, 1], o[:, 2])
    return t


def march(prog, origin, direction, t_max, eps_const: float,
          eps_abs, eps_lin, max_steps: int, active=None,
          relax: float = 1.0, n_de=None) -> torch.Tensor:
    """Primary-ray sphere trace; per-ray t (>= t_max on a miss). Lanes
    that are inactive return t_max + 1; a NaN DE at the origin freezes
    the lane at NaN (reference src/sdf.rs:59-83). `n_de`, if given,
    counts in place the DEs each lane takes in the CUDA march kernel:
    the entry DE of an active lane, then one per step (a plain step
    begun past t_max takes none)."""
    act = (torch.ones_like(t_max, dtype=torch.bool) if active is None
           else active)
    t = _first_de(prog, origin, t_max, act)
    if n_de is not None:
        n_de += act.to(n_de.dtype)
    # NaN and past-the-end lanes are done at their first step
    live = torch.nonzero(act & (t <= t_max)).squeeze(1)
    if relax == 1.0:
        _march_steps(prog, origin, direction, t_max, eps_const, eps_abs,
                     eps_lin, t, live, max_steps, n_de)
        return t
    t_prev = torch.zeros_like(t)
    r_prev = t.clone()
    for _ in range(max_steps):
        if live.numel() == 0:
            break
        if n_de is not None:
            n_de[live] += 1
        tl = t[live]
        r = _de_at(prog, origin, direction, live, tl)
        thresh = torch.clamp(eps_abs[live] + eps_lin[live] * tl,
                             min=eps_const)
        done = (torch.abs(r) < thresh) | (tl > t_max[live])
        tp, rp = t_prev[live], r_prev[live]
        overshoot = (tl - tp) > (torch.abs(rp) + torch.abs(r))
        step = ~(done & ~overshoot)
        adv = step & ~overshoot
        t_prev[live[adv]] = tl[adv]
        r_prev[live[adv]] = r[adv]
        nxt = torch.where(overshoot, tp + rp, tl + relax * r)
        live = live[step]
        t[live] = nxt[step]
    return t


def march_steps(prog, origin, direction, t_max, eps_const: float,
                eps_abs, eps_lin, max_steps: int, active) -> torch.Tensor:
    """int32 [N]: the DEs each ray's closest-hit march takes in
    the intersect kernel: those of the relax-1 march kernel (`march`'s
    `n_de`), and the four normal taps of a ray whose march ends before
    t_max (an SDF hit): the work a schedule of the closest hit has to
    pack into warps."""
    n_de = torch.zeros(active.shape, dtype=torch.int32,
                       device=active.device)
    t = march(prog, origin, direction, t_max, eps_const, eps_abs, eps_lin,
              max_steps, active, n_de=n_de)
    return n_de + 4 * (active & (t < t_max)).to(torch.int32)


def march_phase1(prog, origin, direction, t_max, eps_const: float,
                 eps_abs, eps_lin, steps: int, active):
    """Phase 1 of the two-phase march (march_pallas._march_phase1_kernel):
    every lane takes at most `steps` plain steps. Returns (t1, resolved):
    t as `march` has it after those steps, and whether the lane is done:
    inactive, NaN at its first DE, or it met its threshold or passed
    t_max within them."""
    t = _first_de(prog, origin, t_max, active)
    live = torch.nonzero(active & ~torch.isnan(t)).squeeze(1)
    live = _march_steps(prog, origin, direction, t_max, eps_const, eps_abs,
                        eps_lin, t, live, steps)
    resolved = torch.ones_like(active)
    resolved[live] = False
    return t, resolved


def march_resume(prog, origin, direction, t_max, eps_const: float,
                 eps_abs, eps_lin, steps: int, t1, resolved, order):
    """Phase 2 (march_pallas._march_resume_kernel): the lanes in `order`
    that phase 1 left unresolved march on from t1 for at most `steps`
    more plain steps. Returns a copy of t1 with their final t."""
    t = t1.clone()
    _march_steps(prog, origin, direction, t_max, eps_const, eps_abs, eps_lin,
                 t, order[~resolved[order]], steps)
    return t


def _segment_dir(start, end):
    """Unit direction [N, 3] and length of the segments start -> end."""
    seg = end - start
    gx, gy, gz = seg[:, 0], seg[:, 1], seg[:, 2]
    md = _sqrt(gx * gx + gy * gy + gz * gz)
    inv = 1.0 / md
    return torch.stack([gx * inv, gy * inv, gz * inv], dim=-1), md


def segment_entry(prog, bound_radius: float, start, end, act):
    """Shadow-segment entry (port of march_pallas._segment_entry):
    (unit direction [N,3], effective length md, first t0, entry-resolved
    mask, raw first DE). With bound_radius > 0 the segment is clipped to
    the origin-centred bounding sphere: lanes that miss it resolve at
    entry, the march starts at the sphere entry and ends at its exit.
    The first DE is evaluated for active lanes only (NaN elsewhere)."""
    sx, sy, sz = start[:, 0], start[:, 1], start[:, 2]
    d, md = _segment_dir(start, end)
    dist0 = torch.full_like(sx, float("nan"))
    s = start[act]
    dist0[act] = dist_c(prog, s[:, 0], s[:, 1], s[:, 2])
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


def _occl_steps(prog, start, d, md, detail_scale: float, t, occ, live,
                steps: int, n_de=None):
    """At most `steps` relax-1 occlusion steps of the segments `live`,
    with t advanced in place: at each, a segment whose DE meets
    max(eps_c, eps_l * t) before its end is occluded (set in `occ`), one
    that hits or is past its end is done, and the others step on.
    Returns the segments not done. `n_de`, if given, counts each
    segment's DEs in place."""
    eps_c = 1e-4 * detail_scale
    eps_l = 1e-5 * detail_scale
    for _ in range(steps):
        if live.numel() == 0:
            break
        if n_de is not None:
            n_de[live] += 1
        tl = t[live]
        gt_end = tl > md[live]
        r = _de_at(prog, start, d, live, tl)
        hit = torch.abs(r) < torch.clamp(eps_l * tl, min=eps_c)
        occ[live[hit & ~gt_end]] = True
        step_on = ~(hit | gt_end)
        live = live[step_on]
        t[live] = tl[step_on] + r[step_on]
    return live


def _occl_march(prog, start, end, detail_scale: float, max_steps: int,
                active, bound_radius: float, n_de=None, first_de=False):
    """The relax-1 occlusion march of march_occlusion; `n_de`, if given,
    counts each segment's DEs in place (its first DE, taken for every
    active segment, and one per step)."""
    d, md, t, nan, dist0 = segment_entry(prog, bound_radius, start, end,
                                         active)
    occ = torch.zeros_like(nan)
    if n_de is not None:
        n_de += active.to(n_de.dtype)
    live = torch.nonzero(~nan).squeeze(1)
    steps = max(max_steps, 1)
    if first_de:
        occ[live] = (dist0[live] < 1e-4) & ~(t[live] > md[live])
        live = live[~occ[live]]
        steps = max_steps
    _occl_steps(prog, start, d, md, detail_scale, t.clone(), occ, live, steps,
                n_de)
    return occ


def occlusion_steps(prog, start, end, detail_scale: float,
                    max_steps: int, active, bound_radius: float = 0.0,
                    relax: float = 1.0):
    """int32 [N]: the DEs each segment takes in march_occlusion
    at `relax` (its first DE plus one per step; 0 when inactive), the
    work that a lane spends on it."""
    n_de = torch.zeros(active.shape, dtype=torch.int32, device=active.device)
    march_occlusion(prog, start, end, detail_scale, max_steps, active,
                    bound_radius, relax, n_de)
    return n_de


def march_occlusion(prog, start, end, detail_scale: float,
                    max_steps: int, active, bound_radius: float = 0.0,
                    relax: float = 1.0, n_de=None, first_de: bool = False):
    """Shadow march; bool [N], True where the SDF blocks the segment.

    Per lane: from t0, test |DE| < max(eps_c, eps_l * t) and t > md at
    each step; the verdict is `hit and not past the end` at the step the
    lane resolves, and False for a lane that resolves at entry or runs
    out of steps (the verdict of the JAX march_occlusion; reference
    src/sdf.rs:25-57). A relaxed step that overshoots is never a hit.
    `n_de`, if given, counts each segment's DEs in place. `first_de`
    (relax 1) is the entry of the JAX two-phase occlusion with no
    phase-1 step (march_pallas.py:518): a segment whose first DE is
    below 1e-4 and that does not start past its end is blocked at once,
    the others take at most `max_steps` steps (none at 0). Without it a
    segment takes at least one step, `max_steps` 0 included, as the
    refill march kernels and JAX's chained core do; JAX's march_occlusion
    takes none there, which is the `first_de` verdict at 0 steps
    (march_cuda.march_occlusion routes it so)."""
    if relax == 1.0:
        return _occl_march(prog, start, end, detail_scale, max_steps, active,
                           bound_radius, n_de, first_de)
    d, md, t, nan, _ = segment_entry(prog, bound_radius, start, end, active)
    occ = torch.zeros_like(nan)
    if n_de is not None:
        n_de += active.to(n_de.dtype)
    live = torch.nonzero(~nan).squeeze(1)
    t = t.clone()
    eps_c = 1e-4 * detail_scale
    eps_l = 1e-5 * detail_scale
    t_prev = torch.zeros_like(t)
    r_prev = t.clone()
    for step in range(max(max_steps, 1)):
        if live.numel() == 0:
            break
        if n_de is not None:
            n_de[live] += 1
        tl = t[live]
        gt_end = tl > md[live]
        r = _de_at(prog, start, d, live, tl)
        tp, rp = t_prev[live], r_prev[live]
        overshoot = (tl - tp) > (torch.abs(rp) + torch.abs(r))
        hit = (torch.abs(r) < torch.clamp(eps_l * tl, min=eps_c)) & ~overshoot
        occ[live[hit & ~gt_end]] = True
        if step + 1 >= max_steps:
            break
        step_on = ~(hit | gt_end)
        adv = step_on & ~overshoot
        t_prev[live[adv]] = tl[adv]
        r_prev[live[adv]] = r[adv]
        nxt = torch.where(overshoot, tp + rp, tl + relax * r)
        live = live[step_on]
        t[live] = nxt[step_on]
    return occ


def occlusion_phase1(prog, start, end, detail_scale: float,
                     steps: int, active):
    """Phase 1 of the two-phase occlusion march
    (march_pallas._occl_phase1_kernel): every segment takes at most
    `steps` relax-1 steps from its first DE, with no bounding-sphere clip.
    Returns (occluded, t1, resolved): the verdict so far, t after those
    steps, and whether the segment hit or is past its end (an inactive or
    NaN-entry segment is resolved and unblocked). With no step taken the
    verdict is the kernel's `first DE < 1e-4` (march_pallas.py:518)."""
    d, md, t0, nan, dist0 = segment_entry(prog, 0.0, start, end, active)
    t = t0.clone()
    occ = torch.zeros_like(nan)
    live = torch.nonzero(~nan).squeeze(1)
    if steps == 0:
        occ[live] = (dist0[live] < 1e-4) & ~(t[live] > md[live])
    live = _occl_steps(prog, start, d, md, detail_scale, t, occ, live, steps)
    resolved = torch.ones_like(nan)
    resolved[live] = (t[live] > md[live]) | occ[live]
    return occ, t, resolved


def occlusion_resume(prog, start, end, detail_scale: float,
                     steps: int, occluded, t1, resolved, order):
    """Phase 2 (march_pallas._occl_resume_kernel): the segments in
    `order` that phase 1 left unresolved march on from t1 for at most
    `steps` more relax-1 steps. Returns a copy of `occluded` with their
    final verdicts."""
    d, md = _segment_dir(start, end)
    occ = occluded.clone()
    _occl_steps(prog, start, d, md, detail_scale, t1.clone(), occ,
                order[~resolved[order]], steps)
    return occ


def march_occlusion_chained(prog, start, end, detail_scale: float,
                            max_steps: int, active,
                            bound_radius: float = 0.0):
    """K shadow segments per ray (start/end [K, N, 3], active [K, N]) ->
    bool [K, N]: the plain twin of march_pallas.march_occlusion_chained.
    Chaining only schedules a ray's segments one after another, so each
    verdict is that of `march_occlusion` at relax 1."""
    k, n = start.shape[0], start.shape[1]
    return march_occlusion(prog, start.reshape(k * n, 3),
                           end.reshape(k * n, 3), detail_scale, max_steps,
                           active.reshape(k * n),
                           bound_radius).reshape(k, n)
