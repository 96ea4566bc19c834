"""Wavefront path-tracing integrator: the kernel paths of
`rayn_tpu.render.integrator.bounce` (reference src/integrator.rs:32-281).

One bounce at depth d:
1. at d >= 1 with `use_pallas`, the pre-intersect chunk cost sort
   (`sorted_intersect`), its key from the cost-key kernel (in torch, as
   JAX's XLA key, in a scene with a user-written closure);
2. closest hit + shading info: the fused intersect kernel, or the
   unfused intersect.closest_hit (the march kernel, or at relax 1 with
   `march_sort_steps` the two-phase march_sorted; the torch march for an
   instance the kernels do not take, `intersect.kernel_march_ok`) +
   shading_info where `_fused_ok` fails (JAX's fused_intersect_ok):
   without `use_pallas` or `use_fused_intersect`, with relaxed marching
   or a closure;
3. per-lane shading values (`_derive_shading`; a material's albedo
   function, SceneStatic.mat_param_fns, replaces its color_a there, so
   every tail reads the per-point albedo as a per-lane column); at d = 0
   the extra AOVs (render/aovs.py) of the receiving lanes;
4. the bounce tail, chosen as JAX chooses it:
   - fused (`_fused_ok`, JAX's fused_ok: `use_pallas_occlusion`,
     `use_fused_shadows`, plain marching, no closure): in a scene with
     lights, at d >= 1 the shadow sort-key kernel and the chunk sort
     (`sorted_shadow_march`); then one of
     - the bounce-tail kernel (NEE, volume scattering, emission,
       scatter, roulette, AOVs, termination), with `use_fused_finish`,
       `use_fused_bounce_tail` and lights;
     - else with `use_fused_finish`: the shadow-radiance kernel (with
       lights), then the finish kernel on (radiance + delta);
     - else: emission in torch, the shadow-radiance kernel (with
       lights), then `_finish_bounce`, so (radiance + emission) + delta;
   - the segment queue (otherwise): emission; in a scene with lights,
     every NEE and volume shadow segment of the bounce built into a
     scratch by the queue-segments kernel (with the sphere test), their
     SDF verdicts from the refill march (plain or relaxed; at relax 1
     with `occl_sort_steps` or `occl_phase1_steps` unclipped, the
     two-phase marches' verdicts), or for an instance that fails
     `intersect.kernel_occlusion_ok` from the torch march, and the
     queue-sum
     kernel's radiance + contribution * visibility in segment order;
     then `_finish_bounce`;
   with `mis`, every branch weights NEE of paired lights and, at d >= 1,
   BSDF-hit emission of paired spheres by the power heuristic; the
   sort-key and segments kernels draw the volume sites' equi-angular
   samples themselves from the closest hit's t;
5. the unsort back to pixel-major order.

Sorting moves whole chunks of lanes and every per-lane result is
position-independent, so sorted and unsorted bounces give bit-identical
outputs; each lane's `time` moves with it (it is a PathState column), so
every kernel after a sort reads the lane's own time, and in a scene with
animated lights, spheres or camera every position a kernel or the torch
code takes is taken at that time.

With `compact_bounces`, `trace` partitions the wavefront before every
bounce at d >= 1, alive lanes first in a stable order (`compact`, JAX's
integrator.py:629-645), and after the last bounce gathers every lane
back to ray order with the composed permutation. Since each lane's
result does not depend on its position, the film of a compacted pass is
the same bits as the uncompacted one, and `film.splat` needs no pixel
ids (no atomics, no `index_add_`).
"""

from __future__ import annotations

import warnings
from typing import NamedTuple

import torch

from rayn_tpu_torch.config import RenderSettings
from rayn_tpu_torch.ops import bsdf as bsdf_ops
from rayn_tpu_torch.ops import (intersect, intersect_cuda, march_cuda,
                                shade_cuda)
from rayn_tpu_torch.ops import sdf as sdf_ops
from rayn_tpu_torch.render import aovs as aovs_mod
from rayn_tpu_torch.scene.scene import (REFRACTIVE, SceneData, SceneStatic,
                                        light_position_of)
from rayn_tpu_torch.utils import rng, sampling, vecmath
from rayn_tpu_torch.utils.rng import SampleTables


class PathState(NamedTuple):
    """Struct-of-tensors wavefront state (reference src/ray.rs:4-29)."""
    origin: torch.Tensor      # [N, 3]
    direction: torch.Tensor   # [N, 3]
    time: torch.Tensor        # [N]
    radiance: torch.Tensor    # [N, 3]
    throughput: torch.Tensor  # [N, 3]
    pixel: torch.Tensor       # [N] int32 flat pixel id
    sample_idx: torch.Tensor  # [N] int32 per-pixel sample number
    alive: torch.Tensor       # [N] bool
    prev_pdf: torch.Tensor    # [N] pdf of the BSDF sample (-1 = camera)
    color_out: torch.Tensor   # [N, 3]
    bg_out: torch.Tensor      # [N, 3]
    alpha_out: torch.Tensor   # [N]
    normal_out: torch.Tensor  # [N, 3]


def init_state(origin, direction, time, pixel, sample_idx, alive):
    n = origin.shape[0]
    kw = dict(dtype=torch.float32, device=origin.device)
    z3 = torch.zeros((n, 3), **kw)
    return PathState(
        origin=origin, direction=direction, time=time, radiance=z3,
        throughput=torch.ones((n, 3), **kw), pixel=pixel,
        sample_idx=sample_idx, alive=alive,
        prev_pdf=torch.full((n,), -1.0, **kw), color_out=z3, bg_out=z3,
        alpha_out=torch.zeros((n,), **kw), normal_out=z3)


def _sort_chunk(n: int) -> int:
    """Lanes per sort unit: the first of 128/512/8 dividing n, else 0
    (no sort). Chunks of adjacent lanes keep pixel coherence and make the
    permutation a row gather."""
    for chunk in (128, 512, 8):
        if n % chunk == 0:
            return chunk
    return 0


def _chunk_of(s: RenderSettings, n: int, strict: bool = True) -> int:
    """The sort chunk of a pass of n rays, resolved where a sort runs (as
    JAX resolves it, integrator.py:245-250 and :314-318): `sorted_chunk`
    must divide n (ValueError; 0, no sort, when not `strict`)."""
    chunk = s.sorted_chunk or _sort_chunk(n)
    if s.sorted_chunk and n % chunk:
        if not strict:
            return 0
        raise ValueError(f"sorted_chunk={chunk} must divide rays_per_pass={n}")
    return chunk


def _permute_chunks(tree, perm: torch.Tensor, chunk: int):
    """Move every tensor's rows in chunks of `chunk` by permutation `perm`."""
    def one(t):
        a = t.reshape((-1, chunk) + tuple(t.shape[1:]))
        return a[perm].reshape(t.shape)
    return type(tree)(*(one(t) for t in tree))


def _chunk_perm(key: torch.Tensor, chunk: int) -> torch.Tensor:
    """Chunk permutation by descending summed cost (stable sort)."""
    ckey = key.reshape(-1, chunk).sum(dim=-1)
    return torch.sort(-ckey, stable=True).indices


def _sort_tree_by_cost(trees: tuple, key: torch.Tensor, chunk: int):
    """Sort NamedTuples of per-ray tensors by one chunk permutation of
    descending cost; returns (sorted trees, permutation)."""
    perm = _chunk_perm(key, chunk)
    return tuple(_permute_chunks(t, perm, chunk) for t in trees), perm


def _inverse(perm: torch.Tensor) -> torch.Tensor:
    """The inverse permutation (one scatter of distinct indices)."""
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.shape[0], dtype=perm.dtype,
                             device=perm.device)
    return inv


def _unsort_state(state: PathState, perm: torch.Tensor, chunk: int):
    """Invert a chunk permutation on a bounce's output state."""
    return _permute_chunks(state, _inverse(perm), chunk)


_WARNED: set = set()


def warn_fallback(feature: str, reason: str,
                  consequence: str = "falling back to the ~2x slower "
                                     "unfused path for this render") -> None:
    """Warn once per feature and reason in the process that a fused
    route is off (the words of rayn_tpu/ops/shade_pallas.py:145-160)."""
    if (feature, reason) in _WARNED:
        return
    _WARNED.add((feature, reason))
    warnings.warn(f"rayn_tpu_torch: {feature} unavailable ({reason}); "
                  f"{consequence}", RuntimeWarning, stacklevel=3)


def _eligibility_reason(s: RenderSettings, data: SceneData,
                        static: SceneStatic) -> str | None:
    """What keeps the fused kernels off in this scene, or None (JAX's
    shade_pallas._eligibility_reason): relaxed marching, or an SDF
    instance that is a user-written closure, which no kernel evaluates
    (JAX's kernels trace a closure's fn_c; the port cannot compile torch
    code into them)."""
    if s.march_relaxation != 1.0:
        return "march_relaxation != 1.0 (relaxed march carries extra state)"
    for i, (prog, _mat, _bv) in enumerate(static.sdf_instances(data)):
        if sdf_ops.kernel_ready(prog):
            continue
        if type(prog) is sdf_ops.SdfProgram and prog.fn_c is None:
            return f"SDF instance {i} has no component-form fn_c"
        return (f"SDF instance {i} is a user-written closure, which no "
                "CUDA kernel evaluates")
    return None


def _fused_ok(feature: str, flags: bool, s, data, static) -> bool:
    """Whether the fused `feature` runs: `flags` (the settings that ask
    for it) and the scene's eligibility; a scene that is not eligible
    warns once (warn_fallback)."""
    if not flags:
        return False
    reason = _eligibility_reason(s, data, static)
    if reason is not None:
        warn_fallback(feature, reason)
        return False
    return True


def _derive_shading(data: SceneData, static: SceneStatic, state: PathState,
                    hit, info):
    """(live, material params, receives, vol_trans) of each lane. The
    albedo functions replace color_a lane by lane, so a second call after
    a sort gives every lane the same bits (JAX integrator.py:190-216)."""
    live = state.alive & hit.valid
    mat = bsdf_ops.gather(data.materials, info.mat)
    for mid, fn in static.mat_param_fns:
        mat = mat._replace(color_a=torch.where(
            (info.mat == mid)[:, None], fn(info.point, info.normal),
            mat.color_a))
    receives = bsdf_ops.receives_light(mat) & live
    if static.has_extinction:
        vol_trans = torch.exp(-data.volume_sigma_t * hit.t)
    else:
        vol_trans = torch.ones_like(hit.t)
    return live, mat, receives, vol_trans


def bounce(data: SceneData, static: SceneStatic, settings: RenderSettings,
           tables: SampleTables, state: PathState, depth: int,
           hps_abs0: float, hps_lin0: float, scene_tables=None) -> PathState:
    """One wavefront bounce at `depth`. scene_tables: the constant tables
    of shade_cuda.scene_tables, built per call when not given."""
    return _bounce(data, static, settings, tables, state, depth, hps_abs0,
                   hps_lin0, scene_tables)[0]


def _bounce(data, static, settings, tables, state, depth, hps_abs0,
            hps_lin0, scene_tables=None):
    """`bounce`, and at depth 0 the lanes' extra AOVs (aovs.extract, in
    the input's lane order: depth 0 sorts nothing); () otherwise."""
    n = state.origin.shape[0]
    s = settings
    dev = state.origin.device
    if depth == 0:
        hps_abs = torch.full((n,), hps_abs0, dtype=torch.float32, device=dev)
        hps_lin = torch.full((n,), hps_lin0, dtype=torch.float32, device=dev)
    else:
        hps_abs = torch.zeros((n,), dtype=torch.float32, device=dev)
        hps_lin = torch.full((n,), 2e-4 * depth, dtype=torch.float32,
                             device=dev)

    pre_perm, chunk = None, 0
    if s.sorted_intersect and depth > 0 and static.has_sdf and s.use_pallas:
        chunk = _chunk_of(s, n)
        if chunk:
            key_fn = (intersect_cuda.intersect_cost_key if all(
                sdf_ops.kernel_ready(p) for p, _m, _b in
                static.sdf_instances(data))
                else intersect_cuda.intersect_cost_key_plain)
            key = key_fn(data, static, s, state.origin, state.direction,
                         state.time, state.alive)
            (state,), pre_perm = _sort_tree_by_cost((state,), key, chunk)

    if _fused_ok("fused intersect kernel",
                 s.use_pallas and s.use_fused_intersect, s, data, static):
        hit, info = intersect_cuda.closest_hit_shading(
            data, static, s, state.origin, state.direction, hps_abs, hps_lin,
            state.alive, state.time)
    else:
        t_max = torch.full((n,), 2.0 * s.world_radius, dtype=torch.float32,
                           device=dev)
        hit = intersect.closest_hit(data, static, s, state.origin,
                                    state.direction, state.time, t_max,
                                    hps_abs, hps_lin, state.alive)
        info = intersect.shading_info(data, static, s, hit, state.origin,
                                      state.direction, state.time, hps_abs,
                                      hps_lin)
    live, mat, receives, vol_trans = _derive_shading(data, static, state,
                                                     hit, info)
    aovs = ()
    if depth == 0 and s.extra_aovs:
        aovs = aovs_mod.extract(s, hit, info, mat, receives)
    tabs = scene_tables or shade_cuda.scene_tables(data, static)
    cfg = shade_cuda.shadow_cfg(data, static, s, tables, depth)
    if not _fused_ok("fused shadow/finish kernels",
                     s.use_pallas_occlusion and s.use_fused_shadows, s, data,
                     static):
        out = _segment_queue_tail(data, static, s, tables, cfg, tabs, state,
                                  depth, hit, info, mat, live, receives,
                                  vol_trans)
        if pre_perm is not None:
            out = _unsort_state(out, pre_perm, chunk)
        return out, aovs

    shadow_perm = None
    if (s.sorted_shadow_march and s.chained_shadow_march and depth > 0
            and static.has_sdf and static.n_lights > 0):
        # JAX sorts the shadow segments only before the fused finish; the
        # port also sorts before the split finish, and raises only where
        # JAX does
        chunk = _chunk_of(s, n, strict=s.use_fused_finish)
        if chunk:
            cost = shade_cuda.shadow_sort_key(
                cfg, tabs, info.point, info.normal, info.offset_by,
                state.origin, state.direction, hit.t, live, receives,
                state.sample_idx, state.pixel, state.time)
            (state, hit, info), shadow_perm = _sort_tree_by_cost(
                (state, hit, info), cost, chunk)
            live, mat, receives, vol_trans = _derive_shading(
                data, static, state, hit, info)

    lit = static.n_lights > 0
    if s.use_fused_finish and s.use_fused_bounce_tail and lit:
        out = state._replace(**shade_cuda.bounce_tail(
            cfg, tabs, state, hit, info, mat, live, receives, vol_trans,
            hit.t))
    elif s.use_fused_finish:
        radiance = state.radiance
        if lit:
            radiance = radiance + shade_cuda.shadow_radiance(
                cfg, tabs, state, info, mat, live, receives, vol_trans,
                hit.t)
        out = state._replace(**shade_cuda.finish_bounce(
            cfg, tabs, state, hit, info, mat, live, receives, vol_trans,
            radiance))
    else:
        wo = -state.direction
        radiance = _emission(data, static, s, state, depth, hit, mat, live,
                             wo, vol_trans)
        if lit:
            radiance = radiance + shade_cuda.shadow_radiance(
                cfg, tabs, state, info, mat, live, receives, vol_trans,
                hit.t)
        out = _finish_bounce(s, tables, state, depth, info, mat, live,
                             receives, wo, vol_trans, radiance)
    perm = pre_perm
    if shadow_perm is not None:
        perm = shadow_perm if perm is None else perm[shadow_perm]
    return (out if perm is None else _unsort_state(out, perm, chunk)), aovs


def _emission(data, static, s, state, depth, hit, mat, live, wo, vol_trans):
    """Step 2 (JAX integrator.py:374-395): state radiance + emission. With
    `mis`, at depth >= 1 the BSDF-hit emission of a sphere paired with a
    light is power-heuristic weighted against the NEE strategy that could
    have sampled the same emitter from the previous vertex."""
    le = bsdf_ops.emitted(mat, wo)
    K, NL = static.n_spheres, static.n_lights
    if s.mis and depth > 0 and NL > 0 and K > 0:
        pair = data.sphere_light[torch.clamp(hit.obj, 0, K - 1).long()]
        is_paired = ((hit.obj >= 0) & (hit.obj < K) & (pair >= 0)
                     & (state.prev_pdf >= 0.0))
        lidx = torch.clamp(pair.long(), 0, NL - 1)
        lp = light_position_of(data, lidx, state.time)
        lr = data.light_radii[lidx]
        d2 = vecmath.length_sq(lp - state.origin)
        cos_theta_max = vecmath.sqrt(torch.clamp(1.0 - lr * lr / d2,
                                                 min=0.0))
        # NEE draws nee_light_samples directions, each with density
        # cone pdf / n_lights; the BSDF strategy drew one with prev_pdf
        q = vecmath.div(sampling.uniform_cone_pdf(cos_theta_max), float(NL))
        w_bsdf = sampling.power_heuristic(1.0, state.prev_pdf,
                                          float(s.nee_light_samples), q)
        le = le * torch.where(is_paired, w_bsdf, 1.0)[:, None]
    return state.radiance + torch.where(
        live[:, None], le * state.throughput * vol_trans[:, None], 0.0)


def _segment_queue_tail(data, static, s, tables, cfg, tabs, state, depth,
                        hit, info, mat, live, receives,
                        vol_trans) -> PathState:
    """Steps 2-7 of the unfused bounce (JAX integrator.py:374-518):
    emission; in a scene with lights, the L NEE segments (MIS-weighted
    for paired lights) and the VM*L equi-angular volume segments, built
    with their contributions and the sphere test by the queue-segments
    kernel, their SDF verdicts (`_queue_verdicts`), and radiance +=
    contribution * visibility in segment order (the queue-sum kernel);
    then `_finish_bounce`."""
    wo = -state.direction
    radiance = _emission(data, static, s, state, depth, hit, mat, live, wo,
                         vol_trans)
    if static.n_lights > 0:
        segs = shade_cuda.queue_segments(cfg, tabs, state, info, mat, live,
                                         receives, vol_trans, hit.t)
        radiance = shade_cuda.queue_sum(radiance, segs,
                                        _queue_verdicts(s, cfg, segs))
    return _finish_bounce(s, tables, state, depth, info, mat, live,
                          receives, wo, vol_trans, radiance)


def _queue_verdicts(s, cfg, segs) -> torch.Tensor:
    """[S, N] SDF verdicts of the queued segments. The instances that
    pass `intersect.kernel_occlusion_ok` take the refill march on the
    scratch (`_kernel_verdicts`); each other one, a closure or every
    instance without `use_pallas` or `use_pallas_occlusion`, marches
    the segments still unblocked with the torch march
    (march_cuda.march_occlusion_plain: JAX's jnp march_occlusion, at
    `march_relaxation`, with the clip that `shadow_bv_clip` sets, and at
    `max_vis_marches` 0 its first-DE verdict), in object order. A
    verdict is the OR of the instances' verdicts, which no order
    changes, so the kernel's instances go first."""
    ok = [intersect.kernel_occlusion_ok(s, prog) for prog, _bv in cfg.sdfs]
    kernel = tuple(i for i, k in zip(cfg.sdfs, ok) if k)
    rest = [i for i, k in zip(cfg.sdfs, ok) if not k]
    occ = (_kernel_verdicts(s, cfg._replace(sdfs=kernel), segs) if kernel
           else torch.zeros_like(segs.active))
    if rest:
        g = segs.geom.reshape(6, -1)
        start, end = g[:3].T.contiguous(), g[3:].T.contiguous()
        act = segs.active.reshape(-1)
        occ = occ.reshape(-1)
        for prog, bv in rest:
            occ = occ | march_cuda.march_occlusion_plain(
                prog, start, end, cfg.detail, cfg.max_steps, act & ~occ,
                relax=s.march_relaxation, bound_radius=bv)
        occ = occ.reshape(segs.active.shape)
    return occ


def _kernel_verdicts(s, cfg, segs) -> torch.Tensor:
    """[S, N] SDF verdicts of the queued segments from the refill march
    on the scratch, plain or relaxed, with the bounding-sphere clip as
    `shadow_bv_clip` says (the verdicts of the one-segment and chained
    marches); at plain marching with `occl_sort_steps` or
    `occl_phase1_steps` > 0 unclipped whatever `shadow_bv_clip` says, as
    JAX's two-phase occlusion marches (intersect.py:153-199), whose
    verdicts at a split >= 1 are those of the unclipped march.

    With `max_vis_marches` 0 the march JAX would route to decides: its
    chained march (relax 1, `chained_shadow_march`, 2-30 segments a ray)
    takes one step, as the scratch's march does; its single-segment and
    two-phase marches take none, so those verdicts come from
    march_cuda.march_occlusion's first-DE entry on the scratch's
    segments."""
    two_phase = (s.occl_sort_steps > 0 or s.occl_phase1_steps > 0)
    plain = s.march_relaxation == 1.0
    if plain and two_phase:
        cfg = shade_cuda.unclipped(cfg)
    n_seg = segs.active.shape[0]
    chained = (plain and not two_phase and s.chained_shadow_march
               and 1 < n_seg <= 30)
    if cfg.max_steps <= 0 and cfg.sdfs and not chained:
        g = segs.geom.reshape(6, -1)
        start, end = g[:3].T.contiguous(), g[3:].T.contiguous()
        act = segs.active.reshape(-1)
        occ = torch.zeros_like(act)
        for prog, bv in cfg.sdfs:   # the product fold over the instances
            occ = occ | march_cuda.march_occlusion(
                prog, start, end, cfg.detail, 0, act & ~occ,
                bound_radius=bv)
        return occ.reshape(n_seg, -1)
    return shade_cuda.shadow_march(cfg, segs, s.march_relaxation)


def _finish_bounce(s, tables, state, depth, info, mat, live, receives, wo,
                   vol_trans, radiance) -> PathState:
    """Steps 5-7 of the unfused bounce (JAX integrator.py:547-626): BSDF
    scatter and throughput (roulette at depth > 2), the depth-0 AOVs,
    termination, the NaN-throughput guard and the spawned ray's pdf."""
    n = state.origin.shape[0]
    u_f = rng.sample_1d(s, tables, rng.set1d_fresnel(s, depth),
                        state.sample_idx, state.pixel)
    u_diff = rng.sample_2d(s, tables, rng.set2d_diffuse(s, depth),
                           state.sample_idx, state.pixel)
    u_spec = rng.sample_2d(s, tables, rng.set2d_spec(s, depth),
                           state.sample_idx, state.pixel)
    se = bsdf_ops.scatter(mat, s, wo, info.normal, u_f, u_diff, u_spec)
    ndl = torch.abs(vecmath.dot(se.wi, info.normal))
    new_tp = (state.throughput * vol_trans[:, None] * se.f
              * (ndl / se.pdf)[:, None])
    if depth > 2:  # reference src/integrator.rs:147-156
        roulette = torch.clamp(1.0 - state.throughput.max(dim=-1).values,
                               min=0.05)
        new_tp = new_tp / (1.0 - roulette)[:, None]
    else:
        roulette = torch.zeros((n,), dtype=torch.float32,
                               device=state.origin.device)
    u_r = rng.sample_1d(s, tables, rng.set1d_roulette(s, depth),
                        state.sample_idx, state.pixel)
    terminate = (u_r < roulette) | (depth >= s.max_bounces)

    if depth == 0:
        alpha_out = torch.where(receives, 1.0, state.alpha_out)
        normal_out = torch.where(receives[:, None], info.normal,
                                 state.normal_out)
    else:
        alpha_out, normal_out = state.alpha_out, state.normal_out
    non_recv = (live & ~receives)[:, None]
    if depth == 0:
        bg_out = torch.where(non_recv, radiance, state.bg_out)
        color_out = state.color_out
    else:
        bg_out = state.bg_out
        color_out = torch.where(non_recv, radiance, state.color_out)
    color_out = torch.where((receives & terminate)[:, None], radiance,
                            color_out)
    survive = receives & ~terminate

    ndw = vecmath.dot(info.normal, se.wi)
    new_origin = info.point + info.normal * (
        torch.copysign(torch.ones_like(ndw), ndw) * info.offset_by)[:, None]
    tp_nan = torch.isnan(new_tp).any(dim=-1)
    next_tp = torch.where(tp_nan[:, None], state.throughput, new_tp)
    next_pdf = torch.where(mat.kind == REFRACTIVE, -1.0, se.pdf)
    sv = survive[:, None]
    return state._replace(
        origin=torch.where(sv, new_origin, state.origin),
        direction=torch.where(sv, se.wi, state.direction),
        radiance=radiance,
        throughput=torch.where(sv, next_tp, state.throughput),
        alive=survive,
        prev_pdf=torch.where(survive, next_pdf, state.prev_pdf),
        color_out=color_out, bg_out=bg_out, alpha_out=alpha_out,
        normal_out=normal_out)


def compact_order(alive: torch.Tensor) -> torch.Tensor:
    """The stable partition of the lanes, alive first: lane i of the
    compacted wavefront is lane order[i]. JAX's O(N) form
    (integrator.py:629-645): each lane's destination is its rank among
    the alive lanes, or n_alive + its rank among the dead ones,
    inverted."""
    alive_rank = torch.cumsum(alive.to(torch.int64), 0) - 1
    dead_rank = torch.cumsum((~alive).to(torch.int64), 0) - 1
    return _inverse(torch.where(alive, alive_rank,
                                alive_rank[-1] + 1 + dead_rank))


def _take(state: PathState, idx: torch.Tensor) -> PathState:
    return PathState(*(t.index_select(0, idx) for t in state))


def compact(state: PathState) -> PathState:
    """Stable-partition the wavefront: alive lanes first (reference
    src/film.rs:604-625, the dense repacking, here a gather)."""
    return _take(state, compact_order(state.alive))


def trace(data: SceneData, static: SceneStatic, settings: RenderSettings,
          tables: SampleTables, state: PathState, hps_abs0: float,
          hps_lin0: float) -> tuple[PathState, tuple]:
    """Run the bounce loop (depths 0..max_bounces). Returns the final
    state in the input's lane order and the depth-0 extra AOVs
    (settings.extra_aovs; () without them). With `compact_bounces`
    every bounce at depth >= 1 runs on the compacted wavefront."""
    tabs = shade_cuda.scene_tables(data, static)
    lanes, aovs = None, ()   # lane i of `state` is input lane lanes[i]
    for depth in range(settings.max_bounces + 1):
        if depth > 0 and settings.compact_bounces:
            order = compact_order(state.alive)
            state = _take(state, order)
            lanes = order if lanes is None else lanes[order]
        state, out = _bounce(data, static, settings, tables, state, depth,
                             hps_abs0, hps_lin0, scene_tables=tabs)
        if depth == 0:
            aovs = out
    if lanes is not None:
        state = _take(state, _inverse(lanes))
    return state, aovs
