"""Wavefront path-tracing integrator: the kernel path of
`rayn_tpu.render.integrator.bounce` (reference src/integrator.rs:32-281).

One bounce at depth d:
1. at d >= 1, the pre-intersect chunk cost sort (`sorted_intersect`);
2. closest hit + shading info (the intersect kernel);
3. per-lane shading values (`_derive_shading`);
4. at d >= 1, the equi-angular samples, the shadow sort-key kernel and
   the chunk sort (`sorted_shadow_march`);
5. the bounce-tail kernel (NEE, volume scattering, emission, scatter,
   roulette, AOVs, termination);
6. the unsort back to pixel-major order.

Sorting moves whole chunks of lanes and every per-lane result is
position-independent, so sorted and unsorted bounces give bit-identical
outputs. The unfused segment-queue branch and `compact` are not ported
yet.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rayn_tpu_torch.config import RenderSettings
from rayn_tpu_torch.ops import bsdf as bsdf_ops
from rayn_tpu_torch.ops import intersect_cuda, lights, shade_cuda
from rayn_tpu_torch.ops import spheres as sphere_ops
from rayn_tpu_torch.ops.sdf import dist
from rayn_tpu_torch.scene.scene import (SceneData, SceneStatic,
                                        light_position_of, sphere_centers_at)
from rayn_tpu_torch.utils import rng
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


def _chunk_of(s: RenderSettings, n: int) -> int:
    chunk = s.sorted_chunk or _sort_chunk(n)
    if s.sorted_chunk and n % chunk:
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


def _unsort_state(state: PathState, perm: torch.Tensor, chunk: int):
    """Invert a chunk permutation on a bounce's output state."""
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.shape[0], device=perm.device)
    return _permute_chunks(state, inv, chunk)


def _intersect_cost_key(data: SceneData, static: SceneStatic,
                        settings: RenderSettings, state: PathState):
    """Estimated primary-march steps per lane before the intersect:
    distance to the sphere-fold closest over the first DE step."""
    n = state.origin.shape[0]
    t_max0 = 2.0 * settings.world_radius
    full = torch.full((n,), t_max0, dtype=torch.float32,
                      device=state.origin.device)
    if static.n_spheres:
        ts = sphere_ops.hit(state.origin, state.direction,
                            sphere_centers_at(data, state.time),
                            data.sphere_radii, full)
        bound = torch.clamp(ts.min(dim=-1).values, max=t_max0)
    else:
        bound = full
    d0 = dist(data.sdf_params, state.origin)
    est = torch.clamp(bound / torch.clamp(d0, min=1e-6),
                      max=float(settings.max_marches))
    ok = state.alive & ~torch.isnan(d0)
    return torch.where(ok, est, torch.ones_like(est))


def _derive_shading(data: SceneData, static: SceneStatic, state: PathState,
                    hit, info):
    """(live, material params, receives, vol_trans) of each lane."""
    live = state.alive & hit.valid
    mat = bsdf_ops.gather(data.materials, info.mat)
    receives = bsdf_ops.receives_light(mat) & live
    if static.has_extinction:
        vol_trans = torch.exp(-data.volume_sigma_t * hit.t)
    else:
        vol_trans = torch.ones_like(hit.t)
    return live, mat, receives, vol_trans


def _equi_angular_samples(data, static, s, tables, state, hit, depth):
    """(vol_dists, vol_pdfs): VM*L [N] tensors each, march-major, in torch
    outside the kernels exactly as in JAX (integrator.py:521-544)."""
    vol_dists, vol_pdfs = [], []
    if static.has_scattering and s.volume_marches and static.n_lights > 0:
        for m in range(s.volume_marches):
            u_dist = rng.sample_1d(s, tables, rng.set1d_vol_dist(s, depth, m),
                                   state.sample_idx, state.pixel)
            for i in range(s.nee_light_samples):
                u_pick = rng.sample_1d(
                    s, tables, rng.set1d_vol_pick(s, depth, m, i),
                    state.sample_idx, state.pixel)
                lidx = torch.clamp(
                    torch.floor(u_pick * static.n_lights).to(torch.int64),
                    0, static.n_lights - 1)
                lp = light_position_of(data, lidx, state.time)
                vdist, vpdf = lights.sample_equi_angular(
                    u_dist, lp, state.origin, state.direction, hit.t)
                vol_dists.append(vdist)
                vol_pdfs.append(vpdf)
    return vol_dists, vol_pdfs


def bounce(data: SceneData, static: SceneStatic, settings: RenderSettings,
           tables: SampleTables, state: PathState, depth: int,
           hps_abs0: float, hps_lin0: float, scene_tables=None) -> PathState:
    """One wavefront bounce at `depth`. scene_tables: the (lights,
    spheres) constant tables of shade_cuda.scene_tables, built per call
    when not given."""
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

    chunk = _chunk_of(s, n)
    pre_perm = None
    if s.sorted_intersect and depth > 0 and static.has_sdf and chunk:
        (state,), pre_perm = _sort_tree_by_cost(
            (state,), _intersect_cost_key(data, static, s, state), chunk)

    hit, info = intersect_cuda.closest_hit_shading(
        data, static, s, state.origin, state.direction, hps_abs, hps_lin,
        state.alive)
    live, mat, receives, vol_trans = _derive_shading(data, static, state,
                                                     hit, info)
    lights_t, spheres_t = scene_tables or shade_cuda.scene_tables(data,
                                                                  static)
    cfg = shade_cuda.shadow_cfg(data, static, s, tables, depth)

    shadow_perm = None
    if (s.sorted_shadow_march and s.chained_shadow_march and depth > 0
            and static.has_sdf and static.n_lights > 0 and chunk):
        vd0, _ = _equi_angular_samples(data, static, s, tables, state, hit,
                                       depth)
        cost = shade_cuda.shadow_sort_key(
            cfg, lights_t, info.point, info.normal, info.offset_by,
            state.origin, state.direction, live, receives, state.sample_idx,
            state.pixel, vd0)
        (state, hit, info), shadow_perm = _sort_tree_by_cost(
            (state, hit, info), cost, chunk)
        live, mat, receives, vol_trans = _derive_shading(data, static, state,
                                                         hit, info)

    vol_dists, vol_pdfs = _equi_angular_samples(data, static, s, tables,
                                                state, hit, depth)
    out = shade_cuda.bounce_tail(cfg, lights_t, spheres_t, state, info, mat,
                                 live, receives, vol_trans, vol_dists,
                                 vol_pdfs)
    out = state._replace(**out)
    perm = pre_perm
    if shadow_perm is not None:
        perm = shadow_perm if perm is None else perm[shadow_perm]
    return out if perm is None else _unsort_state(out, perm, chunk)


def trace(data: SceneData, static: SceneStatic, settings: RenderSettings,
          tables: SampleTables, state: PathState, hps_abs0: float,
          hps_lin0: float) -> PathState:
    """Run the bounce loop (depths 0..max_bounces)."""
    tabs = shade_cuda.scene_tables(data, static)
    for depth in range(settings.max_bounces + 1):
        state = bounce(data, static, settings, tables, state, depth,
                       hps_abs0, hps_lin0, scene_tables=tabs)
    return state
