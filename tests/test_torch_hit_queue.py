"""The closest hit's refill schedule, the cost key and the equi-angular
samples of the port, on the CPU.

- The closest-hit kernel is a refill march: persistent lanes take rays
  in any order and evaluate one DE per loop iteration (the entry DE,
  the march steps, the four normal taps of an SDF hit). A plain model of
  that schedule, taking the rays of a 32x32 wavefront in a random order
  on 64 lanes, must equal `closest_hit_shading_plain` bit for bit in
  all six columns at depths 0 and 1, and its DEs per ray must equal
  `march.march_steps`.
- The cost key's twin against JAX's `integrator._intersect_cost_key`
  and the equi-angular twin against JAX's `_equi_angular_samples`, op
  by op (`jax.disable_jit`), with the tolerances stated at each test;
  the cost keys must give the same chunk permutation.
- The sort key's twin, which draws its own equi-angular distances, must
  equal the key of the same segments fed with the distances of the JAX
  integrator's algorithm bit for bit.
- The new wrappers refuse tensors that are neither on the CPU nor on a
  CUDA device.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rayn_tpu.config import RenderSettings as JSettings
from rayn_tpu.render import integrator as jint
from rayn_tpu.scene import presets as jpresets
from rayn_tpu.utils import rng as jrng
from rayn_tpu_torch import convert
from rayn_tpu_torch.config import RenderSettings
from rayn_tpu_torch.ops import filters, intersect_cuda, lights, shade_cuda
from rayn_tpu_torch.ops import march as march_ops
from rayn_tpu_torch.ops.sdf import dist_c
from rayn_tpu_torch.render import integrator, renderer
from rayn_tpu_torch.scene import presets
from rayn_tpu_torch.scene.scene import light_position_of
from rayn_tpu_torch.utils import rng

# The tensors here are small: one torch thread per test worker avoids
# contending with the other pytest workers for the cores.
torch.set_num_threads(1)

RES = (32, 32)
N = 1 << 10
KW = dict(resolution=RES, spp=1, max_marches=64, max_vis_marches=48,
          rays_per_pass=N)


@pytest.fixture(scope="module")
def wavefronts():
    """{depth: (state, hps_abs, hps_lin, hit, info)} of the default
    scene's 32x32 camera wavefront (depth 0) and of its bounce rays
    (depth 1), with the scene converted from JAX's."""
    s = RenderSettings(**KW)
    jdata, jstatic, _ = jpresets.default_scene(resolution=RES)
    data, static = convert.scene(jax.tree.map(np.asarray, jdata), jstatic,
                                 sdf_iterations=12, device="cpu")
    _d, _s, cam = presets.default_scene(resolution=RES, device="cpu")
    tables = rng.build_sample_tables(s, 1)
    fis = filters.build_fis_table(filters.blackman_harris(1.5), 512,
                                  device="cpu")
    o, d, tm, px, si, ok = renderer.generate_rays(
        s, tables, cam, fis, renderer.ray_indices(0, N, "cpu"), 1 / 24,
        2 / 24)
    state = integrator.init_state(o, d, tm, px, si, ok)
    ha, hl = cam.half_pixel_size_coeffs()
    out = {}
    for depth in (0, 1):
        if depth == 0:
            hps = (torch.full((N,), ha), torch.full((N,), hl))
        else:
            hps = (torch.zeros(N), torch.full((N,), 2e-4))
        hit, info = intersect_cuda.closest_hit_shading_plain(
            data, static, s, state.origin, state.direction, *hps,
            state.alive)
        out[depth] = (state, *hps, hit, info)
        live, mat, recv, vtr = integrator._derive_shading(data, static,
                                                          state, hit, info)
        cfg = shade_cuda.shadow_cfg(data, static, s, tables, depth)
        tabs = shade_cuda.scene_tables(data, static)
        state = state._replace(**shade_cuda.bounce_tail_plain(
            cfg, tabs, state, hit, info, mat, live, recv, vtr, hit.t))
    return (jdata, jstatic), (data, static, s, tables), out


# -------------------------------------------- the refill schedule, modelled
ENTRY, MARCH = -2, -1
# sign of (x, y, z) of normal tap k (ops/sdf.py TETRA_TAPS)
TAP_SIGNS = torch.tensor([[1.0, -1.0, -1.0], [-1.0, 1.0, -1.0],
                          [-1.0, -1.0, 1.0], [1.0, 1.0, 1.0]])


def _refill_model(data, static, s, origin, direction, hps_abs, hps_lin,
                  active, lanes=64, seed=0):
    """The closest-hit kernel's schedule in plain torch: `lanes` lanes
    take the rays in a random order; a ray with no DE to take (inactive)
    is done when it is taken; each iteration evaluates one DE per busy
    lane at its stage (entry, march step, normal tap 0-3) and advances
    it; a ray's state lives in its own slot. Returns ((Hit, ShadingInfo),
    the DEs each ray took)."""
    n = origin.shape[0]
    K, mb, detail = static.n_spheres, data.sdf_params, s.sdf_detail_scale
    best_t, best_obj = intersect_cuda.sphere_fold(data, static, s, origin,
                                                  direction)
    hps = torch.zeros(n)
    g = torch.zeros((n, 3))
    n_de = torch.zeros(n, dtype=torch.int32)
    lane_ray = torch.full((lanes,), -1, dtype=torch.int64)
    stage = torch.full((lanes,), ENTRY, dtype=torch.int64)
    step = torch.zeros(lanes, dtype=torch.int64)
    t = torch.zeros(lanes)
    order = torch.randperm(n, generator=torch.Generator().manual_seed(seed))
    order, pos = order.tolist(), 0
    while True:
        for lane in torch.nonzero(lane_ray < 0).squeeze(1).tolist():
            while pos < n:
                i = order[pos]
                pos += 1
                if bool(active[i]):
                    lane_ray[lane], stage[lane] = i, ENTRY
                    break
        busy = torch.nonzero(lane_ray >= 0).squeeze(1)
        if busy.numel() == 0:
            break
        ids, st, tl = lane_ray[busy], stage[busy], t[busy]
        o, d, bt = origin[ids], direction[ids], best_t[ids]
        sign = TAP_SIGNS[torch.clamp(st, min=0)]
        at_march = o + tl[:, None] * d
        at_tap = (o + bt[:, None] * d) + sign * hps[ids][:, None]
        entry, march, tap = st == ENTRY, st == MARCH, st >= 0
        p = torch.where(entry[:, None], o,
                        torch.where(march[:, None], at_march, at_tap))
        dist = dist_c(mb, p[:, 0], p[:, 1], p[:, 2])
        n_de[ids] += 1
        # entry: t is the DE at the origin (a NaN one ends the march)
        done_e = torch.isnan(dist) | (s.max_marches <= 0) | (dist > bt)
        # march step: the cone-traced threshold, else t advances
        eps_abs = (0.05 * detail) * hps_abs[ids]
        eps_lin = (0.05 * detail) * hps_lin[ids]
        hit = torch.abs(dist) < torch.clamp(eps_abs + eps_lin * tl,
                                            min=5e-5 * detail)
        t_m = torch.where(hit, tl, tl + dist)
        step_m = step[busy] + (~hit).long()
        done_m = hit | (step_m >= s.max_marches) | (t_m > bt)
        # normal tap: accumulate the gradient
        g[ids[tap]] = g[ids[tap]] + sign[tap] * dist[tap][:, None]
        new_t = torch.where(entry, dist, torch.where(march, t_m, tl))
        t[busy] = new_t
        step[busy] = torch.where(entry, 0, torch.where(march, step_m,
                                                       step[busy]))
        march_done = (entry & done_e) | (march & done_m)
        sdf_hit = march_done & (new_t < bt)
        h = ids[sdf_hit]
        best_t[h] = new_t[sdf_hit]
        best_obj[h] = K
        hps[h] = torch.clamp(detail * (hps_abs[h] + hps_lin[h] * best_t[h]),
                             min=1e-4)
        stage[busy] = torch.where(
            sdf_hit, 0, torch.where(entry & ~done_e, MARCH,
                                    torch.where(tap, st + 1, st)))
        finished = (march_done & ~sdf_hit) | (tap & (st == 3))
        lane_ray[busy[finished]] = -1
    return intersect_cuda.write_hit_plain(data, static, origin, direction,
                                          active, best_t, best_obj, hps,
                                          g), n_de


def _same_bits(got, want):
    """Equal bit for bit (NaNs of any payload count as equal)."""
    if got.dtype != torch.float32:
        return torch.equal(got, want)
    return bool(((got.view(torch.int32) == want.view(torch.int32))
                 | (torch.isnan(got) & torch.isnan(want))).all())


def _march_args(data, static, s, state, hps_abs, hps_lin):
    """march_ops.march's arguments in the closest hit: the march bounded
    by the sphere fold's closest t."""
    detail = s.sdf_detail_scale
    t_max, _obj = intersect_cuda.sphere_fold(data, static, s, state.origin,
                                             state.direction)
    return (data.sdf_params, state.origin, state.direction, t_max,
            5e-5 * detail, 0.05 * detail * hps_abs, 0.05 * detail * hps_lin,
            s.max_marches, state.alive)


@pytest.mark.parametrize("depth", [0, 1])
def test_refill_schedule_matches_closest_hit_plain(wavefronts, depth):
    """Taken in a random order on 64 lanes, one DE per lane per step,
    every ray ends with the twin's bits in all six columns, having taken
    the DEs that march_steps counts."""
    _j, (data, static, s, _tables), out = wavefronts
    state, hps_abs, hps_lin, hit, info = out[depth]
    (mh, mi), n_de = _refill_model(data, static, s, state.origin,
                                   state.direction, hps_abs, hps_lin,
                                   state.alive, seed=depth)
    assert all(_same_bits(g, w) for g, w in zip(mh, hit))
    assert all(_same_bits(g, w) for g, w in zip(mi, info))
    assert bool((hit.obj == static.n_spheres).any())
    assert torch.equal(n_de, march_ops.march_steps(
        *_march_args(data, static, s, state, hps_abs, hps_lin)))


@pytest.mark.parametrize("depth", [0, 1])
def test_march_steps_counts_plain_march_des(wavefronts, depth, monkeypatch):
    """march_steps counts the entry DE, the steps begun at t <= t_max and
    four taps per SDF hit: the plain march takes the same DEs plus one
    for each ray whose last step left it past t_max, which the kernel
    stops before its DE."""
    _j, (data, static, s, _tables), out = wavefronts
    state, hps_abs, hps_lin, hit, _info = out[depth]
    taken = [0]

    def counting(mb, x, y, z):
        taken[0] += x.numel()
        return dist_c(mb, x, y, z)

    args = _march_args(data, static, s, state, hps_abs, hps_lin)
    t_max = args[3]
    monkeypatch.setattr(march_ops, "dist_c", counting)
    t = march_ops.march(*args)
    monkeypatch.undo()
    n_de = march_ops.march_steps(*args)
    taps = 4 * int((hit.obj == static.n_spheres).sum())
    past = int((state.alive & (t > t_max)).sum())
    assert int(n_de.sum()) - taps <= taken[0] <= int(n_de.sum()) - taps + past
    assert int(n_de[~state.alive].sum()) == 0


def _jax_state(state, t_hit=None):
    """The fields of a port PathState (and a hit's t) as JAX arrays."""
    j = {f: jnp.asarray(getattr(state, f).numpy())
         for f in ("origin", "direction", "time", "alive", "sample_idx",
                   "pixel")}
    return types.SimpleNamespace(**j), types.SimpleNamespace(
        t=None if t_hit is None else jnp.asarray(t_hit.numpy()))


def test_cost_key_twin_matches_jax(wavefronts):
    """The cost key's twin (and its wrapper on the CPU) against JAX's
    _intersect_cost_key op by op, on the depth-1 wavefront (some rays
    dead): rtol 1e-6, the sphere roots' square root and the DE's
    division being the only inexact ops, each correctly rounded in
    both; the chunk permutation of 8-ray chunks is the same."""
    (jdata, jstatic), (data, static, s, _tables), out = wavefronts
    state = out[1][0]
    assert bool((~state.alive).any()) and bool(state.alive.any())
    args = (data, static, s, state.origin, state.direction, state.time,
            state.alive)
    got = intersect_cuda.intersect_cost_key_plain(*args)
    assert _same_bits(intersect_cuda.intersect_cost_key(*args), got)
    with jax.disable_jit():
        want = np.asarray(jint._intersect_cost_key(
            jdata, jstatic, JSettings(**KW), _jax_state(state)[0]))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0.0)
    assert (got > 1.0).any()
    assert torch.equal(integrator._chunk_perm(got, 8),
                       integrator._chunk_perm(torch.from_numpy(want.copy()), 8))


@pytest.mark.parametrize("depth", [0, 1])
def test_equi_angular_twin_matches_jax(wavefronts, depth):
    """The equi-angular twin (whose distances the segments twin draws
    from t_hit) against JAX's _equi_angular_samples op by op: the same
    sampler draws and light picks, then atan2 and tan, whose CPU
    implementations in XLA and torch may round differently. Distances within rtol 1e-5 or atol 2e-5 (a
    sample near the ray's origin is delta + t with delta and t large and
    opposite: the error is an ulp of |delta| <= 2 * world_radius) on
    every site. Pdfs within rtol 1e-4 on >= 99.5% of sites and within
    rtol 0.1 on every site: where theta_a and theta_b nearly cancel (a
    bounce ray that meets the fractal within ~1e-5 of its origin), the
    pdf's 1 / (theta_b - theta_a) turns an ulp of the angles into
    percents."""
    (jdata, jstatic), (data, static, s, tables), out = wavefronts
    state, _ha, _hl, hit, info = out[depth]
    cfg = shade_cuda.shadow_cfg(data, static, s, tables, depth)
    tabs = shade_cuda.scene_tables(data, static)
    args = (cfg, tabs, state.origin, state.direction, hit.t,
            state.sample_idx, state.pixel)
    vd, vp = shade_cuda.equi_angular_plain(*args)
    # the volume sites' start points that the segments twin draws from
    # t_hit are the scatter points at these distances
    live, mat, recv, vtr = integrator._derive_shading(data, static, state,
                                                      hit, info)
    segs = shade_cuda.shadow_segments_plain(cfg, tabs, state, info, mat,
                                            live, recv, vtr, hit.t)
    wd = segs.geom[:3, cfg.L:].permute(1, 2, 0)
    wp = state.origin + vd[:, :, None] * state.direction
    assert _same_bits(wd, wp)
    assert vd.shape == (cfg.VM * cfg.L, N) and cfg.VM * cfg.L > 0
    js = JSettings(**KW)
    jstate, jhit = _jax_state(state, hit.t)
    with jax.disable_jit():
        jd, jp = jint._equi_angular_samples(
            jdata, jstatic, js, jrng.build_sample_tables(js, 1), jstate,
            jhit, depth)
    jd = np.stack([np.asarray(v) for m in jd for v in m])
    jp = np.stack([np.asarray(v) for m in jp for v in m])
    np.testing.assert_allclose(vd.numpy(), jd, rtol=1e-5, atol=2e-5)
    close = np.isclose(vp.numpy(), jp, rtol=1e-4, atol=0.0)
    assert close.mean() >= 0.995, close.mean()
    np.testing.assert_allclose(vp.numpy(), jp, rtol=0.1, atol=0.0)


def _integrator_equi_angular(data, static, s, tables, state, t_hit, depth):
    """The volume sites' distances as the JAX integrator computes them
    (integrator.py:521-544): per march its distance draw, per site its
    light pick and the light's position at the ray's time."""
    out = []
    for m in range(s.volume_marches):
        u_dist = rng.sample_1d(s, tables, rng.set1d_vol_dist(s, depth, m),
                               state.sample_idx, state.pixel)
        for i in range(s.nee_light_samples):
            u_pick = rng.sample_1d(s, tables,
                                   rng.set1d_vol_pick(s, depth, m, i),
                                   state.sample_idx, state.pixel)
            lidx = torch.clamp(torch.floor(u_pick * static.n_lights).to(
                torch.int64), 0, static.n_lights - 1)
            out.append(lights.sample_equi_angular(
                u_dist, light_position_of(data, lidx, state.time),
                state.origin, state.direction, t_hit)[0])
    return out


def test_sort_key_twin_draws_the_integrators_distances(wavefronts):
    """At depth 1, the sort key's twin equals the key of the same
    segments fed with the JAX integrator's equi-angular distances bit for
    bit, and counts one DE per active segment."""
    _j, (data, static, s, tables), out = wavefronts
    state, _ha, _hl, hit, info = out[1]
    live, _mat, recv, _vtr = integrator._derive_shading(data, static, state,
                                                        hit, info)
    cfg = shade_cuda.shadow_cfg(data, static, s, tables, 1)
    tabs = shade_cuda.scene_tables(data, static)
    n_de = torch.zeros(N, dtype=torch.int32)
    head = (cfg, tabs, info.point, info.normal, info.offset_by,
            state.origin, state.direction)
    tail = (live, recv, state.sample_idx, state.pixel)
    got = shade_cuda.shadow_sort_key_plain(*head, hit.t, *tail, n_de=n_de)
    vd = _integrator_equi_angular(data, static, s, tables, state, hit.t, 1)
    want = shade_cuda._shadow_cost_key(*head, *tail, vd)
    assert _same_bits(got, want) and bool((want > cfg.L).any())
    assert _same_bits(shade_cuda.shadow_sort_key(*head, hit.t, *tail), got)
    assert int(n_de[~live].sum()) == 0
    assert int(n_de.max()) <= cfg.L + cfg.VM * cfg.L


def test_new_wrappers_refuse_other_devices():
    """A tensor that is neither on the CPU nor on a CUDA device is
    refused, never moved."""
    data, static, _cam = presets.default_scene(resolution=(8, 8),
                                               device="cpu")
    s = RenderSettings(resolution=(8, 8), spp=1)
    z3 = torch.zeros((4, 3), device="meta")
    z = torch.zeros((4,), device="meta")
    with pytest.raises(ValueError):
        intersect_cuda.intersect_cost_key(data, static, s, z3, z3, z,
                                          z.bool())
    cfg = shade_cuda.shadow_cfg(data, static, s, rng.SampleTables(1), 1)
    tabs = shade_cuda.scene_tables(data, static)
    state = integrator.PathState(*(z3,) * len(integrator.PathState._fields))
    with pytest.raises(ValueError):
        shade_cuda.shadow_segments(cfg, tabs, state, None, None, z.bool(),
                                   z.bool(), z, z)
    with pytest.raises(ValueError):
        intersect_cuda.closest_hit_shading(
            data, static, s, z3, z3, z, z, z.bool(),
            warp_steps=torch.zeros((1,), dtype=torch.int64, device="meta"))
