"""The segments kernels' schedule and their in-kernel equi-angular
samples, on the CPU.

The segments kernels (csrc/shade.cu `shadow_segments_kernel`,
`queue_segments_kernel`) run one thread per ray: a warp computes the
sites of its 32 rays in turn, stages the ids of their active segments
and appends them to the queue with one atomicAdd. A volume site's
equi-angular distance and pdf are drawn in the kernel from the closest
hit's t. On 32x32 wavefronts of the default scene (camera rays and
their bounce rays):
- a plain model of that schedule (warps of 32 rays in a random order,
  each site of a warp's rays computed on those rays alone by the twins'
  per-site functions, one append a warp) equals `shadow_segments_plain`
  and `queue_segments_plain` bit for bit in geom, k, active and count,
  with the queue as a set, and appends once per warp with an active
  segment;
- the twins, which draw their volume sites' samples from t_hit, equal
  the same twins fed with the samples of the JAX integrator's algorithm
  (per march its distance draw, per site the light picked from the
  scene's light channel at the ray's time) bit for bit: with and
  without MIS, with no medium and one NEE sample, and with no lights;
- the four functions that take t_hit refuse tensors that are neither on
  the CPU nor on a CUDA device.
No JAX here: the twins are held to JAX in test_torch_queue.py,
test_torch_shade.py and test_torch_split_tail.py.
"""

import numpy as np
import pytest
import torch

from rayn_tpu_torch.config import RenderSettings
from rayn_tpu_torch.ops import filters, intersect_cuda, lights, shade_cuda
from rayn_tpu_torch.render import integrator, renderer
from rayn_tpu_torch.scene import presets
from rayn_tpu_torch.scene.scene import SceneBuilder, light_position_of
from rayn_tpu_torch.utils import rng

# The tensors here are small: one torch thread per test worker avoids
# contending with the other pytest workers for the cores.
torch.set_num_threads(1)

RES = (32, 32)
N = RES[0] * RES[1]
WARP = 32


def _no_lights_scene(resolution, device):
    """A sky, one Lambertian sphere and the default volume; no light."""
    b = SceneBuilder()
    b.set_volume(0.25, 0.035)
    sky = b.add_sky(top=(0.3, 0.4, 0.6), bottom=(0.01, 0.015, 0.03))
    b.add_sphere((0.0, 0.0, 0.0), 100.0, sky)
    b.add_sphere((0.0, 0.0, 0.0), 1.0, b.add_lambertian((0.5, 0.4, 0.3)))
    _d, _s, cam = presets.default_scene(resolution=resolution, device=device)
    return (*b.build(device), cam)


def _wavefront(depth, mis=False, volume=True, nee=4, scene="default"):
    """(scene, settings, tables, cfg, tabs, state, hit, args): `args` are
    the segments functions' arguments after cfg and tabs at `depth`
    (depth 1: the bounce rays of a depth-0 bounce tail)."""
    s = RenderSettings(resolution=RES, spp=1, max_marches=64,
                       max_vis_marches=48, rays_per_pass=N, mis=mis,
                       nee_light_samples=nee)
    if scene == "default":
        data, static, cam = presets.default_scene(resolution=RES,
                                                  volume=volume,
                                                  device="cpu")
    else:
        data, static, cam = _no_lights_scene(RES, "cpu")
    tables = rng.build_sample_tables(s, 1)
    fis = filters.build_fis_table(filters.blackman_harris(1.5), 512,
                                  device="cpu")
    o, d, tm, px, si, ok = renderer.generate_rays(
        s, tables, cam, fis, renderer.ray_indices(0, N, "cpu"), 1 / 24,
        2 / 24)
    state = integrator.init_state(o, d, tm, px, si, ok)
    ha, hl = cam.half_pixel_size_coeffs()
    tabs = shade_cuda.scene_tables(data, static)
    for dd in range(depth + 1):
        hps = ((torch.full((N,), ha), torch.full((N,), hl)) if dd == 0
               else (torch.zeros(N), torch.full((N,), 2e-4 * dd)))
        hit, info = intersect_cuda.closest_hit_shading_plain(
            data, static, s, state.origin, state.direction, *hps,
            state.alive)
        live, mat, recv, vtr = integrator._derive_shading(data, static,
                                                          state, hit, info)
        cfg = shade_cuda.shadow_cfg(data, static, s, tables, dd)
        if dd < depth:
            state = state._replace(**shade_cuda.bounce_tail_plain(
                cfg, tabs, state, hit, info, mat, live, recv, vtr, hit.t))
    return ((data, static), s, tables, cfg, tabs, state, hit,
            (state, info, mat, live, recv, vtr, hit.t))


def _same_bits(got, want):
    """Equal bit for bit (NaNs of any payload count as equal)."""
    if got.dtype != torch.float32:
        return torch.equal(got, want)
    return bool(((got.view(torch.int32) == want.view(torch.int32))
                 | (torch.isnan(got) & torch.isnan(want))).all())


def _same_segments(got, want):
    """Two scratches hold the same segments and queue the same ids (in
    any order)."""
    count = int(want.count[0])
    return (all(_same_bits(getattr(got, f), getattr(want, f))
                for f in ("geom", "k", "active", "count"))
            and torch.equal(got.queue[:count].sort().values,
                            want.queue[:count].sort().values))


def _site(kind, cfg, tabs, args, vd, vp, j):
    """Site j of the given rays as a warp of the kernel computes it:
    (start [n, 3], end [n, 3], k [n, 3], active [n])."""
    state, info, mat, live, recv, vtr, _t = args
    L = cfg.L
    if kind == "queue":
        if j < L:
            return shade_cuda._queue_nee_segment(cfg, tabs, state, info, mat,
                                                 recv, vtr, j)
        return shade_cuda._queue_vol_segment(cfg, tabs, state, live, j - L,
                                             vd[j - L], vp[j - L])
    v = shade_cuda._lane_values(state, info, mat, live, recv)
    if j < L:
        (s, e, act), k = shade_cuda._nee_segment(cfg, tabs, v, vtr, j)
    else:
        (s, e, act), k = shade_cuda._vol_segment(
            cfg, tabs, v, j - L, vd[j - L], vp[j - L])
    return (torch.stack(s, -1), torch.stack(e, -1), torch.stack(k, -1), act)


def _warp_model(kind, cfg, tabs, args, seed):
    """The kernel's schedule in plain torch: warps of 32 rays taken in a
    random order; in a warp, each site of its rays in turn, computed on
    those rays alone (the volume sites' samples drawn from their t_hit)
    and written to its slot j*N + i; the warp's active ids staged, then
    appended to the queue at once. Returns (the scratch, the appends)."""
    n = args[0].origin.shape[0]
    S = cfg.L + cfg.VM * cfg.L
    nan = float("nan")
    geom = torch.full((6, S, n), nan)
    k = torch.full((3, S, n), nan)
    active = torch.zeros((S, n), dtype=torch.bool)
    queue = torch.zeros((S * n,), dtype=torch.int32)
    count = appends = 0
    warps = torch.randperm(-(-n // WARP),
                           generator=torch.Generator().manual_seed(seed))
    for b in warps.tolist():
        rows = torch.arange(b * WARP, min(n, (b + 1) * WARP))
        cut = tuple(type(a)(*(t[rows] for t in a))
                    if isinstance(a, tuple) else a[rows] for a in args)
        vd, vp = shade_cuda._vol_samples(cfg, tabs, cut[0], cut[-1])
        staged = []
        for j in range(S):
            start, end, kj, act = _site(kind, cfg, tabs, cut, vd, vp, j)
            geom[:, j, rows] = torch.cat([start, end], -1).T
            k[:, j, rows] = kj.T
            active[j, rows] = act
            staged.append(j * n + rows[act])
        staged = torch.cat(staged).to(torch.int32)
        if staged.numel():
            queue[count:count + staged.numel()] = staged
            count += staged.numel()
            appends += 1
    return shade_cuda.ShadowSegments(
        geom, k, active, queue, torch.tensor([count], dtype=torch.int32)), \
        appends


@pytest.mark.parametrize("depth", [0, 1])
@pytest.mark.parametrize("kind", ["shadow", "queue"])
def test_warp_schedule_matches_twins(kind, depth):
    _scene, _s, _t, cfg, tabs, _state, _hit, args = _wavefront(
        depth, mis=True)
    want = getattr(shade_cuda, f"{kind}_segments_plain")(cfg, tabs, *args)
    got, appends = _warp_model(kind, cfg, tabs, args, seed=depth)
    assert cfg.L + cfg.VM * cfg.L == 12 and _same_segments(got, want)
    S = want.active.shape[0]
    warps = want.active.reshape(S, -1, WARP).any(-1).any(0)
    assert appends == int(warps.sum()) > 0
    # fewer than one append per warp and site with an active segment
    assert appends < int(want.active.reshape(S, -1, WARP).any(-1).sum())


def _integrator_samples(data, static, s, tables, state, t_hit, depth):
    """(vol_dist, vol_pdf) [VM*L, N] as the JAX integrator draws them
    (integrator.py:521-544): per march its distance draw, per site its
    light pick and the light's position at the ray's time."""
    out = []
    for m in range(s.volume_marches if static.has_scattering else 0):
        u_dist = rng.sample_1d(s, tables, rng.set1d_vol_dist(s, depth, m),
                               state.sample_idx, state.pixel)
        for i in range(s.nee_light_samples if static.n_lights else 0):
            u_pick = rng.sample_1d(s, tables,
                                   rng.set1d_vol_pick(s, depth, m, i),
                                   state.sample_idx, state.pixel)
            lidx = torch.clamp(torch.floor(u_pick * static.n_lights).to(
                torch.int64), 0, static.n_lights - 1)
            out.append(lights.sample_equi_angular(
                u_dist, light_position_of(data, lidx, state.time),
                state.origin, state.direction, t_hit))
    if not out:
        return torch.zeros((0, N)), torch.zeros((0, N))
    return torch.stack([d for d, _p in out]), torch.stack([p for _d, p in out])


SAMPLE_CASES = {
    "mis": dict(depth=1, mis=True),
    "no_mis": dict(depth=0),
    "no_medium_one_nee": dict(depth=1, mis=True, volume=False, nee=1),
    "no_lights": dict(depth=0, scene="no_lights"),
}


@pytest.mark.parametrize("case", sorted(SAMPLE_CASES))
def test_twins_draw_the_integrators_samples(case, monkeypatch):
    kw = SAMPLE_CASES[case]
    (data, static), s, tables, cfg, tabs, state, hit, args = _wavefront(**kw)
    tail_args = (cfg, tabs, state, hit, *args[1:])
    names = ["shadow_segments_plain", "shadow_radiance_plain"]
    if static.n_lights:
        names.append("queue_segments_plain")
    got = {name: getattr(shade_cuda, name)(cfg, tabs, *args)
           for name in names}
    got["bounce_tail_plain"] = shade_cuda.bounce_tail_plain(*tail_args)
    ref = _integrator_samples(data, static, s, tables, state, hit.t,
                              kw["depth"])
    monkeypatch.setattr(shade_cuda, "_vol_samples",
                        lambda cfg_, tabs_, state_, t_hit_: ref)
    want = {name: getattr(shade_cuda, name)(cfg, tabs, *args)
            for name in names}
    want["bounce_tail_plain"] = shade_cuda.bounce_tail_plain(*tail_args)
    assert (cfg.VM * cfg.L, cfg.L) == {
        "mis": (8, 4), "no_mis": (8, 4), "no_medium_one_nee": (0, 1),
        "no_lights": (0, 0)}[case]
    assert ref[0].shape == (cfg.VM * cfg.L, N)
    for name in names:
        g, w = got[name], want[name]
        if isinstance(w, torch.Tensor):
            assert _same_bits(g, w)
        else:
            assert _same_segments(g, w)
    assert all(_same_bits(got["bounce_tail_plain"][f],
                          want["bounce_tail_plain"][f])
               for f in want["bounce_tail_plain"])
    delta = got["shadow_radiance_plain"]
    assert bool((delta > 0).any()) == bool(static.n_lights)


WRAPPERS = ("shadow_segments", "queue_segments", "shadow_radiance",
            "bounce_tail")


@pytest.mark.parametrize("name", WRAPPERS)
def test_t_hit_wrappers_refuse_meta_tensors(name):
    data, static, _cam = presets.default_scene(resolution=(8, 8),
                                               device="cpu")
    cfg = shade_cuda.shadow_cfg(data, static, RenderSettings(
        resolution=(8, 8), spp=1), rng.SampleTables(1), 1)
    tabs = shade_cuda.scene_tables(data, static)
    z3 = torch.zeros((4, 3), device="meta")
    z = torch.zeros((4,), device="meta")
    state = integrator.PathState(*(z3,) * len(integrator.PathState._fields))
    head = (None,) if name == "bounce_tail" else ()
    with pytest.raises(ValueError):
        getattr(shade_cuda, name)(cfg, tabs, state, *head, None, None,
                                  z.bool(), z.bool(), z, z)


def test_warp_model_takes_warps_in_another_order():
    """The queue's order follows the warps' order, its set does not."""
    _scene, _s, _t, cfg, tabs, _state, _hit, args = _wavefront(0)
    a, _ = _warp_model("shadow", cfg, tabs, args, seed=3)
    b, _ = _warp_model("shadow", cfg, tabs, args, seed=4)
    count = int(a.count[0])
    assert not torch.equal(a.queue[:count], b.queue[:count])
    assert _same_segments(a, b)
    assert np.array_equal(a.active.numpy(), b.active.numpy())
