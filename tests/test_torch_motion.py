"""Motion blur and lenses in the port on the CPU against rayn_tpu: the
animated presets, animated sphere and light channels, animated cameras,
the thin-lens and orthographic cameras.

Every JAX reference runs op by op (`jax.disable_jit`, see
tests/test_torch_render.py) at test_torch_render's 1024-ray shape (16x16,
4 spp, one bounce, `max_marches` 24), so that JAX compiles each primitive
once. Rays span `time_range=(0.0, 2.0)`: at frame 1's 1/24 s every lane
would fall in the first knot interval of an 8-knot channel over [0, 2] s.

- `generate_rays` for the animated pinhole camera (64 knots), a thin lens
  (aperture 0.35, as tests/test_render_e2e.py) and an orthographic
  camera: origins and directions within atol 1e-6, times within 1 ulp
  of 2 s, the sampler's integers (pixel, sample number) bit for bit.
- Images of `default_scene(animated_geo=True)` at 8 and 64 knots on the
  fused path and at 8 knots on the relaxed segment queue: RMSE < 1.5e-3
  and mean relative difference < 1e-3 (test_torch_render's gates).
- Per-lane values at depth 1 with MIS on the 8-knot scene: the closest
  hit's twin against JAX's intersect.closest_hit + shading_info (object
  ids and validity bit for bit, floats within atol 1e-5), the cost key's
  against JAX's (rtol 1e-5), the sort key's against JAX's Pallas kernel
  in interpret mode (rtol 1e-4 on >= 99.9%, as tests/test_torch_shade.py);
  both segments twins against the segments the JAX unfused bounce hands
  to intersect.test_occluded (start and end within atol 1e-4 on >= 99.5%
  of the active segments: a cone sample turns an ulp of sin/cos into
  ~1e-5, shade_pallas.py:34-45; the active flags, JAX's with its
  sphere test, equal on >= 99.9%); and one bounce on the fused, split
  (finish twin with MIS) and relaxed-queue routes against JAX's
  integrator.bounce with test_torch_render's gates.
- The constant scene is unchanged: every twin gives the same bits with
  the lanes' times, with no time and with NaN times.
- none of these scenes or cameras is refused, on the kernel route or
  the route without kernels (`use_pallas=False`).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rayn_tpu.config import RenderSettings as JSettings
from rayn_tpu.ops import filters as jfilters
from rayn_tpu.ops import intersect as jintersect
from rayn_tpu.ops import shade_pallas as jshade
from rayn_tpu.ops import spheres as jspheres
from rayn_tpu.render import camera as jcamera
from rayn_tpu.render import film as jfilm
from rayn_tpu.render import integrator as jint
from rayn_tpu.render import renderer as jrenderer
from rayn_tpu.scene import presets as jpresets
from rayn_tpu.scene.scene import sphere_centers_at as jcenters_at
from rayn_tpu.utils import rng as jrng
from rayn_tpu_torch import convert
from rayn_tpu_torch.config import RenderSettings
from rayn_tpu_torch.ops import filters, intersect_cuda, shade_cuda
from rayn_tpu_torch.render import camera as camera_mod
from rayn_tpu_torch.render import film, integrator, renderer
from rayn_tpu_torch.scene import presets
from rayn_tpu_torch.utils import rng

# The tensors here are small: one torch thread per test worker avoids
# contending with the other pytest workers for the cores.
torch.set_num_threads(1)

RES = (16, 16)
N = RES[0] * RES[1] * 4
TIME = (0.0, 2.0)
ORIGIN = (-1.0125, 0.45, 4.5)   # the default scene's camera origin


def _kw(**change):
    kw = dict(resolution=RES, spp=4, max_bounces=1, max_marches=24,
              max_vis_marches=16, rays_per_pass=N)
    kw.update(change)
    return kw


def _np(x):
    return np.asarray(x)


def _T(x):
    return torch.from_numpy(np.array(x))


def _port_scene(jdata, jstatic):
    return convert.scene(jax.tree.map(np.asarray, jdata), jstatic,
                         sdf_iterations=12, device="cpu")


# ------------------------------------------------------------- cameras
def _jax_camera(kind):
    if kind == "pinhole_animated":
        return jpresets.default_scene(resolution=RES, animated=True)[2]
    if kind == "thin_lens":
        return jcamera.ThinLensCamera.make(RES, 60.0, 0.35, ORIGIN,
                                           (0.0, 0.0, 0.0), (0.0, 1.0, 0.0),
                                           (0.0, 0.0, 0.0))
    return jcamera.OrthographicCamera.make(RES, 6.0, ORIGIN, (0.0, 0.0, 0.0),
                                           (0.0, 1.0, 0.0))


def _port_camera(kind):
    """The same camera built by the port's own constructors."""
    if kind == "pinhole_animated":
        return presets.default_scene(resolution=RES, animated=True,
                                     device="cpu")[2]
    if kind == "thin_lens":
        return camera_mod.ThinLensCamera.make(
            RES, 60.0, 0.35, ORIGIN, (0.0, 0.0, 0.0), (0.0, 1.0, 0.0),
            (0.0, 0.0, 0.0), device="cpu")
    return camera_mod.OrthographicCamera.make(
        RES, 6.0, ORIGIN, (0.0, 0.0, 0.0), (0.0, 1.0, 0.0), device="cpu")


@pytest.mark.parametrize("kind", ["pinhole_animated", "thin_lens",
                                  "orthographic"])
def test_generate_rays_matches_jax(kind):
    js, ts = JSettings(**_kw()), RenderSettings(**_kw())
    jcam = _jax_camera(kind)
    tcam = convert.camera(jax.tree.map(np.asarray, jcam), device="cpu")
    own = _port_camera(kind)
    assert type(own) is type(tcam)
    for a, b in zip(own, tcam):   # the port's constructors give JAX's camera
        if hasattr(a, "values"):
            assert torch.equal(a.values, b.values) and (a.t0, a.t1) == (
                b.t0, b.t1)
        else:
            assert a == b
    assert tcam.half_pixel_size_coeffs() == tuple(
        float(x) for x in jcam.half_pixel_size_coeffs())
    fis = jfilters.build_fis_table(jfilters.blackman_harris(1.5), 512)
    with jax.disable_jit():
        want = jrenderer.generate_rays(
            js, jrng.build_sample_tables(js, frame=1), jcam, fis,
            jrenderer.ray_indices(jnp.int32(0), N), jnp.float32(TIME[0]),
            jnp.float32(TIME[1]))
    got = renderer.generate_rays(
        ts, rng.build_sample_tables(ts, 1), tcam,
        filters.build_fis_table(filters.blackman_harris(1.5), 512,
                                device="cpu"),
        renderer.ray_indices(0, N, "cpu"), *TIME)
    o, d, tm, px, si, ok = (_np(w) for w in want)
    np.testing.assert_allclose(got[0].numpy(), o, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[1].numpy(), d, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[2].numpy(), tm, rtol=0, atol=2.4e-7)
    for g, w in zip(got[3:], (px, si, ok)):
        np.testing.assert_array_equal(g.numpy(), w)
    # the lens spreads the origins; the orthographic rays are parallel
    spread = got[0].std(dim=0).max().item()
    if kind == "thin_lens":
        assert 0.01 < spread < 0.35
    elif kind == "orthographic":
        assert (got[1] == got[1][0]).all() and spread > 1.0


# -------------------------------------------------------------- images
IMAGE_CASES = {"fused_8": (8, {}), "fused_64": (64, {}),
               "relaxed_8": (8, dict(march_relaxation=1.5))}


@pytest.mark.parametrize("case", sorted(IMAGE_CASES))
def test_animated_geo_image_matches_jax(case):
    knots, change = IMAGE_CASES[case]
    kw = _kw(**change)
    jdata, jstatic, jcam = jpresets.default_scene(
        resolution=RES, animated_geo=True, geo_knots=knots)
    with jax.disable_jit():
        want = _np(jfilm.resolve(jrenderer.render_frame(
            jdata, jstatic, JSettings(**kw), jcam, frame=1,
            time_range=TIME), RES).color)
    tdata, tstatic = _port_scene(jdata, jstatic)
    assert tdata.light_pos.knots == knots == tdata.sphere_centers.knots
    tcam = convert.camera(jax.tree.map(np.asarray, jcam), device="cpu")
    f = renderer.render_frame(tdata, tstatic, RenderSettings(**kw), tcam,
                              frame=1, time_range=TIME)
    got = film.resolve(f, RES).color
    assert f.samples.sum().item() == N and np.isfinite(got).all()
    rmse = float(np.sqrt(np.mean((got - want) ** 2)))
    mean_rel = abs(got.mean() - want.mean()) / want.mean()
    assert rmse < 1.5e-3, rmse
    assert mean_rel < 1e-3, mean_rel


# ------------------------------------------------ per-lane values, depth 1
@pytest.fixture(scope="module")
def depth1():
    """The 8-knot animated-geo scene (JAX's and the port's), the JAX
    settings with MIS, JAX's depth-1 state (after its op-by-op depth-0
    bounce), and the segments JAX's depth-1 bounce hands to
    intersect.test_occluded with the state after it. JAX's chunk sorts
    are off, so that the segments come in lane order (a sort changes no
    lane's result)."""
    js = JSettings(**_kw(max_bounces=3, mis=True, sorted_intersect=False,
                         sorted_shadow_march=False))
    jdata, jstatic, jcam = jpresets.default_scene(
        resolution=RES, animated_geo=True, geo_knots=8)
    jtables = jrng.build_sample_tables(js, frame=1)
    fis = jfilters.build_fis_table(jfilters.blackman_harris(1.5), 512)
    ha, hl = jcam.half_pixel_size_coeffs()
    seen = []
    real = jintersect.test_occluded

    def recording(*a, **kw):
        seen.append(a)
        return real(*a, **kw)

    with jax.disable_jit():
        o, d, tm, px, si, ok = jrenderer.generate_rays(
            js, jtables, jcam, fis, jrenderer.ray_indices(jnp.int32(0), N),
            jnp.float32(TIME[0]), jnp.float32(TIME[1]))
        state0 = jint.init_state(o, d, tm, px, si, ok)
        state1 = jint.bounce(jdata, jstatic, js, jtables, state0, 0, ha, hl)
        jint.intersect.test_occluded = recording
        try:
            state2 = jint.bounce(jdata, jstatic, js, jtables, state1, 1, ha,
                                 hl)
        finally:
            jint.intersect.test_occluded = real
    tdata, tstatic = _port_scene(jdata, jstatic)
    return dict(js=js, jdata=jdata, jstatic=jstatic, jtables=jtables,
                state1=state1, state2=state2, occluded_args=seen[0],
                tdata=tdata, tstatic=tstatic)


def _port_state(jstate):
    return integrator.PathState(*(_T(getattr(jstate, f))
                                  for f in integrator.PathState._fields))


def _port_hit(d, ts, state):
    n = state.origin.shape[0]
    hps = (torch.zeros(n), torch.full((n,), 2e-4))
    return intersect_cuda.closest_hit_shading_plain(
        d["tdata"], d["tstatic"], ts, state.origin, state.direction, *hps,
        state.alive, state.time)


def test_closest_hit_and_cost_key_twins_match_jax(depth1):
    d = depth1
    js, ts = d["js"], RenderSettings(**_kw(max_bounces=3, mis=True))
    st = d["state1"]
    n = N
    hps = (jnp.zeros(n), jnp.full((n,), 2e-4, jnp.float32))
    with jax.disable_jit():
        jhit = jintersect.closest_hit(
            d["jdata"], d["jstatic"], js, st.origin, st.direction, st.time,
            jnp.full((n,), 2.0 * js.world_radius, jnp.float32), *hps,
            st.alive)
        jinfo = jintersect.shading_info(d["jdata"], d["jstatic"], js, jhit,
                                        st.origin, st.direction, st.time,
                                        *hps)
        jkey = _np(jint._intersect_cost_key(d["jdata"], d["jstatic"], js, st))
    tstate = _port_state(st)
    hit, info = _port_hit(d, ts, tstate)
    K = d["tstatic"].n_spheres
    obj = _np(jhit.obj)
    np.testing.assert_array_equal(hit.obj.numpy(), obj)
    np.testing.assert_array_equal(hit.valid.numpy(), _np(jhit.valid))
    assert ((obj >= 0) & (obj < K)).sum() > 50 and (obj == K).sum() > 50
    for g, w in ((hit.t, jhit.t), (info.point, jinfo.point),
                 (info.normal, jinfo.normal),
                 (info.offset_by, jinfo.offset_by)):
        np.testing.assert_allclose(g.numpy(), _np(w), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(info.mat.numpy(), _np(jinfo.mat))
    key = intersect_cuda.intersect_cost_key_plain(
        d["tdata"], d["tstatic"], ts, tstate.origin, tstate.direction,
        tstate.time, tstate.alive)
    np.testing.assert_allclose(key.numpy(), jkey, rtol=1e-5, atol=0)


def _tail_args(d, ts, depth=1):
    tstate = _port_state(d["state1"])
    hit, info = _port_hit(d, ts, tstate)
    live, mat, recv, vtr = integrator._derive_shading(
        d["tdata"], d["tstatic"], tstate, hit, info)
    cfg = shade_cuda.shadow_cfg(d["tdata"], d["tstatic"], ts,
                                rng.build_sample_tables(ts, 1), depth)
    tabs = shade_cuda.scene_tables(d["tdata"], d["tstatic"])
    return cfg, tabs, tstate, hit, info, mat, live, recv, vtr


def test_sort_key_twin_matches_pallas_interpret(depth1):
    d = depth1
    js, ts = d["js"], RenderSettings(**_kw(max_bounces=3, mis=True))
    cfg, tabs, st, hit, info, _mat, live, recv, _vtr = _tail_args(d, ts)
    got = shade_cuda.shadow_sort_key_plain(
        cfg, tabs, info.point, info.normal, info.offset_by, st.origin,
        st.direction, hit.t, live, recv, st.sample_idx, st.pixel, st.time)
    jst = d["state1"]
    J = jnp.asarray
    with jax.disable_jit():
        jhit = jintersect.Hit(J(hit.t.numpy()), J(hit.obj.numpy()),
                              J(hit.valid.numpy()))
        vd, _ = jint._equi_angular_samples(d["jdata"], d["jstatic"], js,
                                           d["jtables"], jst, jhit, 1)
    want = _np(jshade.shadow_sort_key(
        d["jdata"], d["jstatic"], js, d["jtables"], 1, J(info.point.numpy()),
        J(info.normal.numpy()), J(info.offset_by.numpy()), jst.origin,
        jst.direction, J(live.numpy()), J(recv.numpy()), jst.sample_idx,
        jst.pixel, jst.time, vd, interpret=True))
    assert np.isfinite(want).all() and want.max() > 1.0
    ok = np.isclose(got.numpy(), want, rtol=1e-4, atol=0.0)
    assert ok.mean() >= 0.999, (ok.mean(), np.abs(got.numpy() - want).max())


@pytest.mark.parametrize("route", ["shadow", "queue"])
def test_segments_twins_match_jax_segments(depth1, route):
    d = depth1
    ts = RenderSettings(**_kw(max_bounces=3, mis=True))
    args = _tail_args(d, ts)
    cfg, tabs, st, hit = args[:4]
    fn = getattr(shade_cuda, f"{route}_segments_plain")
    segs = fn(cfg, tabs, st, *args[4:], hit.t)
    S, n = segs.active.shape
    _s, _st, _set, start, end, time, act = d["occluded_args"][:7]
    assert start.shape == (S * n, 3)
    with jax.disable_jit():
        blocked = _np(jspheres.occluded(
            start, end, jcenters_at(d["jdata"], time),
            d["jdata"].sphere_radii).any(axis=1))
    want_act = _np(act) & ~blocked
    got_act = segs.active.reshape(-1).numpy()
    assert (got_act == want_act).mean() >= 0.999
    both = got_act & want_act
    assert both.sum() > 1000
    geom = segs.geom.reshape(6, -1).T.numpy()
    for g, w in ((geom[:, :3], _np(start)), (geom[:, 3:], _np(end))):
        close = np.isclose(g[both], w[both], rtol=0, atol=1e-4).all(axis=1)
        assert close.mean() >= 0.995, close.mean()


BOUNCE_ROUTES = {"fused": {}, "split": dict(use_fused_bounce_tail=False),
                 "relaxed": dict(march_relaxation=1.5)}


@pytest.mark.parametrize("route", sorted(BOUNCE_ROUTES))
def test_depth1_bounce_matches_jax(depth1, route):
    """One bounce with MIS at depth 1 against JAX's integrator.bounce on
    the same state (the gates of
    test_torch_render.test_segment_queue_bounce_matches_jax). JAX's
    relaxed bounce is its own, the others share JAX's unfused bounce."""
    d = depth1
    change = BOUNCE_ROUTES[route]
    kw = _kw(max_bounces=3, mis=True, **change)
    ts = RenderSettings(**kw)
    jout = d["state2"]
    if change.get("march_relaxation"):
        js = JSettings(**kw)
        with jax.disable_jit():
            jout = jint.bounce(d["jdata"], d["jstatic"], js, d["jtables"],
                               d["state1"], 1, 0.0, 0.0)
    out = integrator.bounce(d["tdata"], d["tstatic"], ts,
                            rng.build_sample_tables(ts, 1),
                            _port_state(d["state1"]), 1, 0.0, 0.0)
    for f in ("radiance", "throughput", "color_out", "bg_out"):
        want, got = _np(getattr(jout, f)), getattr(out, f).numpy()
        close = np.isclose(got, want, rtol=2e-4, atol=2e-5)
        assert close.mean() >= 0.985, (f, close.mean())
        assert np.abs(got - want).max() < 0.1, f
    for f in ("alive", "pixel", "alpha_out", "normal_out"):
        np.testing.assert_array_equal(getattr(out, f).numpy(),
                                      _np(getattr(jout, f)))
    assert _np(jout.alive).any()


# ---------------------------------------- the constant scene, unchanged
def _static_inputs():
    s = RenderSettings(**_kw(max_bounces=3, mis=True))
    data, static, cam = presets.default_scene(resolution=RES, device="cpu")
    tables = rng.build_sample_tables(s, 1)
    o, d, tm, px, si, ok = renderer.generate_rays(
        s, tables, cam, filters.build_fis_table(filters.blackman_harris(1.5),
                                                512, device="cpu"),
        renderer.ray_indices(0, N, "cpu"), *TIME)
    return s, data, static, tables, integrator.init_state(o, d, tm, px, si,
                                                          ok)


def _same(a, b):
    if isinstance(a, torch.Tensor):
        return bool(((a == b) | (a != a) & (b != b)).all())
    if isinstance(a, dict):
        return all(_same(a[k], b[k]) for k in a)
    return all(_same(x, y) for x, y in zip(a, b))


def test_constant_scene_twins_ignore_time():
    """On the static default scene each twin gives the same bits with the
    lanes' times, with no time (the constant route) and with NaN times
    (which would poison any lerp)."""
    s, data, static, tables, state = _static_inputs()
    n = state.origin.shape[0]
    hps = (torch.zeros(n), torch.full((n,), 2e-4))
    nan = torch.full_like(state.time, float("nan"))
    tabs = shade_cuda.scene_tables(data, static)
    assert not tabs.animated
    cfg = shade_cuda.shadow_cfg(data, static, s, tables, 1)

    def all_three(fn):
        outs = [fn(t) for t in (state.time, None, nan)]
        assert _same(outs[0], outs[1]) and _same(outs[0], outs[2])
        return outs[0]

    hit, info = all_three(lambda t: intersect_cuda.closest_hit_shading_plain(
        data, static, s, state.origin, state.direction, *hps, state.alive,
        t))
    all_three(lambda t: intersect_cuda.intersect_cost_key_plain(
        data, static, s, state.origin, state.direction, t, state.alive))
    live, mat, recv, vtr = integrator._derive_shading(data, static, state,
                                                      hit, info)
    all_three(lambda t: shade_cuda.shadow_sort_key_plain(
        cfg, tabs, info.point, info.normal, info.offset_by, state.origin,
        state.direction, hit.t, live, recv, state.sample_idx, state.pixel,
        t))
    for name in ("shadow_segments_plain", "queue_segments_plain",
                 "bounce_tail_plain"):
        fn = getattr(shade_cuda, name)
        extra = (hit,) if name == "bounce_tail_plain" else ()
        all_three(lambda t: fn(cfg, tabs, state._replace(time=t), *extra,
                               info, mat, live, recv, vtr, hit.t))
    rad = state.radiance + 0.5
    all_three(lambda t: shade_cuda.finish_bounce_plain(
        cfg, tabs, state._replace(time=t), hit, info, mat, live, recv, vtr,
        rad))


def test_animated_twins_need_the_time():
    data, static, _cam = presets.default_scene(resolution=RES, device="cpu",
                                               animated_geo=True)
    s = RenderSettings(**_kw())
    z3, z = torch.zeros((4, 3)), torch.zeros(4)
    with pytest.raises(ValueError):
        intersect_cuda.closest_hit_shading_plain(data, static, s, z3, z3, z,
                                                 z, z.bool())


# ------------------------------------------------------------ refusals
@pytest.mark.parametrize("kind", ["animated_geo", "animated", "thin_lens",
                                  "orthographic"])
def test_motion_and_lenses_are_not_refused(kind):
    s = RenderSettings(resolution=(8, 8), spp=1)
    data, static, cam = presets.default_scene(
        resolution=(8, 8), device="cpu", animated_geo=kind == "animated_geo",
        animated=kind == "animated")
    if kind in ("thin_lens", "orthographic"):
        cam = _port_camera(kind)
    # the route without kernels renders them too: its closest hits march
    # in torch, and its film is the unfused kernel route's, bit for bit
    s = dataclasses.replace(s, max_bounces=1, max_marches=48,
                            max_vis_marches=24, use_fused_intersect=False)
    films = [film.tensors(renderer.render_frame(
        data, static, dataclasses.replace(s, use_pallas=use), cam,
        time_range=(0.0, 2.0))) for use in (True, False)]
    assert all(torch.equal(a, b) for a, b in zip(*films))
    assert int(films[0][film.CHANNELS.index("samples")].sum()) == 64
