"""The split bounce tail and MIS of rayn_tpu_torch on the CPU, against
rayn_tpu.

- finish: `finish_bounce_plain` against `shade_pallas.finish_bounce_fused`
  in interpret mode (a loop-free kernel, so interpret mode is cheap) at
  n = 1024 on seeded random inputs, depths 0, 1 and 3, MIS off and on:
  every float column within rtol 1e-5 on >= 99.9% of elements; alive,
  alpha_out and normal_out equal.
- shadow: `shadow_radiance_plain` against `shade_pallas.shadow_radiance`
  in interpret mode at n = 1024, `max_vis_marches` 16, MIS on, on seeded
  random lanes as for the finish test: the radiance gate of tests/test_fused_shadows.py:69-95
  (rtol 2e-4 / atol 2e-5 on >= 98.5% of elements, max |d| < 0.1).
- bounces: one split-tail bounce (`use_fused_bounce_tail=False`) and one
  `use_fused_finish=False` bounce with MIS at depths 0 and 1, against
  JAX's `integrator.bounce` op by op, with the gates of
  test_torch_render.py::test_segment_queue_bounce_matches_jax, except
  that normal_out is held to rtol 1e-5: the port's fused intersect
  computes the normal in another operation order than the unfused
  `shading_info` that JAX runs on the CPU, an ulp apart.
- images: 16x16 at 4 spp against JAX op by op (RMSE < 1.5e-3, mean
  relative difference < 1e-3): MIS on the fused and on the relaxed path,
  a scene without lights (tests/test_render_e2e.py:176-196) and the
  spheres scene with MIS. test_torch_render.py says why op by op.

Every test takes 2 NEE samples and 1 volume march per vertex (4 shadow
segments per ray, not the default 12): the shadow code paths are the
same, and JAX's op-by-op and interpreted references stay short.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rayn_tpu.config import RenderSettings as JSettings
from rayn_tpu.ops import filters as jfilters
from rayn_tpu.ops import intersect as jintersect
from rayn_tpu.ops import shade_pallas as jshade
from rayn_tpu.render import camera as jcamera
from rayn_tpu.render import film as jfilm
from rayn_tpu.render import integrator as jint
from rayn_tpu.render import renderer as jrenderer
from rayn_tpu.scene import presets as jpresets
from rayn_tpu.scene import scene as jscene
from rayn_tpu.utils import rng as jrng
from rayn_tpu_torch import convert
from rayn_tpu_torch.config import RenderSettings
from rayn_tpu_torch.ops import bsdf, shade_cuda
from rayn_tpu_torch.ops.intersect import Hit
from rayn_tpu_torch.render import film, integrator, renderer
from rayn_tpu_torch.utils import rng

# The tensors here are small: one torch thread per test worker avoids
# contending with the other pytest workers for the cores.
torch.set_num_threads(1)

# One shape for every JAX run in this file (1024 rays), so JAX compiles
# each primitive once.
RES = (16, 16)
N = RES[0] * RES[1] * 4


def _np(x):
    return np.array(x)


def _T(x):
    return torch.from_numpy(_np(x))


def _kw(**change):
    kw = dict(resolution=RES, spp=4, max_bounces=1, max_marches=24,
              max_vis_marches=16, rays_per_pass=N, nee_light_samples=2,
              volume_marches=1)
    kw.update(change)
    return kw


def _port_scene(jdata, jstatic):
    return convert.scene(jax.tree.map(np.asarray, jdata), jstatic,
                         sdf_iterations=12, device="cpu")


def _to_port(jstate):
    return integrator.PathState(*(_T(getattr(jstate, f))
                                  for f in integrator.PathState._fields))


# ---------------------------------------------------------------- finish

def _random_wavefront(jdata, jstatic, n, seed):
    """JAX (state, hit, info, pre-emission radiance) of n seeded random
    lanes: hits on every object of the scene (and misses), each shaded
    with its object's material, half of them with a BSDF prev_pdf."""
    g = np.random.default_rng(seed)
    f32 = np.float32

    def unit(k):
        v = g.normal(size=(k, 3))
        return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(f32)

    K = int(jstatic.n_spheres)
    obj = g.integers(-1, K + 1, n).astype(np.int32)
    sphere_mats = _np(jdata.sphere_mats)
    mat = np.where((obj >= 0) & (obj < K), sphere_mats[np.clip(obj, 0, K - 1)],
                   jstatic.sdf_mat).astype(np.int32)
    origin = g.uniform(-3, 3, (n, 3)).astype(f32)
    direction = unit(n)
    t = g.uniform(0.1, 5.0, n).astype(f32)
    state = jint.PathState(
        origin=jnp.asarray(origin), direction=jnp.asarray(direction),
        time=jnp.asarray(g.uniform(1 / 24, 2 / 24, n).astype(f32)),
        radiance=jnp.asarray(g.uniform(0, 1, (n, 3)).astype(f32)),
        throughput=jnp.asarray(g.uniform(0.01, 1, (n, 3)).astype(f32)),
        pixel=jnp.asarray(np.arange(n, dtype=np.int32) // 4),
        sample_idx=jnp.asarray(np.arange(n, dtype=np.int32) % 4),
        alive=jnp.asarray(g.uniform(size=n) < 0.9),
        prev_pdf=jnp.asarray(np.where(g.uniform(size=n) < 0.5, -1.0,
                                      g.uniform(0.01, 5.0, n)).astype(f32)),
        color_out=jnp.asarray(g.uniform(0, 1, (n, 3)).astype(f32)),
        bg_out=jnp.asarray(g.uniform(0, 1, (n, 3)).astype(f32)),
        alpha_out=jnp.asarray(g.uniform(0, 1, n).astype(f32)),
        normal_out=jnp.asarray(unit(n)))
    hit = jintersect.Hit(jnp.asarray(t), jnp.asarray(obj),
                         jnp.asarray(obj >= 0))
    info = jintersect.ShadingInfo(
        point=jnp.asarray(origin + t[:, None] * direction),
        normal=jnp.asarray(unit(n)),
        offset_by=jnp.asarray(g.uniform(1e-4, 1e-3, n).astype(f32)),
        mat=jnp.asarray(mat))
    rad = jnp.asarray(g.uniform(0, 1, (n, 3)).astype(f32))
    return state, hit, info, rad


@pytest.mark.parametrize("mis", [False, True])
def test_finish_twin_matches_pallas_interpret(mis):
    kw = _kw(max_bounces=3, mis=mis)
    js, ts = JSettings(**kw), RenderSettings(**kw)
    jdata, jstatic, _cam = jpresets.default_scene(resolution=RES)
    tdata, tstatic = _port_scene(jdata, jstatic)
    tabs = shade_cuda.scene_tables(tdata, tstatic)
    jtables, ttables = jrng.build_sample_tables(js, 1), rng.build_sample_tables(
        ts, 1)
    jstate, jhit, jinfo, jrad = _random_wavefront(jdata, jstatic, N, 5)
    live, jmat, recv, _wo, vtr = jint._derive_shading(jdata, jstatic, jstate,
                                                      jhit, jinfo)
    tmat = bsdf.MatParams(*map(_T, jmat))
    weighted = 0
    for depth in (0, 1, 3):
        want = jshade.finish_bounce_fused(
            jdata, jstatic, js, jtables, depth, jstate, jhit, jinfo, jmat,
            live, recv, jrad, block_rows=8, interpret=True)
        cfg = shade_cuda.shadow_cfg(tdata, tstatic, ts, ttables, depth)
        got = shade_cuda.finish_bounce_plain(
            cfg, tabs, _to_port(jstate), Hit(*map(_T, jhit)),
            type(jinfo)(*map(_T, jinfo)), tmat, _T(live), _T(recv), _T(vtr),
            _T(jrad))
        for f in ("origin", "direction", "throughput", "radiance",
                  "prev_pdf", "color_out", "bg_out"):
            ok = np.isclose(got[f].numpy(), _np(getattr(want, f)), rtol=1e-5,
                            atol=1e-7)
            assert ok.mean() >= 0.999, (depth, f, ok.mean())
        for f in ("alive", "alpha_out", "normal_out"):
            np.testing.assert_array_equal(got[f].numpy(),
                                          _np(getattr(want, f)))
        if mis and depth:
            # the emission weight moved the radiance of some lanes
            plain = shade_cuda.finish_bounce_plain(
                cfg._replace(mis_on=False), tabs, _to_port(jstate),
                Hit(*map(_T, jhit)), type(jinfo)(*map(_T, jinfo)), tmat,
                _T(live), _T(recv), _T(vtr), _T(jrad))
            weighted += int((plain["radiance"] != got["radiance"]).any(-1)
                            .sum())
    assert weighted > 0 or not mis


# ---------------------------------------------------------------- shadow

def test_shadow_twin_matches_pallas_interpret():
    kw = _kw(mis=True)
    js, ts = JSettings(**kw), RenderSettings(**kw)
    jdata, jstatic, _cam = jpresets.default_scene(resolution=RES)
    tdata, tstatic = _port_scene(jdata, jstatic)
    jtables = jrng.build_sample_tables(js, frame=1)
    jstate, hit, info, _rad = _random_wavefront(jdata, jstatic, N, 9)
    live, mat, recv, _wo, vtr = jint._derive_shading(jdata, jstatic, jstate,
                                                     hit, info)
    vd, vp = jint._equi_angular_samples(jdata, jstatic, js, jtables, jstate,
                                        hit, 0)
    want = _np(jshade.shadow_radiance(
        jdata, jstatic, js, jtables, 0, info.point, info.normal,
        info.offset_by, jstate.origin, jstate.direction, hit.t,
        jstate.throughput, vtr, mat, live, recv, jstate.sample_idx,
        jstate.pixel, jstate.time, vd, vp, block_rows=8, interpret=True))
    cfg = shade_cuda.shadow_cfg(tdata, tstatic, ts,
                                rng.build_sample_tables(ts, 1), 0)
    got = shade_cuda.shadow_radiance_plain(
        cfg, shade_cuda.scene_tables(tdata, tstatic), _to_port(jstate),
        type(info)(*map(_T, info)), bsdf.MatParams(*map(_T, mat)), _T(live),
        _T(recv), _T(vtr), _T(hit.t)).numpy()
    assert (want > 0.0).any(-1).mean() > 0.1
    close = np.isclose(got, want, rtol=2e-4, atol=2e-5)
    assert close.mean() >= 0.985, close.mean()
    assert np.abs(got - want).max() < 0.1


# --------------------------------------------------------------- bounces

BOUNCE_CASES = {"split_tail": dict(use_fused_bounce_tail=False, mis=True),
                "no_fused_finish": dict(use_fused_finish=False, mis=True)}


@pytest.fixture(scope="module")
def jax_bounces():
    """JAX's scene, its hps coefficients and its op-by-op states before
    and after its bounces at depths 0 and 1 with MIS (the JAX package on
    the CPU runs its unfused bounce whatever the split-tail flags say, so
    both cases share it)."""
    js = JSettings(**_kw(max_bounces=3, mis=True))
    jdata, jstatic, jcam = jpresets.default_scene(resolution=RES)
    jtables = jrng.build_sample_tables(js, frame=1)
    fis = jfilters.build_fis_table(jfilters.blackman_harris(1.5), 512)
    ha, hl = jcam.half_pixel_size_coeffs()
    with jax.disable_jit():
        o, d, tm, px, si, ok = jrenderer.generate_rays(
            js, jtables, jcam, fis, jrenderer.ray_indices(jnp.int32(0), N),
            jnp.float32(1 / 24), jnp.float32(2 / 24))
        jstate = jint.init_state(o, d, tm, px, si, ok)
        states = []
        for depth in range(2):
            out = jint.bounce(jdata, jstatic, js, jtables, jstate, depth, ha,
                              hl)
            states.append((jstate, out))
            jstate = out
    return jdata, jstatic, float(ha), float(hl), states


@pytest.mark.parametrize("case", sorted(BOUNCE_CASES))
def test_split_bounce_matches_jax(case, jax_bounces):
    """One bounce at depths 0 and 1 against JAX's integrator.bounce on
    the same state, both op by op (the gates of
    test_segment_queue_bounce_matches_jax)."""
    ts = RenderSettings(**_kw(max_bounces=3, **BOUNCE_CASES[case]))
    jdata, jstatic, ha, hl, states = jax_bounces
    tdata, tstatic = _port_scene(jdata, jstatic)
    ttables = rng.build_sample_tables(ts, 1)
    for depth, (jin, jout) in enumerate(states):
        out = integrator.bounce(tdata, tstatic, ts, ttables, _to_port(jin),
                                depth, ha, hl)
        for f in ("radiance", "throughput", "color_out", "bg_out"):
            want, got = _np(getattr(jout, f)), getattr(out, f).numpy()
            close = np.isclose(got, want, rtol=2e-4, atol=2e-5)
            assert close.mean() >= 0.985, (depth, f, close.mean())
            assert np.abs(got - want).max() < 0.1, (depth, f)
        for f in ("alive", "pixel", "alpha_out"):
            np.testing.assert_array_equal(getattr(out, f).numpy(),
                                          _np(getattr(jout, f)))
        np.testing.assert_allclose(out.normal_out.numpy(),
                                   _np(jout.normal_out), rtol=1e-5, atol=1e-6)
        assert _np(jout.alive).any()


# ---------------------------------------------------------------- images

def _no_lights_scene():
    """JAX's scene of tests/test_render_e2e.py:176-196: sky, a lambert
    sphere and a volume, no lights."""
    b = jscene.SceneBuilder()
    sky = b.add_sky((0.5, 0.6, 0.9), (0.1, 0.1, 0.1))
    b.add_sphere((0, 0, 0), 50.0, sky)
    b.add_sphere((0, 0, 0), 1.0, b.add_lambertian((0.7, 0.7, 0.7)))
    b.set_volume(0.25, 0.035)
    data, static = b.build()
    cam = jcamera.PinholeCamera.make(RES, 50.0, (0, 0, 4), (0, 0, 0),
                                     (0, 1, 0))
    return data, static, cam


def _image_vs_jax(scene, **change):
    """(RMSE, mean relative difference) of the port's 16x16 image at
    4 spp against JAX's op-by-op render of the same settings."""
    kw = _kw(**change)
    if scene == "no_lights":
        jdata, jstatic, jcam = _no_lights_scene()
    else:
        jdata, jstatic, jcam = getattr(jpresets, scene)(resolution=RES)
    with jax.disable_jit():
        want = np.asarray(jfilm.resolve(
            jrenderer.render_frame(jdata, jstatic, JSettings(**kw), jcam,
                                   frame=1), RES).color)
    tdata, tstatic = _port_scene(jdata, jstatic)
    tcam = convert.camera(jax.tree.map(np.asarray, jcam), device="cpu")
    f = renderer.render_frame(tdata, tstatic, RenderSettings(**kw), tcam,
                              frame=1)
    got = film.resolve(f, RES).color
    assert f.samples.sum().item() == N
    assert np.isfinite(got).all() and want.mean() > 0.0
    rmse = float(np.sqrt(np.mean((got - want) ** 2)))
    return rmse, abs(got.mean() - want.mean()) / want.mean()


IMAGE_CASES = {
    "mis_fused": ("default_scene", dict(mis=True)),
    "mis_relaxed": ("default_scene", dict(mis=True, march_relaxation=1.5)),
    "no_lights": ("no_lights", {}),
    "spheres_mis": ("spheres_scene", dict(mis=True)),
}


@pytest.mark.parametrize("case", sorted(IMAGE_CASES))
def test_split_tail_image_matches_jax(case):
    scene, change = IMAGE_CASES[case]
    rmse, mean_rel = _image_vs_jax(scene, **change)
    assert rmse < 1.5e-3, rmse
    assert mean_rel < 1e-3, mean_rel
