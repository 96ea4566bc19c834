"""The port's bounce tail and shadow sort key (plain twins on the CPU)
against rayn_tpu.

- bounce tail: one bounce at depth 0 and 1, volume on and off, against
  JAX's unfused integrator.bounce (the reference the fused Pallas kernel
  is held against), with the gates of tests/test_fused_shadows.py:69-95:
  radiance within rtol 2e-4 / atol 2e-5 on >= 98.5% of elements with
  max |d| < 0.1, throughput diverged on < 1e-3 (depth 0) / 3e-2
  (depth 1) of elements, alive differing on < 1e-3 / 1e-2 of lanes.
- sort key: against shade_pallas.shadow_sort_key in interpret mode
  (a loop-free kernel, so interpret mode is cheap) at n=1024, rtol 1e-4
  on >= 99.9% of lanes.
- the component-form bodies (_sample_cone, _eval_f, _scatter,
  _sphere_occluded) against shade_pallas's own, rtol 1e-5.
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
from rayn_tpu.render import integrator as jint
from rayn_tpu.render import renderer as jrenderer
from rayn_tpu.scene import presets as jpresets
from rayn_tpu.utils import rng as jrng
from rayn_tpu_torch import convert
from rayn_tpu_torch.config import RenderSettings
from rayn_tpu_torch.ops import shade_cuda
from rayn_tpu_torch.render import integrator
from rayn_tpu_torch.utils import rng

# The tensors here are small: one torch thread per test worker avoids
# contending with the other pytest workers for the cores.
torch.set_num_threads(1)


def _np(x):
    return np.array(x)


def _camera_state(js, jcam, n):
    tables = jrng.build_sample_tables(js, frame=1)
    fis = jfilters.build_fis_table(jfilters.blackman_harris(1.5), 512)
    o, d, tm, px, si, ir = jrenderer.generate_rays(
        js, tables, jcam, fis, jrenderer.ray_indices(jnp.int32(0), n),
        jnp.float32(1 / 24), jnp.float32(2 / 24))
    return tables, jint.init_state(o, d, tm, px, si, ir)


def _to_port(jstate):
    return integrator.PathState(
        *(torch.from_numpy(_np(getattr(jstate, f)))
          for f in integrator.PathState._fields))


def _jax_hit(jdata, jstatic, js, jstate, depth, ha, hl):
    """JAX's closest hit + shading of a wavefront at `depth` (the same
    per-lane values its integrator.bounce computes)."""
    n = jstate.origin.shape[0]
    if depth == 0:
        hps_abs = jnp.full((n,), ha, jnp.float32)
        hps_lin = jnp.full((n,), hl, jnp.float32)
    else:
        hps_abs = jnp.zeros((n,), jnp.float32)
        hps_lin = jnp.full((n,), 2e-4 * depth, jnp.float32)
    hit = jintersect.closest_hit(
        jdata, jstatic, js, jstate.origin, jstate.direction, jstate.time,
        jnp.full((n,), 2.0 * js.world_radius, jnp.float32), hps_abs,
        hps_lin, jstate.alive)
    info = jintersect.shading_info(jdata, jstatic, js, hit, jstate.origin,
                                   jstate.direction, jstate.time, hps_abs,
                                   hps_lin)
    return hit, info


@pytest.mark.parametrize("volume", [True, False])
def test_bounce_tail_matches_jax_unfused(volume):
    """The port's bounce tail against JAX's unfused bounce at depths 0
    and 1. Both tails start from JAX's own intersection of the same
    wavefront: JAX's march runs inside an XLA-compiled while loop whose
    FMA contraction moves t by an ulp, which the tetrahedral normal and
    the Phong lobe amplify past rtol 1e-4 on ~1 lane in 500; the
    intersect module is held to its own gates in test_torch_intersect."""
    n, res = 512, (32, 32)
    kw = dict(resolution=res, spp=4, max_marches=64, max_vis_marches=48,
              rays_per_pass=n)
    js = JSettings(**kw, use_fused_shadows=False)
    ts = RenderSettings(**kw)
    jdata, jstatic, jcam = jpresets.default_scene(resolution=res,
                                                  volume=volume)
    tdata, tstatic = convert.scene(jax.tree.map(np.asarray, jdata), jstatic,
                                   sdf_iterations=12, device="cpu")
    jtables, jstate = _camera_state(js, jcam, n)
    ttables = rng.build_sample_tables(ts, 1)
    tabs = shade_cuda.scene_tables(tdata, tstatic)
    ha, hl = jcam.half_pixel_size_coeffs()
    T = lambda a: torch.from_numpy(_np(a))  # noqa: E731
    for depth in range(2):
        jhit, jinfo = _jax_hit(jdata, jstatic, js, jstate, depth, ha, hl)
        tstate = _to_port(jstate)
        hit = type(jhit)(*map(T, jhit))
        info = type(jinfo)(*map(T, jinfo))
        live, mat, receives, vtr = integrator._derive_shading(
            tdata, tstatic, tstate, hit, info)
        cfg = shade_cuda.shadow_cfg(tdata, tstatic, ts, ttables, depth)
        out = shade_cuda.bounce_tail(cfg, tabs, tstate, hit, info, mat,
                                     live, receives, vtr, hit.t)
        jstate = jint.bounce(jdata, jstatic, js, jtables, jstate, depth,
                             ha, hl)
        ra, rb = _np(jstate.radiance), out["radiance"].numpy()
        close = np.isclose(rb, ra, rtol=2e-4, atol=2e-5)
        frac = 1.0 - close.mean()
        assert frac < 1.5e-2, (depth, frac, np.abs(ra - rb).max())
        assert np.abs(ra - rb).max() < 0.1
        ta, tb = _np(jstate.throughput), out["throughput"].numpy()
        tfrac = 1.0 - np.isclose(tb, ta, rtol=1e-4, atol=1e-5).mean()
        assert tfrac < (1e-3 if depth == 0 else 3e-2), (depth, tfrac)
        afrac = (_np(jstate.alive) != out["alive"].numpy()).mean()
        assert afrac < (1e-3 if depth == 0 else 1e-2), (depth, afrac)
        for f in ("color_out", "bg_out", "alpha_out", "normal_out"):
            cfrac = 1.0 - np.isclose(out[f].numpy(), _np(getattr(jstate, f)),
                                     rtol=2e-4, atol=2e-5).mean()
            assert cfrac < 1.5e-2, (depth, f, cfrac)


def test_shadow_sort_key_matches_pallas_interpret():
    n, res = 1024, (32, 32)
    kw = dict(resolution=res, spp=4, max_marches=64, max_vis_marches=48,
              rays_per_pass=n)
    js, ts = JSettings(**kw), RenderSettings(**kw)
    jdata, jstatic, jcam = jpresets.default_scene(resolution=res)
    tdata, tstatic = convert.scene(jax.tree.map(np.asarray, jdata), jstatic,
                                   sdf_iterations=12, device="cpu")
    jtables, jstate = _camera_state(js, jcam, n)
    ha, hl = jcam.half_pixel_size_coeffs()
    # camera-ray hits priced with the depth-1 sampler sets (the key never
    # reads the hit threshold, so no depth-0 bounce is needed)
    depth = 1
    hit, info = _jax_hit(jdata, jstatic, js, jstate, 0, ha, hl)
    live, _mat, receives, _wo, _vt = jint._derive_shading(
        jdata, jstatic, jstate, hit, info)
    vd, _ = jint._equi_angular_samples(jdata, jstatic, js, jtables, jstate,
                                       hit, depth)
    want = _np(jshade.shadow_sort_key(
        jdata, jstatic, js, jtables, depth, info.point, info.normal,
        info.offset_by, jstate.origin, jstate.direction, live, receives,
        jstate.sample_idx, jstate.pixel, jstate.time, vd, interpret=True))

    T = lambda a: torch.from_numpy(_np(a))  # noqa: E731
    cfg = shade_cuda.shadow_cfg(tdata, tstatic, ts,
                                rng.build_sample_tables(ts, 1), depth)
    tabs = shade_cuda.scene_tables(tdata, tstatic)
    got = shade_cuda.shadow_sort_key(
        cfg, tabs, T(info.point), T(info.normal), T(info.offset_by),
        T(jstate.origin), T(jstate.direction), T(hit.t), T(live),
        T(receives), T(jstate.sample_idx), T(jstate.pixel))
    assert np.isfinite(want).all() and want.max() > 1.0
    ok = np.isclose(got.numpy(), want, rtol=1e-4, atol=0.0)
    assert ok.mean() >= 0.999, (ok.mean(), np.abs(got.numpy() - want).max())


def _rand_shading(n, seed):
    g = np.random.default_rng(seed)

    def unit(k):
        v = g.normal(size=(k, 3))
        return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(
            np.float32)

    return g, unit


def test_component_bodies_match_pallas_bodies():
    """The plain twins' component-form helpers against the Pallas kernel
    bodies (which are jnp-callable outside a kernel), rtol 1e-5."""
    n = 4096
    g, unit = _rand_shading(n, 21)
    f32 = np.float32
    u = g.uniform(0, 1, (2, n)).astype(f32)
    lp = g.uniform(-2, 2, (3, n)).astype(f32)
    lr = g.uniform(0.1, 0.3, n).astype(f32)
    p = (lp.T + unit(n) * g.uniform(0.5, 5, (n, 1))).T.astype(f32)
    args = [u[0], u[1], *lp, lr, *p]
    for a, b in zip(shade_cuda._sample_cone(*map(torch.from_numpy, args)),
                    jshade._sample_cone(*map(jnp.asarray, args))):
        np.testing.assert_allclose(a.numpy(), _np(b), rtol=1e-5, atol=1e-5)

    kind = (np.arange(n) % 6).astype(np.int32)
    ca = g.uniform(0.05, 0.95, (3, n)).astype(f32)
    power = np.where(kind == 4, 120.0, np.where(kind == 1, 8.68, 0.0)
                     ).astype(f32)
    ior = np.where(kind == 5, 1.5, 1.0).astype(f32)
    nrm = unit(n).T
    wo = unit(n).T
    wi = unit(n).T
    ef = [kind, *ca, power, *wo, *wi, *nrm]
    for a, b in zip(shade_cuda._eval_f(*map(torch.from_numpy, ef)),
                    jshade._eval_f(*map(jnp.asarray, ef))):
        np.testing.assert_allclose(a.numpy(), _np(b), rtol=1e-5, atol=1e-6)

    us = g.uniform(0, 1, (5, n)).astype(f32)
    sc = [kind, *ca, power, ior, *wo, *nrm, *us]
    for compat in (False, True):
        cfg = type("Cfg", (), dict(compat_reflect=compat,
                                   compat_phi=compat))
        got = shade_cuda._scatter(cfg, *map(torch.from_numpy, sc))
        want = jshade._scatter((compat, compat), *map(jnp.asarray, sc))
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), _np(b), rtol=1e-5,
                                       atol=1e-5)

    spheres = g.uniform(-1, 1, (6, 4)).astype(f32)
    spheres[:, 3] = np.abs(spheres[:, 3]) * 0.5 + 0.1
    s = g.uniform(-2, 2, (3, n)).astype(f32)
    e = g.uniform(-2, 2, (3, n)).astype(f32)
    got = shade_cuda._sphere_occluded(
        torch.from_numpy(spheres[:, :3]), torch.from_numpy(spheres[:, 3]),
        *map(torch.from_numpy, [*s, *e]))
    want = jshade._sphere_occluded(
        [tuple(jnp.float32(v) for v in row) for row in spheres],
        *map(jnp.asarray, [*s, *e]))
    np.testing.assert_array_equal(got.numpy(), _np(want))
