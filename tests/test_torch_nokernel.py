"""The JAX package's route without its kernels in the port:
`use_pallas=False` and `use_pallas_occlusion=False` (render/integrator.py,
ops/intersect.py).

- `use_pallas=False`: every closest hit marches in torch (ops/march.py),
  the fused intersect kernel and the pre-intersect cost sort step aside,
  and the fused shadow kernels keep running, as in JAX. The film equals
  the kernel route's with `use_fused_intersect=False` bit for bit (the
  march kernel equals its twin, which is the torch march, and sorting
  changes no bit). It is not the fused route's bit for bit: the fused
  intersect kernel normalises the tap gradient as g * (1 / |g|), as the
  Pallas kernel does, where the unfused shading info divides, as JAX's
  unfused route does; that stage is held here to one ulp of the normal.
- `use_pallas_occlusion=False`: the segment queue, its verdicts from the
  torch march with the clip that `shadow_bv_clip` sets, whatever
  `occl_sort_steps` says; the film equals `use_fused_shadows=False`'s
  bit for bit.
- spies on march_cuda, intersect_cuda and shade_cuda show which kernel
  wrappers each route calls;
- one render against JAX with the same flag, on the spheres scene and
  the small fractal scene (test_torch_render.py's gates: RMSE < 1e-3 and
  < 5e-3, mean relative difference < 1e-3), JAX op by op;
- `intersect.test_occluded` against JAX's with the flag, verdict for
  verdict, at `max_vis_marches` 16 and 0 (where JAX's jnp march keeps
  its first-DE verdict).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from rayn_tpu.config import RenderSettings as JSettings
from rayn_tpu.ops import intersect as jintersect
from rayn_tpu.render import film as jfilm
from rayn_tpu.render import renderer as jrenderer
from rayn_tpu.scene import presets as jpresets
from rayn_tpu_torch import convert
from rayn_tpu_torch.config import RenderSettings
from rayn_tpu_torch.ops import intersect, intersect_cuda, march_cuda
from rayn_tpu_torch.ops import shade_cuda
from rayn_tpu_torch.render import film, renderer
from rayn_tpu_torch.scene import presets
from rayn_tpu_torch.utils import rng

torch.set_num_threads(1)

RES = (16, 12)
BASE = RenderSettings(resolution=RES, spp=1, max_bounces=2, max_marches=64,
                      max_vis_marches=32, rays_per_pass=96)


def _scene():
    return presets.default_scene(resolution=RES, device="cpu")


def _film(**change):
    data, static, cam = _scene()
    return film.tensors(renderer.render_frame(
        data, static, dataclasses.replace(BASE, **change), cam))


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("flag, twin", [
    ("use_pallas", "use_fused_intersect"),
    ("use_pallas_occlusion", "use_fused_shadows")])
def test_route_matches_its_kernel_route(flag, twin):
    """Each flag's film is the kernel route's with the fused kernels it
    turns off turned off, bit for bit."""
    assert _same(_film(**{flag: False}), _film(**{twin: False}))


def test_fused_intersect_differs_only_in_the_normal():
    """The one stage where the route without kernels leaves the fused
    route's bits: the fused intersect's normal, g * (1 / |g|), against
    shading_info's g / |g|; t, object, point, offset and material agree
    bit for bit."""
    data, static, cam = _scene()
    s = BASE
    tables = rng.build_sample_tables(s, 1)
    from rayn_tpu_torch.ops import filters
    fis = filters.build_fis_table(filters.blackman_harris(1.5),
                                  s.filter_table_size, device="cpu")
    n = RES[0] * RES[1]
    o, d, t, _px, _si, ok = renderer.generate_rays(
        s, tables, cam, fis, renderer.ray_indices(0, n, "cpu"), 1 / 24,
        2 / 24)
    a0, a1 = cam.half_pixel_size_coeffs()
    habs, hlin = torch.full((n,), a0), torch.full((n,), a1)
    fh, fi = intersect_cuda.closest_hit_shading(data, static, s, o, d, habs,
                                                hlin, ok, t)
    nk = dataclasses.replace(s, use_pallas=False)
    uh = intersect.closest_hit(data, static, nk, o, d, t,
                               torch.full((n,), 2 * s.world_radius), habs,
                               hlin, ok)
    ui = intersect.shading_info(data, static, nk, uh, o, d, t, habs, hlin)
    assert _same(fh, uh)
    for f in ("point", "offset_by", "mat"):
        assert torch.equal(getattr(fi, f), getattr(ui, f)), f
    assert (fi.normal - ui.normal).abs().max() <= 2.4e-7


def _spy(monkeypatch, calls, mod, name):
    fn = getattr(mod, name)

    def spy(*a, **kw):
        calls[name] = calls.get(name, 0) + 1
        return fn(*a, **kw)
    monkeypatch.setattr(mod, name, spy)


@pytest.mark.parametrize("change, ran, not_ran", [
    (dict(use_pallas=False), ("bounce_tail", "shadow_sort_key",
                              "shadow_march"),
     ("march", "march_sorted", "closest_hit_shading", "intersect_cost_key",
      "queue_segments")),
    (dict(use_pallas_occlusion=False),
     ("closest_hit_shading", "intersect_cost_key", "queue_segments",
      "queue_sum", "march_occlusion_plain"),
     ("shadow_march", "bounce_tail", "shadow_sort_key", "march_occlusion")),
    (dict(use_pallas=False, use_fused_shadows=False, occl_sort_steps=8),
     ("queue_segments", "queue_sum", "march_occlusion_plain"),
     ("march", "march_sorted", "closest_hit_shading", "intersect_cost_key",
      "shadow_march"))])
def test_spies_show_the_route(monkeypatch, change, ran, not_ran):
    """Which kernel wrappers each route calls: the route without kernels
    calls no closest-hit, march or cost-key wrapper, and with the
    occlusion flag no shadow march; the queue's segments and sum
    kernels keep running."""
    calls = {}
    for mod, names in ((march_cuda, ("march", "march_sorted",
                                     "march_occlusion",
                                     "march_occlusion_plain")),
                       (intersect_cuda, ("closest_hit_shading",
                                         "intersect_cost_key")),
                       (shade_cuda, ("bounce_tail", "shadow_sort_key",
                                     "shadow_march", "queue_segments",
                                     "queue_sum"))):
        for name in names:
            _spy(monkeypatch, calls, mod, name)
    _film(**change)
    assert all(calls.get(k, 0) > 0 for k in ran), calls
    assert not any(calls.get(k, 0) for k in not_ran), calls


def test_occl_sort_steps_is_clipped_without_kernels(monkeypatch):
    """With use_pallas_occlusion=False the queue's verdicts come from the
    clipped torch march whatever occl_sort_steps says (JAX routes the
    two-phase marches only where its kernels run): the film does not
    change with the setting, and every march takes the instance's bound
    radius; the kernel route with the setting marches unclipped."""
    radii = []
    plain = march_cuda.march_occlusion_plain

    def spy(*a, **kw):
        radii.append(kw["bound_radius"])
        return plain(*a, **kw)
    monkeypatch.setattr(march_cuda, "march_occlusion_plain", spy)
    off = dict(use_pallas_occlusion=False)
    a = _film(occl_sort_steps=8, **off)
    assert radii and set(radii) == {3.6}
    assert _same(a, _film(**off))
    unclipped = []
    monkeypatch.setattr(shade_cuda, "shadow_march",
                        lambda cfg, segs, relax=1.0: unclipped.append(
                            [bv for _p, bv in cfg.sdfs]) or
                        shade_cuda.shadow_march_plain(cfg, segs, relax))
    _film(occl_sort_steps=8, use_fused_shadows=False)
    assert unclipped and all(r == [0.0] for r in unclipped)


@pytest.mark.parametrize("scene, flag", [
    ("spheres", "use_pallas"), ("fractal", "use_pallas"),
    ("fractal", "use_pallas_occlusion")])
def test_render_matches_jax(scene, flag):
    """The port's image with the flag off against JAX's with the same
    flag (op by op, its jnp route): RMSE < 1e-3 on the spheres scene,
    < 5e-3 on the fractal, mean relative difference < 1e-3."""
    res = (16, 16)
    kw = dict(resolution=res, spp=4, max_bounces=1, max_marches=24,
              max_vis_marches=16, rays_per_pass=res[0] * res[1] * 4,
              **{flag: False})
    make = (jpresets.spheres_scene if scene == "spheres"
            else jpresets.default_scene)
    jdata, jstatic, jcam = make(resolution=res)
    with jax.disable_jit():
        want = np.asarray(jfilm.resolve(jrenderer.render_frame(
            jdata, jstatic, JSettings(**kw), jcam, frame=1), res).color)
    tdata, tstatic = convert.scene(
        jax.tree.map(np.asarray, jdata), jstatic, device="cpu",
        sdf_iterations=12 if scene == "fractal" else None)
    tcam = convert.camera(jax.tree.map(np.asarray, jcam), device="cpu")
    got = film.resolve(renderer.render_frame(
        tdata, tstatic, RenderSettings(**kw), tcam, frame=1), res).color
    assert np.isfinite(got).all()
    rmse = float(np.sqrt(np.mean((got - want) ** 2)))
    assert rmse < (1e-3 if scene == "spheres" else 5e-3), rmse
    assert abs(got.mean() - want.mean()) / want.mean() < 1e-3


@pytest.mark.parametrize("steps", [16, 0])
def test_occlusion_matches_jax(steps):
    """intersect.test_occluded with use_pallas_occlusion=False against
    JAX's, verdict for verdict, on segments from the camera toward the
    fractal: at 0 steps both keep the first-DE verdict."""
    jdata, jstatic, _ = jpresets.default_scene(resolution=(8, 8))
    tdata, tstatic = convert.scene(jax.tree.map(np.asarray, jdata), jstatic,
                                   sdf_iterations=12, device="cpu")
    g = np.random.default_rng(7)
    m = 512
    start = g.uniform(-3.0, 3.0, (m, 3)).astype(np.float32)
    end = (start * g.uniform(-0.5, 0.2, (m, 1))).astype(np.float32)
    act = g.uniform(size=m) < 0.9
    time = np.zeros((m,), np.float32)
    kw = dict(max_vis_marches=steps, use_pallas_occlusion=False)
    want = np.asarray(jintersect.test_occluded(
        jdata, jstatic, JSettings(**kw), start, end, time, act))
    got = intersect.test_occluded(
        tdata, tstatic, RenderSettings(**kw), torch.from_numpy(start),
        torch.from_numpy(end), torch.from_numpy(time), torch.from_numpy(act))
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < (want == 0).sum() < m
