"""The reduced shadow DE (`shadow_de_iterations`) and `max_vis_marches` 0
of rayn_tpu_torch on the CPU, against rayn_tpu.

- sdf.reduced: the 8-iteration MandelBox's DE against JAX's reduced
  program op by op (rtol 1e-5 / atol 1e-6, test_torch_ops' DE gate).
- intersect.test_occluded at shadow_de_iterations=8 on a segment-major
  queue of 8 x 128 segments in the default scene, on the chained route
  (relax 1) and the relaxed one: visibility equal to JAX's
  test_occluded (its CPU route, the jnp march of the reduced program) on
  >= 99.9% of segments (test_torch_march's occlusion gate: a grazing
  segment may flip on an ulp), and other than the full DE's on some.
- One bounce at depths 0 and 1 at shadow_de_iterations=8 on the fused,
  split-tail and relaxed routes against JAX's integrator.bounce op by op,
  with the gates of test_torch_render.test_segment_queue_bounce_matches_jax
  (normal_out to rtol 1e-5 on the fused routes, as in
  test_torch_split_tail); the port's full-DE bounce gives other
  radiance.
- max_vis_marches 0: march_occlusion at relax 1 and 1.5, with and
  without the bounding-sphere clip, equals JAX's march.march_occlusion
  (no loop step: first DE < 1e-4 before the end) on segments that start
  on the fractal's surface; march_occlusion_chained equals JAX's chained
  Pallas kernel in interpret mode (one step each, its core's rule); the
  phased and sorted occlusions equal JAX's in interpret mode; a
  relaxed segment-queue bounce takes the first-DE verdicts.

Every bounce takes 2 NEE samples and 1 volume march per vertex, as in
test_torch_split_tail, so JAX's op-by-op references stay short.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rayn_tpu.config import RenderSettings as JSettings
from rayn_tpu.ops import filters as jfilters
from rayn_tpu.ops import intersect as jintersect
from rayn_tpu.ops import march as jmarch
from rayn_tpu.ops import march_pallas as jpallas
from rayn_tpu.ops import sdf as jsdf
from rayn_tpu.render import integrator as jint
from rayn_tpu.render import renderer as jrenderer
from rayn_tpu.scene import presets as jpresets
from rayn_tpu.utils import rng as jrng
from rayn_tpu_torch import convert
from rayn_tpu_torch.config import RenderSettings
from rayn_tpu_torch.ops import intersect, march_cuda
from rayn_tpu_torch.ops import sdf as tsdf
from rayn_tpu_torch.render import integrator, renderer
from rayn_tpu_torch.scene import presets
from rayn_tpu_torch.utils import rng
from test_torch_march import DETAIL, MB_ARGS, _segments
from test_torch_phased import _surface_inputs

# The tensors here are small: one torch thread per test worker avoids
# contending with the other pytest workers for the cores.
torch.set_num_threads(1)

RES = (16, 16)
N = RES[0] * RES[1] * 4
ITERS = 8


def _kw(**change):
    kw = dict(resolution=RES, spp=4, max_bounces=3, max_marches=24,
              max_vis_marches=16, rays_per_pass=N, nee_light_samples=2,
              volume_marches=1, shadow_de_iterations=ITERS)
    kw.update(change)
    return kw


@pytest.fixture(scope="module")
def scenes():
    jdata, jstatic, jcam = jpresets.default_scene(resolution=RES)
    tdata, tstatic = convert.scene(jax.tree.map(np.asarray, jdata), jstatic,
                                   sdf_iterations=12, device="cpu")
    return jdata, jstatic, jcam, tdata, tstatic


def test_reduced_mandelbox_matches_jax():
    g = np.random.default_rng(1)
    p = g.uniform(-3.0, 3.0, (2048, 3)).astype(np.float32)
    jmb, tmb = jsdf.mandelbox(**MB_ARGS), tsdf.mandelbox(**MB_ARGS)
    red = tsdf.reduced(tmb, ITERS)
    assert red.iterations == ITERS and red[1:] == tmb[1:]
    assert tsdf.reduced(tmb, 0) is tmb
    with jax.disable_jit():
        want = np.asarray(jmb.reduced(ITERS).dist(jnp.asarray(p)))
    got = tsdf.dist(red, torch.from_numpy(p)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert not np.allclose(got, tsdf.dist(tmb, torch.from_numpy(p)).numpy())


@pytest.mark.parametrize("relax", [1.0, 1.5])
def test_occluded_with_the_reduced_de_matches_jax(scenes, relax):
    jdata, jstatic, _cam, tdata, tstatic = scenes
    start, end, act = _segments((8, 128), 21)
    start, end, act = start.reshape(-1, 3), end.reshape(-1, 3), act.ravel()
    time = np.zeros(len(act), np.float32)
    kw = _kw(march_relaxation=relax)
    want = np.asarray(jintersect.test_occluded(
        jdata, jstatic, JSettings(**kw), jnp.asarray(start), jnp.asarray(end),
        jnp.asarray(time), jnp.asarray(act), segments=8))

    def port(**change):
        return intersect.test_occluded(
            tdata, tstatic, RenderSettings(**dict(kw, **change)),
            torch.from_numpy(start), torch.from_numpy(end),
            torch.from_numpy(time), torch.from_numpy(act),
            segments=8).numpy()

    got = port()
    assert (want == 0).any() and (want == 1).any()
    assert (got == want).mean() >= 0.999
    assert (got != port(shadow_de_iterations=0)).any()


BOUNCE_CASES = {"fused": ("plain", {}),
                "split_tail": ("plain", dict(use_fused_bounce_tail=False)),
                "relaxed": ("relaxed", dict(march_relaxation=1.5))}


@pytest.fixture(scope="module")
def jax_bounces(scenes):
    """JAX's op-by-op states before and after its bounces at depths 0
    and 1, at relax 1 (the JAX package on the CPU runs its unfused bounce
    whatever the fused flags say, so the fused and split routes share
    it) and at relax 1.5."""
    jdata, jstatic, jcam, _d, _s = scenes
    fis = jfilters.build_fis_table(jfilters.blackman_harris(1.5), 512)
    ha, hl = jcam.half_pixel_size_coeffs()
    out = {}
    for name, change in (("plain", {}),
                         ("relaxed", dict(march_relaxation=1.5))):
        js = JSettings(**_kw(**change))
        jtables = jrng.build_sample_tables(js, frame=1)
        with jax.disable_jit():
            o, d, tm, px, si, ok = jrenderer.generate_rays(
                js, jtables, jcam, fis,
                jrenderer.ray_indices(jnp.int32(0), N),
                jnp.float32(1 / 24), jnp.float32(2 / 24))
            jstate = jint.init_state(o, d, tm, px, si, ok)
            states = []
            for depth in range(2):
                nxt = jint.bounce(jdata, jstatic, js, jtables, jstate, depth,
                                  ha, hl)
                states.append((jstate, nxt))
                jstate = nxt
        out[name] = states
    return float(ha), float(hl), out


def _to_port(jstate):
    return integrator.PathState(*(torch.from_numpy(np.array(
        getattr(jstate, f))) for f in integrator.PathState._fields))


@pytest.mark.parametrize("case", sorted(BOUNCE_CASES))
def test_bounce_with_the_reduced_de_matches_jax(case, scenes, jax_bounces):
    ref, change = BOUNCE_CASES[case]
    ts = RenderSettings(**_kw(**change))
    _jd, _js, _jc, tdata, tstatic = scenes
    ha, hl, states = jax_bounces
    ttables = rng.build_sample_tables(ts, 1)
    for depth, (jin, jout) in enumerate(states[ref]):
        out = integrator.bounce(tdata, tstatic, ts, ttables, _to_port(jin),
                                depth, ha, hl)
        for f in ("radiance", "throughput", "color_out", "bg_out"):
            want, got = np.array(getattr(jout, f)), getattr(out, f).numpy()
            close = np.isclose(got, want, rtol=2e-4, atol=2e-5)
            assert close.mean() >= 0.985, (depth, f, close.mean())
            assert np.abs(got - want).max() < 0.1, (depth, f)
        for f in ("alive", "pixel", "alpha_out"):
            np.testing.assert_array_equal(getattr(out, f).numpy(),
                                          np.array(getattr(jout, f)))
        np.testing.assert_allclose(out.normal_out.numpy(),
                                   np.array(jout.normal_out), rtol=1e-5,
                                   atol=1e-6)
    full = integrator.bounce(
        tdata, tstatic, RenderSettings(**_kw(shadow_de_iterations=0,
                                             **change)),
        ttables, _to_port(jin), 1, ha, hl)
    assert not torch.equal(full.radiance, out.radiance)


# ------------------------------------------------------- max_vis_marches 0
@pytest.mark.parametrize("relax", [1.0, 1.5])
@pytest.mark.parametrize("bound", [0.0, 3.6])
def test_occlusion_at_zero_steps_matches_jax(relax, bound):
    """No step: JAX's march_occlusion keeps its entry verdict, first DE
    below 1e-4 before the end (march.py:126-170)."""
    start, end, act = _surface_inputs()
    with jax.disable_jit():
        want = np.asarray(jmarch.march_occlusion(
            jsdf.mandelbox(**MB_ARGS), jnp.asarray(start), jnp.asarray(end),
            DETAIL, 0, active=jnp.asarray(act), relax=relax,
            bound_radius=bound))
    args = (tsdf.mandelbox(**MB_ARGS), torch.from_numpy(start),
            torch.from_numpy(end), DETAIL, 0, torch.from_numpy(act))
    got = march_cuda.march_occlusion(*args, relax=relax, bound_radius=bound)
    plain = march_cuda.march_occlusion_plain(*args, relax=relax,
                                             bound_radius=bound)
    assert want.sum() >= 16 and (~want).any()
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(plain.numpy(), want)
    # one step would give other verdicts on these segments
    one = march_cuda.march_occlusion(*args[:4], 1, args[5], relax=relax,
                                     bound_radius=bound)
    assert (one.numpy() != want).any()


def test_chained_occlusion_at_zero_steps_matches_pallas_interpret():
    """JAX's chained core resolves every segment at its first step when
    max_steps is 0 (stp1 >= max_steps), as the refill march does."""
    start, end, act = _surface_inputs()
    k = 2
    n = len(act) // k * k
    s3, e3, a2 = (x[:n].reshape((k, n // k) + x.shape[1:])
                  for x in (start, end, act))
    want = np.asarray(jpallas.march_occlusion_chained(
        jsdf.mandelbox(**MB_ARGS), jnp.asarray(s3), jnp.asarray(e3), DETAIL,
        0, jnp.asarray(a2), interpret=True, bound_radius=3.6))
    got = march_cuda.march_occlusion_chained(
        tsdf.mandelbox(**MB_ARGS), torch.from_numpy(s3), torch.from_numpy(e3),
        DETAIL, 0, torch.from_numpy(a2), bound_radius=3.6).numpy()
    assert want.any()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["march_occlusion_phased",
                                  "march_occlusion_sorted"])
def test_two_phase_occlusion_at_zero_steps_matches_pallas_interpret(name):
    start, end, act = _surface_inputs()
    want = np.asarray(getattr(jpallas, name)(
        jsdf.mandelbox(**MB_ARGS), jnp.asarray(start), jnp.asarray(end),
        DETAIL, 0, jnp.asarray(act), phase1_steps=8, interpret=True))
    got = getattr(march_cuda, name)(
        tsdf.mandelbox(**MB_ARGS), torch.from_numpy(start),
        torch.from_numpy(end), DETAIL, 0, torch.from_numpy(act),
        phase1_steps=8).numpy()
    assert want.any()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("route", ["fused", "split_tail", "relaxed",
                                   "unfused", "sorted"])
def test_zero_vis_marches_render(route, monkeypatch):
    """Every route renders at max_vis_marches 0; the relaxed queue and
    the two-phase one (JAX's single-segment and two-phase marches) take
    their verdicts from march_occlusion's first-DE entry, the chained
    unfused queue from the scratch's march."""
    change = {"fused": {}, "split_tail": dict(use_fused_bounce_tail=False),
              "relaxed": dict(march_relaxation=1.5),
              "unfused": dict(use_fused_shadows=False),
              "sorted": dict(use_fused_shadows=False,
                             occl_sort_steps=8)}[route]
    calls = []
    real = march_cuda.march_occlusion
    monkeypatch.setattr(march_cuda, "march_occlusion",
                        lambda *a, **k: calls.append(a[4]) or real(*a, **k))
    data, static, cam = presets.default_scene(resolution=(8, 8),
                                              device="cpu")
    s = RenderSettings(resolution=(8, 8), spp=2, max_bounces=1,
                       max_marches=24, max_vis_marches=0, **change)
    f = renderer.render_frame(data, static, s, cam)
    assert f.samples.sum().item() == 8 * 8 * 2
    assert torch.isfinite(f.color).all() and f.alpha.sum().item() > 0.0
    first_de = route in ("relaxed", "sorted")
    assert calls == ([0, 0] if first_de else [])
