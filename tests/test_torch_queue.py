"""The segment-queue bounce of the port, built from its plain twins, on
the CPU against rayn_tpu.

On the card `integrator._segment_queue_tail` runs three kernels: the
queue-segments kernel builds every NEE and volume segment of the bounce
(with the sphere test) into a scratch and queues the active ones, the
refill march gives their SDF verdicts, and the queue-sum kernel adds
k * visible to the emission-added radiance in segment order. Here:

- the tail composed from the twins (queue_segments_plain ->
  shadow_march_plain -> queue_sum_plain -> _finish_bounce) runs one
  bounce at depths 0 and 1 against JAX's unfused integrator.bounce on
  the same state, both op by op, with the gates of
  test_torch_render.test_segment_queue_bounce_matches_jax (radiance,
  throughput, color_out, bg_out within rtol 2e-4 / atol 2e-5 on
  >= 98.5% of elements, max |d| < 0.1; alive, pixel and alpha_out
  equal, normal_out within rtol 1e-5 / atol 1e-6 as in
  test_torch_split_tail), at relax 1 and 1.5, MIS off and on, the
  default scene with and without its volume, and spheres_scene (no SDF);
  and it equals the port's own bounce bit for bit. The cases take each
  value of the three settings at least once (relax 1 with the volume and
  without MIS is test_torch_render's "unfused" case); 8x8 at 1 spp with
  2 NEE samples, one volume march and short marches keeps JAX's op-by-op
  bounces to seconds;
- queue_sum_plain adds in the queue's order, not the fused tail's
  delta from 0;
- march_occlusion, the enqueue and refill-march twins composed, equals
  its one-piece twin, plain and relaxed, with and without the clip;
- with `occl_sort_steps` and `shadow_bv_clip=True` the queue's verdicts
  are the refill march's on the scratch without the clip, on segments
  where the clip changes verdicts, and equal JAX's
  march_occlusion_sorted of the queued segments;
- the new wrappers refuse tensors that are neither on the CPU nor on a
  CUDA device;
- `sorted_chunk` is resolved where a sort runs, as in JAX: a 64-ray
  pass with sorted_chunk=128 renders the same image in both packages
  where no sort runs (spheres_scene; the default scene at max_bounces
  0), and the port raises where JAX does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rayn_tpu.config import RenderSettings as JSettings
from rayn_tpu.ops import filters as jfilters
from rayn_tpu.ops import march_pallas as jpallas
from rayn_tpu.render import film as jfilm
from rayn_tpu.render import integrator as jint
from rayn_tpu.render import renderer as jrenderer
from rayn_tpu.scene import presets as jpresets
from rayn_tpu.utils import rng as jrng
from rayn_tpu_torch import convert
from rayn_tpu_torch.config import RenderSettings
from rayn_tpu_torch.ops import march_cuda, shade_cuda
from rayn_tpu_torch.ops import sdf as tsdf
from rayn_tpu_torch.render import film, integrator, renderer
from rayn_tpu_torch.scene import presets
from rayn_tpu_torch.utils import rng

# The tensors here are small: one torch thread per test worker avoids
# contending with the other pytest workers for the cores.
torch.set_num_threads(1)

# One shape for every op-by-op JAX run in this file (64 rays): JAX
# compiles each primitive once per shape, and that compile is most of
# the cost of the first such run.
RES = (8, 8)
N = RES[0] * RES[1]

# (scene, volume, settings): relax 1 and 1.5, MIS off and on, volume and
# none, and the spheres scene
CASES = {
    "relax1.5_mis": ("default", True, dict(march_relaxation=1.5, mis=True)),
    "relax1_mis_no_volume": ("default", False, dict(
        use_fused_intersect=False, use_fused_shadows=False, mis=True)),
    "relax1.5_no_volume": ("default", False, dict(march_relaxation=1.5)),
    "spheres_mis": ("spheres", False, dict(use_fused_shadows=False,
                                           mis=True)),
}


def _tail_from_twins(data, static, s, tables, cfg, tabs, state, depth, hit,
                     info, mat, live, receives, vol_trans):
    """integrator._segment_queue_tail composed from the plain twins."""
    wo = -state.direction
    radiance = integrator._emission(data, static, s, state, depth, hit, mat,
                                    live, wo, vol_trans)
    if static.n_lights > 0:
        segs = shade_cuda.queue_segments_plain(cfg, tabs, state, info, mat,
                                               live, receives, vol_trans,
                                               hit.t)
        verdict = shade_cuda.shadow_march_plain(cfg, segs,
                                                s.march_relaxation)
        radiance = shade_cuda.queue_sum_plain(radiance, segs, verdict)
    return integrator._finish_bounce(s, tables, state, depth, info, mat,
                                     live, receives, wo, vol_trans, radiance)


@pytest.mark.parametrize("case", sorted(CASES))
def test_queue_tail_from_twins_matches_jax(case, monkeypatch):
    scene, volume, change = CASES[case]
    kw = dict(resolution=RES, spp=1, max_bounces=3, max_marches=12,
              max_vis_marches=8, rays_per_pass=N, nee_light_samples=2,
              volume_marches=1, **change)
    js, ts = JSettings(**kw), RenderSettings(**kw)
    if scene == "spheres":
        jdata, jstatic, jcam = jpresets.spheres_scene(resolution=RES)
    else:
        jdata, jstatic, jcam = jpresets.default_scene(resolution=RES,
                                                      volume=volume)
    tdata, tstatic = convert.scene(jax.tree.map(np.asarray, jdata), jstatic,
                                   sdf_iterations=12, device="cpu")
    jtables = jrng.build_sample_tables(js, frame=1)
    ttables = rng.build_sample_tables(ts, 1)
    fis = jfilters.build_fis_table(jfilters.blackman_harris(1.5), 512)
    ha, hl = jcam.half_pixel_size_coeffs()
    with jax.disable_jit():
        o, d, tm, px, si, ok = jrenderer.generate_rays(
            js, jtables, jcam, fis, jrenderer.ray_indices(jnp.int32(0), N),
            jnp.float32(1 / 24), jnp.float32(2 / 24))
        jstate = jint.init_state(o, d, tm, px, si, ok)
        for depth in range(2):
            tstate = integrator.PathState(
                *(torch.from_numpy(np.array(getattr(jstate, f)))
                  for f in integrator.PathState._fields))
            args = (tdata, tstatic, ts, ttables, tstate, depth, float(ha),
                    float(hl))
            routed = integrator.bounce(*args)
            with monkeypatch.context() as m:
                m.setattr(integrator, "_segment_queue_tail", _tail_from_twins)
                out = integrator.bounce(*args)
            for f in out._fields:
                assert torch.equal(getattr(out, f), getattr(routed, f)), f
            jstate = jint.bounce(jdata, jstatic, js, jtables, jstate, depth,
                                 ha, hl)
            for f in ("radiance", "throughput", "color_out", "bg_out"):
                want, got = np.array(getattr(jstate, f)), getattr(out, f)
                close = np.isclose(got.numpy(), want, rtol=2e-4, atol=2e-5)
                assert close.mean() >= 0.985, (depth, f, close.mean())
                assert np.abs(got.numpy() - want).max() < 0.1, (depth, f)
            for f in ("alive", "pixel", "alpha_out"):
                np.testing.assert_array_equal(getattr(out, f).numpy(),
                                              np.array(getattr(jstate, f)))
            np.testing.assert_allclose(out.normal_out.numpy(),
                                       np.array(jstate.normal_out),
                                       rtol=1e-5, atol=1e-6)
            assert np.array(jstate.alive).any()
            assert (out.radiance != tstate.radiance).any()


def test_queue_sum_keeps_the_queue_order():
    """radiance + k_0 + k_1, not radiance + (k_0 + k_1): with radiance 1
    and two visible contributions of 2^-24 each, the queue's order rounds
    back to 1 twice, while the fused tail's delta from 0 is 2^-23 and
    lifts the sum to 1 + 2^-23."""
    n = 4
    tiny = 2.0 ** -24
    segs = shade_cuda.ShadowSegments(
        geom=torch.zeros((6, 2, n)), k=torch.full((3, 2, n), tiny),
        active=torch.ones((2, n), dtype=torch.bool),
        queue=torch.arange(2 * n, dtype=torch.int32),
        count=torch.full((1,), 2 * n, dtype=torch.int32))
    verdict = torch.zeros((2, n), dtype=torch.bool)
    radiance = torch.ones((n, 3))
    got = shade_cuda.queue_sum_plain(radiance, segs, verdict)
    delta_order = radiance + shade_cuda.shadow_sum_plain(segs, verdict)
    assert torch.equal(got, radiance)
    assert torch.equal(delta_order, torch.full((n, 3), 1.0 + 2.0 ** -23))
    verdict[1] = True   # an occluded segment adds k * 0
    assert torch.equal(shade_cuda.queue_sum_plain(radiance, segs, verdict),
                       radiance)


@pytest.mark.parametrize("relax", [1.0, 1.5])
@pytest.mark.parametrize("bound", [0.0, 3.6])
def test_march_occlusion_twins_compose(relax, bound):
    """The enqueue and refill-march twins (march_occlusion on the CPU)
    give the one-piece twin's verdicts bit for bit."""
    g = np.random.default_rng(4)
    m = 1536
    start = g.uniform(-3.0, 3.0, (m, 3)).astype(np.float32)
    d = g.normal(size=(m, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    end = (start + d * g.uniform(0.2, 6.0, (m, 1))).astype(np.float32)
    end[:16] = start[:16]             # zero length
    start[16:32, 0] = np.nan          # NaN start
    args = (tsdf.mandelbox(iterations=12, box_fold_l=1.0,
                           sphere_min_rad=0.01, sphere_fixed_rad=1.9,
                           scale=-2.1),
            torch.from_numpy(start), torch.from_numpy(end), 0.5, 32,
            torch.from_numpy(g.uniform(size=m) > 0.3), relax, bound)
    queue, count = march_cuda.enqueue(args[5])
    assert int(count[0]) == int(args[5].sum())
    got = march_cuda.occlusion_march(*args[:5], queue, count, relax, bound)
    want = march_cuda.march_occlusion_plain(*args)
    assert want.any() and torch.equal(got, want)
    assert torch.equal(march_cuda.march_occlusion(*args), want)


def test_two_phase_route_marches_the_scratch_unclipped():
    """With `occl_sort_steps=8` and `shadow_bv_clip=True`, _queue_verdicts
    equals the refill march's twin on the same scratch unclipped, and
    JAX's march_occlusion_sorted of the queued segments: 2 x 512 random
    segments through the fractal, under a clip radius of 1.5 in place of
    the scene's 3.6, so that the clip changes verdicts."""
    jdata, jstatic, _ = jpresets.default_scene(resolution=RES)
    data, static = convert.scene(jax.tree.map(np.asarray, jdata), jstatic,
                                 sdf_iterations=12, device="cpu")
    s = RenderSettings(resolution=RES, spp=1, max_vis_marches=32,
                       shadow_bv_clip=True, occl_sort_steps=8)
    cfg = shade_cuda.shadow_cfg(data, static, s, rng.SampleTables(1), 0)
    cfg = cfg._replace(sdfs=tuple((prog, 1.5) for prog, _bv in cfg.sdfs))
    g = np.random.default_rng(8)
    S, n = 2, 512
    start = g.uniform(-3.0, 3.0, (S * n, 3))
    end = g.uniform(-3.0, 3.0, (S * n, 3))
    act = g.uniform(size=S * n) > 0.2
    queue, count = march_cuda.enqueue_plain(torch.from_numpy(act))
    geom = np.concatenate([start, end], -1).astype(np.float32)
    segs = shade_cuda.ShadowSegments(
        geom=torch.from_numpy(geom.T.reshape(6, S, n).copy()),
        k=torch.ones((3, S, n)), active=torch.from_numpy(act.reshape(S, n)),
        queue=queue, count=count)
    got = integrator._queue_verdicts(s, cfg, segs)
    want = shade_cuda.shadow_march_plain(shade_cuda.unclipped(cfg), segs,
                                         1.0)
    clipped = shade_cuda.shadow_march_plain(cfg, segs, 1.0)
    assert want.any() and (want != clipped).any()
    assert torch.equal(got, want)
    (prog, _mat, _bv), = jstatic.sdf_instances(jdata)
    jwant = jpallas.march_occlusion_sorted(
        prog, jnp.asarray(geom[:, :3]), jnp.asarray(geom[:, 3:]), cfg.detail,
        cfg.max_steps, jnp.asarray(act), phase1_steps=8, interpret=True)
    np.testing.assert_array_equal(got.numpy().ravel(), np.asarray(jwant))


def test_queue_wrappers_reject_other_devices():
    """Like every wrapper, the new ones refuse tensors that are neither
    on the CPU nor on a CUDA device."""
    data, static, _cam = presets.default_scene(resolution=(8, 8),
                                               device="cpu")
    cfg = shade_cuda.shadow_cfg(data, static, RenderSettings(
        resolution=(8, 8), spp=1), rng.SampleTables(1), 0)
    tabs = shade_cuda.scene_tables(data, static)
    z3 = torch.zeros((4, 3), device="meta")
    z = torch.zeros((4,), device="meta")
    state = integrator.PathState(*(z3,) * len(integrator.PathState._fields))
    segs = shade_cuda.ShadowSegments(
        torch.zeros((6, 12, 4), device="meta"),
        torch.zeros((3, 12, 4), device="meta"),
        torch.zeros((12, 4), dtype=torch.bool, device="meta"),
        torch.zeros((48,), dtype=torch.int32, device="meta"),
        torch.zeros((1,), dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError):
        shade_cuda.queue_segments(cfg, tabs, state, None, None, z, z, z,
                                  z)
    with pytest.raises(ValueError):
        shade_cuda.queue_sum(z3, segs, segs.active)
    with pytest.raises(ValueError):
        march_cuda.enqueue(z.bool())
    with pytest.raises(ValueError):
        march_cuda.occlusion_march(data.sdf_params, z3, z3, 0.5, 8,
                                   segs.queue[:4], segs.count)


SORTED_CHUNK_CASES = {"spheres": ("spheres", dict(max_bounces=3)),
                      "no_bounce": ("default", dict(max_bounces=0))}


@pytest.mark.parametrize("case", sorted(SORTED_CHUNK_CASES))
def test_sorted_chunk_renders_where_jax_renders(case):
    """A pass of 64 rays with sorted_chunk=128 (which does not divide it)
    renders the spheres scene (no SDF, so no sort) and the default scene
    at max_bounces 0 (no bounce ray, so no sort) in both packages, to the
    image gate of test_torch_render._image_vs_jax (RMSE < 1.5e-3, mean
    relative difference < 1e-3); at max_bounces 1 the default scene
    sorts its bounce rays, and the port raises where JAX does."""
    scene, change = SORTED_CHUNK_CASES[case]
    kw = dict(resolution=RES, spp=1, max_marches=24, max_vis_marches=16,
              rays_per_pass=N, sorted_chunk=128, **change)
    jscene = (jpresets.spheres_scene if scene == "spheres"
              else jpresets.default_scene)
    jdata, jstatic, jcam = jscene(resolution=RES)
    with jax.disable_jit():
        want = np.asarray(jfilm.resolve(
            jrenderer.render_frame(jdata, jstatic, JSettings(**kw), jcam,
                                   frame=1), RES).color)
    tdata, tstatic = convert.scene(jax.tree.map(np.asarray, jdata), jstatic,
                                   sdf_iterations=12, device="cpu")
    tcam = convert.camera(jax.tree.map(np.asarray, jcam), device="cpu")
    f = renderer.render_frame(tdata, tstatic, RenderSettings(**kw), tcam,
                              frame=1)
    got = film.resolve(f, RES).color
    assert f.samples.sum().item() == N and np.isfinite(got).all()
    rmse = float(np.sqrt(np.mean((got - want) ** 2)))
    assert rmse < 1.5e-3, rmse
    assert abs(got.mean() - want.mean()) / want.mean() < 1e-3
    if scene == "default":
        with pytest.raises(ValueError, match="sorted_chunk"):
            renderer.render_frame(tdata, tstatic, RenderSettings(
                **dict(kw, max_bounces=1)), tcam, frame=1)
