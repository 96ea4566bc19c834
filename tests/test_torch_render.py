"""The whole port slice on the CPU against rayn_tpu: images, one
segment-queue bounce, the settings that raise or render, the default
device of the entry points, and the import boundary. The split tail and
MIS are held to JAX in tests/test_torch_split_tail.py.

The image gate is the fused-vs-unfused one of
tests/test_fused_shadows.py:98-119, here at 16x16, 4 spp and one
bounce, for the fused path and for the relaxed segment-queue path:
image RMSE < 1.5e-3 and mean relative difference < 1e-3. The JAX
reference renders op by op (`jax.disable_jit`): XLA's compiled render
contracts a*b+c into FMAs (its compiled MandelBox DE equals the op-by-op
one bit for bit on only ~25% of points), which decorrelates chaotic
fractal lanes like a seed change (measured RMSE 3.4e-3 at 8 spp, 1.3e-3
at 32 spp, against a seed-swap null of 7.2e-2), while op by op every
operation rounds in float32 as in the port and its CUDA kernels.
"""

import dataclasses
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rayn_tpu.config import RenderSettings as JSettings
from rayn_tpu.ops import filters as jfilters
from rayn_tpu.render import film as jfilm
from rayn_tpu.render import integrator as jint
from rayn_tpu.render import renderer as jrenderer
from rayn_tpu.scene import presets as jpresets
from rayn_tpu.utils import rng as jrng
from rayn_tpu_torch import convert
from rayn_tpu_torch.config import RenderSettings
from rayn_tpu_torch.parallel import sharding
from rayn_tpu_torch.render import camera as camera_mod
from rayn_tpu_torch.render import film, integrator, renderer
from rayn_tpu_torch.scene import presets
from rayn_tpu_torch.scene import scene as scene_mod
from rayn_tpu_torch.utils import rng

# The tensors here are small: one torch thread per test worker avoids
# contending with the other pytest workers for the cores.
torch.set_num_threads(1)


# One shape for every op-by-op JAX run in this file (1024 rays): JAX
# compiles each primitive once per shape, and that compile is most of
# the cost of the first such run.
RES = (16, 16)
N = RES[0] * RES[1] * 4


def _kw(**change):
    kw = dict(resolution=RES, spp=4, max_bounces=1, max_marches=24,
              max_vis_marches=16, rays_per_pass=N)
    kw.update(change)
    return kw


def _image_vs_jax(**change):
    """(RMSE, mean relative difference) of the port's 16x16 image at
    4 spp against JAX's op-by-op render of the same settings."""
    res, kw = RES, _kw(**change)
    jdata, jstatic, jcam = jpresets.default_scene(resolution=res)
    with jax.disable_jit():
        want = np.asarray(jfilm.resolve(
            jrenderer.render_frame(jdata, jstatic, JSettings(**kw), jcam,
                                   frame=1), res).color)
    tdata, tstatic = convert.scene(jax.tree.map(np.asarray, jdata), jstatic,
                                   sdf_iterations=12, device="cpu")
    tcam = convert.camera(jax.tree.map(np.asarray, jcam), device="cpu")
    f = renderer.render_frame(tdata, tstatic, RenderSettings(**kw), tcam,
                              frame=1)
    got = film.resolve(f, res).color
    assert f.samples.sum().item() == res[0] * res[1] * 4
    assert np.isfinite(got).all()
    rmse = float(np.sqrt(np.mean((got - want) ** 2)))
    return rmse, abs(got.mean() - want.mean()) / want.mean()


def test_render_matches_jax_image():
    """The fused path (intersect and bounce-tail kernels' plain twins)."""
    rmse, mean_rel = _image_vs_jax()
    assert rmse < 1.5e-3, rmse
    assert mean_rel < 1e-3, mean_rel


def test_relaxed_render_matches_jax_image():
    """The segment-queue path with over-relaxed marching."""
    rmse, mean_rel = _image_vs_jax(march_relaxation=1.5)
    assert rmse < 1.5e-3, rmse
    assert mean_rel < 1e-3, mean_rel


QUEUE_CASES = {"relaxed": dict(march_relaxation=1.5),
               "unfused": dict(use_fused_intersect=False,
                               use_fused_shadows=False),
               "sorted": dict(use_fused_intersect=False,
                              use_fused_shadows=False, march_sort_steps=8,
                              occl_sort_steps=8)}


@pytest.mark.parametrize("case", sorted(QUEUE_CASES))
def test_segment_queue_bounce_matches_jax(case):
    """One segment-queue bounce at depths 0 and 1 against JAX's
    integrator.bounce on the same state, both op by op. Radiance,
    throughput, color_out and bg_out: the gates of
    tests/test_fused_shadows.py:69-95 (within rtol 2e-4 / atol 2e-5 on
    >= 98.5% of elements, max |d| < 0.1; exp, sin, cos, atan2, tan and
    pow round differently in the two libraries, which can flip a grazing
    shadow verdict); alive, pixel, alpha_out and normal_out equal.

    "sorted": on the CPU the JAX package runs its jnp marches whatever
    the two-phase settings say, with the bounding-sphere clip, while the
    port takes its two-phase marches, unclipped as on the TPU; the few
    verdicts the clip changes stay inside the same gates (the two-phase
    functions are held to JAX's exactly in test_torch_phased)."""
    n, kw = N, _kw(max_bounces=3, **QUEUE_CASES[case])
    js, ts = JSettings(**kw), RenderSettings(**kw)
    jdata, jstatic, jcam = jpresets.default_scene(resolution=RES)
    tdata, tstatic = convert.scene(jax.tree.map(np.asarray, jdata), jstatic,
                                   sdf_iterations=12, device="cpu")
    jtables = jrng.build_sample_tables(js, frame=1)
    ttables = rng.build_sample_tables(ts, 1)
    fis = jfilters.build_fis_table(jfilters.blackman_harris(1.5), 512)
    ha, hl = jcam.half_pixel_size_coeffs()
    with jax.disable_jit():
        o, d, tm, px, si, ok = jrenderer.generate_rays(
            js, jtables, jcam, fis, jrenderer.ray_indices(jnp.int32(0), n),
            jnp.float32(1 / 24), jnp.float32(2 / 24))
        jstate = jint.init_state(o, d, tm, px, si, ok)
        for depth in range(2):
            tstate = integrator.PathState(
                *(torch.from_numpy(np.array(getattr(jstate, f)))
                  for f in integrator.PathState._fields))
            out = integrator.bounce(tdata, tstatic, ts, ttables, tstate,
                                    depth, float(ha), float(hl))
            jstate = jint.bounce(jdata, jstatic, js, jtables, jstate, depth,
                                 ha, hl)
            for f in ("radiance", "throughput", "color_out", "bg_out"):
                want, got = np.array(getattr(jstate, f)), getattr(out, f)
                close = np.isclose(got.numpy(), want, rtol=2e-4, atol=2e-5)
                assert close.mean() >= 0.985, (depth, f, close.mean())
                assert np.abs(got.numpy() - want).max() < 0.1, (depth, f)
            for f in ("alive", "pixel", "alpha_out", "normal_out"):
                np.testing.assert_array_equal(getattr(out, f).numpy(),
                                              np.array(getattr(jstate, f)))
            assert np.array(jstate.alive).any()


@pytest.mark.parametrize("change", [
    dict(use_pallas=False), dict(use_pallas_occlusion=False)])
def test_unimplemented_settings_raise(change):
    """Once refused, the JAX package's route without kernels now renders:
    its film is the kernel route's with the fused kernel that the flag
    turns off turned off, bit for bit (tests/test_torch_nokernel.py holds
    the route against JAX)."""
    res = (8, 8)
    data, static, cam = presets.default_scene(resolution=res, device="cpu")
    s = RenderSettings(resolution=res, spp=1, max_bounces=1, max_marches=48,
                       max_vis_marches=24)
    off = ({"use_fused_intersect": False} if "use_pallas" in change
           else {"use_fused_shadows": False})
    got = renderer.render_frame(data, static,
                                dataclasses.replace(s, **change), cam)
    want = renderer.render_frame(data, static,
                                 dataclasses.replace(s, **off), cam)
    assert all(torch.equal(a, b) for a, b in zip(film.tensors(got),
                                                 film.tensors(want)))


@pytest.mark.parametrize("field", [
    "march_sort_steps", "occl_phase1_steps", "occl_sort_steps"])
def test_phased_march_settings_carry_across(field):
    """A phased/sorted march field of the JAX settings is a field here
    too, with JAX's default; a non-zero value renders through the
    two-phase marches of the unfused bounce."""
    assert getattr(RenderSettings(), field) == getattr(JSettings(), field)
    res = (8, 8)
    data, static, cam = presets.default_scene(resolution=res, device="cpu")
    s = RenderSettings(resolution=res, spp=2, max_bounces=1, max_marches=24,
                       max_vis_marches=16, use_fused_intersect=False,
                       use_fused_shadows=False, **{field: 8})
    f = renderer.render_frame(data, static, s, cam)
    assert f.samples.sum().item() == res[0] * res[1] * 2
    assert torch.isfinite(f.color).all() and f.alpha.sum().item() > 0.0


@pytest.mark.parametrize("change", [
    dict(mis=True), dict(use_fused_bounce_tail=False),
    dict(use_fused_finish=False)])
def test_split_tail_settings_render(change):
    """MIS and the split tail render on the fused path (the three
    settings that were refused before their kernels were ported)."""
    res = (8, 8)
    data, static, cam = presets.default_scene(resolution=res, device="cpu")
    s = dataclasses.replace(RenderSettings(
        resolution=res, spp=2, max_bounces=1, max_marches=24,
        max_vis_marches=16), **change)
    f = renderer.render_frame(data, static, s, cam)
    assert f.samples.sum().item() == res[0] * res[1] * 2
    assert torch.isfinite(f.color).all() and f.alpha.sum().item() > 0.0


@pytest.mark.parametrize("change", [
    dict(march_relaxation=1.5), dict(use_fused_shadows=False),
    dict(use_fused_intersect=False),
    dict(march_relaxation=1.5, use_fused_finish=False,
         use_fused_bounce_tail=False)])
def test_segment_queue_settings_render(change):
    """Settings that take the segment queue (or the unfused intersect)
    render; the segment queue never reads the split-tail flags."""
    res = (8, 8)
    data, static, cam = presets.default_scene(resolution=res, device="cpu")
    s = dataclasses.replace(RenderSettings(
        resolution=res, spp=2, max_bounces=1, max_marches=24,
        max_vis_marches=16), **change)
    f = renderer.render_frame(data, static, s, cam)
    assert f.samples.sum().item() == res[0] * res[1] * 2
    assert torch.isfinite(f.color).all() and f.alpha.sum().item() > 0.0


def _entry_point(name):
    """Call one public entry point without a device argument."""
    if name == "default_scene":
        return presets.default_scene(resolution=(8, 8))[0].device
    if name == "SceneBuilder.build":
        b = scene_mod.SceneBuilder()
        b.add_sphere((0.0, 0.0, 0.0), 1.0, b.add_lambertian((0.5,) * 3))
        return b.build()[0].device
    if name == "PinholeCamera.make":
        cam = camera_mod.PinholeCamera.make((8, 8), 60.0, (0.0, 0.0, 4.0),
                                            (0.0, 0.0, 0.0), (0.0, 1.0, 0.0))
        return cam.origin.values.device
    if name == "parallel.make_mesh":
        return sharding.make_mesh().device
    jdata, jstatic, jcam = jpresets.default_scene(resolution=(8, 8))
    if name == "convert.scene":
        return convert.scene(jax.tree.map(np.asarray, jdata), jstatic,
                             sdf_iterations=12)[0].device
    return convert.camera(jax.tree.map(np.asarray, jcam)).origin.values.device


@pytest.mark.parametrize("name", [
    "default_scene", "SceneBuilder.build", "PinholeCamera.make",
    "convert.scene", "convert.camera", "parallel.make_mesh"])
def test_entry_points_default_to_cuda(name):
    """With no device argument an entry point puts its tensors on the
    CUDA card; without a card it raises instead of using the CPU."""
    if torch.cuda.is_available():
        assert _entry_point(name).type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            _entry_point(name)


def test_unimplemented_entry_points_raise():
    """mesh= is rendered since scale-out was ported (tests/
    test_torch_sharding.py); anything but a parallel.sharding.Mesh is a
    TypeError."""
    res = (8, 8)
    data, static, cam = presets.default_scene(resolution=res, device="cpu")
    s = RenderSettings(resolution=res, spp=1)
    with pytest.raises(TypeError):
        renderer.render_frame_resilient(data, static, s, cam, mesh=object())
    with pytest.raises(TypeError):
        renderer.render_frame(data, static, s, cam, mesh=object())


def test_port_never_imports_jax():
    """Importing every module of the port loads no module of JAX or of
    the JAX package (checked against what the interpreter had loaded
    before the port was imported)."""
    code = ("import sys, importlib, pkgutil\n"
            "before = set(sys.modules)\n"
            "import rayn_tpu_torch\n"
            "for m in pkgutil.walk_packages(rayn_tpu_torch.__path__, "
            "'rayn_tpu_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "new = set(sys.modules) - before\n"
            "bad = sorted(k for k in new if k.split('.')[0] in "
            "('jax', 'jaxlib', 'rayn_tpu'))\n"
            "assert not bad, bad\n"
            "assert 'rayn_tpu_torch.render.renderer' in sys.modules\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
