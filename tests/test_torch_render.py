"""The whole port slice on the CPU against rayn_tpu, the unimplemented
settings, and the import boundary.

The image gate is the fused-vs-unfused one of
tests/test_fused_shadows.py:98-119: at 20x20 and 8 spp, image RMSE
< 1.5e-3 and mean relative difference < 1e-3. The JAX reference renders
op by op (`jax.disable_jit`): XLA's compiled render contracts a*b+c into
FMAs (its compiled MandelBox DE equals the op-by-op one bit for bit on
only ~25% of points), which decorrelates chaotic fractal lanes like a
seed change (measured RMSE 3.4e-3 at 8 spp, 1.3e-3 at 32 spp, against a
seed-swap null of 7.2e-2), while op by op every operation rounds in
float32 as in the port and its CUDA kernels.
"""

import dataclasses
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from rayn_tpu.config import RenderSettings as JSettings
from rayn_tpu.render import film as jfilm
from rayn_tpu.render import renderer as jrenderer
from rayn_tpu.scene import presets as jpresets
from rayn_tpu_torch import convert
from rayn_tpu_torch.config import RenderSettings
from rayn_tpu_torch.render import film, renderer
from rayn_tpu_torch.scene import presets

# The tensors here are small: one torch thread per test worker avoids
# contending with the other pytest workers for the cores.
torch.set_num_threads(1)


def test_render_matches_jax_image():
    res = (20, 20)
    kw = dict(resolution=res, spp=8, max_marches=48, max_vis_marches=40,
              rays_per_pass=res[0] * res[1] * 8)
    jdata, jstatic, jcam = jpresets.default_scene(resolution=res)
    with jax.disable_jit():
        want = np.asarray(jfilm.resolve(
            jrenderer.render_frame(jdata, jstatic, JSettings(**kw), jcam,
                                   frame=1), res).color)
    tdata, tstatic = convert.scene(jax.tree.map(np.asarray, jdata), jstatic,
                                   sdf_iterations=12)
    tcam = convert.camera(jax.tree.map(np.asarray, jcam))
    f = renderer.render_frame(tdata, tstatic, RenderSettings(**kw), tcam,
                              frame=1)
    got = film.resolve(f, res).color
    assert f.samples.sum().item() == res[0] * res[1] * 8
    assert np.isfinite(got).all()
    rmse = float(np.sqrt(np.mean((got - want) ** 2)))
    mean_rel = abs(got.mean() - want.mean()) / want.mean()
    assert rmse < 1.5e-3, rmse
    assert mean_rel < 1e-3, mean_rel


@pytest.mark.parametrize("change", [
    dict(mis=True), dict(march_relaxation=1.5),
    dict(shadow_de_iterations=4), dict(extra_aovs=("depth",)),
    dict(compact_bounces=True), dict(use_fused_bounce_tail=False),
    dict(use_fused_shadows=False), dict(use_pallas=False),
    dict(use_fused_intersect=False)])
def test_unimplemented_settings_raise(change):
    res = (8, 8)
    data, static, cam = presets.default_scene(resolution=res)
    s = dataclasses.replace(RenderSettings(resolution=res, spp=1), **change)
    with pytest.raises(NotImplementedError):
        renderer.render_frame(data, static, s, cam)


def test_unimplemented_entry_points_raise():
    res = (8, 8)
    data, static, cam = presets.default_scene(resolution=res)
    s = RenderSettings(resolution=res, spp=1)
    with pytest.raises(NotImplementedError):
        renderer.render_frame(data, static, s, cam, checkpoint_path="x")
    with pytest.raises(NotImplementedError):
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
