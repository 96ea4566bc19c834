"""The port's scale-out against the JAX package's on the CPU: two ranks
of the port (gloo processes, tests/test_torch_sharding.py's workers)
against JAX's `render_frame_sharded` and `render_frames_per_chip` on two
of the conftest's virtual CPU devices, on the same scene converted with
`convert.scene`.

The gates are tests/test_torch_render.py's image gates (RMSE < 1.5e-3,
mean relative difference < 1e-3) and `samples` exact: JAX compiles its
sharded pass with XLA, which contracts a*b+c into FMAs where the port
rounds every operation, so the films are close and not equal. The scene
is the spheres scene: on the default scene those FMAs decorrelate the
fractal's chaotic lanes like a seed change (RMSE 1.9e-3 at 16x12 and 4
spp), and JAX's sharded render op by op, which would not contract, takes
more than ten minutes here. The default scene's sharded film is held to
the port's single-device film in tests/test_torch_sharding.py, and that
film to JAX's op-by-op render in tests/test_torch_render.py.
"""

import jax
import numpy as np
import torch

from rayn_tpu.config import RenderSettings as JSettings
from rayn_tpu.parallel import sharding as jsharding
from rayn_tpu.render import film as jfilm
from rayn_tpu.scene import presets as jpresets
from rayn_tpu_torch import convert
from rayn_tpu_torch.render import film as film_mod

from test_torch_sharding import settings, spawn

torch.set_num_threads(1)


def _jax_and_port_scene(path):
    """JAX's scene, mesh and settings; the port's conversion of the scene
    saved at `path` for the ranks."""
    s = settings()
    js = JSettings(**{f: getattr(s, f) for f in (
        "resolution", "spp", "max_bounces", "volume_marches", "max_marches",
        "max_vis_marches", "rays_per_pass")})
    jdata, jstatic, jcam = jpresets.spheres_scene(resolution=s.resolution)
    tdata, tstatic = convert.scene(jax.tree.map(np.asarray, jdata), jstatic,
                                   device="cpu")
    tcam = convert.camera(jax.tree.map(np.asarray, jcam), device="cpu")
    torch.save((tdata, tstatic, tcam), path)
    return (jdata, jstatic, jcam, js,
            jsharding.make_mesh(jax.devices()[:2]))


def assert_image_gates(got, want, res):
    """got: the port's film tensors; want: JAX's Film."""
    assert torch.equal(got[4], torch.from_numpy(np.array(want.samples)))
    g = film_mod.resolve(film_mod.Film(*got[:5]), res).color
    w = np.asarray(jfilm.resolve(want, res).color)
    assert np.isfinite(g).all()
    rmse = float(np.sqrt(np.mean((g - w) ** 2)))
    assert rmse < 1.5e-3, rmse
    assert abs(g.mean() - w.mean()) / w.mean() < 1e-3


def test_sharded_film_matches_jax(tmp_path):
    path = tmp_path / "scene.pt"
    jdata, jstatic, jcam, js, mesh = _jax_and_port_scene(path)
    want = jsharding.render_frame_sharded(jdata, jstatic, js, jcam,
                                          frame=1, mesh=mesh)
    got = spawn(tmp_path, 2, "film", "spheres", path)
    for g in got:
        assert_image_gates(g["film"], want, js.resolution)


def test_frames_per_chip_match_jax(tmp_path):
    path = tmp_path / "scene.pt"
    jdata, jstatic, jcam, js, mesh = _jax_and_port_scene(path)
    want = jsharding.render_frames_per_chip(jdata, jstatic, js, jcam,
                                            [1, 2], mesh=mesh)
    got = spawn(tmp_path, 2, "frames", "spheres", path)
    for r in range(2):
        for f in range(2):
            assert_image_gates(got[r]["films"][f], want[f], js.resolution)
