"""JAX's dispatch keywords and the last helpers in the port, on the CPU:

- `render_frame(sync_every=, passes_per_dispatch=)` groups passes (a
  group clamped to checkpoint boundaries) and waits on older probes; the
  films are the default call's bit for bit, with and without a
  checkpoint, through render_frame_resilient too, with `_FAIL_HOOK` and
  `progress` called once a pass; `render_passes` is render_pass n times;
- `rng.rd_sequence`, `sampling.uniform_sphere` and
  `scene.light_positions_at` against JAX's on seeded inputs: the R_d
  values exactly, the floats to float32 tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rayn_tpu.scene import presets as jpresets
from rayn_tpu.scene import scene as jscene
from rayn_tpu.utils import rng as jrng
from rayn_tpu.utils import sampling as jsampling
from rayn_tpu_torch.config import RenderSettings
from rayn_tpu_torch.ops import filters
from rayn_tpu_torch.render import film as film_mod
from rayn_tpu_torch.render import renderer
from rayn_tpu_torch.scene import presets
from rayn_tpu_torch.scene import scene as tscene
from rayn_tpu_torch.utils import rng, sampling

torch.set_num_threads(1)

RES = (8, 8)
TIME = (0.0, 1.0 / 24.0)
# 8x8 at 4 spp in 32-ray passes: 8 passes
SMALL = RenderSettings(resolution=RES, spp=4, max_bounces=1,
                       volume_marches=1, max_marches=16, max_vis_marches=8,
                       rays_per_pass=32)


def same(a, b):
    return all(torch.equal(x, y) for x, y in zip(film_mod.tensors(a),
                                                 film_mod.tensors(b)))


@pytest.mark.parametrize("group", [1, 2, 3])
def test_dispatch_keywords_keep_the_film(group, tmp_path, monkeypatch):
    """Every group size and sync cadence gives the default film, with a
    checkpoint every 3 passes too (a group never crosses one), and calls
    the hook and progress once a pass."""
    data, static, cam = presets.spheres_scene(resolution=RES, device="cpu")
    want = renderer.render_frame(data, static, SMALL, cam, time_range=TIME)
    hooked, progress = [], []
    monkeypatch.setattr(renderer, "_FAIL_HOOK", hooked.append)
    got = renderer.render_frame(
        data, static, SMALL, cam, time_range=TIME, sync_every=3,
        passes_per_dispatch=group,
        progress=lambda done, total: progress.append(done))
    assert same(got, want)
    assert hooked == list(range(8))
    assert progress == [32 * (i + 1) for i in range(8)]
    path = str(tmp_path / "ck.npz")
    got = renderer.render_frame_resilient(
        data, static, SMALL, cam, time_range=TIME, checkpoint_path=path,
        checkpoint_every=3, sync_every=2, passes_per_dispatch=group)
    assert same(got, want)
    hooked.clear()
    again = renderer.render_frame(
        data, static, SMALL, cam, time_range=TIME, checkpoint_path=path,
        checkpoint_every=3, passes_per_dispatch=group)
    assert same(again, want) and hooked == []   # the finished checkpoint


def test_render_passes_is_render_pass_n_times():
    """render_passes(n) gives render_pass's film after n passes."""
    data, static, cam = presets.spheres_scene(resolution=RES, device="cpu")
    tables = rng.build_sample_tables(SMALL, 1)
    fis = filters.build_fis_table(filters.blackman_harris(1.5),
                                  SMALL.filter_table_size, device="cpu")
    args = (data, static, SMALL, tables, cam, fis)
    got = renderer.render_passes(film_mod.new_film(64, "cpu"), *args, 32,
                                 32, 3, *TIME)
    want = film_mod.new_film(64, "cpu")
    for p in range(1, 4):
        want = renderer.render_pass(want, *args, 32 * p, 32, *TIME)
    assert same(got, want)


def test_rd_sequence_matches_jax():
    """The R_d samples from any offset, exactly."""
    for dims, n, offset in ((1, 64, 0), (2, 100, 12345), (3, 17, 2 ** 40 + 5),
                            (4, 9, 2 ** 64 - 3)):
        got = rng.rd_sequence(dims, n, offset)
        assert got.dtype == np.float32 and got.shape == (n, dims)
        np.testing.assert_array_equal(got, jrng.rd_sequence(dims, n, offset))


def test_uniform_sphere_matches_jax():
    """Directions on the unit sphere from seeded (u, v)."""
    u, v = np.random.default_rng(3).random((2, 4096), dtype=np.float32)
    got = sampling.uniform_sphere(torch.from_numpy(u), torch.from_numpy(v))
    want = np.asarray(jsampling.uniform_sphere(jnp.asarray(u),
                                               jnp.asarray(v)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-6)
    np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=-1), 1.0,
                               atol=1e-5)


def test_light_positions_at_matches_jax():
    """Every light's center at each ray's time, on the scene whose lights
    orbit (8 knots over [0, 2] s)."""
    t = np.random.default_rng(4).uniform(0.0, 2.0, 256).astype(np.float32)
    tdata = presets.default_scene(resolution=RES, device="cpu",
                                  animated_geo=True)[0]
    jdata = jpresets.default_scene(resolution=RES, animated_geo=True)[0]
    got = tscene.light_positions_at(tdata, torch.from_numpy(t))
    want = np.asarray(jscene.light_positions_at(jdata, jnp.asarray(t)))
    assert got.shape == (256, 5, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
