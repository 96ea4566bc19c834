"""The port's extra AOV channels on the CPU, against rayn_tpu.

- aovs.extract against JAX's on the same seeded inputs: mat_id equal,
  the other channels within rtol 1e-5 / atol 1e-6; an unknown name
  raises ValueError listing the names.
- The film of tests/test_aovs.py's scene (a lambertian sphere under the
  sky and one light) at 24x16, 4 spp, two bounces, with all four AOVs,
  against JAX's render_frame op by op (as tests/test_torch_render.py):
  every channel and every AOV within the sphere-scene image gate (RMSE
  < 1e-3).
- save_channels' AOV PNGs, decoded by Pillow, equal JAX's; a checkpoint
  keeps the extras, saved and loaded and through a resumed render;
  render_pass refuses a film without the extras; the command line's
  --aov writes {base}_{aov}.png.
Pillow is used by these tests only; the port writes PNG itself.
"""

import dataclasses
from types import SimpleNamespace as NS

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from rayn_tpu.config import RenderSettings as JSettings
from rayn_tpu.render import aovs as jaovs
from rayn_tpu.render import film as jfilm
from rayn_tpu.render import renderer as jrenderer
from rayn_tpu.render.camera import PinholeCamera as JPinhole
from rayn_tpu.scene.scene import SceneBuilder as JBuilder
from rayn_tpu_torch import cli, convert
from rayn_tpu_torch.config import RenderSettings
from rayn_tpu_torch.render import aovs, checkpoint, film, renderer
from rayn_tpu_torch.scene import presets

torch.set_num_threads(1)

RES = (24, 16)
ALL = ("depth", "position", "albedo", "mat_id")


def jax_scene(res=RES):
    """tests/test_aovs.py's simple_scene."""
    b = JBuilder()
    sky = b.add_sky(top=(0.3, 0.4, 0.6), bottom=(0.01, 0.015, 0.03))
    b.add_sphere((0.0, 0.0, 0.0), 100.0, sky)
    lam = b.add_lambertian((0.6, 0.3, 0.2))
    b.add_sphere((0.0, 0.0, 0.0), 1.0, lam)
    warm = np.asarray((5.0, 4.0, 2.5)) / np.linalg.norm((5.0, 4.0, 2.5))
    b.add_sphere_light((2.0, 2.5, 2.0), 0.4, warm * 30.0)
    cam = JPinhole.make(res, 60.0, (0.0, 0.0, 3.0), (0.0, 0.0, 0.0),
                        (0.0, 1.0, 0.0))
    data, static = b.build()
    return data, static, cam


def port_scene(res=RES):
    jdata, jstatic, jcam = jax_scene(res)
    data, static = convert.scene(jax.tree.map(np.asarray, jdata), jstatic,
                                 device="cpu")
    return data, static, convert.camera(jax.tree.map(np.asarray, jcam),
                                        device="cpu")


def _rmse(a, b):
    return float(np.sqrt(np.mean((np.asarray(a) - np.asarray(b)) ** 2)))


@pytest.mark.parametrize("names", [(n,) for n in ALL] + [ALL])
def test_extract_matches_jax(names):
    g = np.random.default_rng(11)
    n = 257
    t = g.uniform(0.0, 50.0, n).astype(np.float32)
    point = g.normal(size=(n, 3)).astype(np.float32)
    mat = g.integers(0, 6, n).astype(np.int32)
    color_a = g.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    recv = g.uniform(size=n) < 0.6
    want = jaovs.extract(
        JSettings(extra_aovs=names), NS(t=jnp.asarray(t)),
        NS(point=jnp.asarray(point), mat=jnp.asarray(mat)),
        NS(color_a=jnp.asarray(color_a)), jnp.asarray(recv))
    got = aovs.extract(
        RenderSettings(extra_aovs=names), NS(t=torch.from_numpy(t)),
        NS(point=torch.from_numpy(point), mat=torch.from_numpy(mat)),
        NS(color_a=torch.from_numpy(color_a)), torch.from_numpy(recv))
    assert len(got) == len(want) == len(names)
    for name, g_, w in zip(names, got, want):
        assert g_.dtype == torch.float32 and g_.shape == w.shape
        if name == "mat_id":
            np.testing.assert_array_equal(g_.numpy(), np.asarray(w))
        else:
            np.testing.assert_allclose(g_.numpy(), np.asarray(w), rtol=1e-5,
                                       atol=1e-6)


def test_unknown_aov_raises():
    s = RenderSettings(resolution=(8, 6), spp=1, extra_aovs=("depth", "nope"))
    with pytest.raises(ValueError, match="unknown AOV 'nope'") as e:
        aovs.specs_for(s)
    assert all(n in str(e.value) for n in ALL)
    data, static, cam = port_scene((8, 6))
    with pytest.raises(ValueError, match="unknown AOV"):
        renderer.render_frame(data, static, s, cam)


def test_aov_film_matches_jax():
    kw = dict(resolution=RES, spp=4, max_bounces=2, rays_per_pass=1 << 10,
              extra_aovs=ALL)
    jdata, jstatic, jcam = jax_scene()
    with jax.disable_jit():
        jf = jrenderer.render_frame(jdata, jstatic, JSettings(**kw), jcam,
                                    frame=1)
    want = jfilm.resolve(jf, RES, JSettings(**kw))
    data, static, cam = port_scene()
    s = RenderSettings(**kw)
    f = renderer.render_frame(data, static, s, cam, frame=1)
    got = film.resolve(f, RES, s)
    np.testing.assert_array_equal(f.samples.numpy(), np.asarray(jf.samples))
    assert list(got.extra) == list(want.extra) == list(ALL)
    for c in ("color", "alpha", "background", "normal"):
        assert _rmse(getattr(got, c), getattr(want, c)) < 1e-3, c
    for name in ALL:
        assert got.extra[name].shape == want.extra[name].shape
        scale = max(float(np.abs(want.extra[name]).max()), 1.0)
        assert _rmse(got.extra[name], want.extra[name]) / scale < 1e-3, name
    # the centre sees the sphere (depth ~2, its albedo), a corner the sky
    cy, cx = RES[1] // 2, RES[0] // 2
    assert abs(got.extra["depth"][cy, cx] - 2.0) < 0.05
    np.testing.assert_allclose(got.extra["albedo"][cy, cx], (0.6, 0.3, 0.2),
                               atol=1e-5)
    assert got.extra["depth"][0, 0] == 0.0


def _resolved_extras(g, h=5, w=7):
    f32 = np.float32
    return dict(color=g.uniform(-0.2, 1.4, (h, w, 3)).astype(f32),
                alpha=g.uniform(0, 1, (h, w)).astype(f32),
                background=g.uniform(-0.2, 1.2, (h, w, 3)).astype(f32),
                normal=g.uniform(-1.1, 1.1, (h, w, 3)).astype(f32),
                extra={"depth": g.uniform(0.0, 7.0, (h, w)).astype(f32),
                       "albedo": g.uniform(-0.2, 1.3, (h, w, 3)).astype(f32),
                       "mat_id": np.zeros((h, w), f32)})


def test_save_channels_aov_pngs_match_jax(tmp_path):
    res = _resolved_extras(np.random.default_rng(5))
    kinds = ("color", "depth", "albedo", "mat_id")
    want = jfilm.save_channels(jfilm.ResolvedFilm(**res), tmp_path / "jax",
                               "f", kinds)
    got = film.save_channels(film.ResolvedFilm(**res), tmp_path / "port",
                             "f", kinds)
    assert [p.split("/")[-1] for p in got] == [p.split("/")[-1] for p in want]
    assert got[1].endswith("f_depth.png") and got[2].endswith("f_albedo.png")
    for g_path, w_path in zip(got, want):
        with Image.open(w_path) as wi, Image.open(g_path) as gi:
            assert gi.mode == wi.mode
            w_px, g_px = np.asarray(wi), np.asarray(gi)
        np.testing.assert_array_equal(g_px, w_px)
        np.testing.assert_array_equal(film.read_png(g_path), w_px)


def test_checkpoint_keeps_extras(tmp_path):
    """Saved and loaded by position; a 2-spp checkpoint grown to 4 spp
    gives the flat 4-spp film's extras (the film invariants' atol)."""
    res = (8, 6)
    data, static, cam = port_scene(res)
    s = RenderSettings(resolution=res, spp=2, max_bounces=1,
                       rays_per_pass=32, extra_aovs=("mat_id", "position"))
    f = renderer.render_frame(data, static, s, cam)
    path = str(tmp_path / "ck.npz")
    checkpoint.save(path, f, s, frame=1, next_pass=3, scene=data)
    prog = checkpoint.load_progress(path, s, 1, scene=data)
    assert prog is not None and len(prog.film.extra) == 2
    for x, y in zip(film.tensors(prog.film), film.tensors(f)):
        assert torch.equal(x, y)
    grown_path = str(tmp_path / "grow.npz")
    renderer.render_frame(data, static, s, cam, checkpoint_path=grown_path)
    s4 = dataclasses.replace(s, spp=4)
    grown = renderer.render_frame(data, static, s4, cam,
                                  checkpoint_path=grown_path)
    flat = renderer.render_frame(data, static, s4, cam)
    assert len(grown.extra) == 2
    for x, y in zip(film.tensors(grown), film.tensors(flat)):
        torch.testing.assert_close(x, y, rtol=0, atol=2e-5)


def test_render_pass_refuses_a_film_without_extras():
    data, static, cam = port_scene((8, 6))
    s = RenderSettings(resolution=(8, 6), spp=1, extra_aovs=("depth",))
    with pytest.raises(ValueError, match="extra AOVs"):
        renderer.render_pass(film.new_film(48, "cpu"), data, static, s,
                             None, cam, None, 0, 48, 0.0, 1.0)


def test_resolve_names_extras():
    f = film.new_film(6, "cpu", RenderSettings(extra_aovs=("albedo",
                                                           "depth")))
    assert [tuple(a.shape) for a in f.extra] == [(6, 3), (6,)]
    assert list(film.resolve(f, (3, 2)).extra) == ["aov0", "aov1"]
    assert film.resolve(f, (3, 2)).extra["aov0"].shape == (2, 3, 3)
    assert film.new_film(6, "cpu", RenderSettings()).extra == ()


def test_cli_writes_aov_pngs(tmp_path, capsys):
    out = tmp_path / "out"
    argv = ["--device", "cpu", "--scene", "spheres", "--width", "16",
            "--height", "8", "--spp", "1", "--bounces", "1", "--channels",
            "color", "--aov", "depth", "--aov", "albedo", "--out", str(out)]
    assert cli.main(argv) == 0
    names = sorted(p.name for p in out.iterdir())
    assert names == sorted(f"frame0001_1spp_{k}.png"
                           for k in ("color", "depth", "albedo"))
    assert film.read_png(out / "frame0001_1spp_albedo.png").shape == (8, 16, 3)
    assert film.read_png(out / "frame0001_1spp_depth.png").shape == (8, 16)
    assert "Saved" in capsys.readouterr().err


def test_presets_render_every_aov():
    """The default scene (its MandelBox and spheres) with the four AOVs:
    finite, the MandelBox's material id where it is seen."""
    res = (8, 8)
    data, static, cam = presets.default_scene(resolution=res, device="cpu")
    s = RenderSettings(resolution=res, spp=1, max_bounces=1, max_marches=24,
                       max_vis_marches=16, extra_aovs=ALL)
    got = film.resolve(renderer.render_frame(data, static, s, cam), res, s)
    assert all(np.isfinite(v).all() for v in got.extra.values())
    assert (got.extra["mat_id"] == static.sdf_mat).any()
    assert (got.extra["depth"] > 0).any()
