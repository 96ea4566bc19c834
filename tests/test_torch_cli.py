"""The port's film surface and command line on the CPU, against rayn_tpu.

- Filters: each of the four FIS tables equals JAX's bit for bit.
- spectrum: the six functions against JAX's at atol 1e-6 (rtol 1e-6 for
  the gamma power).
- film.splat against JAX's scatter-add film.splat on seeded random
  values of a pass that starts and ends inside pixels, at atol 1e-6 (the
  sums run in another order); on an aligned pass it equals
  splat_aligned bit for bit. A render whose pass size is not a multiple
  of spp gives the same film bit for bit on two runs, and the
  spp-aligned render's film at the film invariants' atol 2e-5.
- save_channels: every channel, with and without
  transparent_background, decoded by Pillow, equals Pillow's decode of
  JAX's save_channels on the same arrays; the port's own reader decodes
  the same pixels.
- generate_rays with sample_base on a pass that starts inside a pixel:
  integers equal to JAX's, floats within atol 1e-6 (both op by op); the
  rays of a 2-spp segment at sample_base 2 equal those of sample indices
  2 and 3 of a flat 4-spp render bit for bit.
- The command line: every option string of rayn_tpu's parser with its
  default and choices, plus --device; each option the port cannot serve
  exits with its message; main on a 16x16 frame on the CPU writes JAX's
  file names, its colour PNG equal to save_channels of render_frame's
  film; with no card and no --device it raises.
Pillow is used by these tests only; the port writes PNG itself.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from rayn_tpu import cli as jcli
from rayn_tpu.config import RenderSettings as JSettings
from rayn_tpu.ops import filters as jfilters
from rayn_tpu.render import film as jfilm
from rayn_tpu.render import renderer as jrenderer
from rayn_tpu.scene import presets as jpresets
from rayn_tpu.utils import rng as jrng
from rayn_tpu.utils import spectrum as jspectrum
from rayn_tpu_torch import cli, convert
from rayn_tpu_torch.config import RenderSettings
from rayn_tpu_torch.ops import filters
from rayn_tpu_torch.render import film, renderer
from rayn_tpu_torch.scene import presets
from rayn_tpu_torch.utils import rng, spectrum

# The tensors here are small: one torch thread per test worker avoids
# contending with the other pytest workers for the cores.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# --------------------------------------------------------------- filters
@pytest.mark.parametrize("name", sorted(jfilters.FILTERS))
def test_fis_table_matches_jax(name):
    for radius in (0.5, 1.5, 2.0, 3.0):
        want = np.asarray(jfilters.build_fis_table(
            jfilters.FILTERS[name](radius), 512))
        got = filters.build_fis_table(filters.FILTERS[name](radius), 512,
                                      device="cpu").numpy()
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))
    assert filters.FILTERS[name]().name == jfilters.FILTERS[name]().name


# -------------------------------------------------------------- spectrum
def test_spectrum_matches_jax():
    g = np.random.default_rng(7)
    rgb = g.uniform(-0.5, 2.0, (257, 3)).astype(np.float32)
    rgb[3, 1] = np.nan
    other = g.uniform(0, 1, (257, 3)).astype(np.float32)
    mask = g.uniform(size=257) < 0.5
    t, o, m = (torch.from_numpy(x) for x in (rgb, other, mask))
    pos = np.abs(rgb[4:]) + 0.1
    cases = [
        (spectrum.saturate(t), jspectrum.saturate(rgb)),
        (spectrum.gamma_corrected(t), jspectrum.gamma_corrected(rgb)),
        (spectrum.normalized(torch.from_numpy(pos)),
         jspectrum.normalized(pos)),
        (spectrum.max_channel(t[4:]), jspectrum.max_channel(rgb[4:])),
        (spectrum.merge(m, t, o), jspectrum.merge(mask, rgb, other)),
        (spectrum.is_nan(t), jspectrum.is_nan(rgb)),
    ]
    for got, want in cases:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6, equal_nan=True)


# ------------------------------------------------------------------ film
def _pass_values(g, n):
    f32 = np.float32
    return dict(color=g.uniform(0, 2, (n, 3)).astype(f32),
                alpha=g.uniform(0, 1, n).astype(f32),
                background=g.uniform(0, 1, (n, 3)).astype(f32),
                normal=g.normal(size=(n, 3)).astype(f32),
                count=np.ones(n, f32))


def test_splat_matches_jax_scatter():
    """A pass of 50 rays from flat ray 7 at 3 spp (starting and ending
    inside a pixel) onto a film of random sums, twice."""
    g = np.random.default_rng(3)
    n_px, spp = 30, 3
    base = {c: g.uniform(0, 1, (n_px, 3) if c in ("color", "background",
                                                   "normal") else n_px)
            .astype(np.float32) for c in film.CHANNELS}
    base["samples"] = base["samples"] * 0.0
    jf = jfilm.Film(**{c: jnp.asarray(v) for c, v in base.items()})
    tf = film.Film(**{c: torch.from_numpy(v.copy()) for c, v in base.items()})
    for ray0 in (7, 57):
        vals = _pass_values(g, 50)
        pixel = jnp.asarray((ray0 + np.arange(50)) // spp, jnp.int32)
        jf = jfilm.splat(jf, pixel, **{k: jnp.asarray(v)
                                       for k, v in vals.items()})
        tf = film.splat(tf, ray0, spp=spp, **{k: torch.from_numpy(v)
                                              for k, v in vals.items()})
    for c in film.CHANNELS:
        np.testing.assert_allclose(getattr(tf, c).numpy(),
                                   np.asarray(getattr(jf, c)), rtol=0,
                                   atol=1e-6)


def test_splat_of_an_aligned_pass_is_splat_aligned():
    g = np.random.default_rng(4)
    vals = {k: torch.from_numpy(v) for k, v in _pass_values(g, 48).items()}
    a = film.splat(film.new_film(40, "cpu"), 24, spp=4, **vals)
    b = film.splat_aligned(film.new_film(40, "cpu"), 6, spp=4, **vals)
    for x, y in zip(film.tensors(a), film.tensors(b)):
        assert torch.equal(x, y)


def test_unaligned_passes_render():
    """8x8 at 3 spp in passes of 64 rays (64 % 3 = 1): the same bits on
    two runs, and the 48-ray-pass film at atol 2e-5."""
    data, static, cam = presets.spheres_scene(resolution=(8, 8),
                                              device="cpu")
    s = RenderSettings(resolution=(8, 8), spp=3, max_bounces=1,
                       rays_per_pass=64)
    f1 = renderer.render_frame(data, static, s, cam)
    f2 = renderer.render_frame(data, static, s, cam)
    ref = renderer.render_frame(data, static,
                                dataclasses.replace(s, rays_per_pass=48), cam)
    assert f1.samples.sum().item() == 8 * 8 * 3
    for x, y, r in zip(film.tensors(f1), film.tensors(f2),
                       film.tensors(ref)):
        assert torch.equal(x, y)
        torch.testing.assert_close(x, r, rtol=0, atol=2e-5)
    assert not all(torch.equal(x, r)
                   for x, r in zip(film.tensors(f1), film.tensors(ref)))


def _resolved(g, h=5, w=7):
    f32 = np.float32
    return dict(color=g.uniform(-0.2, 1.4, (h, w, 3)).astype(f32),
                alpha=g.uniform(0, 1, (h, w)).astype(f32),
                background=g.uniform(-0.2, 1.2, (h, w, 3)).astype(f32),
                normal=g.uniform(-1.1, 1.1, (h, w, 3)).astype(f32))


@pytest.mark.parametrize("transparent", [False, True])
def test_save_channels_matches_jax(tmp_path, transparent):
    res = _resolved(np.random.default_rng(5))
    kinds = ("color", "alpha", "normal", "background")
    want = jfilm.save_channels(jfilm.ResolvedFilm(**res), tmp_path / "jax",
                               "f", kinds, transparent_background=transparent)
    got = film.save_channels(film.ResolvedFilm(**res), tmp_path / "port",
                             "f", kinds, transparent_background=transparent)
    assert [p.split("/")[-1] for p in got] == [p.split("/")[-1] for p in want]
    for g_path, w_path in zip(got, want):
        with Image.open(w_path) as wi, Image.open(g_path) as gi:
            assert gi.mode == wi.mode
            w_px, g_px = np.asarray(wi), np.asarray(gi)
        np.testing.assert_array_equal(g_px, w_px)
        np.testing.assert_array_equal(film.read_png(g_path), w_px)


# ------------------------------------------------------------------ rays
def test_generate_rays_with_sample_base_matches_jax():
    res, n = (16, 16), 300
    kw = dict(resolution=res, spp=2, max_bounces=1)
    js, ts = JSettings(**kw), RenderSettings(**kw)
    jcam = jpresets.default_scene(resolution=res)[2]
    tcam = convert.camera(jax.tree.map(np.asarray, jcam), device="cpu")
    jfis = jfilters.build_fis_table(jfilters.mitchell_netravali(2.0), 512)
    tfis = filters.build_fis_table(filters.mitchell_netravali(2.0), 512,
                                   device="cpu")
    t0, t1 = 1 / 24, 2 / 24
    with jax.disable_jit():
        want = jrenderer.generate_rays(
            js, jrng.build_sample_tables(js, frame=1), jcam, jfis,
            jrenderer.ray_indices(jnp.int32(5), n), jnp.float32(t0),
            jnp.float32(t1), sample_base=2)
    tables = rng.build_sample_tables(ts, 1)
    got = renderer.generate_rays(ts, tables, tcam, tfis,
                                 renderer.ray_indices(5, n, "cpu"), t0, t1,
                                 sample_base=2)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-6)
    for g, w in zip(got[3:], want[3:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[4].min().item() == 2 and got[4].max().item() == 3
    # the flat 4-spp render's rays of sample indices 2 and 3
    flat = renderer.generate_rays(
        dataclasses.replace(ts, spp=4), tables, tcam, tfis,
        torch.arange(5, 5 + n) // 2 * 4 + torch.arange(5, 5 + n) % 2 + 2,
        t0, t1)
    for g, f in zip(got, flat):
        assert torch.equal(g, f)


# ------------------------------------------------------------------- CLI
def _options(parser):
    return {s: a for a in parser._actions for s in a.option_strings
            if s not in ("-h", "--help")}


def test_parser_has_every_jax_option():
    want, got = _options(jcli.build_parser()), _options(cli.build_parser())
    assert set(got) == set(want) | {"--device"}
    for opt, a in want.items():
        b = got[opt]
        assert (b.dest, b.default, b.choices, b.nargs, b.type) == (
            a.dest, a.default, a.choices, a.nargs, a.type), opt
    assert cli.build_parser().parse_args([]).device == "cuda"


@pytest.mark.parametrize("argv, flag", [
    (["--no-pallas"], "--no-pallas")])
def test_unported_options_exit_with_their_message(argv, flag, tmp_path):
    """Once refused, --no-pallas now renders, as JAX's CLI does: it sets
    use_pallas=False (rayn_tpu/cli.py:156) and nothing else, and its PNGs
    are byte for byte those of the same render through the Python API."""
    res, spp = (8, 6), 1
    rc = cli.main(argv + ["--device", "cpu", "--width", str(res[0]),
                          "--height", str(res[1]), "--spp", str(spp),
                          "--bounces", "1", "--max-marches", "48",
                          "--out", str(tmp_path / "cli")])
    assert rc == 0 and flag == "--no-pallas"
    data, static, cam = presets.default_scene(resolution=res, device="cpu")
    s = RenderSettings(resolution=res, spp=spp, max_bounces=1,
                       max_marches=48, use_pallas=False)
    f = renderer.render_frame(data, static, s, cam, frame=1)
    names = film.save_channels(film.resolve(f, res), str(tmp_path / "api"),
                               "api")
    for path in names:
        ch = os.path.basename(path)[len("api_"):]
        with open(path, "rb") as a, open(
                tmp_path / "cli" / f"frame0001_{spp}spp_{ch}", "rb") as b:
            assert a.read() == b.read(), ch


@pytest.mark.parametrize("flag", ["--multichip", "--num-processes"])
def test_scale_out_options_render_on_the_cpu(flag, tmp_path, capsys):
    """--multichip on a one-rank mesh (no torchrun); --num-processes 2 as
    process 0 here and process 1 in a second interpreter, each saving
    its share of frames 1-2 (the farm's PNGs against one process's:
    tests/test_torch_distributed.py)."""
    argv = ["--device", "cpu", "--scene", "spheres", "--width", "8",
            "--height", "8", "--spp", "2", "--bounces", "1", "--frames",
            "1", "3", "--out", str(tmp_path / "out")]
    peer = None
    if flag == "--num-processes":
        farm = ["--num-processes", "2", "--coordinator",
                f"file://{tmp_path / 'store'}", "--process-id"]
        peer = subprocess.Popen(
            [sys.executable, "-m", "rayn_tpu_torch", *argv, *farm, "1"],
            env={**os.environ, "PYTHONPATH": REPO},
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        argv += farm + ["0"]
    else:
        argv.append(flag)
    try:
        assert cli.main(argv) == 0
        if peer is not None:
            out, err = peer.communicate(timeout=120)
            assert peer.returncode == 0, err
    finally:
        if peer is not None:
            peer.kill()
            peer.wait()
    names = sorted(p.name for p in (tmp_path / "out").iterdir())
    assert names == sorted(f"frame000{f}_2spp_{c}.png" for f in (1, 2)
                           for c in ("alpha", "normal", "color"))


def test_main_writes_jax_file_names(tmp_path, capsys):
    """A 16x16 spheres frame at 3 spp on the CPU: Mitchell-Netravali of
    radius 2, checkpointed, traced, in passes of 100 rays (not a
    multiple of spp)."""
    out = tmp_path / "out"
    argv = ["--device", "cpu", "--scene", "spheres", "--width", "16",
            "--height", "16", "--spp", "3", "--bounces", "1",
            "--rays-per-pass", "100", "--filter", "mitchell_netravali",
            "--filter-radius", "2", "--channels", "color", "alpha",
            "normal", "background", "--checkpoint", str(tmp_path / "ck.npz"),
            "--trace-dir", str(tmp_path / "trace"), "--advance-group", "4",
            "--out", str(out)]
    assert cli.main(argv) == 0
    err = capsys.readouterr().err
    assert "Frame 1: done in" in err and "Msamples/s" in err
    assert "--advance-group" in err and "768/768 rays (100.0%)" in err
    # JAX's names: its save_channels with the CLI's base name
    res = _resolved(np.random.default_rng(0), 1, 1)
    names = jfilm.save_channels(jfilm.ResolvedFilm(**res), tmp_path / "j",
                                "frame0001_3spp",
                                ("color", "alpha", "normal", "background"))
    assert sorted(p.name for p in out.iterdir()) == sorted(
        p.split("/")[-1] for p in names)
    assert (tmp_path / "ck.npz").exists()
    assert (tmp_path / "trace" / "trace.json").exists()
    # the colour PNG is save_channels of render_frame's film
    data, static, cam = presets.spheres_scene(resolution=(16, 16),
                                              device="cpu")
    s = RenderSettings(resolution=(16, 16), spp=3, max_bounces=1,
                       rays_per_pass=100)
    f = renderer.render_frame(data, static, s, cam, frame=1,
                              filter=filters.mitchell_netravali(2.0))
    ref = film.save_channels(film.resolve(f, (16, 16)), tmp_path / "ref",
                             "ref", ("color",))[0]
    np.testing.assert_array_equal(
        film.read_png(out / "frame0001_3spp_color.png"), film.read_png(ref))


def test_main_without_a_card_raises(monkeypatch, tmp_path):
    """No --device and no card: main raises instead of rendering on the
    CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(["--width", "8", "--height", "8", "--out", str(tmp_path)])
    assert not any(tmp_path.iterdir())
