"""Checkpoints, progressive spp and retries of rayn_tpu_torch on the CPU:
the cases of tests/test_checkpoint_cli.py (TestCheckpoint, TestResilient)
and tests/test_retry_surface.py, mirrored on the port at 8x8.

A resumed render equals the uninterrupted one bit for bit (the same
passes are added in the same order, and float32 survives the .npz
exactly); a render grown from 2 to 4 spp equals a flat 4-spp render at
the film invariants' atol 2e-5 (only the accumulation order differs).
No JAX here.
"""

import pytest
import torch

from rayn_tpu_torch.config import RenderSettings
from rayn_tpu_torch.ops import filters
from rayn_tpu_torch.render import checkpoint
from rayn_tpu_torch.render import film as film_mod
from rayn_tpu_torch.render import renderer
from rayn_tpu_torch.scene import presets

# The tensors here are small: one torch thread per test worker avoids
# contending with the other pytest workers for the cores.
torch.set_num_threads(1)

RES = (8, 8)
TIME = (0.0, 1.0 / 24.0)


def small(**change):
    """8x8 at 4 spp, 64 rays a pass: 4 passes."""
    kw = dict(resolution=RES, spp=4, max_bounces=1, volume_marches=1,
              max_marches=16, max_vis_marches=8, rays_per_pass=64)
    kw.update(change)
    return RenderSettings(**kw)


def spheres():
    return presets.spheres_scene(resolution=RES, device="cpu")


def assert_films_equal(a, b):
    for x, y in zip(film_mod.tensors(a), film_mod.tensors(b)):
        assert torch.equal(x, y)


def assert_films_close(a, b, atol=2e-5):
    torch.testing.assert_close(a.samples, b.samples, rtol=0, atol=0)
    for x, y in zip(film_mod.tensors(a), film_mod.tensors(b)):
        torch.testing.assert_close(x, y, rtol=0, atol=atol)


@pytest.fixture
def fail_hook(monkeypatch):
    """Install a renderer._FAIL_HOOK for one test."""
    def install(fn):
        monkeypatch.setattr(renderer, "_FAIL_HOOK", fn)
    return install


class TestCheckpoint:
    def test_roundtrip(self, tmp_path):
        s = small()
        f = film_mod.new_film(64, device="cpu")
        f.color.uniform_()
        path = str(tmp_path / "ck.npz")
        checkpoint.save(path, f, s, frame=1, next_pass=3)
        film2, next_pass = checkpoint.load(path, s, frame=1)
        assert next_pass == 3
        assert_films_equal(film2, f)
        assert not (tmp_path / "ck.npz.tmp.npz").exists()

    def test_fingerprint_mismatch_refused(self, tmp_path):
        s = small()
        path = str(tmp_path / "ck.npz")
        checkpoint.save(path, film_mod.new_film(64, device="cpu"), s,
                        frame=1, next_pass=3)
        assert checkpoint.load(path, s, frame=2) is None
        assert checkpoint.load(path, small(spp=8), frame=1) is None
        # spp is progress: load_progress takes it, only load refuses it
        assert checkpoint.load_progress(path, small(spp=8), 1) is not None

    @pytest.mark.parametrize("what", ["scene", "camera", "time_range",
                                      "filter", "setting"])
    def test_scene_camera_filter_or_setting_mismatch_refused(self, tmp_path,
                                                             what):
        """A checkpoint of one render never resumes into another: another
        scene, camera, shutter, filter table or setting (spp aside)."""
        s = small()
        data_a, _, cam_a = spheres()
        data_b, _, cam_b = presets.default_scene(resolution=RES,
                                                 device="cpu")
        fis = filters.build_fis_table(filters.blackman_harris(1.5),
                                      device="cpu")
        key = dict(settings=s, frame=1, scene=data_a, camera=cam_a,
                   fis_table=fis, time_range=TIME)
        path = str(tmp_path / "ck.npz")
        checkpoint.save(path, film_mod.new_film(64, device="cpu"),
                        next_pass=2, **key)
        assert checkpoint.load(path, **key) is not None
        other = {"scene": dict(scene=data_b), "camera": dict(camera=cam_b),
                 "time_range": dict(time_range=(0.0, 2.0 / 24.0)),
                 "filter": dict(fis_table=filters.build_fis_table(
                     filters.box_filter(0.5), device="cpu")),
                 "setting": dict(settings=small(mis=True))}[what]
        assert checkpoint.load(path, **dict(key, **other)) is None

    def test_fingerprint_ignores_strides(self):
        """Tensors are hashed by value, shape and dtype: the same scene
        with a tensor of other strides has the same fingerprint."""
        data, _, cam = spheres()
        mats = data.materials
        strided = mats._replace(color_a=mats.color_a.t().contiguous().t())
        assert strided.color_a.stride() != mats.color_a.stride()
        s = small()
        assert checkpoint._fingerprint(s, 1, data, cam) == \
            checkpoint._fingerprint(s, 1, data._replace(materials=strided),
                                    cam)

    def test_progressive_spp_growth(self, tmp_path):
        """A 2-spp checkpoint grown to 4 spp renders only the missing
        sample indices and gives the flat 4-spp film (atol 2e-5)."""
        data, static, cam = spheres()
        path = str(tmp_path / "ck.npz")
        renderer.render_frame(data, static, small(spp=2), cam, frame=1,
                              checkpoint_path=path, checkpoint_every=1)
        passes = []
        grown = renderer.render_frame(
            data, static, small(), cam, frame=1, checkpoint_path=path,
            checkpoint_every=1,
            progress=lambda done, total: passes.append((done, total)))
        # 256 rays in all; the grow run rendered the extension segment
        # (128 rays, 2 passes of 64) on top of the saved half
        assert passes == [(192, 256), (256, 256)]
        ref = renderer.render_frame(data, static, small(), cam, frame=1)
        assert_films_close(grown, ref)

    def test_progressive_growth_interrupted_midway(self, tmp_path,
                                                   fail_hook):
        """A grow run killed inside the extension segment resumes inside
        it and still gives the flat render."""
        data, static, cam = spheres()
        path = str(tmp_path / "ck.npz")
        renderer.render_frame(data, static, small(spp=2), cam, frame=1,
                              checkpoint_path=path, checkpoint_every=1)
        calls = []

        def bomb(p):
            calls.append(p)
            if len(calls) == 2:
                raise RuntimeError("injected preemption")

        fail_hook(bomb)
        film = renderer.render_frame_resilient(
            data, static, small(), cam, frame=1, retries=1,
            checkpoint_path=path, checkpoint_every=1)
        assert calls == [0, 1, 1]
        ref = renderer.render_frame(data, static, small(), cam, frame=1)
        assert_films_close(film, ref)

    def test_shrunk_spp_returns_richer_film(self, tmp_path):
        """A checkpoint holding more samples than asked for is returned
        as it is."""
        data, static, cam = spheres()
        path = str(tmp_path / "ck.npz")
        ref = renderer.render_frame(data, static, small(), cam, frame=1,
                                    checkpoint_path=path)
        got = renderer.render_frame(data, static, small(spp=2), cam,
                                    frame=1, checkpoint_path=path)
        assert_films_equal(got, ref)

    def test_resume_produces_identical_film(self, tmp_path):
        """Stopped after 2 of 4 passes and resumed: bit for bit."""
        s = small()
        data, static, cam = spheres()
        ref = renderer.render_frame(data, static, s, cam, frame=1)
        path = str(tmp_path / "ck.npz")
        calls = []

        def interrupt(done, total):
            calls.append(done)
            if len(calls) == 2:
                raise KeyboardInterrupt

        with pytest.raises(KeyboardInterrupt):
            renderer.render_frame(data, static, s, cam, frame=1,
                                  checkpoint_path=path, checkpoint_every=1,
                                  progress=interrupt)
        # the checkpoint's fingerprint holds the filter table too
        assert checkpoint.load(path, s, 1, data, cam, time_range=(
            1 / 24, 2 / 24)) is None
        resumed = renderer.render_frame(data, static, s, cam, frame=1,
                                        checkpoint_path=path,
                                        checkpoint_every=1)
        assert_films_equal(resumed, ref)


class TestResilient:
    def test_retry_resumes_from_checkpoint(self, tmp_path, fail_hook):
        """A render killed mid-frame is retried and resumes at the last
        saved pass: the film of an uninterrupted render, bit for bit."""
        s = small()
        data, static, cam = spheres()
        ref = renderer.render_frame(data, static, s, cam, frame=1)
        calls = []

        def bomb(p):
            calls.append(p)
            if len(calls) == 3:   # die after completing pass 2
                raise RuntimeError("injected preemption")

        fail_hook(bomb)
        film = renderer.render_frame_resilient(
            data, static, s, cam, frame=1, retries=1,
            checkpoint_path=str(tmp_path / "ck.npz"), checkpoint_every=1)
        assert calls == [0, 1, 2, 2, 3]   # resumed at the failed pass
        assert_films_equal(film, ref)

    def test_retries_exhausted_reraises(self, fail_hook):
        data, static, cam = spheres()
        calls = []

        def always(p):
            calls.append(p)
            raise RuntimeError("hard failure")

        fail_hook(always)
        with pytest.raises(RuntimeError, match="hard failure"):
            renderer.render_frame_resilient(data, static, small(), cam,
                                            frame=1, retries=2)
        assert calls == [0, 0, 0]


# ------------------------------------ tests/test_retry_surface.py mirrored
def _scene():
    data, static, cam = spheres()
    return data, static, small(spp=1, max_bounces=0), cam


def test_transient_error_is_retried(fail_hook):
    data, static, settings, cam = _scene()
    calls = []

    def hook(p):
        calls.append(p)
        if len(calls) == 1:
            raise RuntimeError("simulated device loss")

    fail_hook(hook)
    film = renderer.render_frame_resilient(data, static, settings, cam,
                                           retries=2, frame=1)
    assert film.samples.sum().item() == 64
    assert len(calls) >= 2   # the first attempt failed, the retry ran


@pytest.mark.parametrize("error", [ValueError, NotImplementedError])
def test_programming_error_not_retried(fail_hook, error):
    """Deterministic errors re-raise at once: ValueError, and the
    NotImplementedError of a setting the port lacks (a RuntimeError
    subclass)."""
    data, static, settings, cam = _scene()
    calls = []

    def hook(p):
        calls.append(p)
        raise error("bad settings")

    fail_hook(hook)
    with pytest.raises(error):
        renderer.render_frame_resilient(data, static, settings, cam,
                                        retries=3, frame=1)
    assert len(calls) == 1
