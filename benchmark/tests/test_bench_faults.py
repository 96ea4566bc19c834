"""A run with the timed path broken underneath comes out not correct:
the harness's own path on the CPU, its look for a card skipped."""

import pytest

from benchmark.tests.helpers import run_cell, tiny_root


def _renderer():
    from rayn_tpu_torch.render import renderer
    return renderer


CELLS = pytest.mark.parametrize("config,like", [
    ("rtiow_spheres", "spheres_final_8spp"),
    ("rayn_default", "default_final_8spp"),
    ("rayn_default", "default_preview_1spp")])


@CELLS
def test_sound_run_is_correct(tmp_path, config, like):
    rc, out = run_cell(tiny_root(tmp_path, config=config, like=like),
                       "tiny_cell")
    assert rc == 0 and out["correct"] is True


@CELLS
def test_pass_that_returns_its_film_unchanged(tmp_path, monkeypatch, config,
                                              like):
    renderer = _renderer()
    monkeypatch.setattr(renderer, "render_pass",
                        lambda film, *a, **k: film)
    rc, out = run_cell(tiny_root(tmp_path, config=config, like=like),
                       "tiny_cell")
    assert rc == 0 and out["correct"] is False


@CELLS
def test_half_of_each_pass_left_out(tmp_path, monkeypatch, config, like):
    """Only the first half of every pass's rays rendered; each pixel's
    mean is taken over the samples that are left."""
    renderer = _renderer()
    real = renderer.render_pass

    def half(film, data, static, settings, tables, camera, fis, start,
             size, *a, **k):
        return real(film, data, static, settings, tables, camera, fis,
                    start, size // 2, *a, **k)

    monkeypatch.setattr(renderer, "render_pass", half)
    rc, out = run_cell(tiny_root(tmp_path, config=config, like=like),
                       "tiny_cell")
    assert rc == 0 and out["correct"] is False


@CELLS
def test_answer_of_another_frame(tmp_path, monkeypatch, config, like):
    """Each frame's image is altered where it is made: the frame number
    the renderer salts its samples with is off by one."""
    renderer = _renderer()
    real = renderer.render_frame
    monkeypatch.setattr(renderer, "render_frame",
                        lambda *a, frame=1, **k: real(*a, frame=frame + 1,
                                                      **k))
    rc, out = run_cell(tiny_root(tmp_path, config=config, like=like),
                       "tiny_cell")
    assert rc == 0 and out["correct"] is False
