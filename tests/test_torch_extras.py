"""The three per-lane extras together on the CPU: extra AOVs, an albedo
function on the default scene's MandelBox and compaction, in one 16x16
frame (no JAX).

- The film invariants hold with all three: pass sizes 2^8 and 2^7 agree
  to atol 2e-5 (fused and relaxed), and sorted and unsorted films are
  the same bits.
- The albedo AOV is the albedo function's value at each lane's position
  and normal (the position AOV and the depth-0 normal) wherever the lane
  shaded the MandelBox, after compaction moved the lanes.
- render_frame_resilient with a failure injected after a pass resumes
  from the checkpoint to the uninterrupted film, extras included.
"""

import dataclasses

import pytest
import torch

from rayn_tpu_torch.config import RenderSettings
from rayn_tpu_torch.ops import filters
from rayn_tpu_torch.render import film, integrator, renderer
from rayn_tpu_torch.scene import presets
from rayn_tpu_torch.utils import rng

torch.set_num_threads(1)

RES = (16, 16)
AOVS = ("depth", "position", "albedo", "mat_id")


def albedo(p, n):
    return torch.stack([0.5 + 0.4 * torch.sin(3.0 * p[:, 0]),
                        0.5 + 0.4 * torch.sin(3.0 * p[:, 1] + 1.0),
                        0.4 + 0.3 * n[:, 2]], dim=-1)


def scene():
    data, static, cam = presets.default_scene(resolution=RES, device="cpu")
    return data, dataclasses.replace(
        static, mat_param_fns=((static.sdf_mat, albedo),)), cam


def settings(**change):
    kw = dict(resolution=RES, spp=4, max_bounces=3, max_marches=24,
              max_vis_marches=16, rays_per_pass=1 << 8, extra_aovs=AOVS,
              compact_bounces=True)
    return RenderSettings(**{**kw, **change})


@pytest.mark.parametrize("change", [{}, dict(march_relaxation=1.5)])
def test_invariants_with_every_extra(change):
    data, static, cam = scene()
    a = renderer.render_frame(data, static, settings(**change), cam)
    b = renderer.render_frame(data, static, settings(
        **change, rays_per_pass=1 << 7), cam)
    c = renderer.render_frame(data, static, settings(
        **change, sorted_intersect=False, sorted_shadow_march=False), cam)
    assert len(a.extra) == 4
    assert a.samples.sum().item() == RES[0] * RES[1] * 4
    for x, y, z in zip(film.tensors(a), film.tensors(b), film.tensors(c)):
        torch.testing.assert_close(x, y, rtol=0.0, atol=2e-5)
        assert torch.equal(x, z)


def test_albedo_aov_is_the_function_at_each_lane():
    data, static, cam = scene()
    s = settings()
    n = s.rays_per_pass
    tables = rng.build_sample_tables(s, 1)
    fis = filters.build_fis_table(filters.blackman_harris(1.5), 512,
                                  device="cpu")
    o, d, t, px, si, ok = renderer.generate_rays(
        s, tables, cam, fis, renderer.ray_indices(0, n, "cpu"), 1 / 24,
        2 / 24)
    ha, hl = cam.half_pixel_size_coeffs()
    state, aovs = integrator.trace(data, static, s, tables,
                                   integrator.init_state(o, d, t, px, si, ok),
                                   ha, hl)
    depth, position, alb, mat_id = aovs
    assert torch.equal(state.pixel, px) and torch.equal(state.sample_idx, si)
    sdf = mat_id == static.sdf_mat
    assert 10 < int(sdf.sum()) < n
    torch.testing.assert_close(alb[sdf],
                               albedo(position, state.normal_out)[sdf],
                               rtol=0.0, atol=1e-6)
    recv = state.alpha_out > 0
    assert torch.equal(recv, depth > 0)
    assert not bool(alb[~recv].any()) and not bool(position[~recv].any())
    table = data.materials.color_a[static.sdf_mat]
    assert not bool((alb[sdf] == table).all(-1).any())


def test_resilient_render_keeps_every_extra(tmp_path, monkeypatch):
    data, static, cam = scene()
    s = settings()
    ref = renderer.render_frame(data, static, s, cam)
    failed = []

    def fail_once(p):
        if p == 2 and not failed:
            failed.append(p)
            raise RuntimeError("injected")

    monkeypatch.setattr(renderer, "_FAIL_HOOK", fail_once)
    got = renderer.render_frame_resilient(
        data, static, s, cam, retries=1, checkpoint_every=2,
        checkpoint_path=str(tmp_path / "ck.npz"))
    assert failed == [2] and len(got.extra) == 4
    for x, y in zip(film.tensors(got), film.tensors(ref)):
        assert torch.equal(x, y)
