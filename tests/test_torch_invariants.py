"""The renderer's invariants in the port, on the CPU.

- Chunk-sorted and unsorted films are equal bit for bit: sorting only
  moves lanes, and every per-lane result is position-independent. Pass
  sizes are multiples of 128, so moving 128-lane chunks keeps every
  lane's SIMD alignment in torch's CPU kernels.
- Films at pass sizes 256 and 512 agree to atol 2e-5 (f32 accumulation
  order only).
- A partial last pass adds exactly spp samples to every pixel.
- The kernel wrappers run their plain twins only for CPU tensors.
"""

import numpy as np
import pytest
import torch

from rayn_tpu_torch.config import RenderSettings
from rayn_tpu_torch.ops import intersect_cuda, shade_cuda
from rayn_tpu_torch.render import film, integrator, renderer
from rayn_tpu_torch.scene import presets
from rayn_tpu_torch.utils import rng

# The tensors here are small: one torch thread per test worker avoids
# contending with the other pytest workers for the cores.
torch.set_num_threads(1)


def _render(**kw):
    res = (16, 16)
    data, static, cam = presets.default_scene(resolution=res, device="cpu")
    s = RenderSettings(resolution=res, spp=4, max_marches=48,
                       max_vis_marches=32, **kw)
    return renderer.render_frame(data, static, s, cam, frame=3)


def test_sorted_and_unsorted_films_bit_identical(monkeypatch):
    perms = []
    orig = integrator._chunk_perm

    def spy(key, chunk):
        perm = orig(key, chunk)
        perms.append(perm)
        return perm

    monkeypatch.setattr(integrator, "_chunk_perm", spy)
    a = _render(rays_per_pass=512)
    assert perms, "the sorts never ran"
    assert any(not torch.equal(p, torch.arange(p.numel())) for p in perms), \
        "every sort was the identity: the test would be vacuous"
    b = _render(rays_per_pass=512, sorted_shadow_march=False,
                sorted_intersect=False)
    for x, y in zip(film.tensors(a), film.tensors(b)):
        assert torch.equal(x, y)


def test_pass_size_invariance():
    a = _render(rays_per_pass=256)
    b = _render(rays_per_pass=512)
    for x, y in zip(film.tensors(a), film.tensors(b)):
        torch.testing.assert_close(x, y, rtol=0.0, atol=2e-5)
    assert a.samples.sum().item() == 16 * 16 * 4


def test_tail_pass_and_image_sanity():
    """A pass size that leaves a partial last pass (1024 rays in passes of
    384): every pixel gets spp samples, colours are finite, alpha > 0."""
    f = _render(rays_per_pass=384)
    np.testing.assert_array_equal(f.samples.numpy(), 4.0)
    img = film.resolve(f, (16, 16))
    assert np.isfinite(img.color).all() and img.alpha.max() > 0.0


def test_wrappers_reject_other_devices():
    """A wrapper runs its plain twin only for CPU tensors; anything else
    that is not CUDA is refused, never moved to the CPU."""
    res = (8, 8)
    data, static, _cam = presets.default_scene(resolution=res, device="cpu")
    s = RenderSettings(resolution=res, spp=1)
    z3 = torch.zeros((4, 3), device="meta")
    z = torch.zeros((4,), device="meta")
    with pytest.raises(ValueError):
        intersect_cuda.closest_hit_shading(data, static, s, z3, z3, z, z,
                                           z.bool())
    cfg = shade_cuda.shadow_cfg(data, static, s, rng.SampleTables(1), 0)
    tabs = shade_cuda.scene_tables(data, static)
    with pytest.raises(ValueError):
        shade_cuda.shadow_sort_key(cfg, tabs, z3, z3, z, z3, z3, z,
                                   z.bool(), z.bool(), z.int(), z.int())
    state = integrator.PathState(*(z3,) * len(integrator.PathState._fields))
    for wrapper, tail in ((shade_cuda.bounce_tail, (None, z)),
                          (shade_cuda.finish_bounce, (None, z3))):
        with pytest.raises(ValueError):
            wrapper(cfg, tabs, state, None, None, None, z, z, *tail)
    with pytest.raises(ValueError):
        shade_cuda.shadow_radiance(cfg, tabs, state, None, None, z, z, z,
                                   z)
