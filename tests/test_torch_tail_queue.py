"""The shadow half of the port's bounce tail as three pieces, on the CPU.

`bounce_tail` and `shadow_radiance` run three kernels: the segments
kernel builds every shadow segment and queues the active ones, the march
kernel marches the queue, the sum kernel adds k * visible in segment
order. Their plain twins, composed, must equal the one-piece twins
(`bounce_tail_plain`, `shadow_radiance_plain`) bit for bit on 2^10 lanes
of the default scene's camera wavefront, with MIS off and on; the march
must not depend on the order of its queue; `occlusion_steps` must count
the DEs the plain occlusion march takes. No JAX here: the one-piece
twins are held to JAX in test_torch_shade.py and test_torch_split_tail.py.
"""

import numpy as np
import pytest
import torch

from rayn_tpu_torch.config import RenderSettings
from rayn_tpu_torch.ops import filters, intersect_cuda
from rayn_tpu_torch.ops import march as march_ops
from rayn_tpu_torch.ops import shade_cuda
from rayn_tpu_torch.render import integrator, renderer
from rayn_tpu_torch.scene import presets
from rayn_tpu_torch.utils import rng

# The tensors here are small: one torch thread per test worker avoids
# contending with the other pytest workers for the cores.
torch.set_num_threads(1)

RES = (32, 32)
N = 1 << 10


@pytest.fixture(scope="module")
def wavefront():
    """(data, static, hit, info, state) of the default scene's camera
    rays: 32x32 at 1 spp."""
    s = RenderSettings(resolution=RES, spp=1, max_marches=64,
                       rays_per_pass=N)
    data, static, cam = presets.default_scene(resolution=RES, device="cpu")
    tables = rng.build_sample_tables(s, 1)
    fis = filters.build_fis_table(filters.blackman_harris(1.5), 512,
                                  device="cpu")
    o, d, tm, px, si, ok = renderer.generate_rays(
        s, tables, cam, fis, renderer.ray_indices(0, N, "cpu"), 1 / 24,
        2 / 24)
    state = integrator.init_state(o, d, tm, px, si, ok)
    ha, hl = cam.half_pixel_size_coeffs()
    hit, info = intersect_cuda.closest_hit_shading_plain(
        data, static, s, state.origin, state.direction,
        torch.full((N,), ha), torch.full((N,), hl), state.alive)
    return data, static, hit, info, state


def _tail_args(wavefront, mis):
    """bounce_tail's arguments at depth 0, max_vis_marches 48."""
    data, static, hit, info, state = wavefront
    s = RenderSettings(resolution=RES, spp=1, max_vis_marches=48,
                       rays_per_pass=N, mis=mis)
    tables = rng.build_sample_tables(s, 1)
    live, mat, recv, vtr = integrator._derive_shading(data, static, state,
                                                      hit, info)
    cfg = shade_cuda.shadow_cfg(data, static, s, tables, 0)
    tabs = shade_cuda.scene_tables(data, static)
    return (cfg, tabs, state, hit, info, mat, live, recv, vtr, hit.t)


def _same_bits(got, want):
    """Equal bit for bit (NaNs of any payload count as equal)."""
    if got.dtype == torch.bool:
        return torch.equal(got, want)
    return bool(((got.view(torch.int32) == want.view(torch.int32))
                 | (torch.isnan(got) & torch.isnan(want))).all())


@pytest.mark.parametrize("mis", [False, True])
def test_composed_twins_match_one_piece_twins(wavefront, mis):
    args = _tail_args(wavefront, mis)
    cfg, tabs, state, hit, info, mat, live, recv, vtr, t_hit = args
    shadow_args = (cfg, tabs, state, info, mat, live, recv, vtr, t_hit)
    segs = shade_cuda.shadow_segments_plain(*shadow_args)
    S = cfg.L + cfg.VM * cfg.L
    assert S == 12 and segs.geom.shape == (6, S, N)
    count = int(segs.count[0])
    assert count == int(segs.active.sum()) > 0
    assert torch.equal(segs.queue[:count].long(),
                       torch.nonzero(segs.active.reshape(-1)).squeeze(1))
    verdict = shade_cuda.shadow_march_plain(cfg, segs)
    assert verdict.any() and not (verdict & ~segs.active).any()
    delta = shade_cuda.shadow_sum_plain(segs, verdict)
    want = shade_cuda.shadow_radiance_plain(*shadow_args)
    assert (want > 0.0).any() and _same_bits(delta, want)
    got = shade_cuda.tail_sum_plain(cfg, tabs, state, hit, info, mat, live,
                                    recv, vtr, segs, verdict)
    want_tail = shade_cuda.bounce_tail_plain(*args)
    assert all(_same_bits(got[f], want_tail[f]) for f in want_tail)
    # the functions take the twins of their three kernels on the CPU
    assert _same_bits(shade_cuda.shadow_radiance(*shadow_args), want)
    fn = shade_cuda.bounce_tail(*args)
    assert all(_same_bits(fn[f], want_tail[f]) for f in want_tail)


def test_permuted_queue_gives_same_verdicts(wavefront):
    cfg, tabs, state, _hit, info, mat, live, recv, vtr, t_hit = _tail_args(
        wavefront, True)
    segs = shade_cuda.shadow_segments_plain(cfg, tabs, state, info, mat,
                                            live, recv, vtr, t_hit)
    count = int(segs.count[0])
    perm = torch.from_numpy(np.random.default_rng(3).permutation(count))
    queue = segs.queue.clone()
    queue[:count] = segs.queue[:count][perm]
    want = shade_cuda.shadow_march_plain(cfg, segs)
    got = shade_cuda.shadow_march_plain(cfg, segs._replace(queue=queue))
    assert want.any() and torch.equal(got, want)


def test_occlusion_steps_counts_the_march_des():
    """Sum of occlusion_steps = the DEs march_occlusion evaluates on the
    same 384 seeded segments (clipped; some inactive, some of zero
    length)."""
    data, _static, _cam = presets.default_scene(resolution=(8, 8),
                                                device="cpu")
    g = np.random.default_rng(11)
    n = 384
    start = g.uniform(-3.0, 3.0, (n, 3)).astype(np.float32)
    d = g.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    end = start + d * g.uniform(0.2, 6.0, (n, 1)).astype(np.float32)
    end[:8] = start[:8]
    act = g.uniform(size=n) > 0.25
    start, end, act = map(torch.from_numpy, (start, end, act))
    args = (data.sdf_params, start, end, 0.5, 40, act, 3.6)
    n_de = [0]
    orig = march_ops.dist_c

    def counting(mb, x, y, z):
        n_de[0] += x.numel()
        return orig(mb, x, y, z)

    march_ops.dist_c = counting
    try:
        occ = march_ops.march_occlusion(*args)
    finally:
        march_ops.dist_c = orig
    steps = march_ops.occlusion_steps(*args)
    assert steps.dtype == torch.int32 and occ.any()
    assert int(steps.sum()) == n_de[0]
    assert bool((steps[~act] == 0).all()) and bool((steps[act] >= 1).all())
    assert int(steps.max()) == 41    # the first DE and max_steps steps


def test_segment_wrappers_reject_other_devices():
    """Like every wrapper, the three kernels' wrappers refuse tensors that
    are neither on the CPU nor on a CUDA device."""
    data, static, _cam = presets.default_scene(resolution=(8, 8),
                                               device="cpu")
    cfg = shade_cuda.shadow_cfg(data, static, RenderSettings(
        resolution=(8, 8), spp=1), rng.SampleTables(1), 0)
    tabs = shade_cuda.scene_tables(data, static)
    z3 = torch.zeros((4, 3), device="meta")
    z = torch.zeros((4,), device="meta")
    state = integrator.PathState(*(z3,) * len(integrator.PathState._fields))
    segs = shade_cuda.ShadowSegments(
        torch.zeros((6, 12, 4), device="meta"),
        torch.zeros((3, 12, 4), device="meta"),
        torch.zeros((12, 4), dtype=torch.bool, device="meta"),
        torch.zeros((48,), dtype=torch.int32, device="meta"),
        torch.zeros((1,), dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError):
        shade_cuda.shadow_segments(cfg, tabs, state, None, None, z, z, z,
                                   z)
    with pytest.raises(ValueError):
        shade_cuda.shadow_march(cfg, segs)
    with pytest.raises(ValueError):
        shade_cuda.shadow_sum(segs, segs.active)
    with pytest.raises(ValueError):
        shade_cuda.tail_sum(cfg, tabs, state, None, None, None, z, z, z,
                            segs, segs.active)
