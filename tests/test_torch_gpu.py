"""Each CUDA kernel of rayn_tpu_torch against its plain twin, on the card.

Run on a machine with an NVIDIA GPU (sm_90a) and nvcc:

    python -m pytest tests/test_torch_gpu.py -m gpu -q

Without CUDA the `cuda` fixture skips every test here. The inputs are
the real kernel inputs of the default scene at 2^14 rays (128x128 at
1 spp), depths 0 and 1, with MIS off and on for the tail kernels; the
gates are the JAX package's fused-vs-unfused gates
(tests/test_fused_intersect.py:52-68, test_fused_shadows.py:69-95),
except for the shadow kernels (segments, march, the two sums) and the
functions on them (`bounce_tail`, `shadow_radiance`), which equal their
plain twins bit for bit, also on adversarial segments and on a scene
with no medium and one NEE sample; the segments kernels also on ragged
batches and with 24 sites a ray, and their volume sites (the
equi-angular samples they draw from t_hit) under both samplers.
The occlusion functions (the enqueue kernel, then the refill march on
[M, 3] segments) take 12 x 2^14 seeded random segments and equal their
one-piece twins bit for bit, plain and relaxed, with and without the
clip, also on adversarial segments (zero length, NaN start, an empty
queue, a queue of one, relaxed steps that overshoot past the end). The
segment queue's kernels (queue segments, the refill march on the
scratch at relax 1 and 1.5, queue sum) equal their twins bit for bit,
and the segment-queue tail the same tail on the twins. The march
kernel (the refill march over the wavefront, plain and relaxed) equals
its twin bit for bit at depths 0 and 1 and on adversarial batches (no
ray, fewer than a warp, a ragged count, none active, NaN entry DEs,
entry DEs past t_max). The two-phase marches (one launch of the march
kernel, no argsort) equal their one-piece plain versions and the march
kernel at splits 0, 8 and 32. The
two-phase occlusion functions (the enqueue kernel and the refill march,
nothing else) equal their one-piece plain versions at splits 0, 8 and
16, on random segments and on segments that start on the fractal, and
march_occlusion with no clip at splits 8 and 16; on the segment queue
their settings launch the scratch's refill march and nothing else.
Animated scenes (`default_scene(animated_geo=True)` at 8 and 64 knots,
rays over [0, 2] s): the `_anim_kernel` instantiations of the closest
hit, the cost key, the sort key, both segments kernels, the tail sum and
the finish equal their twins as on the constant scene (the finish to
the same gates), and give other results than the same kernels at time
0, which reads knot 0; the animated camera, the thin lens and the
orthographic camera render through the kernels.
SDF programs (PROGRAM_SCENES: the default scene with a second, program
instance, and a scene whose first instance uses every opcode): every
kernel that reads the SDF runs its Tape instantiation and equals its
twin bit for bit, and the default scene's MandelBox run as a one-op tape
gives the MBoxOnly kernels' bits. With a second instance deeper than
the Tape kernels' stacks ("deep", and "deep_animated" with animated
lights and spheres) every such kernel runs its DeepTape instantiation,
and equals its twin bit for bit too.
The route without kernels (`use_pallas=False`, `use_pallas_occlusion=
False`) and a scene with a user-written closure give the films of the
kernel routes they stand beside, bit for bit.
A kernel whose tensors are on cuda:1 while cuda:0 is current runs on
cuda:1 (needs two cards; skipped on one).
"""

import dataclasses

import numpy as np
import pytest
import torch

from rayn_tpu_torch import _build
from rayn_tpu_torch.config import RenderSettings
from rayn_tpu_torch.ops import filters, intersect_cuda, march_cuda, shade_cuda
from rayn_tpu_torch.ops import march as march_ops
from rayn_tpu_torch.ops import sdf as sdf_ops
from rayn_tpu_torch.render import camera as camera_mod
from rayn_tpu_torch.render import film as film_mod
from rayn_tpu_torch.render import integrator, renderer
from rayn_tpu_torch.scene import presets
from rayn_tpu_torch.scene.animation import AnimChannel
from rayn_tpu_torch.scene.scene import SceneBuilder
from rayn_tpu_torch.utils import rng

pytestmark = pytest.mark.gpu

RES = (128, 128)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _wavefront(dev, depth, mis=False, volume=True, nee=4, knots=0,
               scene=None):
    """(scene, settings, tables, state, hps) of the default scene's
    wavefront at `depth` (depth 1 = the bounce rays of a plain depth-0
    bounce); with `knots`, of the scene with animated lights and spheres
    (`animated_geo`) at that many knots, its rays over [0, 2] s; with
    `scene`, of the scene of PROGRAM_SCENES of that name."""
    s = RenderSettings(resolution=RES, spp=1, max_marches=128,
                       max_vis_marches=64, rays_per_pass=RES[0] * RES[1],
                       mis=mis, nee_light_samples=nee)
    if scene is not None:
        data, static, cam = PROGRAM_SCENES[scene](dev)
    else:
        data, static, cam = presets.default_scene(
            resolution=RES, device=dev, volume=volume,
            animated_geo=knots > 0, geo_knots=max(knots, 1))
    tables = rng.build_sample_tables(s, 1)
    fis = filters.build_fis_table(filters.blackman_harris(1.5), 512,
                                  device=dev)
    n = RES[0] * RES[1]
    o, d, tm, px, si, ok = renderer.generate_rays(
        s, tables, cam, fis, renderer.ray_indices(0, n, dev),
        *((0.0, 2.0) if knots else (1 / 24, 2 / 24)))
    state = integrator.init_state(o, d, tm, px, si, ok)
    ha, hl = cam.half_pixel_size_coeffs()
    if depth == 1:
        hit, info = intersect_cuda.closest_hit_shading_plain(
            data, static, s, state.origin, state.direction,
            torch.full((n,), ha, device=dev), torch.full((n,), hl, device=dev),
            state.alive, state.time)
        live, mat, recv, vtr = integrator._derive_shading(data, static,
                                                          state, hit, info)
        cfg = shade_cuda.shadow_cfg(data, static, s, tables, 0)
        tabs = shade_cuda.scene_tables(data, static)
        out = shade_cuda.bounce_tail_plain(cfg, tabs, state, hit, info, mat,
                                           live, recv, vtr, hit.t)
        state = state._replace(**out)
        ha, hl = 0.0, 2e-4
    hps = (torch.full((n,), ha, device=dev), torch.full((n,), hl, device=dev))
    return data, static, s, tables, state, hps


def _hit(data, static, s, state, hps, fn):
    return fn(data, static, s, state.origin, state.direction, *hps,
              state.alive, state.time)


def _hits_equal(got, want):
    """Every column of (Hit, ShadingInfo) equal bit for bit."""
    (gh, gi), (wh, wi) = got, want
    return (all(_same_bits(g, w) for g, w in zip(gh, wh))
            and all(_same_bits(g, w) for g, w in zip(gi, wi)))


@pytest.mark.parametrize("case", ["camera", "bounce", "half inactive",
                                  "no steps"])
def test_closest_hit_kernel_matches_plain(cuda, case):
    """The refill closest hit equals its twin bit for bit in all six
    columns; its warps take at least the ideal Σ DEs / 32 loop steps."""
    data, static, s, _t, state, hps = _wavefront(
        cuda, 1 if case == "bounce" else 0)
    if case == "half inactive":
        state = state._replace(alive=state.alive & (torch.arange(
            state.alive.shape[0], device=cuda) % 3 != 0))
    if case == "no steps":
        s = dataclasses.replace(s, max_marches=0)
    before = intersect_cuda.closest_hit_shading.launches
    steps = torch.zeros((1,), dtype=torch.int64, device=cuda)
    got = intersect_cuda.closest_hit_shading(
        data, static, s, state.origin, state.direction, *hps, state.alive,
        warp_steps=steps)
    want = _hit(data, static, s, state, hps,
                intersect_cuda.closest_hit_shading_plain)
    torch.cuda.synchronize()
    assert intersect_cuda.closest_hit_shading.launches == before + 1
    assert _hits_equal(got, want)
    detail = s.sdf_detail_scale
    t_max, _obj = intersect_cuda.sphere_fold(data, static, s, state.origin,
                                             state.direction)
    n_de = march_ops.march_steps(
        data.sdf_params, state.origin, state.direction, t_max,
        5e-5 * detail, 0.05 * detail * hps[0], 0.05 * detail * hps[1],
        s.max_marches, state.alive)
    assert int(steps[0]) >= int(n_de.sum()) / 32


def test_closest_hit_kernel_without_sdf_takes_no_de(cuda):
    """Spheres only: every ray is written when it is taken, with no DE."""
    s = RenderSettings(resolution=RES, spp=1, rays_per_pass=RES[0] * RES[1])
    data, static, cam = presets.spheres_scene(resolution=RES, device=cuda)
    n = RES[0] * RES[1]
    tables = rng.build_sample_tables(s, 1)
    fis = filters.build_fis_table(filters.blackman_harris(1.5), 512,
                                  device=cuda)
    o, d, _tm, _px, _si, ok = renderer.generate_rays(
        s, tables, cam, fis, renderer.ray_indices(0, n, cuda), 1 / 24, 2 / 24)
    hps = (torch.zeros((n,), device=cuda), torch.zeros((n,), device=cuda))
    steps = torch.zeros((1,), dtype=torch.int64, device=cuda)
    got = intersect_cuda.closest_hit_shading(data, static, s, o, d, *hps, ok,
                                             warp_steps=steps)
    want = intersect_cuda.closest_hit_shading_plain(data, static, s, o, d,
                                                    *hps, ok)
    torch.cuda.synchronize()
    assert _hits_equal(got, want) and int(steps[0]) == 0


def test_cost_key_kernel_matches_plain(cuda):
    data, static, s, _t, state, _hps = _wavefront(cuda, 1)
    args = (data, static, s, state.origin, state.direction, state.time,
            state.alive)
    before = intersect_cuda.intersect_cost_key.launches
    got = intersect_cuda.intersect_cost_key(*args)
    want = intersect_cuda.intersect_cost_key_plain(*args)
    torch.cuda.synchronize()
    assert intersect_cuda.intersect_cost_key.launches == before + 1
    assert _same_bits(got, want) and bool((want > 1.0).any())


def test_kernel_launches_on_the_card_of_its_tensors(cuda):
    """`_build.launch` enters the device of the kernel's tensors: the
    closest hit with its inputs on cuda:1 while cuda:0 is the current
    device runs there and equals its twin bit for bit. A machine with one
    card skips it."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices (inputs on cuda:1 while "
                    "cuda:0 is current)")
    other = torch.device("cuda", 1)
    data, static, s, _t, state, hps = _wavefront(other, 1)
    with torch.cuda.device(0):
        got = _hit(data, static, s, state, hps,
                   intersect_cuda.closest_hit_shading)
        assert torch.cuda.current_device() == 0
    want = _hit(data, static, s, state, hps,
                intersect_cuda.closest_hit_shading_plain)
    torch.cuda.synchronize(other)
    assert got[0].t.device == other
    assert _hits_equal(got, want)


@pytest.mark.parametrize("sampler", ["rd", "hash"])
@pytest.mark.parametrize("depth", [0, 1])
def test_equi_angular_sites_match_plain(cuda, depth, sampler):
    """Both segments kernels draw their volume sites' equi-angular
    samples from t_hit: their volume segments (start at the scatter
    point, k through the pdf) equal the twins', drawn with
    equi_angular_plain, bit for bit under either sampler."""
    cfg, tabs, state, _hit_, info, mat, live, recv, vtr, t_hit = (
        _tail_inputs(cuda, depth))
    cfg = cfg._replace(sampler=sampler)
    args = (cfg, tabs, state, info, mat, live, recv, vtr, t_hit)
    for fn in (shade_cuda.shadow_segments, shade_cuda.queue_segments):
        before = fn.launches
        got = fn(*args)
        _launched(fn, before)
        want = getattr(shade_cuda, fn.__name__ + "_plain")(*args)
        assert cfg.VM * cfg.L > 0 and want.active[cfg.L:].any()
        assert _same_segments(got, want)


@pytest.mark.parametrize("nee", [4, 8])
@pytest.mark.parametrize("n", [0, 17, 1189])
def test_segments_kernels_on_ragged_batches(cuda, n, nee):
    """No ray, fewer rays than a warp, a count that is not a multiple of
    32; with 8 NEE samples S = 24 sites (twice the staged ids a warp):
    both segments kernels equal their twins bit for bit."""
    cfg, tabs, state, _hit_, info, mat, live, recv, vtr, t_hit = (
        _tail_inputs(cuda, 1, True, nee=nee))
    assert cfg.L + cfg.VM * cfg.L == 3 * nee

    def cut(x):
        return type(x)(*(t[:n] for t in x))

    args = (cfg, tabs, cut(state), cut(info), cut(mat), live[:n], recv[:n],
            vtr[:n], t_hit[:n])
    for fn in (shade_cuda.shadow_segments, shade_cuda.queue_segments):
        got = fn(*args)
        want = getattr(shade_cuda, fn.__name__ + "_plain")(*args)
        torch.cuda.synchronize()
        assert got.geom.shape == (6, 3 * nee, n)
        assert _same_segments(got, want)
        assert n == 0 or int(want.count[0]) > 0


def _tail_inputs(cuda, depth, mis=False, **scene):
    data, static, s, tables, state, hps = _wavefront(cuda, depth, mis,
                                                     **scene)
    hit, info = _hit(data, static, s, state, hps,
                     intersect_cuda.closest_hit_shading_plain)
    live, mat, recv, vtr = integrator._derive_shading(data, static, state,
                                                      hit, info)
    cfg = shade_cuda.shadow_cfg(data, static, s, tables, depth)
    tabs = shade_cuda.scene_tables(data, static)
    return cfg, tabs, state, hit, info, mat, live, recv, vtr, hit.t


def _check_radiance(got, want):
    close = torch.isclose(got, want, rtol=2e-4, atol=2e-5)
    assert close.float().mean().item() >= 0.985
    assert (got - want).abs().max().item() < 0.1


def _check_state(got, want, depth):
    _check_radiance(got["radiance"], want["radiance"])
    tfrac = 1.0 - torch.isclose(got["throughput"], want["throughput"],
                                rtol=1e-4, atol=1e-5).float().mean().item()
    assert tfrac < (1e-3 if depth == 0 else 3e-2)
    afrac = (got["alive"] != want["alive"]).float().mean().item()
    assert afrac < (1e-3 if depth == 0 else 1e-2)


def _same_bits(got, want):
    """Equal bit for bit (NaNs of any payload count as equal)."""
    if got.dtype == torch.bool:
        return torch.equal(got, want)
    return bool(((got.view(torch.int32) == want.view(torch.int32))
                 | (torch.isnan(got) & torch.isnan(want))).all())


def _launched(fn, before):
    torch.cuda.synchronize()
    assert fn.launches == before + 1


_SEGMENT_KERNELS = (shade_cuda.shadow_segments, shade_cuda.shadow_march)


def _launches(*fns):
    return [fn.launches for fn in fns]


def _bounce_tail_vs_plain(args):
    fns = (*_SEGMENT_KERNELS, shade_cuda.tail_sum)
    before = _launches(*fns)
    got = shade_cuda.bounce_tail(*args)
    want = shade_cuda.bounce_tail_plain(*args)
    torch.cuda.synchronize()
    assert _launches(*fns) == [n + 1 for n in before]
    assert want["radiance"].abs().max().item() > 0.0
    assert all(_same_bits(got[f], want[f]) for f in want)


def _shadow_radiance_vs_plain(args):
    cfg, tabs, state, _hit_, info, mat, live, recv, vtr, t_hit = args
    args = (cfg, tabs, state, info, mat, live, recv, vtr, t_hit)
    fns = (*_SEGMENT_KERNELS, shade_cuda.shadow_sum)
    before = _launches(*fns)
    got = shade_cuda.shadow_radiance(*args)
    want = shade_cuda.shadow_radiance_plain(*args)
    torch.cuda.synchronize()
    assert _launches(*fns) == [n + 1 for n in before]
    assert want.abs().max().item() > 0.0
    assert _same_bits(got, want)


@pytest.mark.parametrize("depth", [0, 1])
def test_bounce_tail_kernel_matches_plain(cuda, depth):
    _bounce_tail_vs_plain(_tail_inputs(cuda, depth))


@pytest.mark.parametrize("depth", [0, 1])
def test_bounce_tail_kernel_with_mis_matches_plain(cuda, depth):
    _bounce_tail_vs_plain(_tail_inputs(cuda, depth, True))


@pytest.mark.parametrize("mis", [False, True])
@pytest.mark.parametrize("depth", [0, 1])
def test_shadow_radiance_kernel_matches_plain(cuda, depth, mis):
    _shadow_radiance_vs_plain(_tail_inputs(cuda, depth, mis))


def _same_segments(got, want):
    """Two ShadowSegments hold the same segments and queue the same ids
    (in any order)."""
    count = int(want.count[0])
    return (all(_same_bits(getattr(got, f), getattr(want, f))
                for f in ("geom", "k", "active", "count"))
            and torch.equal(got.queue[:count].sort().values,
                            want.queue[:count].sort().values))


@pytest.mark.parametrize("mis", [False, True])
@pytest.mark.parametrize("depth", [0, 1])
def test_shadow_segments_kernel_matches_plain(cuda, depth, mis):
    cfg, tabs, state, _hit_, info, mat, live, recv, vtr, t_hit = (
        _tail_inputs(cuda, depth, mis))
    args = (cfg, tabs, state, info, mat, live, recv, vtr, t_hit)
    before = shade_cuda.shadow_segments.launches
    got = shade_cuda.shadow_segments(*args)
    _launched(shade_cuda.shadow_segments, before)
    want = shade_cuda.shadow_segments_plain(*args)
    assert int(want.count[0]) > 0 and _same_segments(got, want)


@pytest.mark.parametrize("mis", [False, True])
@pytest.mark.parametrize("depth", [0, 1])
def test_shadow_march_kernel_matches_plain(cuda, depth, mis):
    cfg, tabs, state, _hit_, info, mat, live, recv, vtr, t_hit = (
        _tail_inputs(cuda, depth, mis))
    segs = shade_cuda.shadow_segments_plain(cfg, tabs, state, info, mat,
                                            live, recv, vtr, t_hit)
    before = shade_cuda.shadow_march.launches
    got = shade_cuda.shadow_march(cfg, segs)
    _launched(shade_cuda.shadow_march, before)
    want = shade_cuda.shadow_march_plain(cfg, segs)
    assert want.any() and _same_bits(got, want)


@pytest.mark.parametrize("mis", [False, True])
@pytest.mark.parametrize("depth", [0, 1])
def test_shadow_sum_kernels_match_plain(cuda, depth, mis):
    cfg, tabs, state, hit, info, mat, live, recv, vtr, t_hit = (
        _tail_inputs(cuda, depth, mis))
    segs = shade_cuda.shadow_segments_plain(cfg, tabs, state, info, mat,
                                            live, recv, vtr, t_hit)
    verdict = shade_cuda.shadow_march_plain(cfg, segs)
    before = shade_cuda.shadow_sum.launches
    got = shade_cuda.shadow_sum(segs, verdict)
    _launched(shade_cuda.shadow_sum, before)
    assert _same_bits(got, shade_cuda.shadow_sum_plain(segs, verdict))
    tail = (cfg, tabs, state, hit, info, mat, live, recv, vtr, segs, verdict)
    before = shade_cuda.tail_sum.launches
    got = shade_cuda.tail_sum(*tail)
    _launched(shade_cuda.tail_sum, before)
    want = shade_cuda.tail_sum_plain(*tail)
    assert all(_same_bits(got[f], want[f]) for f in want)


def _adversarial_segments(dev, queue):
    """A scratch of 2 x 4096 segments: seeded random ones, ones of zero
    length (rays 0-63) and ones that start at NaN (rays 64-127), about
    half of them active; rays 128-191 have none. queue: "shuffled" queues
    every active segment in a seeded random order, "three" only the
    first three, so that most warps find no work."""
    g = np.random.default_rng(5)
    S, n = 2, 4096
    start = g.uniform(-3.0, 3.0, (S, n, 3)).astype(np.float32)
    d = g.normal(size=(S, n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    end = start + d * g.uniform(0.2, 6.0, (S, n, 1)).astype(np.float32)
    end[:, :64] = start[:, :64]
    start[:, 64:128, 0] = np.nan
    act = g.uniform(size=(S, n)) > 0.5
    act[:, :128] |= g.uniform(size=(S, 128)) > 0.2
    act[:, 128:192] = False
    ids = np.flatnonzero(act)
    ids = g.permutation(ids) if queue == "shuffled" else ids[:3]
    if queue == "three":
        act[:] = False
        act.reshape(-1)[ids] = True
    q = np.zeros(S * n, np.int32)
    q[:ids.size] = ids
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    return shade_cuda.ShadowSegments(
        geom=T(np.concatenate([start, end], -1).transpose(2, 0, 1)),
        k=T(g.uniform(0.0, 1.0, (3, S, n)).astype(np.float32)),
        active=T(act), queue=T(q),
        count=T(np.array([ids.size], np.int32)))


@pytest.mark.parametrize("queue", ["shuffled", "three"])
def test_shadow_march_kernel_on_adversarial_segments(cuda, queue):
    data, static, _cam = presets.default_scene(resolution=RES, device=cuda)
    cfg = shade_cuda.shadow_cfg(data, static, RenderSettings(
        resolution=RES, spp=1, max_vis_marches=64), rng.SampleTables(1), 0)
    segs = _adversarial_segments(cuda, queue)
    got = shade_cuda.shadow_march(cfg, segs)
    want = shade_cuda.shadow_march_plain(cfg, segs)
    torch.cuda.synchronize()
    assert _same_bits(got, want)
    assert want.any() or queue == "three"
    assert _same_bits(shade_cuda.shadow_sum(segs, got),
                      shade_cuda.shadow_sum_plain(segs, want))


@pytest.mark.parametrize("depth", [0, 1])
def test_tail_kernels_without_medium_one_nee_sample(cuda, depth):
    """VM = 0 and L = 1, and the first 64 rays (two warps) with no
    active segment: both functions and the segments kernel bit for bit."""
    args = list(_tail_inputs(cuda, depth, True, volume=False, nee=1))
    cfg = args[0]
    assert (cfg.L, cfg.VM) == (1, 0)
    for j in (6, 7):     # live, receives
        args[j] = args[j].clone()
        args[j][:64] = False
    _bounce_tail_vs_plain(args)
    _shadow_radiance_vs_plain(args)
    cfg, tabs, state, _hit_, info, mat, live, recv, vtr, t_hit = args
    shadow_args = (cfg, tabs, state, info, mat, live, recv, vtr, t_hit)
    got = shade_cuda.shadow_segments(*shadow_args)
    want = shade_cuda.shadow_segments_plain(*shadow_args)
    torch.cuda.synchronize()
    assert got.geom.shape[1] == 1 and _same_segments(got, want)
    assert not want.active[:, :64].any()


def _queue_args(cuda, depth, mis, **scene):
    """queue_segments' arguments on the default scene's wavefront."""
    cfg, tabs, state, _hit_, info, mat, live, recv, vtr, t_hit = (
        _tail_inputs(cuda, depth, mis, **scene))
    return cfg, tabs, state, info, mat, live, recv, vtr, t_hit


@pytest.mark.parametrize("mis", [False, True])
@pytest.mark.parametrize("depth", [0, 1])
def test_queue_segments_kernel_matches_plain(cuda, depth, mis):
    args = _queue_args(cuda, depth, mis)
    before = shade_cuda.queue_segments.launches
    got = shade_cuda.queue_segments(*args)
    _launched(shade_cuda.queue_segments, before)
    want = shade_cuda.queue_segments_plain(*args)
    assert int(want.count[0]) > 0 and _same_segments(got, want)


@pytest.mark.parametrize("depth", [0, 1])
def test_queue_segments_kernel_without_medium_one_nee_sample(cuda, depth):
    """VM = 0 and L = 1, with MIS, and the first 64 rays (two warps)
    with no segment worth marching."""
    args = list(_queue_args(cuda, depth, True, volume=False, nee=1))
    assert (args[0].L, args[0].VM) == (1, 0)
    for j in (5, 6):     # live, receives
        args[j] = args[j].clone()
        args[j][:64] = False
    got = shade_cuda.queue_segments(*args)
    want = shade_cuda.queue_segments_plain(*args)
    torch.cuda.synchronize()
    assert got.geom.shape[1] == 1 and _same_segments(got, want)
    assert not want.active[:, :64].any()


@pytest.mark.parametrize("relax", [1.0, 1.5])
@pytest.mark.parametrize("depth", [0, 1])
def test_queue_march_and_sum_kernels_match_plain(cuda, depth, relax):
    """The refill march on the queue path's scratch, plain and relaxed,
    then the queue sum on the emission-added radiance."""
    args = _queue_args(cuda, depth, True)
    cfg, state = args[0], args[2]
    segs = shade_cuda.queue_segments_plain(*args)
    before = shade_cuda.shadow_march.launches
    got = shade_cuda.shadow_march(cfg, segs, relax)
    _launched(shade_cuda.shadow_march, before)
    verdict = shade_cuda.shadow_march_plain(cfg, segs, relax)
    assert verdict.any() and _same_bits(got, verdict)
    radiance = state.radiance + 0.25
    before = shade_cuda.queue_sum.launches
    got = shade_cuda.queue_sum(radiance, segs, verdict)
    _launched(shade_cuda.queue_sum, before)
    want = shade_cuda.queue_sum_plain(radiance, segs, verdict)
    assert (want != radiance).any() and _same_bits(got, want)


@pytest.mark.parametrize("change", [
    dict(march_relaxation=1.5), dict(use_fused_shadows=False),
    dict(march_relaxation=1.5, mis=True),
    dict(use_fused_shadows=False, march_sort_steps=8, occl_sort_steps=8)])
@pytest.mark.parametrize("depth", [0, 1])
def test_queue_tail_matches_plain_twins(cuda, depth, change, monkeypatch):
    """The segment-queue bounce at a depth with its queue kernels and
    with their plain twins (the intersect on the kernels both times):
    every output column bit for bit."""
    data, static, s, tables, state, hps = _wavefront(cuda, depth)
    s = dataclasses.replace(s, **change)
    args = (data, static, s, tables, state, depth, *(float(h[0]) for h in hps))
    fns = (shade_cuda.queue_segments, shade_cuda.queue_sum)
    before = _launches(*fns)
    got = integrator.bounce(*args)
    torch.cuda.synchronize()
    assert _launches(*fns) == [n + 1 for n in before]
    for name in ("queue_segments", "shadow_march", "queue_sum"):
        monkeypatch.setattr(shade_cuda, name,
                            getattr(shade_cuda, name + "_plain"))
    want = integrator.bounce(*args)
    assert all(_same_bits(getattr(got, f), getattr(want, f))
               for f in want._fields)


@pytest.mark.parametrize("mis", [False, True])
@pytest.mark.parametrize("depth", [0, 1])
def test_finish_bounce_kernel_matches_plain(cuda, depth, mis):
    cfg, tabs, state, hit, info, mat, live, recv, vtr, t_hit = (
        _tail_inputs(cuda, depth, mis))
    radiance = state.radiance + shade_cuda.shadow_radiance_plain(
        cfg, tabs, state, info, mat, live, recv, vtr, t_hit)
    args = (cfg, tabs, state, hit, info, mat, live, recv, vtr, radiance)
    before = shade_cuda.finish_bounce.launches
    got = shade_cuda.finish_bounce(*args)
    want = shade_cuda.finish_bounce_plain(*args)
    torch.cuda.synchronize()
    assert shade_cuda.finish_bounce.launches == before + 1
    _check_state(got, want, depth)


def test_shadow_sort_key_kernel_matches_plain(cuda):
    """The key draws its volume sites' distances itself: equal to the
    twin bit for bit."""
    cfg, tabs, state, hit, info, _mat, live, recv, _vtr, _t_hit = (
        _tail_inputs(cuda, 1))
    args = (cfg, tabs, info.point, info.normal, info.offset_by,
            state.origin, state.direction, hit.t, live, recv,
            state.sample_idx, state.pixel)
    before = shade_cuda.shadow_sort_key.launches
    got = shade_cuda.shadow_sort_key(*args)
    want = shade_cuda.shadow_sort_key_plain(*args)
    torch.cuda.synchronize()
    assert shade_cuda.shadow_sort_key.launches == before + 1
    assert _same_bits(got, want)


# Adversarial batches of the march kernel's take: no ray, fewer rays
# than a warp, a count that is not a multiple of 32, every lane
# inactive, NaN entry DEs (NaN origins), entry DEs past t_max.
MARCH_CASES = ("camera", "bounce", "empty", "few", "ragged", "inactive",
               "nan entry", "entry past t_max")


def _march_case(cuda, case):
    """(mb, origin, direction, t_max, eps_const, eps_abs, eps_lin),
    max_steps and active of the march kernel's inputs in `case`: the
    default scene's camera rays (depth 0) or bounce rays (depth 1),
    bounded by twice the world radius, cut or altered."""
    data, static, s, _t, state, (ha, hl) = _wavefront(
        cuda, 1 if case == "bounce" else 0)
    o, d, alive = state.origin, state.direction, state.alive
    n = o.shape[0]
    t_max = torch.full((n,), 2.0 * s.world_radius, device=cuda)
    detail = s.sdf_detail_scale
    ea, el = 0.05 * detail * ha, 0.05 * detail * hl
    cut = {"empty": 0, "few": 17, "ragged": 32 * 37 + 5}.get(case)
    if cut is not None:
        o, d, t_max, ea, el, alive = (x[:cut].contiguous() for x in (
            o, d, t_max, ea, el, alive))
    lane = torch.arange(o.shape[0], device=cuda)
    if case == "inactive":
        alive = torch.zeros_like(alive)
    elif case == "nan entry":
        o = torch.where((lane % 3 == 0)[:, None], float("nan"), o)
    elif case == "entry past t_max":
        t_max = torch.where(lane % 2 == 0, 1e-3, t_max)
    return ((data.sdf_params, o, d, t_max, 5e-5 * detail, ea, el),
            s.max_marches, alive)


@pytest.mark.parametrize("relax", [1.0, 1.5])
@pytest.mark.parametrize("case", MARCH_CASES)
def test_march_kernel_matches_plain(cuda, case, relax):
    """The refill march equals its twin bit for bit, plain and relaxed;
    its warps take at least the ideal Σ DEs / 32 loop steps (DEs per ray
    from march's `n_de`)."""
    head, max_steps, alive = _march_case(cuda, case)
    args = (*head, max_steps, alive, relax)
    before = march_cuda.march.launches
    steps = torch.zeros((1,), dtype=torch.int64, device=cuda)
    got = march_cuda.march(*args, warp_steps=steps)
    n_de = torch.zeros(alive.shape, dtype=torch.int32, device=cuda)
    want = march_ops.march(*args, n_de=n_de)
    torch.cuda.synchronize()
    assert march_cuda.march.launches == before + 1
    assert _same_bits(got, want) and _same_bits(
        want, march_cuda.march_plain(*args))
    assert int(steps[0]) >= int(n_de.sum()) / 32
    if case in ("camera", "bounce"):
        assert 0 < int(((want < head[3]) & alive).sum()) < int(alive.sum())
    if case == "nan entry":
        assert bool(torch.isnan(got).any())
    if case == "entry past t_max":
        assert bool((alive & (got > head[3])).any())


def _segments(dev, k, n):
    g = np.random.default_rng(7)
    start = g.uniform(-3.0, 3.0, (k, n, 3)).astype(np.float32)
    d = g.normal(size=(k, n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    end = start + d * g.uniform(0.2, 6.0, (k, n, 1)).astype(np.float32)
    act = g.uniform(size=(k, n)) > 0.3
    return (torch.from_numpy(start).to(dev), torch.from_numpy(end).to(dev),
            torch.from_numpy(act).to(dev))


_OCCL_KERNELS = (march_cuda.enqueue, march_cuda.occlusion_march)


@pytest.mark.parametrize("bound", [0.0, 3.6])
@pytest.mark.parametrize("relax", [1.0, 1.5])
def test_march_occlusion_kernel_matches_plain(cuda, relax, bound):
    data, static, cam = presets.default_scene(resolution=RES, device=cuda)
    start, end, act = _segments(cuda, 12, RES[0] * RES[1])
    args = (data.sdf_params, start.reshape(-1, 3), end.reshape(-1, 3), 0.5,
            100, act.reshape(-1), relax, bound)
    before = _launches(*_OCCL_KERNELS)
    got = march_cuda.march_occlusion(*args)
    want = march_cuda.march_occlusion_plain(*args)
    torch.cuda.synchronize()
    assert _launches(*_OCCL_KERNELS) == [n + 1 for n in before]
    assert want.any() and _same_bits(got, want)


@pytest.mark.parametrize("bound", [0.0, 3.6])
def test_chained_occlusion_kernel_matches_plain(cuda, bound):
    data, static, cam = presets.default_scene(resolution=RES, device=cuda)
    start, end, act = _segments(cuda, 12, RES[0] * RES[1])
    args = (data.sdf_params, start, end, 0.5, 100, act, bound)
    before = _launches(*_OCCL_KERNELS)
    got = march_cuda.march_occlusion_chained(*args)
    want = march_cuda.march_occlusion_chained_plain(*args)
    torch.cuda.synchronize()
    assert _launches(*_OCCL_KERNELS) == [n + 1 for n in before]
    assert got.shape == act.shape
    assert want.any() and _same_bits(got, want)


@pytest.mark.parametrize("case", ["random", "none", "one", "all"])
def test_enqueue_kernel_matches_plain(cuda, case):
    """The queue holds the ids of the active entries (in any order) and
    `count` says how many: random, all inactive (an empty queue), one
    active, all active, over a length that is no multiple of 32."""
    g = np.random.default_rng(3)
    m = 12 * 4099
    act = {"random": g.uniform(size=m) > 0.4, "none": np.zeros(m, bool),
           "all": np.ones(m, bool),
           "one": np.arange(m) == m - 7}[case]
    act = torch.from_numpy(act).to(cuda)
    before = march_cuda.enqueue.launches
    queue, count = march_cuda.enqueue(act)
    _launched(march_cuda.enqueue, before)
    q_want, c_want = march_cuda.enqueue_plain(act)
    n = int(c_want[0])
    assert torch.equal(count, c_want) and queue.shape == (m,)
    assert torch.equal(queue[:n].sort().values, q_want[:n].sort().values)


def _past_end_overshoots(mb, start, end, detail, steps, relax, act):
    """How many segments take a relaxed step at which t is past the
    segment's end while that step overshot: march_occlusion's relaxed
    loop tests the end first, so such a segment is unblocked and never
    falls back (a torch walk of ops/march.py's relaxed branch)."""
    d, md, t, nan, _ = march_ops.segment_entry(mb, 0.0, start, end, act)
    t, t_prev, r_prev = t.clone(), torch.zeros_like(t), t.clone()
    live = torch.nonzero(~nan).squeeze(1)
    eps_c, eps_l = 1e-4 * detail, 1e-5 * detail
    hits = 0
    for _ in range(steps):
        tl, s, dl = t[live], start[live], d[live]
        r = sdf_ops.dist_c(mb, s[:, 0] + tl * dl[:, 0],
                           s[:, 1] + tl * dl[:, 1], s[:, 2] + tl * dl[:, 2])
        gt_end = tl > md[live]
        tp, rp = t_prev[live], r_prev[live]
        over = (tl - tp) > (torch.abs(rp) + torch.abs(r))
        hits += int((gt_end & over).sum())
        hit = (torch.abs(r) < torch.clamp(eps_l * tl, min=eps_c)) & ~over
        on = ~(hit | gt_end)
        adv = on & ~over
        t_prev[live[adv]], r_prev[live[adv]] = tl[adv], r[adv]
        nxt = torch.where(over, tp + rp, tl + relax * r)
        live = live[on]
        t[live] = nxt[on]
    return hits


@pytest.mark.parametrize("queue", ["adversarial", "one", "empty",
                                   "overshoot"])
def test_occlusion_march_kernel_on_adversarial_segments(cuda, queue):
    """The [M, 3] refill march against its twin bit for bit, plain and
    relaxed, clipped and not: zero-length and NaN-start segments in a
    shuffled queue, a queue of one, an empty queue, and short segments
    at relax 1.9 whose relaxed steps overshoot past their end."""
    data, _static, _cam = presets.default_scene(resolution=RES, device=cuda)
    mb = data.sdf_params
    segs = _adversarial_segments(cuda, "shuffled")
    g = segs.geom.reshape(6, -1).T
    start, end = g[:, :3].contiguous(), g[:, 3:].contiguous()
    act = segs.active.reshape(-1)
    relaxes = (1.0, 1.5)
    if queue == "one":
        act = torch.zeros_like(act)
        act[70] = True    # a NaN-start segment
    elif queue == "empty":
        act = torch.zeros_like(act)
    elif queue == "overshoot":
        gen = np.random.default_rng(9)
        d = gen.normal(size=(8192, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        s0 = gen.uniform(-2.5, 2.5, (8192, 3)).astype(np.float32)
        e0 = s0 + d * gen.uniform(0.02, 0.6, (8192, 1)).astype(np.float32)
        start = torch.from_numpy(s0).to(cuda)
        end = torch.from_numpy(e0).to(cuda)
        act = torch.ones((8192,), dtype=torch.bool, device=cuda)
        relaxes = (1.9,)
        assert _past_end_overshoots(mb, start, end, 0.5, 64, 1.9, act) > 0
    for relax in relaxes:
        for bound in (0.0, 3.6):
            args = (mb, start, end, 0.5, 64, act, relax, bound)
            got = march_cuda.march_occlusion(*args)
            want = march_cuda.march_occlusion_plain(*args)
            torch.cuda.synchronize()
            assert _same_bits(got, want), (relax, bound)
    assert want.any() or queue in ("one", "empty")


def _march_inputs(cuda):
    """(mb, origin, direction, t_max, eps_const, eps_abs, eps_lin),
    max_steps and active of the default scene's camera rays."""
    data, static, s, _t, state, (ha, hl) = _wavefront(cuda, 0)
    t_max = torch.full((ha.shape[0],), 2.0 * s.world_radius, device=cuda)
    detail = s.sdf_detail_scale
    return ((data.sdf_params, state.origin, state.direction, t_max,
             5e-5 * detail, 0.05 * detail * ha, 0.05 * detail * hl),
            s.max_marches, state.alive)


@pytest.mark.parametrize("split", [0, 8, 32])
@pytest.mark.parametrize("name", ["march_sorted", "march_phased"])
def test_two_phase_march_matches_plain(cuda, name, split, monkeypatch):
    """One launch of the march kernel, no other kernel and no argsort:
    equal to the one-piece plain version (the TPU schedule) and to
    march_plain bit for bit."""
    head, max_steps, alive = _march_inputs(cuda)
    before = _all_launches()
    with monkeypatch.context() as m:
        m.setattr(torch, "argsort", None)
        got = getattr(march_cuda, name)(*head, max_steps, alive,
                                        phase1_steps=split)
    _launched_only(before, march_cuda.march)
    want = getattr(march_cuda, name + "_plain")(*head, max_steps, alive,
                                                phase1_steps=split)
    assert _same_bits(got, want)
    assert _same_bits(want, march_cuda.march_plain(*head, max_steps, alive))


@pytest.mark.parametrize("name", ["march_sorted", "march_phased"])
def test_two_phase_march_matches_march_kernel(cuda, name):
    head, max_steps, alive = _march_inputs(cuda)
    got = getattr(march_cuda, name)(*head, max_steps, alive, phase1_steps=8)
    want = march_cuda.march(*head, max_steps, alive)
    torch.cuda.synchronize()
    assert _same_bits(got, want)


def _queue(cuda):
    data, _static, _cam = presets.default_scene(resolution=RES, device=cuda)
    start, end, act = _segments(cuda, 12, RES[0] * RES[1])
    return (data.sdf_params, start.reshape(-1, 3), end.reshape(-1, 3), 0.5,
            100, act.reshape(-1))


def _all_launches():
    """{wrapper name: launches} of every kernel wrapper of the port."""
    return {f"{mod.__name__}.{name}": fn.launches
            for mod in (intersect_cuda, march_cuda, shade_cuda)
            for name, fn in vars(mod).items()
            if callable(fn) and hasattr(fn, "launches")}


def _launched_only(before, *fns):
    """Since `before`, each of `fns` launched once and no other
    wrapper launched."""
    torch.cuda.synchronize()
    after = _all_launches()
    names = {f"{fn.__module__}.{fn.__name__}" for fn in fns}
    assert {k: after[k] - before[k] for k in after
            if after[k] != before[k]} == {k: 1 for k in names}


def _surface_queue(cuda):
    """_queue's head with segments that start where the camera rays hit
    the fractal (so that the first DE is often below 1e-4), 0.2-3 long
    in random directions."""
    head, max_steps, alive = _march_inputs(cuda)
    t = march_cuda.march_plain(*head, max_steps, alive)
    o, d = head[1], head[2]
    hit = alive & (t < head[3])
    start = (o + t[:, None] * d)[hit]
    g = torch.Generator(device="cpu").manual_seed(5)
    dirs = torch.randn(start.shape, generator=g).to(cuda)
    dirs = dirs / dirs.norm(dim=-1, keepdim=True)
    length = 0.2 + 2.8 * torch.rand((start.shape[0], 1), generator=g)
    end = start + dirs * length.to(cuda)
    act = torch.rand((start.shape[0],), generator=g).to(cuda) > 0.1
    return (head[0], start.contiguous(), end.contiguous(), 0.5, 100, act)


@pytest.mark.parametrize("segments", ["random", "surface"])
@pytest.mark.parametrize("split", [0, 8, 16])
@pytest.mark.parametrize("name", ["march_occlusion_phased",
                                  "march_occlusion_sorted"])
def test_two_phase_occlusion_matches_plain(cuda, name, split, segments):
    """The enqueue kernel and the refill march (the first-DE entry at
    split 0), and no other kernel: equal to the one-piece plain version
    bit for bit, and to march_occlusion with no clip at splits >= 1."""
    args = _queue(cuda) if segments == "random" else _surface_queue(cuda)
    before = _all_launches()
    got = getattr(march_cuda, name)(*args, phase1_steps=split)
    _launched_only(before, march_cuda.enqueue, march_cuda.occlusion_march)
    want = getattr(march_cuda, name + "_plain")(*args, phase1_steps=split)
    assert want.any() and _same_bits(got, want)
    if split:
        assert _same_bits(got, march_cuda.march_occlusion(
            *args, bound_radius=0.0))


@pytest.mark.parametrize("depth", [0, 1])
def test_two_phase_queue_route_launches_the_scratch_march(cuda, depth):
    """With `occl_sort_steps=8` the segment queue's verdicts come from
    one launch of the scratch's refill march, unclipped, and from no
    other kernel."""
    cfg, tabs, state, _hit, info, mat, live, recv, vtr, t_hit = (
        _tail_inputs(cuda, depth, False))
    segs = shade_cuda.queue_segments_plain(cfg, tabs, state, info, mat,
                                           live, recv, vtr, t_hit)
    s = RenderSettings(resolution=RES, spp=1, max_vis_marches=64,
                       occl_sort_steps=8)
    before = _all_launches()
    got = integrator._queue_verdicts(s, cfg, segs)
    _launched_only(before, shade_cuda.shadow_march)
    assert cfg.sdfs[0][1] > 0.0 and got.any() and _same_bits(
        got, shade_cuda.shadow_march_plain(shade_cuda.unclipped(cfg), segs))


@pytest.mark.parametrize("name", ["march_occlusion_phased",
                                  "march_occlusion_sorted"])
def test_two_phase_occlusion_matches_occlusion_kernel(cuda, name):
    mb, start, end, detail, max_steps, act = _queue(cuda)
    got = getattr(march_cuda, name)(mb, start, end, detail, max_steps, act,
                                    phase1_steps=8)
    want = march_cuda.march_occlusion(mb, start, end, detail, max_steps, act,
                                      bound_radius=0.0)
    torch.cuda.synchronize()
    assert want.any() and _same_bits(got, want)


# ------------------------------------------------------ animated scenes
@pytest.mark.parametrize("knots", [8, 64])
@pytest.mark.parametrize("depth", [0, 1])
def test_animated_intersect_kernels_match_plain(cuda, depth, knots):
    """The closest hit and the cost key on the animated-geo scene: bit
    for bit with their twins, and not the results at time 0 (knot 0)."""
    data, static, s, _t, state, hps = _wavefront(cuda, depth, knots=knots)
    assert data.sphere_centers.knots == knots
    got = _hit(data, static, s, state, hps,
               intersect_cuda.closest_hit_shading)
    want = _hit(data, static, s, state, hps,
                intersect_cuda.closest_hit_shading_plain)
    at0 = _hit(data, static, s, state._replace(time=state.time * 0.0), hps,
               intersect_cuda.closest_hit_shading)
    torch.cuda.synchronize()
    assert _hits_equal(got, want) and not _hits_equal(got, at0)
    args = (data, static, s, state.origin, state.direction, state.time,
            state.alive)
    key = intersect_cuda.intersect_cost_key(*args)
    assert _same_bits(key, intersect_cuda.intersect_cost_key_plain(*args))
    key0 = intersect_cuda.intersect_cost_key(*args[:5], state.time * 0.0,
                                             state.alive)
    assert not _same_bits(key, key0)


def _anim_tail(cuda, depth, knots, mis=True):
    return _tail_inputs(cuda, depth, mis, knots=knots)


@pytest.mark.parametrize("knots", [8, 64])
@pytest.mark.parametrize("depth", [0, 1])
def test_animated_tail_kernels_match_plain(cuda, depth, knots):
    """With MIS on the animated-geo scene: both segments kernels, the
    bounce tail (segments, march, tail sum) and shadow radiance bit for
    bit with their twins, the finish within the finish's gates; the
    segments differ from the ones at time 0."""
    args = _anim_tail(cuda, depth, knots)
    cfg, tabs, state, hit, info, mat, live, recv, vtr, t_hit = args
    assert tabs.animated and tabs.light_knots.knots == knots
    seg_args = (cfg, tabs, state, info, mat, live, recv, vtr, t_hit)
    for fn in (shade_cuda.shadow_segments, shade_cuda.queue_segments):
        before = fn.launches
        got = fn(*seg_args)
        _launched(fn, before)
        want = getattr(shade_cuda, fn.__name__ + "_plain")(*seg_args)
        assert int(want.count[0]) > 0 and _same_segments(got, want)
        at0 = fn(cfg, tabs, state._replace(time=state.time * 0.0),
                 *seg_args[3:])
        assert not _same_bits(at0.geom, got.geom)
    _bounce_tail_vs_plain(args)
    _shadow_radiance_vs_plain(args)
    radiance = state.radiance + shade_cuda.shadow_radiance_plain(*seg_args)
    fargs = (cfg, tabs, state, hit, info, mat, live, recv, vtr, radiance)
    got = shade_cuda.finish_bounce(*fargs)
    want = shade_cuda.finish_bounce_plain(*fargs)
    torch.cuda.synchronize()
    _check_state(got, want, depth)


@pytest.mark.parametrize("knots", [8, 64])
def test_animated_sort_key_kernel_matches_plain(cuda, knots):
    cfg, tabs, state, hit, info, _mat, live, recv, _vtr, _t_hit = (
        _anim_tail(cuda, 1, knots))
    args = (cfg, tabs, info.point, info.normal, info.offset_by,
            state.origin, state.direction, hit.t, live, recv,
            state.sample_idx, state.pixel)
    got = shade_cuda.shadow_sort_key(*args, state.time)
    want = shade_cuda.shadow_sort_key_plain(*args, state.time)
    at0 = shade_cuda.shadow_sort_key(*args, state.time * 0.0)
    torch.cuda.synchronize()
    assert _same_bits(got, want) and not _same_bits(got, at0)
    with pytest.raises(ValueError):
        shade_cuda.shadow_sort_key(*args)


def _camera_frame(cuda, cam_kind):
    res = (96, 54)
    if cam_kind == "animated":
        data, static, cam = presets.default_scene(resolution=res,
                                                  device=cuda, animated=True)
    else:
        data, static, _c = presets.default_scene(resolution=res, device=cuda)
        origin = tuple(float(x) * 2.25 for x in (-0.45, 0.2, 2.0))
        if cam_kind == "thin lens":
            cam = camera_mod.ThinLensCamera.make(
                res, 60.0, 0.35, origin, (0.0, 0.0, 0.0), (0.0, 1.0, 0.0),
                (0.0, 0.0, 0.0), device=cuda)
        else:
            cam = camera_mod.OrthographicCamera.make(
                res, 6.0, origin, (0.0, 0.0, 0.0), (0.0, 1.0, 0.0),
                device=cuda)
    s = RenderSettings(resolution=res, spp=2, max_marches=64,
                       max_vis_marches=32)
    return data, static, s, cam


@pytest.mark.parametrize("cam_kind", ["animated", "thin lens",
                                      "orthographic"])
def test_cameras_render_through_the_kernels(cuda, cam_kind):
    """Each camera renders through the closest-hit, segments and
    tail-sum kernels: finite colour and some coverage."""
    data, static, s, cam = _camera_frame(cuda, cam_kind)
    fns = (intersect_cuda.closest_hit_shading, shade_cuda.shadow_segments,
           shade_cuda.tail_sum)
    before = _launches(*fns)
    got = renderer.render_frame(data, static, s, cam, time_range=(0.0, 2.0))
    torch.cuda.synchronize()
    assert all(n > b for n, b in zip(_launches(*fns), before))
    assert torch.isfinite(got.color).all() and got.alpha.sum() > 0


# ------------------------------------------- zero steps, checkpoints, CLI
@pytest.mark.parametrize("bound", [0.0, 3.6])
@pytest.mark.parametrize("relax", [1.0, 1.5])
def test_march_occlusion_at_zero_steps_matches_plain(cuda, relax, bound):
    """max_steps 0 takes the first-DE march kernel at any relax: the
    verdicts of march_occlusion_plain (JAX's march with no loop step)."""
    data, static, cam = presets.default_scene(resolution=RES, device=cuda)
    start, end, act = _segments(cuda, 12, RES[0] * RES[1])
    args = (data.sdf_params, start.reshape(-1, 3), end.reshape(-1, 3), 0.5,
            0, act.reshape(-1), relax, bound)
    got = march_cuda.march_occlusion(*args)
    want = march_cuda.march_occlusion_plain(*args)
    torch.cuda.synchronize()
    assert _same_bits(got, want)


def test_checkpointed_frame_resumes_bit_for_bit(cuda, tmp_path, monkeypatch):
    """A frame that fails after pass 3 and resumes from its checkpoint
    (every 2 passes) gives the uninterrupted film bit for bit, and the
    checkpoint loads on the CPU."""
    data, static, cam = presets.default_scene(resolution=RES, device=cuda)
    s = RenderSettings(resolution=RES, spp=4, max_marches=64,
                       max_vis_marches=32, rays_per_pass=8192)
    ref = renderer.render_frame(data, static, s, cam, frame=1)
    failed = []

    def fail_once(p):
        if p == 3 and not failed:
            failed.append(p)
            raise RuntimeError("injected")

    monkeypatch.setattr(renderer, "_FAIL_HOOK", fail_once)
    path = str(tmp_path / "ck.npz")
    got = renderer.render_frame_resilient(data, static, s, cam, frame=1,
                                          retries=1, checkpoint_path=path,
                                          checkpoint_every=2)
    torch.cuda.synchronize()
    assert failed == [3]
    assert all(torch.equal(a, b)
               for a, b in zip(film_mod.tensors(got), film_mod.tensors(ref)))
    from rayn_tpu_torch.render import checkpoint
    fis = filters.build_fis_table(filters.blackman_harris(1.5), device=cuda)
    key = dict(scene=data, camera=cam, fis_table=fis,
               time_range=(1 / 24, 2 / 24))
    on_cpu = checkpoint.load(path, s, 1, device="cpu", **key)
    assert on_cpu is not None and on_cpu[0].color.device.type == "cpu"
    assert torch.equal(on_cpu[0].color, ref.color.cpu())


# ------------------------------------------------------------ SDF programs
def _slab(m=sdf_ops):
    """The program scene's instance 1: a rounded slab smooth-unioned with
    a torus, 2.6 below the MandelBox."""
    return m.translate(m.smooth_union(
        m.rounded(m.box((2.0, 0.1, 2.0)), 0.05), m.torus(1.2, 0.1), 0.2),
        (0.0, -2.6, 0.0))


def _every_op(m=sdf_ops):
    """A program with every opcode of the tape."""
    mb = m.mandelbox(12, 1.0, 0.01, 1.9, -2.1)
    return m.union(
        m.scale(m.subtraction(m.intersection(mb, m.sphere(1.5)),
                              m.plane((0.0, 1.0, 0.0), 0.2)), 0.8),
        m.translate(m.smooth_union(m.rounded(m.torus(1.0, 0.2), 0.05),
                                   m.box((0.3, 0.3, 0.3)), 0.25),
                    (0.5, 0.5, 0.5)))


def _deep(m=sdf_ops):
    """A program deeper than the Tape kernels' stacks: the slab's box at
    the end of a right-nested chain of eleven concentric tori (12
    distances at once), inside twelve nested translates that together
    move it 2.6 down (12 saved points): the DeepTape kernels."""
    p = m.box((2.0, 0.1, 2.0))
    ops = (m.union, m.intersection, m.subtraction,
           lambda a, b: m.smooth_union(a, b, 0.05))
    for i in range(11):
        p = ops[i % 4](m.rounded(m.torus(0.4 + 0.15 * i, 0.04), 0.01), p)
    for _ in range(12):
        p = m.translate(p, (0.0, -2.6 / 12, 0.0))
    return p


def _program_scene(dev, second=None, knots=0):
    """The default scene with its MandelBox as instance 0 and `second`
    (the slab by default), with a lambertian material of its own, as
    instance 1; with `knots`, of the scene with animated lights and
    spheres at that many knots."""
    data, static, cam = presets.default_scene(
        resolution=RES, device=dev, animated_geo=knots > 0,
        geo_knots=max(knots, 1))

    def channel(ch, k):
        if knots:
            return AnimChannel(ch.values[k].cpu(), ch.t0, ch.t1)
        return ch.values[k, 0].tolist()

    b = SceneBuilder()
    b.set_volume(0.25, 0.035)
    for kind, a, bb, power, ior in zip(*(
            x.tolist() for x in data.materials)):
        b._add_material(kind, a, bb, power, ior)
    slab = b.add_lambertian((0.6, 0.5, 0.4))
    for k in range(static.n_spheres):
        b.add_sphere(channel(data.sphere_centers, k),
                     float(data.sphere_radii[k]), int(data.sphere_mats[k]))
    for i in range(static.n_lights):
        b.add_sphere_light(channel(data.light_pos, i),
                           float(data.light_radii[i]),
                           data.light_emission[i].tolist())
    b.add_sdf(data.sdf_params, static.sdf_mat, static.sdf_bound_radius)
    b.add_sdf(second or _slab(), slab, bound_radius=4.3)
    return (*b.build(dev), cam)


def _every_op_scene(dev):
    """Sky, a light with its emissive body, the every-opcode program
    (instance 0) and a sphere program (instance 1)."""
    b = SceneBuilder()
    b.add_sphere((0.0, 0.0, 0.0), 100.0, b.add_sky((0.3, 0.4, 0.6),
                                                   (0.01, 0.015, 0.03)))
    b.add_sphere_light((2.0, 2.5, 2.0), 0.4, (30.0, 24.0, 15.0))
    b.add_sphere((2.0, 2.5, 2.0), 0.39, b.add_emissive((3.0, 2.4, 1.5)))
    b.add_sdf(_every_op(), b.add_dielectric((0.2, 0.3, 0.8), 0.3),
              bound_radius=2.5)
    b.add_sdf(sdf_ops.translate(sdf_ops.sphere(0.4), (-1.2, -0.3, 0.5)),
              b.add_lambertian((0.7, 0.2, 0.2)), bound_radius=2.0)
    cam = camera_mod.PinholeCamera.make(RES, 50.0, (0.3, 0.8, 4.0),
                                        (0.0, 0.0, 0.0), (0.0, 1.0, 0.0),
                                        device=dev)
    return (*b.build(dev), cam)


PROGRAM_SCENES = {
    "program": _program_scene, "every_op": _every_op_scene,
    "deep": lambda dev: _program_scene(dev, _deep()),
    "deep_animated": lambda dev: _program_scene(dev, _deep(), knots=8)}


@pytest.mark.parametrize("depth", [0, 1])
@pytest.mark.parametrize("scene", sorted(PROGRAM_SCENES))
def test_program_intersect_kernels_match_plain(cuda, scene, depth):
    """The closest hit (every instance in turn, the taps of the one hit)
    and the cost key (summed over the instances) equal their twins."""
    data, static, s, _t, state, hps = _wavefront(cuda, depth, scene=scene)
    assert len(static.sdf_instances(data)) == 2
    before = intersect_cuda.closest_hit_shading.launches
    got = _hit(data, static, s, state, hps,
               intersect_cuda.closest_hit_shading)
    want = _hit(data, static, s, state, hps,
                intersect_cuda.closest_hit_shading_plain)
    _launched(intersect_cuda.closest_hit_shading, before)
    assert _hits_equal(got, want)
    obj = want[0].obj
    assert bool((obj == static.n_spheres).any()) and bool(
        (obj == static.n_spheres + 1).any())
    args = (data, static, s, state.origin, state.direction, state.time,
            state.alive)
    before = intersect_cuda.intersect_cost_key.launches
    got = intersect_cuda.intersect_cost_key(*args)
    _launched(intersect_cuda.intersect_cost_key, before)
    assert _same_bits(got, intersect_cuda.intersect_cost_key_plain(*args))


@pytest.mark.parametrize("depth", [0, 1])
@pytest.mark.parametrize("scene", sorted(PROGRAM_SCENES))
def test_program_tail_kernels_match_plain(cuda, scene, depth):
    """The bounce tail and shadow radiance (a segment goes through the
    instances in turn in one launch of the march), the sort key (summed
    over the instances) and the queue's refill march at relax 1 and 1.5
    equal their twins bit for bit."""
    data, static, s, tables, state, hps = _wavefront(cuda, depth, True,
                                                     scene=scene)
    hit, info = _hit(data, static, s, state, hps,
                     intersect_cuda.closest_hit_shading_plain)
    live, mat, recv, vtr = integrator._derive_shading(data, static, state,
                                                      hit, info)
    cfg = shade_cuda.shadow_cfg(data, static, s, tables, depth)
    tabs = shade_cuda.scene_tables(data, static)
    args = (cfg, tabs, state, hit, info, mat, live, recv, vtr, hit.t)
    _bounce_tail_vs_plain(args)
    _shadow_radiance_vs_plain(args)
    key_args = (cfg, tabs, info.point, info.normal, info.offset_by,
                state.origin, state.direction, hit.t, live, recv,
                state.sample_idx, state.pixel, state.time)
    before = shade_cuda.shadow_sort_key.launches
    got = shade_cuda.shadow_sort_key(*key_args)
    _launched(shade_cuda.shadow_sort_key, before)
    assert _same_bits(got, shade_cuda.shadow_sort_key_plain(*key_args))
    segs = shade_cuda.queue_segments_plain(cfg, tabs, state, info, mat, live,
                                           recv, vtr, hit.t)
    for relax in (1.0, 1.5):
        got = shade_cuda.shadow_march(cfg, segs, relax)
        want = shade_cuda.shadow_march_plain(cfg, segs, relax)
        assert want.any() and _same_bits(got, want)


@pytest.mark.parametrize("relax", [1.0, 1.5])
@pytest.mark.parametrize("scene", sorted(PROGRAM_SCENES))
def test_program_march_kernels_match_plain(cuda, scene, relax):
    """The march kernel and march_occlusion (enqueue + refill march) on
    each instance's program, and the first-DE entry, equal their twins."""
    data, static, s, _t, state, (ha, hl) = _wavefront(cuda, 1, scene=scene)
    n = state.origin.shape[0]
    t_max = torch.full((n,), 2.0 * s.world_radius, device=cuda)
    start, end, act = _segments(cuda, 4, n)
    for prog, _mat, bv in static.sdf_instances(data):
        args = (prog, state.origin, state.direction, t_max, 5e-5, 0.05 * ha,
                0.05 * hl, s.max_marches, state.alive, relax)
        assert _same_bits(march_cuda.march(*args),
                          march_cuda.march_plain(*args))
        for steps, bound in ((100, bv), (100, 0.0), (0, bv)):
            oargs = (prog, start.reshape(-1, 3), end.reshape(-1, 3), 0.5,
                     steps, act.reshape(-1), relax, bound)
            assert _same_bits(march_cuda.march_occlusion(*oargs),
                              march_cuda.march_occlusion_plain(*oargs))
        if relax == 1.0:
            pargs = (prog, start.reshape(-1, 3), end.reshape(-1, 3), 0.5, 64,
                     act.reshape(-1))
            for split in (0, 8):
                assert _same_bits(
                    march_cuda.march_occlusion_phased(*pargs, split),
                    march_cuda.march_occlusion_phased_plain(*pargs, split))


def test_forced_tape_matches_mbox_only(cuda):
    """The default scene's MandelBox run as a one-op tape (the Tape
    kernels) gives the MBoxOnly kernels' bits: closest hit, cost key,
    bounce tail, sort key and march."""
    args = _tail_inputs(cuda, 1)
    cfg, tabs, state, hit, info, mat, live, recv, vtr, t_hit = args
    data, static, s, _t, _state, hps = _wavefront(cuda, 1)
    key_args = (cfg, tabs, info.point, info.normal, info.offset_by,
                state.origin, state.direction, hit.t, live, recv,
                state.sample_idx, state.pixel)
    n = state.origin.shape[0]
    margs = (data.sdf_params, state.origin, state.direction,
             torch.full((n,), 200.0, device=cuda), 5e-5, hps[0] * 0.05,
             hps[1] * 0.05, s.max_marches, state.alive, 1.5)

    def run():
        return (_hit(data, static, s, state, hps,
                     intersect_cuda.closest_hit_shading),
                intersect_cuda.intersect_cost_key(
                    data, static, s, state.origin, state.direction,
                    state.time, state.alive),
                shade_cuda.bounce_tail(*args),
                shade_cuda.shadow_sort_key(*key_args),
                march_cuda.march(*margs))
    mbox = run()
    with _build.tape_forced():
        tape = run()
    assert _hits_equal(tape[0], mbox[0])
    assert _same_bits(tape[1], mbox[1])
    assert all(_same_bits(tape[2][f], mbox[2][f]) for f in mbox[2])
    assert _same_bits(tape[3], mbox[3]) and _same_bits(tape[4], mbox[4])


def test_deep_scenes_take_the_deep_tape(cuda):
    """The deep scenes' instances run the DeepTape kernels (tape 2), the
    scratch sized for a persistent grid at most what the card holds."""
    props = torch.cuda.get_device_properties(cuda)
    cap = props.multi_processor_count * props.max_threads_per_multi_processor
    for name in ("deep", "deep_animated"):
        data, static, _cam = PROGRAM_SCENES[name](cuda)
        insts = static.sdf_instances(data)
        assert max(sdf_ops.tape(insts[1][0])[2:]) == 12
        sdf = _build.sdf_args(insts, cuda, 1 << 24)[1]
        assert (sdf.tape, sdf.depth, sdf.points, sdf.slots) == (
            2, 12, 12, cap)
        assert _build.sdf_args(insts, cuda, 1000,
                               persistent=False)[1].slots == 1024


def _frame(data, static, cam, **change):
    s = RenderSettings(resolution=RES, spp=1, max_marches=128,
                       max_vis_marches=64, rays_per_pass=RES[0] * RES[1],
                       **change)
    return film_mod.tensors(renderer.render_frame(data, static, s, cam))


@pytest.mark.parametrize("flag, twin", [
    ("use_pallas", "use_fused_intersect"),
    ("use_pallas_occlusion", "use_fused_shadows")])
def test_route_without_kernels_matches_kernel_route(cuda, flag, twin):
    """The route without kernels on the card (its marches in torch) gives
    the film of the kernel route with the same fused kernels off, bit for
    bit; the marches it replaces launch no kernel."""
    data, static, cam = presets.default_scene(resolution=RES, device=cuda)
    before = (march_cuda.march.launches, shade_cuda.shadow_march.launches,
              intersect_cuda.intersect_cost_key.launches)
    got = _frame(data, static, cam, **{flag: False})
    after = (march_cuda.march.launches, shade_cuda.shadow_march.launches,
             intersect_cuda.intersect_cost_key.launches)
    want = _frame(data, static, cam, **{twin: False})
    assert all(_same_bits(a, b) for a, b in zip(got, want))
    if flag == "use_pallas":
        assert after[0] == before[0] and after[2] == before[2]
        assert after[1] > before[1]   # the fused shadow kernels still run
    else:
        assert after[1] == before[1]


def test_closure_scene_matches_library_scene(cuda):
    """A closure torus written with vecmath ops gives the library Torus's
    film on the card, bit for bit, on the unfused route."""
    from rayn_tpu_torch.utils import vecmath

    def torus_fn(prm, p):
        x, y, z = p[..., 0], p[..., 1], p[..., 2]
        qx = vecmath.sqrt(x * x + z * z) - prm["major"]
        return vecmath.sqrt(qx * qx + y * y) - prm["minor"]

    closure = sdf_ops.SdfProgram(torus_fn, {"major": 1.2, "minor": 0.1})
    lib = sdf_ops.torus(1.2, 0.1)
    films = [_frame(*_program_scene(cuda, sdf_ops.translate(
        p, (0.0, -2.6, 0.0))), use_fused_intersect=False,
        use_fused_shadows=False) for p in (closure, lib)]
    assert all(_same_bits(a, b) for a, b in zip(*films))
