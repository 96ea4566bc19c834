"""The plain reference against the renderer's CPU route, its sampler and
filter table against the renderer's, and its bfloat16 control against
the cells' limits."""

import numpy as np
import pytest
import torch

from benchmark import check, program
from benchmark.reference import filters as ref_filters
from benchmark.reference.precision import BFLOAT16, round_bf16
from benchmark.reference.sampler import Layout, Streams
from benchmark.reference.tracer import Tracer
from benchmark.tests.helpers import load_json, tiny_config

CELL_OF = {"rayn_default": "default_final_8spp",
           "rtiow_spheres": "spheres_final_8spp"}


def test_sampler_streams_are_the_renderers_bits():
    from rayn_tpu_torch.config import RenderSettings
    from rayn_tpu_torch.utils import rng
    s = RenderSettings()
    lay = Layout(s.nee_light_samples, s.volume_marches, s.max_bounces)
    g = np.random.default_rng(0)
    pixel = g.integers(0, 1280 * 720, 512)
    sidx = g.integers(0, 8, 512)
    for frame in (1, 123456, 1 + 1000 * (2 ** 31 + 77)):
        st = Streams(lay, np.full(512, frame), pixel, sidx)
        tab = rng.build_sample_tables(s, frame)
        tp, ts = torch.as_tensor(pixel), torch.as_tensor(sidx)
        for set_id in (0, 1, 7, s.num_1d_sets - 1):
            want = rng.sample_1d(s, tab, set_id, ts, tp).numpy()
            np.testing.assert_array_equal(st.u1(set_id), want)
        for set_id in (0, 3, s.num_2d_sets - 1):
            want = rng.sample_2d(s, tab, set_id, ts, tp).numpy()
            np.testing.assert_array_equal(st.u2(set_id), want)
    assert lay.fresnel(2) == rng.set1d_fresnel(s, 2)
    assert lay.roulette(3) == rng.set1d_roulette(s, 3)
    assert lay.vol_dist(1, 1) == rng.set1d_vol_dist(s, 1, 1)
    assert lay.vol_pick(2, 1, 3) == rng.set1d_vol_pick(s, 2, 1, 3)
    assert lay.vol(1, 1, 2) == rng.set2d_vol(s, 1, 1, 2)
    assert lay.diffuse(3) == rng.set2d_diffuse(s, 3)
    assert lay.spec(0) == rng.set2d_spec(s, 0)


def test_filter_table_is_the_renderers():
    from rayn_tpu_torch.ops import filters
    want = filters.build_fis_table(filters.blackman_harris(1.5), 512,
                                   device="cpu").numpy()
    np.testing.assert_array_equal(
        ref_filters.fis_table("blackman_harris", 1.5, 512), want)


def test_bfloat16_rounding():
    x = np.array([1.0, 1.00390625, 1.0078125, 3.14159, -2.5e-7], np.float32)
    r = round_bf16(x)
    np.testing.assert_array_equal(r[:3], [1.0, 1.0, 1.0078125])
    assert abs(r[3] - 3.140625) < 1e-9
    assert (r.view(np.uint32) & 0xFFFF).max() == 0


def _port_pixels(cfg, frame):
    s = program.settings_of(cfg, use_pallas=False)
    r = program.Renderer(cfg, s, "cpu")
    res = r.resolve(r.render(frame))
    n = s.resolution[0] * s.resolution[1]
    return check.take(res, np.arange(n)), n


@pytest.mark.parametrize("name", ["rtiow_spheres", "rayn_default"])
def test_reference_agrees_with_the_cpu_route(name):
    """16x16 frames of the configuration: the renderer's route without
    kernels (float32) against the reference (float64), judged by the
    limits of the configuration's 8-spp cell."""
    cfg = tiny_config(name, res=(16, 16), rays_per_pass=2048)
    frame = 1 + 1000 * 41
    got, n = _port_pixels(cfg, frame)
    with np.errstate(all="ignore"):
        want = Tracer(cfg).render(np.full(n, frame), np.arange(n))
    values = check.numbers(got, want)
    limits = load_json(f"benchmark/checks/{CELL_OF[name]}.json")["limits"]
    ok, report = check.judge(values, limits)
    assert ok, report


@pytest.mark.parametrize("name,res", [("rtiow_spheres", (16, 16)),
                                      ("rayn_default", (8, 8))])
def test_bfloat16_control_fails_the_limits(name, res):
    """The reference computed in bfloat16, put in the renderer's place, is
    not correct by the cell's limits."""
    cfg = tiny_config(name, res=res, rays_per_pass=2048)
    n = res[0] * res[1]
    frame = 1 + 1000 * 43
    with np.errstate(all="ignore"):
        want = Tracer(cfg).render(np.full(n, frame), np.arange(n))
        ctl = Tracer(cfg, BFLOAT16).render(np.full(n, frame), np.arange(n))
    limits = load_json(f"benchmark/checks/{CELL_OF[name]}.json")["limits"]
    ok, report = check.judge(check.numbers(ctl, want), limits)
    assert not ok, report
