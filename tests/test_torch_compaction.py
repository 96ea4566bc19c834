"""Wavefront compaction in the port (`compact_bounces`,
integrator.compact / compact_order) on the CPU, against rayn_tpu.

- `compact` of a seeded state equals JAX's `compact` in every column
  (all lanes alive, none, a mix).
- The compacted film equals the uncompacted film bit for bit
  (`torch.equal`), the extra AOV accumulators included, on the default
  scene with an albedo function on its MandelBox, on every route of
  `integrator.bounce`: the fused twins, the split tail with MIS, the
  unfused finish, the relaxed segment queue, the relax-1 unfused queue
  and the sorted two-phase marches. The permutations were not the
  identity: the test would be vacuous otherwise. `trace` hands the lanes
  back in ray order, so the splat is the uncompacted one's.
- The compacted film of tests/test_compaction.py's spheres scene against
  JAX's compacted film (op by op) at that test's tolerances.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rayn_tpu.config import RenderSettings as JSettings
from rayn_tpu.render import film as jfilm
from rayn_tpu.render import integrator as jint
from rayn_tpu.render import renderer as jrenderer
from rayn_tpu.scene import presets as jpresets
from rayn_tpu_torch import convert
from rayn_tpu_torch.config import RenderSettings
from rayn_tpu_torch.render import film, integrator, renderer
from rayn_tpu_torch.scene import presets

torch.set_num_threads(1)


def albedo(p, n):
    return torch.stack([0.5 + 0.4 * torch.sin(3.0 * p[:, 0]),
                        0.5 + 0.4 * torch.sin(3.0 * p[:, 1] + 1.0),
                        0.4 + 0.3 * n[:, 2]], dim=-1)


def _state(g, n, p_alive):
    f32 = np.float32
    cols = dict(
        origin=g.normal(size=(n, 3)).astype(f32),
        direction=g.normal(size=(n, 3)).astype(f32),
        time=g.uniform(size=n).astype(f32),
        radiance=g.uniform(size=(n, 3)).astype(f32),
        throughput=g.uniform(size=(n, 3)).astype(f32),
        pixel=np.arange(n, dtype=np.int32) // 4,
        sample_idx=np.arange(n, dtype=np.int32) % 4,
        alive=g.uniform(size=n) < p_alive,
        prev_pdf=g.uniform(size=n).astype(f32),
        color_out=g.uniform(size=(n, 3)).astype(f32),
        bg_out=g.uniform(size=(n, 3)).astype(f32),
        alpha_out=g.uniform(size=n).astype(f32),
        normal_out=g.normal(size=(n, 3)).astype(f32))
    return cols


@pytest.mark.parametrize("p_alive", [0.0, 0.37, 1.0])
def test_compact_matches_jax(p_alive):
    cols = _state(np.random.default_rng(5), 301, p_alive)
    want = jint.compact(jint.PathState(
        **{k: jnp.asarray(v) for k, v in cols.items()}))
    got = integrator.compact(integrator.PathState(
        **{k: torch.from_numpy(v) for k, v in cols.items()}))
    for f in integrator.PathState._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)))
    order = integrator.compact_order(torch.from_numpy(cols["alive"]))
    n_alive = int(cols["alive"].sum())
    assert bool(got.alive[:n_alive].all()) and not got.alive[n_alive:].any()
    assert torch.equal(order.sort().values, torch.arange(301))


ROUTES = {
    "fused": {},
    "split tail, mis": dict(mis=True, use_fused_bounce_tail=False),
    "unfused finish": dict(use_fused_finish=False),
    "relaxed queue": dict(march_relaxation=1.5),
    "unfused queue": dict(use_fused_intersect=False, use_fused_shadows=False),
    "sorted two-phase": dict(use_fused_intersect=False,
                             use_fused_shadows=False, march_sort_steps=8,
                             occl_sort_steps=8)}


@pytest.mark.parametrize("route", list(ROUTES))
def test_compacted_film_is_bit_for_bit(route, monkeypatch):
    res = (16, 16)
    data, static, cam = presets.default_scene(resolution=res, device="cpu")
    static = dataclasses.replace(static, mat_param_fns=((static.sdf_mat,
                                                         albedo),))
    s = RenderSettings(resolution=res, spp=2, max_bounces=3, max_marches=24,
                       max_vis_marches=16, rays_per_pass=256,
                       extra_aovs=("depth", "position", "albedo", "mat_id"),
                       **ROUTES[route])
    plain = renderer.render_frame(data, static, s, cam)
    orders = []
    real = integrator.compact_order

    def spy(alive):
        orders.append(real(alive))
        return orders[-1]

    monkeypatch.setattr(integrator, "compact_order", spy)
    packed = renderer.render_frame(
        data, static, dataclasses.replace(s, compact_bounces=True), cam)
    assert len(orders) == 2 * s.max_bounces
    assert any(not torch.equal(o, torch.arange(o.numel())) for o in orders)
    assert len(packed.extra) == 4
    for x, y in zip(film.tensors(packed), film.tensors(plain)):
        assert torch.equal(x, y)


def test_compacted_film_matches_jax():
    """tests/test_compaction.py's render, compacted in both packages."""
    res = (24, 16)
    kw = dict(resolution=res, spp=4, max_bounces=3, volume_marches=1,
              max_marches=24, max_vis_marches=12, rays_per_pass=1 << 11,
              compact_bounces=True)
    jdata, jstatic, jcam = jpresets.spheres_scene(resolution=res)
    with jax.disable_jit():
        want = jfilm.resolve(jrenderer.render_frame(
            jdata, jstatic, JSettings(**kw), jcam, 1), res)
    data, static = convert.scene(jax.tree.map(np.asarray, jdata), jstatic,
                                 device="cpu")
    cam = convert.camera(jax.tree.map(np.asarray, jcam), device="cpu")
    got = film.resolve(renderer.render_frame(data, static,
                                             RenderSettings(**kw), cam, 1),
                       res)
    np.testing.assert_allclose(got.color, want.color, atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(got.alpha, want.alpha, atol=1e-6)
    np.testing.assert_allclose(got.normal, want.normal, atol=2e-5)
