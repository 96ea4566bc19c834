"""Per-point albedo functions in the port (SceneBuilder.set_albedo_fn,
SceneStatic.mat_param_fns, convert.scene(albedo_fns=)) on the CPU,
against rayn_tpu.

- `_derive_shading`'s color_a against JAX's on the same (point, normal)
  and material ids of tests/test_param_materials.py's procedural scene,
  within atol 1e-6 (the rest of the material equal).
- That scene carried across with the torch counterpart of its jnp
  albedo, rendered at 10x8, 8 spp, three bounces on the fused path, the
  split tail with MIS, the segment queue and with compaction, against
  JAX's render_frame op by op (`jax.disable_jit`: XLA's compiled render
  contracts FMAs, tests/test_torch_render.py): colour, alpha, normal
  and the albedo and position AOVs within the sphere-scene gate (RMSE
  < 1e-3); the material's sentinel constant never reaches the image.
- convert.scene refuses a JAX albedo function without a torch one, and
  a torch one for a material that has none; the builder keeps the
  functions in material order; the checkpoint fingerprint tells two
  albedo functions apart (JAX's hashes only the scene's leaves) and
  resumes under the same function.
"""

import dataclasses
from types import SimpleNamespace as NS

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rayn_tpu.config import RenderSettings as JSettings
from rayn_tpu.render import film as jfilm
from rayn_tpu.render import integrator as jint
from rayn_tpu.render import renderer as jrenderer
from rayn_tpu.render.camera import PinholeCamera as JPinhole
from rayn_tpu.scene.scene import SceneBuilder as JBuilder
from rayn_tpu_torch import convert
from rayn_tpu_torch.config import RenderSettings
from rayn_tpu_torch.render import checkpoint, film, integrator, renderer
from rayn_tpu_torch.scene import presets
from rayn_tpu_torch.scene.scene import SceneBuilder

torch.set_num_threads(1)

RES = (10, 8)


def albedo_jax(p, n):
    """tests/test_param_materials.py's smooth procedural albedo."""
    r = 0.5 + 0.4 * jnp.sin(3.0 * p[:, 0])
    g = 0.5 + 0.4 * jnp.sin(3.0 * p[:, 1] + 1.0)
    b = 0.4 + 0.3 * n[:, 2]
    return jnp.stack([r, g, b], axis=-1)


def albedo_torch(p, n):
    """albedo_jax in torch."""
    r = 0.5 + 0.4 * torch.sin(3.0 * p[:, 0])
    g = 0.5 + 0.4 * torch.sin(3.0 * p[:, 1] + 1.0)
    b = 0.4 + 0.3 * n[:, 2]
    return torch.stack([r, g, b], dim=-1)


def albedo_torch_cool(p, n):
    """Another albedo, for the fingerprint."""
    return torch.stack([0.2 + 0.0 * p[:, 0], 0.3 + 0.1 * n[:, 1],
                        0.7 + 0.0 * p[:, 2]], dim=-1)


def jax_scene(res=RES):
    """tests/test_param_materials.py's procedural_scene."""
    b = JBuilder()
    sky = b.add_sky(top=(0.3, 0.4, 0.6),
                    bottom=np.asarray((0.2, 0.3, 0.6), np.float32) * 0.05)
    b.add_sphere((0.0, 0.0, 0.0), 100.0, sky)
    lam = b.add_lambertian((9.9, 9.9, 9.9))  # sentinel, overridden
    b.set_albedo_fn(lam, albedo_jax)
    b.add_sphere((0.0, -100.5, 0.0), 100.0, lam)
    b.add_sphere((0.0, 0.2, 0.0), 0.7, lam)
    warm = np.asarray((5.0, 4.0, 2.5)) / np.linalg.norm((5.0, 4.0, 2.5))
    b.add_sphere_light((2.0, 2.5, 2.0), 0.4, warm * 30.0)
    cam = JPinhole.make(res, 60.0, (0.0, 0.8, 3.0), (0.0, 0.0, 0.0),
                        (0.0, 1.0, 0.0))
    data, static = b.build()
    return data, static, cam, lam


def port_scene(res=RES, fn=albedo_torch):
    jdata, jstatic, jcam, lam = jax_scene(res)
    data, static = convert.scene(jax.tree.map(np.asarray, jdata), jstatic,
                                 device="cpu", albedo_fns={lam: fn})
    return data, static, convert.camera(jax.tree.map(np.asarray, jcam),
                                        device="cpu")


def test_derive_shading_matches_jax():
    jdata, jstatic, _jcam, lam = jax_scene()
    data, static, _cam = port_scene()
    assert static.mat_param_fns == ((lam, albedo_torch),)
    g = np.random.default_rng(21)
    n = 300
    point = g.normal(size=(n, 3)).astype(np.float32)
    normal = g.normal(size=(n, 3)).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    mat = g.integers(0, static.n_materials, n).astype(np.int32)
    alive, valid = g.uniform(size=n) < 0.8, g.uniform(size=n) < 0.9
    t = g.uniform(0.1, 9.0, n).astype(np.float32)
    direction = g.normal(size=(n, 3)).astype(np.float32)

    def args(a):
        return (NS(alive=a(alive), direction=a(direction)),
                NS(valid=a(valid), t=a(t)),
                NS(mat=a(mat), point=a(point), normal=a(normal)))

    _l, jmat, jrecv, _wo, _v = jint._derive_shading(jdata, jstatic,
                                                    *args(jnp.asarray))
    live, tmat, recv, _v = integrator._derive_shading(
        data, static, *args(torch.from_numpy))
    assert (mat == lam).sum() > 30
    np.testing.assert_allclose(tmat.color_a.numpy(), np.asarray(jmat.color_a),
                               rtol=0, atol=1e-6)
    assert tmat.color_a.numpy().max() < 9.0
    for f in ("kind", "color_b", "power", "ior"):
        np.testing.assert_array_equal(getattr(tmat, f).numpy(),
                                      np.asarray(getattr(jmat, f)))
    np.testing.assert_array_equal(recv.numpy(), np.asarray(jrecv))


ROUTES = {"fused": {}, "split tail, mis": dict(mis=True,
                                               use_fused_bounce_tail=False),
          "segment queue": dict(use_fused_shadows=False),
          "compacted": dict(compact_bounces=True)}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_procedural_scene_matches_jax(route):
    kw = dict(resolution=RES, spp=8, max_bounces=3, rays_per_pass=1 << 10,
              extra_aovs=("albedo", "position"), **ROUTES[route])
    jdata, jstatic, jcam, _lam = jax_scene()
    js = JSettings(**kw)
    with jax.disable_jit():
        want = jfilm.resolve(jrenderer.render_frame(jdata, jstatic, js, jcam,
                                                    frame=1), RES, js)
    data, static, cam = port_scene()
    s = RenderSettings(**kw)
    got = film.resolve(renderer.render_frame(data, static, s, cam, frame=1),
                       RES, s)
    for c in ("color", "alpha", "normal"):
        rmse = float(np.sqrt(np.mean((getattr(got, c) - getattr(want, c))
                                     ** 2)))
        assert rmse < 1e-3, (c, rmse)
    for name in ("albedo", "position"):
        rmse = float(np.sqrt(np.mean((got.extra[name] - want.extra[name])
                                     ** 2)))
        assert rmse < 1e-3, (name, rmse)
    assert got.color.max() < 9.0 and got.extra["albedo"].max() < 0.95


def test_convert_refuses_a_missing_torch_function():
    jdata, jstatic, _jcam, lam = jax_scene()
    jd = jax.tree.map(np.asarray, jdata)
    with pytest.raises(ValueError, match="albedo_fns"):
        convert.scene(jd, jstatic, device="cpu")
    with pytest.raises(ValueError, match=r"materials \[0\]"):
        convert.scene(jd, jstatic, device="cpu",
                      albedo_fns={lam: albedo_torch, 0: albedo_torch})


def test_builder_keeps_functions_in_material_order():
    b = SceneBuilder()
    m = [b.add_lambertian((0.5,) * 3) for _ in range(3)]
    b.add_sphere((0.0, 0.0, 0.0), 1.0, m[0])
    b.set_albedo_fn(m[2], albedo_torch_cool)
    b.set_albedo_fn(m[0], albedo_torch)
    _data, static = b.build("cpu")
    assert static.mat_param_fns == ((m[0], albedo_torch),
                                    (m[2], albedo_torch_cool))


def test_fingerprint_sees_the_albedo_function(tmp_path):
    """Two scenes that differ only in the albedo function differ in the
    fingerprint, and a render of one does not resume the other's
    checkpoint; the same function made again (another object, the same
    code) resumes it."""
    s = RenderSettings(resolution=(6, 4), spp=1, max_bounces=1)
    (da, sa, cam), (db, sb, _c) = port_scene((6, 4)), port_scene(
        (6, 4), albedo_torch_cool)

    def fp(d, st):
        return checkpoint._fingerprint(s, 1, (d, st.mat_param_fns), cam)

    assert fp(da, sa) != fp(db, sb)

    def make():
        return lambda p, n: albedo_torch(p, n)

    assert make() is not make()
    assert fp(da, _with_fn(sa, make())) == fp(da, _with_fn(sa, make()))
    path = str(tmp_path / "ck.npz")
    fa = renderer.render_frame(da, sa, s, cam, checkpoint_path=path)
    fb = renderer.render_frame(db, sb, s, cam, checkpoint_path=path)
    ref_b = renderer.render_frame(db, sb, s, cam)
    assert torch.equal(fb.color, ref_b.color)
    assert not torch.equal(fa.color, fb.color)
    calls = []
    again = renderer.render_frame(da, _with_fn(sa, make()), s, cam,
                                  checkpoint_path=str(tmp_path / "a.npz"))
    resumed = renderer.render_frame(
        da, _with_fn(sa, make()), s, cam,
        checkpoint_path=str(tmp_path / "a.npz"),
        progress=lambda done, total: calls.append(done))
    assert calls == [] and torch.equal(again.color, resumed.color)


def _with_fn(static, fn):
    return dataclasses.replace(
        static, mat_param_fns=((static.mat_param_fns[0][0], fn),))


def test_albedo_function_changes_the_default_scene():
    """An albedo function on the MandelBox's material of the default
    scene moves its image and its albedo AOV there, and nowhere else."""
    res = (8, 8)
    data, static, cam = presets.default_scene(resolution=res, device="cpu")
    s = RenderSettings(resolution=res, spp=1, max_bounces=1, max_marches=24,
                       max_vis_marches=16, extra_aovs=("albedo", "mat_id"))
    plain = film.resolve(renderer.render_frame(data, static, s, cam), res, s)
    st = dataclasses.replace(static, mat_param_fns=((static.sdf_mat,
                                                     albedo_torch),))
    got = film.resolve(renderer.render_frame(data, st, s, cam), res, s)
    sdf = got.extra["mat_id"] == static.sdf_mat
    assert sdf.any() and (~sdf).any()
    assert not np.allclose(got.extra["albedo"][sdf],
                           plain.extra["albedo"][sdf])
    np.testing.assert_array_equal(got.extra["albedo"][~sdf],
                                  plain.extra["albedo"][~sdf])
    assert not np.array_equal(got.color, plain.color)
