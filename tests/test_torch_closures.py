"""User-written SDF closures in the port (ops/sdf.py SdfProgram): a
torch point-form DE with a nest of parameters. No kernel evaluates one,
so an instance of it marches in torch (ops/march.py) and a scene that
holds one takes the unfused route, as JAX routes a program with no fn_c.

- a JAX `SdfProgram(fn, params)` with no fn_c beside the port's closure,
  carried across with convert.scene and rendered on both (JAX op by op,
  its jnp route): RMSE < 5e-3 and mean relative difference < 1e-3
  (test_torch_render.py's fractal gates);
- the closure torus, written with the port's vecmath ops, bit for bit
  with the library Torus on the unfused route, and with the fused flags
  set (which the closure turns off, with one warning per feature);
- a scene of library and closure instances: the library one marches in
  the kernels' wrappers, the closure in torch;
- `reduced` (a closure's reduce_fn) and the checkpoint fingerprint (the
  functions' names and the params; captured values are not hashed, as
  in JAX).
"""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rayn_tpu.config import RenderSettings as JSettings
from rayn_tpu.ops import sdf as jsdf
from rayn_tpu.render import camera as jcamera
from rayn_tpu.render import film as jfilm
from rayn_tpu.render import renderer as jrenderer
from rayn_tpu.scene import scene as jscene
from rayn_tpu_torch import _build, convert
from rayn_tpu_torch.config import RenderSettings
from rayn_tpu_torch.ops import march as march_ops
from rayn_tpu_torch.ops import march_cuda, sdf, shade_cuda
from rayn_tpu_torch.render import camera as tcamera
from rayn_tpu_torch.render import checkpoint, film, integrator, renderer
from rayn_tpu_torch.scene import scene as tscene
from rayn_tpu_torch.utils import rng, vecmath

torch.set_num_threads(1)

RES = (16, 12)
BASE = RenderSettings(resolution=RES, spp=1, max_bounces=2, max_marches=64,
                      max_vis_marches=32, rays_per_pass=96)
UNFUSED = dict(use_fused_intersect=False, use_fused_shadows=False)


def torus_fn(prm, p):
    """The library Torus's DE (ops/sdf.py dist_c) as a closure."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    qx = vecmath.sqrt(x * x + z * z) - prm["major"]
    return vecmath.sqrt(qx * qx + y * y) - prm["minor"]


def jtorus_fn(prm, p):
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    qx = jnp.sqrt(x * x + z * z) - prm["major"]
    return jnp.sqrt(qx * qx + y * y) - prm["minor"]


def closure_torus(major=1.3, minor=0.12):
    return sdf.SdfProgram(torus_fn, {"major": major, "minor": minor})


def scene(pkg: str, second):
    """Sky, a light and its emissive body, the 12-iteration MandelBox
    (instance 0, bound 3.6) and `second` (instance 1, a tilted torus's
    place: moved 0.9 down, bound 1.6), built with JAX's SceneBuilder
    ("jax") or the port's: (data, static, camera)."""
    sc, cam_mod, m = ((jscene, jcamera, jsdf) if pkg == "jax"
                      else (tscene, tcamera, sdf))
    b = sc.SceneBuilder()
    b.add_sphere((0.0, 0.0, 0.0), 100.0,
                 b.add_sky((0.3, 0.4, 0.6), (0.01, 0.015, 0.03)))
    b.add_sphere_light((2.0, 2.5, 2.0), 0.4, (30.0, 24.0, 15.0))
    b.add_sphere((2.0, 2.5, 2.0), 0.39, b.add_emissive((3.0, 2.4, 1.5)))
    b.set_volume(0.25, 0.035)
    b.add_sdf(m.mandelbox(12, 1.0, 0.01, 1.9, -2.1),
              b.add_dielectric((0.2, 0.2, 0.2), 0.6), bound_radius=3.6)
    b.add_sdf(second, b.add_lambertian((0.6, 0.5, 0.4)), bound_radius=1.6)
    cam = (RES, 55.0, (0.5, 1.2, 4.2), (0.0, -0.3, 0.0), (0.0, 1.0, 0.0))
    if pkg == "jax":
        return (*b.build(), cam_mod.PinholeCamera.make(*cam))
    return (*b.build("cpu"), cam_mod.PinholeCamera.make(*cam, device="cpu"))


def _render(second, **change):
    data, static, cam = scene("torch", second)
    return film.tensors(renderer.render_frame(
        data, static, dataclasses.replace(BASE, **change), cam))


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def test_closure_matches_jax():
    """JAX's closure (no fn_c: its jnp route) and the port's, the port's
    params filled from JAX's leaves by convert.scene, at 16x16, 4 spp,
    one bounce."""
    res = (16, 16)
    kw = dict(resolution=res, spp=4, max_bounces=1, max_marches=24,
              max_vis_marches=16, rays_per_pass=res[0] * res[1] * 4)
    jprog = jsdf.SdfProgram(jtorus_fn, {"major": jnp.float32(1.3),
                                        "minor": jnp.float32(0.12)})
    jdata, jstatic, jcam = scene("jax", jprog)
    jcam = jcamera.PinholeCamera.make(res, 55.0, (0.5, 1.2, 4.2),
                                      (0.0, -0.3, 0.0), (0.0, 1.0, 0.0))
    with jax.disable_jit():
        want = np.asarray(jfilm.resolve(jrenderer.render_frame(
            jdata, jstatic, JSettings(**kw), jcam, frame=1), res).color)
    tdata, tstatic = convert.scene(
        jax.tree.map(np.asarray, jdata), jstatic, device="cpu",
        programs=[sdf.MandelBox(12, 0.0, 0.0, 0.0, 0.0),
                  closure_torus(0.0, 0.0)])
    prog = tstatic.sdf_instances(tdata)[1][0]
    assert prog.params == {"major": np.float32(1.3),
                           "minor": np.float32(0.12)}
    tcam = convert.camera(jax.tree.map(np.asarray, jcam), device="cpu")
    got = film.resolve(renderer.render_frame(
        tdata, tstatic, RenderSettings(**kw), tcam, frame=1), res).color
    assert np.isfinite(got).all()
    rmse = float(np.sqrt(np.mean((got - want) ** 2)))
    assert rmse < 5e-3, rmse
    assert abs(got.mean() - want.mean()) / want.mean() < 1e-3


@pytest.mark.parametrize("flags", ["unfused", "fused"])
def test_closure_torus_is_the_library_torus(flags):
    """The closure torus gives the library Torus's film bit for bit on
    the unfused route; with the fused flags set the closure scene takes
    that route itself (its cost key in torch), with the same bits."""
    want = _render(sdf.torus(1.3, 0.12), **UNFUSED)
    got = _render(closure_torus(), **(UNFUSED if flags == "unfused"
                                      else {}))
    assert _same(got, want)


def test_warns_once_per_feature():
    """A closure scene with the fused flags set warns once per feature
    and reason, in the words of JAX's warn_fallback, however many
    bounces and passes ask."""
    integrator._WARNED.clear()
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        _render(closure_torus())
        _render(closure_torus())
    msgs = sorted(str(w.message) for w in got
                  if issubclass(w.category, RuntimeWarning))
    reason = "SDF instance 1 has no component-form fn_c"
    assert msgs == [
        f"rayn_tpu_torch: fused intersect kernel unavailable ({reason}); "
        "falling back to the ~2x slower unfused path for this render",
        f"rayn_tpu_torch: fused shadow/finish kernels unavailable "
        f"({reason}); falling back to the ~2x slower unfused path for "
        "this render"]


def test_mixed_scene_routes_each_instance(monkeypatch):
    """The MandelBox (library) marches through the kernels' wrappers, the
    closure through the torch marches; the shadow queue's kernel march
    sees the library instance alone."""
    seen = {"march": [], "torch_march": [], "smarch": [], "occl": []}

    def spy(key, fn, pick):
        def call(*a, **kw):
            seen[key].append(pick(*a))
            return fn(*a, **kw)
        return call

    monkeypatch.setattr(march_cuda, "march", spy(
        "march", march_cuda.march, lambda p, *a: type(p).__name__))
    monkeypatch.setattr(march_ops, "march", spy(
        "torch_march", march_ops.march, lambda p, *a: type(p).__name__))
    monkeypatch.setattr(shade_cuda, "shadow_march", spy(
        "smarch", shade_cuda.shadow_march,
        lambda cfg, *a: [type(p).__name__ for p, _bv in cfg.sdfs]))
    monkeypatch.setattr(march_cuda, "march_occlusion_plain", spy(
        "occl", march_cuda.march_occlusion_plain,
        lambda p, *a: type(p).__name__))
    _render(closure_torus(), **UNFUSED)
    assert set(seen["march"]) == {"MandelBox"}
    assert "SdfProgram" in seen["torch_march"]
    assert seen["smarch"] and all(s == ["MandelBox"] for s in seen["smarch"])
    assert set(seen["occl"]) == {"SdfProgram"}
    with pytest.raises(NotImplementedError):
        sdf.tape(closure_torus())
    with pytest.raises(NotImplementedError):
        _build.sdf_args([(closure_torus(), 0, 0.0)], torch.device("cpu"))


def test_reduced_takes_the_reduce_fn():
    """reduced() gives a closure with a reduce_fn its reduced fn (the
    reduce_fn dropped, as JAX's SdfProgram.reduced), at 0 iterations or
    without a reduce_fn the program itself; shadow_cfg gives the shadow
    marches the reduced closure."""
    half = sdf.SdfProgram(lambda prm, p: torus_fn(prm, p) * 0.5,
                          {"major": 1.3, "minor": 0.12})
    prog = closure_torus()._replace(reduce_fn=lambda it: half.fn)
    r = sdf.reduced(prog, 8)
    assert (r.fn, r.params, r.fn_c, r.reduce_fn) == (
        half.fn, prog.params, None, None)
    assert sdf.reduced(prog, 0) is prog
    assert sdf.reduced(closure_torus(), 8) == closure_torus()
    pair = prog._replace(reduce_fn=lambda it: (half.fn, torus_fn))
    assert sdf.reduced(pair, 4).fn_c is torus_fn
    p = torch.tensor([[1.3, 0.5, 0.0], [0.0, 0.0, 2.0]])
    assert torch.equal(sdf.dist(r, p), sdf.dist(half, p))
    data, static, _cam = scene("torch", prog)
    cfg = shade_cuda.shadow_cfg(
        data, static, dataclasses.replace(BASE, shadow_de_iterations=8),
        rng.build_sample_tables(BASE, 1), 1)
    assert cfg.sdfs[1][0].fn is half.fn


def test_fingerprint_hashes_names_and_params():
    """Two closures differ in the checkpoint's fingerprint by their
    function or their params (a dict by its sorted keys); a value the
    function captures is not hashed, as in JAX (ROADMAP)."""
    s = RenderSettings(resolution=(4, 4), spp=1)

    def fp(prog):
        return checkpoint._fingerprint(s, 1, scene("torch", prog)[0])

    scale = [1.0]

    def captured(prm, p):
        return torus_fn(prm, p) * scale[0]

    base = fp(closure_torus())
    assert fp(closure_torus()) == base
    assert fp(closure_torus(minor=0.13)) != base
    assert fp(sdf.SdfProgram(torus_fn, {"minor": 0.12, "major": 1.3})) \
        == base
    assert fp(sdf.SdfProgram(captured, {"major": 1.3, "minor": 0.12})) \
        != base
    a = fp(sdf.SdfProgram(captured, {"major": 1.3, "minor": 0.12}))
    scale[0] = 2.0
    assert fp(sdf.SdfProgram(captured, {"major": 1.3, "minor": 0.12})) == a
    t = sdf.SdfProgram(torus_fn, {"major": torch.tensor(1.3),
                                  "minor": torch.tensor(0.12)})
    assert fp(t) != fp(t._replace(params={"major": torch.tensor(1.3),
                                          "minor": torch.tensor(0.125)}))
