"""User-written SDF closures inside the kernels (ops/sdf_expr.py): a
closure's fn_c lowered to an expression program that the ExprTape
kernels run. On the CPU the kernels' wrappers run their plain twins, so
these tests hold the lowering, its tape and its routing:

- `expr_dist_c` (the program run in torch, op for op as the CUDA
  interpreter) equals fn_c bit for bit on 10^4 seeded points, for the
  torus closure, a closure of every op of the set, a closure's reduced
  program and a closure in a Union with a library Sphere (through the
  tape's words and operands);
- the op words are the same traced on the CPU, on the meta device and
  on fake CUDA tensors (vecmath.sqrt is one SQRT, vecmath.div one DIV),
  `t / 2.0` is torch's CUDA `t * (1 / 2)` (DIVS), and new parameter
  values change the operands, not the words;
- routing: a kernel-ready closure scene takes the fused kernels with no
  warning; a closure without fn_c, with a non-scalar leaf or with an op
  outside the set keeps the torch route, each with its reason;
- the closure torus's fused film is the library Torus's, bit for bit;
- a JAX SdfProgram with fn_c and the port's closure give films within
  test_torch_closures.py's gates.
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
from rayn_tpu_torch.ops import intersect_cuda, sdf
from rayn_tpu_torch.ops import sdf_expr as ex
from rayn_tpu_torch.render import camera as tcamera
from rayn_tpu_torch.render import film, integrator, renderer
from rayn_tpu_torch.scene import scene as tscene
from rayn_tpu_torch.utils import vecmath

torch.set_num_threads(1)

RES = (16, 12)
BASE = RenderSettings(resolution=RES, spp=1, max_bounces=2, max_marches=64,
                      max_vis_marches=32, rays_per_pass=96)


def torus_c(prm, x, y, z):
    """The library Torus's DE (ops/sdf.py dist_c) as a closure's fn_c."""
    qx = vecmath.sqrt(x * x + z * z) - prm["major"]
    return vecmath.sqrt(qx * qx + y * y) - prm["minor"]


def every_c(prm, x, y, z):
    """Every op of the expression programs, with number and tensor
    parameters."""
    a = (vecmath.div(x, 3.0) + y / 2.0 + 2.0 / (z * z + 1.0) + y ** 2
         + x ** 3 + z ** -2 + (x * x + 1.0) ** 0.5)
    b = (torch.clamp(z, 0.0, 1.0) + torch.where(x > 0.5, x, 0.0)
         + torch.floor(x) - torch.abs(y))
    c = (torch.sin(x) * torch.cos(y) + torch.exp(-z * z)
         + torch.log(x * x + 1.0) + (x * x + 1.0) ** 1.7
         + torch.abs(x) ** prm["e"] + prm["r"] ** torch.abs(y))
    d = (torch.minimum(x, y) - torch.maximum(y, z)
         + torch.clamp(x, min=prm["lo"]) + x / prm["s"] - (-prm["k"]) * y
         + prm["k"] / (y * y + 2.0) + vecmath.div(x, prm["r"]))
    e = torch.where(((x < y) & (y <= z)) | ~(x >= 0.0),
                    vecmath.sqrt(x * x + 4.0),
                    (x == y).float() + (x != z) * 1.0)
    return a + b + c + d + e - prm["r"]


EVERY_PARAMS = {"e": 1.5, "lo": -0.25, "s": 3.0, "k": 0.7,
                "r": torch.tensor(0.3)}


def closure(fn_c, params, reduce_fn=None):
    return sdf.SdfProgram(
        lambda prm, p: fn_c(prm, p[..., 0], p[..., 1], p[..., 2]), params,
        fn_c, reduce_fn)


def closure_torus(major=1.3, minor=0.12):
    return closure(torus_c, {"major": major, "minor": minor})


def half_torus_c(prm, x, y, z):
    return torus_c(prm, x, y, z) * 0.5


def points(n=10_000, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.uniform(-2.0, 2.0, n).astype(np.float32))
            for _ in range(3)]


def bits(t):
    return t.contiguous().view(torch.int32)


def tape_dist(tp, x, y, z):
    """A torch run of a tape of closures, spheres, unions, translates and
    pops, each closure's program rebuilt from its inline words and its
    operands as the kernels read them."""
    ds, saved, k, q = [], [], 0, 0
    while k < len(tp.ops):
        code, op = tp.ops[k], tp.ops[k] & 0xFF
        k += 1
        if op == sdf.OP_EXPR:
            n, head = code >> 8, tp.ops[k]
            words = tp.ops[k + 1:k + n]
            n_prm = head & 0xFF
            ops, i = [], 0
            while i < len(words):
                ops.append(words[i] & 0xFF)
                i += 2 if words[i] & 0xFF == ex.X_WHERE else 1
            prog = ex.Expr(words, tuple(("const", v) for v in
                                        tp.operands[q:q + n_prm]), 0,
                           (head >> 8) & 0xFF, tuple(ops))
            ds.append(ex.expr_dist_c(prog, [], x, y, z))
            k, q = k + n, q + n_prm
        elif op == sdf.OP_SPHERE:
            ds.append(vecmath.sqrt(x * x + y * y + z * z) - tp.operands[q])
            q += 1
        elif op == sdf.OP_UNION:
            b = ds.pop()
            ds.append(torch.minimum(ds.pop(), b))
        elif op == sdf.OP_TRANSLATE:
            saved.append((x, y, z))
            x, y, z = (x - tp.operands[q], y - tp.operands[q + 1],
                       z - tp.operands[q + 2])
            q += 3
        elif op == sdf.OP_POP:
            x, y, z = saved.pop()
        else:
            raise AssertionError(op)
    return ds[0]


@pytest.mark.parametrize("case", ["torus", "every op", "reduced", "union"])
def test_expr_program_equals_fn_c(case):
    """The lowered program run in torch equals fn_c bit for bit."""
    x, y, z = points()
    if case == "union":
        prog = sdf.union(sdf.translate(closure_torus(), (0.1, -0.2, 0.3)),
                         sdf.sphere(0.5))
        want = sdf.dist_c(prog, x, y, z)
        got = tape_dist(sdf.tape(prog), x, y, z)
        assert sdf.tape(prog).ops[1] & 0xFF == sdf.OP_EXPR
    else:
        prog = {"torus": closure_torus(),
                "every op": closure(every_c, EVERY_PARAMS),
                "reduced": sdf.reduced(closure_torus()._replace(
                    reduce_fn=lambda it: (closure(half_torus_c, {}).fn,
                                          half_torus_c)), 8)}[case]
        assert sdf.kernel_ready(prog)
        want = prog.fn_c(prog.params, x, y, z)
        expr = ex.lower_closure(prog)
        got = ex.expr_dist_c(expr, sdf.param_leaves(prog.params), x, y, z)
        assert got.dtype == torch.float32
    assert torch.equal(bits(got), bits(want))
    if case == "every op":
        assert set(expr.ops) == set(range(11)) | set(range(16, 34))


def test_lowering_is_the_same_on_every_device():
    """The op words of a closure traced on the CPU (vecmath.sqrt through
    float64, vecmath.div a fill and a division), on the meta device and
    on fake CUDA tensors are the same: one SQRT a vecmath.sqrt."""
    torus = closure_torus()
    got = {d: ex.lower_closure(torus, d) for d in ("cpu", "meta", "cuda")}
    assert got["cpu"] == got["meta"] == got["cuda"]
    assert got["cpu"].ops == (ex.X_MUL, ex.X_MUL, ex.X_ADD, ex.X_SQRT,
                              ex.X_SUB, ex.X_MUL, ex.X_MUL, ex.X_ADD,
                              ex.X_SQRT, ex.X_SUB)
    every = closure(every_c, EVERY_PARAMS)
    assert ex.lower_closure(every, "cpu") == ex.lower_closure(every, "meta")


def test_division_rounds_as_torch_on_the_card():
    """`t / 2.0` by a number is DIVS (torch's CUDA t * (1 / c)), by a
    vecmath.div fill or a tensor parameter DIV, by a number parameter
    DIVS; parameter values are operands, so new values give the same
    words and other operands."""
    def ops(fn_c, params):
        return ex.lower_closure(closure(fn_c, params)).ops

    assert ops(lambda p, x, y, z: x / 2.0, {}) == (ex.X_DIVS,)
    assert ops(lambda p, x, y, z: vecmath.div(x, 2.0), {}) == (ex.X_DIV,)
    assert ops(lambda p, x, y, z: x / p["s"], {"s": 3.0}) == (ex.X_DIVS,)
    assert ops(lambda p, x, y, z: x / p["s"],
               {"s": torch.tensor(3.0)}) == (ex.X_DIV,)
    assert ops(lambda p, x, y, z: p["s"] / x, {"s": 3.0}) == (
        ex.X_RECIP, ex.X_MUL)
    a, b = sdf.tape(closure_torus(1.3, 0.12)), sdf.tape(closure_torus(
        1.5, 0.2))
    assert a.ops == b.ops and a.operands != b.operands
    assert b.operands == (np.float32(1.5), np.float32(0.2))
    # the kernels' tables are cached by the functions and the values
    t = closure_torus(1.3, 0.12)
    assert sdf.cache_key(t) == sdf.cache_key(t._replace(params={
        "major": 1.3, "minor": 0.12})) != sdf.cache_key(t._replace(params={
            "major": 1.5, "minor": 0.2}))


def _scene(second):
    b = tscene.SceneBuilder()
    b.add_sphere((0.0, 0.0, 0.0), 100.0,
                 b.add_sky((0.3, 0.4, 0.6), (0.01, 0.015, 0.03)))
    b.add_sphere_light((2.0, 2.5, 2.0), 0.4, (30.0, 24.0, 15.0))
    b.add_sphere((2.0, 2.5, 2.0), 0.39, b.add_emissive((3.0, 2.4, 1.5)))
    b.set_volume(0.25, 0.035)
    b.add_sdf(sdf.mandelbox(12, 1.0, 0.01, 1.9, -2.1),
              b.add_dielectric((0.2, 0.2, 0.2), 0.6), bound_radius=3.6)
    b.add_sdf(second, b.add_lambertian((0.6, 0.5, 0.4)), bound_radius=1.6)
    cam = tcamera.PinholeCamera.make(RES, 55.0, (0.5, 1.2, 4.2),
                                     (0.0, -0.3, 0.0), (0.0, 1.0, 0.0),
                                     device="cpu")
    return (*b.build("cpu"), cam)


def _render(second, **change):
    data, static, cam = _scene(second)
    return film.tensors(renderer.render_frame(
        data, static, dataclasses.replace(BASE, **change), cam))


ROUTES = {
    "ready": (closure_torus(), None),
    "no fn_c": (closure_torus()._replace(fn_c=None),
                "has no component-form fn_c"),
    "non-scalar leaf": (closure(
        lambda p, x, y, z: torus_c({"major": p["c"][0], "minor": p["c"][1]},
                                   x, y, z),
        {"c": torch.tensor([1.3, 0.12])}), "has non-scalar parameter leaves"),
    "op outside the set": (closure(
        lambda p, x, y, z: torch.atan2(y, x) * 0.0 + torus_c(p, x, y, z),
        {"major": 1.3, "minor": 0.12}), "aten.atan2"),
}


@pytest.mark.parametrize("case", sorted(ROUTES))
def test_routing(case, monkeypatch):
    """A kernel-ready closure takes the fused intersect (the kernel's
    wrapper) and warns nothing; the others keep the torch route and warn
    their reason, JAX's words where JAX has the limit."""
    prog, reason = ROUTES[case]
    calls = []
    hit = intersect_cuda.closest_hit_shading
    monkeypatch.setattr(intersect_cuda, "closest_hit_shading",
                        lambda *a, **k: calls.append(1) or hit(*a, **k))
    integrator._WARNED.clear()
    ex._WARNED.clear()
    small = dict(resolution=(8, 6), max_bounces=1, rays_per_pass=48)
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        data, static, cam = _scene(prog)
        cam = tcamera.PinholeCamera.make((8, 6), 55.0, (0.5, 1.2, 4.2),
                                         (0.0, -0.3, 0.0), (0.0, 1.0, 0.0),
                                         device="cpu")
        renderer.render_frame(data, static,
                              dataclasses.replace(BASE, **small), cam)
    msgs = [str(w.message) for w in got
            if issubclass(w.category, RuntimeWarning)]
    assert sdf.kernel_ready(prog) == (reason is None)
    if reason is None:
        assert calls and not msgs
        return
    assert not calls
    why = integrator._eligibility_reason(BASE, data, static)
    assert why.startswith("SDF instance 1 ") and reason in why
    assert sum(reason in m for m in msgs) >= 2, msgs
    with pytest.raises(NotImplementedError, match="no tape"):
        _build.sdf_args([(prog, 0, 1.0)], torch.device("cpu"))


def test_fused_closure_film_is_the_library_torus_film():
    """The closure torus's film on the fused route (the kernels' twins,
    fn_c) equals the library Torus's fused film bit for bit."""
    got = _render(closure_torus())
    want = _render(sdf.torus(1.3, 0.12))
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def jtorus_c(prm, x, y, z):
    qx = jnp.sqrt(x * x + z * z) - prm["major"]
    return jnp.sqrt(qx * qx + y * y) - prm["minor"]


def test_closure_with_fn_c_matches_jax():
    """JAX's closure with fn_c and the port's kernel-ready closure, its
    params filled from JAX's leaves by convert.scene, at 16x16, 2 spp,
    one bounce: test_torch_closures.py's gates."""
    res = (16, 16)
    kw = dict(resolution=res, spp=2, max_bounces=1, max_marches=24,
              max_vis_marches=16, rays_per_pass=res[0] * res[1] * 2)
    jprog = jsdf.SdfProgram(
        lambda prm, p: jtorus_c(prm, p[..., 0], p[..., 1], p[..., 2]),
        {"major": jnp.float32(1.3), "minor": jnp.float32(0.12)}, jtorus_c)
    b = jscene.SceneBuilder()
    b.add_sphere((0.0, 0.0, 0.0), 100.0,
                 b.add_sky((0.3, 0.4, 0.6), (0.01, 0.015, 0.03)))
    b.add_sphere_light((2.0, 2.5, 2.0), 0.4, (30.0, 24.0, 15.0))
    b.add_sphere((2.0, 2.5, 2.0), 0.39, b.add_emissive((3.0, 2.4, 1.5)))
    b.set_volume(0.25, 0.035)
    b.add_sdf(jsdf.mandelbox(12, 1.0, 0.01, 1.9, -2.1),
              b.add_dielectric((0.2, 0.2, 0.2), 0.6), bound_radius=3.6)
    b.add_sdf(jprog, b.add_lambertian((0.6, 0.5, 0.4)), bound_radius=1.6)
    jdata, jstatic = b.build()
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
    assert sdf.kernel_ready(prog) and prog.params == {
        "major": np.float32(1.3), "minor": np.float32(0.12)}
    tcam = convert.camera(jax.tree.map(np.asarray, jcam), device="cpu")
    got = film.resolve(renderer.render_frame(
        tdata, tstatic, RenderSettings(**kw), tcam, frame=1), res).color
    assert np.isfinite(got).all()
    rmse = float(np.sqrt(np.mean((got - want) ** 2)))
    assert rmse < 5e-3, rmse
    assert abs(got.mean() - want.mean()) / want.mean() < 1e-3
