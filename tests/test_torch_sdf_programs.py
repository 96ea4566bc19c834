"""SDF programs and several SDF instances in the port, against rayn_tpu.

- every primitive and combinator of rayn_tpu/ops/sdf.py, and one nested
  program that uses every opcode: the port's plain DE against JAX's fn_c
  on 4,096 points, bit for bit; the tetrahedral normal and `reduced`
  (which acts on a bare MandelBox only, as JAX's does);
- the tape the CUDA kernels read: it round-trips to the program, a
  postfix model of csrc/common.cuh tape_de gives the plain DE's bits,
  and a program deeper than the stacks raises;
- tests/test_multi_sdf.py's two-instance scene carried across with
  convert.scene: closest hit (t and object id K + i), occlusion and
  shading info against JAX's functions, and the plain twins of the
  kernels against the plain functions;
- the image gate of test_torch_render.py (16x16, 4 spp, one bounce: RMSE
  < 1.5e-3, mean relative difference < 1e-3) on that scene and on a
  small version of the program scene (the default scene plus a second,
  program instance), fused and relaxed;
- the checkpoint fingerprint and convert.scene's refusals.

JAX runs op by op (`jax.disable_jit`) through its plain jnp paths, as
in test_torch_render.py; no Pallas kernel runs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rayn_tpu.config import RenderSettings as JSettings
from rayn_tpu.ops import intersect as jintersect
from rayn_tpu.ops import sdf as jsdf
from rayn_tpu.render import camera as jcamera
from rayn_tpu.render import film as jfilm
from rayn_tpu.render import integrator as jint
from rayn_tpu.render import renderer as jrenderer
from rayn_tpu.scene import scene as jscene
from rayn_tpu_torch import convert
from rayn_tpu_torch.config import RenderSettings
from rayn_tpu_torch.ops import intersect, intersect_cuda, march_cuda, sdf
from rayn_tpu_torch.ops import shade_cuda
from rayn_tpu_torch.render import camera as tcamera
from rayn_tpu_torch.render import checkpoint, film, renderer
from rayn_tpu_torch.scene import scene as tscene
from rayn_tpu_torch.utils import rng
from test_multi_sdf import two_sdf_scene

torch.set_num_threads(1)


def _programs(m):
    """Each primitive and combinator of the SDF module `m` (JAX's or the
    port's), and two programs that nest them."""
    s, b = m.sphere(0.7), m.box((0.5, 0.3, 0.8))
    t, mb = m.torus(1.2, 0.1), m.mandelbox(12, 1.0, 0.5, 1.0, -2.0)
    return {
        "mandelbox": mb, "sphere": s, "box": b, "torus": t,
        "plane": m.plane((0.3, 1.0, -0.2), 0.4),
        "union": m.union(s, b), "intersection": m.intersection(s, b),
        "subtraction": m.subtraction(b, s),
        "smooth_union": m.smooth_union(s, b, 0.3),
        "translate": m.translate(t, (0.1, -0.2, 0.3)),
        "scale": m.scale(b, 1.7), "rounded": m.rounded(b, 0.05),
        # the program scene's instance 1
        "slab": m.translate(m.smooth_union(
            m.rounded(m.box((2.0, 0.1, 2.0)), 0.05), m.torus(1.2, 0.1),
            0.2), (0.0, -2.6, 0.0)),
        # every opcode
        "every_op": m.union(
            m.scale(m.subtraction(m.intersection(mb, m.sphere(1.5)),
                                  m.plane((0.0, 1.0, 0.0), 0.2)), 0.8),
            m.translate(m.smooth_union(m.rounded(m.torus(1.0, 0.2), 0.05),
                                       m.box((0.3, 0.3, 0.3)), 0.25),
                        (0.5, 0.5, 0.5))),
    }


NAMES = sorted(_programs(sdf))
PTS = np.random.default_rng(13).uniform(-3.0, 3.0, (4096, 3)).astype(
    np.float32)


def _jax_dist(prog, pts):
    with jax.disable_jit():
        return np.asarray(prog.fn_c(prog.params, *(jnp.asarray(pts[:, i])
                                                   for i in range(3))))


def _same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and bool(np.all(
        (a.view(np.int32) == b.view(np.int32)) | (np.isnan(a) & np.isnan(b))))


def _tensors(pts):
    return [torch.from_numpy(pts[:, i].copy()) for i in range(3)]


@pytest.mark.parametrize("name", NAMES)
def test_dist_matches_jax(name):
    """The plain DE equals JAX's fn_c bit for bit, and the program's
    leaves are JAX's parameter leaves in pytree order."""
    jp, tp = _programs(jsdf)[name], _programs(sdf)[name]
    want = _jax_dist(jp, PTS)
    got = sdf.dist_c(tp, *_tensors(PTS)).numpy()
    assert _same_bits(got, want)
    assert sdf.leaves(tp) == [float(v) for v in jax.tree.leaves(jp.params)]


@pytest.mark.parametrize("name", ["mandelbox", "slab", "every_op"])
def test_tetrahedral_normal_matches_jax(name):
    jp, tp = _programs(jsdf)[name], _programs(sdf)[name]
    eps = np.random.default_rng(3).uniform(1e-4, 1e-2, 4096).astype(
        np.float32)
    with jax.disable_jit():
        want = np.asarray(jsdf.tetrahedral_normal(jp, jnp.asarray(PTS),
                                                  jnp.asarray(eps)))
    got = sdf.tetrahedral_normal(tp, torch.from_numpy(PTS),
                                 torch.from_numpy(eps)).numpy()
    assert _same_bits(got, want)


@pytest.mark.parametrize("case", ["bare", "in_union", "zero"])
def test_reduced_matches_jax(case):
    """A bare MandelBox reduces to the shadow iterations; one inside a
    combinator keeps its full iterations, as JAX's _from_c drops the
    reduce_fn; at 0 nothing changes."""
    def make(m):
        mb = m.mandelbox(12, 1.0, 0.01, 1.9, -2.1)
        return mb if case != "in_union" else m.union(mb, m.sphere(0.3))
    iters = 0 if case == "zero" else 8
    jp, tp = make(jsdf).reduced(iters), sdf.reduced(make(sdf), iters)
    assert _same_bits(sdf.dist_c(tp, *_tensors(PTS)).numpy(),
                      _jax_dist(jp, PTS))
    full = sdf.dist_c(make(sdf), *_tensors(PTS)).numpy()
    assert _same_bits(full, sdf.dist_c(tp, *_tensors(PTS)).numpy()) == (
        case != "bare")


# operands each opcode reads from the instance's operand stream
N_OPERANDS = {sdf.OP_MBOX: 4, sdf.OP_SPHERE: 1, sdf.OP_BOX: 3,
              sdf.OP_TORUS: 2, sdf.OP_PLANE: 4, sdf.OP_UNION: 0,
              sdf.OP_INTERSECTION: 0, sdf.OP_SUBTRACTION: 0,
              sdf.OP_SMOOTH_UNION: 1, sdf.OP_TRANSLATE: 3, sdf.OP_SCALE: 1,
              sdf.OP_ROUNDED: 1, sdf.OP_POP: 0, sdf.OP_POP_SCALE: 1}


def from_tape(tp):
    """The program a tape was lowered from (the inverse of sdf.tape)."""
    stack, saved, it = [], [], iter(tp.operands)
    leaf_type = {v: k for k, v in sdf.LEAF_OP.items()}
    binary_type = {v: k for k, v in sdf.BINARY_OP.items()}

    def take(op):
        return [next(it) for _ in range(N_OPERANDS[op])]

    for code in tp.ops:
        op = code & 0xFF
        if op == sdf.OP_MBOX:
            stack.append(sdf.MandelBox(code >> 8, *take(op)))
        elif op in leaf_type:
            stack.append(leaf_type[op](*take(op)))
        elif op in binary_type:
            b, a = stack.pop(), stack.pop()
            stack.append(binary_type[op](a, b, *take(op)))
        elif op in (sdf.OP_TRANSLATE, sdf.OP_SCALE):
            saved.append((op, take(op)))
        elif op in (sdf.OP_POP, sdf.OP_POP_SCALE):
            kind, args = saved.pop()
            take(op)
            stack.append((sdf.Translate if kind == sdf.OP_TRANSLATE
                          else sdf.Scale)(stack.pop(), *args))
        else:
            assert op == sdf.OP_ROUNDED, code
            stack.append(sdf.Rounded(stack.pop(), *take(op)))
    assert len(stack) == 1 and not saved
    return stack[0]


def _tape_model(tp, x, y, z):
    """csrc/common.cuh tape_de in torch: the postfix program over a stack
    of distances and a stack of saved points."""
    d, saved, q = [], [], iter(tp.operands)
    for code in tp.ops:
        op = code & 0xFF
        if op in (sdf.OP_MBOX, sdf.OP_SPHERE, sdf.OP_BOX, sdf.OP_TORUS,
                  sdf.OP_PLANE):
            leaf = from_tape(sdf.Tape((code,), tuple(
                next(q) for _ in range(N_OPERANDS[op])), 1, 0))
            d.append(sdf.dist_c(leaf, x, y, z))
        elif op in (sdf.OP_UNION, sdf.OP_INTERSECTION, sdf.OP_SUBTRACTION):
            b, a = d.pop(), d.pop()
            d.append(torch.minimum(a, b) if op == sdf.OP_UNION else
                     torch.maximum(a, b) if op == sdf.OP_INTERSECTION else
                     torch.maximum(a, -b))
        elif op == sdf.OP_SMOOTH_UNION:
            b, a = d.pop(), d.pop()
            d.append(sdf.dist_c(sdf.SmoothUnion(
                sdf.Plane(1.0, 0.0, 0.0, 0.0), sdf.Plane(0.0, 1.0, 0.0, 0.0),
                next(q)), a, b, z))
        elif op == sdf.OP_TRANSLATE:
            saved.append((x, y, z))
            x, y, z = x - next(q), y - next(q), z - next(q)
        elif op == sdf.OP_SCALE:
            saved.append((x, y, z))
            f = next(q)
            x, y, z = (sdf._div(c, f) for c in (x, y, z))
        elif op == sdf.OP_ROUNDED:
            d.append(d.pop() - next(q))
        elif op == sdf.OP_POP:
            x, y, z = saved.pop()
        elif op == sdf.OP_POP_SCALE:
            x, y, z = saved.pop()
            d.append(d.pop() * next(q))
    assert len(d) == 1 and not saved
    return d[0]


@pytest.mark.parametrize("name", NAMES)
def test_tape_round_trips(name):
    """The tape lowers the program and back, and run as the kernels run
    it (postfix, op by op) it gives the plain DE's bits."""
    prog = _programs(sdf)[name]
    tp = sdf.tape(prog)
    assert from_tape(tp) == prog
    assert 1 <= tp.depth <= sdf.DEPTH_CAP and tp.points <= sdf.DEPTH_CAP
    xyz = _tensors(PTS)
    assert _same_bits(_tape_model(tp, *xyz).numpy(),
                      sdf.dist_c(prog, *xyz).numpy())


def _deep(kind, n):
    p = sdf.sphere(0.5)
    for i in range(n):
        p = (sdf.union(sdf.sphere(0.1 * i), p) if kind == "distances"
             else sdf.translate(p, (0.1, 0.0, 0.0)))
    return p


@pytest.mark.parametrize("kind", ["distances", "points"])
def test_tape_depth_cap_raises(kind):
    """A program whose stack would pass DEPTH_CAP is no longer refused:
    tape() lowers it with its depth, set_sdf and add_sdf take it, and
    _build.sdf_args gives it the DeepTape kernels (tape 2), while one at
    the cap keeps the Tape kernels (tape 1)."""
    from rayn_tpu_torch import _build

    ok = _deep(kind, sdf.DEPTH_CAP - (kind == "distances"))
    assert max(sdf.tape(ok)[2:]) == sdf.DEPTH_CAP
    deep = _deep(kind, sdf.DEPTH_CAP + 1)
    assert max(sdf.tape(deep)[2:]) > sdf.DEPTH_CAP
    assert _from_tape_ok(deep)
    b = tscene.SceneBuilder()
    mat = b.add_lambertian((0.5,) * 3)
    b.set_sdf(deep, mat)
    assert b.add_sdf(deep, mat) == 1
    cpu = torch.device("cpu")
    assert _build.sdf_args([(ok, mat, 0.0)], cpu, 64)[1].tape == 1
    assert _build.sdf_args([(deep, mat, 0.0)], cpu, 64)[1].tape == 2


def _from_tape_ok(prog):
    """The tape of `prog` lowers back to it and runs to dist_c's bits."""
    tp = sdf.tape(prog)
    xyz = _tensors(PTS)
    return from_tape(tp) == prog and _same_bits(
        _tape_model(tp, *xyz).numpy(), sdf.dist_c(prog, *xyz).numpy())


def test_scene_takes_programs_and_instances():
    b = tscene.SceneBuilder()
    red, blue = b.add_lambertian((0.7, 0.2, 0.2)), b.add_lambertian(
        (0.2, 0.2, 0.7))
    progs = _programs(sdf)
    assert b.add_sdf(progs["every_op"], red, bound_radius=3.0) == 0
    assert b.add_sdf(progs["slab"], blue, bound_radius=4.3) == 1
    assert b.add_sdf(progs["mandelbox"], red) == 2
    b.add_sphere((0.0, 0.0, 0.0), 50.0, b.add_sky((1,) * 3, (0,) * 3))
    data, static = b.build("cpu")
    assert static.sdf_mat == red and static.sdf_bound_radius == 3.0
    assert static.sdf_instances(data) == [
        (progs["every_op"], red, 3.0), (progs["slab"], blue, 4.3),
        (progs["mandelbox"], red, 0.0)]
    with pytest.raises(NotImplementedError, match="closure"):
        b.set_sdf(lambda p, x, y, z: x, red)
    # a user-written closure is a program: set_sdf and add_sdf take it
    closure = sdf.SdfProgram(
        lambda prm, p: torch.linalg.vector_norm(p, dim=-1) - prm["r"],
        {"r": 0.5})
    assert b.add_sdf(closure, blue, bound_radius=1.0) == 3
    data, static = b.build("cpu")
    assert static.sdf_instances(data)[3] == (closure, blue, 1.0)


# ------------------------------------------------ two instances, carried
def _two_scene():
    jdata, jstatic, jcam = two_sdf_scene()
    # the structure of each instance; JAX's leaves fill in the numbers
    shape = sdf.translate(sdf.sphere(1.0), (0.0, 0.0, 0.0))
    tdata, tstatic = convert.scene(jax.tree.map(np.asarray, jdata), jstatic,
                                   programs=[shape, shape], device="cpu")
    return jdata, jstatic, jcam, tdata, tstatic


def _rays(n=256, seed=5):
    g = np.random.default_rng(seed)
    o = g.uniform((-2.0, -1.0, 2.0), (2.0, 1.0, 3.0), (n, 3))
    d = g.uniform((-1.5, -0.6, -0.5), (1.5, 0.6, 0.5), (n, 3)) - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return o.astype(np.float32), d


QUERY_KW = dict(resolution=(8, 6), rays_per_pass=64, max_marches=64,
                max_vis_marches=32)


@pytest.mark.parametrize("query", ["closest_hit", "shading_info",
                                   "test_occluded"])
def test_two_instances_match_jax(query):
    """closest_hit (t, object id K + i), shading_info (normal, offset,
    material of the instance hit) and test_occluded (the product fold)
    of the port against JAX's on the same rays, bit for bit."""
    jdata, jstatic, _jc, tdata, tstatic = _two_scene()
    js, ts = JSettings(**QUERY_KW), RenderSettings(**QUERY_KW)
    o, d = _rays()
    n = o.shape[0]
    zeros, ones = np.zeros(n, np.float32), np.ones(n, bool)
    t_max = np.full(n, 200.0, np.float32)
    hps = np.full(n, 1e-3, np.float32)
    j = [jnp.asarray(v) for v in (o, d, zeros, t_max, hps, hps, ones)]
    t = [torch.from_numpy(v.copy()) for v in (o, d, zeros, t_max, hps, hps,
                                              ones)]
    with jax.disable_jit():
        jhit = jintersect.closest_hit(jdata, jstatic, js, *j)
        thit = intersect.closest_hit(tdata, tstatic, ts, *t)
        assert _same_bits(thit.t.numpy(), np.asarray(jhit.t))
        assert np.array_equal(thit.obj.numpy(), np.asarray(jhit.obj))
        # both instances and the sky are hit
        assert set(np.asarray(jhit.obj).tolist()) >= {0, 1, 2}
        jinfo = jintersect.shading_info(jdata, jstatic, js, jhit, j[0], j[1],
                                        j[2], j[4], j[5])
        tinfo = intersect.shading_info(tdata, tstatic, ts, thit, t[0], t[1],
                                       t[2], t[4], t[5])
        if query == "shading_info":
            for name in ("point", "normal", "offset_by", "mat"):
                assert _same_bits(getattr(tinfo, name).numpy(),
                                  np.asarray(getattr(jinfo, name))), name
            assert set(tinfo.mat[thit.obj >= 1].tolist()) == {1, 2}
        if query == "test_occluded":
            light = np.asarray(jdata.light_pos.values[0, 0])
            start = np.asarray(jinfo.point) + 1e-3 * np.asarray(jinfo.normal)
            g = np.random.default_rng(7)
            start[::2] = g.uniform(-1.5, 1.5, (n // 2, 3))
            end = np.broadcast_to(light, start.shape).copy()
            end[1::4] = g.uniform(-1.5, 1.5, (len(end[1::4]), 3))
            start, end = start.astype(np.float32), end.astype(np.float32)
            act = np.asarray(jhit.valid) | (np.arange(n) % 2 == 0)
            want = np.asarray(jintersect.test_occluded(
                jdata, jstatic, js, jnp.asarray(start), jnp.asarray(end),
                j[2], jnp.asarray(act)))
            got = intersect.test_occluded(
                tdata, tstatic, ts, torch.from_numpy(start),
                torch.from_numpy(end), t[2], torch.from_numpy(act)).numpy()
            assert np.array_equal(got, want)
            assert 0 < (want == 0).sum() < n


@pytest.mark.parametrize("twin", ["closest_hit_shading", "cost_key",
                                  "shadow_march", "sort_key"])
def test_two_instance_twins(twin):
    """The kernels' plain twins fold over the instances as the plain
    functions do: the fused closest hit against closest_hit +
    shading_info (the normal within 1e-6: the twin, as JAX's fused
    kernel, multiplies by the norm's reciprocal where tetrahedral_normal
    divides), the cost key against JAX's _intersect_cost_key, the
    shadow march against march_occlusion folded per instance, and the
    sort key against the sum of its one-instance keys (rtol 1e-6: the
    twin sums a segment's instance costs before adding them to the key,
    as JAX's seg_cost does, and the sum of keys adds in another order)."""
    jdata, jstatic, _jc, data, static = _two_scene()
    s = RenderSettings(**QUERY_KW)
    o, d = _rays()
    n = o.shape[0]
    org, dirn = torch.from_numpy(o), torch.from_numpy(d)
    zeros = torch.zeros(n)
    ones = torch.ones(n, dtype=torch.bool)
    hps = torch.full((n,), 1e-3)
    if twin == "closest_hit_shading":
        hit, info = intersect_cuda.closest_hit_shading_plain(
            data, static, s, org, dirn, hps, hps, ones, zeros)
        t_max = torch.full((n,), 2.0 * s.world_radius)
        want = intersect.closest_hit(data, static, s, org, dirn, zeros,
                                     t_max, hps, hps, ones)
        winfo = intersect.shading_info(data, static, s, want, org, dirn,
                                       zeros, hps, hps)
        assert _same_bits(hit.t.numpy(), want.t.numpy())
        assert torch.equal(hit.obj, want.obj)
        for name in ("point", "offset_by", "mat"):
            assert _same_bits(getattr(info, name).numpy(),
                              getattr(winfo, name).numpy()), name
        assert torch.allclose(info.normal, winfo.normal, rtol=0.0,
                              atol=1e-6)
        assert set(info.mat[hit.obj >= 1].tolist()) == {1, 2}
        return
    if twin == "cost_key":
        alive = torch.from_numpy(np.arange(n) % 3 != 0)
        got = intersect_cuda.intersect_cost_key_plain(data, static, s, org,
                                                      dirn, zeros, alive)
        jstate = jint.init_state(*(jnp.asarray(v) for v in (
            o, d, np.zeros(n, np.float32), np.zeros(n, np.int32),
            np.zeros(n, np.int32), alive.numpy())))
        with jax.disable_jit():
            want = jint._intersect_cost_key(jdata, jstatic, JSettings(
                **QUERY_KW), jstate)
        assert _same_bits(got.numpy(), np.asarray(want))
        return
    tables = rng.build_sample_tables(s, 1)
    cfg = shade_cuda.shadow_cfg(data, static, s, tables, 1)
    assert len(cfg.sdfs) == 2
    tabs = shade_cuda.scene_tables(data, static)
    hit, info = intersect_cuda.closest_hit_shading_plain(
        data, static, s, org, dirn, hps, hps, ones, zeros)
    live = hit.valid
    if twin == "shadow_march":
        g = np.random.default_rng(9)
        start = torch.from_numpy(g.uniform(-1.5, 1.5, (n, 3)).astype(
            np.float32))
        end = torch.from_numpy(g.uniform(-2.5, 2.5, (n, 3)).astype(
            np.float32))
        segs = shade_cuda.ShadowSegments(
            geom=torch.cat([start, end], -1).T.reshape(6, 1, n).contiguous(),
            k=torch.zeros(3, 1, n), active=ones[None],
            queue=torch.arange(n, dtype=torch.int32),
            count=torch.tensor([n], dtype=torch.int32))
        got = shade_cuda.shadow_march_plain(cfg, segs)[0]
        want = torch.zeros(n, dtype=torch.bool)
        for prog, bv in cfg.sdfs:
            want = want | march_cuda.march_occlusion_plain(
                prog, start, end, cfg.detail, cfg.max_steps, ones & ~want,
                bound_radius=bv)
        assert torch.equal(got, want) and 0 < int(want.sum()) < n
        return
    key_args = (tabs, info.point, info.normal, info.offset_by, org, dirn,
                hit.t, live, live, torch.zeros(n, dtype=torch.int32),
                torch.arange(n, dtype=torch.int32), zeros)
    both = shade_cuda.shadow_sort_key_plain(cfg, *key_args)
    each = [shade_cuda.shadow_sort_key_plain(cfg._replace(sdfs=(inst,)),
                                             *key_args)
            for inst in cfg.sdfs]
    assert torch.allclose(both, each[0] + each[1], rtol=1e-6, atol=0.0)
    assert (both > each[0]).all()


# ----------------------------------------------------------- the images
def program_scene(pkg: str, resolution):
    """presets.default_scene's scene with its MandelBox as instance 0
    (bound 3.6) and, as instance 1, a rounded slab smooth-unioned with a
    torus, moved 2.6 down, with a lambertian material of its own (bound
    4.3 contains it), built with JAX's SceneBuilder (pkg "jax") or the
    port's: (data, static, camera)."""
    m, sc, cam_mod = ((jsdf, jscene, jcamera) if pkg == "jax"
                      else (sdf, tscene, tcamera))
    b = sc.SceneBuilder()
    b.set_volume(0.25, 0.035)
    sky = b.add_sky(top=(0.3, 0.4, 0.6),
                    bottom=np.asarray((0.2, 0.3, 0.6), np.float32) * 0.05)
    b.add_sphere((0.0, 0.0, 0.0), 100.0, sky)
    grey = b.add_dielectric(albedo=(0.2, 0.2, 0.2), roughness=0.6)
    b.add_sdf(m.mandelbox(iterations=12, box_fold_l=1.0, sphere_min_rad=0.01,
                          sphere_fixed_rad=1.9, scale=-2.1), grey,
              bound_radius=3.6)
    green = np.asarray((1.5, 4.5, 3.0), np.float32)
    green = green / np.linalg.norm(green)
    blue = np.asarray((1.5, 3.0, 4.5), np.float32)
    blue = blue / np.linalg.norm(blue)
    blue_emissive = b.add_emissive(blue * 3.0)
    green_emissive = b.add_emissive(green * 3.0)
    for pos, rad in [((1.2, -1.2, 1.2), 0.15), ((-1.2, 1.2, 1.2), 0.15)]:
        pos = np.asarray(pos, np.float32)
        green_pos = pos * np.asarray((1.0, -1.0, 1.0), np.float32)
        b.add_sphere_light(green_pos, rad, green * 40.0)
        b.add_sphere_light(pos, rad, blue * 40.0)
        b.add_sphere(green_pos, rad - 0.01, green_emissive)
        b.add_sphere(pos, rad - 0.01, blue_emissive)
    b.add_sphere_light((0.0, 0.0, 0.0), 0.25, green * 20.0)
    b.add_sphere((0.0, 0.0, 0.0), 0.24, green_emissive)
    slab = b.add_lambertian((0.6, 0.5, 0.4))
    b.add_sdf(_programs(m)["slab"], slab, bound_radius=4.3)
    origin = np.asarray((-0.45, 0.2, 2.0), np.float32) * 2.25
    cam_args = (resolution, 60.0, origin, (0.0, 0.0, 0.0), (0.0, 1.0, 0.0))
    if pkg == "jax":
        return (*b.build(), cam_mod.PinholeCamera.make(*cam_args))
    return (*b.build("cpu"),
            cam_mod.PinholeCamera.make(*cam_args, device="cpu"))


RES = (16, 16)


def _image_vs_jax(scene: str, **change):
    kw = dict(resolution=RES, spp=4, max_bounces=1, max_marches=24,
              max_vis_marches=16, rays_per_pass=RES[0] * RES[1] * 4)
    kw.update(change)
    if scene == "two_sdf":
        jdata, jstatic, jcam, tdata, tstatic = _two_scene()
        jcam = two_sdf_scene(RES)[2]
    else:
        jdata, jstatic, jcam = program_scene("jax", RES)
        tdata, tstatic, _ = program_scene("torch", RES)
        assert convert.scene(jax.tree.map(np.asarray, jdata), jstatic,
                             programs=[p for p, _m, _b in
                                       tstatic.sdf_instances(tdata)],
                             device="cpu")[0].extra_sdf_params == \
            tdata.extra_sdf_params
    with jax.disable_jit():
        want = np.asarray(jfilm.resolve(jrenderer.render_frame(
            jdata, jstatic, JSettings(**kw), jcam, frame=1), RES).color)
    tcam = convert.camera(jax.tree.map(np.asarray, jcam), device="cpu")
    f = renderer.render_frame(tdata, tstatic, RenderSettings(**kw), tcam,
                              frame=1)
    got = film.resolve(f, RES).color
    assert np.isfinite(got).all()
    rmse = float(np.sqrt(np.mean((got - want) ** 2)))
    return rmse, abs(got.mean() - want.mean()) / want.mean()


@pytest.mark.parametrize("path", ["fused", "relaxed"])
@pytest.mark.parametrize("scene", ["two_sdf", "program"])
def test_image_matches_jax(scene, path):
    """The fused path (the intersect and bounce-tail kernels' twins) and
    the relaxed segment queue, gated as test_torch_render.py gates the
    default scene."""
    change = {"march_relaxation": 1.5} if path == "relaxed" else {}
    rmse, mean_rel = _image_vs_jax(scene, **change)
    assert rmse < 1.5e-3, rmse
    assert mean_rel < 1e-3, mean_rel


# ---------------------------------------------- checkpoint and convert
def test_checkpoint_fingerprint_sees_operations(tmp_path):
    """Two scenes whose programs have equal leaves but other operations
    refuse each other's checkpoint (render_frame keys it on the
    SceneData)."""
    def scene(op):
        b = tscene.SceneBuilder()
        b.add_sphere((0.0, 0.0, 0.0), 50.0, b.add_sky((1,) * 3, (0,) * 3))
        b.set_sdf(op(sdf.sphere(0.5), sdf.box((0.4, 0.4, 0.4))),
                  b.add_lambertian((0.5,) * 3))
        return b.build("cpu")
    a, b = scene(sdf.union)[0], scene(sdf.intersection)[0]
    assert sdf.leaves(a.sdf_params) == sdf.leaves(b.sdf_params)
    s = RenderSettings(resolution=(4, 4), spp=1)
    assert checkpoint._fingerprint(s, 1, a) != checkpoint._fingerprint(
        s, 1, b)
    path = str(tmp_path / "ck.npz")
    checkpoint.save(path, film.new_film(16, device="cpu"), s, 1, 1, scene=a)
    assert checkpoint.load_progress(path, s, 1, scene=a) is not None
    assert checkpoint.load_progress(path, s, 1, scene=b) is None


@pytest.mark.parametrize("case", ["leaf_count", "unknown_program",
                                  "iterations_only", "program_count"])
def test_convert_refuses(case):
    jdata, jstatic, _ = two_sdf_scene()
    jdata = jax.tree.map(np.asarray, jdata)
    shape = sdf.translate(sdf.sphere(1.0), (0.0, 0.0, 0.0))
    kw = {"leaf_count": dict(programs=[shape, sdf.sphere(1.0)]),
          "unknown_program": dict(programs=[shape, (1.0, 2.0, 3.0, 4.0)]),
          "iterations_only": dict(sdf_iterations=12),
          "program_count": dict(programs=[shape])}[case]
    err = (ValueError if case in ("leaf_count", "program_count")
           else NotImplementedError)
    with pytest.raises(err):
        convert.scene(jdata, jstatic, device="cpu", **kw)


def test_shadow_cfg_reduces_bare_mandelbox_only():
    """shadow_cfg gives each instance its reduced program and its bound
    radius where shadow_bv_clip is set: the bare MandelBox at the shadow
    iterations, a MandelBox inside a union at its full ones."""
    b = tscene.SceneBuilder()
    b.add_sphere((0.0, 0.0, 0.0), 50.0, b.add_sky((1,) * 3, (0,) * 3))
    mat = b.add_lambertian((0.5,) * 3)
    mb = sdf.mandelbox(12, 1.0, 0.01, 1.9, -2.1)
    b.add_sdf(mb, mat, bound_radius=3.6)
    b.add_sdf(sdf.union(mb, sdf.sphere(0.2)), mat, bound_radius=3.7)
    b.add_sphere_light((2.0, 2.0, 2.0), 0.2, (1.0, 1.0, 1.0))
    data, static = b.build("cpu")
    for clip in (True, False):
        s = RenderSettings(resolution=(4, 4), shadow_de_iterations=8,
                           shadow_bv_clip=clip)
        cfg = shade_cuda.shadow_cfg(data, static, s,
                                    rng.build_sample_tables(s, 1), 1)
        assert cfg.sdfs == ((mb._replace(iterations=8), 3.6 * clip),
                            (sdf.union(mb, sdf.sphere(0.2)), 3.7 * clip))
        assert shade_cuda.unclipped(cfg).sdfs == tuple(
            (p, 0.0) for p, _ in cfg.sdfs)
    assert dataclasses.replace(static).extra_sdfs[0].bound_radius == 3.7
