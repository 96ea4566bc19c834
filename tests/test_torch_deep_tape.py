"""SDF programs deeper than the Tape kernels' stacks (ops/sdf.py
DEPTH_CAP, csrc/common.cuh kSdfDepth): the DeepTape kernels keep the
distance and point stacks of each thread in a device scratch
(csrc/common.cuh DeepStacks, _build.sdf_args).

- the tape of 12-deep programs (12 distances, 12 saved points, both)
  run as the DeepTape kernels run it, with its stacks in the scratch's
  layout (row k of `slots` for distance k, rows depth + k, depth +
  points + k and depth + 2 * points + k for saved point k), gives
  dist_c's bits;
- `_build.sdf_args` picks the DeepTape kernels (tape 2) exactly when a
  program of the scene needs more than DEPTH_CAP, and sizes the scratch
  for the launch's grid;
- the scene builder takes such programs, and a frame renders with one.
No JAX here; the kernels themselves run in tests/test_torch_gpu.py and
chip_smoke.py phase 18.
"""

import math

import numpy as np
import pytest
import torch

from rayn_tpu_torch import _build
from rayn_tpu_torch.config import RenderSettings
from rayn_tpu_torch.ops import sdf
from rayn_tpu_torch.render import film, renderer
from rayn_tpu_torch.scene import presets
from rayn_tpu_torch.scene import scene as tscene

torch.set_num_threads(1)

N_OPERANDS = {sdf.OP_MBOX: 4, sdf.OP_SPHERE: 1, sdf.OP_BOX: 3,
              sdf.OP_TORUS: 2, sdf.OP_PLANE: 4, sdf.OP_UNION: 0,
              sdf.OP_INTERSECTION: 0, sdf.OP_SUBTRACTION: 0,
              sdf.OP_SMOOTH_UNION: 1, sdf.OP_TRANSLATE: 3, sdf.OP_SCALE: 1,
              sdf.OP_ROUNDED: 1, sdf.OP_POP: 0, sdf.OP_POP_SCALE: 1}
LEAF = {sdf.OP_MBOX: sdf.MandelBox, sdf.OP_SPHERE: sdf.Sphere,
        sdf.OP_BOX: sdf.Box, sdf.OP_TORUS: sdf.Torus,
        sdf.OP_PLANE: sdf.Plane}


def deep_program(kind: str, n: int = 12):
    """A program that holds `n` distances at once ("distances"), saves
    `n` points at once ("points"), or both: concentric tori, each a
    different op, in a right-nested chain of combinators, inside n
    nested translates and scales."""
    ops = (sdf.union, sdf.intersection, sdf.subtraction,
           lambda a, b: sdf.smooth_union(a, b, 0.05))
    p = sdf.torus(0.3, 0.03)
    if kind in ("distances", "both"):
        for i in range(1, n):
            leaf = sdf.rounded(sdf.torus(0.3 + 0.1 * i, 0.03), 0.01)
            p = ops[i % 4](leaf, p)
    if kind in ("points", "both"):
        for i in range(n):
            p = (sdf.translate(p, (0.01 * i, -0.2, 0.02)) if i % 3
                 else sdf.scale(p, 1.0 + 0.01 * i))
    return p


def deep_model(tp, x, y, z):
    """csrc/common.cuh tape_run over DeepStacks, in torch: lane t's
    stacks live in a scratch of len(x) slots, distance k at row k,
    saved point k at rows depth + k, depth + points + k and depth +
    2 * points + k."""
    n = x.shape[0]
    D, P = tp.depth, tp.points
    scratch = torch.full(((D + 3 * P) * n,), float("nan"))
    lanes = torch.arange(n)

    def row(r):
        return r * n + lanes

    nd = np_ = 0
    q = iter(tp.operands)
    for code in tp.ops:
        op = code & 0xFF
        args = [next(q) for _ in range(N_OPERANDS[op])]
        if op in LEAF:
            leaf = (sdf.MandelBox(code >> 8, *args) if op == sdf.OP_MBOX
                    else LEAF[op](*args))
            scratch[row(nd)] = sdf.dist_c(leaf, x, y, z)
            nd += 1
        elif op in (sdf.OP_UNION, sdf.OP_INTERSECTION, sdf.OP_SUBTRACTION,
                    sdf.OP_SMOOTH_UNION):
            nd -= 1
            a, b = scratch[row(nd - 1)], scratch[row(nd)]
            if op == sdf.OP_UNION:
                d = torch.minimum(a, b)
            elif op == sdf.OP_INTERSECTION:
                d = torch.maximum(a, b)
            elif op == sdf.OP_SUBTRACTION:
                d = torch.maximum(a, -b)
            else:
                k = args[0]
                h = torch.clamp(0.5 + sdf._div(0.5 * (b - a), k), 0.0, 1.0)
                d = b + (a - b) * h - k * h * (1.0 - h)
            scratch[row(nd - 1)] = d
        elif op in (sdf.OP_TRANSLATE, sdf.OP_SCALE):
            for c, v in enumerate((x, y, z)):
                scratch[row(D + c * P + np_)] = v
            np_ += 1
            if op == sdf.OP_TRANSLATE:
                x, y, z = x - args[0], y - args[1], z - args[2]
            else:
                x, y, z = (sdf._div(v, args[0]) for v in (x, y, z))
        elif op == sdf.OP_ROUNDED:
            scratch[row(nd - 1)] = scratch[row(nd - 1)] - args[0]
        else:
            np_ -= 1
            x, y, z = (scratch[row(D + c * P + np_)] for c in range(3))
            if op == sdf.OP_POP_SCALE:
                scratch[row(nd - 1)] = scratch[row(nd - 1)] * args[0]
    assert nd == 1 and np_ == 0
    return scratch[row(0)]


def _points(n=2048, seed=3):
    g = np.random.default_rng(seed)
    p = g.uniform(-1.6, 1.6, (n, 3)).astype(np.float32)
    return [torch.from_numpy(p[:, i].copy()) for i in range(3)]


@pytest.mark.parametrize("kind", ["distances", "points", "both"])
def test_deep_tape_matches_dist_c(kind):
    """The tape of a 12-deep program needs 12 distances and/or 12 saved
    points at once, and run over the scratch's layout gives dist_c's
    bits."""
    prog = deep_program(kind)
    tp = sdf.tape(prog)
    want = {"distances": (12, 0), "points": (1, 12), "both": (12, 12)}[kind]
    assert (tp.depth, tp.points) == want
    xyz = _points()
    got = deep_model(tp, *xyz)
    ref = sdf.dist_c(prog, *xyz)
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))


@pytest.mark.parametrize("case", ["at_cap", "over_cap", "mixed"])
def test_sdf_args_picks_the_deep_tape(case):
    """Tape 1 for programs whose stacks fit DEPTH_CAP; tape 2 with a
    scratch of slots x (depth + 3 points) floats, the slots the launch's
    grid rounded to 128 threads, when any program of the scene needs
    more (the deepest decides)."""
    cap = sdf.DEPTH_CAP
    shallow = deep_program("distances", cap)
    deep = deep_program("both", cap + 4)
    insts = {"at_cap": [(shallow, 1, 0.0)],
             "over_cap": [(deep, 1, 2.0)],
             "mixed": [(sdf.mandelbox(12, 1.0, 0.01, 1.9, -2.1), 0, 3.6),
                       (shallow, 1, 0.0), (deep, 2, 2.0)]}[case]
    cpu = torch.device("cpu")
    mb, a = _build.sdf_args(insts, cpu, 1000, persistent=True)
    assert (mb.iters, a.n_inst) == (0, len(insts))
    if case == "at_cap":
        assert (a.tape, a.slots, a.deep) == (1, 0, None)
        return
    assert (a.tape, a.depth, a.points) == (2, cap + 4, cap + 4)
    assert a.slots == _build.deep_slots(1000, cpu, True) == 1024
    scratch = _build._DEEP[str(cpu)]
    assert a.deep == scratch.data_ptr()
    assert scratch.numel() >= 1024 * (cap + 4 + 3 * (cap + 4))
    # the one-thread-a-ray kernels (cost key, sort key): one slot a ray
    assert _build.sdf_args(insts, cpu, 5000, persistent=False)[1].slots \
        == 5120


def test_scene_builder_takes_deep_programs():
    """set_sdf and add_sdf take programs of any depth, and a frame with a
    12-deep instance renders (the kernels' plain twins on the CPU)."""
    b = tscene.SceneBuilder()
    mat = b.add_lambertian((0.5,) * 3)
    deep = sdf.translate(deep_program("both"), (0.0, -0.4, 0.0))
    b.set_sdf(deep, mat, bound_radius=2.2)
    assert b.add_sdf(deep_program("points"), mat) == 1
    cam = presets.spheres_scene(resolution=(8, 6), device="cpu")[2]
    b2 = tscene.SceneBuilder()
    b2.add_sphere((0.0, 0.0, 0.0), 50.0, b2.add_sky((0.3, 0.4, 0.6),
                                                    (0.02,) * 3))
    b2.add_sphere_light((1.5, 2.0, 1.5), 0.3, (20.0, 18.0, 15.0))
    b2.add_sdf(deep, b2.add_lambertian((0.6, 0.5, 0.4)), bound_radius=2.2)
    d2, s2 = b2.build("cpu")
    assert s2.sdf_instances(d2)[0][0] == deep
    s = RenderSettings(resolution=(8, 6), spp=1, max_bounces=1,
                       max_marches=32, max_vis_marches=16, rays_per_pass=48)
    f = renderer.render_frame(d2, s2, s, cam)
    img = film.resolve(f, (8, 6))
    assert np.isfinite(img.color).all()
    assert int(f.samples.sum()) == 48
    assert math.isfinite(float(img.alpha.mean()))
