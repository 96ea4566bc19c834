"""Signed-distance-field programs (port of rayn_tpu.ops.sdf).

The JAX package represents an SDF as a traced closure plus a parameter
pytree. The port's kernels are compiled CUDA, so a program here is a
plain value: a tree of NamedTuples, one per primitive or combinator,
whose float fields are the float32-rounded scalar parameters in the JAX
pytree's leaf order (`leaves`), and whose int fields are structure (the
MandelBox's iteration count). Primitives: `MandelBox`, `Sphere`, `Box`,
`Torus`, `Plane`; combinators: `Union`, `Intersection`, `Subtraction`,
`SmoothUnion`, `Translate`, `Scale`, `Rounded`. The constructors take
the names and arguments of the JAX module's.

`dist_c` is the plain torch DE of any program, op for op as JAX's
`fn_c`; `tape` lowers a program to what the CUDA kernels read: int32
opcodes and float32 operands evaluated as a postfix program with a
stack of distances and a stack of saved points (csrc/common.cuh
tape_run), of any depth.

A user-written program is an `SdfProgram(fn, params, fn_c, reduce_fn)`,
JAX's type with torch code: `fn(params, p [..., 3])` is its point-form
DE and `params` any nest of tensors and floats. No kernel can evaluate
it (that would take a code generator), so it has no tape: an instance of
it marches with ops/march.py, and a scene that holds one takes the
unfused route without the fused kernels, as JAX routes a program with no
`fn_c` (`kernel_ready`, render/integrator.py). A library combinator may
hold one; the whole program is then a closure program.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from rayn_tpu_torch.utils import vecmath
from rayn_tpu_torch.utils.vecmath import div as _div
from rayn_tpu_torch.utils.vecmath import sqrt as _sqrt


def _f32(x) -> float:
    return float(np.float32(x))


# ------------------------------------------------------------- primitives
class MandelBox(NamedTuple):
    """MandelBox distance estimator (reference src/sdf.rs:104-188)."""
    iterations: int
    scale: float          # e.g. -2.1 (reference src/setup.rs:84)
    box_l: float          # box-fold side length
    min_rad_sq: float     # sphere-fold min radius^2
    fixed_rad_sq: float   # sphere-fold fixed radius^2


class Sphere(NamedTuple):
    radius: float


class Box(NamedTuple):
    hx: float
    hy: float
    hz: float


class Torus(NamedTuple):
    major: float
    minor: float


class Plane(NamedTuple):
    nx: float
    ny: float
    nz: float
    offset: float


# ------------------------------------------------------------ combinators
class Union(NamedTuple):
    a: tuple
    b: tuple


class Intersection(NamedTuple):
    a: tuple
    b: tuple


class Subtraction(NamedTuple):
    """a minus b."""
    a: tuple
    b: tuple


class SmoothUnion(NamedTuple):
    a: tuple
    b: tuple
    k: float


class Translate(NamedTuple):
    a: tuple
    x: float
    y: float
    z: float


class Scale(NamedTuple):
    a: tuple
    factor: float


class Rounded(NamedTuple):
    a: tuple
    radius: float


class SdfProgram(NamedTuple):
    """A user-written SDF (rayn_tpu.ops.sdf.SdfProgram's fields): `fn(
    params, p [..., 3]) -> [...]` a torch point-form DE; `params` any
    nest of tensors and floats (dicts, lists, tuples, NamedTuples);
    `fn_c(params, x, y, z)` its component form, if given (the DE then
    evaluates through it); `reduce_fn(iterations)` the reduced `fn`, or
    an (fn, fn_c) pair, for the shadow marches (RenderSettings.
    shadow_de_iterations)."""
    fn: Callable
    params: Any
    fn_c: Optional[Callable] = None
    reduce_fn: Optional[Callable] = None


PROGRAM_TYPES = (MandelBox, Sphere, Box, Torus, Plane, Union, Intersection,
                 Subtraction, SmoothUnion, Translate, Scale, Rounded,
                 SdfProgram)


def mandelbox(iterations: int, box_fold_l: float, sphere_min_rad: float,
              sphere_fixed_rad: float, scale: float) -> MandelBox:
    return MandelBox(int(iterations), _f32(scale), _f32(box_fold_l),
                     _f32(sphere_min_rad * sphere_min_rad),
                     _f32(sphere_fixed_rad * sphere_fixed_rad))


def sphere(radius: float) -> Sphere:
    return Sphere(_f32(radius))


def box(half_extents) -> Box:
    return Box(*(_f32(v) for v in half_extents))


def torus(major: float, minor: float) -> Torus:
    return Torus(_f32(major), _f32(minor))


def plane(normal, offset: float = 0.0) -> Plane:
    """The normal is normalised in float64 and each component then
    rounded to float32, as the JAX module does."""
    n = np.asarray(normal, np.float64)
    n = n / np.linalg.norm(n)
    return Plane(_f32(n[0]), _f32(n[1]), _f32(n[2]), _f32(offset))


def union(a, b) -> Union:
    return Union(check(a), check(b))


def intersection(a, b) -> Intersection:
    return Intersection(check(a), check(b))


def subtraction(a, b) -> Subtraction:
    return Subtraction(check(a), check(b))


def smooth_union(a, b, k: float) -> SmoothUnion:
    return SmoothUnion(check(a), check(b), _f32(k))


def translate(a, offset) -> Translate:
    return Translate(check(a), *(_f32(v) for v in offset))


def scale(a, factor: float) -> Scale:
    return Scale(check(a), _f32(factor))


def rounded(a, radius: float) -> Rounded:
    return Rounded(check(a), _f32(radius))


def _children(prog):
    if type(prog) is SdfProgram:
        return []
    return [v for v in prog if isinstance(v, PROGRAM_TYPES)]


def check(prog):
    """`prog` if it is a program: the library's types, whose children are
    programs, or an SdfProgram with a callable fn; else
    NotImplementedError."""
    if not isinstance(prog, PROGRAM_TYPES):
        raise NotImplementedError(
            f"{type(prog).__name__} is not an SDF program: the library's "
            "primitives and combinators (ops/sdf.py), or a user-written "
            "closure as SdfProgram(fn, params)")
    if type(prog) is SdfProgram and not callable(prog.fn):
        raise NotImplementedError("SdfProgram.fn must be callable")
    for child in _children(prog):
        check(child)
    return prog


def kernel_ready(prog) -> bool:
    """Whether the kernels can evaluate the program: it holds no
    user-written SdfProgram (JAX's `_pallas_ok` on a program with fn_c,
    rayn_tpu/ops/intersect.py:33-41)."""
    if type(prog) is SdfProgram:
        return False
    return all(kernel_ready(c) for c in _children(check(prog)))


def param_leaves(x) -> list:
    """The leaves of a nest in jax.tree.leaves order: dict values by
    sorted key, tuples, lists and NamedTuples in order, no leaf for
    None."""
    if x is None:
        return []
    if isinstance(x, dict):
        return [leaf for k in sorted(x) for leaf in param_leaves(x[k])]
    if isinstance(x, (tuple, list)):
        return [leaf for y in x for leaf in param_leaves(y)]
    return [x]


def _unflatten(x, it):
    """`x`'s nest with each leaf taken from the iterator `it`."""
    if x is None:
        return None
    if isinstance(x, dict):
        got = {k: _unflatten(x[k], it) for k in sorted(x)}
        return type(x)((k, got[k]) for k in x)
    if isinstance(x, (tuple, list)):
        vals = [_unflatten(y, it) for y in x]
        return type(x)(*vals) if hasattr(x, "_fields") else type(x)(vals)
    return next(it)


def leaves(prog) -> list:
    """The program's parameters in the JAX pytree's leaf order
    (jax.tree.leaves of the JAX program's params): floats, and a
    closure's tensors."""
    if type(check(prog)) is SdfProgram:
        return param_leaves(prog.params)
    out = []
    for v in prog:
        if isinstance(v, PROGRAM_TYPES):
            out += leaves(v)
        elif isinstance(v, float):
            out.append(v)
    return out


def _like(old, value):
    """`value` as a leaf of the kind of `old`: a tensor of old's dtype
    (on value's device if it is a tensor, else on old's), an int, or a
    float rounded to float32."""
    if isinstance(old, torch.Tensor):
        if isinstance(value, torch.Tensor):
            return value.to(dtype=old.dtype)
        return torch.as_tensor(np.asarray(value), dtype=old.dtype).to(
            old.device)
    if isinstance(old, int) and not isinstance(old, bool):
        return int(np.asarray(value))
    return _f32(value)


def with_leaves(prog, values):
    """The program of the same structure with its leaves replaced, in
    leaf order, by `values` (each a float rounded to float32, or a
    closure's tensor with its old leaf's dtype and device); raises
    ValueError when the counts differ."""
    values = list(values)
    want = len(leaves(prog))
    if len(values) != want:
        raise ValueError(f"{type(prog).__name__} program has {want} "
                         f"parameter leaves, got {len(values)}")
    it = iter(values)

    def fill(p):
        if type(p) is SdfProgram:
            return p._replace(params=_unflatten(
                p.params, iter([_like(o, next(it))
                                for o in param_leaves(p.params)])))
        return type(p)(*(fill(v) if isinstance(v, PROGRAM_TYPES)
                         else _f32(next(it)) if isinstance(v, float) else v
                         for v in p))
    return fill(prog)


def to_device(prog, device):
    """The program with every tensor of a closure's params on
    `device`."""
    vals = leaves(prog)
    if not any(isinstance(v, torch.Tensor) for v in vals):
        return prog
    return with_leaves(prog, [v.to(device) if isinstance(v, torch.Tensor)
                              else v for v in vals])


def reduced(prog, iterations: int):
    """The shadow marches' program (RenderSettings.shadow_de_iterations):
    a bare MandelBox at `iterations` iterations, a closure with a
    reduce_fn its reduced fn (and fn_c; the reduce_fn dropped, as JAX's
    SdfProgram.reduced); any other program, and every program at 0,
    unchanged. JAX's `_from_c` drops the reduce_fn, so a MandelBox inside
    a combinator keeps its full iterations (rayn_tpu/ops/sdf.py:52-57,
    120-124)."""
    if iterations and isinstance(prog, MandelBox):
        return prog._replace(iterations=int(iterations))
    if iterations and type(prog) is SdfProgram and prog.reduce_fn:
        fn = prog.reduce_fn(int(iterations))
        fn, fn_c = fn if isinstance(fn, tuple) else (fn, None)
        return SdfProgram(fn, prog.params, fn_c)
    return prog


# ----------------------------------------------------------- distances
def _mandelbox_c(mb: MandelBox, x, y, z):
    """reference src/sdf.rs:126-141: per iteration a box fold, a sphere
    fold, then p = p*scale + p0 and dr = -dr*scale + 1; DE = |p| / |dr|.
    NaN propagates like jnp.clip/jnp.maximum."""
    ox, oy, oz = x, y, z
    dr = torch.ones_like(x)
    lo, hi = -mb.box_l, mb.box_l
    for _ in range(mb.iterations):
        x = torch.clamp(x, lo, hi) * 2.0 - x
        y = torch.clamp(y, lo, hi) * 2.0 - y
        z = torch.clamp(z, lo, hi) * 2.0 - z
        r2 = x * x + y * y + z * z
        mul = torch.clamp(_div(mb.fixed_rad_sq,
                               torch.clamp(r2, min=mb.min_rad_sq)), min=1.0)
        x, y, z = x * mul, y * mul, z * mul
        dr = dr * mul
        x = x * mb.scale + ox
        y = y * mb.scale + oy
        z = z * mb.scale + oz
        dr = -dr * mb.scale + 1.0
    return _sqrt(x * x + y * y + z * z) / torch.abs(dr)


def dist_c(prog, x: torch.Tensor, y: torch.Tensor,
           z: torch.Tensor) -> torch.Tensor:
    """Component-form DE of any program, op for op as the JAX fn_c:
    minimum/maximum propagate NaN, `** 2` is a product, and every
    division is one IEEE division."""
    t = type(prog)
    if t is SdfProgram:
        if prog.fn_c is not None:
            return prog.fn_c(prog.params, x, y, z)
        return prog.fn(prog.params, torch.stack([x, y, z], dim=-1))
    if t is MandelBox:
        return _mandelbox_c(prog, x, y, z)
    if t is Sphere:
        return _sqrt(x * x + y * y + z * z) - prog.radius
    if t is Box:
        qx = torch.abs(x) - prog.hx
        qy = torch.abs(y) - prog.hy
        qz = torch.abs(z) - prog.hz
        mx, my, mz = (torch.clamp(q, min=0.0) for q in (qx, qy, qz))
        outside = _sqrt(mx * mx + my * my + mz * mz)
        inside = torch.clamp(torch.maximum(qx, torch.maximum(qy, qz)),
                             max=0.0)
        return outside + inside
    if t is Torus:
        qx = _sqrt(x * x + z * z) - prog.major
        return _sqrt(qx * qx + y * y) - prog.minor
    if t is Plane:
        return x * prog.nx + y * prog.ny + z * prog.nz + prog.offset
    if t is Union:
        return torch.minimum(dist_c(prog.a, x, y, z),
                             dist_c(prog.b, x, y, z))
    if t is Intersection:
        return torch.maximum(dist_c(prog.a, x, y, z),
                             dist_c(prog.b, x, y, z))
    if t is Subtraction:
        return torch.maximum(dist_c(prog.a, x, y, z),
                             -dist_c(prog.b, x, y, z))
    if t is SmoothUnion:
        d1, d2, k = dist_c(prog.a, x, y, z), dist_c(prog.b, x, y, z), prog.k
        h = torch.clamp(0.5 + _div(0.5 * (d2 - d1), k), 0.0, 1.0)
        return d2 + (d1 - d2) * h - k * h * (1.0 - h)
    if t is Translate:
        return dist_c(prog.a, x - prog.x, y - prog.y, z - prog.z)
    if t is Scale:
        s = prog.factor
        return dist_c(prog.a, _div(x, s), _div(y, s), _div(z, s)) * s
    if t is Rounded:
        return dist_c(prog.a, x, y, z) - prog.radius
    check(prog)
    raise AssertionError(t)


def dist(prog, p: torch.Tensor) -> torch.Tensor:
    """Point-form DE: a closure's fn, any other program's dist_c."""
    if type(prog) is SdfProgram:
        return prog.fn(prog.params, p)
    return dist_c(prog, p[..., 0], p[..., 1], p[..., 2])


# sdfu normals_fast tetrahedral tap directions (shared with the CUDA
# kernel, which unrolls the same four taps in the same order).
TETRA_TAPS = ((1.0, -1.0, -1.0), (-1.0, 1.0, -1.0),
              (-1.0, -1.0, 1.0), (1.0, 1.0, 1.0))


def tetrahedral_normal(prog, p: torch.Tensor,
                       eps: torch.Tensor) -> torch.Tensor:
    """4-tap tetrahedral gradient estimate, normalized (reference
    src/sdf.rs:92-96). eps: [...] per-point step size."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    g = [torch.zeros_like(x) for _ in range(3)]
    for kx, ky, kz in TETRA_TAPS:
        d = dist_c(prog, x + kx * eps, y + ky * eps, z + kz * eps)
        g = [g[0] + kx * d, g[1] + ky * d, g[2] + kz * d]
    return vecmath.normalize(torch.stack(g, dim=-1), eps=1e-20)


# ------------------------------------------------------------------ tape
# Opcodes of csrc/common.cuh tape_de (the low byte of an op word; the
# MandelBox keeps its iteration count in the bits above). Each op takes
# its operands from the instance's operand stream in order.
OP_MBOX, OP_SPHERE, OP_BOX, OP_TORUS, OP_PLANE = 0, 1, 2, 3, 4
OP_UNION, OP_INTERSECTION, OP_SUBTRACTION, OP_SMOOTH_UNION = 5, 6, 7, 8
OP_TRANSLATE, OP_SCALE, OP_ROUNDED, OP_POP, OP_POP_SCALE = 9, 10, 11, 12, 13
# The most distances, and the most saved points, the Tape kernels hold at
# once (csrc/common.cuh kSdfDepth: fixed arrays per thread); a deeper
# program runs the DeepTape kernels, whose stacks live in a device
# scratch (_build.sdf_args).
DEPTH_CAP = 8

LEAF_OP = {MandelBox: OP_MBOX, Sphere: OP_SPHERE, Box: OP_BOX,
           Torus: OP_TORUS, Plane: OP_PLANE}
BINARY_OP = {Union: OP_UNION, Intersection: OP_INTERSECTION,
             Subtraction: OP_SUBTRACTION, SmoothUnion: OP_SMOOTH_UNION}


class Tape(NamedTuple):
    """A program as the kernels read it: postfix op words and their
    operands, and the deepest the distance and point stacks get."""
    ops: tuple        # int32 op words
    operands: tuple   # float32 operands, in op order
    depth: int        # distances held at once
    points: int       # points saved at once


def _emit(prog, ops, prm):
    t = type(prog)
    if t in LEAF_OP:
        code = LEAF_OP[t]
        if t is MandelBox:
            if not 0 <= prog.iterations < 2 ** 23:
                raise ValueError(f"MandelBox iterations {prog.iterations}")
            code |= prog.iterations << 8
        ops.append(code)
        prm.extend(v for v in prog if isinstance(v, float))
    elif t in BINARY_OP:
        _emit(prog.a, ops, prm)
        _emit(prog.b, ops, prm)
        ops.append(BINARY_OP[t])
        if t is SmoothUnion:
            prm.append(prog.k)
    elif t is Translate:
        ops.append(OP_TRANSLATE)
        prm.extend((prog.x, prog.y, prog.z))
        _emit(prog.a, ops, prm)
        ops.append(OP_POP)
    elif t is Scale:
        ops.append(OP_SCALE)
        prm.append(prog.factor)
        _emit(prog.a, ops, prm)
        ops.append(OP_POP_SCALE)
        prm.append(prog.factor)
    elif t is Rounded:
        _emit(prog.a, ops, prm)
        ops.append(OP_ROUNDED)
        prm.append(prog.radius)
    else:
        check(prog)
        raise NotImplementedError(
            "a user-written SdfProgram has no tape: no kernel evaluates it "
            "(it marches with ops/march.py)")


def _depths(ops) -> tuple[int, int]:
    depth = points = nd = np_ = 0
    for code in ops:
        op = code & 0xFF
        if op in LEAF_OP.values():
            nd += 1
        elif op in BINARY_OP.values():
            nd -= 1
        elif op in (OP_TRANSLATE, OP_SCALE):
            np_ += 1
        elif op in (OP_POP, OP_POP_SCALE):
            np_ -= 1
        depth, points = max(depth, nd), max(points, np_)
    return depth, points


def tape(prog) -> Tape:
    """The program as postfix op words and operands, of any depth.
    Raises NotImplementedError for anything but a program of the
    library's types."""
    ops, prm = [], []
    _emit(check(prog), ops, prm)
    return Tape(tuple(ops), tuple(prm), *_depths(ops))
