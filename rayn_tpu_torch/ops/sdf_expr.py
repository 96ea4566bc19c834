"""Expression programs: a user-written SDF closure's `fn_c` as the CUDA
kernels run it.

`lower_closure(prog)` traces `prog.fn_c(params, x, y, z)` with
torch.fx's `make_fx` (x, y, z 1-D float32, each scalar parameter leaf a
0-d placeholder in `sdf.param_leaves` order) into a straight-line
program over a small register file: int32 instruction words and a table
of float32 operands (the parameter leaves and the constants). Python
control flow on static values unrolls, as under `jax.jit`; control flow
on the data fails the trace. The parameters stay operands, so new values
give new operands and the same words.

Each instruction does what one torch op does on the card, not what the
source text says (the closure's torch route is the kernels' twin):
- `t / c` by a number (a Python number, a number parameter, a CPU
  tensor constant) is torch's CUDA `t * (1 / c)`, DIVS; by a tensor on
  the card it is one IEEE division, DIV;
- `t ** c` by a number is torch's CUDA pow by a scalar, POWS: 0 -> 1,
  1 -> t, 0.5 -> sqrt, -0.5 -> rsqrt, -1 -> 1 / t, 2 -> t * t, 3 -> t * t
  * t, -2 -> 1 / (t * t), else powf; by a tensor POW (powf);
- minimum, maximum and clamp propagate NaN; comparisons give 1 or 0.
`vecmath.sqrt` (float64 on the CPU) and `vecmath.div` with a number (a
0-d fill) lower to one SQRT and one DIV on every device. A parameter
that is a Python number and meets another number or parameter before it
meets x, y or z would be rounded in float64 by the closure and in
float32 by a kernel: such a closure is refused. So is any op outside the
set, a value of another dtype or shape, and more than 125 registers or
128 operands; the closure then marches in torch.

`expr_dist_c` runs a program in torch, op for op as the CUDA interpreter
(csrc/common.cuh expr_run), each op as the torch call it stands for: the
tests hold the lowering against `fn_c` with it.
"""

from __future__ import annotations

import math
import warnings
from typing import NamedTuple, Optional

import numpy as np
import torch

from rayn_tpu_torch.utils import vecmath

# Instruction opcodes (csrc/common.cuh kX*): the low byte of a word; the
# destination register, then the sources a and b, in the bytes above.
# WHERE takes a second word whose low byte is its third source.
(X_MOV, X_NEG, X_ABS, X_SQRT, X_FLOOR, X_SIN, X_COS, X_EXP, X_LOG,
 X_RECIP, X_NOT) = range(11)
(X_ADD, X_SUB, X_MUL, X_DIV, X_DIVS, X_MIN, X_MAX, X_POW, X_POWS, X_LT,
 X_LE, X_GT, X_GE, X_EQ, X_NE, X_AND, X_OR, X_WHERE) = range(16, 34)
# A source: 0-2 the point's x, y, z; 3-127 register s - 3; 128-255
# operand s - 128.
N_XYZ, OPERAND0 = 3, 128
MAX_REGS, MAX_OPERANDS = OPERAND0 - N_XYZ, 256 - OPERAND0
_TRACE_N = 7


class Expr(NamedTuple):
    """A lowered closure: its instruction words, its operand slots (each
    ("leaf", i), parameter leaf i, or ("const", value)), the registers
    it holds at once, the source of its result, and its instructions'
    opcodes in order."""
    words: tuple
    operands: tuple
    regs: int
    result: int
    ops: tuple


class Refused(Exception):
    """Why a closure does not lower."""


def leaf_kinds(params) -> Optional[tuple]:
    """Each parameter leaf's kind: "number" (a Python or numpy number,
    which torch treats as a scalar) or "tensor" (a 0-d float32 tensor);
    None when a leaf is neither (JAX's rule: every leaf a scalar)."""
    from rayn_tpu_torch.ops.sdf import param_leaves

    kinds = []
    for leaf in param_leaves(params):
        if isinstance(leaf, torch.Tensor):
            if leaf.dim() != 0 or leaf.dtype != torch.float32:
                return None
            kinds.append("tensor")
        elif isinstance(leaf, (int, float, np.integer, np.floating)):
            kinds.append("number")
        else:
            return None
    return tuple(kinds)


def params_structure(x):
    """The nest's shape with its leaves left out (a hashable key)."""
    if isinstance(x, dict):
        return ("dict", type(x),
                tuple((k, params_structure(x[k])) for k in sorted(x)))
    if isinstance(x, (tuple, list)):
        return (type(x), tuple(params_structure(y) for y in x))
    return None


_LOWERED: dict = {}
_WARNED: set = set()


def lower_closure(prog, device: str = "meta") -> Expr:
    """The expression program of closure `prog` (an sdf.SdfProgram with
    fn_c and scalar leaves) traced on `device` ("cuda" on fake tensors,
    which needs no card; "cpu" or "meta" on those), cached by fn_c, the
    params' structure and their leaves' kinds. Raises Refused with the
    reason it does not lower, having warned once for it."""
    kinds = leaf_kinds(prog.params)
    if prog.fn_c is None or kinds is None:
        raise Refused("no fn_c" if prog.fn_c is None
                      else "non-scalar parameter leaves")
    key = (prog.fn_c, params_structure(prog.params), kinds, device)
    got = _LOWERED.get(key)
    if got is None:
        try:
            got = _lower(prog, kinds, device)
        except Refused as e:
            got = e
        _LOWERED[key] = got
    if isinstance(got, Refused):
        name = getattr(prog.fn_c, "__qualname__", repr(prog.fn_c))
        if (name, str(got)) not in _WARNED:
            _WARNED.add((name, str(got)))
            warnings.warn(
                f"rayn_tpu_torch: SDF closure {name} marches in torch, not "
                f"in the CUDA kernels ({got})", RuntimeWarning, stacklevel=3)
        raise got
    return got


def _trace(prog, kinds, device):
    from torch.fx.experimental.proxy_tensor import make_fx

    from rayn_tpu_torch.ops.sdf import _unflatten

    def fn(*args):
        leaves, (x, y, z) = args[:len(kinds)], args[len(kinds):]
        return prog.fn_c(_unflatten(prog.params, iter(leaves)), x, y, z)

    def run():
        ins = [torch.zeros((), dtype=torch.float32, device=device)
               for _ in kinds]
        ins += [torch.zeros((_TRACE_N,), dtype=torch.float32, device=device)
                for _ in range(3)]
        return make_fx(fn)(*ins)

    try:
        if device == "cuda":
            from torch._subclasses.fake_tensor import FakeTensorMode
            with FakeTensorMode():
                return run()
        return run()
    except Refused:
        raise
    except Exception as e:   # data-dependent control flow, bad ops, ...
        msg = str(e).strip().splitlines()[0] if str(e).strip() else ""
        raise Refused(f"fn_c does not trace: {type(e).__name__}: "
                      f"{msg[:160]}") from None


class _Val(NamedTuple):
    """A traced value: what it is ("xyz", "reg", "operand"), its index,
    whether it acts as a number on the card (a Python or numpy number, a
    CPU tensor), whether it depends on x, y or z, whether it holds a
    number parameter, and its role in the float64 square root pattern."""
    what: str
    index: int
    number: bool = False
    varying: bool = False
    number_leaf: bool = False
    f64: str = ""


def _lower(prog, kinds, device) -> Expr:
    graph = _trace(prog, kinds, device).graph
    aten = torch.ops.aten
    nodes = list(graph.nodes)
    out = next(n for n in nodes if n.op == "output")
    # reachable from the output
    live, stack = set(), [out]
    while stack:
        n = stack.pop()
        if n in live:
            continue
        live.add(n)
        stack.extend(n.all_input_nodes)

    consts: dict = {}
    operands: list = []
    leaf_slot: dict = {}
    ins: list = []        # (opcode, dst vreg, sources)
    vals: dict = {}
    on_cpu = torch.device(device).type == "cpu"
    placeholders = [n for n in nodes if n.op == "placeholder"]

    def operand(entry, key=None) -> int:
        key = entry if key is None else key
        if key not in consts:
            if len(operands) >= MAX_OPERANDS:
                raise Refused(f"more than {MAX_OPERANDS} operands")
            consts[key] = len(operands)
            operands.append(entry)
        return consts[key]

    def const(value, number: bool) -> _Val:
        value = float(value)
        # one slot a value: NaN by itself, -0.0 apart from 0.0
        key = ("nan",) if math.isnan(value) else (
            "const", value, math.copysign(1.0, value))
        return _Val("operand", operand(("const", value), key), number=number)

    def val(a) -> _Val:
        if isinstance(a, torch.fx.Node):
            return vals[a]
        if isinstance(a, (bool, int, float)):
            return const(a, True)
        raise Refused(f"an argument {a!r} the kernels do not take")

    def emit(op, *srcs, number_leaf=False) -> _Val:
        varying = any(s.varying for s in srcs)
        # -c and |c| round alike in float64 and float32
        if (not varying and any(s.number_leaf for s in srcs)
                and op not in (X_NEG, X_ABS)):
            raise Refused(
                "a number parameter meets a number before it meets x, y or "
                "z (rounded in float64 by the closure, float32 by a kernel):"
                " give it as a 0-d float32 tensor")
        ins.append((op, len(ins), srcs))
        return _Val("reg", len(ins) - 1, varying=varying,
                    number_leaf=number_leaf)

    def f32_shape(n):
        v = n.meta.get("val")
        if not isinstance(v, torch.Tensor):
            raise Refused(f"{n.target} gives no tensor")
        if tuple(v.shape) not in ((), (_TRACE_N,)):
            raise Refused(f"{n.target} gives shape {tuple(v.shape)}")
        return v

    unary = {aten.neg.default: X_NEG, aten.abs.default: X_ABS,
             aten.floor.default: X_FLOOR, aten.sin.default: X_SIN,
             aten.cos.default: X_COS, aten.exp.default: X_EXP,
             aten.log.default: X_LOG, aten.reciprocal.default: X_RECIP,
             aten.logical_not.default: X_NOT,
             aten.bitwise_not.default: X_NOT}
    binary = {aten.mul.Tensor: X_MUL, aten.maximum.default: X_MAX,
              aten.minimum.default: X_MIN,
              aten.lt.Tensor: X_LT, aten.lt.Scalar: X_LT,
              aten.le.Tensor: X_LE, aten.le.Scalar: X_LE,
              aten.gt.Tensor: X_GT, aten.gt.Scalar: X_GT,
              aten.ge.Tensor: X_GE, aten.ge.Scalar: X_GE,
              aten.eq.Tensor: X_EQ, aten.eq.Scalar: X_EQ,
              aten.ne.Tensor: X_NE, aten.ne.Scalar: X_NE,
              aten.logical_and.default: X_AND,
              aten.bitwise_and.Tensor: X_AND,
              aten.logical_or.default: X_OR, aten.bitwise_or.Tensor: X_OR,
              aten.clamp_min.Tensor: X_MAX, aten.clamp_max.Tensor: X_MIN}
    alias = (aten.alias.default, aten.clone.default, aten.detach.default,
             aten.lift_fresh_copy.default)
    fills = (aten.full.default, aten.scalar_tensor.default,
             aten.full_like.default, aten.zeros_like.default,
             aten.ones_like.default, aten.zeros.default, aten.ones.default)

    for i, n in enumerate(placeholders):
        if i < len(kinds):
            number = kinds[i] == "number"
            vals[n] = _Val("operand", 0, number=number, number_leaf=number)
            leaf_slot[n] = i
        else:
            vals[n] = _Val("xyz", i - len(kinds), varying=True)
    for n in nodes:
        if n.op == "placeholder":
            if n in live and n in leaf_slot:
                v = vals[n]
                vals[n] = v._replace(index=operand(("leaf", leaf_slot[n])))
            continue
        if n.op == "output" or n not in live:
            continue
        if n.op == "get_attr":
            t = getattr(graph.owning_module, n.target)
            if not isinstance(t, torch.Tensor) or t.numel() != 1:
                raise Refused("a tensor constant that is not one number")
            number = t.device.type == "cpu" and not on_cpu
            t = getattr(t, "constant", None) if getattr(
                t, "fake_mode", None) else t
            if t is None:
                raise Refused("a tensor constant of unknown value")
            vals[n] = const(t.item(), number)
            continue
        if n.op != "call_function":
            raise Refused(f"a {n.op} node")
        t, a, kw = n.target, n.args, n.kwargs
        v = f32_shape(n)
        name = getattr(t, "__name__", str(t))
        if v.dtype == torch.float64:
            # vecmath.sqrt on the CPU: to float64, sqrt, back
            if t is aten._to_copy.default and vals[a[0]].f64 == "":
                vals[n] = vals[a[0]]._replace(f64="cast")
            elif t is aten.sqrt.default and vals[a[0]].f64 == "cast":
                vals[n] = vals[a[0]]._replace(f64="sqrt")
            else:
                raise Refused(f"float64 arithmetic ({name})")
            continue
        if v.dtype not in (torch.float32, torch.bool):
            raise Refused(f"{name} gives {v.dtype}")
        srcs = [vals[x] for x in n.all_input_nodes]
        if any(s.f64 for s in srcs) and not (
                t is aten._to_copy.default and vals[a[0]].f64 == "sqrt"):
            raise Refused(f"float64 arithmetic ({name})")
        if t is aten._to_copy.default:
            if set(kw) - {"dtype", "device", "layout"}:
                raise Refused(f"{name} with {sorted(kw)}")
            src = vals[a[0]]
            if src.f64 == "sqrt":
                vals[n] = emit(X_SQRT, src._replace(f64=""))
            elif a[0].meta["val"].dtype == torch.bool:
                vals[n] = emit(X_MOV, src)
            else:
                vals[n] = src
        elif t in alias or (
                t in (aten.view.default, aten.reshape.default,
                      aten.expand.default, aten._unsafe_view.default)
                and tuple(a[0].meta["val"].shape) == tuple(v.shape)):
            vals[n] = vals[a[0]]
        elif t in fills:
            value = {aten.zeros_like.default: 0.0, aten.zeros.default: 0.0,
                     aten.ones_like.default: 1.0,
                     aten.ones.default: 1.0}.get(t)
            if value is None:
                value = a[0] if t is aten.scalar_tensor.default else a[1]
            # a fill on the CPU acts as a number on the card; a *_like
            # fill lies on its input's device
            dev = "x" if name.endswith("_like") else kw.get("device", "cpu")
            number = (dev != "x" and torch.device(dev).type == "cpu"
                      and not on_cpu)
            vals[n] = const(value, number)
        elif t in unary:
            vals[n] = emit(unary[t], val(a[0]),
                           number_leaf=unary[t] in (X_NEG, X_ABS)
                           and val(a[0]).number_leaf)
        elif t is aten.sqrt.default:
            vals[n] = emit(X_SQRT, val(a[0]))
        elif t in (aten.add.Tensor, aten.sub.Tensor):
            if kw.get("alpha", 1) != 1:
                raise Refused(f"{name} with alpha {kw['alpha']}")
            vals[n] = emit(X_ADD if t is aten.add.Tensor else X_SUB,
                           val(a[0]), val(a[1]))
        elif t in (aten.rsub.Scalar, aten.rsub.Tensor):
            if kw.get("alpha", 1) != 1:
                raise Refused(f"{name} with alpha {kw['alpha']}")
            vals[n] = emit(X_SUB, val(a[1]), val(a[0]))
        elif t is aten.div.Tensor:
            if kw.get("rounding_mode") is not None:
                raise Refused(f"{name} with rounding_mode")
            num, den = val(a[0]), val(a[1])
            if num.number_leaf and not num.varying:
                # a number parameter over a tensor: torch's
                # reciprocal(t) * c
                vals[n] = emit(X_MUL, emit(X_RECIP, den), num)
            else:
                vals[n] = emit(X_DIVS if den.number else X_DIV, num, den)
        elif t in (aten.pow.Tensor_Scalar, aten.pow.Tensor_Tensor):
            base, ex = val(a[0]), val(a[1])
            if t is aten.pow.Tensor_Scalar or ex.number_leaf:
                vals[n] = emit(X_POWS, base, ex)
            elif ex.number:
                raise Refused("a CPU tensor exponent")
            else:
                vals[n] = emit(X_POW, base, ex)
        elif t is aten.pow.Scalar:
            vals[n] = emit(X_POW, val(a[0]), val(a[1]))
        elif t in binary:
            vals[n] = emit(binary[t], val(a[0]), val(a[1]))
        elif t in (aten.clamp.default, aten.clamp.Tensor,
                   aten.clamp_min.default, aten.clamp_max.default):
            lo = a[1] if len(a) > 1 else kw.get("min")
            hi = a[2] if len(a) > 2 else kw.get("max")
            if t is aten.clamp_max.default:
                lo, hi = None, a[1]
            r = val(a[0])
            if lo is not None:
                r = emit(X_MAX, r, val(lo))
            if hi is not None:
                r = emit(X_MIN, r, val(hi))
            vals[n] = r
        elif t is aten.where.self:
            vals[n] = emit(X_WHERE, val(a[0]), val(a[1]), val(a[2]))
        else:
            raise Refused(f"aten.{name} is outside the kernels' op set")
    if not isinstance(out.args[0], torch.fx.Node):
        raise Refused("fn_c returns more than one value")
    res = vals[out.args[0]]
    rv = out.args[0].meta.get("val")
    if rv is None or rv.dtype != torch.float32 or tuple(rv.shape) != (
            _TRACE_N,):
        raise Refused("fn_c does not return float32 of x's shape")
    return _allocate(ins, operands, res)


def _allocate(ins, operands, res) -> Expr:
    """Register allocation (a register is freed after its value's last
    use) and the instruction words."""
    last = {}
    for k, (_op, _dst, srcs) in enumerate(ins):
        for s in srcs:
            if s.what == "reg":
                last[s.index] = k
    if res.what == "reg":
        last[res.index] = len(ins)
    phys, free, words, ops, regs = {}, [], [], [], 0

    def code(s: _Val) -> int:
        if s.what == "xyz":
            return s.index
        if s.what == "operand":
            return OPERAND0 + s.index
        return N_XYZ + phys[s.index]

    for k, (op, dst, srcs) in enumerate(ins):
        cs = [code(s) for s in srcs]
        for s in srcs:
            if s.what == "reg" and last.get(s.index) == k \
                    and phys[s.index] not in free:
                free.append(phys[s.index])
        if dst not in last:       # a dead value (the trace keeps none)
            last[dst] = k
        free.sort()
        phys[dst] = free.pop(0) if free else regs
        regs = max(regs, phys[dst] + 1)
        if regs > MAX_REGS:
            raise Refused(f"more than {MAX_REGS} registers")
        cs += [0] * (3 - len(cs))
        words.append(op | (N_XYZ + phys[dst]) << 8 | cs[0] << 16
                     | cs[1] << 24)
        if op == X_WHERE:
            words.append(cs[2])
        ops.append(op)
    words = tuple(int(np.int32(np.uint32(w))) for w in words)
    return Expr(words, tuple(operands), regs, code(res), tuple(ops))


def operand_values(expr: Expr, leaves) -> list:
    """The float32 operand table of `expr` for the parameter `leaves`
    (sdf.param_leaves order)."""
    out = []
    for kind, v in expr.operands:
        x = leaves[v] if kind == "leaf" else v
        out.append(float(np.float32(float(x))))
    return out


def expr_dist_c(expr: Expr, leaves, x: torch.Tensor, y: torch.Tensor,
                z: torch.Tensor) -> torch.Tensor:
    """The program run in torch, op for op as the CUDA interpreter, each
    op as the torch call it stands for (a number operand of DIVS and POWS
    as a Python number, any other operand as a 0-d float32 tensor)."""
    regs: dict = {}

    def src(s: int, number: bool = False):
        if s < N_XYZ:
            return (x, y, z)[s]
        if s < OPERAND0:
            return regs[s]
        kind, v = expr.operands[s - OPERAND0]
        v = leaves[v] if kind == "leaf" else v
        if isinstance(v, torch.Tensor):
            return float(v) if number else v.to(x.device)
        if number:
            return float(v)
        return torch.full((), float(v), dtype=torch.float32, device=x.device)

    k = 0
    words = [int(np.uint32(np.int32(w))) for w in expr.words]
    for op in expr.ops:
        w = words[k]
        k += 1
        dst, sa, sb = (w >> 8) & 0xFF, (w >> 16) & 0xFF, (w >> 24) & 0xFF
        a = src(sa)
        if op == X_MOV:
            r = a.to(torch.float32)
        elif op == X_NEG:
            r = -a
        elif op == X_ABS:
            r = torch.abs(a)
        elif op == X_SQRT:
            r = vecmath.sqrt(a)
        elif op == X_FLOOR:
            r = torch.floor(a)
        elif op == X_SIN:
            r = torch.sin(a)
        elif op == X_COS:
            r = torch.cos(a)
        elif op == X_EXP:
            r = torch.exp(a)
        elif op == X_LOG:
            r = torch.log(a)
        elif op == X_RECIP:
            r = torch.reciprocal(a)
        elif op == X_NOT:
            r = ~a.to(torch.bool)
        elif op == X_DIVS:
            r = a / src(sb, number=True)
        elif op == X_POWS:
            r = a ** src(sb, number=True)
        elif op == X_WHERE:
            c = src(words[k] & 0xFF)
            k += 1
            r = torch.where(a.to(torch.bool), src(sb), c)
        else:
            b = src(sb)
            r = {X_ADD: lambda: a + b, X_SUB: lambda: a - b,
                 X_MUL: lambda: a * b, X_DIV: lambda: a / b,
                 X_MIN: lambda: torch.minimum(a, b),
                 X_MAX: lambda: torch.maximum(a, b),
                 X_POW: lambda: torch.pow(a, b),
                 X_LT: lambda: a < b, X_LE: lambda: a <= b,
                 X_GT: lambda: a > b, X_GE: lambda: a >= b,
                 X_EQ: lambda: a == b, X_NE: lambda: a != b,
                 X_AND: lambda: a.to(torch.bool) & b.to(torch.bool),
                 X_OR: lambda: a.to(torch.bool) | b.to(torch.bool)}[op]()
        regs[dst] = r
    return torch.broadcast_to(src(expr.result), x.shape)
