"""Build and load the port's CUDA kernels.

Each `csrc/*.cu` source is compiled by its own `nvcc` process (all
started together) and the objects are linked into one shared library
with a plain C interface, loaded with ctypes (no PyTorch headers, so a
build takes seconds). The build runs at first use, never at import,
into `build/kernels/` beside the package (listed in .gitignore; override
with RAYN_TORCH_BUILD_DIR), and is redone when the hash of the sources
and flags changes. Each kernel has an `extern "C"` launcher
`cudaError_t name(const Args*, cudaStream_t)`; `launch` passes the
argument struct and PyTorch's current stream and raises if the launcher
returns an error.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
ARCH = "arch=compute_90a,code=sm_90a"
# IEEE division/sqrt and no FMA contraction: the kernels must agree with
# the plain torch twins to float32 rounding (ill-conditioned cone terms
# amplify any ulp difference, shade_pallas.py:34-45).
FLAGS = ("-gencode", ARCH, "-std=c++17", "-O3", "--fmad=false",
         "-Xcompiler", "-fPIC")
KERNELS = ("rayn_closest_hit", "rayn_cost_key",
           "rayn_shadow_segments", "rayn_shadow_march",
           "rayn_shadow_sum", "rayn_tail_sum", "rayn_finish_bounce",
           "rayn_shadow_sort_key", "rayn_queue_segments", "rayn_queue_sum",
           "rayn_march", "rayn_enqueue", "rayn_occl_march")

_lib = None
build_log = ""


def build_dir() -> Path:
    env = os.environ.get("RAYN_TORCH_BUILD_DIR")
    return Path(env) if env else CSRC.parent.parent / "build" / "kernels"


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    cands = [shutil.which("nvcc"),
             os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                          "bin", "nvcc")]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def library_path(verbose: bool = False) -> Path:
    """Compile the kernels if the sources changed; return the .so path.
    verbose adds `-Xptxas -v` and keeps its report in `build_log`."""
    global build_log
    extra = ("-Xptxas", "-v") if verbose else ()
    h = hashlib.sha256(" ".join(FLAGS + extra).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    out_dir = build_dir()
    lib = out_dir / f"rayn_kernels_{h.hexdigest()[:16]}.so"
    log = lib.with_suffix(".log")
    if lib.exists():
        build_log = log.read_text() if log.exists() else ""
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs, procs = [], []
        for src in sorted(CSRC.glob("*.cu")):
            obj = os.path.join(tmp, src.stem + ".o")
            objs.append(obj)
            procs.append(subprocess.Popen(
                [nvcc, *FLAGS, *extra, "-c", "-o", obj, str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        logs = [p.communicate()[0] for p in procs]
        build_log = "".join(logs)
        failed = [p.returncode for p in procs if p.returncode != 0]
        if not failed:
            so = os.path.join(tmp, lib.name)
            link = subprocess.run([nvcc, *FLAGS, "-shared", "-o", so, *objs],
                                  capture_output=True, text=True)
            build_log += link.stdout + link.stderr
            failed = [link.returncode] if link.returncode != 0 else []
        if failed:
            raise RuntimeError(f"nvcc failed ({failed}):\n{build_log}")
        log.write_text(build_log)
        os.replace(so, lib)   # atomic: a concurrent build never sees a partial
    return lib


def load(verbose: bool = False) -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(library_path(verbose)))
        for name in KERNELS:
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def launch(name: str, args: ctypes.Structure, device) -> None:
    """Launch kernel `name` with its argument struct on the current
    stream of `device`; raise if the launch is refused. The launch runs
    with `device` as the thread's current CUDA device, so that a tensor
    on another card than the current one gets its own card's stream and
    grid (the `<<<>>>` launch in csrc/ uses the current device)."""
    import torch

    fn = getattr(load(), name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(ctypes.addressof(args), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


class MBox(ctypes.Structure):
    """csrc/common.cuh MBox: a MandelBox's iteration count and scalars."""
    _fields_ = [("iters", ctypes.c_int), ("scale", ctypes.c_float),
                ("box_l", ctypes.c_float), ("min_rad_sq", ctypes.c_float),
                ("fixed_rad_sq", ctypes.c_float)]


class SdfInst(ctypes.Structure):
    """csrc/common.cuh SdfInst: one instance's place in the tape, its
    material and bounding sphere."""
    _fields_ = [("op0", ctypes.c_int), ("n_ops", ctypes.c_int),
                ("prm0", ctypes.c_int), ("mat", ctypes.c_int),
                ("bv_r", ctypes.c_float), ("bv_r2", ctypes.c_float)]


class Sdf(ctypes.Structure):
    """csrc/common.cuh DeepSdf: the Sdf (the instance table and tape of
    the Tape kernels, tape 1), then the stack scratch of the DeepTape
    ones (tape 2)."""
    _fields_ = [("n_inst", ctypes.c_int), ("tape", ctypes.c_int),
                ("inst", ctypes.c_void_p), ("ops", ctypes.c_void_p),
                ("prm", ctypes.c_void_p), ("deep", ctypes.c_void_p),
                ("slots", ctypes.c_int64), ("depth", ctypes.c_int),
                ("points", ctypes.c_int)]


_TAPED: dict = {}


def taped(args: ctypes.Structure, sdf: Sdf) -> ctypes.Structure:
    """csrc/common.cuh DeepTaped<Args>: a DE-reading kernel's arguments,
    then its Sdf. Every launcher of such a kernel takes it; it passes its
    DeepTape kernels all of it, its Tape kernels the Taped<Args> prefix,
    and its MBoxOnly kernels (sdf.tape 0) the arguments alone, so that
    those take the arguments they took before SDF programs existed."""
    cls = _TAPED.get(type(args))
    if cls is None:
        cls = _TAPED[type(args)] = type(
            "Taped" + type(args).__name__, (ctypes.Structure,),
            {"_fields_": [("a", type(args)), ("sdf", Sdf)]})
    return cls(a=args, sdf=sdf)


# The device tables of the Tape kernels, made once per set of instances
# and device (a host-to-device copy) and kept: a render reads the same
# few sets in every pass.
_TAPES: dict = {}
_TAPES_MAX = 64
_force_tape = False


@contextlib.contextmanager
def tape_forced():
    """Within it every scene runs the Tape kernels, a bare MandelBox as a
    one-op tape (to price the interpreter against MBoxOnly)."""
    global _force_tape
    old, _force_tape = _force_tape, True
    try:
        yield
    finally:
        _force_tape = old


def _tape_tables(instances, device):
    """[n, 6] int32 instance rows (SdfInst), int32 op words and float32
    operands of the instances, on `device`, and the deepest the distance
    and point stacks of any of them get."""
    import numpy as np
    import torch

    from rayn_tpu_torch.ops import sdf as sdf_ops

    rows = np.zeros((len(instances), 6), np.int32)
    ops, prm = [], []
    depth = points = 0
    for i, (prog, mat, bv) in enumerate(instances):
        tp = sdf_ops.tape(prog)
        rows[i, :4] = (len(ops), len(tp.ops), len(prm), mat)
        # the square in double, then rounded: as the twins and MBoxOnly
        rows[i, 4:].view(np.float32)[:] = (bv, bv * bv)
        ops += tp.ops
        prm += tp.operands
        depth, points = max(depth, tp.depth), max(points, tp.points)
    return (torch.as_tensor(rows, device=device),
            torch.as_tensor(np.asarray(ops, np.int32), device=device),
            torch.as_tensor(np.asarray(prm, np.float32), device=device),
            depth, points)


# The DeepTape kernels' stack scratch, one per device, grown on demand.
# Every launch of the port runs on its device's current stream, so
# launches that share it run one after another.
_DEEP: dict = {}


def deep_slots(threads: int, device, persistent: bool) -> int:
    """Thread slots a DeepTape launch of `threads` work items needs: its
    grid rounded to whole 128-thread blocks, and for a persistent grid
    (launch_persistent) at most what the card holds at once."""
    import torch

    slots = -(-threads // 128) * 128
    if persistent and device.type == "cuda":
        p = torch.cuda.get_device_properties(device)
        slots = min(slots,
                    p.multi_processor_count * p.max_threads_per_multi_processor)
    return slots


def _deep_scratch(n_floats: int, device):
    import torch

    buf = _DEEP.get(str(device))
    if buf is None or buf.numel() < n_floats:
        buf = _DEEP[str(device)] = torch.empty(
            (n_floats,), dtype=torch.float32, device=device)
    return buf


def _bare_mandelbox(instances) -> bool:
    """Whether SDF `instances` ((program, ...) in object order) run the
    MBoxOnly kernels: one bare MandelBox, the Tape not forced."""
    from rayn_tpu_torch.ops import sdf as sdf_ops

    return (len(instances) == 1 and not _force_tape
            and type(instances[0][0]) is sdf_ops.MandelBox)


def mbox_of(instances) -> MBox:
    """The MBox that the MBoxOnly kernels read for SDF `instances`: the
    one bare MandelBox's, else zeros."""
    return mbox_struct(instances[0][0] if _bare_mandelbox(instances)
                       else None)


def sdf_args(instances, device, threads: int = 0,
             persistent: bool = True) -> tuple[MBox, Sdf]:
    """The (MBox, Sdf) arguments of SDF `instances`, a sequence of
    (program, material id, bound radius) in object order: for one bare
    MandelBox its MBox and an Sdf of tape 0 (the MBoxOnly kernels); else
    a zero MBox and the tape tables on `device`, tape 1 (the Tape
    kernels) when every program's stacks fit `sdf.DEPTH_CAP`, else tape
    2 (the DeepTape kernels) with a stack scratch of `deep_slots(threads,
    device, persistent)` thread slots; n_inst 0 for none. A user-written
    program (sdf.SdfProgram) raises NotImplementedError: no kernel
    evaluates it."""
    from rayn_tpu_torch.ops import sdf as sdf_ops

    inst = tuple((sdf_ops.check(p), int(m), float(b))
                 for p, m, b in instances)
    if not all(sdf_ops.kernel_ready(p) for p, _m, _b in inst):
        raise NotImplementedError("a user-written SdfProgram has no tape: "
                                  "no kernel evaluates it")
    if not inst:
        return mbox_struct(None), Sdf(n_inst=0, tape=0)
    if _bare_mandelbox(inst):
        return mbox_struct(inst[0][0]), Sdf(n_inst=1, tape=0)
    key = (inst, str(device))
    tables = _TAPES.get(key)
    if tables is None:
        if len(_TAPES) >= _TAPES_MAX:
            _TAPES.pop(next(iter(_TAPES)))
        tables = _TAPES[key] = _tape_tables(inst, device)
    rows, ops, prm, depth, points = tables
    sdf = Sdf(n_inst=len(inst), tape=1, inst=rows.data_ptr(),
              ops=ops.data_ptr(), prm=prm.data_ptr())
    if max(depth, points) > sdf_ops.DEPTH_CAP:
        slots = deep_slots(threads, device, persistent)
        sdf.tape, sdf.slots, sdf.depth, sdf.points = 2, slots, depth, points
        sdf.deep = _deep_scratch(slots * (depth + 3 * points),
                                 device).data_ptr()
    return mbox_struct(None), sdf


class QueueMarch(ctypes.Structure):
    """csrc/common.cuh QueueMarch: the refill march's queue, verdicts and
    scalars."""
    _fields_ = [(name, ctypes.c_void_p)
                for name in ("queue", "count", "head", "verdict")] + [
        ("m", ctypes.c_int64), ("max_steps", ctypes.c_int), ("mb", MBox),
        ("eps_c", ctypes.c_float), ("eps_l", ctypes.c_float),
        ("relax", ctypes.c_float), ("bv_r", ctypes.c_float),
        ("bv_r2", ctypes.c_float)]


def queue_march(queue: int, count: int, head, verdict, sdfs, detail: float,
                max_steps: int, relax: float) -> tuple[QueueMarch, Sdf]:
    """The QueueMarch of a refill march over M = verdict.numel() segments
    (queue and count: checked pointers; head: a zeroed [1] int32 tensor;
    verdict: a zeroed [M] bool tensor) through the SDF instances `sdfs`,
    a sequence of (program, bound radius) in object order, and their
    Sdf."""
    bv = float(sdfs[0][1]) if sdfs else 0.0
    mb, sdf = sdf_args([(p, 0, b) for p, b in sdfs], verdict.device,
                       verdict.numel())
    return QueueMarch(
        queue=queue, count=count, head=head.data_ptr(),
        verdict=verdict.data_ptr(), m=verdict.numel(), max_steps=max_steps,
        mb=mb, eps_c=1e-4 * detail, eps_l=1e-5 * detail, relax=relax,
        bv_r=bv, bv_r2=float(bv * bv)), sdf


class Track(ctypes.Structure):
    """csrc/common.cuh Track: a channel of positions [count, T, 3]."""
    _fields_ = [("knots", ctypes.c_void_p), ("T", ctypes.c_int),
                ("t0", ctypes.c_float), ("span", ctypes.c_float)]


class Anim(ctypes.Structure):
    """csrc/common.cuh Anim: the scene's light, sphere and MIS-light
    position tracks."""
    _fields_ = [("lights", Track), ("spheres", Track), ("mis", Track)]


def track(ch, name: str, count: int, device) -> Track:
    """The Track of an AnimChannel with values [count, T, 3] on `device`
    (None: an empty constant track). span is t1 - t0 rounded to float32,
    the divisor animation._lerp_state divides by."""
    import torch

    if ch is None:
        return Track(None, 1, 0.0, 1.0)
    T = int(ch.values.shape[1])
    knots = check(ch.values, name, torch.float32, (count, T, 3), device)
    return Track(knots, T, ch.t0, ch.t1 - ch.t0)


def mbox_struct(mb) -> MBox:
    """MBox of an ops.sdf.MandelBox (zeros for no SDF)."""
    if mb is None:
        return MBox(0, 0.0, 0.0, 0.0, 0.0)
    return MBox(mb.iterations, mb.scale, mb.box_l, mb.min_rad_sq,
                 mb.fixed_rad_sq)


def device_of(name: str, t: torch.Tensor):
    """The CUDA device of a kernel wrapper's operand `t`, or None when it
    lies on the CPU (the wrapper then runs its plain twin); raises for
    any other device."""
    if t.device.type == "cpu":
        return None
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")
    return t.device


def check(t: torch.Tensor, name: str, dtype, shape, device) -> int:
    """Validate one kernel operand and return its device pointer."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")
    return t.data_ptr()
