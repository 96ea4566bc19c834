"""Sphere-tracing kernels of the segment-queue bounce: CUDA and plain twins.

Port of the `rayn_tpu.ops.march_pallas` kernels that the unfused bounce
runs (csrc/march.cu):

- `march` replaces `march` (`_march_kernel`): the closest-hit march of
  one SDF program along each ray, plain or over-relaxed (`relax`). The
  kernel is a refill march over the wavefront: persistent lanes that each
  take a ray (a warp claims 32 ray ids at a time from a device counter),
  march it and write its t to the ray's own slot, then take the next.
- `march_occlusion` replaces `march_occlusion` (`_occl_kernel`): shadow
  segments with the bounding-sphere clip, plain or over-relaxed. It is a
  function over two kernels: `enqueue` compacts the ids of the active
  segments into a queue (one atomicAdd per warp), and `occlusion_march`
  marches the queue with persistent lanes that each take a segment,
  march it and take the next (the refill march of the bounce tail's
  shadow queue, csrc/common.cuh), writing each verdict to the segment's
  own slot.
- `march_occlusion_chained` replaces `march_occlusion_chained`
  (`_chained_occl_core`): K segments per ray, each with the relax-1
  verdict of `march_occlusion`: the same two kernels on the K*N
  segments (the TPU's chaining was a schedule, never a result).
- `march_sorted` and `march_phased` replace the TPU functions of those
  names (`_march_phase1_kernel`, a regroup of the lanes by a sort or a
  partition, `_march_resume_kernel`). Every lane of the two-phase march
  takes the steps of one uncapped plain march, so at every split the
  result is `march`'s at relax 1 bit for bit, and the refill march
  regroups its lanes as each ray resolves: both are one launch of the
  march kernel, with `phase1_steps` checked and selecting nothing.
  `march_sorted_plain` and `march_phased_plain` are the TPU functions'
  own schedule in plain torch (phase 1, the lane order, the resume), the
  references the tests hold against JAX.
- `march_occlusion_phased` and `march_occlusion_sorted` replace the TPU
  functions of those names (`_occl_phase1_kernel`, a regroup of the
  lanes, `_occl_resume_kernel`). Their verdicts are those of
  `march_occlusion` at relax 1 with no bounding-sphere clip at every
  split >= 1, and the refill march regroups its lanes as each segment
  resolves, so both are the enqueue kernel and the refill march; at
  split 0 the march takes JAX's first-DE verdict (march_pallas.py:518).
  `march_occlusion_phased_plain` and `march_occlusion_sorted_plain` are
  the TPU functions' own schedule in plain torch (phase 1, the lane
  order, the resume), the references the tests hold against JAX.

Every function takes one SDF program (ops/sdf.py), as JAX's take one
instance a call: a bare MandelBox launches the kernels' MBoxOnly
instantiations, any other program their Tape ones.

Each kernel wrapper launches its kernel for CUDA tensors, counts the
launch in its `launches` attribute, and raises on anything the kernel
does not take. For CPU tensors it calls its `_plain` twin, which is the
plain torch march of ops/march.py. `march_occlusion_plain` and
`march_occlusion_chained_plain` are the two functions in one piece.
"""

from __future__ import annotations

import ctypes

import torch

from rayn_tpu_torch import _build
from rayn_tpu_torch._build import MBox, QueueMarch, check, queue_march
from rayn_tpu_torch.ops import march as march_ops

_P = ctypes.c_void_p


class _MarchArgs(ctypes.Structure):
    _fields_ = [(name, _P) for name in (
        "origin", "direction", "t_max", "eps_abs", "eps_lin", "active",
        "head", "warp_steps", "t")] + [
        ("n", ctypes.c_int64), ("max_steps", ctypes.c_int), ("mb", MBox),
        ("eps_const", ctypes.c_float), ("relax", ctypes.c_float)]


class _EnqueueArgs(ctypes.Structure):
    _fields_ = [(name, _P) for name in ("active", "queue", "count")] + [
        ("n", ctypes.c_int64)]


class _OcclMarchArgs(ctypes.Structure):
    _fields_ = [("start", _P), ("end", _P), ("q", QueueMarch),
                ("first_de", ctypes.c_int)]


def _cuda_device(t: torch.Tensor, name: str) -> torch.device:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")
    return t.device


def _steps_at_least(steps: int, least: int, name: str) -> int:
    if steps < least:
        raise ValueError(f"{name} needs at least {least} steps, got {steps}")
    return steps


def _int32_ids(m: int, name: str) -> int:
    if m >= 2 ** 31:
        raise ValueError(f"{name}: {m} ids overflow int32")
    return m


def march_plain(prog, origin, direction, t_max, eps_const: float,
                eps_abs, eps_lin, max_steps: int, active,
                relax: float = 1.0) -> torch.Tensor:
    """Plain twin of the march kernel (ops/march.py march)."""
    return march_ops.march(prog, origin, direction, t_max, eps_const, eps_abs,
                           eps_lin, max_steps, active, relax)


def march(prog, origin, direction, t_max, eps_const: float,
          eps_abs, eps_lin, max_steps: int, active, relax: float = 1.0,
          warp_steps=None) -> torch.Tensor:
    """[N] f32 t of the closest SDF hit along each ray (>= t_max on a
    miss, t_max + 1 on an inactive lane, NaN where the first DE is).
    `warp_steps`, a [1] int64 CUDA tensor, has the kernel's warps add
    their loop iterations to it (one DE per busy lane each)."""
    if origin.device.type == "cpu":
        return march_plain(prog, origin, direction, t_max, eps_const, eps_abs,
                           eps_lin, max_steps, active, relax)
    dev = _cuda_device(origin, "march")
    n = _int32_ids(origin.shape[0], "march")
    f32 = torch.float32
    t = torch.empty((n,), dtype=f32, device=dev)
    head = torch.zeros((1,), dtype=torch.int32, device=dev)
    mb, sdf = _build.sdf_args([(prog, 0, 0.0)], dev, n)
    args = _MarchArgs(
        origin=check(origin, "origin", f32, (n, 3), dev),
        direction=check(direction, "direction", f32, (n, 3), dev),
        t_max=check(t_max, "t_max", f32, (n,), dev),
        eps_abs=check(eps_abs, "eps_abs", f32, (n,), dev),
        eps_lin=check(eps_lin, "eps_lin", f32, (n,), dev),
        active=check(active, "active", torch.bool, (n,), dev),
        head=head.data_ptr(),
        warp_steps=(None if warp_steps is None else check(
            warp_steps, "warp_steps", torch.int64, (1,), dev)),
        t=t.data_ptr(), n=n, max_steps=max_steps, mb=mb,
        eps_const=eps_const, relax=relax)
    _build.launch("rayn_march", _build.taped(args, sdf), dev)
    march.launches += 1
    return t


march.launches = 0


def enqueue_plain(active):
    """Plain twin of the enqueue kernel: the ids of the True entries of
    `active` in id order, then zeros ([M] int32), and their count ([1]
    int32)."""
    ids = torch.nonzero(active).squeeze(1).to(torch.int32)
    queue = torch.zeros(active.shape, dtype=torch.int32,
                        device=active.device)
    queue[:ids.numel()] = ids
    return queue, torch.full((1,), ids.numel(), dtype=torch.int32,
                             device=active.device)


def enqueue(active):
    """(queue [M] int32, count [1] int32): the ids of the True entries of
    the [M] bool `active`, in any order, first in the queue, and how
    many there are."""
    if active.device.type == "cpu":
        return enqueue_plain(active)
    dev = _cuda_device(active, "enqueue")
    m = _int32_ids(active.shape[0], "enqueue")
    queue = torch.empty((m,), dtype=torch.int32, device=dev)
    count = torch.zeros((1,), dtype=torch.int32, device=dev)
    args = _EnqueueArgs(active=check(active, "active", torch.bool, (m,), dev),
                        queue=queue.data_ptr(), count=count.data_ptr(), n=m)
    _build.launch("rayn_enqueue", args, dev)
    enqueue.launches += 1
    return queue, count


enqueue.launches = 0


def occlusion_march_plain(prog, start, end, detail_scale: float,
                          max_steps: int, queue, count, relax: float = 1.0,
                          bound_radius: float = 0.0,
                          first_de: bool = False) -> torch.Tensor:
    """Plain twin of the refill march: the march_occlusion verdicts
    (ops/march.py) of the queued segments, False elsewhere."""
    verdict = torch.zeros((start.shape[0],), dtype=torch.bool,
                          device=start.device)
    ids = queue[:int(count[0])].long()
    verdict[ids] = march_ops.march_occlusion(
        prog, start[ids], end[ids], detail_scale, max_steps,
        torch.ones_like(ids, dtype=torch.bool), bound_radius, relax,
        first_de=first_de)
    return verdict


def occlusion_march(prog, start, end, detail_scale: float,
                    max_steps: int, queue, count, relax: float = 1.0,
                    bound_radius: float = 0.0,
                    first_de: bool = False) -> torch.Tensor:
    """[M] bool: True where the SDF blocks segment start -> end, for the
    segments whose ids are the first `count` entries of `queue` ([M]
    int32, any order); False for the others. With `first_de` (relax 1
    only) a segment whose first DE is below 1e-4 before its end is
    blocked at once and `max_steps` may be 0 (ops/march.py
    march_occlusion)."""
    if first_de and relax != 1.0:
        raise ValueError(f"the first-DE entry marches at relax 1, got {relax}")
    if start.device.type == "cpu":
        return occlusion_march_plain(prog, start, end, detail_scale,
                                     max_steps, queue, count, relax,
                                     bound_radius, first_de)
    dev = _cuda_device(start, "occlusion_march")
    m = _int32_ids(start.shape[0], "occlusion_march")
    f32, i32 = torch.float32, torch.int32
    verdict = torch.zeros((m,), dtype=torch.bool, device=dev)
    head = torch.zeros((1,), dtype=i32, device=dev)
    q, sdf = queue_march(check(queue, "queue", i32, (m,), dev),
                         check(count, "count", i32, (1,), dev), head,
                         verdict, [(prog, bound_radius)], detail_scale,
                         _steps_at_least(max_steps, 0 if first_de else 1,
                                         "occlusion_march"),
                         relax)
    args = _OcclMarchArgs(
        start=check(start, "start", f32, (m, 3), dev),
        end=check(end, "end", f32, (m, 3), dev), q=q,
        first_de=int(first_de))
    _build.launch("rayn_occl_march", _build.taped(args, sdf), dev)
    occlusion_march.launches += 1
    return verdict


occlusion_march.launches = 0


def march_occlusion_plain(prog, start, end, detail_scale: float,
                          max_steps: int, active, relax: float = 1.0,
                          bound_radius: float = 0.0) -> torch.Tensor:
    """Plain version of `march_occlusion` in one piece (ops/march.py)."""
    if max_steps <= 0:
        return march_ops.march_occlusion(prog, start, end, detail_scale, 0,
                                         active, bound_radius,
                                         first_de=True)
    return march_ops.march_occlusion(prog, start, end, detail_scale, max_steps,
                                     active, bound_radius, relax)


def march_occlusion(prog, start, end, detail_scale: float,
                    max_steps: int, active, relax: float = 1.0,
                    bound_radius: float = 0.0) -> torch.Tensor:
    """[M] bool: True where the SDF blocks segment start -> end (active
    segments; False for the others): the enqueue kernel, then the refill
    march of the queue. At `max_steps` 0 no segment steps, at any
    `relax`: the verdict is the first-DE entry's (first DE below 1e-4
    before the end), as JAX's march_occlusion and its Pallas kernel give
    with no loop iteration (ops/march.py:126-170)."""
    queue, count = enqueue(active)
    if max_steps <= 0:
        return occlusion_march(prog, start, end, detail_scale, 0, queue, count,
                               1.0, bound_radius, first_de=True)
    return occlusion_march(prog, start, end, detail_scale, max_steps, queue,
                           count, relax, bound_radius)


def march_occlusion_chained_plain(prog, start, end,
                                  detail_scale: float, max_steps: int,
                                  active,
                                  bound_radius: float = 0.0) -> torch.Tensor:
    """Plain version of `march_occlusion_chained` in one piece
    (ops/march.py)."""
    return march_ops.march_occlusion_chained(prog, start, end, detail_scale,
                                             max_steps, active, bound_radius)


def march_occlusion_chained(prog, start, end, detail_scale: float,
                            max_steps: int, active,
                            bound_radius: float = 0.0) -> torch.Tensor:
    """[K, N] bool verdicts of K segments per ray (start/end [K, N, 3],
    active [K, N]), each that of `march_occlusion` at relax 1: the same
    two kernels on the K*N segments. At `max_steps` 0 every segment takes
    one step, as in JAX's chained core (march_pallas.py:883-896)."""
    k, n = start.shape[0], start.shape[1]
    return march_occlusion(prog, start.reshape(k * n, 3),
                           end.reshape(k * n, 3), detail_scale,
                           max(max_steps, 1), active.reshape(k * n), 1.0,
                           bound_radius).reshape(k, n)


# ------------------------------------------------ the two-phase functions
def _check_split(phase1_steps: int) -> None:
    if phase1_steps < 0:
        raise ValueError(f"phase1_steps must be >= 0, got {phase1_steps}")


def partition_order(resolved):
    """Lane order with the unresolved lanes first, each group in lane
    order (march_pallas.py:465-471, :641-647)."""
    return torch.argsort(resolved.to(torch.uint8), stable=True)


def sorted_order(resolved, length, t1, phase1_steps: int):
    """Lane order by predicted remaining steps, resolved lanes first:
    the length left over phase 1's speed (march_pallas.py:209-213,
    :740-746)."""
    speed = torch.clamp(t1, min=1e-20) / float(phase1_steps)
    return torch.argsort(torch.where(resolved, -1.0, (length - t1) / speed))


def _march_two_phase_plain(sort: bool, prog, origin, direction, t_max,
                           eps_const, eps_abs, eps_lin, max_steps, active,
                           phase1_steps):
    _check_split(phase1_steps)
    head = (prog, origin, direction, t_max, eps_const, eps_abs, eps_lin)
    t1, resolved = march_ops.march_phase1(
        *head, min(phase1_steps, max_steps), active)
    if phase1_steps >= max_steps:
        return t1
    order = (sorted_order(resolved, t_max, t1, phase1_steps) if sort
             else partition_order(resolved))
    return march_ops.march_resume(*head, max_steps - phase1_steps, t1,
                                  resolved, order)


def march_sorted_plain(prog, origin, direction, t_max,
                       eps_const: float, eps_abs, eps_lin, max_steps: int,
                       active, phase1_steps: int = 8) -> torch.Tensor:
    """march_pallas.march_sorted in plain torch, in one piece: phase 1,
    a sort by predicted remaining steps, the resume."""
    return _march_two_phase_plain(True, prog, origin, direction, t_max,
                                  eps_const, eps_abs, eps_lin, max_steps,
                                  active, phase1_steps)


def march_phased_plain(prog, origin, direction, t_max,
                       eps_const: float, eps_abs, eps_lin, max_steps: int,
                       active, phase1_steps: int = 32) -> torch.Tensor:
    """march_pallas.march_phased in plain torch, in one piece: phase 1,
    the unresolved lanes first, the resume."""
    return _march_two_phase_plain(False, prog, origin, direction, t_max,
                                  eps_const, eps_abs, eps_lin, max_steps,
                                  active, phase1_steps)


def march_sorted(prog, origin, direction, t_max, eps_const: float,
                 eps_abs, eps_lin, max_steps: int, active,
                 phase1_steps: int = 8) -> torch.Tensor:
    """[N] t of march_pallas.march_sorted: `march`'s at relax 1, from one
    launch of the march kernel (`march_plain` on the CPU).
    `phase1_steps` (>= 0) selects nothing: every split gives the same
    bits."""
    _check_split(phase1_steps)
    return march(prog, origin, direction, t_max, eps_const, eps_abs, eps_lin,
                 max_steps, active)


def march_phased(prog, origin, direction, t_max, eps_const: float,
                 eps_abs, eps_lin, max_steps: int, active,
                 phase1_steps: int = 32) -> torch.Tensor:
    """[N] t of march_pallas.march_phased, the same as march_sorted's:
    one launch of the march kernel, `phase1_steps` (>= 0) selecting
    nothing."""
    _check_split(phase1_steps)
    return march(prog, origin, direction, t_max, eps_const, eps_abs, eps_lin,
                 max_steps, active)


def march_occlusion_phased_plain(prog, start, end,
                                 detail_scale: float, max_steps: int, active,
                                 phase1_steps: int = 16) -> torch.Tensor:
    """march_pallas.march_occlusion_phased in plain torch, in one piece:
    phase 1, the unresolved segments first, the resume."""
    return _occlusion_two_phase_plain(False, prog, start, end, detail_scale,
                                      max_steps, active, phase1_steps)


def march_occlusion_sorted_plain(prog, start, end,
                                 detail_scale: float, max_steps: int, active,
                                 phase1_steps: int = 8) -> torch.Tensor:
    """march_pallas.march_occlusion_sorted in plain torch, in one piece:
    phase 1, a sort by predicted remaining steps, the resume."""
    return _occlusion_two_phase_plain(True, prog, start, end, detail_scale,
                                      max_steps, active, phase1_steps)


def _occlusion_two_phase_plain(sort: bool, prog, start, end, detail_scale,
                               max_steps, active, phase1_steps):
    _check_split(phase1_steps)
    occ, t1, resolved = march_ops.occlusion_phase1(
        prog, start, end, detail_scale, min(phase1_steps, max_steps), active)
    if phase1_steps >= max_steps:
        return occ
    if sort:
        seg = end - start
        order = sorted_order(resolved, torch.sqrt((seg * seg).sum(-1)), t1,
                             phase1_steps)
    else:
        order = partition_order(resolved)
    return march_ops.occlusion_resume(prog, start, end, detail_scale,
                                      max_steps - phase1_steps, occ, t1,
                                      resolved, order)


def _occlusion_refill(prog, start, end, detail_scale, max_steps, active,
                      phase1_steps):
    """The enqueue kernel and the unclipped relax-1 refill march, with
    the first-DE entry where phase 1 would take no step."""
    _check_split(phase1_steps)
    queue, count = enqueue(active)
    return occlusion_march(prog, start, end, detail_scale, max_steps, queue,
                           count, first_de=min(phase1_steps, max_steps) == 0)


def march_occlusion_phased(prog, start, end, detail_scale: float,
                           max_steps: int, active,
                           phase1_steps: int = 16) -> torch.Tensor:
    """[M] bool verdicts of march_pallas.march_occlusion_phased: those of
    `march_occlusion` at relax 1 with no bounding-sphere clip, from the
    enqueue kernel and the refill march. `phase1_steps` (>= 0) only
    selects JAX's verdict at split 0 (no phase-1 step: a segment whose
    first DE is below 1e-4 before its end is blocked, the others march
    in full); on the CPU the same two twins run."""
    return _occlusion_refill(prog, start, end, detail_scale, max_steps,
                             active, phase1_steps)


def march_occlusion_sorted(prog, start, end, detail_scale: float,
                           max_steps: int, active,
                           phase1_steps: int = 8) -> torch.Tensor:
    """[M] bool verdicts of march_pallas.march_occlusion_sorted, the same
    as march_occlusion_phased's at the same split (the lane order never
    changes a verdict): the enqueue kernel and the refill march, with
    `phase1_steps` (>= 0) only selecting the split-0 verdict."""
    return _occlusion_refill(prog, start, end, detail_scale, max_steps,
                             active, phase1_steps)
