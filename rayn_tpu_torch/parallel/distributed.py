"""Multi-process frame farm (port of rayn_tpu.parallel.distributed).

Frames are dealt round-robin over the processes of a torch.distributed
group, one process per card. Nothing crosses between processes but the
group's handshake: every process renders its own frames with
`renderer.render_frame` and writes its own PNGs, and each frame's film
is the same bits as a one-process render of it (the samplers are salted
only by the frame number, so where a frame renders does not matter).

`init` is the counterpart of `jax.distributed.initialize`: given a
coordinator and a process count above 1 it joins that group; with no
arguments under torchrun (WORLD_SIZE above 1) it joins torchrun's group;
otherwise it does nothing. Before the group starts, the process is bound
to its card, `cuda:{LOCAL_RANK}` (or `rank % device_count`), so that
"cuda" means the rank's own card.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist

# A rank that died surfaces in the others as an error after this long,
# not as a hang.
TIMEOUT = datetime.timedelta(minutes=10)


def init(coordinator_address: Optional[str] = None,
         num_processes: Optional[int] = None,
         process_id: Optional[int] = None, backend: Optional[str] = None,
         device="cuda") -> bool:
    """Join a process group; True if this call started one.

    `coordinator_address` is `host:port` (a TCP rendezvous, process 0
    listens) or any torch init_method URL, such as `file:///path` on a
    shared file system. The backend is NCCL on the card and gloo when
    `device` is the CPU. A missing card raises."""
    if dist.is_initialized():
        return False
    if num_processes is not None and num_processes > 1:
        if coordinator_address is None or process_id is None:
            raise ValueError("num_processes > 1 needs coordinator_address "
                             "and process_id")
        method = (coordinator_address if "://" in coordinator_address
                  else f"tcp://{coordinator_address}")
        rank, world = process_id, num_processes
    elif (num_processes is None and coordinator_address is None
          and int(os.environ.get("WORLD_SIZE", "1")) > 1):
        method, rank, world = "env://", int(os.environ["RANK"]), None
    else:
        return False
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("rayn_tpu_torch: no CUDA device; pass "
                               "device='cpu' to run the group on the CPU")
        local = os.environ.get("LOCAL_RANK")
        torch.cuda.set_device(int(local) if local is not None
                              else rank % torch.cuda.device_count())
    kw = dict(world_size=world, rank=rank) if world is not None else {}
    dist.init_process_group(
        backend or ("nccl" if dev.type == "cuda" else "gloo"),
        init_method=method, timeout=TIMEOUT, **kw)
    return True


def frames_for_process(frames: Sequence[int], process_id: int,
                       num_processes: int) -> list[int]:
    """Round-robin frame deal: process p renders frames[p::P]."""
    return list(frames)[process_id::num_processes]


def render_frames_multiprocess(data, static, settings, camera,
                               frames: Sequence[int],
                               process_id: Optional[int] = None,
                               num_processes: Optional[int] = None,
                               per_chip: bool = True,
                               filter=None, frame_rate: float = 24.0,
                               shutter_speed: float = 1.0 / 24.0):
    """Render this process's share of `frames` on the scene's device;
    returns [(frame, Film)] of that share, in order. No collective runs.
    The rank and the process count default to the group's (0 and 1
    without a group).

    `per_chip` is accepted for the JAX package's signature and changes
    nothing: there it deals a process's frames one per local chip, and
    here every process owns one card, so the farm's ranks are already
    that level."""
    from rayn_tpu_torch.render import renderer

    grouped = dist.is_initialized()
    pid = process_id if process_id is not None else (
        dist.get_rank() if grouped else 0)
    nproc = num_processes if num_processes is not None else (
        dist.get_world_size() if grouped else 1)
    mine = frames_for_process(frames, pid, nproc)
    return [(f, renderer.render_frame(
        data, static, settings, camera, frame=f, filter=filter,
        frame_rate=frame_rate, shutter_speed=shutter_speed)) for f in mine]
