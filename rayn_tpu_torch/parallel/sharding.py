"""Rendering over the ranks of a torch.distributed group (port of
rayn_tpu.parallel.sharding).

The JAX package shards the flat (pixel, sample) ray-index space over a
`jax.sharding.Mesh` of chips with `shard_map` and merges the films with
a `psum`. Here the mesh is a process group, one process per card: every
rank calls the same function (SPMD), renders its slice of each pass
into a zero film, and `all_reduce` adds the slices, so every rank holds
the same merged film, as the replicated `psum` gives. Since the samplers
are counter functions of (pixel, sample), a ray gives the same bits on
any rank; the rank count changes the image only through the float32
order of the film's sums (atol 2e-5; the sample counts are exact).

Only the pass's pixel window is reduced: the ranks' ray slices are
contiguous, so their union covers the pixels [pass_start // spp,
ceil(pass_end / spp)) clipped to the film, about size·per_device/spp
pixels, and outside it every rank's film is zero. The collectives are
`all_reduce`, `broadcast` and `barrier`, which NCCL and gloo both take
on CUDA tensors.

A failure on one rank becomes a failure on every rank at the same
collective. Collectives pair by their order on each rank, so a rank
that stopped at an error and started again alone would pair its next
collective with a peer's later one. Every collective of a frame
(`render_pass_sharded`'s window, `agree`'s word at a checkpoint)
therefore carries a status word: a rank whose work failed still enters
the collective, with a zero contribution and its word set, and after
it every rank reads the summed word and raises the same error
(`PassFailed`, which a retry takes up on every rank together, or
`PassAborted`, which none retries).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist

from rayn_tpu_torch.config import RenderSettings
from rayn_tpu_torch.ops import filters as filter_ops
from rayn_tpu_torch.render import checkpoint as ckpt
from rayn_tpu_torch.render import film as film_mod
from rayn_tpu_torch.render import renderer


class PassFailed(RuntimeError):
    """A rank of the mesh failed with a transient error (a RuntimeError
    or an OSError); every rank raises it at the same collective, so all
    retry together (renderer.render_frame_resilient)."""


class PassAborted(Exception):
    """A rank of the mesh failed with an error that no retry mends;
    every rank raises it at the same collective."""


# The status word: a transient failure adds 1, any other failure
# _ABORT (more than any rank count), so the sum says whether a rank
# failed and whether a retry may mend it.
_ABORT = float(1 << 20)
# per device, the words [ok, transient failure, fatal failure]: a view
# of one rides at the end of a pass's window with no launch of its own
_WORDS: dict = {}


def _word(err, device) -> torch.Tensor:
    """[1] f32 status word of this rank: 0 for no error."""
    words = _WORDS.get(str(device))
    if words is None:
        words = _WORDS[str(device)] = torch.tensor(
            [0.0, 1.0, _ABORT], dtype=torch.float32, device=device)
    k = 0 if err is None else 1 if _transient(err) else 2
    return words[k:k + 1]


def _transient(err) -> bool:
    return (isinstance(err, renderer._TRANSIENT_ERRORS)
            and not isinstance(err, (NotImplementedError, PassAborted)))


def _raise_if_failed(total: float, err, what: str) -> None:
    """Raise on every rank once the summed word says a rank failed,
    chained to this rank's own error where it had one."""
    if total == 0.0:
        return
    if total >= _ABORT:
        raise PassAborted(f"a rank of the mesh failed in {what}; no retry "
                          "mends it") from err
    raise PassFailed(f"{int(total)} rank(s) of the mesh failed in {what}") \
        from err


def agree(mesh: Mesh, err, what: str) -> None:
    """One all_reduce of the ranks' status words (`err`: this rank's
    error, or None); every rank raises if any rank failed. It also
    stands for a barrier: no rank leaves before every rank has come."""
    if mesh.group is None:
        if err is not None:
            raise err
        return
    word = _word(err, mesh.device).clone()
    dist.all_reduce(word, op=dist.ReduceOp.SUM, group=mesh.group)
    _raise_if_failed(float(word.item()), err, what)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in a ("tile", "spp") mesh over a process group.
    `group` None is a one-rank mesh that runs no collective."""
    shape: dict          # {"tile": t, "spp": s}, t * s == size
    rank: int
    size: int
    device: torch.device
    group: Optional[object] = None

    @property
    def dev_index(self) -> int:
        """The rank's index in the ray deal: tile-major, tile * spp +
        spp_index (rayn_tpu/parallel/sharding.py:67-68), which is the
        rank."""
        return self.rank


def make_mesh(group=None, tile_axis: Optional[int] = None,
              device=None) -> Mesh:
    """The mesh of `group` (default: the initialised process group;
    without one, a one-rank mesh). `tile_axis` must divide the group's
    size (default: all of it). The device is the rank's card unless the
    caller asks for another, such as "cpu"; with no card that raises."""
    if dist.is_initialized():
        group = group if group is not None else dist.group.WORLD
        rank, size = dist.get_rank(group), dist.get_world_size(group)
    elif group is not None:
        raise ValueError("a group was given, but no process group is "
                         "initialised")
    else:
        rank, size = 0, 1
    tile_axis = size if tile_axis is None else tile_axis
    if tile_axis < 1 or size % tile_axis:
        raise ValueError(f"tile_axis {tile_axis} does not divide the "
                         f"group's {size} ranks")
    dev = _resolved(torch.device(device if device is not None else "cuda"))
    return Mesh({"tile": tile_axis, "spp": size // tile_axis}, rank, size,
                dev, group)


def _resolved(dev: torch.device) -> torch.device:
    """A CUDA device with its index (the current card when none is
    given); a missing card raises."""
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError("rayn_tpu_torch: no CUDA device; pass "
                           "device='cpu' to render on the CPU")
    return dev if dev.index is not None else torch.device(
        "cuda", torch.cuda.current_device())


def check_mesh(mesh, data) -> None:
    """TypeError for anything but a Mesh; ValueError for a mesh on
    another device than the scene's."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a rayn_tpu_torch.parallel.sharding."
                        f"Mesh (make_mesh()), not {type(mesh).__name__}")
    if _resolved(torch.device(mesh.device)) != data.device:
        raise ValueError(f"the mesh is on {mesh.device} and the scene on "
                         f"{data.device}")


def pass_window(pass_start: int, pass_size: int, spp: int,
                n_pixels: int) -> tuple[int, int]:
    """The pixels [lo, hi) that rays [pass_start, pass_start + pass_size)
    splat into, clipped to the film."""
    return pass_start // spp, min(n_pixels,
                                  -(-(pass_start + pass_size) // spp))


def render_pass_sharded(mesh: Mesh, film: film_mod.Film, data, static,
                        settings: RenderSettings, tables, camera,
                        fis_table, pass_start: int, per_device: int,
                        t0: float, t1: float, sample_base: int = 0,
                        after=None) -> film_mod.Film:
    """One pass of `per_device * mesh.size` rays: this rank renders rays
    [pass_start + rank * per_device, + per_device) into a zero film and
    calls `after()` if given, the ranks' films are summed over the
    pass's pixel window by one all_reduce (every accumulator, the extras
    too, and the status word at its end), and the sum is added to `film`
    in place, which is returned. Every rank of the mesh must call it
    with the same arguments but its film. If the rank's render or
    `after` raises, it still enters the all_reduce, with a zero window
    and its word set, and every rank raises PassFailed or PassAborted
    after it; `film` is then left as it was."""
    n_px = film.color.shape[0]
    err = None
    try:
        local = renderer.render_pass(
            film_mod.new_film(n_px, mesh.device, settings), data, static,
            settings, tables, camera, fis_table,
            pass_start + mesh.rank * per_device, per_device, t0, t1,
            sample_base=sample_base)
        if after is not None:
            after()
    except Exception as e:  # every rank must reach the all_reduce
        if mesh.group is None:
            raise
        err = e
        local = film_mod.new_film(n_px, mesh.device, settings)
    lo, hi = pass_window(pass_start, per_device * mesh.size, settings.spp,
                         n_px)
    parts = [t[lo:hi] for t in film_mod.tensors(local)]
    if mesh.group is not None:
        flat = torch.cat([p.reshape(-1) for p in parts]
                         + [_word(err, mesh.device)])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.group)
        _raise_if_failed(float(flat[-1].item()), err,
                         f"the pass at ray {pass_start}")
        parts = _unflatten(flat, parts)
    for acc, part in zip(film_mod.tensors(film), parts):
        acc[lo:hi] += part
    return film


def barrier(mesh: Mesh) -> None:
    """Wait until every rank of the mesh's group has come here (NCCL's
    barrier on the rank's card)."""
    if mesh.group is None:
        return
    kw = ({"device_ids": [mesh.device.index]}
          if dist.get_backend(mesh.group) == "nccl" else {})
    dist.barrier(group=mesh.group, **kw)


def _unflatten(flat: torch.Tensor, like: list) -> list:
    """Views of `flat` shaped as the tensors of `like`, in order."""
    out, i = [], 0
    for t in like:
        out.append(flat[i:i + t.numel()].view(t.shape))
        i += t.numel()
    return out


def _broadcast_film(film: film_mod.Film, src: int,
                    group) -> film_mod.Film:
    """The film of group rank `src` on every rank (one broadcast of all
    its accumulators); `film` is this rank's film or a zero one of the
    same shapes."""
    parts = film_mod.tensors(film)
    flat = torch.cat([p.reshape(-1) for p in parts])
    dist.broadcast(flat, src=dist.get_global_rank(group, src), group=group)
    got = _unflatten(flat, parts)
    return film_mod.Film(*got[:len(film_mod.CHANNELS)],
                         extra=tuple(got[len(film_mod.CHANNELS):]))


def render_frames_per_chip(data, static, settings: RenderSettings, camera,
                           frames, mesh: Optional[Mesh] = None,
                           filter=None, frame_rate: float = 24.0,
                           shutter_speed: float = 1.0 / 24.0,
                           checkpoint_dir: Optional[str] = None,
                           retries: int = 0,
                           progress: Optional[callable] = None
                           ) -> list[film_mod.Film]:
    """Frame-level parallelism: whole frames dealt one per rank. Frames
    go out in chunks of mesh.size, chunk[i] to rank i, which renders it
    alone with `renderer.render_frame` (so its film is the same bits as
    the sequential render); then each owner broadcasts its film, and
    every rank returns every frame's film, in the order of `frames`.

    With `checkpoint_dir`, the owner saves each finished frame as
    `<dir>/frame_<f>.npz` (render_frame's checkpoint of that frame) and
    every rank skips the frames already saved there, so a farm that
    stopped loses at most its chunk in flight. The directory must be one
    file system shared by every rank. A failed render is retried
    `retries` times inside its rank, before the broadcast, resuming from
    its checkpoint where it has one. `progress(frames_done,
    frames_total)` runs on every rank after each chunk."""
    mesh = mesh if mesh is not None else make_mesh()
    check_mesh(mesh, data)
    w, h = settings.resolution
    filt = filter or filter_ops.blackman_harris(1.5)
    n_passes = renderer.seg_passes(settings, settings.spp)[1]

    def path(f):
        return os.path.join(checkpoint_dir, f"frame_{f}.npz")

    frames = list(frames)
    by_frame: dict = {}
    todo = []
    for f in frames:
        if checkpoint_dir and f not in by_frame:
            t0 = f / frame_rate
            saved = ckpt.load(path(f), **renderer.checkpoint_key(
                data, static, settings, camera, f, (t0, t0 + shutter_speed),
                filt), device=data.device)
            if saved is not None and saved[1] >= n_passes:
                by_frame[f] = saved[0]
                continue
        if f not in by_frame and f not in todo:
            todo.append(f)
    if checkpoint_dir:
        # no owner may save a frame before every rank has looked
        barrier(mesh)

    done = len(frames) - len(todo)
    for c0 in range(0, len(todo), mesh.size):
        chunk = todo[c0:c0 + mesh.size]
        mine = None
        if mesh.rank < len(chunk):
            f = chunk[mesh.rank]
            mine = renderer.render_frame_resilient(
                data, static, settings, camera, retries=retries, frame=f,
                filter=filt, frame_rate=frame_rate,
                shutter_speed=shutter_speed,
                checkpoint_path=path(f) if checkpoint_dir else None,
                checkpoint_every=n_passes)
        for i, f in enumerate(chunk):
            film = mine if i == mesh.rank else film_mod.new_film(
                w * h, data.device, settings)
            if mesh.group is not None:
                film = _broadcast_film(film, i, mesh.group)
            by_frame[f] = film
        done += len(chunk)
        if progress is not None:
            progress(done, len(frames))
    return [by_frame[f] for f in frames]


def render_frame_sharded(data, static, settings: RenderSettings, camera,
                         frame: int = 1, mesh: Optional[Mesh] = None,
                         **kwargs) -> film_mod.Film:
    """`renderer.render_frame` over a mesh (default: `make_mesh()`, the
    initialised group on the rank's card), so every option of the
    one-card path (checkpoints, progress, filter) works on it. For
    retries use `renderer.render_frame_resilient(..., mesh=mesh)`."""
    return renderer.render_frame(data, static, settings, camera,
                                 frame=frame,
                                 mesh=mesh if mesh is not None
                                 else make_mesh(), **kwargs)
