"""Frame renderer: ray generation -> wavefront trace -> film splat (port
of rayn_tpu.render.renderer: ray_indices, generate_rays, render_pass,
render_passes, render_frame, render_frame_resilient; reference
src/film.rs:380-628).

The frame's (pixel, sample) grid is flattened into one ray index space
and rendered in passes of `rays_per_pass` rays with a plain loop; the
last pass may run past the end of the frame, and its extra lanes start
dead and splat nothing. The film holds one accumulator for each of
`settings.extra_aovs` (render/aovs.py, taken at depth 0); with
`compact_bounces` the integrator hands the pass back in ray order, so
every pass is splatted the same way. A checkpointed render saves the
film every few passes and resumes where it stopped, growing spp
progressively (render/checkpoint.py). With a mesh
(parallel/sharding.py) every rank of a process group renders its slice
of each pass and the film is merged by all_reduce.
"""

from __future__ import annotations

import collections
import dataclasses
import sys
from typing import Optional

import torch

from rayn_tpu_torch.config import RenderSettings
from rayn_tpu_torch.ops import filters as filter_ops
from rayn_tpu_torch.render import checkpoint as ckpt
from rayn_tpu_torch.render import film as film_mod
from rayn_tpu_torch.render.camera import Camera
from rayn_tpu_torch.render.integrator import init_state, trace
from rayn_tpu_torch.scene.scene import SceneData, SceneStatic
from rayn_tpu_torch.utils import rng
from rayn_tpu_torch.utils.profiling import span
from rayn_tpu_torch.utils.rng import SampleTables
from rayn_tpu_torch.utils.vecmath import div


def ray_indices(pass_start: int, pass_size: int, device):
    """Flat ray ids of one pass, made on the device."""
    return pass_start + torch.arange(pass_size, dtype=torch.int64,
                                     device=device)


def generate_rays(settings: RenderSettings, tables: SampleTables,
                  camera: Camera, fis_table: torch.Tensor,
                  ray_idx: torch.Tensor, t0: float, t1: float,
                  sample_base: int = 0):
    """Camera rays for flat ray indices (pixel-major, spp-minor): FIS
    pixel offsets, NDC, shutter-time jitter, lens samples (reference
    src/film.rs:456-527). Returns (origin, direction, time, pixel,
    sample_idx, in_range).

    `sample_base` offsets the per-pixel sample index: with settings.spp
    K and sample_base B these are the rays of sample indices [B, B + K)
    of every pixel, the same bits as those rays of a flat render of
    spp >= B + K (the samplers are counter functions of (pixel,
    sample_idx)): the progressive-spp segments of render_frame."""
    w, h = settings.resolution
    total = w * h * settings.spp
    in_range = ray_idx < total
    safe_idx = torch.clamp(ray_idx, max=total - 1)
    pixel = (safe_idx // settings.spp).to(torch.int32)
    sample_idx = (safe_idx % settings.spp).to(torch.int32) + sample_base
    x = (pixel % w).to(torch.float32)
    y = (pixel // w).to(torch.float32)

    u_px = rng.sample_2d(settings, tables, rng.set2d_pixel_uv(), sample_idx,
                         pixel)
    off_x = filter_ops.fis_sample(fis_table, u_px[:, 0])
    off_y = filter_ops.fis_sample(fis_table, u_px[:, 1])
    ndc = torch.stack([div(x + 0.5 + off_x, w), div(y + 0.5 + off_y, h)],
                      dim=-1)

    u_t = rng.sample_1d(settings, tables, rng.set1d_time(), sample_idx, pixel)
    t0f = torch.tensor(t0, dtype=torch.float32)
    t1f = torch.tensor(t1, dtype=torch.float32)
    time = float(t0f) + float(t1f - t0f) * u_t
    lens = rng.sample_2d(settings, tables, rng.set2d_lens(), sample_idx,
                         pixel)
    origin, direction = camera.generate(ndc, time, lens)
    return origin, direction, time, pixel, sample_idx, in_range


def render_pass(film: film_mod.Film, data: SceneData, static: SceneStatic,
                settings: RenderSettings, tables: SampleTables,
                camera: Camera, fis_table: torch.Tensor,
                pass_start: int, pass_size: int, t0: float,
                t1: float, sample_base: int = 0) -> film_mod.Film:
    """Render rays [pass_start, pass_start + pass_size) into the film;
    `sample_base` shifts their per-pixel sample indices (progressive
    spp; see generate_rays). `film.splat` adds it, padding a pass that
    starts or ends inside a pixel to whole pixels (an aligned pass gives
    `film.splat_aligned`'s bits). A film without an accumulator for each
    of settings.extra_aovs raises ValueError."""
    if settings.extra_aovs and len(film.extra) != len(settings.extra_aovs):
        raise ValueError(
            "film was created without the configured extra AOVs: build it "
            "with film.new_film(n_pixels, device, settings)")
    with span("rayn.pass.rays"):
        ray_idx = ray_indices(pass_start, pass_size, fis_table.device)
        origin, direction, time, pixel, sample_idx, in_range = generate_rays(
            settings, tables, camera, fis_table, ray_idx, t0, t1,
            sample_base)
        hps_abs0, hps_lin0 = camera.half_pixel_size_coeffs()
        state = init_state(origin, direction, time, pixel, sample_idx,
                           in_range)
    with span("rayn.pass.trace"):
        state, aovs = trace(data, static, settings, tables, state, hps_abs0,
                            hps_lin0)
    with span("rayn.pass.splat"):
        return film_mod.splat(
            film, pass_start, color=state.color_out, alpha=state.alpha_out,
            background=state.bg_out, normal=state.normal_out,
            count=in_range.to(torch.float32), spp=settings.spp, extra=aovs)


def render_passes(film: film_mod.Film, data: SceneData, static: SceneStatic,
                  settings: RenderSettings, tables: SampleTables,
                  camera: Camera, fis_table: torch.Tensor, pass_start: int,
                  pass_size: int, n_passes: int, t0: float, t1: float,
                  sample_base: int = 0) -> film_mod.Film:
    """Render `n_passes` consecutive passes of `pass_size` rays from ray
    `pass_start` (rayn_tpu/render/renderer.py:148-177). The port's passes
    are eager, so this is render_pass n_passes times, the same bits; the
    JAX package's one fori_loop dispatch has no counterpart here."""
    for i in range(n_passes):
        film = render_pass(film, data, static, settings, tables, camera,
                           fis_table, pass_start + i * pass_size, pass_size,
                           t0, t1, sample_base)
    return film


def seg_passes(settings: RenderSettings, spp_seg: int,
               ranks: int = 1) -> tuple[int, int]:
    """(pass_size, n_passes) of a [*, * + spp_seg) sample segment over
    `ranks` ranks: each rank takes up to rays_per_pass rays a pass
    (rayn_tpu/render/renderer.py:266-275)."""
    w, h = settings.resolution
    seg_total = w * h * spp_seg
    per_rank = min(settings.rays_per_pass, -(-seg_total // ranks))
    return per_rank * ranks, -(-seg_total // (per_rank * ranks))


def checkpoint_key(data: SceneData, static: SceneStatic,
                   settings: RenderSettings, camera: Camera, frame: int,
                   time_range: tuple[float, float],
                   filter: filter_ops.Filter, ranks: int = 1) -> dict:
    """What a frame's checkpoint is fingerprinted by (render/
    checkpoint.py), the filter as its table on the scene's device. Its
    passes count in `seg_passes` units, which depend on the rank count
    above 1, so such a checkpoint names its ranks too."""
    fis_table = filter_ops.build_fis_table(
        filter, settings.filter_table_size, device=data.device)
    scene = (data, static.mat_param_fns)
    if ranks > 1:
        scene += (f"{ranks} ranks",)
    return dict(settings=settings, frame=frame, scene=scene, camera=camera,
                fis_table=fis_table, time_range=time_range)


# Test-only fault injection point: called with the pass index after every
# completed pass (tests/test_torch_checkpoint.py uses it to kill a render
# mid-frame and exercise render_frame_resilient's checkpoint resume).
_FAIL_HOOK = None

# Errors worth retrying: device and runtime failures (torch raises CUDA
# errors as RuntimeError) and host I/O hiccups. Programming errors
# (ValueError, TypeError) and NotImplementedError, a RuntimeError that
# names a setting the port lacks, are deterministic and re-raise at once.
_TRANSIENT_ERRORS = (RuntimeError, OSError)


def render_frame_resilient(data: SceneData, static: SceneStatic,
                           settings: RenderSettings, camera: Camera,
                           retries: int = 2, **kwargs) -> film_mod.Film:
    """render_frame with failure detection and elastic resume: a failed
    attempt is retried up to `retries` times (transient runtime and I/O
    errors only); with a checkpoint_path each retry resumes at the last
    saved pass instead of ray 0, so a crashed render loses at most
    `checkpoint_every` passes of work (rayn_tpu/render/renderer.py:
    182-216). With `mesh=`, every rank raises a failure of any rank at
    the same collective (parallel/sharding.py), so the ranks retry
    together, each from rank 0's checkpoint; an error that no retry
    mends (sharding.PassAborted) is raised on every rank at once."""
    for attempt in range(retries + 1):
        try:
            return render_frame(data, static, settings, camera, **kwargs)
        except NotImplementedError:
            raise
        except _TRANSIENT_ERRORS as e:
            if attempt == retries:
                raise
            where = ("resuming from checkpoint"
                     if kwargs.get("checkpoint_path")
                     else "restarting the frame")
            print(f"render attempt {attempt + 1} failed ({e!r}); {where}",
                  file=sys.stderr)


def render_frame(data: SceneData, static: SceneStatic,
                 settings: RenderSettings, camera: Camera,
                 frame: int = 1, time_range: tuple[float, float] = None,
                 filter: Optional[filter_ops.Filter] = None,
                 frame_rate: float = 24.0, shutter_speed: float = 1.0 / 24.0,
                 checkpoint_path: Optional[str] = None,
                 checkpoint_every: int = 4,
                 progress: Optional[callable] = None,
                 sync_every: int = 8,
                 passes_per_dispatch: int = 1,
                 mesh=None) -> film_mod.Film:
    """Render a full frame on the scene's device, in passes of
    `settings.rays_per_pass` rays. Frame f covers [f/frame_rate,
    f/frame_rate + shutter_speed) (reference src/main.rs:47-62); the
    pixel filter is `filter`, Blackman-Harris of radius 1.5 when None
    (src/main.rs:51).

    With checkpoint_path set, the film is saved every `checkpoint_every`
    passes and at the end, and a render that stopped resumes where it
    stopped. Re-run with a higher settings.spp against a checkpoint, it
    renders only the missing sample indices [spp_done, spp) of every
    pixel and adds them to the saved film; a checkpoint that already
    holds spp samples is returned as it is. `progress(done, total)` is
    called with ray counts after every pass (the reference's progress
    bar, src/film.rs:636); it reads nothing from the device. Follows
    rayn_tpu/render/renderer.py:219-397.

    Passes go out in groups of up to `passes_per_dispatch`
    (render_passes), a group clamped to checkpoint boundaries; the mesh
    path stays one pass a group. After each group a probe (a CUDA event
    on the film's card) is recorded, and once `sync_every` passes are in
    flight the host waits on the oldest probe, not on the newest pass: at
    most that many passes are queued ahead of the host. Each group's
    passes are the same eager passes, so every setting of the two gives
    the default's film bit for bit. `_FAIL_HOOK` and `progress` run once
    a pass.

    With `mesh` (parallel.sharding.make_mesh()), every rank of the mesh
    calls render_frame with the same arguments, renders its slice of each
    pass, and gets the same merged film (parallel.sharding.
    render_pass_sharded); rank 0 alone saves checkpoints, a resume loads
    the same file on every rank, and `progress` runs on every rank with
    the same counts. A failed pass or checkpoint on any rank raises on
    every rank at the same collective (sharding.PassFailed or
    PassAborted). A mesh on another device than the scene's raises
    ValueError, anything but a Mesh TypeError."""
    ranks = 1
    if mesh is not None:
        from rayn_tpu_torch.parallel import sharding
        sharding.check_mesh(mesh, data)
        ranks = mesh.size
    w, h = settings.resolution
    if time_range is None:
        start = frame / frame_rate
        time_range = (start, start + shutter_speed)
    with span("rayn.frame.setup"):
        tables = rng.build_sample_tables(settings, frame)
        ck_key = checkpoint_key(data, static, settings, camera, frame,
                                time_range,
                                filter or filter_ops.blackman_harris(1.5),
                                ranks)
        fis_table = ck_key["fis_table"]

        # Segment plan: (spp_base, spp_target, start_pass). A fresh render
        # is one segment [0, spp); a resumed one first finishes the
        # checkpoint's segment, then (if spp grew) adds the segment
        # [ckpt_spp, spp).
        film = film_mod.new_film(w * h, data.device, settings)
        segments = [(0, settings.spp, 0)]
        if checkpoint_path:
            prog = ckpt.load_progress(checkpoint_path, **ck_key,
                                      device=data.device)
            if prog is not None:
                film, segments = prog.film, []
                if prog.next_pass < seg_passes(settings, prog.spp
                                               - prog.spp_base, ranks)[1]:
                    segments.append((prog.spp_base, prog.spp,
                                     prog.next_pass))
                if prog.spp < settings.spp:
                    segments.append((prog.spp, settings.spp, 0))

    grand_total = w * h * max(settings.spp,
                              segments[-1][1] if segments else 0)
    if segments:
        sb0, st0, p00 = segments[0]
        done = w * h * sb0 + min(
            p00 * seg_passes(settings, st0 - sb0, ranks)[0],
            w * h * (st0 - sb0))
    else:
        done = grand_total
    sync_every = max(1, sync_every)
    group_max = max(1, passes_per_dispatch) if mesh is None else 1
    probes = collections.deque()   # (passes, event) of groups in flight
    for sb, st, start_pass in segments:
        seg_settings = dataclasses.replace(settings, spp=st - sb)
        pass_size, n_passes = seg_passes(settings, st - sb, ranks)
        p = start_pass
        while p < n_passes:
            group = min(group_max, n_passes - p)
            if checkpoint_path:
                group = min(group, checkpoint_every - p % checkpoint_every)
            for q in range(p, p + group):
                with span("rayn.pass"):
                    if mesh is None:
                        film = render_pass(film, data, static, seg_settings,
                                           tables, camera, fis_table,
                                           q * pass_size, pass_size,
                                           time_range[0], time_range[1],
                                           sample_base=sb)
                        if _FAIL_HOOK is not None:
                            _FAIL_HOOK(q)
                    else:
                        # the hook runs in the pass body: a rank it fails
                        # still enters the pass's all_reduce, and every
                        # rank raises
                        film = sharding.render_pass_sharded(
                            mesh, film, data, static, seg_settings, tables,
                            camera, fis_table, q * pass_size,
                            pass_size // ranks, time_range[0],
                            time_range[1], sample_base=sb,
                            after=None if _FAIL_HOOK is None
                            else (lambda q=q: _FAIL_HOOK(q)))
                done = min(done + pass_size, grand_total)
                if progress is not None:
                    progress(done, grand_total)
            p += group
            want_ckpt = checkpoint_path and (p % checkpoint_every == 0
                                             or p == n_passes)
            probes.append((group, _probe(film)))
            if want_ckpt or p == n_passes:
                waits = len(probes)   # a save reads the finished film
            else:
                waits = int(sum(g for g, _e in probes) >= sync_every)
            for _ in range(waits):
                _g, event = probes.popleft()
                if event is not None:
                    with span("rayn.pass.wait"):
                        event.synchronize()
            if want_ckpt:
                with span("rayn.frame.checkpoint"):
                    err = None
                    try:
                        if mesh is None or mesh.rank == 0:
                            ckpt.save(checkpoint_path, film, next_pass=p,
                                      spp_base=sb, spp=st, **ck_key)
                    except Exception as e:
                        if mesh is None:
                            raise
                        err = e
                    if mesh is not None:
                        # no rank runs ahead of the file it may resume
                        # from, and a failed save fails every rank here
                        sharding.agree(mesh, err, f"the checkpoint after "
                                                  f"pass {p - 1}")
    return film


def _probe(film: film_mod.Film):
    """A CUDA event recorded after the film's last pass on its card's
    current stream (None on the CPU, where every pass has ended)."""
    dev = film.samples.device
    if dev.type != "cuda":
        return None
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(dev))
    return event
