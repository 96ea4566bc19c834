"""Frame renderer: ray generation -> wavefront trace -> film splat (port
of rayn_tpu.render.renderer: ray_indices, generate_rays, render_pass,
render_frame; reference src/film.rs:380-628).

The frame's (pixel, sample) grid is flattened into one ray index space
and rendered in passes of `rays_per_pass` rays with a plain loop; the
last pass may run past the end of the frame, and its extra lanes start
dead and splat nothing. Checkpoints and multi-device meshes are not
ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

from rayn_tpu_torch.config import RenderSettings, unsupported_reason
from rayn_tpu_torch.ops import filters as filter_ops
from rayn_tpu_torch.render import film as film_mod
from rayn_tpu_torch.render.camera import Camera
from rayn_tpu_torch.render.integrator import init_state, trace
from rayn_tpu_torch.scene.scene import SceneData, SceneStatic
from rayn_tpu_torch.utils import rng
from rayn_tpu_torch.utils.rng import SampleTables
from rayn_tpu_torch.utils.vecmath import div


def ray_indices(pass_start: int, pass_size: int, device):
    """Flat ray ids of one pass, made on the device."""
    return pass_start + torch.arange(pass_size, dtype=torch.int64,
                                     device=device)


def generate_rays(settings: RenderSettings, tables: SampleTables,
                  camera: Camera, fis_table: torch.Tensor,
                  ray_idx: torch.Tensor, t0: float, t1: float):
    """Camera rays for flat ray indices (pixel-major, spp-minor): FIS
    pixel offsets, NDC, shutter-time jitter, lens samples (reference
    src/film.rs:456-527). Returns (origin, direction, time, pixel,
    sample_idx, in_range)."""
    w, h = settings.resolution
    total = w * h * settings.spp
    in_range = ray_idx < total
    safe_idx = torch.clamp(ray_idx, max=total - 1)
    pixel = (safe_idx // settings.spp).to(torch.int32)
    sample_idx = (safe_idx % settings.spp).to(torch.int32)
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
                t1: float) -> film_mod.Film:
    """Render rays [pass_start, pass_start + pass_size) into the film."""
    if pass_size % settings.spp:
        raise NotImplementedError(
            "pass sizes that are not a multiple of spp need the scatter "
            "splat, which is not ported yet")
    ray_idx = ray_indices(pass_start, pass_size, fis_table.device)
    origin, direction, time, pixel, sample_idx, in_range = generate_rays(
        settings, tables, camera, fis_table, ray_idx, t0, t1)
    hps_abs0, hps_lin0 = camera.half_pixel_size_coeffs()
    state = init_state(origin, direction, time, pixel, sample_idx, in_range)
    state = trace(data, static, settings, tables, state, hps_abs0, hps_lin0)
    return film_mod.splat_aligned(
        film, pass_start // settings.spp, color=state.color_out,
        alpha=state.alpha_out, background=state.bg_out,
        normal=state.normal_out, count=in_range.to(torch.float32),
        spp=settings.spp)


def check_supported(data: SceneData, static: SceneStatic,
                    settings: RenderSettings, camera) -> None:
    """Raise NotImplementedError naming the first setting or scene
    feature this port does not implement yet. Every camera class and
    animated light, sphere and camera channels are ported."""
    reason = unsupported_reason(settings)
    if reason is not None:
        raise NotImplementedError(f"rayn_tpu_torch does not implement "
                                  f"{reason} yet")


def render_frame(data: SceneData, static: SceneStatic,
                 settings: RenderSettings, camera: Camera,
                 frame: int = 1, time_range: tuple[float, float] = None,
                 frame_rate: float = 24.0, shutter_speed: float = 1.0 / 24.0,
                 checkpoint_path: Optional[str] = None,
                 mesh=None) -> film_mod.Film:
    """Render a full frame on the scene's device, in passes of
    `settings.rays_per_pass` rays. Frame f covers [f/frame_rate,
    f/frame_rate + shutter_speed) (reference src/main.rs:47-62), filtered
    by the Blackman-Harris filter of radius 1.5 (src/main.rs:51)."""
    if checkpoint_path is not None:
        raise NotImplementedError(
            "rayn_tpu_torch does not implement checkpoint_path yet")
    if mesh is not None:
        raise NotImplementedError("rayn_tpu_torch does not implement mesh "
                                  "(multi-device) rendering yet")
    check_supported(data, static, settings, camera)
    w, h = settings.resolution
    if time_range is None:
        start = frame / frame_rate
        time_range = (start, start + shutter_speed)
    tables = rng.build_sample_tables(settings, frame)
    fis_table = filter_ops.build_fis_table(
        filter_ops.blackman_harris(1.5),
        settings.filter_table_size, device=data.device)
    total = w * h * settings.spp
    pass_size = min(settings.rays_per_pass, total)
    n_passes = -(-total // pass_size)
    film = film_mod.new_film(w * h, device=data.device)
    for p in range(n_passes):
        film = render_pass(film, data, static, settings, tables, camera,
                           fis_table, p * pass_size, pass_size,
                           time_range[0], time_range[1])
    return film
