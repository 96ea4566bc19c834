"""Command-line renderer of the PyTorch/CUDA port (port of rayn_tpu.cli;
reference src/main.rs:28-98): build the scene, loop over frames with a
24 fps / (1/24) s-shutter schedule, render, print timing, save PNG
channels. Every option of `python -m rayn_tpu` is here with its default,
plus `--device`; `--no-pallas` sets `use_pallas=False`, the JAX
package's route without its kernels (config.py).

    python -m rayn_tpu_torch --scene fractal --width 1280 --height 720 \
        --spp 8 --frames 1 2 --out renders

Scale-out runs one process per card (rayn_tpu_torch/parallel):
`--num-processes N --process-id i --coordinator host:port` starts
process i of a frame farm, each process rendering and saving its
round-robin share; `--multichip` renders on the group that torchrun
started (`torchrun --nproc-per-node N -m rayn_tpu_torch --multichip
...`; without torchrun, one rank), each frame's passes over the ranks
(`--multichip-mode rays`) or whole frames one per rank (`frames`;
`auto` takes frames for two frames or more), and rank 0 alone prints
progress and saves the PNGs.
"""

from __future__ import annotations

import argparse
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="rayn_tpu_torch", description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--device", default="cuda",
                   help="torch device to render on (default: the CUDA "
                        "card; with no card the run fails unless this is "
                        "cpu)")
    p.add_argument("--scene", choices=("fractal", "spheres"),
                   default="fractal")
    p.add_argument("--width", type=int, default=1280)
    p.add_argument("--height", type=int, default=720)
    p.add_argument("--spp", type=int, default=8,
                   help="effective samples per pixel (reference default: "
                        "SAMPLES=2 x 4 lanes = 8)")
    p.add_argument("--bounces", type=int, default=3)
    p.add_argument("--volume-marches", type=int, default=2)
    p.add_argument("--no-volume", action="store_true")
    p.add_argument("--animated", action="store_true",
                   help="animate the camera over the shutter interval")
    p.add_argument("--frames", type=int, nargs=2, default=(1, 2),
                   metavar=("START", "END"),
                   help="frame range [start, end) (reference: 1..2)")
    p.add_argument("--frame-rate", type=float, default=24.0)
    p.add_argument("--shutter", type=float, default=1.0 / 24.0)
    p.add_argument("--filter", default="blackman_harris",
                   choices=("blackman_harris", "mitchell_netravali", "box",
                            "lanczos_sinc"))
    p.add_argument("--filter-radius", type=float, default=1.5)
    p.add_argument("--sampler", choices=("rd", "hash"), default="rd")
    p.add_argument("--out", default="renders")
    p.add_argument("--channels", nargs="+",
                   default=("alpha", "normal", "color"),
                   choices=("color", "alpha", "normal", "background"))
    p.add_argument("--aov", action="append", default=[],
                   choices=("depth", "position", "albedo", "mat_id"),
                   help="extra AOV channels (render/aovs.py registry), "
                        "saved as {base}_{aov}.png")
    p.add_argument("--transparent-background", action="store_true")
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint file for preemptible rendering")
    p.add_argument("--retries", type=int, default=0,
                   help="retry a failed frame this many times; with "
                        "--checkpoint each retry resumes at the last "
                        "saved pass")
    p.add_argument("--rays-per-pass", type=int, default=1 << 20)
    p.add_argument("--max-marches", type=int, default=256)
    p.add_argument("--no-pallas", action="store_true",
                   help="march the closest hits in torch, without the "
                        "fused intersect kernel (use_pallas=False)")
    p.add_argument("--trace-dir", default=None,
                   help="write a torch.profiler trace (trace.json) here")
    p.add_argument("--multichip", action="store_true",
                   help="render on the ranks of the torchrun group, one "
                        "card each (without torchrun: one rank)")
    p.add_argument("--multichip-mode", choices=("auto", "rays", "frames"),
                   default="auto", help="with --multichip only")
    p.add_argument("--coordinator", default=None,
                   help="frame-farm coordinator address (host:port), with "
                        "--num-processes only")
    p.add_argument("--num-processes", type=int, default=None,
                   help="frame-farm process count (one process per "
                        "card)")
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--mis", action="store_true",
                   help="MIS-weight paired light/emissive emitters "
                        "(removes the reference's co-located double "
                        "count; default off = reference-faithful)")
    p.add_argument("--relax", type=float, default=1.0,
                   help="sphere-trace over-relaxation factor")
    # --- camera (reference offers these in code, src/camera.rs:120-285) ---
    p.add_argument("--camera", choices=("pinhole", "thinlens", "ortho"),
                   default="pinhole")
    p.add_argument("--fov", type=float, default=60.0,
                   help="vertical field of view in degrees (pinhole/"
                        "thinlens; reference default 60)")
    p.add_argument("--aperture", type=float, default=0.05,
                   help="thin-lens aperture radius (depth of field)")
    p.add_argument("--focus", type=float, nargs=3, default=None,
                   metavar=("X", "Y", "Z"),
                   help="thin-lens focus point (default: the look-at "
                        "point)")
    p.add_argument("--ortho-height", type=float, default=4.0,
                   help="orthographic view height in world units")
    p.add_argument("--animated-geo", action="store_true",
                   help="fractal scene with orbiting sphere lights")
    p.add_argument("--no-shadow-bv-clip", action="store_true",
                   help="disable the bounding-sphere clip of SDF shadow "
                        "segments")
    p.add_argument("--shadow-de-iterations", type=int, default=0,
                   help="truncated-iteration DE for shadow marches "
                        "(0 = full; measured fidelity-NEGATIVE for the "
                        "MandelBox, BASELINE.md)")
    p.add_argument("--no-chained-shadow", action="store_true",
                   help="the JAX package's per-segment shadow loops; "
                        "here it only picks which JAX march's verdicts "
                        "the port follows (the same image unless "
                        "max_vis_marches is 0)")
    p.add_argument("--no-sorted-shadow", action="store_true",
                   help="skip the cost-sorted chunk schedule of the shadow "
                        "kernels (the same image either way)")
    p.add_argument("--advance-group", type=int, default=None,
                   help="the TPU chained march's advance grouping; the "
                        "port has no such march and ignores it")
    return p


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.advance_group is not None:
        print("--advance-group sizes the TPU's chained shadow march, which "
              "rayn_tpu_torch does not have: ignored", file=sys.stderr)

    import torch
    import torch.distributed as dist

    from rayn_tpu_torch.parallel import distributed

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("rayn_tpu_torch: no CUDA device; pass --device "
                           "cpu to render on the CPU")
    farm = bool(args.num_processes and args.num_processes > 1)
    if farm and (args.coordinator is None or args.process_id is None):
        parser.error("--num-processes > 1 needs --coordinator and "
                     "--process-id")
    # before any tensor is made: init binds the rank to its card
    started = False
    if farm:
        started = distributed.init(coordinator_address=args.coordinator,
                                   num_processes=args.num_processes,
                                   process_id=args.process_id, device=dev)
    elif args.multichip:
        started = distributed.init(device=dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    try:
        return _render(args, dev, farm)
    finally:
        if started:
            dist.destroy_process_group()


def _render(args, dev, farm: bool) -> int:
    """Build the scene on `dev`, render the frames and save them."""
    import contextlib

    import torch

    from rayn_tpu_torch.config import RenderSettings
    from rayn_tpu_torch.ops import filters as filter_ops
    from rayn_tpu_torch.parallel import distributed, sharding
    from rayn_tpu_torch.render import film as film_mod
    from rayn_tpu_torch.render import renderer
    from rayn_tpu_torch.render.camera import (OrthographicCamera,
                                              PinholeCamera, ThinLensCamera)
    from rayn_tpu_torch.scene import presets
    from rayn_tpu_torch.utils.profiling import device_trace

    res = (args.width, args.height)
    settings = RenderSettings(
        resolution=res, spp=args.spp, max_bounces=args.bounces,
        volume_marches=args.volume_marches, sampler=args.sampler,
        rays_per_pass=args.rays_per_pass, max_marches=args.max_marches,
        use_pallas=not args.no_pallas, mis=args.mis,
        march_relaxation=args.relax,
        shadow_bv_clip=not args.no_shadow_bv_clip,
        shadow_de_iterations=args.shadow_de_iterations,
        chained_shadow_march=not args.no_chained_shadow,
        sorted_shadow_march=not args.no_sorted_shadow,
        extra_aovs=tuple(args.aov))

    if args.scene == "fractal":
        data, static, camera = presets.default_scene(
            resolution=res, volume=not args.no_volume,
            animated=args.animated, animated_geo=args.animated_geo,
            device=dev)
    else:
        data, static, camera = presets.spheres_scene(resolution=res,
                                                     device=dev)

    # Rebuild the camera kind around the preset's (possibly animated)
    # origin, look-at and up channels.
    if args.camera == "thinlens":
        focus = tuple(args.focus) if args.focus else camera.at
        camera = ThinLensCamera.make(res, args.fov, args.aperture,
                                     camera.origin, camera.at, camera.up,
                                     focus, device=dev)
    elif args.camera == "ortho":
        camera = OrthographicCamera.make(res, args.ortho_height,
                                         camera.origin, camera.at, camera.up,
                                         device=dev)
    elif args.fov != 60.0:
        camera = PinholeCamera.make(res, args.fov, camera.origin, camera.at,
                                    camera.up, device=dev)

    filt = filter_ops.FILTERS[args.filter](args.filter_radius)

    def progress(done, total):
        pct = 100.0 * done / total
        print(f"\r  {done}/{total} rays ({pct:5.1f}%)", end="",
              flush=True, file=sys.stderr)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def save_frame(frame, film, secs):
        n_samples = res[0] * res[1] * args.spp
        print(f"\nFrame {frame}: done in {secs:.2f}s "
              f"({n_samples / secs / 1e6:.3f} Msamples/s)",
              file=sys.stderr)
        paths = film_mod.save_channels(
            film_mod.resolve(film, res, settings), args.out,
            f"frame{frame:04d}_{args.spp}spp",
            tuple(args.channels) + tuple(args.aov),
            transparent_background=args.transparent_background)
        for p in paths:
            print(f"Saved {p}", file=sys.stderr)

    frame_list = list(range(args.frames[0], args.frames[1]))
    trace_cm = (device_trace(args.trace_dir) if args.trace_dir
                else contextlib.nullcontext())
    with trace_cm:
        if farm:
            # the frame farm: this process's round-robin share, saved here
            start = time.perf_counter()
            out = distributed.render_frames_multiprocess(
                data, static, settings, camera, frame_list,
                per_chip=args.multichip, filter=filt,
                frame_rate=args.frame_rate, shutter_speed=args.shutter)
            sync()
            secs = time.perf_counter() - start
            for frame, film in out:
                save_frame(frame, film, secs / max(1, len(out)))
            return 0
        mesh = sharding.make_mesh(device=dev) if args.multichip else None
        lead = mesh is None or mesh.rank == 0
        if args.multichip and (
                args.multichip_mode == "frames"
                or (args.multichip_mode == "auto" and len(frame_list) >= 2)):
            start = time.perf_counter()
            films = sharding.render_frames_per_chip(
                data, static, settings, camera, frame_list, mesh=mesh,
                filter=filt, frame_rate=args.frame_rate,
                shutter_speed=args.shutter, retries=args.retries)
            sync()
            secs = time.perf_counter() - start
            if lead:
                for frame, film in zip(frame_list, films):
                    save_frame(frame, film, secs / len(frame_list))
            return 0
        for frame in frame_list:
            start = time.perf_counter()
            t0 = frame / args.frame_rate
            if mesh is not None:
                film = sharding.render_frame_sharded(
                    data, static, settings, camera, frame=frame, mesh=mesh,
                    time_range=(t0, t0 + args.shutter), filter=filt,
                    progress=progress if lead else None)
            else:
                film = renderer.render_frame_resilient(
                    data, static, settings, camera, frame=frame,
                    retries=args.retries,
                    time_range=(t0, t0 + args.shutter), filter=filt,
                    checkpoint_path=args.checkpoint, progress=progress)
            sync()
            if lead:
                save_frame(frame, film, time.perf_counter() - start)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
