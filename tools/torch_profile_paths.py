#!/usr/bin/env python3
"""Profile 2^20-ray passes of the port's render paths on one NVIDIA GPU.

    python3 tools/torch_profile_paths.py [--root DIR] [--paths P,...]
                                         [--rounds R] [--label NAME]
                                         [--json PATH]

Imports rayn_tpu_torch from --root (default: this checkout), so that two
trees can be compared in turns from separate processes in one call on
one card (parent, change, change, parent), builds its kernels, and for
each path (fused, relaxed, unfused, sorted: chip_smoke.py phase 4's
workload, the 1080p default scene at 2^20 rays per pass, max_marches 256,
max_vis_marches 100, as phase 7 runs them; fused-nosort,
fused-nosort-intersect and fused-nosort-shadow: the fused pass with
`sorted_intersect` and `sorted_shadow_march`, the first or the second
off; animated-geo and animated: the fused pass on
`default_scene(animated_geo=True)`, its lights and emissive spheres on
8-knot channels, and on `default_scene(animated=True)`, its camera on a
64-knot orbit, both with rays over [0, 2] s, as chip_smoke.py phase 13
renders them; spheres: the fused pass on `presets.spheres_scene`, which
has no SDF; program: the fused pass on chip_smoke.program_scene, the
default scene with a second, program SDF instance) calls
chip_smoke.profile_pass: five unprofiled passes
timed on the host clock up to `torch.cuda.synchronize()`, then one pass
under torch.profiler for the device busy time, the idle share of the
median unprofiled wall, the launch count, the device time by kernel and
the peak device memory. With --rounds R the paths' unprofiled walls
are then taken in turns, R rounds, the order reversed every other
round. With --film PATH it also renders each path's whole frame
(`render_frame`, phase 4's 1080p, 4 spp) and saves the films there; with
--film-ref PATH it renders them and prints whether each film equals the
one of its path saved there bit for bit (a parent's, to show that a
change leaves the scenes' images as they were). Prints the card's name
and power limit and one JSON line; exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(HERE),
                    help="checkout whose rayn_tpu_torch is profiled")
    ap.add_argument("--paths", default="fused,relaxed,unfused,sorted")
    ap.add_argument("--rounds", type=int, default=0,
                    help="then time the paths' walls in turns, R rounds")
    ap.add_argument("--label", default="")
    ap.add_argument("--json", default=None)
    ap.add_argument("--film", default=None,
                    help="save each path's 1080p film here")
    ap.add_argument("--film-ref", default=None,
                    help="compare each path's film with the one saved here")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    import torch
    if not torch.cuda.is_available():
        print("torch_profile_paths: no CUDA device", file=sys.stderr)
        return 1
    from rayn_tpu_torch import _build
    from rayn_tpu_torch.config import RenderSettings
    from rayn_tpu_torch.ops import filters
    from rayn_tpu_torch.render import film as film_mod
    from rayn_tpu_torch.render import renderer
    from rayn_tpu_torch.scene import presets
    from rayn_tpu_torch.utils import rng

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    _build.load()
    (w, h), n = smoke.MAIN_RES, smoke.MAIN_PASS
    main_s = RenderSettings(resolution=(w, h), spp=smoke.MAIN_SPP,
                            rays_per_pass=n, max_marches=256,
                            max_vis_marches=100)
    unfused_s = dataclasses.replace(main_s, use_fused_intersect=False,
                                    use_fused_shadows=False)
    # path: (settings, the default scene's animation, the rays' time range)
    frame1 = (1.0 / 24, 2.0 / 24)
    settings = {
        "animated-geo": (main_s, dict(animated_geo=True), smoke.ANIM_TIME),
        "animated": (main_s, dict(animated=True), smoke.ANIM_TIME),
        "fused": main_s,
        "fused-nosort": dataclasses.replace(
            main_s, sorted_intersect=False, sorted_shadow_march=False),
        "fused-nosort-intersect": dataclasses.replace(
            main_s, sorted_intersect=False),
        "fused-nosort-shadow": dataclasses.replace(
            main_s, sorted_shadow_march=False),
        "relaxed": dataclasses.replace(main_s,
                                       march_relaxation=smoke.RELAX),
        "unfused": unfused_s,
        "sorted": dataclasses.replace(unfused_s, march_sort_steps=8,
                                      occl_sort_steps=8),
        "spheres": (main_s, dict(scene="spheres"), frame1),
        "program": (main_s, dict(scene="program"), frame1)}
    settings = {k: v if isinstance(v, tuple) else (v, {}, frame1)
                for k, v in settings.items()}
    scenes = {}
    fis = filters.build_fis_table(filters.blackman_harris(1.5), 512,
                                  device=dev)
    tables = rng.build_sample_tables(main_s, 1)
    film = film_mod.new_film(w * h, device=dev)
    out = {"root": str(Path(args.root).resolve()), "label": args.label,
           "smi": smi, "paths": {}}
    paths = args.paths.split(",")

    def one_pass(path):
        s, anim, (t0, t1) = settings[path]
        key = tuple(sorted(anim.items()))
        if key not in scenes:   # made on first use: a parent tree may
            kind = anim.get("scene")  # have no animated or program scenes
            scenes[key] = (
                presets.spheres_scene((w, h), device=dev)
                if kind == "spheres" else
                smoke.program_scene((w, h), dev) if kind == "program" else
                presets.default_scene(resolution=(w, h), device=dev,
                                      **anim))
        data, static, cam = scenes[key]
        return lambda: renderer.render_pass(film, data, static, s, tables,
                                            cam, fis, 0, n, t0, t1)

    for path in paths:
        out["paths"][path] = smoke.profile_pass(
            one_pass(path), f"{args.label} {path}".strip())
    walls = {path: [] for path in paths}
    for r in range(args.rounds):
        for path in (paths if r % 2 == 0 else paths[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            one_pass(path)()
            torch.cuda.synchronize()
            walls[path].append((time.perf_counter() - t0) * 1e3)
    if args.rounds:
        out["interleaved_walls_ms"] = walls
        print(f"{args.label} interleaved pass walls ms, {args.rounds} "
              f"rounds: {walls}; medians "
              f"{ {p: sorted(w)[len(w) // 2] for p, w in walls.items()} }",
              flush=True)
    if args.film or args.film_ref:
        films = {}
        for path in paths:
            s, anim, t_range = settings[path]
            data, static, cam = scenes[tuple(sorted(anim.items()))]
            fr = renderer.render_frame(data, static, s, cam, frame=1,
                                       time_range=t_range)
            films[path] = {f: getattr(fr, f).cpu()
                           for f in film_mod.CHANNELS}
        if args.film:
            torch.save(films, args.film)
        if args.film_ref:
            ref = torch.load(args.film_ref)
            same = {path: {f: bool(torch.equal(c, ref[path][f]))
                           for f, c in cols.items()}
                    for path, cols in films.items() if path in ref}
            out["film_equal_to_ref"] = same
            print(f"{args.label} films equal to {args.film_ref} bit for "
                  f"bit: {same}", flush=True)
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(out, fh, indent=1)
    print(smi)
    print(json.dumps({k: v for k, v in out.items() if k != "paths"}
                     | {"paths": {p: {k: r[k] for k in (
                         "pass_wall_ms", "busy_ms", "idle_share",
                         "launches", "peak_bytes")}
                         for p, r in out["paths"].items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
