#!/usr/bin/env python3
"""Time a refill-march kernel at each persistent grid size, on one
NVIDIA GPU.

    python3 tools/torch_probe_hit_grid.py [--kernel hit|march]
                                          [--blocks 0,12,8,6,5,4,3]
                                          [--parent DIR]

For each value k of --blocks, builds the port's kernels with
`-DRAYN_HIT_BLOCKS_PER_SM=k` (--kernel hit, the closest hit of
csrc/intersect.cu) or `-DRAYN_MARCH_BLOCKS_PER_SM=k` (--kernel march,
the closest-hit march of csrc/march.cu; 0: as many blocks as fit) into
build/probe/<kernel><k>/ and, in a process of its own, renders one
2^20-ray pass of the 1080p default scene at 4 spp (chip_smoke.py phase
4's workload: max_marches 256, max_vis_marches 100), capturing the
kernel's inputs at depths 0-3: the closest hit's on the fused path, the
march's on the relaxed path (relax 1.5) and on the relax-1 unfused
path. Then it times the kernel on each with CUDA events (10 launches
after one warm-up) and reads its warps' loop steps. With --parent DIR
the same for the port at DIR (its own kernels, no step count). Prints
one JSON line per build, then the card's name and power limit; exits
non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


# --kernel: the kernel's module and wrapper, its grid macro, and the
# paths (label, RenderSettings overrides) whose inputs it is timed on
KERNELS = {
    "hit": ("intersect_cuda", "closest_hit_shading",
            "RAYN_HIT_BLOCKS_PER_SM", (("fused", {}),)),
    "march": ("march_cuda", "march", "RAYN_MARCH_BLOCKS_PER_SM",
              (("relaxed", dict(march_relaxation=1.5)),
               ("unfused", dict(use_fused_intersect=False,
                                use_fused_shadows=False)))),
}


def measure(root: Path, blocks, kernel_name: str) -> dict:
    """{path depth: {ms, steps}} of the kernel on one pass's inputs."""
    sys.path.insert(0, str(root))
    import dataclasses
    import importlib

    import torch

    from rayn_tpu_torch import _build
    from rayn_tpu_torch.config import RenderSettings
    from rayn_tpu_torch.ops import filters, shade_cuda
    from rayn_tpu_torch.render import integrator, renderer
    from rayn_tpu_torch.scene import presets
    from rayn_tpu_torch.utils import rng

    mod_name, attr, macro, paths = KERNELS[kernel_name]
    mod = importlib.import_module(f"rayn_tpu_torch.ops.{mod_name}")
    if blocks is not None:
        _build.FLAGS = _build.FLAGS + (f"-D{macro}={blocks}",)
    dev = torch.device("cuda", 0)
    (w, h), n = (1920, 1080), 1 << 20
    base = RenderSettings(resolution=(w, h), spp=4, rays_per_pass=n,
                          max_marches=256, max_vis_marches=100)
    data, static, cam = presets.default_scene(resolution=(w, h), device=dev)
    tables = rng.build_sample_tables(base, 1)
    fis = filters.build_fis_table(filters.blackman_harris(1.5), 512,
                                  device=dev)
    o, d, tm, px, si, ok = renderer.generate_rays(
        base, tables, cam, fis, renderer.ray_indices(0, n, dev), 1 / 24,
        2 / 24)
    ha, hl = cam.half_pixel_size_coeffs()
    kernel, captured = getattr(mod, attr), []
    tabs = shade_cuda.scene_tables(data, static)
    for label, overrides in paths:
        s = dataclasses.replace(base, **overrides)
        calls = []

        def record(*a, **kw):
            calls.append((a, kw))
            return kernel(*a, **kw)

        record.launches = 0
        setattr(mod, attr, record)
        state = integrator.init_state(o, d, tm, px, si, ok)
        for depth in range(s.max_bounces + 1):
            state = integrator.bounce(data, static, s, tables, state, depth,
                                      ha, hl, scene_tables=tabs)
        setattr(mod, attr, kernel)
        captured += [(f"{label} {i}", a, kw) for i, (a, kw) in
                     enumerate(calls)]
        del state, calls
    out = {}
    for key, a, kw in captured:
        steps = torch.zeros((1,), dtype=torch.int64, device=dev)
        count = {} if blocks is None else dict(warp_steps=steps)
        kernel(*a, **kw, **count)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(10):
            kernel(*a, **kw)
        end.record()
        torch.cuda.synchronize()
        out[key] = dict(ms=start.elapsed_time(end) / 10,
                        steps=int(steps[0]) if count else None)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernel", choices=sorted(KERNELS), default="hit")
    ap.add_argument("--blocks", default="0,12,8,6,5,4,3")
    ap.add_argument("--parent", default=None,
                    help="also time the kernel of the port at DIR")
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker is not None:
        root, blocks = args.worker.split(",")
        res = measure(Path(root), None if blocks == "-" else int(blocks),
                      args.kernel)
        print(json.dumps({"kernel": args.kernel, "root": root,
                          "blocks_per_sm": blocks, "depths": res}),
              flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("torch_probe_hit_grid: no CUDA device", file=sys.stderr)
        return 1
    runs = [(str(HERE), k) for k in args.blocks.split(",")]
    if args.parent:
        runs.append((str(Path(args.parent).resolve()), "-"))
    for root, k in runs:
        env = dict(os.environ)
        if k != "-":
            env["RAYN_TORCH_BUILD_DIR"] = str(HERE / "build" / "probe" /
                                              f"{args.kernel}{k}")
        subprocess.run([sys.executable, __file__, "--kernel", args.kernel,
                        "--worker", f"{root},{k}"], env=env, check=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
