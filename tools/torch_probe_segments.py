#!/usr/bin/env python3
"""Probe the two segments kernels of csrc/shade.cu on one NVIDIA GPU.

    python3 tools/torch_probe_segments.py [--builds base,noenqueue,...]
                                          [--parent DIR] [--json PATH]

Each build of --builds compiles the port's kernels into a directory of
its own under build/probe/ and, in a process of its own, captures the
inputs of `shade_cuda.shadow_segments` (the fused path, chip_smoke.py
phase 4's workload: the 1080p default scene, one 2^20-ray pass,
max_marches 256, max_vis_marches 100) and of `shade_cuda.queue_segments`
(the same at march_relaxation 1.5) at depths 0 and 1, runs the kernel on
each beside its plain twin and reports:
- the kernel's device time (torch.profiler, the mean of 10 launches,
  the 50 MB L2 cache overwritten before each);
- its registers and spills (`nvcc -Xptxas -v`);
- the active segments out of S*N, from the twin's `active`;
- the atomicAdds on the queue's count: one per 32-ray warp and site with
  an active segment (an append per site), and one per 32 or 64 rays with
  an active segment (the appends of a warp or of two warps aggregated);
- its bytes bound: the ray columns it reads, the segment scratch and the
  queued ids it writes, at 3.35 TB/s;
- whether its scratch equals the twin's (geom, k, active, count; the
  queue as a set).
Builds: `base` (the kernels as they are), `noenqueue` (a copy of csrc/
with the queue appends removed from the segments kernels: the count and
queue stay unwritten, so only geom, k and active are compared),
`minblocks6` and `minblocks8` (a copy of csrc/ whose segments kernels
are declared `__launch_bounds__(kSegThreads, 6)` or 8: a register budget
that lets 6 or 8 blocks of 128 threads share an SM).
With --parent DIR, the builds `base` and `noenqueue` of the port at DIR
as well. Prints one JSON line per build,
then the card's name and power limit; exits non-zero without a CUDA
device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
PEAK_BYTES_PER_S = 3.35e12
# a queue append of a segments kernel: one statement on one line,
# `enqueue(...)` (one a site) or `enqueue_stage(...)` and
# `enqueue_flush(...)` (a warp's ids staged, then appended at once)
APPEND = re.compile(r"^\s*enqueue\w*\(.*\);\s*$", re.M)
# the segments kernels' launch bounds, one thread per ray
BOUNDS = "__launch_bounds__(kSegThreads)"


def patched_csrc(root: Path, out: Path, build: str) -> Path:
    """A copy of root's csrc/ whose segments kernels append nothing to
    the queue (noenqueue) or have a register budget for k blocks an SM
    (minblocks<k>)."""
    dst = out / "csrc"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(root / "rayn_tpu_torch" / "csrc", dst)
    shade = dst / "shade.cu"
    text = shade.read_text()
    if build == "noenqueue":
        text, n = APPEND.subn("", text)
    elif build.startswith("minblocks"):
        blocks = int(build[len("minblocks"):])
        n = text.count(BOUNDS)
        text = text.replace(BOUNDS, BOUNDS[:-1] + f", {blocks})")
    else:
        raise ValueError(f"unknown build {build}")
    if n == 0:
        raise RuntimeError(f"{build}: nothing to patch in {shade}")
    shade.write_text(text)
    return dst


def measure(root: Path, build: str, out_dir: Path) -> dict:
    sys.path.insert(0, str(root))
    import importlib.util

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from rayn_tpu_torch import _build
    from rayn_tpu_torch.config import RenderSettings
    from rayn_tpu_torch.ops import filters, shade_cuda
    from rayn_tpu_torch.render import integrator, renderer
    from rayn_tpu_torch.scene import presets
    from rayn_tpu_torch.utils import rng

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    if build != "base":
        _build.CSRC = patched_csrc(root, out_dir, build)
    _build.load(verbose=True)
    ptx = smoke.ptxas_report(_build.build_log)
    dev = torch.device("cuda", 0)
    (w, h), n = smoke.MAIN_RES, smoke.MAIN_PASS
    base = RenderSettings(resolution=(w, h), spp=smoke.MAIN_SPP,
                          rays_per_pass=n, max_marches=256,
                          max_vis_marches=100)
    data, static, cam = presets.default_scene(resolution=(w, h), device=dev)
    tables = rng.build_sample_tables(base, 1)
    fis = filters.build_fis_table(filters.blackman_harris(1.5), 512,
                                  device=dev)
    o, d, tm, px, si, ok = renderer.generate_rays(
        base, tables, cam, fis, renderer.ray_indices(0, n, dev), 1 / 24,
        2 / 24)
    ha, hl = cam.half_pixel_size_coeffs()
    tabs = shade_cuda.scene_tables(data, static)
    # (label, settings, wrapper name, kernel entry)
    paths = (("fused", base, "shadow_segments", "shadow_segments_kernel"),
             ("relaxed", dataclasses.replace(base, march_relaxation=1.5),
              "queue_segments", "queue_segments_kernel"))
    scrub = torch.empty((64 << 20,), dtype=torch.uint8, device=dev)

    def device_ms(fn, a, entry, reps=10):
        fn(*a)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                scrub.zero_()
                fn(*a)
            torch.cuda.synchronize()
        tags = (f"rayn::{entry}(", f"{len(entry)}{entry}E")
        ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA
              and any(t in e.name for t in tags)]
        if not ev:
            return None
        return sum(e.time_range.elapsed_us() for e in ev) / 1e3 / len(ev)

    def same_bits(got, want):
        if got.dtype == torch.bool:
            return torch.equal(got, want)
        return bool(((got.view(torch.int32) == want.view(torch.int32))
                     | (torch.isnan(got) & torch.isnan(want))).all())

    def read_bytes(a):
        """Bytes of the columns a segments kernel reads once: the ray
        columns, then vol_dist and vol_pdf or t_hit."""
        (_cfg, tb, state, info, mat, live, recv, vtr, *vol) = a
        cols = [info.point, info.normal, info.offset_by, state.origin,
                state.direction, state.throughput, state.sample_idx,
                state.pixel, mat.kind, mat.color_a, mat.power, live, recv,
                vtr, tb.lights, tb.spheres]
        for v in vol:
            cols += list(v) if isinstance(v, (list, tuple)) else [v]
        return sum(t.numel() * t.element_size() for t in cols)

    out = {}
    for label, s, attr, entry in paths:
        kernel, calls = getattr(shade_cuda, attr), []

        def record(*a, **kw):
            calls.append(a)
            return kernel(*a, **kw)

        record.launches = 0
        setattr(shade_cuda, attr, record)
        state = integrator.init_state(o, d, tm, px, si, ok)
        for depth in (0, 1):
            state = integrator.bounce(data, static, s, tables, state, depth,
                                      ha, hl, scene_tables=tabs)
        setattr(shade_cuda, attr, kernel)
        twin = getattr(shade_cuda, attr + "_plain")
        for depth, a in enumerate(calls):
            got, want = kernel(*a), twin(*a)
            torch.cuda.synchronize()
            S, nr = want.active.shape
            act = want.active
            count = int(want.count[0])
            same = all(same_bits(getattr(got, f), getattr(want, f))
                       for f in ("geom", "k", "active"))
            if build != "noenqueue":
                same = same and torch.equal(got.count, want.count) and \
                    torch.equal(got.queue[:count].sort().values,
                                want.queue[:count].sort().values)
            pad = (-nr) % 64
            padded = torch.nn.functional.pad(act, (0, pad))
            written = sum(t.numel() * t.element_size() for t in (
                want.geom, want.k, want.active, want.count)) + 4 * count
            n_bytes = read_bytes(a) + written
            p = ptx.get(next(k for k in ptx if f"{len(entry)}{entry}" in k),
                        {})
            out[f"{label} depth {depth}"] = dict(
                kernel=entry, device_ms=device_ms(kernel, a, entry),
                registers=p.get("registers"),
                spill_stores=p.get("spill_stores"),
                spill_loads=p.get("spill_loads"),
                segments=S * nr, active=int(act.sum()),
                atomics_warp_site=int(
                    padded.reshape(S, -1, 32).any(-1).sum()),
                atomics_rays32=int(
                    padded.reshape(S, -1, 32).any(0).any(-1).sum()),
                atomics_rays64=int(
                    padded.reshape(S, -1, 64).any(0).any(-1).sum()),
                bytes=n_bytes, bound_ms=n_bytes / PEAK_BYTES_PER_S * 1e3,
                equal_to_twin=same)
            del got, want
        del calls, state
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--builds", default="base,noenqueue,minblocks6,"
                                        "minblocks8")
    ap.add_argument("--parent", default=None,
                    help="also probe the builds base and noenqueue of the "
                         "port at DIR")
    ap.add_argument("--json", default=None)
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker is not None:
        root, build, out_dir = args.worker.split(",")
        res = measure(Path(root), build, Path(out_dir))
        print(json.dumps({"root": root, "build": build, "depths": res}),
              flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("torch_probe_segments: no CUDA device", file=sys.stderr)
        return 1
    runs = [("change", HERE, b) for b in args.builds.split(",")]
    if args.parent:
        runs += [("parent", Path(args.parent).resolve(), b)
                 for b in ("base", "noenqueue")]
    lines = []
    for label, root, build in runs:
        out_dir = HERE / "build" / "probe" / f"seg-{label}-{build}"
        out_dir.mkdir(parents=True, exist_ok=True)
        env = dict(os.environ, RAYN_TORCH_BUILD_DIR=str(out_dir / "kernels"))
        res = subprocess.run(
            [sys.executable, __file__, "--worker",
             f"{root},{build},{out_dir}"], env=env, capture_output=True,
            text=True)
        if res.returncode != 0:
            print(res.stdout[-4000:], res.stderr[-8000:], file=sys.stderr)
            raise RuntimeError(f"{label} {build}: worker exited "
                               f"{res.returncode}")
        line = res.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        lines.append(json.loads(line))
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(lines, fh, indent=1)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
