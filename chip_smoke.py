#!/usr/bin/env python3
"""Smoke test of rayn_tpu_torch, the PyTorch/CUDA port, on one NVIDIA GPU.

    python3 chip_smoke.py [--json PATH] [--profile]

Phases (any failed gate raises and the script exits non-zero):
1. Device: CUDA must be available; prints the card, the device count and
   `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`.
2. Build: compiles csrc/*.cu with nvcc (-Xptxas -v); prints the build
   seconds and each kernel's registers, spills and shared memory.
3. Kernels against their plain twins: one 2^20-ray pass of the 1920x1080
   default scene runs through the plain twins, which records the real
   inputs of the three kernels (intersect and bounce tail at depths 0
   and 1, sort key at depths 1 and 2); each kernel then runs on those
   inputs beside its twin, gated by the JAX package's fused-vs-unfused
   gates, and both are timed with CUDA events.
4. Main path: render_frame on the default scene at 1920x1080, 4 spp,
   2^20 rays per pass, max_marches 256, max_vis_marches 100 (bench.py's
   headline workload with spp cut from 16 to 4); every kernel must have
   launched; the film must hold w*h*spp samples, finite colour and
   coverage around the image centre.
5. Invariants: sorted and unsorted films equal bit for bit (256x256,
   4 spp); pass sizes 2^16 and 2^15 agree to atol 2e-5.
6. Image gate: 64x64 at 32 spp through the kernels and through the plain
   twins; RMSE <= 1.5x a seed-swap null (plain twins at frame 101) and
   mean relative difference <= 1e-3 (bench.py:117-151).
7. Profile (only with --profile): five unprofiled 2^20-ray passes of the
   phase-4 workload, each timed on the host clock up to
   `torch.cuda.synchronize()`, then one pass under `torch.profiler`. The
   device busy time is the union of the profiled kernels' intervals; the
   idle share is 1 - busy / the median unprofiled pass wall (the
   profiler's own launch tracing inflates the profiled pass's wall, so
   that wall is printed but not used). Also prints the launch count and
   device time by kernel name.

The last three lines of standard output are the kernels' JSON record,
the nvidia-smi line, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import re
import subprocess
import sys
import time


# Workload sizes (module constants so a CPU rehearsal can shrink them).
MAIN_RES, MAIN_SPP, MAIN_PASS = (1920, 1080), 4, 1 << 20
INV_RES, INV_PASSES = (256, 256), (1 << 16, 1 << 15)
IMG_RES, IMG_SPP = (64, 64), 32
DEVICE = "cuda"


def gate(cond, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def log(msg: str) -> None:
    print(msg, flush=True)


def ptxas_report(build_log: str) -> dict:
    """{kernel entry: {registers, spill_stores, spill_loads, smem}} from
    nvcc -Xptxas -v output."""
    out, cur = {}, None
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = m.group(1)
            out[cur] = {}
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[cur]["spill_stores"] = int(m.group(1))
            out[cur]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[cur]["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            out[cur]["smem"] = int(s.group(1)) if s else 0
    return out


def busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def profile_pass(one_pass) -> dict:
    """Phase 7: device busy time and idle share of one main-path pass."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    one_pass()
    torch.cuda.synchronize()
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        one_pass()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        one_pass()
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = busy_us((e.time_range.start, e.time_range.end)
                   for e in kernels) / 1e3
    by_name: dict = {}
    for e in kernels:
        ms, calls = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, calls + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:25]
    launches = sum(1 for e in prof.events() if e.name == "cudaLaunchKernel")
    wall = sorted(walls)[len(walls) // 2]
    log(f"[7 profile] unprofiled pass wall ms {walls}; device busy {busy} "
        f"ms; idle share {1 - busy / wall} of the median wall {wall} ms; "
        f"profiled pass wall {prof_wall} ms; {len(kernels)} kernels, "
        f"{launches} cudaLaunchKernel calls")
    for name, (ms, calls) in top:
        log(f"[7 profile] {ms:9.3f} ms {100 * ms / busy:6.2f}% {calls:6d}x "
            f" {name[:90]}")
    return dict(pass_wall_ms=walls, busy_ms=busy, idle_share=1 - busy / wall,
                profiled_wall_ms=prof_wall, n_kernels=len(kernels),
                launches=launches, top=[(n, ms, c) for n, (ms, c) in top])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", default=None,
                    help="also write every measurement to this file")
    ap.add_argument("--profile", action="store_true",
                    help="also run phase 7, the profiled main-path pass")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    import numpy as np

    from rayn_tpu_torch import _build
    from rayn_tpu_torch.config import RenderSettings
    from rayn_tpu_torch.ops import filters, intersect_cuda, shade_cuda
    from rayn_tpu_torch.render import film as film_mod
    from rayn_tpu_torch.render import renderer
    from rayn_tpu_torch.scene import presets
    from rayn_tpu_torch.utils import rng

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE, 0)
    record: dict = {}

    # ---------------------------------------------------------- 1. device
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"[1 device] {name}; device_count={count}; torch "
        f"{torch.__version__} cuda {torch.version.cuda}")
    log(f"[1 device] nvidia-smi: {smi}")
    record["device"] = dict(name=name, count=count, smi=smi)

    # ----------------------------------------------------------- 2. build
    t0 = time.perf_counter()
    _build.load(verbose=True)
    build_s = time.perf_counter() - t0
    ptx = ptxas_report(_build.build_log)
    log(f"[2 build] {build_s:.1f} s")
    for entry, p in ptx.items():
        log(f"[2 build] {entry}: {p}")
    gate(len(ptx) >= 3, f"ptxas reported {len(ptx)} kernels, expected 3")
    record["build"] = dict(seconds=build_s, ptxas=ptx)

    W, H = MAIN_RES
    main_s = RenderSettings(resolution=(W, H), spp=MAIN_SPP,
                            rays_per_pass=MAIN_PASS, max_marches=256,
                            max_vis_marches=100)
    data, static, cam = presets.default_scene(resolution=(W, H),
                                              device=dev)

    # ------------------------------------ 3. kernels vs plain twins
    wrappers = {
        "intersect": (intersect_cuda, "closest_hit_shading",
                      intersect_cuda.closest_hit_shading_plain),
        "key": (shade_cuda, "shadow_sort_key",
                shade_cuda.shadow_sort_key_plain),
        "tail": (shade_cuda, "bounce_tail", shade_cuda.bounce_tail_plain),
    }

    @contextlib.contextmanager
    def plain_twins(capture=None):
        """Route the render path's three kernel calls to their plain
        twins (recording the first two calls of each into `capture`)."""
        saved = {k: getattr(mod, attr) for k, (mod, attr, _p)
                 in wrappers.items()}

        def recorder(key, fn):
            def call(*a, **kw):
                if capture is not None and len(capture[key]) < 2:
                    capture[key].append((a, kw))
                return fn(*a, **kw)
            return call

        for key, (mod, attr, plain) in wrappers.items():
            setattr(mod, attr, recorder(key, plain))
        try:
            yield
        finally:
            for key, (mod, attr, _p) in wrappers.items():
                setattr(mod, attr, saved[key])

    kernels = {"intersect": intersect_cuda.closest_hit_shading,
               "key": shade_cuda.shadow_sort_key,
               "tail": shade_cuda.bounce_tail}
    captured = {k: [] for k in wrappers}
    fis = filters.build_fis_table(filters.blackman_harris(1.5), 512,
                                  device=dev)
    tables = rng.build_sample_tables(main_s, 1)
    t0 = time.perf_counter()
    with plain_twins(captured):
        renderer.render_pass(film_mod.new_film(W * H, device=dev), data,
                             static, main_s, tables, cam, fis, 0, MAIN_PASS,
                             1.0 / 24, 2.0 / 24)
    torch.cuda.synchronize()
    log(f"[3 kernels] plain-twin pass of {MAIN_PASS} rays: "
        f"{time.perf_counter() - t0:.1f} s")
    gate(all(len(v) == 2 for v in captured.values()),
         f"captured {[len(v) for v in captured.values()]} calls")

    def timed(fn, a, kw, reps):
        fn(*a, **kw)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn(*a, **kw)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    results = {}
    for key in ("intersect", "key", "tail"):
        errs = []
        for i, (a, kw) in enumerate(captured[key]):
            got = kernels[key](*a, **kw)
            want = wrappers[key][2](*a, **kw)
            torch.cuda.synchronize()
            depth = i + (1 if key == "key" else 0)
            if key == "intersect":
                (gh, gi), (wh, wi) = got, want
                same = (gh.obj == wh.obj) & (gh.valid == wh.valid)
                frac = same.float().mean().item()
                gate(frac >= 0.999, f"intersect depth {depth}: obj/valid "
                     f"agree on {frac:.5f} < 0.999 of lanes")
                ok_t = torch.isclose(gh.t[same], wh.t[same], rtol=1e-4,
                                     atol=1e-5)
                ok_p = torch.isclose(gi.point[same], wi.point[same],
                                     rtol=1e-4, atol=1e-5)
                gate(bool(ok_t.all()) and bool(ok_p.all()),
                     f"intersect depth {depth}: t/point out of tolerance on "
                     f"{int((~ok_t).sum())}/{int((~ok_p).sum())} values")
                err = (gh.t[same] - wh.t[same]).abs().max().item()
                log(f"[3 kernels] intersect depth {depth}: obj/valid agree "
                    f"{frac:.6f}, max |dt| {err:.3g}")
            elif key == "key":
                ok = torch.isclose(got, want, rtol=1e-4, atol=0.0)
                frac = ok.float().mean().item()
                gate(frac >= 0.999, f"sort key depth {depth}: {frac:.5f} "
                     "< 0.999 of lanes within rtol 1e-4")
                err = (got - want).abs().max().item()
                log(f"[3 kernels] sort key depth {depth}: within rtol 1e-4 "
                    f"on {frac:.6f}, max |d| {err:.3g}")
            else:
                rg, rw = got["radiance"], want["radiance"]
                close = torch.isclose(rg, rw, rtol=2e-4, atol=2e-5)
                frac = close.float().mean().item()
                err = (rg - rw).abs().max().item()
                gate(frac >= 0.985 and err < 0.1,
                     f"tail depth {depth}: radiance close on {frac:.5f}, "
                     f"max |d| {err}")
                tfrac = 1.0 - torch.isclose(
                    got["throughput"], want["throughput"], rtol=1e-4,
                    atol=1e-5).float().mean().item()
                gate(tfrac < (1e-3 if depth == 0 else 3e-2),
                     f"tail depth {depth}: throughput diverged on {tfrac}")
                afrac = (got["alive"] != want["alive"]).float().mean().item()
                gate(afrac < (1e-3 if depth == 0 else 1e-2),
                     f"tail depth {depth}: alive differs on {afrac}")
                log(f"[3 kernels] tail depth {depth}: radiance close "
                    f"{frac:.6f}, max |d| {err:.3g}, throughput diverged "
                    f"{tfrac:.2e}, alive differs {afrac:.2e}")
            errs.append(err)
        a, kw = captured[key][1]
        ms = timed(kernels[key], a, kw, reps=5)
        plain_ms = timed(wrappers[key][2], a, kw, reps=1)
        log(f"[3 kernels] {key}: kernel {ms:.3f} ms, plain twin "
            f"{plain_ms:.3f} ms per call at {MAIN_PASS} rays")
        results[key] = dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms)
    del captured
    torch.cuda.empty_cache()

    # -------------------------------------------------------- 4. main path
    for fn in kernels.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    f = renderer.render_frame(data, static, main_s, cam, frame=1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in kernels.items()}
    peak = torch.cuda.max_memory_allocated(dev)
    n_samples = W * H * main_s.spp
    log(f"[4 main] {W}x{H} @ {main_s.spp} spp: {wall:.3f} s wall, "
        f"{n_samples / wall / 1e6:.4f} Msamples/s, peak device memory "
        f"{peak / 2**30:.2f} GiB, launches {launches}")
    gate(all(v > 0 for v in launches.values()), f"launches {launches}")
    gate(int(f.samples.sum().item()) == n_samples, "film sample count")
    img = film_mod.resolve(f, (W, H))
    gate(np.isfinite(img.color).all(), "non-finite colour")
    # the exact centre pixel sees the emissive sphere at the origin,
    # which does not receive light (alpha 0); coverage is checked on the
    # central 5% crop
    ch, cw = max(1, H // 40), max(1, W // 40)
    crop = img.alpha[H // 2 - ch:H // 2 + ch, W // 2 - cw:W // 2 + cw]
    gate(crop.mean() > 0.0, "no coverage around the image centre")
    log(f"[4 main] mean colour {img.color.mean():.6f}, mean alpha "
        f"{img.alpha.mean():.4f}, centre-crop alpha {crop.mean():.4f}")
    record["main"] = dict(seconds=wall, msamples_per_s=n_samples / wall / 1e6,
                          peak_bytes=peak, launches=launches,
                          mean_color=float(img.color.mean()))
    del f, img
    torch.cuda.empty_cache()

    # ------------------------------------------------------ 5. invariants
    res5 = INV_RES
    d5, s5, c5 = presets.default_scene(resolution=res5, device=dev)

    def render5(**kw):
        s = RenderSettings(resolution=res5, spp=4, **kw)
        return renderer.render_frame(d5, s5, s, c5, frame=1)

    a = render5()
    b = render5(sorted_shadow_march=False, sorted_intersect=False)
    gate(all(torch.equal(x, y) for x, y in zip(a, b)),
         "sorted and unsorted films differ")
    p16 = render5(rays_per_pass=INV_PASSES[0])
    p15 = render5(rays_per_pass=INV_PASSES[1])
    diff = max((x - y).abs().max().item() for x, y in zip(p16, p15))
    gate(diff <= 2e-5, f"pass-size films differ by {diff}")
    log(f"[5 invariants] sorted == unsorted bit for bit; 2^16 vs 2^15 "
        f"passes max |d| {diff:.3g}")

    # ------------------------------------------------------ 6. image gate
    res6, spp6 = IMG_RES, IMG_SPP
    d6, s6, c6 = presets.default_scene(resolution=res6, device=dev)
    set6 = RenderSettings(resolution=res6, spp=spp6, max_marches=64,
                          max_vis_marches=64,
                          rays_per_pass=res6[0] * res6[1] * spp6)

    def render6(frame):
        fr = renderer.render_frame(d6, s6, set6, c6, frame=frame)
        return film_mod.resolve(fr, res6).color

    img_k = render6(1)
    with plain_twins():
        img_p = render6(1)
        img_null = render6(101)
    rmse = float(np.sqrt(np.mean((img_k - img_p) ** 2)))
    null = float(np.sqrt(np.mean((img_p - img_null) ** 2)))
    mean_rel = float(abs(img_k.mean() - img_p.mean())
                     / max(img_p.mean(), 1e-9))
    log(f"[6 image] kernels vs plain twins at 64x64 @ 32 spp: RMSE "
        f"{rmse:.3e}, seed-swap null {null:.3e}, mean rel diff "
        f"{mean_rel:.3e}")
    gate(rmse <= 1.5 * null and mean_rel <= 1e-3, "image gate failed")
    record["image"] = dict(rmse=rmse, null_rmse=null, mean_rel=mean_rel)

    # --------------------------------------------- 7. profile (optional)
    if args.profile:
        film7 = film_mod.new_film(W * H, device=dev)
        record["profile"] = profile_pass(lambda: renderer.render_pass(
            film7, data, static, main_s, tables, cam, fis, 0, MAIN_PASS,
            1.0 / 24, 2.0 / 24))

    sources = {"intersect": ("closest_hit_shading",
                             "rayn_tpu_torch/csrc/intersect.cu",
                             "rayn_tpu/ops/intersect_pallas.py:225"),
               "key": ("shadow_sort_key", "rayn_tpu_torch/csrc/shade.cu",
                       "rayn_tpu/ops/shade_pallas.py:1971"),
               "tail": ("bounce_tail", "rayn_tpu_torch/csrc/shade.cu",
                        "rayn_tpu/ops/shade_pallas.py:1711")}
    kern = [dict(name=sources[k][0], route="cuda", source=sources[k][1],
                 replaces=sources[k][2], launches=launches[k],
                 max_abs_err=results[k]["max_abs_err"], ms=results[k]["ms"],
                 plain_ms=results[k]["plain_ms"])
            for k in ("intersect", "key", "tail")]
    record["kernels"] = kern
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(record, fh, indent=1)
    print(json.dumps({"kernels": kern}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
