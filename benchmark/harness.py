"""One run of one cell: set-up, a closed loop of frames for a fixed time,
an optional traced stretch, the check against the plain reference, and
the result line.

Everything that belongs to one cell is data, found by name: the cell in
BENCHMARK.json's `workloads`, its configuration in the file that
BENCHMARK.json's `configs` names, its traffic mix in
benchmark/traffic/<traffic>.json, its check's budget and limits in
benchmark/checks/<cell>.json, and each per-layer metric in
benchmark/metrics/<metric>.py. A run is one process on one card.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

from benchmark import check, program, tracing

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "rayn_tpu")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    check: dict
    end_to_end: list
    per_layer: list
    metric_files: dict


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell `name` of root/BENCHMARK.json with its data files."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    data = root / "benchmark"
    traffic = json.loads((data / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    if int(traffic.get("chips", w["chips"])) != int(w["chips"]):
        raise ValueError(f"{name}: its traffic {w['traffic']} is for "
                         f"{traffic['chips']} chips")
    if int(w["chips"]) != 1:
        raise ValueError(f"{name}: the harness runs one card, not "
                         f"{w['chips']}")
    chk = json.loads((data / "checks" / f"{name}.json").read_text())
    files = {m["name"]: data / "metrics" / f"{m['name']}.py"
             for m in bench["per_layer"]}
    return Cell(name, int(w["chips"]), config, traffic, chk,
                bench["end_to_end"], bench["per_layer"], files)


def load_metric(name: str, path: Path):
    """A per-layer metric's module: UNIT, LAYER, MOVES and read(run)."""
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def first_frame(seed: int) -> int:
    return 1 + 1000 * seed


def cache_env(root: Path) -> dict:
    """Build and kernel caches at fixed paths inside the checkout."""
    cache = root / "build" / "bench_cache"
    return {"RAYN_TORCH_BUILD_DIR": str(root / "build" / "kernels"),
            "TORCH_EXTENSIONS_DIR": str(cache / "torch_extensions"),
            "TRITON_CACHE_DIR": str(cache / "triton"),
            "TORCHINDUCTOR_CACHE_DIR": str(cache / "inductor"),
            "CUDA_CACHE_PATH": str(cache / "cuda")}


# ---- the run ----------------------------------------------------------

def run_frames(cell: Cell, seed: int, seconds: float, trace: bool,
               device: str, t0: float) -> dict:
    """Set up, run the window (and the traced frames), and return what the
    result is made of."""
    import torch

    cuda = device == "cuda"
    dev = (torch.device("cuda", torch.cuda.current_device()) if cuda
           else torch.device("cpu"))
    phases = [("start, import", time.perf_counter() - t0)]
    if cuda:
        from rayn_tpu_torch import _build
        _build.load()
    phases.append(("kernels loaded", time.perf_counter() - t0))
    settings = program.settings_of(cell.config, spp=cell.traffic["spp"])
    r = program.Renderer(cell.config, settings, dev)
    phases.append(("scene built", time.perf_counter() - t0))
    w, h = settings.resolution
    f0 = first_frame(seed)

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    # warm-up: whole frames of the cell's own settings (the first frames
    # after one still run slower), numbered before the window's
    for j in range(int(cell.traffic["warmup_frames"])):
        r.resolve(r.render(f0 - 1 - j))
    sync()
    setup_s = time.perf_counter() - t0
    phases.append(("warm-up frames", setup_s))
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)

    spans = tracing.Spans()
    picks, frames = [], []
    ppf = int(cell.check["pixels_per_frame"])
    t_start = time.perf_counter()
    k = 0
    while k == 0 or time.perf_counter() - t_start < seconds:
        f = f0 + k
        with spans.span("frame", frame=f):
            film = r.render(f)
            with spans.span("resolve", frame=f):
                res = r.resolve(film)
        picks.append(check.take(res, check.frame_pixels(
            seed, f, w * h, ppf)))
        frames.append(f)
        k += 1
    sync()
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0

    traced = None
    if trace:
        from torch.profiler import (ProfilerActivity, profile,
                                    record_function)
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if cuda else [])
        n_tr = int(cell.traffic["trace_frames"])
        with profile(activities=acts) as prof:
            tt0 = time.perf_counter()
            for j in range(n_tr):
                with record_function("render_frame"):
                    film = r.render(f0 + k + j)
                with record_function("resolve"):
                    r.resolve(film)
            sync()
            tt1 = time.perf_counter()
        traced = tracing.reduce_profile(prof)
        del prof
        traced.update(window_s=tt1 - tt0,
                      passes=n_tr * r.passes_per_frame(),
                      samples=n_tr * w * h * settings.spp)
    passes = r.passes_per_frame()
    del r, film
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return dict(setup_s=setup_s, phases=phases, spans=spans.items,
                frames=frames, picks=picks, peak=peak, traced=traced,
                samples_per_frame=w * h * settings.spp,
                passes_per_frame=passes, resolution=(w, h),
                kind=(torch.cuda.get_device_name(dev) if cuda else "cpu"))


# ---- the result -------------------------------------------------------

def end_to_end(rec: dict) -> dict:
    walls = [s["end"] - s["start"] for s in rec["spans"]
             if s["name"] == "frame"]
    frames = [s for s in rec["spans"] if s["name"] == "frame"]
    window = frames[-1]["end"] - frames[0]["start"]
    return dict(
        msamples_per_s=len(frames) * rec["samples_per_frame"] / window / 1e6,
        frame_ms_p90=float(np.percentile(np.asarray(walls) * 1e3, 90)),
        peak_device_gib=rec["peak"] / 2 ** 30,
        setup_s=rec["setup_s"])


def reference_check(cell: Cell, rec: dict, seed: int):
    """(correct, report, info): the reference at the checked pixels."""
    from benchmark.reference.tracer import Tracer

    w, h = rec["resolution"]
    idx, frames, pixels = check.check_set(
        seed, rec["frames"], w * h, int(cell.check["pixels"]),
        int(cell.check["pixels_per_frame"]))
    cfg = dict(cell.config)
    cfg["settings"] = dict(cfg["settings"], spp=cell.traffic["spp"])
    t = time.perf_counter()
    with np.errstate(all="ignore"):
        want = Tracer(cfg).render(frames, pixels)
    ref_s = time.perf_counter() - t
    got = check.concat([rec["picks"][i] for i in idx])
    ok, report = check.judge(check.numbers(got, want), cell.check["limits"])
    return ok, report, dict(pixels=len(pixels), frames=len(idx),
                            reference_s=ref_s)


def forbidden_modules() -> list[str]:
    return sorted(m for m in list(sys.modules)
                  if m.split(".", 1)[0] in FORBIDDEN)


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def run(name: str, seed: int, seconds: float, trace: bool, t0: float,
        root: Path = ROOT, device: str | None = None) -> int:
    """The benchmark's run; prints the result line. `device` None is the
    real run (CUDA); tests pass "cpu"."""
    cell = load_cell(name, root)
    if device is None:
        import torch
        if not torch.cuda.is_available():
            print("run: no CUDA device", file=sys.stderr)
            return 2
        if torch.cuda.device_count() < cell.chips:
            print(f"run: {cell.name} needs {cell.chips} cards, found "
                  f"{torch.cuda.device_count()}", file=sys.stderr)
            return 2
        device = "cuda"
    metrics_mods = {m: load_metric(m, p) for m, p in cell.metric_files.items()}
    for m in cell.per_layer:
        mod = metrics_mods[m["name"]]
        if (mod.UNIT, mod.LAYER, mod.MOVES) != (m["unit"], m["layer"],
                                                m["moves"]):
            raise ValueError(f"metric {m['name']}: its file and "
                             f"BENCHMARK.json disagree")
    rec = run_frames(cell, seed, seconds, trace, device, t0)
    e2e = end_to_end(rec)
    log = sys.stderr
    if device == "cuda":
        print(f"card: {power_limit()}", file=log)
    print("set-up, seconds from the start: " + ", ".join(
        f"{n} {t:.3f}" for n, t in rec["phases"]), file=log)
    walls = np.asarray([s["end"] - s["start"] for s in rec["spans"]
                        if s["name"] == "frame"]) * 1e3
    res_ms = np.asarray([s["end"] - s["start"] for s in rec["spans"]
                         if s["name"] == "resolve"]) * 1e3
    q = np.percentile(walls, [0, 10, 50, 90, 100])
    print("frame walls ms: min/p10/p50/p90/max " + "/".join(
        f"{v:.1f}" for v in q) + "; first " + " ".join(
        f"{v:.1f}" for v in walls[:4]) + "; last " + " ".join(
        f"{v:.1f}" for v in walls[-4:]) + (
        f"; resolve p50 {np.median(res_ms):.1f}" if res_ms.size else ""),
        file=log)
    print(f"{cell.name}: seed {seed}, {len(rec['frames'])} frames from "
          f"{rec['frames'][0]}, {rec['passes_per_frame']} passes a "
          f"frame; "
          + ", ".join(f"{k} {v}" for k, v in e2e.items()), file=log)

    result_metrics = {}
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    if trace:
        run_view = dict(spans=rec["spans"], trace=rec["traced"])
        for m in cell.per_layer:
            v = metrics_mods[m["name"]].read(run_view)
            if v is not None:
                result_metrics[m["name"]] = dict(value=float(v),
                                                 unit=units[m["name"]])
    else:
        for m in cell.end_to_end:
            result_metrics[m["name"]] = dict(value=float(e2e[m["name"]]),
                                             unit=units[m["name"]])
    dev = dict(platform="gpu" if device == "cuda" else "cpu",
               kind=rec["kind"], count=1,
               memory_peak_bytes=int(rec["peak"]))
    out = dict(correct=False, attempted=len(rec["frames"]), failed=0,
               metrics=result_metrics, device=dev)
    if trace:
        tr = rec["traced"]
        dev["busy_s"] = tracing.union_length(
            (s, e) for _n, s, e in tr["device"]) * 1e-6
        dev["window_s"] = float(tr["window_s"])
        out["breakdown"] = tracing.breakdown(tr)

    ok, report, info = reference_check(cell, rec, seed)
    out["correct"] = bool(ok)
    out["check"] = report
    bad = forbidden_modules()
    if bad:
        print(f"run: forbidden modules loaded: {bad}", file=log)
        return 3
    print(f"check: {info['pixels']} pixels of {info['frames']} frames, "
          f"reference {info['reference_s']:.1f} s", file=log)
    for k, v in report.items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r} "
              f"{'ok' if v['value'] <= v['limit'] else 'FAILED'}", file=log)
    log.flush()
    print(json.dumps(out), flush=True)
    return 0
