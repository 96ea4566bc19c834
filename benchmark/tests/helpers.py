"""Small cells for the benchmark's CPU tests: a temporary checkout root
holding a BENCHMARK.json and benchmark/ data files, driven through the
harness's own code with the device check skipped."""

from __future__ import annotations

import io
import json
import shutil
import time
from contextlib import redirect_stdout
from pathlib import Path

from benchmark import harness

ROOT = Path(__file__).resolve().parent.parent.parent


def load_json(rel: str) -> dict:
    return json.loads((ROOT / rel).read_text())


def tiny_config(name: str, res=(16, 16), rays_per_pass=512, **settings):
    cfg = load_json(f"benchmark/configs/{name}.json")
    cfg["settings"] = dict(cfg["settings"], resolution=list(res),
                           rays_per_pass=rays_per_pass, **settings)
    return cfg


def make_root(tmp: Path, cells: list[dict], configs: dict, traffic: dict,
              checks: dict) -> Path:
    """A checkout root with only data files beside the repository's code:
    `cells` are BENCHMARK.json workloads, the rest {name: json}."""
    bench = load_json("BENCHMARK.json")
    bench["workloads"] = cells
    bench["configs"] = [dict(name=n, source="test", reduced=[], why="test",
                             file=f"benchmark/configs/{n}.json")
                        for n in configs]
    data = tmp / "benchmark"
    for sub, items in (("configs", configs), ("traffic", traffic),
                       ("checks", checks)):
        (data / sub).mkdir(parents=True, exist_ok=True)
        for n, obj in items.items():
            (data / sub / f"{n}.json").write_text(json.dumps(obj))
    shutil.copytree(ROOT / "benchmark" / "metrics", data / "metrics")
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


def tiny_root(tmp: Path, cell="tiny_cell", config="rtiow_spheres",
              like="spheres_final_8spp", **settings) -> Path:
    """One small cell of the configuration `config`, at the samples per
    pixel of the real cell `like` and judged by its limits."""
    real = {w["name"]: w for w in load_json("BENCHMARK.json")["workloads"]}
    spp = load_json(f"benchmark/traffic/{real[like]['traffic']}.json")["spp"]
    chk = load_json(f"benchmark/checks/{like}.json")
    chk = dict(chk, pixels=96, pixels_per_frame=48)
    return make_root(
        tmp, [dict(name=cell, config="tiny_config", traffic="tiny",
                   chips=1, why="test")],
        {"tiny_config": tiny_config(config, res=(12, 8), rays_per_pass=128,
                                    **settings)},
        {"tiny": dict(name="tiny", spp=spp, chips=1, trace_frames=1,
                      warmup_frames=1)},
        {cell: chk})


def run_cell(root: Path, cell: str, trace=False, seed=3, seconds=0.5):
    """(return code, the result line as a dict or None)."""
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = harness.run(cell, seed, seconds, trace, time.perf_counter(),
                         root, device="cpu")
    lines = buf.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None)
