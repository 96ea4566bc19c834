#!/usr/bin/env python3
"""The check's control: the plain reference computed in bfloat16, put in
the renderer's place, judged against the float64 reference.

    python3 benchmark/control.py --workload CELL --seeds 1,2,3 [--frames N]

For each seed it draws the check's frames and pixels exactly as a run of
the cell that finished N frames would (the frames 1 + 1000 * seed on),
renders them with the reference in float64 and in bfloat16 (reference/
precision.py), and prints the numbers the check compares with the cell's
limits, one JSON line a seed. A limit has to fail here and hold for the
renderer (PERF.md). The benchmark's own runs do not run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--frames", type=int, default=128)
    args = ap.parse_args(argv)
    import numpy as np
    from benchmark import check, harness
    from benchmark.reference.precision import BFLOAT16, FLOAT64
    from benchmark.reference.tracer import Tracer

    cell = harness.load_cell(args.workload)
    cfg = dict(cell.config)
    cfg["settings"] = dict(cfg["settings"], spp=cell.traffic["spp"])
    w, h = cfg["settings"]["resolution"]
    for seed in (int(s) for s in args.seeds.split(",")):
        f0 = harness.first_frame(seed)
        _idx, frames, pixels = check.check_set(
            seed, [f0 + i for i in range(args.frames)], w * h,
            int(cell.check["pixels"]), int(cell.check["pixels_per_frame"]))
        t = time.perf_counter()
        with np.errstate(all="ignore"):
            want = Tracer(cfg, FLOAT64).render(frames, pixels)
            got = Tracer(cfg, BFLOAT16).render(frames, pixels)
        values = check.numbers(got, want)
        ok, report = check.judge(values, cell.check["limits"])
        print(json.dumps(dict(workload=cell.name, seed=seed,
                              control_correct=ok, numbers=values,
                              limits=cell.check["limits"],
                              pixels=int(len(pixels)),
                              seconds=time.perf_counter() - t)), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0] = str(ROOT)
    sys.exit(main())
