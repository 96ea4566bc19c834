#!/usr/bin/env python3
"""Time a first-use build of the port's CUDA kernels and report each
kernel's registers and spills, for one or more checkouts in turn.

    python3 tools/torch_build_report.py [--roots DIR,DIR,...]
                                        [--rounds R] [--json PATH]

For each root (default: this checkout) and each of R rounds (default
1), in turns, a fresh process imports that root's rayn_tpu_torch and
runs `_build.library_path(verbose=True)` into a new empty build
directory (RAYN_TORCH_BUILD_DIR), so nothing is reused: the wall time
is the first-use build (one nvcc a source, all started together, then
the link), and the `-Xptxas -v` report gives each kernel entry's
registers, spill bytes and shared memory. Then prints, per entry, where
the roots disagree. Needs nvcc, not a card. One JSON line at the end.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent

_CHILD = """
import importlib.util, json, os, sys, time
sys.path.insert(0, sys.argv[1])
from rayn_tpu_torch import _build
assert os.path.realpath(_build.__file__).startswith(
    os.path.realpath(sys.argv[1]))
spec = importlib.util.spec_from_file_location(
    "smoke", os.path.join(sys.argv[2], "chip_smoke.py"))
smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(smoke)
t0 = time.perf_counter()
_build.library_path(verbose=True)
print(json.dumps(dict(seconds=time.perf_counter() - t0,
                      ptxas=smoke.ptxas_report(_build.build_log))))
"""


def build_once(root: str) -> dict:
    """{seconds, ptxas} of one build of `root`'s kernels from nothing."""
    with tempfile.TemporaryDirectory() as tmp:
        env = {**os.environ, "RAYN_TORCH_BUILD_DIR": tmp,
               "PYTHONDONTWRITEBYTECODE": "1"}
        out = subprocess.run(
            [sys.executable, "-c", _CHILD, root, str(HERE)], env=env,
            capture_output=True, text=True, check=True, timeout=1800)
    return json.loads(out.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--roots", default=str(HERE))
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    roots = args.roots.split(",")
    runs = {r: [] for r in roots}
    for i in range(args.rounds):
        for root in (roots if i % 2 == 0 else roots[::-1]):
            rec = build_once(root)
            runs[root].append(rec)
            print(f"[build] {root}: {rec['seconds']:.2f} s, "
                  f"{len(rec['ptxas'])} kernel entries", flush=True)
    ptx = {r: runs[r][0]["ptxas"] for r in roots}
    for entry in sorted(set().union(*ptx.values())):
        vals = [ptx[r].get(entry) for r in roots]
        same = all(v == vals[0] for v in vals)
        print(f"[ptxas] {'same' if same else 'DIFFERS'} {entry}: "
              + "; ".join(f"{r}: {v}" for r, v in zip(roots, vals)))
    out = {r: dict(seconds=[x["seconds"] for x in runs[r]],
                   entries=len(ptx[r]), ptxas=ptx[r]) for r in roots}
    if args.json:
        Path(args.json).write_text(json.dumps(out, indent=1))
    print(json.dumps({r: dict(seconds=v["seconds"], entries=v["entries"])
                      for r, v in out.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
