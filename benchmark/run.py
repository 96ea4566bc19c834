#!/usr/bin/env python3
"""The renderer's benchmark: one cell of BENCHMARK.json, one run.

    python3 benchmark/run.py --workload CELL --seed N --seconds S --trace 0|1

Run from the root of a checkout on a machine with the cell's CUDA cards.
It builds (first run of a checkout) or loads the renderer's kernels,
builds the cell's scene on the card, renders one warm-up frame, then
renders frames one after another for S seconds, each a call of
`render_frame` and `film.resolve`, from frame 1 + 1000 * N on. With
--trace 1 it then renders the traffic's `trace_frames` frames under
torch.profiler and reports the per-layer metrics instead of the
end-to-end ones. Last, it checks the timed frames against the plain
reference (benchmark/reference) and prints one JSON line. It exits
non-zero, with no result, without the cards the cell asks for.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    from benchmark import harness
    os.environ.update(harness.cache_env(ROOT))
    return harness.run(args.workload, args.seed, args.seconds,
                       bool(args.trace), T0, ROOT)


if __name__ == "__main__":
    sys.path[0] = str(ROOT)   # not benchmark/: its modules are a package
    sys.exit(main())
