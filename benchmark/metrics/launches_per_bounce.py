"""Kernel launches the host issued (tracing.LAUNCH_NAMES) inside the
program's `rayn.bounce` spans, one a depth of the integrator's bounce
loop, per such span over the traced frames."""

import bisect

from benchmark.program_spans import intervals
from benchmark.tracing import LAUNCH_NAMES

UNIT = "launches"
LAYER = "bounce glue"
MOVES = "msamples_per_s"


def read(run):
    tr = run["trace"]
    if not tr:
        return None
    bounces = intervals(tr, "rayn.bounce")
    starts = sorted(s for n, s, _e in tr["host"] if n in LAUNCH_NAMES)
    if not bounces or not starts:
        return None
    n = sum(bisect.bisect_right(starts, e) - bisect.bisect_left(starts, s)
            for s, e in bounces)
    return n / len(bounces)
