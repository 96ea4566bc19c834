"""The card's idle time inside the program's `rayn.pass` spans (while the
host issues a pass, the card has nothing to run: the pass is bound by
its launches and host work) as a share of the traced stretch, both on
the profiler's clock: 100 x the pass spans' time not covered by a kernel,
copy or fill / the first event's start to the last event's end."""

from benchmark.program_spans import covered, intervals, merged, window_us

UNIT = "%"
LAYER = "pass"
MOVES = "msamples_per_s"


def read(run):
    tr = run["trace"]
    if not tr or not tr["device"]:
        return None
    passes = intervals(tr, "rayn.pass")
    if not passes:
        return None
    busy = merged((s, e) for _n, s, e in tr["device"])
    idle = sum((b - a) - covered(busy, a, b) for a, b in passes)
    return 100.0 * idle / window_us(tr)
