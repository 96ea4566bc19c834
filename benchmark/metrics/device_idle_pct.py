"""Idle share of the card over the traced frames: 100 x (1 - the union of
its kernel, copy and fill intervals / the traced stretch's host wall)."""

from benchmark.tracing import union_length

UNIT = "%"
LAYER = "device"
MOVES = "msamples_per_s"


def read(run):
    tr = run["trace"]
    if not tr or not tr["device"]:
        return None
    busy = union_length((s, e) for _n, s, e in tr["device"]) * 1e-6
    return 100.0 * (1.0 - busy / tr["window_s"])
