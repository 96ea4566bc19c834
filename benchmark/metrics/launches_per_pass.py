"""Kernel launches the host issued (the CUDA runtime's and driver's launch
calls) over the traced frames, per pass."""

UNIT = "launches"
LAYER = "pass"
MOVES = "msamples_per_s"


def read(run):
    tr = run["trace"]
    if not tr or tr["passes"] <= 0 or not tr["launches"]:
        return None
    return tr["launches"] / tr["passes"]
