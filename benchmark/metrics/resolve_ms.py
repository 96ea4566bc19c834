"""The benchmark's own span around `film.resolve` (the film copied to the
host and divided into per-pixel means), the mean a frame over the
window's frames, in milliseconds."""

UNIT = "ms"
LAYER = "frame"
MOVES = "msamples_per_s"


def read(run):
    d = [s["end"] - s["start"] for s in run["spans"] if s["name"] == "resolve"]
    if not d:
        return None
    return 1e3 * sum(d) / len(d)
