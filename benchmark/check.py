"""What decides `correct`: the timed frames' pixels against the plain
reference.

During the window, each timed frame leaves the resolved values of a few
pixels drawn from (seed, frame number): color, background, alpha and
normal. Once the window has closed, frames drawn from the seed (the
first and the last always among them) are rendered again by the
reference (reference/tracer.py) at those pixels, from the configuration
file and the frame numbers alone, and each pixel's error is the largest
over its channels of |program - reference|, color and background
compared as x / (1 + |x|), alpha as it is and the normal halved, so that
every channel reads in [0, 1] (a NaN reads 1). The numbers compared:

- `err_median`: the median pixel error. Where a sample's path is the same
  on both sides, the two differ by float32 rounding against float64;
- `diverged_share`: the share of pixels whose error passes 0.01, the
  pixels where some sample's path took another turn (a march that ends a
  step apart on the MandelBox's detail, a roulette or lobe choice on the
  other side of its threshold).

Each has its limit in the cell's check file (checks/<cell>.json), set
from the program's readings over seeds and the control's (PERF.md).
"""

from __future__ import annotations

import numpy as np

DIVERGED = 0.01
CHANNELS = ("color", "background", "alpha", "normal")


def frame_pixels(seed: int, frame: int, n_pixels: int, count: int):
    """The pixels of `frame` that the check may read, drawn from the seed."""
    rng = np.random.default_rng(np.random.SeedSequence(
        [seed % (1 << 64), frame % (1 << 64)]))
    return np.sort(rng.choice(n_pixels, size=count, replace=False))


def take(resolved, pixels) -> dict:
    """The resolved film's values at flat pixel ids (y-major rows)."""
    out = {}
    for ch in CHANNELS:
        a = np.asarray(getattr(resolved, ch))
        flat = a.reshape(-1, 3) if a.ndim == 3 else a.reshape(-1)
        out[ch] = np.array(flat[pixels], np.float64)
    return out


def frames_to_check(seed: int, n_frames: int, budget_frames: int):
    """Indices of the window's frames to compare: the first, the last and
    frames drawn from the seed, at most `budget_frames`."""
    if n_frames <= budget_frames:
        return list(range(n_frames))
    rng = np.random.default_rng(np.random.SeedSequence(
        [seed % (1 << 64), 0x636865636B]))
    middle = rng.choice(np.arange(1, n_frames - 1),
                        size=max(budget_frames - 2, 0), replace=False)
    return sorted({0, n_frames - 1, *middle.tolist()})


def check_set(seed: int, frames: list, n_pixels: int, pixels: int,
              per_frame: int):
    """(indices into `frames`, frame number of each pixel, pixel ids) of
    what the check compares: `pixels // per_frame` frames of the window
    (frames_to_check), `per_frame` pixels of each (frame_pixels)."""
    idx = frames_to_check(seed, len(frames), pixels // per_frame)
    fr = np.concatenate([np.full(per_frame, frames[i], np.int64)
                         for i in idx])
    px = np.concatenate([frame_pixels(seed, frames[i], n_pixels, per_frame)
                         for i in idx])
    return idx, fr, px


def tone(x):
    return x / (1.0 + np.abs(x))


def pixel_errors(got: dict, want: dict) -> np.ndarray:
    e = np.maximum(np.abs(tone(got["color"]) - tone(want["color"])).max(1),
                   np.abs(tone(got["background"])
                          - tone(want["background"])).max(1))
    e = np.maximum(e, np.abs(got["alpha"] - want["alpha"]))
    e = np.maximum(e, 0.5 * np.abs(got["normal"] - want["normal"]).max(1))
    bad = np.zeros(e.shape, bool)
    for ch in CHANNELS:
        v = got[ch].reshape(e.shape[0], -1)
        bad |= ~np.isfinite(v).all(axis=1)
    return np.where(bad | np.isnan(e), 1.0, e)


def numbers(got: dict, want: dict) -> dict:
    e = pixel_errors(got, want)
    return dict(err_median=float(np.median(e)),
                diverged_share=float(np.mean(e > DIVERGED)))


def concat(parts: list[dict]) -> dict:
    return {ch: np.concatenate([p[ch] for p in parts]) for ch in CHANNELS}


def judge(values: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, {name: {value, limit}})."""
    report = {k: dict(value=values[k], limit=limits[k]) for k in limits}
    ok = all(values[k] <= limits[k] for k in limits)
    return ok, report
