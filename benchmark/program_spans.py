"""The program's own spans (`rayn.*`, rayn_tpu_torch/utils/profiling.py)
as the host events of a traced run show them (tracing.reduce_profile):
what the span metrics in metrics/*.py read. A program without such spans
gives them nothing to read, and each reports nothing."""

from __future__ import annotations

import bisect

from benchmark.tracing import LAUNCH_NAMES

FRAME = "rayn.frame.setup"   # one a render_frame call


def intervals(trace: dict, name: str) -> list[tuple[float, float]]:
    """(start_us, end_us) of every host event named `name`, in order."""
    return sorted((s, e) for n, s, e in trace["host"] if n == name)


def per_frame_ms(trace, name: str):
    """Host milliseconds in the spans `name` a traced frame, or None."""
    if not trace:
        return None
    frames, spans = intervals(trace, FRAME), intervals(trace, name)
    if not frames or not spans:
        return None
    return 1e-3 * sum(e - s for s, e in spans) / len(frames)


def merged(ivs) -> list[tuple[float, float]]:
    """The union of (start, end) intervals as disjoint sorted intervals."""
    out: list[list[float]] = []
    for s, e in sorted(ivs):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def covered(union: list[tuple[float, float]], a: float, b: float) -> float:
    """Length of [a, b] that the disjoint sorted intervals `union` cover."""
    i = max(0, bisect.bisect_right(union, (a,)) - 1)
    total = 0.0
    while i < len(union) and union[i][0] < b:
        s, e = union[i]
        total += max(0.0, min(e, b) - max(s, a))
        i += 1
    return total


def window_us(trace: dict) -> float:
    """The traced stretch on the profiler's clock: the first event's start
    to the last event's end, host and device."""
    evs = trace["host"] + trace["device"]
    return max(e for _n, _s, e in evs) - min(s for _n, s, _e in evs)


def launched_kernels(trace: dict):
    """[(launch call start_us, kernel start_us, kernel end_us)] in launch
    order, or None. The reduced trace keeps no correlation ids, so the
    n-th launch call is paired with the n-th kernel: sound where the
    kernels ran in launch order, one after another on one stream, and
    each launch call has its kernel in the trace (equal counts). Where
    either fails there is no pairing. Copies and fills are not
    kernels."""
    launches = sorted(s for n, s, _e in trace["host"] if n in LAUNCH_NAMES)
    kernels = sorted((s, e) for n, s, e in trace["device"]
                     if not n.startswith(("Memcpy", "Memset")))
    if not launches or len(launches) != len(kernels):
        return None
    if any(b[0] < a[1] for a, b in zip(kernels, kernels[1:])):
        return None   # kernels overlap: more than one stream
    return [(l, s, e) for l, (s, e) in zip(launches, kernels)]


def kernel_ms_in(trace: dict, names) -> float | None:
    """Device milliseconds of the kernels whose launch calls lie inside
    the host spans `names` (launched_kernels' pairing), or None."""
    pairs = launched_kernels(trace)
    if pairs is None:
        return None
    starts = [l for l, _s, _e in pairs]
    total = 0.0
    for a, b in merged(iv for n in names for iv in intervals(trace, n)):
        i, j = bisect.bisect_left(starts, a), bisect.bisect_right(starts, b)
        total += sum(e - s for _l, s, e in pairs[i:j])
    return 1e-3 * total
