"""Profiling helpers: the renderer's named spans and a torch.profiler
device trace for Perfetto / chrome://tracing. The reference's only
instrumentation is a wall clock print per frame and a per-tile progress
bar (reference src/main.rs:75-82, src/film.rs:636).

Tracing is on exactly while a torch.profiler session records (the CLI's
`--trace-dir`, the benchmark's `--trace 1` stretch). Then each `span` is
a `record_function` on the profiler's timeline, on the clock of the
device events and the launch calls: a span's device time is that of the
kernels whose launch calls it holds. Otherwise a span checks one flag
and does nothing else.
"""

from __future__ import annotations

import contextlib
import os

import torch

_profiling = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager naming a stretch of the renderer's work while a
    torch.profiler session records; outside one, a shared no-op context.
    Spans change no result."""
    if not _profiling():
        return _OFF
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Trace the CPU ops, the renderer's spans and, where a card is
    present, the CUDA kernels of the block with torch.profiler, and write
    the timeline into `log_dir` as trace.json (chrome trace format)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
