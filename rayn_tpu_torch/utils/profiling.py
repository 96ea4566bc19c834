"""Profiling helpers (port of rayn_tpu.utils.profiling): phase timers with
samples/sec, a torch.profiler device trace for Perfetto / chrome://tracing,
and a steady-state timer. The reference's only instrumentation is a wall
clock print per frame and a per-tile progress bar (reference
src/main.rs:75-82, src/film.rs:636).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch


def _sync(device) -> None:
    """Wait for the work queued on a CUDA device (no-op for the CPU)."""
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class PhaseTimer:
    """Accumulates wall time per named phase; with `block_on` (a device)
    a phase ends in a synchronize, so its time covers the device work."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str, block_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _sync(block_on)
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self, samples: Optional[int] = None) -> str:
        lines = []
        for name, total in sorted(self.totals.items(),
                                  key=lambda kv: -kv[1]):
            line = f"{name:>20}: {total:8.3f}s x{self.counts[name]}"
            if samples:
                line += f"  ({samples / total / 1e6:.3f} Msamples/s)"
            lines.append(line)
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Trace the CPU ops and, where a card is present, the CUDA kernels
    of the block with torch.profiler, and write the timeline into
    `log_dir` as trace.json (chrome trace format)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def live_samples_per_sec(fn, *args, warmup: int = 1, iters: int = 3,
                         samples_per_call: int = 0, device="cuda"):
    """Time fn(*args) after `warmup` calls; each timed run ends in a
    synchronize of `device`. Returns (seconds_per_call, Msamples/s)."""
    for _ in range(warmup):
        fn(*args)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    _sync(device)
    dt = (time.perf_counter() - t0) / iters
    ms = samples_per_call / dt / 1e6 if samples_per_call else 0.0
    return dt, ms
