"""What a run records: the benchmark's own spans, and the device and host
events of a torch.profiler trace, reduced to plain lists that the
per-layer metrics read (metrics/*.py).
"""

from __future__ import annotations

import contextlib
import time

# Host-side launch calls of the CUDA runtime and driver APIs.
LAUNCH_NAMES = frozenset({"cudaLaunchKernel", "cudaLaunchKernelExC",
                          "cuLaunchKernel", "cuLaunchKernelEx"})


class Spans:
    """Named host-clock intervals (perf_counter seconds), in order."""

    def __init__(self):
        self.items: list[dict] = []

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.items.append(dict(name=name, start=t0,
                                   end=time.perf_counter(), **attrs))


def union_length(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def kernel_name(name: str) -> str:
    """A device event's kernel name without its return type, namespace,
    template arguments or parameter list (`void ns::foo_kernel<1>(Args)`
    -> foo_kernel); a copy or fill keeps its kind (`Memcpy DtoH`)."""
    base = name.replace("(anonymous namespace)::", "")
    base = base.split("(", 1)[0].split("<", 1)[0].strip()
    if base.startswith(("Memcpy", "Memset")):
        return base
    return base.rsplit(" ", 1)[-1].rsplit("::", 1)[-1]


def reduce_profile(prof) -> dict:
    """The trace as lists: device events (name, start_us, end_us), the
    count of launch calls, and the host events (name, start_us, end_us)
    that the idle gaps are named by."""
    from torch.autograd import DeviceType

    device, host, launches = [], [], 0
    for e in prof.events():
        tr = e.time_range
        if e.device_type == DeviceType.CUDA:
            # a record_function's span on the device's timeline is no work
            if not getattr(e, "is_user_annotation", False):
                device.append((e.name, float(tr.start), float(tr.end)))
        else:
            if e.name in LAUNCH_NAMES:
                launches += 1
            host.append((e.name, float(tr.start), float(tr.end)))
    return dict(device=device, launches=launches, host=host)


def breakdown(trace: dict, top: int = 10) -> dict:
    """The device operations that took most time (seconds summed by
    kernel name), and the longest idle gaps, each named by the innermost
    host event running at its middle."""
    by_name: dict[str, float] = {}
    for name, s, e in trace["device"]:
        k = kernel_name(name)
        by_name[k] = by_name.get(k, 0.0) + (e - s) * 1e-6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    ivs = sorted((s, e) for _n, s, e in trace["device"])
    gaps, end = [], None
    for s, e in ivs:
        if end is not None and s > end:
            gaps.append((end, s))
        end = e if end is None else max(end, e)
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    host = trace["host"]
    named = []
    for g0, g1 in gaps:
        mid = 0.5 * (g0 + g1)
        inner = [h for h in host if h[1] <= mid <= h[2]]
        label = (min(inner, key=lambda h: h[2] - h[1])[0] if inner
                 else "host: no traced event")
        named.append([label, (g1 - g0) * 1e-6])
    return dict(device_ops=[[n, s] for n, s in ops], idle_gaps=named)
