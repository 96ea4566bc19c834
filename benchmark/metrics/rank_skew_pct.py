"""Imbalance of the ranks' contiguous slices of each pass (a cell on
several cards): 100 x (the largest / the mean - 1) of the ranks' device
ms in kernels over the traced frames. NCCL's kernels (a rank's all_reduce
spins while it waits for a slower one), copies and fills are left out:
rank 0 alone copies the film to the host to resolve it. On one card
there is nothing to read."""

from benchmark.tracing import kernel_name

UNIT = "%"
LAYER = "scale-out"
MOVES = "msamples_per_s"


def read(run):
    traces = run.get("ranks")
    if not traces:
        return None
    ms = [sum((e - s) * 1e-3 for name, s, e in tr["device"]
              if not kernel_name(name).startswith(("nccl", "Memcpy",
                                                   "Memset")))
          for tr in traces]
    mean = sum(ms) / len(ms)
    if mean <= 0.0:
        return None
    return 100.0 * (max(ms) / mean - 1.0)
