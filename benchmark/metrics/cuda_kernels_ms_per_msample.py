"""Device time of the renderer's own CUDA kernels (the `__global__`
functions of its csrc/, benchmark/kernel_names.py) over the traced
frames, per million camera samples traced."""

from benchmark.kernel_names import PORT_KERNELS
from benchmark.tracing import kernel_name

UNIT = "ms/Msample"
LAYER = "kernels"
MOVES = "msamples_per_s"


def read(run):
    tr = run["trace"]
    if not tr:
        return None
    ms = sum((e - s) * 1e-3 for name, s, e in tr["device"]
             if kernel_name(name) in PORT_KERNELS)
    if ms <= 0.0:
        return None
    return ms / (tr["samples"] / 1e6)
