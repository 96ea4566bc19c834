"""Device time of everything else the frames ran on the card (PyTorch's
kernels, copies and fills; not the renderer's CUDA kernels) over the
traced frames, per million camera samples traced."""

from benchmark.kernel_names import PORT_KERNELS
from benchmark.tracing import kernel_name

UNIT = "ms/Msample"
LAYER = "bounce glue"
MOVES = "msamples_per_s"


def read(run):
    tr = run["trace"]
    if not tr:
        return None
    ms = sum((e - s) * 1e-3 for name, s, e in tr["device"]
             if kernel_name(name) not in PORT_KERNELS)
    if ms <= 0.0:
        return None
    return ms / (tr["samples"] / 1e6)
