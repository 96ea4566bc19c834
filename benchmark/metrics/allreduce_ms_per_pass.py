"""Device time of the NCCL kernels on each card over the traced frames,
per traced pass, the least over the cards (a cell on several cards).
Every NCCL kernel there is a pass's all_reduce of its pixel window: the
ranks' control runs over gloo, on the host. An all_reduce that waits
for a slower rank spins on its card, so the slowest rank's figure, the
least, is nearest the transfer itself. On one card, or where a card's
trace shows no NCCL kernel, there is nothing to read."""

from benchmark.tracing import kernel_name

UNIT = "ms"
LAYER = "scale-out"
MOVES = "msamples_per_s"


def read(run):
    traces = run.get("ranks")
    if not traces:
        return None
    per_pass = [sum((e - s) * 1e-3 for name, s, e in tr["device"]
                    if kernel_name(name).startswith("nccl")) / tr["passes"]
                for tr in traces]
    if min(per_pass) <= 0.0:
        return None
    return min(per_pass)
