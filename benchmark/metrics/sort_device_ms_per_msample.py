"""Device time of the program's chunk sorts and unsorts (the
`rayn.bounce.sort` and `rayn.bounce.unsort` spans: the cost keys, the
sorts and the gathers before the intersect and the shadow tail, and the
gathers back) over the traced frames, per million camera samples traced:
the trace's kernels whose launch calls lie in those spans
(program_spans.kernel_ms_in). A frame that sorts nothing reads 0; a
program without the spans, or a trace whose launch calls and kernels do
not pair, gives no reading."""

from benchmark.program_spans import FRAME, intervals, kernel_ms_in

UNIT = "ms/Msample"
LAYER = "bounce glue"
MOVES = "msamples_per_s"


def read(run):
    tr = run["trace"]
    if not tr or not intervals(tr, FRAME):
        return None
    ms = kernel_ms_in(tr, ("rayn.bounce.sort", "rayn.bounce.unsort"))
    if ms is None:
        return None
    return ms / (tr["samples"] / 1e6)
