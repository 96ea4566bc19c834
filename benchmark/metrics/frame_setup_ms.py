"""Host time of the program's `rayn.frame.setup` spans (a frame's sample
tables, filter table, zero film and checkpoint look-up, before its first
pass) on the profiler's clock, the mean a traced frame, in
milliseconds."""

from benchmark.program_spans import FRAME, per_frame_ms

UNIT = "ms"
LAYER = "frame"
MOVES = "msamples_per_s"


def read(run):
    return per_frame_ms(run["trace"], FRAME)
