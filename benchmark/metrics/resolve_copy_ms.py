"""Host time of the program's `rayn.resolve.copy` spans (each film
accumulator's copy to the host inside `film.resolve`) on the profiler's
clock, summed over the traced frames and divided by the frames (the
`rayn.frame.setup` spans, one a `render_frame`), in milliseconds."""

from benchmark.program_spans import per_frame_ms

UNIT = "ms"
LAYER = "frame"
MOVES = "msamples_per_s"


def read(run):
    return per_frame_ms(run["trace"], "rayn.resolve.copy")
