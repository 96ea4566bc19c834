"""The readers of the program's own spans (benchmark/program_spans.py) on
the canned trace of test_bench_metrics.py, extended with two frames'
worth of `rayn.*` host events and launch calls, and a frame whose launch
calls pair with its kernels."""

import pytest

from benchmark import tracing
from benchmark.tests.test_bench_metrics import CARD, COPY, RUN, read

LAUNCH = "cudaLaunchKernel"

# microseconds on the profiler's clock: frame set-ups, passes, bounces,
# the resolve's copies and means, the benchmark's `resolve`, and launch
# calls (five inside a bounce, one outside)
SPANS = [("rayn.frame.setup", 0.0, 10.0),
         ("rayn.pass", 10.0, 520.0),
         ("rayn.bounce", 20.0, 300.0),
         (LAUNCH, 25.0, 26.0), (LAUNCH, 100.0, 101.0),
         ("rayn.bounce", 300.0, 510.0),
         (LAUNCH, 310.0, 311.0), (LAUNCH, 320.0, 321.0),
         ("rayn.pass", 680.0, 850.0),
         ("rayn.bounce", 690.0, 840.0), (LAUNCH, 700.0, 701.0),
         ("rayn.frame.setup", 860.0, 880.0), (LAUNCH, 865.0, 866.0),
         ("resolve", 890.0, 1000.0),
         ("rayn.resolve.copy", 900.0, 930.0),
         ("rayn.resolve.mean", 930.0, 990.0),
         ("rayn.resolve.copy", 990.0, 995.0)]
TRACED = dict(CARD, host=CARD["host"] + SPANS)
SPAN_RUN = dict(RUN, trace=dict(RUN["trace"], **TRACED))

SPAN_METRICS = ("resolve_copy_ms", "resolve_mean_ms", "frame_setup_ms",
                "idle_launch_bound_pct", "launches_per_bounce",
                "sort_device_ms_per_msample")


def test_resolve_copy_and_mean_ms_a_frame():
    # copies 30 + 5 us, means 60 us, over two frames
    assert read("resolve_copy_ms", SPAN_RUN) == pytest.approx(17.5e-3)
    assert read("resolve_mean_ms", SPAN_RUN) == pytest.approx(30e-3)


def test_frame_setup_ms_is_the_mean_setup_span():
    assert read("frame_setup_ms", SPAN_RUN) == pytest.approx(15e-3)


def test_idle_launch_bound_pct():
    # pass [10, 520] idle over [500, 520]; pass [680, 850] busy only over
    # [680, 700] and [800, 850]: 20 + 100 us idle of the 1000 us stretch
    assert read("idle_launch_bound_pct", SPAN_RUN) == pytest.approx(12.0)


def test_launches_per_bounce():
    # five launch calls inside three bounces; the one at 865 is outside
    assert read("launches_per_bounce", SPAN_RUN) == pytest.approx(5 / 3)


# a frame whose launch calls pair one to one with its kernels (copies and
# fills aside): sort and unsort launch the first and third kernels
KERNEL = "void at::native::vectorized_gather_kernel<16>(char*)"
SORTED = dict(device=[(KERNEL, 50.0, 80.0), (KERNEL, 120.0, 150.0),
                      (COPY, 200.0, 250.0), (KERNEL, 400.0, 460.0),
                      (KERNEL, 500.0, 520.0)],
              launches=4,
              host=[("rayn.frame.setup", 0.0, 10.0),
                    ("rayn.bounce.sort", 20.0, 40.0), (LAUNCH, 25.0, 26.0),
                    ("rayn.bounce.intersect", 40.0, 60.0),
                    (LAUNCH, 45.0, 46.0),
                    ("rayn.bounce.unsort", 300.0, 320.0),
                    (LAUNCH, 305.0, 306.0), (LAUNCH, 330.0, 331.0)],
              window_s=1e-3, passes=1, samples=4000)


def _sorted_run(**trace):
    return dict(RUN, trace=dict(SORTED, **trace))


def test_sort_device_ms_per_msample():
    # kernels 30 + 60 us launched in the sort and unsort, 4000 samples
    assert read("sort_device_ms_per_msample", _sorted_run()) == \
        pytest.approx(0.09 / 4e-3)


def test_sort_device_ms_reads_zero_where_nothing_sorts():
    host = [h for h in SORTED["host"] if not h[0].startswith("rayn.bounce.")
            or h[0] == "rayn.bounce.intersect"]
    assert read("sort_device_ms_per_msample", _sorted_run(host=host)) == 0.0


def test_sort_device_ms_needs_launches_paired_with_kernels():
    # a kernel missing from the trace, or two kernels that overlap (more
    # than one stream): launch order no longer says which kernel is whose
    missing = SORTED["device"][:-1]
    overlap = [(KERNEL, 50.0, 130.0)] + SORTED["device"][1:]
    for device in (missing, overlap):
        assert read("sort_device_ms_per_msample",
                    _sorted_run(device=device)) is None


def test_span_readers_report_nothing_without_the_programs_spans():
    """A program without the spans (the parent of the program that has
    them) gives no reading and no error, and no trace gives none."""
    for name in SPAN_METRICS:
        assert read(name, RUN) is None
        assert read(name, dict(RUN, trace=None, spans=[])) is None


def test_spans_change_no_other_reader():
    for name in ("device_idle_pct", "cuda_kernels_ms_per_msample",
                 "torch_glue_ms_per_msample", "launches_per_pass",
                 "resolve_ms"):
        assert read(name, SPAN_RUN) == read(name, RUN)


def test_breakdown_names_gaps_by_the_innermost_span():
    gaps = tracing.breakdown(TRACED)["idle_gaps"]
    # [500, 600] by the copy op at its middle, [700, 800] by the bounce
    # inside the pass
    assert gaps[0] == ["aten::copy_", pytest.approx(1e-4)]
    assert gaps[1] == ["rayn.bounce", pytest.approx(1e-4)]
