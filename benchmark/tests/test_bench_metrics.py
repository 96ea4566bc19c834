"""Each per-layer metric's reader on a canned trace and span list."""

import pytest

from benchmark import harness, tracing
from benchmark.tests.helpers import ROOT

HIT = "closest_hit_kernel(ClosestArgs)"
GLUE = "void at::native::vectorized_elementwise_kernel<4, F, A>(int, F, A)"
COPY = "Memcpy DtoH (Device -> Pageable)"

# microseconds on the profiler's clock
CARD = dict(device=[(HIT, 0.0, 400.0), (GLUE, 300.0, 500.0),
                    (COPY, 600.0, 700.0), (HIT, 800.0, 850.0)],
            launches=30, host=[("aten::copy_", 500.0, 620.0)])
RUN = dict(spans=[dict(name="frame", start=0.0, end=1.0),
                  dict(name="resolve", start=0.5, end=0.51),
                  dict(name="resolve", start=1.5, end=1.53)],
           trace=dict(CARD, window_s=1e-3, passes=2, samples=4000))


def read(name, run=RUN):
    return harness.load_metric(
        name, ROOT / "benchmark" / "metrics" / f"{name}.py").read(run)


def test_device_idle_pct():
    # busy [0, 500] + [600, 700] + [800, 850] = 650 us of 1000
    assert read("device_idle_pct") == pytest.approx(100 * (1 - 650e-6 / 1e-3))


def test_kernel_and_glue_time_per_msample():
    # port kernels 400 + 50 us; glue 200 + 100 us; 4000 samples
    assert read("cuda_kernels_ms_per_msample") == pytest.approx(0.45 / 4e-3)
    assert read("torch_glue_ms_per_msample") == pytest.approx(0.3 / 4e-3)


def test_launches_per_pass():
    assert read("launches_per_pass") == pytest.approx(30 / 2)


def test_resolve_ms_is_the_mean_span():
    assert read("resolve_ms") == pytest.approx(20.0)


def test_readers_report_nothing_without_a_trace():
    run = dict(RUN, trace=None, spans=[])
    for name in ("device_idle_pct", "cuda_kernels_ms_per_msample",
                 "torch_glue_ms_per_msample", "launches_per_pass",
                 "resolve_ms"):
        assert read(name, run) is None


def test_breakdown_names_ops_and_gaps():
    b = tracing.breakdown(CARD)
    assert b["device_ops"][0] == ["closest_hit_kernel", pytest.approx(4.5e-4)]
    assert b["idle_gaps"][0] == ["aten::copy_", pytest.approx(1e-4)]
    assert tracing.kernel_name(GLUE) == "vectorized_elementwise_kernel"
    assert tracing.kernel_name(
        "void at::native::(anonymous namespace)::cunn_SoftMaxForward<4>"
        "(float*)") == "cunn_SoftMaxForward"
    assert tracing.kernel_name(COPY) == "Memcpy DtoH"
