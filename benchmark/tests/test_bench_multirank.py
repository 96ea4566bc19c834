"""A cell on several cards (benchmark/multirank.py), run on the CPU as
two gloo ranks at a tiny size, sound and with its timed path broken,
and the scale-out layer's readers on a canned four-rank trace (its NCCL
kernel's name as an H100's trace gives it)."""

import io
import json
import pickle
import time
from contextlib import redirect_stdout

import numpy as np
import pytest

from benchmark import check, harness, multirank, program
from benchmark.tests.helpers import (ROOT, load_json, make_root,
                                     tiny_config)
from benchmark.tests.test_bench_metrics import RUN, read

SEED = 5
# 12x8 at 8 spp is 768 samples: two passes of 2 x 200 rays, the second
# ending past the frame, so rank 1's last slice is partly out of it
CONFIG = tiny_config("rtiow_spheres", res=(12, 8), rays_per_pass=200)
CELL = "tiny_x2"


def two_rank_root(tmp):
    chk = dict(load_json("benchmark/checks/spheres_final_8spp.json"),
               pixels=96, pixels_per_frame=48)
    return make_root(
        tmp, [dict(name=CELL, config="tiny_config", traffic="tiny_x2",
                   chips=2, why="test")],
        {"tiny_config": CONFIG},
        {"tiny_x2": dict(name="tiny_x2", spp=8, chips=2, trace_frames=1,
                         warmup_frames=1)},
        {CELL: chk})


def wrap_rank(monkeypatch, tmp, ranks, body: str):
    """Run each rank in `ranks` (one or a tuple) through a script that
    first executes `body` (with `harness`, `program` and `multirank`
    imported) in its process."""
    ranks = (ranks,) if isinstance(ranks, int) else tuple(ranks)
    script = tmp / "rank_wrapped.py"
    script.write_text(
        f"import sys\nsys.path[0] = {str(ROOT)!r}\n"
        "from benchmark import harness, multirank, program\n"
        f"{body}\nmultirank.entry(sys.argv[1:])\n")
    real = multirank.rank_command

    def command(r, *a, **k):
        cmd = real(r, *a, **k)
        return [cmd[0], str(script), *cmd[2:]] if r in ranks else cmd

    monkeypatch.setattr(multirank, "rank_command", command)


def launch(root, trace=False):
    """(return code, standard output's lines, seconds)."""
    buf = io.StringIO()
    t = time.monotonic()
    with redirect_stdout(buf):
        rc = harness.run(CELL, SEED, 0.5, trace, time.perf_counter(), root,
                         device="cpu")
    return rc, buf.getvalue().splitlines(), time.monotonic() - t


def test_two_ranks_print_one_line_and_render_the_one_process_frames(
        tmp_path, monkeypatch):
    """Rank 0's result is the only line; the pixels it checked are those
    of the same frames rendered by one process, to float32 sum order."""
    saved = tmp_path / "picks.pkl"
    wrap_rank(monkeypatch, tmp_path, 0, f"""
import pickle
real = harness.report
def report(cell, rec, *a, **k):
    with open({str(saved)!r}, "wb") as f:
        pickle.dump(dict(frames=rec["frames"], picks=rec["picks"]), f)
    return real(cell, rec, *a, **k)
harness.report = report""")
    rc, lines, _s = launch(two_rank_root(tmp_path), trace=True)
    assert rc == 0 and len(lines) == 1
    out = json.loads(lines[0])
    assert out["correct"] is True and out["device"]["count"] == 2
    assert out["device"]["window_s"] > 0
    assert "resolve_ms" in out["metrics"]
    # no card, so no device trace: the scale-out readers find nothing
    assert "allreduce_ms_per_pass" not in out["metrics"]

    got = pickle.loads(saved.read_bytes())
    assert len(got["frames"]) == len(got["picks"]) >= 1
    settings = program.settings_of(CONFIG, spp=8)
    r = program.Renderer(CONFIG, settings, "cpu")
    for f, pick in zip(got["frames"], got["picks"]):
        want = check.take(r.resolve(r.render(f)),
                          check.frame_pixels(SEED, f, 96, 48))
        for ch in check.CHANNELS:
            np.testing.assert_allclose(pick[ch], want[ch], rtol=0,
                                       atol=2e-5)


def test_a_rank_that_raises_ends_the_run_with_no_result(tmp_path,
                                                        monkeypatch):
    """Rank 1 raises at the window's first frame while rank 0 waits for
    it in the pass's all_reduce: the launcher stops rank 0 and exits
    non-zero at once, printing nothing on standard output."""
    wrap_rank(monkeypatch, tmp_path, 1, f"""
real = program.Renderer.render
def render(self, frame):
    if frame >= harness.first_frame({SEED}):
        raise RuntimeError("a rank fails")
    return real(self, frame)
program.Renderer.render = render""")
    rc, lines, seconds = launch(two_rank_root(tmp_path))
    assert rc != 0 and lines == []
    assert seconds < 30


# faults planted under the timed path of every rank
FAULTS = {
    # the pass's film windows are not summed over the ranks: rank 0
    # resolves its own slices alone
    "exchange_left_out": """
import torch.distributed as dist
real = dist.all_reduce
def all_reduce(t, *a, **k):
    if t.is_floating_point():
        return None
    return real(t, *a, **k)
dist.all_reduce = all_reduce""",
    "pass_returns_film_unchanged": """
from rayn_tpu_torch.render import renderer
renderer.render_pass = lambda film, *a, **k: film""",
    # each rank renders the first half of its slice of every pass
    "half_of_each_slice_left_out": """
from rayn_tpu_torch.render import renderer
real = renderer.render_pass
def half(film, data, static, settings, tables, camera, fis, start, size,
         *a, **k):
    return real(film, data, static, settings, tables, camera, fis, start,
                size // 2, *a, **k)
renderer.render_pass = half""",
    # each frame's image is altered where it is made: salted with the
    # next frame's number
    "answer_of_another_frame": """
from rayn_tpu_torch.render import renderer
real = renderer.render_frame
def render_frame(*a, frame=1, **k):
    return real(*a, frame=frame + 1, **k)
renderer.render_frame = render_frame""",
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(tmp_path, monkeypatch, fault):
    """The two ranks' run, its look for a card skipped, with the timed
    path broken on both ranks: the result line says not correct."""
    wrap_rank(monkeypatch, tmp_path, (0, 1), FAULTS[fault])
    rc, lines, _s = launch(two_rank_root(tmp_path))
    assert rc == 0 and len(lines) == 1
    assert json.loads(lines[0])["correct"] is False


def test_rank_samples_cover_the_frame_once():
    """The ranks' samples a frame add up to the frame's, the last pass's
    slices cut at its end."""
    from rayn_tpu_torch.parallel.sharding import Mesh
    settings = program.settings_of(CONFIG, spp=8)
    r = program.Renderer(CONFIG, settings, "cpu")
    got = []
    for rank in range(2):
        r.mesh = Mesh({"tile": 2, "spp": 1}, rank, 2, "cpu")
        got.append(r.samples_per_frame())
        assert r.passes_per_frame() == 2
    assert got == [400, 368] and sum(got) == 12 * 8 * 8


NCCL = "ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage<4096ul>)"
HIT = "closest_hit_kernel(ClosestArgs)"
GLUE = "void at::native::vectorized_elementwise_kernel<4, F, A>(int, F, A)"
COPY = "Memcpy DtoH (Device -> Pageable)"


def rank_trace(nccl_us, work_us, copy_us=0.0, passes=2):
    """A rank's reduced trace: its NCCL kernels, then its work (a port
    kernel and glue, half each), then a copy, in microseconds."""
    dev, t = [], 0.0
    for d in nccl_us:
        dev.append((NCCL, t, t + d))
        t += d
    for name in (HIT, GLUE):
        dev.append((name, t, t + work_us / 2))
        t += work_us / 2
    dev.append((COPY, t, t + copy_us))
    return dict(device=dev, host=[], launches=0, window_s=1e-2,
                passes=passes, samples=4000)


# rank 0 resolves (a copy of 900 us) and waits least in its all_reduces
RANKS = [rank_trace([40.0, 60.0], 1000.0, copy_us=900.0),
         rank_trace([300.0, 500.0], 1200.0),
         rank_trace([200.0, 200.0], 1100.0),
         rank_trace([100.0, 700.0], 700.0)]


def test_allreduce_ms_per_pass_is_the_least_ranks():
    # NCCL ms a pass: 0.05, 0.4, 0.2, 0.4
    run = dict(RUN, ranks=RANKS)
    assert read("allreduce_ms_per_pass", run) == pytest.approx(0.05)


def test_rank_skew_pct_leaves_out_nccl_and_copies():
    # kernels 1000, 1200, 1100, 700 us: mean 1000, largest 1200
    run = dict(RUN, ranks=RANKS)
    assert read("rank_skew_pct", run) == pytest.approx(20.0)


@pytest.mark.parametrize("name", ["allreduce_ms_per_pass", "rank_skew_pct"])
def test_scale_out_readers_find_nothing_on_one_card(name):
    assert read(name, dict(RUN, ranks=None)) is None
    assert read(name, RUN) is None
    no_nccl = [rank_trace([], 1000.0)] * 2
    if name == "allreduce_ms_per_pass":
        assert read(name, dict(RUN, ranks=no_nccl)) is None

