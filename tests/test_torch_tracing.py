"""The renderer's spans (rayn_tpu_torch/utils/profiling.py): under
torch.profiler (`profiling.device_trace`, the CLI's `--trace-dir`) every
`rayn.*` span a frame runs is a host event in the trace file, as often
as the frame's passes and bounces say and nested as the code nests; the
stages of a bounce do not overlap, so each launch lies in one stage;
with no profiler a span enters nothing; and the film is the same bits
with tracing on and off.

The `gpu` case renders under the profiler on the card:

    python -m pytest tests/test_torch_tracing.py -m gpu -q
"""

import json
import tempfile
from pathlib import Path

import pytest
import torch

from rayn_tpu_torch.config import RenderSettings
from rayn_tpu_torch.render import film as film_mod
from rayn_tpu_torch.render import renderer
from rayn_tpu_torch.scene import presets
from rayn_tpu_torch.utils import profiling

STAGES = ("rayn.pass.rays", "rayn.pass.splat", "rayn.bounce.compact",
          "rayn.bounce.sort", "rayn.bounce.intersect", "rayn.bounce.shade",
          "rayn.bounce.unsort")

# each span's enclosing span (the compaction after the last bounce lies
# in the pass's trace, the others in their bounce)
PARENT = {"rayn.pass.rays": "rayn.pass", "rayn.pass.trace": "rayn.pass",
          "rayn.pass.splat": "rayn.pass", "rayn.bounce": "rayn.pass.trace",
          "rayn.bounce.compact": "rayn.pass.trace",
          "rayn.bounce.sort": "rayn.bounce",
          "rayn.bounce.intersect": "rayn.bounce",
          "rayn.bounce.shade": "rayn.bounce",
          "rayn.bounce.unsort": "rayn.bounce"}

# (scene, resolution, settings, spans a frame): the spheres scene has no
# SDF, so it sorts nothing; the MandelBox scene, compacted, at depth 1
# sorts before the intersect and before the shadow tail and unsorts once.
# The fused tail's shading is two spans a bounce, around the shadow sort.
CASES = {
    "spheres": (presets.spheres_scene, (16, 8),
                dict(spp=2, rays_per_pass=128),
                {"rayn.frame.setup": 1, "rayn.pass": 2, "rayn.pass.rays": 2,
                 "rayn.pass.trace": 2, "rayn.pass.splat": 2,
                 "rayn.bounce": 8, "rayn.bounce.intersect": 8,
                 "rayn.bounce.shade": 16, "rayn.resolve.copy": 5,
                 "rayn.resolve.mean": 5}),
    "mandelbox_compacted": (presets.default_scene, (8, 4),
                            dict(spp=1, rays_per_pass=32, max_bounces=1,
                                 max_marches=8, max_vis_marches=8,
                                 volume_marches=1, compact_bounces=True),
                            {"rayn.frame.setup": 1, "rayn.pass": 1,
                             "rayn.pass.rays": 1, "rayn.pass.trace": 1,
                             "rayn.pass.splat": 1, "rayn.bounce": 2,
                             "rayn.bounce.compact": 2,
                             "rayn.bounce.sort": 2,
                             "rayn.bounce.intersect": 2,
                             "rayn.bounce.shade": 4,
                             "rayn.bounce.unsort": 1,
                             "rayn.resolve.copy": 5,
                             "rayn.resolve.mean": 5}),
}


def _frame(case, device="cpu"):
    """The case's scene and settings, and a function that renders and
    resolves its frame: (film tensors, resolved film)."""
    make, res, kw, _ = CASES[case]
    data, static, cam = make(res, device=device)
    s = RenderSettings(resolution=res, **kw)

    def render():
        f = renderer.render_frame(data, static, s, cam, frame=3)
        return film_mod.tensors(f), film_mod.resolve(f, res, s)
    return render


def _traced(render, device):
    """Render under `profiling.device_trace`: (film, resolved, the rayn.*
    host events of its trace.json as (name, start_us, end_us), the
    profiler)."""
    with tempfile.TemporaryDirectory() as tmp:
        with profiling.device_trace(tmp) as prof:
            film, res = render()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        doc = json.loads((Path(tmp) / "trace.json").read_text())
    events = [(e["name"], e["ts"], e["ts"] + e["dur"])
              for e in doc["traceEvents"]
              if e.get("cat") == "user_annotation"
              and e["name"].startswith("rayn.")]
    return film, res, events, prof


@pytest.fixture(scope="module", params=sorted(CASES))
def traced(request):
    """(case, film untraced, film traced, resolved both, events)."""
    render = _frame(request.param)
    film0, res0 = render()
    film1, res1, events, _prof = _traced(render, torch.device("cpu"))
    return request.param, film0, film1, res0, res1, events


def test_spans_of_a_traced_frame(traced):
    case, _f0, _f1, _r0, _r1, events = traced
    counts = {}
    for name, _s, _e in events:
        counts[name] = counts.get(name, 0) + 1
    assert counts == CASES[case][3]


def test_spans_nest_as_the_code_does(traced):
    *_, events = traced
    by_name = {}
    for name, s, e in events:
        by_name.setdefault(name, []).append((s, e))
    for name, parent in PARENT.items():
        for s, e in by_name.get(name, []):
            assert any(ps <= s and e <= pe for ps, pe in by_name[parent]), \
                (name, parent)
    passes = by_name["rayn.pass"]
    for name in ("rayn.frame.setup", "rayn.resolve.copy",
                 "rayn.resolve.mean"):
        for s, e in by_name[name]:
            assert all(e <= ps or pe <= s for ps, pe in passes), name


def test_film_is_the_same_bits_with_tracing_on(traced):
    _case, film0, film1, res0, res1, _events = traced
    assert all(torch.equal(a, b) for a, b in zip(film0, film1))
    assert all((a == b).all() for a, b in zip(res0[:4], res1[:4]))


def test_stages_do_not_overlap(traced):
    """No two stage spans overlap, so a launch call, and the device time
    of its kernel, falls in one stage alone."""
    *_, events = traced
    stages = sorted((s, e) for n, s, e in events if n in STAGES)
    assert stages
    assert all(b[0] >= a[1] for a, b in zip(stages, stages[1:]))


def test_no_profiler_enters_no_span(monkeypatch):
    """Outside a profiler every span is one shared no-op context, and a
    frame enters no record_function."""
    assert profiling.span("a") is profiling.span("b")

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    render = _frame("spheres")
    render()


def test_checkpointed_frame_spans_each_save(tmp_path):
    """A checkpoint after every pass: one `rayn.frame.checkpoint` a save,
    outside the passes, and the film of the frame without checkpoints."""
    make, res, kw, _ = CASES["spheres"]
    data, static, cam = make(res, device="cpu")
    s = RenderSettings(resolution=res, **kw)

    def render():
        f = renderer.render_frame(data, static, s, cam, frame=3,
                                  checkpoint_path=str(tmp_path / "ck"),
                                  checkpoint_every=1)
        return film_mod.tensors(f), None
    film, _, events, _prof = _traced(render, torch.device("cpu"))
    saves = [(a, b) for n, a, b in events if n == "rayn.frame.checkpoint"]
    passes = [(a, b) for n, a, b in events if n == "rayn.pass"]
    assert len(saves) == 2
    assert all(e <= ps or pe <= s for s, e in saves for ps, pe in passes)
    want, _ = _frame("spheres")()
    assert all(torch.equal(a, b) for a, b in zip(film, want))


@pytest.mark.gpu
def test_film_is_the_same_bits_under_the_profiler_on_the_card():
    """The film on the card, traced and not, bit for bit; and each stage
    of the sorted bounce is on the profiler's device timeline too."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    dev = torch.device("cuda", 0)
    make, _res, _kw, _ = CASES["mandelbox_compacted"]
    res = (64, 32)
    data, static, cam = make(res, device=dev)
    s = RenderSettings(resolution=res, spp=2, rays_per_pass=2048)

    def render():
        f = renderer.render_frame(data, static, s, cam, frame=3)
        return film_mod.tensors(f), film_mod.resolve(f, res, s)
    film0, _ = render()
    film1, _, events, prof = _traced(render, dev)
    assert all(torch.equal(a, b) for a, b in zip(film0, film1))
    device_ms = {a.key: 1e-3 * a.device_time_total
                 for a in prof.key_averages() if a.key.startswith("rayn.")}
    assert {n for n, _s, _e in events} == set(device_ms)
    for name in ("rayn.bounce.sort", "rayn.bounce.intersect",
                 "rayn.bounce.shade", "rayn.bounce.unsort"):
        assert device_ms[name] > 0.0, name
