"""The harness finds every piece of a cell by name, from data files."""

import json
import re

import pytest
import torch

from benchmark import harness, program
from benchmark.tests.helpers import ROOT, load_json, run_cell, tiny_root

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_cell_added_as_data_files_runs_unchanged(tmp_path):
    """A configuration, a traffic mix, a check file and a BENCHMARK.json
    entry, and no code: the harness runs the cell, traced, and judges it."""
    root = tiny_root(tmp_path, cell="added_cell")
    rc, out = run_cell(root, "added_cell", trace=True)
    assert rc == 0
    assert out["correct"] is True
    assert list(out)[-1] == "check"
    assert set(out["check"]) == {"err_median", "diverged_share"}
    assert out["metrics"]["resolve_ms"]["unit"] == "ms"
    assert out["device"]["window_s"] > 0


def test_untraced_run_reports_the_end_to_end_metrics(tmp_path):
    root = tiny_root(tmp_path)
    rc, out = run_cell(root, "tiny_cell")
    assert rc == 0 and out["correct"] is True
    want = {m["name"] for m in load_json("BENCHMARK.json")["end_to_end"]}
    assert set(out["metrics"]) == want
    assert out["metrics"]["msamples_per_s"]["value"] > 0
    assert out["attempted"] >= 1 and out["failed"] == 0


def test_benchmark_json_follows_the_contract():
    bench = load_json("BENCHMARK.json")
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"]
    names = [c["name"] for c in bench["configs"]]
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert 1 <= len(c["why"]) <= 200 and "\n" not in c["why"]
        assert NAME.match(c["name"]) and c["file"].startswith("benchmark/")
        assert load_json(c["file"])["name"] == c["name"]
    cells = bench["workloads"]
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["config"] in names
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        harness.load_cell(w["name"])   # every data file is there
    metrics = bench["end_to_end"] + bench["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert "setup_s" in {m["name"] for m in bench["end_to_end"]}
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in bench["per_layer"]:
        mod = harness.load_metric(
            m["name"], ROOT / "benchmark" / "metrics" / f"{m['name']}.py")
        assert (mod.UNIT, mod.LAYER, mod.MOVES) == (
            m["unit"], m["layer"], m["moves"])
    assert len(json.dumps(bench)) < 64 * 1024


@pytest.mark.parametrize("name", ["rayn_default"])
def test_configuration_transcribes_its_preset(name):
    """The configuration's scene, built from data, is the preset's."""
    from rayn_tpu_torch.scene import presets
    cfg = load_json(f"benchmark/configs/{name}.json")
    res = tuple(cfg["settings"]["resolution"])
    want = presets.default_scene(res, device="cpu")
    got = program.build_scene(cfg, "cpu")

    def leaves(x):
        if isinstance(x, torch.Tensor):
            return [x]
        if isinstance(x, (float, int, bool, str)) or x is None:
            return [x]
        if hasattr(x, "_asdict"):
            return [v for f in x._asdict().values() for v in leaves(f)]
        if isinstance(x, (tuple, list)):
            return [v for f in x for v in leaves(f)]
        return [v for f in vars(x).values() for v in leaves(f)]

    for a, b in zip(got, want):
        la, lb = leaves(a), leaves(b)
        assert len(la) == len(lb)
        for u, v in zip(la, lb):
            if isinstance(u, torch.Tensor):
                assert torch.equal(u, v)
            else:
                assert u == v


def test_spheres_configuration_is_the_books_scene():
    """rtiow_spheres builds the five spheres of the book's scene (the
    hollow sphere's inner surface a bubble of ior 1/1.5) inside the world
    sphere, with no light, SDF or volume, and the book's camera."""
    cfg = load_json("benchmark/configs/rtiow_spheres.json")
    data, static, camera = program.build_scene(cfg, "cpu")
    assert static.n_spheres == 6 and static.n_lights == 0
    assert not static.has_sdf
    radii = data.sphere_radii.tolist()
    assert radii == pytest.approx([100.0, 100.0, 0.5, 0.5, 0.45, 0.5])
    ior = data.materials.ior[data.sphere_mats.long()].tolist()
    assert ior[3] == 1.5 and abs(ior[4] - 1 / 1.5) < 1e-7
    assert camera.origin.sample(torch.zeros(1)).tolist() == [[-2.0, 2.0,
                                                              1.0]]


def test_settings_keep_every_render_field():
    for name in ("rayn_default", "rtiow_spheres"):
        cfg = load_json(f"benchmark/configs/{name}.json")
        s = program.settings_of(cfg)
        assert s.resolution == (1280, 720) and s.spp == 8
        assert s.max_bounces == 3 and s.volume_marches == 2
    with pytest.raises(ValueError):
        program.settings_of(dict(cfg, settings=dict(cfg["settings"],
                                                    bogus=1)))
