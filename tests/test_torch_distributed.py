"""The port's multi-process frame farm (rayn_tpu_torch.parallel.
distributed) and the command line's scale-out options on the CPU: two
local processes in a gloo group, as tests/test_distributed.py runs two
JAX processes with a localhost coordinator. Every frame must be the
same bits as the one-process render (the samplers are salted only by
the frame, so where a frame renders does not matter)."""

import os
import socket
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist

from rayn_tpu_torch import cli
from rayn_tpu_torch.config import RenderSettings
from rayn_tpu_torch.parallel import distributed
from rayn_tpu_torch.render import film as film_mod
from rayn_tpu_torch.render import renderer
from rayn_tpu_torch.scene import presets

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(REPO, "tests")
RES = (16, 12)


def settings():
    return RenderSettings(resolution=RES, spp=2, max_bounces=2,
                          volume_marches=1, max_marches=16,
                          max_vis_marches=8, rays_per_pass=RES[0] * RES[1]
                          * 2)


def _worker(argv):
    """Process `pid` of the farm: its share of frames 1-4, saved."""
    pid, nproc, coord, out = int(argv[0]), int(argv[1]), argv[2], argv[3]
    assert distributed.init(coordinator_address=coord, num_processes=nproc,
                            process_id=pid, device="cpu")
    try:
        assert dist.get_world_size() == nproc and dist.get_rank() == pid
        data, static, cam = presets.default_scene(resolution=RES,
                                                  device="cpu")
        got = distributed.render_frames_multiprocess(
            data, static, settings(), cam, frames=range(1, 5),
            per_chip=False)
        for f, film in got:
            torch.save(film_mod.tensors(film),
                       os.path.join(out, f"frame{f}_p{pid}.pt"))
    finally:
        dist.destroy_process_group()


RUN = ("import sys; sys.path.insert(0, sys.argv[1]); "
       "import test_torch_distributed as t; t._worker(sys.argv[2:])")


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_all(cmds, timeout=240):
    """Run the commands as processes at once; fail if one fails or
    hangs, and leave none running."""
    env = {**os.environ, "PYTHONPATH": REPO}
    procs = [subprocess.Popen(c, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, f"process failed:\n{out}\n{err}"
    finally:
        for p in procs:
            p.kill()
            p.wait()


def test_two_process_frame_farm(tmp_path):
    """Two processes with a TCP coordinator on localhost: process p
    renders frames[p::2], each the same bits as render_frame."""
    coord = f"127.0.0.1:{_free_port()}"
    run_all([[sys.executable, "-c", RUN, TESTS, str(pid), "2", coord,
              str(tmp_path)] for pid in range(2)])
    data, static, cam = presets.default_scene(resolution=RES, device="cpu")
    for f in range(1, 5):
        saved = torch.load(tmp_path / f"frame{f}_p{(f - 1) % 2}.pt")
        ref = renderer.render_frame(data, static, settings(), cam, frame=f)
        for a, b in zip(saved, film_mod.tensors(ref), strict=True):
            assert torch.equal(a, b)
    assert len(list(tmp_path.glob("frame*_p*.pt"))) == 4


def test_frames_for_process():
    assert distributed.frames_for_process(range(1, 8), 0, 3) == [1, 4, 7]
    assert distributed.frames_for_process(range(1, 8), 2, 3) == [3, 6]
    assert distributed.frames_for_process([5], 1, 2) == []


def test_init_is_a_no_op_for_one_process(monkeypatch):
    """Like jax.distributed's: no group without a process count above 1
    or torchrun's environment; render_frames_multiprocess then renders
    every frame."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert distributed.init() is False
    assert distributed.init(coordinator_address="127.0.0.1:1",
                            num_processes=1, process_id=0) is False
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert distributed.init() is False
    assert not dist.is_initialized()
    data, static, cam = presets.spheres_scene(resolution=RES, device="cpu")
    got = distributed.render_frames_multiprocess(data, static, settings(),
                                                 cam, [1, 2])
    assert [f for f, _ in got] == [1, 2]


def test_init_needs_a_coordinator_and_a_process_id():
    with pytest.raises(ValueError):
        distributed.init(num_processes=2, process_id=0)
    with pytest.raises(ValueError):
        distributed.init(coordinator_address="127.0.0.1:1", num_processes=2)
    assert not dist.is_initialized()


CLI_ARGS = ["--device", "cpu", "--scene", "spheres", "--width", "16",
            "--height", "12", "--spp", "2", "--bounces", "1",
            "--rays-per-pass", "200"]


def _pngs(d):
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())}


def test_cli_frame_farm_writes_the_one_process_pngs(tmp_path, capsys):
    """`--num-processes 2` as two processes (a FileStore rendezvous):
    together they write the PNGs of a one-process run, byte for byte."""
    argv = CLI_ARGS + ["--frames", "1", "5"]
    assert cli.main(argv + ["--out", str(tmp_path / "one")]) == 0
    store = tmp_path / "store"
    run_all([[sys.executable, "-m", "rayn_tpu_torch", *argv,
              "--num-processes", "2", "--process-id", str(pid),
              "--coordinator", f"file://{store}", "--out",
              str(tmp_path / "farm")] for pid in range(2)])
    one, farm = _pngs(tmp_path / "one"), _pngs(tmp_path / "farm")
    assert len(one) == 4 * 3 and farm == one


@pytest.mark.parametrize("mode", ["rays", "frames"])
def test_cli_multichip_on_one_rank(tmp_path, mode, capsys):
    """`--multichip` without torchrun: a one-rank mesh, which writes the
    PNGs of a run without it, byte for byte."""
    argv = CLI_ARGS + ["--frames", "1", "3"]
    assert cli.main(argv + ["--out", str(tmp_path / "one")]) == 0
    assert cli.main(argv + ["--multichip", "--multichip-mode", mode,
                            "--out", str(tmp_path / "mesh")]) == 0
    assert not dist.is_initialized()
    one, mesh = _pngs(tmp_path / "one"), _pngs(tmp_path / "mesh")
    assert len(one) == 2 * 3 and mesh == one
