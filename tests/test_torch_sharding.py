"""The port's scale-out on the CPU (rayn_tpu_torch.parallel.sharding):
ranks are separate processes in a gloo group whose rendezvous is a
FileStore in the test's directory, as tests/test_distributed.py spawns
its JAX workers. Each rank runs `_worker` (below) and saves what it
rendered; the test holds it against the one-process render.

Gates: a sharded film against the single-device film, `samples` exact
and every other accumulator within atol 2e-5 (only the float32 order of
the sums changes with the rank count; tests/test_sharding.py's gate),
and every rank holding the same bits; whole frames dealt one per rank,
a killed and resumed render, and the frame checkpoints bit for bit.
"""

import dataclasses
import functools
import os
import subprocess
import sys

import pytest
import torch

from rayn_tpu_torch.config import RenderSettings
from rayn_tpu_torch.parallel import distributed, sharding
from rayn_tpu_torch.render import film as film_mod
from rayn_tpu_torch.render import renderer
from rayn_tpu_torch.scene import presets

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(REPO, "tests")
# The rays of a pass per rank: not a multiple of spp, so a pixel's
# samples can fall to two ranks.
PASS = 198


def settings(**change):
    return dataclasses.replace(RenderSettings(
        resolution=(16, 12), spp=4, max_bounces=2, volume_marches=1,
        max_marches=32, max_vis_marches=16, rays_per_pass=PASS), **change)


SCENES = {"spheres": (presets.spheres_scene, {}),
          "default": (presets.default_scene,
                      dict(extra_aovs=("depth", "albedo")))}


def scene(name, path=None):
    """(data, static, camera, settings) of a named case on the CPU, or
    the scene saved at `path` (tests/test_torch_sharding_jax.py)."""
    if path is not None:
        data, static, cam = torch.load(path, weights_only=False)
        return data, static, cam, settings()
    fn, change = SCENES[name]
    s = settings(**change)
    return (*fn(resolution=s.resolution, device="cpu"), s)


@functools.cache
def single_device_film(name):
    """render_frame's film of a named case (frame 1)."""
    data, static, cam, s = scene(name)
    return film_mod.tensors(renderer.render_frame(data, static, s, cam))


# ------------------------------------------------------------ the ranks
def _task_film(mesh, name, path=None):
    data, static, cam, s = scene(name, path)
    f = sharding.render_frame_sharded(data, static, s, cam, frame=1,
                                      mesh=mesh)
    return dict(film=film_mod.tensors(f), shape=mesh.shape,
                tile1=sharding.make_mesh(tile_axis=1, device="cpu").shape,
                dev_index=mesh.dev_index)


def _task_frames(mesh, name, path=None):
    data, static, cam, s = scene(name, path)
    films = sharding.render_frames_per_chip(data, static, s, cam,
                                            range(1, 6), mesh=mesh)
    return dict(films=[film_mod.tensors(f) for f in films])


def _task_resume(mesh, name, ckdir):
    """A render killed after pass 1 on every rank, retried by
    render_frame_resilient from its checkpoint, beside the uninterrupted
    one."""
    data, static, cam, s = scene(name)
    s = dataclasses.replace(s, rays_per_pass=24)
    ref = sharding.render_frame_sharded(data, static, s, cam, mesh=mesh)
    calls = {"n": 0, "resumed_at": None}

    def bomb(p):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("injected preemption")
        if calls["n"] == 3:
            calls["resumed_at"] = p

    renderer._FAIL_HOOK = bomb
    try:
        film = renderer.render_frame_resilient(
            data, static, s, cam, retries=1, mesh=mesh,
            checkpoint_path=os.path.join(ckdir, "ck.npz"),
            checkpoint_every=1)
    finally:
        renderer._FAIL_HOOK = None
    return dict(ref=film_mod.tensors(ref), film=film_mod.tensors(film),
                resumed_at=calls["resumed_at"])


def _task_frames_checkpoint(mesh, name, ckdir):
    """Frames per rank with a checkpoint directory: stopped after the
    first chunk, then run again."""
    data, static, cam, s = scene(name)

    def stop(done, total):
        raise KeyboardInterrupt

    with pytest.raises(KeyboardInterrupt):
        sharding.render_frames_per_chip(data, static, s, cam, range(1, 6),
                                        mesh=mesh, checkpoint_dir=ckdir,
                                        progress=stop)
    progressed = []
    films = sharding.render_frames_per_chip(
        data, static, s, cam, range(1, 6), mesh=mesh, checkpoint_dir=ckdir,
        progress=lambda done, total: progressed.append((done, total)))
    return dict(films=[film_mod.tensors(f) for f in films],
                progressed=progressed, saved=sorted(os.listdir(ckdir)))


TASKS = {"film": _task_film, "frames": _task_frames,
         "resume": _task_resume, "frames_checkpoint": _task_frames_checkpoint}


def _worker(argv):
    """One rank: `rank world store out task args...`. One rank makes a
    one-rank gloo group, so that its collectives run too."""
    import torch.distributed as dist

    rank, world, store, out, task, *args = argv
    rank, world = int(rank), int(world)
    if world == 1:
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                rank=0, world_size=1)
    else:
        assert distributed.init(coordinator_address=f"file://{store}",
                                num_processes=world, process_id=rank,
                                device="cpu")
    try:
        result = TASKS[task](sharding.make_mesh(device="cpu"), *args)
        torch.save(result, os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


RUN = ("import sys; sys.path.insert(0, sys.argv[1]); "
       "import test_torch_sharding as t; t._worker(sys.argv[2:])")


def spawn(tmp_path, world, task, *args, timeout=240):
    """Run `task` on `world` ranks; every rank's result, in rank order.
    A rank that fails or hangs fails the test, and none is left
    running."""
    env = {**os.environ, "PYTHONPATH": REPO}
    store = tmp_path / "store"
    procs = [subprocess.Popen(
        [sys.executable, "-c", RUN, TESTS, str(r), str(world), str(store),
         str(tmp_path), task, *map(str, args)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, f"rank failed:\n{out}\n{err}"
    finally:
        for p in procs:
            p.kill()
            p.wait()
    return [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


def assert_same_bits(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


# ------------------------------------------------------------- the tests
def test_mesh_shapes():
    """Without a process group: one rank, no collective; tile_axis must
    divide the rank count; a missing card raises."""
    m = sharding.make_mesh(device="cpu")
    assert (m.shape, m.rank, m.size, m.group, m.dev_index) == (
        {"tile": 1, "spp": 1}, 0, 1, None, 0)
    assert m.device == torch.device("cpu")
    with pytest.raises(ValueError):
        sharding.make_mesh(tile_axis=2, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            sharding.make_mesh()


def test_pass_window():
    """The pixels a pass splats into: from its first ray's pixel through
    its last one's, clipped to the film."""
    assert sharding.pass_window(0, 396, 4, 192) == (0, 99)
    assert sharding.pass_window(396, 396, 4, 192) == (99, 192)
    assert sharding.pass_window(594, 594, 4, 192) == (148, 192)


@pytest.mark.parametrize("world", [1, 2, 3])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_sharded_film_matches_single_device(tmp_path, name, world):
    """1-3 ranks against render_frame: samples exact, the colour,
    alpha, background, normal and extra accumulators within 2e-5, every
    rank the same bits; the mesh's shape over the ranks."""
    ref = single_device_film(name)
    got = spawn(tmp_path, world, "film", name)
    for r, g in enumerate(got):
        assert g["shape"] == {"tile": world, "spp": 1}
        assert g["tile1"] == {"tile": 1, "spp": world}
        assert g["dev_index"] == r
        assert_same_bits(g["film"], got[0]["film"])
    film = got[0]["film"]
    assert len(film) == len(ref) == 5 + len(SCENES[name][1].get(
        "extra_aovs", ()))
    assert torch.equal(film[4], ref[4])
    for a, b in zip(film, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=2e-5)


def test_frames_per_chip_match_sequential(tmp_path):
    """Five frames over two ranks (chunks 2 + 2 + 1): every rank returns
    every frame, each the same bits as render_frame."""
    data, static, cam, s = scene("spheres")
    got = spawn(tmp_path, 2, "frames", "spheres")
    for f in range(1, 6):
        ref = film_mod.tensors(renderer.render_frame(data, static, s, cam,
                                                     frame=f))
        for g in got:
            assert_same_bits(g["films"][f - 1], ref)
    assert not torch.equal(got[0]["films"][0][0], got[0]["films"][4][0])


def test_sharded_kill_and_resume(tmp_path):
    """Killed after pass 1 on both ranks, the render resumes at pass 1
    from rank 0's checkpoint and equals the uninterrupted sharded film
    bit for bit."""
    got = spawn(tmp_path, 2, "resume", "spheres", tmp_path)
    for g in got:
        assert g["resumed_at"] == 1
        assert_same_bits(g["film"], g["ref"])
    assert_same_bits(got[1]["film"], got[0]["film"])


def test_frames_per_chip_checkpoint_skip_and_resume(tmp_path):
    """Stopped after the first chunk, a farm with a checkpoint directory
    skips the two saved frames and renders the other three (chunks 2 +
    1); every film equals render_frame's."""
    ckdir = tmp_path / "farm"
    ckdir.mkdir()
    got = spawn(tmp_path, 2, "frames_checkpoint", "spheres", ckdir)
    data, static, cam, s = scene("spheres")
    for g in got:
        assert g["progressed"] == [(4, 5), (5, 5)]
        assert g["saved"] == [f"frame_{f}.npz" for f in range(1, 6)]
    for f in range(1, 6):
        ref = film_mod.tensors(renderer.render_frame(data, static, s, cam,
                                                     frame=f))
        for g in got:
            assert_same_bits(g["films"][f - 1], ref)


def test_wrong_mesh_raises():
    """A mesh on another device than the scene's is a ValueError,
    anything but a Mesh a TypeError, on every entry point."""
    data, static, cam, s = scene("spheres")
    other = sharding.Mesh({"tile": 1, "spp": 1}, 0, 1, torch.device("meta"))
    for fn in (renderer.render_frame, renderer.render_frame_resilient,
               sharding.render_frame_sharded):
        with pytest.raises(ValueError):
            fn(data, static, s, cam, mesh=other)
        with pytest.raises(TypeError):
            fn(data, static, s, cam, mesh=object())
    with pytest.raises(ValueError):
        sharding.render_frames_per_chip(data, static, s, cam, [1],
                                        mesh=other)
