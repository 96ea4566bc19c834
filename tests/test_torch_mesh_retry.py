"""A failure on one rank of a mesh, retried by every rank together
(rayn_tpu_torch.parallel.sharding, renderer.render_frame_resilient).

Two gloo ranks on the CPU, separate processes whose rendezvous is a
FileStore in the test's directory, with a process-group timeout of 30 s:
a rank that left the others' collective order would make its peer wait
that long and then fail, so a test of a broken retry fails within about
a minute and never hangs. Each case renders the uninterrupted film on
the mesh first, then the same frame with a failure on one rank only:
- the pass hook (`renderer._FAIL_HOOK`) raising on rank 1 alone,
  mid-frame;
- rank 0's checkpoint save raising OSError (only rank 0 saves);
- an error no retry mends (ValueError) on rank 1 alone, which every rank
  raises at once as PassAborted.
Gate: both ranks' films bit for bit with the uninterrupted film.
"""

import datetime
import os
import subprocess
import sys

import pytest
import torch

from rayn_tpu_torch.config import RenderSettings
from rayn_tpu_torch.parallel import sharding
from rayn_tpu_torch.render import checkpoint as ckpt
from rayn_tpu_torch.render import film as film_mod
from rayn_tpu_torch.render import renderer
from rayn_tpu_torch.scene import presets

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(REPO, "tests")
# seconds a collective waits for a peer
GROUP_TIMEOUT = 30


def _scene():
    s = RenderSettings(resolution=(12, 8), spp=4, max_bounces=2,
                       volume_marches=1, max_marches=32, max_vis_marches=16,
                       rays_per_pass=24)
    return (*presets.spheres_scene(resolution=s.resolution, device="cpu"), s)


def _render(mesh, ckdir, **kw):
    data, static, cam, s = _scene()
    return film_mod.tensors(renderer.render_frame_resilient(
        data, static, s, cam, retries=1, mesh=mesh,
        checkpoint_path=os.path.join(ckdir, "ck.npz"), checkpoint_every=2,
        **kw))


def _case_hook(mesh, ckdir):
    """The pass hook raises on rank 1 alone at its pass 3."""
    calls = {"n": 0}

    def bomb(p):
        calls["n"] += 1
        if mesh.rank == 1 and calls["n"] == 4:
            raise RuntimeError("injected failure on rank 1")

    renderer._FAIL_HOOK = bomb
    try:
        return dict(film=_render(mesh, ckdir), calls=calls["n"])
    finally:
        renderer._FAIL_HOOK = None


def _case_save(mesh, ckdir):
    """Rank 0's second checkpoint save raises OSError (a full disk)."""
    save, calls = ckpt.save, {"n": 0}

    def failing_save(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 2:
            raise OSError("injected: no space left on device")
        return save(*a, **kw)

    ckpt.save = failing_save
    try:
        return dict(film=_render(mesh, ckdir), calls=calls["n"])
    finally:
        ckpt.save = save


def _case_abort(mesh, ckdir):
    """A ValueError on rank 1 alone: every rank raises PassAborted."""
    def bomb(p):
        if mesh.rank == 1 and p == 2:
            raise ValueError("injected programming error on rank 1")

    renderer._FAIL_HOOK = bomb
    try:
        _render(mesh, ckdir)
    except sharding.PassAborted as e:
        return dict(aborted=type(e.__cause__).__name__)
    finally:
        renderer._FAIL_HOOK = None
    return dict(aborted=None)


CASES = {"hook": _case_hook, "save": _case_save, "abort": _case_abort}


def _worker(argv):
    """One rank: `rank world store out case`."""
    import torch.distributed as dist

    rank, world, store, out, case = argv
    rank, world = int(rank), int(world)
    dist.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT))
    try:
        mesh = sharding.make_mesh(device="cpu")
        data, static, cam, s = _scene()
        ref = film_mod.tensors(renderer.render_frame(data, static, s, cam,
                                                     mesh=mesh))
        ckdir = os.path.join(out, "ck")
        os.makedirs(ckdir, exist_ok=True)
        got = CASES[case](mesh, ckdir)
        torch.save(dict(ref=ref, **got), os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


RUN = ("import sys; sys.path.insert(0, sys.argv[1]); "
       "import test_torch_mesh_retry as t; t._worker(sys.argv[2:])")


def _spawn(tmp_path, case, world=2, timeout=4 * GROUP_TIMEOUT):
    """Every rank's result, in rank order; a rank that fails or outlasts
    `timeout` fails the test, and none is left running."""
    env = {**os.environ, "PYTHONPATH": REPO}
    procs = [subprocess.Popen(
        [sys.executable, "-c", RUN, TESTS, str(r), str(world),
         str(tmp_path / "store"), str(tmp_path), case],
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


@pytest.mark.parametrize("case", ["hook", "save"])
def test_one_rank_failure_is_retried_by_every_rank(tmp_path, case):
    """A failure on one rank only: both ranks retry from rank 0's
    checkpoint and end with the uninterrupted film, bit for bit."""
    got = _spawn(tmp_path, case)
    for r in got:
        assert len(r["film"]) == len(r["ref"])
        for a, b in zip(r["film"], r["ref"]):
            assert torch.equal(a, b)
        assert r["ref"][film_mod.CHANNELS.index("samples")].sum() == (
            12 * 8 * 4)
    assert got[0]["calls"] > (2 if case == "save" else 4)


def test_unmendable_failure_aborts_every_rank(tmp_path):
    """A ValueError on rank 1 alone is raised as PassAborted on both
    ranks at the same pass, chained to rank 1's own error, and neither
    retries."""
    got = _spawn(tmp_path, "abort")
    assert [r["aborted"] for r in got] == ["NoneType", "ValueError"]


def test_one_rank_mesh_raises_the_error_itself():
    """Without a process group the pass body's own error propagates,
    as render_frame without a mesh."""
    data, static, cam, s = _scene()

    def bomb(p):
        raise ValueError("boom")

    renderer._FAIL_HOOK = bomb
    try:
        with pytest.raises(ValueError, match="boom"):
            renderer.render_frame(data, static, s, cam,
                                  mesh=sharding.make_mesh(device="cpu"))
    finally:
        renderer._FAIL_HOOK = None


def test_status_word_rides_in_the_window():
    """The pass's status word is a view of a per-device constant (no
    launch of its own): 0 for no error, 1 for a transient one, more than
    any rank count for one no retry mends."""
    cpu = torch.device("cpu")
    words = [float(sharding._word(e, cpu)) for e in (
        None, RuntimeError("x"), OSError("x"), ValueError("x"),
        NotImplementedError("x"))]
    assert words[:3] == [0.0, 1.0, 1.0]
    assert words[3] == words[4] == sharding._ABORT > 1 << 16
    assert sharding._word(None, cpu).data_ptr() == sharding._word(
        None, cpu).data_ptr()
    with pytest.raises(sharding.PassFailed):
        sharding._raise_if_failed(1.0, None, "x")
    with pytest.raises(sharding.PassAborted):
        sharding._raise_if_failed(sharding._ABORT + 1.0, None, "x")
