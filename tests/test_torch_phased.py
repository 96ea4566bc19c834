"""The port's two-phase marches (march_sorted, march_phased,
march_occlusion_phased, march_occlusion_sorted; their kernels' plain
twins on the CPU) against its single-phase marches and against rayn_tpu.

- Every split of phase 1 and the resume, 0 and past max_steps included:
  each function equals the port's single-phase twin bit for bit (the
  march by int32 view; the occlusion ones against march_occlusion with no
  bounding-sphere clip, which is how the JAX functions march).
- The marches are one launch of the march kernel: on the CPU the
  functions run march_plain, and their one-piece plain versions
  (march_sorted_plain, march_phased_plain), which keep the TPU schedule
  (phase 1, the lane order, the resume), equal it bit for bit at every
  split.
- The occlusion functions are the enqueue kernel and the refill march,
  with JAX's first-DE entry at split 0. Their composed twins
  (enqueue_plain -> occlusion_march_plain, unclipped) equal the
  one-piece plain versions, which keep the TPU schedule (phase 1, the
  lane order, the resume), bit for bit at every split, on random
  segments and on segments that start on the fractal's surface; at
  splits >= 1 both equal march_occlusion_plain with no clip.
- Against the JAX functions in interpret mode at splits 1 and 8:
  occlusion verdicts equal; for the march's one-piece plain versions,
  hits and misses equal and t within rtol/atol 1e-5 on >= 99% of lanes
  (the gate of test_torch_march.test_relaxed_march_matches_pallas_interpret:
  interpret mode contracts a*b+c into FMAs). At split 0 the occlusion
  verdict of a segment is JAX's `first DE < 1e-4`, held on segments that
  start on the fractal's surface. The one-piece plain occlusion versions
  equal the JAX functions at splits 1 and 8 too.
- intersect.test_occluded with `occl_sort_steps` ignores
  `shadow_bv_clip`, as the JAX package does: its verdicts equal the
  sphere fold plus JAX's unclipped march_occlusion_sorted.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rayn_tpu.ops import march_pallas as jpallas
from rayn_tpu.ops import sdf as jsdf
from rayn_tpu.ops import spheres as jspheres
from rayn_tpu.scene import presets as jpresets
from rayn_tpu.scene.scene import sphere_centers_at as jcenters_at
from rayn_tpu_torch import convert
from rayn_tpu_torch.config import RenderSettings
from rayn_tpu_torch.ops import intersect, march_cuda
from rayn_tpu_torch.ops import sdf as tsdf
from test_torch_march import DETAIL, MB_ARGS, _rays, _segments

# The tensors here are small: one torch thread per test worker avoids
# contending with the other pytest workers for the cores.
torch.set_num_threads(1)

N = 1024          # one 8 x 128 block of the Pallas kernels
MAX_STEPS = 32
MARCHES = ("march_sorted", "march_phased")
OCCLUSIONS = ("march_occlusion_phased", "march_occlusion_sorted")
EPS_CONST = 5e-5 * DETAIL


@functools.lru_cache(maxsize=None)
def _march_inputs():
    return _rays(N, 4)


@functools.lru_cache(maxsize=None)
def _occl_inputs():
    return _segments((N,), 11)


@functools.lru_cache(maxsize=None)
def _surface_inputs():
    """(start, end, active) of 256 segments that start where the rays
    of _march_inputs hit the fractal, 0.2-3 long in random directions."""
    r = _march_inputs()
    t = _single_phase("march")
    on = (t < r["t_max"]) & r["act"]
    start = (r["o"] + t[:, None] * r["d"])[on][:256]
    g = np.random.default_rng(5)
    d = g.normal(size=start.shape)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    end = (start + d * g.uniform(0.2, 3.0, (len(start), 1))).astype(
        np.float32)
    return start.astype(np.float32), end, g.uniform(size=len(start)) > 0.1


INPUTS = {"random": _occl_inputs, "surface": _surface_inputs}


def _port(name, split, max_steps=MAX_STEPS, inputs=None):
    """The port's two-phase function `name`, or its one-piece plain
    version `name`_plain (numpy result)."""
    mb, fn = tsdf.mandelbox(**MB_ARGS), getattr(march_cuda, name)
    if name.removesuffix("_plain") in MARCHES:
        r = {k: torch.from_numpy(v) for k, v in _march_inputs().items()}
        return fn(mb, r["o"], r["d"], r["t_max"], EPS_CONST, r["eps_abs"],
                  r["eps_lin"], max_steps, r["act"],
                  phase1_steps=split).numpy()
    start, end, act = inputs or _occl_inputs()
    return fn(mb, torch.from_numpy(start), torch.from_numpy(end), DETAIL,
              max_steps, torch.from_numpy(act), phase1_steps=split).numpy()


def _jax(name, split, inputs=None):
    """JAX's function `name` in interpret mode on the same inputs."""
    mb, fn = jsdf.mandelbox(**MB_ARGS), getattr(jpallas, name)
    if name in MARCHES:
        r = {k: jnp.asarray(v) for k, v in _march_inputs().items()}
        return np.asarray(fn(mb, r["o"], r["d"], r["t_max"], EPS_CONST,
                             r["eps_abs"], r["eps_lin"], MAX_STEPS, r["act"],
                             phase1_steps=split, interpret=True))
    start, end, act = inputs or _occl_inputs()
    return np.asarray(fn(mb, jnp.asarray(start), jnp.asarray(end), DETAIL,
                         MAX_STEPS, jnp.asarray(act), phase1_steps=split,
                         interpret=True))


@functools.lru_cache(maxsize=None)
def _jax_default(name, split):
    """_jax on the default inputs, once per worker."""
    return _jax(name, split)


@functools.lru_cache(maxsize=None)
def _one_piece_march(name, split):
    """The march `name`'s one-piece plain version on the default inputs,
    once per worker."""
    return _port(name + "_plain", split)


@functools.lru_cache(maxsize=None)
def _single_phase(kind):
    mb = tsdf.mandelbox(**MB_ARGS)
    if kind == "march":
        r = {k: torch.from_numpy(v) for k, v in _march_inputs().items()}
        return march_cuda.march(mb, r["o"], r["d"], r["t_max"], EPS_CONST,
                                r["eps_abs"], r["eps_lin"], MAX_STEPS,
                                r["act"]).numpy()
    start, end, act = _occl_inputs()
    return march_cuda.march_occlusion(
        mb, torch.from_numpy(start), torch.from_numpy(end), DETAIL,
        MAX_STEPS, torch.from_numpy(act), bound_radius=0.0).numpy()


@pytest.mark.parametrize("split", [0, 1, 8, MAX_STEPS, MAX_STEPS + 20])
@pytest.mark.parametrize("name", MARCHES + OCCLUSIONS)
def test_two_phase_equals_single_phase(name, split):
    got = _port(name, split)
    if name in MARCHES:
        want = _single_phase("march")
        hits = want < _march_inputs()["t_max"]
        assert 0.2 < hits.mean() < 0.95, hits.mean()
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
        one_piece = _one_piece_march(name, split)
        np.testing.assert_array_equal(one_piece.view(np.int32),
                                      want.view(np.int32))
    else:
        want = _single_phase("occlusion")
        assert want.any() and (~want).any()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("split", [1, 8])
@pytest.mark.parametrize("name", MARCHES + OCCLUSIONS)
def test_two_phase_matches_pallas_interpret(name, split):
    if name in OCCLUSIONS:
        np.testing.assert_array_equal(_port(name, split),
                                      _jax_default(name, split))
        return
    got, want = _one_piece_march(name, split), _jax_default(name, split)
    t_max = _march_inputs()["t_max"]
    np.testing.assert_array_equal(got < t_max, want < t_max)
    close = np.isclose(got, want, rtol=1e-5, atol=1e-5)
    assert close.mean() >= 0.99, close.mean()


def test_occlusion_split_zero_takes_the_first_de_verdict():
    """With no phase-1 step a segment is occluded where its first DE is
    below 1e-4 (march_pallas.py:518), not where a step would hit: on
    segments that start on the fractal's surface, the port's phased
    occlusion at split 0 equals JAX's."""
    inputs = _surface_inputs()
    dist0 = tsdf.dist_c(tsdf.mandelbox(**MB_ARGS),
                        *torch.from_numpy(inputs[0]).T).numpy()
    assert (dist0 < 1e-4).sum() >= 16
    got = _port("march_occlusion_phased", 0, inputs=inputs)
    np.testing.assert_array_equal(
        got, _jax("march_occlusion_phased", 0, inputs=inputs))
    # the rule differs from a first step's verdict on these segments
    assert (got != _port("march_occlusion_phased", 1, inputs=inputs)).any()


def test_occluded_two_phase_route_is_unclipped():
    """A segment-major queue of 8 x 128 segments on the default scene,
    with `shadow_bv_clip=True` and `occl_sort_steps=8`: visibility equals
    the JAX sphere fold plus JAX's unclipped march_occlusion_sorted of
    the unblocked segments."""
    jdata, jstatic, _ = jpresets.default_scene(resolution=(8, 8))
    tdata, tstatic = convert.scene(jax.tree.map(np.asarray, jdata), jstatic,
                                   sdf_iterations=12, device="cpu")
    start, end, act = _segments((8, 128), 21)
    start, end, act = start.reshape(-1, 3), end.reshape(-1, 3), act.ravel()
    s = RenderSettings(max_vis_marches=MAX_STEPS, shadow_bv_clip=True,
                       occl_sort_steps=8)
    time = np.zeros(N, np.float32)
    got = intersect.test_occluded(
        tdata, tstatic, s, torch.from_numpy(start), torch.from_numpy(end),
        torch.from_numpy(time), torch.from_numpy(act), segments=8).numpy()
    sph = np.asarray(jspheres.occluded(
        jnp.asarray(start), jnp.asarray(end),
        jcenters_at(jdata, jnp.asarray(time)), jdata.sphere_radii)).any(1)
    (prog, _mat, _bv), = jstatic.sdf_instances(jdata)
    sdf = np.asarray(jpallas.march_occlusion_sorted(
        prog, jnp.asarray(start), jnp.asarray(end), DETAIL, MAX_STEPS,
        jnp.asarray(act & ~sph), phase1_steps=8, interpret=True))
    assert sph.any() and sdf.any()
    np.testing.assert_array_equal(got, np.where(sph | sdf, 0.0, 1.0))


@pytest.mark.parametrize("inputs", sorted(INPUTS))
@pytest.mark.parametrize("split", [0, 1, 8, MAX_STEPS, MAX_STEPS + 20])
@pytest.mark.parametrize("name", OCCLUSIONS)
def test_occlusion_twins_equal_one_piece_plain(name, split, inputs):
    """The function on the CPU, and its twins composed by hand, equal
    the one-piece plain version bit for bit; at splits >= 1 also the
    unclipped single-phase march."""
    mb = tsdf.mandelbox(**MB_ARGS)
    start, end, act = (torch.from_numpy(a) for a in INPUTS[inputs]())
    head = (mb, start, end, DETAIL, MAX_STEPS)
    queue, count = march_cuda.enqueue_plain(act)
    composed = march_cuda.occlusion_march_plain(*head, queue, count,
                                                first_de=split == 0)
    got = getattr(march_cuda, name)(*head, act, phase1_steps=split)
    want = getattr(march_cuda, name + "_plain")(*head, act,
                                                phase1_steps=split)
    assert want.any() and (~want & act).any()
    assert torch.equal(composed, want) and torch.equal(got, want)
    if split >= 1:
        assert torch.equal(want, march_cuda.march_occlusion_plain(
            *head, act, bound_radius=0.0))


@pytest.mark.parametrize("split", [1, 8])
@pytest.mark.parametrize("name", OCCLUSIONS)
def test_one_piece_plain_occlusion_matches_pallas_interpret(name, split):
    mb = tsdf.mandelbox(**MB_ARGS)
    start, end, act = (torch.from_numpy(a) for a in _occl_inputs())
    got = getattr(march_cuda, name + "_plain")(mb, start, end, DETAIL,
                                               MAX_STEPS, act,
                                               phase1_steps=split)
    np.testing.assert_array_equal(got.numpy(), _jax_default(name, split))
