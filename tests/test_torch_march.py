"""The port's march kernels (their plain twins on the CPU) against
rayn_tpu.

- march: the plain march at relax 1 and 1.5 against rayn_tpu.ops.march
  (t within rtol/atol 1e-5, the gate of test_torch_intersect), and at
  relax 1.5 against the Pallas kernel in interpret mode on one 1024-lane
  block (tests/test_march_pallas.py holds that kernel to the jnp march
  at relax 1 only).
- march_occlusion: relax 1 and 1.5, with and without the 3.6 bounding-
  sphere clip, against rayn_tpu.ops.march: verdicts equal on >= 99.9% of
  segments (a grazing segment may flip on an ulp).
- march_occlusion_chained: K = 12 segments per ray against the Pallas
  chained kernel in interpret mode on one 1024-lane block: equal.

The JAX march references run op by op (`jax.disable_jit`), so that both
sides round every float32 operation alike (the port's plain march equals
them bit for bit). The segment-queue bounce and the relaxed image are
held to JAX's in test_torch_render.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rayn_tpu.ops import march as jmarch
from rayn_tpu.ops import march_pallas as jpallas
from rayn_tpu.ops import sdf as jsdf
from rayn_tpu_torch.ops import march_cuda
from rayn_tpu_torch.ops import sdf as tsdf

# The tensors here are small: one torch thread per test worker avoids
# contending with the other pytest workers for the cores.
torch.set_num_threads(1)

MB_ARGS = dict(iterations=12, box_fold_l=1.0, sphere_min_rad=0.01,
               sphere_fixed_rad=1.9, scale=-2.1)
DETAIL = 0.5


def _rays(n, seed):
    """Rays from a shell of radius 4.5 aimed into the fractal, t_max 9,
    cone thresholds of a 720p camera, every 10th lane inactive."""
    g = np.random.default_rng(seed)
    o = g.normal(size=(n, 3))
    o = 4.5 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = g.uniform(-1.2, 1.2, (n, 3)) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    f32 = np.float32
    return dict(o=o.astype(f32), d=d.astype(f32),
                t_max=np.full(n, 9.0, f32), eps_abs=np.zeros(n, f32),
                eps_lin=np.full(n, 0.05 * DETAIL * 4.8e-4, f32),
                act=np.arange(n) % 10 != 3)


def _march_pair(r, max_steps, relax, jax_fn, **jax_kw):
    J = {k: jnp.asarray(v) for k, v in r.items()}
    T = {k: torch.from_numpy(v) for k, v in r.items()}
    with jax.disable_jit():
        want = np.asarray(jax_fn(
            jsdf.mandelbox(**MB_ARGS), J["o"], J["d"], J["t_max"],
            5e-5 * DETAIL, J["eps_abs"], J["eps_lin"], max_steps=max_steps,
            active=J["act"], relax=relax, **jax_kw))
    got = march_cuda.march(tsdf.mandelbox(**MB_ARGS), T["o"], T["d"],
                           T["t_max"], 5e-5 * DETAIL, T["eps_abs"],
                           T["eps_lin"], max_steps, T["act"], relax).numpy()
    hits = (want < r["t_max"]) & r["act"]
    assert 0.2 < hits.mean() < 0.95, hits.mean()
    np.testing.assert_array_equal(got < r["t_max"], want < r["t_max"])
    return got, want


@pytest.mark.parametrize("relax", [1.0, 1.5])
def test_march_matches_jax(relax):
    got, want = _march_pair(_rays(512, 3), 48, relax, jmarch.march)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_relaxed_march_matches_pallas_interpret():
    """Interpret mode compiles the kernel body with XLA, which contracts
    a*b+c into FMAs: t moves by ulps, which rays that graze the fractal
    amplify past the gate (6 of these 1024 lanes, by up to 7e-4), so the
    t gate holds on >= 99% of lanes and hits and misses agree on all."""
    got, want = _march_pair(_rays(1024, 4), 32, 1.5, jpallas.march,
                            interpret=True)
    close = np.isclose(got, want, rtol=1e-5, atol=1e-5)
    assert close.mean() >= 0.99, close.mean()


def _segments(shape, seed):
    g = np.random.default_rng(seed)
    start = g.uniform(-3.0, 3.0, shape + (3,)).astype(np.float32)
    d = g.normal(size=shape + (3,)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    end = (start + d * g.uniform(0.2, 6.0, shape + (1,))).astype(np.float32)
    return start, end, g.uniform(size=shape) > 0.1


@pytest.mark.parametrize("relax", [1.0, 1.5])
@pytest.mark.parametrize("bound", [0.0, 3.6])
def test_march_occlusion_matches_jax(relax, bound):
    start, end, act = _segments((4096,), 11)
    want = np.asarray(jmarch.march_occlusion(
        jsdf.mandelbox(**MB_ARGS), jnp.asarray(start), jnp.asarray(end),
        DETAIL, 48, active=jnp.asarray(act), relax=relax,
        bound_radius=bound))
    got = march_cuda.march_occlusion(
        tsdf.mandelbox(**MB_ARGS), torch.from_numpy(start),
        torch.from_numpy(end), DETAIL, 48, torch.from_numpy(act),
        relax=relax, bound_radius=bound).numpy()
    assert want.any() and (~want).any()
    assert (got == want).mean() >= 0.999


def test_chained_occlusion_matches_pallas_interpret():
    start, end, act = _segments((12, 1024), 12)
    want = np.asarray(jpallas.march_occlusion_chained(
        jsdf.mandelbox(**MB_ARGS), jnp.asarray(start), jnp.asarray(end),
        DETAIL, 16, jnp.asarray(act), interpret=True, bound_radius=3.6))
    got = march_cuda.march_occlusion_chained(
        tsdf.mandelbox(**MB_ARGS), torch.from_numpy(start),
        torch.from_numpy(end), DETAIL, 16, torch.from_numpy(act),
        bound_radius=3.6).numpy()
    assert got.shape == (12, 1024) and want.any() and (~want).any()
    np.testing.assert_array_equal(got, want)


def test_march_wrappers_reject_other_devices():
    """A wrapper runs its plain twin only for CPU tensors; anything else
    that is not CUDA is refused, never moved to the CPU."""
    mb = tsdf.mandelbox(**MB_ARGS)
    z3 = torch.zeros((4, 3), device="meta")
    z = torch.zeros((4,), device="meta")
    with pytest.raises(ValueError):
        march_cuda.march(mb, z3, z3, z, 1e-4, z, z, 8, z.bool())
    with pytest.raises(ValueError):
        march_cuda.march_occlusion(mb, z3, z3, DETAIL, 8, z.bool())
    with pytest.raises(ValueError):
        march_cuda.march_occlusion_chained(mb, z3[None], z3[None], DETAIL,
                                           8, z.bool()[None])
    for fn, args in (
            (march_cuda.march_sorted, (z3, z3, z, 1e-4, z, z, 8, z.bool())),
            (march_cuda.march_phased, (z3, z3, z, 1e-4, z, z, 8, z.bool())),
            (march_cuda.march_occlusion_phased,
             (z3, z3, DETAIL, 8, z.bool())),
            (march_cuda.march_occlusion_sorted,
             (z3, z3, DETAIL, 8, z.bool()))):
        with pytest.raises(ValueError):
            fn(mb, *args)

