"""rayn_tpu_torch.utils.rng against rayn_tpu.utils.rng: the port's int64
emulation of the u32 sampler arithmetic must give the same bits as JAX.

Inputs are 4096 (pixel, sample) pairs drawn with a numpy seed, and both
samplers are checked over every set id of the default layout. The
tolerance is zero: sample values must be equal bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rayn_tpu.config import RenderSettings as JSettings
from rayn_tpu.utils import rng as jrng
from rayn_tpu_torch.config import RenderSettings
from rayn_tpu_torch.utils import rng

# The tensors here are small: one torch thread per test worker avoids
# contending with the other pytest workers for the cores.
torch.set_num_threads(1)

N = 4096


def _pairs():
    g = np.random.default_rng(1234)
    pixel = g.integers(0, 1920 * 1080, N).astype(np.int32)
    sample = g.integers(0, 1 << 16, N).astype(np.int32)
    # include the edges of the int32 sample-index range
    sample[:4] = [0, 1, (1 << 31) - 1, (1 << 31) - 2]
    return pixel, sample


@pytest.mark.parametrize("sampler", ["rd", "hash"])
@pytest.mark.parametrize("dim", [1, 2])
def test_samples_bit_exact(sampler, dim):
    pixel, sample = _pairs()
    js = JSettings(sampler=sampler)
    ts = RenderSettings(sampler=sampler)
    frame = 7
    jt = jrng.build_sample_tables(js, frame)
    tt = rng.build_sample_tables(ts, frame)
    jp, jsm = jnp.asarray(pixel), jnp.asarray(sample)
    tp, tsm = torch.from_numpy(pixel), torch.from_numpy(sample)
    n_sets = ts.num_1d_sets if dim == 1 else ts.num_2d_sets
    assert n_sets == (js.num_1d_sets if dim == 1 else js.num_2d_sets)
    jfn = jrng.sample_1d if dim == 1 else jrng.sample_2d
    tfn = rng.sample_1d if dim == 1 else rng.sample_2d
    want = np.stack([np.asarray(jfn(js, jt, k, jsm, jp))
                     for k in range(n_sets)])
    got = np.stack([tfn(ts, tt, k, tsm, tp).numpy() for k in range(n_sets)])
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_hash_and_rd_bits_bit_exact():
    """pcg_hash / hash_combine over full-range u32 words, and _rd_bits with
    set bases past 2^31 (where an int64 product would overflow without
    the 16-bit limbs)."""
    g = np.random.default_rng(99)
    w = g.integers(0, 1 << 32, (3, N), dtype=np.uint64).astype(np.uint32)
    jw = [jnp.asarray(x) for x in w]
    tw = [torch.from_numpy(x.astype(np.int64)) for x in w]
    np.testing.assert_array_equal(
        rng.pcg_hash(tw[0]).numpy().astype(np.uint32),
        np.asarray(jrng.pcg_hash(jw[0])))
    np.testing.assert_array_equal(
        rng.hash_combine(*tw).numpy().astype(np.uint32),
        np.asarray(jrng.hash_combine(*jw)))
    n = g.integers(0, 1 << 31, N).astype(np.int32)
    for base in (0, 12345, (1 << 31) + 17, (1 << 32) - 1):
        for alpha in (rng.A1, rng.A2[0], rng.A2[1]):
            want = np.asarray(jrng._rd_bits(alpha, jnp.uint32(base),
                                            jnp.asarray(n)))
            got = rng._rd_bits(alpha, base, torch.from_numpy(n)).numpy()
            np.testing.assert_array_equal(got.view(np.uint32),
                                          want.view(np.uint32))


def test_set_layout_matches():
    js, ts = JSettings(), RenderSettings()
    for d in range(ts.max_bounces + 1):
        for i in range(ts.nee_light_samples):
            assert rng.set1d_light_pick(ts, d, i) == \
                jrng.set1d_light_pick(js, d, i)
            assert rng.set2d_nee(ts, d, i) == jrng.set2d_nee(js, d, i)
            for m in range(ts.volume_marches):
                assert rng.set1d_vol_pick(ts, d, m, i) == \
                    jrng.set1d_vol_pick(js, d, m, i)
                assert rng.set2d_vol(ts, d, m, i) == \
                    jrng.set2d_vol(js, d, m, i)
        for m in range(ts.volume_marches):
            assert rng.set1d_vol_dist(ts, d, m) == \
                jrng.set1d_vol_dist(js, d, m)
        assert rng.set1d_fresnel(ts, d) == jrng.set1d_fresnel(js, d)
        assert rng.set1d_roulette(ts, d) == jrng.set1d_roulette(js, d)
        assert rng.set2d_diffuse(ts, d) == jrng.set2d_diffuse(js, d)
        assert rng.set2d_spec(ts, d) == jrng.set2d_spec(js, d)
