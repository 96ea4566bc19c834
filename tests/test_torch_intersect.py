"""The port's fused closest-hit + shading (its plain twin on the CPU)
against rayn_tpu's unfused intersect.closest_hit + shading_info.

Camera rays come from JAX's generate_rays and reach both packages as
numpy. The gates are the JAX package's own fused-vs-unfused gates
(tests/test_fused_intersect.py:52-68): object ids, validity and
materials equal; t within rtol/atol 1e-5; points within rtol 1e-4 /
atol 1e-5; normals within rtol 1e-3 / atol 2e-4 (four-tap differences
of the DE amplify ulps); offsets within rtol 1e-4 / atol 1e-7.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rayn_tpu.config import RenderSettings as JSettings
from rayn_tpu.ops import filters as jfilters
from rayn_tpu.ops import intersect as jintersect
from rayn_tpu.render import renderer as jrenderer
from rayn_tpu.scene import presets as jpresets
from rayn_tpu.utils import rng as jrng
from rayn_tpu_torch import convert
from rayn_tpu_torch.config import RenderSettings
from rayn_tpu_torch.ops import intersect, intersect_cuda, march
from rayn_tpu_torch.ops import sdf as tsdf

# The tensors here are small: one torch thread per test worker avoids
# contending with the other pytest workers for the cores.
torch.set_num_threads(1)

N = 1024
RES = (32, 32)


def _setup():
    js = JSettings(resolution=RES, spp=4, max_marches=64, rays_per_pass=N)
    ts = RenderSettings(resolution=RES, spp=4, max_marches=64,
                        rays_per_pass=N)
    jdata, jstatic, jcam = jpresets.default_scene(resolution=RES)
    tdata, tstatic = convert.scene(jax.tree.map(np.asarray, jdata), jstatic,
                                   sdf_iterations=12, device="cpu")
    tables = jrng.build_sample_tables(js, frame=1)
    fis = jfilters.build_fis_table(jfilters.blackman_harris(1.5), 512)
    o, d, tm, _px, _si, in_range = jrenderer.generate_rays(
        js, tables, jcam, fis, jrenderer.ray_indices(jnp.int32(0), N),
        jnp.float32(1 / 24), jnp.float32(2 / 24))
    ha, hl = jcam.half_pixel_size_coeffs()
    rays = dict(o=np.array(o), d=np.array(d), tm=np.array(tm),
                act=np.array(in_range),
                ha=np.full(N, np.asarray(ha), np.float32),
                hl=np.full(N, np.asarray(hl), np.float32))
    # deactivate a few lanes so the inactive path is exercised too
    rays["act"][::17] = False
    return (js, jdata, jstatic), (ts, tdata, tstatic), rays


def _jax_ref(js, jdata, jstatic, r):
    j = {k: jnp.asarray(v) for k, v in r.items()}
    t_max = jnp.full((N,), 2.0 * js.world_radius, jnp.float32)
    hit = jintersect.closest_hit(jdata, jstatic, js, j["o"], j["d"],
                                 j["tm"], t_max, j["ha"], j["hl"], j["act"])
    info = jintersect.shading_info(jdata, jstatic, js, hit, j["o"], j["d"],
                                   j["tm"], j["ha"], j["hl"])
    return hit, info


def _check(hit, info, hit_ref, info_ref):
    A = np.asarray
    np.testing.assert_array_equal(hit.valid.numpy(), A(hit_ref.valid))
    np.testing.assert_array_equal(hit.obj.numpy(), A(hit_ref.obj))
    np.testing.assert_allclose(hit.t.numpy(), A(hit_ref.t), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(info.mat.numpy(), A(info_ref.mat))
    np.testing.assert_allclose(info.point.numpy(), A(info_ref.point),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(info.normal.numpy(), A(info_ref.normal),
                               rtol=1e-3, atol=2e-4)
    np.testing.assert_allclose(info.offset_by.numpy(), A(info_ref.offset_by),
                               rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("path", ["fused", "unfused"])
def test_closest_hit_matches_jax(path):
    """`fused`: intersect_cuda.closest_hit_shading (CPU tensors -> its plain
    twin); `unfused`: the port's intersect.closest_hit + shading_info."""
    (js, jdata, jstatic), (ts, tdata, tstatic), r = _setup()
    hit_ref, info_ref = _jax_ref(js, jdata, jstatic, r)
    t = {k: torch.from_numpy(v) for k, v in r.items()}
    if path == "fused":
        hit, info = intersect_cuda.closest_hit_shading(
            tdata, tstatic, ts, t["o"], t["d"], t["ha"], t["hl"], t["act"])
    else:
        t_max = torch.full((N,), 2.0 * ts.world_radius)
        hit = intersect.closest_hit(tdata, tstatic, ts, t["o"], t["d"],
                                    t["tm"], t_max, t["ha"], t["hl"],
                                    t["act"])
        info = intersect.shading_info(tdata, tstatic, ts, hit, t["o"],
                                      t["d"], t["tm"], t["ha"], t["hl"])
    _check(hit, info, hit_ref, info_ref)


def test_occlusion_march_matches_jax():
    """march_occlusion with the bounding-sphere clip against JAX's plain
    march_occlusion on random shadow segments: verdicts equal on
    >= 99.9% of segments (a grazing segment may flip on an ulp)."""
    from rayn_tpu.ops import march as jmarch
    from rayn_tpu.ops import sdf as jsdf
    g = np.random.default_rng(11)
    n = 4096
    start = g.uniform(-3.0, 3.0, (n, 3)).astype(np.float32)
    d = g.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    end = (start + d * g.uniform(0.2, 6.0, (n, 1))).astype(np.float32)
    act = g.uniform(size=n) > 0.1
    args = dict(iterations=12, box_fold_l=1.0, sphere_min_rad=0.01,
                sphere_fixed_rad=1.9, scale=-2.1)
    want = np.asarray(jmarch.march_occlusion(
        jsdf.mandelbox(**args), jnp.asarray(start), jnp.asarray(end), 0.5,
        48, active=jnp.asarray(act), bound_radius=3.6))
    got = march.march_occlusion(
        tsdf.mandelbox(**args), torch.from_numpy(start),
        torch.from_numpy(end), 0.5, 48, torch.from_numpy(act),
        bound_radius=3.6).numpy()
    assert want.any() and (~want).any()
    assert (got == want).mean() >= 0.999
