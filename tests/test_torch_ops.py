"""rayn_tpu_torch scene math against rayn_tpu on the CPU.

Every input is drawn from a numpy seed and handed to both packages as
numpy; outputs must agree with rtol 1e-5 (float32 arithmetic in the same
order; the atol stated per check covers values near zero). The scene
converted from JAX must equal the port's own default_scene exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rayn_tpu.config import RenderSettings as JSettings
from rayn_tpu.ops import bsdf as jbsdf
from rayn_tpu.ops import filters as jfilters
from rayn_tpu.ops import lights as jlights
from rayn_tpu.ops import sdf as jsdf
from rayn_tpu.ops import spheres as jspheres
from rayn_tpu.scene import presets as jpresets
from rayn_tpu.scene.scene import Materials as JMaterials
from rayn_tpu_torch import convert
from rayn_tpu_torch.config import RenderSettings
from rayn_tpu_torch.ops import bsdf, filters, lights, sdf, spheres
from rayn_tpu_torch.scene import presets
from rayn_tpu_torch.scene.scene import Materials

# The tensors here are small: one torch thread per test worker avoids
# contending with the other pytest workers for the cores.
torch.set_num_threads(1)

N = 2048
RTOL = 1e-5


def _rng(seed=0):
    return np.random.default_rng(seed)


def _unit(g, n):
    v = g.normal(size=(n, 3)).astype(np.float32)
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _close(got, want, atol=1e-6, rtol=RTOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def _mb_pair():
    args = dict(iterations=12, box_fold_l=1.0, sphere_min_rad=0.01,
                sphere_fixed_rad=1.9, scale=-2.1)
    return jsdf.mandelbox(**args), sdf.mandelbox(**args)


def test_mandelbox_de_and_normal():
    g = _rng(1)
    p = g.uniform(-3.0, 3.0, (N, 3)).astype(np.float32)
    jmb, tmb = _mb_pair()
    _close(sdf.dist(tmb, torch.from_numpy(p)), jmb.dist(jnp.asarray(p)))
    eps = g.uniform(1e-4, 1e-2, N).astype(np.float32)
    _close(sdf.tetrahedral_normal(tmb, torch.from_numpy(p),
                                  torch.from_numpy(eps)),
           jsdf.tetrahedral_normal(jmb, jnp.asarray(p), jnp.asarray(eps)),
           atol=1e-5)


def test_sphere_hit_and_occlusion():
    g = _rng(2)
    k = 6
    o = g.uniform(-2.0, 2.0, (N, 3)).astype(np.float32)
    d = _unit(g, N)
    centers = g.uniform(-1.5, 1.5, (N, k, 3)).astype(np.float32)
    radii = g.uniform(0.1, 1.0, k).astype(np.float32)
    t_max = np.full(N, 200.0, np.float32)
    t = [torch.from_numpy(a) for a in (o, d, centers, radii, t_max)]
    j = [jnp.asarray(a) for a in (o, d, centers, radii, t_max)]
    _close(spheres.hit(*t), jspheres.hit(*j))
    end = (o + d * g.uniform(0.1, 4.0, (N, 1))).astype(np.float32)
    np.testing.assert_array_equal(
        spheres.occluded(t[0], torch.from_numpy(end), t[2], t[3]).numpy(),
        np.asarray(jspheres.occluded(j[0], jnp.asarray(end), j[2], j[3])))


def test_sample_cone_and_equi_angular():
    g = _rng(3)
    u = g.uniform(0.0, 1.0, (N, 2)).astype(np.float32)
    lp = g.uniform(-2.0, 2.0, (N, 3)).astype(np.float32)
    lr = g.uniform(0.1, 0.3, N).astype(np.float32)
    p = (lp + _unit(g, N) * g.uniform(0.5, 5.0, (N, 1))).astype(np.float32)
    em = g.uniform(0.0, 40.0, (N, 3)).astype(np.float32)
    tt = [torch.from_numpy(a) for a in (u, lp, lr, p, em)]
    jj = [jnp.asarray(a) for a in (u, lp, lr, p, em)]
    for got, want in zip(lights.sample_cone(*tt), jlights.sample_cone(*jj)):
        _close(got, want, atol=1e-5)
    o = g.uniform(-3.0, 3.0, (N, 3)).astype(np.float32)
    d = _unit(g, N)
    tmax = g.uniform(0.5, 50.0, N).astype(np.float32)
    args = (u[:, 0], lp, o, d, tmax)
    for got, want in zip(
            lights.sample_equi_angular(*(torch.from_numpy(a) for a in args)),
            jlights.sample_equi_angular(*(jnp.asarray(a) for a in args))):
        _close(got, want, atol=1e-5)


def _materials(g):
    """One material of each of the six kinds."""
    kind = np.arange(6, dtype=np.int32)
    ca = g.uniform(0.05, 0.95, (6, 3)).astype(np.float32)
    cb = g.uniform(0.0, 3.0, (6, 3)).astype(np.float32)
    power = np.array([0.0, 8.68, 0.0, 0.0, 120.0, 0.0], np.float32)
    ior = np.array([1.0, 1.0, 1.0, 1.0, 1.0, 1.5], np.float32)
    cols = (kind, ca, cb, power, ior)
    return (JMaterials(*(jnp.asarray(c) for c in cols)),
            Materials(*(torch.from_numpy(c) for c in cols)))


@pytest.mark.parametrize("compat", [False, True])
def test_bsdf_eval_and_scatter_all_kinds(compat):
    g = _rng(4)
    jm, tm = _materials(g)
    mid = (np.arange(N) % 6).astype(np.int32)
    jp, tp = jbsdf.gather(jm, jnp.asarray(mid)), bsdf.gather(
        tm, torch.from_numpy(mid))
    for a, b in zip(tp, jp):
        _close(a, b, atol=0.0, rtol=0.0)
    n = _unit(g, N)
    wo = _unit(g, N)
    wo = np.where(np.sum(wo * n, -1, keepdims=True) < 0, -wo, wo)
    wo[::7] = -wo[::7]   # some rays arrive from behind (refraction exits)
    wi = _unit(g, N)
    uf = g.uniform(0.0, 1.0, N).astype(np.float32)
    ud = g.uniform(0.0, 1.0, (N, 2)).astype(np.float32)
    us = g.uniform(0.0, 1.0, (N, 2)).astype(np.float32)
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    _close(bsdf.eval_f(tp, T(wo), T(wi), T(n)),
           jbsdf.eval_f(jp, jnp.asarray(wo), jnp.asarray(wi), jnp.asarray(n)),
           atol=1e-5)
    _close(bsdf.receives_light(tp), jbsdf.receives_light(jp), 0.0, 0.0)
    _close(bsdf.emitted(tp, T(wo)), jbsdf.emitted(jp, jnp.asarray(wo)))
    ts = RenderSettings(compat_spec_reflect=compat, compat_spec_phi=compat)
    js = JSettings(compat_spec_reflect=compat, compat_spec_phi=compat)
    got = bsdf.scatter(tp, ts, T(wo), T(n), T(uf), T(ud), T(us))
    want = jbsdf.scatter(jp, js, jnp.asarray(wo), jnp.asarray(n),
                         jnp.asarray(uf), jnp.asarray(ud), jnp.asarray(us))
    for a, b in zip(got, want):
        _close(a, b, atol=1e-5)


def test_fis_table_and_sample():
    jt = jfilters.build_fis_table(jfilters.blackman_harris(1.5), 512)
    tt = filters.build_fis_table(filters.blackman_harris(1.5), 512,
                                 device="cpu")
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    u = _rng(5).uniform(0.0, 1.0, N).astype(np.float32)
    _close(filters.fis_sample(tt, torch.from_numpy(u)),
           jfilters.fis_sample(jt, jnp.asarray(u)))


def test_pinhole_generate():
    res = (64, 36)
    _, _, jcam = jpresets.default_scene(resolution=res)
    _, _, tcam = presets.default_scene(resolution=res, device="cpu")
    g = _rng(6)
    ndc = g.uniform(0.0, 1.0, (N, 2)).astype(np.float32)
    tm = g.uniform(0.0, 1.0, N).astype(np.float32)
    lens = g.uniform(0.0, 1.0, (N, 2)).astype(np.float32)
    got = tcam.generate(*(torch.from_numpy(a) for a in (ndc, tm, lens)))
    want = jcam.generate(*(jnp.asarray(a) for a in (ndc, tm, lens)))
    for a, b in zip(got, want):
        _close(a, b)
    assert tcam.half_pixel_size_coeffs() == tuple(
        float(x) for x in jcam.half_pixel_size_coeffs())


def test_convert_matches_port_default_scene():
    """The JAX default_scene carried across by convert equals the port's
    own presets.default_scene array for array."""
    res = (64, 36)
    jdata, jstatic, jcam = jpresets.default_scene(resolution=res)
    cdata, cstatic = convert.scene(jax.tree.map(np.asarray, jdata), jstatic,
                                   sdf_iterations=12, device="cpu")
    ccam = convert.camera(jax.tree.map(np.asarray, jcam), device="cpu")
    tdata, tstatic, tcam = presets.default_scene(resolution=res, device="cpu")
    assert cstatic == tstatic

    def leaves(x):
        if isinstance(x, torch.Tensor):
            return [x]
        if isinstance(x, tuple):
            return [leaf for item in x for leaf in leaves(item)]
        return [x]

    for got, want in ((cdata, tdata), (ccam, tcam)):
        a, b = leaves(got), leaves(want)
        assert len(a) == len(b)
        for x, y in zip(a, b):
            if isinstance(y, torch.Tensor):
                assert x.dtype == y.dtype and torch.equal(x, y)
            else:
                assert x == y and type(x) is type(y)


def test_animation_channels_match_jax():
    """Constant and 8-knot batched channels sampled per ray, including
    times outside [t0, t1] (clamped), against JAX's one-hot lerp."""
    from rayn_tpu.scene import animation as janim
    from rayn_tpu_torch.scene import animation
    g = _rng(7)
    for knots in (1, 8):
        vals = g.uniform(-2.0, 2.0, (5, knots, 3)).astype(np.float32)
        jch = janim.AnimChannel(jnp.asarray(vals), jnp.float32(0.0),
                                jnp.float32(2.0))
        tch = animation.AnimChannel(torch.from_numpy(vals), 0.0, 2.0)
        t = g.uniform(-0.5, 2.5, N).astype(np.float32)
        idx = g.integers(0, 5, N).astype(np.int32)
        _close(animation.sample_batched(tch, torch.from_numpy(t)),
               janim.sample_batched(jch, jnp.asarray(t)))
        _close(animation.sample_batched_at(tch, torch.from_numpy(idx),
                                           torch.from_numpy(t)),
               janim.sample_batched_at(jch, jnp.asarray(idx),
                                       jnp.asarray(t)))
