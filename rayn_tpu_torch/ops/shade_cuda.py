"""The bounce tail, its two halves and the shadow sort key: CUDA kernels
and plain twins.

Port of the four `rayn_tpu.ops.shade_pallas` kernels of the fused
render paths:

- `shadow_radiance` replaces `shadow_radiance` (`_shadow_kernel` ->
  `_shadow_delta`, with `march_pallas._segment_entry` and the chained
  occlusion core inlined): per ray, L NEE light samples (power-heuristic
  weighted for paired lights when `mis`) and VM*L equi-angular volume
  samples, each tested against the spheres and marched through the SDF.
  Returns the radiance delta [N, 3].
- `finish_bounce` replaces `finish_bounce_fused` (`_finish_kernel` ->
  `_finish_tail`): emission (power-heuristic weighted for paired spheres
  at depth > 0 when `mis`), BSDF scatter, Russian roulette, the depth-0
  AOVs and termination, from the pre-emission radiance. Returns the next
  PathState.
- `bounce_tail` replaces `bounce_tail_fused` (`_bounce_tail_kernel`):
  both halves, the finish on (state radiance + delta).
- `shadow_sort_key` replaces `shadow_sort_key` (`_shadow_key_kernel` ->
  `_shadow_cost_key` -> `_segment_cost`): per ray, the summed estimate
  min(segment length / first DE, max_steps) over the same segments.

The sort key and the segments kernels below draw the volume sites'
equi-angular distances and pdfs themselves from the closest hit's t
(the XLA ops of the JAX integrator's `_equi_angular_samples`), which the
TPU kernels took from outside only because Mosaic lowers neither arctan2
nor tan.

`shadow_radiance` and `bounce_tail` are functions over three kernels:
`shadow_segments` builds every segment once into a scratch (one thread
per ray) and queues the active ones (one atomicAdd a warp),
`shadow_march` marches the queue (persistent lanes that refill from
it), and `shadow_sum` / `tail_sum` sum k * visible in the JAX segment
order (the latter then runs the finish tail).

The segment-queue bounce (relaxed marching or `use_fused_shadows=False`,
render/integrator._segment_queue_tail) runs on the same scratch:
`queue_segments` builds the segments of the unfused JAX integrator
(its op order, not the fused body's), `shadow_march` marches them (with
the relaxed step at `relax` != 1), and `queue_sum` adds k * visible to
the emission-added radiance one segment at a time, in segment order.

Each kernel wrapper launches its CUDA kernel (csrc/shade.cu) for CUDA
tensors, counts the launch in its `launches` attribute, and raises on
anything the kernel does not take. For CPU tensors it calls its `_plain`
twin, which mirrors the kernel body formula for formula (the JAX fused
body, not the unfused integrator path), so kernel and twin differ only
in the compiler's float choices. `bounce_tail_plain` and
`shadow_radiance_plain` are the same pipeline in one piece
(`_shadow_delta_plain`: the segment loop, the verdicts, the ordered
sum). Every twin draws the equi-angular samples with
`equi_angular_plain`, the JAX integrator's torch code for them.

In a scene whose light or sphere channels are animated, every kernel
here (its `_anim_kernel` instantiation) and every twin takes each light
position, sphere center and MIS light position at the ray's time (the
state's `time`; the sort key's `time` argument), the lerp of the
channel's knots, as JAX's `_site_light_positions` and
`scene.sphere_centers_at` resolve them; a constant scene never reads the
time.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from rayn_tpu_torch import _build
from rayn_tpu_torch._build import check, device_of
from rayn_tpu_torch.ops import bsdf as bsdf_ops
from rayn_tpu_torch.ops import lights as light_ops
from rayn_tpu_torch.ops import march as march_ops
from rayn_tpu_torch.ops import march_cuda
from rayn_tpu_torch.ops import sdf as sdf_ops
from rayn_tpu_torch.ops import spheres as sphere_ops
from rayn_tpu_torch.scene.animation import (AnimChannel, need_time, rows_at,
                                            sample_batched_at)
from rayn_tpu_torch.scene.scene import (DIELECTRIC, EMISSIVE, LAMBERT,
                                        METALLIC, REFRACTIVE, SKY)
from rayn_tpu_torch.utils import rng as rng_mod
from rayn_tpu_torch.utils import vecmath
from rayn_tpu_torch.utils.sampling import power_heuristic
from rayn_tpu_torch.utils.vecmath import div as _div
from rayn_tpu_torch.utils.vecmath import sqrt as _sqrt

_PI = 3.14159265358979     # shade_pallas._PI (same float32 as math.pi)
_TWO_PI = 2.0 * _PI
_INV_4PI = 1.0 / (4.0 * _PI)
_F0 = 0.04
F32_EPS = 1.1920929e-07    # f32::EPSILON (reference src/material.rs:236)


class ShadowCfg(NamedTuple):
    """Every scalar the shadow/tail/key bodies read; one source for the
    kernels' argument structs and the plain twins. `sampler` and
    `num_1d_sets` make it a sampler layout for utils.rng."""
    sampler: str
    frame: int
    num_1d_sets: int
    L: int
    VM: int
    NL: int
    K: int
    has_ext: bool
    # the shadow marches' SDF instances in object order: (program reduced
    # to shadow_de_iterations, bounding-sphere clip radius or 0)
    sdfs: tuple
    eps_c: float
    eps_l: float
    detail: float
    max_steps: int
    correction: float
    vm_correction: float
    sigma_t: float
    sigma_s: float
    compat_reflect: bool
    compat_phi: bool
    set_pick: tuple
    set_nee: tuple
    set_vol_pick: tuple    # VM*L, march-major
    set_vol: tuple
    set_vol_dist: tuple    # VM: the equi-angular distance draw of march m
    set_fres: int
    set_diff: int
    set_spec: int
    set_rr: int
    roulette_on: bool
    terminate_all: bool
    aov: bool
    mis: bool       # weight NEE of paired lights
    mis_on: bool    # weight BSDF-hit emission of paired spheres

    @property
    def compat_spec_reflect(self) -> bool:
        """The reflection convention under the settings' name, for
        bsdf.eval_pdf."""
        return self.compat_reflect


def shadow_cfg(data, static, s, tables, depth: int) -> ShadowCfg:
    """The shadow-kernel configuration of one bounce (mirrors
    shade_pallas._shadow_cfg_const and the bounce_tail_fused flags): each
    SDF instance's shadow program (sdf.reduced: a bare MandelBox
    truncated to `shadow_de_iterations` where that is set) with its bound
    radius where `shadow_bv_clip` is set."""
    NL, K = int(static.n_lights), int(static.n_spheres)
    L = s.nee_light_samples if NL > 0 else 0
    VM = s.volume_marches if (static.has_scattering and NL > 0) else 0
    detail = s.sdf_detail_scale * s.shadow_eps_scale
    return ShadowCfg(
        sampler=s.sampler, frame=int(tables.frame),
        num_1d_sets=s.num_1d_sets, L=L, VM=VM, NL=NL, K=K,
        has_ext=static.has_extinction,
        sdfs=tuple((sdf_ops.reduced(prog, s.shadow_de_iterations),
                    float(bv) if s.shadow_bv_clip else 0.0)
                   for prog, _mat, bv in static.sdf_instances(data)),
        eps_c=1e-4 * detail, eps_l=1e-5 * detail, detail=detail,
        max_steps=s.max_vis_marches,
        correction=(NL / L) if L else 0.0,
        vm_correction=(NL / L / VM) if (L and VM) else 0.0,
        sigma_t=data.volume_sigma_t if static.has_extinction else 0.0,
        sigma_s=data.volume_sigma_s if static.has_scattering else 0.0,
        compat_reflect=bool(s.compat_spec_reflect),
        compat_phi=bool(s.compat_spec_phi),
        set_pick=tuple(rng_mod.set1d_light_pick(s, depth, i)
                       for i in range(L)),
        set_nee=tuple(rng_mod.set2d_nee(s, depth, i) for i in range(L)),
        set_vol_pick=tuple(rng_mod.set1d_vol_pick(s, depth, m, i)
                           for m in range(VM) for i in range(L)),
        set_vol=tuple(rng_mod.set2d_vol(s, depth, m, i)
                      for m in range(VM) for i in range(L)),
        set_vol_dist=tuple(rng_mod.set1d_vol_dist(s, depth, m)
                           for m in range(VM)),
        set_fres=rng_mod.set1d_fresnel(s, depth),
        set_diff=rng_mod.set2d_diffuse(s, depth),
        set_spec=rng_mod.set2d_spec(s, depth),
        set_rr=rng_mod.set1d_roulette(s, depth),
        roulette_on=depth > 2, terminate_all=depth >= s.max_bounces,
        aov=depth == 0, mis=bool(s.mis),
        mis_on=bool(s.mis) and K > 0 and NL > 0 and depth > 0)


class SceneTables(NamedTuple):
    """The scene tables the tail kernels read, on the scene's device: the
    constant tables (their positions are knot 0 of each channel, the
    position of a constant one) and the position channels, whose knots the
    kernels lerp at each ray's time where a channel is animated."""
    lights: torch.Tensor   # [NL, 8] pos xyz, radius, emission rgb, paired
    spheres: torch.Tensor  # [K, 4] center xyz, radius
    mis: torch.Tensor      # [K, 5] paired flag, paired light radius, pos xyz
    light_knots: AnimChannel   # [NL, TL, 3] light positions
    sphere_knots: AnimChannel  # [K, TS, 3] sphere centers
    mis_knots: AnimChannel     # [K, TL, 3] each sphere's paired light

    @property
    def animated(self) -> bool:
        """A light or sphere position moves over time."""
        return self.light_knots.knots > 1 or self.sphere_knots.knots > 1


def scene_tables(data, static) -> SceneTables:
    """Built with device gathers only (no host sync)."""
    lights = torch.cat([data.light_pos.values[:, 0, :],
                        data.light_radii[:, None], data.light_emission,
                        data.light_paired[:, None]], dim=-1).contiguous()
    spheres = torch.cat([data.sphere_centers.values[:, 0, :],
                         data.sphere_radii[:, None]], dim=-1).contiguous()
    pair = data.sphere_light
    lk = data.light_pos
    if static.n_lights:
        lidx = torch.clamp(pair.long(), 0, static.n_lights - 1)
        mis_knots = lk.values[lidx]
        mis = torch.cat([(pair >= 0).to(torch.float32)[:, None],
                         data.light_radii[lidx][:, None],
                         mis_knots[:, 0, :]], dim=-1)
    else:
        mis = torch.zeros((pair.shape[0], 5), dtype=torch.float32,
                          device=pair.device)
        mis_knots = torch.zeros((pair.shape[0], 1, 3), dtype=torch.float32,
                                device=pair.device)
    return SceneTables(
        lights, spheres, mis.contiguous(),
        AnimChannel(lk.values.contiguous(), lk.t0, lk.t1),
        AnimChannel(data.sphere_centers.values.contiguous(),
                    data.sphere_centers.t0, data.sphere_centers.t1),
        AnimChannel(mis_knots.contiguous(), lk.t0, lk.t1))



# --------------------------------------------------------------------------
# Plain twins: component-form torch mirrors of the kernel bodies
# --------------------------------------------------------------------------

def _s1(cfg, set_id, sidx, pix):
    return rng_mod.sample_1d(cfg, rng_mod.SampleTables(cfg.frame), set_id,
                             sidx, pix)


def _s2(cfg, set_id, sidx, pix):
    u = rng_mod.sample_2d(cfg, rng_mod.SampleTables(cfg.frame), set_id, sidx,
                          pix)
    return u[:, 0], u[:, 1]


def _onb(nx, ny, nz):
    """Pixar/Duff ONB with signbit(-0.0) = negative (shade_pallas._onb)."""
    ks = torch.where(torch.signbit(nz), -1.0, 1.0)
    ka = 1.0 / (1.0 + torch.abs(nz))
    kb = -ks * nx * ny * ka
    return ((1.0 - nx * nx * ka, ks * kb, -ks * nx),
            (kb, ks - ny * ny * ka * ks, -ny))


def _pick_light(u, tables, time):
    """Per-lane light row, clip(floor(u * NL), 0, NL - 1): the light-table
    columns (pos xyz, radius, emission rgb, paired), its position at each
    lane's time."""
    NL = tables.lights.shape[0]
    idx = torch.clamp(torch.floor(u * NL).to(torch.int64), 0, NL - 1)
    row = tables.lights[idx].unbind(-1)
    if tables.light_knots.knots == 1:
        return row
    pos = sample_batched_at(tables.light_knots, idx,
                            need_time(time, "lights"))
    return (*pos.unbind(-1), *row[3:])


def _sample_cone(u1, u2, lx, ly, lz, lrad, px, py, pz):
    """Visible-cap sphere-light sample (shade_pallas._sample_cone)."""
    dlx, dly, dlz = lx - px, ly - py, lz - pz
    dist_sq = dlx * dlx + dly * dly + dlz * dlz
    dist = _sqrt(dist_sq)
    inv = 1.0 / dist
    nx, ny, nz = -(dlx * inv), -(dly * inv), -(dlz * inv)
    uu, vv = _onb(nx, ny, nz)
    r2 = lrad * lrad
    sin_theta_max_2 = r2 / dist_sq
    cos_theta_max = _sqrt(torch.clamp(1.0 - sin_theta_max_2, min=0.0))
    cos_theta = (1.0 - u1) + u1 * cos_theta_max
    sin_theta = _sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    phi = u2 * _TWO_PI
    ds = dist * cos_theta - _sqrt(
        torch.clamp(r2 - dist_sq * sin_theta * sin_theta, min=0.0))
    cos_alpha = (dist_sq + r2 - ds * ds) / (2.0 * dist * lrad)
    sin_alpha = _sqrt(torch.clamp(1.0 - cos_alpha * cos_alpha, min=0.0))
    sc = sin_alpha * torch.cos(phi)
    ss = sin_alpha * torch.sin(phi)
    ex = lx + (uu[0] * sc + vv[0] * ss + nx * cos_alpha) * lrad
    ey = ly + (uu[1] * sc + vv[1] * ss + ny * cos_alpha) * lrad
    ez = lz + (uu[2] * sc + vv[2] * ss + nz * cos_alpha) * lrad
    pdf = 1.0 / (_TWO_PI * (1.0 - cos_theta_max))
    return ex, ey, ez, pdf


def _eval_f(kind, car, cag, cab, power, wox, woy, woz, wix, wiy, wiz,
            nx, ny, nz):
    """BSDF f(wo, wi) for NEE (shade_pallas._eval_f)."""
    inv_pi = 1.0 / _PI
    d = torch.clamp(wix * nx + wiy * ny + wiz * nz, min=0.0)
    one_minus = 1.0 - d
    om2 = one_minus * one_minus
    om5 = om2 * om2 * one_minus
    fresnel = _F0 + (1.0 - _F0) * om5
    hx, hy, hz = wox + wix, woy + wiy, woz + wiz
    hlen = _sqrt(hx * hx + hy * hy + hz * hz)
    hinv = 1.0 / torch.clamp(hlen, min=1e-20)
    hdn = torch.clamp((hx * nx + hy * ny + hz * nz) * hinv, min=0.0)
    cos_alpha = torch.pow(hdn, power)
    spec_factor = _div(cos_alpha * (power + 2.0), 2.0 * _PI)
    spec_f = spec_factor * fresnel
    one_minus_f = 1.0 - fresnel
    is_lam = (kind == LAMBERT).to(torch.float32)
    is_diel = (kind == DIELECTRIC).to(torch.float32)
    is_met = (kind == METALLIC).to(torch.float32)

    def chan(c):
        lam = c * inv_pi
        diel = spec_f + c * inv_pi * one_minus_f
        met = (c + (1.0 - c) * om5) * spec_factor
        return is_lam * lam + is_diel * diel + is_met * met

    return chan(car), chan(cag), chan(cab)


def _eval_pdf(cfg, kind, power, wox, woy, woz, wix, wiy, wiz, nx, ny, nz):
    """Solid-angle pdf of scatter sampling wi, for the NEE MIS weight
    (shade_pallas._eval_pdf)."""
    lambert_pdf = _div(torch.clamp(wix * nx + wiy * ny + wiz * nz, min=0.0),
                       _PI)
    diffuse_pdf = torch.clamp(lambert_pdf, min=1e-5)
    won = wox * nx + woy * ny + woz * nz
    if cfg.compat_reflect:
        rx, ry, rz = (wox - 2.0 * won * nx, woy - 2.0 * won * ny,
                      woz - 2.0 * won * nz)
    else:
        rx, ry, rz = (2.0 * won * nx - wox, 2.0 * won * ny - woy,
                      2.0 * won * nz - woz)
    cos_alpha = torch.clamp(rx * wix + ry * wiy + rz * wiz, min=0.0)
    cos_alpha_pow = torch.clamp(torch.pow(cos_alpha, power), min=F32_EPS)
    spec_pdf = _div(power + 1.0, _TWO_PI) * cos_alpha_pow
    one_m = 1.0 - torch.abs(won)
    om2 = one_m * one_m
    fresnel = _F0 + (1.0 - _F0) * (om2 * om2 * one_m)
    diel_pdf = fresnel * spec_pdf + (1.0 - fresnel) * diffuse_pdf
    pdf = torch.where(kind == LAMBERT, lambert_pdf, 0.0)
    pdf = torch.where(kind == DIELECTRIC, diel_pdf, pdf)
    return torch.where(kind == METALLIC, spec_pdf, pdf)


def _sphere_occluded(centers, radii, sx, sy, sz, ex, ey, ez):
    """Any-sphere segment occlusion (shade_pallas._sphere_occluded):
    centers indexed [..., k, :] (animation.rows_at), radii [K]."""
    dx, dy, dz = ex - sx, ey - sy, ez - sz
    dist = _sqrt(dx * dx + dy * dy + dz * dz)
    inv = 1.0 / dist
    ux, uy, uz = dx * inv, dy * inv, dz * inv
    occ = torch.zeros_like(sx, dtype=torch.bool)
    for k in range(radii.shape[0]):
        cx, cy, cz = centers[..., k, :].unbind(-1)
        rad = radii[k]
        ocx, ocy, ocz = sx - cx, sy - cy, sz - cz
        b = ocx * ux + ocy * uy + ocz * uz
        c = ocx * ocx + ocy * ocy + ocz * ocz - rad * rad
        descrim = b * b - c
        desc_pos = descrim > 0.0
        dsq = _sqrt(torch.clamp(descrim, min=0.0))
        t1 = -b - dsq
        t2 = -b + dsq
        occ = occ | ((torch.minimum(t1, t2) > 1e-3) & (t1 <= dist)
                     & desc_pos)
    return occ


def _concentric_disk(u, v):
    a = u * 2.0 - 1.0
    b = v * 2.0 - 1.0
    b = torch.where((a == 0.0) & (b == 0.0), 1e-4, b)
    a_safe = torch.where(a == 0.0, 1.0, a)
    phi1 = (_PI / 4.0) * b / a_safe
    phi2 = (_PI / 2.0) - (_PI / 4.0) * a / b
    take1 = (a * a) > (b * b)
    r = torch.where(take1, a, b)
    phi = torch.where(take1, phi1, phi2)
    return r * torch.cos(phi), r * torch.sin(phi)


def _norm3(x, y, z, eps):
    mag = _sqrt(x * x + y * y + z * z)
    inv = 1.0 / torch.clamp(mag, min=eps) if eps else 1.0 / mag
    return x * inv, y * inv, z * inv


def _basis(uu, vv, w, x, y, z):
    return (x * uu[0] + y * vv[0] + z * w[0],
            x * uu[1] + y * vv[1] + z * w[1],
            x * uu[2] + y * vv[2] + z * w[2])


def _scatter(cfg, kind, car, cag, cab, power, ior, wox, woy, woz,
             nx, ny, nz, u_f, u_d1, u_d2, u_s1, u_s2):
    """Component-form BSDF sampling (shade_pallas._scatter). Returns
    (wi xyz, f rgb, pdf)."""
    uu, vv = _onb(nx, ny, nz)
    dx, dy = _concentric_disk(u_d1, u_d2)
    dz = _sqrt(1.0 - torch.clamp(dx * dx + dy * dy, max=1.0))
    dbx, dby, dbz = _norm3(*_basis(uu, vv, (nx, ny, nz), dx, dy, dz), 0.0)
    lambert_pdf = _div(dz, _PI)
    diffuse_pdf = torch.clamp(lambert_pdf, min=1e-5)
    inv_pi = 1.0 / _PI

    won = wox * nx + woy * ny + woz * nz
    if cfg.compat_reflect:
        rx, ry, rz = (wox - 2.0 * won * nx, woy - 2.0 * won * ny,
                      woz - 2.0 * won * nz)
    else:
        rx, ry, rz = (2.0 * won * nx - wox, 2.0 * won * ny - woy,
                      2.0 * won * nz - woz)
    ru, rv = _onb(rx, ry, rz)
    sa = torch.pow(u_s1, 1.0 / (power + 1.0))
    sb = _sqrt(torch.clamp(1.0 - sa * sa, min=0.0))
    sphi = (2.0 * u_s2) if cfg.compat_phi else ((2.0 * _PI) * u_s2)
    ssx, ssy, ssz = sb * torch.cos(sphi), sb * torch.sin(sphi), sa
    sbx, sby, sbz = _norm3(*_basis(ru, rv, (rx, ry, rz), ssx, ssy, ssz), 0.0)
    cos_alpha_pow = torch.clamp(torch.pow(ssz, power), min=F32_EPS)
    spec_pdf = _div(power + 1.0, _TWO_PI) * cos_alpha_pow
    spec_coeff = _div(power + 2.0, _TWO_PI) * cos_alpha_pow
    below = (nx * sbx + ny * sby + nz * sbz) < 0.0
    spec_coeff = torch.where(below, 0.0, spec_coeff)

    cos = torch.abs(won)
    one_m = 1.0 - cos
    om2 = one_m * one_m
    fresnel = _F0 + (1.0 - _F0) * (om2 * om2 * one_m)
    take_spec = u_f < fresnel
    diel_pdf = fresnel * spec_pdf + (1.0 - fresnel) * diffuse_pdf

    is_diel = kind == DIELECTRIC
    dsel = is_diel & take_spec
    wix = torch.where(dsel, sbx, dbx)
    wiy = torch.where(dsel, sby, dby)
    wiz = torch.where(dsel, sbz, dbz)
    pdf = torch.where(is_diel, diel_pdf, lambert_pdf)

    def chan_df(c):
        diffuse_f = c * inv_pi
        return torch.where(dsel, spec_coeff, diffuse_f)

    fr, fg, fb = chan_df(car), chan_df(cag), chan_df(cab)

    is_metal = kind == METALLIC
    om5 = om2 * om2 * one_m
    wix = torch.where(is_metal, sbx, wix)
    wiy = torch.where(is_metal, sby, wiy)
    wiz = torch.where(is_metal, sbz, wiz)
    pdf = torch.where(is_metal, spec_pdf, pdf)
    fr = torch.where(is_metal, (car + (1.0 - car) * om5) * spec_coeff, fr)
    fg = torch.where(is_metal, (cag + (1.0 - cag) * om5) * spec_coeff, fg)
    fb = torch.where(is_metal, (cab + (1.0 - cab) * om5) * spec_coeff, fb)

    is_refr = kind == REFRACTIVE
    entering = won > 0.0
    nrx = torch.where(entering, nx, -nx)
    nry = torch.where(entering, ny, -ny)
    nrz = torch.where(entering, nz, -nz)
    eta = torch.where(entering, 1.0 / ior, ior)
    ci = torch.abs(won)
    sin2_t = eta * eta * torch.clamp(1.0 - ci * ci, min=0.0)
    tir = sin2_t > 1.0
    cos_t = _sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
    k_eta = eta * ci - cos_t
    rfx, rfy, rfz = _norm3(-wox * eta + nrx * k_eta, -woy * eta + nry * k_eta,
                           -woz * eta + nrz * k_eta, 1e-20)
    f0r = (1.0 - ior) / (1.0 + ior)
    f0r = f0r * f0r
    omc = 1.0 - ci
    omc2 = omc * omc
    fresnel_r = f0r + (1.0 - f0r) * (omc2 * omc2 * omc)
    wodn = wox * nrx + woy * nry + woz * nrz
    rlx = 2.0 * wodn * nrx - wox
    rly = 2.0 * wodn * nry - woy
    rlz = 2.0 * wodn * nrz - woz
    take_reflect = (u_f < fresnel_r) | tir
    ax = torch.where(take_reflect, rlx, rfx)
    ay = torch.where(take_reflect, rly, rfy)
    az = torch.where(take_reflect, rlz, rfz)
    auu, avv = _onb(ax, ay, az)
    rwx, rwy, rwz = _norm3(*_basis(auu, avv, (ax, ay, az), dx, dy, dz), 0.0)
    refr_pdf = torch.clamp(_div(dz, _PI), min=1e-6)
    ndl_r = torch.clamp(torch.abs(rwx * nx + rwy * ny + rwz * nz), min=1e-6)
    scale_r = refr_pdf / ndl_r
    wix = torch.where(is_refr, rwx, wix)
    wiy = torch.where(is_refr, rwy, wiy)
    wiz = torch.where(is_refr, rwz, wiz)
    pdf = torch.where(is_refr, refr_pdf, pdf)
    fr, fg, fb = (torch.where(is_refr,
                              torch.where(take_reflect, 1.0, c) * scale_r, f)
                  for c, f in ((car, fr), (cag, fg), (cab, fb)))
    return wix, wiy, wiz, fr, fg, fb, pdf


def _nee_site(cfg, tables, i, v):
    """Light pick + cone sample of NEE site i: (end xyz, pdf, emission,
    paired flag)."""
    u_pick = _s1(cfg, cfg.set_pick[i], v["sidx"], v["pix"])
    lx, ly, lz, lrad, er, eg, eb, pair = _pick_light(u_pick, tables, v["tm"])
    u1, u2 = _s2(cfg, cfg.set_nee[i], v["sidx"], v["pix"])
    p_x, p_y, p_z = v["p"]
    ex, ey, ez, pdf = _sample_cone(u1, u2, lx, ly, lz, lrad, p_x, p_y, p_z)
    return ex, ey, ez, pdf, (er, eg, eb), pair


def _vol_site(cfg, tables, j, vd_j, v):
    """Light pick + scatter point + cone sample of volume site j
    (march-major): (start xyz, end xyz, light pdf, emission)."""
    u_pick = _s1(cfg, cfg.set_vol_pick[j], v["sidx"], v["pix"])
    lx, ly, lz, lrad, er, eg, eb, _pair = _pick_light(u_pick, tables,
                                                      v["tm"])
    (o_x, o_y, o_z), (d_x, d_y, d_z) = v["o"], v["d"]
    spx = o_x + vd_j * d_x
    spy = o_y + vd_j * d_y
    spz = o_z + vd_j * d_z
    u1, u2 = _s2(cfg, cfg.set_vol[j], v["sidx"], v["pix"])
    ex, ey, ez, pdf = _sample_cone(u1, u2, lx, ly, lz, lrad, spx, spy, spz)
    return (spx, spy, spz), (ex, ey, ez), pdf, (er, eg, eb)


def _stack(*cols):
    return torch.stack(cols, dim=-1)


def unclipped(cfg: ShadowCfg) -> ShadowCfg:
    """The configuration with no bounding-sphere clip on any instance."""
    return cfg._replace(sdfs=tuple((prog, 0.0) for prog, _bv in cfg.sdfs))


def _occlusion_fold(cfg, start, end, act, relax: float = 1.0):
    """[M] bool: march_ops.march_occlusion folded over the SDF instances,
    each with its bound radius, marching only the segments still active
    and unblocked (intersect.test_occluded's product fold)."""
    occ = torch.zeros_like(act)
    for prog, bv in cfg.sdfs:
        occ = occ | march_ops.march_occlusion(
            prog, start, end, cfg.detail, cfg.max_steps, act & ~occ, bv,
            relax)
    return occ


def _sdf_verdicts(cfg, segs):
    """Occlusion verdict of every segment (`_occlusion_fold`): all
    segments march as one batch, each with its own step sequence
    (scheduling never changes a verdict). segs: list of (start xyz, end
    xyz, active)."""
    if not cfg.sdfs or not segs:
        return [torch.zeros_like(a) for (_s, _e, a) in segs]
    n = segs[0][2].shape[0]
    start = torch.cat([_stack(*s) for (s, _e, _a) in segs])
    end = torch.cat([_stack(*e) for (_s, e, _a) in segs])
    act = torch.cat([a for (_s, _e, a) in segs])
    return list(_occlusion_fold(cfg, start, end, act).split(n))


def _ordered_sum(ks, vis, like):
    """sum of k * visible over the segments in their order, from 0 (the
    JAX order: NEE 0..L-1, then volume sites march-major). ks: (r, g, b)
    per segment; vis: a bool [N] per segment."""
    rad_r = torch.zeros_like(like)
    rad_g = torch.zeros_like(like)
    rad_b = torch.zeros_like(like)
    for (kr, kg, kb), v in zip(ks, vis):
        v = v.to(torch.float32)
        rad_r = rad_r + kr * v
        rad_g = rad_g + kg * v
        rad_b = rad_b + kb * v
    return rad_r, rad_g, rad_b


def _lane_values(state, info, mat, live, receives):
    d = state.direction.unbind(-1)
    return dict(
        p=info.point.unbind(-1), n=info.normal.unbind(-1),
        off=info.offset_by, o=state.origin.unbind(-1), d=d,
        tp=state.throughput.unbind(-1), kind=mat.kind,
        ca=mat.color_a.unbind(-1), cb=mat.color_b.unbind(-1),
        pw=mat.power, ior=mat.ior, sidx=state.sample_idx,
        pix=state.pixel, alive=live, recv=receives,
        wo=(-d[0], -d[1], -d[2]), tm=state.time)


def _nee_segment(cfg, tables, v, vtr, i):
    """NEE site i of each ray (shade_pallas._shadow_delta's NEE body):
    ((start xyz, end xyz, active), contribution k (r, g, b)). With `mis`,
    the NEE of a paired light is weighted before `worth` decides whether
    its segment is marched; a segment is active when it is worth
    marching and no sphere blocks it."""
    p_x, p_y, p_z = v["p"]
    n_x, n_y, n_z = v["n"]
    off = v["off"]
    tp_x, tp_y, tp_z = v["tp"]
    wo_x, wo_y, wo_z = v["wo"]
    c_r, c_g, c_b = v["ca"]
    receives = v["recv"]
    ex, ey, ez, pdf, (er, eg, eb), pair = _nee_site(cfg, tables, i, v)
    wfx, wfy, wfz = ex - p_x, ey - p_y, ez - p_z
    dist = _sqrt(wfx * wfx + wfy * wfy + wfz * wfz)
    dinv = 1.0 / dist
    wix, wiy, wiz = wfx * dinv, wfy * dinv, wfz * dinv
    ndw = n_x * wix + n_y * wiy + n_z * wiz
    bias = torch.where(torch.signbit(ndw), -off, off)
    sx, sy, sz = p_x + n_x * bias, p_y + n_y * bias, p_z + n_z * bias
    fr, fg, fb = _eval_f(v["kind"], c_r, c_g, c_b, v["pw"],
                         wo_x, wo_y, wo_z, wix, wiy, wiz, n_x, n_y, n_z)
    ndl = torch.clamp(ndw, min=0.0)
    seg_trans = (torch.exp(-cfg.sigma_t * dist) if cfg.has_ext
                 else 1.0)
    scale = _div(seg_trans, pdf) * (cfg.correction * vtr)
    kr = torch.where(receives, er * fr * ndl * scale * tp_x, 0.0)
    kg = torch.where(receives, eg * fg * ndl * scale * tp_y, 0.0)
    kb = torch.where(receives, eb * fb * ndl * scale * tp_z, 0.0)
    if cfg.mis:
        p_bsdf = _eval_pdf(cfg, v["kind"], v["pw"], wo_x, wo_y, wo_z,
                           wix, wiy, wiz, n_x, n_y, n_z)
        w_light = power_heuristic(float(cfg.L), _div(pdf, float(cfg.NL)),
                                  1.0, p_bsdf)
        w = torch.where(pair > 0.0, w_light, 1.0)
        kr, kg, kb = kr * w, kg * w, kb * w
    worth = receives & ((kr != 0.0) | (kg != 0.0) | (kb != 0.0))
    blocked = _sphere_occluded(rows_at(tables.sphere_knots, v["tm"], "NEE"),
                               tables.spheres[:, 3], sx, sy, sz, ex, ey, ez)
    return ((sx, sy, sz), (ex, ey, ez), worth & ~blocked), (kr, kg, kb)


def _vol_segment(cfg, tables, v, j, vd, vp):
    """Volume site j of each ray (march-major) at its equi-angular
    distance vd and pdf vp: ((start xyz, end xyz, active), contribution
    k (r, g, b))."""
    tp_x, tp_y, tp_z = v["tp"]
    alive = v["alive"]
    (spx, spy, spz), (ex, ey, ez), light_pdf, (er, eg, eb) = \
        _vol_site(cfg, tables, j, vd, v)
    sgx, sgy, sgz = ex - spx, ey - spy, ez - spz
    dist_pl = _sqrt(sgx * sgx + sgy * sgy + sgz * sgz)
    if cfg.has_ext:
        seg_trans = torch.exp(-cfg.sigma_t * dist_pl)
        to_point = torch.exp(-cfg.sigma_t * vd)
    else:
        seg_trans = to_point = 1.0
    scale = (_div(_INV_4PI * seg_trans, vp * light_pdf)
             * cfg.vm_correction * cfg.sigma_s * to_point)
    kr = torch.where(alive, er * scale * tp_x, 0.0)
    kg = torch.where(alive, eg * scale * tp_y, 0.0)
    kb = torch.where(alive, eb * scale * tp_z, 0.0)
    worth = alive & ((kr != 0.0) | (kg != 0.0) | (kb != 0.0))
    blocked = _sphere_occluded(rows_at(tables.sphere_knots, v["tm"],
                                       "volume sites"),
                               tables.spheres[:, 3], spx, spy, spz, ex, ey,
                               ez)
    return ((spx, spy, spz), (ex, ey, ez), worth & ~blocked), (kr, kg, kb)


def _segment_loop(cfg, tables, v, vtr, vol_dist, vol_pdf):
    """Steps 3 + 4 of a bounce up to the SDF march (shade_pallas
    ._shadow_delta): the NEE sites 0..L-1, then the volume sites
    march-major. Returns (segs, ks): per segment (start xyz, end xyz,
    active) and its contribution k (r, g, b)."""
    out = [_nee_segment(cfg, tables, v, vtr, i) for i in range(cfg.L)]
    out += [_vol_segment(cfg, tables, v, j, vol_dist[j], vol_pdf[j])
            for j in range(cfg.VM * cfg.L)]
    return [seg for seg, _k in out], [k for _seg, k in out]


def _shadow_delta_plain(cfg, tables, v, vtr, vol_dist, vol_pdf):
    """The per-bounce shadow pipeline (shade_pallas._shadow_delta):
    radiance delta (r, g, b) of the segment loop's segments, each marched
    where active, summed in segment order."""
    segs, ks = _segment_loop(cfg, tables, v, vtr, vol_dist, vol_pdf)
    occ = _sdf_verdicts(cfg, segs)
    return _ordered_sum(ks, [a & ~o for (_s, _e, a), o in zip(segs, occ)],
                        v["p"][0])


def _finish_plain(cfg, tables, v, vtr, state, obj, rad_in):
    """Steps 2 and 5-7 of a bounce (shade_pallas._finish_tail) from the
    pre-emission radiance rad_in: the 24 output columns as [N,3]/[N]
    tensors in PathState order."""
    o_x, o_y, o_z = v["o"]
    d_x, d_y, d_z = v["d"]
    tp_x, tp_y, tp_z = v["tp"]
    n_x, n_y, n_z = v["n"]
    p_x, p_y, p_z = v["p"]
    off, live, receives = v["off"], v["alive"], v["recv"]
    sidx, pix, kind = v["sidx"], v["pix"], v["kind"]
    car, cag, cab = v["ca"]
    cbr, cbg, cbb = v["cb"]
    wox, woy, woz = v["wo"]

    t_sky = 0.5 * (woy + 1.0)
    is_sky = kind == SKY
    is_em = kind == EMISSIVE
    le_r = torch.where(is_sky, car * (1.0 - t_sky) + cbr * t_sky,
                       torch.where(is_em, cbr, 0.0))
    le_g = torch.where(is_sky, cag * (1.0 - t_sky) + cbg * t_sky,
                       torch.where(is_em, cbg, 0.0))
    le_b = torch.where(is_sky, cab * (1.0 - t_sky) + cbb * t_sky,
                       torch.where(is_em, cbb, 0.0))
    if cfg.mis_on:
        # BSDF-hit emission of a sphere paired with a light, weighted
        # against the NEE strategy that could have sampled it
        K = tables.mis.shape[0]
        idx = torch.clamp(obj, 0, K - 1).long()
        pairf, lrad, lpx, lpy, lpz = tables.mis[idx].unbind(-1)
        if tables.mis_knots.knots > 1:   # the paired light at the time
            lpx, lpy, lpz = sample_batched_at(
                tables.mis_knots, idx,
                need_time(state.time, "mis")).unbind(-1)
        ppdf = state.prev_pdf
        is_paired = (obj >= 0) & (obj < K) & (pairf > 0.0) & (ppdf >= 0.0)
        dlx, dly, dlz = lpx - o_x, lpy - o_y, lpz - o_z
        d2 = dlx * dlx + dly * dly + dlz * dlz
        cos_theta_max = _sqrt(torch.clamp(1.0 - lrad * lrad / d2, min=0.0))
        q = _div(_div(1.0, _TWO_PI * (1.0 - cos_theta_max)), float(cfg.NL))
        w = torch.where(is_paired,
                        power_heuristic(1.0, ppdf, float(cfg.L), q), 1.0)
        le_r, le_g, le_b = le_r * w, le_g * w, le_b * w
    rad_r = rad_in[0] + torch.where(live, le_r * tp_x * vtr, 0.0)
    rad_g = rad_in[1] + torch.where(live, le_g * tp_y * vtr, 0.0)
    rad_b = rad_in[2] + torch.where(live, le_b * tp_z * vtr, 0.0)

    u_f = _s1(cfg, cfg.set_fres, sidx, pix)
    u_d1, u_d2 = _s2(cfg, cfg.set_diff, sidx, pix)
    u_s1, u_s2 = _s2(cfg, cfg.set_spec, sidx, pix)
    wix, wiy, wiz, f_r, f_g, f_b, pdf = _scatter(
        cfg, kind, car, cag, cab, v["pw"], v["ior"], wox, woy, woz,
        n_x, n_y, n_z, u_f, u_d1, u_d2, u_s1, u_s2)
    ndl = torch.abs(wix * n_x + wiy * n_y + wiz * n_z)
    scale = vtr * (ndl / pdf)
    ntp_x = tp_x * scale * f_r
    ntp_y = tp_y * scale * f_g
    ntp_z = tp_z * scale * f_b
    max_tp = torch.maximum(tp_x, torch.maximum(tp_y, tp_z))
    if cfg.roulette_on:
        roulette = torch.clamp(1.0 - max_tp, min=0.05)
    else:
        roulette = torch.zeros_like(max_tp)
    inv_keep = 1.0 / (1.0 - roulette)
    ntp_x, ntp_y, ntp_z = ntp_x * inv_keep, ntp_y * inv_keep, ntp_z * inv_keep
    u_r = _s1(cfg, cfg.set_rr, sidx, pix)
    terminate = (u_r < roulette) | cfg.terminate_all

    rad = _stack(rad_r, rad_g, rad_b)
    if cfg.aov:
        al = torch.where(receives, 1.0, state.alpha_out)
        nout = torch.where(receives[:, None], _stack(n_x, n_y, n_z),
                           state.normal_out)
    else:
        al, nout = state.alpha_out, state.normal_out
    non_recv = live & ~receives
    bgsel = non_recv if cfg.aov else torch.zeros_like(non_recv)
    bg = torch.where(bgsel[:, None], rad, state.bg_out)
    csel = torch.zeros_like(non_recv) if cfg.aov else non_recv
    co = torch.where(csel[:, None], rad, state.color_out)
    co = torch.where((receives & terminate)[:, None], rad, co)
    survive = receives & ~terminate

    ndw = n_x * wix + n_y * wiy + n_z * wiz
    bias = torch.where(torch.signbit(ndw), -off, off)
    new_o = _stack(p_x + n_x * bias, p_y + n_y * bias, p_z + n_z * bias)
    tp_nan = torch.isnan(ntp_x) | torch.isnan(ntp_y) | torch.isnan(ntp_z)
    f = _stack(torch.where(tp_nan, tp_x, ntp_x),
               torch.where(tp_nan, tp_y, ntp_y),
               torch.where(tp_nan, tp_z, ntp_z))
    next_pdf = torch.where(kind == REFRACTIVE, -1.0, pdf)
    sv = survive[:, None]
    return dict(
        origin=torch.where(sv, new_o, state.origin),
        direction=torch.where(sv, _stack(wix, wiy, wiz), state.direction),
        throughput=torch.where(sv, f, state.throughput),
        radiance=rad, alive=survive,
        prev_pdf=torch.where(survive, next_pdf, state.prev_pdf),
        color_out=co, bg_out=bg, alpha_out=al, normal_out=nout)


def _vol_samples(cfg: ShadowCfg, tables: SceneTables, state, t_hit):
    """(vol_dist, vol_pdf), [VM*L, N] each: the volume sites' equi-angular
    samples along each ray up to its closest hit t_hit."""
    return equi_angular_plain(cfg, tables, state.origin, state.direction,
                              t_hit, state.sample_idx, state.pixel,
                              state.time)


def shadow_radiance_plain(cfg: ShadowCfg, tables: SceneTables, state, info,
                          mat, live, receives, vol_trans, t_hit):
    """Plain version of `shadow_radiance`: the [N, 3] radiance delta of
    one bounce's NEE and volume segments."""
    v = _lane_values(state, info, mat, live, receives)
    return _stack(*_shadow_delta_plain(cfg, tables, v, vol_trans,
                                       *_vol_samples(cfg, tables, state,
                                                     t_hit)))


def finish_bounce_plain(cfg: ShadowCfg, tables: SceneTables, state, hit,
                        info, mat, live, receives, vol_trans, radiance):
    """Plain twin of the finish kernel: the next PathState fields (as
    bounce_tail_plain) from the pre-emission radiance [N, 3]."""
    v = _lane_values(state, info, mat, live, receives)
    return _finish_plain(cfg, tables, v, vol_trans, state, hit.obj,
                         radiance.unbind(-1))


def bounce_tail_plain(cfg: ShadowCfg, tables: SceneTables, state, hit, info,
                      mat, live, receives, vol_trans, t_hit):
    """Plain version of `bounce_tail`: the next PathState fields as a
    dict (origin, direction, throughput, radiance, alive, prev_pdf,
    color_out, bg_out, alpha_out, normal_out). Association order is the
    two-kernel path's: (state.radiance + shadow delta) + emission."""
    v = _lane_values(state, info, mat, live, receives)
    dr, dg, db = _shadow_delta_plain(cfg, tables, v, vol_trans,
                                     *_vol_samples(cfg, tables, state, t_hit))
    rx, ry, rz = state.radiance.unbind(-1)
    return _finish_plain(cfg, tables, v, vol_trans, state, hit.obj,
                         (rx + dr, ry + dg, rz + db))


class ShadowSegments(NamedTuple):
    """The shadow segments of one bounce, S = L + VM*L per ray, segment j
    of ray i at j*N + i (NEE sites, then volume sites march-major)."""
    geom: torch.Tensor     # [6, S, N] f32: start xyz, end xyz
    k: torch.Tensor        # [3, S, N] f32: contribution rgb
    active: torch.Tensor   # [S, N] bool: worth marching, no sphere in the way
    queue: torch.Tensor    # [S*N] i32: ids of the active segments first
    count: torch.Tensor    # [1] i32: how many ids the queue holds


def _planes(cols, rows, x):
    """[rows, S, N] stack of S per-segment tuples of `rows` [N] columns
    like x."""
    if not cols:
        return x.new_empty((rows, 0, x.shape[0]))
    return torch.stack([torch.stack(c) for c in cols], dim=1)


def shadow_segments_plain(cfg: ShadowCfg, tables: SceneTables, state, info,
                          mat, live, receives, vol_trans,
                          t_hit) -> ShadowSegments:
    """Plain twin of the segments kernel: the segment loop's segments,
    with the active ones queued in id order."""
    v = _lane_values(state, info, mat, live, receives)
    segs, ks = _segment_loop(cfg, tables, v, vol_trans,
                             *_vol_samples(cfg, tables, state, t_hit))
    n = state.origin.shape[0]
    x = v["p"][0]
    active = (torch.stack([a for (_s, _e, a) in segs]) if segs else
              torch.zeros((0, n), dtype=torch.bool, device=x.device))
    queue, count = march_cuda.enqueue_plain(active.reshape(-1))
    return ShadowSegments(
        geom=_planes([(*s, *e) for (s, e, _a) in segs], 6, x),
        k=_planes(ks, 3, x), active=active, queue=queue, count=count)


def shadow_march_plain(cfg: ShadowCfg, segs: ShadowSegments,
                       relax: float = 1.0) -> torch.Tensor:
    """Plain twin of the march kernel: [S, N] bool, True where an SDF
    instance blocks a queued segment (the march_occlusion verdicts at
    `relax`, each instance with its bounding-sphere clip, folded as a
    product over the instances); False elsewhere."""
    S, n = segs.active.shape
    verdict = torch.zeros((S * n,), dtype=torch.bool,
                          device=segs.active.device)
    if cfg.sdfs:
        ids = segs.queue[:int(segs.count[0])].long()
        g = segs.geom.reshape(6, -1)[:, ids].T
        verdict[ids] = _occlusion_fold(
            cfg, g[:, :3], g[:, 3:], torch.ones_like(ids, dtype=torch.bool),
            relax)
    return verdict.reshape(S, n)


def _segment_sum(segs: ShadowSegments, verdict):
    return _ordered_sum(zip(*segs.k), segs.active & ~verdict,
                        segs.k.new_zeros(segs.k.shape[2]))


def shadow_sum_plain(segs: ShadowSegments, verdict) -> torch.Tensor:
    """Plain twin of the shadow-sum kernel: the [N, 3] radiance delta,
    k * (active and not blocked) summed over the segments in order."""
    return _stack(*_segment_sum(segs, verdict))


def tail_sum_plain(cfg: ShadowCfg, tables: SceneTables, state, hit, info,
                   mat, live, receives, vol_trans, segs: ShadowSegments,
                   verdict) -> dict:
    """Plain twin of the tail-sum kernel: the finish tail (as
    bounce_tail_plain) on state radiance + the segments' delta."""
    v = _lane_values(state, info, mat, live, receives)
    dr, dg, db = _segment_sum(segs, verdict)
    rx, ry, rz = state.radiance.unbind(-1)
    return _finish_plain(cfg, tables, v, vol_trans, state, hit.obj,
                         (rx + dr, ry + dg, rz + db))


def _queue_light(cfg, tables, set_id, state):
    """The light that sampler set `set_id` picks for each lane (_pick_light):
    position [N, 3] at the lane's time, radius, emission [N, 3], paired
    flag."""
    lx, ly, lz, lrad, er, eg, eb, paired = _pick_light(
        _s1(cfg, set_id, state.sample_idx, state.pixel), tables, state.time)
    return _stack(lx, ly, lz), lrad, _stack(er, eg, eb), paired


def _queue_u2(cfg, set_id, state):
    return rng_mod.sample_2d(cfg, rng_mod.SampleTables(cfg.frame), set_id,
                             state.sample_idx, state.pixel)


def _queue_blocked(cfg, tables, start, end, time):
    """[N] bool: a sphere blocks the segment start -> end (the sphere test
    of intersect.test_occluded), the centers at each lane's time."""
    if not cfg.K:
        return torch.zeros(start.shape[:1], dtype=torch.bool,
                           device=start.device)
    centers = rows_at(tables.sphere_knots, time, "queue segments").expand(
        start.shape[0], cfg.K, 3)
    return sphere_ops.occluded(start, end, centers,
                               tables.spheres[:, 3]).any(dim=1)


def _queue_nee_segment(cfg, tables, state, info, mat, receives, vol_trans,
                       i):
    """NEE site i of the unfused bounce (JAX integrator.py:420-483), its
    torch build as the segment queue ran it op by op, MIS-weighted for
    paired lights: (start, end, contribution [N, 3], active: worth
    marching and no sphere in the way)."""
    wo = -state.direction
    ones = torch.ones_like(vol_trans)
    lp, lr, lem, paired = _queue_light(cfg, tables, cfg.set_pick[i], state)
    end_point, li, pdf = light_ops.sample_cone(
        _queue_u2(cfg, cfg.set_nee[i], state), lp, lr, info.point, lem)
    wi_full = end_point - info.point
    dist = vecmath.length(wi_full)
    wi = wi_full / dist[:, None]
    ndw = vecmath.dot(info.normal, wi)
    occ_origin = info.point + info.normal * (
        torch.copysign(ones, ndw) * info.offset_by)[:, None]
    f = (bsdf_ops.eval_f(mat, wo, wi, info.normal)
         * torch.clamp(ndw, min=0.0)[:, None])
    seg_trans = torch.exp(-cfg.sigma_t * dist) if cfg.has_ext else ones
    contrib = (li * f * (seg_trans / pdf)[:, None] * state.throughput
               * (cfg.correction * vol_trans)[..., None])
    contrib = torch.where(receives[:, None], contrib, 0.0)
    if cfg.mis:
        # unpaired lights are invisible to BSDF rays: weight 1
        p_bsdf = bsdf_ops.eval_pdf(mat, cfg, wo, wi, info.normal)
        w_light = power_heuristic(float(cfg.L), _div(pdf, float(cfg.NL)),
                                  1.0, p_bsdf)
        contrib = contrib * torch.where(paired > 0.0, w_light, 1.0)[:, None]
    act = receives & (contrib != 0.0).any(dim=-1)
    return (occ_origin, end_point, contrib,
            act & ~_queue_blocked(cfg, tables, occ_origin, end_point,
                                  state.time))


def _queue_vol_segment(cfg, tables, state, live, j, vd, vp):
    """Volume site j (march-major) of the unfused bounce (JAX
    integrator.py:485-501) at its equi-angular distance vd and pdf vp:
    (start, end, contribution [N, 3], active)."""
    ones = torch.ones_like(vd)
    lp, lr, lem, _paired = _queue_light(cfg, tables, cfg.set_vol_pick[j],
                                        state)
    sampled = state.origin + vd[:, None] * state.direction
    end_point, li, light_pdf = light_ops.sample_cone(
        _queue_u2(cfg, cfg.set_vol[j], state), lp, lr, sampled, lem)
    dist_pl = vecmath.length(end_point - sampled)
    if cfg.has_ext:
        seg_trans = torch.exp(-cfg.sigma_t * dist_pl)
        to_point = torch.exp(-cfg.sigma_t * vd)
    else:
        seg_trans = to_point = ones
    scale = (1.0 / (4.0 * math.pi) * seg_trans / (vp * light_pdf)
             * cfg.vm_correction * cfg.sigma_s * to_point)
    contrib = torch.where(live[:, None],
                          li * scale[:, None] * state.throughput, 0.0)
    act = live & (contrib != 0.0).any(dim=-1)
    return (sampled, end_point, contrib,
            act & ~_queue_blocked(cfg, tables, sampled, end_point,
                                  state.time))


def _queue_segment_loop(cfg, tables, state, info, mat, live, receives,
                        vol_trans, vol_dist, vol_pdf):
    """Steps 3 + 4 of the unfused bounce (JAX integrator.py:420-501): the
    L NEE segments, then the VM*L equi-angular volume segments
    (march-major), each (start, end, contribution [N, 3], active). The
    sampler, light and sphere values come from `cfg` and `tables`, the
    positions at each lane's time."""
    return ([_queue_nee_segment(cfg, tables, state, info, mat, receives,
                                vol_trans, i) for i in range(cfg.L)]
            + [_queue_vol_segment(cfg, tables, state, live, j, vol_dist[j],
                                  vol_pdf[j])
               for j in range(cfg.VM * cfg.L)])


def queue_segments_plain(cfg: ShadowCfg, tables: SceneTables, state, info,
                         mat, live, receives, vol_trans,
                         t_hit) -> ShadowSegments:
    """Plain twin of the queue-segments kernel: the unfused bounce's
    segments (_queue_segment_loop) with the sphere test of
    intersect.test_occluded, as a segment scratch (see ShadowSegments);
    a segment is active when it is worth marching and no sphere blocks
    it, and the active ones are queued in id order."""
    start, end, k, active = (torch.stack(c) for c in zip(*_queue_segment_loop(
        cfg, tables, state, info, mat, live, receives, vol_trans,
        *_vol_samples(cfg, tables, state, t_hit))))
    queue, count = march_cuda.enqueue_plain(active.reshape(-1))
    return ShadowSegments(
        geom=torch.cat([start, end], dim=-1).permute(2, 0, 1).contiguous(),
        k=k.permute(2, 0, 1).contiguous(), active=active, queue=queue,
        count=count)


def queue_sum_plain(radiance, segs: ShadowSegments, verdict) -> torch.Tensor:
    """Plain twin of the queue-sum kernel: the segment queue's radiance
    (JAX integrator.py:512-514), radiance [N, 3] + k_j * visible_j for
    each segment j in turn, visible_j = active and not blocked."""
    vis = (segs.active & ~verdict).to(torch.float32)
    for j in range(vis.shape[0]):
        radiance = radiance + segs.k[:, j].T * vis[j][:, None]
    return radiance


def _segment_cost(cfg, start, end, act):
    """Per SDF instance min(md / max(t0, 1e-6), max_steps), or 1 for a
    segment resolved at entry or starting past its end
    (shade_pallas._segment_cost), summed over the instances from 0
    (_shadow_cost_key's seg_cost)."""
    cost = torch.zeros_like(start[0])
    for prog, bv in cfg.sdfs:
        _d, md, t0, nan, _ = march_ops.segment_entry(
            prog, bv, _stack(*start), _stack(*end), act)
        est = torch.clamp(md / torch.clamp(t0, min=1e-6),
                          max=float(cfg.max_steps))
        cost = cost + torch.where(nan | (t0 > md), 1.0, est)
    return cost


def equi_angular_plain(cfg: ShadowCfg, tables: SceneTables, origin,
                       direction, t_hit, sample_idx, pixel, time=None):
    """The volume sites' equi-angular samples, as the segments and
    sort-key kernels draw them (csrc/common.cuh equi_angular_site): the
    JAX integrator's `_equi_angular_samples` (integrator.py:521-544) in
    torch. Returns
    (vol_dist, vol_pdf), [VM*L, N] each, march-major: for march m the
    distance draw, for each site the light pick (its position at each
    ray's `time`) and lights.sample_equi_angular along each ray up to its
    closest hit t_hit."""
    dists, pdfs = [], []
    for m in range(cfg.VM):
        u_dist = _s1(cfg, cfg.set_vol_dist[m], sample_idx, pixel)
        for i in range(cfg.L):
            u_pick = _s1(cfg, cfg.set_vol_pick[m * cfg.L + i], sample_idx,
                         pixel)
            light_pos = torch.stack(_pick_light(u_pick, tables, time)[:3],
                                    -1)
            vd, vp = light_ops.sample_equi_angular(u_dist, light_pos, origin,
                                                   direction, t_hit)
            dists.append(vd)
            pdfs.append(vp)
    if not dists:
        empty = torch.empty((0, origin.shape[0]), dtype=torch.float32,
                            device=origin.device)
        return empty, empty.clone()
    return torch.stack(dists), torch.stack(pdfs)


def shadow_sort_key_plain(cfg: ShadowCfg, tables: SceneTables, point, normal,
                          offset_by, origin, direction, t_hit, live,
                          receives, sample_idx, pixel, time=None, n_de=None):
    """Plain twin of the sort-key kernel: `_shadow_cost_key` on the
    volume sites' distances of `equi_angular_plain`, the lights at each
    ray's `time`. `n_de`, if given, counts in place the DEs each ray's
    key takes (one per active segment and instance, at its start)."""
    if not cfg.sdfs:
        return torch.zeros_like(offset_by)
    vol_dist, _ = equi_angular_plain(cfg, tables, origin, direction, t_hit,
                                     sample_idx, pixel, time)
    return _shadow_cost_key(cfg, tables, point, normal, offset_by, origin,
                            direction, live, receives, sample_idx, pixel,
                            vol_dist, n_de, time)


def _shadow_cost_key(cfg: ShadowCfg, tables: SceneTables, point, normal,
                     offset_by, origin, direction, live, receives,
                     sample_idx, pixel, vol_dist, n_de=None, time=None):
    """shade_pallas._shadow_cost_key: the summed segment costs of the NEE
    sites and of the volume sites at distances `vol_dist` ([VM*L] rows of
    [N]), the lights at each ray's `time`. The scene must have an SDF."""
    d = direction.unbind(-1)
    v = dict(p=point.unbind(-1), n=normal.unbind(-1), off=offset_by,
             o=origin.unbind(-1), d=d, sidx=sample_idx, pix=pixel, tm=time)
    p_x, p_y, p_z = v["p"]
    n_x, n_y, n_z = v["n"]
    key = torch.zeros_like(p_x)
    for i in range(cfg.L):
        ex, ey, ez, _pdf, _em, _pair = _nee_site(cfg, tables, i, v)
        wfx, wfy, wfz = ex - p_x, ey - p_y, ez - p_z
        dist = _sqrt(wfx * wfx + wfy * wfy + wfz * wfz)
        dinv = 1.0 / dist
        ndw = n_x * wfx * dinv + n_y * wfy * dinv + n_z * wfz * dinv
        bias = torch.where(torch.signbit(ndw), -offset_by, offset_by)
        start = (p_x + n_x * bias, p_y + n_y * bias, p_z + n_z * bias)
        act = receives & (ndw > 0.0)
        key = key + _segment_cost(cfg, start, (ex, ey, ez), act)
        if n_de is not None:
            n_de += act.to(n_de.dtype) * len(cfg.sdfs)
    for j in range(cfg.VM * cfg.L):
        sp, e, _pdf, _em = _vol_site(cfg, tables, j, vol_dist[j], v)
        key = key + _segment_cost(cfg, sp, e, live)
        if n_de is not None:
            n_de += live.to(n_de.dtype) * len(cfg.sdfs)
    return key


# --------------------------------------------------------------------------
# CUDA wrappers
# --------------------------------------------------------------------------

class _Sampler(ctypes.Structure):
    _fields_ = [("hash", ctypes.c_int), ("frame", ctypes.c_uint32),
                ("num_1d_sets", ctypes.c_int),
                ("a1_lo", ctypes.c_uint32), ("a1_hi", ctypes.c_uint32),
                ("a2_lo", ctypes.c_uint32 * 2),
                ("a2_hi", ctypes.c_uint32 * 2)]


class _ShadowScalars(ctypes.Structure):
    _fields_ = [
        ("smp", _Sampler), ("mb", _build.MBox),
        ("L", ctypes.c_int), ("VM", ctypes.c_int), ("NL", ctypes.c_int),
        ("K", ctypes.c_int), ("has_ext", ctypes.c_int),
        ("has_sdf", ctypes.c_int),
        ("max_steps", ctypes.c_int),
        ("bv_r", ctypes.c_float), ("bv_r2", ctypes.c_float),
        ("eps_c", ctypes.c_float), ("eps_l", ctypes.c_float),
        ("correction", ctypes.c_float), ("vm_correction", ctypes.c_float),
        ("sigma_t", ctypes.c_float), ("sigma_s", ctypes.c_float),
        ("compat_reflect", ctypes.c_int), ("compat_phi", ctypes.c_int),
        ("set_fres", ctypes.c_int), ("set_diff", ctypes.c_int),
        ("set_spec", ctypes.c_int), ("set_rr", ctypes.c_int),
        ("roulette_on", ctypes.c_int), ("terminate_all", ctypes.c_int),
        ("aov", ctypes.c_int), ("mis", ctypes.c_int), ("mis_on", ctypes.c_int),
        ("set_pick0", ctypes.c_int),
        ("set_nee0", ctypes.c_int), ("set_vol_pick0", ctypes.c_int),
        ("set_vol0", ctypes.c_int), ("set_vol_dist0", ctypes.c_int),
        ("schlick_exp", ctypes.c_float), ("anim", _build.Anim)]


_P = ctypes.c_void_p


def _ptrs(*names):
    return [(name, _P) for name in names]


class _RayCols(ctypes.Structure):
    _fields_ = _ptrs("point", "normal", "offset_by", "origin", "direction",
                     "throughput", "vol_trans", "kind", "color_a", "power",
                     "sample_idx", "pixel", "live", "recv", "time")


class _ShadowCols(ctypes.Structure):
    _fields_ = _ptrs("t_hit", "lights", "spheres")


# output columns in PathState order, each with its csrc/shade.cu name
_OUT = ("origin", "direction", "throughput", "radiance", "alive", "prev_pdf",
        "color_out", "bg_out", "alpha_out", "normal_out")


class _FinishCols(ctypes.Structure):
    _fields_ = _ptrs("color_b", "ior", "radiance", "color_out", "bg_out",
                     "alpha_out", "normal_out", "prev_pdf", "obj", "mis",
                     *(f"o_{name}" for name in _OUT))


class _SegCols(ctypes.Structure):
    _fields_ = _ptrs(*ShadowSegments._fields)


class _SegArgs(ctypes.Structure):
    _fields_ = [("r", _RayCols), ("s", _ShadowCols), ("g", _SegCols),
                ("n", ctypes.c_int64), ("sc", _ShadowScalars)]


class _SegMarchArgs(ctypes.Structure):
    _fields_ = [("geom", _P), ("q", _build.QueueMarch)]


class _SumCols(ctypes.Structure):
    _fields_ = _ptrs("k", "active", "verdict") + [("S", ctypes.c_int)]


class _ShadowSumArgs(ctypes.Structure):
    _fields_ = [("s", _SumCols), ("o_delta", _P), ("n", ctypes.c_int64)]


class _QueueSumArgs(ctypes.Structure):
    _fields_ = [("s", _SumCols), ("radiance", _P), ("o_radiance", _P),
                ("n", ctypes.c_int64)]


class _TailSumArgs(ctypes.Structure):
    _fields_ = [("r", _RayCols), ("f", _FinishCols), ("s", _SumCols),
                ("n", ctypes.c_int64), ("sc", _ShadowScalars)]


class _FinishArgs(ctypes.Structure):
    _fields_ = [("r", _RayCols), ("f", _FinishCols), ("n", ctypes.c_int64),
                ("sc", _ShadowScalars)]


class _KeyArgs(ctypes.Structure):
    _fields_ = [(name, _P) for name in (
        "point", "normal", "offset_by", "origin", "direction", "t_hit",
        "sample_idx", "pixel", "live", "recv", "time", "lights", "key")] + [
        ("n", ctypes.c_int64), ("sc", _ShadowScalars)]


def sampler_struct(frame: int, sampler_hash: bool, num_1d_sets: int):
    M = rng_mod.M32
    a2 = rng_mod.A2
    return _Sampler(int(sampler_hash), frame & M, num_1d_sets,
                    rng_mod.A1 & M, (rng_mod.A1 >> 32) & M,
                    (ctypes.c_uint32 * 2)(a2[0] & M, a2[1] & M),
                    (ctypes.c_uint32 * 2)((a2[0] >> 32) & M,
                                          (a2[1] >> 32) & M))


def _base(ids: tuple) -> int:
    """The first set id of a run of consecutive ids (the kernels derive
    site i's id as base + i)."""
    if not ids:
        return 0
    if ids != tuple(range(ids[0], ids[0] + len(ids))):
        raise ValueError(f"set ids {ids} are not consecutive")
    return ids[0]


def _anim(cfg: ShadowCfg, tables: SceneTables, dev):
    """The kernels' Anim: the light, sphere and MIS-light position
    tracks."""
    return _build.Anim(
        lights=_build.track(tables.light_knots, "light knots", cfg.NL, dev),
        spheres=_build.track(tables.sphere_knots, "sphere knots", cfg.K, dev),
        mis=_build.track(tables.mis_knots, "mis knots", cfg.K, dev))


def _scalars(cfg: ShadowCfg, tables: SceneTables, dev) -> _ShadowScalars:
    bv_r = float(cfg.sdfs[0][1]) if cfg.sdfs else 0.0
    return _ShadowScalars(anim=_anim(cfg, tables, dev),
        mb=_build.mbox_of(cfg.sdfs),
        smp=sampler_struct(cfg.frame, cfg.sampler == "hash",
                           cfg.num_1d_sets),
        L=cfg.L, VM=cfg.VM, NL=cfg.NL, K=cfg.K, has_ext=int(cfg.has_ext),
        has_sdf=int(bool(cfg.sdfs)),
        max_steps=cfg.max_steps, bv_r=bv_r, bv_r2=float(bv_r * bv_r),
        eps_c=cfg.eps_c, eps_l=cfg.eps_l,
        correction=cfg.correction, vm_correction=cfg.vm_correction,
        sigma_t=cfg.sigma_t, sigma_s=cfg.sigma_s,
        compat_reflect=int(cfg.compat_reflect),
        compat_phi=int(cfg.compat_phi), set_fres=cfg.set_fres,
        set_diff=cfg.set_diff, set_spec=cfg.set_spec, set_rr=cfg.set_rr,
        roulette_on=int(cfg.roulette_on),
        terminate_all=int(cfg.terminate_all), aov=int(cfg.aov),
        mis=int(cfg.mis), mis_on=int(cfg.mis_on),
        set_pick0=_base(cfg.set_pick), set_nee0=_base(cfg.set_nee),
        set_vol_pick0=_base(cfg.set_vol_pick), set_vol0=_base(cfg.set_vol),
        set_vol_dist0=_base(cfg.set_vol_dist), schlick_exp=5.0)


def _time_col(tables: SceneTables, time, n, dev):
    """The time column's pointer: each ray's time, which an animated
    scene needs (null for a constant scene given none)."""
    if time is None and not tables.animated:
        return None
    return check(need_time(time, "the tail kernels"), "time",
                 torch.float32, (n,), dev)


def _ray_cols(tables, state, info, mat, live, receives, vol_trans, dev):
    n = state.origin.shape[0]
    f32, i32, b8 = torch.float32, torch.int32, torch.bool
    v3, v1 = (n, 3), (n,)
    return _RayCols(
        point=check(info.point, "point", f32, v3, dev),
        normal=check(info.normal, "normal", f32, v3, dev),
        offset_by=check(info.offset_by, "offset_by", f32, v1, dev),
        origin=check(state.origin, "origin", f32, v3, dev),
        direction=check(state.direction, "direction", f32, v3, dev),
        throughput=check(state.throughput, "throughput", f32, v3, dev),
        vol_trans=check(vol_trans, "vol_trans", f32, v1, dev),
        kind=check(mat.kind, "kind", i32, v1, dev),
        color_a=check(mat.color_a, "color_a", f32, v3, dev),
        power=check(mat.power, "power", f32, v1, dev),
        sample_idx=check(state.sample_idx, "sample_idx", i32, v1, dev),
        pixel=check(state.pixel, "pixel", i32, v1, dev),
        live=check(live, "live", b8, v1, dev),
        recv=check(receives, "receives", b8, v1, dev),
        time=_time_col(tables, state.time, n, dev))


def _shadow_cols(cfg, tables, t_hit, n, dev):
    f32 = torch.float32
    return _ShadowCols(
        t_hit=check(t_hit, "t_hit", f32, (n,), dev),
        lights=check(tables.lights, "lights", f32, (cfg.NL, 8), dev),
        spheres=check(tables.spheres, "spheres", f32, (cfg.K, 4), dev))


def _finish_cols(cfg, tables, state, hit, mat, radiance, dev):
    """(the _FinishCols struct, the output tensors in PathState order)."""
    n = state.origin.shape[0]
    f32, i32, b8 = torch.float32, torch.int32, torch.bool
    v3, v1 = (n, 3), (n,)
    out = {name: torch.empty(v1 if name in ("alive", "prev_pdf", "alpha_out")
                             else v3, dtype=b8 if name == "alive" else f32,
                             device=dev) for name in _OUT}
    cols = _FinishCols(
        color_b=check(mat.color_b, "color_b", f32, v3, dev),
        ior=check(mat.ior, "ior", f32, v1, dev),
        radiance=check(radiance, "radiance", f32, v3, dev),
        color_out=check(state.color_out, "color_out", f32, v3, dev),
        bg_out=check(state.bg_out, "bg_out", f32, v3, dev),
        alpha_out=check(state.alpha_out, "alpha_out", f32, v1, dev),
        normal_out=check(state.normal_out, "normal_out", f32, v3, dev),
        prev_pdf=check(state.prev_pdf, "prev_pdf", f32, v1, dev),
        obj=check(hit.obj, "obj", i32, v1, dev),
        mis=check(tables.mis, "mis", f32, (cfg.K, 5), dev),
        **{f"o_{name}": t.data_ptr() for name, t in out.items()})
    return cols, out


def _seg_cols(segs: ShadowSegments, dev) -> dict:
    """Pointers of a segment scratch, shapes checked; S and N from
    `active`."""
    S, n = segs.active.shape
    f32, i32 = torch.float32, torch.int32
    return dict(geom=check(segs.geom, "geom", f32, (6, S, n), dev),
                k=check(segs.k, "k", f32, (3, S, n), dev),
                active=check(segs.active, "active", torch.bool, (S, n), dev),
                queue=check(segs.queue, "queue", i32, (S * n,), dev),
                count=check(segs.count, "count", i32, (1,), dev))


def _sum_cols(segs: ShadowSegments, verdict, n, dev) -> _SumCols:
    S = segs.active.shape[0]
    cols = _seg_cols(segs, dev)
    return _SumCols(k=cols["k"], active=cols["active"],
                    verdict=check(verdict, "verdict", torch.bool, (S, n),
                                  dev), S=S)


def _segment_scratch(name, cfg, tables, state, info, mat, live, receives,
                     vol_trans, t_hit, dev):
    """(a fresh segment scratch, the _SegArgs of a segments kernel that
    fills it)."""
    if cfg.NL < 1:
        raise NotImplementedError(f"{name} needs a scene with lights")
    n = state.origin.shape[0]
    S = cfg.L + cfg.VM * cfg.L
    if S * n >= 2 ** 31:
        raise ValueError(f"{S} x {n} shadow segments overflow int32 ids")
    f32 = torch.float32
    segs = ShadowSegments(
        geom=torch.empty((6, S, n), dtype=f32, device=dev),
        k=torch.empty((3, S, n), dtype=f32, device=dev),
        active=torch.empty((S, n), dtype=torch.bool, device=dev),
        queue=torch.empty((S * n,), dtype=torch.int32, device=dev),
        count=torch.zeros((1,), dtype=torch.int32, device=dev))
    args = _SegArgs(
        r=_ray_cols(tables, state, info, mat, live, receives, vol_trans, dev),
        s=_shadow_cols(cfg, tables, t_hit, n, dev),
        g=_SegCols(**_seg_cols(segs, dev)), n=n,
        sc=_scalars(cfg, tables, dev))
    return segs, args


def shadow_segments(cfg: ShadowCfg, tables: SceneTables, state, info, mat,
                    live, receives, vol_trans, t_hit) -> ShadowSegments:
    """The shadow segments of one bounce (see ShadowSegments), the active
    ones queued in any order. t_hit: [N] the closest hit's t, the range
    of the volume sites' equi-angular distances."""
    dev = device_of("shadow_segments", state.origin)
    if dev is None:
        return shadow_segments_plain(cfg, tables, state, info, mat, live,
                                     receives, vol_trans, t_hit)
    segs, args = _segment_scratch("shadow_segments", cfg, tables, state,
                                  info, mat, live, receives, vol_trans,
                                  t_hit, dev)
    _build.launch("rayn_shadow_segments", args, dev)
    shadow_segments.launches += 1
    return segs


shadow_segments.launches = 0


def shadow_march(cfg: ShadowCfg, segs: ShadowSegments,
                 relax: float = 1.0) -> torch.Tensor:
    """[S, N] bool: True where an SDF instance blocks a queued segment,
    marched plain at `relax` 1 and over-relaxed otherwise, through each
    instance in turn in one launch (False for every segment of a scene
    without an SDF, with no launch)."""
    dev = device_of("shadow_march", segs.active)
    if dev is None:
        return shadow_march_plain(cfg, segs, relax)
    S, n = segs.active.shape
    verdict = torch.zeros((S, n), dtype=torch.bool, device=dev)
    if not cfg.sdfs:
        return verdict
    cols = _seg_cols(segs, dev)
    head = torch.zeros((1,), dtype=torch.int32, device=dev)
    q, sdf = _build.queue_march(cols["queue"], cols["count"], head, verdict,
                                cfg.sdfs, cfg.detail, cfg.max_steps, relax)
    _build.launch("rayn_shadow_march",
                  _build.taped(_SegMarchArgs(geom=cols["geom"], q=q), sdf),
                  dev)
    shadow_march.launches += 1
    return verdict


shadow_march.launches = 0


def shadow_sum(segs: ShadowSegments, verdict) -> torch.Tensor:
    """[N, 3] radiance delta: k * (active and not blocked) summed over the
    segments in order."""
    dev = device_of("shadow_sum", segs.active)
    if dev is None:
        return shadow_sum_plain(segs, verdict)
    n = segs.active.shape[1]
    delta = torch.empty((n, 3), dtype=torch.float32, device=dev)
    args = _ShadowSumArgs(s=_sum_cols(segs, verdict, n, dev),
                          o_delta=delta.data_ptr(), n=n)
    _build.launch("rayn_shadow_sum", args, dev)
    shadow_sum.launches += 1
    return delta


shadow_sum.launches = 0


def tail_sum(cfg: ShadowCfg, tables: SceneTables, state, hit, info, mat,
             live, receives, vol_trans, segs: ShadowSegments,
             verdict) -> dict:
    """The next PathState fields (see bounce_tail_plain) from state
    radiance + the segments' delta."""
    dev = device_of("tail_sum", state.origin)
    if dev is None:
        return tail_sum_plain(cfg, tables, state, hit, info, mat, live,
                              receives, vol_trans, segs, verdict)
    n = state.origin.shape[0]
    fcols, out = _finish_cols(cfg, tables, state, hit, mat, state.radiance,
                              dev)
    args = _TailSumArgs(
        r=_ray_cols(tables, state, info, mat, live, receives, vol_trans, dev),
        f=fcols, s=_sum_cols(segs, verdict, n, dev), n=n,
        sc=_scalars(cfg, tables, dev))
    _build.launch("rayn_tail_sum", args, dev)
    tail_sum.launches += 1
    return out


tail_sum.launches = 0


def queue_segments(cfg: ShadowCfg, tables: SceneTables, state, info, mat,
                   live, receives, vol_trans, t_hit) -> ShadowSegments:
    """The shadow segments of one segment-queue bounce (see
    ShadowSegments and queue_segments_plain), the active ones queued in
    any order. t_hit: [N] the closest hit's t."""
    dev = device_of("queue_segments", state.origin)
    if dev is None:
        return queue_segments_plain(cfg, tables, state, info, mat, live,
                                    receives, vol_trans, t_hit)
    segs, args = _segment_scratch("queue_segments", cfg, tables, state, info,
                                  mat, live, receives, vol_trans, t_hit, dev)
    _build.launch("rayn_queue_segments", args, dev)
    queue_segments.launches += 1
    return segs


queue_segments.launches = 0


def queue_sum(radiance, segs: ShadowSegments, verdict) -> torch.Tensor:
    """[N, 3]: radiance + k * (active and not blocked) of each segment in
    turn, in segment order."""
    dev = device_of("queue_sum", segs.active)
    if dev is None:
        return queue_sum_plain(radiance, segs, verdict)
    n = segs.active.shape[1]
    out = torch.empty((n, 3), dtype=torch.float32, device=dev)
    args = _QueueSumArgs(
        s=_sum_cols(segs, verdict, n, dev),
        radiance=check(radiance, "radiance", torch.float32, (n, 3), dev),
        o_radiance=out.data_ptr(), n=n)
    _build.launch("rayn_queue_sum", args, dev)
    queue_sum.launches += 1
    return out


queue_sum.launches = 0


def bounce_tail(cfg: ShadowCfg, tables: SceneTables, state, hit, info, mat,
                live, receives, vol_trans, t_hit) -> dict:
    """Whole bounce tail of one bounce: segments, march, sum and finish.
    t_hit: [N] the closest hit's t. Returns the next PathState fields
    (see bounce_tail_plain)."""
    segs = shadow_segments(cfg, tables, state, info, mat, live, receives,
                           vol_trans, t_hit)
    return tail_sum(cfg, tables, state, hit, info, mat, live, receives,
                    vol_trans, segs, shadow_march(cfg, segs))


def shadow_radiance(cfg: ShadowCfg, tables: SceneTables, state, info, mat,
                    live, receives, vol_trans, t_hit) -> torch.Tensor:
    """[N, 3] radiance delta of one bounce's NEE and volume segments:
    segments, march, sum (see shadow_radiance_plain). t_hit: [N] the
    closest hit's t."""
    segs = shadow_segments(cfg, tables, state, info, mat, live, receives,
                           vol_trans, t_hit)
    return shadow_sum(segs, shadow_march(cfg, segs))


def finish_bounce(cfg: ShadowCfg, tables: SceneTables, state, hit, info, mat,
                  live, receives, vol_trans, radiance) -> dict:
    """The next PathState fields from the pre-emission radiance [N, 3]
    (state radiance + shadow delta; see finish_bounce_plain)."""
    dev = device_of("finish_bounce", state.origin)
    if dev is None:
        return finish_bounce_plain(cfg, tables, state, hit, info, mat, live,
                                   receives, vol_trans, radiance)
    fcols, out = _finish_cols(cfg, tables, state, hit, mat, radiance, dev)
    args = _FinishArgs(
        r=_ray_cols(tables, state, info, mat, live, receives, vol_trans, dev),
        f=fcols, n=state.origin.shape[0], sc=_scalars(cfg, tables, dev))
    _build.launch("rayn_finish_bounce", args, dev)
    finish_bounce.launches += 1
    return out


finish_bounce.launches = 0


def shadow_sort_key(cfg: ShadowCfg, tables: SceneTables, point, normal,
                    offset_by, origin, direction, t_hit, live, receives,
                    sample_idx, pixel, time=None) -> torch.Tensor:
    """[N] f32 cost key of one bounce's shadow segments (scheduling only:
    it never feeds a verdict or a radiance term). t_hit: the closest
    hit's t, the range of the volume sites' distances; time: each ray's
    time, which a scene with animated lights needs."""
    dev = device_of("shadow_sort_key", point)
    if dev is None:
        return shadow_sort_key_plain(cfg, tables, point, normal, offset_by,
                                     origin, direction, t_hit, live,
                                     receives, sample_idx, pixel, time)
    if cfg.NL < 1:
        raise NotImplementedError("shadow_sort_key needs a scene with lights")
    n = point.shape[0]
    f32, i32, b8 = torch.float32, torch.int32, torch.bool
    key = torch.empty((n,), dtype=f32, device=dev)
    v3, v1 = (n, 3), (n,)
    args = _KeyArgs(
        point=check(point, "point", f32, v3, dev),
        normal=check(normal, "normal", f32, v3, dev),
        offset_by=check(offset_by, "offset_by", f32, v1, dev),
        origin=check(origin, "origin", f32, v3, dev),
        direction=check(direction, "direction", f32, v3, dev),
        t_hit=check(t_hit, "t_hit", f32, v1, dev),
        sample_idx=check(sample_idx, "sample_idx", i32, v1, dev),
        pixel=check(pixel, "pixel", i32, v1, dev),
        live=check(live, "live", b8, v1, dev),
        recv=check(receives, "receives", b8, v1, dev),
        time=_time_col(tables, time, n, dev),
        lights=check(tables.lights, "lights", f32, (cfg.NL, 8), dev),
        key=key.data_ptr(), n=n, sc=_scalars(cfg, tables, dev))
    sdf = _build.sdf_args([(p, 0, bv) for p, bv in cfg.sdfs], dev, n,
                          persistent=False)[1]
    _build.launch("rayn_shadow_sort_key", _build.taped(args, sdf), dev)
    shadow_sort_key.launches += 1
    return key


shadow_sort_key.launches = 0
