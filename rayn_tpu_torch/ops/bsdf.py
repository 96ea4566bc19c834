"""Material evaluation over the wavefront (port of rayn_tpu.ops.bsdf).

Materials are a tagged parameter table; each ray gathers its parameters
by material id and every BSDF variant is evaluated with masked selects.
Lambertian and Dielectric follow reference src/material.rs:117-256; Sky
and Emissive are non-receiving emitters; Metallic and Refractive are the
working versions of the reference's commented-out stubs.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rayn_tpu_torch.config import RenderSettings
from rayn_tpu_torch.scene.scene import (DIELECTRIC, EMISSIVE, LAMBERT,
                                        METALLIC, REFRACTIVE, SKY, Materials)
from rayn_tpu_torch.utils import sampling, vecmath
from rayn_tpu_torch.utils.vecmath import sqrt as _sqrt

F0 = 0.04                # reference src/material.rs:197, :247
F32_EPS = 1.1920929e-07  # f32::EPSILON (reference src/material.rs:236)


class MatParams(NamedTuple):
    """Per-ray gathered material parameters."""
    kind: torch.Tensor     # [N] int32
    color_a: torch.Tensor  # [N, 3]
    color_b: torch.Tensor  # [N, 3]
    power: torch.Tensor    # [N]
    ior: torch.Tensor      # [N]


def gather(materials: Materials, mat_id: torch.Tensor) -> MatParams:
    """Per-ray material parameters (plain indexing: the JAX package's
    one-hot `small_gather` existed only for the TPU)."""
    idx = mat_id.long()
    return MatParams(kind=materials.kind[idx], color_a=materials.color_a[idx],
                     color_b=materials.color_b[idx],
                     power=materials.power[idx], ior=materials.ior[idx])


def receives_light(p: MatParams) -> torch.Tensor:
    """[N] bool: the surface scatters further light."""
    return ((p.kind == LAMBERT) | (p.kind == DIELECTRIC)
            | (p.kind == METALLIC) | (p.kind == REFRACTIVE))


def emitted(p: MatParams, wo: torch.Tensor) -> torch.Tensor:
    """le(wo) [N, 3]: sky gradient or emission (reference
    src/material.rs:444-448, :489-520)."""
    t = 0.5 * (wo[:, 1:2] + 1.0)
    sky_le = p.color_a * (1.0 - t) + p.color_b * t
    zero = torch.zeros_like(sky_le)
    le = torch.where((p.kind == SKY)[:, None], sky_le, zero)
    return torch.where((p.kind == EMISSIVE)[:, None], p.color_b, le)


def eval_f(p: MatParams, wo, wi, n) -> torch.Tensor:
    """BSDF value f(wo, wi) [N, 3] for NEE; non-receiving kinds give 0."""
    lambert_f = vecmath.div(p.color_a, sampling.PI)
    d = torch.clamp(vecmath.dot(wi, n), min=0.0)
    fresnel = sampling.f_schlick(d, F0)
    half = vecmath.normalize(wo + wi, eps=1e-20)
    cos_alpha = torch.clamp(vecmath.dot(half, n), min=0.0) ** p.power
    spec_factor = vecmath.div(cos_alpha * (p.power + 2.0), 2.0 * sampling.PI)
    spec_f = (spec_factor * fresnel)[:, None]
    diel_f = spec_f + lambert_f * (1.0 - fresnel)[:, None]
    fres_c = p.color_a + (1.0 - p.color_a) * ((1.0 - d) ** 5)[:, None]
    metal_f = fres_c * spec_factor[:, None]
    f = torch.where((p.kind == LAMBERT)[:, None], lambert_f,
                    torch.zeros_like(lambert_f))
    f = torch.where((p.kind == DIELECTRIC)[:, None], diel_f, f)
    return torch.where((p.kind == METALLIC)[:, None], metal_f, f)


def eval_pdf(p: MatParams, settings: RenderSettings, wo, wi, n):
    """Solid-angle pdf [N] with which `scatter` would have sampled wi,
    for the MIS weights: Lambert cosine, Dielectric Fresnel-mixed
    cosine/Phong, Metallic Phong; 0 for the other kinds (no NEE)."""
    cos_i = torch.clamp(vecmath.dot(wi, n), min=0.0)
    lambert_pdf = vecmath.div(cos_i, sampling.PI)
    diffuse_pdf = torch.clamp(lambert_pdf, min=1e-5)  # src/material.rs:223
    if settings.compat_spec_reflect:
        reflection = vecmath.reflect_glsl(wo, n)
    else:
        reflection = vecmath.reflect(wo, n)
    cos_alpha = torch.clamp(vecmath.dot(reflection, wi), min=0.0)
    cos_alpha_pow = torch.clamp(cos_alpha ** p.power, min=F32_EPS)
    spec_pdf = vecmath.div(p.power + 1.0, sampling.TWO_PI) * cos_alpha_pow
    fresnel = sampling.f_schlick(torch.abs(vecmath.dot(n, wo)), F0)
    diel_pdf = fresnel * spec_pdf + (1.0 - fresnel) * diffuse_pdf
    zero = torch.zeros_like(lambert_pdf)
    pdf = torch.where(p.kind == LAMBERT, lambert_pdf, zero)
    pdf = torch.where(p.kind == DIELECTRIC, diel_pdf, pdf)
    return torch.where(p.kind == METALLIC, spec_pdf, pdf)


class ScatterEvent(NamedTuple):
    wi: torch.Tensor   # [N, 3]
    f: torch.Tensor    # [N, 3]
    pdf: torch.Tensor  # [N]


def scatter(p: MatParams, settings: RenderSettings, wo, normal, u_fresnel,
            u_diffuse, u_spec) -> ScatterEvent:
    """Importance-sample the BSDF (reference src/material.rs:118-137,
    :207-256, plus the Metallic and Refractive variants)."""
    uu, vv = vecmath.orthonormal_basis(normal)
    ds = sampling.cosine_hemisphere(u_diffuse[:, 0], u_diffuse[:, 1])
    diffuse_bounce = vecmath.normalize(
        vecmath.basis_transform(uu, vv, normal, ds))
    lambert_pdf = vecmath.div(ds[:, 2], sampling.PI)
    diffuse_pdf = torch.clamp(lambert_pdf, min=1e-5)
    diffuse_f = vecmath.div(p.color_a, sampling.PI)

    if settings.compat_spec_reflect:
        reflection = vecmath.reflect_glsl(wo, normal)
    else:
        reflection = vecmath.reflect(wo, normal)
    ru, rv = vecmath.orthonormal_basis(reflection)
    ss = sampling.cosine_power_hemisphere(
        u_spec[:, 0], u_spec[:, 1], p.power,
        compat_phi=settings.compat_spec_phi)
    spec_bounce = vecmath.normalize(
        vecmath.basis_transform(ru, rv, reflection, ss))
    cos_alpha_pow = torch.clamp(ss[:, 2] ** p.power, min=F32_EPS)
    spec_pdf = vecmath.div(p.power + 1.0, sampling.TWO_PI) * cos_alpha_pow
    spec_coeff = vecmath.div(p.power + 2.0, sampling.TWO_PI) * cos_alpha_pow
    below = vecmath.dot(normal, spec_bounce) < 0.0
    spec_coeff = torch.where(below, torch.zeros_like(spec_coeff), spec_coeff)
    spec_f = spec_coeff[:, None].expand_as(diffuse_f)

    cos = torch.abs(vecmath.dot(normal, wo))
    fresnel = sampling.f_schlick(cos, F0)
    take_spec = u_fresnel < fresnel
    diel_wi = torch.where(take_spec[:, None], spec_bounce, diffuse_bounce)
    diel_f = torch.where(take_spec[:, None], spec_f, diffuse_f)
    diel_pdf = fresnel * spec_pdf + (1.0 - fresnel) * diffuse_pdf

    is_diel = p.kind == DIELECTRIC
    wi = torch.where(is_diel[:, None], diel_wi, diffuse_bounce)
    f = torch.where(is_diel[:, None], diel_f, diffuse_f)
    pdf = torch.where(is_diel, diel_pdf, lambert_pdf)

    is_metal = p.kind == METALLIC
    fres_c = p.color_a + (1.0 - p.color_a) * ((1.0 - cos) ** 5)[:, None]
    metal_f = fres_c * spec_coeff[:, None]
    wi = torch.where(is_metal[:, None], spec_bounce, wi)
    f = torch.where(is_metal[:, None], metal_f, f)
    pdf = torch.where(is_metal, spec_pdf, pdf)

    is_refr = p.kind == REFRACTIVE
    cos_i = vecmath.dot(wo, normal)
    entering = cos_i > 0.0
    n_ref = torch.where(entering[:, None], normal, -normal)
    eta = torch.where(entering, 1.0 / p.ior, p.ior)
    ci = torch.abs(cos_i)
    sin2_t = eta * eta * torch.clamp(1.0 - ci * ci, min=0.0)
    tir = sin2_t > 1.0
    cos_t = _sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
    refr_dir = vecmath.normalize(
        -wo * eta[:, None] + n_ref * (eta * ci - cos_t)[:, None], eps=1e-20)
    f0 = sampling.f0_from_ior(p.ior)
    fresnel_r = sampling.f_schlick(ci, f0)
    reflect_dir = vecmath.reflect(wo, n_ref)
    take_reflect = (u_fresnel < fresnel_r) | tir
    axis = torch.where(take_reflect[:, None], reflect_dir, refr_dir)
    auu, avv = vecmath.orthonormal_basis(axis)
    rs = sampling.cosine_hemisphere(u_diffuse[:, 0], u_diffuse[:, 1])
    refr_wi = vecmath.normalize(vecmath.basis_transform(auu, avv, axis, rs))
    refr_pdf = torch.clamp(vecmath.div(rs[:, 2], sampling.PI), min=1e-6)
    refr_color = torch.where(take_reflect[:, None],
                             torch.ones_like(p.color_a), p.color_a)
    ndl_r = torch.clamp(torch.abs(vecmath.dot(refr_wi, normal)), min=1e-6)
    refr_f = refr_color * (refr_pdf / ndl_r)[:, None]
    wi = torch.where(is_refr[:, None], refr_wi, wi)
    f = torch.where(is_refr[:, None], refr_f, f)
    pdf = torch.where(is_refr, refr_pdf, pdf)
    return ScatterEvent(wi, f, pdf)
