"""The plain reference: a path tracer in NumPy over a batch of samples.

A frozen copy of the repository's scalar oracle (tests/oracle.py,
tests/oracle_renderer.py), with the loops over samples turned into
array operations over the batch, and these departures:

- the sampler streams are computed here (sampler.py), not taken from
  the renderer's packages;
- the filter-importance table is built here (filters.py);
- the scene comes from the configuration file (scene.py), whose sphere
  lights are sampled for next-event estimation and whose homogeneous
  volume adds equi-angular single scattering toward each light sample,
  as the oracle does; the renderer's alternative routes (sorts, fused
  kernels, queues) give the same per-sample semantics and are not
  modelled;
- static scenes and the pinhole camera only, and the "rd" sampler; MIS,
  thin lenses and motion are outside its scope;
- it works in a chosen precision (precision.py): float64 for the
  reference, bfloat16 for the control.

Per sample: a camera ray through the pixel's filter-distributed offset;
per bounce: the closest hit over the analytic spheres and the sphere
traced MandelBox (cone-traced hit threshold, tetrahedral normal, origin
offset), emission of sky and emissive surfaces, next-event estimation
toward `nee_light_samples` lights picked uniformly (visible-cap cone
samples, shadow rays against spheres and the MandelBox), equi-angular
volume scattering toward `volume_marches` x `nee_light_samples` light
samples, BSDF sampling (lambert, dielectric, metallic, refractive) and
Russian roulette past depth 2. A pixel's value is the mean of its
samples: color, background (emitters seen at depth 0), alpha and the
depth-0 normal of receiving surfaces.
"""

from __future__ import annotations

import numpy as np

from . import filters
from .precision import FLOAT64, Precision
from .sampler import Layout, Streams
from .scene import (DIELECTRIC, EMISSIVE, LAMBERT, METALLIC, REFRACTIVE,
                    SKY, Scene)

PI = np.pi
F32_EPS = 1.1920929e-07


def dot(a, b):
    return a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1] + a[:, 2] * b[:, 2]


def norm(a):
    return np.sqrt(dot(a, a))


def normalize(a):
    return a / norm(a)[:, None]


def onb(n):
    ks = np.where(n[:, 2] >= 0.0, 1.0, -1.0)
    ka = 1.0 / (1.0 + np.abs(n[:, 2]))
    kb = -ks * n[:, 0] * n[:, 1] * ka
    uu = np.stack([1.0 - n[:, 0] * n[:, 0] * ka, ks * kb, -ks * n[:, 0]], -1)
    vv = np.stack([kb, ks - n[:, 1] * n[:, 1] * ka * ks, -n[:, 1]], -1)
    return uu, vv


def along(uu, vv, ww, s):
    return uu * s[:, 0:1] + vv * s[:, 1:2] + ww * s[:, 2:3]


def concentric_disk(u, v):
    a = u * 2.0 - 1.0
    b = v * 2.0 - 1.0
    b = np.where((a == 0.0) & (b == 0.0), 1e-4, b)
    a_safe = np.where(a == 0.0, 1.0, a)
    b_safe = np.where(b == 0.0, 1.0, b)
    take1 = a * a > b * b
    r = np.where(take1, a, b)
    phi = np.where(take1, (PI / 4) * b / a_safe,
                   PI / 2 - (PI / 4) * a / b_safe)
    return r * np.cos(phi), r * np.sin(phi)


def cosine_hemisphere(u, v):
    x, y = concentric_disk(u, v)
    z = np.sqrt(1.0 - np.minimum(x * x + y * y, 1.0))
    return np.stack([x, y, z], -1)


def cosine_power(u, v, power):
    a = u ** (1.0 / (power + 1.0))
    b = np.sqrt(np.maximum(1.0 - a * a, 0.0))
    phi = v * (2 * PI)
    return np.stack([b * np.cos(phi), b * np.sin(phi), a], -1)


def schlick(c, f0):
    m = 1.0 - c
    return f0 + (1.0 - f0) * (m * m * m * m * m)


def mandelbox(p, sdf):
    """Distance estimate of the MandelBox (reference src/sdf.rs:126-141)."""
    x, y, z = p[:, 0], p[:, 1], p[:, 2]
    ox, oy, oz = x, y, z
    dr = np.ones_like(x)
    lo, hi = -sdf["box_l"], sdf["box_l"]
    for _ in range(sdf["iterations"]):
        x = np.clip(x, lo, hi) * 2.0 - x
        y = np.clip(y, lo, hi) * 2.0 - y
        z = np.clip(z, lo, hi) * 2.0 - z
        r2 = x * x + y * y + z * z
        mul = np.maximum(sdf["fixed_rad2"] / np.maximum(r2, sdf["min_rad2"]),
                         1.0)
        x, y, z = x * mul, y * mul, z * mul
        dr = dr * mul
        x = x * sdf["scale"] + ox
        y = y * sdf["scale"] + oy
        z = z * sdf["scale"] + oz
        dr = -dr * sdf["scale"] + 1.0
    return np.sqrt(x * x + y * y + z * z) / np.abs(dr)


class Tracer:
    def __init__(self, config: dict, prec: Precision = FLOAT64):
        self.prec = prec
        st = config["settings"]
        self.scene = Scene(config)
        self.spp = int(st["spp"])
        self.max_bounces = int(st["max_bounces"])
        self.L = int(st["nee_light_samples"])
        self.VM = int(st["volume_marches"])
        self.world_radius = float(st["world_radius"])
        self.detail = float(st["sdf_detail_scale"])
        self.max_marches = int(st["max_marches"])
        self.max_vis = int(st["max_vis_marches"])
        for key, want in (("mis", False), ("sampler", "rd"),
                          ("shadow_de_iterations", 0),
                          ("shadow_eps_scale", 1.0),
                          ("compat_spec_phi", False),
                          ("compat_spec_reflect", False)):
            if st.get(key, want) != want:
                raise ValueError(f"the reference renders {key}={want!r} "
                                 f"only")
        flt = config["filter"]
        self.fis = filters.fis_table(flt["name"], flt["radius"],
                                     int(st["filter_table_size"]))
        self.layout = Layout(self.L, self.VM, self.max_bounces)
        f = prec.f
        sc = self.scene
        self.centers = f(sc.centers)
        self.radii = f(sc.radii)
        self.color_a = f(sc.color_a)
        self.color_b = f(sc.color_b)
        self.power = f(sc.power)
        self.ior = f(sc.ior)
        self.light_pos = f(sc.light_pos)
        self.light_rad = f(sc.light_rad)
        self.light_emit = f(sc.light_emit)

    # ---- geometry ----------------------------------------------------
    def de(self, p):
        return mandelbox(p, self.scene.sdf)

    def sphere_hits(self, o, d, t_max):
        """Closest analytic sphere hit: (t, sphere id or -1)."""
        best = t_max.copy()
        idx = np.full(o.shape[0], -1, np.int64)
        for k in range(self.scene.n_spheres):
            oc = o - self.centers[k]
            b = dot(oc, d)
            c = dot(oc, oc) - self.radii[k] * self.radii[k]
            disc = b * b - c
            ok = disc > 0.0
            sq = np.sqrt(np.where(ok, disc, 0.0))
            t1, t2 = -b - sq, -b + sq
            v1 = ok & (t1 > 1e-4) & (t1 <= best)
            v2 = ok & (t2 > 1e-4) & (t2 <= best)
            t = np.where(v1, t1, t2)
            take = (v1 | v2) & (t < best)
            best = np.where(take, t, best)
            idx = np.where(take, k, idx)
        return best, idx

    def march(self, o, d, t_max, eps_lin):
        """Sphere trace (reference src/sdf.rs:59-83): t starts at the DE
        of the origin and stops where |DE| < max(eps, eps_lin * t), past
        t_max, or after max_marches steps."""
        eps_c = 5e-5 * self.detail
        t = self.de(o)
        live = np.nonzero(~np.isnan(t))[0]
        for _ in range(self.max_marches):
            if live.size == 0:
                break
            tt = t[live]
            dist = self.de(o[live] + tt[:, None] * d[live])
            thresh = np.maximum(eps_c, eps_lin * tt)
            done = (np.abs(dist) < thresh) | (tt > t_max[live])
            t[live] = np.where(done, tt, tt + dist)
            live = live[~done]
        return t

    def closest_hit(self, o, d, hl):
        t_max = self.prec.f(np.full(o.shape[0], 2.0 * self.world_radius))
        best, obj = self.sphere_hits(o, d, t_max)
        if self.scene.sdf is not None:
            t = self.march(o, d, best, 0.05 * self.detail * hl)
            take = ~np.isnan(t) & (t < best)
            best = np.where(take, t, best)
            obj = np.where(take, self.scene.n_spheres, obj)
        return best, obj

    def occluded(self, a, b):
        """[M] bool: the segment a -> b is blocked by a sphere or the
        MandelBox (reference src/sdf.rs:25-57)."""
        seg = b - a
        dist = norm(seg)
        d = seg / dist[:, None]
        blocked = np.zeros(a.shape[0], bool)
        for k in range(self.scene.n_spheres):
            oc = a - self.centers[k]
            bq = dot(oc, d)
            cq = dot(oc, oc) - self.radii[k] * self.radii[k]
            disc = bq * bq - cq
            ok = disc > 0.0
            sq = np.sqrt(np.where(ok, disc, 0.0))
            t1, t2 = -bq - sq, -bq + sq
            blocked |= ok & (np.minimum(t1, t2) > 1e-3) & (t1 <= dist)
        if self.scene.sdf is None:
            return blocked
        eps_c = 1e-4 * self.detail
        eps_l = 1e-5 * self.detail
        t = self.de(a)
        live = np.nonzero(~blocked & ~np.isnan(t))[0]
        for _ in range(self.max_vis):
            if live.size == 0:
                break
            tt = t[live]
            past = tt > dist[live]
            live, tt = live[~past], tt[~past]
            dd = self.de(a[live] + tt[:, None] * d[live])
            hit = np.abs(dd) < np.maximum(eps_c, eps_l * tt)
            blocked[live[hit]] = tt[hit] <= dist[live[hit]]
            t[live] = tt + dd
            live = live[~hit]
        return blocked

    def normal(self, p, eps):
        ks = ((1.0, -1.0, -1.0), (-1.0, 1.0, -1.0), (-1.0, -1.0, 1.0),
              (1.0, 1.0, 1.0))
        n = self.prec.zeros(p.shape)
        for k in ks:
            kv = self.prec.f(k)
            n = n + kv * self.de(p + kv * eps[:, None])[:, None]
        return normalize(n)

    # ---- lights ------------------------------------------------------
    def pick(self, u):
        nl = self.scene.n_lights
        return np.minimum((np.asarray(u, np.float64) * nl).astype(np.int64),
                          nl - 1)

    def cone_sample(self, u, li, p):
        """Visible-cap sample of light li seen from p: (point, pdf)
        (reference src/light.rs:38-72)."""
        lp = self.light_pos[li]
        rad = self.light_rad[li]
        to = lp - p
        dist_sq = dot(to, to)
        dist = np.sqrt(dist_sq)
        nor = -(to / dist[:, None])
        uu, vv = onb(nor)
        r2 = rad * rad
        cos_max = np.sqrt(np.maximum(1.0 - r2 / dist_sq, 0.0))
        u0, u1 = self.prec.f(u[:, 0]), self.prec.f(u[:, 1])
        cos_t = (1.0 - u0) + u0 * cos_max
        sin_t = np.sqrt(np.maximum(1.0 - cos_t * cos_t, 0.0))
        phi = u1 * (2 * PI)
        ds = dist * cos_t - np.sqrt(np.maximum(r2 - dist_sq * sin_t * sin_t,
                                               0.0))
        cos_a = (dist_sq + r2 - ds * ds) / (2.0 * dist * rad)
        sin_a = np.sqrt(np.maximum(1.0 - cos_a * cos_a, 0.0))
        off = (uu * (sin_a * np.cos(phi))[:, None]
               + vv * (sin_a * np.sin(phi))[:, None] + nor * cos_a[:, None])
        return lp + off * rad[:, None], 1.0 / ((2 * PI) * (1.0 - cos_max))

    def equi_angular(self, u, li, o, d, t_max):
        """Equi-angular distance toward light li along the ray (Kulla and
        Fajardo; reference src/light.rs:75-102): (distance, pdf)."""
        lp = self.light_pos[li]
        delta = dot(lp - o, d)
        dl = norm(o + delta[:, None] * d - lp)
        ta = np.arctan2(-delta, dl)
        tb = np.arctan2(t_max - delta, dl)
        th = ta + (tb - ta) * self.prec.f(u)
        t = dl * np.tan(th)
        return delta + t, dl / ((tb - ta) * (dl * dl + t * t))

    def transmittance(self, dist):
        if self.scene.sigma_t is None:
            return self.prec.ones(dist.shape)
        return np.exp(dist * -self.scene.sigma_t)

    def eval_f(self, kind, c_a, power, wo, wi, n):
        """BSDF value for next-event estimation (refractive: none)."""
        ndl = np.maximum(dot(n, wi), 0.0)
        fr = schlick(ndl, 0.04)
        half = normalize(wo + wi)
        spec = (np.maximum(dot(half, n), 0.0) ** power * (power + 2.0)
                / (2 * PI))
        lam = c_a / PI
        diel = (spec * fr)[:, None] + lam * (1.0 - fr)[:, None]
        metal = (c_a + (1.0 - c_a) * ((1.0 - ndl) ** 5)[:, None]) \
            * spec[:, None]
        f = np.where((kind == LAMBERT)[:, None], lam, 0.0 * lam)
        f = np.where((kind == DIELECTRIC)[:, None], diel, f)
        return np.where((kind == METALLIC)[:, None], metal, f)

    # ---- the integrator ----------------------------------------------
    def render(self, frame, pixel) -> dict:
        """Mean color [P, 3], background [P, 3], alpha [P] and normal
        [P, 3] of pixels `pixel` of frames `frame` ([P] each), from
        sample indices [0, spp)."""
        frame = np.asarray(frame, np.int64)
        pixel = np.asarray(pixel, np.int64)
        P, S = pixel.shape[0], self.spp
        N = P * S
        pix = np.repeat(pixel, S)
        streams = Streams(self.layout, np.repeat(frame, S), pix,
                          np.tile(np.arange(S), P))
        prec, f, sc = self.prec, self.prec.f, self.scene
        lay = self.layout

        # camera rays (reference src/film.rs:456-527)
        w, h = sc.width, sc.height
        u_px = streams.u2(lay.pixel_uv())
        ox = filters.fis_offset(self.fis, u_px[:, 0], prec)
        oy = filters.fis_offset(self.fis, u_px[:, 1], prec)
        ndc_x = (f(pix % w) + 0.5 + ox) / w
        ndc_y = (f(pix // w) + 0.5 + oy) / h
        org = f(sc.cam_origin)
        d = (f(sc.cam_lower_left) + f(sc.cam_u) * sc.cam_span[0]
             * ndc_x[:, None] + f(sc.cam_v) * sc.cam_span[1]
             * ndc_y[:, None] - org)
        d = normalize(d)
        o = d * 0.0 + org
        tp = prec.ones((N, 3))
        rad = prec.zeros((N, 3))
        color = prec.zeros((N, 3))
        background = prec.zeros((N, 3))
        normal_out = prec.zeros((N, 3))
        alpha = prec.zeros(N)
        alive = np.ones(N, bool)
        nl = sc.n_lights

        for depth in range(self.max_bounces + 1):
            a = np.nonzero(alive)[0]
            if a.size == 0:
                break
            hl = sc.hps if depth == 0 else 2e-4 * depth
            t, obj = self.closest_hit(o[a], d[a], hl)
            miss = obj < 0
            alive[a[miss]] = False
            a, t, obj = a[~miss], t[~miss], obj[~miss]
            if a.size == 0:
                break
            st = streams.take(a)
            oa, da, tpa = o[a], d[a], tp[a]
            p = oa + t[:, None] * da
            is_sdf = obj >= sc.n_spheres
            sph = np.minimum(obj, sc.n_spheres - 1)
            n = normalize(p - self.centers[sph])
            offset_by = prec.zeros(a.size)
            mat = sc.sphere_mat[sph]
            if sc.sdf is not None and is_sdf.any():
                k = np.nonzero(is_sdf)[0]
                eps = np.maximum(t[k] * (self.detail * hl), 1e-4)
                n[k] = self.normal(p[k], eps)
                offset_by[k] = eps
                mat = np.where(is_sdf, sc.sdf_mat, mat)
            kind = sc.kind[mat]
            c_a = self.color_a[mat]
            power = self.power[mat]
            wo = -da
            vol_tr = self.transmittance(t)
            ra = rad[a]

            # emission of the sky and of emissive surfaces
            tt = (wo[:, 1] + 1.0) * 0.5
            sky = c_a * (1.0 - tt)[:, None] + self.color_b[mat] * tt[:, None]
            le = np.where((kind == SKY)[:, None], sky, 0.0 * sky)
            le = np.where((kind == EMISSIVE)[:, None], self.color_b[mat], le)
            ra = ra + le * tpa * vol_tr[:, None]
            receives = ((kind == LAMBERT) | (kind == DIELECTRIC)
                        | (kind == METALLIC) | (kind == REFRACTIVE))

            # next-event estimation (no light reaches a refractive lobe)
            if nl:
                corr = nl / self.L
                for i in range(self.L):
                    li = self.pick(st.u1(lay.light_pick(depth, i)))
                    lpt, pdf = self.cone_sample(st.u2(lay.nee(depth, i)),
                                                li, p)
                    full = lpt - p
                    dist = norm(full)
                    wi = full / dist[:, None]
                    ndw = dot(n, wi)
                    ndl = np.maximum(ndw, 0.0)
                    start = p + n * (np.sign(ndw) * offset_by)[:, None]
                    use = np.nonzero(receives & (kind != REFRACTIVE))[0]
                    vis = np.zeros(a.size, bool)
                    vis[use] = ~self.occluded(start[use], lpt[use])
                    fv = self.eval_f(kind, c_a, power, wo, wi, n)
                    contrib = (self.light_emit[li] * fv * ndl[:, None]
                               * self.transmittance(dist)[:, None]
                               / pdf[:, None] * tpa * corr
                               * vol_tr[:, None])
                    ra = ra + np.where(vis[:, None], contrib, 0.0 * contrib)

            # single scattering in the volume, toward each light sample
            if sc.sigma_s is not None and nl:
                vc = nl / self.L / self.VM
                for m in range(self.VM):
                    ud = st.u1(lay.vol_dist(depth, m))
                    for i in range(self.L):
                        li = self.pick(st.u1(lay.vol_pick(depth, m, i)))
                        vd, vpdf = self.equi_angular(ud, li, oa, da, t)
                        sp = oa + vd[:, None] * da
                        lpt, lpdf = self.cone_sample(
                            st.u2(lay.vol(depth, m, i)), li, sp)
                        dpl = norm(lpt - sp)
                        vis = ~self.occluded(sp, lpt)
                        contrib = (self.light_emit[li] * (1.0 / (4 * PI))
                                   * (self.transmittance(dpl)
                                      / (vpdf * lpdf) * vc * sc.sigma_s
                                      * self.transmittance(vd))[:, None]
                                   * tpa)
                        ra = ra + np.where(vis[:, None], contrib,
                                           0.0 * contrib)

            if depth == 0:
                r0 = a[receives]
                alpha[r0] = alpha[r0] + 1.0
                normal_out[r0] = normal_out[r0] + n[receives]
            stop = ~receives
            if depth == 0:
                background[a[stop]] = background[a[stop]] + ra[stop]
            else:
                color[a[stop]] = color[a[stop]] + ra[stop]
            alive[a[stop]] = False
            rad[a] = ra

            # BSDF sampling and Russian roulette for receiving surfaces
            r = np.nonzero(receives)[0]
            if r.size == 0:
                continue
            ar, sr = a[r], st.take(r)
            nr, wor, kr = n[r], wo[r], kind[r]
            car, pwr, ior = c_a[r], power[r], self.ior[mat[r]]
            uf = f(sr.u1(lay.fresnel(depth)))
            udiff = f(sr.u2(lay.diffuse(depth)))
            uspec = f(sr.u2(lay.spec(depth)))
            buu, bvv = onb(nr)
            ds = cosine_hemisphere(udiff[:, 0], udiff[:, 1])
            dbounce = normalize(along(buu, bvv, nr, ds))
            lam_pdf = ds[:, 2] / PI
            lam_f = car / PI
            # lambert
            wi, fv, pdf = dbounce, lam_f, lam_pdf
            # dielectric and metallic: a Phong lobe about the reflection
            refl = nr * (dot(wor, nr) * 2.0)[:, None] - wor
            ruu, rvv = onb(refl)
            ss = cosine_power(uspec[:, 0], uspec[:, 1], pwr)
            sbounce = normalize(along(ruu, rvv, refl, ss))
            cap = np.maximum(ss[:, 2] ** pwr, F32_EPS)
            spdf = (pwr + 1.0) / (2 * PI) * cap
            scoeff = np.where(dot(nr, sbounce) < 0.0, 0.0,
                              (pwr + 2.0) / (2 * PI) * cap)
            cosw = np.abs(dot(nr, wor))
            fr = schlick(cosw, 0.04)
            take_spec = uf < fr
            diel = kr == DIELECTRIC
            wi = np.where((diel & take_spec)[:, None], sbounce, wi)
            fv = np.where((diel & take_spec)[:, None],
                          scoeff[:, None] + 0.0 * lam_f, fv)
            pdf = np.where(diel, fr * spdf + (1.0 - fr)
                           * np.maximum(lam_pdf, 1e-5), pdf)
            metal = kr == METALLIC
            fres_c = car + (1.0 - car) * ((1.0 - cosw) ** 5)[:, None]
            wi = np.where(metal[:, None], sbounce, wi)
            fv = np.where(metal[:, None], fres_c * scoeff[:, None], fv)
            pdf = np.where(metal, spdf, pdf)
            # refractive: Fresnel-weighted reflect or refract, a cosine
            # lobe about the chosen axis, total internal reflection
            refr = kr == REFRACTIVE
            if refr.any():
                cos_i = dot(wor, nr)
                entering = cos_i > 0.0
                n_ref = np.where(entering[:, None], nr, -nr)
                eta = np.where(entering, 1.0 / ior, ior)
                ci = np.abs(cos_i)
                sin2_t = eta * eta * np.maximum(1.0 - ci * ci, 0.0)
                tir = sin2_t > 1.0
                cos_t = np.sqrt(np.maximum(1.0 - sin2_t, 0.0))
                refr_dir = (-wor * eta[:, None]
                            + n_ref * (eta * ci - cos_t)[:, None])
                refr_dir = refr_dir / np.maximum(norm(refr_dir),
                                                 1e-20)[:, None]
                f0 = ((1.0 - ior) / (1.0 + ior)) ** 2
                take_refl = (uf < schlick(ci, f0)) | tir
                refl_dir = n_ref * (dot(wor, n_ref) * 2.0)[:, None] - wor
                axis = np.where(take_refl[:, None], refl_dir, refr_dir)
                auu, avv = onb(axis)
                rs = cosine_hemisphere(udiff[:, 0], udiff[:, 1])
                rwi = normalize(along(auu, avv, axis, rs))
                rpdf = np.maximum(rs[:, 2] / PI, 1e-6)
                colr = np.where(take_refl[:, None], 1.0 + 0.0 * car, car)
                ndl_r = np.maximum(np.abs(dot(rwi, nr)), 1e-6)
                wi = np.where(refr[:, None], rwi, wi)
                fv = np.where(refr[:, None], colr * (rpdf / ndl_r)[:, None],
                              fv)
                pdf = np.where(refr, rpdf, pdf)
            ndl = np.abs(dot(wi, nr))
            tpr = tp[ar]
            new_tp = tpr * vol_tr[r][:, None] * fv * (ndl / pdf)[:, None]
            if depth > 2:
                rf = np.maximum(1.0 - tpr.max(axis=1), 0.05)
                with np.errstate(divide="ignore", invalid="ignore"):
                    new_tp = np.where((rf < 1.0)[:, None],
                                      new_tp / (1.0 - rf)[:, None], new_tp)
            else:
                rf = prec.zeros(r.size)
            ur = f(sr.u1(lay.roulette(depth)))
            end = (ur < rf) | (depth >= self.max_bounces)
            color[ar[end]] = color[ar[end]] + ra[r][end]
            alive[ar[end]] = False
            ok = ~np.isnan(new_tp).any(axis=1)
            tp[ar[ok]] = new_tp[ok]
            sgn = np.sign(dot(nr, wi)) * offset_by[r]
            o[ar] = p[r] + nr * sgn[:, None]
            d[ar] = wi

        def mean(x):
            return np.asarray(x, np.float64).reshape(P, S, *x.shape[1:]) \
                .mean(axis=1)

        return dict(color=mean(color), background=mean(background),
                    alpha=mean(alpha), normal=mean(normal_out))
