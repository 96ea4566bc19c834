"""A configuration file's scene as plain arrays for the reference.

Reads the same JSON the harness builds the renderer's scene from, with
its own code: materials (the Phong exponent of a dielectric or metallic
material remapped from its roughness, reference src/material.rs:166-174),
spheres, sphere lights, the MandelBox, the volume and the pinhole camera
(reference src/camera.rs:94-118).
"""

from __future__ import annotations

import math

import numpy as np

LAMBERT, DIELECTRIC, SKY, EMISSIVE, METALLIC, REFRACTIVE = range(6)
_KINDS = {"lambertian": LAMBERT, "dielectric": DIELECTRIC, "sky": SKY,
          "emissive": EMISSIVE, "metallic": METALLIC,
          "refractive": REFRACTIVE}


def _remap(roughness: float) -> float:
    return 1.0 + (1.0 - roughness) ** 4 * 300.0


class Scene:
    def __init__(self, config: dict):
        sc = config["scene"]
        st = config["settings"]
        self.width, self.height = st["resolution"]
        names = {}
        kind, color_a, color_b, power, ior = [], [], [], [], []
        for i, m in enumerate(sc["materials"]):
            names[m["name"]] = i
            k = _KINDS[m["kind"]]
            a = b = (0.0, 0.0, 0.0)
            pw, ix = 0.0, 1.0
            if k == LAMBERT:
                a = m["albedo"]
            elif k == DIELECTRIC:
                a, pw = m["albedo"], _remap(m["roughness"])
            elif k == METALLIC:
                a, pw = m["f0"], _remap(m["roughness"])
            elif k == REFRACTIVE:
                a, ix = m["color"], m["ior"]
            elif k == SKY:
                a, b = m["top"], m["bottom"]
            else:
                b = m["emission"]
            kind.append(k)
            color_a.append(a)
            color_b.append(b)
            power.append(pw)
            ior.append(ix)
        self.kind = np.asarray(kind, np.int64)
        self.color_a = np.asarray(color_a, np.float64)
        self.color_b = np.asarray(color_b, np.float64)
        self.power = np.asarray(power, np.float64)
        self.ior = np.asarray(ior, np.float64)
        self.centers = np.asarray([s["center"] for s in sc["spheres"]],
                                  np.float64).reshape(-1, 3)
        self.radii = np.asarray([s["radius"] for s in sc["spheres"]],
                                np.float64)
        self.sphere_mat = np.asarray(
            [names[s["material"]] for s in sc["spheres"]], np.int64)
        lights = sc.get("lights", [])
        self.light_pos = np.asarray([x["position"] for x in lights],
                                    np.float64).reshape(-1, 3)
        self.light_rad = np.asarray([x["radius"] for x in lights],
                                    np.float64)
        self.light_emit = np.asarray([x["emission"] for x in lights],
                                     np.float64).reshape(-1, 3)
        vol = sc.get("volume")
        self.sigma_s = None if vol is None else float(vol["sigma_s"])
        self.sigma_t = None if vol is None else float(vol["sigma_t"])
        sdf = sc.get("sdf")
        self.sdf = None
        if sdf is not None:
            if sdf["program"] != "mandelbox":
                raise ValueError("the reference marches a MandelBox only")
            self.sdf = dict(iterations=int(sdf["iterations"]),
                            box_l=float(sdf["box_fold_l"]),
                            min_rad2=float(sdf["sphere_min_rad"]) ** 2,
                            fixed_rad2=float(sdf["sphere_fixed_rad"]) ** 2,
                            scale=float(sdf["scale"]))
            self.sdf_mat = names[sdf["material"]]
        cam = sc["camera"]
        if cam["kind"] != "pinhole":
            raise ValueError("the reference has a pinhole camera only")
        origin = np.asarray(cam["origin"], np.float64)
        at = np.asarray(cam["at"], np.float64)
        up = np.asarray(cam["up"], np.float64)
        half_h = math.tan(cam["vfov_degrees"] * math.pi / 360.0)
        half_w = self.width / self.height * half_h
        w = (origin - at) / np.linalg.norm(origin - at)
        u = np.cross(up, w)
        u /= np.linalg.norm(u)
        v = np.cross(w, u)
        self.cam_origin = origin
        self.cam_u, self.cam_v = u, v
        self.cam_lower_left = origin - u * half_w - v * half_h - w
        self.cam_span = (2.0 * half_w, 2.0 * half_h)
        # the cone-traced hit threshold's slope at depth 0
        self.hps = half_h / self.height

    @property
    def n_spheres(self) -> int:
        return len(self.radii)

    @property
    def n_lights(self) -> int:
        return len(self.light_rad)
