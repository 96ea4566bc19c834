"""The system under test: rayn_tpu_torch, driven from a configuration file.

Everything the benchmark takes from the renderer goes through here: the
scene built from the configuration's data with `SceneBuilder` and the
pinhole camera, `render_frame` (on several cards, through the mesh of
`parallel.sharding`), and `film.resolve`, which copies the film to the
host and so ends a frame.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def settings_of(config: dict, spp: int | None = None, **overrides):
    """The renderer's RenderSettings for a configuration (and a traffic
    mix's spp); fields the file leaves out keep the renderer's defaults."""
    from rayn_tpu_torch.config import RenderSettings
    st = dict(config["settings"])
    st["resolution"] = tuple(st["resolution"])
    if spp is not None:
        st["spp"] = int(spp)
    st.update(overrides)
    fields = {f.name for f in dataclasses.fields(RenderSettings)}
    unknown = set(st) - fields
    if unknown:
        raise ValueError(f"{config['name']}: unknown settings {unknown}")
    return RenderSettings(**st)


def build_scene(config: dict, device):
    """(SceneData, SceneStatic, camera) of the configuration's scene on
    `device`: materials, spheres and sphere lights in the file's order."""
    from rayn_tpu_torch.ops import sdf as sdf_ops
    from rayn_tpu_torch.render.camera import PinholeCamera
    from rayn_tpu_torch.scene.scene import SceneBuilder

    sc = config["scene"]
    b = SceneBuilder()
    if sc.get("volume") is not None:
        b.set_volume(sc["volume"]["sigma_s"], sc["volume"]["sigma_t"])
    mats = {}
    for m in sc["materials"]:
        k = m["kind"]
        if k == "sky":
            mats[m["name"]] = b.add_sky(top=m["top"], bottom=m["bottom"])
        elif k == "lambertian":
            mats[m["name"]] = b.add_lambertian(m["albedo"])
        elif k == "dielectric":
            mats[m["name"]] = b.add_dielectric(m["albedo"], m["roughness"])
        elif k == "metallic":
            mats[m["name"]] = b.add_metallic(m["f0"], m["roughness"])
        elif k == "refractive":
            mats[m["name"]] = b.add_refractive(m["color"], m["roughness"],
                                               m["ior"])
        elif k == "emissive":
            mats[m["name"]] = b.add_emissive(m["emission"])
        else:
            raise ValueError(f"unknown material kind {k!r}")
    for s in sc["spheres"]:
        b.add_sphere(np.asarray(s["center"], np.float32), s["radius"],
                     mats[s["material"]])
    for light in sc.get("lights", []):
        b.add_sphere_light(np.asarray(light["position"], np.float32),
                           light["radius"],
                           np.asarray(light["emission"], np.float32))
    sdf = sc.get("sdf")
    if sdf is not None:
        if sdf["program"] != "mandelbox":
            raise ValueError(f"unknown SDF program {sdf['program']!r}")
        prog = sdf_ops.mandelbox(
            iterations=sdf["iterations"], box_fold_l=sdf["box_fold_l"],
            sphere_min_rad=sdf["sphere_min_rad"],
            sphere_fixed_rad=sdf["sphere_fixed_rad"], scale=sdf["scale"])
        b.set_sdf(prog, mats[sdf["material"]],
                  bound_radius=sdf["bound_radius"])
    cam = sc["camera"]
    if cam["kind"] != "pinhole":
        raise ValueError(f"unknown camera {cam['kind']!r}")
    camera = PinholeCamera.make(
        tuple(config["settings"]["resolution"]), cam["vfov_degrees"],
        np.asarray(cam["origin"], np.float32),
        np.asarray(cam["at"], np.float32), np.asarray(cam["up"], np.float32),
        device=device)
    data, static = b.build(device)
    return data, static, camera


class Renderer:
    """One configuration's scene on one card (or the CPU), rendering whole
    frames through the renderer's entry point; with `mesh`
    (parallel.sharding.make_mesh()), this rank's slice of each frame."""

    def __init__(self, config: dict, settings, device, mesh=None):
        from rayn_tpu_torch.ops import filters
        self.config = config
        self.settings = settings
        self.mesh = mesh
        self.data, self.static, self.camera = build_scene(config, device)
        flt = config["filter"]
        self.filter = filters.FILTERS[flt["name"]](flt["radius"])

    def render(self, frame: int):
        """The frame's film: one call of `render_frame`."""
        from rayn_tpu_torch.render import renderer
        return renderer.render_frame(
            self.data, self.static, self.settings, self.camera, frame=frame,
            filter=self.filter, frame_rate=self.config["frame_rate"],
            shutter_speed=self.config["shutter_speed"], mesh=self.mesh)

    def resolve(self, film):
        """Per-pixel means on the host (numpy, [H, W, ...])."""
        from rayn_tpu_torch.render import film as film_mod
        return film_mod.resolve(film, self.settings.resolution,
                                self.settings)

    def passes_per_frame(self) -> int:
        """Passes the renderer runs for one frame."""
        from rayn_tpu_torch.render import renderer
        ranks = 1 if self.mesh is None else self.mesh.size
        return renderer.seg_passes(self.settings, self.settings.spp,
                                   ranks)[1]

    def samples_per_frame(self) -> int:
        """Camera samples this rank renders a frame: the whole frame's on
        one card; on a mesh, those of the rank's slice of each pass that
        lie inside the frame (the last pass may end past it)."""
        from rayn_tpu_torch.render import renderer
        w, h = self.settings.resolution
        total = w * h * self.settings.spp
        if self.mesh is None:
            return total
        size, n = renderer.seg_passes(self.settings, self.settings.spp,
                                      self.mesh.size)
        per = size // self.mesh.size
        starts = (p * size + self.mesh.rank * per for p in range(n))
        return sum(max(0, min(total, lo + per) - lo) for lo in starts)
