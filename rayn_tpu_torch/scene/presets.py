"""Built-in scenes (port of rayn_tpu.scene.presets).

`default_scene` is the reference's hard-coded scene (src/setup.rs:46-170):
sky dome, 12-iteration MandelBox, five sphere lights with co-located
emissive bodies, a homogeneous volume and a pinhole camera; with
`animated` its camera orbits over [0, 2] s (64 knots), with
`animated_geo` four of its lights and their emissive bodies orbit over
[0, 2] s (`geo_knots` knots). `spheres_scene` has analytic spheres only.
"""

from __future__ import annotations

import numpy as np

from rayn_tpu_torch.ops import sdf as sdf_ops
from rayn_tpu_torch.render.camera import PinholeCamera
from rayn_tpu_torch.scene.animation import AnimChannel
from rayn_tpu_torch.scene.scene import SceneBuilder


def _normalized(v):
    v = np.asarray(v, np.float32)
    return v / np.linalg.norm(v)


def _orbit(pos, rate: float, phase: float, knots: int, device):
    """A channel of `pos` turned about the y axis by rate * t + phase,
    baked at `knots` knots over [0, 2] s."""
    x, y, z = np.asarray(pos, np.float32)

    def fn(t):
        ang = rate * t + phase
        c, s = np.cos(ang), np.sin(ang)
        return np.asarray((c * x + s * z, y, -s * x + c * z), np.float32)

    return AnimChannel.from_fn(fn, 0.0, 2.0, knots=knots, device=device)


def default_scene(resolution=(1280, 720), world_radius: float = 100.0,
                  fractal_iterations: int = 12, volume: bool = True,
                  animated: bool = False, animated_geo: bool = False,
                  geo_knots: int = 8, device="cuda"):
    """Returns (scene_data, scene_static, camera), tensors on `device`
    (the CUDA card unless the caller asks for another device).

    `animated`: the camera orbits (0.35 rad/s about y, 64 knots), for
    camera motion blur. `animated_geo`: the four outer sphere lights and
    their emissive bodies orbit (0.25 rad/s), each pair on one channel so
    that the MIS pairing autodetect still pairs them; the kernels lerp
    their knots at each ray's time."""
    b = SceneBuilder()
    if volume:
        b.set_volume(0.25, 0.035)

    sky = b.add_sky(top=(0.3, 0.4, 0.6),
                    bottom=np.asarray((0.2, 0.3, 0.6), np.float32) * 0.05)
    b.add_sphere((0.0, 0.0, 0.0), world_radius, sky)

    grey = b.add_dielectric(albedo=(0.2, 0.2, 0.2), roughness=0.6)
    mandelbox = sdf_ops.mandelbox(
        iterations=fractal_iterations, box_fold_l=1.0,
        sphere_min_rad=0.01, sphere_fixed_rad=1.9, scale=-2.1)
    # Bounding sphere for shadow-segment clipping (measured in the JAX
    # package: the {DE < 1e-3} shell ends at |p| = 2.78; 3.6 adds margin).
    b.set_sdf(mandelbox, grey, bound_radius=3.6)

    green = _normalized((1.5, 4.5, 3.0))
    blue = _normalized((1.5, 3.0, 4.5))
    blue_emissive = b.add_emissive(blue * 3.0)
    green_emissive = b.add_emissive(green * 3.0)
    for i, (pos, rad) in enumerate([((1.2, -1.2, 1.2), 0.15),
                                    ((-1.2, 1.2, 1.2), 0.15)]):
        pos = np.asarray(pos, np.float32)
        green_pos = pos * np.asarray((1.0, -1.0, 1.0), np.float32)
        if animated_geo:  # staged on the host; build() moves them
            green_pos = _orbit(green_pos, 0.25, 0.6 * i, geo_knots, "cpu")
            pos = _orbit(pos, 0.25, 0.3 + 0.6 * i, geo_knots, "cpu")
        b.add_sphere_light(green_pos, rad, green * 40.0)
        b.add_sphere_light(pos, rad, blue * 40.0)
        b.add_sphere(green_pos, rad - 0.01, green_emissive)
        b.add_sphere(pos, rad - 0.01, blue_emissive)
    b.add_sphere_light((0.0, 0.0, 0.0), 0.25, green * 20.0)
    b.add_sphere((0.0, 0.0, 0.0), 0.24, green_emissive)

    origin = np.asarray((-0.45, 0.2, 2.0), np.float32) * 2.25
    if animated:
        origin = _orbit(origin, 0.35, 0.0, 64, device)
    camera = PinholeCamera.make(resolution, 60.0, origin, (0.0, 0.0, 0.0),
                                (0.0, 1.0, 0.0), device=device)
    data, static = b.build(device)
    return data, static, camera


def spheres_scene(resolution=(1280, 720), world_radius: float = 100.0,
                  device="cuda"):
    """Analytic-spheres-only scene (bench.py `--config spheres`): a row of
    lambert / dielectric / metal / refractive spheres on a floor under the
    sky, lit by two sphere lights with co-located emissive bodies, and no
    SDF. Returns (scene_data, scene_static, camera) on `device`."""
    b = SceneBuilder()
    sky = b.add_sky(top=(0.3, 0.4, 0.6),
                    bottom=np.asarray((0.2, 0.3, 0.6), np.float32) * 0.05)
    b.add_sphere((0.0, 0.0, 0.0), world_radius, sky)

    floor = b.add_lambertian((0.5, 0.5, 0.5))
    b.add_sphere((0.0, -100.5, 0.0), 100.0, floor)

    mats = [
        b.add_lambertian((0.7, 0.3, 0.3)),
        b.add_dielectric((0.8, 0.8, 0.2), 0.2),
        b.add_metallic((0.9, 0.7, 0.3), 0.15),
        b.add_dielectric((0.3, 0.5, 0.8), 0.6),
        b.add_refractive((0.9, 0.95, 1.0), 0.0, 1.5),
        b.add_lambertian((0.2, 0.7, 0.4)),
    ]
    for i, m in enumerate(mats):
        b.add_sphere((-2.0 + i * 0.8, 0.0, 0.0), 0.38, m)

    warm = _normalized((5.0, 4.0, 2.5))
    b.add_sphere_light((2.0, 2.5, 2.0), 0.4, warm * 30.0)
    b.add_sphere_light((-2.0, 1.5, -1.0), 0.3, warm * 20.0)
    emissive = b.add_emissive(warm * 3.0)
    b.add_sphere((2.0, 2.5, 2.0), 0.39, emissive)
    b.add_sphere((-2.0, 1.5, -1.0), 0.29, emissive)

    camera = PinholeCamera.make(resolution, 60.0, (0.0, 0.8, 4.0),
                                (0.0, 0.0, 0.0), (0.0, 1.0, 0.0),
                                device=device)
    data, static = b.build(device)
    return data, static, camera
