"""Render settings.

The frozen dataclass of `rayn_tpu.config.RenderSettings`, so a settings
object means the same render in both packages. The fields that only
sized Pallas blocks on the TPU (`pallas_block_rows`,
`pallas_occl_block_rows`, `chained_advance_group`) are left out: nothing
here reads them. Every other value renders, as in the JAX package.
`use_pallas=False` and `use_pallas_occlusion=False` choose the JAX
package's route without its kernels: the closest hit, or the shadow
marches, of every SDF instance march in torch (ops/march.py) and the
fused kernels that evaluate a distance step aside, as JAX routes them
(render/integrator.py); the kernels that read no SDF keep running.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RenderSettings:
    """All render knobs (reference src/setup.rs:16-44, src/main.rs:47-57).
    See rayn_tpu.config.RenderSettings for the full notes on each."""

    resolution: tuple[int, int] = (1280, 720)
    spp: int = 8
    max_bounces: int = 3
    volume_marches: int = 2
    nee_light_samples: int = 4
    world_radius: float = 100.0
    extra_aovs: tuple = ()
    sdf_detail_scale: float = 0.5
    max_marches: int = 256
    max_vis_marches: int = 100
    shadow_de_iterations: int = 0
    shadow_eps_scale: float = 1.0
    shadow_bv_clip: bool = True
    filter_table_size: int = 512
    sampler: str = "rd"
    mis: bool = False
    compat_spec_phi: bool = False
    compat_spec_reflect: bool = False
    rays_per_pass: int = 1 << 20
    use_pallas: bool = True
    use_pallas_occlusion: bool = True
    chained_shadow_march: bool = True
    occl_phase1_steps: int = 0
    occl_sort_steps: int = 0
    sorted_shadow_march: bool = True
    sorted_chunk: int = 0
    sorted_intersect: bool = True
    use_fused_shadows: bool = True
    use_fused_finish: bool = True
    use_fused_bounce_tail: bool = True
    use_fused_intersect: bool = True
    march_sort_steps: int = 0
    march_relaxation: float = 1.0
    compact_bounces: bool = False

    def __post_init__(self):
        if self.sampler not in ("rd", "hash"):
            raise ValueError(f"unknown sampler {self.sampler!r}")
        if self.spp < 1 or self.max_bounces < 0:
            raise ValueError("spp must be >= 1 and max_bounces >= 0")

    # ---- sampler dimension layout (documented in utils/rng.py) ----
    @property
    def sets_1d_per_depth(self) -> int:
        # light picks + volume light picks + volume distance + fresnel
        # + roulette
        return (self.nee_light_samples
                + self.volume_marches * (self.nee_light_samples + 1) + 2)

    @property
    def sets_2d_per_depth(self) -> int:
        # NEE light samples + volume light samples + diffuse dir + spec dir
        return self.nee_light_samples * (1 + self.volume_marches) + 2

    @property
    def num_1d_sets(self) -> int:
        # set 0 = shutter time jitter (reference src/film.rs:509-512)
        return 1 + (self.max_bounces + 1) * self.sets_1d_per_depth

    @property
    def num_2d_sets(self) -> int:
        # set 0 = pixel uv (filter importance sampling), set 1 = lens
        return 2 + (self.max_bounces + 1) * self.sets_2d_per_depth
