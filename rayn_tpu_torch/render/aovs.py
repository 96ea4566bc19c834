"""Extra film AOVs (port of rayn_tpu.render.aovs).

An AOV is a name, a per-lane width and an extractor over the depth-0
shading data; `RenderSettings.extra_aovs` (a tuple of names) selects the
ones a render accumulates. The four reference channels (Color, Alpha,
Background, WorldNormal) stay fixed Film fields, and the extras ride the
same splat, resolve and save path (render/film.py `Film.extra`).

Every extra follows the reference's depth-0 AOV convention: like Alpha
and WorldNormal it is written once, at the camera hit, for receiving
lanes (reference src/integrator.rs:161-169).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch


@dataclasses.dataclass(frozen=True)
class AovSpec:
    """One optional channel: `fn(hit, info, mat) -> [N] or [N, dim]`
    evaluated at depth 0; `extract` masks it to receiving lanes and the
    film adds it to `Film.extra`."""
    name: str
    dim: int  # 1 or 3
    fn: Callable


AOV_SPECS = {
    "depth": AovSpec("depth", 1, lambda hit, info, mat: hit.t),
    "position": AovSpec("position", 3, lambda hit, info, mat: info.point),
    # after the per-point albedo functions (integrator._derive_shading)
    "albedo": AovSpec("albedo", 3, lambda hit, info, mat: mat.color_a),
    "mat_id": AovSpec("mat_id", 1,
                      lambda hit, info, mat: info.mat.to(torch.float32)),
}


def specs_for(settings) -> tuple[AovSpec, ...]:
    """The specs of settings.extra_aovs in order; an unknown name raises
    ValueError listing the available ones (a typo must not drop a
    channel silently)."""
    try:
        return tuple(AOV_SPECS[n] for n in settings.extra_aovs)
    except KeyError as e:
        raise ValueError(f"unknown AOV {e.args[0]!r}; available: "
                         f"{sorted(AOV_SPECS)}") from None


def extract(settings, hit, info, mat, receives) -> tuple[torch.Tensor, ...]:
    """Depth-0 values of every configured extra channel, zero where the
    lane does not receive light."""
    out = []
    for spec in specs_for(settings):
        v = spec.fn(hit, info, mat)
        mask = receives if spec.dim == 1 else receives[:, None]
        out.append(torch.where(mask, v, 0.0))
    return tuple(out)
