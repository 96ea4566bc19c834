"""Color / radiometry helpers (port of rayn_tpu.utils.spectrum).

The reference wraps linear-RGB in `Srgb`/`WSrgb` newtypes with a small op
surface (reference src/spectrum.rs:5-120). Here a color is a [..., 3]
float32 tensor and these are free functions over it.
"""

from __future__ import annotations

import torch

from rayn_tpu_torch.utils import vecmath


def saturate(rgb: torch.Tensor) -> torch.Tensor:
    """Clamp to [0, 1] (reference src/spectrum.rs:30-38)."""
    return torch.clamp(rgb, 0.0, 1.0)


def gamma_corrected(rgb: torch.Tensor, gamma: float = 2.2) -> torch.Tensor:
    """Power 1/gamma encode (reference src/spectrum.rs:40-46)."""
    return torch.pow(torch.clamp(rgb, min=0.0), 1.0 / gamma)


def normalized(rgb: torch.Tensor) -> torch.Tensor:
    """Unit-length color (reference src/spectrum.rs:48-52; used by the
    default scene's light colors, src/setup.rs:100-101)."""
    return rgb / vecmath.length(rgb)[..., None]


def max_channel(rgb: torch.Tensor) -> torch.Tensor:
    """Largest channel: drives Russian roulette (reference
    src/spectrum.rs:54-60, src/integrator.rs:149)."""
    return rgb.max(dim=-1).values


def merge(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Lane select: mask ? a : b (the reference's WSrgb::merge,
    src/spectrum.rs:85-87). mask: [...] bool; a, b: [..., 3]."""
    return torch.where(mask[..., None], a, b)


def is_nan(rgb: torch.Tensor) -> torch.Tensor:
    """Per-lane any-channel NaN (reference src/spectrum.rs:79-82)."""
    return torch.isnan(rgb).any(dim=-1)
