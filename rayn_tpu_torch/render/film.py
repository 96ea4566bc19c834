"""Multi-channel film (port of rayn_tpu.render.film: Film, new_film,
splat_aligned, resolve).

Channels mirror reference src/film.rs:103-120: Color, Alpha, Background,
WorldNormal, plus the per-pixel sample count. A pass that covers whole
pixels in pixel-major order is splatted by a reshape-sum over the spp
axis and one slice add per channel: no atomics, so the film is the same
bits on every run (CUDA `index_add_` would add in a varying order).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Film(NamedTuple):
    color: torch.Tensor       # [P, 3] sum of terminated path radiance
    alpha: torch.Tensor       # [P]    sum of hit coverage
    background: torch.Tensor  # [P, 3] sum of depth-0 escaped radiance
    normal: torch.Tensor      # [P, 3] sum of depth-0 world normals
    samples: torch.Tensor     # [P]    per-pixel sample counts


def new_film(n_pixels: int, device) -> Film:
    kw = dict(dtype=torch.float32, device=device)
    return Film(color=torch.zeros((n_pixels, 3), **kw),
                alpha=torch.zeros((n_pixels,), **kw),
                background=torch.zeros((n_pixels, 3), **kw),
                normal=torch.zeros((n_pixels, 3), **kw),
                samples=torch.zeros((n_pixels,), **kw))


def splat_aligned(film: Film, pixel0: int, color, alpha, background, normal,
                  count, spp: int) -> Film:
    """Add one pass whose ray i belongs to pixel pixel0 + i // spp, in
    place (the JAX version donates the film buffers). Rays past the end of
    the frame must carry zero contributions; their rows fall off the film
    (renderer.py:53-59, film.py:87-95 in JAX)."""
    n = color.shape[0]
    rows = n // spp
    n_px = film.color.shape[0]
    take = max(0, min(rows, n_px - pixel0))

    def add(acc, vals):
        sums = vals.reshape((rows, spp) + tuple(vals.shape[1:])).sum(dim=1)
        acc[pixel0:pixel0 + take] += sums[:take]
        return acc

    return Film(color=add(film.color, color), alpha=add(film.alpha, alpha),
                background=add(film.background, background),
                normal=add(film.normal, normal),
                samples=add(film.samples, count))


class ResolvedFilm(NamedTuple):
    """Per-pixel means as numpy arrays shaped [H, W, ...], y=0 at the
    bottom (reference raster convention, src/film.rs:237)."""
    color: np.ndarray
    alpha: np.ndarray
    background: np.ndarray
    normal: np.ndarray


def resolve(film: Film, resolution: tuple[int, int]) -> ResolvedFilm:
    w, h = resolution
    cnt = np.maximum(film.samples.cpu().numpy(), 1e-8)[:, None]

    def mean(acc, vec: bool):
        a = acc.cpu().numpy()
        return (a / cnt).reshape(h, w, 3) if vec else \
            (a / cnt[:, 0]).reshape(h, w)

    return ResolvedFilm(color=mean(film.color, True),
                        alpha=mean(film.alpha, False),
                        background=mean(film.background, True),
                        normal=mean(film.normal, True))
