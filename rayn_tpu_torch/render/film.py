"""Multi-channel film (port of rayn_tpu.render.film: Film, new_film,
splat, splat_aligned, resolve, save_channels).

Channels mirror reference src/film.rs:103-120: Color, Alpha, Background,
WorldNormal, plus the per-pixel sample count and the configured extra
AOVs (render/aovs.py), one accumulator each. A pass that covers whole
pixels in pixel-major order is splatted by a reshape-sum over the spp
axis and one slice add per channel; a pass that starts or ends inside a
pixel is padded with zero lanes to whole pixels first. No atomics, so
the film is the same bits on every run (CUDA `index_add_` would add in a
varying order).

PNGs are written with the standard library (zlib): 8-bit grayscale, RGB
or RGBA, every row with filter type 0.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from rayn_tpu_torch.render.aovs import specs_for


class Film(NamedTuple):
    color: torch.Tensor       # [P, 3] sum of terminated path radiance
    alpha: torch.Tensor       # [P]    sum of hit coverage
    background: torch.Tensor  # [P, 3] sum of depth-0 escaped radiance
    normal: torch.Tensor      # [P, 3] sum of depth-0 world normals
    samples: torch.Tensor     # [P]    per-pixel sample counts
    # the extra AOV accumulators in RenderSettings.extra_aovs order,
    # [P] or [P, 3] each
    extra: tuple = ()


# the fixed channels, in field order (Film.extra follows them)
CHANNELS = Film._fields[:5]


def tensors(film: Film) -> list:
    """Every accumulator of the film: the fixed channels, then the
    extras."""
    return [getattr(film, c) for c in CHANNELS] + list(film.extra)


def new_film(n_pixels: int, device, settings=None) -> Film:
    """A zero film; with `settings`, one accumulator for each of its
    extra AOVs (an unknown name raises ValueError)."""
    kw = dict(dtype=torch.float32, device=device)
    extra = ()
    if settings is not None and settings.extra_aovs:
        extra = tuple(torch.zeros((n_pixels,) if s.dim == 1
                                  else (n_pixels, 3), **kw)
                      for s in specs_for(settings))
    return Film(color=torch.zeros((n_pixels, 3), **kw),
                alpha=torch.zeros((n_pixels,), **kw),
                background=torch.zeros((n_pixels, 3), **kw),
                normal=torch.zeros((n_pixels, 3), **kw),
                samples=torch.zeros((n_pixels,), **kw), extra=extra)


def splat_aligned(film: Film, pixel0: int, color, alpha, background, normal,
                  count, spp: int, extra: tuple = ()) -> Film:
    """Add one pass whose ray i belongs to pixel pixel0 + i // spp, in
    place (the JAX version donates the film buffers); `extra` holds the
    pass's values of the film's extra AOVs. Rays past the end of the
    frame must carry zero contributions; their rows fall off the film
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
                samples=add(film.samples, count),
                extra=tuple(add(acc, v) for acc, v in zip(film.extra, extra)))


def splat(film: Film, ray0: int, color, alpha, background, normal, count,
          spp: int, extra: tuple = ()) -> Film:
    """Add one pass of rays ray0, ray0 + 1, ... (flat ids, pixel-major:
    ray r belongs to pixel r // spp), in place, for a pass that need not
    start or end on a pixel boundary (JAX's scatter-add `splat`, which
    its renderer takes for such passes, rayn_tpu/render/renderer.py:
    112-127). The pass is
    padded with zero lanes to whole pixels and added as `splat_aligned`
    adds it, so an aligned pass gives `splat_aligned`'s bits."""
    lead = ray0 % spp
    trail = -(lead + color.shape[0]) % spp

    def pad(v):
        if not (lead or trail):
            return v
        z = v.new_zeros
        return torch.cat([z((lead,) + tuple(v.shape[1:])), v,
                          z((trail,) + tuple(v.shape[1:]))])

    return splat_aligned(film, ray0 // spp, pad(color), pad(alpha),
                         pad(background), pad(normal), pad(count), spp,
                         tuple(pad(v) for v in extra))


class ResolvedFilm(NamedTuple):
    """Per-pixel means as numpy arrays shaped [H, W, ...], y=0 at the
    bottom (reference raster convention, src/film.rs:237)."""
    color: np.ndarray
    alpha: np.ndarray
    background: np.ndarray
    normal: np.ndarray
    # {name: [H, W] or [H, W, 3]} means of the extra AOVs
    extra: dict = {}


def resolve(film: Film, resolution: tuple[int, int],
            settings=None) -> ResolvedFilm:
    """Per-pixel means; the extras are named by settings.extra_aovs, or
    aov0, aov1, ... without settings."""
    w, h = resolution
    cnt = np.maximum(film.samples.cpu().numpy(), 1e-8)[:, None]

    def mean(acc, vec: bool):
        a = acc.cpu().numpy()
        return (a / cnt).reshape(h, w, 3) if vec else \
            (a / cnt[:, 0]).reshape(h, w)

    extra = {}
    if film.extra:
        if settings is not None:
            names = [s.name for s in specs_for(settings)]
        else:
            names = [f"aov{i}" for i in range(len(film.extra))]
        extra = {name: mean(acc, acc.dim() == 2)
                 for name, acc in zip(names, film.extra)}
    return ResolvedFilm(color=mean(film.color, True),
                        alpha=mean(film.alpha, False),
                        background=mean(film.background, True),
                        normal=mean(film.normal, True), extra=extra)


def _gamma(rgb: np.ndarray, g: float = 2.2) -> np.ndarray:
    return np.power(np.maximum(rgb, 0.0), 1.0 / g)


def _to_u8(x: np.ndarray) -> np.ndarray:
    return np.clip(x * 255.0, 0.0, 255.0).astype(np.uint8)


_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_COLOR_TYPE = {1: 0, 3: 2, 4: 6}   # channels -> L, RGB, RGBA


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data)))


def write_png(path, img: np.ndarray) -> None:
    """Write a uint8 image [H, W] (grayscale), [H, W, 3] (RGB) or
    [H, W, 4] (RGBA), first row at the top."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    h, w = img.shape[:2]
    channels = 1 if img.ndim == 2 else img.shape[2]
    rows = img.reshape(h, w * channels)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, _PNG_COLOR_TYPE[channels],
                         0, 0, 0)
    with open(path, "wb") as fh:
        fh.write(_PNG_SIGNATURE + _png_chunk(b"IHDR", header)
                 + _png_chunk(b"IDAT", zlib.compress(raw.tobytes()))
                 + _png_chunk(b"IEND", b""))


def read_png(path) -> np.ndarray:
    """Read a PNG that `write_png` wrote (8-bit L, RGB or RGBA, not
    interlaced, filter type 0 on every row): uint8 [H, W] or [H, W, C]."""
    data = Path(path).read_bytes()
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if zlib.crc32(kind + body) != struct.unpack(
                ">I", data[pos + 8 + n:pos + 12 + n])[0]:
            raise ValueError(f"{path}: bad CRC in {kind!r}")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        pos += 12 + n
    w, h, depth, ctype, _comp, _filt, interlace = header
    channels = {v: k for k, v in _PNG_COLOR_TYPE.items()}.get(ctype)
    if depth != 8 or channels is None or interlace:
        raise ValueError(f"{path}: unsupported PNG format {header}")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw.reshape(h, 1 + w * channels)
    if raw[:, 0].any():
        raise ValueError(f"{path}: rows with a filter other than type 0")
    img = raw[:, 1:].reshape(h, w, channels)
    return img[..., 0] if channels == 1 else img


def save_channels(resolved: ResolvedFilm, output_folder, base_name: str,
                  channels=("color", "alpha", "normal"),
                  transparent_background: bool = False) -> list[str]:
    """Write PNGs mirroring reference src/film.rs:205-377: color is
    saturate+gamma-2.2 of color(+background) (or alpha-composited when
    transparent_background), normal is 0.5+0.5 remap, alpha is grayscale,
    background is saturate+gamma-2.2; an extra AOV is RGB clipped to
    [0, 1] with no gamma (vector) or grayscale divided by its maximum
    (scalar). Images are y-flipped (raster y-up -> image y-down,
    src/film.rs:237). Returns the paths written,
    `{output_folder}/{base_name}_{channel}.png`."""
    out = Path(output_folder)
    out.mkdir(parents=True, exist_ok=True)
    written = []
    for kind in channels:
        if kind == "color" and transparent_background:
            rgb = _gamma(np.clip(resolved.color, 0.0, 1.0))
            img = np.concatenate([_to_u8(rgb),
                                  _to_u8(resolved.alpha)[..., None]], axis=-1)
        elif kind == "color":
            img = _to_u8(_gamma(np.clip(resolved.color + resolved.background,
                                        0.0, 1.0)))
        elif kind == "background":
            img = _to_u8(_gamma(np.clip(resolved.background, 0.0, 1.0)))
        elif kind == "normal":
            img = _to_u8(resolved.normal * 0.5 + 0.5)
        elif kind == "alpha":
            img = _to_u8(resolved.alpha)
        elif kind in resolved.extra:
            a = resolved.extra[kind]
            if a.ndim == 3:
                img = _to_u8(np.clip(a, 0.0, 1.0))
            else:
                img = _to_u8(a / (float(a.max()) or 1.0))
        else:
            raise ValueError(f"unknown channel {kind}")
        path = out / f"{base_name}_{kind}.png"
        write_png(path, img[::-1])
        written.append(str(path))
    return written
