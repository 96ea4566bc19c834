"""Deterministic, counter-based sample generation.

Bit-exact port of `rayn_tpu.utils.rng`: the same two samplers ("rd" =
R_d low-discrepancy values with a per-pixel Cranley-Patterson rotation,
"hash" = PCG hash streams), the same set-id layout, the same bits.

torch has no usable uint32 arithmetic, so every u32 value lives in an
int64 tensor in [0, 2^32) and every wrapping operation is masked with
`& 0xFFFFFFFF`. Every intermediate stays below 2^63: a product of two
full 32-bit words is split into 16-bit limbs (`_mul32`), and the PCG
multipliers (< 2^30) times a 32-bit word fit directly.

Sampler dimension ("set") layout, identical to the JAX package:

  1D sets: 0 = shutter-time jitter; then per depth d, base = 1 + d*S1:
    +0..L-1                 NEE light picks (L = nee_light_samples)
    +L..L+VM*L-1            volume-scatter light picks (march-major)
    +VM*L+L..VM*L+L+VM-1    volume-scatter distance samples
    +S1-2                   fresnel lobe select
    +S1-1                   russian-roulette
  2D sets: 0 = pixel uv (FIS), 1 = lens; then per depth d, base = 2 + d*S2:
    +0..L-1                 NEE light direction samples
    +L..L+VM*L-1            volume light direction samples
    +S2-2                   diffuse bounce
    +S2-1                   specular bounce
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from rayn_tpu_torch.config import RenderSettings

_U64_MASK = (1 << 64) - 1
M32 = 0xFFFFFFFF
_M16 = 0xFFFF


def _phi_d(dims: int) -> float:
    """Generalized golden ratio: unique positive root of x^(d+1) = x + 1."""
    x = 2.0
    for _ in range(64):
        x = (1.0 + x) ** (1.0 / (dims + 1))
    return x


def rd_alphas_u64(dims: int) -> list[int]:
    """Per-dimension R_d step in u64 fixed point."""
    g = _phi_d(dims)
    out = []
    for i in range(dims):
        frac = (1.0 / g) ** (i + 1) % 1.0
        out.append(int(round(frac * (1 << 64))) & _U64_MASK)
    return out


def rd_sequence(dims: int, n: int, index_offset: int) -> np.ndarray:
    """[n, dims] float32 R_d samples from sequence index `index_offset`:
    (idx * alpha) mod 2^64 in u64 fixed point, its top 24 bits over 2^24
    (rayn_tpu/utils/rng.py:74; the quasi-rd crate of the reference,
    src/sampler.rs:23-29). On the host, as in the JAX package."""
    alphas = rd_alphas_u64(dims)
    idx = np.arange(n, dtype=np.uint64) + np.uint64(index_offset & _U64_MASK)
    out = np.empty((n, dims), dtype=np.float32)
    with np.errstate(over="ignore"):
        for d, a in enumerate(alphas):
            vals = idx * np.uint64(a)   # wrapping u64 multiply
            out[:, d] = (vals >> np.uint64(40)).astype(np.float64) / float(
                1 << 24)
    return out


A1 = rd_alphas_u64(1)[0]
A2 = rd_alphas_u64(2)

SET_SALT_1D = 0x9E3779B9
SET_SALT_2D = 0x85EBCA6B


class SampleTables(NamedTuple):
    """Sampler stream state: only the frame salt (a Python int in
    [0, 2^32)); both samplers are counter-based."""
    frame: int


def build_sample_tables(settings: RenderSettings, frame: int) -> SampleTables:
    return SampleTables(int(frame) & M32)


def _u32(x) -> torch.Tensor:
    """An integer tensor as u32 words held in int64."""
    return x.to(torch.int64) & M32


def _mul32(a, b):
    """(a * b) mod 2^32 for u32 words in int64 (tensor or int operands),
    through 16-bit limbs of b so no product reaches 2^49."""
    lo = a * (b & _M16)
    hi = (a * (b >> 16)) & _M16
    return (lo + (hi << 16)) & M32


def _rd_bits(alpha: int, set_base, n: torch.Tensor) -> torch.Tensor:
    """(H >> 8) * 2^-24 as float32 in [0, 1), with
    H = hi32(aL * n) + aL*set_base + aH*n (mod 2^32) — the top bits of
    ((set_base << 32) + n) * alpha mod 2^64 (see rayn_tpu.utils.rng)."""
    a_l = alpha & M32
    a_h = (alpha >> 32) & M32
    a0 = alpha & _M16
    a1 = (alpha >> 16) & _M16
    n = _u32(n)
    n0 = n & _M16
    n1 = n >> 16
    m00 = a0 * n0
    m01 = a0 * n1
    m10 = a1 * n0
    m11 = a1 * n1
    carry = ((m00 >> 16) + (m01 & _M16) + (m10 & _M16)) >> 16
    p0h = (m11 + (m01 >> 16) + (m10 >> 16) + carry) & M32
    if isinstance(set_base, int):
        sb = _mul32(set_base & M32, a_l)
    else:
        sb = _mul32(_u32(set_base), a_l)
    h = (p0h + sb + _mul32(n, a_h)) & M32
    return (h >> 8).to(torch.float32) * (2.0 ** -24)


def rd_value_1d(frame: int, set_id: int, n: torch.Tensor):
    return _rd_bits(A1, (frame + set_id) & M32, n)


def rd_value_2d(frame: int, num_1d_sets: int, set_id: int, n: torch.Tensor):
    base = (frame + num_1d_sets + set_id) & M32
    return _rd_bits(A2[0], base, n), _rd_bits(A2[1], base, n)


def pcg_hash(x: torch.Tensor) -> torch.Tensor:
    """PCG-RXS-M-XS 32-bit hash (Jarzynski & Olano). u32 words in int64."""
    x = (_u32(x) * 747796405 + 2891336453) & M32
    x = (((x >> ((x >> 28) + 4)) ^ x) * 277803737) & M32
    return (x >> 22) ^ x


def hash_combine(*words) -> torch.Tensor:
    """Fold words into one u32 hash: h = pcg(w0); h = pcg(h ^ w1); ...
    The first word must be a tensor; later ones may be ints."""
    h = pcg_hash(words[0])
    for w in words[1:]:
        w = (w & M32) if isinstance(w, int) else _u32(w)
        h = pcg_hash(h ^ w)
    return h


def hash_to_unit_f32(h: torch.Tensor) -> torch.Tensor:
    """u32 -> float32 in [0, 1) using the top 24 bits (exact)."""
    return (h >> 8).to(torch.float32) * (2.0 ** -24)


def _scramble(tables: SampleTables, pixel, set_salt: int, set_id: int):
    return hash_to_unit_f32(
        hash_combine(pixel, set_salt ^ set_id, tables.frame))


def sample_1d(settings: RenderSettings, tables: SampleTables, set_id: int,
              sample_idx: torch.Tensor, pixel: torch.Tensor) -> torch.Tensor:
    """One f32 in [0,1) per ray for decision dimension `set_id`."""
    if settings.sampler == "hash":
        return hash_to_unit_f32(hash_combine(
            pixel, sample_idx, SET_SALT_1D ^ set_id, tables.frame))
    base = rd_value_1d(tables.frame, set_id, sample_idx)
    scr = _scramble(tables, pixel, SET_SALT_1D, set_id)
    return torch.remainder(base + scr, 1.0)


def sample_2d(settings: RenderSettings, tables: SampleTables, set_id: int,
              sample_idx: torch.Tensor, pixel: torch.Tensor) -> torch.Tensor:
    """[N, 2] f32 in [0,1) per ray for 2D decision `set_id`."""
    if settings.sampler == "hash":
        u = hash_to_unit_f32(hash_combine(
            pixel, sample_idx, SET_SALT_2D ^ (2 * set_id), tables.frame))
        v = hash_to_unit_f32(hash_combine(
            pixel, sample_idx, SET_SALT_2D ^ (2 * set_id + 1), tables.frame))
        return torch.stack([u, v], dim=-1)
    bu, bv = rd_value_2d(tables.frame, settings.num_1d_sets, set_id,
                         sample_idx)
    scr_u = _scramble(tables, pixel, SET_SALT_2D, 2 * set_id)
    scr_v = _scramble(tables, pixel, SET_SALT_2D, 2 * set_id + 1)
    base = torch.stack([bu, bv], dim=-1)
    scr = torch.stack([scr_u, scr_v], dim=-1)
    return torch.remainder(base + scr, 1.0)


# --- set-id helpers mirroring the layout documented above ------------------

def set1d_time() -> int:
    return 0


def set1d_light_pick(s: RenderSettings, depth: int, i: int) -> int:
    return 1 + depth * s.sets_1d_per_depth + i


def set1d_vol_pick(s: RenderSettings, depth: int, march: int, i: int) -> int:
    return (1 + depth * s.sets_1d_per_depth + s.nee_light_samples
            + march * s.nee_light_samples + i)


def set1d_vol_dist(s: RenderSettings, depth: int, march: int) -> int:
    return (1 + depth * s.sets_1d_per_depth
            + s.nee_light_samples * (1 + s.volume_marches) + march)


def set1d_fresnel(s: RenderSettings, depth: int) -> int:
    return 1 + depth * s.sets_1d_per_depth + s.sets_1d_per_depth - 2


def set1d_roulette(s: RenderSettings, depth: int) -> int:
    return 1 + depth * s.sets_1d_per_depth + s.sets_1d_per_depth - 1


def set2d_pixel_uv() -> int:
    return 0


def set2d_lens() -> int:
    return 1


def set2d_nee(s: RenderSettings, depth: int, i: int) -> int:
    return 2 + depth * s.sets_2d_per_depth + i


def set2d_vol(s: RenderSettings, depth: int, march: int, i: int) -> int:
    return (2 + depth * s.sets_2d_per_depth + s.nee_light_samples
            + march * s.nee_light_samples + i)


def set2d_diffuse(s: RenderSettings, depth: int) -> int:
    return 2 + depth * s.sets_2d_per_depth + s.sets_2d_per_depth - 2


def set2d_spec(s: RenderSettings, depth: int) -> int:
    return 2 + depth * s.sets_2d_per_depth + s.sets_2d_per_depth - 1
