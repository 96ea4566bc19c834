"""The renderer's sampler streams in NumPy (a frozen copy of the R_d and
PCG-hash arithmetic of rayn_tpu_torch/utils/rng.py, the "rd" sampler,
reference src/sampler.rs:23-29).

A sample of decision set `s` for (frame f, pixel p, sample index i) is
frac(R_d(i) + scramble(p, s, f)): R_d(i) = the top 24 bits of
((base << 32) + i) * alpha mod 2^64 over 2^24, base = f + s (1D) or
f + num_1d_sets + s (2D), with the generalized golden ratio's alphas in
u64 fixed point; the Cranley-Patterson rotation is a PCG-RXS-M-XS hash
of (pixel, salt ^ set, frame) to 24 bits. All integer words are uint64
masked to 32 bits, the sum and the wrap are float32, as in the renderer.

Set layout, per depth d (S1, S2 sets a depth):
  1D: 0 shutter time; 1 + d*S1 + [0, L) NEE light picks, then VM*L
      volume light picks, VM volume distances, the fresnel select, the
      roulette.
  2D: 0 pixel uv, 1 lens; 2 + d*S2 + [0, L) NEE directions, then VM*L
      volume light directions, the diffuse bounce, the specular bounce.
"""

from __future__ import annotations

import numpy as np

M32 = 0xFFFFFFFF
_U64 = (1 << 64) - 1
SET_SALT_1D = 0x9E3779B9
SET_SALT_2D = 0x85EBCA6B


def _phi_d(dims: int) -> float:
    x = 2.0
    for _ in range(64):
        x = (1.0 + x) ** (1.0 / (dims + 1))
    return x


def rd_alphas_u64(dims: int) -> list[int]:
    g = _phi_d(dims)
    return [int(round(((1.0 / g) ** (i + 1) % 1.0) * (1 << 64))) & _U64
            for i in range(dims)]


A1 = rd_alphas_u64(1)[0]
A2 = rd_alphas_u64(2)


def _u32(x) -> np.ndarray:
    return np.asarray(x).astype(np.uint64) & np.uint64(M32)


def _rd(alpha: int, base: np.ndarray, n: np.ndarray) -> np.ndarray:
    word = (_u32(base) << np.uint64(32)) | _u32(n)
    with np.errstate(over="ignore"):
        prod = word * np.uint64(alpha)
    return (prod >> np.uint64(40)).astype(np.float32) * np.float32(2.0 ** -24)


def pcg_hash(x: np.ndarray) -> np.ndarray:
    m = np.uint64(M32)
    x = (_u32(x) * np.uint64(747796405) + np.uint64(2891336453)) & m
    x = (((x >> ((x >> np.uint64(28)) + np.uint64(4))) ^ x)
         * np.uint64(277803737)) & m
    return (x >> np.uint64(22)) ^ x


def _scramble(pixel, salt: int, frame) -> np.ndarray:
    h = pcg_hash(pixel)
    h = pcg_hash(h ^ np.uint64(salt & M32))
    h = pcg_hash(h ^ _u32(frame))
    return (h >> np.uint64(8)).astype(np.float32) * np.float32(2.0 ** -24)


class Layout:
    """Set ids of one render's settings."""

    def __init__(self, nee_light_samples: int, volume_marches: int,
                 max_bounces: int):
        self.L = nee_light_samples
        self.VM = volume_marches
        self.S1 = self.L + self.VM * (self.L + 1) + 2
        self.S2 = self.L * (1 + self.VM) + 2
        self.num_1d = 1 + (max_bounces + 1) * self.S1

    def light_pick(self, d, i):
        return 1 + d * self.S1 + i

    def vol_pick(self, d, m, i):
        return 1 + d * self.S1 + self.L + m * self.L + i

    def vol_dist(self, d, m):
        return 1 + d * self.S1 + self.L * (1 + self.VM) + m

    def fresnel(self, d):
        return d * self.S1 + self.S1 - 1

    def roulette(self, d):
        return d * self.S1 + self.S1

    @staticmethod
    def pixel_uv():
        return 0

    def nee(self, d, i):
        return 2 + d * self.S2 + i

    def vol(self, d, m, i):
        return 2 + d * self.S2 + self.L + m * self.L + i

    def diffuse(self, d):
        return 2 + d * self.S2 + self.S2 - 2

    def spec(self, d):
        return 2 + d * self.S2 + self.S2 - 1


class Streams:
    """Samples for a batch of (frame, pixel, sample index) rays; `frame`
    is the frame number (its low 32 bits salt the streams)."""

    def __init__(self, layout: Layout, frame, pixel, sample_idx):
        self.layout = layout
        self.frame = _u32(frame)
        self.pixel = _u32(pixel)
        self.sidx = _u32(sample_idx)

    def take(self, idx: np.ndarray) -> "Streams":
        return Streams(self.layout, self.frame[idx], self.pixel[idx],
                       self.sidx[idx])

    def u1(self, set_id: int) -> np.ndarray:
        base = (self.frame + np.uint64(set_id)) & np.uint64(M32)
        v = _rd(A1, base, self.sidx) + _scramble(
            self.pixel, SET_SALT_1D ^ set_id, self.frame)
        return np.remainder(v, np.float32(1.0))

    def u2(self, set_id: int) -> np.ndarray:
        base = ((self.frame + np.uint64(self.layout.num_1d + set_id))
                & np.uint64(M32))
        bu = _rd(A2[0], base, self.sidx)
        bv = _rd(A2[1], base, self.sidx)
        su = _scramble(self.pixel, SET_SALT_2D ^ (2 * set_id), self.frame)
        sv = _scramble(self.pixel, SET_SALT_2D ^ (2 * set_id + 1),
                       self.frame)
        return np.remainder(np.stack([bu + su, bv + sv], axis=-1),
                            np.float32(1.0))
