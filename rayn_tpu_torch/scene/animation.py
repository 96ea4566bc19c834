"""Time-sampled animation channels (port of rayn_tpu.scene.animation).

A channel is a uniform grid of knots over [t0, t1], linearly
interpolated at each ray's time; constants are 1-knot channels. The
JAX package contracted one-hot lerp weights because native gathers were
slow on the TPU; here the lerp is two plain gathers, which gives the
same values (the one-hot form only added exact zeros).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from rayn_tpu_torch.utils.vecmath import div


class AnimChannel(NamedTuple):
    """values: [T, D] (or [K, T, D] when batched); t0, t1: the time range
    the knots span, as float32-rounded Python floats."""
    values: torch.Tensor
    t0: float
    t1: float

    @staticmethod
    def constant(value, device) -> "AnimChannel":
        v = np.atleast_1d(np.asarray(value, np.float32))[None, :]
        return AnimChannel(torch.as_tensor(v, device=device), 0.0, 1.0)

    @property
    def knots(self) -> int:
        return int(self.values.shape[-2])

    def sample(self, t: torch.Tensor) -> torch.Tensor:
        """Interpolate at times t [N] -> [N, D]; clamps outside [t0, t1]."""
        vals = self.values
        n = vals.shape[0]
        if n == 1:
            return vals[0].expand(t.shape + (vals.shape[1],))
        i0, frac = _lerp_state(t, self.t0, self.t1, n)
        return (vals[i0] * (1.0 - frac)[:, None]
                + vals[i0 + 1] * frac[:, None])


def _lerp_state(t, t0: float, t1: float, n: int):
    """Knot index and fraction (mirrors the JAX clip/floor/clamp)."""
    u = div(t - t0, t1 - t0) * (n - 1)
    u = torch.clamp(u, 0.0, n - 1)
    i0 = torch.clamp(torch.floor(u).to(torch.int64), 0, n - 2)
    return i0, u - i0.to(torch.float32)


def stack_channels(channels: list[AnimChannel]) -> AnimChannel:
    """Stack K channels into one batched channel with values [K, T, D]."""
    knots = max(c.values.shape[0] for c in channels)
    vals = []
    for c in channels:
        v = c.values
        if v.shape[0] == 1 and knots > 1:
            v = v.expand((knots,) + tuple(v.shape[1:]))
        elif v.shape[0] != knots:
            raise ValueError("all animated channels in a store must share "
                             f"the same knot count ({v.shape[0]} vs {knots})")
        vals.append(v)
    return AnimChannel(torch.stack(vals), channels[0].t0, channels[0].t1)


def sample_batched_at(ch: AnimChannel, obj_idx: torch.Tensor,
                      t: torch.Tensor) -> torch.Tensor:
    """Batched channel [K, T, D] at per-ray object ids and times -> [N, D]."""
    vals = ch.values
    k, n, _ = vals.shape
    idx = obj_idx.long()
    if n == 1:
        return vals[idx, 0, :]
    i0, frac = _lerp_state(t, ch.t0, ch.t1, n)
    frac = frac[:, None]
    return vals[idx, i0] * (1.0 - frac) + vals[idx, i0 + 1] * frac


def sample_batched(ch: AnimChannel, t: torch.Tensor) -> torch.Tensor:
    """Batched channel [K, T, D] at per-ray times t [N] -> [N, K, D]."""
    vals = ch.values
    k, n, d = vals.shape
    if n == 1:
        return vals[:, 0, :].expand(t.shape + (k, d))
    i0, frac = _lerp_state(t, ch.t0, ch.t1, n)
    frac = frac[:, None, None]
    v0 = vals[:, i0].permute(1, 0, 2)
    v1 = vals[:, i0 + 1].permute(1, 0, 2)
    return v0 * (1.0 - frac) + v1 * frac
