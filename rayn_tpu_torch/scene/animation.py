"""Time-sampled animation channels (port of rayn_tpu.scene.animation).

A channel is a uniform grid of knots over [t0, t1], linearly
interpolated at each ray's time; constants are 1-knot channels, and
procedural closures or keyframes are baked onto the grid on the host
(`AnimChannel.from_fn`, `AnimChannel.keyframes`). The JAX package
contracted one-hot lerp weights because native gathers were slow on the
TPU; here the lerp is two plain gathers, which gives the same values
(the one-hot form only added exact zeros). The CUDA kernels lerp the
same way per lane (csrc/common.cuh `lerp_state`, `track_at`).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

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

    @staticmethod
    def keyframes(times, values, device="cuda") -> "AnimChannel":
        """Bake (time, value) keyframes onto the uniform grid over
        times[0]..times[-1]: values at uniformly spaced times are stored
        as they are, others are resampled on the host (np.interp)."""
        times = np.asarray(times, np.float64)
        values = np.atleast_2d(np.asarray(values, np.float32))
        if values.shape[0] != times.shape[0]:
            raise ValueError("times and values length mismatch")
        t0, t1 = float(times[0]), float(times[-1])
        uniform = np.linspace(t0, t1, len(times))
        if not np.allclose(times, uniform):
            res = np.empty_like(values)
            for d in range(values.shape[1]):
                res[:, d] = np.interp(uniform, times, values[:, d])
            values = res
        return AnimChannel(torch.as_tensor(values, device=device),
                           _f32(t0), _f32(t1))

    @staticmethod
    def from_fn(fn: Callable[[float], object], t0: float, t1: float,
                knots: int = 64, device="cuda") -> "AnimChannel":
        """Bake a host-side closure t -> value at `knots` uniform times
        over [t0, t1] (reference src/animation.rs:55-68)."""
        vals = np.stack([np.atleast_1d(np.asarray(fn(float(t)), np.float32))
                         for t in np.linspace(t0, t1, knots)])
        return AnimChannel(torch.as_tensor(vals, device=device), _f32(t0),
                           _f32(t1))

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


def _f32(x) -> float:
    return float(np.float32(x))


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


def need_time(time, what: str):
    """`time`, which an animated channel must be given."""
    if time is None:
        raise ValueError(f"{what}: an animated scene needs each ray's time")
    return time


def rows_at(ch: AnimChannel, time, what: str) -> torch.Tensor:
    """Each object's value of a batched channel [K, T, D], indexed
    [..., k, :]: the [K, D] rows of a constant channel (the time is not
    read), or [N, K, D] at each of the times [N]."""
    if ch.knots == 1:
        return ch.values[:, 0, :]
    return sample_batched(ch, need_time(time, what))


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
