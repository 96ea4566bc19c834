"""Vector math on trailing-axis-3 tensors (port of rayn_tpu.utils.vecmath).

Dot products are written out component by component, ((x + y) + z), so
the summation order is the same on every device and at every tensor
size: per-ray results must not depend on where a ray sits in a pass.
"""

from __future__ import annotations

import torch


def div(a, b):
    """IEEE float32 a / b where either side may be a Python number.
    torch rounds `c / t` as reciprocal(t) * c, and on CUDA `t / c` as
    t * (1 / c): two roundings each. A 0-d tensor on the other operand's
    device keeps it one correctly rounded division, as in JAX and CUDA
    (made with a fill, not a host copy, so it never waits for the card)."""
    if not isinstance(a, torch.Tensor):
        a = torch.full((), a, dtype=b.dtype, device=b.device)
    elif not isinstance(b, torch.Tensor):
        b = torch.full((), b, dtype=a.dtype, device=a.device)
    return a / b


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root, as XLA and CUDA give it.
    torch's CPU kernel is off by one ulp on ~0.5% of inputs; the float64
    root rounded to float32 is exact (53 >= 2*24 + 2 bits)."""
    if x.device.type == "cpu":
        return torch.sqrt(x.to(torch.float64)).to(torch.float32)
    return torch.sqrt(x)


def dot(a: torch.Tensor, b: torch.Tensor, keepdim: bool = False):
    d = a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]
    return d.unsqueeze(-1) if keepdim else d


def length_sq(v: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    return dot(v, v, keepdim)


def length(v: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    return sqrt(length_sq(v, keepdim))


def normalize(v: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """v / |v| (NaN on zero vectors unless eps > 0 guards the norm)."""
    mag = length(v, keepdim=True)
    if eps:
        mag = torch.clamp(mag, min=eps)
    return v / mag


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz,
                        ax * by - ay * bx], dim=-1)


def reflect(v: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Mirror `v` about the normal `n`: 2(v.n)n - v."""
    return 2.0 * dot(v, n, keepdim=True) * n - v


def reflect_glsl(v: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """GLSL-style reflect of an incident vector: v - 2(v.n)n."""
    return v - 2.0 * dot(v, n, keepdim=True) * n


def orthonormal_basis(n: torch.Tensor):
    """Branchless (Pixar/Duff) orthonormal basis around unit normal `n`
    (reference src/math.rs:49-59; signum(+0) = +1)."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    ks = torch.copysign(torch.ones_like(nz), nz)
    ka = 1.0 / (1.0 + torch.abs(nz))
    kb = -ks * nx * ny * ka
    uu = torch.stack([1.0 - nx * nx * ka, ks * kb, -ks * nx], dim=-1)
    vv = torch.stack([kb, ks - ny * ny * ka * ks, -ny], dim=-1)
    return uu, vv


def basis_transform(uu, vv, ww, v):
    """Local-space v=(x,y,z) in world space: x*uu + y*vv + z*ww."""
    return uu * v[..., 0:1] + vv * v[..., 1:2] + ww * v[..., 2:3]
