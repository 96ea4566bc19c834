"""Checkpoint / resume for progressive and preemptible rendering (port of
rayn_tpu.render.checkpoint).

The film accumulator (per-pixel channel sums and sample counts) is the
checkpoint: saved between passes it makes a render resumable, and since
the samplers are counter functions of (pixel, sample_idx), spp can grow
across runs: a re-run at a higher spp renders only the missing sample
indices [spp_done, spp_new) of every pixel and adds them to the saved
film (renderer.render_frame's segment plan).

A checkpoint is an .npz file with a fingerprint of what determines the
image; a resume under another fingerprint is refused. `spp` is left out
of the fingerprint (it is progress, not identity) and stored as progress
fields:

  spp_base  - samples fully accumulated for every pixel below this index
  spp       - target sample count of the segment in flight
  next_pass - passes of the segment [spp_base, spp) already accumulated

The fingerprint hashes tensors as host bytes with their shape and dtype,
never their device or strides, so a checkpoint written on the card loads
on the CPU and the other way round; a function (a material's albedo
function, a user-written SDF program's) by its name, bytecode and
constants, not by the values its closure captures. The settings classes of
the two packages differ, so a JAX checkpoint does not resume here.

The film's extra AOV accumulators are saved by position as extra0,
extra1, ...; settings.extra_aovs is in the fingerprint, so a load always
finds the arrays the settings name.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from rayn_tpu_torch.config import RenderSettings
from rayn_tpu_torch.ops.sdf import SdfProgram
from rayn_tpu_torch.render import film as film_mod

_CHANNELS = film_mod.CHANNELS


class Progress(NamedTuple):
    """Resume point of a checkpointed render (see module docstring)."""
    film: film_mod.Film
    spp_base: int
    spp: int
    next_pass: int


def _code_id(fn) -> str:
    """A function's identity across processes: its qualified name, its
    bytecode and its constants (not the values its closure captures)."""
    code = getattr(fn, "__code__", None)
    if code is None:
        return f"callable {type(fn).__qualname__}"
    consts = tuple(c for c in code.co_consts if not hasattr(c, "co_code"))
    return f"{fn.__qualname__} {code.co_code.hex()} {consts!r}"


def _leaves(x):
    """The tensors and scalars of a nest of NamedTuples, tuples, lists
    and dicts (by sorted key), in field order, each NamedTuple preceded
    by its class name (an SDF program's operations: two programs with
    equal parameters differ there), each function as its `_code_id`; a
    user-written SDF program (ops/sdf.py SdfProgram) as its functions'
    modules and `_code_id`s and its params (the values its functions
    capture are not hashed, as in the JAX package)."""
    if isinstance(x, dict):
        for k in sorted(x):
            yield repr(k)
            yield from _leaves(x[k])
    elif isinstance(x, SdfProgram):
        yield "SdfProgram"
        for fn in (x.fn, x.fn_c, x.reduce_fn):
            yield (None if fn is None else
                   f"{getattr(fn, '__module__', None)} {_code_id(fn)}")
        yield from _leaves(x.params)
    elif isinstance(x, (tuple, list)):
        if hasattr(x, "_fields"):
            yield type(x).__name__
        for y in x:
            yield from _leaves(y)
    elif callable(x):
        yield _code_id(x)
    else:
        yield x


def _fingerprint(settings: RenderSettings, frame: int, scene=None,
                 camera=None, fis_table=None, time_range=None) -> str:
    """Digest of everything that determines the accumulated image: the
    settings except spp, the frame, the shutter time range, the camera's
    kind, and every tensor and scalar of the scene, the camera (its
    animation channels too) and the filter table (which captures the
    filter's kind, radius and table size). Resuming under any mismatch is
    refused: blending two different renders would corrupt the image."""
    cfg = dataclasses.asdict(settings)
    del cfg["spp"]  # progressive: more samples extend, never conflict
    h = hashlib.sha256()
    h.update(json.dumps(
        {"settings": cfg, "frame": frame,
         "time_range": [float(t) for t in time_range]
         if time_range is not None else None,
         "camera_kind": type(camera).__name__ if camera is not None
         else None},
        sort_keys=True, default=str).encode())
    for leaf in _leaves((scene, camera, fis_table)):
        if isinstance(leaf, torch.Tensor):
            arr = leaf.detach().cpu().numpy()
            h.update(str(arr.shape).encode())
            h.update(str(arr.dtype).encode())
            h.update(np.ascontiguousarray(arr).tobytes())
        else:
            h.update(repr(leaf).encode())
    return h.hexdigest()[:16]


def save(path: str, film: film_mod.Film, settings: RenderSettings,
         frame: int, next_pass: int, scene=None, camera=None,
         fis_table=None, time_range=None, spp_base: int = 0,
         spp: Optional[int] = None) -> None:
    """Write the film and progress to `path` atomically: a temporary file
    next to it, then os.replace. Reads the film to the host, so it waits
    for the device's work on it."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp.npz"
    np.savez(
        tmp, **{c: getattr(film, c).cpu().numpy() for c in _CHANNELS},
        **{f"extra{i}": a.cpu().numpy() for i, a in enumerate(film.extra)},
        next_pass=np.int64(next_pass), spp_base=np.int64(spp_base),
        spp=np.int64(settings.spp if spp is None else spp),
        fingerprint=np.bytes_(_fingerprint(
            settings, frame, scene, camera, fis_table, time_range).encode()))
    os.replace(tmp, path)


def load_progress(path: str, settings: RenderSettings, frame: int,
                  scene=None, camera=None, fis_table=None, time_range=None,
                  device="cpu") -> Optional[Progress]:
    """The resume point (film on `device`, segment progress), or None if
    the file is absent or was written under another fingerprint. An spp
    mismatch does not refuse: the caller decides how to extend
    (renderer.render_frame grows spp progressively)."""
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        if bytes(z["fingerprint"]).decode() != _fingerprint(
                settings, frame, scene, camera, fis_table, time_range):
            return None
        extra = []
        while f"extra{len(extra)}" in z:
            extra.append(torch.as_tensor(z[f"extra{len(extra)}"],
                                         device=device))
        film = film_mod.Film(*(torch.as_tensor(z[c], device=device)
                               for c in _CHANNELS), extra=tuple(extra))
        return Progress(film, int(z["spp_base"]), int(z["spp"]),
                        int(z["next_pass"]))


def load(path: str, settings: RenderSettings, frame: int, scene=None,
         camera=None, fis_table=None, time_range=None,
         device="cpu") -> Optional[tuple[film_mod.Film, int]]:
    """(film, next_pass), or None if absent or incompatible, an spp
    mismatch included (a same-shape resume only; load_progress knows
    progressive spp)."""
    p = load_progress(path, settings, frame, scene, camera, fis_table,
                      time_range, device)
    if p is None or p.spp != settings.spp or p.spp_base != 0:
        return None
    return p.film, p.next_pass
