#!/usr/bin/env python3
"""Count the device ops of the port's segment-queue tail, on the CPU.

    python3 tools/torch_count_ops.py [--root DIR]

Renders the 16x16 default scene at 1 spp and `march_relaxation` 1.5 on
the CPU with the port at DIR (default: this checkout) and counts, with a
TorchDispatchMode, the ATen ops that would each launch a kernel on the
card (views, empties and other metadata ops excluded), each kernel
wrapper counted as one launch whatever its plain twin runs. Prints the
ops that `integrator._segment_queue_tail` issues at each bounce
(emission and finish included) and the pass's total: a prediction of
the launch counts that torch.profiler then measures on the card.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
NO_LAUNCH = {"view", "_unsafe_view", "select", "slice", "unsqueeze",
             "squeeze", "expand", "t", "permute", "alias", "as_strided",
             "empty", "empty_like", "detach", "unbind", "split",
             "lift_fresh"}
WRAPPERS = {"march_cuda": ("march", "march_occlusion",
                           "march_occlusion_chained", "enqueue",
                           "occlusion_march"),
            "shade_cuda": ("queue_segments", "queue_sum", "shadow_march")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(HERE))
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from rayn_tpu_torch.config import RenderSettings
    from rayn_tpu_torch.ops import march_cuda, shade_cuda
    from rayn_tpu_torch.render import integrator, renderer
    from rayn_tpu_torch.scene import presets

    class Count(TorchDispatchMode):
        n, on = 0, True

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if self.on and func.__name__.split(".")[0] not in NO_LAUNCH:
                Count.n += 1
            return func(*args, **(kwargs or {}))

    def one_launch(fn):
        def call(*a, **kw):
            Count.n += 1
            Count.on = False
            try:
                return fn(*a, **kw)
            finally:
                Count.on = True
        return call

    mods = {"march_cuda": march_cuda, "shade_cuda": shade_cuda}
    for mod, names in WRAPPERS.items():
        for name in names:
            if hasattr(mods[mod], name):
                setattr(mods[mod], name, one_launch(getattr(mods[mod], name)))
    tail, per_bounce = integrator._segment_queue_tail, []

    def counted_tail(*a, **kw):
        before = Count.n
        out = tail(*a, **kw)
        per_bounce.append(Count.n - before)
        return out

    integrator._segment_queue_tail = counted_tail
    res = (16, 16)
    data, static, cam = presets.default_scene(resolution=res, device="cpu")
    s = RenderSettings(resolution=res, spp=1, max_marches=24,
                       max_vis_marches=16, march_relaxation=1.5,
                       rays_per_pass=res[0] * res[1])
    with Count():
        renderer.render_frame(data, static, s, cam, frame=1)
    print(f"root {Path(args.root).resolve()}: the tail's ops per bounce "
          f"{per_bounce}, pass total {Count.n}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
