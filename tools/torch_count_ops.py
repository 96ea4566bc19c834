#!/usr/bin/env python3
"""Count the device ops of one render pass of the port, on the CPU.

    python3 tools/torch_count_ops.py [--root DIR] [--fused]

Renders the 16x16 default scene at 1 spp on the CPU with the port at DIR
(default: this checkout) and counts, with a TorchDispatchMode, the ATen
ops that would each launch a kernel on the card (views, empties and
other metadata ops excluded), each kernel wrapper counted as one launch
whatever its plain twin runs: a prediction of the launch counts that
torch.profiler then measures on the card.

Default: the segment-queue path at `march_relaxation` 1.5; prints the
ops that `integrator._segment_queue_tail` issues at each bounce
(emission and finish included) and the pass's total.

--fused: the fused path (the default settings); prints the pass's ops
by glue family: the equi-angular samples and the intersect cost key
(torch code in `integrator` where the tree has it, else the kernel
wrappers `shade_cuda.equi_angular` and `intersect_cuda.intersect_cost_key`,
one launch a call), the fused path's other kernels (closest hit, sort
key, the bounce tail's segments, march and tail sum), and everything
else (camera, sorts, unsort, `_derive_shading`, splat).
"""

from __future__ import annotations

import argparse
import sys
from collections import Counter
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
NO_LAUNCH = {"view", "_unsafe_view", "select", "slice", "unsqueeze",
             "squeeze", "expand", "t", "permute", "alias", "as_strided",
             "empty", "empty_like", "detach", "unbind", "split",
             "lift_fresh"}
QUEUE_WRAPPERS = {"march_cuda": ("march", "march_occlusion",
                                 "march_occlusion_chained", "enqueue",
                                 "occlusion_march"),
                  "shade_cuda": ("queue_segments", "queue_sum",
                                 "shadow_march", "equi_angular"),
                  "intersect_cuda": ("intersect_cost_key",)}
# the fused path's families: (module, name, family, one launch a call)
FUSED = (("integrator", "_equi_angular_samples", "equi-angular samples",
          False),
         ("shade_cuda", "equi_angular", "equi-angular samples", True),
         ("integrator", "_intersect_cost_key", "intersect cost key", False),
         ("intersect_cuda", "intersect_cost_key", "intersect cost key", True),
         ("intersect_cuda", "closest_hit_shading", "kernels", True),
         ("shade_cuda", "shadow_sort_key", "kernels", True),
         ("shade_cuda", "shadow_segments", "kernels", True),
         ("shade_cuda", "shadow_march", "kernels", True),
         ("shade_cuda", "tail_sum", "kernels", True))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--fused", action="store_true",
                    help="count the fused pass by glue family")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))
    from torch.utils._python_dispatch import TorchDispatchMode

    from rayn_tpu_torch.config import RenderSettings
    from rayn_tpu_torch.ops import intersect_cuda, march_cuda, shade_cuda
    from rayn_tpu_torch.render import integrator, renderer
    from rayn_tpu_torch.scene import presets

    mods = {"march_cuda": march_cuda, "shade_cuda": shade_cuda,
            "intersect_cuda": intersect_cuda, "integrator": integrator}
    counts: Counter = Counter()
    state = {"family": "everything else", "on": True}

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if state["on"] and func.__name__.split(".")[0] not in NO_LAUNCH:
                counts[state["family"]] += 1
            return func(*args, **(kwargs or {}))

    def attributed(fn, family, one_launch):
        """fn with its ops counted under `family` (one op a call, its own
        ops not counted, when it is a kernel wrapper)."""
        def call(*a, **kw):
            outer = dict(state)
            state["family"] = family
            if one_launch:
                counts[family] += 1
                state["on"] = False
            try:
                return fn(*a, **kw)
            finally:
                state.update(outer)
        return call

    res = (16, 16)
    data, static, cam = presets.default_scene(resolution=res, device="cpu")
    s = RenderSettings(resolution=res, spp=1, max_marches=24,
                       max_vis_marches=16, rays_per_pass=res[0] * res[1],
                       march_relaxation=1.0 if args.fused else 1.5)
    if args.fused:
        for mod, name, family, one in FUSED:
            if hasattr(mods[mod], name):
                setattr(mods[mod], name,
                        attributed(getattr(mods[mod], name), family, one))
        with Count():
            renderer.render_frame(data, static, s, cam, frame=1)
        print(f"root {Path(args.root).resolve()}: fused pass ops by family "
              f"{dict(sorted(counts.items()))}, pass total "
              f"{sum(counts.values())}")
        return 0
    for mod, names in QUEUE_WRAPPERS.items():
        for name in names:
            if hasattr(mods[mod], name):
                setattr(mods[mod], name, attributed(
                    getattr(mods[mod], name), "everything else", True))
    tail, per_bounce = integrator._segment_queue_tail, []

    def counted_tail(*a, **kw):
        before = sum(counts.values())
        out = tail(*a, **kw)
        per_bounce.append(sum(counts.values()) - before)
        return out

    integrator._segment_queue_tail = counted_tail
    with Count():
        renderer.render_frame(data, static, s, cam, frame=1)
    print(f"root {Path(args.root).resolve()}: the tail's ops per bounce "
          f"{per_bounce}, pass total {sum(counts.values())}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
