#!/usr/bin/env python3
"""Smoke test of rayn_tpu_torch, the PyTorch/CUDA port, on one NVIDIA GPU.

    python3 chip_smoke.py [--json PATH] [--profile]

Phases (any failed gate raises and the script exits non-zero):
1. Device: CUDA must be available; prints the card, the device count and
   `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`.
2. Build: compiles csrc/*.cu with nvcc (-Xptxas -v), one process per
   source; prints the build seconds and each kernel's registers, spills
   and shared memory.
3. Kernels against their plain twins: one 2^20-ray pass of the 1920x1080
   default scene runs through the plain twins on each of seven paths and
   records the real inputs of the kernels at depths 0 and 1 (sort key and
   cost key: 1 and 2): the fused path (intersect, cost key, sort key,
   the bounce tail's segments, march and tail-sum kernels),
   the fused path with MIS (the
   same tail), the split tail with MIS (segments, march, shadow-sum and
   finish kernels), the relaxed segment queue (relax 1.5) and the relax-1
   unfused segment queue (the march kernel, the cost
   key on the unfused path, and the queue-segments, refill-march and
   queue-sum kernels with the segment-queue tail that runs them), and
   those two with MIS (max_bounces 1: depths 0 and 1
   only); and the inputs of the two functions on the shadow kernels,
   bounce_tail and shadow_radiance. Each kernel then runs on those inputs
   beside its twin, gated by the JAX package's fused-vs-unfused gates;
   the intersect (all six columns), cost-key, sort-key,
   march, shadow and queue kernels must equal their twins bit for bit (a
   segments kernel's queue as a set, its volume sites drawn from the
   closest hit's t as equi_angular_plain draws them; the atomicAdds on
   the queue's count, one per warp of 32 rays with an active segment,
   are printed), the two functions their one-piece
   plain versions, and the segment-queue tail the same tail on the plain
   twins, in every output column. Kernel and twin are timed with CUDA
   events, the short kernels (cost key, sort key, finish,
   segments, sums, enqueue) by their device time in torch.profiler, and
   the twin's DE count (the finish and segments kernels: their bytes)
   gives the kernel's bound. On the fused path's intersect inputs at
   depths 0 and 1, the DEs of each ray (march.march_steps: entry DE,
   march steps, normal taps) give the DE steps per 32-lane warp of one
   thread per ray (sequential) and the ideal Σ / 32, printed beside the
   loop steps the refill kernel's warps took (its counter) and its time;
   likewise the sort key's DEs (one per active segment) at depths 1 and
   2 give its sequential and ideal steps. Rows 7 and 8,
   march_occlusion and march_occlusion_chained (the enqueue kernel, then
   the refill march on [M, 3] segments), run on the queue paths'
   segments at depths 0 and 1, at relax 1 and 1.5 with and without the
   bounding-sphere clip, and must equal their one-piece twins bit for
   bit, the enqueue kernel its twin (as a set). On the shadow queues of
   the bounce tail and of the two queue paths at depths 0 and 1, the DEs
   of each segment (march.occlusion_steps, relaxed on the relaxed path)
   give the DE steps per 32-lane warp of three schedules (one thread per
   ray or per segment, the TPU's chaining, lanes that refill from the
   queue), printed beside the times of the refill march on the scratch
   and of march_occlusion on the same segments. Then the two-phase
   marches on the relax-1 unfused path's inputs: the closest-hit march at
   depths 0 and 1 and its [12N] shadow queue. At phase-1 steps 0, 8 and
   32, march_sorted and march_phased (one launch of the march kernel)
   equal their one-piece plain versions (phase 1, the lane order and
   the resume in plain torch) and the march kernel bit for bit. The
   march kernel (a refill march over the wavefront) equals its twin bit
   for bit on the relaxed path's inputs (relax 1.5) and the unfused
   path's (relax 1) at depths 0 and 1, and on those inputs its warps'
   loop steps (its counter) are printed beside the ideal Σ DEs / 32
   (DEs per ray from march's `n_de`) and the slowest lane's per warp.
   At splits 0, 8 and 16, march_occlusion_phased and
   march_occlusion_sorted (the enqueue kernel and the refill march with
   no clip, the first-DE entry at split 0) equal their one-piece plain
   versions (phase 1, the lane order and the resume in plain torch) bit
   for bit, and at 8 and 16 march_occlusion with no clip. On the depth-1
   inputs, at each function's JAX default split, the function, the
   single-phase march and the plain function are timed, with the
   occlusion's enqueue and
   refill-march kernels by their device time beside the segment queue's
   route (the refill march on the scratch with no clip); the script
   prints how many of the queue's verdicts the bounding-sphere clip
   changes, and the registers and spills of the refill-march kernels,
   the closest-hit march's among them (no spill allowed).
4. Main path: render_frame on the default scene at 1920x1080, 4 spp,
   2^20 rays per pass, max_marches 256, max_vis_marches 100 (bench.py's
   headline workload with spp cut from 16 to 4); every kernel of the
   fused path (intersect, cost key, sort key, segments,
   march, tail sum) must have launched (the shadow-sum and finish kernels
   not); the film must hold w*h*spp samples,
   finite colour and coverage around the image centre.
5. Invariants: sorted and unsorted films equal bit for bit (256x256,
   4 spp); pass sizes 2^16 and 2^15 agree to atol 2e-5, on the fused
   path and on the relaxed path; with MIS, the split-tail film and the
   bounce-tail film agree to atol 2e-5 (the script prints whether they
   are equal bit for bit).
6. Image gates at 64x64, 32 spp, RMSE <= 1.5x a seed-swap null (plain
   twins at frame 101) and mean relative difference <= 1e-3
   (bench.py:117-151): the kernels against the plain twins on the fused
   path, on the relaxed and relax-1 unfused paths and on the split tail
   with MIS, and the relax-1 unfused path against the fused image (the
   films of the three segment-queue paths must also equal their
   plain-twin films bit for bit); the sorted two-phase
   path (`march_sort_steps=8`, `occl_sort_steps=8`, unfused), kernels
   against plain twins, and by RMSE only against the clipped unfused
   image (its occlusion marches are unclipped). The MIS image's mean
   against the image without MIS is printed, not gated: MIS removes the
   paired emitters' double count, so the mean moves by design. The
   relaxed image against the fused one is held to the RMSE gate only: over-relaxed marching darkens this scene by a few
   percent (in the JAX package too), and the script prints by how much.
7. Profile (only with --profile; run after phase 12, so that no main
   path runs after the profiler): five unprofiled 2^20-ray passes of the
   phase-4 workload, each timed on the host clock up to
   `torch.cuda.synchronize()`, then one pass under `torch.profiler`. The
   device busy time is the union of the profiled kernels' intervals; the
   idle share is 1 - busy / the median unprofiled pass wall (the
   profiler's own launch tracing inflates the profiled pass's wall, so
   that wall is printed but not used). Also prints the launch count and
   device time by kernel name. The same again for the phase-8 workload
   and for phase 4's workload on the relax-1 unfused path, on the
   phase-10 split tail with MIS and on phase 12's sorted path; then the
   fused, fused-MIS, split-MIS, unfused and sorted passes timed in turns,
   and the fused pass with `sorted_intersect` and `sorted_shadow_march`
   on and off.
8. The relaxed main path: phase 4's workload at march_relaxation 1.5,
   which takes the segment queue; the march, cost-key,
   queue-segments, refill-march and queue-sum kernels must have launched
   (and not the enqueue and
   [M, 3] march kernels, which only intersect.test_occluded runs), with
   phase 4's film gates.
9. The relax-1 unfused path: use_fused_intersect and use_fused_shadows
   off, 960x540 at 4 spp (phase 4's aspect, so its centre crop covers
   the same view angles); the same kernels as phase 8 must have
   launched, with the film gates.
10. The split tail with MIS: phase 4's workload with `mis=True` and
   `use_fused_bounce_tail=False`; the intersect, cost-key, sort-key,
   segments, march, shadow-sum and finish kernels must have
   launched (the tail-sum
   kernel not), with phase 4's film gates.
11. The smaller paths, each gated on its own kernels and the film gates:
   `use_fused_finish=False` with MIS at 480x270 (intersect, key,
   segments, march and shadow sum; no finish kernel); the default scene
   without its lights and their emissive bodies at 960x540 (intersect and
   finish; no shadow, key or tail kernel); MIS at
   relaxation 1.5 at
   480x270 (march and the queue kernels); the spheres scene with MIS at
   480x270
   on the bounce tail and on the split tail (no SDF, so no sort or cost
   key; the march wrapper launches nothing there).
12. The two-phase marches: phase 9's path at phase 4's size (1080p, 4
   spp) with `march_sort_steps=8` and `occl_sort_steps=8`, and at 960x540
   with `march_sort_steps=8` and `occl_phase1_steps=16`; the march
   kernel (march_sorted's one launch), the refill march on the scratch
   and the cost-key, queue-segments and queue-sum kernels
   must have launched and the enqueue and [M, 3] refill-march kernels
   not, with the film gates. At 256x256, 4 spp: the film with
   `march_sort_steps=8` alone equals the unfused film bit for bit, the
   film with `occl_sort_steps=8` equals the one with
   `occl_phase1_steps=16` and the unfused film with
   `shadow_bv_clip=False`, and the sorted path's films at pass sizes
   2^16 and 2^15 agree to atol 2e-5.

13. Motion and lenses (rays over [0, 2] s): render_frame on
   `default_scene(animated_geo=True)` at 8 and 64 knots, 1080p, 4 spp,
   2^20 rays a pass, on the fused path, with phase 4's gates (the same
   kernels launched, the film gates). Then the inputs of one 2^20-ray
   pass of the static scene and of the animated-geo scene at 8 and at 64
   knots, recorded at depths 0 and 1 (the keys 1 and 2) on the fused path
   with MIS, the split tail with MIS and the relaxed queue with MIS: each
   changed kernel and function equals its twin as in phase 3 (closest
   hit, cost key and sort key, both segments kernels with their queue as
   a set, the march, the sums, the bounce tail, shadow radiance and the
   queue tail bit for bit; the finish to its gates); the animated inputs
   run the `_anim_kernel` instantiations (the profiler must see them) and
   give other results at time 0 (knot 0); each one's depth-1 time on the
   animated inputs is printed beside its time on the static inputs of the
   same call. Last, `default_scene(animated=True)` and a thin-lens
   camera (aperture 0.35, focused at its look-at point) at 1080p, 4 spp,
   and an orthographic camera (6 units tall) at 960x540, each with the
   film gates.

14. The command line and its surface (after phase 13, before phase 7):
   (a) `cli.main` in process, `--width 1920 --height 1080 --spp 4
   --frames 1 2 --filter mitchell_netravali --filter-radius 2` into a
   temporary directory: exit 0, the fused path's kernels launched (the
   counts set to 0 just before it), JAX's three default channels written
   under JAX's names, and the colour PNG (read back by film.read_png)
   equal to save_channels of render_frame's film with the same settings
   and filter; the frame's wall and Msamples/s. (b) At 1080p, 4 spp: the
   frame without and with a checkpoint every 2 passes (walls, films bit
   for bit), render_frame_resilient(retries=1) with a failure injected
   after pass 5 (resumed from the last save; the film bit for bit with
   the uninterrupted one), and a 2-spp checkpoint grown to 4 spp (the
   flat film to atol 2e-5). (c) `shadow_de_iterations=8`: the inputs of
   one 2^20-ray pass on the fused path, the split tail with MIS and the
   relaxed queue, recorded at depths 0 and 1 (sort key 1 and 2); the
   sort key, bounce tail, shadow radiance, both segments kernels (queue
   as a set), the march, sums and queue tail against their twins as in
   phase 3, row 7 (march_occlusion) on the relaxed queue's segments
   against its one-piece twin; each of rows 2, 3, 5, 7 and the segments
   kernels timed at depth 1 at 8 iterations and at the scene's 12 on the
   same inputs, with the DEs each needs at both (the twin's lanes at each
   step) and its bound at 8; a 1080p 4-spp frame with the film gates, other than the
   full DE's film. At 256x256 with `max_vis_marches=0`, the fused path's
   and the relaxed queue's kernels against their twins (the queue's
   verdicts from the first-DE occlusion march). (d) 1080p at 3 spp in
   2^20-ray passes (not a multiple of spp): two runs bit for bit, and the
   film at 3*2^18-ray passes to atol 2e-5.
15. SDF programs (after phase 14, before phase 7): the registers and
   spills of every `_tape_` kernel; `program_scene` (the default scene
   with a second, program SDF instance) at 1080p: one 2^20-ray pass's
   inputs on the fused, split-MIS and relaxed paths (four calls of each
   kernel, so that the march kernel's instance 1 at depth 1 is among
   them), every kernel and the queue tail against their twins as in
   phase 3 (each a `_tape_` kernel here), rows 7-12 on instance 1's
   program against their one-piece plain versions bit for bit, and each
   one's depth-1 time, DEs (counted per instance, `sdf_flops`), ps a DE
   and bound; `every_op_scene` (an instance that uses every opcode) at
   256x256 against the twins; the default scene's depth-1 kernels with
   its MandelBox as a one-op tape (`_build.tape_forced`) against the
   MBoxOnly kernels on the same inputs, bit for bit and timed; the
   program scene's fused and relaxed 1080p frames (phase 4's and phase
   8's launch gates) and at 256x256 sorted against unsorted and 2^16
   against 2^15 passes (fused, relaxed, sorted two-phase); one profiled
   pass of the program scene and of the default scene (launches a pass).
16. Per-lane extras (after phase 15, before phase 7): the default scene
   with a smooth albedo function on its MandelBox's material, the four
   extra AOVs (depth, position, albedo, mat_id) and `compact_bounces`.
   1080p 4-spp frames on the fused path (phase 4's gates) and the relaxed
   path (phase 8's), each beside the same frame without the extras, in
   turns; the fused frame with compaction and the albedo function but no
   AOVs (peak memory); the split tail with MIS at 480x270 (phase 10's
   gates); every such frame must hold one finite accumulator a
   configured AOV. At 256x256, 4 spp: the compacted film equals the
   uncompacted one bit for bit, AOV accumulators included, on the fused,
   relaxed and sorted two-phase paths, and two compacted runs agree bit
   for bit. The inputs of one 2^20-ray pass with the albedo function and
   compaction at depths 0 and 1 (keys 1 and 2) on the fused path and the
   relaxed queue: every kernel and the queue tail against its twin as in
   phase 3, each kernel's depth-1 time. The compaction's device time by
   kernel name on the depth-1 state (the partition and gather, and the
   gather back to ray order); one profiled pass without the extras and
   with them without and with compaction, in turns (device busy time,
   launches). `cli.main --aov depth --aov albedo` at 480x270 writes the
   two AOV PNGs under JAX's names beside the three default channels.
17. Scale-out (after phase 16, before phase 7), in child processes of
   this script (`--scale-out-rank`), which load phase 2's library: (a)
   phase 4's frame through `render_frame(mesh=make_mesh())` in a
   one-rank NCCL group (a FileStore in a temporary directory), its film
   bit for bit with phase 4's, phase 4's kernels launched; (b) the same
   in a two-rank gloo group with both ranks on cuda:0 (NCCL refuses two
   ranks on one card; gloo takes CUDA tensors for all_reduce and
   broadcast): `samples` exact, colour, alpha, background and normal
   within atol 2e-5, the ranks' films the same bits, phase 4's kernels
   launched in each rank (the wrappers' counts, and the kernel names of
   one profiled sharded pass), then `render_frames_per_chip` over frames
   1-3 at 480x270 on both ranks, bit for bit with this process's
   `render_frame` of each frame; (c) `python -m rayn_tpu_torch
   --num-processes 2 --coordinator 127.0.0.1:<port>` over frames 1-4 at
   480x270, 2 spp, as two processes, every PNG byte for byte the
   one-process CLI's. Printed: the 1080p frame walls of (a) and (b)
   beside this process's frame, in turns; the pass window's all_reduce
   (host ms, and device ms under NCCL) and bytes a pass; launches of one
   sharded pass; peak memory per rank. Two ranks sharing one card
   measure the collective's cost and the sharing, not scaling; cards
   other than cuda:0 are not exercised on a one-card machine.
18. The route without kernels, closures and deep programs (after phase
   17, before phase 7): (a) phase 4's scene at 1080p, 1 spp, with
   `use_pallas=False`: its film bit for bit with the kernel route's with
   `use_fused_intersect=False`, and against the fused route (whose
   intersect kernel normalises the normal as g * (1/|g|), where the
   unfused shading info divides) phase 4's image gate; no closest-hit,
   march or cost-key kernel launched or in the profile, the fused shadow
   kernels in both; launches, device busy ms, idle share and pass walls
   of both routes, in turns; (b) `use_pallas_occlusion=False` at
   960x540: bit for bit with `use_fused_shadows=False`, no shadow-march
   launch, the queue-segments and queue-sum kernels launched; (c)
   `python -m rayn_tpu_torch --no-pallas` at 480x270, 2 spp: its PNGs
   byte for byte those of render_frame + save_channels; (d) the program
   scene with a closure torus (vecmath ops) as instance 1 at 960x540: bit
   for bit with the library Torus on the unfused route, one warning per
   fused feature; (e) the program scene with `deep_program` (12 distances
   and 12 saved points) at 1080p: every DeepTape kernel against its twin
   bit for bit on one pass's inputs (fused and relaxed paths, rows 6-12's
   functions on the deep instance, the first-DE entry, and the animated
   instantiations on the animated-geo scene at 64x64), with each one's
   depth-1 ms, DEs and ps a DE beside phase 15's Tape numbers, and the
   DeepTape kernels' registers and spills.

The last three lines of standard output are the kernels' JSON record
(rows 1-5, the cost key and both segments kernels with `ms_animated`,
their depth-1 time on the 8-knot animated-geo inputs, and the 64-knot
one; rows 2, 3, 5, 7 and the segments kernels with `ms_shadow_de_8`,
`ms_full_de_same_inputs`, their DEs at both and the bound at 8
iterations; every row that reads the SDF with `ms_program`, its
program-scene time, and rows 1, 2, 3, 6 and the cost key with
`ms_tape_default_scene` beside `ms_mbox_only_same_inputs`; the rows
phase 16 times with `ms_extras`, `max_abs_err_extras` and
`launches_extras`, their depth-1 time, error and frame launches with
per-lane albedo and compacted lanes; the rows phase 4 launches with
`launches_sharded_2_ranks`, each phase-17 (b) rank's launches in its
1080p frame; every row that reads the SDF with `ms_deep`,
`de_evals_deep`, `ps_per_de_deep` and `bound_ms_deep`, its DeepTape
kernel's phase-18 depth-1 numbers), the nvidia-smi line, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time


# Workload sizes (module constants so a CPU rehearsal can shrink them).
MAIN_RES, MAIN_SPP, MAIN_PASS = (1920, 1080), 4, 1 << 20
INV_RES, INV_PASSES = (256, 256), (1 << 16, 1 << 15)
IMG_RES, IMG_SPP = (64, 64), 32
UNFUSED_RES = (960, 540)
# phase 11's small frames keep 1080p's aspect: in a square frame the
# emissive sphere at the origin fills the centre crop of the film gate
SMALL_RES = (480, 270)
RELAX = 1.5
DEVICE = "cuda"
# phase 13: the shutter interval of the animated scenes (their channels
# span [0, 2] s) and the knot counts of the animated-geo scene
ANIM_TIME = (0.0, 2.0)
ANIM_KNOTS = (8, 64)

# H100 SXM peaks (NVIDIA data sheet): float32 outside the tensor cores
# and HBM3 bandwidth; a kernel's bound is the larger of its MandelBox DE
# flops over the first and its bytes in and out over the second.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def de_flops(iterations: int) -> int:
    """float32 operations of one MandelBox DE (csrc/common.cuh
    mandelbox_de): per iteration 3 box folds (min, max, mul, sub), |p|^2
    (3 mul, 2 add), the sphere fold (max, div, max), 4 scaling muls, 3
    mul-adds of p * scale + p0 and dr = -dr * scale + 1 (neg, mul, add):
    33; then |p| / |dr| (3 mul, 2 add, sqrt, abs, div): 8."""
    return 33 * iterations + 8


# The port's CUDA kernels: key, module of rayn_tpu_torch.ops, wrapper
# name (each wrapper counts its launches and has a `_plain` twin), and
# the kernel entries the wrapper launches.
# A kernel that reads scene positions has a second instantiation for
# animated scenes, `_anim_kernel` (ANIM_ENTRIES).
# A kernel that reads the SDF has a Tape instantiation, `_tape_kernel`, for
# any scene but one whose only SDF is a bare MandelBox, and a DeepTape one,
# `_deep_kernel`, for a scene with a program deeper than the Tape's stacks.
CUDA_KERNELS = (
    ("intersect", "intersect_cuda", "closest_hit_shading",
     ("closest_hit_kernel", "closest_hit_anim_kernel",
      "closest_hit_tape_kernel", "closest_hit_anim_tape_kernel",
      "closest_hit_deep_kernel", "closest_hit_anim_deep_kernel")),
    ("costkey", "intersect_cuda", "intersect_cost_key",
     ("cost_key_kernel", "cost_key_anim_kernel", "cost_key_tape_kernel",
      "cost_key_anim_tape_kernel", "cost_key_deep_kernel",
      "cost_key_anim_deep_kernel")),
    ("key", "shade_cuda", "shadow_sort_key",
     ("shadow_sort_key_kernel", "shadow_sort_key_anim_kernel",
      "shadow_sort_key_tape_kernel", "shadow_sort_key_anim_tape_kernel",
      "shadow_sort_key_deep_kernel", "shadow_sort_key_anim_deep_kernel")),
    ("seg", "shade_cuda", "shadow_segments",
     ("shadow_segments_kernel", "shadow_segments_anim_kernel")),
    ("smarch", "shade_cuda", "shadow_march",
     ("shadow_march_kernel", "shadow_march_relaxed_kernel",
      "shadow_march_tape_kernel", "shadow_march_relaxed_tape_kernel",
      "shadow_march_deep_kernel", "shadow_march_relaxed_deep_kernel")),
    ("ssum", "shade_cuda", "shadow_sum", ("shadow_sum_kernel",)),
    ("tsum", "shade_cuda", "tail_sum",
     ("tail_sum_kernel", "tail_sum_anim_kernel")),
    ("finish", "shade_cuda", "finish_bounce",
     ("finish_bounce_kernel", "finish_bounce_anim_kernel")),
    ("qseg", "shade_cuda", "queue_segments",
     ("queue_segments_kernel", "queue_segments_anim_kernel")),
    ("qsum", "shade_cuda", "queue_sum", ("queue_sum_kernel",)),
    ("march", "march_cuda", "march",
     ("march_kernel", "march_relaxed_kernel", "march_tape_kernel",
      "march_relaxed_tape_kernel", "march_deep_kernel",
      "march_relaxed_deep_kernel")),
    ("enqueue", "march_cuda", "enqueue", ("enqueue_kernel",)),
    ("omarch", "march_cuda", "occlusion_march",
     ("occl_march_kernel", "occl_march_relaxed_kernel",
      "occl_march_first_de_kernel", "occl_march_tape_kernel",
      "occl_march_relaxed_tape_kernel", "occl_march_first_de_tape_kernel",
      "occl_march_deep_kernel", "occl_march_relaxed_deep_kernel",
      "occl_march_first_de_deep_kernel")),
)
ENTRIES = {key: entries for key, _m, _a, entries in CUDA_KERNELS}
# each key's kernels for the constant scene and for an animated one
STATIC_ENTRIES = {k: tuple(e for e in es if "_anim_" not in e)
                  for k, es in ENTRIES.items()}
ANIM_ENTRIES = {k: tuple(e for e in es if "_anim_" in e) or es
                for k, es in ENTRIES.items()}
# Functions over those kernels, each with a `_plain` version in one
# piece: key, module, name.
FUNCTIONS = (("tail", "shade_cuda", "bounce_tail"),
             ("shadow", "shade_cuda", "shadow_radiance"),
             ("occl", "march_cuda", "march_occlusion"),
             ("chained", "march_cuda", "march_occlusion_chained"))
# Kernels timed by their device time in torch.profiler (and the enqueue
# kernel, phase 3's rows 7-8): under ~0.5 ms, CUDA events around the
# wrapper would count its host work between launches as kernel time.
DEVICE_TIMED = ("costkey", "key", "seg", "ssum", "tsum", "finish", "qseg",
                "qsum")

# The TPU kernels (every function that reaches pl.pallas_call), the
# segments kernel of rows 2 and 5 (the segment loop of their
# _shadow_delta), then the kernels that replace XLA code of the JAX
# integrator (the segment queue's two, the cost key) and the equi-angular
# samples, which the segments kernels draw: the name in the
# kernels line, the port's source, the
# file:line it replaces, the key whose time and bound the row gives (a
# kernel's or a function's), the main path and kernel key whose launches
# it gives, and the keys of the CUDA kernels that compute it.
MD, MP = "rayn_tpu_torch/csrc/march.cu", "rayn_tpu/ops/march_pallas.py"
SH, SP = "rayn_tpu_torch/csrc/shade.cu", "rayn_tpu/ops/shade_pallas.py"
JI = "rayn_tpu/render/integrator.py"
# Rows 7 and 8 on the segment-queue bounce: their segments come from the
# queue-segments kernel and their verdicts from the same refill march on
# the scratch (shadow_march_relaxed_kernel at relax 1.5, phase 8;
# shadow_march_kernel at relax 1, phase 9), so their launches are that
# kernel's; march_occlusion and march_occlusion_chained (enqueue + the
# [M, 3] refill march) serve intersect.test_occluded and are timed on
# the same segments. Rows 10 and 11 likewise: on phase 12's paths their
# verdicts are the scratch's refill march with no clip, and the
# functions (enqueue + the [M, 3] refill march) are timed on the unfused
# path's segments. Rows 9 and 12 are one launch of the march kernel (row
# 6's), so their launches are the march kernel's on phase 12's sorted
# path; row 12 has no setting of its own.
KERNEL_ROWS = (
    ("closest_hit_shading", "rayn_tpu_torch/csrc/intersect.cu",
     "rayn_tpu/ops/intersect_pallas.py:225", "intersect",
     ("main", "intersect"), ("intersect",)),
    ("shadow_sort_key", SH, f"{SP}:1971", "key", ("main", "key"), ("key",)),
    ("bounce_tail_fused", SH, f"{SP}:1711", "tail", ("main", "tsum"),
     ("seg", "smarch", "tsum")),
    ("shadow_radiance", SH, f"{SP}:1886", "shadow", ("split", "ssum"),
     ("seg", "smarch", "ssum")),
    ("finish_bounce_fused", SH, f"{SP}:1562", "finish", ("split", "finish"),
     ("finish",)),
    ("march", MD, f"{MP}:124", "march", ("relaxed", "march"), ("march",)),
    ("march_occlusion", MD, f"{MP}:780", "occl", ("relaxed", "smarch"),
     ("enqueue", "omarch", "smarch")),
    ("march_occlusion_chained", MD, f"{MP}:959", "chained",
     ("unfused", "smarch"), ("enqueue", "omarch", "smarch")),
    ("march_sorted", MD, f"{MP}:163", "march_sorted", ("sorted", "march"),
     ("march",)),
    ("march_occlusion_phased", MD, f"{MP}:582", "march_occlusion_phased",
     ("phased", "smarch"), ("enqueue", "omarch", "smarch")),
    ("march_occlusion_sorted", MD, f"{MP}:677", "march_occlusion_sorted",
     ("sorted", "smarch"), ("enqueue", "omarch", "smarch")),
    ("march_phased", MD, f"{MP}:421", "march_phased", ("sorted", "march"),
     ("march",)),
    ("shadow_segments", SH, f"{SP}:763", "seg", ("main", "seg"), ("seg",)),
    ("queue_segments", SH, f"{JI}:420", "qseg", ("relaxed", "qseg"),
     ("qseg",)),
    ("queue_sum", SH, f"{JI}:512", "qsum", ("relaxed", "qsum"), ("qsum",)),
    ("intersect_cost_key", "rayn_tpu_torch/csrc/intersect.cu", f"{JI}:144",
     "costkey", ("main", "costkey"), ("costkey",)),
    ("equi_angular_samples", SH, f"{JI}:521", "seg", ("main", "seg"),
     ("seg", "qseg")),
)
# The phase-1 steps of the two-phase functions in phase 3 (the JAX
# defaults and 0; the sorted ones are also phase 12's settings).
SPLITS = {"march_sorted": (0, 8, 32), "march_phased": (0, 8, 32),
          "march_occlusion_phased": (0, 8, 16),
          "march_occlusion_sorted": (0, 8, 16)}
ROW_SPLIT = {"march_sorted": 8, "march_phased": 32,
             "march_occlusion_phased": 16, "march_occlusion_sorted": 8}
# The refill marches: the instantiations of csrc/common.cuh refill_march
# (rows 2 and 5, the scratch's; 7 and 8, the [M, 3] one; the first-DE
# entry of rows 10 and 11 at split 0) and the closest-hit march of rows
# 6, 9 and 12 (csrc/march.cu march_refill, plain and relaxed).
REFILL_KERNELS = ("shadow_march_kernel", "shadow_march_relaxed_kernel",
                  "occl_march_kernel", "occl_march_relaxed_kernel",
                  "occl_march_first_de_kernel", "march_kernel",
                  "march_relaxed_kernel")


# float32 operations of one evaluation of each op of an SDF program
# (csrc/common.cuh tape_de), the MandelBox's from de_flops: a sphere 3 mul,
# 2 add, sqrt, sub; a box 3 abs, 3 sub, 3 max, 3 mul, 2 add, sqrt, 2 max,
# min, add; a torus 4 mul, 2 add, 2 sqrt, 2 sub; a plane 3 mul, 3 add; a
# smooth union 4 sub, 5 mul, a div, an add, a max and a min; a translate 3
# sub; a scale 3 div and a mul.
SDF_OP_FLOPS = {"Sphere": 7, "Box": 19, "Torus": 10, "Plane": 6,
                "Union": 1, "Intersection": 1, "Subtraction": 2,
                "SmoothUnion": 13, "Translate": 3, "Scale": 4, "Rounded": 1}


def sdf_flops(prog) -> int:
    """float32 operations of one DE of an SDF program (ops/sdf.py)."""
    name = type(prog).__name__
    if name == "MandelBox":
        return de_flops(prog.iterations)
    return SDF_OP_FLOPS[name] + sum(sdf_flops(v) for v in prog
                                    if isinstance(v, tuple))


def slab(sdf_ops):
    """The program scene's instance 1: a rounded slab smooth-unioned with
    a torus, 2.6 below the MandelBox (in frame: the far half of the slab
    shows at the foot of the default camera's view)."""
    return sdf_ops.translate(sdf_ops.smooth_union(
        sdf_ops.rounded(sdf_ops.box((2.0, 0.1, 2.0)), 0.05),
        sdf_ops.torus(1.2, 0.1), 0.2), (0.0, -2.6, 0.0))


def deep_program(sdf_ops):
    """Phase 18's instance 1, deeper than the Tape kernels' stacks: the
    slab's box at the end of a right-nested chain of eleven concentric
    tori, each joined by another combinator (12 distances at once), in
    twelve nested translates that together move it 2.6 down (12 saved
    points): the DeepTape kernels."""
    m = sdf_ops
    p = m.box((2.0, 0.1, 2.0))
    ops = (m.union, m.intersection, m.subtraction,
           lambda a, b: m.smooth_union(a, b, 0.05))
    for i in range(11):
        p = ops[i % 4](m.rounded(m.torus(0.4 + 0.15 * i, 0.04), 0.01), p)
    for _ in range(12):
        p = m.translate(p, (0.0, -2.6 / 12, 0.0))
    return p


def torus_closure(sdf_ops):
    """Phase 18 (d): the library Torus(1.2, 0.1) as a user-written
    closure (sdf.SdfProgram), its DE written with the port's vecmath ops
    as ops/sdf.py dist_c writes the Torus's."""
    from rayn_tpu_torch.utils import vecmath

    def torus_fn(prm, p):
        x, y, z = p[..., 0], p[..., 1], p[..., 2]
        qx = vecmath.sqrt(x * x + z * z) - prm["major"]
        return vecmath.sqrt(qx * qx + y * y) - prm["minor"]

    return sdf_ops.SdfProgram(torus_fn, {"major": 1.2, "minor": 0.1})


def animated_program_scene(resolution, device, second, knots=8):
    """presets.default_scene(animated_geo=True) (its lights and emissive
    spheres on `knots`-knot channels) with `second` as SDF instance 1,
    with a lambertian material of its own (bound 4.3):
    (data, static, camera)."""
    from rayn_tpu_torch.scene import presets
    from rayn_tpu_torch.scene.animation import AnimChannel
    from rayn_tpu_torch.scene.scene import SceneBuilder

    data, static, cam = presets.default_scene(
        resolution=resolution, device=device, animated_geo=True,
        geo_knots=knots)
    b = SceneBuilder()
    b.set_volume(0.25, 0.035)
    for kind, a, bb, power, ior in zip(*(x.tolist() for x in
                                         data.materials)):
        b._add_material(kind, a, bb, power, ior)
    mat = b.add_lambertian((0.6, 0.5, 0.4))

    def channel(ch, k):
        return AnimChannel(ch.values[k].cpu(), ch.t0, ch.t1)

    for k in range(static.n_spheres):
        b.add_sphere(channel(data.sphere_centers, k),
                     float(data.sphere_radii[k]), int(data.sphere_mats[k]))
    for i in range(static.n_lights):
        b.add_sphere_light(channel(data.light_pos, i),
                           float(data.light_radii[i]),
                           data.light_emission[i].tolist())
    b.add_sdf(data.sdf_params, static.sdf_mat, static.sdf_bound_radius)
    b.add_sdf(second, mat, bound_radius=4.3)
    return (*b.build(device), cam)


def program_scene(resolution, device, second=None):
    """presets.default_scene's scene with its MandelBox as SDF instance 0
    (bound 3.6) and `second` (default: `slab`) as instance 1, with a
    lambertian material of its own (bound 4.3 contains it): (data,
    static, camera). Built with the port's SceneBuilder as
    default_scene builds its scene."""
    import numpy as np

    from rayn_tpu_torch.ops import sdf as sdf_ops
    from rayn_tpu_torch.render.camera import PinholeCamera
    from rayn_tpu_torch.scene.scene import SceneBuilder

    b = SceneBuilder()
    b.set_volume(0.25, 0.035)
    sky = b.add_sky(top=(0.3, 0.4, 0.6),
                    bottom=np.asarray((0.2, 0.3, 0.6), np.float32) * 0.05)
    b.add_sphere((0.0, 0.0, 0.0), 100.0, sky)
    grey = b.add_dielectric(albedo=(0.2, 0.2, 0.2), roughness=0.6)
    b.add_sdf(sdf_ops.mandelbox(iterations=12, box_fold_l=1.0,
                                sphere_min_rad=0.01, sphere_fixed_rad=1.9,
                                scale=-2.1), grey, bound_radius=3.6)
    green = np.asarray((1.5, 4.5, 3.0), np.float32)
    green = green / np.linalg.norm(green)
    blue = np.asarray((1.5, 3.0, 4.5), np.float32)
    blue = blue / np.linalg.norm(blue)
    blue_emissive = b.add_emissive(blue * 3.0)
    green_emissive = b.add_emissive(green * 3.0)
    for pos, rad in [((1.2, -1.2, 1.2), 0.15), ((-1.2, 1.2, 1.2), 0.15)]:
        pos = np.asarray(pos, np.float32)
        green_pos = pos * np.asarray((1.0, -1.0, 1.0), np.float32)
        b.add_sphere_light(green_pos, rad, green * 40.0)
        b.add_sphere_light(pos, rad, blue * 40.0)
        b.add_sphere(green_pos, rad - 0.01, green_emissive)
        b.add_sphere(pos, rad - 0.01, blue_emissive)
    b.add_sphere_light((0.0, 0.0, 0.0), 0.25, green * 20.0)
    b.add_sphere((0.0, 0.0, 0.0), 0.24, green_emissive)
    b.add_sdf(second if second is not None else slab(sdf_ops),
              b.add_lambertian((0.6, 0.5, 0.4)), bound_radius=4.3)
    origin = np.asarray((-0.45, 0.2, 2.0), np.float32) * 2.25
    cam = PinholeCamera.make(resolution, 60.0, origin, (0.0, 0.0, 0.0),
                             (0.0, 1.0, 0.0), device=device)
    return (*b.build(device), cam)


def every_op_scene(resolution, device):
    """Sky, a light with its emissive body, a program that uses every
    opcode of the tape (instance 0) and a translated sphere (instance 1),
    each with its own material: (data, static, camera)."""
    from rayn_tpu_torch.ops import sdf as m
    from rayn_tpu_torch.render.camera import PinholeCamera
    from rayn_tpu_torch.scene.scene import SceneBuilder

    b = SceneBuilder()
    b.add_sphere((0.0, 0.0, 0.0), 100.0,
                 b.add_sky((0.3, 0.4, 0.6), (0.01, 0.015, 0.03)))
    b.add_sphere_light((2.0, 2.5, 2.0), 0.4, (30.0, 24.0, 15.0))
    b.add_sphere((2.0, 2.5, 2.0), 0.39, b.add_emissive((3.0, 2.4, 1.5)))
    mb = m.mandelbox(12, 1.0, 0.01, 1.9, -2.1)
    every = m.union(
        m.scale(m.subtraction(m.intersection(mb, m.sphere(1.5)),
                              m.plane((0.0, 1.0, 0.0), 0.2)), 0.8),
        m.translate(m.smooth_union(m.rounded(m.torus(1.0, 0.2), 0.05),
                                   m.box((0.3, 0.3, 0.3)), 0.25),
                    (0.5, 0.5, 0.5)))
    b.add_sdf(every, b.add_dielectric((0.2, 0.3, 0.8), 0.3),
              bound_radius=2.5)
    b.add_sdf(m.translate(m.sphere(0.4), (-1.2, -0.3, 0.5)),
              b.add_lambertian((0.7, 0.2, 0.2)), bound_radius=2.0)
    cam = PinholeCamera.make(resolution, 50.0, (0.3, 0.8, 4.0),
                             (0.0, 0.0, 0.0), (0.0, 1.0, 0.0),
                             device=device)
    return (*b.build(device), cam)


def gate(cond, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def log(msg: str) -> None:
    print(msg, flush=True)


def ptxas_report(build_log: str) -> dict:
    """{kernel entry: {registers, spill_stores, spill_loads, smem}} from
    nvcc -Xptxas -v output."""
    out, cur = {}, None
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = m.group(1)
            out[cur] = {}
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[cur]["spill_stores"] = int(m.group(1))
            out[cur]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[cur]["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            out[cur]["smem"] = int(s.group(1)) if s else 0
    return out


def busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def profile_pass(one_pass, label: str) -> dict:
    """Phase 7: device busy time, idle share and peak device memory (from
    the first pass on) of one `label` pass."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.reset_peak_memory_stats()
    one_pass()
    torch.cuda.synchronize()
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        one_pass()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    for _ in range(3):   # a session that records no kernel is retried
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            one_pass()
            torch.cuda.synchronize()
            prof_wall = (time.perf_counter() - t0) * 1e3
        kernels = [e for e in prof.events()
                   if e.device_type == DeviceType.CUDA]
        if kernels:
            break
    busy = busy_us((e.time_range.start, e.time_range.end)
                   for e in kernels) / 1e3
    by_name: dict = {}
    for e in kernels:
        ms, calls = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, calls + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:25]
    launches = sum(1 for e in prof.events() if e.name == "cudaLaunchKernel")
    wall = sorted(walls)[len(walls) // 2]
    peak = torch.cuda.max_memory_allocated()
    log(f"[7 profile] {label}: unprofiled pass wall ms {walls}; device "
        f"busy {busy} ms; idle share {1 - busy / wall} of the median wall "
        f"{wall} ms; "
        f"profiled pass wall {prof_wall} ms; {len(kernels)} kernels, "
        f"{launches} cudaLaunchKernel calls; peak device memory {peak} B")
    for name, (ms, calls) in top:
        log(f"[7 profile] {label} {ms:9.3f} ms {100 * ms / busy:6.2f}% "
            f"{calls:6d}x  {name[:90]}")
    return dict(pass_wall_ms=walls, busy_ms=busy, idle_share=1 - busy / wall,
                profiled_wall_ms=prof_wall, n_kernels=len(kernels),
                launches=launches, peak_bytes=peak,
                top=[(n, ms, c) for n, (ms, c) in top])


def io_tensors(key, a, kw, out):
    """(inputs, outputs) of one kernel call: the tensors the kernel reads
    and writes, each counted once for its bound (with each ray's time
    where the scene is animated)."""
    if key == "intersect":
        hit, info = out
        moving = a[0].sphere_centers.knots > 1
        return list(a[3:9] if moving else a[3:8]), [hit.t, hit.obj, *info]
    if key == "key":      # point .. pixel: the NEE and volume sites' rays
        return list(a[2:13] if a[1].animated else a[2:12]), [out]
    if key == "costkey":  # origin, direction, alive
        moving = a[0].sphere_centers.knots > 1
        return [a[3], a[4], a[6]] + ([a[5]] if moving else []), [out]
    if key == "smarch":   # the queued segments' start and end, the queue
        segs = a[1]
        count = int(segs.count[0])
        return ([segs.geom.reshape(6, -1)[:, :count], segs.queue[:count],
                 segs.count], [out])
    if key == "ssum":
        segs, verdict = a
        return [segs.k, segs.active, verdict], [out]
    if key == "qsum":
        radiance, segs, verdict = a
        return [radiance, segs.k, segs.active, verdict], [out]
    if key in ("tail", "shadow", "finish", "seg", "qseg", "tsum"):
        if key in ("shadow", "seg", "qseg"):
            (_cfg, tabs_, state, info, mat, live, recv, vtr, t_hit) = a
        elif key == "tail":
            (_cfg, tabs_, state, hit, info, mat, live, recv, vtr, t_hit) = a
        elif key == "tsum":
            (_cfg, tabs_, state, hit, info, mat, live, recv, vtr, segs,
             verdict) = a
        else:
            (_cfg, tabs_, state, hit, info, mat, live, recv, vtr, rad) = a
        ins = [info.point, info.normal, info.offset_by, state.origin,
               state.direction, state.throughput, state.sample_idx,
               state.pixel, mat.kind, mat.color_a, mat.power, live, recv,
               vtr] + ([state.time] if tabs_.animated else [])
        if key not in ("shadow", "seg", "qseg"):  # the finish's columns
            ins += [hit.obj, state.color_out, state.bg_out, state.alpha_out,
                    state.normal_out, state.prev_pdf, mat.color_b, mat.ior,
                    rad if key == "finish" else state.radiance]
        if key == "finish":
            return ins, list(out.values())
        if key == "tsum":
            return ins + [segs.k, segs.active, verdict], list(out.values())
        ins.append(t_hit)
        if key in ("seg", "qseg"):
            count = int(out.count[0])
            return ins, [out.geom, out.k, out.active, out.queue[:count],
                         out.count]
        return ins, (list(out.values()) if key == "tail" else [out])
    if key == "march":
        return [a[1], a[2], a[3], kw["eps_abs"], kw["eps_lin"],
                kw["active"]], [out]
    return [a[1], a[2], a[5]], [out]     # occl, chained: start, end, act


# ------------------------------------------------------- 17. scale-out
# The accumulators whose sums two ranks may order differently (samples
# is a count, exact at any rank count), and their gate (the JAX
# package's, tests/test_sharding.py).
SHARD_ATOL = 2e-5
# phase 17 (c): the command-line farm's frames [1, 5) and samples a pixel
FARM_FRAMES, FARM_SPP = (1, 5), 2


def scale_out_rank(cfg: dict) -> int:
    """One rank of phase 17, in its own process: joins the group that
    `cfg` names, renders the 1080p frame twice through
    `render_frame(mesh=...)` (the first with launch counts and peak
    memory, the second timed as well), saves the film, times the pass
    window's all_reduce, profiles one sharded pass and, with
    cfg["frames"], renders frames 1-3 at cfg["small_res"] with
    `render_frames_per_chip`. Prints one "SCALE_OUT {json}" line."""
    import dataclasses

    import torch
    import torch.distributed as dist
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from rayn_tpu_torch import _build
    from rayn_tpu_torch.config import RenderSettings
    from rayn_tpu_torch.ops import filters, intersect_cuda, march_cuda
    from rayn_tpu_torch.ops import shade_cuda
    from rayn_tpu_torch.parallel import distributed, sharding
    from rayn_tpu_torch.render import film as film_mod
    from rayn_tpu_torch.render import renderer
    from rayn_tpu_torch.scene import presets
    from rayn_tpu_torch.utils import rng

    rank, world, cuda = cfg["rank"], cfg["world"], cfg["device"] == "cuda"
    if cuda and not torch.cuda.is_available():
        raise RuntimeError("scale-out rank: no CUDA device")
    t_start = time.perf_counter()
    if cuda:
        _build.load(verbose=True)   # phase 2's build: found, not rebuilt
    store = f"file://{cfg['store']}"
    if world == 1:
        # distributed.init starts no group for one process
        if cuda:
            torch.cuda.set_device(0)
        dist.init_process_group(cfg["backend"], init_method=store, rank=0,
                                world_size=1)
    else:
        gate(distributed.init(coordinator_address=store,
                              num_processes=world, process_id=rank,
                              backend=cfg["backend"], device=cfg["device"]),
             "scale-out rank: no group started")
    mesh = sharding.make_mesh(device=None if cuda else cfg["device"])
    dev = mesh.device
    gate(mesh.size == world and mesh.rank == rank,
         f"scale-out rank {rank}: mesh {mesh}")
    mods = {"intersect_cuda": intersect_cuda, "shade_cuda": shade_cuda,
            "march_cuda": march_cuda}
    kernels = {key: getattr(mods[m], attr)
               for key, m, attr, _e in CUDA_KERNELS}

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    s = RenderSettings(resolution=tuple(cfg["res"]), spp=cfg["spp"],
                       rays_per_pass=cfg["pass"], max_marches=256,
                       max_vis_marches=100)
    w, h = s.resolution
    data, static, cam = presets.default_scene(resolution=(w, h), device=dev)
    out = dict(rank=rank, world=world, backend=cfg["backend"],
               mesh=mesh.shape, start_s=time.perf_counter() - t_start)
    walls, films = [], []
    for i in range(2):
        for fn in kernels.values():
            fn.launches = 0
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        sharding.barrier(mesh)
        sync()
        t0 = time.perf_counter()
        films.append(renderer.render_frame(data, static, s, cam, frame=1,
                                           mesh=mesh))
        sync()
        walls.append(time.perf_counter() - t0)
        if i == 0:
            out["launches"] = {k: fn.launches for k, fn in kernels.items()}
            out["peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                                 if cuda else 0)
    gate(all(torch.equal(a, b) for a, b in zip(
        film_mod.tensors(films[0]), film_mod.tensors(films[1]))),
         f"scale-out rank {rank}: two renders of the frame differ")
    out["walls_s"] = walls
    torch.save([t.cpu() for t in film_mod.tensors(films[0])],
               os.path.join(cfg["out"], f"{cfg['tag']}_r{rank}.pt"))
    del films

    # the pass window's all_reduce alone, at this frame's pass plan
    pass_size, n_passes = renderer.seg_passes(s, s.spp, world)
    per_rank = pass_size // world
    lo, hi = sharding.pass_window(0, pass_size, s.spp, w * h)
    buf = torch.zeros(((hi - lo) * 11,), device=dev)
    host_ms, dev_ms = [], []
    for _ in range(6):
        # device time under NCCL only: gloo reduces on the host
        ev = ([torch.cuda.Event(enable_timing=True) for _ in range(2)]
              if cfg["backend"] == "nccl" else None)
        sync()
        t0 = time.perf_counter()
        if ev:
            ev[0].record()
        dist.all_reduce(buf, group=mesh.group)
        if ev:
            ev[1].record()
        sync()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        if ev:
            dev_ms.append(ev[0].elapsed_time(ev[1]))
    out.update(passes=n_passes, per_rank=per_rank,
               reduce_bytes=buf.numel() * 4, reduce_host_ms=host_ms[1:],
               reduce_device_ms=dev_ms[1:] or None)
    del buf

    # one profiled sharded pass: kernel names and launches
    tables = rng.build_sample_tables(s, 1)
    fis = filters.build_fis_table(filters.blackman_harris(1.5),
                                  s.filter_table_size, device=dev)
    scratch = film_mod.new_film(w * h, dev, s)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    for _ in range(3):   # a session that records no kernel is retried
        with profile(activities=acts) as prof:
            sharding.render_pass_sharded(mesh, scratch, data, static, s,
                                         tables, cam, fis, 0, per_rank,
                                         1.0 / 24, 2.0 / 24)
            sync()
        names = sorted({e.name for e in prof.events()
                        if e.device_type == DeviceType.CUDA})
        if names or not cuda:
            break
    out["kernel_names"] = names
    out["pass_launches"] = sum(1 for e in prof.events() if e.name in (
        "cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
        "cuLaunchKernelEx"))
    del scratch

    if cfg.get("frames"):
        small = dataclasses.replace(s, resolution=tuple(cfg["small_res"]))
        d2, st2, c2 = presets.default_scene(resolution=small.resolution,
                                            device=dev)
        for fn in kernels.values():
            fn.launches = 0
        sync()
        t0 = time.perf_counter()
        got = sharding.render_frames_per_chip(d2, st2, small, c2, [1, 2, 3],
                                              mesh=mesh)
        sync()
        out["frames_wall_s"] = time.perf_counter() - t0
        out["frames_launches"] = {k: fn.launches
                                  for k, fn in kernels.items()}
        torch.save([[t.cpu() for t in film_mod.tensors(f)] for f in got],
                   os.path.join(cfg["out"], f"{cfg['tag']}_frames_r{rank}.pt"))
    dist.destroy_process_group()
    print("SCALE_OUT " + json.dumps(out), flush=True)
    return 0


def run_ranks(cmds, label: str, timeout: float = 300.0) -> list:
    """Start the commands together; every one's standard output. Their
    output goes to files, so that no process blocks on a full pipe while
    another waits for it in a collective. A process that fails or
    outlives `timeout` fails the phase, and none is left running."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = here + os.pathsep + env.get("PYTHONPATH", "")
    with tempfile.TemporaryDirectory() as logs:
        files = [(open(f"{logs}/{i}.out", "w+"), open(f"{logs}/{i}.err", "w+"))
                 for i in range(len(cmds))]
        procs = [subprocess.Popen(c, cwd=here, env=env, stdout=o, stderr=e,
                                  text=True) for c, (o, e) in zip(cmds, files)]
        try:
            # a rank that failed leaves the others waiting in a
            # collective: stop them at once
            deadline = time.monotonic() + timeout
            while (any(p.poll() is None for p in procs)
                   and not any(p.poll() for p in procs)
                   and time.monotonic() < deadline):
                time.sleep(0.2)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        outs, bad = [], []
        for i, (p, (o, e)) in enumerate(zip(procs, files)):
            o.seek(0)
            e.seek(0)
            out, err = o.read(), e.read()
            o.close()
            e.close()
            outs.append(out)
            if p.returncode != 0:
                bad.append(f"process {i} exited {p.returncode}:\n"
                           f"{out[-2000:]}\n{err[-4000:]}")
    # -9: stopped after another process failed, or at the time limit
    gate(not bad, f"{label}: " + "\n".join(bad))
    return outs


def scale_out(data, static, cam, main_s, need, absent, cli) -> dict:
    """Phase 17 (module docstring): (a) one NCCL rank, (b) two gloo ranks
    on one card, then frames one per rank, (c) the command line's frame
    farm; gates and the printed numbers. Returns the phase's record."""
    import dataclasses
    import socket

    import torch

    from rayn_tpu_torch import _build
    from rayn_tpu_torch.render import film as film_mod
    from rayn_tpu_torch.render import renderer
    from rayn_tpu_torch.scene import presets

    cuda = DEVICE == "cuda"
    dev = torch.device("cuda", 0) if cuda else torch.device(DEVICE)
    W, H = main_s.resolution
    rec = {}
    t_phase = time.perf_counter()

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def parent_frame():
        """Phase 4's frame in this process: (film on the host, wall)."""
        sync()
        t0 = time.perf_counter()
        f = renderer.render_frame(data, static, main_s, cam, frame=1)
        sync()
        wall = time.perf_counter() - t0
        return [t.cpu() for t in film_mod.tensors(f)], wall

    def rank_cmd(cfg):
        return [sys.executable, os.path.abspath(__file__),
                "--scale-out-rank", json.dumps(cfg)]

    def results(outs):
        return [json.loads(next(line[len("SCALE_OUT "):]
                                for line in o.splitlines()
                                if line.startswith("SCALE_OUT ")))
                for o in outs]

    def gate_launches(label, launches):
        gate(all(launches[k] > 0 for k in need)
             and not any(launches[k] for k in absent),
             f"{label}: launches {launches}, needed {need}, absent {absent}")

    film4, wall4 = parent_frame()
    walls_parent = [wall4]
    if cuda:
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        base = {"device": DEVICE, "res": [W, H], "spp": main_s.spp,
                "pass": main_s.rays_per_pass, "out": tmp,
                "small_res": list(SMALL_RES)}

        # (a) one NCCL rank
        cfg_a = dict(base, rank=0, world=1, tag="a", store=f"{tmp}/store_a",
                     backend="nccl" if cuda else "gloo")
        (res_a,) = results(run_ranks([rank_cmd(cfg_a)], "17 (a)"))
        film_a = torch.load(f"{tmp}/a_r0.pt")
        gate_launches("17 (a)", res_a["launches"])
        gate(all(torch.equal(x, y) for x, y in zip(film_a, film4)),
             "17 (a): the one-rank NCCL film differs from phase 4's")
        del film_a

        # (b) two gloo ranks on the one card, then frames one per rank
        cfg_b = dict(base, world=2, tag="b", store=f"{tmp}/store_b",
                     backend="gloo", frames=True)
        res_b = results(run_ranks(
            [rank_cmd(dict(cfg_b, rank=r)) for r in range(2)], "17 (b)"))
        films_b = [torch.load(f"{tmp}/b_r{r}.pt") for r in range(2)]
        gate(all(torch.equal(x, y) for x, y in zip(*films_b)),
             "17 (b): the two ranks' films differ")
        gate(torch.equal(films_b[0][4], film4[4]),
             "17 (b): samples differ from phase 4's")
        diff_b = {c: (x - y).abs().max().item() for c, x, y in zip(
            film_mod.CHANNELS[:4], films_b[0], film4)}
        gate(all(d <= SHARD_ATOL for d in diff_b.values()),
             f"17 (b): max |film - phase 4's| {diff_b} > {SHARD_ATOL}")
        for r, res in enumerate(res_b):
            gate_launches(f"17 (b) rank {r}", res["launches"])
            gate_launches(f"17 (b) rank {r} frames", res["frames_launches"])
        for label, res in [("(a) rank 0", res_a)] + [
                (f"(b) rank {r}", x) for r, x in enumerate(res_b)]:
            # the counts are the gate; the profiler's names, where its
            # session recorded kernels at all, must agree with them
            names = res["kernel_names"]

            def seen(entry):
                # the entry as a whole name: march_kernel is not
                # shadow_march_kernel
                pat = re.compile(rf"(?<!\w){entry}(?!\w)")
                return any(pat.search(n) for n in names)

            missing = [k for k in need
                       if not any(seen(e) for e in STATIC_ENTRIES[k])]
            gate(not (cuda and names and missing),
                 f"17 {label}: the profiler saw no kernel of {missing} in "
                 f"{names}")
            ours = sorted(e for es in ENTRIES.values() for e in es
                          if seen(e))
            log(f"[17 scale-out] {label}: the profiled sharded pass ran "
                f"{len(names)} distinct kernels, the port's "
                f"{ours or 'none recorded'}, and "
                f"{[n[:80] for n in names if 'nccl' in n.lower()]} of NCCL")
        del films_b
        sc = presets.default_scene(resolution=SMALL_RES, device=dev)
        small = dataclasses.replace(main_s, resolution=SMALL_RES)
        for r in range(2):
            got = torch.load(f"{tmp}/b_frames_r{r}.pt")
            for i, f in enumerate((1, 2, 3)):
                ref = film_mod.tensors(renderer.render_frame(
                    *sc[:2], small, sc[2], frame=f))
                gate(all(torch.equal(x, y.cpu()) for x, y in zip(got[i], ref)),
                     f"17 (b) rank {r}: frame {f} of render_frames_per_chip "
                     f"differs from render_frame's")
        del sc
        _f, wall_after = parent_frame()
        walls_parent.append(wall_after)

        # (c) the command line's frame farm against one process
        _build.library_path()   # the CLI's build, once, before its ranks
        sock = socket.socket()
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
        sock.close()
        argv = ["--device", DEVICE, "--width", str(SMALL_RES[0]),
                "--height", str(SMALL_RES[1]), "--spp", str(FARM_SPP),
                "--frames", *map(str, FARM_FRAMES)]
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            rc = cli.main(argv + ["--out", f"{tmp}/one"])
        gate(rc == 0, f"17 (c): the one-process CLI: rc {rc}, "
             f"{err.getvalue()[-400:]!r}")
        t0 = time.perf_counter()
        run_ranks([[sys.executable, "-m", "rayn_tpu_torch", *argv,
                    "--num-processes", "2", "--process-id", str(i),
                    "--coordinator", f"127.0.0.1:{port}", "--out",
                    f"{tmp}/farm"] for i in range(2)], "17 (c)")
        farm_wall = time.perf_counter() - t0

        def pngs(d):
            return {n: open(os.path.join(d, n), "rb").read()
                    for n in sorted(os.listdir(d))}

        one, farm = pngs(f"{tmp}/one"), pngs(f"{tmp}/farm")
        n_frames = FARM_FRAMES[1] - FARM_FRAMES[0]
        gate(len(one) == 3 * n_frames and farm == one,
             f"17 (c): the farm wrote {sorted(farm)}, the one-process run "
             f"{sorted(one)}, or a PNG differs")

    log(f"[17 scale-out] (a) one NCCL rank: film bit for bit with phase "
        f"4's; launches {res_a['launches']}")
    log(f"[17 scale-out] (b) two gloo ranks on cuda:0: samples exact, "
        f"max |d| {diff_b} (atol {SHARD_ATOL}), ranks the same bits; "
        f"frames 1-3 at {SMALL_RES[0]}x{SMALL_RES[1]} per rank bit for bit "
        f"with render_frame")
    log(f"[17 scale-out] (c) python -m rayn_tpu_torch --num-processes 2, "
        f"frames {FARM_FRAMES[0]}-{FARM_FRAMES[1] - 1} at {SMALL_RES[0]}x"
        f"{SMALL_RES[1]}, {FARM_SPP} spp: {len(farm)} PNGs byte for byte "
        f"the one-process run's; the two processes took {farm_wall:.3f} s "
        f"from start to exit")
    log(f"[17 scale-out] {W}x{H} frame walls in turns, s (two ranks on one "
        f"card measure the collective's cost and the sharing, not "
        f"scaling): this process {walls_parent[0]:.4f}; (a) one NCCL rank "
        f"{res_a['walls_s']}; (b) two gloo ranks "
        f"{[r['walls_s'] for r in res_b]}; this process "
        f"{walls_parent[1]:.4f}")
    for label, res in [("(a) nccl rank 0", res_a)] + [
            (f"(b) gloo rank {r}", x) for r, x in enumerate(res_b)]:
        log(f"[17 scale-out] {label}: {res['passes']} passes of "
            f"{res['per_rank']} rays a rank; the window all_reduce "
            f"{res['reduce_bytes']} B a pass, host ms {res['reduce_host_ms']}"
            f", device ms {res['reduce_device_ms']}; one sharded pass "
            f"{res['pass_launches']} launches; the frame's kernel launches "
            f"{res['launches']}; peak device memory "
            f"{res['peak_bytes']} B; kernel library load and group start "
            f"{res['start_s']:.2f} s")
    rec.update(a=res_a, b=res_b, diff_b=diff_b, walls_parent_s=walls_parent,
               farm_wall_s=farm_wall, farm_pngs=len(farm),
               seconds=time.perf_counter() - t_phase)
    log(f"[17 scale-out] phase took {rec['seconds']:.1f} s")
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", default=None,
                    help="also write every measurement to this file")
    ap.add_argument("--profile", action="store_true",
                    help="also run phase 7, the profiled main-path passes")
    ap.add_argument("--scale-out-rank", default=None, metavar="JSON",
                    help="run one rank of phase 17 (the phase starts these "
                         "processes itself)")
    args = ap.parse_args(argv)
    if args.scale_out_rank is not None:
        return scale_out_rank(json.loads(args.scale_out_rank))

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    import dataclasses

    import numpy as np

    from rayn_tpu_torch import _build
    from rayn_tpu_torch.config import RenderSettings
    from rayn_tpu_torch.ops import filters, intersect_cuda, march_cuda
    from rayn_tpu_torch.ops import march as march_ops
    from rayn_tpu_torch.ops import sdf as sdf_ops
    from rayn_tpu_torch.ops import shade_cuda
    from rayn_tpu_torch.render import film as film_mod
    from rayn_tpu_torch.render import integrator, renderer
    from rayn_tpu_torch.render.camera import (OrthographicCamera,
                                              PinholeCamera, ThinLensCamera)
    from rayn_tpu_torch.scene import presets
    from rayn_tpu_torch.scene.scene import SceneBuilder
    from rayn_tpu_torch.utils import rng

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE, 0)
    record: dict = {}

    # ---------------------------------------------------------- 1. device
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"[1 device] {name}; device_count={count}; torch "
        f"{torch.__version__} cuda {torch.version.cuda}")
    log(f"[1 device] nvidia-smi: {smi}")
    record["device"] = dict(name=name, count=count, smi=smi)

    # ----------------------------------------------------------- 2. build
    t0 = time.perf_counter()
    _build.load(verbose=True)
    build_s = time.perf_counter() - t0
    ptx = ptxas_report(_build.build_log)
    log(f"[2 build] {build_s:.1f} s")
    for entry, p in ptx.items():
        log(f"[2 build] {entry}: {p}")
    entries = [e for es in ENTRIES.values() for e in es]
    gate(len(ptx) == len(entries)
         and all(any(f"{len(e)}{e}" in name for name in ptx) for e in entries),
         f"ptxas reported kernels {sorted(ptx)}, expected {entries}")
    record["build"] = dict(seconds=build_s, ptxas=ptx)

    W, H = MAIN_RES
    main_s = RenderSettings(resolution=(W, H), spp=MAIN_SPP,
                            rays_per_pass=MAIN_PASS, max_marches=256,
                            max_vis_marches=100)
    relax_s = dataclasses.replace(main_s, march_relaxation=RELAX)
    mis_s = dataclasses.replace(main_s, mis=True)
    split_s = dataclasses.replace(mis_s, use_fused_bounce_tail=False)
    unfused_s = dataclasses.replace(main_s, use_fused_intersect=False,
                                    use_fused_shadows=False)
    # the queue paths with MIS, captured at depths 0 and 1 only
    relax_mis_s = dataclasses.replace(relax_s, mis=True, max_bounces=1)
    unfused_mis_s = dataclasses.replace(unfused_s, mis=True, max_bounces=1)
    sorted_kw = dict(march_sort_steps=8, occl_sort_steps=8)
    sorted_s = dataclasses.replace(unfused_s, **sorted_kw)
    data, static, cam = presets.default_scene(resolution=(W, H),
                                              device=dev)
    flops_per_de = de_flops(data.sdf_params.iterations)

    # ------------------------------------ 3. kernels vs plain twins
    mods = {"intersect_cuda": intersect_cuda, "shade_cuda": shade_cuda,
            "march_cuda": march_cuda}
    wrappers = {key: (mods[mod], attr, getattr(mods[mod], attr + "_plain"))
                for key, mod, attr, _e in CUDA_KERNELS}
    kernels = {key: getattr(mod, attr)
               for key, (mod, attr, _p) in wrappers.items()}
    functions = {key: getattr(mods[mod], attr)
                 for key, mod, attr in FUNCTIONS}
    queue_tail = integrator._segment_queue_tail

    def queue_tail_plain(*a, **kw):
        """The segment-queue tail on the plain twins."""
        with plain_twins():
            return queue_tail(*a, **kw)

    # each key's CUDA path (a kernel wrapper, a function over kernels, the
    # segment-queue tail) and its plain version (a kernel's twin, a
    # function's one-piece twin, the tail on the twins)
    impl = {**kernels, **functions, "qtail": queue_tail}
    twin = {**{key: p for key, (_m, _a, p) in wrappers.items()},
            **{key: getattr(mods[mod], attr + "_plain")
               for key, mod, attr in FUNCTIONS},
            "qtail": queue_tail_plain}
    # the callables that plain_twins replaces: (module, name, CUDA path)
    recordable = {**{key: (mod, attr, kernels[key])
                     for key, (mod, attr, _p) in wrappers.items()},
                  "tail": (shade_cuda, "bounce_tail", functions["tail"]),
                  "shadow": (shade_cuda, "shadow_radiance",
                             functions["shadow"]),
                  "qtail": (integrator, "_segment_queue_tail", queue_tail)}

    @contextlib.contextmanager
    def plain_twins(capture=None, limit=2):
        """Route the render path's kernel calls to their plain twins
        (recording the first `limit` calls of each kernel, of each function
        over kernels and of the segment-queue tail into `capture`)."""
        def recorder(key, fn):
            def call(*a, **kw):
                if capture is not None and len(capture[key]) < limit:
                    capture[key].append((a, kw))
                return fn(*a, **kw)
            return call

        for key, (mod, attr, plain) in wrappers.items():
            setattr(mod, attr, recorder(key, plain))
        if capture is not None:   # these run on the twins above
            for key in ("tail", "shadow", "qtail"):
                mod, attr, fn = recordable[key]
                setattr(mod, attr, recorder(key, fn))
        try:
            yield
        finally:
            for mod, attr, fn in recordable.values():
                setattr(mod, attr, fn)

    fis = filters.build_fis_table(filters.blackman_harris(1.5), 512,
                                  device=dev)
    tables = rng.build_sample_tables(main_s, 1)
    # (path, settings, kernels and functions whose inputs it records)
    tail_keys = ("tail", "seg", "smarch", "tsum")
    queue_keys = ("qtail", "qseg", "smarch", "qsum")
    paths = (("fused", main_s, ("intersect", "costkey", "key", *tail_keys)),
             ("fused mis", mis_s, tail_keys),
             ("split mis", split_s, ("shadow", "seg", "smarch", "ssum",
                                     "finish")),
             ("relaxed", relax_s, ("march", *queue_keys)),
             ("relaxed mis", relax_mis_s, queue_keys),
             ("unfused", unfused_s, ("march", "costkey", *queue_keys)),
             ("unfused mis", unfused_mis_s, queue_keys))
    captured = {}
    for path, s, keys in paths:
        cap = {k: [] for k in impl}
        t0 = time.perf_counter()
        with plain_twins(cap):
            renderer.render_pass(film_mod.new_film(W * H, device=dev), data,
                                 static, s, tables, cam, fis, 0, MAIN_PASS,
                                 1.0 / 24, 2.0 / 24)
        torch.cuda.synchronize()
        log(f"[3 kernels] plain-twin pass of {MAIN_PASS} rays, {path} path: "
            f"{time.perf_counter() - t0:.1f} s")
        gate(all(len(cap[k]) == 2 for k in keys),
             f"{path}: captured {[len(cap[k]) for k in keys]} calls")
        for k in keys:
            captured[(path, k)] = cap[k]
        del cap

    def timed(fn, a, kw, reps):
        fn(*a, **kw)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn(*a, **kw)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    scrub = torch.empty((64 << 20,), dtype=torch.uint8, device=dev)

    def device_ms(fn, a, kw, entries, reps=10):
        # (phase 13 passes one instantiation's entries: None then also
        # says that this instantiation did not run)
        """Device time of one launch of the kernel `entries` that
        fn(*a, **kw) launches once a call, from torch.profiler (so no
        host time between launches counts), with the 50 MB L2 cache
        overwritten before each call, as a render pass leaves it: the
        mean over the launches the profiler recorded, or None if it
        recorded none. A session that records no kernel at all (the
        profiler on that machine sometimes does) is retried twice."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        fn(*a, **kw)
        torch.cuda.synchronize()
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    scrub.zero_()
                    fn(*a, **kw)
                torch.cuda.synchronize()
            cuda = [e for e in prof.events()
                    if e.device_type == DeviceType.CUDA]
            if cuda:
                break
        tags = [t for e in entries for t in (f"rayn::{e}(", f"{len(e)}{e}E")]
        ev = [e for e in cuda if any(t in e.name for t in tags)]
        if not ev:
            return None
        return sum(e.time_range.elapsed_us() for e in ev) / 1e3 / len(ev)

    def count_des(fn, a, kw):
        """MandelBox DEs of fn(*a, **kw), a plain twin or a function of
        them: the lanes of each of its march steps."""
        n_de = [0]
        orig = march_ops.dist_c

        def counting(mb, x, y, z):
            n_de[0] += x.numel()
            return orig(mb, x, y, z)

        march_ops.dist_c = counting
        try:
            fn(*a, **kw)
        finally:
            march_ops.dist_c = orig
        return n_de[0]

    def hit_steps(a):
        """[N] DEs of each ray's closest hit (march.march_steps on the
        sphere fold's bound) for closest_hit_shading's arguments `a`."""
        d_, st_, s_, o, d, h_abs, h_lin, act = a[:8]
        bound_t, _obj = intersect_cuda.sphere_fold(d_, st_, s_, o, d,
                                                   a[8] if len(a) > 8 else
                                                   None)
        detail = s_.sdf_detail_scale
        return march_ops.march_steps(
            d_.sdf_params, o, d, bound_t, 5e-5 * detail,
            0.05 * detail * h_abs, 0.05 * detail * h_lin, s_.max_marches,
            act)

    def de_evals(key, a, kw, out):
        """MandelBox DEs the kernel needs on these inputs: the intersect's
        march_steps, the cost key's one per live ray, else counted from
        the plain twin's lanes at each step."""
        if key == "intersect":
            return int(hit_steps(a).sum())
        if key == "costkey":
            return int(a[6].sum())
        return count_des(twin[key], a, kw)

    def bound(n_de, ins, outs):
        """(bound ms, what bounds it, bytes) of a call that needs n_de DEs
        and reads `ins` and writes `outs` once."""
        n_bytes = sum(t.numel() * t.element_size() for t in ins + outs)
        ops_ms = n_de * flops_per_de / PEAK_F32_FLOPS * 1e3
        bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
        return (max(ops_ms, bytes_ms),
                "operations" if ops_ms >= bytes_ms else "bytes", n_bytes)

    def same_bits(got, want):
        """Equal bit for bit (float NaNs of any payload count as equal)."""
        if got.dtype == torch.bool:
            return torch.equal(got, want)
        return bool(((got.view(torch.int32) == want.view(torch.int32))
                     | (torch.isnan(got) & torch.isnan(want))).all())

    def max_diff(got, want):
        """max |got - want| where neither is NaN (verdicts: 1.0 if any
        differs)."""
        if got.dtype == torch.bool:
            return float(bool((got != want).any()))
        d = (got - want).abs()
        d = d[~torch.isnan(d)]
        return d.max().item() if d.numel() else 0.0

    def check_verdicts(label, got, want, act):
        n_act = max(int(act.sum()), 1)
        bad = int(((got != want) & act).sum())
        gate(1.0 - bad / n_act >= 0.999, f"{label}: verdicts differ on "
             f"{bad} of {n_act} active segments")
        log(f"[3 kernels] {label}: verdicts differ on {bad} of {n_act} "
            f"active segments ({got.numel()} segments, "
            f"{int(want.sum())} occluded)")
        return float(bad > 0)

    def check_radiance(label, rg, rw):
        close = torch.isclose(rg, rw, rtol=2e-4, atol=2e-5)
        frac = close.float().mean().item()
        err = (rg - rw).abs().max().item()
        gate(frac >= 0.985 and err < 0.1,
             f"{label}: radiance close on {frac:.5f}, max |d| {err}")
        log(f"[3 kernels] {label}: radiance close {frac:.6f}, max |d| "
            f"{err:.3g}, bit for bit: {bool(torch.equal(rg, rw))}")
        return err

    seg_atomics = {}

    def check(key, path, depth, a, kw, got, want):
        label = f"{key} {path} depth {depth}"
        if key == "intersect":
            cols = {f"{c}.{f}": same_bits(getattr(g, f), getattr(w, f))
                    for c, g, w in (("hit", got[0], want[0]),
                                    ("info", got[1], want[1]))
                    for f in g._fields}
            gate(all(cols.values()), f"{label}: columns {cols} against "
                 "closest_hit_shading_plain")
            log(f"[3 kernels] {label}: t, obj, valid, point, normal, "
                "offset and material equal to the twin's bit for bit "
                f"({int((want[0].obj == static.n_spheres).sum())} SDF hits)")
            return max(max_diff(g, w) for g, w in zip(got[1], want[1])
                       if g.dtype == torch.float32)
        if key in ("key", "costkey"):
            gate(same_bits(got, want), f"{label}: differs from its twin")
            log(f"[3 kernels] {label}: equal to its twin bit for bit (mean "
                f"key {want.mean().item():.4f})")
            return max_diff(got, want)
        if key == "shadow":
            err = check_radiance(label, got, want)
            gate(same_bits(got, want), f"{label}: differs from "
                 "shadow_radiance_plain")
            return err
        if key in ("ssum", "qsum"):
            gate(same_bits(got, want), f"{label}: differs from its twin")
            log(f"[3 kernels] {label}: equal to its twin bit for bit")
            return max_diff(got, want)
        if key == "qtail":
            same = {f: same_bits(getattr(got, f), getattr(want, f))
                    for f in got._fields}
            gate(all(same.values()), f"{label}: columns {same} against the "
                 "tail on the plain twins")
            log(f"[3 kernels] {label}: every output column equal to the "
                "tail on the plain twins bit for bit")
            return max_diff(got.radiance, want.radiance)
        if key in ("seg", "qseg"):
            count = int(want.count[0])
            same = (all(same_bits(getattr(got, f), getattr(want, f))
                        for f in ("geom", "k", "active", "count"))
                    and torch.equal(got.queue[:count].sort().values,
                                    want.queue[:count].sort().values))
            gate(same, f"{label}: segments differ from the twin's")
            S, n = want.active.shape
            warps = torch.nn.functional.pad(want.active, (0, -n % 32))
            atomics = int(warps.reshape(S, -1, 32).any(-1).any(0).sum())
            seg_atomics[label] = atomics
            log(f"[3 kernels] {label}: {count} of {want.active.numel()} "
                "segments queued; segments and queue (as a set) equal to "
                f"the twin's bit for bit; {atomics} atomicAdds on the count "
                "(warps of 32 rays with an active segment)")
            return max(max_diff(got.geom, want.geom),
                       max_diff(got.k, want.k))
        if key == "smarch":
            gate(same_bits(got, want), f"{label}: verdicts differ from the "
                 "twin's")
            log(f"[3 kernels] {label}: verdicts equal to the twin's bit for "
                f"bit ({int(a[1].count[0])} queued, {int(want.sum())} "
                "occluded)")
            return max_diff(got, want)
        if key in ("tail", "finish", "tsum"):
            err = check_radiance(label, got["radiance"], want["radiance"])
            tfrac = 1.0 - torch.isclose(
                got["throughput"], want["throughput"], rtol=1e-4,
                atol=1e-5).float().mean().item()
            gate(tfrac < (1e-3 if depth == 0 else 3e-2),
                 f"{label}: throughput diverged on {tfrac}")
            afrac = (got["alive"] != want["alive"]).float().mean().item()
            gate(afrac < (1e-3 if depth == 0 else 1e-2),
                 f"{label}: alive differs on {afrac}")
            same = all(same_bits(got[f], want[f]) for f in got)
            log(f"[3 kernels] {label}: throughput diverged {tfrac:.2e}, "
                f"alive differs {afrac:.2e}, every column bit for bit: "
                f"{same}")
            gate(same or key == "finish", f"{label}: a column differs from "
                 "its plain version")
            return err
        if key == "march":
            gate(same_bits(got, want), f"{label}: differs from its twin")
            hits = int(((want < a[3]) & kw["active"]).sum())
            log(f"[3 kernels] {label}: equal to its twin bit for bit "
                f"({hits} hits)")
            return max_diff(got, want)
        act = a[5] if len(a) > 5 else kw["active"]
        return check_verdicts(label, got, want, act)

    results = {}
    for path, _s, keys in paths:
        for key in keys:
            errs = []
            for i, (a, kw) in enumerate(captured[(path, key)]):
                depth = i + (1 if key in ("key", "costkey") else 0)
                got = impl[key](*a, **kw)
                want = twin[key](*a, **kw)
                torch.cuda.synchronize()
                errs.append(check(key, path, depth, a, kw, got, want))
            if key == "qtail":   # a bounce's tail, not a kernel: no time
                results[(path, key)] = dict(max_abs_err=max(errs))
                continue
            a, kw = captured[(path, key)][1]
            out = impl[key](*a, **kw)
            ins, outs = io_tensors(key, a, kw, out)
            n_bytes = sum(t.numel() * t.element_size() for t in ins + outs)
            n_de = de_evals(key, a, kw, out)
            ops_ms = n_de * flops_per_de / PEAK_F32_FLOPS * 1e3
            bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
            ms = timed(impl[key], a, kw, reps=5)
            plain_ms = timed(twin[key], a, kw, reps=1)
            dev_ms = (device_ms(impl[key], a, kw, ENTRIES[key])
                      if key in DEVICE_TIMED else None)
            log(f"[3 kernels] {key} ({path}): kernel {ms:.3f} ms (CUDA "
                f"events), device time {dev_ms} ms (profiler), plain twin "
                f"{plain_ms:.3f} ms per call at {MAIN_PASS} rays; {n_de} DEs "
                f"-> {ops_ms:.3f} ms at {PEAK_F32_FLOPS:.3g} flop/s, "
                f"{n_bytes} B -> {bytes_ms:.3f} ms at {PEAK_BYTES_PER_S:.3g} "
                "B/s")
            results[(path, key)] = dict(
                max_abs_err=max(errs), ms=ms, device_ms=dev_ms,
                plain_ms=plain_ms, de_evals=n_de, bytes=n_bytes,
                bound_ms=max(ops_ms, bytes_ms),
                bound_by="operations" if ops_ms >= bytes_ms else "bytes")
            del out, ins, outs
    record["kernel_checks"] = {f"{p} {k}": r for (p, k), r in results.items()}
    record["segment_atomics"] = seg_atomics
    del got, want

    # ------- 3, continued: the closest hit's and the sort key's DE steps
    # Per ray, the DEs of its closest hit (march_steps: the entry DE, the
    # march steps, the normal taps of an SDF hit) and of its sort key (one
    # per active segment, at its start); per warp of 32 rays, what one
    # thread per ray costs (the slowest lane) against the ideal total / 32;
    # for the closest hit beside the loop steps the refill kernel's warps
    # took (its counter) and its time at that depth, on the fused path's
    # inputs.
    de_steps = {}
    for depth, (a, kw) in enumerate(captured[("fused", "intersect")]):
        w = hit_steps(a).reshape(-1, 32).long()
        counter = torch.zeros((1,), dtype=torch.int64, device=dev)
        kernels["intersect"](*a, warp_steps=counter)
        q = dict(des=int(w.sum()), sequential=int(w.max(-1).values.sum()),
                 ideal=int(w.sum()) / 32, refill=int(counter[0]),
                 ms=timed(kernels["intersect"], a, kw, reps=5))
        de_steps[f"intersect depth {depth}"] = q
        log(f"[3 DE steps] intersect depth {depth}: {q['des']} DEs over "
            f"{w.numel()} rays; 32-lane warp steps: sequential "
            f"{q['sequential']}, ideal {q['ideal']}, refill kernel "
            f"{q['refill']}; {q['ms']:.3f} ms")
    for depth, (a, kw) in zip((1, 2), captured[("fused", "key")]):
        n_de = torch.zeros(a[2].shape[0], dtype=torch.int32, device=dev)
        wrappers["key"][2](*a, n_de=n_de)
        w = n_de.reshape(-1, 32).long()
        q = dict(des=int(w.sum()), sequential=int(w.max(-1).values.sum()),
                 ideal=int(w.sum()) / 32,
                 device_ms=device_ms(kernels["key"], a, kw, ENTRIES["key"]))
        de_steps[f"key depth {depth}"] = q
        log(f"[3 DE steps] sort key depth {depth}: {q['des']} DEs; 32-lane "
            f"warp steps: sequential {q['sequential']}, ideal "
            f"{q['ideal']}; {q['device_ms']} ms device time")
        del n_de, w
    # The closest-hit march of the queue paths (rows 6, 9 and 12): the
    # march kernel's DEs per ray (march's n_de: the entry DE, one per
    # step) on the relaxed (relax 1.5) and unfused (relax 1) paths'
    # inputs, the warp steps of one thread per ray and the ideal, beside
    # the refill kernel's counter and its time.
    for path in ("relaxed", "unfused"):
        for depth, (a, kw) in enumerate(captured[(path, "march")]):
            n_de = torch.zeros(kw["active"].shape, dtype=torch.int32,
                               device=dev)
            march_ops.march(*a, **kw, n_de=n_de)
            w = n_de.reshape(-1, 32).long()
            counter = torch.zeros((1,), dtype=torch.int64, device=dev)
            kernels["march"](*a, **kw, warp_steps=counter)
            q = dict(des=int(w.sum()), sequential=int(w.max(-1).values.sum()),
                     ideal=int(w.sum()) / 32, refill=int(counter[0]),
                     relax=kw.get("relax", 1.0),
                     ms=timed(kernels["march"], a, kw, reps=5))
            q["refill_per_ideal"] = q["refill"] / max(q["ideal"], 1.0)
            de_steps[f"march {path} depth {depth}"] = q
            log(f"[3 DE steps] march {path} depth {depth} (relax "
                f"{q['relax']}): {q['des']} DEs over {w.numel()} rays; "
                f"32-lane warp steps: sequential {q['sequential']}, ideal "
                f"{q['ideal']}, refill kernel {q['refill']} "
                f"({q['refill_per_ideal']:.3f} of the ideal); "
                f"{q['ms']:.3f} ms")
            del n_de, w
    record["de_steps"] = de_steps

    # -------- 3, continued: the shadow queues, warp steps and designs
    # Per segment, the DEs of the plain twin's march (occlusion_steps, at
    # the path's relaxation); per warp of 32 rays, what three schedules
    # cost in DE steps: one thread per ray marching its segments in turn,
    # or one per segment (both: the sum over segments of the slowest
    # lane), the TPU's chaining (the slowest lane's sum), and lanes that
    # refill from a queue (total / 32, the drain aside). The refill march
    # on the scratch is timed beside march_occlusion (enqueue and the
    # [M, 3] refill march) on the same segments.
    def aos(segs):
        """(start, end [M, 3], active [M]) of a segment scratch."""
        g = segs.geom.reshape(6, -1).T
        return (g[:, :3].contiguous(), g[:, 3:].contiguous(),
                segs.active.reshape(-1))

    shadow_queues = {}
    for path in ("fused", "relaxed", "unfused"):
        for depth, (a, kw) in enumerate(captured[(path, "smarch")]):
            cfg, segs = a[:2]
            (mb, bv_r), = cfg.sdfs   # the default scene's one MandelBox
            relax = a[2] if len(a) > 2 else 1.0
            S, n = segs.active.shape
            start, end, act = aos(segs)
            steps = march_ops.occlusion_steps(
                mb, start, end, cfg.detail, cfg.max_steps, act,
                bv_r, relax).reshape(S, n // 32, 32).long()
            total = int(steps.sum())
            occl_args = (mb, start, end, cfg.detail, cfg.max_steps, act,
                         relax, bv_r)
            q = dict(segments=S * n, queued=int(segs.count[0]), des=total,
                     relax=relax,
                     sequential=int(steps.max(-1).values.sum()),
                     chained=int(steps.sum(0).max(-1).values.sum()),
                     ideal=total / 32,
                     march_ms=timed(kernels["smarch"], a, kw, reps=5),
                     march_occlusion_ms=timed(functions["occl"], occl_args,
                                              {}, reps=5))
            log(f"[3 shadow queue] {path} depth {depth} (relax {relax}): "
                f"{q['queued']} of {q['segments']} segments queued, {total} "
                f"DEs; 32-lane warp steps: sequential {q['sequential']}, "
                f"chained {q['chained']}, ideal {q['ideal']}; refill march "
                f"{q['march_ms']:.3f} ms, march_occlusion "
                f"{q['march_occlusion_ms']:.3f} ms")
            shadow_queues[f"{path} depth {depth}"] = q
            del segs, start, end, act, steps, occl_args
    record["shadow_queues"] = shadow_queues

    # ------------ 3, continued: rows 7 and 8 on the queue paths' segments
    # march_occlusion and march_occlusion_chained (the enqueue kernel and
    # the refill march on [M, 3] segments) against their one-piece plain
    # versions bit for bit, at relax 1 and 1.5 with and without the clip,
    # and the enqueue kernel against its twin (the queue as a set); then
    # each row's time and bound on the depth-1 inputs of its path (row 7:
    # relaxed at 1.5, clipped; row 8: unfused, clipped).
    occl_err = {"occl": 0.0, "chained": 0.0}
    for path, depth in (("relaxed", 0), ("relaxed", 1), ("unfused", 0),
                        ("unfused", 1)):
        (cfg, segs, _relax), _kw = captured[(path, "smarch")][depth]
        S, n = segs.active.shape
        start, end, act = aos(segs)
        (mb, bv_r), = cfg.sdfs
        head = (mb, start, end, cfg.detail, cfg.max_steps)
        q_got, c_got = kernels["enqueue"](act)
        q_want, c_want = wrappers["enqueue"][2](act)
        n_queued = int(c_want[0])
        gate(torch.equal(c_got, c_want) and torch.equal(
            q_got[:n_queued].sort().values, q_want[:n_queued].sort().values),
             f"enqueue {path} depth {depth}: the queue differs from its twin")
        checks = ([("occl", (*head, act, relax, bv), {})
                   for relax in (1.0, RELAX) for bv in (bv_r, 0.0)]
                  if path == "relaxed" else
                  [("chained", (mb, start.reshape(S, n, 3),
                                end.reshape(S, n, 3), cfg.detail,
                                cfg.max_steps, act.reshape(S, n), bv), {})
                   for bv in (bv_r, 0.0)])
        for key, a, kw in checks:
            got, want = functions[key](*a, **kw), twin[key](*a, **kw)
            gate(same_bits(got, want), f"{key} {path} depth {depth} at "
                 f"(relax, clip) {a[6:]}: differs from its one-piece twin")
            occl_err[key] = max(occl_err[key], max_diff(got, want))
        log(f"[3 rows 7-8] {path} depth {depth}: enqueue ({n_queued} of "
            f"{act.numel()} queued) and {checks[0][0]} at (relax, clip) or "
            f"(clip) {[c[1][6:] for c in checks]} equal to their twins bit "
            "for bit")
        if depth == 1:
            # relaxed: relax 1.5, clipped; unfused: clipped
            key, a, kw = checks[2 if path == "relaxed" else 0]
            got = functions[key](*a, **kw)
            with plain_twins():
                n_de = count_des(twin[key], a, kw)
            b_ms, b_by, n_bytes = bound(n_de, [start, end, act], [got])
            r = dict(max_abs_err=occl_err[key], ms=timed(functions[key], a,
                                                         kw, reps=5),
                     plain_ms=timed(twin[key], a, kw, reps=1),
                     de_evals=n_de, bytes=n_bytes, bound_ms=b_ms,
                     bound_by=b_by,
                     enqueue_ms=device_ms(kernels["enqueue"], (act,), {},
                                          ENTRIES["enqueue"]),
                     enqueue_bound_ms=bound(0, [act], [q_want[:n_queued],
                                                       c_want])[0],
                     march_ms=device_ms(functions[key], a, kw,
                                        ENTRIES["omarch"]))
            results[(path, key)] = r
            log(f"[3 rows 7-8] {key} ({path}, depth 1): {r['ms']:.3f} ms "
                f"(enqueue {r['enqueue_ms']} ms device time, bound "
                f"{r['enqueue_bound_ms']:.4f} ms by bytes; refill march "
                f"{r['march_ms']} ms device time), plain {r['plain_ms']:.3f} "
                f"ms; {n_de} DEs, bound {b_ms:.3f} ms by {b_by}")
        del segs, start, end, act, head, q_got, q_want, checks
    record["rows_7_8"] = {f"{p} {k}": r for (p, k), r in results.items()
                          if k in ("occl", "chained")}

    # ----------------- 3, continued: the two-phase marches, same inputs
    two_phase, clip_changes = {}, {}
    two_phase_err = {fname: 0.0 for fname in SPLITS}
    for depth in (0, 1):
        a, kw = captured[("unfused", "march")][depth]
        mb, act, steps = a[0], kw["active"], kw["max_steps"]
        mhead = (*a, kw["eps_const"], kw["eps_abs"], kw["eps_lin"])
        single = kernels["march"](*mhead, steps, act)
        (cfg, segs, _relax), _kw = captured[("unfused", "smarch")][depth]
        start, end, oact = aos(segs)
        oargs = (mb, start, end, cfg.detail, cfg.max_steps, oact)
        unclipped = functions["occl"](*oargs, bound_radius=0.0)
        clipped = functions["occl"](*oargs, bound_radius=cfg.sdfs[0][1])
        clip_changes[depth] = int(((unclipped != clipped) & oact).sum())
        log(f"[3 two-phase] depth {depth}: the bounding-sphere clip changes "
            f"{clip_changes[depth]} of {int(oact.sum())} active verdicts of "
            f"the {oact.numel()}-segment queue")
        for fname, splits in SPLITS.items():
            is_march = fname in ("march_sorted", "march_phased")
            fn = getattr(march_cuda, fname)
            fargs = (*mhead, steps, act) if is_march else oargs
            for split in splits:
                label = f"{fname} depth {depth} split {split}"
                fkw = dict(phase1_steps=split)
                # the function against the TPU schedule in plain torch
                # (phase 1, the lane order, the resume)
                got = fn(*fargs, **fkw)
                plain_fn = getattr(march_cuda, fname + "_plain")
                want = plain_fn(*fargs, **fkw)
                gate(same_bits(got, want), f"{label}: differs from its "
                     "one-piece plain version")
                if is_march:
                    # one launch of the march kernel, which the
                    # single-phase march is too
                    gate(same_bits(got, single), f"{label}: differs from "
                         "the march kernel")
                    err = max(max_diff(got, want), max_diff(got, single))
                    log(f"[3 two-phase] {label}: equal to its one-piece "
                        "plain version and the march kernel bit for bit "
                        f"({int((got < mhead[3]).sum())} hits)")
                else:
                    # the enqueue kernel and the refill march; at splits
                    # >= 1 the single-phase march with no clip too
                    n_diff = int(((got != unclipped) & oact).sum())
                    gate(split == 0 or n_diff == 0, f"{label}: differs from "
                         "the single-phase march (march_occlusion, "
                         "unclipped)")
                    err = max_diff(got, want)
                    log(f"[3 two-phase] {label}: equal to its one-piece "
                        f"plain version bit for bit; {n_diff} active "
                        "verdicts differ from the unclipped single-phase "
                        f"march's ({int(got.sum())} occluded)")
                del want
                two_phase_err[fname] = max(two_phase_err[fname], err)
                if depth == 0 or split != ROW_SPLIT[fname]:
                    continue
                # times and bound on the depth-1 inputs at the row's split
                plain_ms = timed(plain_fn, fargs, fkw, reps=1)
                if is_march:
                    # the DEs of the TPU schedule in plain torch
                    n_de = count_des(plain_fn, fargs, fkw)
                    ins = [*mhead[1:4], *mhead[5:], act]
                    extra = dict(
                        single_ms=timed(impl["march"], fargs, {}, reps=5))
                    parts = "one launch of the march kernel"
                else:
                    # the refill march's DEs: the unclipped single-phase
                    # march's (phase 1 skips the DE of a lane that stops
                    # past its end at the split)
                    n_de = count_des(twin["occl"], fargs,
                                     dict(bound_radius=0.0))
                    ins = [start, end, oact]
                    # the segment queue's route: the refill march on the
                    # scratch, unclipped
                    route = (shade_cuda.unclipped(cfg), segs, 1.0)
                    extra = dict(
                        single_ms=timed(impl["occl"], fargs,
                                        dict(bound_radius=0.0), reps=5),
                        enqueue_ms=device_ms(fn, fargs, fkw,
                                             ENTRIES["enqueue"]),
                        march_ms=device_ms(fn, fargs, fkw,
                                           ENTRIES["omarch"]),
                        scratch_ms=timed(kernels["smarch"], route, {},
                                         reps=5),
                        scratch_device_ms=device_ms(kernels["smarch"], route,
                                                    {}, ENTRIES["smarch"]))
                    parts = (f"enqueue {extra['enqueue_ms']} ms and refill "
                             f"march {extra['march_ms']} ms device time; the "
                             f"scratch's refill march {extra['scratch_ms']:.3f}"
                             f" ms ({extra['scratch_device_ms']} ms device)")
                b_ms, b_by, n_bytes = bound(n_de, ins, [got])
                r = dict(ms=timed(fn, fargs, fkw, reps=5), plain_ms=plain_ms,
                         de_evals=n_de, bytes=n_bytes, bound_ms=b_ms,
                         bound_by=b_by, split=split, **extra)
                two_phase[fname] = r
                log(f"[3 two-phase] {fname} (depth 1, split {split}): "
                    f"{r['ms']:.3f} ms, {parts}; single-phase march "
                    f"{r['single_ms']:.3f} ms; plain {plain_ms:.3f} ms; "
                    f"{n_de} DEs, bound {b_ms:.3f} ms by {b_by}")
        del single, unclipped, clipped, got, segs, start, end, oargs, fargs
    refill = {e: p for e in REFILL_KERNELS for name, p in ptx.items()
              if f"{len(e)}{e}E" in name}
    log(f"[3 two-phase] the refill-march kernels' ptxas report: {refill}")
    gate(len(refill) == len(REFILL_KERNELS) and not any(
        p.get("spill_stores") or p.get("spill_loads")
        for p in refill.values()), f"refill-march kernels spill: {refill}")
    record["two_phase"] = dict(two_phase, clip_changes=clip_changes,
                               max_abs_err=two_phase_err,
                               refill_ptxas=refill)
    # drop the last captured inputs too, or they count in phase 4's peak
    del captured, a, kw, mhead, act, oact, ins, route, scrub
    torch.cuda.empty_cache()

    def reset_launches():
        for fn in kernels.values():
            fn.launches = 0

    def main_path(phase, s, res, need, scene=None, absent=(),
                  time_range=None, filter=None, keep=False):
        """Render one frame of `s` on `scene` (default: the default scene
        at `res`) over `time_range` (default: frame 1's shutter) with the
        pixel filter `filter` (default: render_frame's); gate that the
        kernels `need` launched and the kernels `absent` did not, the
        sample count, finite colour and centre coverage. With `keep`
        the film is returned too, as "film"."""
        w, h = res
        if scene is None:
            scene = (presets.default_scene if res != MAIN_RES else
                     lambda resolution, device: (data, static, cam))
        d_, st_, c_ = scene(resolution=res, device=dev)
        reset_launches()
        torch.cuda.reset_peak_memory_stats(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        f = renderer.render_frame(d_, st_, s, c_, frame=1,
                                  time_range=time_range, filter=filter)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in kernels.items()}
        peak = torch.cuda.max_memory_allocated(dev)
        n_samples = w * h * s.spp
        log(f"[{phase}] {w}x{h} @ {s.spp} spp: {wall:.3f} s wall, "
            f"{n_samples / wall / 1e6:.4f} Msamples/s, peak device memory "
            f"{peak / 2**30:.2f} GiB ({peak} B), launches {launches}")
        gate(all(launches[k] > 0 for k in need)
             and not any(launches[k] for k in absent),
             f"{phase}: launches {launches}, needed {need}, absent {absent}")
        gate(int(f.samples.sum().item()) == n_samples, "film sample count")
        img = film_mod.resolve(f, (w, h))
        gate(np.isfinite(img.color).all(), "non-finite colour")
        gate(len(f.extra) == len(s.extra_aovs) and all(
            bool(torch.isfinite(x).all()) for x in f.extra),
            f"{phase}: {len(f.extra)} extra AOV accumulators for "
            f"{s.extra_aovs}, or non-finite ones")
        # the exact centre pixel sees the emissive sphere at the origin,
        # which does not receive light (alpha 0); coverage is checked on
        # the central 5% crop
        ch, cw = max(1, h // 40), max(1, w // 40)
        crop = img.alpha[h // 2 - ch:h // 2 + ch, w // 2 - cw:w // 2 + cw]
        gate(crop.mean() > 0.0, "no coverage around the image centre")
        log(f"[{phase}] mean colour {img.color.mean():.6f}, mean alpha "
            f"{img.alpha.mean():.4f}, centre-crop alpha {crop.mean():.4f}")
        out = dict(seconds=wall, msamples_per_s=n_samples / wall / 1e6,
                   peak_bytes=peak, launches=launches)
        if keep:
            out["film"] = f
        del f, img
        torch.cuda.empty_cache()
        return out

    def films_equal(a, b):
        """Every accumulator of two films (the extras too) the same bits."""
        return all(torch.equal(x, y) for x, y in zip(film_mod.tensors(a),
                                                     film_mod.tensors(b)))

    def films_diff(a, b):
        return max((x - y).abs().max().item() for x, y in zip(
            film_mod.tensors(a), film_mod.tensors(b)))

    # -------------------------------------------------------- 4. main path
    queue_path = ("march", "costkey", "qseg", "smarch", "qsum")
    not_queue = ("qseg", "qsum", "enqueue", "omarch")
    record["main"] = main_path("4 main", main_s, MAIN_RES,
                               ("intersect", "costkey", "key", "seg",
                                "smarch", "tsum"),
                               absent=("ssum", "finish", *not_queue))

    # ------------------------------------------------------ 5. invariants
    res5 = INV_RES
    d5, s5, c5 = presets.default_scene(resolution=res5, device=dev)

    def render5(**kw):
        s = RenderSettings(resolution=res5, spp=4, **kw)
        return renderer.render_frame(d5, s5, s, c5, frame=1)

    a = render5()
    b = render5(sorted_shadow_march=False, sorted_intersect=False)
    gate(films_equal(a, b), "sorted and unsorted films differ")
    inv = {}
    for label, kw in (("fused", {}),
                      ("relaxed", dict(march_relaxation=RELAX))):
        p16 = render5(rays_per_pass=INV_PASSES[0], **kw)
        p15 = render5(rays_per_pass=INV_PASSES[1], **kw)
        inv[label] = films_diff(p16, p15)
        gate(inv[label] <= 2e-5,
             f"{label}: pass-size films differ by {inv[label]}")
    split5 = render5(mis=True, use_fused_bounce_tail=False)
    tail5 = render5(mis=True)
    inv["split vs tail, mis"] = films_diff(split5, tail5)
    gate(inv["split vs tail, mis"] <= 2e-5,
         f"mis: split-tail and bounce-tail films differ by "
         f"{inv['split vs tail, mis']}")
    same = films_equal(split5, tail5)
    del split5, tail5
    log(f"[5 invariants] sorted == unsorted bit for bit; 2^16 vs 2^15 "
        f"passes and split vs bounce tail with mis, max |d| {inv}; split "
        f"and bounce-tail films with mis bit for bit: {same}")
    record["invariants"] = dict(inv, split_tail_bit_for_bit=same)

    # ------------------------------------------------------ 6. image gate
    res6, spp6 = IMG_RES, IMG_SPP
    d6, s6, c6 = presets.default_scene(resolution=res6, device=dev)
    set6 = RenderSettings(resolution=res6, spp=spp6, max_marches=64,
                          max_vis_marches=64,
                          rays_per_pass=res6[0] * res6[1] * spp6)

    def render6(frame, **kw):
        fr = renderer.render_frame(d6, s6, dataclasses.replace(set6, **kw),
                                   c6, frame=frame)
        return film_mod.resolve(fr, res6).color

    def image_gate(label, img, ref, null, gate_mean=True):
        rmse = float(np.sqrt(np.mean((img - ref) ** 2)))
        mean_rel = float(abs(img.mean() - ref.mean())
                         / max(ref.mean(), 1e-9))
        log(f"[6 image] {label} at {res6[0]}x{res6[1]} @ {spp6} spp: RMSE "
            f"{rmse:.3e}, seed-swap null {null:.3e}, mean rel diff "
            f"{mean_rel:.3e}, mean ratio {img.mean() / ref.mean():.6f}")
        gate(rmse <= 1.5 * null and (mean_rel <= 1e-3 or not gate_mean),
             f"image gate failed: {label}")
        return dict(rmse=rmse, null_rmse=null, mean_rel=mean_rel)

    relaxed = dict(march_relaxation=RELAX)
    split_mis = dict(mis=True, use_fused_bounce_tail=False)
    unfused = dict(use_fused_intersect=False, use_fused_shadows=False)
    two_phase6 = dict(unfused, **sorted_kw)
    img_k = render6(1)
    img_rk = render6(1, **relaxed)
    img_sk = render6(1, **split_mis)
    img_tk = render6(1, **two_phase6)
    img_uk = render6(1, **unfused)
    with plain_twins():
        img_p = render6(1)
        img_null = render6(101)
        img_rp = render6(1, **relaxed)
        img_sp = render6(1, **split_mis)
        img_tp = render6(1, **two_phase6)
        img_up = render6(1, **unfused)
    # the segment queue's paths (phases 8, 9 and 12) run kernels that
    # equal their twins bit for bit, so their films must too
    queue_same = {label: bool(np.array_equal(x, y)) for label, x, y in (
        ("relaxed", img_rk, img_rp), ("unfused", img_uk, img_up),
        ("sorted two-phase", img_tk, img_tp))}
    log(f"[6 image] queue paths, kernel film equal to the plain-twin film "
        f"bit for bit: {queue_same}")
    gate(all(queue_same.values()), f"queue paths: films {queue_same}")
    mis_ratio = float(img_sk.mean() / img_k.mean())
    log(f"[6 image] mis=True against mis=False at {res6[0]}x{res6[1]} @ "
        f"{spp6} spp: mean ratio {mis_ratio:.6f} (not gated: MIS removes "
        "the double count of the paired emitters)")
    null = float(np.sqrt(np.mean((img_p - img_null) ** 2)))
    record["image"] = {
        "kernels_vs_plain": image_gate("kernels vs plain twins", img_k,
                                       img_p, null),
        "relaxed_kernels_vs_plain": image_gate(
            "relaxed path, kernels vs plain twins", img_rk, img_rp, null),
        "split_mis_kernels_vs_plain": image_gate(
            "split tail with mis, kernels vs plain twins", img_sk, img_sp,
            null),
        "mis_vs_no_mis_mean_ratio": mis_ratio,
        # Over-relaxed steps can pass through thin parts of the fractal
        # (the JAX march does the same; tests/test_torch_render.py holds
        # the port's relaxed image to JAX's), so the relaxed image is
        # darker than the plain one by more than 1e-3: only its RMSE is
        # gated against the fused image, and its mean ratio is printed.
        "relaxed_vs_fused": image_gate(
            "relaxed path vs fused path", img_rk, img_k, null,
            gate_mean=False),
        "unfused_vs_fused": image_gate(
            "relax-1 unfused path vs fused path", img_uk, img_k, null),
        "unfused_kernels_vs_plain": image_gate(
            "relax-1 unfused path, kernels vs plain twins", img_uk, img_up,
            null),
        "queue_paths_bit_for_bit": queue_same,
        "two_phase_kernels_vs_plain": image_gate(
            "sorted two-phase path, kernels vs plain twins", img_tk, img_tp,
            null),
        # the two-phase occlusion marches unclipped, the unfused path with
        # the bounding-sphere clip, so only the RMSE is gated
        "two_phase_vs_unfused": image_gate(
            "sorted two-phase path vs clipped unfused path", img_tk, img_uk,
            null, gate_mean=False)}

    # ------------------------------------------- 8. relaxed main path
    not_fused = ("intersect", "key", "seg", "ssum", "tsum", "finish",
                 "enqueue", "omarch")
    record["relaxed"] = main_path("8 relaxed", relax_s, MAIN_RES,
                                  queue_path, absent=not_fused)

    # --------------------------------------- 9. relax-1 unfused path
    unf = dataclasses.replace(unfused_s, resolution=UNFUSED_RES)
    record["unfused"] = main_path("9 unfused", unf, UNFUSED_RES,
                                  queue_path, absent=not_fused)

    # ------------------------------- 10. split tail with MIS, full width
    record["split"] = main_path("10 split mis", split_s, MAIN_RES,
                                ("intersect", "costkey", "key", "seg",
                                 "smarch", "ssum", "finish"),
                                absent=("tsum", *not_queue))

    # ------------------------------------------ 11. the smaller paths
    def no_lights_scene(resolution, device):
        """The default scene without its five sphere lights and their
        emissive bodies: sky, MandelBox, its material, volume, camera."""
        b = SceneBuilder()
        b.set_volume(0.25, 0.035)
        sky = b.add_sky(top=(0.3, 0.4, 0.6),
                        bottom=np.asarray((0.2, 0.3, 0.6), np.float32)
                        * 0.05)
        b.add_sphere((0.0, 0.0, 0.0), 100.0, sky)
        grey = b.add_dielectric(albedo=(0.2, 0.2, 0.2), roughness=0.6)
        b.set_sdf(sdf_ops.mandelbox(iterations=12, box_fold_l=1.0,
                                    sphere_min_rad=0.01,
                                    sphere_fixed_rad=1.9, scale=-2.1),
                  grey, bound_radius=3.6)
        origin = np.asarray((-0.45, 0.2, 2.0), np.float32) * 2.25
        camera = PinholeCamera.make(resolution, 60.0, origin,
                                    (0.0, 0.0, 0.0), (0.0, 1.0, 0.0),
                                    device=device)
        return (*b.build(device), camera)

    small = dataclasses.replace(mis_s, resolution=SMALL_RES)
    record["smaller"] = {
        "no_fused_finish_mis": main_path(
            "11 use_fused_finish=False, mis", dataclasses.replace(
                small, use_fused_finish=False), SMALL_RES,
            ("intersect", "costkey", "key", "seg", "smarch", "ssum"),
            absent=("finish", "tsum")),
        "no_lights": main_path(
            "11 no lights", dataclasses.replace(
                main_s, resolution=UNFUSED_RES), UNFUSED_RES,
            ("intersect", "costkey", "finish"), scene=no_lights_scene,
            absent=("seg", "smarch", "ssum", "tsum", "key")),
        "relaxed_mis": main_path(
            "11 relaxed, mis", dataclasses.replace(
                small, march_relaxation=RELAX), SMALL_RES,
            queue_path, absent=not_fused),
        "spheres_mis": main_path(
            "11 spheres, mis", small, SMALL_RES, ("intersect", "seg", "tsum"),
            scene=presets.spheres_scene, absent=("key", "costkey")),
        "spheres_split_mis": main_path(
            "11 spheres, split tail, mis", dataclasses.replace(
                small, use_fused_bounce_tail=False), SMALL_RES,
            ("intersect", "seg", "ssum", "finish"),
            scene=presets.spheres_scene,
            absent=("key", "costkey", "tsum")),
    }

    # ------------------------------------------ 12. the two-phase marches
    # march_sort_steps launches the march kernel (march_sorted); the
    # two-phase march kernels are gone, and no [M, 3] occlusion runs
    need12 = ("march", "smarch", "costkey", "qseg", "qsum")
    absent12 = ("enqueue", "omarch")
    record["sorted"] = main_path("12 sorted", sorted_s, MAIN_RES, need12,
                                 absent=absent12)
    record["phased"] = main_path(
        "12 phased", dataclasses.replace(
            unfused_s, resolution=UNFUSED_RES, march_sort_steps=8,
            occl_phase1_steps=16), UNFUSED_RES, need12, absent=absent12)
    unf5 = dict(use_fused_intersect=False, use_fused_shadows=False)
    same12 = {}
    for label, x_kw, y_kw in (
            ("march_sort_steps=8 vs unfused", dict(march_sort_steps=8), {}),
            ("occl_sort_steps=8 vs occl_phase1_steps=16",
             dict(occl_sort_steps=8), dict(occl_phase1_steps=16)),
            ("occl_sort_steps=8 vs unfused, shadow_bv_clip=False",
             dict(occl_sort_steps=8), dict(shadow_bv_clip=False))):
        x, y = render5(**unf5, **x_kw), render5(**unf5, **y_kw)
        same12[label] = films_equal(x, y)
        gate(same12[label], f"12 invariants: {label}: films differ")
    del x, y
    p16 = render5(rays_per_pass=INV_PASSES[0], **unf5, **sorted_kw)
    p15 = render5(rays_per_pass=INV_PASSES[1], **unf5, **sorted_kw)
    same12["2^16 vs 2^15 passes, max |d|"] = films_diff(p16, p15)
    gate(same12["2^16 vs 2^15 passes, max |d|"] <= 2e-5,
         f"12 invariants: sorted pass-size films differ: {same12}")
    del p16, p15
    log(f"[12 invariants] at {res5[0]}x{res5[1]}, 4 spp, bit for bit: "
        f"{same12}")
    record["invariants"]["two_phase"] = same12

    # ------------------------------------------ 13. motion and lenses
    def geo_scene(knots):
        def scene(resolution, device):
            return presets.default_scene(resolution=resolution,
                                         device=device, animated_geo=True,
                                         geo_knots=knots)
        return scene

    fused_need = ("intersect", "costkey", "key", "seg", "smarch", "tsum")
    fused_absent = ("ssum", "finish", *not_queue)
    motion = {f"animated_geo_{k}": main_path(
        f"13 animated-geo, {k} knots", main_s, MAIN_RES, fused_need,
        scene=geo_scene(k), absent=fused_absent, time_range=ANIM_TIME)
        for k in ANIM_KNOTS}

    # The inputs of one pass of the static scene and of the animated-geo
    # scene at each knot count, kernel against twin (phase 3's checks);
    # on the animated inputs at depth 1, the kernels that read positions
    # give other results at time 0; each one's depth-1 time, by phase 3's
    # method, on the static inputs and the animated ones of this call.
    scrub = torch.empty((64 << 20,), dtype=torch.uint8, device=dev)
    paths13 = (("fused mis", dataclasses.replace(mis_s, max_bounces=2),
                ("intersect", "costkey", "key", "tail", "seg", "smarch",
                 "tsum")),
               ("split mis", dataclasses.replace(split_s, max_bounces=1),
                ("shadow", "ssum", "finish")),
               ("relaxed mis", relax_mis_s, ("qtail", "qseg", "smarch",
                                              "qsum")))
    reads_positions = ("intersect", "costkey", "key", "tail", "seg", "tsum",
                       "shadow", "finish", "qseg")
    time_arg = {"intersect": 8, "costkey": 5, "key": 12}

    def at_time0(key, a):
        a = list(a)
        if key in time_arg:
            a[time_arg[key]] = a[time_arg[key]] * 0.0
        else:
            a[2] = a[2]._replace(time=a[2].time * 0.0)
        return a

    def tensors_of(x):
        if isinstance(x, torch.Tensor):
            return [x]
        if isinstance(x, dict):
            x = list(x.values())
        return [t for y in x for t in tensors_of(y)]

    scenes13 = [("static", lambda resolution, device: (data, static, cam))]
    scenes13 += [(f"{k} knots", geo_scene(k)) for k in ANIM_KNOTS]
    times13, bounds13 = {}, {}
    for label, scene in scenes13:
        d13, st13, c13 = scene(resolution=(W, H), device=dev)
        moving = label != "static"
        for path, s13, keys in paths13:
            cap = {k: [] for k in impl}
            with plain_twins(cap):
                renderer.render_pass(film_mod.new_film(W * H, device=dev),
                                     d13, st13, s13, tables, c13, fis, 0,
                                     MAIN_PASS, *ANIM_TIME)
            torch.cuda.synchronize()
            gate(all(len(cap[k]) == 2 for k in keys),
                 f"13 {label} {path}: captured "
                 f"{[len(cap[k]) for k in keys]} calls")
            for key in keys:
                for i, (a, kw) in enumerate(cap[key]):
                    depth = i + (1 if key in time_arg and key != "intersect"
                                 else 0)
                    got = impl[key](*a, **kw)
                    want = twin[key](*a, **kw)
                    torch.cuda.synchronize()
                    check(key, f"{label} {path}", depth, a, kw, got, want)
                    if moving and depth == 1 and key in reads_positions:
                        got0 = impl[key](*at_time0(key, a), **kw)
                        torch.cuda.synchronize()
                        gate(not all(same_bits(g, w) for g, w in zip(
                            tensors_of(got), tensors_of(got0))),
                            f"13 {label} {path} {key}: the same results at "
                            "time 0 (knot 0)")
                        del got0
                    del got, want
                if key not in reads_positions:
                    continue
                a, kw = cap[key][0 if key in ("key", "costkey") else 1]
                entries = (ANIM_ENTRIES if moving else
                           STATIC_ENTRIES).get(key)
                dev_ms = None
                if entries is not None:
                    dev_ms = device_ms(impl[key], a, kw, entries)
                    gate(dev_ms is not None, f"13 {label} {path} {key}: the "
                         f"profiler saw none of {entries}")
                ms = (dev_ms if key in DEVICE_TIMED else
                      timed(impl[key], a, kw, reps=5))
                times13[(label, key)] = ms
                if moving:
                    out = impl[key](*a, **kw)
                    ins, outs = io_tensors(key, a, kw, out)
                    bounds13[(label, key)] = bound(
                        de_evals(key, a, kw, out), ins, outs)[:2]
                    del out, ins, outs
                    ref = times13[("static", key)]
                    log(f"[13 motion] {key} ({path}), depth 1: {label} "
                        f"{ms:.4f} ms, static scene {ref:.4f} ms (ratio "
                        f"{ms / ref:.3f}); bound "
                        f"{bounds13[(label, key)][0]:.4f} ms "
                        f"({bounds13[(label, key)][1]})")
            del cap, a, kw
            torch.cuda.empty_cache()
    del scrub
    record["motion_kernels"] = {
        f"{label} {key}": dict(ms=ms, bound=bounds13.get((label, key)))
        for (label, key), ms in times13.items()}

    def camera_scene(kind):
        def scene(resolution, device):
            d_, st_, c_ = presets.default_scene(
                resolution=resolution, device=device,
                animated=kind == "animated camera")
            origin = tuple(float(x) * 2.25 for x in (-0.45, 0.2, 2.0))
            at, up = (0.6, 0.4, 0.0), (0.0, 1.0, 0.0)
            if kind == "thin lens":
                c_ = ThinLensCamera.make(resolution, 60.0, 0.35, origin, at,
                                         up, at, device=device)
            elif kind == "orthographic":
                c_ = OrthographicCamera.make(resolution, 6.0, origin, at, up,
                                             device=device)
            return d_, st_, c_
        return scene

    for kind, res in (("animated camera", MAIN_RES),
                      ("thin lens", MAIN_RES),
                      ("orthographic", UNFUSED_RES)):
        motion[kind.replace(" ", "_")] = main_path(
            f"13 {kind}", dataclasses.replace(main_s, resolution=res), res,
            fused_need, scene=camera_scene(kind), absent=fused_absent,
            time_range=ANIM_TIME)
    record["motion"] = motion

    # ------------------- 14. the command line, checkpoints, reduced DE
    from rayn_tpu_torch import cli

    mitchell = filters.mitchell_netravali(2.0)
    main_pixels = W * H

    def launched(fn):
        """fn() with every launch count set to 0 just before it; returns
        (its result, the counts just after, its wall in s)."""
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return out, {k: fn_.launches for k, fn_ in kernels.items()}, wall

    def gate_fused(label, launches):
        gate(all(launches[k] > 0 for k in fused_need)
             and not any(launches[k] for k in fused_absent),
             f"{label}: launches {launches}, needed {fused_need}, absent "
             f"{fused_absent}")

    rec14 = {}
    with tempfile.TemporaryDirectory() as tmp:
        # (a) python -m rayn_tpu_torch, in process, the default channels
        argv = ["--device", DEVICE, "--width", str(W), "--height", str(H),
                "--spp", str(MAIN_SPP), "--rays-per-pass", str(MAIN_PASS),
                "--frames", "1", "2", "--filter", "mitchell_netravali",
                "--filter-radius", "2", "--out", f"{tmp}/cli"]
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            rc, launches, cli_wall = launched(lambda: cli.main(argv))
        line = re.search(r"Frame 1: done in ([0-9.]+)s \(([0-9.]+) "
                         r"Msamples/s\)", err.getvalue())
        gate(rc == 0 and line is not None, f"14 cli: rc {rc}, stderr "
             f"{err.getvalue()[-400:]!r}")
        gate_fused("14 cli", launches)
        names = sorted(os.listdir(f"{tmp}/cli"))
        want_names = sorted(f"frame0001_{MAIN_SPP}spp_{k}.png"
                            for k in ("alpha", "normal", "color"))
        gate(names == want_names, f"14 cli wrote {names}, not {want_names}")
        ref, _l, ref_wall = launched(lambda: renderer.render_frame(
            data, static, main_s, cam, frame=1, filter=mitchell))
        ref_png = film_mod.save_channels(film_mod.resolve(ref, (W, H)),
                                         f"{tmp}/ref", "ref", ("color",))[0]
        same_png = np.array_equal(
            film_mod.read_png(f"{tmp}/cli/frame0001_{MAIN_SPP}spp_color.png"),
            film_mod.read_png(ref_png))
        gate(same_png, "14 cli: the colour PNG differs from save_channels "
             "of render_frame's film")
        log(f"[14 cli] rc 0, wrote {names}; the CLI printed "
            f"'{line.group(0)}'; cli.main took {cli_wall} s (scene, render, "
            f"PNGs); its colour PNG equals save_channels of render_frame's "
            f"film (Mitchell-Netravali, radius 2), whose frame took "
            f"{ref_wall} s ({main_pixels * MAIN_SPP / ref_wall / 1e6} "
            f"Msamples/s); launches {launches}")
        rec14["cli"] = dict(frame_s_printed=float(line.group(1)),
                            msamples_per_s_printed=float(line.group(2)),
                            main_s=cli_wall, launches=launches,
                            render_frame_s=ref_wall)

        # (b) checkpoints: with and without saving, a failure at pass 5
        # resumed from the last save, and 2 spp grown to 4
        n_passes = -(-main_pixels * MAIN_SPP // MAIN_PASS)
        gate(n_passes >= 6, f"14: {n_passes} passes, the failure needs 6")
        plain, _l, plain_wall = launched(lambda: renderer.render_frame(
            data, static, main_s, cam, frame=1, filter=mitchell))
        saved, launches, ck_wall = launched(lambda: renderer.render_frame(
            data, static, main_s, cam, frame=1, filter=mitchell,
            checkpoint_path=f"{tmp}/a.npz", checkpoint_every=2))
        gate_fused("14 checkpointed", launches)
        gate(films_equal(plain, ref) and films_equal(saved, ref),
             "14: the checkpointed film differs from the plain one")
        failed = []

        def fail_once(p):
            if p == 5 and not failed:
                failed.append(p)
                raise RuntimeError("injected failure after pass 5")

        renderer._FAIL_HOOK = fail_once
        try:
            with contextlib.redirect_stderr(io.StringIO()):
                resumed, _l, resume_wall = launched(
                    lambda: renderer.render_frame_resilient(
                        data, static, main_s, cam, retries=1, frame=1,
                        filter=mitchell, checkpoint_path=f"{tmp}/b.npz",
                        checkpoint_every=2))
        finally:
            renderer._FAIL_HOOK = None
        gate(failed == [5] and films_equal(resumed, ref),
             f"14: the resumed film differs from the uninterrupted one "
             f"(failures {failed})")
        renderer.render_frame(data, static,
                              dataclasses.replace(main_s, spp=2), cam,
                              frame=1, filter=mitchell,
                              checkpoint_path=f"{tmp}/c.npz",
                              checkpoint_every=2)
        grown, _l, grow_wall = launched(lambda: renderer.render_frame(
            data, static, main_s, cam, frame=1, filter=mitchell,
            checkpoint_path=f"{tmp}/c.npz", checkpoint_every=2))
        grow_diff = films_diff(grown, ref)
        gate(torch.equal(grown.samples, ref.samples) and grow_diff <= 2e-5,
             f"14: the film grown from 2 spp differs by {grow_diff}")
        ck_bytes = os.path.getsize(f"{tmp}/a.npz")
        log(f"[14 checkpoint] {W}x{H} @ {MAIN_SPP} spp, {n_passes} passes: "
            f"frame {plain_wall} s without a checkpoint, {ck_wall} s saving "
            f"every 2 passes ({ck_bytes} B a checkpoint), both films bit "
            f"for bit; failed after pass 5 and resumed: {resume_wall} s, "
            f"the film bit for bit; grown from 2 to 4 spp: {grow_wall} s, "
            f"max |d| {grow_diff} against the flat film")
        rec14["checkpoint"] = dict(
            passes=n_passes, plain_s=plain_wall, checkpointed_s=ck_wall,
            checkpoint_bytes=ck_bytes, resumed_s=resume_wall,
            grown_s=grow_wall, grown_max_abs_diff=grow_diff)
        del plain, saved, resumed, grown

    # (c) the reduced shadow DE: the kernels that take it against their
    # twins on one pass's captured inputs, each one's depth-1 time beside
    # its time at full iterations on the same inputs, and a frame
    de8 = dict(shadow_de_iterations=8)
    full_mb = data.sdf_params
    scrub = torch.empty((64 << 20,), dtype=torch.uint8, device=dev)
    paths14 = (("fused", dataclasses.replace(main_s, max_bounces=2, **de8),
                ("key", "tail", "seg", "smarch", "tsum")),
               ("split mis", dataclasses.replace(split_s, max_bounces=1,
                                                 **de8),
                ("shadow", "seg", "smarch", "ssum")),
               ("relaxed", dataclasses.replace(relax_s, max_bounces=1, **de8),
                ("qtail", "qseg", "smarch", "qsum")))
    timed14 = {"fused": ("key", "tail", "seg"), "split mis": ("shadow",),
               "relaxed": ("qseg", "occl")}
    ms14, des14 = {}, {}

    def time14(key, a, kw):
        if key in DEVICE_TIMED:
            return device_ms(impl[key], a, kw, ENTRIES[key])
        return timed(impl[key], a, kw, reps=5)

    for path, s14, keys in paths14:
        cap = {k: [] for k in impl}
        with plain_twins(cap):
            renderer.render_pass(film_mod.new_film(W * H, device=dev), data,
                                 static, s14, tables, cam, fis, 0, MAIN_PASS,
                                 1.0 / 24, 2.0 / 24)
        torch.cuda.synchronize()
        gate(all(len(cap[k]) == 2 for k in keys),
             f"14 shadow-de {path}: captured {[len(cap[k]) for k in keys]}")
        gate(cap["smarch"][0][0][0].sdfs[0][0].iterations == 8,
             f"14 shadow-de {path}: the shadow march's MandelBox has "
             f"{cap['smarch'][0][0][0].sdfs[0][0].iterations} iterations")
        for key in keys:
            for i, (a, kw) in enumerate(cap[key]):
                depth = i + (1 if key == "key" else 0)
                got = impl[key](*a, **kw)
                want = twin[key](*a, **kw)
                torch.cuda.synchronize()
                check(key, f"shadow-de-8 {path}", depth, a, kw, got, want)
                del got, want
        cfg, segs = cap["smarch"][1][0][:2]
        start, end, act = aos(segs)
        calls = {key: cap[key][0 if key == "key" else 1]
                 for key in timed14[path] if key != "occl"}
        if path == "relaxed":   # row 7 on the queue's depth-1 segments
            (mb, bv_r), = cfg.sdfs
            a = (mb, start, end, cfg.detail, cfg.max_steps, act, RELAX, bv_r)
            got, want = functions["occl"](*a), twin["occl"](*a)
            gate(same_bits(got, want), "14 shadow-de occl: differs from its "
                 "one-piece twin")
            del got, want
            calls["occl"] = (a, {})
        for key, (a, kw) in calls.items():
            a_full = ((full_mb,) + a[1:] if key == "occl" else
                      (a[0]._replace(sdfs=((full_mb, a[0].sdfs[0][1]),)),)
                      + a[1:])
            ms14[key] = (time14(key, a, kw), time14(key, a_full, kw))
            # the DEs each needs (the twin's lanes at each step) and the
            # bound at 8 iterations: a DE of 8 costs de_flops(8)
            out = impl[key](*a, **kw)
            ins, outs = io_tensors(key, a, kw, out)
            n8, n_full = (count_des(twin[key], x, kw) for x in (a, a_full))
            bytes_ms = bound(0, ins, outs)[0]
            ops8 = n8 * de_flops(8) / PEAK_F32_FLOPS * 1e3
            des14[key] = (n8, n_full, max(ops8, bytes_ms),
                          "operations" if ops8 >= bytes_ms else "bytes")
            log(f"[14 shadow-de] {key} ({path}, depth 1): "
                f"{ms14[key][0]} ms at 8 iterations, {ms14[key][1]} ms at "
                f"{full_mb.iterations} on the same inputs; {n8} DEs at 8, "
                f"{n_full} at {full_mb.iterations}; bound at 8 "
                f"{des14[key][2]} ms ({des14[key][3]})")
            del out, ins, outs
        del cap, a, a_full, kw, calls, segs, start, end, act
        torch.cuda.empty_cache()
    del scrub
    de8_frame = main_path("14 shadow-de 8",
                          dataclasses.replace(main_s, **de8), MAIN_RES,
                          fused_need, absent=fused_absent, filter=mitchell,
                          keep=True)
    de8_diff = films_diff(de8_frame.pop("film"), ref)
    gate(de8_diff > 0.0, "14: the 8-iteration film equals the full DE's")
    log(f"[14 shadow-de] the 8-iteration frame differs from the full DE's "
        f"by max |d| {de8_diff}")
    rec14["shadow_de_8"] = dict(kernel_ms=ms14, de_evals_bound=des14,
                                frame=de8_frame,
                                max_abs_diff_vs_full=de8_diff)

    # max_vis_marches 0 at 256x256: kernel against twin on the fused path
    # and the relaxed queue (whose verdicts are the first-DE entry's)
    n0 = INV_RES[0] * INV_RES[1] * 4
    for path, s0, keys in (
            ("fused", RenderSettings(resolution=INV_RES, spp=4,
                                     max_bounces=2, max_vis_marches=0),
             ("key", "tail", "seg", "smarch", "tsum")),
            ("relaxed", RenderSettings(resolution=INV_RES, spp=4,
                                       max_bounces=1, max_vis_marches=0,
                                       march_relaxation=RELAX),
             ("qtail", "qseg", "qsum"))):
        cap = {k: [] for k in impl}
        with plain_twins(cap):
            renderer.render_pass(film_mod.new_film(n0 // 4, device=dev), d5,
                                 s5, s0, tables, c5, fis, 0, n0, 1.0 / 24,
                                 2.0 / 24)
        gate(all(len(cap[k]) == 2 for k in keys),
             f"14 vis-0 {path}: captured {[len(cap[k]) for k in keys]}")
        reset_launches()
        for key in keys:
            for i, (a, kw) in enumerate(cap[key]):
                got = impl[key](*a, **kw)
                want = twin[key](*a, **kw)
                torch.cuda.synchronize()
                check(key, f"vis-0 {path}", i + (key == "key"), a, kw, got,
                      want)
        if path == "relaxed":
            gate(kernels["omarch"].launches > 0
                 and not kernels["smarch"].launches,
                 "14 vis-0 relaxed: the queue's verdicts did not come from "
                 "the first-DE occlusion march")
        del cap
    log("[14 vis-0] max_vis_marches 0 at "
        f"{INV_RES[0]}x{INV_RES[1]}: the fused path's and the relaxed "
        "queue's kernels equal their twins")

    # (d) passes that are not a multiple of spp: 3 spp in 2^20-ray passes
    s3 = dataclasses.replace(main_s, spp=3)
    odd = []
    for rays in (MAIN_PASS, MAIN_PASS, 3 * (MAIN_PASS // 4)):
        f, launches, wall = launched(lambda: renderer.render_frame(
            data, static, dataclasses.replace(s3, rays_per_pass=rays), cam,
            frame=1))
        gate_fused(f"14 spp 3, {rays}-ray passes", launches)
        gate(int(f.samples.sum().item()) == main_pixels * 3,
             "14 spp 3: film sample count")
        odd.append((f, wall))
    odd_diff = films_diff(odd[0][0], odd[2][0])
    gate(films_equal(odd[0][0], odd[1][0]) and odd_diff <= 2e-5,
         f"14 spp 3: the two runs differ, or the 3*2^18-ray film by "
         f"{odd_diff}")
    log(f"[14 spp 3] {W}x{H} @ 3 spp in {MAIN_PASS}-ray passes: two runs "
        f"bit for bit ({odd[0][1]} s, {odd[1][1]} s); against "
        f"{3 * (MAIN_PASS // 4)}-ray passes ({odd[2][1]} s) max |d| "
        f"{odd_diff}")
    rec14["unaligned"] = dict(walls_s=[w for _f, w in odd],
                              max_abs_diff=odd_diff)
    record["phase14"] = rec14
    del odd, ref, de8_frame
    torch.cuda.empty_cache()

    # ------------------------------------------------ 15. SDF programs
    # The program scene at full width (program_scene: the default scene
    # with a second, program instance): one pass's inputs on the fused,
    # split-MIS and relaxed paths, each kernel that reads the SDF (its
    # Tape instantiation) and each function on them against its twin bit
    # for bit, and the depth-1 time, DEs and ps a DE of each; the
    # every-opcode scene at 256x256 against the twins; the default scene's
    # kernels with its MandelBox run as a one-op tape against MBoxOnly on
    # the same inputs; frames on the fused and relaxed paths, the phase-5
    # and phase-12 invariants on the program scene; one profiled pass of
    # the program scene and one of the default scene (launches a pass).
    rec15 = {}
    scrub = torch.empty((64 << 20,), dtype=torch.uint8, device=dev)
    pd, pst, pcam = program_scene((W, H), dev)
    insts15 = pst.sdf_instances(pd)
    gate(len(insts15) == 2 and type(insts15[1][0]).__name__ == "Translate",
         f"15: the program scene's instances {insts15}")
    tape_ptx = {e: p for e in sorted({e for es in ENTRIES.values()
                                      for e in es if "_tape_" in e})
                for name, p in ptx.items() if f"{len(e)}{e}E" in name}
    log(f"[15 programs] registers and spills of the Tape kernels: "
        f"{tape_ptx}")
    rec15["tape_ptxas"] = tape_ptx

    def de_cost(fn, a, kw):
        """(DEs, float32 operations) of fn(*a, **kw), a plain twin or a
        function of them: the lanes of each DE it takes, each weighted by
        its program's operations (sdf_flops)."""
        tally = [0, 0]
        mods = ((march_ops, "dist_c", 1), (intersect_cuda, "dist_c", 1),
                (intersect_cuda, "dist", 3))
        saved = [getattr(m, f) for m, f, _ in mods]

        def counting(orig, per):
            def call(prog, x, *rest):
                lanes = x.numel() // per
                tally[0] += lanes
                tally[1] += lanes * sdf_flops(prog)
                return orig(prog, x, *rest)
            return call

        for (m, f, per), orig in zip(mods, saved):
            setattr(m, f, counting(orig, per))
        try:
            fn(*a, **kw)
        finally:
            for (m, f, _), orig in zip(mods, saved):
                setattr(m, f, orig)
        return tuple(tally)

    def hit_cost(a):
        """(DEs, operations) the closest hit takes on its arguments `a`:
        each instance's march (march's n_de, bounded by the closest t so
        far) and the four taps of the instance hit."""
        d_, st_, s_, o, d, h_abs, h_lin, act = a[:8]
        best_t, best_obj = intersect_cuda.sphere_fold(
            d_, st_, s_, o, d, a[8] if len(a) > 8 else None)
        detail = s_.sdf_detail_scale
        progs = [p for p, _m, _b in st_.sdf_instances(d_)]
        n = ops = 0
        for i, prog in enumerate(progs):
            n_de = torch.zeros(act.shape, dtype=torch.int32, device=dev)
            t = march_ops.march(prog, o, d, best_t, 5e-5 * detail,
                                0.05 * detail * h_abs, 0.05 * detail * h_lin,
                                s_.max_marches, act, n_de=n_de)
            closer = t < best_t
            best_t = torch.where(closer, t, best_t)
            best_obj = torch.where(closer, st_.n_spheres + i, best_obj)
            c = int(n_de.sum())
            n, ops = n + c, ops + c * sdf_flops(prog)
        for i, prog in enumerate(progs):
            c = 4 * int((best_obj == st_.n_spheres + i).sum())
            n, ops = n + c, ops + c * sdf_flops(prog)
        return n, ops

    def cost15(key, a, kw):
        if key == "intersect":
            return hit_cost(a)
        if key == "costkey":
            alive = int(a[6].sum())
            progs = [p for p, _m, _b in a[1].sdf_instances(a[0])]
            return (alive * len(progs),
                    alive * sum(sdf_flops(p) for p in progs))
        return de_cost(twin.get(key) or plain15[key], a, kw)

    def time15(key, a, kw, phase="15 programs"):
        """A call's time: a short kernel's profiler device time (when the
        profiler sees none of its launches, CUDA events, logged), the
        others' CUDA events."""
        fn = impl.get(key) or funcs15[key]
        if key in DEVICE_TIMED:
            ms = device_ms(fn, a, kw, ENTRIES[key])
            if ms is not None:
                return ms
            log(f"[{phase}] {key}: the profiler saw none of "
                f"{ENTRIES[key]}; timed with CUDA events")
        return timed(fn, a, kw, reps=5)

    def row15(label, key, a, kw, got, phase="15 programs"):
        """Depth-1 time, DEs, ps a DE and bound of one call."""
        ms = time15(key, a, kw)
        n_de, ops = cost15(key, a, kw)
        io_key = {"march_sorted": "march", "march_phased": "march"}.get(
            key, key if key in impl else "occl")
        ins, outs = io_tensors(io_key, a, kw, got)
        n_bytes = sum(t.numel() * t.element_size() for t in ins + outs)
        ops_ms = ops / PEAK_F32_FLOPS * 1e3
        bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
        r = dict(ms=ms, de_evals=n_de, ps_per_de=ms * 1e9 / max(n_de, 1),
                 bound_ms=max(ops_ms, bytes_ms),
                 bound_by="operations" if ops_ms >= bytes_ms else "bytes")
        log(f"[{phase}] {label} {key}, depth 1: {ms} ms, {n_de} DEs, "
            f"{r['ps_per_de']} ps a DE; bound {r['bound_ms']} ms "
            f"({r['bound_by']})")
        return r

    # the two-phase functions and the occlusion functions on one program
    funcs15 = {"occl": march_cuda.march_occlusion,
               "chained": march_cuda.march_occlusion_chained,
               "march_sorted": march_cuda.march_sorted,
               "march_phased": march_cuda.march_phased,
               "march_occlusion_phased": march_cuda.march_occlusion_phased,
               "march_occlusion_sorted": march_cuda.march_occlusion_sorted}
    plain15 = {k: getattr(march_cuda, f.__name__ + "_plain")
               for k, f in funcs15.items()}
    paths15 = (("fused", dataclasses.replace(main_s, max_bounces=2),
                ("intersect", "costkey", "key", "tail", "seg", "smarch",
                 "tsum")),
               ("split mis", dataclasses.replace(split_s, max_bounces=1),
                ("shadow", "seg", "smarch", "ssum", "finish")),
               ("relaxed", dataclasses.replace(relax_s, max_bounces=1),
                ("march", "qtail", "qseg", "smarch", "qsum")))
    timed15 = {"fused": ("intersect", "costkey", "key", "tail", "smarch"),
               "split mis": ("shadow",), "relaxed": ("march", "smarch")}

    def capture15(d_, st_, c_, s_, keys, label, n_rays):
        """Each kernel's calls on one pass of (d_, st_, c_) at s_ (four:
        the march kernel runs once an instance), checked against its
        twin; returns the captured calls."""
        cap = {k: [] for k in impl}
        with plain_twins(cap, limit=4):
            renderer.render_pass(film_mod.new_film(n_rays, device=dev), d_,
                                 st_, s_, tables, c_, fis, 0, n_rays,
                                 1.0 / 24, 2.0 / 24)
        torch.cuda.synchronize()
        gate(all(len(cap[k]) >= 2 for k in keys),
             f"15 {label}: captured {[len(cap[k]) for k in keys]}")
        for key in keys:
            for i, (a, kw) in enumerate(cap[key]):
                got = impl[key](*a, **kw)
                want = twin[key](*a, **kw)
                torch.cuda.synchronize()
                check(key, f"15 {label}", i if key != "march" else i // 2,
                      a, kw, got, want)
                del got, want
        return cap

    def one_program(cfg, segs, march_call):
        """The row-6-12 functions on instance 1's program: march_occlusion
        (relax 1.5, clipped), the chained march (clipped) and the two-phase
        occlusions (unclipped, their JAX splits) on a queue's segments,
        the two-phase marches (their JAX splits) on a march kernel call's
        rays; each against its one-piece plain version bit for bit.
        Returns {key: (args, kwargs)}."""
        prog, bv = cfg.sdfs[1]
        S, n = segs.active.shape
        start, end, act = aos(segs)
        (_p, *mrest), mkw = march_call
        mkw = {k: v for k, v in mkw.items() if k != "relax"}
        calls = {
            "occl": ((prog, start, end, cfg.detail, cfg.max_steps, act,
                      RELAX, bv), {}),
            "chained": ((prog, start.reshape(S, n, 3), end.reshape(S, n, 3),
                         cfg.detail, cfg.max_steps, act.reshape(S, n), bv),
                        {}),
            "march_occlusion_phased": ((prog, start, end, cfg.detail,
                                        cfg.max_steps, act), dict(
                                            phase1_steps=16)),
            "march_occlusion_sorted": ((prog, start, end, cfg.detail,
                                        cfg.max_steps, act), dict(
                                            phase1_steps=8)),
            "march_sorted": ((prog, *mrest), dict(mkw, phase1_steps=8)),
            "march_phased": ((prog, *mrest), dict(mkw, phase1_steps=32))}
        for key, (a, kw) in calls.items():
            got = funcs15[key](*a, **kw)
            want = plain15[key](*a, **kw)
            torch.cuda.synchronize()
            gate(same_bits(got, want), f"15 {key}: differs from its "
                 "one-piece plain version on instance 1's program")
        log(f"[15 programs] {sorted(calls)} on instance 1's program equal "
            "their one-piece plain versions bit for bit")
        return calls

    times15 = {}
    for path, s15, keys in paths15:
        cap = capture15(pd, pst, pcam, s15, keys, f"program {path}",
                        MAIN_PASS)
        gate(len(cap["smarch"][0][0][0].sdfs) == 2,
             f"15 {path}: the shadow march has "
             f"{len(cap['smarch'][0][0][0].sdfs)} instances")
        for key in timed15[path]:
            # depth 1: the sort key's and cost key's first call, the
            # march's fourth (instance 1 at depth 1), the others' second
            a, kw = cap[key][{"key": 0, "costkey": 0, "march": 3}.get(key, 1)]
            got = impl[key](*a, **kw)
            times15[f"{path} {key}"] = row15(path, key, a, kw, got)
            del got
        if path == "relaxed":
            (cfg, segs, _relax), _kw = cap["smarch"][1]
            calls = one_program(cfg, segs, cap["march"][3])
            for key, (a, kw) in calls.items():
                got = funcs15[key](*a, **kw)
                times15[f"{path} {key}"] = row15(path, key, a, kw, got)
                del got
        del cap
        torch.cuda.empty_cache()
    rec15["program_kernels"] = times15

    # the every-opcode scene: kernels and functions against their twins
    eo = every_op_scene(INV_RES, dev)
    n_eo = INV_RES[0] * INV_RES[1] * 4
    for path, s15, keys in paths15:
        cap = capture15(*eo, dataclasses.replace(s15, resolution=INV_RES),
                        keys, f"every-op {path}", n_eo)
        if path == "relaxed":
            (cfg, segs, _relax), _kw = cap["smarch"][1]
            one_program(cfg, segs, cap["march"][3])
        del cap
    del eo
    log(f"[15 programs] the every-opcode scene at {INV_RES[0]}x"
        f"{INV_RES[1]}: every kernel equal to its twin")

    # the default scene through the Tape kernels (a one-op tape) against
    # MBoxOnly on the same inputs
    price = {}
    for path, s15, keys in (
            ("fused", dataclasses.replace(main_s, max_bounces=2),
             ("intersect", "costkey", "key", "tail", "smarch")),
            ("relaxed", dataclasses.replace(relax_s, max_bounces=1),
             ("march", "smarch"))):
        cap = {k: [] for k in impl}
        with plain_twins(cap):
            renderer.render_pass(film_mod.new_film(W * H, device=dev), data,
                                 static, s15, tables, cam, fis, 0, MAIN_PASS,
                                 1.0 / 24, 2.0 / 24)
        for key in keys:
            a, kw = cap[key][0 if key in ("key", "costkey") else 1]
            mbox = impl[key](*a, **kw)
            mbox_ms = time15(key, a, kw)
            with _build.tape_forced():
                tape = impl[key](*a, **kw)
                tape_ms = time15(key, a, kw)
            torch.cuda.synchronize()
            gate(all(same_bits(x, y) for x, y in zip(
                tensors_of(tape), tensors_of(mbox))),
                f"15 tape price {path} {key}: the one-op tape differs from "
                "MBoxOnly")
            price[f"{path} {key}"] = dict(mbox_only_ms=mbox_ms,
                                          tape_ms=tape_ms,
                                          ratio=tape_ms / mbox_ms)
            log(f"[15 tape price] {key} ({path}, depth 1, default scene): "
                f"MBoxOnly {mbox_ms} ms, one-op tape {tape_ms} ms (ratio "
                f"{tape_ms / mbox_ms}), bit for bit")
            del mbox, tape
        del cap
        torch.cuda.empty_cache()
    rec15["tape_price"] = price
    del scrub

    # frames and invariants
    rec15["fused"] = main_path("15 program fused", main_s, MAIN_RES,
                               fused_need, scene=program_scene,
                               absent=fused_absent)
    rec15["relaxed"] = main_path("15 program relaxed", relax_s, MAIN_RES,
                                 queue_path, scene=program_scene,
                                 absent=not_fused)
    d15, st15, c15 = program_scene(INV_RES, dev)

    def render15(**kw):
        return renderer.render_frame(
            d15, st15, RenderSettings(resolution=INV_RES, spp=4, **kw), c15,
            frame=1)

    inv15 = {"sorted == unsorted": films_equal(
        render15(), render15(sorted_shadow_march=False,
                             sorted_intersect=False))}
    gate(inv15["sorted == unsorted"], "15: sorted and unsorted films differ")
    for label, kw in (("fused", {}), ("relaxed", dict(march_relaxation=RELAX)),
                      ("sorted two-phase", dict(unf5, **sorted_kw))):
        p16 = render15(rays_per_pass=INV_PASSES[0], **kw)
        p15 = render15(rays_per_pass=INV_PASSES[1], **kw)
        inv15[label] = films_diff(p16, p15)
        gate(inv15[label] <= 2e-5,
             f"15 {label}: pass-size films differ by {inv15[label]}")
    log(f"[15 invariants] the program scene at {INV_RES[0]}x{INV_RES[1]}, "
        f"4 spp: {inv15}")
    rec15["invariants"] = inv15
    del d15, st15, c15, p16, p15

    # launches a pass (the profiler's cudaLaunchKernel count)
    film15 = film_mod.new_film(W * H, device=dev)
    rec15["profile"] = {
        label: profile_pass(lambda d_=d_, st_=st_, c_=c_: renderer.render_pass(
            film15, d_, st_, main_s, tables, c_, fis, 0, MAIN_PASS, 1.0 / 24,
            2.0 / 24), f"15 {label}")
        for label, (d_, st_, c_) in (("program fused", (pd, pst, pcam)),
                                     ("default fused", (data, static, cam)))}
    log(f"[15 programs] launches a pass: program scene "
        f"{rec15['profile']['program fused']['launches']}, default scene "
        f"{rec15['profile']['default fused']['launches']}")
    record["phase15"] = rec15
    del film15, pd, pst, pcam
    torch.cuda.empty_cache()

    # --------------------------------------------- 16. per-lane extras
    # The default scene with an albedo function on its MandelBox's
    # material, the four extra AOVs and compaction: frames on the fused,
    # relaxed and split paths with their launch gates, the compaction
    # invariant at 256x256, the kernels against their twins on one pass's
    # per-lane-albedo, compacted inputs, the command line's AOV PNGs, and
    # what the extras cost: frame walls, profiled passes in turns, the
    # compaction's own kernels, peak memory.
    rec16 = {}
    aovs16 = ("depth", "position", "albedo", "mat_id")

    def albedo16(p, n):
        """A smooth albedo (tests/test_param_materials.py's), lane by
        lane."""
        return torch.stack([0.5 + 0.4 * torch.sin(3.0 * p[:, 0]),
                            0.5 + 0.4 * torch.sin(3.0 * p[:, 1] + 1.0),
                            0.4 + 0.3 * n[:, 2]], dim=-1)

    def extras_scene(resolution, device):
        d_, st_, c_ = presets.default_scene(resolution=resolution,
                                            device=device)
        return d_, dataclasses.replace(
            st_, mat_param_fns=((st_.sdf_mat, albedo16),)), c_

    ext16 = dict(extra_aovs=aovs16, compact_bounces=True)
    main16 = dataclasses.replace(main_s, **ext16)
    relax16 = dataclasses.replace(relax_s, **ext16)
    split_need = ("intersect", "costkey", "key", "seg", "smarch", "ssum",
                  "finish")

    # frames: without the extras and with them, in turns (the order
    # reversed in the second round)
    specs16 = {"fused": (main_s, None, fused_need, fused_absent),
               "fused, extras": (main16, extras_scene, fused_need,
                                 fused_absent),
               "relaxed": (relax_s, None, queue_path, not_fused),
               "relaxed, extras": (relax16, extras_scene, queue_path,
                                   not_fused)}
    frames16 = {label: [] for label in specs16}
    for r in range(2):
        for label in (list(specs16) if r == 0 else list(specs16)[::-1]):
            s16, scene16, need, absent = specs16[label]
            frames16[label].append(main_path(
                f"16 {label}", s16, MAIN_RES, need, scene=scene16,
                absent=absent))
    frames16["fused, extras but no AOVs"] = [main_path(
        "16 fused, extras but no AOVs", dataclasses.replace(
            main16, extra_aovs=()), MAIN_RES, fused_need,
        scene=extras_scene, absent=fused_absent)]
    frames16["split mis, extras"] = [main_path(
        "16 split mis, extras", dataclasses.replace(
            split_s, resolution=SMALL_RES, **ext16), SMALL_RES, split_need,
        scene=extras_scene, absent=("tsum", *not_queue))]
    rec16["frames"] = frames16
    peak_aov = (frames16["fused, extras"][0]["peak_bytes"]
                - frames16["fused, extras but no AOVs"][0]["peak_bytes"])
    log(f"[16 extras] 1080p 4-spp frames, Msamples/s: " + ", ".join(
        f"{k} {[round(r['msamples_per_s'], 4) for r in v]}"
        for k, v in frames16.items()) + f"; peak device memory of the "
        f"fused frame with the four AOV accumulators minus without: "
        f"{peak_aov} B")
    rec16["peak_bytes_aovs_minus_none"] = peak_aov

    # the compaction invariant at 256x256: compacted = uncompacted, the
    # AOV accumulators included, on three paths; two compacted runs
    d16, st16, c16 = extras_scene(INV_RES, dev)

    def render16(**kw):
        return renderer.render_frame(d16, st16, RenderSettings(
            resolution=INV_RES, spp=4, extra_aovs=aovs16, **kw), c16,
            frame=1)

    inv16 = {}
    for label, kw in (("fused", {}), ("relaxed", dict(march_relaxation=RELAX)),
                      ("sorted two-phase", dict(unf5, **sorted_kw))):
        packed = render16(compact_bounces=True, **kw)
        inv16[label] = films_equal(packed, render16(**kw))
        gate(inv16[label] and len(packed.extra) == 4,
             f"16 {label}: the compacted film differs from the uncompacted")
    inv16["two compacted runs"] = films_equal(
        render16(compact_bounces=True), render16(compact_bounces=True))
    gate(inv16["two compacted runs"], "16: two compacted films differ")
    log(f"[16 invariants] {INV_RES[0]}x{INV_RES[1]}, 4 spp, the four AOVs "
        f"and the albedo function, compacted film = uncompacted film bit "
        f"for bit: {inv16}")
    rec16["invariants"] = inv16
    del d16, st16, c16, packed

    # kernels against their twins on the inputs of one 2^20-ray pass with
    # the albedo function, compacted from depth 1 on
    scrub = torch.empty((64 << 20,), dtype=torch.uint8, device=dev)
    dx, stx, cx = extras_scene(MAIN_RES, dev)
    paths16 = (("fused", dataclasses.replace(main16, max_bounces=2),
                ("intersect", "costkey", "key", "tail", "seg", "smarch",
                 "tsum")),
               ("relaxed", dataclasses.replace(relax16, max_bounces=1),
                ("march", "qtail", "qseg", "smarch", "qsum")))
    times16, errs16, state16 = {}, {}, None
    for path, s16, keys in paths16:
        cap = {k: [] for k in impl}
        with plain_twins(cap):
            renderer.render_pass(
                film_mod.new_film(W * H, device=dev, settings=s16), dx, stx,
                s16, tables, cx, fis, 0, MAIN_PASS, 1.0 / 24, 2.0 / 24)
        torch.cuda.synchronize()
        gate(all(len(cap[k]) == 2 for k in keys),
             f"16 {path}: captured {[len(cap[k]) for k in keys]} calls")
        for key in keys:
            errs = []
            for i, (a, kw) in enumerate(cap[key]):
                depth = i + (1 if key in ("key", "costkey") else 0)
                got = impl[key](*a, **kw)
                want = twin[key](*a, **kw)
                torch.cuda.synchronize()
                errs.append(check(key, f"16 {path}", depth, a, kw, got,
                                  want))
                del got, want
            errs16[(path, key)] = max(errs)
            if key == "qtail":
                continue
            a, kw = cap[key][0 if key in ("key", "costkey") else 1]
            times16[(path, key)] = time15(key, a, kw, "16 kernels")
            log(f"[16 kernels] {key} ({path}), depth 1, per-lane albedo, "
                f"compacted lanes: {times16[(path, key)]:.4f} ms")
        if path == "fused":
            state16 = cap["tail"][1][0][2]   # the depth-1 state
        del cap, a, kw
        torch.cuda.empty_cache()
    rec16["kernels"] = {f"{p} {k}": dict(ms=times16.get((p, k)),
                                         max_abs_err=e)
                        for (p, k), e in errs16.items()}

    # the compaction's own kernels, on that depth-1 state: the partition
    # and gather (three a pass) and the gather back to ray order (one)
    def by_kernel(fn, reps=5):
        """Device ms a call by kernel name (torch.profiler; a session
        that sees no kernel is retried twice)."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        fn()
        torch.cuda.synchronize()
        out = {}
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
            for e in prof.events():
                if e.device_type == DeviceType.CUDA:
                    ms, calls = out.get(e.name, (0.0, 0))
                    out[e.name] = (ms + e.time_range.elapsed_us() / 1e3
                                   / reps, calls + 1)
            if out:
                return out
        gate(False, "16 compaction: the profiler saw no kernel")

    back = integrator.compact_order(state16.alive)
    comp16 = {"compact": by_kernel(lambda: integrator.compact(state16)),
              "gather back": by_kernel(
                  lambda: integrator._take(state16, back))}
    for label, names in comp16.items():
        total = sum(ms for ms, _c in names.values())
        log(f"[16 compaction] {label} of {MAIN_PASS} lanes "
            f"({int(state16.alive.sum())} alive): {total:.4f} ms of device "
            f"time a call; by kernel: " + "; ".join(
                f"{n[:60]} {ms:.4f} ms x{c // 5}"
                for n, (ms, c) in sorted(names.items(),
                                         key=lambda kv: -kv[1][0])))
    rec16["compaction_by_kernel"] = {
        label: {n: dict(ms=ms, calls=c // 5) for n, (ms, c) in names.items()}
        for label, names in comp16.items()}
    del state16, back, scrub

    # one profiled pass: no extras; the extras without and with
    # compaction, in turns
    film16 = film_mod.new_film(W * H, device=dev, settings=main16)

    def pass16(d_, st_, c_, s_):
        return lambda: renderer.render_pass(
            film16, d_, st_, s_, tables, c_, fis, 0, MAIN_PASS, 1.0 / 24,
            2.0 / 24)

    fns16 = {"plain": pass16(data, static, cam, dataclasses.replace(
                 main16, extra_aovs=(), compact_bounces=False)),
             "extras, no compaction": pass16(dx, stx, cx, dataclasses.replace(
                 main16, compact_bounces=False)),
             "extras, compaction": pass16(dx, stx, cx, main16)}
    turns16 = []
    for label in ("plain", "extras, no compaction", "extras, compaction",
                  "extras, compaction", "extras, no compaction", "plain"):
        r = profile_pass(fns16[label], f"16 {label}")
        turns16.append(dict(label=label, busy_ms=r["busy_ms"],
                            launches=r["launches"],
                            idle_share=r["idle_share"],
                            pass_wall_ms=r["pass_wall_ms"],
                            peak_bytes=r["peak_bytes"]))
    log("[16 profile] device busy ms / launches a pass, in turns: " +
        "; ".join(f"{t['label']} {t['busy_ms']:.3f} / {t['launches']}"
                  for t in turns16))
    rec16["profile_turns"] = turns16
    del film16, fns16, dx, stx, cx
    torch.cuda.empty_cache()

    # the command line's AOV PNGs under JAX's names
    with tempfile.TemporaryDirectory() as tmp:
        argv = ["--device", DEVICE, "--width", str(SMALL_RES[0]),
                "--height", str(SMALL_RES[1]), "--spp", str(MAIN_SPP),
                "--aov", "depth", "--aov", "albedo", "--out", f"{tmp}/cli"]
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            rc, launches, cli16_wall = launched(lambda: cli.main(argv))
        gate(rc == 0, f"16 cli: rc {rc}, stderr {err.getvalue()[-400:]!r}")
        gate_fused("16 cli", launches)
        names = sorted(os.listdir(f"{tmp}/cli"))
        want_names = sorted(f"frame0001_{MAIN_SPP}spp_{k}.png" for k in (
            "alpha", "normal", "color", "depth", "albedo"))
        gate(names == want_names, f"16 cli wrote {names}, not {want_names}")
        shapes = {k: film_mod.read_png(
            f"{tmp}/cli/frame0001_{MAIN_SPP}spp_{k}.png").shape
            for k in ("depth", "albedo")}
        gate(shapes == {"depth": SMALL_RES[::-1],
                        "albedo": (*SMALL_RES[::-1], 3)},
             f"16 cli: AOV PNG shapes {shapes}")
    log(f"[16 cli] --aov depth --aov albedo at {SMALL_RES[0]}x"
        f"{SMALL_RES[1]}: wrote {names} in {cli16_wall:.3f} s")
    rec16["cli"] = dict(files=names, wall_s=cli16_wall)
    record["phase16"] = rec16

    # ----------------------------------------------------- 17. scale-out
    record["phase17"] = scale_out(data, static, cam, main_s, fused_need,
                                  fused_absent, cli)

    # ---------- 18. the route without kernels, closures, deep programs
    # (a) use_pallas=False on phase 4's scene at 1080p, 1 spp; (b)
    # use_pallas_occlusion=False at 960x540; (c) the CLI's --no-pallas;
    # (d) a closure instance; (e) a program deeper than the Tape's stacks
    # through the DeepTape kernels, each against its twin.
    import warnings

    rec18 = {}
    t_phase18 = time.perf_counter()
    s18 = dataclasses.replace(main_s, spp=1)
    n18 = W * H

    def whole_word(names, entry):
        pat = re.compile(rf"(?<!\w){entry}(?!\w)")
        return any(pat.search(n) for n in names)

    def profile18(one_pass, both=False):
        """(device busy ms, cudaLaunchKernel calls, kernel names) of one
        pass under torch.profiler (retried where a session records no
        kernel). The route without kernels makes ~10^6 events a pass:
        they are read from kineto's raw events where this torch has
        them, since building prof.events() for them takes minutes; with
        `both`, the counts from prof.events() are logged beside."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        for _ in range(3):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                one_pass()
                torch.cuda.synchronize()
            try:
                ev = [(e.name(), e.device_type(), e.start_ns() / 1e3,
                       (e.start_ns() + e.duration_ns()) / 1e3)
                      for e in prof.profiler.kineto_results.events()]
            except AttributeError:
                ev = None
            slow = None
            if ev is None or both:
                slow = [(e.name, e.device_type, e.time_range.start,
                         e.time_range.end) for e in prof.events()]
                ev = ev or slow
            ks = [e for e in ev if e[1] == DeviceType.CUDA]
            if ks:
                break

        def counts(events):
            kern = [e for e in events if e[1] == DeviceType.CUDA]
            return (sum(1 for e in events if e[0] == "cudaLaunchKernel"),
                    len(kern), sorted({e[0] for e in kern}))

        if both:
            log(f"[18 no-pallas] launches and kernels of the pass from "
                f"kineto's raw events {counts(ev)[:2]}, from prof.events() "
                f"{counts(slow)[:2]}, the same names: "
                f"{counts(ev)[2] == counts(slow)[2]}")
        busy = busy_us((start, end) for _n, _d, start, end in ks) / 1e3
        return busy, counts(ev)[0], {e[0] for e in ks}

    # (a) the films: the route without kernels against the kernel route
    # with the fused intersect off (bit for bit: the march kernel equals
    # its twin, the torch march) and against the fused route (the fused
    # intersect normalises g * (1 / |g|), the unfused shading info
    # divides: phase 4's image gate)
    nk_s = dataclasses.replace(s18, use_pallas=False)
    nk, nk_l, nk_wall = launched(lambda: renderer.render_frame(
        data, static, nk_s, cam, frame=1))
    uk, _l, uk_wall = launched(lambda: renderer.render_frame(
        data, static, dataclasses.replace(s18, use_fused_intersect=False),
        cam, frame=1))
    fk, fk_l, fk_wall = launched(lambda: renderer.render_frame(
        data, static, s18, cam, frame=1))
    null_f = renderer.render_frame(data, static, s18, cam, frame=101)
    gate(not any(nk_l[k] for k in ("intersect", "march", "costkey",
                                   "omarch"))
         and all(nk_l[k] > 0 for k in ("key", "seg", "smarch", "tsum")),
         f"18 (a): launches {nk_l}")
    same_a = films_equal(nk, uk)
    gate(same_a, "18 (a): the use_pallas=False film differs from the "
         "kernel route's with use_fused_intersect=False")
    img_nk, img_fk, img_null = (film_mod.resolve(f, (W, H)).color
                                for f in (nk, fk, null_f))
    rmse_a = float(np.sqrt(np.mean((img_nk - img_fk) ** 2)))
    null_a = float(np.sqrt(np.mean((img_fk - img_null) ** 2)))
    mean_rel_a = float(abs(img_nk.mean() - img_fk.mean())
                       / max(img_fk.mean(), 1e-9))
    fused_same = films_equal(nk, fk)
    gate(fused_same or (rmse_a <= 1.5 * null_a and mean_rel_a <= 1e-3),
         f"18 (a): image gate against the fused route: RMSE {rmse_a}, "
         f"null {null_a}, mean rel {mean_rel_a}")
    log(f"[18 no-pallas] (a) {W}x{H} @ 1 spp, {MAIN_PASS}-ray passes: "
        f"use_pallas=False film bit for bit with use_fused_intersect=False"
        f"'s: {same_a}; against the fused route bit for bit: {fused_same} "
        f"(stage: the fused intersect's normal, g * (1/|g|), against "
        f"shading_info's g / |g|), max |d| {films_diff(nk, fk)}, RMSE "
        f"{rmse_a} against a seed-swap null {null_a}, mean rel diff "
        f"{mean_rel_a}; frame walls {nk_wall} s (use_pallas=False), "
        f"{uk_wall} s (unfused intersect), {fk_wall} s (fused); launches "
        f"{nk_l}")
    rec18["a"] = dict(bit_for_bit_unfused_intersect=same_a,
                      bit_for_bit_fused=fused_same, rmse=rmse_a,
                      null_rmse=null_a, mean_rel=mean_rel_a,
                      frame_s=dict(no_pallas=nk_wall, unfused=uk_wall,
                                   fused=fk_wall), launches=nk_l)
    del nk, uk, fk, null_f, img_nk, img_fk, img_null
    torch.cuda.empty_cache()

    # (a) the passes: walls in turns, then one profiled pass each
    film18 = film_mod.new_film(n18, device=dev)
    pass18 = {label: (lambda s_=s_: renderer.render_pass(
        film18, data, static, s_, tables, cam, fis, 0, MAIN_PASS,
        1.0 / 24, 2.0 / 24))
        for label, s_ in (("use_pallas=False", nk_s), ("kernels", s18))}
    walls18 = {label: [] for label in pass18}
    for r in range(2):
        for label in (list(pass18) if r % 2 == 0 else list(pass18)[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pass18[label]()
            torch.cuda.synchronize()
            walls18[label].append((time.perf_counter() - t0) * 1e3)
    prof18 = {}
    for label, fn in pass18.items():
        t0 = time.perf_counter()
        busy, launches, names = profile18(fn, both=label == "kernels")
        prof_s = time.perf_counter() - t0
        wall = sorted(walls18[label])[len(walls18[label]) // 2]
        prof18[label] = dict(busy_ms=busy, launches=launches,
                             pass_wall_ms=walls18[label],
                             idle_share=1.0 - busy / wall)
        if label == "use_pallas=False":
            absent = [e for k in ("intersect", "march", "costkey")
                      for e in ENTRIES[k] if whole_word(names, e)]
            present = [e for e in ("shadow_segments_kernel",
                                   "shadow_march_kernel", "tail_sum_kernel",
                                   "shadow_sort_key_kernel")
                       if whole_word(names, e)]
            gate(not absent and len(present) == 4,
                 f"18 (a): the profile shows {absent} and {present}")
        log(f"[18 no-pallas] (a) {label} pass of {MAIN_PASS} rays: "
            f"launches {launches}, device busy {busy} ms, idle share "
            f"{1.0 - busy / wall} of the median wall {wall} ms; walls in "
            f"turns {walls18[label]} ms; the profiled pass took {prof_s} s")
    rec18["a"]["passes"] = prof18
    del film18
    log(f"[18] (a) took {time.perf_counter() - t_phase18:.1f} s")

    # (b) use_pallas_occlusion=False at 960x540, 1 spp
    db, sb_, cb = presets.default_scene(resolution=UNFUSED_RES, device=dev)
    sb = RenderSettings(resolution=UNFUSED_RES, spp=1,
                        rays_per_pass=MAIN_PASS, max_marches=256,
                        max_vis_marches=100)
    no_occ, occ_l, occ_wall = launched(lambda: renderer.render_frame(
        db, sb_, dataclasses.replace(sb, use_pallas_occlusion=False), cb,
        frame=1))
    unf, unf_l, unf_wall = launched(lambda: renderer.render_frame(
        db, sb_, dataclasses.replace(sb, use_fused_shadows=False), cb,
        frame=1))
    same_b = films_equal(no_occ, unf)
    gate(same_b, "18 (b): the use_pallas_occlusion=False film differs "
         "from use_fused_shadows=False's")
    gate(occ_l["smarch"] == 0 and occ_l["omarch"] == 0 and occ_l["qseg"] > 0
         and occ_l["qsum"] > 0 and unf_l["smarch"] > 0,
         f"18 (b): launches {occ_l} (use_fused_shadows=False: {unf_l})")
    log(f"[18 no-pallas] (b) {UNFUSED_RES[0]}x{UNFUSED_RES[1]} @ 1 spp: "
        f"use_pallas_occlusion=False film bit for bit with "
        f"use_fused_shadows=False's; no shadow-march launch; frame walls "
        f"{occ_wall} s and {unf_wall} s; launches {occ_l}")
    rec18["b"] = dict(bit_for_bit=same_b, launches=occ_l,
                      frame_s=dict(no_occlusion_kernels=occ_wall,
                                   unfused_shadows=unf_wall))
    del no_occ, unf, db, sb_, cb

    # (c) the CLI's --no-pallas against the same render through the API
    with tempfile.TemporaryDirectory() as tmp:
        argv = ["--device", DEVICE, "--width", str(SMALL_RES[0]),
                "--height", str(SMALL_RES[1]), "--spp", "2",
                "--rays-per-pass", str(MAIN_PASS), "--frames", "1", "2",
                "--no-pallas", "--out", f"{tmp}/cli"]
        with contextlib.redirect_stderr(io.StringIO()):
            rc, cli_l, cli_wall = launched(lambda: cli.main(argv))
        gate(rc == 0 and cli_l["intersect"] == 0 and cli_l["march"] == 0
             and cli_l["tsum"] > 0, f"18 (c): rc {rc}, launches {cli_l}")
        dc, stc, cc = presets.default_scene(resolution=SMALL_RES, device=dev)
        ref = renderer.render_frame(dc, stc, RenderSettings(
            resolution=SMALL_RES, spp=2, rays_per_pass=MAIN_PASS,
            max_marches=256, max_vis_marches=100, use_pallas=False), cc,
            frame=1)
        written = film_mod.save_channels(film_mod.resolve(ref, SMALL_RES),
                                         f"{tmp}/api", "api")
        same_c = {}
        for path in written:
            ch = os.path.basename(path)[len("api_"):]
            with open(path, "rb") as a, open(
                    f"{tmp}/cli/frame0001_2spp_{ch}", "rb") as b:
                same_c[ch] = a.read() == b.read()
        gate(len(same_c) == 3 and all(same_c.values()),
             f"18 (c): PNGs byte for byte {same_c}")
    log(f"[18 no-pallas] (c) --no-pallas at {SMALL_RES[0]}x{SMALL_RES[1]} "
        f"@ 2 spp: rc 0 in {cli_wall} s; its PNGs byte for byte those of "
        f"render_frame + save_channels: {same_c}; launches {cli_l}")
    rec18["c"] = dict(png_bytes_equal=same_c, wall_s=cli_wall,
                      launches=cli_l)
    del ref, dc, stc, cc

    # (d) a closure instance against the library Torus
    clo = program_scene(UNFUSED_RES, dev, second=sdf_ops.translate(
        torus_closure(sdf_ops), (0.0, -2.6, 0.0)))
    lib = program_scene(UNFUSED_RES, dev, second=sdf_ops.translate(
        sdf_ops.torus(1.2, 0.1), (0.0, -2.6, 0.0)))
    integrator._WARNED.clear()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        f_clo, clo_l, clo_wall = launched(lambda: renderer.render_frame(
            clo[0], clo[1], sb, clo[2], frame=1))
    f_lib, lib_l, lib_wall = launched(lambda: renderer.render_frame(
        lib[0], lib[1], dataclasses.replace(sb, use_fused_intersect=False,
                                            use_fused_shadows=False),
        lib[2], frame=1))
    msgs = [str(w.message) for w in caught
            if issubclass(w.category, RuntimeWarning)
            and "rayn_tpu_torch:" in str(w.message)]
    same_d = films_equal(f_clo, f_lib)
    gate(same_d, "18 (d): the closure film differs from the library "
         "Torus's on the unfused route")
    gate(sorted(m.split(" unavailable")[0] for m in msgs) == [
        "rayn_tpu_torch: fused intersect kernel",
        "rayn_tpu_torch: fused shadow/finish kernels"],
         f"18 (d): warnings {msgs}")
    gate(clo_l["intersect"] == 0 and clo_l["march"] > 0
         and clo_l["smarch"] > 0, f"18 (d): launches {clo_l}")
    for m in msgs:
        log(f"[18 closure] warned once: {m}")
    log(f"[18 closure] (d) {UNFUSED_RES[0]}x{UNFUSED_RES[1]} @ 1 spp: the "
        f"closure torus's film bit for bit with the library Torus's on the "
        f"unfused route; frame walls {clo_wall} s (closure, fused flags "
        f"set) and {lib_wall} s (library, unfused); launches {clo_l}")
    rec18["d"] = dict(bit_for_bit=same_d, warnings=msgs, launches=clo_l,
                      frame_s=dict(closure=clo_wall, library=lib_wall))
    del clo, lib, f_clo, f_lib
    torch.cuda.empty_cache()

    # (e) a deep program through the DeepTape kernels
    log(f"[18] (a)-(d) took {time.perf_counter() - t_phase18:.1f} s")
    scrub = torch.empty((64 << 20,), dtype=torch.uint8, device=dev)
    deep = deep_program(sdf_ops)
    tp = sdf_ops.tape(deep)
    gate((tp.depth, tp.points) == (12, 12),
         f"18 (e): the program holds {tp.depth} distances and {tp.points} "
         "points")
    dd, dst, dcam = program_scene((W, H), dev, second=deep)
    deep_sdf = _build.sdf_args(dst.sdf_instances(dd), dev, MAIN_PASS)[1]
    gate(deep_sdf.tape == 2, f"18 (e): tape {deep_sdf.tape}")
    deep_ptx = {e: p for e in sorted({e for es in ENTRIES.values()
                                      for e in es if "_deep_" in e})
                for name, p in ptx.items() if f"{len(e)}{e}E" in name}
    log(f"[18 deep] registers and spills of the DeepTape kernels: "
        f"{deep_ptx}; the scratch: {deep_sdf.slots} thread slots x "
        f"{tp.depth + 3 * tp.points} floats")
    rec18["deep_ptxas"] = deep_ptx
    times18 = {}
    for path, s_, keys in (paths15[0], paths15[2]):
        t0 = time.perf_counter()
        cap = capture15(dd, dst, dcam, s_, keys, f"deep {path}", MAIN_PASS)
        log(f"[18] (e) {path}: the captured pass and the checks took "
            f"{time.perf_counter() - t0:.1f} s")
        for key in timed15[path]:
            a, kw = cap[key][{"key": 0, "costkey": 0, "march": 3}.get(key, 1)]
            got = impl[key](*a, **kw)
            times18[f"{path} {key}"] = row15(path, key, a, kw, got,
                                             phase="18 deep")
            del got
        if path == "relaxed":
            (cfg, segs, _relax), _kw = cap["smarch"][1]
            calls = one_program(cfg, segs, cap["march"][3])
            for key, (a, kw) in calls.items():
                got = funcs15[key](*a, **kw)
                times18[f"{path} {key}"] = row15(path, key, a, kw, got,
                                                 phase="18 deep")
                del got
            # the first-DE entry (split 0) on the deep program
            a0, kw0 = calls["march_occlusion_phased"]
            kw0 = dict(kw0, phase1_steps=0)
            gate(same_bits(funcs15["march_occlusion_phased"](*a0, **kw0),
                           plain15["march_occlusion_phased"](*a0, **kw0)),
                 "18 (e): the first-DE entry differs from its plain version")
        del cap
        torch.cuda.empty_cache()
    for k, r in times18.items():
        p15 = times15.get(k)
        log(f"[18 deep] {k}: {r['ms']} ms, {r['de_evals']} DEs, "
            f"{r['ps_per_de']} ps a DE (phase 15's Tape program scene: "
            + (f"{p15['ms']} ms, {p15['de_evals']} DEs, {p15['ps_per_de']} "
               "ps a DE)" if p15 else "not timed)"))
    # the animated DeepTape kernels on the animated-geo scene, small
    ad = animated_program_scene(IMG_RES, dev, deep)
    capture15(*ad, dataclasses.replace(paths15[0][1], resolution=IMG_RES),
              ("intersect", "costkey", "key", "tail", "seg", "smarch",
               "tsum"), "deep animated", IMG_RES[0] * IMG_RES[1] * 4)
    log(f"[18 deep] the animated DeepTape kernels at {IMG_RES[0]}x"
        f"{IMG_RES[1]}: every kernel equal to its twin")
    rec18["deep_kernels"] = times18
    del dd, dst, dcam, ad, scrub
    torch.cuda.empty_cache()
    rec18["seconds"] = time.perf_counter() - t_phase18
    log(f"[18] phase took {rec18['seconds']:.1f} s")
    record["phase18"] = rec18

    # --------------------------------------------- 7. profile (optional)
    # Last of the render phases: passes that ran after torch.profiler in
    # the same process were measured slower, so no main path follows it.
    if args.profile:
        film7 = film_mod.new_film(W * H, device=dev)

        def pass7(s):
            return lambda: renderer.render_pass(
                film7, data, static, s, tables, cam, fis, 0, MAIN_PASS,
                1.0 / 24, 2.0 / 24)

        record["profile"] = {
            label: profile_pass(pass7(s), label)
            for label, s in (("fused", main_s), ("relaxed", relax_s),
                             ("unfused", unfused_s),
                             ("split mis", split_s), ("sorted", sorted_s))}
        # The host's launch rate drifts within a call, so the fused pass,
        # the fused pass with MIS, the split tail with MIS, the relax-1
        # unfused pass and the sorted two-phase pass are also timed
        # alternately, the order reversed every other round.
        sorts_off = {"fused, no sorts": dict(sorted_intersect=False,
                                             sorted_shadow_march=False),
                     "fused, no intersect sort": dict(sorted_intersect=False),
                     "fused, no shadow sort": dict(sorted_shadow_march=False)}
        fns7 = {"fused": pass7(main_s), "fused mis": pass7(mis_s),
                "split mis": pass7(split_s), "unfused": pass7(unfused_s),
                "sorted": pass7(sorted_s),
                **{label: pass7(dataclasses.replace(main_s, **kw))
                   for label, kw in sorts_off.items()}}
        walls7 = {label: [] for label in fns7}
        for r in range(8):
            for label in (list(walls7) if r % 2 == 0 else
                          list(walls7)[::-1]):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fns7[label]()
                torch.cuda.synchronize()
                walls7[label].append((time.perf_counter() - t0) * 1e3)
        med7 = {k: sorted(v)[len(v) // 2] for k, v in walls7.items()}
        log(f"[7 profile] interleaved pass walls ms, 8 rounds: {walls7}; "
            f"medians {med7}")
        record["profile"]["interleaved_walls_ms"] = walls7
        del film7

    # Each row's launches come from the main path that runs it (its
    # KERNEL_ROWS entry), its time and bound from phase 3: the march
    # kernel on the relaxed path's inputs (its error the larger of its two
    # paths'), rows 7 and 8 on the queue paths' segments, the two-phase
    # functions at their row's split, the others on the path named by
    # their launches. The bounce tail and shadow radiance give their
    # function's time and bound and the largest error of the function and
    # its kernels. A short kernel's time is its device time.
    path_of = {"main": "fused", "split": "split mis", "relaxed": "relaxed",
               "unfused": "unfused"}
    kern = []
    for kname, src, rep, tkey, (phase, lkey), keys in KERNEL_ROWS:
        if kname in two_phase:
            r, err = two_phase[kname], two_phase_err[kname]
        else:
            r = results[(path_of[phase], tkey)]
            err = max(v["max_abs_err"] for (_p, k), v in results.items()
                      if k == tkey or k in keys)
        ms = r["ms"]
        if tkey in DEVICE_TIMED and r.get("device_ms") is not None:
            ms = r["device_ms"]
        row = dict(
            name=kname, route="cuda", source=src, replaces=rep,
            launches=record[phase]["launches"][lkey], max_abs_err=err,
            ms=ms, plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=None,
            cuda_kernels=[e for k in keys for e in ENTRIES[k]])
        if tkey in ms14:   # a kernel that takes the reduced shadow DE
            row.update(ms_shadow_de_8=ms14[tkey][0],
                       ms_full_de_same_inputs=ms14[tkey][1],
                       bound_ms_shadow_de_8=des14[tkey][2],
                       de_evals_shadow_de_8=des14[tkey][0],
                       de_evals_full_de_same_inputs=des14[tkey][1])
        p15 = next((v for k, v in times15.items() if k.endswith(f" {tkey}")),
                   None)
        if p15 is not None:   # a kernel that reads the SDF
            row.update(ms_program=p15["ms"], de_evals_program=p15["de_evals"],
                       ps_per_de_program=p15["ps_per_de"],
                       bound_ms_program=p15["bound_ms"])
        p18 = next((v for k, v in times18.items()
                    if k.endswith(f" {tkey}")), None)
        if p18 is not None:   # phase 18: the DeepTape kernel
            row.update(ms_deep=p18["ms"], de_evals_deep=p18["de_evals"],
                       ps_per_de_deep=p18["ps_per_de"],
                       bound_ms_deep=p18["bound_ms"])
        if f"fused {tkey}" in price or f"relaxed {tkey}" in price:
            pr = price.get(f"fused {tkey}") or price[f"relaxed {tkey}"]
            row.update(ms_tape_default_scene=pr["tape_ms"],
                       ms_mbox_only_same_inputs=pr["mbox_only_ms"])
        t16 = next(((p, k) for p, k in times16 if k == tkey), None)
        if t16 is not None:   # phase 16: per-lane albedo, compacted lanes
            row.update(ms_extras=times16[t16],
                       max_abs_err_extras=errs16[t16],
                       launches_extras=frames16[
                           "fused, extras" if phase == "main" else
                           "relaxed, extras"][0]["launches"][lkey]
                       if phase in ("main", "relaxed") else None)
        if ("8 knots", tkey) in times13:   # a kernel that reads positions
            row.update(
                ms_animated=times13[("8 knots", tkey)],
                ms_animated_64=times13[("64 knots", tkey)],
                ms_static_same_call=times13[("static", tkey)],
                bound_ms_animated=bounds13[("8 knots", tkey)][0])
        if phase == "main":   # phase 17 (b): each of two ranks' frame
            row["launches_sharded_2_ranks"] = [
                r["launches"][lkey] for r in record["phase17"]["b"]]
        kern.append(row)
    record["kernels"] = kern
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(record, fh, indent=1)
    print(json.dumps({"kernels": kern}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": record["device"]["name"],
        "count": record["device"]["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
