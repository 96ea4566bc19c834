// Sphere-tracing kernels of the segment-queue bounce for Hopper (sm_90a).
//
// march_kernel / march_relaxed_kernel replace rayn_tpu/ops/
// march_pallas.py march (_march_kernel): the closest-hit march of one SDF
// program (a bare MandelBox, or any program in the *_tape_* kernels) along
// each ray, bounded by its t_max, with the cone
// threshold max(eps_const, eps_abs + eps_lin * t), plain (relax = 1) or
// over-relaxed (Keinert's overshoot test and conservative fallback,
// t_prev / r_prev per ray). The same kernel replaces march_pallas.py
// march_sorted and march_phased (_march_phase1_kernel, a regroup of the
// lanes by a sort or a partition, _march_resume_kernel): every lane of
// the two-phase march takes the steps of one uncapped plain march, so at
// every split its result is the march's at relax 1, bit for bit
// (march_pallas.py:171), and the refill march regroups its lanes as each
// ray resolves, so no split, sort or resume is needed.
// enqueue_kernel and occl_march_kernel / occl_march_relaxed_kernel
// replace march_pallas.march_occlusion (_occl_kernel with
// _segment_entry: one shadow segment per lane with the bounding-sphere
// clip, plain or over-relaxed) and march_occlusion_chained
// (_chained_occl_core: the K segments of a ray, each with the relax-1
// march_occlusion verdict), which march_cuda.py runs as the same pair on
// K*N segments: the enqueue kernel compacts the ids of the active
// segments (one atomicAdd per warp), and the refill march (common.cuh
// refill_march, the march of the bounce tail's shadow queue) marches
// them from the [M, 3] start and end tensors, writing each verdict to the
// segment's own slot. The same pair replaces march_pallas.py
// march_occlusion_phased and march_occlusion_sorted (phase 1, a regroup
// of the lanes by a payload sort, the resume): their verdicts are those
// of the single-phase march with no bounding-sphere clip at every split
// >= 1, and the refill march regroups lanes as each segment resolves, so
// no split is needed; at split 0 occl_march_first_de_kernel takes JAX's
// first-DE verdict (march_pallas.py:518).
//
// What bounds them on the H100: float32 ALU and the drain. A step is one
// 12-iteration MandelBox DE (~400 flops) and a lane takes up to
// max_steps of them, against 12-40 bytes in and 1-4 bytes out per
// segment or ray; lanes of a warp march different numbers of steps, and
// the warp's last rays run with idle lanes beside them.
// What the design does about it: persistent lanes that each take a ray
// or a queued segment, march it to the end, write its result to its own
// slot and take the next, so a warp costs about its lanes' total steps /
// 32 plus the drain (one thread per segment or per ray cost each warp
// its slowest lane's steps; the TPU's chaining only packed block
// iterations, and its two-phase regroup only grouped lanes by a guess at
// their remaining steps). Every loop iteration evaluates exactly one DE
// per busy lane. Inactive segments never reach the queue, and the march
// reads the queue's length on the device. The closest-hit march needs no
// queue: its warps take the wavefront itself, 32 ray ids at a time with
// one atomicAdd on a device counter; each lane loads one ray (coalesced),
// an inactive ray is written there and then, and the live ones are
// handed to idle lanes by shuffles, so a take costs one memory round
// trip for 32 rays (the batch take of intersect.cu closest_hit_kernel).
// The take is a copy of that kernel's, not a shared function: the two
// carry different payloads (the sphere fold's closest t and object there,
// t_max and the cone terms here), and closest_hit_kernel stays as it was
// measured (56 registers). Each ray's arithmetic is the one-thread-per-
// ray body's, in the same order, so the order in which rays are taken
// changes no bit.
#include "common.cuh"

namespace rayn {

struct MarchArgs {  // ops/march_cuda.py _MarchArgs
  const float* origin;     // [N, 3]
  const float* direction;  // [N, 3]
  const float* t_max;      // [N]
  const float* eps_abs;    // [N]
  const float* eps_lin;    // [N]
  const bool* active;      // [N]
  // [1] ray ids handed out (0 at launch); unsigned, so the takes past
  // n < 2^31 of the last warps cannot wrap
  unsigned* head;
  // [1] or null: the loop iterations of every warp are added here (each
  // iteration evaluates one DE per busy lane; for measurement)
  unsigned long long* warp_steps;
  float* t;                // [N] out
  long long n;
  int max_steps;
  MBox mb;
  float eps_const;
  float relax;
};

struct EnqueueArgs {  // ops/march_cuda.py _EnqueueArgs
  const bool* active;  // [M]
  int* queue;          // [M] out: ids of the active segments, any order
  int* count;          // [1] out: ids in the queue (0 at launch)
  long long n;         // M
};

struct OcclMarchArgs {  // ops/march_cuda.py _OcclMarchArgs
  const float* start;  // [M, 3]
  const float* end;    // [M, 3]
  QueueMarch q;
  int first_de;        // JAX's split-0 entry (relax 1, no clip)
};

// Step policies of the closest-hit march: one step of a ray past its
// entry DE, whose DE `dist` at o + t*d has been taken and whose cone
// threshold at t is `thresh`; `step` counts the steps taken. True when
// the ray is done (t final); else t has advanced.
// march.py march at relax 1 (march_pallas._march_kernel): a DE below the
// threshold ends the march; else t advances by it, and the march ends
// after max_steps steps or past t_max (the test that precedes the next
// step's DE).
struct PlainMarch {
  __device__ __forceinline__ void enter(float) {}
  __device__ __forceinline__ bool operator()(float dist, float thresh,
                                             float t_max, int& step,
                                             int max_steps, float& t) {
    if (fabsf(dist) < thresh) return true;
    t = t + dist;
    ++step;
    return step >= max_steps || t > t_max;
  }
};

// The over-relaxed march: a DE below the threshold or a t past t_max ends
// the march unless the step overshot (t - t_prev > |r_prev| + |dist|),
// which falls back to t_prev + r_prev; else t advances by relax * dist.
// t_prev and r_prev are 0 and the entry DE at entry.
struct RelaxedMarch {
  float relax, t_prev, r_prev;
  __device__ __forceinline__ void enter(float t0) {
    t_prev = 0.0f;
    r_prev = t0;
  }
  __device__ __forceinline__ bool operator()(float dist, float thresh,
                                             float t_max, int& step,
                                             int max_steps, float& t) {
    const bool overshoot = (t - t_prev) > (fabsf(r_prev) + fabsf(dist));
    const bool done = (fabsf(dist) < thresh) || (t > t_max);
    if (done && !overshoot) return true;
    if (overshoot) {
      t = t_prev + r_prev;
    } else {
      t_prev = t;
      r_prev = dist;
      t = t + relax * dist;
    }
    ++step;
    return step >= max_steps;
  }
};

// The closest-hit march of every ray (march.py march), written to the
// ray's own slot: t_max + 1 for an inactive ray, NaN where the entry DE
// is, else t after the march. Persistent blocks; each lane takes a ray
// from the warp's batch, takes its entry DE at the origin, then one step
// of the policy per loop iteration until it is done, writes t and takes
// the next. An entry DE that is NaN or past t_max ends the march there:
// no step can move t (a plain step tests t_max before its DE, and a
// relaxed first step cannot overshoot, since t0 - 0 <= |t0| + |dist|).
// S: the SDF kind; `sdf` holds the one program marched (TapeSdf).
template <class Step, class S>
__device__ __forceinline__ void march_refill(const MarchArgs& a,
                                             const Sdf& sdf, Step st) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  int id = -1;         // this lane's ray, -1 while idle
  bool entry = false;  // its next DE is the entry DE, at the origin
  int step = 0;
  float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 0.0f;
  float t_max = 0.0f, eps_abs = 0.0f, eps_lin = 0.0f, t = 0.0f;
  // The warp's batch: slot `lane` holds ray bi, loaded; `pending` marks
  // the slots whose ray still waits for a lane.
  int bi = -1;
  float b_ox = 0.0f, b_oy = 0.0f, b_oz = 0.0f, b_dx = 0.0f, b_dy = 0.0f,
        b_dz = 0.0f, b_tm = 0.0f, b_ea = 0.0f, b_el = 0.0f;
  unsigned pending = 0u;
  bool drained = false;
  unsigned long long iters = 0;
  for (;;) {
    unsigned idle = __ballot_sync(FULL_MASK, id < 0);
    while (idle != 0u && !drained) {
      if (pending == 0u) {  // the next 32 rays, one per lane
        unsigned b = 0u;
        if (lane == 0) b = atomicAdd(a.head, 32u);
        b = __shfl_sync(FULL_MASK, b, 0);
        if ((long long)b >= a.n) {
          drained = true;
          break;
        }
        bi = (int)b + lane;
        bool live = false;
        if ((long long)bi < a.n) {
          b_tm = a.t_max[bi];
          live = a.active[bi];
          if (live) {
            const long long i3 = 3LL * bi;
            b_ox = a.origin[i3];
            b_oy = a.origin[i3 + 1];
            b_oz = a.origin[i3 + 2];
            b_dx = a.direction[i3];
            b_dy = a.direction[i3 + 1];
            b_dz = a.direction[i3 + 2];
            b_ea = a.eps_abs[bi];
            b_el = a.eps_lin[bi];
          } else {  // no DE to take: done the moment it is loaded
            a.t[bi] = b_tm + 1.0f;
          }
        }
        pending = __ballot_sync(FULL_MASK, live);
        continue;
      }
      // the r-th idle lane takes the r-th pending slot
      unsigned m = pending;
      for (int r = __popc(idle & below); r > 0 && m != 0u; --r) m &= m - 1u;
      const bool take = id < 0 && m != 0u;
      const int src = take ? __ffs(m) - 1 : lane;
      const int v_id = __shfl_sync(FULL_MASK, bi, src);
      const float v_ox = __shfl_sync(FULL_MASK, b_ox, src);
      const float v_oy = __shfl_sync(FULL_MASK, b_oy, src);
      const float v_oz = __shfl_sync(FULL_MASK, b_oz, src);
      const float v_dx = __shfl_sync(FULL_MASK, b_dx, src);
      const float v_dy = __shfl_sync(FULL_MASK, b_dy, src);
      const float v_dz = __shfl_sync(FULL_MASK, b_dz, src);
      const float v_tm = __shfl_sync(FULL_MASK, b_tm, src);
      const float v_ea = __shfl_sync(FULL_MASK, b_ea, src);
      const float v_el = __shfl_sync(FULL_MASK, b_el, src);
      if (take) {
        id = v_id;
        ox = v_ox;
        oy = v_oy;
        oz = v_oz;
        dx = v_dx;
        dy = v_dy;
        dz = v_dz;
        t_max = v_tm;
        eps_abs = v_ea;
        eps_lin = v_el;
        entry = true;
      }
      // the lowest min(idle, pending) pending slots are handed out
      for (int k = min(__popc(idle), __popc(pending)); k > 0; --k)
        pending &= pending - 1u;
      idle = __ballot_sync(FULL_MASK, id < 0);
    }
    if (idle == FULL_MASK) {  // every ray is taken and written
      if (a.warp_steps != nullptr && lane == 0)
        atomicAdd(a.warp_steps, iters);
      return;
    }
    ++iters;
    if (id < 0) continue;
    const float px = entry ? ox : ox + t * dx;
    const float py = entry ? oy : oy + t * dy;
    const float pz = entry ? oz : oz + t * dz;
    const float dist = S::de(a.mb, sdf, 0, px, py, pz);
    bool done;
    if (entry) {
      entry = false;
      t = dist;
      step = 0;
      done = isnan(t) || a.max_steps <= 0 || t > t_max;
      st.enter(t);
    } else {
      done = st(dist, nmax(a.eps_const, eps_abs + eps_lin * t), t_max, step,
                a.max_steps, t);
    }
    if (done) {
      a.t[id] = t;
      id = -1;
    }
  }
}

__global__ void __launch_bounds__(128) march_kernel(const MarchArgs a) {
  march_refill<PlainMarch, MBoxOnly>(a, Sdf{}, PlainMarch{});
}

__global__ void __launch_bounds__(128)
    march_relaxed_kernel(const MarchArgs a) {
  march_refill<RelaxedMarch, MBoxOnly>(a, Sdf{},
                                       RelaxedMarch{a.relax, 0.0f, 0.0f});
}

__global__ void __launch_bounds__(128)
    march_tape_kernel(const Taped<MarchArgs> t) {
  march_refill<PlainMarch, TapeSdf>(t.a, t.sdf, PlainMarch{});
}

__global__ void __launch_bounds__(128)
    march_relaxed_tape_kernel(const Taped<MarchArgs> t) {
  march_refill<RelaxedMarch, TapeSdf>(t.a, t.sdf,
                                      RelaxedMarch{t.a.relax, 0.0f, 0.0f});
}

__global__ void __launch_bounds__(128)
    march_deep_kernel(const DeepTaped<MarchArgs> t) {
  march_refill<PlainMarch, DeepTapeSdf>(t.a, t.sdf, PlainMarch{});
}

__global__ void __launch_bounds__(128)
    march_relaxed_deep_kernel(const DeepTaped<MarchArgs> t) {
  march_refill<RelaxedMarch, DeepTapeSdf>(
      t.a, t.sdf, RelaxedMarch{t.a.relax, 0.0f, 0.0f});
}

__global__ void __launch_bounds__(128)
    march_expr_kernel(const DeepTaped<MarchArgs> t) {
  march_refill<PlainMarch, ExprTapeSdf>(t.a, t.sdf, PlainMarch{});
}

__global__ void __launch_bounds__(128)
    march_relaxed_expr_kernel(const DeepTaped<MarchArgs> t) {
  march_refill<RelaxedMarch, ExprTapeSdf>(
      t.a, t.sdf, RelaxedMarch{t.a.relax, 0.0f, 0.0f});
}

// Appends the id of every active segment to the queue.
__global__ void __launch_bounds__(128) enqueue_kernel(const EnqueueArgs a) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  enqueue(i < a.n && a.active[i], (int)i, a.count, a.queue);
}

// The SDF verdict of every queued segment start -> end (refill_march).
__global__ void __launch_bounds__(128) occl_march_kernel(
    const OcclMarchArgs a) {
  refill_march(AosSegments{a.start, a.end}, a.q, Sdf{}, PlainStep{});
}

__global__ void __launch_bounds__(128) occl_march_relaxed_kernel(
    const OcclMarchArgs a) {
  refill_march(AosSegments{a.start, a.end}, a.q, Sdf{},
               RelaxedStep{a.q.relax, 0.0f, 0.0f});
}

// The two-phase occlusion at split 0: the first-DE entry, then plain
// steps.
__global__ void __launch_bounds__(128) occl_march_first_de_kernel(
    const OcclMarchArgs a) {
  refill_march<AosSegments, PlainStep, true>(AosSegments{a.start, a.end},
                                             a.q, Sdf{}, PlainStep{});
}

// The same three for any program but a bare MandelBox.
__global__ void __launch_bounds__(128) occl_march_tape_kernel(
    const Taped<OcclMarchArgs> t) {
  refill_march<AosSegments, PlainStep, false, TapeSdf>(
      AosSegments{t.a.start, t.a.end}, t.a.q, t.sdf, PlainStep{});
}

__global__ void __launch_bounds__(128) occl_march_relaxed_tape_kernel(
    const Taped<OcclMarchArgs> t) {
  refill_march<AosSegments, RelaxedStep, false, TapeSdf>(
      AosSegments{t.a.start, t.a.end}, t.a.q, t.sdf,
      RelaxedStep{t.a.q.relax, 0.0f, 0.0f});
}

__global__ void __launch_bounds__(128) occl_march_first_de_tape_kernel(
    const Taped<OcclMarchArgs> t) {
  refill_march<AosSegments, PlainStep, true, TapeSdf>(
      AosSegments{t.a.start, t.a.end}, t.a.q, t.sdf, PlainStep{});
}

// And for a program deeper than kSdfDepth.
__global__ void __launch_bounds__(128) occl_march_deep_kernel(
    const DeepTaped<OcclMarchArgs> t) {
  refill_march<AosSegments, PlainStep, false, DeepTapeSdf>(
      AosSegments{t.a.start, t.a.end}, t.a.q, t.sdf, PlainStep{});
}

__global__ void __launch_bounds__(128) occl_march_relaxed_deep_kernel(
    const DeepTaped<OcclMarchArgs> t) {
  refill_march<AosSegments, RelaxedStep, false, DeepTapeSdf>(
      AosSegments{t.a.start, t.a.end}, t.a.q, t.sdf,
      RelaxedStep{t.a.q.relax, 0.0f, 0.0f});
}

__global__ void __launch_bounds__(128) occl_march_first_de_deep_kernel(
    const DeepTaped<OcclMarchArgs> t) {
  refill_march<AosSegments, PlainStep, true, DeepTapeSdf>(
      AosSegments{t.a.start, t.a.end}, t.a.q, t.sdf, PlainStep{});
}

// And for a scene with a kernel-ready closure.
__global__ void __launch_bounds__(128) occl_march_expr_kernel(
    const DeepTaped<OcclMarchArgs> t) {
  refill_march<AosSegments, PlainStep, false, ExprTapeSdf>(
      AosSegments{t.a.start, t.a.end}, t.a.q, t.sdf, PlainStep{});
}

__global__ void __launch_bounds__(128) occl_march_relaxed_expr_kernel(
    const DeepTaped<OcclMarchArgs> t) {
  refill_march<AosSegments, RelaxedStep, false, ExprTapeSdf>(
      AosSegments{t.a.start, t.a.end}, t.a.q, t.sdf,
      RelaxedStep{t.a.q.relax, 0.0f, 0.0f});
}

__global__ void __launch_bounds__(128) occl_march_first_de_expr_kernel(
    const DeepTaped<OcclMarchArgs> t) {
  refill_march<AosSegments, PlainStep, true, ExprTapeSdf>(
      AosSegments{t.a.start, t.a.end}, t.a.q, t.sdf, PlainStep{});
}

}  // namespace rayn

// Blocks an SM of the closest-hit march's persistent grid (0: as many as
// fit). tools/torch_probe_hit_grid.py --kernel march builds other values
// and times each depth.
#ifndef RAYN_MARCH_BLOCKS_PER_SM
#define RAYN_MARCH_BLOCKS_PER_SM 4
#endif

// Persistent (launch_persistent): every block runs until all rays are
// taken; plain steps at relax 1, relaxed ones otherwise; the *_tape_*
// instantiations for any program but a bare MandelBox, the *_deep_* ones
// for a program deeper than kSdfDepth, the *_expr_* ones for a
// kernel-ready closure.
extern "C" cudaError_t rayn_march(
    const rayn::DeepTaped<rayn::MarchArgs>* args, cudaStream_t stream) {
  const rayn::MarchArgs& a = args->a;
  if (a.n <= 0) return cudaSuccess;
  const bool plain = a.relax == 1.0f;
  if (args->sdf.tape == 3)
    return rayn::launch_persistent(
        plain ? rayn::march_expr_kernel : rayn::march_relaxed_expr_kernel,
        *args, a.n, stream, RAYN_MARCH_BLOCKS_PER_SM);
  if (args->sdf.tape == 2)
    return rayn::launch_persistent(
        plain ? rayn::march_deep_kernel : rayn::march_relaxed_deep_kernel,
        *args, a.n, stream, RAYN_MARCH_BLOCKS_PER_SM);
  if (args->sdf.tape)
    return rayn::launch_persistent(
        plain ? rayn::march_tape_kernel : rayn::march_relaxed_tape_kernel,
        args->taped(), a.n, stream, RAYN_MARCH_BLOCKS_PER_SM);
  return rayn::launch_persistent(
      plain ? rayn::march_kernel : rayn::march_relaxed_kernel, a, a.n,
      stream, RAYN_MARCH_BLOCKS_PER_SM);
}

extern "C" cudaError_t rayn_enqueue(const rayn::EnqueueArgs* args,
                                    cudaStream_t stream) {
  if (args->n <= 0) return cudaSuccess;
  rayn::enqueue_kernel<<<rayn::blocks_of(args->n, 128), 128, 0, stream>>>(
      *args);
  return cudaGetLastError();
}

// Persistent (launch_persistent); the first-DE entry where first_de is
// set, else plain steps at relax 1 and relaxed ones otherwise; the *_tape_*
// instantiations for any program but a bare MandelBox, the *_deep_* ones
// for a program deeper than kSdfDepth, the *_expr_* ones for a
// kernel-ready closure.
extern "C" cudaError_t rayn_occl_march(
    const rayn::DeepTaped<rayn::OcclMarchArgs>* args, cudaStream_t stream) {
  const rayn::OcclMarchArgs& a = args->a;
  if (a.q.m <= 0) return cudaSuccess;
  if (args->sdf.tape == 3)
    return rayn::launch_persistent(
        a.first_de          ? rayn::occl_march_first_de_expr_kernel
        : a.q.relax == 1.0f ? rayn::occl_march_expr_kernel
                            : rayn::occl_march_relaxed_expr_kernel,
        *args, a.q.m, stream);
  if (args->sdf.tape == 2)
    return rayn::launch_persistent(
        a.first_de          ? rayn::occl_march_first_de_deep_kernel
        : a.q.relax == 1.0f ? rayn::occl_march_deep_kernel
                            : rayn::occl_march_relaxed_deep_kernel,
        *args, a.q.m, stream);
  if (args->sdf.tape)
    return rayn::launch_persistent(
        a.first_de          ? rayn::occl_march_first_de_tape_kernel
        : a.q.relax == 1.0f ? rayn::occl_march_tape_kernel
                            : rayn::occl_march_relaxed_tape_kernel,
        args->taped(), a.q.m, stream);
  return rayn::launch_persistent(a.first_de ? rayn::occl_march_first_de_kernel
                                 : a.q.relax == 1.0f
                                     ? rayn::occl_march_kernel
                                     : rayn::occl_march_relaxed_kernel,
                                 a, a.q.m, stream);
}
