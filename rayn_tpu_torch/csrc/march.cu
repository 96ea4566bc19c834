// Sphere-tracing kernels of the segment-queue bounce for Hopper (sm_90a).
//
// march_kernel replaces rayn_tpu/ops/march_pallas.py march
// (_march_kernel): the closest-hit march of the MandelBox along each ray,
// bounded by its t_max, with the cone threshold max(eps_const, eps_abs +
// eps_lin * t), plain (relax = 1) or over-relaxed (Keinert's overshoot
// test and conservative fallback, frozen t_prev / r_prev).
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
// What bounds them on the H100: float32 ALU. A step is one 12-iteration
// MandelBox DE (~400 flops) and a lane takes up to max_steps of them,
// against 12-40 bytes in and 1-4 bytes out per segment or ray; lanes of a
// warp also march different numbers of steps.
// What the design does about it: the march kernel's persistent lanes
// each take a queued segment, march it and take the next, so a warp
// costs about its lanes' total steps / 32 plus the drain (one thread per
// segment or per ray cost each warp its slowest lane's steps; the TPU's
// chaining only packed block iterations). Inactive segments never reach
// the queue, and the march reads the queue's length on the device.
//
// The two-phase kernels replace march_pallas.py's _march_phase1_kernel
// and _march_resume_kernel (march_sorted, march_phased): phase 1 marches
// every lane at most a few plain steps and writes t1 and whether the
// lane resolved; the resume kernel finishes the unresolved lanes from t1.
// What bounds them: the same float32 ALU, and a warp runs until its
// slowest lane is done. What the design does about it: the caller orders
// the lanes between the phases (a sort by predicted remaining steps, or
// the unresolved lanes first), and thread i of the resume kernel takes
// lane order[i], so a warp holds lanes of like remaining work, and a warp
// of resolved lanes exits at once. The thread reads its lane's inputs
// and t1 where they lie and writes its result back to that lane: one
// indirect load per input instead of the TPU's payload sort of 11-13
// columns and its un-permute. Every lane takes the steps of one uncapped
// march (march_plain rounds as march_ray does), so the result is
// bit-identical to the single-phase march.
#include "common.cuh"

namespace rayn {

struct MarchArgs {  // ops/march_cuda.py _MarchArgs
  const float* origin;     // [N, 3]
  const float* direction;  // [N, 3]
  const float* t_max;      // [N]
  const float* eps_abs;    // [N]
  const float* eps_lin;    // [N]
  const bool* active;      // [N] (not read by the resume kernel)
  float* t;                // [N] out (resume: phase 1's t, finished in place)
  bool* resolved;          // [N] phase 1 out, resume in
  const long long* order;  // [n_order] lanes of the resume kernel
  long long n;
  long long n_order;
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

// The plain (relax 1) march of one ray for at most `steps` steps from t,
// advanced in place; true iff the ray resolved within them: it passed
// t_max or its DE met the threshold.
__device__ __forceinline__ bool march_plain(const MBox& mb, float ox,
                                            float oy, float oz, float dx,
                                            float dy, float dz, float& t,
                                            float t_max, float eps_const,
                                            float eps_abs, float eps_lin,
                                            int steps) {
  for (int step = 0; step < steps; ++step) {
    if (t > t_max) return true;
    const float r = mandelbox_de(mb, ox + t * dx, oy + t * dy, oz + t * dz);
    if (fabsf(r) < nmax(eps_const, eps_abs + eps_lin * t)) return true;
    t = t + r;
  }
  return false;
}

// march.py march / march_pallas._march_kernel for one active ray whose
// first DE is t (already known not to be NaN).
__device__ __forceinline__ float march_ray(const MBox& mb, float ox, float oy,
                                           float oz, float dx, float dy,
                                           float dz, float t, float t_max,
                                           float eps_const, float eps_abs,
                                           float eps_lin, int max_steps,
                                           float relax) {
  if (relax == 1.0f) {
    march_plain(mb, ox, oy, oz, dx, dy, dz, t, t_max, eps_const, eps_abs,
                eps_lin, max_steps);
    return t;
  }
  float t_prev = 0.0f, r_prev = t;
  for (int step = 0; step < max_steps; ++step) {
    const float r = mandelbox_de(mb, ox + t * dx, oy + t * dy, oz + t * dz);
    const bool overshoot = (t - t_prev) > (fabsf(r_prev) + fabsf(r));
    const bool done =
        (fabsf(r) < nmax(eps_const, eps_abs + eps_lin * t)) || (t > t_max);
    if (done && !overshoot) break;
    if (overshoot) {
      t = t_prev + r_prev;
    } else {
      t_prev = t;
      r_prev = r;
      t = t + relax * r;
    }
  }
  return t;
}

__global__ void __launch_bounds__(128) march_kernel(const MarchArgs a) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const float t_max = a.t_max[i];
  if (!a.active[i]) {
    a.t[i] = t_max + 1.0f;
    return;
  }
  const float ox = a.origin[3 * i], oy = a.origin[3 * i + 1],
              oz = a.origin[3 * i + 2];
  const float t0 = mandelbox_de(a.mb, ox, oy, oz);
  if (isnan(t0)) {
    a.t[i] = t0;
    return;
  }
  a.t[i] = march_ray(a.mb, ox, oy, oz, a.direction[3 * i],
                     a.direction[3 * i + 1], a.direction[3 * i + 2], t0,
                     t_max, a.eps_const, a.eps_abs[i], a.eps_lin[i],
                     a.max_steps, a.relax);
}

// Appends the id of every active segment to the queue.
__global__ void __launch_bounds__(128) enqueue_kernel(const EnqueueArgs a) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  enqueue(i < a.n && a.active[i], (int)i, a.count, a.queue);
}

// The SDF verdict of every queued segment start -> end (refill_march).
__global__ void __launch_bounds__(128) occl_march_kernel(
    const OcclMarchArgs a) {
  refill_march(AosSegments{a.start, a.end}, a.q, PlainStep{});
}

__global__ void __launch_bounds__(128) occl_march_relaxed_kernel(
    const OcclMarchArgs a) {
  refill_march(AosSegments{a.start, a.end}, a.q,
               RelaxedStep{a.q.relax, 0.0f, 0.0f});
}

// The two-phase occlusion at split 0: the first-DE entry, then plain
// steps.
__global__ void __launch_bounds__(128) occl_march_first_de_kernel(
    const OcclMarchArgs a) {
  refill_march<AosSegments, PlainStep, true>(AosSegments{a.start, a.end},
                                             a.q, PlainStep{});
}

// march.py march_phase1: t after at most max_steps plain steps, and
// whether the lane resolved (inactive and NaN-entry lanes are).
__global__ void __launch_bounds__(128) march_phase1_kernel(const MarchArgs a) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const float t_max = a.t_max[i];
  if (!a.active[i]) {
    a.t[i] = t_max + 1.0f;
    a.resolved[i] = true;
    return;
  }
  const float ox = a.origin[3 * i], oy = a.origin[3 * i + 1],
              oz = a.origin[3 * i + 2];
  float t = mandelbox_de(a.mb, ox, oy, oz);
  const bool resolved =
      isnan(t) || march_plain(a.mb, ox, oy, oz, a.direction[3 * i],
                              a.direction[3 * i + 1], a.direction[3 * i + 2],
                              t, t_max, a.eps_const, a.eps_abs[i],
                              a.eps_lin[i], a.max_steps);
  a.t[i] = t;
  a.resolved[i] = resolved;
}

// march.py march_resume: thread i finishes lane order[i] from its t.
__global__ void __launch_bounds__(128) march_resume_kernel(const MarchArgs a) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n_order) return;
  const long long j = a.order[i];
  if (j < 0 || j >= a.n || a.resolved[j]) return;
  float t = a.t[j];
  march_plain(a.mb, a.origin[3 * j], a.origin[3 * j + 1], a.origin[3 * j + 2],
              a.direction[3 * j], a.direction[3 * j + 1],
              a.direction[3 * j + 2], t, a.t_max[j], a.eps_const,
              a.eps_abs[j], a.eps_lin[j], a.max_steps);
  a.t[j] = t;
}

}  // namespace rayn

extern "C" cudaError_t rayn_march(const rayn::MarchArgs* args,
                                  cudaStream_t stream) {
  if (args->n <= 0) return cudaSuccess;
  rayn::march_kernel<<<rayn::blocks_of(args->n, 128), 128, 0, stream>>>(
      *args);
  return cudaGetLastError();
}

extern "C" cudaError_t rayn_enqueue(const rayn::EnqueueArgs* args,
                                    cudaStream_t stream) {
  if (args->n <= 0) return cudaSuccess;
  rayn::enqueue_kernel<<<rayn::blocks_of(args->n, 128), 128, 0, stream>>>(
      *args);
  return cudaGetLastError();
}

// Persistent (launch_persistent); the first-DE entry where first_de is
// set, else plain steps at relax 1 and relaxed ones otherwise.
extern "C" cudaError_t rayn_occl_march(const rayn::OcclMarchArgs* args,
                                       cudaStream_t stream) {
  if (args->q.m <= 0) return cudaSuccess;
  return rayn::launch_persistent(args->first_de
                                     ? rayn::occl_march_first_de_kernel
                                 : args->q.relax == 1.0f
                                     ? rayn::occl_march_kernel
                                     : rayn::occl_march_relaxed_kernel,
                                 *args, args->q.m, stream);
}

extern "C" cudaError_t rayn_march_phase1(const rayn::MarchArgs* args,
                                         cudaStream_t stream) {
  if (args->n <= 0) return cudaSuccess;
  rayn::march_phase1_kernel<<<rayn::blocks_of(args->n, 128), 128, 0,
                              stream>>>(*args);
  return cudaGetLastError();
}

extern "C" cudaError_t rayn_march_resume(const rayn::MarchArgs* args,
                                         cudaStream_t stream) {
  if (args->n_order <= 0) return cudaSuccess;
  rayn::march_resume_kernel<<<rayn::blocks_of(args->n_order, 128), 128, 0,
                              stream>>>(*args);
  return cudaGetLastError();
}
