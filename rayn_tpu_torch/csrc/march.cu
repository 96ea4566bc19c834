// Sphere-tracing kernels of the segment-queue bounce for Hopper (sm_90a).
//
// march_kernel replaces rayn_tpu/ops/march_pallas.py march
// (_march_kernel): the closest-hit march of the MandelBox along each ray,
// bounded by its t_max, with the cone threshold max(eps_const, eps_abs +
// eps_lin * t), plain (relax = 1) or over-relaxed (Keinert's overshoot
// test and conservative fallback, frozen t_prev / r_prev).
// march_occlusion_kernel replaces march_pallas.march_occlusion
// (_occl_kernel with _segment_entry): one shadow segment per thread with
// the bounding-sphere clip, plain or over-relaxed.
// march_occlusion_chained_kernel replaces
// march_pallas.march_occlusion_chained (_chained_occl_core): the K
// segments of a ray, marched one after another by one thread; each
// verdict is the relax-1 march_occlusion verdict of that segment.
//
// What bounds them on the H100: float32 ALU. A step is one 12-iteration
// MandelBox DE (~400 flops) and a lane takes up to max_steps of them,
// against 12-40 bytes in and 1-4 bytes out per segment or ray; lanes of a
// warp also march different numbers of steps.
// What the design does about it: one thread per ray or segment, reading
// the [N, 3] / [N] tensors in place; each thread stops the moment its own
// lane resolves (on the TPU a block ran until its slowest lane was done,
// which only decided when the loop stopped, never a result), and
// inactive or entry-resolved lanes evaluate no DE. The TPU's chained
// scheduling and advance groups only packed block iterations; here a
// thread simply walks its K segments in order.
//
// The two-phase kernels replace march_pallas.py's _march_phase1_kernel
// and _march_resume_kernel (march_sorted, march_phased) and
// _occl_phase1_kernel and _occl_resume_kernel (march_occlusion_phased,
// march_occlusion_sorted): phase 1 marches every lane at most a few
// plain steps and writes t1 and whether the lane resolved (the
// occlusion one its verdict too, with no bounding-sphere clip, as on the
// TPU); the resume kernel finishes the unresolved lanes from t1.
// What bounds them: the same float32 ALU, and a warp runs until its
// slowest lane is done. What the design does about it: the caller orders
// the lanes between the phases (a sort by predicted remaining steps, or
// the unresolved lanes first), and thread i of the resume kernel takes
// lane order[i], so a warp holds lanes of like remaining work, and a warp
// of resolved lanes exits at once. The thread reads its lane's inputs
// and t1 where they lie and writes its result back to that lane: one
// indirect load per input instead of the TPU's payload sort of 11-13
// columns and its un-permute. Every lane takes the steps of one uncapped
// march (march_plain and occl_steps round as march_ray and sdf_occluded
// do), so the result is bit-identical to the single-phase kernels.
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

struct OcclArgs {  // ops/march_cuda.py _OcclArgs
  const float* start;  // [M, 3] ([K, N, 3] for the chained kernel)
  const float* end;    // [M, 3]
  const bool* active;  // [M] (not read by the resume kernel)
  bool* occluded;      // [M] out (resume: phase 1's, finished in place)
  float* t1;           // [M] phase 1 out, resume in
  bool* resolved;      // [M] phase 1 out, resume in
  const long long* order;  // [n_order] segments of the resume kernel
  long long n;         // M, or N rays of K segments each
  long long n_order;
  int K;               // segments per ray (chained kernel only)
  int max_steps;
  MBox mb;
  float eps_c, eps_l;  // 1e-4 * detail, 1e-5 * detail
  float relax;
  float bv_r, bv_r2;   // bounding-sphere clip radius (0 = none) and its square
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

// march.py march_occlusion relax branch / march_pallas._occl_kernel body_r
// for one segment: True iff the SDF blocks s->e.
__device__ __forceinline__ bool sdf_occluded_relaxed(
    const MBox& mb, float bv_r, float bv_r2, int max_steps, float eps_c,
    float eps_l, float relax, float sx, float sy, float sz, float ex,
    float ey, float ez) {
  float dx, dy, dz, md, t;
  if (!segment_entry(mb, bv_r, bv_r2, sx, sy, sz, ex, ey, ez, dx, dy, dz, md,
                     t))
    return false;
  float t_prev = 0.0f, r_prev = t;
  for (int step = 0;; ++step) {
    const bool gt_end = t > md;
    const float r = mandelbox_de(mb, sx + t * dx, sy + t * dy, sz + t * dz);
    const bool overshoot = (t - t_prev) > (fabsf(r_prev) + fabsf(r));
    const bool hit = fabsf(r) < nmax(eps_c, eps_l * t) && !overshoot;
    if (hit || gt_end) return hit && !gt_end;
    if (step + 1 >= max_steps) return false;
    if (overshoot) {
      t = t_prev + r_prev;
    } else {
      t_prev = t;
      r_prev = r;
      t = t + relax * r;
    }
  }
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

__device__ __forceinline__ bool occluded_at(const OcclArgs& a, long long j) {
  if (!a.active[j]) return false;
  const float* s = a.start + 3 * j;
  const float* e = a.end + 3 * j;
  if (a.relax == 1.0f)
    return sdf_occluded(a.mb, a.bv_r, a.bv_r2, a.max_steps, a.eps_c, a.eps_l,
                        s[0], s[1], s[2], e[0], e[1], e[2]);
  return sdf_occluded_relaxed(a.mb, a.bv_r, a.bv_r2, a.max_steps, a.eps_c,
                              a.eps_l, a.relax, s[0], s[1], s[2], e[0], e[1],
                              e[2]);
}

__global__ void __launch_bounds__(128)
    march_occlusion_kernel(const OcclArgs a) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= a.n) return;
  a.occluded[j] = occluded_at(a, j);
}

// relax is 1 here (the wrapper sets it): chaining needs the plain march
__global__ void __launch_bounds__(128)
    march_occlusion_chained_kernel(const OcclArgs a) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  for (int k = 0; k < a.K; ++k) {
    const long long j = (long long)k * a.n + i;
    a.occluded[j] = occluded_at(a, j);
  }
}

// The relax-1 occlusion loop of _occl_phase1_kernel / _occl_resume_kernel
// for one segment: at most `steps` steps from t, advanced in place. At
// each, `hit` is set to whether the DE met the threshold, and the segment
// stops when it hit or t is past md.
__device__ __forceinline__ void occl_steps(const MBox& mb, float sx, float sy,
                                           float sz, float dx, float dy,
                                           float dz, float md, float eps_c,
                                           float eps_l, int steps, float& t,
                                           bool& hit) {
  for (int step = 0; step < steps; ++step) {
    const bool gt_end = t > md;
    const float r = mandelbox_de(mb, sx + t * dx, sy + t * dy, sz + t * dz);
    hit = fabsf(r) < nmax(eps_c, eps_l * t);
    if (hit || gt_end) return;
    t = t + r;
  }
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

// march.py occlusion_phase1: the verdict, t and resolved flag of a
// segment after at most max_steps relax-1 steps from its first DE (no
// clip). A segment that takes no step is occluded where that DE is below
// a literal 1e-4 (march_pallas.py:518).
__global__ void __launch_bounds__(128) occl_phase1_kernel(const OcclArgs a) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= a.n) return;
  const float* s = a.start + 3 * j;
  const float* e = a.end + 3 * j;
  float dx, dy, dz, md, t = nan_f();
  bool hit = false, resolved = true;
  if (a.active[j] && segment_entry(a.mb, 0.0f, 0.0f, s[0], s[1], s[2], e[0],
                                   e[1], e[2], dx, dy, dz, md, t)) {
    hit = t < 1e-4f;
    occl_steps(a.mb, s[0], s[1], s[2], dx, dy, dz, md, a.eps_c, a.eps_l,
               a.max_steps, t, hit);
    const bool past = t > md;
    resolved = past || hit;
    hit = hit && !past;
  }
  a.occluded[j] = hit;
  a.t1[j] = t;
  a.resolved[j] = resolved;
}

// march.py occlusion_resume: thread i finishes segment order[i] from t1.
__global__ void __launch_bounds__(128) occl_resume_kernel(const OcclArgs a) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n_order) return;
  const long long j = a.order[i];
  if (j < 0 || j >= a.n || a.resolved[j]) return;
  const float* s = a.start + 3 * j;
  const float* e = a.end + 3 * j;
  float dx, dy, dz, md, t = a.t1[j];
  segment_dir(s[0], s[1], s[2], e[0], e[1], e[2], dx, dy, dz, md);
  bool hit = false;
  occl_steps(a.mb, s[0], s[1], s[2], dx, dy, dz, md, a.eps_c, a.eps_l,
             a.max_steps, t, hit);
  a.occluded[j] = hit && !(t > md);
}

__host__ inline unsigned blocks_of(long long n, int threads) {
  return (unsigned)((n + threads - 1) / threads);
}

}  // namespace rayn

extern "C" cudaError_t rayn_march(const rayn::MarchArgs* args,
                                  cudaStream_t stream) {
  if (args->n <= 0) return cudaSuccess;
  rayn::march_kernel<<<rayn::blocks_of(args->n, 128), 128, 0, stream>>>(
      *args);
  return cudaGetLastError();
}

extern "C" cudaError_t rayn_march_occlusion(const rayn::OcclArgs* args,
                                            cudaStream_t stream) {
  if (args->n <= 0) return cudaSuccess;
  rayn::march_occlusion_kernel<<<rayn::blocks_of(args->n, 128), 128, 0,
                                 stream>>>(*args);
  return cudaGetLastError();
}

extern "C" cudaError_t rayn_march_occlusion_chained(
    const rayn::OcclArgs* args, cudaStream_t stream) {
  if (args->n <= 0 || args->K <= 0) return cudaSuccess;
  rayn::march_occlusion_chained_kernel<<<rayn::blocks_of(args->n, 128), 128,
                                         0, stream>>>(*args);
  return cudaGetLastError();
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

extern "C" cudaError_t rayn_occl_phase1(const rayn::OcclArgs* args,
                                        cudaStream_t stream) {
  if (args->n <= 0) return cudaSuccess;
  rayn::occl_phase1_kernel<<<rayn::blocks_of(args->n, 128), 128, 0,
                             stream>>>(*args);
  return cudaGetLastError();
}

extern "C" cudaError_t rayn_occl_resume(const rayn::OcclArgs* args,
                                        cudaStream_t stream) {
  if (args->n_order <= 0) return cudaSuccess;
  rayn::occl_resume_kernel<<<rayn::blocks_of(args->n_order, 128), 128, 0,
                             stream>>>(*args);
  return cudaGetLastError();
}
