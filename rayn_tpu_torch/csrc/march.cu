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
#include "common.cuh"

namespace rayn {

struct MarchArgs {  // ops/march_cuda.py _MarchArgs
  const float* origin;     // [N, 3]
  const float* direction;  // [N, 3]
  const float* t_max;      // [N]
  const float* eps_abs;    // [N]
  const float* eps_lin;    // [N]
  const bool* active;      // [N]
  float* t;                // [N]
  long long n;
  int max_steps;
  MBox mb;
  float eps_const;
  float relax;
};

struct OcclArgs {  // ops/march_cuda.py _OcclArgs
  const float* start;  // [M, 3] ([K, N, 3] for the chained kernel)
  const float* end;    // [M, 3]
  const bool* active;  // [M]
  bool* occluded;      // [M]
  long long n;         // M, or N rays of K segments each
  int K;               // segments per ray (chained kernel only)
  int max_steps;
  MBox mb;
  float eps_c, eps_l;  // 1e-4 * detail, 1e-5 * detail
  float relax;
  float bv_r, bv_r2;   // bounding-sphere clip radius (0 = none) and its square
};

// march.py march / march_pallas._march_kernel for one active ray whose
// first DE is t (already known not to be NaN).
__device__ __forceinline__ float march_ray(const MBox& mb, float ox, float oy,
                                           float oz, float dx, float dy,
                                           float dz, float t, float t_max,
                                           float eps_const, float eps_abs,
                                           float eps_lin, int max_steps,
                                           float relax) {
  if (relax == 1.0f) {
    for (int step = 0; step < max_steps; ++step) {
      if (t > t_max) break;
      const float r = mandelbox_de(mb, ox + t * dx, oy + t * dy, oz + t * dz);
      if (fabsf(r) < nmax(eps_const, eps_abs + eps_lin * t)) break;
      t = t + r;
    }
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
