// Fused closest hit + shading info for Hopper (sm_90a).
//
// Replaces rayn_tpu/ops/intersect_pallas.py closest_hit_shading
// (_intersect_kernel): per ray, the closest root over the K spheres, the
// MandelBox march bounded by that running closest t (threshold
// max(eps_const, eps_abs + eps_lin * t), at most max_steps steps), then
// the point, the sphere or tetrahedral normal, the shading offset and the
// material id.
//
// What bounds it on the H100: float32 ALU. A march step is one 12-
// iteration MandelBox DE (~200 flops) and a ray takes up to 256 steps,
// while the ray reads ~40 bytes and writes ~48; warps also diverge,
// because each lane marches its own number of steps.
// What the design does about it: one thread per ray reading the [N,3] /
// [N] tensors in place (the TPU's (8,128) row tiling is gone), each
// thread stops the moment its own ray resolves (the TPU kernel ran a
// block until every lane was done), and inactive lanes skip the march.
// Scene constants (K spheres as [x, y, z, r, mat]) come in as a small
// device buffer that stays in L1.
#include "common.cuh"

namespace rayn {

struct IntersectArgs {
  const float* origin;     // [N, 3]
  const float* direction;  // [N, 3]
  const float* hps_abs;    // [N]
  const float* hps_lin;    // [N]
  const bool* active;      // [N]
  const float* spheres;    // [K, 5]
  float* t;                // [N]
  int* obj;                // [N]
  float* point;            // [N, 3]
  float* normal;           // [N, 3]
  float* offset_by;        // [N]
  int* mat;                // [N]
  long long n;
  int K;
  int has_sdf;
  int sdf_mat;
  int max_steps;
  MBox mb;
  float t_max0;     // 2 * world_radius
  float eps_const;  // 5e-5 * detail
  float eps_k;      // 0.05 * detail
  float detail;
};

__global__ void __launch_bounds__(128)
    closest_hit_kernel(const IntersectArgs a) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const float ox = a.origin[3 * i], oy = a.origin[3 * i + 1],
              oz = a.origin[3 * i + 2];
  const float dx = a.direction[3 * i], dy = a.direction[3 * i + 1],
              dz = a.direction[3 * i + 2];
  const float hps_abs = a.hps_abs[i], hps_lin = a.hps_lin[i];
  const bool active = a.active[i];

  // sphere closest-hit fold (ops/spheres.hit + closest select)
  float best_t = a.t_max0;
  int best_obj = -1;
  for (int k = 0; k < a.K; ++k) {
    const float tk = sphere_hit(ox, oy, oz, dx, dy, dz, a.spheres + 5 * k,
                                a.t_max0);
    if (tk < best_t) {
      best_t = tk;
      best_obj = k;
    }
  }

  // SDF march bounded by the running closest (march_pallas relax=1 body)
  if (a.has_sdf && active) {
    const float t_max = best_t;
    const float eps_abs = a.eps_k * hps_abs, eps_lin = a.eps_k * hps_lin;
    float t = mandelbox_de(a.mb, ox, oy, oz);
    if (!isnan(t)) {
      for (int step = 0; step < a.max_steps; ++step) {
        if (t > t_max) break;
        const float dist = mandelbox_de(a.mb, ox + t * dx, oy + t * dy,
                                        oz + t * dz);
        if (fabsf(dist) < nmax(a.eps_const, eps_abs + eps_lin * t)) break;
        t = t + dist;
      }
      if (t < best_t) {
        best_t = t;
        best_obj = a.K;
      }
    }
  }

  // shading info (ops/intersect.shading_info)
  const float px = ox + best_t * dx, py = oy + best_t * dy,
              pz = oz + best_t * dz;
  float nx = 0.0f, ny = 0.0f, nz = 0.0f, off = 0.0f;
  int mat = 0;
  if (best_obj >= 0 && best_obj < a.K) {
    const float* s = a.spheres + 5 * best_obj;
    const float vx = px - s[0], vy = py - s[1], vz = pz - s[2];
    const float vlen = sqrtf(vx * vx + vy * vy + vz * vz);
    const float vinv = 1.0f / nmax(vlen, 1e-20f);
    nx = vx * vinv;
    ny = vy * vinv;
    nz = vz * vinv;
    mat = (int)s[4];
  } else if (best_obj == a.K) {
    const float hps = nmax(1e-4f, a.detail * (hps_abs + hps_lin * best_t));
    // sdfu normals_fast taps, in ops/sdf.py TETRA_TAPS order
    const float taps[4][3] = {{1.f, -1.f, -1.f}, {-1.f, 1.f, -1.f},
                              {-1.f, -1.f, 1.f}, {1.f, 1.f, 1.f}};
    float gx = 0.0f, gy = 0.0f, gz = 0.0f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float dk = mandelbox_de(a.mb, px + taps[k][0] * hps,
                                    py + taps[k][1] * hps,
                                    pz + taps[k][2] * hps);
      gx = gx + taps[k][0] * dk;
      gy = gy + taps[k][1] * dk;
      gz = gz + taps[k][2] * dk;
    }
    const float glen = sqrtf(gx * gx + gy * gy + gz * gz);
    const float ginv = 1.0f / nmax(glen, 1e-20f);
    nx = gx * ginv;
    ny = gy * ginv;
    nz = gz * ginv;
    mat = a.sdf_mat;
    off = hps;
  }
  a.t[i] = best_t;
  a.obj[i] = best_obj;
  a.point[3 * i] = px;
  a.point[3 * i + 1] = py;
  a.point[3 * i + 2] = pz;
  a.normal[3 * i] = nx;
  a.normal[3 * i + 1] = ny;
  a.normal[3 * i + 2] = nz;
  a.offset_by[i] = off;
  a.mat[i] = mat;
}

}  // namespace rayn

extern "C" cudaError_t rayn_closest_hit(const rayn::IntersectArgs* args,
                                        cudaStream_t stream) {
  if (args->n <= 0) return cudaSuccess;
  const int threads = 128;
  const long long blocks = (args->n + threads - 1) / threads;
  rayn::closest_hit_kernel<<<(unsigned)blocks, threads, 0, stream>>>(*args);
  return cudaGetLastError();
}
