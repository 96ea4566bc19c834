// Fused bounce tail and shadow sort key for Hopper (sm_90a).
//
// bounce_tail_kernel replaces rayn_tpu/ops/shade_pallas.py
// bounce_tail_fused (_bounce_tail_kernel = _shadow_delta + _finish_tail,
// inlining march_pallas._segment_entry and _chained_occl_core). Per ray:
// L NEE light picks with cone samples, the BSDF, and VM*L equi-angular
// volume sites (distances and pdfs come in precomputed); each segment is
// tested against the spheres and marched through the MandelBox with the
// bounding-sphere clip; the radiance delta is accumulated in the JAX
// segment order (NEE 0..L-1, then volume sites march-major); then
// emission, BSDF scatter, Russian roulette, the depth-0 AOVs and
// termination write the next PathState.
//
// shadow_sort_key_kernel replaces shade_pallas.shadow_sort_key
// (_shadow_key_kernel -> _shadow_cost_key -> _segment_cost): the same
// segments, each priced at min(length / first DE, max_steps).
//
// What bounds them on the H100: float32 ALU and warp divergence. A ray
// marches up to 12 shadow segments of up to max_vis_marches MandelBox DEs
// each (~200 flops per DE), against ~60 floats of memory traffic per ray
// per bounce, and lanes of a warp march different numbers of steps.
// What the design does about it: one thread per ray; the segments are
// built and marched one after another inside the thread, so only one
// segment's registers are live at a time (register pressure is the main
// risk of a kernel this long; the TPU's chained scheduling, which only
// changed block iteration counts and never a verdict, is not carried
// over). A segment whose contribution is zero or that a sphere blocks is
// never marched. Scene constants (lights [NL, 8], spheres [K, 4]) come in
// as a small device buffer that stays in L1. The host sorts rays by the
// sort key in chunks so that warps hold rays of similar cost.
#include "common.cuh"

namespace rayn {

struct ShadowScalars {  // ops/shade_cuda.py _ShadowScalars
  Sampler smp;
  MBox mb;
  int L, VM, NL, K;
  int has_ext, has_sdf;
  int max_steps;
  float bv_r, bv_r2;
  float eps_c, eps_l;
  float correction, vm_correction;
  float sigma_t, sigma_s;
  int compat_reflect, compat_phi;
  int set_fres, set_diff, set_spec, set_rr;
  int roulette_on, terminate_all, aov;
  // set ids of site i are base + i (utils/rng.py layout; volume sites
  // march-major); bases, not arrays, so no kernel-parameter array is
  // indexed at run time
  int set_pick0, set_nee0, set_vol_pick0, set_vol0;
};

struct TailArgs {  // ops/shade_cuda.py _TailArgs
  const float *point, *normal, *offset_by, *origin, *direction, *throughput,
      *vol_trans;
  const int* kind;
  const float *color_a, *color_b, *power, *ior;
  const int *sample_idx, *pixel;
  const bool *live, *recv;
  const float *radiance, *color_out, *bg_out, *alpha_out, *normal_out,
      *prev_pdf;
  const float *vol_dist, *vol_pdf;  // [VM*L, N]
  const float *lights, *spheres;
  float *o_origin, *o_direction, *o_throughput, *o_radiance;
  bool* o_alive;
  float *o_prev_pdf, *o_color_out, *o_bg_out, *o_alpha_out, *o_normal_out;
  long long n;
  ShadowScalars sc;
};

struct KeyArgs {  // ops/shade_cuda.py _KeyArgs
  const float *point, *normal, *offset_by, *origin, *direction;
  const int *sample_idx, *pixel;
  const bool *live, *recv;
  const float* vol_dist;
  const float* lights;
  float* key;
  long long n;
  ShadowScalars sc;
};

// Light pick + cone sample of NEE site i from point p (shade_pallas
// _shadow_delta / _shadow_cost_key, shared so both price one segment).
__device__ __forceinline__ int nee_site(const ShadowScalars& sc,
                                        const float* __restrict__ lights,
                                        int i, uint32_t sidx, uint32_t pix,
                                        float px, float py, float pz,
                                        float& ex, float& ey, float& ez,
                                        float& pdf) {
  const int l =
      pick_light(sample_1d(sc.smp, sc.set_pick0 + i, sidx, pix), sc.NL);
  const float* lr = lights + 8 * l;
  float u1, u2;
  sample_2d(sc.smp, sc.set_nee0 + i, sidx, pix, u1, u2);
  sample_cone(u1, u2, lr[0], lr[1], lr[2], lr[3], px, py, pz, ex, ey, ez,
              pdf);
  return l;
}

// Light pick + scatter point + cone sample of volume site j.
__device__ __forceinline__ int vol_site(const ShadowScalars& sc,
                                        const float* __restrict__ lights,
                                        int j, uint32_t sidx, uint32_t pix,
                                        float vd, float ox, float oy, float oz,
                                        float dx, float dy, float dz,
                                        float& spx, float& spy, float& spz,
                                        float& ex, float& ey, float& ez,
                                        float& pdf) {
  const int l =
      pick_light(sample_1d(sc.smp, sc.set_vol_pick0 + j, sidx, pix), sc.NL);
  const float* lr = lights + 8 * l;
  spx = ox + vd * dx;
  spy = oy + vd * dy;
  spz = oz + vd * dz;
  float u1, u2;
  sample_2d(sc.smp, sc.set_vol0 + j, sidx, pix, u1, u2);
  sample_cone(u1, u2, lr[0], lr[1], lr[2], lr[3], spx, spy, spz, ex, ey, ez,
              pdf);
  return l;
}

__device__ __forceinline__ float3 ld3(const float* p, long long i) {
  return make_float3(p[3 * i], p[3 * i + 1], p[3 * i + 2]);
}

__device__ __forceinline__ void st3(float* p, long long i, float x, float y,
                                    float z) {
  p[3 * i] = x;
  p[3 * i + 1] = y;
  p[3 * i + 2] = z;
}

__global__ void __launch_bounds__(128)
    bounce_tail_kernel(const TailArgs a) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const ShadowScalars& sc = a.sc;
  const float3 p = ld3(a.point, i), nrm = ld3(a.normal, i);
  const float3 o = ld3(a.origin, i), d = ld3(a.direction, i);
  const float3 tp = ld3(a.throughput, i);
  const float off = a.offset_by[i], vtr = a.vol_trans[i];
  const int kind = a.kind[i];
  const float3 ca = ld3(a.color_a, i);
  const float pw = a.power[i];
  const uint32_t sidx = (uint32_t)a.sample_idx[i], pix = (uint32_t)a.pixel[i];
  const bool alive = a.live[i], receives = a.recv[i];
  const float wox = -d.x, woy = -d.y, woz = -d.z;

  // --- steps 3 + 4: NEE and volume single scattering (_shadow_delta) ---
  float rad_r = 0.0f, rad_g = 0.0f, rad_b = 0.0f;
  for (int s = 0; s < sc.L; ++s) {
    float ex, ey, ez, pdf;
    const int l = nee_site(sc, a.lights, s, sidx, pix, p.x, p.y, p.z, ex, ey,
                           ez, pdf);
    const float* lr = a.lights + 8 * l;
    const float wfx = ex - p.x, wfy = ey - p.y, wfz = ez - p.z;
    const float dist = sqrtf(wfx * wfx + wfy * wfy + wfz * wfz);
    const float dinv = 1.0f / dist;
    const float wix = wfx * dinv, wiy = wfy * dinv, wiz = wfz * dinv;
    const float ndw = nrm.x * wix + nrm.y * wiy + nrm.z * wiz;
    const float bias = signbit(ndw) ? -off : off;
    const float sx = p.x + nrm.x * bias, sy = p.y + nrm.y * bias,
                sz = p.z + nrm.z * bias;
    float fr, fg, fb;
    eval_f(kind, ca.x, ca.y, ca.z, pw, wox, woy, woz, wix, wiy, wiz, nrm.x,
           nrm.y, nrm.z, fr, fg, fb);
    const float ndl = nmax(0.0f, ndw);
    const float seg_trans = sc.has_ext ? expf(-sc.sigma_t * dist) : 1.0f;
    const float scale = (seg_trans / pdf) * (sc.correction * vtr);
    const float kr = receives ? lr[4] * fr * ndl * scale * tp.x : 0.0f;
    const float kg = receives ? lr[5] * fg * ndl * scale * tp.y : 0.0f;
    const float kb = receives ? lr[6] * fb * ndl * scale * tp.z : 0.0f;
    const bool worth = receives && (kr != 0.0f || kg != 0.0f || kb != 0.0f);
    bool vis = worth && !sphere_occluded(a.spheres, sc.K, sx, sy, sz, ex, ey,
                                         ez);
    if (vis && sc.has_sdf)
      vis = !sdf_occluded(sc.mb, sc.bv_r, sc.bv_r2, sc.max_steps, sc.eps_c,
                          sc.eps_l, sx, sy, sz, ex, ey, ez);
    const float v = vis ? 1.0f : 0.0f;
    rad_r = rad_r + kr * v;
    rad_g = rad_g + kg * v;
    rad_b = rad_b + kb * v;
  }
  for (int j = 0; j < sc.VM * sc.L; ++j) {
    const float vd = a.vol_dist[(long long)j * a.n + i];
    const float vp = a.vol_pdf[(long long)j * a.n + i];
    float spx, spy, spz, ex, ey, ez, light_pdf;
    const int l = vol_site(sc, a.lights, j, sidx, pix, vd, o.x, o.y, o.z,
                           d.x, d.y, d.z, spx, spy, spz, ex, ey, ez,
                           light_pdf);
    const float* lr = a.lights + 8 * l;
    const float sgx = ex - spx, sgy = ey - spy, sgz = ez - spz;
    const float dist_pl = sqrtf(sgx * sgx + sgy * sgy + sgz * sgz);
    const float seg_trans = sc.has_ext ? expf(-sc.sigma_t * dist_pl) : 1.0f;
    const float to_point = sc.has_ext ? expf(-sc.sigma_t * vd) : 1.0f;
    const float scale = INV_4PI_F * seg_trans / (vp * light_pdf) *
                        sc.vm_correction * sc.sigma_s * to_point;
    const float kr = alive ? lr[4] * scale * tp.x : 0.0f;
    const float kg = alive ? lr[5] * scale * tp.y : 0.0f;
    const float kb = alive ? lr[6] * scale * tp.z : 0.0f;
    const bool worth = alive && (kr != 0.0f || kg != 0.0f || kb != 0.0f);
    bool vis = worth && !sphere_occluded(a.spheres, sc.K, spx, spy, spz, ex,
                                         ey, ez);
    if (vis && sc.has_sdf)
      vis = !sdf_occluded(sc.mb, sc.bv_r, sc.bv_r2, sc.max_steps, sc.eps_c,
                          sc.eps_l, spx, spy, spz, ex, ey, ez);
    const float v = vis ? 1.0f : 0.0f;
    rad_r = rad_r + kr * v;
    rad_g = rad_g + kg * v;
    rad_b = rad_b + kb * v;
  }

  // --- step 2: emission, after the shadow delta (_finish_tail) ---
  const float3 cb = ld3(a.color_b, i);
  const float3 rin = ld3(a.radiance, i);
  rad_r = rin.x + rad_r;
  rad_g = rin.y + rad_g;
  rad_b = rin.z + rad_b;
  const float t_sky = 0.5f * (woy + 1.0f);
  float le_r = 0.0f, le_g = 0.0f, le_b = 0.0f;
  if (kind == 2) {  // Sky
    le_r = ca.x * (1.0f - t_sky) + cb.x * t_sky;
    le_g = ca.y * (1.0f - t_sky) + cb.y * t_sky;
    le_b = ca.z * (1.0f - t_sky) + cb.z * t_sky;
  } else if (kind == 3) {  // Emissive
    le_r = cb.x;
    le_g = cb.y;
    le_b = cb.z;
  }
  rad_r = rad_r + (alive ? le_r * tp.x * vtr : 0.0f);
  rad_g = rad_g + (alive ? le_g * tp.y * vtr : 0.0f);
  rad_b = rad_b + (alive ? le_b * tp.z * vtr : 0.0f);

  // --- step 5: scatter, throughput, roulette ---
  const float u_f = sample_1d(sc.smp, sc.set_fres, sidx, pix);
  float u_d1, u_d2, u_s1, u_s2;
  sample_2d(sc.smp, sc.set_diff, sidx, pix, u_d1, u_d2);
  sample_2d(sc.smp, sc.set_spec, sidx, pix, u_s1, u_s2);
  float wix, wiy, wiz, f_r, f_g, f_b, pdf;
  scatter(sc.compat_reflect, sc.compat_phi, kind, ca.x, ca.y, ca.z, pw,
          a.ior[i], wox, woy, woz, nrm.x, nrm.y, nrm.z, u_f, u_d1, u_d2, u_s1,
          u_s2, wix, wiy, wiz, f_r, f_g, f_b, pdf);
  const float ndl = fabsf(wix * nrm.x + wiy * nrm.y + wiz * nrm.z);
  const float scale = vtr * (ndl / pdf);
  float ntp_x = tp.x * scale * f_r, ntp_y = tp.y * scale * f_g,
        ntp_z = tp.z * scale * f_b;
  const float max_tp = nmax(tp.x, nmax(tp.y, tp.z));
  const float roulette = sc.roulette_on ? nmax(1.0f - max_tp, 0.05f) : 0.0f;
  const float inv_keep = 1.0f / (1.0f - roulette);
  ntp_x = ntp_x * inv_keep;
  ntp_y = ntp_y * inv_keep;
  ntp_z = ntp_z * inv_keep;
  const float u_r = sample_1d(sc.smp, sc.set_rr, sidx, pix);
  const bool terminate = sc.terminate_all || (u_r < roulette);

  // --- steps 6 + 7: depth-0 AOVs and termination bookkeeping ---
  const bool aov_set = sc.aov && receives;
  a.o_alpha_out[i] = aov_set ? 1.0f : a.alpha_out[i];
  const float3 no = ld3(a.normal_out, i);
  if (aov_set)
    st3(a.o_normal_out, i, nrm.x, nrm.y, nrm.z);
  else
    st3(a.o_normal_out, i, no.x, no.y, no.z);
  const bool non_recv = alive && !receives;
  const float3 bg = ld3(a.bg_out, i);
  if (sc.aov && non_recv)
    st3(a.o_bg_out, i, rad_r, rad_g, rad_b);
  else
    st3(a.o_bg_out, i, bg.x, bg.y, bg.z);
  const float3 co = ld3(a.color_out, i);
  if ((!sc.aov && non_recv) || (receives && terminate))
    st3(a.o_color_out, i, rad_r, rad_g, rad_b);
  else
    st3(a.o_color_out, i, co.x, co.y, co.z);
  st3(a.o_radiance, i, rad_r, rad_g, rad_b);

  const bool survive = receives && !terminate;
  a.o_alive[i] = survive;
  if (survive) {
    const float ndw = nrm.x * wix + nrm.y * wiy + nrm.z * wiz;
    const float bias = signbit(ndw) ? -off : off;
    st3(a.o_origin, i, p.x + nrm.x * bias, p.y + nrm.y * bias,
        p.z + nrm.z * bias);
    st3(a.o_direction, i, wix, wiy, wiz);
    const bool tp_nan = isnan(ntp_x) || isnan(ntp_y) || isnan(ntp_z);
    if (tp_nan)
      st3(a.o_throughput, i, tp.x, tp.y, tp.z);
    else
      st3(a.o_throughput, i, ntp_x, ntp_y, ntp_z);
    a.o_prev_pdf[i] = kind == 5 ? -1.0f : pdf;
  } else {
    st3(a.o_origin, i, o.x, o.y, o.z);
    st3(a.o_direction, i, d.x, d.y, d.z);
    st3(a.o_throughput, i, tp.x, tp.y, tp.z);
    a.o_prev_pdf[i] = a.prev_pdf[i];
  }
}

__global__ void __launch_bounds__(128)
    shadow_sort_key_kernel(const KeyArgs a) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const ShadowScalars& sc = a.sc;
  float key = 0.0f;
  if (sc.has_sdf) {
    const float3 p = ld3(a.point, i), nrm = ld3(a.normal, i);
    const float off = a.offset_by[i];
    const uint32_t sidx = (uint32_t)a.sample_idx[i],
                   pix = (uint32_t)a.pixel[i];
    const bool alive = a.live[i], receives = a.recv[i];
    for (int s = 0; s < sc.L; ++s) {
      float ex, ey, ez, pdf;
      nee_site(sc, a.lights, s, sidx, pix, p.x, p.y, p.z, ex, ey, ez, pdf);
      const float wfx = ex - p.x, wfy = ey - p.y, wfz = ez - p.z;
      const float dist = sqrtf(wfx * wfx + wfy * wfy + wfz * wfz);
      const float dinv = 1.0f / dist;
      const float ndw =
          nrm.x * wfx * dinv + nrm.y * wfy * dinv + nrm.z * wfz * dinv;
      const float bias = signbit(ndw) ? -off : off;
      key = key + segment_cost(sc.mb, sc.bv_r, sc.bv_r2, sc.max_steps,
                               receives && ndw > 0.0f, p.x + nrm.x * bias,
                               p.y + nrm.y * bias, p.z + nrm.z * bias, ex, ey,
                               ez);
    }
    const float3 o = ld3(a.origin, i), d = ld3(a.direction, i);
    for (int j = 0; j < sc.VM * sc.L; ++j) {
      const float vd = a.vol_dist[(long long)j * a.n + i];
      float spx, spy, spz, ex, ey, ez, pdf;
      vol_site(sc, a.lights, j, sidx, pix, vd, o.x, o.y, o.z, d.x, d.y,
               d.z, spx, spy, spz, ex, ey, ez, pdf);
      key = key + segment_cost(sc.mb, sc.bv_r, sc.bv_r2, sc.max_steps,
                               alive, spx, spy, spz, ex, ey, ez);
    }
  }
  a.key[i] = key;
}

}  // namespace rayn

extern "C" cudaError_t rayn_bounce_tail(const rayn::TailArgs* args,
                                        cudaStream_t stream) {
  if (args->n <= 0) return cudaSuccess;
  const int threads = 128;
  const long long blocks = (args->n + threads - 1) / threads;
  rayn::bounce_tail_kernel<<<(unsigned)blocks, threads, 0, stream>>>(*args);
  return cudaGetLastError();
}

extern "C" cudaError_t rayn_shadow_sort_key(const rayn::KeyArgs* args,
                                            cudaStream_t stream) {
  if (args->n <= 0) return cudaSuccess;
  const int threads = 128;
  const long long blocks = (args->n + threads - 1) / threads;
  rayn::shadow_sort_key_kernel<<<(unsigned)blocks, threads, 0, stream>>>(
      *args);
  return cudaGetLastError();
}
