// Bounce tail, its two halves, and the shadow sort key for Hopper (sm_90a).
//
// Three kernels share two __device__ bodies, as the Pallas kernels of
// rayn_tpu/ops/shade_pallas.py share _shadow_delta and _finish_tail:
// - shadow_radiance_kernel replaces shadow_radiance (_shadow_kernel ->
//   _shadow_delta, inlining march_pallas._segment_entry and
//   _chained_occl_core): per ray, L NEE light picks with cone samples, the
//   BSDF, the NEE MIS weight of paired lights, and VM*L equi-angular volume
//   sites (distances and pdfs come in precomputed); each segment is tested
//   against the spheres and marched through the MandelBox with the
//   bounding-sphere clip; the radiance delta [N, 3] is accumulated in the
//   JAX segment order (NEE 0..L-1, then volume sites march-major).
// - finish_bounce_kernel replaces finish_bounce_fused (_finish_kernel ->
//   _finish_tail): emission with its MIS weight, BSDF scatter, Russian
//   roulette, the depth-0 AOVs and termination write the next PathState
//   from the pre-emission radiance.
// - bounce_tail_kernel replaces bounce_tail_fused (_bounce_tail_kernel):
//   shadow_delta, then finish_tail on (state radiance + delta), with the
//   delta kept in registers.
//
// shadow_sort_key_kernel replaces shade_pallas.shadow_sort_key
// (_shadow_key_kernel -> _shadow_cost_key -> _segment_cost): the same
// segments, each priced at min(length / first DE, max_steps).
//
// What bounds them on the H100: float32 ALU and warp divergence. A ray
// marches up to 12 shadow segments of up to max_vis_marches MandelBox DEs
// each (~400 flops per DE), against ~60 floats of memory traffic per ray
// per bounce, and lanes of a warp march different numbers of steps. The
// finish half alone is loop-free and bound by its ~64 columns of traffic.
// What the design does about it: one thread per ray; the segments are
// built and marched one after another inside the thread, so only one
// segment's registers are live at a time (register pressure is the main
// risk of a kernel this long; the TPU's chained scheduling, which only
// changed block iteration counts and never a verdict, is not carried
// over). A segment whose weighted contribution is zero or that a sphere
// blocks is never marched. Scene constants (lights [NL, 8], spheres
// [K, 4], the per-sphere MIS table [K, 5]) come in as small device
// buffers that stay in L1. The host sorts rays by the sort key in chunks
// so that warps hold rays of similar cost.
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
  // MIS: weight NEE of paired lights (mis); weight BSDF-hit emission of
  // paired spheres at this depth (mis_on = mis, depth > 0, K and NL > 0)
  int mis, mis_on;
  // set ids of site i are base + i (utils/rng.py layout; volume sites
  // march-major); bases, not arrays, so no kernel-parameter array is
  // indexed at run time
  int set_pick0, set_nee0, set_vol_pick0, set_vol0;
};

struct RayCols {  // ops/shade_cuda.py _RayCols: read by every tail kernel
  const float *point, *normal, *offset_by, *origin, *direction, *throughput,
      *vol_trans;
  const int* kind;
  const float *color_a, *power;
  const int *sample_idx, *pixel;
  const bool *live, *recv;
};

struct ShadowCols {  // ops/shade_cuda.py _ShadowCols
  const float *vol_dist, *vol_pdf;  // [VM*L, N]
  const float *lights, *spheres;    // [NL, 8], [K, 4]
};

struct FinishCols {  // ops/shade_cuda.py _FinishCols
  const float *color_b, *ior;
  // [N, 3]: the state radiance (bounce tail) or the pre-emission radiance
  // (finish kernel)
  const float* radiance;
  const float *color_out, *bg_out, *alpha_out, *normal_out, *prev_pdf;
  const int* obj;
  const float* mis;  // [K, 5]: paired flag, light radius, light position
  float *o_origin, *o_direction, *o_throughput, *o_radiance;
  bool* o_alive;
  float *o_prev_pdf, *o_color_out, *o_bg_out, *o_alpha_out, *o_normal_out;
};

struct TailArgs {  // ops/shade_cuda.py _TailArgs
  RayCols r;
  ShadowCols s;
  FinishCols f;
  long long n;
  ShadowScalars sc;
};

struct ShadowArgs {  // ops/shade_cuda.py _ShadowArgs
  RayCols r;
  ShadowCols s;
  float* o_delta;  // [N, 3]
  long long n;
  ShadowScalars sc;
};

struct FinishArgs {  // ops/shade_cuda.py _FinishArgs
  RayCols r;
  FinishCols f;
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

// One ray's values of the columns every tail reads.
struct Ray {
  float3 p, nrm, o, d, tp, ca;
  float off, vtr, pw;
  int kind;
  uint32_t sidx, pix;
  bool alive, receives;
};

__device__ __forceinline__ Ray load_ray(const RayCols& c, long long i) {
  Ray r;
  r.p = ld3(c.point, i);
  r.nrm = ld3(c.normal, i);
  r.o = ld3(c.origin, i);
  r.d = ld3(c.direction, i);
  r.tp = ld3(c.throughput, i);
  r.off = c.offset_by[i];
  r.vtr = c.vol_trans[i];
  r.kind = c.kind[i];
  r.ca = ld3(c.color_a, i);
  r.pw = c.power[i];
  r.sidx = (uint32_t)c.sample_idx[i];
  r.pix = (uint32_t)c.pixel[i];
  r.alive = c.live[i];
  r.receives = c.recv[i];
  return r;
}

// Steps 3 + 4 of a bounce (shade_pallas._shadow_delta): the radiance
// delta of the NEE and volume single-scattering segments.
__device__ __forceinline__ void shadow_delta(const ShadowScalars& sc,
                                             const ShadowCols& s, long long n,
                                             long long i, const Ray& r,
                                             float& rad_r, float& rad_g,
                                             float& rad_b) {
  const float3 p = r.p, nrm = r.nrm, tp = r.tp;
  const float wox = -r.d.x, woy = -r.d.y, woz = -r.d.z;
  rad_r = 0.0f;
  rad_g = 0.0f;
  rad_b = 0.0f;
  for (int j = 0; j < sc.L; ++j) {
    float ex, ey, ez, pdf;
    const int l = nee_site(sc, s.lights, j, r.sidx, r.pix, p.x, p.y, p.z, ex,
                           ey, ez, pdf);
    const float* lr = s.lights + 8 * l;
    const float wfx = ex - p.x, wfy = ey - p.y, wfz = ez - p.z;
    const float dist = sqrtf(wfx * wfx + wfy * wfy + wfz * wfz);
    const float dinv = 1.0f / dist;
    const float wix = wfx * dinv, wiy = wfy * dinv, wiz = wfz * dinv;
    const float ndw = nrm.x * wix + nrm.y * wiy + nrm.z * wiz;
    const float bias = signbit(ndw) ? -r.off : r.off;
    const float sx = p.x + nrm.x * bias, sy = p.y + nrm.y * bias,
                sz = p.z + nrm.z * bias;
    float fr, fg, fb;
    eval_f(r.kind, r.ca.x, r.ca.y, r.ca.z, r.pw, wox, woy, woz, wix, wiy, wiz,
           nrm.x, nrm.y, nrm.z, fr, fg, fb);
    const float ndl = nmax(0.0f, ndw);
    const float seg_trans = sc.has_ext ? expf(-sc.sigma_t * dist) : 1.0f;
    const float scale = (seg_trans / pdf) * (sc.correction * r.vtr);
    float kr = r.receives ? lr[4] * fr * ndl * scale * tp.x : 0.0f;
    float kg = r.receives ? lr[5] * fg * ndl * scale * tp.y : 0.0f;
    float kb = r.receives ? lr[6] * fb * ndl * scale * tp.z : 0.0f;
    if (sc.mis && lr[7] > 0.0f) {
      // NEE of a paired light, weighted against the BSDF strategy
      const float p_bsdf =
          eval_pdf(sc.compat_reflect, r.kind, r.pw, wox, woy, woz, wix, wiy,
                   wiz, nrm.x, nrm.y, nrm.z);
      const float w =
          power_heuristic((float)sc.L, pdf / (float)sc.NL, 1.0f, p_bsdf);
      kr = kr * w;
      kg = kg * w;
      kb = kb * w;
    }
    const bool worth =
        r.receives && (kr != 0.0f || kg != 0.0f || kb != 0.0f);
    bool vis = worth && !sphere_occluded(s.spheres, sc.K, sx, sy, sz, ex, ey,
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
    const float vd = s.vol_dist[(long long)j * n + i];
    const float vp = s.vol_pdf[(long long)j * n + i];
    float spx, spy, spz, ex, ey, ez, light_pdf;
    const int l = vol_site(sc, s.lights, j, r.sidx, r.pix, vd, r.o.x, r.o.y,
                           r.o.z, r.d.x, r.d.y, r.d.z, spx, spy, spz, ex, ey,
                           ez, light_pdf);
    const float* lr = s.lights + 8 * l;
    const float sgx = ex - spx, sgy = ey - spy, sgz = ez - spz;
    const float dist_pl = sqrtf(sgx * sgx + sgy * sgy + sgz * sgz);
    const float seg_trans = sc.has_ext ? expf(-sc.sigma_t * dist_pl) : 1.0f;
    const float to_point = sc.has_ext ? expf(-sc.sigma_t * vd) : 1.0f;
    const float scale = INV_4PI_F * seg_trans / (vp * light_pdf) *
                        sc.vm_correction * sc.sigma_s * to_point;
    const float kr = r.alive ? lr[4] * scale * tp.x : 0.0f;
    const float kg = r.alive ? lr[5] * scale * tp.y : 0.0f;
    const float kb = r.alive ? lr[6] * scale * tp.z : 0.0f;
    const bool worth = r.alive && (kr != 0.0f || kg != 0.0f || kb != 0.0f);
    bool vis = worth && !sphere_occluded(s.spheres, sc.K, spx, spy, spz, ex,
                                         ey, ez);
    if (vis && sc.has_sdf)
      vis = !sdf_occluded(sc.mb, sc.bv_r, sc.bv_r2, sc.max_steps, sc.eps_c,
                          sc.eps_l, spx, spy, spz, ex, ey, ez);
    const float v = vis ? 1.0f : 0.0f;
    rad_r = rad_r + kr * v;
    rad_g = rad_g + kg * v;
    rad_b = rad_b + kb * v;
  }
}

// Steps 2 and 5-7 of a bounce (shade_pallas._finish_tail) from the
// pre-emission radiance rad_*: emission with its MIS weight, scatter,
// roulette, the depth-0 AOVs and termination; writes the next PathState.
__device__ __forceinline__ void finish_tail(const ShadowScalars& sc,
                                            const FinishCols& f, long long i,
                                            const Ray& r, float rad_r,
                                            float rad_g, float rad_b) {
  const float3 p = r.p, nrm = r.nrm, o = r.o, d = r.d, tp = r.tp, ca = r.ca;
  const float wox = -d.x, woy = -d.y, woz = -d.z;
  const int kind = r.kind;
  const float3 cb = ld3(f.color_b, i);
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
  if (sc.mis_on) {
    // BSDF-hit emission of a sphere paired with a light, weighted against
    // the NEE strategy that could have sampled it from the previous vertex
    const int obj = f.obj[i];
    const float ppdf = f.prev_pdf[i];
    if (obj >= 0 && obj < sc.K && f.mis[5 * obj] > 0.0f && ppdf >= 0.0f) {
      const float* m = f.mis + 5 * obj;
      const float dlx = m[2] - o.x, dly = m[3] - o.y, dlz = m[4] - o.z;
      const float d2 = dlx * dlx + dly * dly + dlz * dlz;
      const float cos_theta_max = sqrtf(nmax(0.0f, 1.0f - m[1] * m[1] / d2));
      const float q =
          1.0f / (TWO_PI_F * (1.0f - cos_theta_max)) / (float)sc.NL;
      const float w = power_heuristic(1.0f, ppdf, (float)sc.L, q);
      le_r = le_r * w;
      le_g = le_g * w;
      le_b = le_b * w;
    }
  }
  rad_r = rad_r + (r.alive ? le_r * tp.x * r.vtr : 0.0f);
  rad_g = rad_g + (r.alive ? le_g * tp.y * r.vtr : 0.0f);
  rad_b = rad_b + (r.alive ? le_b * tp.z * r.vtr : 0.0f);

  // --- step 5: scatter, throughput, roulette ---
  const float u_f = sample_1d(sc.smp, sc.set_fres, r.sidx, r.pix);
  float u_d1, u_d2, u_s1, u_s2;
  sample_2d(sc.smp, sc.set_diff, r.sidx, r.pix, u_d1, u_d2);
  sample_2d(sc.smp, sc.set_spec, r.sidx, r.pix, u_s1, u_s2);
  float wix, wiy, wiz, f_r, f_g, f_b, pdf;
  scatter(sc.compat_reflect, sc.compat_phi, kind, ca.x, ca.y, ca.z, r.pw,
          f.ior[i], wox, woy, woz, nrm.x, nrm.y, nrm.z, u_f, u_d1, u_d2, u_s1,
          u_s2, wix, wiy, wiz, f_r, f_g, f_b, pdf);
  const float ndl = fabsf(wix * nrm.x + wiy * nrm.y + wiz * nrm.z);
  const float scale = r.vtr * (ndl / pdf);
  float ntp_x = tp.x * scale * f_r, ntp_y = tp.y * scale * f_g,
        ntp_z = tp.z * scale * f_b;
  const float max_tp = nmax(tp.x, nmax(tp.y, tp.z));
  const float roulette = sc.roulette_on ? nmax(1.0f - max_tp, 0.05f) : 0.0f;
  const float inv_keep = 1.0f / (1.0f - roulette);
  ntp_x = ntp_x * inv_keep;
  ntp_y = ntp_y * inv_keep;
  ntp_z = ntp_z * inv_keep;
  const float u_r = sample_1d(sc.smp, sc.set_rr, r.sidx, r.pix);
  const bool terminate = sc.terminate_all || (u_r < roulette);

  // --- steps 6 + 7: depth-0 AOVs and termination bookkeeping ---
  const bool receives = r.receives;
  const bool aov_set = sc.aov && receives;
  f.o_alpha_out[i] = aov_set ? 1.0f : f.alpha_out[i];
  const float3 no = ld3(f.normal_out, i);
  if (aov_set)
    st3(f.o_normal_out, i, nrm.x, nrm.y, nrm.z);
  else
    st3(f.o_normal_out, i, no.x, no.y, no.z);
  const bool non_recv = r.alive && !receives;
  const float3 bg = ld3(f.bg_out, i);
  if (sc.aov && non_recv)
    st3(f.o_bg_out, i, rad_r, rad_g, rad_b);
  else
    st3(f.o_bg_out, i, bg.x, bg.y, bg.z);
  const float3 co = ld3(f.color_out, i);
  if ((!sc.aov && non_recv) || (receives && terminate))
    st3(f.o_color_out, i, rad_r, rad_g, rad_b);
  else
    st3(f.o_color_out, i, co.x, co.y, co.z);
  st3(f.o_radiance, i, rad_r, rad_g, rad_b);

  const bool survive = receives && !terminate;
  f.o_alive[i] = survive;
  if (survive) {
    const float ndw = nrm.x * wix + nrm.y * wiy + nrm.z * wiz;
    const float bias = signbit(ndw) ? -r.off : r.off;
    st3(f.o_origin, i, p.x + nrm.x * bias, p.y + nrm.y * bias,
        p.z + nrm.z * bias);
    st3(f.o_direction, i, wix, wiy, wiz);
    const bool tp_nan = isnan(ntp_x) || isnan(ntp_y) || isnan(ntp_z);
    if (tp_nan)
      st3(f.o_throughput, i, tp.x, tp.y, tp.z);
    else
      st3(f.o_throughput, i, ntp_x, ntp_y, ntp_z);
    f.o_prev_pdf[i] = kind == 5 ? -1.0f : pdf;
  } else {
    st3(f.o_origin, i, o.x, o.y, o.z);
    st3(f.o_direction, i, d.x, d.y, d.z);
    st3(f.o_throughput, i, tp.x, tp.y, tp.z);
    f.o_prev_pdf[i] = f.prev_pdf[i];
  }
}

__global__ void __launch_bounds__(128)
    bounce_tail_kernel(const TailArgs a) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const Ray r = load_ray(a.r, i);
  float dr, dg, db;
  shadow_delta(a.sc, a.s, a.n, i, r, dr, dg, db);
  // the two-kernel association order: (state radiance + delta) + emission
  const float3 rin = ld3(a.f.radiance, i);
  finish_tail(a.sc, a.f, i, r, rin.x + dr, rin.y + dg, rin.z + db);
}

__global__ void __launch_bounds__(128)
    shadow_radiance_kernel(const ShadowArgs a) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const Ray r = load_ray(a.r, i);
  float dr, dg, db;
  shadow_delta(a.sc, a.s, a.n, i, r, dr, dg, db);
  st3(a.o_delta, i, dr, dg, db);
}

__global__ void __launch_bounds__(128)
    finish_bounce_kernel(const FinishArgs a) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const Ray r = load_ray(a.r, i);
  const float3 rin = ld3(a.f.radiance, i);
  finish_tail(a.sc, a.f, i, r, rin.x, rin.y, rin.z);
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

extern "C" cudaError_t rayn_shadow_radiance(const rayn::ShadowArgs* args,
                                             cudaStream_t stream) {
  if (args->n <= 0) return cudaSuccess;
  const int threads = 128;
  const long long blocks = (args->n + threads - 1) / threads;
  rayn::shadow_radiance_kernel<<<(unsigned)blocks, threads, 0, stream>>>(
      *args);
  return cudaGetLastError();
}

extern "C" cudaError_t rayn_finish_bounce(const rayn::FinishArgs* args,
                                          cudaStream_t stream) {
  if (args->n <= 0) return cudaSuccess;
  const int threads = 128;
  const long long blocks = (args->n + threads - 1) / threads;
  rayn::finish_bounce_kernel<<<(unsigned)blocks, threads, 0, stream>>>(
      *args);
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
