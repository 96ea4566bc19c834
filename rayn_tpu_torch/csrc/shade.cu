// The bounce tail, its two halves, and the shadow sort key for Hopper
// (sm_90a).
//
// The shadow half of rayn_tpu/ops/shade_pallas.py's bounce_tail_fused
// (_bounce_tail_kernel) and shadow_radiance (_shadow_kernel), that is
// _shadow_delta with march_pallas._segment_entry and _chained_occl_core
// inlined, runs here as three kernels over a segment scratch:
// - shadow_segments_kernel, one thread per ray: for each NEE site (L) and
//   each volume site (VM*L, march-major), the light pick, the cone sample
//   (a volume site's scatter point at the equi-angular distance it draws
//   itself from the closest hit's t), the BSDF, the NEE MIS weight of
//   paired lights (before `worth`), `worth` and the sphere test. It writes
//   each segment's start, end and contribution k to a struct-of-arrays
//   scratch [., S, N] (S = L + VM*L), its active flag (worth marching and
//   no sphere in the way), and appends the id j*N + i of every active
//   segment to a compacted queue, one atomicAdd per warp.
// - shadow_march_kernel: the SDF verdict of every queued segment (the
//   bounding-sphere clip, the relax-1 step sequence and verdict rule of
//   march_occlusion), written to the segment's own slot: refill_march
//   (common.cuh) on the scratch; shadow_march_relaxed_kernel is the same
//   march with the relaxed step, for the segment queue at relax != 1. Their
//   *_tape_* instantiations take any SDF instances: a segment goes through
//   each in turn, in the one launch, until one blocks it.
// - shadow_sum_kernel / tail_sum_kernel, one thread per ray: k * visible
//   summed over the segments in the JAX order (NEE 0..L-1, then volume
//   sites march-major) from 0; the first writes the radiance delta [N, 3]
//   (shadow_radiance), the second runs finish_tail on (state radiance +
//   delta) (bounce_tail_fused).
// finish_bounce_kernel replaces finish_bounce_fused (_finish_kernel ->
// _finish_tail): emission with its MIS weight, BSDF scatter, Russian
// roulette, the depth-0 AOVs and termination write the next PathState
// from the pre-emission radiance.
// shadow_sort_key_kernel replaces shade_pallas.shadow_sort_key
// (_shadow_key_kernel -> _shadow_cost_key -> _segment_cost): the same
// segments, each priced at min(length / first DE, max_steps). It draws its
// volume sites' equi-angular distances itself (equi_angular_site), which
// the TPU kernel took from outside because Mosaic lowers neither arctan2
// nor tan.
// The XLA ops of rayn_tpu/render/integrator.py _equi_angular_samples
// (:521) run inside the segments kernels (vol_sample, equi_angular_site),
// which the TPU kernels took from outside for the same reason.
// The segment-queue bounce (rayn_tpu/render/integrator.py:420-514, the
// unfused path whose occlusion the TPU ran in march_pallas's
// march_occlusion and march_occlusion_chained) runs here as:
// - queue_segments_kernel: shadow_segments_kernel's sites with the
//   unfused bounce's op order (lights.sample_cone, bsdf.eval_f, its
//   contribution products, spheres.occluded), into the same scratch;
// - shadow_march_kernel / shadow_march_relaxed_kernel on that scratch;
// - queue_sum_kernel: radiance + k_0 * visible_0 + k_1 * visible_1 + ...
//   in segment order from the emission-added radiance (the queue's
//   order, not the fused tail's delta from 0).
//
// What bounds them on the H100: float32 ALU and warp divergence. A ray has
// up to 12 shadow segments of up to max_vis_marches MandelBox DEs each
// (~400 flops per DE), against ~60 floats of memory traffic per ray per
// bounce; the segments of a warp's lanes take different numbers of steps,
// and most are not marched at all (inactive). A thread that marched its
// ray's segments one after another cost its warp the sum over segments of
// the slowest lane's steps, and held the whole ray in registers across the
// march (96 registers).
// What the design does about it: the march kernel runs persistent blocks
// whose lanes each take a segment id from the queue, march it, write its
// verdict and take the next, so a warp costs about its lanes' total steps
// / 32 plus the drain at the end (the GPU form of the TPU's chaining).
// A warp takes 32 queue slots with one atomicAdd and hands them to its
// idle lanes by shuffles. Every loop iteration evaluates exactly one DE
// per busy lane: a new segment's first DE, at its start, is an iteration
// of the same loop. The marching lane holds only the segment (start,
// direction, length, t), so the kernel needs few registers and the SM
// keeps many warps in flight to hide the DE's dependent chain. Sampling
// and the finish tail run once per ray in the loop-free kernels. The
// scratch (~0.5 GB at 2^20 rays and S = 12) costs ~0.3 ms of traffic.
// The segments kernels are bound by neither: they move ~560-580 B a ray
// (0.175 ms at 2^20 rays) and take no DE, but each site is a chain of
// IEEE divisions and square roots, sinf/cosf, expf, powf and, for a
// volume site, atan2f/tanf, issued one operation at a time under
// --fmad=false (tools/torch_probe_segments.py on an H100: ~0.44 ms at
// depth 1 with the queue appends compiled out). The probe ruled out
// what else could hold them: the appends cost 0.02-0.03 ms
// (one atomicAdd per warp and site or per warp alike); a register
// budget for 6 blocks an SM changed nothing, one for 8 spilled and ran
// slower; and one thread per (ray, site), one warp per site in blocks of
// 32 rays (12x the threads, each reloading its ray and its sampler
// state), ran 36% slower than one thread per ray. So a thread keeps its
// ray in registers across its sites; a warp stages its active ids in
// shared memory and appends them with one atomicAdd (a warp's 32 rays,
// not 32 rays per site); a volume site draws its equi-angular sample
// in the thread (no [VM*L, N] distances and pdfs written by one kernel
// and read by the next: 64 B a ray and a launch a bounce); and a lane
// whose ray takes no light skips the BSDF and the transmittances, work
// its zero contribution never reads.
// Scene constants (lights [NL, 8], spheres [K, 4], the per-sphere MIS
// table [K, 5]) come in as small device buffers that stay in L1. No
// kernel waits on the host: the march reads the queue length on the
// device.
// Animated scenes (light or sphere channels with more than one knot): the
// segments, tail-sum, finish and sort-key kernels have *_anim_kernel
// instantiations that read every light position, sphere center and MIS
// light position at the ray's time, the lerp of its knots (At<true> in
// common.cuh, ShadowScalars::anim), where JAX resolved them outside its
// kernels because the in-kernel lerp cost Mosaic registers and VMEM. Here
// a thread computes its ray's Lerp once; a position then costs six loads
// from a table of a few KB (through the read-only cache) and three
// multiplies and an add a component, far below a site's transcendentals.
// The constant scene's kernels are the At<false> instantiations, the code
// they had before.
#include "common.cuh"

namespace rayn {

struct ShadowScalars {  // ops/shade_cuda.py _ShadowScalars
  Sampler smp;
  MBox mb;
  int L, VM, NL, K;
  int has_ext, has_sdf;
  int max_steps;
  float bv_r, bv_r2;  // instance 0's clip radius (MBoxOnly), its square
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
  // set id of the equi-angular distance draw of march m: set_vol_dist0 + m
  int set_vol_dist0;
  // 5: the exponent of bsdf.eval_f's (1 - d) ** 5, read at run time as
  // torch's CUDA pow reads it (eval_f_unfused)
  float schlick_exp;
  Anim anim;  // the scene's position tracks (read by *_anim_kernel)
};

// True when the scene's light or sphere positions are animated.
__host__ __forceinline__ bool animated(const ShadowScalars& sc) {
  return sc.anim.lights.T > 1 || sc.anim.spheres.T > 1;
}

struct RayCols {  // ops/shade_cuda.py _RayCols: read by every tail kernel
  const float *point, *normal, *offset_by, *origin, *direction, *throughput,
      *vol_trans;
  const int* kind;
  const float *color_a, *power;
  const int *sample_idx, *pixel;
  const bool *live, *recv;
  const float* time;  // [N] the ray's time (read when animated)
};

struct ShadowCols {  // ops/shade_cuda.py _ShadowCols
  const float* t_hit;             // [N] the closest hit's t: the volume
                                  // sites' range
  const float *lights, *spheres;  // [NL, 8], [K, 4]
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

struct SegCols {  // ops/shade_cuda.py _SegCols: the segment scratch
  float* geom;    // [6, S, N] start xyz, end xyz
  float* k;       // [3, S, N] contribution rgb
  bool* active;   // [S, N] worth marching and not blocked by a sphere
  int* queue;     // [S*N] ids j*N + i of the active segments, any order
  int* count;     // [1] ids in the queue (0 at launch)
};

struct SegArgs {  // ops/shade_cuda.py _SegArgs
  RayCols r;
  ShadowCols s;
  SegCols g;
  long long n;
  ShadowScalars sc;
};

struct SegMarchArgs {  // ops/shade_cuda.py _SegMarchArgs
  const float* geom;   // [6, M], M = S*N
  QueueMarch q;
};

struct SumCols {  // ops/shade_cuda.py _SumCols
  const float* k;        // [3, S, N]
  const bool* active;    // [S, N]
  const bool* verdict;   // [S, N]
  int S;
};

struct ShadowSumArgs {  // ops/shade_cuda.py _ShadowSumArgs
  SumCols s;
  float* o_delta;  // [N, 3]
  long long n;
};

struct QueueSumArgs {  // ops/shade_cuda.py _QueueSumArgs
  SumCols s;
  const float* radiance;  // [N, 3] the emission-added radiance
  float* o_radiance;      // [N, 3]
  long long n;
};

struct TailSumArgs {  // ops/shade_cuda.py _TailSumArgs
  RayCols r;
  FinishCols f;
  SumCols s;
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
  const float* t_hit;  // [N] the closest hit's t: the volume sites' range
  const int *sample_idx, *pixel;
  const bool *live, *recv;
  const float* time;   // [N] the ray's time (read when animated)
  const float* lights;
  float* key;
  long long n;
  ShadowScalars sc;
};

// The equi-angular sample of volume site j (march-major: march j / L).
template <class Pos>
__device__ __forceinline__ void vol_sample(const ShadowScalars& sc,
                                           const Pos& at,
                                           const float* __restrict__ lights,
                                           int j, uint32_t sidx, uint32_t pix,
                                           float3 o, float3 d, float t_hit,
                                           float& dist, float& pdf) {
  equi_angular_site(sc.smp, at, sc.set_vol_dist0 + j / sc.L,
                    sc.set_vol_pick0 + j, sc.NL, lights, sidx, pix, o.x, o.y,
                    o.z, d.x, d.y, d.z, t_hit, dist, pdf);
}

// Light pick + cone sample of NEE site i from point p (shade_pallas
// _shadow_delta / _shadow_cost_key, shared so both price one segment;
// kDivide: the unfused bounce's cone sample; the light at the ray's time).
template <bool kDivide = false, class Pos>
__device__ __forceinline__ int nee_site(const ShadowScalars& sc,
                                        const Pos& at,
                                        const float* __restrict__ lights,
                                        int i, uint32_t sidx, uint32_t pix,
                                        float px, float py, float pz,
                                        float& ex, float& ey, float& ez,
                                        float& pdf) {
  const int l =
      pick_light(sample_1d(sc.smp, sc.set_pick0 + i, sidx, pix), sc.NL);
  const float3 lp = at.light(lights, l);
  float u1, u2;
  sample_2d(sc.smp, sc.set_nee0 + i, sidx, pix, u1, u2);
  sample_cone<kDivide>(u1, u2, lp.x, lp.y, lp.z, lights[8 * l + 3], px, py,
                       pz, ex, ey, ez, pdf);
  return l;
}

// Light pick + scatter point + cone sample of volume site j.
template <bool kDivide = false, class Pos>
__device__ __forceinline__ int vol_site(const ShadowScalars& sc,
                                        const Pos& at,
                                        const float* __restrict__ lights,
                                        int j, uint32_t sidx, uint32_t pix,
                                        float vd, float ox, float oy, float oz,
                                        float dx, float dy, float dz,
                                        float& spx, float& spy, float& spz,
                                        float& ex, float& ey, float& ez,
                                        float& pdf) {
  const int l =
      pick_light(sample_1d(sc.smp, sc.set_vol_pick0 + j, sidx, pix), sc.NL);
  const float3 lp = at.light(lights, l);
  spx = ox + vd * dx;
  spy = oy + vd * dy;
  spz = oz + vd * dz;
  float u1, u2;
  sample_2d(sc.smp, sc.set_vol0 + j, sidx, pix, u1, u2);
  sample_cone<kDivide>(u1, u2, lp.x, lp.y, lp.z, lights[8 * l + 3], spx, spy,
                       spz, ex, ey, ez, pdf);
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

__device__ __forceinline__ void put_segment(const SegCols& g, long long m,
                                            long long id, float sx, float sy,
                                            float sz, float ex, float ey,
                                            float ez, float kr, float kg,
                                            float kb, bool act) {
  g.geom[id] = sx;
  g.geom[m + id] = sy;
  g.geom[2 * m + id] = sz;
  g.geom[3 * m + id] = ex;
  g.geom[4 * m + id] = ey;
  g.geom[5 * m + id] = ez;
  g.k[id] = kr;
  g.k[m + id] = kg;
  g.k[2 * m + id] = kb;
  g.active[id] = act;
}

// Threads a block of a segments kernel: one ray each.
constexpr int kSegThreads = 128;

// NEE site j of ray r (shade_pallas._shadow_delta's NEE body; kUnfused:
// the op order of the unfused bounce's torch build), written to slot
// j*N + i of the scratch when `store`. Returns its active flag. A lane
// whose ray receives no light skips the BSDF and the transmittance: its
// contribution is 0 whatever they are (the MIS weight still multiplies
// it, so a NaN weight stays NaN as in the twin).
template <bool kUnfused, class Pos>
__device__ __forceinline__ bool nee_segment(const SegArgs& a, const Pos& at,
                                            const Ray& r, int j, long long i,
                                            long long m, bool store) {
  const ShadowScalars& sc = a.sc;
  const float* lights = a.s.lights;
  const float3 p = r.p, nrm = r.nrm, tp = r.tp;
  const float wox = -r.d.x, woy = -r.d.y, woz = -r.d.z;
  float ex, ey, ez, pdf;
  const int l = nee_site<kUnfused>(sc, at, lights, j, r.sidx, r.pix, p.x,
                                   p.y, p.z, ex, ey, ez, pdf);
  const float* lr = lights + 8 * l;
  const float wfx = ex - p.x, wfy = ey - p.y, wfz = ez - p.z;
  const float dist = sqrtf(wfx * wfx + wfy * wfy + wfz * wfz);
  float wix, wiy, wiz;
  if (kUnfused) {
    wix = wfx / dist;
    wiy = wfy / dist;
    wiz = wfz / dist;
  } else {
    const float dinv = 1.0f / dist;
    wix = wfx * dinv;
    wiy = wfy * dinv;
    wiz = wfz * dinv;
  }
  const float ndw = nrm.x * wix + nrm.y * wiy + nrm.z * wiz;
  const float bias = signbit(ndw) ? -r.off : r.off;
  const float sx = p.x + nrm.x * bias, sy = p.y + nrm.y * bias,
              sz = p.z + nrm.z * bias;
  float kr = 0.0f, kg = 0.0f, kb = 0.0f;
  if (r.receives) {
    const float ndl = nmax(0.0f, ndw);
    const float seg_trans = sc.has_ext ? expf(-sc.sigma_t * dist) : 1.0f;
    float fr, fg, fb;
    if (kUnfused) {
      // li * (f * ndl) * (seg_trans / pdf) * tp * (correction * vol_trans)
      eval_f_unfused(r.kind, r.ca.x, r.ca.y, r.ca.z, r.pw, sc.schlick_exp,
                     wox, woy, woz, wix, wiy, wiz, nrm.x, nrm.y, nrm.z, fr,
                     fg, fb);
      const float st_pdf = seg_trans / pdf;
      const float cv = sc.correction * r.vtr;
      kr = lr[4] * (fr * ndl) * st_pdf * tp.x * cv;
      kg = lr[5] * (fg * ndl) * st_pdf * tp.y * cv;
      kb = lr[6] * (fb * ndl) * st_pdf * tp.z * cv;
    } else {
      eval_f(r.kind, r.ca.x, r.ca.y, r.ca.z, r.pw, wox, woy, woz, wix, wiy,
             wiz, nrm.x, nrm.y, nrm.z, fr, fg, fb);
      const float scale = (seg_trans / pdf) * (sc.correction * r.vtr);
      kr = lr[4] * fr * ndl * scale * tp.x;
      kg = lr[5] * fg * ndl * scale * tp.y;
      kb = lr[6] * fb * ndl * scale * tp.z;
    }
  }
  if (sc.mis && lr[7] > 0.0f) {
    // NEE of a paired light, weighted against the BSDF strategy
    const float p_bsdf = eval_pdf(sc.compat_reflect, r.kind, r.pw, wox, woy,
                                  woz, wix, wiy, wiz, nrm.x, nrm.y, nrm.z);
    const float w =
        power_heuristic((float)sc.L, pdf / (float)sc.NL, 1.0f, p_bsdf);
    kr = kr * w;
    kg = kg * w;
    kb = kb * w;
  }
  const bool worth = r.receives && (kr != 0.0f || kg != 0.0f || kb != 0.0f);
  const bool act = worth && !sphere_occluded<kUnfused>(at, a.s.spheres, sc.K,
                                                       sx, sy, sz, ex, ey, ez);
  if (store)
    put_segment(a.g, m, (long long)j * a.n + i, sx, sy, sz, ex, ey, ez, kr,
                kg, kb, act);
  return act;
}

// Volume site j of ray r (march-major), its equi-angular distance and pdf
// drawn here from the closest hit's t_hit (vol_sample), written to slot
// (L + j)*N + i of the scratch when `store`. Returns its active flag. A
// lane whose ray is not alive skips the transmittances: its contribution
// is 0.
template <bool kUnfused, class Pos>
__device__ __forceinline__ bool vol_segment(const SegArgs& a, const Pos& at,
                                            const Ray& r, float t_hit, int j,
                                            long long i, long long m,
                                            bool store) {
  const ShadowScalars& sc = a.sc;
  const float* lights = a.s.lights;
  float vd, vp;
  vol_sample(sc, at, lights, j, r.sidx, r.pix, r.o, r.d, t_hit, vd, vp);
  float spx, spy, spz, ex, ey, ez, light_pdf;
  const int l = vol_site<kUnfused>(sc, at, lights, j, r.sidx, r.pix, vd,
                                   r.o.x, r.o.y, r.o.z, r.d.x, r.d.y, r.d.z,
                                   spx, spy, spz, ex, ey, ez, light_pdf);
  const float* lr = lights + 8 * l;
  float kr = 0.0f, kg = 0.0f, kb = 0.0f;
  if (r.alive) {
    const float sgx = ex - spx, sgy = ey - spy, sgz = ez - spz;
    const float dist_pl = sqrtf(sgx * sgx + sgy * sgy + sgz * sgz);
    const float seg_trans = sc.has_ext ? expf(-sc.sigma_t * dist_pl) : 1.0f;
    const float to_point = sc.has_ext ? expf(-sc.sigma_t * vd) : 1.0f;
    const float scale = INV_4PI_F * seg_trans / (vp * light_pdf) *
                        sc.vm_correction * sc.sigma_s * to_point;
    kr = lr[4] * scale * r.tp.x;
    kg = lr[5] * scale * r.tp.y;
    kb = lr[6] * scale * r.tp.z;
  }
  const bool worth = r.alive && (kr != 0.0f || kg != 0.0f || kb != 0.0f);
  const bool act = worth && !sphere_occluded<kUnfused>(
                                at, a.s.spheres, sc.K, spx, spy, spz, ex, ey,
                                ez);
  if (store)
    put_segment(a.g, m, (long long)(sc.L + j) * a.n + i, spx, spy, spz, ex,
                ey, ez, kr, kg, kb, act);
  return act;
}

// Stages the ids of a warp's active segments in its list `ids`, after
// the `staged` ids already there (a count every lane holds); every lane
// of the warp calls it.
__device__ __forceinline__ void enqueue_stage(bool act, int id, int* ids,
                                              int& staged) {
  const unsigned m = __ballot_sync(FULL_MASK, act);
  if (act) ids[staged + __popc(m & ((1u << (threadIdx.x & 31)) - 1u))] = id;
  staged += __popc(m);
}

// Appends a warp's staged ids to the queue: one atomicAdd on the count,
// then one coalesced copy. Every lane of the warp calls it.
__device__ __forceinline__ void enqueue_flush(const int* ids, int staged,
                                              int* count, int* queue) {
  if (staged == 0) return;
  __syncwarp();
  const int lane = threadIdx.x & 31;
  int base = 0;
  if (lane == 0) base = atomicAdd(count, staged);
  base = __shfl_sync(FULL_MASK, base, 0);
  for (int k = lane; k < staged; k += 32) queue[base + k] = ids[k];
}

// Steps 3 + 4 of a bounce up to the SDF march (shade_pallas._shadow_delta):
// the NEE and volume single-scattering segments of ray i, each written to
// the scratch and, when active, queued: a warp stages the ids of its 32
// rays' active segments in shared memory and appends them with one
// atomicAdd. Lanes past the end (in = false) compute ray n-1 and store
// nothing, so that every lane of a warp stages. kUnfused: the same
// segments in the op order of the unfused bounce's torch build
// (shade_cuda.queue_segments_plain). kAnim: positions at the ray's time.
template <bool kUnfused, bool kAnim>
__device__ __forceinline__ void segments(const SegArgs& a) {
  extern __shared__ int s_ids[];  // 32 * S ids a warp
  const int L = a.sc.L, S = L + a.sc.VM * L;
  const long long i0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool in = i0 < a.n;
  const long long i = in ? i0 : a.n - 1;
  const long long m = (long long)S * a.n;
  int* ids = s_ids + (threadIdx.x >> 5) * 32 * S;
  int staged = 0;
  const Ray r = load_ray(a.r, i);
  const At<kAnim> at(a.sc.anim, kAnim ? a.r.time[i] : 0.0f);
  for (int j = 0; j < L; ++j) {
    const bool act = nee_segment<kUnfused>(a, at, r, j, i, m, in);
    const int id = (int)((long long)j * a.n + i);
    enqueue_stage(in && act, id, ids, staged);
  }
  const float t_hit = a.s.t_hit[i];
  for (int j = 0; j < S - L; ++j) {
    const bool act = vol_segment<kUnfused>(a, at, r, t_hit, j, i, m, in);
    const int id = (int)((long long)(L + j) * a.n + i);
    enqueue_stage(in && act, id, ids, staged);
  }
  enqueue_flush(ids, staged, a.g.count, a.g.queue);
}

__global__ void __launch_bounds__(kSegThreads)
    shadow_segments_kernel(const SegArgs a) {
  segments<false, false>(a);
}

__global__ void __launch_bounds__(kSegThreads)
    shadow_segments_anim_kernel(const SegArgs a) {
  segments<false, true>(a);
}

__global__ void __launch_bounds__(kSegThreads)
    queue_segments_kernel(const SegArgs a) {
  segments<true, false>(a);
}

__global__ void __launch_bounds__(kSegThreads)
    queue_segments_anim_kernel(const SegArgs a) {
  segments<true, true>(a);
}

// One thread per ray, kSegThreads a block, with shared memory for the
// ids of all their segments; `anim` for an animated scene, else `kernel`.
__host__ cudaError_t launch_segments(void (*kernel)(SegArgs),
                                     void (*anim)(SegArgs), const SegArgs& a,
                                     cudaStream_t stream) {
  if (animated(a.sc)) kernel = anim;
  const int S = a.sc.L + a.sc.VM * a.sc.L;
  if (a.n <= 0 || S <= 0) return cudaSuccess;
  const int smem = (int)sizeof(int) * kSegThreads * S;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<blocks_of(a.n, kSegThreads), kSegThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// The SDF verdict of every queued segment of the scratch (refill_march).
__global__ void __launch_bounds__(128) shadow_march_kernel(
    const SegMarchArgs a) {
  refill_march(SoaSegments{a.geom, a.q.m}, a.q, Sdf{}, PlainStep{});
}

__global__ void __launch_bounds__(128) shadow_march_relaxed_kernel(
    const SegMarchArgs a) {
  refill_march(SoaSegments{a.geom, a.q.m}, a.q, Sdf{},
               RelaxedStep{a.q.relax, 0.0f, 0.0f});
}

// The same two for any SDF but one bare MandelBox: a segment goes through
// every instance in turn until one blocks it.
__global__ void __launch_bounds__(128) shadow_march_tape_kernel(
    const Taped<SegMarchArgs> t) {
  refill_march<SoaSegments, PlainStep, false, TapeSdf>(
      SoaSegments{t.a.geom, t.a.q.m}, t.a.q, t.sdf, PlainStep{});
}

__global__ void __launch_bounds__(128) shadow_march_relaxed_tape_kernel(
    const Taped<SegMarchArgs> t) {
  refill_march<SoaSegments, RelaxedStep, false, TapeSdf>(
      SoaSegments{t.a.geom, t.a.q.m}, t.a.q, t.sdf,
      RelaxedStep{t.a.q.relax, 0.0f, 0.0f});
}

// And for a program deeper than kSdfDepth.
__global__ void __launch_bounds__(128) shadow_march_deep_kernel(
    const DeepTaped<SegMarchArgs> t) {
  refill_march<SoaSegments, PlainStep, false, DeepTapeSdf>(
      SoaSegments{t.a.geom, t.a.q.m}, t.a.q, t.sdf, PlainStep{});
}

__global__ void __launch_bounds__(128) shadow_march_relaxed_deep_kernel(
    const DeepTaped<SegMarchArgs> t) {
  refill_march<SoaSegments, RelaxedStep, false, DeepTapeSdf>(
      SoaSegments{t.a.geom, t.a.q.m}, t.a.q, t.sdf,
      RelaxedStep{t.a.q.relax, 0.0f, 0.0f});
}

// k * visible of ray i's segments, summed from 0 in the JAX order (NEE
// 0..L-1, then volume sites march-major): the radiance delta.
__device__ __forceinline__ void segment_sum(const SumCols& c, long long n,
                                            long long i, float& rad_r,
                                            float& rad_g, float& rad_b) {
  const long long m = (long long)c.S * n;
  rad_r = 0.0f;
  rad_g = 0.0f;
  rad_b = 0.0f;
  for (int j = 0; j < c.S; ++j) {
    const long long id = (long long)j * n + i;
    const float v = (c.active[id] && !c.verdict[id]) ? 1.0f : 0.0f;
    rad_r = rad_r + c.k[id] * v;
    rad_g = rad_g + c.k[m + id] * v;
    rad_b = rad_b + c.k[2 * m + id] * v;
  }
}

// Steps 2 and 5-7 of a bounce (shade_pallas._finish_tail) from the
// pre-emission radiance rad_*: emission with its MIS weight, scatter,
// roulette, the depth-0 AOVs and termination; writes the next PathState.
// The MIS light's position is taken at the ray's time (`at`).
template <class Pos>
__device__ __forceinline__ void finish_tail(const ShadowScalars& sc,
                                            const Pos& at,
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
      const float3 lp = at.mis_light(f.mis, obj);
      const float dlx = lp.x - o.x, dly = lp.y - o.y, dlz = lp.z - o.z;
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

template <bool kAnim>
__device__ __forceinline__ void tail_sum(const TailSumArgs& a) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const Ray r = load_ray(a.r, i);
  float dr, dg, db;
  segment_sum(a.s, a.n, i, dr, dg, db);
  // the two-kernel association order: (state radiance + delta) + emission
  const float3 rin = ld3(a.f.radiance, i);
  finish_tail(a.sc, At<kAnim>(a.sc.anim, kAnim ? a.r.time[i] : 0.0f), a.f, i,
              r, rin.x + dr, rin.y + dg, rin.z + db);
}

__global__ void __launch_bounds__(128) tail_sum_kernel(const TailSumArgs a) {
  tail_sum<false>(a);
}

__global__ void __launch_bounds__(128)
    tail_sum_anim_kernel(const TailSumArgs a) {
  tail_sum<true>(a);
}

__global__ void __launch_bounds__(128)
    shadow_sum_kernel(const ShadowSumArgs a) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  float dr, dg, db;
  segment_sum(a.s, a.n, i, dr, dg, db);
  st3(a.o_delta, i, dr, dg, db);
}

// The segment queue's radiance (rayn_tpu/render/integrator.py:512-514):
// the emission-added radiance plus k * visible of ray i's segments, one
// at a time, in segment order.
__global__ void __launch_bounds__(128) queue_sum_kernel(const QueueSumArgs a) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const SumCols& c = a.s;
  const long long m = (long long)c.S * a.n;
  float3 rad = ld3(a.radiance, i);
  for (int j = 0; j < c.S; ++j) {
    const long long id = (long long)j * a.n + i;
    const float v = (c.active[id] && !c.verdict[id]) ? 1.0f : 0.0f;
    rad.x = rad.x + c.k[id] * v;
    rad.y = rad.y + c.k[m + id] * v;
    rad.z = rad.z + c.k[2 * m + id] * v;
  }
  st3(a.o_radiance, i, rad.x, rad.y, rad.z);
}

template <bool kAnim>
__device__ __forceinline__ void finish_bounce(const FinishArgs& a) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const Ray r = load_ray(a.r, i);
  const float3 rin = ld3(a.f.radiance, i);
  finish_tail(a.sc, At<kAnim>(a.sc.anim, kAnim ? a.r.time[i] : 0.0f), a.f, i,
              r, rin.x, rin.y, rin.z);
}

__global__ void __launch_bounds__(128)
    finish_bounce_kernel(const FinishArgs a) {
  finish_bounce<false>(a);
}

__global__ void __launch_bounds__(128)
    finish_bounce_anim_kernel(const FinishArgs a) {
  finish_bounce<true>(a);
}

// S: the SDF kind; each segment is priced summed over the instances
// (instances_cost).
template <bool kAnim, class S>
__device__ __forceinline__ void shadow_sort_key(const KeyArgs& a,
                                                const Sdf& sdf) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const ShadowScalars& sc = a.sc;
  float key = 0.0f;
  if (sc.has_sdf) {
    const At<kAnim> at(sc.anim, kAnim ? a.time[i] : 0.0f);
    const float3 p = ld3(a.point, i), nrm = ld3(a.normal, i);
    const float off = a.offset_by[i];
    const uint32_t sidx = (uint32_t)a.sample_idx[i],
                   pix = (uint32_t)a.pixel[i];
    const bool alive = a.live[i], receives = a.recv[i];
    for (int s = 0; s < sc.L; ++s) {
      float ex, ey, ez, pdf;
      nee_site(sc, at, a.lights, s, sidx, pix, p.x, p.y, p.z, ex, ey, ez,
               pdf);
      const float wfx = ex - p.x, wfy = ey - p.y, wfz = ez - p.z;
      const float dist = sqrtf(wfx * wfx + wfy * wfy + wfz * wfz);
      const float dinv = 1.0f / dist;
      const float ndw =
          nrm.x * wfx * dinv + nrm.y * wfy * dinv + nrm.z * wfz * dinv;
      const float bias = signbit(ndw) ? -off : off;
      key = key + instances_cost<S>(sc.mb, sdf, sc.bv_r, sc.bv_r2,
                                    sc.max_steps, receives && ndw > 0.0f,
                                    p.x + nrm.x * bias, p.y + nrm.y * bias,
                                    p.z + nrm.z * bias, ex, ey, ez);
    }
    const float3 o = ld3(a.origin, i), d = ld3(a.direction, i);
    const float t_hit = a.t_hit[i];
    for (int j = 0; j < sc.VM * sc.L; ++j) {
      float vd, vp;
      vol_sample(sc, at, a.lights, j, sidx, pix, o, d, t_hit, vd, vp);
      float spx, spy, spz, ex, ey, ez, pdf;
      vol_site(sc, at, a.lights, j, sidx, pix, vd, o.x, o.y, o.z, d.x, d.y,
               d.z, spx, spy, spz, ex, ey, ez, pdf);
      key = key + instances_cost<S>(sc.mb, sdf, sc.bv_r, sc.bv_r2,
                                    sc.max_steps, alive, spx, spy, spz, ex,
                                    ey, ez);
    }
  }
  a.key[i] = key;
}

__global__ void __launch_bounds__(128)
    shadow_sort_key_kernel(const KeyArgs a) {
  shadow_sort_key<false, MBoxOnly>(a, Sdf{});
}

__global__ void __launch_bounds__(128)
    shadow_sort_key_anim_kernel(const KeyArgs a) {
  shadow_sort_key<true, MBoxOnly>(a, Sdf{});
}

__global__ void __launch_bounds__(128)
    shadow_sort_key_tape_kernel(const Taped<KeyArgs> t) {
  shadow_sort_key<false, TapeSdf>(t.a, t.sdf);
}

__global__ void __launch_bounds__(128)
    shadow_sort_key_anim_tape_kernel(const Taped<KeyArgs> t) {
  shadow_sort_key<true, TapeSdf>(t.a, t.sdf);
}

__global__ void __launch_bounds__(128)
    shadow_sort_key_deep_kernel(const DeepTaped<KeyArgs> t) {
  shadow_sort_key<false, DeepTapeSdf>(t.a, t.sdf);
}

__global__ void __launch_bounds__(128)
    shadow_sort_key_anim_deep_kernel(const DeepTaped<KeyArgs> t) {
  shadow_sort_key<true, DeepTapeSdf>(t.a, t.sdf);
}

}  // namespace rayn

extern "C" cudaError_t rayn_shadow_segments(const rayn::SegArgs* args,
                                            cudaStream_t stream) {
  return rayn::launch_segments(rayn::shadow_segments_kernel,
                               rayn::shadow_segments_anim_kernel, *args,
                               stream);
}

extern "C" cudaError_t rayn_queue_segments(const rayn::SegArgs* args,
                                           cudaStream_t stream) {
  return rayn::launch_segments(rayn::queue_segments_kernel,
                               rayn::queue_segments_anim_kernel, *args,
                               stream);
}

// Persistent (launch_persistent); plain steps at relax 1, else relaxed;
// the *_tape_* instantiations for any SDF but one bare MandelBox.
extern "C" cudaError_t rayn_shadow_march(
    const rayn::DeepTaped<rayn::SegMarchArgs>* args, cudaStream_t stream) {
  const rayn::SegMarchArgs& a = args->a;
  if (a.q.m <= 0) return cudaSuccess;
  const bool plain = a.q.relax == 1.0f;
  if (args->sdf.tape == 2)
    return rayn::launch_persistent(
        plain ? rayn::shadow_march_deep_kernel
              : rayn::shadow_march_relaxed_deep_kernel,
        *args, a.q.m, stream);
  if (args->sdf.tape)
    return rayn::launch_persistent(
        plain ? rayn::shadow_march_tape_kernel
              : rayn::shadow_march_relaxed_tape_kernel,
        args->taped(), a.q.m, stream);
  return rayn::launch_persistent(
      plain ? rayn::shadow_march_kernel : rayn::shadow_march_relaxed_kernel,
      a, a.q.m, stream);
}

extern "C" cudaError_t rayn_shadow_sum(const rayn::ShadowSumArgs* args,
                                       cudaStream_t stream) {
  if (args->n <= 0) return cudaSuccess;
  rayn::shadow_sum_kernel<<<rayn::blocks_of(args->n, 128), 128, 0, stream>>>(
      *args);
  return cudaGetLastError();
}

extern "C" cudaError_t rayn_tail_sum(const rayn::TailSumArgs* args,
                                     cudaStream_t stream) {
  if (args->n <= 0) return cudaSuccess;
  void (*kernel)(rayn::TailSumArgs) = rayn::animated(args->sc)
                                          ? rayn::tail_sum_anim_kernel
                                          : rayn::tail_sum_kernel;
  kernel<<<rayn::blocks_of(args->n, 128), 128, 0, stream>>>(*args);
  return cudaGetLastError();
}

extern "C" cudaError_t rayn_queue_sum(const rayn::QueueSumArgs* args,
                                      cudaStream_t stream) {
  if (args->n <= 0) return cudaSuccess;
  rayn::queue_sum_kernel<<<rayn::blocks_of(args->n, 128), 128, 0, stream>>>(
      *args);
  return cudaGetLastError();
}

extern "C" cudaError_t rayn_finish_bounce(const rayn::FinishArgs* args,
                                          cudaStream_t stream) {
  if (args->n <= 0) return cudaSuccess;
  void (*kernel)(rayn::FinishArgs) = rayn::animated(args->sc)
                                         ? rayn::finish_bounce_anim_kernel
                                         : rayn::finish_bounce_kernel;
  kernel<<<rayn::blocks_of(args->n, 128), 128, 0, stream>>>(*args);
  return cudaGetLastError();
}

extern "C" cudaError_t rayn_shadow_sort_key(
    const rayn::DeepTaped<rayn::KeyArgs>* args, cudaStream_t stream) {
  const rayn::KeyArgs& a = args->a;
  if (a.n <= 0) return cudaSuccess;
  const bool anim = rayn::animated(a.sc);
  const unsigned blocks = rayn::blocks_of(a.n, 128);
  if (args->sdf.tape == 2) {
    void (*kernel)(rayn::DeepTaped<rayn::KeyArgs>) =
        anim ? rayn::shadow_sort_key_anim_deep_kernel
             : rayn::shadow_sort_key_deep_kernel;
    kernel<<<blocks, 128, 0, stream>>>(*args);
  } else if (args->sdf.tape) {
    void (*kernel)(rayn::Taped<rayn::KeyArgs>) =
        anim ? rayn::shadow_sort_key_anim_tape_kernel
             : rayn::shadow_sort_key_tape_kernel;
    kernel<<<blocks, 128, 0, stream>>>(args->taped());
  } else {
    void (*kernel)(rayn::KeyArgs) = anim ? rayn::shadow_sort_key_anim_kernel
                                         : rayn::shadow_sort_key_kernel;
    kernel<<<blocks, 128, 0, stream>>>(a);
  }
  return cudaGetLastError();
}
