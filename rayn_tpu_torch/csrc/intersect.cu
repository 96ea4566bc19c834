// Fused closest hit + shading info, and the pre-intersect cost key, for
// Hopper (sm_90a).
//
// closest_hit_kernel replaces rayn_tpu/ops/intersect_pallas.py
// closest_hit_shading (_intersect_kernel): per ray, the closest root over
// the K spheres, the march of each SDF instance in turn bounded by the
// running closest t (threshold max(eps_const, eps_abs + eps_lin * t), at
// most max_steps steps), then the point, the sphere normal or the
// tetrahedral normal of the instance hit, the shading offset and the
// material id. The MBoxOnly kernels take one bare MandelBox (the code
// they had before SDF programs), the *_tape_* kernels any instances.
//
// What bounds it on the H100: float32 ALU and warp divergence. A ray takes
// its entry DE, up to max_steps (256) march DEs and, on an SDF hit, four
// normal taps: one 12-iteration MandelBox DE is ~400 flops, against ~40
// bytes read and ~48 written per ray. Marched one thread per ray, a warp
// costs its slowest lane's march plus four DEs if any lane hits the SDF.
// What the design does about it: the refill march of the shadow queue
// (refill_march in common.cuh) over the wavefront itself. Persistent
// blocks; each lane takes a ray, runs it to the end and writes every
// output to the ray's own slot, then takes the next. Every loop iteration
// evaluates exactly one DE per busy lane, and a lane's stages are the
// entry DE at the origin, the march steps, then the four normal taps of
// an SDF hit, so a warp costs about its lanes' total DEs / 32 plus the
// drain. The take is a batch: a warp claims 32 ray ids with one atomicAdd
// on a device counter, and each lane loads one of them (coalesced) and
// folds it over the spheres, all 32 at once; a ray that needs no DE (an
// inactive ray, or a scene without an SDF) is written there and then,
// and the others are handed to idle lanes by shuffles, so a take costs no
// memory round trip and no fold run by one lane while 31 wait (a take
// that loaded and folded one ray per idle lane left the kernel no faster
// than one thread per ray). Compacting the live rays first (an enqueue
// kernel, the march, a shading kernel) was the alternative; the batch
// needs no queue and no scratch because every ray's id is its slot, and
// keeps the fold and the shading in the one launch. Each ray's arithmetic
// is the one-thread-per-ray body's, in the same order, so the order in
// which rays are taken changes no bit.
//
// cost_key_kernel replaces the XLA fusion of rayn_tpu/render/
// integrator.py _intersect_cost_key (the chunk sort's key before the
// intersect at depths >= 1): the sphere fold's closest t, clamped to
// t_max0, over the first DE at the origin, clamped to max_steps; 1 for a
// dead ray or a NaN first DE. One thread per ray; bounded by one DE per
// live ray.
// Scene constants (K spheres as [x, y, z, r, mat]) come in as a small
// device buffer that stays in L1. In a scene whose sphere centers are
// animated (TS > 1) the *_anim_kernel instantiations read each center at
// the ray's time instead, the lerp of its knots [K, TS, 3] (At<true> in
// common.cuh; a table of any knot count, read through the read-only
// cache): each ray computes its Lerp once, then a center costs six loads,
// three multiplies and an add a component, against ~400 flops a DE. The
// constant scene's kernels are the At<false> instantiations, the code
// they had before.
#include "common.cuh"

namespace rayn {

struct IntersectArgs {
  const float* origin;     // [N, 3]
  const float* direction;  // [N, 3]
  const float* hps_abs;    // [N]
  const float* hps_lin;    // [N]
  const bool* active;      // [N]
  const float* time;       // [N] the ray's time (read when animated)
  const float* spheres;    // [K, 5]
  int* head;               // [1] ray ids handed out (0 at launch)
  // [1] or null: the loop iterations of every warp are added here (each
  // iteration evaluates one DE per busy lane; for measurement)
  unsigned long long* warp_steps;
  float* t;                // [N]
  int* obj;                // [N]
  float* point;            // [N, 3]
  float* normal;           // [N, 3]
  float* offset_by;        // [N]
  int* mat;                // [N]
  long long n;
  int K;
  int has_sdf;
  int sdf_mat;      // instance 0's material (MBoxOnly)
  int max_steps;
  MBox mb;
  float t_max0;     // 2 * world_radius
  float eps_const;  // 5e-5 * detail
  float eps_k;      // 0.05 * detail
  float detail;
  Anim anim;        // the sphere centers' track (the others unused)
};

struct CostKeyArgs {
  const float* origin;     // [N, 3]
  const float* direction;  // [N, 3]
  const bool* alive;       // [N]
  const float* time;       // [N] the ray's time (read when animated)
  const float* spheres;    // [K, 5]
  float* key;              // [N]
  long long n;
  int K;
  int max_steps;
  MBox mb;
  float t_max0;
  Anim anim;               // the sphere centers' track (the others unused)
};

// The sphere closest-hit fold (ops/spheres.hit + closest select), the
// centers at the ray's time (`at`).
template <class Pos>
__device__ __forceinline__ void sphere_fold(const Pos& at,
                                            const float* __restrict__ spheres,
                                            int K, float t_max0, float ox,
                                            float oy, float oz, float dx,
                                            float dy, float dz, float& best_t,
                                            int& best_obj) {
  best_t = t_max0;
  best_obj = -1;
  for (int k = 0; k < K; ++k) {
    const float tk =
        sphere_hit(ox, oy, oz, dx, dy, dz, at.template sphere<5>(spheres, k),
                   spheres[5 * k + 3], t_max0);
    if (tk < best_t) {
      best_t = tk;
      best_obj = k;
    }
  }
}

// The shading info of ray i (ops/intersect.shading_info) from its closest
// t and object: a sphere's normal, or for SDF instance i (best_obj == K +
// i) the normalised tap gradient g with offset hps and the instance's
// material; every output written. A sphere's center is taken at the ray's
// time (`at`).
template <class S, class Pos>
__device__ __forceinline__ void write_hit(const IntersectArgs& a,
                                          const Sdf& sdf, const Pos& at,
                                          long long i,
                                          float ox, float oy, float oz,
                                          float dx, float dy, float dz,
                                          float best_t, int best_obj,
                                          float hps, float gx, float gy,
                                          float gz) {
  const float px = ox + best_t * dx, py = oy + best_t * dy,
              pz = oz + best_t * dz;
  float nx = 0.0f, ny = 0.0f, nz = 0.0f, off = 0.0f;
  int mat = 0;
  if (best_obj >= 0 && best_obj < a.K) {
    const float3 c = at.template sphere<5>(a.spheres, best_obj);
    const float vx = px - c.x, vy = py - c.y, vz = pz - c.z;
    const float vlen = sqrtf(vx * vx + vy * vy + vz * vz);
    const float vinv = 1.0f / nmax(vlen, 1e-20f);
    nx = vx * vinv;
    ny = vy * vinv;
    nz = vz * vinv;
    mat = (int)a.spheres[5 * best_obj + 4];
  } else if (S::kTape ? best_obj >= a.K : best_obj == a.K) {
    const float glen = sqrtf(gx * gx + gy * gy + gz * gz);
    const float ginv = 1.0f / nmax(glen, 1e-20f);
    nx = gx * ginv;
    ny = gy * ginv;
    nz = gz * ginv;
    mat = S::kTape ? sdf.inst[best_obj - a.K].mat : a.sdf_mat;
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

// A lane's stage: the entry DE, the march, or normal tap 0..3 (sdfu
// normals_fast taps in ops/sdf.py TETRA_TAPS order: the sign of x is +
// for taps 0 and 3, of y for 1 and 3, of z for 2 and 3).
constexpr int kEntry = -2, kMarch = -1;

__device__ __forceinline__ float tap_sign(int tap, int axis) {
  return (tap == axis || tap == 3) ? 1.0f : -1.0f;
}

// S: the SDF kind. With several instances (TapeSdf) a ray marches instance
// 0, 1, ... in turn (stage kEntry again for each), each bounded by the
// closest t so far, and takes the four taps of the instance it hit last
// (the closest; a tie keeps the earlier object): the bits of JAX's
// taps of every instance selected by the object id.
template <bool kAnim, class S>
__device__ __forceinline__ void closest_hit(const IntersectArgs& a,
                                            const Sdf& sdf) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  int id = -1;  // this lane's ray, -1 while idle
  int stage = kEntry, step = 0, best_obj = -1;
  int inst = 0, hit_inst = 0;  // the instance marched, the one hit (Tape)
  float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 0.0f;
  float hps_abs = 0.0f, hps_lin = 0.0f, t = 0.0f, best_t = 0.0f, hps = 0.0f;
  float tm = 0.0f;  // the ray's time (animated scenes)
  float gx = 0.0f, gy = 0.0f, gz = 0.0f;
  // The warp's batch: slot `lane` holds ray bi, loaded and folded;
  // `pending` marks the slots whose ray still waits for a lane.
  int bi = -1, b_obj = -1;
  float b_ox = 0.0f, b_oy = 0.0f, b_oz = 0.0f, b_dx = 0.0f, b_dy = 0.0f,
        b_dz = 0.0f, b_ha = 0.0f, b_hl = 0.0f, b_t = 0.0f, b_tm = 0.0f;
  unsigned pending = 0u;
  bool drained = false;
  unsigned long long iters = 0;
  for (;;) {
    unsigned idle = __ballot_sync(FULL_MASK, id < 0);
    while (idle != 0u && !drained) {
      if (pending == 0u) {  // the next 32 rays, one per lane
        int b = 0;
        if (lane == 0) b = atomicAdd(a.head, 32);
        b = __shfl_sync(FULL_MASK, b, 0);
        if ((long long)b >= a.n) {
          drained = true;
          break;
        }
        bi = b + lane;
        bool needs_de = false;
        if ((long long)bi < a.n) {
          const long long i3 = 3LL * bi;
          b_ox = a.origin[i3];
          b_oy = a.origin[i3 + 1];
          b_oz = a.origin[i3 + 2];
          b_dx = a.direction[i3];
          b_dy = a.direction[i3 + 1];
          b_dz = a.direction[i3 + 2];
          if (kAnim) b_tm = a.time[bi];
          const At<kAnim> at(a.anim, b_tm);
          sphere_fold(at, a.spheres, a.K, a.t_max0, b_ox, b_oy, b_oz, b_dx,
                      b_dy, b_dz, b_t, b_obj);
          needs_de = a.has_sdf && a.active[bi];
          if (needs_de) {
            b_ha = a.hps_abs[bi];
            b_hl = a.hps_lin[bi];
          } else {  // no DE to take: done the moment it is folded
            write_hit<S>(a, sdf, at, bi, b_ox, b_oy, b_oz, b_dx, b_dy, b_dz,
                         b_t, b_obj, 0.0f, 0.0f, 0.0f, 0.0f);
          }
        }
        pending = __ballot_sync(FULL_MASK, needs_de);
        continue;
      }
      // the r-th idle lane takes the r-th pending slot
      unsigned m = pending;
      for (int r = __popc(idle & below); r > 0 && m != 0u; --r) m &= m - 1u;
      const bool take = id < 0 && m != 0u;
      const int src = take ? __ffs(m) - 1 : lane;
      const int v_id = __shfl_sync(FULL_MASK, bi, src);
      const int v_obj = __shfl_sync(FULL_MASK, b_obj, src);
      const float v_ox = __shfl_sync(FULL_MASK, b_ox, src);
      const float v_oy = __shfl_sync(FULL_MASK, b_oy, src);
      const float v_oz = __shfl_sync(FULL_MASK, b_oz, src);
      const float v_dx = __shfl_sync(FULL_MASK, b_dx, src);
      const float v_dy = __shfl_sync(FULL_MASK, b_dy, src);
      const float v_dz = __shfl_sync(FULL_MASK, b_dz, src);
      const float v_ha = __shfl_sync(FULL_MASK, b_ha, src);
      const float v_hl = __shfl_sync(FULL_MASK, b_hl, src);
      const float v_t = __shfl_sync(FULL_MASK, b_t, src);
      const float v_tm = kAnim ? __shfl_sync(FULL_MASK, b_tm, src) : 0.0f;
      if (take) {
        id = v_id;
        best_obj = v_obj;
        best_t = v_t;
        ox = v_ox;
        oy = v_oy;
        oz = v_oz;
        dx = v_dx;
        dy = v_dy;
        dz = v_dz;
        hps_abs = v_ha;
        hps_lin = v_hl;
        tm = v_tm;
        stage = kEntry;
        inst = 0;
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
    float px, py, pz;
    if (stage == kEntry) {
      px = ox;
      py = oy;
      pz = oz;
    } else if (stage == kMarch) {
      px = ox + t * dx;
      py = oy + t * dy;
      pz = oz + t * dz;
    } else {
      px = (ox + best_t * dx) + tap_sign(stage, 0) * hps;
      py = (oy + best_t * dy) + tap_sign(stage, 1) * hps;
      pz = (oz + best_t * dz) + tap_sign(stage, 2) * hps;
    }
    const float dist =
        S::de(a.mb, sdf, stage < 0 ? inst : hit_inst, px, py, pz);
    bool march_done = false;
    if (stage == kEntry) {
      // a NaN first DE ends the march with no hit (NaN < best_t is false)
      t = dist;
      march_done = isnan(t) || a.max_steps <= 0 || t > best_t;
      stage = kMarch;
      step = 0;
    } else if (stage == kMarch) {
      const float eps_abs = a.eps_k * hps_abs, eps_lin = a.eps_k * hps_lin;
      if (fabsf(dist) < nmax(a.eps_const, eps_abs + eps_lin * t)) {
        march_done = true;
      } else {
        t = t + dist;
        ++step;
        march_done = step >= a.max_steps || t > best_t;
      }
    } else {
      gx = gx + tap_sign(stage, 0) * dist;
      gy = gy + tap_sign(stage, 1) * dist;
      gz = gz + tap_sign(stage, 2) * dist;
      if (stage == 3) {
        write_hit<S>(a, sdf, At<kAnim>(a.anim, tm), id, ox, oy, oz, dx, dy,
                     dz, best_t, best_obj, hps, gx, gy, gz);
        id = -1;
      } else {
        ++stage;
      }
    }
    if (march_done) {
      if constexpr (!S::kTape) {
        if (t < best_t) {  // an SDF hit: its four normal taps follow
          best_t = t;
          best_obj = a.K;
          hps = nmax(1e-4f, a.detail * (hps_abs + hps_lin * best_t));
          gx = 0.0f;
          gy = 0.0f;
          gz = 0.0f;
          stage = 0;
        } else {
          write_hit<S>(a, sdf, At<kAnim>(a.anim, tm), id, ox, oy, oz, dx,
                       dy, dz, best_t, best_obj, 0.0f, 0.0f, 0.0f, 0.0f);
          id = -1;
        }
      } else {
        if (t < best_t) {
          best_t = t;
          best_obj = a.K + inst;
          hit_inst = inst;
        }
        if (inst + 1 < sdf.n_inst) {  // the next instance's entry DE
          ++inst;
          stage = kEntry;
        } else if (best_obj >= a.K) {  // an SDF hit: its four taps follow
          hps = nmax(1e-4f, a.detail * (hps_abs + hps_lin * best_t));
          gx = 0.0f;
          gy = 0.0f;
          gz = 0.0f;
          stage = 0;
        } else {
          write_hit<S>(a, sdf, At<kAnim>(a.anim, tm), id, ox, oy, oz, dx,
                       dy, dz, best_t, best_obj, 0.0f, 0.0f, 0.0f, 0.0f);
          id = -1;
        }
      }
    }
  }
}

__global__ void __launch_bounds__(128)
    closest_hit_kernel(const IntersectArgs a) {
  closest_hit<false, MBoxOnly>(a, Sdf{});
}

__global__ void __launch_bounds__(128)
    closest_hit_anim_kernel(const IntersectArgs a) {
  closest_hit<true, MBoxOnly>(a, Sdf{});
}

__global__ void __launch_bounds__(128)
    closest_hit_tape_kernel(const Taped<IntersectArgs> t) {
  closest_hit<false, TapeSdf>(t.a, t.sdf);
}

__global__ void __launch_bounds__(128)
    closest_hit_anim_tape_kernel(const Taped<IntersectArgs> t) {
  closest_hit<true, TapeSdf>(t.a, t.sdf);
}

__global__ void __launch_bounds__(128)
    closest_hit_deep_kernel(const DeepTaped<IntersectArgs> t) {
  closest_hit<false, DeepTapeSdf>(t.a, t.sdf);
}

__global__ void __launch_bounds__(128)
    closest_hit_anim_deep_kernel(const DeepTaped<IntersectArgs> t) {
  closest_hit<true, DeepTapeSdf>(t.a, t.sdf);
}

__global__ void __launch_bounds__(128)
    closest_hit_expr_kernel(const DeepTaped<IntersectArgs> t) {
  closest_hit<false, ExprTapeSdf>(t.a, t.sdf);
}

__global__ void __launch_bounds__(128)
    closest_hit_anim_expr_kernel(const DeepTaped<IntersectArgs> t) {
  closest_hit<true, ExprTapeSdf>(t.a, t.sdf);
}

// Tape: the estimate of each instance, 1 for a dead ray or a NaN first DE,
// summed from 0 in instance order (JAX integrator.py:166-172).
template <bool kAnim, class S>
__device__ __forceinline__ void cost_key(const CostKeyArgs& a,
                                         const Sdf& sdf) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  float key = 1.0f;
  if (a.alive[i]) {
    const float ox = a.origin[3 * i], oy = a.origin[3 * i + 1],
                oz = a.origin[3 * i + 2];
    const float dx = a.direction[3 * i], dy = a.direction[3 * i + 1],
                dz = a.direction[3 * i + 2];
    // min over the spheres (NaN-propagating, as torch's min), then t_max0
    float bound = a.t_max0;
    if (a.K > 0) {
      const At<kAnim> at(a.anim, kAnim ? a.time[i] : 0.0f);
      float m = sphere_hit(ox, oy, oz, dx, dy, dz,
                           at.template sphere<5>(a.spheres, 0), a.spheres[3],
                           a.t_max0);
      for (int k = 1; k < a.K; ++k)
        m = nmin(m, sphere_hit(ox, oy, oz, dx, dy, dz,
                               at.template sphere<5>(a.spheres, k),
                               a.spheres[5 * k + 3], a.t_max0));
      bound = nmin(m, a.t_max0);
    }
    if constexpr (!S::kTape) {
      const float d0 = S::de(a.mb, sdf, 0, ox, oy, oz);
      if (!isnan(d0))
        key = nmin(bound / nmax(d0, 1e-6f), (float)a.max_steps);
    } else {
      key = 0.0f;
      for (int j = 0; j < sdf.n_inst; ++j) {
        const float d0 = S::de(a.mb, sdf, j, ox, oy, oz);
        key = key + (isnan(d0) ? 1.0f
                               : nmin(bound / nmax(d0, 1e-6f),
                                      (float)a.max_steps));
      }
    }
  } else if constexpr (S::kTape) {
    key = 0.0f;
    for (int j = 0; j < sdf.n_inst; ++j) key = key + 1.0f;
  }
  a.key[i] = key;
}

__global__ void __launch_bounds__(128) cost_key_kernel(const CostKeyArgs a) {
  cost_key<false, MBoxOnly>(a, Sdf{});
}

__global__ void __launch_bounds__(128)
    cost_key_anim_kernel(const CostKeyArgs a) {
  cost_key<true, MBoxOnly>(a, Sdf{});
}

__global__ void __launch_bounds__(128)
    cost_key_tape_kernel(const Taped<CostKeyArgs> t) {
  cost_key<false, TapeSdf>(t.a, t.sdf);
}

__global__ void __launch_bounds__(128)
    cost_key_anim_tape_kernel(const Taped<CostKeyArgs> t) {
  cost_key<true, TapeSdf>(t.a, t.sdf);
}

__global__ void __launch_bounds__(128)
    cost_key_deep_kernel(const DeepTaped<CostKeyArgs> t) {
  cost_key<false, DeepTapeSdf>(t.a, t.sdf);
}

__global__ void __launch_bounds__(128)
    cost_key_anim_deep_kernel(const DeepTaped<CostKeyArgs> t) {
  cost_key<true, DeepTapeSdf>(t.a, t.sdf);
}

__global__ void __launch_bounds__(128)
    cost_key_expr_kernel(const DeepTaped<CostKeyArgs> t) {
  cost_key<false, ExprTapeSdf>(t.a, t.sdf);
}

__global__ void __launch_bounds__(128)
    cost_key_anim_expr_kernel(const DeepTaped<CostKeyArgs> t) {
  cost_key<true, ExprTapeSdf>(t.a, t.sdf);
}

}  // namespace rayn

// Blocks an SM of the closest hit's persistent grid: four (16 warps), not
// the nine that fit. A warp then gets ~500 rays of a 2^20-ray pass, so the
// drain (lanes that idle while the warp's last rays finish) is a smaller
// share of its steps, and 16 warps still hide the DE's latency.
// tools/torch_probe_hit_grid.py builds other values and times each depth.
#ifndef RAYN_HIT_BLOCKS_PER_SM
#define RAYN_HIT_BLOCKS_PER_SM 4
#endif

// Persistent (launch_persistent): every block runs until all rays are
// taken. The *_anim_* instantiations when the sphere centers are animated,
// the *_tape_* ones for any SDF but one bare MandelBox, the *_deep_* ones
// for a program deeper than kSdfDepth, the *_expr_* ones for a scene with
// a kernel-ready closure.
extern "C" cudaError_t rayn_closest_hit(
    const rayn::DeepTaped<rayn::IntersectArgs>* args, cudaStream_t stream) {
  const rayn::IntersectArgs& a = args->a;
  if (a.n <= 0) return cudaSuccess;
  const bool anim = a.anim.spheres.T > 1;
  if (args->sdf.tape == 3)
    return rayn::launch_persistent(anim ? rayn::closest_hit_anim_expr_kernel
                                        : rayn::closest_hit_expr_kernel,
                                   *args, a.n, stream,
                                   RAYN_HIT_BLOCKS_PER_SM);
  if (args->sdf.tape == 2)
    return rayn::launch_persistent(anim ? rayn::closest_hit_anim_deep_kernel
                                        : rayn::closest_hit_deep_kernel,
                                   *args, a.n, stream,
                                   RAYN_HIT_BLOCKS_PER_SM);
  if (args->sdf.tape)
    return rayn::launch_persistent(anim ? rayn::closest_hit_anim_tape_kernel
                                        : rayn::closest_hit_tape_kernel,
                                   args->taped(), a.n, stream,
                                   RAYN_HIT_BLOCKS_PER_SM);
  return rayn::launch_persistent(anim ? rayn::closest_hit_anim_kernel
                                      : rayn::closest_hit_kernel,
                                 a, a.n, stream, RAYN_HIT_BLOCKS_PER_SM);
}

extern "C" cudaError_t rayn_cost_key(
    const rayn::DeepTaped<rayn::CostKeyArgs>* args, cudaStream_t stream) {
  const rayn::CostKeyArgs& a = args->a;
  if (a.n <= 0) return cudaSuccess;
  const bool anim = a.anim.spheres.T > 1;
  const unsigned blocks = rayn::blocks_of(a.n, 128);
  if (args->sdf.tape == 3) {
    void (*kernel)(rayn::DeepTaped<rayn::CostKeyArgs>) =
        anim ? rayn::cost_key_anim_expr_kernel : rayn::cost_key_expr_kernel;
    kernel<<<blocks, 128, 0, stream>>>(*args);
  } else if (args->sdf.tape == 2) {
    void (*kernel)(rayn::DeepTaped<rayn::CostKeyArgs>) =
        anim ? rayn::cost_key_anim_deep_kernel : rayn::cost_key_deep_kernel;
    kernel<<<blocks, 128, 0, stream>>>(*args);
  } else if (args->sdf.tape) {
    void (*kernel)(rayn::Taped<rayn::CostKeyArgs>) =
        anim ? rayn::cost_key_anim_tape_kernel : rayn::cost_key_tape_kernel;
    kernel<<<blocks, 128, 0, stream>>>(args->taped());
  } else {
    void (*kernel)(rayn::CostKeyArgs) =
        anim ? rayn::cost_key_anim_kernel : rayn::cost_key_kernel;
    kernel<<<blocks, 128, 0, stream>>>(a);
  }
  return cudaGetLastError();
}
