// Device helpers shared by the port's kernels (intersect.cu, march.cu,
// shade.cu).
//
// Every function here mirrors a body of rayn_tpu's Pallas kernels (the
// `kDivide` and `_unfused` variants: the unfused bounce's torch ops)
// formula for formula, in the same association order, so that with
// --fmad=false and IEEE division/sqrt a kernel differs from its plain
// torch twin only where a transcendental (sin, cos, exp, pow) rounds
// differently. The traps this file guards:
//  - NaN: jnp.maximum/minimum propagate NaN, CUDA's fmaxf/fminf return
//    the other operand; nmax/nmin propagate like jnp.
//  - Sign bits: jnp.signbit sees -0.0 as negative; so does signbit().
//  - The sampler is plain wrapping uint32 arithmetic.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace rayn {

// rayn_tpu constants, rounded to float32 exactly as JAX rounds a Python
// double that meets a float32 array.
constexpr double kPi = 3.14159265358979;
constexpr float PI_F = (float)kPi;
constexpr float TWO_PI_F = (float)(2.0 * kPi);
constexpr float INV_PI_F = (float)(1.0 / kPi);
constexpr float FRAC_PI_4_F = (float)(kPi / 4.0);
constexpr float FRAC_PI_2_F = (float)(kPi / 2.0);
constexpr float INV_4PI_F = (float)(1.0 / (4.0 * kPi));
constexpr float F0_F = 0.04f;
constexpr float ONE_MINUS_F0_F = (float)(1.0 - 0.04);
constexpr float F32_EPS_F = 1.1920929e-07f;
constexpr float MISS_F = 3.4e38f;

// ---------------------------------------------------------------- NaN-aware
__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fc00000); }
__device__ __forceinline__ float nmax(float a, float b) {
  return (isnan(a) || isnan(b)) ? nan_f() : fmaxf(a, b);
}
__device__ __forceinline__ float nmin(float a, float b) {
  return (isnan(a) || isnan(b)) ? nan_f() : fminf(a, b);
}

// ------------------------------------------------------------ argument types
struct MBox {  // ops/sdf.py MandelBox
  int iters;
  float scale, box_l, min_rad_sq, fixed_rad_sq;
};

// One SDF instance of a scene (_build.py SdfInst): where its program lies
// in the tape, its material and its bounding sphere.
struct SdfInst {
  int op0, n_ops;     // its op words: ops[op0, op0 + n_ops)
  int prm0;           // its first operand: prm[prm0]
  int mat;            // its material id
  float bv_r, bv_r2;  // bounding-sphere clip radius (0 = none), its square
};

// The SDF instances of a Tape kernel (_build.py Sdf): the instance table
// and the tape (ops/sdf.py tape: postfix op words and their operands). A
// scene whose one instance is a bare MandelBox runs the MBoxOnly kernels,
// which take the arguments they took before SDF programs existed (the
// MBox, bound and material there); any other scene runs the Tape kernels,
// which take Taped arguments: the same arguments, then the Sdf.
struct Sdf {
  int n_inst;           // instances (0 = no SDF)
  int tape;             // 1: the Tape instantiation, 2: the DeepTape one
  const SdfInst* inst;  // [n_inst]
  const int* ops;
  const float* prm;
};

template <class Args>
struct Taped {
  Args a;
  Sdf sdf;
};

// The Sdf of the DeepTape kernels (_build.py Sdf, whose fields these
// are): the stacks of thread t (its global index) live in a device
// scratch of `slots` thread slots, distance k at deep[k * slots + t] and
// saved point k's x, y, z at rows depth + k, depth + points + k and
// depth + 2 * points + k. The launchers take DeepTaped arguments and pass
// the Tape kernels their Taped prefix, the MBoxOnly kernels the Args.
struct DeepSdf : Sdf {
  float* deep;
  long long slots;
  int depth, points;
};

template <class Args>
struct DeepTaped {  // _build.py Taped
  Args a;
  DeepSdf sdf;

  Taped<Args> taped() const { return Taped<Args>{a, sdf}; }
};

struct Sampler {  // utils/rng.py: sampler kind, frame salt, R_d alphas
  int hash;
  uint32_t frame;
  int num_1d_sets;
  uint32_t a1_lo, a1_hi;
  uint32_t a2_lo[2], a2_hi[2];
};

// ------------------------------------------------------------- MandelBox DE
// ops/sdf.py mandelbox fn_c (reference src/sdf.rs:126-141). fminf/fmaxf
// are safe here: a NaN coordinate stays NaN through `clip(x)*2 - x` and
// makes the final sqrt NaN whichever way the folds treat it.
__device__ __forceinline__ float mandelbox_de(const MBox& mb, float x,
                                              float y, float z) {
  const float ox = x, oy = y, oz = z;
  float dr = 1.0f;
  for (int i = 0; i < mb.iters; ++i) {
    x = fminf(fmaxf(x, -mb.box_l), mb.box_l) * 2.0f - x;
    y = fminf(fmaxf(y, -mb.box_l), mb.box_l) * 2.0f - y;
    z = fminf(fmaxf(z, -mb.box_l), mb.box_l) * 2.0f - z;
    const float r2 = x * x + y * y + z * z;
    const float mul = fmaxf(1.0f, mb.fixed_rad_sq / fmaxf(mb.min_rad_sq, r2));
    x = x * mul;
    y = y * mul;
    z = z * mul;
    dr = dr * mul;
    x = x * mb.scale + ox;
    y = y * mb.scale + oy;
    z = z * mb.scale + oz;
    dr = -dr * mb.scale + 1.0f;
  }
  return sqrtf(x * x + y * y + z * z) / fabsf(dr);
}

// ------------------------------------------------------------ SDF programs
// Opcodes of a tape (ops/sdf.py OP_*): the low byte of an op word; the
// MandelBox keeps its iteration count in the bits above. Each op reads its
// operands from the instance's operand stream in turn.
constexpr int kOpMBox = 0, kOpSphere = 1, kOpBox = 2, kOpTorus = 3,
              kOpPlane = 4, kOpUnion = 5, kOpIntersection = 6,
              kOpSubtraction = 7, kOpSmoothUnion = 8, kOpTranslate = 9,
              kOpScale = 10, kOpRounded = 11, kOpPop = 12, kOpPopScale = 13;
// The most distances, and the most saved points, the Tape kernels hold at
// once in per-thread arrays (ops/sdf.py DEPTH_CAP); a deeper program runs
// the DeepTape kernels (deep_tape_de).
constexpr int kSdfDepth = 8;

// The DE of instance `inst` at (x, y, z): its tape run as a postfix
// program over a stack of distances, the point moved by Translate and
// Scale and restored from a stack of saved points after their operand.
// Every op rounds as the JAX fn_c (ops/sdf.py dist_c): minimum and maximum
// propagate NaN (nmin/nmax), `** 2` is a product, divisions are IEEE.
__device__ __forceinline__ float tape_de(const Sdf& s, int inst, float x,
                                         float y, float z) {
  const SdfInst& in = s.inst[inst];
  const int* op = s.ops + in.op0;
  const float* q = s.prm + in.prm0;
  float d[kSdfDepth], sx[kSdfDepth], sy[kSdfDepth], sz[kSdfDepth];
  int nd = 0, np = 0;
  for (int k = 0; k < in.n_ops; ++k) {
    const int code = __ldg(op + k);
    switch (code & 0xff) {
      case kOpMBox: {
        const MBox mb{code >> 8, __ldg(q), __ldg(q + 1), __ldg(q + 2),
                      __ldg(q + 3)};
        q += 4;
        d[nd++] = mandelbox_de(mb, x, y, z);
        break;
      }
      case kOpSphere:
        d[nd++] = sqrtf(x * x + y * y + z * z) - __ldg(q);
        q += 1;
        break;
      case kOpBox: {
        const float qx = fabsf(x) - __ldg(q), qy = fabsf(y) - __ldg(q + 1),
                    qz = fabsf(z) - __ldg(q + 2);
        q += 3;
        const float mx = nmax(qx, 0.0f), my = nmax(qy, 0.0f),
                    mz = nmax(qz, 0.0f);
        const float outside = sqrtf(mx * mx + my * my + mz * mz);
        d[nd++] = outside + nmin(nmax(qx, nmax(qy, qz)), 0.0f);
        break;
      }
      case kOpTorus: {
        const float qx = sqrtf(x * x + z * z) - __ldg(q);
        d[nd++] = sqrtf(qx * qx + y * y) - __ldg(q + 1);
        q += 2;
        break;
      }
      case kOpPlane:
        d[nd++] = x * __ldg(q) + y * __ldg(q + 1) + z * __ldg(q + 2) +
                  __ldg(q + 3);
        q += 4;
        break;
      case kOpUnion:
        --nd;
        d[nd - 1] = nmin(d[nd - 1], d[nd]);
        break;
      case kOpIntersection:
        --nd;
        d[nd - 1] = nmax(d[nd - 1], d[nd]);
        break;
      case kOpSubtraction:
        --nd;
        d[nd - 1] = nmax(d[nd - 1], -d[nd]);
        break;
      case kOpSmoothUnion: {
        const float kk = __ldg(q);
        q += 1;
        --nd;
        const float d1 = d[nd - 1], d2 = d[nd];
        const float h = nmin(nmax(0.5f + 0.5f * (d2 - d1) / kk, 0.0f), 1.0f);
        d[nd - 1] = d2 + (d1 - d2) * h - kk * h * (1.0f - h);
        break;
      }
      case kOpTranslate:
        sx[np] = x;
        sy[np] = y;
        sz[np] = z;
        ++np;
        x = x - __ldg(q);
        y = y - __ldg(q + 1);
        z = z - __ldg(q + 2);
        q += 3;
        break;
      case kOpScale: {
        sx[np] = x;
        sy[np] = y;
        sz[np] = z;
        ++np;
        const float f = __ldg(q);
        q += 1;
        x = x / f;
        y = y / f;
        z = z / f;
        break;
      }
      case kOpRounded:
        d[nd - 1] = d[nd - 1] - __ldg(q);
        q += 1;
        break;
      case kOpPop:
        --np;
        x = sx[np];
        y = sy[np];
        z = sz[np];
        break;
      case kOpPopScale:
        --np;
        x = sx[np];
        y = sy[np];
        z = sz[np];
        d[nd - 1] = d[nd - 1] * __ldg(q);
        q += 1;
        break;
    }
  }
  return d[0];
}

// tape_de with its stacks in the thread's slots of the DeepTape scratch
// (DeepSdf), so a program of any depth: the same ops in the same order.
__device__ __forceinline__ float deep_tape_de(const DeepSdf& s, int inst,
                                              float x, float y, float z) {
  const SdfInst& in = s.inst[inst];
  const int* op = s.ops + in.op0;
  const float* q = s.prm + in.prm0;
  const long long n = s.slots;
  float* const d =
      s.deep + ((long long)blockIdx.x * blockDim.x + threadIdx.x);
  float* const sx = d + s.depth * n;
  float* const sy = sx + s.points * n;
  float* const sz = sy + s.points * n;
  int nd = 0, np = 0;
  for (int k = 0; k < in.n_ops; ++k) {
    const int code = __ldg(op + k);
    switch (code & 0xff) {
      case kOpMBox: {
        const MBox mb{code >> 8, __ldg(q), __ldg(q + 1), __ldg(q + 2),
                      __ldg(q + 3)};
        q += 4;
        d[(nd++) * n] = mandelbox_de(mb, x, y, z);
        break;
      }
      case kOpSphere:
        d[(nd++) * n] = sqrtf(x * x + y * y + z * z) - __ldg(q);
        q += 1;
        break;
      case kOpBox: {
        const float qx = fabsf(x) - __ldg(q), qy = fabsf(y) - __ldg(q + 1),
                    qz = fabsf(z) - __ldg(q + 2);
        q += 3;
        const float mx = nmax(qx, 0.0f), my = nmax(qy, 0.0f),
                    mz = nmax(qz, 0.0f);
        const float outside = sqrtf(mx * mx + my * my + mz * mz);
        d[(nd++) * n] = outside + nmin(nmax(qx, nmax(qy, qz)), 0.0f);
        break;
      }
      case kOpTorus: {
        const float qx = sqrtf(x * x + z * z) - __ldg(q);
        d[(nd++) * n] = sqrtf(qx * qx + y * y) - __ldg(q + 1);
        q += 2;
        break;
      }
      case kOpPlane:
        d[(nd++) * n] =
            x * __ldg(q) + y * __ldg(q + 1) + z * __ldg(q + 2) + __ldg(q + 3);
        q += 4;
        break;
      case kOpUnion:
        --nd;
        d[(nd - 1) * n] = nmin(d[(nd - 1) * n], d[nd * n]);
        break;
      case kOpIntersection:
        --nd;
        d[(nd - 1) * n] = nmax(d[(nd - 1) * n], d[nd * n]);
        break;
      case kOpSubtraction:
        --nd;
        d[(nd - 1) * n] = nmax(d[(nd - 1) * n], -d[nd * n]);
        break;
      case kOpSmoothUnion: {
        const float kk = __ldg(q);
        q += 1;
        --nd;
        const float d1 = d[(nd - 1) * n], d2 = d[nd * n];
        const float h = nmin(nmax(0.5f + 0.5f * (d2 - d1) / kk, 0.0f), 1.0f);
        d[(nd - 1) * n] = d2 + (d1 - d2) * h - kk * h * (1.0f - h);
        break;
      }
      case kOpTranslate:
        sx[np * n] = x;
        sy[np * n] = y;
        sz[np * n] = z;
        ++np;
        x = x - __ldg(q);
        y = y - __ldg(q + 1);
        z = z - __ldg(q + 2);
        q += 3;
        break;
      case kOpScale: {
        sx[np * n] = x;
        sy[np * n] = y;
        sz[np * n] = z;
        ++np;
        const float f = __ldg(q);
        q += 1;
        x = x / f;
        y = y / f;
        z = z / f;
        break;
      }
      case kOpRounded:
        d[(nd - 1) * n] = d[(nd - 1) * n] - __ldg(q);
        q += 1;
        break;
      case kOpPop:
        --np;
        x = sx[np * n];
        y = sy[np * n];
        z = sz[np * n];
        break;
      case kOpPopScale:
        --np;
        x = sx[np * n];
        y = sy[np * n];
        z = sz[np * n];
        d[(nd - 1) * n] = d[(nd - 1) * n] * __ldg(q);
        q += 1;
        break;
    }
  }
  return d[0];
}

// The SDF kinds a DE-reading kernel is instantiated for. MBoxOnly: the one
// bare MandelBox of the scene, its DE inlined as before programs existed
// (one instance, `inst` unused). Tape: any number of instances, each any
// program whose stacks fit kSdfDepth, through tape_de.
struct MBoxOnly {
  static constexpr bool kTape = false;
  __device__ static __forceinline__ float de(const MBox& mb, const Sdf&, int,
                                             float x, float y, float z) {
    return mandelbox_de(mb, x, y, z);
  }
};

struct TapeSdf {
  static constexpr bool kTape = true;
  __device__ static __forceinline__ float de(const MBox&, const Sdf& s,
                                             int inst, float x, float y,
                                             float z) {
    return tape_de(s, inst, x, y, z);
  }
};

// DeepTape: as Tape, with the stacks in the thread's slots of the DeepSdf
// scratch (any depth; the host sizes it for the launch's grid).
struct DeepTapeSdf {
  static constexpr bool kTape = true;
  __device__ static __forceinline__ float de(const MBox&, const Sdf& s,
                                             int inst, float x, float y,
                                             float z) {
    return deep_tape_de(static_cast<const DeepSdf&>(s), inst, x, y, z);
  }
};

// ------------------------------------------------------ animated positions
// A channel of positions over time (scene/animation.py AnimChannel,
// values [count, T, 3]): T knots on a uniform grid over [t0, t0 + span].
// T == 1 is a constant channel.
struct Track {
  const float* knots;  // [count, T, 3]
  int T;
  float t0, span;  // t0 and float32(t1 - t0)
};

// The scene's animated positions: lights [NL, TL, 3], sphere centers
// [K, TS, 3], and the knots of the light paired with each sphere [K, TL, 3]
// (the MIS table's position column; same t0 and span as the lights').
struct Anim {
  Track lights, spheres, mis;
};

// A lane's place in a track (animation._lerp_state): u = (t - t0) / span *
// (T - 1) with one IEEE division, clamped to [0, T - 1]; its floor clamped
// to [0, T - 2]; the fraction u - i0. Unfused, as torch's ops round
// (--fmad=false).
struct Lerp {
  int i0;
  float frac;
};

__device__ __forceinline__ Lerp lerp_state(const Track& c, float t) {
  if (c.T <= 1) return Lerp{0, 0.0f};
  const float top = (float)(c.T - 1);
  const float u = fminf(fmaxf((t - c.t0) / c.span * top, 0.0f), top);
  const int i0 = min(max((int)floorf(u), 0), c.T - 2);
  return Lerp{i0, u - (float)i0};
}

// Object k's position at the lane's Lerp (animation.sample_batched_at):
// v[k, i0] * (1 - frac) + v[k, i0 + 1] * frac, per component; knot 0 of a
// constant track. The knots are read through the read-only cache.
__device__ __forceinline__ float3 track_at(const Track& c, int k, Lerp s) {
  const float* v = c.knots + 3 * ((long long)k * c.T + s.i0);
  if (c.T <= 1) return make_float3(__ldg(v), __ldg(v + 1), __ldg(v + 2));
  const float w0 = 1.0f - s.frac;
  return make_float3(__ldg(v) * w0 + __ldg(v + 3) * s.frac,
                     __ldg(v + 1) * w0 + __ldg(v + 4) * s.frac,
                     __ldg(v + 2) * w0 + __ldg(v + 5) * s.frac);
}

// Where a kernel reads a scene position for one lane. At<false>, the
// constant scene: the rows of the constant tables (lights [NL, 8] and the
// MIS table [K, 5] as shade.cu lays them out, spheres with kStride floats
// a row), as before animated channels existed. At<true>: the knot lerp at
// the lane's time; a kernel instantiated with it takes the lane's time
// once and a Lerp a track.
template <bool kAnim>
struct At;

template <>
struct At<false> {
  __device__ __forceinline__ At(const Anim&, float) {}
  __device__ __forceinline__ float3 light(const float* lights, int l) const {
    const float* r = lights + 8 * l;
    return make_float3(r[0], r[1], r[2]);
  }
  template <int kStride>
  __device__ __forceinline__ float3 sphere(const float* sph, int k) const {
    const float* r = sph + kStride * k;
    return make_float3(r[0], r[1], r[2]);
  }
  __device__ __forceinline__ float3 mis_light(const float* mis, int k) const {
    const float* r = mis + 5 * k;
    return make_float3(r[2], r[3], r[4]);
  }
};

template <>
struct At<true> {
  const Anim& a;
  Lerp l, s;
  __device__ __forceinline__ At(const Anim& an, float t)
      : a(an), l(lerp_state(an.lights, t)), s(lerp_state(an.spheres, t)) {}
  __device__ __forceinline__ float3 light(const float*, int i) const {
    return track_at(a.lights, i, l);
  }
  template <int kStride>
  __device__ __forceinline__ float3 sphere(const float*, int k) const {
    return track_at(a.spheres, k, s);
  }
  __device__ __forceinline__ float3 mis_light(const float*, int k) const {
    return track_at(a.mis, k, l);
  }
};

// ------------------------------------------------------------------ sampler
__device__ __forceinline__ uint32_t pcg_hash(uint32_t x) {
  x = x * 747796405u + 2891336453u;
  x = ((x >> ((x >> 28u) + 4u)) ^ x) * 277803737u;
  return (x >> 22u) ^ x;
}

__device__ __forceinline__ float hash_to_unit(uint32_t h) {
  return (float)(int)(h >> 8u) * 5.9604644775390625e-08f;  // 2^-24
}

// bits 40..63 of ((set_base << 32) + n) * alpha mod 2^64 (utils/rng.py _rd_bits)
__device__ __forceinline__ float rd_bits(uint32_t a_l, uint32_t a_h,
                                         uint32_t set_base, uint32_t n) {
  const uint32_t a0 = a_l & 0xFFFFu, a1 = a_l >> 16u;
  const uint32_t n0 = n & 0xFFFFu, n1 = n >> 16u;
  const uint32_t m00 = a0 * n0, m01 = a0 * n1, m10 = a1 * n0, m11 = a1 * n1;
  const uint32_t carry =
      ((m00 >> 16u) + (m01 & 0xFFFFu) + (m10 & 0xFFFFu)) >> 16u;
  const uint32_t p0h = m11 + (m01 >> 16u) + (m10 >> 16u) + carry;
  const uint32_t h = p0h + a_l * set_base + a_h * n;
  return (float)(int)(h >> 8u) * 5.9604644775390625e-08f;
}

__device__ __forceinline__ float frac1(float x) {  // jnp.mod(x, 1.0), x in [0, 2)
  return x >= 1.0f ? x - 1.0f : x;
}

constexpr uint32_t SALT_1D = 0x9E3779B9u;
constexpr uint32_t SALT_2D = 0x85EBCA6Bu;

__device__ __forceinline__ float sample_1d(const Sampler& s, int set_id,
                                           uint32_t sidx, uint32_t pix) {
  const uint32_t sid = (uint32_t)set_id;
  if (s.hash) {
    return hash_to_unit(pcg_hash(
        pcg_hash(pcg_hash(pcg_hash(pix) ^ sidx) ^ (SALT_1D ^ sid)) ^ s.frame));
  }
  const float base = rd_bits(s.a1_lo, s.a1_hi, s.frame + sid, sidx);
  const float scr =
      hash_to_unit(pcg_hash(pcg_hash(pcg_hash(pix) ^ (SALT_1D ^ sid)) ^ s.frame));
  return frac1(base + scr);
}

__device__ __forceinline__ void sample_2d(const Sampler& s, int set_id,
                                          uint32_t sidx, uint32_t pix,
                                          float& u, float& v) {
  const uint32_t sid = (uint32_t)set_id;
  const uint32_t su = SALT_2D ^ (sid * 2u), sv = SALT_2D ^ (sid * 2u + 1u);
  if (s.hash) {
    const uint32_t h0 = pcg_hash(pcg_hash(pix) ^ sidx);
    u = hash_to_unit(pcg_hash(pcg_hash(h0 ^ su) ^ s.frame));
    v = hash_to_unit(pcg_hash(pcg_hash(h0 ^ sv) ^ s.frame));
    return;
  }
  const uint32_t base = s.frame + (uint32_t)s.num_1d_sets + sid;
  const float bu = rd_bits(s.a2_lo[0], s.a2_hi[0], base, sidx);
  const float bv = rd_bits(s.a2_lo[1], s.a2_hi[1], base, sidx);
  const uint32_t hp = pcg_hash(pix);
  const float scr_u = hash_to_unit(pcg_hash(pcg_hash(hp ^ su) ^ s.frame));
  const float scr_v = hash_to_unit(pcg_hash(pcg_hash(hp ^ sv) ^ s.frame));
  u = frac1(bu + scr_u);
  v = frac1(bv + scr_v);
}

// --------------------------------------------------------------- geometry
// shade_pallas._onb: Pixar/Duff basis, signbit(-0.0) counts as negative.
__device__ __forceinline__ void onb(float nx, float ny, float nz, float uu[3],
                                    float vv[3]) {
  const float ks = signbit(nz) ? -1.0f : 1.0f;
  const float ka = 1.0f / (1.0f + fabsf(nz));
  const float kb = -ks * nx * ny * ka;
  uu[0] = 1.0f - nx * nx * ka;
  uu[1] = ks * kb;
  uu[2] = -ks * nx;
  vv[0] = kb;
  vv[1] = ks - ny * ny * ka * ks;
  vv[2] = -ny;
}

// shade_pallas._pick_light: clip(floor(u * NL), 0, NL - 1).
__device__ __forceinline__ int pick_light(float u, int NL) {
  int idx = (int)floorf(u * (float)NL);
  return idx < 0 ? 0 : (idx > NL - 1 ? NL - 1 : idx);
}

// The equi-angular distance sample of one volume site (integrator
// ._equi_angular_samples with lights.sample_equi_angular, reference
// src/light.rs:75-102), in torch's op order: the distance draw u of the
// site's march (set_dist), the light picked by set_pick from the light
// table [NL, 8] (its position at the lane's time: `at`), then delta,
// closest, d, the two angles, the distance delta + d * tan(th) along
// o + s*d and its pdf. atan2f and tanf equal torch's CUDA atan2 and tan
// bit for bit on the H100, under either --fmad setting
// (tools/torch_probe_trig.py counts the lanes that differ).
template <class Pos>
__device__ __forceinline__ void equi_angular_site(
    const Sampler& smp, const Pos& at, int set_dist, int set_pick, int NL,
    const float* __restrict__ lights, uint32_t sidx, uint32_t pix, float ox,
    float oy, float oz, float dx, float dy, float dz, float max_distance,
    float& dist, float& pdf) {
  const float u = sample_1d(smp, set_dist, sidx, pix);
  const float3 lp =
      at.light(lights, pick_light(sample_1d(smp, set_pick, sidx, pix), NL));
  const float delta =
      (lp.x - ox) * dx + (lp.y - oy) * dy + (lp.z - oz) * dz;
  const float cx = (ox + delta * dx) - lp.x, cy = (oy + delta * dy) - lp.y,
              cz = (oz + delta * dz) - lp.z;
  const float d = sqrtf(cx * cx + cy * cy + cz * cz);
  const float theta_a = atan2f(-delta, d);
  const float theta_b = atan2f(max_distance - delta, d);
  const float th = theta_a + (theta_b - theta_a) * u;
  const float t = d * tanf(th);
  dist = delta + t;
  pdf = d / ((theta_b - theta_a) * (d * d + t * t));
}

// shade_pallas._sample_cone (reference src/light.rs:38-72). kDivide:
// ops/lights.sample_cone, the unfused bounce's sampler, which divides the
// direction to the light by its length where the fused body multiplies
// by the reciprocal.
template <bool kDivide = false>
__device__ __forceinline__ void sample_cone(float u1, float u2, float lx,
                                            float ly, float lz, float lrad,
                                            float px, float py, float pz,
                                            float& ex, float& ey, float& ez,
                                            float& pdf) {
  const float dlx = lx - px, dly = ly - py, dlz = lz - pz;
  const float dist_sq = dlx * dlx + dly * dly + dlz * dlz;
  const float dist = sqrtf(dist_sq);
  float nx, ny, nz;
  if (kDivide) {
    nx = -(dlx / dist);
    ny = -(dly / dist);
    nz = -(dlz / dist);
  } else {
    const float inv = 1.0f / dist;
    nx = -(dlx * inv);
    ny = -(dly * inv);
    nz = -(dlz * inv);
  }
  float uu[3], vv[3];
  onb(nx, ny, nz, uu, vv);
  const float r2 = lrad * lrad;
  const float sin_theta_max_2 = r2 / dist_sq;
  const float cos_theta_max = sqrtf(nmax(0.0f, 1.0f - sin_theta_max_2));
  const float cos_theta = (1.0f - u1) + u1 * cos_theta_max;
  const float sin_theta = sqrtf(nmax(0.0f, 1.0f - cos_theta * cos_theta));
  const float phi = u2 * TWO_PI_F;
  const float ds =
      dist * cos_theta - sqrtf(nmax(0.0f, r2 - dist_sq * sin_theta * sin_theta));
  const float cos_alpha = (dist_sq + r2 - ds * ds) / (2.0f * dist * lrad);
  const float sin_alpha = sqrtf(nmax(0.0f, 1.0f - cos_alpha * cos_alpha));
  const float sc = sin_alpha * cosf(phi);
  const float ss = sin_alpha * sinf(phi);
  ex = lx + (uu[0] * sc + vv[0] * ss + nx * cos_alpha) * lrad;
  ey = ly + (uu[1] * sc + vv[1] * ss + ny * cos_alpha) * lrad;
  ez = lz + (uu[2] * sc + vv[2] * ss + nz * cos_alpha) * lrad;
  pdf = 1.0f / (TWO_PI_F * (1.0f - cos_theta_max));
}

// shade_pallas._sphere_occluded: any of K spheres [x, y, z, r] blocks s->e
// (their centers at the lane's time: `at`). kDivide: ops/spheres.occluded
// (the unfused bounce), whose unit direction is (e - s) / |e - s|.
template <bool kDivide = false, class Pos>
__device__ __forceinline__ bool sphere_occluded(const Pos& at,
                                                const float* __restrict__ sph,
                                                int K, float sx, float sy,
                                                float sz, float ex, float ey,
                                                float ez) {
  const float dx = ex - sx, dy = ey - sy, dz = ez - sz;
  const float dist = sqrtf(dx * dx + dy * dy + dz * dz);
  float ux, uy, uz;
  if (kDivide) {
    ux = dx / dist;
    uy = dy / dist;
    uz = dz / dist;
  } else {
    const float inv = 1.0f / dist;
    ux = dx * inv;
    uy = dy * inv;
    uz = dz * inv;
  }
  bool occ = false;
  for (int k = 0; k < K; ++k) {
    const float3 c = at.template sphere<4>(sph, k);
    const float ocx = sx - c.x, ocy = sy - c.y, ocz = sz - c.z,
                rad = sph[4 * k + 3];
    const float b = ocx * ux + ocy * uy + ocz * uz;
    const float c2 = ocx * ocx + ocy * ocy + ocz * ocz - rad * rad;
    const float descrim = b * b - c2;
    const float dsq = sqrtf(nmax(descrim, 0.0f));
    const float t1 = -b - dsq, t2 = -b + dsq;
    occ = occ || ((nmin(t1, t2) > 1e-3f) && (t1 <= dist) && (descrim > 0.0f));
  }
  return occ;
}

// ops/spheres.hit for one sphere (reference src/sphere.rs:48-72) of
// center c and radius rad: the nearer valid root in (1e-4, t_max], else
// MISS.
__device__ __forceinline__ float sphere_hit(float ox, float oy, float oz,
                                            float dx, float dy, float dz,
                                            float3 c, float rad,
                                            float t_max) {
  const float ocx = ox - c.x, ocy = oy - c.y, ocz = oz - c.z;
  const float b = ocx * dx + ocy * dy + ocz * dz;
  const float cc = ocx * ocx + ocy * ocy + ocz * ocz - rad * rad;
  const float descrim = b * b - cc;
  const bool desc_pos = descrim > 0.0f;
  const float ds = sqrtf(nmax(descrim, 0.0f));
  const float t1 = -b - ds, t2 = -b + ds;
  const bool t1v = (t1 > 1e-4f) && (t1 <= t_max) && desc_pos;
  const bool t2v = (t2 > 1e-4f) && (t2 <= t_max) && desc_pos;
  return t1v ? t1 : (t2v ? t2 : MISS_F);
}

// shade_pallas._eval_f: f(wo, wi) for NEE; is-kind masks multiply every
// lobe, as in the Pallas body.
__device__ __forceinline__ void eval_f(int kind, float car, float cag,
                                       float cab, float power, float wox,
                                       float woy, float woz, float wix,
                                       float wiy, float wiz, float nx,
                                       float ny, float nz, float& fr,
                                       float& fg, float& fb) {
  const float d = nmax(0.0f, wix * nx + wiy * ny + wiz * nz);
  const float one_minus = 1.0f - d;
  const float om2 = one_minus * one_minus;
  const float om5 = om2 * om2 * one_minus;
  const float fresnel = F0_F + ONE_MINUS_F0_F * om5;
  const float hx = wox + wix, hy = woy + wiy, hz = woz + wiz;
  const float hlen = sqrtf(hx * hx + hy * hy + hz * hz);
  const float hinv = 1.0f / nmax(hlen, 1e-20f);
  const float hdn = nmax(0.0f, (hx * nx + hy * ny + hz * nz) * hinv);
  const float cos_alpha = powf(hdn, power);
  const float spec_factor = cos_alpha * (power + 2.0f) / TWO_PI_F;
  const float spec_f = spec_factor * fresnel;
  const float one_minus_f = 1.0f - fresnel;
  const float is_lam = kind == 0 ? 1.0f : 0.0f;
  const float is_diel = kind == 1 ? 1.0f : 0.0f;
  const float is_met = kind == 4 ? 1.0f : 0.0f;
  const float c[3] = {car, cag, cab};
  float f[3];
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    const float lam = c[ch] * INV_PI_F;
    const float diel = spec_f + c[ch] * INV_PI_F * one_minus_f;
    const float met = (c[ch] + (1.0f - c[ch]) * om5) * spec_factor;
    f[ch] = is_lam * lam + is_diel * diel + is_met * met;
  }
  fr = f[0];
  fg = f[1];
  fb = f[2];
}

// ops/bsdf.eval_f, the unfused bounce's NEE BSDF, in its own op order:
// c / pi, the half vector divided by its clamped length, (1 - d)^5 as
// powf(1 - d, schlick_exp) with schlick_exp = 5 at run time (torch's CUDA
// pow of a tensor by the scalar 5), and the lobe picked by kind.
__device__ __forceinline__ void eval_f_unfused(
    int kind, float car, float cag, float cab, float power,
    float schlick_exp, float wox, float woy, float woz, float wix,
    float wiy, float wiz, float nx, float ny, float nz, float& fr,
    float& fg, float& fb) {
  const float d = nmax(0.0f, wix * nx + wiy * ny + wiz * nz);
  const float m = 1.0f - d;
  const float m2 = m * m;
  const float fresnel = F0_F + ONE_MINUS_F0_F * (m2 * m2 * m);
  const float hx = wox + wix, hy = woy + wiy, hz = woz + wiz;
  const float hmag = nmax(sqrtf(hx * hx + hy * hy + hz * hz), 1e-20f);
  const float hdn =
      nmax((hx / hmag) * nx + (hy / hmag) * ny + (hz / hmag) * nz, 0.0f);
  const float spec_factor = powf(hdn, power) * (power + 2.0f) / TWO_PI_F;
  const float spec_f = spec_factor * fresnel;
  const float m5 = powf(m, schlick_exp);
  const float c[3] = {car, cag, cab};
  float f[3];
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    const float lam = c[ch] / PI_F;
    if (kind == 0)
      f[ch] = lam;
    else if (kind == 1)
      f[ch] = spec_f + lam * (1.0f - fresnel);
    else if (kind == 4)
      f[ch] = (c[ch] + (1.0f - c[ch]) * m5) * spec_factor;
    else
      f[ch] = 0.0f;
  }
  fr = f[0];
  fg = f[1];
  fb = f[2];
}

// shade_pallas._power_heuristic (reference src/math.rs:193-199).
__device__ __forceinline__ float power_heuristic(float nf, float f_pdf,
                                                 float ng, float g_pdf) {
  const float f = nf * f_pdf, g = ng * g_pdf;
  return f * f / (f * f + g * g);
}

// shade_pallas._eval_pdf: the solid-angle pdf with which scatter() would
// have sampled wi (MIS weights only); 0 for kinds that take no NEE.
__device__ __forceinline__ float eval_pdf(int compat_reflect, int kind,
                                          float power, float wox, float woy,
                                          float woz, float wix, float wiy,
                                          float wiz, float nx, float ny,
                                          float nz) {
  const float cos_i = nmax(0.0f, wix * nx + wiy * ny + wiz * nz);
  const float lambert_pdf = cos_i / PI_F;
  const float diffuse_pdf = nmax(1e-5f, lambert_pdf);
  const float won = wox * nx + woy * ny + woz * nz;
  float rx, ry, rz;
  if (compat_reflect) {
    rx = wox - 2.0f * won * nx;
    ry = woy - 2.0f * won * ny;
    rz = woz - 2.0f * won * nz;
  } else {
    rx = 2.0f * won * nx - wox;
    ry = 2.0f * won * ny - woy;
    rz = 2.0f * won * nz - woz;
  }
  const float cos_alpha = nmax(0.0f, rx * wix + ry * wiy + rz * wiz);
  const float cos_alpha_pow = nmax(powf(cos_alpha, power), F32_EPS_F);
  const float spec_pdf = (power + 1.0f) / TWO_PI_F * cos_alpha_pow;
  const float one_m = 1.0f - fabsf(won);
  const float om2 = one_m * one_m;
  const float fresnel = F0_F + ONE_MINUS_F0_F * (om2 * om2 * one_m);
  const float diel_pdf = fresnel * spec_pdf + (1.0f - fresnel) * diffuse_pdf;
  if (kind == 0) return lambert_pdf;
  if (kind == 1) return diel_pdf;
  if (kind == 4) return spec_pdf;
  return 0.0f;
}

__device__ __forceinline__ void concentric_disk(float u, float v, float& x,
                                                float& y) {
  const float a = u * 2.0f - 1.0f;
  float b = v * 2.0f - 1.0f;
  if (a == 0.0f && b == 0.0f) b = 1e-4f;
  const float a_safe = a == 0.0f ? 1.0f : a;
  const float phi1 = FRAC_PI_4_F * b / a_safe;
  const float phi2 = FRAC_PI_2_F - FRAC_PI_4_F * a / b;
  const bool take1 = (a * a) > (b * b);
  const float r = take1 ? a : b;
  const float phi = take1 ? phi1 : phi2;
  x = r * cosf(phi);
  y = r * sinf(phi);
}

__device__ __forceinline__ void norm3(float& x, float& y, float& z,
                                      float eps) {
  const float mag = sqrtf(x * x + y * y + z * z);
  const float inv = eps > 0.0f ? 1.0f / nmax(mag, eps) : 1.0f / mag;
  x = x * inv;
  y = y * inv;
  z = z * inv;
}

__device__ __forceinline__ void basis(const float uu[3], const float vv[3],
                                      float wx, float wy, float wz, float x,
                                      float y, float z, float& ox, float& oy,
                                      float& oz) {
  ox = x * uu[0] + y * vv[0] + z * wx;
  oy = x * uu[1] + y * vv[1] + z * wy;
  oz = x * uu[2] + y * vv[2] + z * wz;
}

// shade_pallas._scatter: BSDF importance sampling (reference
// src/material.rs:118-137 Lambert, :207-256 Dielectric, plus the working
// Metallic and Refractive variants). Returns wi, f and pdf.
__device__ __forceinline__ void scatter(
    int compat_reflect, int compat_phi, int kind, float car, float cag, float cab,
    float power, float ior, float wox, float woy, float woz, float nx,
    float ny, float nz, float u_f, float u_d1, float u_d2, float u_s1,
    float u_s2, float& wix, float& wiy, float& wiz, float& fr, float& fg,
    float& fb, float& pdf) {
  float uu[3], vv[3];
  onb(nx, ny, nz, uu, vv);
  float dsx, dsy;
  concentric_disk(u_d1, u_d2, dsx, dsy);
  const float dsz = sqrtf(1.0f - nmin(dsx * dsx + dsy * dsy, 1.0f));
  float dbx, dby, dbz;
  basis(uu, vv, nx, ny, nz, dsx, dsy, dsz, dbx, dby, dbz);
  norm3(dbx, dby, dbz, 0.0f);
  const float lambert_pdf = dsz / PI_F;
  const float diffuse_pdf = nmax(1e-5f, lambert_pdf);

  const float won = wox * nx + woy * ny + woz * nz;
  float rx, ry, rz;
  if (compat_reflect) {
    rx = wox - 2.0f * won * nx;
    ry = woy - 2.0f * won * ny;
    rz = woz - 2.0f * won * nz;
  } else {
    rx = 2.0f * won * nx - wox;
    ry = 2.0f * won * ny - woy;
    rz = 2.0f * won * nz - woz;
  }
  float ru[3], rv[3];
  onb(rx, ry, rz, ru, rv);
  const float sa = powf(u_s1, 1.0f / (power + 1.0f));
  const float sb = sqrtf(nmax(1.0f - sa * sa, 0.0f));
  const float sphi = compat_phi ? (2.0f * u_s2) : (TWO_PI_F * u_s2);
  float sbx, sby, sbz;
  basis(ru, rv, rx, ry, rz, sb * cosf(sphi), sb * sinf(sphi), sa, sbx, sby,
        sbz);
  norm3(sbx, sby, sbz, 0.0f);
  const float cos_alpha_pow = nmax(powf(sa, power), F32_EPS_F);
  const float spec_pdf = (power + 1.0f) / TWO_PI_F * cos_alpha_pow;
  float spec_coeff = (power + 2.0f) / TWO_PI_F * cos_alpha_pow;
  if ((nx * sbx + ny * sby + nz * sbz) < 0.0f) spec_coeff = 0.0f;

  const float cosv = fabsf(won);
  const float one_m = 1.0f - cosv;
  const float om2 = one_m * one_m;
  const float fresnel = F0_F + ONE_MINUS_F0_F * (om2 * om2 * one_m);
  const bool take_spec = u_f < fresnel;
  const float diel_pdf = fresnel * spec_pdf + (1.0f - fresnel) * diffuse_pdf;

  const bool dsel = kind == 1 && take_spec;
  wix = dsel ? sbx : dbx;
  wiy = dsel ? sby : dby;
  wiz = dsel ? sbz : dbz;
  pdf = kind == 1 ? diel_pdf : lambert_pdf;
  fr = dsel ? spec_coeff : car * INV_PI_F;
  fg = dsel ? spec_coeff : cag * INV_PI_F;
  fb = dsel ? spec_coeff : cab * INV_PI_F;

  if (kind == 4) {  // Metallic
    const float om5 = om2 * om2 * one_m;
    wix = sbx;
    wiy = sby;
    wiz = sbz;
    pdf = spec_pdf;
    fr = (car + (1.0f - car) * om5) * spec_coeff;
    fg = (cag + (1.0f - cag) * om5) * spec_coeff;
    fb = (cab + (1.0f - cab) * om5) * spec_coeff;
  } else if (kind == 5) {  // Refractive
    const bool entering = won > 0.0f;
    const float nrx = entering ? nx : -nx, nry = entering ? ny : -ny,
                nrz = entering ? nz : -nz;
    const float eta = entering ? 1.0f / ior : ior;
    const float ci = fabsf(won);
    const float sin2_t = eta * eta * nmax(0.0f, 1.0f - ci * ci);
    const bool tir = sin2_t > 1.0f;
    const float cos_t = sqrtf(nmax(0.0f, 1.0f - sin2_t));
    const float k_eta = eta * ci - cos_t;
    float rfx = -wox * eta + nrx * k_eta, rfy = -woy * eta + nry * k_eta,
          rfz = -woz * eta + nrz * k_eta;
    norm3(rfx, rfy, rfz, 1e-20f);
    float f0r = (1.0f - ior) / (1.0f + ior);
    f0r = f0r * f0r;
    const float omc = 1.0f - ci;
    const float omc2 = omc * omc;
    const float fresnel_r = f0r + (1.0f - f0r) * (omc2 * omc2 * omc);
    const float wodn = wox * nrx + woy * nry + woz * nrz;
    const bool take_reflect = (u_f < fresnel_r) || tir;
    const float ax = take_reflect ? 2.0f * wodn * nrx - wox : rfx;
    const float ay = take_reflect ? 2.0f * wodn * nry - woy : rfy;
    const float az = take_reflect ? 2.0f * wodn * nrz - woz : rfz;
    float auu[3], avv[3];
    onb(ax, ay, az, auu, avv);
    float rwx, rwy, rwz;
    basis(auu, avv, ax, ay, az, dsx, dsy, dsz, rwx, rwy, rwz);
    norm3(rwx, rwy, rwz, 0.0f);
    const float refr_pdf = nmax(dsz / PI_F, 1e-6f);
    const float ndl_r = nmax(fabsf(rwx * nx + rwy * ny + rwz * nz), 1e-6f);
    const float scale_r = refr_pdf / ndl_r;
    wix = rwx;
    wiy = rwy;
    wiz = rwz;
    pdf = refr_pdf;
    fr = (take_reflect ? 1.0f : car) * scale_r;
    fg = (take_reflect ? 1.0f : cag) * scale_r;
    fb = (take_reflect ? 1.0f : cab) * scale_r;
  }
}

// The unit direction d and the length md of segment s->e.
__device__ __forceinline__ void segment_dir(float sx, float sy, float sz,
                                            float ex, float ey, float ez,
                                            float& dx, float& dy, float& dz,
                                            float& md) {
  const float gx = ex - sx, gy = ey - sy, gz = ez - sz;
  md = sqrtf(gx * gx + gy * gy + gz * gz);
  const float inv = 1.0f / md;
  dx = gx * inv;
  dy = gy * inv;
  dz = gz * inv;
}

// The entry of segment s->e with direction d (segment_dir) once its first
// DE dist0, taken at s, is known: md clipped to the bounding sphere when
// bv_r > 0, and the first march distance t0. False when the segment
// resolves at entry: a NaN first DE, or a miss of the bounding sphere.
__device__ __forceinline__ bool entry_from_de(float bv_r, float bv_r2,
                                              float sx, float sy, float sz,
                                              float dx, float dy, float dz,
                                              float dist0, float& md,
                                              float& t0) {
  if (isnan(dist0)) return false;
  t0 = dist0;
  if (bv_r > 0.0f) {
    const float b = sx * dx + sy * dy + sz * dz;
    const float c = sx * sx + sy * sy + sz * sz - bv_r2;
    const float disc = b * b - c;
    const float sq = sqrtf(nmax(disc, 0.0f));
    const float t_exit = -b + sq;
    if (disc <= 0.0f || t_exit <= 0.0f) return false;
    md = nmin(md, t_exit);
    t0 = nmax(dist0, nmax(-b - sq, 0.0f));
  }
  return true;
}

// march_pallas._segment_entry (reference src/sdf.rs:25-57) for segment
// s->e of SDF instance `inst` with bounding radius bv_r: its direction d,
// its march length md and its first march distance t0 (entry_from_de on
// the DE at s).
template <class S>
__device__ __forceinline__ bool segment_entry(const MBox& mb, const Sdf& sdf,
                                              int inst, float bv_r,
                                              float bv_r2, float sx, float sy,
                                              float sz, float ex, float ey,
                                              float ez, float& dx, float& dy,
                                              float& dz, float& md,
                                              float& t0) {
  segment_dir(sx, sy, sz, ex, ey, ez, dx, dy, dz, md);
  return entry_from_de(bv_r, bv_r2, sx, sy, sz, dx, dy, dz,
                       S::de(mb, sdf, inst, sx, sy, sz), md, t0);
}

// Relax-1 occlusion step number `step` at t, whose DE `dist` at s + t*d
// has been taken: true when the segment resolves here, with `occ` its
// verdict (hit before its end; a segment past its end or out of steps is
// unblocked); else t advances by dist.
__device__ __forceinline__ bool occl_step(float dist, float md, float eps_c,
                                          float eps_l, int step,
                                          int max_steps, float& t,
                                          bool& occ) {
  const bool gt_end = t > md;
  const bool hit = fabsf(dist) < nmax(eps_c, eps_l * t);
  occ = hit && !gt_end;
  if (hit || gt_end || step + 1 >= max_steps) return true;
  t = t + dist;
  return false;
}

// Relaxed occlusion step number `step` (march.py march_occlusion's
// relaxed branch, march_pallas._occl_kernel body_r) at t, whose DE `dist`
// at s + t*d has been taken; t_prev and r_prev are the last accepted t and
// its DE (0 and the first t at entry). True when the segment resolves
// here, with `occ` its verdict: a hit (never on an overshoot) before its
// end; a segment past its end (tested on t before the step) or out of
// steps is unblocked. Else t advances by relax * dist, or falls back to
// t_prev + r_prev after an overshoot.
__device__ __forceinline__ bool occl_step_relaxed(
    float dist, float md, float eps_c, float eps_l, float relax, int step,
    int max_steps, float& t, float& t_prev, float& r_prev, bool& occ) {
  const bool gt_end = t > md;
  const bool overshoot = (t - t_prev) > (fabsf(r_prev) + fabsf(dist));
  const bool hit = fabsf(dist) < nmax(eps_c, eps_l * t) && !overshoot;
  occ = hit && !gt_end;
  if (hit || gt_end || step + 1 >= max_steps) return true;
  if (overshoot) {
    t = t_prev + r_prev;
  } else {
    t_prev = t;
    r_prev = dist;
    t = t + relax * dist;
  }
  return false;
}

// The sort key's price of one segment for one SDF instance
// (shade_pallas._segment_cost): min(md / max(t0, 1e-6), max_steps), or 1
// for an inactive or entry-resolved segment or one that starts past its
// end.
template <class S>
__device__ __forceinline__ float segment_cost(const MBox& mb, const Sdf& sdf,
                                              int inst, float bv_r,
                                              float bv_r2, int max_steps,
                                              bool act, float sx, float sy,
                                              float sz, float ex, float ey,
                                              float ez) {
  float dx, dy, dz, md, t0;
  if (!act ||
      !segment_entry<S>(mb, sdf, inst, bv_r, bv_r2, sx, sy, sz, ex, ey, ez,
                        dx, dy, dz, md, t0) ||
      t0 > md)
    return 1.0f;
  return nmin(md / nmax(t0, 1e-6f), (float)max_steps);
}

// A segment's price summed over the SDF instances (the fold marches every
// instance over a still-unblocked segment), from 0 in instance order, as
// shade_pallas._shadow_cost_key's seg_cost; MBoxOnly prices its one
// instance with the bound radius bv_r, Tape each instance with its own.
template <class S>
__device__ __forceinline__ float instances_cost(const MBox& mb,
                                                const Sdf& sdf, float bv_r,
                                                float bv_r2, int max_steps,
                                                bool act, float sx, float sy,
                                                float sz, float ex, float ey,
                                                float ez) {
  if constexpr (!S::kTape) {
    return segment_cost<S>(mb, sdf, 0, bv_r, bv_r2, max_steps, act, sx, sy,
                           sz, ex, ey, ez);
  } else {
    float c = 0.0f;
    for (int i = 0; i < sdf.n_inst; ++i)
      c = c + segment_cost<S>(mb, sdf, i, sdf.inst[i].bv_r,
                              sdf.inst[i].bv_r2, max_steps, act, sx, sy, sz,
                              ex, ey, ez);
    return c;
  }
}

// ------------------------------------------------ compacted queue, refill
constexpr unsigned FULL_MASK = 0xffffffffu;

// Appends the ids of the warp's active segments to the queue with one
// atomicAdd on the shared count. Every lane of the warp calls it.
__device__ __forceinline__ void enqueue(bool act, int id, int* count,
                                        int* queue) {
  const unsigned m = __ballot_sync(FULL_MASK, act);
  if (m == 0u) return;
  const int lane = threadIdx.x & 31;
  const int leader = __ffs(m) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(count, __popc(m));
  base = __shfl_sync(FULL_MASK, base, leader);
  if (act) queue[base + __popc(m & ((1u << lane) - 1u))] = id;
}

// The refill march's queue, verdicts and scalars (ops/shade_cuda.py and
// ops/march_cuda.py _QueueMarch).
struct QueueMarch {
  const int* queue;    // [M] ids of the segments to march, any order
  const int* count;    // [1] ids in the queue
  int* head;           // [1] queue slots handed out (0 at launch)
  bool* verdict;       // [M] out: the SDF blocks the segment (false at launch)
  long long m;         // M
  int max_steps;
  MBox mb;
  float eps_c, eps_l;  // 1e-4 * detail, 1e-5 * detail
  float relax;
  // bounding-sphere clip radius (0 = none) and its square: the MBoxOnly
  // march's; the Tape march reads each instance's own
  float bv_r, bv_r2;
};

// Segment loaders of the refill march: the segment scratch [6, M]
// (start xyz, end xyz; shade.cu), or start and end [M, 3] (march.cu).
struct SoaSegments {
  const float* geom;
  long long m;
  __device__ __forceinline__ void load(int id, float& sx, float& sy,
                                       float& sz, float& ex, float& ey,
                                       float& ez) const {
    sx = geom[id];
    sy = geom[m + id];
    sz = geom[2 * m + id];
    ex = geom[3 * m + id];
    ey = geom[4 * m + id];
    ez = geom[5 * m + id];
  }
};

struct AosSegments {
  const float* start;
  const float* end;
  __device__ __forceinline__ void load(int id, float& sx, float& sy,
                                       float& sz, float& ex, float& ey,
                                       float& ez) const {
    const long long j = 3LL * id;
    sx = start[j];
    sy = start[j + 1];
    sz = start[j + 2];
    ex = end[j];
    ey = end[j + 1];
    ez = end[j + 2];
  }
};

// Step policies of the refill march: a lane's step state past its t.
struct PlainStep {
  __device__ __forceinline__ void enter(float) {}
  __device__ __forceinline__ bool operator()(float dist, float md,
                                             float eps_c, float eps_l,
                                             int step, int max_steps,
                                             float& t, bool& occ) {
    return occl_step(dist, md, eps_c, eps_l, step, max_steps, t, occ);
  }
};

struct RelaxedStep {
  float relax, t_prev, r_prev;
  __device__ __forceinline__ void enter(float t0) {
    t_prev = 0.0f;
    r_prev = t0;
  }
  __device__ __forceinline__ bool operator()(float dist, float md,
                                             float eps_c, float eps_l,
                                             int step, int max_steps,
                                             float& t, bool& occ) {
    return occl_step_relaxed(dist, md, eps_c, eps_l, relax, step, max_steps,
                             t, t_prev, r_prev, occ);
  }
};

// The SDF verdict of every queued segment, written to the segment's own
// slot, so the queue's order never changes a result. Persistent blocks:
// each lane takes a segment id from the queue, marches it (the entry of
// segment_entry, then one step of the policy until it resolves), writes
// its verdict and takes the next id. A warp takes 32 queue slots at a
// time with one atomicAdd and hands them to its idle lanes in lane order.
// Every iteration evaluates one DE per busy lane; the first DE of a
// segment is taken at its start (s + 0*d would be NaN for a zero-length
// segment). The queue's length is read on the device. FirstDe is the
// entry of the JAX two-phase occlusion with no phase-1 step
// (march_pallas.py:518): a segment whose first DE is below a literal 1e-4
// and that does not start past its end is blocked at once, and with
// max_steps 0 no segment steps on.
// S is the SDF kind (MBoxOnly or TapeSdf). With several instances a segment
// is marched through instance 0, 1, ... in turn, each with its own bound
// radius: one that an instance leaves unblocked goes on to the next in
// place (its entry DE is the next iteration's), so the verdict is the
// product fold of intersect.test_occluded and one launch covers every
// instance.
template <class Segments, class Step, bool FirstDe = false,
          class S = MBoxOnly>
__device__ __forceinline__ void refill_march(const Segments& segs,
                                             const QueueMarch& a,
                                             const Sdf& sdf, Step st) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const int total = *a.count;
  int id = -1;         // this lane's segment, -1 while idle
  bool entry = false;  // its next DE is the entry DE, at the start
  int step = 0;
  int inst = 0;        // the SDF instance it is marched through (Tape)
  float sx = 0.0f, sy = 0.0f, sz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 0.0f,
        md = 0.0f, t = 0.0f;
  // the warp's batch of queue slots: `batch` ids, the one of slot `lane`
  // in `mine`; slots below `taken` are handed out
  int mine = -1, batch = 0, taken = 0;
  bool drained = false;
  for (;;) {
    unsigned idle = __ballot_sync(FULL_MASK, id < 0);
    while (idle != 0u && !drained) {
      if (taken == batch) {
        int base = 0;
        if (lane == 0) base = atomicAdd(a.head, 32);
        base = __shfl_sync(FULL_MASK, base, 0);
        batch = min(32, total - base);
        if (batch <= 0) {
          drained = true;
          break;
        }
        taken = 0;
        mine = lane < batch ? a.queue[base + lane] : -1;
      }
      const int slot = taken + __popc(idle & below);
      const int got = __shfl_sync(FULL_MASK, mine, slot & 31);
      if (id < 0 && slot < batch) {
        id = got;
        entry = true;
        step = 0;
        inst = 0;
        float ex, ey, ez;
        segs.load(id, sx, sy, sz, ex, ey, ez);
        segment_dir(sx, sy, sz, ex, ey, ez, dx, dy, dz, md);
      }
      taken = min(batch, taken + __popc(idle));
      idle = __ballot_sync(FULL_MASK, id < 0);
    }
    if (idle == FULL_MASK) return;  // the queue is drained
    if (id >= 0) {
      const float px = entry ? sx : sx + t * dx;
      const float py = entry ? sy : sy + t * dy;
      const float pz = entry ? sz : sz + t * dz;
      const float dist = S::de(a.mb, sdf, inst, px, py, pz);
      bool done, occ = false;
      if (entry) {
        entry = false;
        float bv_r = a.bv_r, bv_r2 = a.bv_r2;
        if constexpr (S::kTape) {
          bv_r = sdf.inst[inst].bv_r;
          bv_r2 = sdf.inst[inst].bv_r2;
        }
        done = !entry_from_de(bv_r, bv_r2, sx, sy, sz, dx, dy, dz, dist, md,
                              t);
        if constexpr (FirstDe) {
          if (!done) {
            occ = dist < 1e-4f && !(t > md);
            done = occ || a.max_steps <= 0;
          }
        }
        st.enter(t);
      } else {
        done = st(dist, md, a.eps_c, a.eps_l, step, a.max_steps, t, occ);
        ++step;
      }
      bool next = false;  // unblocked: the next instance marches it
      if constexpr (S::kTape) next = done && !occ && inst + 1 < sdf.n_inst;
      if (next) {
        ++inst;
        entry = true;
        step = 0;
        float ex, ey, ez;  // md again, unclipped
        segs.load(id, sx, sy, sz, ex, ey, ez);
        segment_dir(sx, sy, sz, ex, ey, ez, dx, dy, dz, md);
      } else if (done) {
        a.verdict[id] = occ;
        id = -1;
      }
    }
  }
}

__host__ inline unsigned blocks_of(long long n, int threads) {
  return (unsigned)((n + threads - 1) / threads);
}

// Launches a refill-march kernel of 128 threads a block on as many
// blocks as fit on the card at once, at most max_per_sm an SM when it is
// above 0 (fewer for a short queue); each block runs until the queue is
// drained.
template <class Args>
__host__ cudaError_t launch_persistent(void (*kernel)(Args), const Args& a,
                                       long long m, cudaStream_t stream,
                                       int max_per_sm = 0) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 128,
                                                        0);
  if (err != cudaSuccess) return err;
  if (max_per_sm > 0 && per_sm > max_per_sm) per_sm = max_per_sm;
  const unsigned resident = (unsigned)(sms * (per_sm > 0 ? per_sm : 1));
  const unsigned needed = blocks_of(m, 128);
  kernel<<<resident < needed ? resident : needed, 128, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace rayn
