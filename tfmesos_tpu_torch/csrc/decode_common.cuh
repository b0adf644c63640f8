// The decode math shared by flash_decode.cu (linear cache) and
// flash_decode_paged.cu (paged pool): how a consumer warp scores its
// slice of a staged key block and takes the online-softmax step against
// its values, so the two kernels cannot diverge.  The counterpart of the
// JAX package's _decode_block_scores and _decode_accumulate
// (tfmesos_tpu/ops/attention.py:563-593), rounding where they round:
//
// * scores: q . k in float32 (an int8 K block widens exactly), times
//   `scale`, then times the block's per-position k-scale when int8;
//   positions past a row's limit are -inf;
// * the running sum l takes the unscaled, unrounded probabilities; then
//   p meets V as _decode_accumulate casts it: rounded to bf16 for a bf16
//   V block, unrounded for float32, and for an int8 V block (widened to
//   float32) unrounded after the per-position v-scale is folded in.
//
// A CTA holds RT query rows of one (kv head, batch row) — rows t-major
// over the G = H / KV query heads of the kv head, row r of the tile being
// chunk token (r0 + r) / G — and CWARPS consumer warps walk the key
// blocks (BLOCK_KEYS positions each, staged in shared memory in their
// stored type by a producer warp).  Each consumer warp owns KW keys of
// every block: D / 8 lanes per key, each lane 8 elements of head_dim read
// with one vector shared load, the dot finished by shuffles.  A warp
// keeps its own running (m, l, o) in registers and merges with the other
// warps once, after its last block (decode_split.cuh).  p is rounded
// against its warp's running max, not the whole row's: other bits than
// the JAX kernel, the same function.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "int8_round.cuh"

namespace tfm_decode {

constexpr int BLOCK_KEYS = 64;               // keys per block
constexpr int CWARPS = 4;                    // consumer warps
constexpr int THREADS = (CWARPS + 1) * 32;   // + one producer warp
constexpr int RT = 4;                        // query rows per CTA
constexpr int VEC = 8;                       // head_dim elements per lane
constexpr int KW = BLOCK_KEYS / CWARPS;      // keys per warp per block

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(int8_t x) { return (float)x; }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// p as it meets a V block of type TV in P.V (vss: the block's staged
// v-scales, int8 only).
template <typename TV> struct PV {
  static __device__ __forceinline__ float operand(float p, const float*,
                                                  int) {
    return p;
  }
};
template <> struct PV<__nv_bfloat16> {
  static __device__ __forceinline__ float operand(float p, const float*,
                                                  int) {
    return __bfloat162float(__float2bfloat16(p));
  }
};
template <> struct PV<int8_t> {
  static __device__ __forceinline__ float operand(float p, const float* vss,
                                                  int i) {
    return p * vss[i];
  }
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// 8 consecutive elements of T at p (aligned to their size) as floats.
template <typename T>
__device__ __forceinline__ void load8(const T* p, float* x);
template <>
__device__ __forceinline__ void load8<__nv_bfloat16>(const __nv_bfloat16* p,
                                                     float* x) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) x[i] = to_f(e[i]);
}
template <>
__device__ __forceinline__ void load8<float>(const float* p, float* x) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
template <>
__device__ __forceinline__ void load8<int8_t>(const int8_t* p, float* x) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const int8_t* e = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) x[i] = to_f(e[i]);
}

// How a warp's lanes cover head_dim D: LPK lanes a key, KPS keys a step,
// STEPS steps for the warp's KW keys of a block.
template <int D>
struct Lanes {
  static constexpr int LPK = D / VEC;
  static constexpr int KPS = 32 / LPK;
  static constexpr int STEPS = KW > KPS ? KW / KPS : 1;
};

// Load the tile's RT query rows (q contiguous [B, t, H, D], padding rows
// zero) into qs [RT][D] as float32.
template <typename TQ, int D>
__device__ __forceinline__ void load_rows(const TQ* q, float* qs, int b,
                                          int t, int H, int G, int kvh,
                                          int r0, int R) {
  for (int idx = threadIdx.x; idx < RT * D; idx += THREADS) {
    const int r = idx / D, d = idx % D;
    const int tt = (r0 + r) / G, gi = (r0 + r) % G;
    qs[idx] = r < R ? to_f(q[(((long long)b * t + tt) * H + kvh * G + gi) *
                             D + d])
                    : 0.f;
  }
}

// The 8 elements of a key slot this lane holds, replaced by the slot as
// an int8 slot holds it, back in TQ (ops/quant.py int8_round_trip):
// scale = absmax / 127 over the slot's D elements (its LPK lanes), then
// TQ(float(rint-clipped x / scale) * float(TQ(scale))) — exact in
// float32, rounded once.
template <typename TQ, int LPK>
__device__ __forceinline__ void round_slot(float* x) {
  float mx = 0.f;
#pragma unroll
  for (int e = 0; e < VEC; ++e) mx = fmaxf(mx, fabsf(x[e]));
#pragma unroll
  for (int off = 1; off < LPK; off <<= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  const float scale = tfm_int8::absmax_scale(mx);
  const float sq = to_f(from_f<TQ>(scale));
#pragma unroll
  for (int e = 0; e < VEC; ++e)
    x[e] = to_f(from_f<TQ>(tfm_int8::round_step(x[e] / scale) * sq));
}

// One consumer warp's running state over the CTA's RT rows: its lanes'
// slices of q and o ([li * VEC, + VEC) of head_dim), and per row the
// running max m and sum l of this lane group's keys.
template <int D>
struct WarpRows {
  float q[RT][VEC], o[RT][VEC], m[RT], l[RT];

  __device__ __forceinline__ void init(const float* qs, int lane) {
    const int li = lane % Lanes<D>::LPK;
#pragma unroll
    for (int r = 0; r < RT; ++r) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        q[r][e] = qs[r * D + li * VEC + e];
        o[r][e] = 0.f;
      }
      m[r] = -INFINITY;
      l[r] = 0.f;
    }
  }

  // The online-softmax step over this warp's keys [warp * KW, + KW) of
  // one staged block, for the tile's first NR rows (NR = 1 when the tile
  // has a single row, as a t = 1 step without GQA does: the padding
  // rows' products are never computed): n valid keys, key i at position
  // kpos0 + i, K and V of type TV at ks / vs ([BLOCK_KEYS][D]),
  // per-position scales kss / vss when TV is int8.  A row sees positions
  // <= lims[r].  A step of the warp with no valid key is skipped.
  // `as_int8` (a block of q's type only): each K and V slot is first
  // rounded as an int8 slot holds it (round_slot).
  template <int NR, typename TV>
  __device__ __forceinline__ void step(const int (&lims)[RT], const TV* ks,
                                       const TV* vs, const float* kss,
                                       const float* vss, int n, int kpos0,
                                       float scale, bool as_int8, int warp,
                                       int lane) {
    using Ln = Lanes<D>;
    constexpr bool kScaled = std::is_same<TV, int8_t>::value;
    const int li = lane % Ln::LPK, g = lane / Ln::LPK;
    // Scores of this warp's keys: sc[r][st] for key
    // warp * KW + st * KPS + g (invalid lanes keep -inf).
    float sc[NR][Ln::STEPS];
#pragma unroll
    for (int st = 0; st < Ln::STEPS; ++st) {
      const int kin = st * Ln::KPS + g;
      const int key = warp * KW + kin;
      const bool valid = kin < KW && key < n;
      if (warp * KW + st * Ln::KPS >= n) {        // the whole step: none
#pragma unroll
        for (int r = 0; r < NR; ++r) sc[r][st] = -INFINITY;
        continue;
      }
      float kx[VEC];
      load8<TV>(ks + (valid ? key : 0) * D + li * VEC, kx);
      if constexpr (!kScaled) {
        if (as_int8) round_slot<TV, Ln::LPK>(kx);
      }
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) dot += q[r][e] * kx[e];
#pragma unroll
        for (int off = 1; off < Ln::LPK; off <<= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        float s = dot * scale;
        if (kScaled) s = s * kss[valid ? key : 0];
        sc[r][st] = valid && kpos0 + key <= lims[r] ? s : -INFINITY;
      }
    }
    // The warp's running (m, l) per row; o rescaled once per block.
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      float mt = -INFINITY;
#pragma unroll
      for (int st = 0; st < Ln::STEPS; ++st) mt = fmaxf(mt, sc[r][st]);
#pragma unroll
      for (int off = Ln::LPK; off < 32; off <<= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m[r], mt);
      const float corr = m[r] == -INFINITY ? 0.f : expf(m[r] - m_new);
      m[r] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int st = 0; st < Ln::STEPS; ++st) {
        const float p =
            sc[r][st] == -INFINITY ? 0.f : expf(sc[r][st] - m_new);
        sc[r][st] = p;
        sum += p;
      }
      l[r] = l[r] * corr + sum;     // this lane group's keys only
#pragma unroll
      for (int e = 0; e < VEC; ++e) o[r][e] *= corr;
    }
#pragma unroll
    for (int st = 0; st < Ln::STEPS; ++st) {
      const int kin = st * Ln::KPS + g;
      const int key = warp * KW + kin;
      const bool valid = kin < KW && key < n;
      // round_slot's shuffles need every lane of a step that has a key.
      if (warp * KW + st * Ln::KPS >= n || (!valid && !as_int8)) continue;
      float vx[VEC];
      load8<TV>(vs + (valid ? key : 0) * D + li * VEC, vx);
      if constexpr (!kScaled) {
        if (as_int8) round_slot<TV, Ln::LPK>(vx);
      }
      if (valid) {
#pragma unroll
        for (int r = 0; r < NR; ++r) {
          const float pv = PV<TV>::operand(sc[r][st], vss, key);
#pragma unroll
          for (int e = 0; e < VEC; ++e) o[r][e] += pv * vx[e];
        }
      }
    }
  }

  // After the warp's last block: sum its lane groups (each holds its
  // keys' l and o; m is uniform) and leave (m, l, o) in shared memory:
  // wm, wl [CWARPS][RT], wo [CWARPS][RT][D].
  __device__ __forceinline__ void park(float* wm, float* wl, float* wo,
                                       int warp, int lane) {
    constexpr int LPK = Lanes<D>::LPK;
    const int li = lane % LPK, g = lane / LPK;
#pragma unroll
    for (int r = 0; r < RT; ++r) {
#pragma unroll
      for (int off = LPK; off < 32; off <<= 1) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], off);
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          o[r][e] += __shfl_xor_sync(0xffffffffu, o[r][e], off);
      }
      if (g == 0) {
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          wo[(warp * RT + r) * D + li * VEC + e] = o[r][e];
      }
      if (lane == 0) {
        wm[warp * RT + r] = m[r];
        wl[warp * RT + r] = l[r];
      }
    }
  }
};

}  // namespace tfm_decode
