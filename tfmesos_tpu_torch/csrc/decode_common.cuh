// The decode math shared by flash_decode.cu (linear cache) and
// flash_decode_paged.cu (paged pool): the score tile of one staged key
// block and the online-softmax step against its values, so the two
// kernels cannot diverge.  The counterpart of the JAX package's
// _decode_block_scores and _decode_accumulate
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
// A CTA holds R <= ROW_TILE query rows of one (kv head, batch row) —
// rows t-major over the G = H / KV query heads of the kv head, row r of
// the tile being chunk token (r0 + r) / G — and walks key blocks of up
// to `nk` positions, staged in shared memory as float32.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace tfm_decode {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
// Query rows per CTA: longer chunks tile their t * G rows over CTAs.
constexpr int ROW_TILE = 16;

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

// Shared-memory carve-up of one CTA: R rows of queries and accumulators,
// one staged block of nk keys (K padded to D + 1 against bank conflicts)
// with its scales, the score tile and per-row softmax state.
struct Smem {
  float *qs, *os, *ks, *vs, *kss, *vss, *ss, *ms, *ls, *cs;
  int* lim;
  __device__ Smem(float* base, int R, int nk, int D) {
    qs = base;                 // [R][D]
    os = qs + R * D;           // [R][D]
    ks = os + R * D;           // [nk][D + 1]
    vs = ks + nk * (D + 1);    // [nk][D]
    kss = vs + nk * D;         // [nk]
    vss = kss + nk;            // [nk]
    ss = vss + nk;             // [R][nk]
    ms = ss + R * nk;          // [R]
    ls = ms + R;               // [R]
    cs = ls + R;               // [R]
    lim = reinterpret_cast<int*>(cs + R);   // [R]
  }
};

__host__ __device__ inline long long smem_bytes(int R, int nk, int D) {
  return ((long long)2 * R * D + (long long)nk * (D + 1) +
          (long long)nk * D + 2LL * nk + (long long)R * nk + 4LL * R) * 4;
}

// Load this tile's R query rows (q contiguous [B, t, H, D]) and clear the
// accumulators.
template <typename TQ>
__device__ void load_rows(const TQ* q, const Smem& sm, int b, int t, int H,
                          int G, int kvh, int r0, int R, int D) {
  for (int idx = threadIdx.x; idx < R * D; idx += THREADS) {
    const int r = idx / D, d = idx % D;
    const int tt = (r0 + r) / G, gi = (r0 + r) % G;
    sm.qs[idx] =
        to_f(q[(((long long)b * t + tt) * H + kvh * G + gi) * D + d]);
    sm.os[idx] = 0.f;
  }
  for (int r = threadIdx.x; r < R; r += THREADS) {
    sm.ms[r] = -INFINITY;
    sm.ls[r] = 0.f;
  }
}

// Write o / l for this tile's rows into out (contiguous [B, t, H, D]); a
// row that saw no key writes zeros.
template <typename TQ>
__device__ void store_rows(TQ* out, const Smem& sm, int b, int t, int H,
                           int G, int kvh, int r0, int R, int D) {
  for (int idx = threadIdx.x; idx < R * D; idx += THREADS) {
    const int r = idx / D, d = idx % D;
    const int tt = (r0 + r) / G, gi = (r0 + r) % G;
    const float l = sm.ls[r];
    out[(((long long)b * t + tt) * H + kvh * G + gi) * D + d] =
        from_f<TQ>(l > 0.f ? sm.os[idx] / l : 0.f);
  }
}

// Stage n positions of K and V (row stride `stride` elements between
// positions, head_dim contiguous) and, when given, their per-position
// scales.  Ends with a barrier.
template <typename T>
__device__ void stage(const T* k, const T* v, long long stride,
                      const float* ksc, const float* vsc, const Smem& sm,
                      int n, int D) {
  for (int idx = threadIdx.x; idx < n * D; idx += THREADS) {
    const int p = idx / D, d = idx % D;
    sm.ks[p * (D + 1) + d] = to_f(k[p * stride + d]);
    sm.vs[idx] = to_f(v[p * stride + d]);
  }
  if (ksc != nullptr) {
    for (int p = threadIdx.x; p < n; p += THREADS) {
      sm.kss[p] = ksc[p];
      sm.vss[p] = vsc[p];
    }
  }
  __syncthreads();
}

// ss[r][p] = (q_r . k_p) * scale [* kss[p]] where kpos0 + p <= lim[r],
// else -inf.  Ends with a barrier.
__device__ inline void score_tile(const Smem& sm, bool kscaled, int kpos0,
                                  int R, int n, int D, float scale) {
  for (int idx = threadIdx.x; idx < R * n; idx += THREADS) {
    const int r = idx / n, p = idx % n;
    const float* qr = sm.qs + r * D;
    const float* kr = sm.ks + p * (D + 1);
    float dot = 0.f;
    for (int d = 0; d < D; ++d) dot += qr[d] * kr[d];
    float s = dot * scale;
    if (kscaled) s = s * sm.kss[p];
    sm.ss[r * n + p] = kpos0 + p > sm.lim[r] ? -INFINITY : s;
  }
  __syncthreads();
}

// One online-softmax step of the score tile against the staged V block
// of type TV: the running (m, l, o) of every row.  Handles all-masked
// tiles (no exp(-inf - -inf)).  Ends with a barrier.
template <typename TV>
__device__ void accumulate(const Smem& sm, int R, int n, int D) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  for (int r = warp; r < R; r += WARPS) {
    float* row = sm.ss + r * n;
    float mx = -INFINITY;
    for (int p = lane; p < n; p += 32) mx = fmaxf(mx, row[p]);
    mx = warp_max(mx);
    const float m_old = sm.ms[r];
    const float m_new = fmaxf(m_old, mx);
    float sum = 0.f;
    for (int p = lane; p < n; p += 32) {
      const float s = row[p];
      const float e = (s == -INFINITY) ? 0.f : expf(s - m_new);
      sum += e;
      row[p] = PV<TV>::operand(e, sm.vss, p);
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      const float corr = (m_old == -INFINITY) ? 0.f : expf(m_old - m_new);
      sm.ms[r] = m_new;
      sm.ls[r] = sm.ls[r] * corr + sum;
      sm.cs[r] = corr;
    }
  }
  __syncthreads();
  for (int idx = tid; idx < R * D; idx += THREADS) {
    const int r = idx / D, d = idx % D;
    const float* row = sm.ss + r * n;
    float acc = sm.os[idx] * sm.cs[r];
    for (int p = 0; p < n; ++p) acc += row[p] * sm.vs[p * D + d];
    sm.os[idx] = acc;
  }
  __syncthreads();
}

}  // namespace tfm_decode
