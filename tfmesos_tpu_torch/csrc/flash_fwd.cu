// Flash-attention forward for Hopper (sm_90a): bf16 operands on the
// tensor cores, fp32 operands on the FMA units; fp32 accumulation.
//
// Replaces: tfmesos_tpu/ops/attention.py, _flash_kernel (called through
// _flash_forward / flash_attention) — the TPU kernel that carries the
// prompt prefill and the training/eval forward.
//
// What it computes: o = softmax(scale * q k^T + mask) v per (batch, head),
// q [B, Tq, H, D], k/v [B, Tk, KV, D] (GQA: q head h reads kv head h / G,
// G = H / KV, through strides — the repeat is never materialized), causal
// or full, optional sliding window and a static q_offset (query row i is
// global position i + q_offset), plus the per-row logsumexp
// lse [B, H, Tq] fp32.  A row that sees no key gives o = 0 and
// lse = -inf, as the TPU kernel does.  The ragged Tq/Tk edge is masked
// here, so any length runs.
//
// What bounds it on this card: at the serving prefill shapes
// (B=1, T<=1024, H=8, D=64) the FLOPs (~T^2*H*D) need ~0.1-0.5 us at
// 989 TFLOP/s and the few MB of operands ~1 us at 3.35 TB/s, so the
// least time is a few microseconds — the kernel is latency-bound, far
// from either peak, and its grid (T/64 x H x B CTAs) is smaller than the
// 132 SMs at the shorter prompts.
//
// What this design does about it: one CTA per (64-row q block, head,
// batch) and the loop runs only over the K/V tiles the causal/window
// mask can reach.  For bf16 (the serving dtype) each of the CTA's 4 warps
// owns 16 query rows and runs both products on the tensor cores with
// mma.sync m16n8k16 (bf16 in, fp32 accumulate): q stays in registers as
// A fragments, each 64-key K tile and its transposed V tile sit in
// padded shared memory (conflict-free fragment loads), the scores' fp32
// accumulators are re-packed in registers as the bf16 A operand of the
// P·V product (P rounds to bf16 there, as the TPU kernel's
// p.astype(v.dtype) does), and the online softmax keeps m/l/o in fp32.
// For fp32 operands a simple FMA kernel runs: two threads per query row,
// each owning an interleaved half of head_dim.  wgmma/TMA pipelining and
// splitting short prompts over more CTAs are later work; PERF.md records
// the distance to the bound.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

using tfm::bf16;
using tfm::mma_bf16_smem;
using tfm::pack_a;

constexpr int BQ = 64;        // query rows per CTA
constexpr int THREADS = 128;  // 4 warps

struct Geometry {
  int Tq, Tk, H, G;
  long long sqb, sqt, sqh, skb, skt, skh;
  int causal, window, q_offset;
  float scale;
};

// Keys query rows [r0, r0 + BQ) can see: [lo, hi).
__device__ __forceinline__ void key_range(const Geometry& g, int r0, int* lo,
                                          int* hi) {
  *lo = 0;
  *hi = g.Tk;
  if (g.causal) {
    *hi = min(g.Tk, r0 + BQ + g.q_offset);
    if (g.window > 0) *lo = max(0, r0 + g.q_offset - (g.window - 1));
  }
}

__device__ __forceinline__ bool masked(const Geometry& g, int qrow, int kp) {
  if (kp >= g.Tk) return true;
  if (!g.causal) return false;
  const int qpos = qrow + g.q_offset;
  return kp > qpos || (g.window > 0 && kp < qpos - (g.window - 1));
}

// ---------------------------------------------------------------- bf16 ---

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     float* __restrict__ lse, Geometry g) {
  constexpr int BK = 64;           // keys per tile
  constexpr int KS = D / 16;       // k-steps of S = Q K^T over head_dim
  constexpr int NS = BK / 8;       // 8-key n-tiles of S
  constexpr int NO = D / 8;        // 8-dim n-tiles of O
  constexpr int PAD = 8;           // row padding: conflict-free fragments
  __shared__ __align__(16) bf16 ks[BK][D + PAD];     // [key][d]
  __shared__ __align__(16) bf16 vt[D][BK + PAD];     // [d][key]

  const int qb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / g.G;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, tg = lane & 3;           // mma group / thread
  const int r0 = qb * BQ;
  const int row_lo = r0 + warp * 16 + gr, row_hi = row_lo + 8;

  // Q as A fragments, kept in registers for the whole key loop.
  uint32_t qa[KS][4];
  const bf16* qbase = q + b * g.sqb + h * g.sqh;
#pragma unroll
  for (int s = 0; s < KS; ++s) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = (i & 1) ? row_hi : row_lo;
      const int d = s * 16 + tg * 2 + ((i & 2) ? 8 : 0);
      qa[s][i] = row < g.Tq ? *reinterpret_cast<const uint32_t*>(
                                  qbase + (long long)row * g.sqt + d)
                            : 0u;
    }
  }

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};   // this thread's partial row sums

  int lo, hi;
  key_range(g, r0, &lo, &hi);
  const bf16* kbase = k + b * g.skb + kvh * g.skh;
  const bf16* vbase = v + b * g.skb + kvh * g.skh;
  for (int k0 = (lo / BK) * BK; k0 < hi; k0 += BK) {
    __syncthreads();                         // previous tile consumed
    for (int idx = tid; idx < BK * D / 2; idx += THREADS) {
      const int j = idx / (D / 2), d = (idx % (D / 2)) * 2;
      const int kp = k0 + j;
      uint32_t kk = 0u, vv = 0u;
      if (kp < g.Tk) {
        kk = *reinterpret_cast<const uint32_t*>(kbase + kp * g.skt + d);
        vv = *reinterpret_cast<const uint32_t*>(vbase + kp * g.skt + d);
      }
      *reinterpret_cast<uint32_t*>(&ks[j][d]) = kk;
      const __nv_bfloat162 v2 = *reinterpret_cast<const __nv_bfloat162*>(&vv);
      vt[d][j] = v2.x;
      vt[d + 1][j] = v2.y;
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys.
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int t = 0; t < KS; ++t) {
        mma_bf16_smem(s[n], qa[t], &ks[n * 8 + gr][t * 16 + tg * 2]);
      }
    }
    // Scale, mask, and the tile's row maxima (rows lo: c0/c1, hi: c2/c3).
    float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = (i < 2) ? row_lo : row_hi;
        const int kp = k0 + n * 8 + tg * 2 + (i & 1);
        s[n][i] = masked(g, row, kp) ? -INFINITY : s[n][i] * g.scale;
        mt[i >> 1] = fmaxf(mt[i >> 1], s[n][i]);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
      const float m_new = fmaxf(m[r], mt[r]);
      // Guarded: a row with nothing visible yet keeps m = -inf, and
      // exp(-inf - -inf) must read as 0, not NaN.
      corr[r] = (m[r] == -INFINITY) ? 0.f : expf(m[r] - m_new);
      m[r] = m_new;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = (s[n][i] == -INFINITY) ? 0.f
                                               : expf(s[n][i] - m[i >> 1]);
        s[n][i] = p;
        l[i >> 1] += p;
      }
    }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }
    // O += P V: the S accumulators re-packed as bf16 A fragments.
#pragma unroll
    for (int t = 0; t < BK / 16; ++t) {
      uint32_t pa[4];
      pack_a(pa, s[2 * t], s[2 * t + 1]);
#pragma unroll
      for (int n = 0; n < NO; ++n)
        mma_bf16_smem(acc[n], pa, &vt[n * 8 + gr][t * 16 + tg * 2]);
    }
  }

  // Full row sums: the 4 threads of an mma group share each row.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r ? row_hi : row_lo;
    if (row >= g.Tq) continue;
    const bool empty = l[r] == 0.f;
    const float inv = empty ? 0.f : 1.f / l[r];
    bf16* orow = o + (((long long)b * g.Tq + row) * g.H + h) * D;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<uint32_t*>(orow + n * 8 + tg * 2) =
          tfm::pack_bf16(acc[n][2 * r] * inv, acc[n][2 * r + 1] * inv);
    if (tg == 0)
      lse[((long long)b * g.H + h) * g.Tq + row] =
          empty ? -INFINITY : m[r] + logf(l[r]);
  }
}

// ---------------------------------------------------------------- fp32 ---

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_fma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, Geometry g) {
  constexpr int DH = D / 2;                 // dims per thread
  constexpr int BK = D <= 64 ? 64 : 32;     // keys per shared tile
  __shared__ float ks[BK][D + 1];
  __shared__ float vs[BK][D + 1];

  const int qb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / g.G;
  const int tid = threadIdx.x;
  const int r = tid >> 1;                   // query row in the block
  const int part = tid & 1;                 // which interleaved half of D
  const int r0 = qb * BQ;
  const int qrow = r0 + r;
  const bool row_ok = qrow < g.Tq;

  float qreg[DH], acc[DH];
  const float* qp =
      q + b * g.sqb + (long long)(row_ok ? qrow : 0) * g.sqt + h * g.sqh;
#pragma unroll
  for (int i = 0; i < DH; ++i) {
    qreg[i] = row_ok ? qp[2 * i + part] : 0.f;
    acc[i] = 0.f;
  }

  int lo, hi;
  key_range(g, r0, &lo, &hi);
  float m = -INFINITY, l = 0.f;
  for (int k0 = (lo / BK) * BK; k0 < hi; k0 += BK) {
    __syncthreads();                        // previous tile consumed
    for (int idx = tid; idx < BK * D; idx += THREADS) {
      const int j = idx / D, d = idx % D;
      const int kp = k0 + j;
      float kk = 0.f, vv = 0.f;
      if (kp < g.Tk) {
        const long long off = b * g.skb + (long long)kp * g.skt +
                              kvh * g.skh + d;
        kk = k[off];
        vv = v[off];
      }
      ks[j][d] = kk;
      vs[j][d] = vv;
    }
    __syncthreads();

    float s[BK];
    float mt = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < DH; ++i) dot += qreg[i] * ks[j][2 * i + part];
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      s[j] = masked(g, qrow, k0 + j) ? -INFINITY : dot * g.scale;
      mt = fmaxf(mt, s[j]);
    }
    const float m_new = fmaxf(m, mt);
    const float corr = (m == -INFINITY) ? 0.f : expf(m - m_new);
    float lsum = 0.f;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float p = (s[j] == -INFINITY) ? 0.f : expf(s[j] - m_new);
      s[j] = p;
      lsum += p;
    }
    l = l * corr + lsum;
#pragma unroll
    for (int i = 0; i < DH; ++i) acc[i] *= corr;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
#pragma unroll
      for (int i = 0; i < DH; ++i) acc[i] += s[j] * vs[j][2 * i + part];
    }
    m = m_new;
  }

  if (!row_ok) return;
  const bool empty = l == 0.f;
  float* op = o + (((long long)b * g.Tq + qrow) * g.H + h) * D;
#pragma unroll
  for (int i = 0; i < DH; ++i) op[2 * i + part] = empty ? 0.f : acc[i] / l;
  if (part == 0)
    lse[((long long)b * g.H + h) * g.Tq + qrow] =
        empty ? -INFINITY : m + logf(l);
}

template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o,
                       void* lse, int B, const Geometry& g,
                       cudaStream_t stream) {
  dim3 grid((g.Tq + BQ - 1) / BQ, g.H, B);
  flash_fwd_mma_kernel<D><<<grid, THREADS, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(lse), g);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_fma(const void* q, const void* k, const void* v, void* o,
                       void* lse, int B, const Geometry& g,
                       cudaStream_t stream) {
  dim3 grid((g.Tq + BQ - 1) / BQ, g.H, B);
  flash_fwd_fma_kernel<D><<<grid, THREADS, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), g);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* tfm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q: [B, Tq, H, D] with element strides (sqb, sqt, sqh) and unit stride
// on D; k/v: [B, Tk, KV, D] sharing strides (skb, skt, skh); all strides
// even for bf16 (pairs of elements load as one 32-bit word).  o:
// contiguous [B, Tq, H, D] of q's type; lse: contiguous fp32 [B, H, Tq].
// window <= 0 means no window.  Returns cudaGetLastError() after the
// launch.
extern "C" int tfm_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, int B, int Tq, int Tk,
                             int H, int KV, int D, long long sqb,
                             long long sqt, long long sqh, long long skb,
                             long long skt, long long skh, int causal,
                             int window, int q_offset, float scale,
                             int is_bf16, void* stream) {
  if (KV <= 0 || H % KV != 0) return cudaErrorInvalidValue;
  const Geometry g{Tq, Tk, H, H / KV, sqb, sqt, sqh, skb, skt, skh,
                   causal, window, q_offset, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (is_bf16) {             // tensor cores: head_dim a multiple of 16
    switch (D) {
      case 16: err = launch_mma<16>(q, k, v, o, lse, B, g, s); break;
      case 32: err = launch_mma<32>(q, k, v, o, lse, B, g, s); break;
      case 64: err = launch_mma<64>(q, k, v, o, lse, B, g, s); break;
      case 128: err = launch_mma<128>(q, k, v, o, lse, B, g, s); break;
      default: err = cudaErrorInvalidValue;
    }
  } else {
    switch (D) {
      case 8: err = launch_fma<8>(q, k, v, o, lse, B, g, s); break;
      case 16: err = launch_fma<16>(q, k, v, o, lse, B, g, s); break;
      case 32: err = launch_fma<32>(q, k, v, o, lse, B, g, s); break;
      case 64: err = launch_fma<64>(q, k, v, o, lse, B, g, s); break;
      case 128: err = launch_fma<128>(q, k, v, o, lse, B, g, s); break;
      default: err = cudaErrorInvalidValue;
    }
  }
  return static_cast<int>(err);
}
