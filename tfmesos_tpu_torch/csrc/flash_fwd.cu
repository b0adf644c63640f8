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
// What bounds it on this card: operations at the training shape
// ([8, 2048, 8, 64] causal: ~34 GFLOP, 0.035 ms at 989 TFLOP/s against
// ~17 MB, 0.005 ms at 3.35 TB/s), and for the short serving prefills
// (B = 1, T <= 1024) latency and a grid smaller than the 132 SMs.  The
// tensor cores reach their rate only through wgmma fed from shared
// memory that TMA keeps full; Ampere's mma.sync from registers loaded
// one 32-bit word at a time, behind a barrier per tile, ran the first
// version at ~43 TFLOP/s.
//
// What this design does about it (bf16, head_dim 64 or 128):
// * Warp specialization.  A CTA owns BQ = 128 query rows of one (head,
//   batch): two consumer warpgroups of 64 rows each, plus one producer
//   warp.  The producer issues TMA tile loads of Q (once) and of K/V
//   tiles (BK = 128 keys at head_dim 64, 64 at 128) into a 3-stage ring
//   under mbarriers (hopper_async.cuh); TMA zero-fills the ragged T edge.
//   The consumers release a stage through its `empty` barrier.  No
//   setmaxnreg: 288 threads leave each up to 224 registers, and the
//   consumers compile to ~150 (the -Xptxas -v report).
// * Tensor maps.  q [B, Tq, H, D] and k/v [B, Tk, KV, D] are 4-D tensor
//   maps with 128-byte swizzle (a 64-wide bf16 row is 128 bytes; D = 128
//   loads two 64-column panels), encoded on the host with
//   cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint(By-
//   Version): the libraries are not linked against libcuda.  A map is a
//   pure function of pointer, shape and strides, so the last 48 are kept
//   and a call on buffers seen before skips the encoder; the shared
//   memory limit is raised once per device.  The wrapper hands over
//   16-byte-aligned bases and strides (its stride rule).
// * Both products on wgmma (wgmma.cuh).  S = Q K^T reads Q and K from the
//   swizzled tiles; O += P V takes P from registers — the S accumulators
//   packed to bf16, which rounds P where the TPU kernel's
//   p.astype(v.dtype) does — and V from shared memory through the
//   transpose bit, so no transposed copy of V is made.
// * Masks only where they bite: a tile is masked only if it crosses the
//   diagonal, the window edge or Tk.  The exponent is exp2 with
//   scale * log2(e) folded into one multiply-add.
// * Heaviest first: the grid launches the causal q blocks with the most
//   keys first, so the short rows fill the tail.
// * Short prompts: where ceil(Tq / 128) x H x B CTAs cannot fill the
//   132 SMs (the serving prefills at B = 1, T <= ~1000) the wrapper picks
//   the one-consumer variant, BQ = 64 (a static rule on shapes).
// head_dim 16 and 32 in bf16 keep the mma.sync kernel (m16n8k16, 64 rows
// a CTA); float32 operands run a simple FMA kernel, two threads per
// query row.  No overlap of the softmax with the next tile's products
// inside a warpgroup yet; PERF.md records the distance to the bound.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <mutex>

#include "hopper_async.cuh"
#include "mma_bf16.cuh"
#include "wgmma.cuh"

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

// Keys query rows [r0, r0 + rows) can see: [lo, hi).
__device__ __forceinline__ void key_range_rows(const Geometry& g, int r0,
                                               int rows, int* lo, int* hi) {
  *lo = 0;
  *hi = g.Tk;
  if (g.causal) {
    *hi = min(g.Tk, r0 + rows + g.q_offset);
    if (g.window > 0) *lo = max(0, r0 + g.q_offset - (g.window - 1));
  }
}

__device__ __forceinline__ void key_range(const Geometry& g, int r0, int* lo,
                                          int* hi) {
  key_range_rows(g, r0, BQ, lo, hi);
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

// ---------------------------------------------------------- bf16 wgmma ---

constexpr int PANEL = 64;            // bf16 columns of one 128-byte row
constexpr float LN2 = 0.6931471805599453f;

template <int D> struct WgTile;
template <> struct WgTile<64> { static constexpr int BK = 128; };
template <> struct WgTile<128> { static constexpr int BK = 64; };

// Shared memory of the wgmma kernel with NWG consumer warpgroups, from a
// 1024-byte aligned base: Q [D/64 panels][BQ rows][128 B], then NST
// stages of K and of V [D/64 panels][BK rows][128 B], then the barriers.
template <int D, int NWG>
struct WgLayout {
  static constexpr int BK = WgTile<D>::BK, NST = 3, PANELS = D / PANEL;
  static constexpr int BQ = 64 * NWG;
  static constexpr int THREADS = 128 * NWG + 32;
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int T_BYTES = BK * D * 2;         // one K or V tile
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + NST * T_BYTES;
  static constexpr int BAR_OFF = V_OFF + NST * T_BYTES;
  static constexpr int BYTES = BAR_OFF + (2 * NST + 1) * 8 + 1024;
};

template <int BK>
__device__ __forceinline__ void mma_s(float (&s)[BK / 2], uint64_t da,
                                      uint64_t db, int scale_d);
template <>
__device__ __forceinline__ void mma_s<64>(float (&s)[32], uint64_t da,
                                          uint64_t db, int scale_d) {
  tfm_wgmma::mma_ss_n64(s, da, db, scale_d);
}
template <>
__device__ __forceinline__ void mma_s<128>(float (&s)[64], uint64_t da,
                                           uint64_t db, int scale_d) {
  tfm_wgmma::mma_ss_n128(s, da, db, scale_d);
}

template <int D>
__device__ __forceinline__ void mma_o(float (&o)[D / 2],
                                      const uint32_t (&a)[4], uint64_t db);
template <>
__device__ __forceinline__ void mma_o<64>(float (&o)[32],
                                          const uint32_t (&a)[4],
                                          uint64_t db) {
  tfm_wgmma::mma_rs_n64_tb(o, a, db);
}
template <>
__device__ __forceinline__ void mma_o<128>(float (&o)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  tfm_wgmma::mma_rs_n128_tb(o, a, db);
}

template <int D, int NWG>
__global__ void __launch_bounds__(WgLayout<D, NWG>::THREADS, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tmq,
                       const __grid_constant__ CUtensorMap tmk,
                       const __grid_constant__ CUtensorMap tmv,
                       bf16* __restrict__ o, float* __restrict__ lse,
                       Geometry g, float scale_log2) {
  using L = WgLayout<D, NWG>;
  constexpr int BK = L::BK, BQ = L::BQ, NST = L::NST;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* empty = full + NST;
  uint64_t* qbar = empty + NST;

  const int h = blockIdx.x, b = blockIdx.y;
  const int qb = gridDim.z - 1 - blockIdx.z;       // heaviest rows first
  const int kvh = h / g.G, r0 = qb * BQ;
  int lo, hi;
  key_range_rows(g, r0, BQ, &lo, &hi);
  const int kfirst = (lo / BK) * BK;
  const int ntiles = hi > kfirst ? (hi - kfirst + BK - 1) / BK : 0;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  if (tid == 0) {
    for (int i = 0; i < NST; ++i) {
      tfm_async::mbar_init(&full[i], 1);
      tfm_async::mbar_init(&empty[i], 4 * NWG);   // every consumer warp
    }
    tfm_async::mbar_init(qbar, 1);
    tfm_async::fence_barrier_init();
  }
  __syncthreads();

  if (warp == 4 * NWG) {
    // ---- producer: Q once, then the K/V tiles through the ring --------
    if (lane == 0) {
      tfm_async::mbar_arrive_expect_tx(qbar, L::Q_BYTES);
#pragma unroll
      for (int p = 0; p < L::PANELS; ++p)
        tfm_async::tma_load_4d(smem + p * BQ * 128, &tmq, p * PANEL, h, r0,
                               b, qbar);
      for (int i = 0; i < ntiles; ++i) {
        const int st = i % NST, k0 = kfirst + i * BK;
        if (i >= NST) tfm_async::mbar_wait(&empty[st], ((i / NST) - 1) & 1);
        tfm_async::mbar_arrive_expect_tx(&full[st], 2 * L::T_BYTES);
        unsigned char* kt = smem + L::K_OFF + st * L::T_BYTES;
        unsigned char* vt = smem + L::V_OFF + st * L::T_BYTES;
#pragma unroll
        for (int p = 0; p < L::PANELS; ++p) {
          tfm_async::tma_load_4d(kt + p * BK * 128, &tmk, p * PANEL, kvh, k0,
                                 b, &full[st]);
          tfm_async::tma_load_4d(vt + p * BK * 128, &tmv, p * PANEL, kvh, k0,
                                 b, &full[st]);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns rows [r0w, r0w + 64) --------------
  const int wg = warp / 4, wq = warp % 4;
  const int r0w = r0 + 64 * wg;
  int lo_w, hi_w;
  key_range_rows(g, r0w, 64, &lo_w, &hi_w);
  const bool rows_live = r0w < g.Tq;
  const int row0 = r0w + 16 * wq + lane / 4;        // and row0 + 8
  const int cq = 2 * (lane % 4);
  const unsigned char* qt = smem + wg * 64 * 128;

  float acc[D / 2];
#pragma unroll
  for (int j = 0; j < D / 2; ++j) acc[j] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};   // running max, log2 domain
  float l[2] = {0.f, 0.f};               // this thread's partial sums
  tfm_async::mbar_wait(qbar, 0);

  for (int i = 0; i < ntiles; ++i) {
    const int st = i % NST, k0 = kfirst + i * BK;
    tfm_async::mbar_wait(&full[st], (i / NST) & 1);
    if (rows_live && k0 < hi_w && k0 + BK > lo_w) {
      const unsigned char* kt = smem + L::K_OFF + st * L::T_BYTES;
      const unsigned char* vt = smem + L::V_OFF + st * L::T_BYTES;
      // S = Q K^T over head_dim in 16-wide k-steps (4 per 64-col panel).
      float s[BK / 2];
      tfm_wgmma::fence_operand(acc);
      tfm_wgmma::fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int p = kk / 4, c = (kk % 4) * 32;
        mma_s<BK>(s, tfm_wgmma::desc_sw128(qt + p * BQ * 128 + c, 16, 1024),
                  tfm_wgmma::desc_sw128(kt + p * BK * 128 + c, 16, 1024),
                  kk > 0);
      }
      tfm_wgmma::commit();
      tfm_wgmma::wait_all();
      tfm_wgmma::fence_operand(s);
      // Mask only a tile that crosses the diagonal, the window or Tk.
      const int first = r0w + g.q_offset, lastp = first + 63;
      const bool edge =
          k0 + BK > g.Tk ||
          (g.causal && (k0 + BK - 1 > first ||
                        (g.window > 0 && k0 < lastp - (g.window - 1))));
      if (edge) {
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = row0 + ((e & 2) ? 8 : 0);
            if (masked(g, row, k0 + 8 * j + cq + (e & 1)))
              s[4 * j + e] = -INFINITY;
          }
        }
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        mx[0] = fmaxf(mx[0], fmaxf(s[4 * j], s[4 * j + 1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
      float msafe[2], corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r] * scale_log2);
        // A row with nothing visible yet keeps m = -inf; subtracting 0
        // then sends every exp2 of -inf to 0 instead of NaN.
        msafe[r] = m_new == -INFINITY ? 0.f : m_new;
        corr[r] = exp2f(m[r] - msafe[r]);
        m[r] = m_new;
        l[r] *= corr[r];
      }
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(fmaf(s[4 * j + e], scale_log2,
                                     -msafe[e >> 1]));
          s[4 * j + e] = p;
          l[e >> 1] += p;
        }
      }
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        acc[4 * j] *= corr[0];
        acc[4 * j + 1] *= corr[0];
        acc[4 * j + 2] *= corr[1];
        acc[4 * j + 3] *= corr[1];
      }
      // O += P V: P from registers (bf16), V through the transpose bit.
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        pa[kk][0] = tfm::pack_bf16(s[8 * kk], s[8 * kk + 1]);
        pa[kk][1] = tfm::pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        pa[kk][2] = tfm::pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        pa[kk][3] = tfm::pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }
      tfm_wgmma::fence_operand(acc);
      tfm_wgmma::fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        mma_o<D>(acc, pa[kk],
                 tfm_wgmma::desc_sw128(vt + kk * 16 * 128, BK * 128, 1024));
      tfm_wgmma::commit();
      tfm_wgmma::wait_all();
      tfm_wgmma::fence_operand(acc);
    }
    __syncwarp();
    if (lane == 0) tfm_async::mbar_arrive(&empty[st]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= g.Tq) continue;
    const bool none = l[r] == 0.f;
    const float inv = none ? 0.f : 1.f / l[r];
    bf16* orow = o + (((long long)b * g.Tq + row) * g.H + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(orow + 8 * j + cq) = tfm::pack_bf16(
          acc[4 * j + 2 * r] * inv, acc[4 * j + 2 * r + 1] * inv);
    if (lane % 4 == 0)
      lse[((long long)b * g.H + h) * g.Tq + row] =
          none ? -INFINITY : (m[r] + log2f(l[r])) * LN2;
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, looked up once through the
// runtime (the library is not linked against libcuda).
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// What a tensor map encodes: a bf16 [B, T, heads, D] operand at `base`
// (element strides sb, st, sh; unit stride on D), read in boxes of 64
// columns x `rows` rows of one (head, batch).
struct MapArgs {
  const void* base;
  long long sb, st, sh;
  int B, T, heads, D, rows;
  bool operator==(const MapArgs& o) const {
    return base == o.base && sb == o.sb && st == o.st && sh == o.sh &&
           B == o.B && T == o.T && heads == o.heads && D == o.D &&
           rows == o.rows;
  }
};

// The 4-D tensor map of `a`: 128-byte swizzle, zero fill out of bounds.
bool encode(CUtensorMap* map, const MapArgs& a) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)a.D, (cuuint64_t)a.heads,
                              (cuuint64_t)a.T, (cuuint64_t)a.B};
  const cuuint64_t strides[3] = {(cuuint64_t)a.sh * 2, (cuuint64_t)a.st * 2,
                                 (cuuint64_t)a.sb * 2};
  const cuuint32_t box[4] = {(cuuint32_t)PANEL, 1, (cuuint32_t)a.rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
             const_cast<void*>(a.base), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A map is a pure function of its MapArgs, so the last MAPS encoded are
// kept and a call on the same buffers (PyTorch's caching allocator hands
// every layer of a step the same blocks) skips the driver's encoder.
constexpr int MAPS = 48;
bool encode_cached(CUtensorMap* map, const MapArgs& a) {
  static MapArgs keys[MAPS];
  static CUtensorMap maps[MAPS];
  static int filled = 0, next = 0;
  static std::mutex mu;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < filled; ++i) {
    if (keys[i] == a) {
      *map = maps[i];
      return true;
    }
  }
  if (!encode(map, a)) return false;
  keys[next] = a;
  maps[next] = *map;
  next = (next + 1) % MAPS;
  if (filled < MAPS) ++filled;
  return true;
}

// What this thread's last tfm_flash_fwd launched: route (0 the FMA
// kernel, 1 mma.sync, 2 wgmma), query rows per CTA, and the grid.
thread_local int last_launch[5] = {0, 0, 0, 0, 0};

void record(int route, int rows, const dim3& grid) {
  last_launch[0] = route;
  last_launch[1] = rows;
  last_launch[2] = grid.x;
  last_launch[3] = grid.y;
  last_launch[4] = grid.z;
}

template <int D, int NWG>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         void* o, void* lse, int B, int KV,
                         const Geometry& g, cudaStream_t stream) {
  using L = WgLayout<D, NWG>;
  CUtensorMap mq, mk, mv;
  // Tk = 0 leaves every row empty and loads no K/V tile; its maps get
  // one (never read) row so that they encode.
  const int tk = g.Tk > 0 ? g.Tk : 1;
  if (!encode_cached(&mq, {q, g.sqb, g.sqt, g.sqh, B, g.Tq, g.H, D, L::BQ}) ||
      !encode_cached(&mk, {k, g.skb, g.skt, g.skh, B, tk, KV, D, L::BK}) ||
      !encode_cached(&mv, {v, g.skb, g.skt, g.skh, B, tk, KV, D, L::BK}))
    return cudaErrorInvalidValue;
  auto kernel = flash_fwd_wgmma_kernel<D, NWG>;
  static std::atomic<unsigned> smem_set{0};
  cudaError_t err = tfm_async::smem_limit_once(
      smem_set, reinterpret_cast<const void*>(kernel), L::BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid(g.H, B, (g.Tq + L::BQ - 1) / L::BQ);
  kernel<<<grid, L::THREADS, L::BYTES, stream>>>(
      mq, mk, mv, static_cast<bf16*>(o), static_cast<float*>(lse), g,
      g.scale * 1.4426950408889634f);
  record(2, L::BQ, grid);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_wgmma_rows(const void* q, const void* k, const void* v,
                              void* o, void* lse, int B, int KV,
                              const Geometry& g, int block_rows,
                              cudaStream_t stream) {
  if (block_rows == 64)
    return launch_wgmma<D, 1>(q, k, v, o, lse, B, KV, g, stream);
  if (block_rows == 128)
    return launch_wgmma<D, 2>(q, k, v, o, lse, B, KV, g, stream);
  return cudaErrorInvalidValue;
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
  record(1, BQ, grid);
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
  record(0, BQ, grid);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* tfm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// What this thread's last tfm_flash_fwd launched: out[0] the route (0
// FMA, 1 mma.sync, 2 wgmma), out[1] query rows per CTA, out[2..4] the
// grid.
extern "C" void tfm_flash_fwd_last_launch(int* out) {
  for (int i = 0; i < 5; ++i) out[i] = last_launch[i];
}

// q: [B, Tq, H, D] with element strides (sqb, sqt, sqh) and unit stride
// on D; k/v: [B, Tk, KV, D] sharing strides (skb, skt, skh).  bf16 at
// head_dim 64 or 128 (the wgmma route) needs 16-byte aligned bases and
// strides of a multiple of 8 elements (a tensor map's rule), a positive
// scale, and block_rows 64 or 128 (query rows a CTA); the other routes
// need even strides for bf16 and ignore block_rows.  o: contiguous
// [B, Tq, H, D] of q's type; lse: contiguous fp32 [B, H, Tq].  window
// <= 0 means no window.  Returns cudaGetLastError() after the launch.
extern "C" int tfm_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, int B, int Tq, int Tk,
                             int H, int KV, int D, long long sqb,
                             long long sqt, long long sqh, long long skb,
                             long long skt, long long skh, int causal,
                             int window, int q_offset, float scale,
                             int is_bf16, int block_rows, void* stream) {
  if (KV <= 0 || H % KV != 0) return cudaErrorInvalidValue;
  const Geometry g{Tq, Tk, H, H / KV, sqb, sqt, sqh, skb, skt, skh,
                   causal, window, q_offset, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (Tq == 0) return cudaSuccess;                    // nothing to do
  if (is_bf16 && (D == 64 || D == 128)) {
    if (!(scale > 0.f)) return cudaErrorInvalidValue;
    err = D == 64 ? launch_wgmma_rows<64>(q, k, v, o, lse, B, KV, g,
                                          block_rows, s)
                  : launch_wgmma_rows<128>(q, k, v, o, lse, B, KV, g,
                                           block_rows, s);
  } else if (is_bf16) {      // mma.sync: head_dim 16 or 32
    switch (D) {
      case 16: err = launch_mma<16>(q, k, v, o, lse, B, g, s); break;
      case 32: err = launch_mma<32>(q, k, v, o, lse, B, g, s); break;
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
