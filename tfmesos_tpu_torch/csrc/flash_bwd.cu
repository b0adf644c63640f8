// Flash-attention backward for Hopper (sm_90a): dq, and dk/dv, from the
// forward's stored per-row logsumexp; fp32 accumulation.
//
// Replaces: tfmesos_tpu/ops/attention.py, _flash_bwd_dq_kernel and
// _flash_bwd_dkv_kernel (called through _mha_bwd_pallas, the backward of
// flash_attention's custom_vjp) — the two TPU kernels of every training
// step's attention gradient.
//
// What it computes, per (batch, q head h, kv head h / G):
//   p  = exp(scale * q k^T - lse), 0 where the causal/window mask hides
//        the key (a select, never a multiply: a row that sees no key has
//        lse = -inf, and exp(s - lse) is +inf there);
//   dp = do v^T,  ds = p * (dp - delta),  delta = rowsum(do * o) given;
//   dq = scale * ds k,  dk = scale * ds^T q,  dv = p^T do,
// dk/dv summed over the G q heads of a kv head.  q/do [B, Tq, H, D],
// k/v [B, Tk, KV, D], lse/delta fp32 [B, H, Tq]; query row i is position
// i + q_offset; any Tq/Tk runs.  As in the TPU kernels, p rounds to the
// operand type before p^T do, and ds before ds k and ds^T q.  Outputs:
// contiguous dq, dk, dv in the operand type or fp32 (out_f32).
//
// What bounds it on this card: at the training shape (B 8, T 2048, H 8,
// D 64, causal, bf16) dq does 6*D FLOPs per visible (q, k) pair = 5.2e10,
// 0.052 ms at 989 TFLOP/s, against ~85 MB (0.025 ms at 3.35 TB/s); dk/dv
// 8*D per pair = 6.9e10, 0.069 ms.  Operations bound both, and the tensor
// cores reach their rate only through wgmma fed from shared memory that
// TMA keeps full: the first version (mma.sync from 32-bit shared loads
// behind a barrier a tile, transposed copies of K, Q and dO in shared
// memory, the mask on every element) ran at ~60 TFLOP/s.
//
// What this design does about it (bf16, head_dim 64 or 128) — the
// forward's shape (flash_fwd.cu), one kernel per gradient, no atomics:
// * dq: a CTA owns BQ = 128 q rows of one (head, batch) in two consumer
//   warpgroups (64 rows in one where ceil(Tq / 128) x H x B CTAs cannot
//   fill the SMs); its producer loads Q and dO once by TMA and streams
//   64-key K/V tiles through a 3-stage mbarrier ring.  S = Q K^T and
//   dP = dO V^T run on wgmma from K-major swizzled tiles, in two commit
//   groups, so p (exp2, scale * log2 e folded, lse * log2 e once a row)
//   is formed while dP is on the tensor cores; ds = p (dp - delta),
//   packed to bf16, is the register A operand of dQ += ds K, with K read
//   MN-major through the transpose bit: no transposed copy.  The q tiles
//   with the most keys go first.
// * dk/dv: a CTA owns 128 (or 64: the same rule over KV heads) keys of
//   one (kv head, batch), K and V loaded once.  The producer streams, for
//   each q head of the group and each q tile that sees the keys, Q and dO
//   by TMA and the lse/delta slices (stored by the producer warp) through
//   a 4-stage ring.  S^T = K Q^T and dP^T = V dO^T run on wgmma; P^T and
//   dS^T, formed in registers, are the A operands of dV += P^T dO and
//   dK += dS^T Q (dO, Q through the transpose bit).  The group's sum stays
//   in registers: deterministic.  Key tiles that see the most rows go
//   first.  head_dim 128 streams 32-row q tiles (wgmma N 32).
// * Registers: with two consumer warpgroups the producer is a whole
//   warpgroup that gives its registers to them (setmaxnreg: 40 / 232 of
//   the 168 that 384 threads launch with), so dK, dV, S^T and dP^T stay
//   in registers without spilling; the one-warpgroup CTAs (160 threads)
//   already have up to 255.
// * Masks only on tiles that cross the diagonal, the window edge, Tq or
//   Tk.  Each launch's route, rows a CTA, streamed tile and grid are
//   readable (tfm_flash_bwd_last_launch).
// bf16 head_dim 16 and 32 keep the mma.sync kernels (m16n8k16, 64 rows a
// CTA, padded shared tiles); float32 operands run FMA kernels, two
// threads a row.  PERF.md records the distance to the bound.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "hopper_async.cuh"
#include "mma_bf16.cuh"
#include "tensor_map.cuh"
#include "wgmma.cuh"

namespace {

using tfm::bf16;
using tfm::mma_bf16_smem;
using tfm::pack_a;
using tfm_tmap::PANEL;

constexpr int BQ = 64;        // q rows per mma.sync / FMA dq CTA
constexpr int BKV = 64;       // keys per mma.sync / FMA dk/dv CTA
constexpr int THREADS = 128;  // 4 warps
constexpr int PAD = 8;        // bf16 row padding of every mma.sync tile
constexpr int MMA_TILE = 64;  // keys (dq) / q rows (dk/dv) a mma.sync tile
constexpr float LOG2E = 1.4426950408889634f;

// Keys (dq) / q rows (dk/dv) an FMA kernel's shared tile holds.
__host__ __device__ constexpr int fma_tile(int d) { return d <= 64 ? 64 : 32; }

struct Geometry {
  int Tq, Tk, H, KV, G;
  int causal, window, q_offset;
  float scale;
  int out_f32;
};

// True where query row qrow (global position qrow + q_offset) must not
// see key kp — including the ragged edge of either length.
__device__ __forceinline__ bool masked(const Geometry& g, int qrow, int kp) {
  if (qrow >= g.Tq || kp >= g.Tk) return true;
  if (!g.causal) return false;
  const int qpos = qrow + g.q_offset;
  return kp > qpos || (g.window > 0 && kp < qpos - (g.window - 1));
}

// Keys that q rows [r0, r0 + rows) can see: [lo, hi).
__device__ __forceinline__ void key_range(const Geometry& g, int r0, int rows,
                                          int* lo, int* hi) {
  *lo = 0;
  *hi = g.Tk;
  if (g.causal) {
    *hi = min(g.Tk, r0 + rows + g.q_offset);
    if (g.window > 0) *lo = max(0, r0 + g.q_offset - (g.window - 1));
  }
}

// Q rows that can see keys [k0, k0 + keys): [lo, hi).
__device__ __forceinline__ void row_range(const Geometry& g, int k0, int keys,
                                          int* lo, int* hi) {
  *lo = 0;
  *hi = g.Tq;
  if (g.causal) {
    *lo = max(0, k0 - g.q_offset);
    if (g.window > 0)
      *hi = min(g.Tq, k0 + keys + g.window - 1 - g.q_offset);
  }
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two neighbouring outputs (off even) in fp32 or bf16.
__device__ __forceinline__ void store2(void* out, long long off, float a,
                                       float b, int out_f32) {
  if (out_f32)
    *reinterpret_cast<float2*>(static_cast<float*>(out) + off) =
        make_float2(a, b);
  else
    *reinterpret_cast<uint32_t*>(static_cast<bf16*>(out) + off) =
        tfm::pack_bf16(a, b);
}

// ------------------------------------------------------- bf16 mma.sync ---
// head_dim 16 and 32: contiguous operands, 4 warps of 16 rows (dq) or 16
// keys (dk/dv), 64-wide padded shared tiles.

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const bf16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, void* __restrict__ dq,
                        Geometry g) {
  constexpr int BK = MMA_TILE;  // keys per tile
  constexpr int KS = D / 16;    // k-steps over head_dim (S, dP)
  constexpr int NS = BK / 8;    // 8-key n-tiles of S and dP
  constexpr int NO = D / 8;     // 8-dim n-tiles of dQ
  __shared__ __align__(16) bf16 ks[BK][D + PAD];   // [key][d]
  __shared__ __align__(16) bf16 vs[BK][D + PAD];   // [key][d]
  __shared__ __align__(16) bf16 kt[D][BK + PAD];   // [d][key]

  const int qb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / g.G;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, tg = lane & 3;
  const int r0 = qb * BQ;
  const int row_lo = r0 + warp * 16 + gr, row_hi = row_lo + 8;

  // q and do as A fragments, in registers for the whole key loop.
  const long long rs = (long long)g.H * D;                 // row stride
  const bf16* qbase = q + ((long long)b * g.Tq * g.H + h) * D;
  const bf16* dbase = dout + ((long long)b * g.Tq * g.H + h) * D;
  uint32_t qa[KS][4], da[KS][4];
#pragma unroll
  for (int s = 0; s < KS; ++s) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = (i & 1) ? row_hi : row_lo;
      const int d = s * 16 + tg * 2 + ((i & 2) ? 8 : 0);
      const bool ok = row < g.Tq;
      qa[s][i] = ok ? ld32(qbase + row * rs + d) : 0u;
      da[s][i] = ok ? ld32(dbase + row * rs + d) : 0u;
    }
  }
  float lse_r[2], dl_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r ? row_hi : row_lo;
    const long long idx = ((long long)b * g.H + h) * g.Tq + row;
    lse_r[r] = row < g.Tq ? lse[idx] : 0.f;
    dl_r[r] = row < g.Tq ? delta[idx] : 0.f;
  }

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  int lo, hi;
  key_range(g, r0, BQ, &lo, &hi);
  const long long kstride = (long long)g.KV * D;           // key stride
  const bf16* kbase = k + ((long long)b * g.Tk * g.KV + kvh) * D;
  const bf16* vbase = v + ((long long)b * g.Tk * g.KV + kvh) * D;
  for (int k0 = (lo / BK) * BK; k0 < hi; k0 += BK) {
    __syncthreads();                         // previous tile consumed
    for (int idx = tid; idx < BK * D / 2; idx += THREADS) {
      const int j = idx / (D / 2), d = (idx % (D / 2)) * 2;
      const int kp = k0 + j;
      uint32_t kk = 0u, vv = 0u;
      if (kp < g.Tk) {
        kk = ld32(kbase + kp * kstride + d);
        vv = ld32(vbase + kp * kstride + d);
      }
      *reinterpret_cast<uint32_t*>(&ks[j][d]) = kk;
      *reinterpret_cast<uint32_t*>(&vs[j][d]) = vv;
      const __nv_bfloat162 k2 = *reinterpret_cast<const __nv_bfloat162*>(&kk);
      kt[d][j] = k2.x;
      kt[d + 1][j] = k2.y;
    }
    __syncthreads();

    // S = q k^T and dP = do v^T for this warp's 16 rows x BK keys.
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = dp[n][i] = 0.f;
#pragma unroll
      for (int t = 0; t < KS; ++t) {
        mma_bf16_smem(s[n], qa[t], &ks[n * 8 + gr][t * 16 + tg * 2]);
        mma_bf16_smem(dp[n], da[t], &vs[n * 8 + gr][t * 16 + tg * 2]);
      }
    }
    // ds = p (dp - delta), p from the stored lse; kept in s.
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = (i < 2) ? row_lo : row_hi;
        const int kp = k0 + n * 8 + tg * 2 + (i & 1);
        const float p = masked(g, row, kp)
                            ? 0.f
                            : expf(s[n][i] * g.scale - lse_r[i >> 1]);
        s[n][i] = p * (dp[n][i] - dl_r[i >> 1]);
      }
    }
    // dQ += ds k: ds re-packed as bf16 A fragments, k from kt.
#pragma unroll
    for (int t = 0; t < BK / 16; ++t) {
      uint32_t pa[4];
      pack_a(pa, s[2 * t], s[2 * t + 1]);
#pragma unroll
      for (int n = 0; n < NO; ++n)
        mma_bf16_smem(acc[n], pa, &kt[n * 8 + gr][t * 16 + tg * 2]);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r ? row_hi : row_lo;
    if (row >= g.Tq) continue;
    const long long base = (((long long)b * g.Tq + row) * g.H + h) * D;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      store2(dq, base + n * 8 + tg * 2, acc[n][2 * r] * g.scale,
             acc[n][2 * r + 1] * g.scale, g.out_f32);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_mma_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         void* __restrict__ dk, void* __restrict__ dv,
                         Geometry g) {
  constexpr int BT = MMA_TILE;  // q rows per tile
  constexpr int KS = D / 16;    // k-steps over head_dim (S^T, dP^T)
  constexpr int NS = BT / 8;    // 8-row n-tiles of S^T and dP^T
  constexpr int NO = D / 8;     // 8-dim n-tiles of dK and dV
  __shared__ __align__(16) bf16 qs[BT][D + PAD];   // [row][d]
  __shared__ __align__(16) bf16 os[BT][D + PAD];   // do, [row][d]
  __shared__ __align__(16) bf16 qt[D][BT + PAD];   // [d][row]
  __shared__ __align__(16) bf16 ot[D][BT + PAD];   // do, [d][row]
  __shared__ float ls[BT], dl[BT];

  const int kb = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, tg = lane & 3;
  const int k0 = kb * BKV;
  const int key_lo = k0 + warp * 16 + gr, key_hi = key_lo + 8;

  // k and v as A fragments, in registers for the whole loop.
  const long long kstride = (long long)g.KV * D;
  const bf16* kbase = k + ((long long)b * g.Tk * g.KV + kvh) * D;
  const bf16* vbase = v + ((long long)b * g.Tk * g.KV + kvh) * D;
  uint32_t ka[KS][4], va[KS][4];
#pragma unroll
  for (int s = 0; s < KS; ++s) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = (i & 1) ? key_hi : key_lo;
      const int d = s * 16 + tg * 2 + ((i & 2) ? 8 : 0);
      const bool ok = key < g.Tk;
      ka[s][i] = ok ? ld32(kbase + key * kstride + d) : 0u;
      va[s][i] = ok ? ld32(vbase + key * kstride + d) : 0u;
    }
  }

  float dk_acc[NO][4], dv_acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) {
#pragma unroll
    for (int i = 0; i < 4; ++i) dk_acc[n][i] = dv_acc[n][i] = 0.f;
  }

  int lo, hi;
  row_range(g, k0, BKV, &lo, &hi);
  const long long rs = (long long)g.H * D;
  for (int e = 0; e < g.G; ++e) {            // the group's q heads
    const int h = kvh * g.G + e;
    const bf16* qbase = q + ((long long)b * g.Tq * g.H + h) * D;
    const bf16* dbase = dout + ((long long)b * g.Tq * g.H + h) * D;
    const long long lbase = ((long long)b * g.H + h) * g.Tq;
    for (int r0 = (lo / BT) * BT; r0 < hi; r0 += BT) {
      __syncthreads();                       // previous tile consumed
      for (int idx = tid; idx < BT * D / 2; idx += THREADS) {
        const int i = idx / (D / 2), d = (idx % (D / 2)) * 2;
        const int row = r0 + i;
        uint32_t qq = 0u, oo = 0u;
        if (row < g.Tq) {
          qq = ld32(qbase + row * rs + d);
          oo = ld32(dbase + row * rs + d);
        }
        *reinterpret_cast<uint32_t*>(&qs[i][d]) = qq;
        *reinterpret_cast<uint32_t*>(&os[i][d]) = oo;
        const __nv_bfloat162 q2 =
            *reinterpret_cast<const __nv_bfloat162*>(&qq);
        const __nv_bfloat162 o2 =
            *reinterpret_cast<const __nv_bfloat162*>(&oo);
        qt[d][i] = q2.x;
        qt[d + 1][i] = q2.y;
        ot[d][i] = o2.x;
        ot[d + 1][i] = o2.y;
      }
      for (int i = tid; i < BT; i += THREADS) {
        const int row = r0 + i;
        ls[i] = row < g.Tq ? lse[lbase + row] : 0.f;
        dl[i] = row < g.Tq ? delta[lbase + row] : 0.f;
      }
      __syncthreads();

      // S^T = k q^T and dP^T = v do^T: this warp's 16 keys x BT rows.
      float st[NS][4], dpt[NS][4];
#pragma unroll
      for (int n = 0; n < NS; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) st[n][i] = dpt[n][i] = 0.f;
#pragma unroll
        for (int t = 0; t < KS; ++t) {
          mma_bf16_smem(st[n], ka[t], &qs[n * 8 + gr][t * 16 + tg * 2]);
          mma_bf16_smem(dpt[n], va[t], &os[n * 8 + gr][t * 16 + tg * 2]);
        }
      }
      // p^T into st, ds^T = p^T (dp^T - delta) into dpt.
#pragma unroll
      for (int n = 0; n < NS; ++n) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = (i < 2) ? key_lo : key_hi;
          const int col = n * 8 + tg * 2 + (i & 1);
          const float p = masked(g, r0 + col, key)
                              ? 0.f
                              : expf(st[n][i] * g.scale - ls[col]);
          st[n][i] = p;
          dpt[n][i] = p * (dpt[n][i] - dl[col]);
        }
      }
      // dV += p^T do and dK += ds^T q over this tile's rows.
#pragma unroll
      for (int t = 0; t < BT / 16; ++t) {
        uint32_t pa[4], sa[4];
        pack_a(pa, st[2 * t], st[2 * t + 1]);
        pack_a(sa, dpt[2 * t], dpt[2 * t + 1]);
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          mma_bf16_smem(dv_acc[n], pa, &ot[n * 8 + gr][t * 16 + tg * 2]);
          mma_bf16_smem(dk_acc[n], sa, &qt[n * 8 + gr][t * 16 + tg * 2]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = r ? key_hi : key_lo;
    if (key >= g.Tk) continue;
    const long long base = (((long long)b * g.Tk + key) * g.KV + kvh) * D;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const long long off = base + n * 8 + tg * 2;
      store2(dk, off, dk_acc[n][2 * r] * g.scale,
             dk_acc[n][2 * r + 1] * g.scale, g.out_f32);
      store2(dv, off, dv_acc[n][2 * r], dv_acc[n][2 * r + 1], g.out_f32);
    }
  }
}

// ---------------------------------------------------------- bf16 wgmma ---

// Descriptor of k-step kk (16 columns of head_dim) of a K-major SW128
// tile whose 64-column panels hold `rows` rows each.
__device__ __forceinline__ uint64_t kmajor(const unsigned char* tile,
                                           int rows, int kk) {
  return tfm_wgmma::desc_sw128(tile + (kk / 4) * rows * 128 + (kk % 4) * 32,
                               16, 1024);
}

// Descriptor of k-step kk (16 rows) of the same tile read MN-major (head
// dim along N, through the transpose bit): panels of `rows` rows at LBO.
__device__ __forceinline__ uint64_t mnmajor(const unsigned char* tile,
                                            int rows, int kk) {
  return tfm_wgmma::desc_sw128(tile + kk * 16 * 128, rows * 128, 1024);
}

// d (+)= A x B^T over one 16-wide k-step, both K-major in shared memory:
// the S-shaped products, N = 32 or 64 columns.
template <int N>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], uint64_t da,
                                       uint64_t db, int scale_d);
template <>
__device__ __forceinline__ void mma_ss<32>(float (&d)[16], uint64_t da,
                                           uint64_t db, int scale_d) {
  tfm_wgmma::mma_ss_n32(d, da, db, scale_d);
}
template <>
__device__ __forceinline__ void mma_ss<64>(float (&d)[32], uint64_t da,
                                           uint64_t db, int scale_d) {
  tfm_wgmma::mma_ss_n64(d, da, db, scale_d);
}

// d += A (registers) x B (shared, MN-major): the gradient products, N =
// head_dim.
template <int D>
__device__ __forceinline__ void mma_grad(float (&d)[D / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db);
template <>
__device__ __forceinline__ void mma_grad<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  tfm_wgmma::mma_rs_n64_tb(d, a, db);
}
template <>
__device__ __forceinline__ void mma_grad<128>(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  tfm_wgmma::mma_rs_n128_tb(d, a, db);
}

// The accumulators of N columns packed to bf16 as register A operands,
// one per 16-column k-step (wgmma.cuh: the C layout is the A layout).
template <int N>
__device__ __forceinline__ void pack_rows(uint32_t (&a)[N / 16][4],
                                          const float (&s)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    a[kk][0] = tfm::pack_bf16(s[8 * kk], s[8 * kk + 1]);
    a[kk][1] = tfm::pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    a[kk][2] = tfm::pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    a[kk][3] = tfm::pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// Threads of a wgmma CTA with NWG consumer warpgroups.  With two, the
// producer is a whole warpgroup, so that it can hand its registers to the
// consumers (setmaxnreg): 384 threads launch with 168 registers each; the
// producer keeps PRODUCER_REGS and the consumers rise to CONSUMER_REGS
// (40 x 128 + 232 x 256 = 168 x 384).  With one, 160 threads already have
// up to 255.
template <int NWG>
struct Threads {
  static constexpr int N = NWG == 2 ? 384 : 160;
};
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;

// Shared memory of the dq kernel with NWG consumer warpgroups, from a
// 1024-byte aligned base: Q and dO [D/64 panels][BQ rows][128 B], NST
// stages of K and of V [D/64 panels][BK rows][128 B], the barriers.
template <int D, int NWG>
struct DqLayout {
  static constexpr int BK = 64, NST = 3, PANELS = D / PANEL;
  static constexpr int BQ = 64 * NWG;
  static constexpr int THREADS = Threads<NWG>::N;
  static constexpr int Q_BYTES = BQ * D * 2;         // Q or dO
  static constexpr int T_BYTES = BK * D * 2;         // one K or V tile
  static constexpr int DO_OFF = Q_BYTES;
  static constexpr int K_OFF = 2 * Q_BYTES;
  static constexpr int V_OFF = K_OFF + NST * T_BYTES;
  static constexpr int BAR_OFF = V_OFF + NST * T_BYTES;
  static constexpr int BYTES = BAR_OFF + (2 * NST + 1) * 8 + 1024;
};

template <int D, int NWG>
__global__ void __launch_bounds__(DqLayout<D, NWG>::THREADS, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tmq,
                          const __grid_constant__ CUtensorMap tmdo,
                          const __grid_constant__ CUtensorMap tmk,
                          const __grid_constant__ CUtensorMap tmv,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          void* __restrict__ dq, Geometry g,
                          float scale_log2) {
  using L = DqLayout<D, NWG>;
  constexpr int BK = L::BK, BQ = L::BQ, NST = L::NST;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* empty = full + NST;
  uint64_t* qbar = empty + NST;

  const int h = blockIdx.x, b = blockIdx.y;
  const int qb = gridDim.z - 1 - blockIdx.z;       // most keys first
  const int kvh = h / g.G, r0 = qb * BQ;
  int lo, hi;
  key_range(g, r0, BQ, &lo, &hi);
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

  if (warp >= 4 * NWG) {
    if constexpr (NWG == 2) tfm_wgmma::reg_dealloc<PRODUCER_REGS>();
    // ---- producer: Q and dO once, then the K/V tiles through the ring --
    if (warp == 4 * NWG && lane == 0) {
      tfm_async::mbar_arrive_expect_tx(qbar, 2 * L::Q_BYTES);
#pragma unroll
      for (int p = 0; p < L::PANELS; ++p) {
        tfm_async::tma_load_4d(smem + p * BQ * 128, &tmq, p * PANEL, h, r0,
                               b, qbar);
        tfm_async::tma_load_4d(smem + L::DO_OFF + p * BQ * 128, &tmdo,
                               p * PANEL, h, r0, b, qbar);
      }
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
  if constexpr (NWG == 2) tfm_wgmma::reg_alloc<CONSUMER_REGS>();

  // ---- consumers: warpgroup wg owns rows [r0w, r0w + 64) --------------
  const int wg = warp / 4, wq = warp % 4;
  const int r0w = r0 + 64 * wg;
  int lo_w, hi_w;
  key_range(g, r0w, 64, &lo_w, &hi_w);
  const bool rows_live = r0w < g.Tq;
  const int row0 = r0w + 16 * wq + lane / 4;        // and row0 + 8
  const int cq = 2 * (lane % 4);
  float lse2[2], dl[2];        // lse * log2(e) and delta of the two rows
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    const long long idx = ((long long)b * g.H + h) * g.Tq + row;
    lse2[r] = row < g.Tq ? lse[idx] * LOG2E : 0.f;
    dl[r] = row < g.Tq ? delta[idx] : 0.f;
  }
  // A tile is masked only where it crosses the diagonal, the window edge
  // or Tk (rows past Tq are never stored).
  const int first = r0w + g.q_offset, last = first + 63;

  float acc[D / 2];
#pragma unroll
  for (int j = 0; j < D / 2; ++j) acc[j] = 0.f;
  tfm_async::mbar_wait(qbar, 0);
  const unsigned char* qt = smem + wg * 64 * 128;
  const unsigned char* dot = smem + L::DO_OFF + wg * 64 * 128;

  for (int i = 0; i < ntiles; ++i) {
    const int st = i % NST, k0 = kfirst + i * BK;
    tfm_async::mbar_wait(&full[st], (i / NST) & 1);
    if (rows_live && k0 < hi_w && k0 + BK > lo_w) {
      const unsigned char* kt = smem + L::K_OFF + st * L::T_BYTES;
      const unsigned char* vt = smem + L::V_OFF + st * L::T_BYTES;
      // S = Q K^T and dP = dO V^T, two commit groups: p is formed from
      // S while dP is still on the tensor cores.  Both read A from shared
      // memory: Q and dO kept as register A operands across this loop
      // came back wrong at head_dim 64 under nvcc 12.9 (the SASS packs
      // ds into the registers holding dO; fences do not change it).
      float s[BK / 2], dp[BK / 2];
      tfm_wgmma::fence_operand(acc);
      tfm_wgmma::fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma_ss<BK>(s, kmajor(qt, BQ, kk), kmajor(kt, BK, kk), kk > 0);
      tfm_wgmma::commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma_ss<BK>(dp, kmajor(dot, BQ, kk), kmajor(vt, BK, kk), kk > 0);
      tfm_wgmma::commit();
      tfm_wgmma::wait<1>();
      tfm_wgmma::fence_operand(s);
      const bool edge =
          k0 + BK > g.Tk ||
          (g.causal && (k0 + BK - 1 > first ||
                        (g.window > 0 && k0 < last - (g.window - 1))));
      // p into s; a masked element is selected to 0 (its exp2 may be
      // +inf), so its ds below is 0 as well.
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = exp2f(fmaf(s[4 * j + e], scale_log2, -lse2[e >> 1]));
          if (edge && masked(g, row0 + ((e & 2) ? 8 : 0),
                             k0 + 8 * j + cq + (e & 1)))
            p = 0.f;
          s[4 * j + e] = p;
        }
      }
      tfm_wgmma::wait_all();
      tfm_wgmma::fence_operand(dp);
      // ds = p (dp - delta) into s (delta is finite on every row).
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) s[j] *= dp[j] - dl[(j >> 1) & 1];
      // dQ += ds K: ds from registers (bf16), K through the transpose bit.
      uint32_t da[BK / 16][4];
      pack_rows<BK>(da, s);
      tfm_wgmma::fence_operand(da);
      tfm_wgmma::fence_operand(acc);
      tfm_wgmma::fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        mma_grad<D>(acc, da[kk], mnmajor(kt, BK, kk));
      tfm_wgmma::commit();
      tfm_wgmma::wait_all();
      tfm_wgmma::fence_operand(acc);
      tfm_wgmma::fence_operand(da);
    }
    __syncwarp();
    if (lane == 0) tfm_async::mbar_arrive(&empty[st]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= g.Tq) continue;
    const long long base = (((long long)b * g.Tq + row) * g.H + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      store2(dq, base + 8 * j + cq, acc[4 * j + 2 * r] * g.scale,
             acc[4 * j + 2 * r + 1] * g.scale, g.out_f32);
  }
}

// q rows a streamed dk/dv tile holds (wgmma N of S^T and dP^T).
template <int D> struct DkvTile;
template <> struct DkvTile<64> { static constexpr int BT = 64; };
template <> struct DkvTile<128> { static constexpr int BT = 32; };

// Shared memory of the dk/dv kernel: K and V [D/64 panels][BK rows]
// [128 B] once, NST stages of Q and of dO [D/64 panels][BT rows][128 B],
// NST stages of the lse and delta slices (BT floats each), the barriers.
template <int D, int NWG>
struct DkvLayout {
  static constexpr int BT = DkvTile<D>::BT, NST = 4, PANELS = D / PANEL;
  static constexpr int BK = 64 * NWG;                // keys a CTA
  static constexpr int THREADS = Threads<NWG>::N;
  static constexpr int KV_BYTES = BK * D * 2;        // K or V
  static constexpr int T_BYTES = BT * D * 2;         // one Q or dO tile
  static constexpr int V_OFF = KV_BYTES;
  static constexpr int Q_OFF = 2 * KV_BYTES;
  static constexpr int O_OFF = Q_OFF + NST * T_BYTES;
  static constexpr int L_OFF = O_OFF + NST * T_BYTES;
  static constexpr int BAR_OFF = L_OFF + NST * 2 * BT * 4;
  static constexpr int BYTES = BAR_OFF + (2 * NST + 1) * 8 + 1024;
};

template <int D, int NWG>
__global__ void __launch_bounds__(DkvLayout<D, NWG>::THREADS, 1)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tmq,
                           const __grid_constant__ CUtensorMap tmdo,
                           const __grid_constant__ CUtensorMap tmk,
                           const __grid_constant__ CUtensorMap tmv,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           void* __restrict__ dk, void* __restrict__ dv,
                           Geometry g, float scale_log2) {
  using L = DkvLayout<D, NWG>;
  constexpr int BT = L::BT, BK = L::BK, NST = L::NST;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  float* lring = reinterpret_cast<float*>(smem + L::L_OFF);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* empty = full + NST;
  uint64_t* kvbar = empty + NST;

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * BK;               // most q rows first
  int lo, hi;
  row_range(g, k0, BK, &lo, &hi);
  const int rfirst = (lo / BT) * BT;
  const int nrt = hi > rfirst ? (hi - rfirst + BT - 1) / BT : 0;
  const int ntiles = g.G * nrt;                 // (q head, q tile) pairs
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  if (tid == 0) {
    for (int i = 0; i < NST; ++i) {
      tfm_async::mbar_init(&full[i], 1);
      tfm_async::mbar_init(&empty[i], 4 * NWG);
    }
    tfm_async::mbar_init(kvbar, 1);
    tfm_async::fence_barrier_init();
  }
  __syncthreads();

  if (warp >= 4 * NWG) {
    if constexpr (NWG == 2) tfm_wgmma::reg_dealloc<PRODUCER_REGS>();
    if (warp != 4 * NWG) return;
    // ---- producer: K and V once, then (Q, dO, lse, delta) per tile ----
    if (lane == 0) {
      tfm_async::mbar_arrive_expect_tx(kvbar, 2 * L::KV_BYTES);
#pragma unroll
      for (int p = 0; p < L::PANELS; ++p) {
        tfm_async::tma_load_4d(smem + p * BK * 128, &tmk, p * PANEL, kvh, k0,
                               b, kvbar);
        tfm_async::tma_load_4d(smem + L::V_OFF + p * BK * 128, &tmv,
                               p * PANEL, kvh, k0, b, kvbar);
      }
    }
    for (int i = 0; i < ntiles; ++i) {
      const int st = i % NST;
      const int h = kvh * g.G + i / nrt, r0 = rfirst + (i % nrt) * BT;
      if (i >= NST) tfm_async::mbar_wait(&empty[st], ((i / NST) - 1) & 1);
      float* ls = lring + st * 2 * BT;
      float* dls = ls + BT;
      const long long lb = ((long long)b * g.H + h) * g.Tq + r0;
      const int n = min(BT, g.Tq - r0);
      // The lse/delta slices (2 x BT floats beside 2 x BT x D x 2 bytes of
      // Q and dO) are stored by the warp itself before the stage's one
      // arrival, 0 past Tq.
      for (int j = lane; j < BT; j += 32) {
        ls[j] = j < n ? lse[lb + j] : 0.f;
        dls[j] = j < n ? delta[lb + j] : 0.f;
      }
      __syncwarp();
      if (lane == 0) {
        tfm_async::mbar_arrive_expect_tx(&full[st], 2 * L::T_BYTES);
        unsigned char* qs = smem + L::Q_OFF + st * L::T_BYTES;
        unsigned char* os = smem + L::O_OFF + st * L::T_BYTES;
#pragma unroll
        for (int p = 0; p < L::PANELS; ++p) {
          tfm_async::tma_load_4d(qs + p * BT * 128, &tmq, p * PANEL, h, r0,
                                 b, &full[st]);
          tfm_async::tma_load_4d(os + p * BT * 128, &tmdo, p * PANEL, h, r0,
                                 b, &full[st]);
        }
      }
      __syncwarp();
    }
    return;
  }
  if constexpr (NWG == 2) tfm_wgmma::reg_alloc<CONSUMER_REGS>();

  // ---- consumers: warpgroup wg owns keys [kw0, kw0 + 64) --------------
  const int wg = warp / 4, wq = warp % 4;
  const int kw0 = k0 + 64 * wg;
  int lo_w, hi_w;
  row_range(g, kw0, 64, &lo_w, &hi_w);
  const bool keys_live = kw0 < g.Tk;
  const int key0 = kw0 + 16 * wq + lane / 4;        // and key0 + 8
  const int cq = 2 * (lane % 4);
  const unsigned char* kt = smem + wg * 64 * 128;
  const unsigned char* vt = smem + L::V_OFF + wg * 64 * 128;

  float dkacc[D / 2], dvacc[D / 2];
#pragma unroll
  for (int j = 0; j < D / 2; ++j) dkacc[j] = dvacc[j] = 0.f;
  tfm_async::mbar_wait(kvbar, 0);

  for (int i = 0; i < ntiles; ++i) {
    const int st = i % NST, r0 = rfirst + (i % nrt) * BT;
    tfm_async::mbar_wait(&full[st], (i / NST) & 1);
    if (keys_live && r0 < hi_w && r0 + BT > lo_w) {
      const unsigned char* qs = smem + L::Q_OFF + st * L::T_BYTES;
      const unsigned char* os = smem + L::O_OFF + st * L::T_BYTES;
      const float* ls = lring + st * 2 * BT;
      const float* dls = ls + BT;
      // S^T = K Q^T and dP^T = V dO^T, two commit groups: P^T is formed
      // from S^T while dP^T is still on the tensor cores.
      float s[BT / 2], dp[BT / 2];
      tfm_wgmma::fence_operand(dkacc);
      tfm_wgmma::fence_operand(dvacc);
      tfm_wgmma::fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma_ss<BT>(s, kmajor(kt, BK, kk), kmajor(qs, BT, kk), kk > 0);
      tfm_wgmma::commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma_ss<BT>(dp, kmajor(vt, BK, kk), kmajor(os, BT, kk), kk > 0);
      tfm_wgmma::commit();
      tfm_wgmma::wait<1>();
      tfm_wgmma::fence_operand(s);
      // Masked only where the tile crosses the diagonal, the window edge,
      // Tq (the slices past it are stale) or Tk.
      const bool edge =
          r0 + BT > g.Tq || kw0 + 64 > g.Tk ||
          (g.causal &&
           (kw0 + 63 > r0 + g.q_offset ||
            (g.window > 0 &&
             kw0 < r0 + BT - 1 + g.q_offset - (g.window - 1))));
      // P^T into s (columns are q rows), a masked element selected to 0.
#pragma unroll
      for (int j = 0; j < BT / 8; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(ls + 8 * j + cq);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = exp2f(fmaf(s[4 * j + e], scale_log2,
                               -LOG2E * ((e & 1) ? l2.y : l2.x)));
          if (edge && masked(g, r0 + 8 * j + cq + (e & 1),
                             key0 + ((e & 2) ? 8 : 0)))
            p = 0.f;
          s[4 * j + e] = p;
        }
      }
      uint32_t pa[BT / 16][4];
      pack_rows<BT>(pa, s);
      tfm_wgmma::wait_all();  // dP^T landed
      tfm_wgmma::fence_operand(dp);
      // dS^T = P^T (dP^T - delta) into dp (delta is finite on every row,
      // 0 past Tq).
#pragma unroll
      for (int j = 0; j < BT / 8; ++j) {
        const float2 d2 = *reinterpret_cast<const float2*>(dls + 8 * j + cq);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[4 * j + e] =
              s[4 * j + e] * (dp[4 * j + e] - ((e & 1) ? d2.y : d2.x));
      }
      // dV += P^T dO and dK += dS^T Q: P^T and dS^T from registers
      // (bf16), dO and Q through the transpose bit.
      uint32_t sa[BT / 16][4];
      pack_rows<BT>(sa, dp);
      tfm_wgmma::fence_operand(pa);
      tfm_wgmma::fence_operand(sa);
      tfm_wgmma::fence_operand(dkacc);
      tfm_wgmma::fence_operand(dvacc);
      tfm_wgmma::fence();
#pragma unroll
      for (int kk = 0; kk < BT / 16; ++kk) {
        mma_grad<D>(dvacc, pa[kk], mnmajor(os, BT, kk));
        mma_grad<D>(dkacc, sa[kk], mnmajor(qs, BT, kk));
      }
      tfm_wgmma::commit();
      tfm_wgmma::wait_all();
      tfm_wgmma::fence_operand(dkacc);
      tfm_wgmma::fence_operand(dvacc);
      tfm_wgmma::fence_operand(pa);
      tfm_wgmma::fence_operand(sa);
    }
    __syncwarp();
    if (lane == 0) tfm_async::mbar_arrive(&empty[st]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key >= g.Tk) continue;
    const long long base = (((long long)b * g.Tk + key) * g.KV + kvh) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const long long off = base + 8 * j + cq;
      store2(dk, off, dkacc[4 * j + 2 * r] * g.scale,
             dkacc[4 * j + 2 * r + 1] * g.scale, g.out_f32);
      store2(dv, off, dvacc[4 * j + 2 * r], dvacc[4 * j + 2 * r + 1],
             g.out_f32);
    }
  }
}

// ---------------------------------------------------------------- fp32 ---
// Two threads per row (dq) or key (dk/dv), each owning an interleaved
// half of head_dim; dot products close with one shuffle.

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_fma_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dq, Geometry g) {
  constexpr int DH = D / 2;
  constexpr int BK = fma_tile(D);
  __shared__ float ks[BK][D + 1];
  __shared__ float vs[BK][D + 1];

  const int qb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / g.G;
  const int tid = threadIdx.x, part = tid & 1;
  const int r0 = qb * BQ;
  const int qrow = r0 + (tid >> 1);
  const bool row_ok = qrow < g.Tq;
  const long long off =
      row_ok ? (((long long)b * g.Tq + qrow) * g.H + h) * D : 0;
  float qreg[DH], dreg[DH], acc[DH];
#pragma unroll
  for (int i = 0; i < DH; ++i) {
    qreg[i] = row_ok ? q[off + 2 * i + part] : 0.f;
    dreg[i] = row_ok ? dout[off + 2 * i + part] : 0.f;
    acc[i] = 0.f;
  }
  const long long lidx = ((long long)b * g.H + h) * g.Tq + qrow;
  const float lse_r = row_ok ? lse[lidx] : 0.f;
  const float dl_r = row_ok ? delta[lidx] : 0.f;

  int lo, hi;
  key_range(g, r0, BQ, &lo, &hi);
  for (int k0 = (lo / BK) * BK; k0 < hi; k0 += BK) {
    __syncthreads();
    for (int idx = tid; idx < BK * D; idx += THREADS) {
      const int j = idx / D, d = idx % D;
      const int kp = k0 + j;
      float kk = 0.f, vv = 0.f;
      if (kp < g.Tk) {
        const long long o = (((long long)b * g.Tk + kp) * g.KV + kvh) * D + d;
        kk = k[o];
        vv = v[o];
      }
      ks[j][d] = kk;
      vs[j][d] = vv;
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int i = 0; i < DH; ++i) {
        s += qreg[i] * ks[j][2 * i + part];
        dp += dreg[i] * vs[j][2 * i + part];
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      dp += __shfl_xor_sync(0xffffffffu, dp, 1);
      const float p =
          masked(g, qrow, k0 + j) ? 0.f : expf(s * g.scale - lse_r);
      const float ds = p * (dp - dl_r);
#pragma unroll
      for (int i = 0; i < DH; ++i) acc[i] += ds * ks[j][2 * i + part];
    }
  }
  if (!row_ok) return;
#pragma unroll
  for (int i = 0; i < DH; ++i) dq[off + 2 * i + part] = acc[i] * g.scale;
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_fma_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv,
                         Geometry g) {
  constexpr int DH = D / 2;
  constexpr int BT = fma_tile(D);
  __shared__ float qs[BT][D + 1];
  __shared__ float os[BT][D + 1];
  __shared__ float ls[BT], dl[BT];

  const int kb = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, part = tid & 1;
  const int k0 = kb * BKV;
  const int key = k0 + (tid >> 1);
  const bool key_ok = key < g.Tk;
  const long long off =
      key_ok ? (((long long)b * g.Tk + key) * g.KV + kvh) * D : 0;
  float kreg[DH], vreg[DH], dk_acc[DH], dv_acc[DH];
#pragma unroll
  for (int i = 0; i < DH; ++i) {
    kreg[i] = key_ok ? k[off + 2 * i + part] : 0.f;
    vreg[i] = key_ok ? v[off + 2 * i + part] : 0.f;
    dk_acc[i] = dv_acc[i] = 0.f;
  }

  int lo, hi;
  row_range(g, k0, BKV, &lo, &hi);
  for (int e = 0; e < g.G; ++e) {
    const int h = kvh * g.G + e;
    const long long lbase = ((long long)b * g.H + h) * g.Tq;
    for (int r0 = (lo / BT) * BT; r0 < hi; r0 += BT) {
      __syncthreads();
      for (int idx = tid; idx < BT * D; idx += THREADS) {
        const int i = idx / D, d = idx % D;
        const int row = r0 + i;
        float qq = 0.f, oo = 0.f;
        if (row < g.Tq) {
          const long long o = (((long long)b * g.Tq + row) * g.H + h) * D + d;
          qq = q[o];
          oo = dout[o];
        }
        qs[i][d] = qq;
        os[i][d] = oo;
      }
      for (int i = tid; i < BT; i += THREADS) {
        const int row = r0 + i;
        ls[i] = row < g.Tq ? lse[lbase + row] : 0.f;
        dl[i] = row < g.Tq ? delta[lbase + row] : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int i = 0; i < BT; ++i) {
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int x = 0; x < DH; ++x) {
          s += kreg[x] * qs[i][2 * x + part];
          dp += vreg[x] * os[i][2 * x + part];
        }
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        dp += __shfl_xor_sync(0xffffffffu, dp, 1);
        const float p =
            masked(g, r0 + i, key) ? 0.f : expf(s * g.scale - ls[i]);
        const float ds = p * (dp - dl[i]);
#pragma unroll
        for (int x = 0; x < DH; ++x) {
          dv_acc[x] += p * os[i][2 * x + part];
          dk_acc[x] += ds * qs[i][2 * x + part];
        }
      }
    }
  }
  if (!key_ok) return;
#pragma unroll
  for (int i = 0; i < DH; ++i) {
    dk[off + 2 * i + part] = dk_acc[i] * g.scale;
    dv[off + 2 * i + part] = dv_acc[i];
  }
}

// ------------------------------------------------------------- launch ---

struct Strides {
  long long b, t, h;     // element strides of dims 0-2; unit on head_dim
};

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *dq, *dk, *dv;
  int B;
  Strides sq, so, sk;    // q, do, and k/v (shared)
};

// Tensor maps kept (tensor_map.cuh): four a kernel (q, do, k, v), so a
// training step's 8 layers x 2 kernels fit (64 maps).
constexpr int MAPS = 96;

// What this thread's last launch of each kernel (0 dq, 1 dk/dv) ran:
// route (0 FMA, 1 mma.sync, 2 wgmma), rows a CTA (q rows for dq, keys
// for dk/dv), rows a streamed tile holds (keys for dq, q rows for
// dk/dv), and the grid.
thread_local int last_launch[2][6] = {{0, 0, 0, 0, 0, 0},
                                      {0, 0, 0, 0, 0, 0}};

void record(int which, int route, int rows, int tile, const dim3& grid) {
  int* out = last_launch[which];
  out[0] = route;
  out[1] = rows;
  out[2] = tile;
  out[3] = grid.x;
  out[4] = grid.y;
  out[5] = grid.z;
}

// The four tensor maps of a wgmma launch: q/do in boxes of `qrows` rows,
// k/v in boxes of `krows`.
bool encode_maps(CUtensorMap* m, const Args& a, const Geometry& g, int D,
                 int qrows, int krows) {
  using tfm_tmap::encode_cached;
  return encode_cached<MAPS>(&m[0], {a.q, a.sq.b, a.sq.t, a.sq.h, a.B, g.Tq,
                                     g.H, D, qrows}) &&
         encode_cached<MAPS>(&m[1], {a.dout, a.so.b, a.so.t, a.so.h, a.B,
                                     g.Tq, g.H, D, qrows}) &&
         encode_cached<MAPS>(&m[2], {a.k, a.sk.b, a.sk.t, a.sk.h, a.B, g.Tk,
                                     g.KV, D, krows}) &&
         encode_cached<MAPS>(&m[3], {a.v, a.sk.b, a.sk.t, a.sk.h, a.B, g.Tk,
                                     g.KV, D, krows});
}

template <int D, int NWG>
cudaError_t launch_dq_wgmma(const Args& a, const Geometry& g,
                            cudaStream_t s) {
  using L = DqLayout<D, NWG>;
  CUtensorMap m[4];
  if (!encode_maps(m, a, g, D, L::BQ, L::BK)) return cudaErrorInvalidValue;
  auto kernel = flash_bwd_dq_wgmma_kernel<D, NWG>;
  static std::atomic<unsigned> smem_set{0};
  cudaError_t err = tfm_async::smem_limit_once(
      smem_set, reinterpret_cast<const void*>(kernel), L::BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid(g.H, a.B, (g.Tq + L::BQ - 1) / L::BQ);
  kernel<<<grid, L::THREADS, L::BYTES, s>>>(
      m[0], m[1], m[2], m[3], static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), a.dq, g, g.scale * LOG2E);
  record(0, 2, L::BQ, L::BK, grid);
  return cudaGetLastError();
}

template <int D, int NWG>
cudaError_t launch_dkv_wgmma(const Args& a, const Geometry& g,
                             cudaStream_t s) {
  using L = DkvLayout<D, NWG>;
  CUtensorMap m[4];
  if (!encode_maps(m, a, g, D, L::BT, L::BK)) return cudaErrorInvalidValue;
  auto kernel = flash_bwd_dkv_wgmma_kernel<D, NWG>;
  static std::atomic<unsigned> smem_set{0};
  cudaError_t err = tfm_async::smem_limit_once(
      smem_set, reinterpret_cast<const void*>(kernel), L::BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid(g.KV, a.B, (g.Tk + L::BK - 1) / L::BK);
  kernel<<<grid, L::THREADS, L::BYTES, s>>>(
      m[0], m[1], m[2], m[3], static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), a.dk, a.dv, g, g.scale * LOG2E);
  record(1, 2, L::BK, L::BT, grid);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_wgmma(int which, const Args& a, const Geometry& g,
                         int rows, cudaStream_t s) {
  if (rows == 64)
    return which == 0 ? launch_dq_wgmma<D, 1>(a, g, s)
                      : launch_dkv_wgmma<D, 1>(a, g, s);
  if (rows == 128)
    return which == 0 ? launch_dq_wgmma<D, 2>(a, g, s)
                      : launch_dkv_wgmma<D, 2>(a, g, s);
  return cudaErrorInvalidValue;
}

template <int D>
cudaError_t launch_mma(int which, const Args& a, const Geometry& g,
                       cudaStream_t s) {
  const bf16 *q = static_cast<const bf16*>(a.q),
             *k = static_cast<const bf16*>(a.k),
             *v = static_cast<const bf16*>(a.v),
             *dout = static_cast<const bf16*>(a.dout);
  const float *lse = static_cast<const float*>(a.lse),
              *delta = static_cast<const float*>(a.delta);
  if (which == 0) {
    const dim3 grid((g.Tq + BQ - 1) / BQ, g.H, a.B);
    flash_bwd_dq_mma_kernel<D><<<grid, THREADS, 0, s>>>(q, k, v, dout, lse,
                                                        delta, a.dq, g);
    record(0, 1, BQ, MMA_TILE, grid);
  } else {
    const dim3 grid((g.Tk + BKV - 1) / BKV, g.KV, a.B);
    flash_bwd_dkv_mma_kernel<D><<<grid, THREADS, 0, s>>>(
        q, k, v, dout, lse, delta, a.dk, a.dv, g);
    record(1, 1, BKV, MMA_TILE, grid);
  }
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_fma(int which, const Args& a, const Geometry& g,
                       cudaStream_t s) {
  const float *q = static_cast<const float*>(a.q),
              *k = static_cast<const float*>(a.k),
              *v = static_cast<const float*>(a.v),
              *dout = static_cast<const float*>(a.dout),
              *lse = static_cast<const float*>(a.lse),
              *delta = static_cast<const float*>(a.delta);
  if (which == 0) {
    const dim3 grid((g.Tq + BQ - 1) / BQ, g.H, a.B);
    flash_bwd_dq_fma_kernel<D><<<grid, THREADS, 0, s>>>(
        q, k, v, dout, lse, delta, static_cast<float*>(a.dq), g);
    record(0, 0, BQ, fma_tile(D), grid);
  } else {
    const dim3 grid((g.Tk + BKV - 1) / BKV, g.KV, a.B);
    flash_bwd_dkv_fma_kernel<D><<<grid, THREADS, 0, s>>>(
        q, k, v, dout, lse, delta, static_cast<float*>(a.dk),
        static_cast<float*>(a.dv), g);
    record(1, 0, BKV, fma_tile(D), grid);
  }
  return cudaGetLastError();
}

// The route of these operands: bf16 head_dim 64/128 on wgmma (rows 64 or
// 128 a CTA), bf16 16/32 on mma.sync, fp32 head_dim 8..128 on the FMA
// units.  Anything else is refused, never sent another way.
cudaError_t launch(int which, int D, int is_bf16, int rows, const Args& a,
                   const Geometry& g, cudaStream_t s) {
  if (is_bf16) {
    switch (D) {
      case 16: return launch_mma<16>(which, a, g, s);
      case 32: return launch_mma<32>(which, a, g, s);
      case 64: return launch_wgmma<64>(which, a, g, rows, s);
      case 128: return launch_wgmma<128>(which, a, g, rows, s);
      default: return cudaErrorInvalidValue;
    }
  }
  switch (D) {
    case 8: return launch_fma<8>(which, a, g, s);
    case 16: return launch_fma<16>(which, a, g, s);
    case 32: return launch_fma<32>(which, a, g, s);
    case 64: return launch_fma<64>(which, a, g, s);
    case 128: return launch_fma<128>(which, a, g, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" const char* tfm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// What this thread's last launches ran: out[0..5] for tfm_flash_bwd_dq,
// out[6..11] for tfm_flash_bwd_dkv, each the route (0 FMA, 1 mma.sync,
// 2 wgmma), rows a CTA (q rows / keys), rows a streamed tile holds (keys
// / q rows) and the grid.
extern "C" void tfm_flash_bwd_last_launch(int* out) {
  for (int i = 0; i < 12; ++i) out[i] = last_launch[i / 6][i % 6];
}

// Shared arguments of both entries.  q/do: [B, Tq, H, D] with element
// strides (sqb, sqt, sqh) / (sob, sot, soh) and unit stride on D; k/v:
// [B, Tk, KV, D] sharing strides (skb, skt, skh); lse/delta: contiguous
// fp32 [B, H, Tq]; all operands bf16 (is_bf16) or all fp32.  bf16 at
// head_dim 64 or 128 (the wgmma route) needs 16-byte aligned bases and
// strides of a multiple of 8 elements (a tensor map's rule) and
// block_rows 64 or 128 (rows a CTA); the other routes need contiguous
// operands and ignore the strides and block_rows.  window <= 0 means no
// window.  Outputs are contiguous, in the operand type or, with out_f32,
// fp32 (fp32 operands always write fp32).  Each entry returns
// cudaGetLastError() after its launch.

// dq: [B, Tq, H, D].
extern "C" int tfm_flash_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int B, int Tq, int Tk,
    int H, int KV, int D, long long sqb, long long sqt, long long sqh,
    long long sob, long long sot, long long soh, long long skb,
    long long skt, long long skh, int causal, int window, int q_offset,
    float scale, int is_bf16, int out_f32, int block_rows, void* stream) {
  if (KV <= 0 || H % KV != 0) return cudaErrorInvalidValue;
  const Geometry g{Tq, Tk, H, KV, H / KV, causal, window, q_offset, scale,
                   is_bf16 ? out_f32 : 1};
  const Args a{q, k, v, dout, lse, delta, dq, nullptr, nullptr, B,
               {sqb, sqt, sqh}, {sob, sot, soh}, {skb, skt, skh}};
  return static_cast<int>(launch(0, D, is_bf16, block_rows, a, g,
                                 static_cast<cudaStream_t>(stream)));
}

// dk, dv: [B, Tk, KV, D], each summed over its G = H / KV q heads;
// block_rows is keys a CTA.
extern "C" int tfm_flash_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int B, int Tq,
    int Tk, int H, int KV, int D, long long sqb, long long sqt,
    long long sqh, long long sob, long long sot, long long soh,
    long long skb, long long skt, long long skh, int causal, int window,
    int q_offset, float scale, int is_bf16, int out_f32, int block_rows,
    void* stream) {
  if (KV <= 0 || H % KV != 0) return cudaErrorInvalidValue;
  const Geometry g{Tq, Tk, H, KV, H / KV, causal, window, q_offset, scale,
                   is_bf16 ? out_f32 : 1};
  const Args a{q, k, v, dout, lse, delta, nullptr, dk, dv, B,
               {sqb, sqt, sqh}, {sob, sot, soh}, {skb, skt, skh}};
  return static_cast<int>(launch(1, D, is_bf16, block_rows, a, g,
                                 static_cast<cudaStream_t>(stream)));
}
