// Flash-attention backward for Hopper (sm_90a): dq, and dk/dv, from the
// forward's stored per-row logsumexp.  bf16 operands on the tensor cores
// (mma.sync m16n8k16), fp32 operands on the FMA units; fp32 accumulation.
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
// with dk/dv summed over the G q heads that share a kv head.  Operands are
// contiguous q/do [B, Tq, H, D], k/v [B, Tk, KV, D], lse/delta fp32
// [B, H, Tq]; query row i is global position i + q_offset; any Tq/Tk runs
// (the ragged edge is masked here).  As in the TPU kernels, p rounds to
// the operand type before p^T do and ds before ds k and ds^T q.  Outputs
// are dq [B, Tq, H, D] and dk/dv [B, Tk, KV, D], in the operand type or
// fp32 (out_f32), written once each from fp32 registers.
//
// What bounds it on this card: at the training shape (B 8, T 2048, H 8,
// D 64, causal, bf16) dq does 6*D FLOPs per visible (q, k) pair (q k^T,
// do v^T, ds k) = 5.2e10, 0.052 ms at 989 TFLOP/s, and moves ~85 MB
// (0.025 ms at 3.35 TB/s); dk/dv does 8*D per pair (q k^T, do v^T,
// p^T do, ds^T q) = 6.9e10, 0.069 ms.  Both are bound by operations.
//
// What this design does about it: the TPU kernels carry their
// accumulators across a sequential grid dimension; here the reduction is
// a loop inside one CTA, so nothing crosses CTAs and no atomics are
// needed (the result is deterministic).
// * dq: one CTA per (64-row q tile, q head, batch); 4 warps of 16 rows.
//   q and do stay in registers as A fragments; the CTA loops over the key
//   tiles the mask lets the tile see (up to the causal diagonal, from the
//   window's first live tile), with K and V in padded shared tiles
//   [key][d] (B of q k^T and do v^T) and K once more as [d][key] (B of
//   ds k).  S and dP accumulate in registers, ds is formed there and
//   re-packed as the bf16 A fragment of ds k; dq stays in fp32 registers.
// * dk/dv: one CTA per (64-key tile, kv head, batch); 4 warps of 16 keys.
//   The CTA computes the transposed products directly — S^T = k q^T and
//   dP^T = v do^T with k and v as register A fragments — so p^T and ds^T
//   come out in the accumulator layout that is already the A fragment of
//   p^T do and ds^T q.  It loops over the G q heads of the group and, for
//   each, over the q tiles from the diagonal to the window's end, with q
//   and do staged in shared memory both as [row][d] and [d][row].
// Every tile is padded by 8 bf16 a row, so the fragment loads of a warp
// hit 32 distinct banks.  wgmma/TMA pipelining is later work; PERF.md
// records the distance to the bound.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

using tfm::bf16;
using tfm::mma_bf16_smem;
using tfm::pack_a;

constexpr int BQ = 64;        // q rows per dq CTA
constexpr int BKV = 64;       // keys per dk/dv CTA
constexpr int THREADS = 128;  // 4 warps
constexpr int PAD = 8;        // bf16 row padding of every shared tile

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

// ---------------------------------------------------------------- bf16 ---

template <int D, int BK>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const bf16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, void* __restrict__ dq,
                        Geometry g) {
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

template <int D, int BT>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_mma_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         void* __restrict__ dk, void* __restrict__ dv,
                         Geometry g) {
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
  constexpr int BK = D <= 64 ? 64 : 32;
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
  constexpr int BT = D <= 64 ? 64 : 32;
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

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *dq, *dk, *dv;
  int B;
};

// bf16 runs the tensor-core kernels (head_dim a multiple of 16), fp32 the
// FMA kernels; the tile along the loop shrinks at head_dim 128 so the
// static shared tiles stay under 48 KB.
template <int D>
cudaError_t launch_dq(const Args& a, const Geometry& g, int is_bf16,
                      cudaStream_t s) {
  constexpr int BK = D <= 64 ? 64 : 32;
  dim3 grid((g.Tq + BQ - 1) / BQ, g.H, a.B);
  if constexpr (D % 16 == 0) {
    if (is_bf16) {
      flash_bwd_dq_mma_kernel<D, BK><<<grid, THREADS, 0, s>>>(
          static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
          static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
          static_cast<const float*>(a.lse),
          static_cast<const float*>(a.delta), a.dq, g);
      return cudaGetLastError();
    }
  }
  if (is_bf16) return cudaErrorInvalidValue;
  flash_bwd_dq_fma_kernel<D><<<grid, THREADS, 0, s>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<float*>(a.dq), g);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const Args& a, const Geometry& g, int is_bf16,
                       cudaStream_t s) {
  constexpr int BT = D <= 64 ? 64 : 32;
  dim3 grid((g.Tk + BKV - 1) / BKV, g.KV, a.B);
  if constexpr (D % 16 == 0) {
    if (is_bf16) {
      flash_bwd_dkv_mma_kernel<D, BT><<<grid, THREADS, 0, s>>>(
          static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
          static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
          static_cast<const float*>(a.lse),
          static_cast<const float*>(a.delta), a.dk, a.dv, g);
      return cudaGetLastError();
    }
  }
  if (is_bf16) return cudaErrorInvalidValue;
  flash_bwd_dkv_fma_kernel<D><<<grid, THREADS, 0, s>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<float*>(a.dk), static_cast<float*>(a.dv), g);
  return cudaGetLastError();
}

// head_dim the kernels take: 8 (fp32 only), 16, 32, 64, 128.
template <template <int> class F>
cudaError_t dispatch(int D, int is_bf16, const Args& a, const Geometry& g,
                     cudaStream_t s) {
  switch (D) {
    case 8: return F<8>::run(a, g, is_bf16, s);
    case 16: return F<16>::run(a, g, is_bf16, s);
    case 32: return F<32>::run(a, g, is_bf16, s);
    case 64: return F<64>::run(a, g, is_bf16, s);
    case 128: return F<128>::run(a, g, is_bf16, s);
    default: return cudaErrorInvalidValue;
  }
}

template <int D>
struct DQ {
  static cudaError_t run(const Args& a, const Geometry& g, int is_bf16,
                         cudaStream_t s) {
    return launch_dq<D>(a, g, is_bf16, s);
  }
};

template <int D>
struct DKV {
  static cudaError_t run(const Args& a, const Geometry& g, int is_bf16,
                         cudaStream_t s) {
    return launch_dkv<D>(a, g, is_bf16, s);
  }
};

}  // namespace

extern "C" const char* tfm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Shared arguments of both entries.  q/do: contiguous [B, Tq, H, D];
// k/v: contiguous [B, Tk, KV, D]; lse/delta: contiguous fp32 [B, H, Tq];
// all operands bf16 (is_bf16) or all fp32.  window <= 0 means no window.
// Outputs are contiguous, in the operand type or, with out_f32, fp32
// (fp32 operands always write fp32).  Each entry returns
// cudaGetLastError() after its launch.

// dq: [B, Tq, H, D].
extern "C" int tfm_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dq, int B, int Tq,
                                int Tk, int H, int KV, int D, int causal,
                                int window, int q_offset, float scale,
                                int is_bf16, int out_f32, void* stream) {
  if (KV <= 0 || H % KV != 0) return cudaErrorInvalidValue;
  const Geometry g{Tq, Tk, H, KV, H / KV, causal, window, q_offset, scale,
                   is_bf16 ? out_f32 : 1};
  const Args a{q, k, v, dout, lse, delta, dq, nullptr, nullptr, B};
  return static_cast<int>(
      dispatch<DQ>(D, is_bf16, a, g, static_cast<cudaStream_t>(stream)));
}

// dk, dv: [B, Tk, KV, D], each summed over its G = H / KV q heads.
extern "C" int tfm_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dk, void* dv, int B,
                                 int Tq, int Tk, int H, int KV, int D,
                                 int causal, int window, int q_offset,
                                 float scale, int is_bf16, int out_f32,
                                 void* stream) {
  if (KV <= 0 || H % KV != 0) return cudaErrorInvalidValue;
  const Geometry g{Tq, Tk, H, KV, H / KV, causal, window, q_offset, scale,
                   is_bf16 ? out_f32 : 1};
  const Args a{q, k, v, dout, lse, delta, nullptr, dk, dv, B};
  return static_cast<int>(
      dispatch<DKV>(D, is_bf16, a, g, static_cast<cudaStream_t>(stream)));
}
