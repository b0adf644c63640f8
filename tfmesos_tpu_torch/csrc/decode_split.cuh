// Flash-decoding's bookkeeping, shared by the decode kernels that split
// a row's live key blocks over S CTAs (flash_decode.cu,
// flash_decode_paged.cu): which blocks a split owns, how a split leaves
// its partial softmax state, and the merge of the S partials.
//
// A split's partial for one query row is (m, l, o): its running max, its
// sum of exp(s - m) and its unnormalized sum of p v, all float32.  A
// split that owns no block leaves the empty partial (-inf, 0, 0).  The
// merge is m* = max_s m_s, l = sum_s l_s e^(m_s - m*),
// o = sum_s o_s e^(m_s - m*) / l, with e^(-inf - m*) read as 0 and a row
// whose l is 0 written as zeros.  Every sum runs in a fixed order, so
// results are the same bits from run to run.
//
// Partials live in scratch the caller allocates: pm, pl [S][rows] and
// po [S][rows][D], rows = B * t * H in the output's row order.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include <atomic>
#include <type_traits>

#include "decode_common.cuh"
#include "hopper_async.cuh"

namespace tfm_split {

// Split s of S owns the contiguous blocks [j0, j1) of a row's nb live
// blocks: shares of ceil(nb / S), the last ones short or empty.
__device__ __forceinline__ void split_share(int nb, int S, int s,
                                            int* j0, int* j1) {
  const int per = (nb + S - 1) / S;
  *j0 = min(nb, s * per);
  *j1 = min(nb, *j0 + per);
}

// Weight of a partial with max m against the merged max mx.
__device__ __forceinline__ float merge_weight(float m, float mx) {
  return m == -INFINITY ? 0.f : expf(m - mx);
}

// The most splits a row may have: the merge holds two per lane.
constexpr int MAX_SPLITS = 64;

// One warp per output row: merge the row's S <= MAX_SPLITS partials into
// out (contiguous [rows][D] of TQ).  Lane i holds splits i and i + 32,
// so the partials' loads all issue at once; the weights reach the lanes
// that sum o by shuffles.  Every sum runs in a fixed order.
template <typename TQ>
__global__ void __launch_bounds__(128)
merge_partials(const float* __restrict__ pm, const float* __restrict__ pl,
               const float* __restrict__ po, TQ* __restrict__ out, int rows,
               int S, int D) {
  const int row = blockIdx.x * 4 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const long long i0 = (long long)lane * rows + row;
  const long long i1 = i0 + 32LL * rows;
  const float m0 = lane < S ? pm[i0] : -INFINITY;
  const float m1 = lane + 32 < S ? pm[i1] : -INFINITY;
  const float mx = tfm_decode::warp_max(fmaxf(m0, m1));
  const float w0 = merge_weight(m0, mx), w1 = merge_weight(m1, mx);
  const float l = tfm_decode::warp_sum((lane < S ? pl[i0] * w0 : 0.f) +
                                       (lane + 32 < S ? pl[i1] * w1 : 0.f));
  for (int d0 = 0; d0 < D; d0 += 32) {
    const int d = d0 + lane;
    float o = 0.f;
#pragma unroll 8
    for (int s = 0; s < S; ++s) {
      const float w = __shfl_sync(0xffffffffu, s < 32 ? w0 : w1, s % 32);
      if (d < D) o += po[((long long)s * rows + row) * D + d] * w;
    }
    if (d < D)
      out[(long long)row * D + d] =
          tfm_decode::from_f<TQ>(l > 0.f ? o / l : 0.f);
  }
}

// After every consumer warp parked its (m, l, o) (wm, wl [CWARPS][RT],
// wo [CWARPS][RT][D]; call after a CTA barrier): merge the warps of the
// tile's R rows and write the output (S = 1: pm is null; out contiguous
// [B, t, H, D]) or split `split`'s partial, in the output's row order.
template <typename TQ, int D>
__device__ __forceinline__ void finish_tile(
    const float* wm, const float* wl, const float* wo, int R, int r0, int G,
    int b, int t, int H, int kvh, int B, int split, TQ* out, float* pm,
    float* pl, float* po) {
  using tfm_decode::CWARPS;
  using tfm_decode::RT;
  const int out_rows = B * t * H;
  for (int idx = threadIdx.x; idx < R * D; idx += tfm_decode::THREADS) {
    const int r = idx / D, d = idx % D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < CWARPS; ++w) mx = fmaxf(mx, wm[w * RT + r]);
    float lsum = 0.f, osum = 0.f;
#pragma unroll
    for (int w = 0; w < CWARPS; ++w) {
      const float wt = merge_weight(wm[w * RT + r], mx);
      lsum += wl[w * RT + r] * wt;
      osum += wo[(w * RT + r) * D + d] * wt;
    }
    const int tt = (r0 + r) / G, gi = (r0 + r) % G;
    const long long row = ((long long)b * t + tt) * H + kvh * G + gi;
    if (pm == nullptr) {
      out[row * D + d] = tfm_decode::from_f<TQ>(lsum > 0.f ? osum / lsum
                                                           : 0.f);
    } else {
      const long long prow = (long long)split * out_rows + row;
      po[prow * D + d] = osum;
      if (d == 0) {
        pm[prow] = mx;
        pl[prow] = lsum;
      }
    }
  }
}

// CTAs of the merge over `rows` output rows (four warps, a row each).
inline int merge_blocks(int rows) { return (rows + 3) / 4; }

template <typename TQ>
cudaError_t launch_merge(const float* pm, const float* pl, const float* po,
                         TQ* out, int rows, int S, int D,
                         cudaStream_t stream) {
  merge_partials<TQ><<<merge_blocks(rows), 128, 0, stream>>>(pm, pl, po,
                                                             out, rows, S, D);
  return cudaGetLastError();
}

// Launch a split decode kernel — grid (KV, B x row tiles, S) of THREADS
// threads and `bytes` of dynamic shared memory, the limit raised once per
// instance through `smem_set` — and, with S > 1, the merge.  The grids go
// to `report`: x, y, z = S, and the merge's CTAs (0: none ran).  `a` is
// the kernel's argument struct (KV, B, tiles, S, t, H, out, pm, pl, po).
template <typename TQ, int D, typename Args>
int launch_split(void (*kernel)(Args), int bytes,
                 std::atomic<unsigned>& smem_set, const Args& a, int* report,
                 cudaStream_t s) {
  cudaError_t err = tfm_async::smem_limit_once(
      smem_set, reinterpret_cast<const void*>(kernel), bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.KV, a.B * a.tiles, a.S);
  kernel<<<grid, tfm_decode::THREADS, bytes, s>>>(a);
  err = cudaGetLastError();
  const int rows = a.B * a.t * a.H;
  report[0] = grid.x;
  report[1] = grid.y;
  report[2] = grid.z;
  report[3] = a.S > 1 ? merge_blocks(rows) : 0;
  if (err != cudaSuccess || a.S == 1) return err;
  return launch_merge<TQ>(a.pm, a.pl, a.po, static_cast<TQ*>(a.out), rows,
                          a.S, D, s);
}

// f(std::integral_constant<int, D>()) for a head_dim the decode kernels
// are built for, else cudaErrorInvalidValue.
template <typename F>
int with_head_dim(int D, F f) {
  switch (D) {
    case 8: return f(std::integral_constant<int, 8>());
    case 16: return f(std::integral_constant<int, 16>());
    case 32: return f(std::integral_constant<int, 32>());
    case 64: return f(std::integral_constant<int, 64>());
    case 128: return f(std::integral_constant<int, 128>());
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tfm_split
