// Paged decode attention for Hopper (sm_90a): bf16 or float32 pools, or
// int8 pools with per-position float32 scales; float32 accumulation.
//
// Replaces: tfmesos_tpu/ops/attention.py, _flash_decode_paged_kernel
// (called through flash_decode_paged) — the TPU kernel behind every
// decode tick of the continuous batcher.
//
// What it computes: for each row b and each of its t chunk tokens,
// attention of q [B, t, H, D] over that row's cache, which lives in
// pages of a shared stacked pool [L, P, KV, page, D] (layer `layer`,
// read in place) named by the row's page-table row table[b, :NP], with
// ragged per-row positions pos[b].  Without a self chunk the pool holds
// the chunk already: token tt sees positions <= pos + tt.  With the
// deferred-write self chunk (kself/vself [B, t, KV, D] in q's type, not
// yet committed to the pool) the pool bound is exclusive — positions
// <= pos - 1 for every token — and the chunk attends from the self
// operand under the intra-chunk causal mask (token tt sees self slots
// <= tt).  `round_self` rounds each self slot first as an int8 pool slot
// holds it (int8_round.cuh), so the caller of an int8 pool hands over
// the raw chunk.  GQA: the G = H / KV query heads of a kv head share its
// pages.  int8 pools carry lane-major scales [L, P, KV, 1, page] folded
// into the score and the probability (decode_common.cuh), so pages are
// read at int8 width.
//
// What bounds it on this card: bytes.  A t = 1 step does ~4 FLOPs per
// K/V element it reads, far below the ~295 FLOP/byte balance point, so
// the least time is the live pages' K and V (and scales) over 3.35 TB/s.
// Reaching that needs the whole card reading at once — the serving
// shape has only B x KV = 64 (row, kv head) pairs for 132 SMs — and
// copies in flight while the products run.
//
// What this design does about it (flash_decode.cu's, over a page table):
// * Flash-decoding.  The grid is (KV, B x row tiles, S): the S CTAs of a
//   (row, kv head, tile of <= 4 query rows) split its live 64-key blocks
//   into contiguous shares (decode_split.cuh).  S comes from static
//   shapes and the SM count (the wrapper's _decode_plan), never from pos.
//   Each CTA reads pos[b] itself; a share past the live bound leaves the
//   empty partial.  The last split also takes the self chunk, whether or
//   not it owns pool blocks.  With S > 1 the partials go to scratch and
//   merge_partials combines them in a fixed order; with S = 1 the CTA
//   writes the output and no merge runs.
// * The producer warp chases the page table.  Block j is positions
//   [64 j, 64 j + 64) of the row: one page at page 64, a part of one page
//   above, several pages below.  Its lanes read the table entries of the
//   block's spans (one page each, clamped to [0, P)) one block ahead,
//   and each span of one kv head is a contiguous slab of the pool, so it
//   arrives by 1-D bulk copies (cp.async.bulk) of K and V — and of the
//   two lane-major scale slices of an int8 pool — into a ring of 3-4
//   stages guarded by mbarriers.  A block stages only up to the tile's
//   last visible position (rounded up to 8 keys).  Operands stay in their
//   stored type in shared memory; a span that is not 16-byte aligned or
//   sized is loaded by the producer warp with ordinary loads.  The self
//   chunk follows the pool blocks in the same ring, a block of up to 64
//   slots at a time (a bulk copy a slot), so a chunk of any length runs.
// * No block barrier.  Each of the 4 consumer warps owns 16 keys of every
//   block and keeps its own running (m, l, o) (decode_common.cuh); with
//   round_self a warp rounds its own self slots in registers as it loads
//   them.  Warps merge once, after their last block.  A one-row tile
//   (t = 1 without GQA: every serving tick of the flagship) runs an
//   instance that computes only its row, and a warp skips the steps of a
//   partial block that hold no key of its.

#include "decode_split.cuh"
#include "hopper_async.cuh"

namespace {

using tfm_async::mbar_arrive;
using tfm_async::mbar_arrive_expect_tx;
using tfm_async::mbar_wait;
using tfm_decode::aligned16;
using tfm_decode::BLOCK_KEYS;
using tfm_decode::CWARPS;
using tfm_decode::RT;
using tfm_decode::THREADS;

template <typename TQ, typename TKV, int D>
struct Plan {
  // A stage holds a pool block (K, V and scales) or a self block (K and
  // V of up to BLOCK_KEYS slots in q's type), whichever is larger.
  static constexpr int KV_BYTES = BLOCK_KEYS * D * (int)sizeof(TKV);
  static constexpr int SELF_BYTES = BLOCK_KEYS * D * (int)sizeof(TQ);
  static constexpr int POOL_STAGE = 2 * KV_BYTES + 2 * BLOCK_KEYS * 4;
  static constexpr int STAGE =
      POOL_STAGE > 2 * SELF_BYTES ? POOL_STAGE : 2 * SELF_BYTES;
  static constexpr int NST = 4 * STAGE <= 160 * 1024 ? 4 : 3;
  // stages, then 2 * NST barriers, q rows, the warps' partials, limits
  static constexpr int BAR_OFF = NST * STAGE;
  static constexpr int Q_OFF = BAR_OFF + 2 * NST * 8;
  static constexpr int WM_OFF = Q_OFF + RT * D * 4;
  static constexpr int WL_OFF = WM_OFF + CWARPS * RT * 4;
  static constexpr int WO_OFF = WL_OFF + CWARPS * RT * 4;
  static constexpr int LIM_OFF = WO_OFF + CWARPS * RT * D * 4;
  static constexpr int BYTES = LIM_OFF + RT * 4;
};

struct Args {
  const void *q, *kp, *vp;
  const float *ksc, *vsc;
  const int *table, *pos;
  const void *kself, *vself;  // the deferred self chunk, or null
  void* out;
  float *pm, *pl, *po;        // partials (S > 1), else null
  int B, t, H, KV, P, ps, NP, layer, S, tiles, round_self;
  float scale;
};

// Keys pool block j stages: its positions up to the tile's last visible
// one, `last`, rounded up to 8 (whole 32-byte scale slices), within the
// `cap` positions the table holds.
__device__ __forceinline__ int pool_keys(int j, int last, int cap) {
  const int k0 = j * BLOCK_KEYS;
  return min(min(BLOCK_KEYS, cap - k0), (last + 1 - k0 + 7) & ~7);
}

// The spans of pool block j (one page each) that this lane stages: span
// s = lane + 32 h covers table column c0 + s.  Their page ids, clamped
// into the pool, go to pg[h] (0 for a lane without that span).
__device__ __forceinline__ void span_pages(const int* trow, int j, int last,
                                           int cap, int ps, int P, int lane,
                                           int* pg) {
  const int k0 = j * BLOCK_KEYS, n = pool_keys(j, last, cap);
  const int c0 = k0 / ps, nsp = (k0 + n - 1) / ps - c0 + 1;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int s = lane + 32 * h;
    pg[h] = s < nsp ? max(0, min(trow[c0 + s], P - 1)) : 0;
  }
}

// Three CTAs an SM at head_dim <= 64 (at most 136 registers a thread):
// the serving shape's 8 x 8 x S 5 = 320 CTAs then run in one wave on 132
// SMs instead of two (PERF.md's findings have the timings).  Head_dim
// 128 would spill under that cap.
template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(THREADS, D <= 64 ? 3 : 1)
paged_split_kernel(const Args a) {
  using P = Plan<TQ, TKV, D>;
  constexpr bool kInt8 = std::is_same<TKV, int8_t>::value;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + P::BAR_OFF);
  uint64_t* empty = full + P::NST;
  float* qs = reinterpret_cast<float*>(smem + P::Q_OFF);
  float* wm = reinterpret_cast<float*>(smem + P::WM_OFF);
  float* wl = reinterpret_cast<float*>(smem + P::WL_OFF);
  float* wo = reinterpret_cast<float*>(smem + P::WO_OFF);
  int* lim = reinterpret_cast<int*>(smem + P::LIM_OFF);

  const int kvh = blockIdx.x, b = blockIdx.y / a.tiles;
  const int r0 = (blockIdx.y % a.tiles) * RT, split = blockIdx.z;
  const int G = a.H / a.KV, rows = a.t * G;
  const int R = min(RT, rows - r0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const bool has_self = a.kself != nullptr;

  // This tile's last pool position: committed positions < pos with a
  // self chunk, else its last token's own bound.  Its live blocks within
  // the table, the share of them this split owns, and the self blocks
  // (the last split's, slots up to the tile's last token).
  const int p0 = a.pos[b];
  const int tt_last = (r0 + R - 1) / G;
  const int last = has_self ? p0 - 1 : p0 + tt_last;
  const int cap = a.NP * a.ps;
  const int nb = last < 0 ? 0
                          : min(last / BLOCK_KEYS + 1,
                                (cap + BLOCK_KEYS - 1) / BLOCK_KEYS);
  int j0, j1;
  tfm_split::split_share(nb, a.S, split, &j0, &j1);
  const int npool = j1 - j0;
  const int nself =
      has_self && split == a.S - 1 ? tt_last / BLOCK_KEYS + 1 : 0;

  if (tid == 0) {
    for (int i = 0; i < P::NST; ++i) {
      tfm_async::mbar_init(&full[i], 1);
      tfm_async::mbar_init(&empty[i], CWARPS);
    }
    tfm_async::fence_barrier_init();
  }
  tfm_decode::load_rows<TQ, D>(static_cast<const TQ*>(a.q), qs, b, a.t,
                               a.H, G, kvh, r0, R);
  for (int r = tid; r < RT; r += THREADS)            // -1: sees nothing
    lim[r] = r >= R ? -1 : has_self ? p0 - 1 : p0 + (r0 + r) / G;
  __syncthreads();

  if (warp == CWARPS) {
    // ---- producer: pool blocks of the share, then the self blocks ----
    const int* trow = a.table + (long long)b * a.NP;
    const long long slab = (long long)a.ps * D;     // a page's head slab
    const long long head0 = (long long)a.layer * a.P * a.KV + kvh;
    const TKV* kp = static_cast<const TKV*>(a.kp);
    const TKV* vp = static_cast<const TKV*>(a.vp);
    int pg[2];
    if (npool > 0) span_pages(trow, j0, last, cap, a.ps, a.P, lane, pg);
    for (int i = 0; i < npool + nself; ++i) {
      const int st = i % P::NST;
      int nxt[2] = {0, 0};
      if (i + 1 < npool)     // the next block's pages load while we wait
        span_pages(trow, j0 + i + 1, last, cap, a.ps, a.P, lane, nxt);
      if (i >= P::NST) mbar_wait(&empty[st], ((i / P::NST) - 1) & 1);
      unsigned char* stage = smem + st * P::STAGE;
      if (i < npool) {
        TKV* ks = reinterpret_cast<TKV*>(stage);
        TKV* vs = reinterpret_cast<TKV*>(stage + P::KV_BYTES);
        float* kss = reinterpret_cast<float*>(stage + 2 * P::KV_BYTES);
        float* vss = kss + BLOCK_KEYS;
        const int j = j0 + i, k0 = j * BLOCK_KEYS;
        const int n = pool_keys(j, last, cap);
        const int c0 = k0 / a.ps, nsp = (k0 + n - 1) / a.ps - c0 + 1;
        // Span s: positions [lo, hi) of page pg, at offset lo - k0 of the
        // stage.  Bulk copies only if every span's pieces are aligned.
        bool ok = true;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int s = lane + 32 * h;
          if (s >= nsp) continue;
          const int base = (c0 + s) * a.ps;
          const int lo = max(k0, base), hi = min(k0 + n, base + a.ps);
          const long long src = (head0 + (long long)pg[h] * a.KV) * slab +
                                (long long)(lo - base) * D;
          const int off = (lo - k0) * D;
          ok = ok && aligned16(kp + src) && aligned16(vp + src) &&
               aligned16(ks + off) && (hi - lo) * D * sizeof(TKV) % 16 == 0;
          if (kInt8) {
            const long long ssrc =
                (head0 + (long long)pg[h] * a.KV) * a.ps + (lo - base);
            ok = ok && aligned16(a.ksc + ssrc) && aligned16(a.vsc + ssrc) &&
                 aligned16(kss + (lo - k0)) && (hi - lo) * 4 % 16 == 0;
          }
        }
        if (__all_sync(0xffffffffu, ok)) {
          if (lane == 0)
            mbar_arrive_expect_tx(
                &full[st], 2 * n * D * sizeof(TKV) + (kInt8 ? 8 * n : 0));
          __syncwarp();
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int s = lane + 32 * h;
            if (s >= nsp) continue;
            const int base = (c0 + s) * a.ps;
            const int lo = max(k0, base), hi = min(k0 + n, base + a.ps);
            const long long src = (head0 + (long long)pg[h] * a.KV) * slab +
                                  (long long)(lo - base) * D;
            const int off = (lo - k0) * D;
            const uint32_t bytes = (hi - lo) * D * sizeof(TKV);
            tfm_async::bulk_load(ks + off, kp + src, bytes, &full[st]);
            tfm_async::bulk_load(vs + off, vp + src, bytes, &full[st]);
            if (kInt8) {
              const long long ssrc =
                  (head0 + (long long)pg[h] * a.KV) * a.ps + (lo - base);
              tfm_async::bulk_load(kss + (lo - k0), a.ksc + ssrc,
                                   (hi - lo) * 4, &full[st]);
              tfm_async::bulk_load(vss + (lo - k0), a.vsc + ssrc,
                                   (hi - lo) * 4, &full[st]);
            }
          }
        } else {
          for (int idx = lane; idx < n * D; idx += 32) {
            const int kpos = k0 + idx / D;
            const int page = max(0, min(trow[kpos / a.ps], a.P - 1));
            const long long src = (head0 + (long long)page * a.KV) * slab +
                                  (long long)(kpos % a.ps) * D + idx % D;
            ks[idx] = kp[src];
            vs[idx] = vp[src];
          }
          if (kInt8) {
            for (int p = lane; p < n; p += 32) {
              const int kpos = k0 + p;
              const int page = max(0, min(trow[kpos / a.ps], a.P - 1));
              const long long ssrc =
                  (head0 + (long long)page * a.KV) * a.ps + kpos % a.ps;
              kss[p] = a.ksc[ssrc];
              vss[p] = a.vsc[ssrc];
            }
          }
          tfm_async::fence_proxy_async();
          __syncwarp();
          if (lane == 0) mbar_arrive(&full[st]);
        }
        pg[0] = nxt[0];
        pg[1] = nxt[1];
      } else {
        // Self slots [s0, s0 + n): slot s holds token s's K/V of this kv
        // head, KV * D elements apart in the chunk.
        TQ* ks = reinterpret_cast<TQ*>(stage);
        TQ* vs = reinterpret_cast<TQ*>(stage + P::SELF_BYTES);
        const int s0 = (i - npool) * BLOCK_KEYS;
        const int n = min(BLOCK_KEYS, tt_last + 1 - s0);
        const long long stride = (long long)a.KV * D;
        const long long src = (((long long)b * a.t + s0) * a.KV + kvh) * D;
        const TQ* kb = static_cast<const TQ*>(a.kself) + src;
        const TQ* vb = static_cast<const TQ*>(a.vself) + src;
        constexpr uint32_t bytes = D * sizeof(TQ);
        if (aligned16(kb) && aligned16(vb) && bytes % 16 == 0 &&
            stride * sizeof(TQ) % 16 == 0) {
          if (lane == 0) mbar_arrive_expect_tx(&full[st], 2 * n * bytes);
          __syncwarp();
          for (int s = lane; s < n; s += 32) {
            tfm_async::bulk_load(ks + s * D, kb + s * stride, bytes,
                                 &full[st]);
            tfm_async::bulk_load(vs + s * D, vb + s * stride, bytes,
                                 &full[st]);
          }
        } else {
          for (int idx = lane; idx < n * D; idx += 32) {
            const long long e = (idx / D) * stride + idx % D;
            ks[idx] = kb[e];
            vs[idx] = vb[e];
          }
          tfm_async::fence_proxy_async();
          __syncwarp();
          if (lane == 0) mbar_arrive(&full[st]);
        }
      }
    }
  } else {
    // ---- consumers: warp `warp` owns keys [warp * KW, + KW) of a block --
    tfm_decode::WarpRows<D> w;
    w.init(qs, lane);
    int lims[RT], self_lims[RT];
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      lims[r] = lim[r];
      self_lims[r] = r < R ? (r0 + r) / G : -1;   // intra-chunk causality
    }
    // A one-row tile computes one row's products (NR 1), else all RT.
    auto consume = [&](auto nr) {
      constexpr int NR = decltype(nr)::value;
      for (int i = 0; i < npool + nself; ++i) {
        const int st = i % P::NST;
        mbar_wait(&full[st], (i / P::NST) & 1);
        const unsigned char* stage = smem + st * P::STAGE;
        if (i < npool) {
          const int j = j0 + i;
          const float* kss =
              reinterpret_cast<const float*>(stage + 2 * P::KV_BYTES);
          w.template step<NR, TKV>(
              lims, reinterpret_cast<const TKV*>(stage),
              reinterpret_cast<const TKV*>(stage + P::KV_BYTES), kss,
              kss + BLOCK_KEYS, pool_keys(j, last, cap), j * BLOCK_KEYS,
              a.scale, false, warp, lane);
        } else {
          const int s0 = (i - npool) * BLOCK_KEYS;
          w.template step<NR, TQ>(
              self_lims, reinterpret_cast<const TQ*>(stage),
              reinterpret_cast<const TQ*>(stage + P::SELF_BYTES), nullptr,
              nullptr, min(BLOCK_KEYS, tt_last + 1 - s0), s0, a.scale,
              a.round_self != 0, warp, lane);
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[st]);
      }
    };
    if (R == 1)
      consume(std::integral_constant<int, 1>());
    else
      consume(std::integral_constant<int, RT>());
    w.park(wm, wl, wo, warp, lane);
  }
  __syncthreads();

  // Merge the warps; write the output (S = 1) or this split's partial.
  tfm_split::finish_tile<TQ, D>(wm, wl, wo, R, r0, G, b, a.t, a.H, kvh, a.B,
                                split, static_cast<TQ*>(a.out), a.pm, a.pl,
                                a.po);
}

// The grids of this thread's last tfm_flash_decode_paged call: the split
// kernel's (x, y, z = S) and the merge's x (0: no merge ran).
thread_local int last_launch[4] = {0, 0, 0, 0};

template <typename TQ, typename TKV>
int launch(const Args& a, int D, cudaStream_t s) {
  return tfm_split::with_head_dim(D, [&](auto d) {
    constexpr int kD = decltype(d)::value;
    static std::atomic<unsigned> smem_set{0};
    return tfm_split::launch_split<TQ, kD>(
        paged_split_kernel<TQ, TKV, kD>, Plan<TQ, TKV, kD>::BYTES, smem_set,
        a, last_launch, s);
  });
}

}  // namespace

extern "C" const char* tfm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// What this thread's last tfm_flash_decode_paged launched: out[0..2] the
// split kernel's grid (KV, B x row tiles, S), out[3] the merge's CTAs (0
// when S = 1 and no merge ran).
extern "C" void tfm_flash_decode_paged_last_launch(int* out) {
  for (int i = 0; i < 4; ++i) out[i] = last_launch[i];
}

// q: contiguous [B, t, H, D]; kpool/vpool: contiguous [L, P, KV, ps, D]
// (int8 when kv_int8, else q's type); kscale/vscale: contiguous float32
// [L, P, KV, 1, ps] when kv_int8, else null; table: contiguous int32
// [B, NP]; pos: int32 [B]; kself/vself: contiguous [B, t, KV, D] of q's
// type, or null (no self chunk); round_self: round each self slot as an
// int8 slot first; out: contiguous [B, t, H, D] of q's type (bf16 when
// is_bf16, else float32).  splits: 1 <= S <= 64 CTAs per (row, kv head,
// row tile); with S > 1, pm/pl (float32 [S, B*t*H]) and po (float32
// [S, B*t*H, D]) are the partials' scratch and a merge kernel follows,
// else they are null.  head_dim D in {8, 16, 32, 64, 128}.  Returns
// cudaGetLastError() after the launches.
extern "C" int tfm_flash_decode_paged(
    const void* q, const void* kpool, const void* vpool, const void* kscale,
    const void* vscale, const void* table, const void* pos,
    const void* kself, const void* vself, void* out, void* pm, void* pl,
    void* po, int B, int t, int H, int KV, int D, int P, int ps, int NP,
    int layer, int splits, int round_self, float scale, int is_bf16,
    int kv_int8, void* stream) {
  if (KV <= 0 || H % KV != 0 || B <= 0 || t <= 0 || ps <= 0 || P <= 0 ||
      NP < 0 || splits < 1 || splits > tfm_split::MAX_SPLITS)
    return cudaErrorInvalidValue;
  if (kv_int8 && (kscale == nullptr || vscale == nullptr))
    return cudaErrorInvalidValue;
  if ((kself == nullptr) != (vself == nullptr) ||
      (round_self && kself == nullptr))
    return cudaErrorInvalidValue;
  if (splits > 1 && (pm == nullptr || pl == nullptr || po == nullptr))
    return cudaErrorInvalidValue;
  const int rows = t * (H / KV);
  Args a{q, kpool, vpool,
         kv_int8 ? static_cast<const float*>(kscale) : nullptr,
         kv_int8 ? static_cast<const float*>(vscale) : nullptr,
         static_cast<const int*>(table), static_cast<const int*>(pos),
         kself, vself, out,
         splits > 1 ? static_cast<float*>(pm) : nullptr,
         static_cast<float*>(pl), static_cast<float*>(po),
         B, t, H, KV, P, ps, NP, layer, splits, (rows + RT - 1) / RT,
         round_self, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    using TQ = __nv_bfloat16;
    return kv_int8 ? launch<TQ, int8_t>(a, D, s) : launch<TQ, TQ>(a, D, s);
  }
  return kv_int8 ? launch<float, int8_t>(a, D, s)
                 : launch<float, float>(a, D, s);
}
