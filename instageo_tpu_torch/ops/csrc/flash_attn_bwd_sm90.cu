// Flash-attention backward for Hopper (sm_90a) with TMA, wgmma and warp
// specialisation: bf16 q, k, v, O, dO and f32 lse in, bf16 dq, dk, dv out,
// head dims 64 and 80.
//
// Replaces three Pallas TPU kernels of instageo_tpu/ops/attention.py:
//   _attn_bwd_kernel_blo  (O and dO merged (B, L, H*Dh), the training path),
//   _attn_bwd_kernel      (O and dO heads-first),
//   _attn_bwd_kernel_bloq (q rows in blocks, dk/dv summed over them in f32).
// A layout is only a set of strides (tensor maps for q, k, v, dO; element
// strides for O, dq, dk, dv). flash_attn_bwd.cu computes the same function
// with mma.sync for the other head dims.
//
// Math, the TPU kernels' rounding points, per (b, h):
//   S = Q K^T (f32 from bf16 products); P = exp(S*scale - lse), computed as
//   2^(S*c - lse*log2 e) with c = scale*log2 e: one FFMA and one EX2 per score;
//   dP = dO V^T; delta = rowsum(f32(dO) * f32(O)); dS = bf16(P * (dP - delta));
//   dV = bf16(P)^T dO, dK = scale * dS^T Q, dQ = scale * dS K, each summed in
//   f32 and rounded to bf16 once.
//
// Three launches on the caller's stream:
// 1. pre-pass, one block per (64-row q tile, head, batch), four threads per
//    row: delta and lse*log2(e) into an f32 scratch of (2, B, H, Lp), Lp = L
//    rounded up to 64, with delta = 0 and lse = +inf past L (so P = 0 for
//    those q rows: they add nothing to dK and dV).
// 2. dK/dV kernel: a persistent grid of one CTA per SM walks the work items
//    (128-key tile, head, batch), key tiles fastest.
//    - Warpgroup 0 is the producer (24 registers; one thread issues): the
//      item's K and V once, into one of two buffers (a "full" and an "empty"
//      mbarrier each) so that the next item's load overlaps this one, then
//      every 64-row tile of Q and dO with its 64 lse and delta values (bulk
//      copies) through a ring of three stages that runs on across items.
//    - Warpgroups 1 and 2 are consumers of 64 keys each (240 registers). Per q
//      tile: S^T = K Q^T and dP^T = V dO^T (wgmma SS, both operands K-major
//      over Dh); P^T and dS^T in registers; dV += bf16(P^T) dO and dK +=
//      bf16(dS^T) Q (wgmma RS: the packed accumulator is the A fragment; dO and
//      Q read MN-major from their TMA tiles).
//    - dK and dV stay in f32 registers over all q tiles and are stored once,
//      through shared memory, 16 bytes per thread and whole rows per 8 or 10
//      threads (stores from registers, 4 bytes per thread and 16 bytes per
//      row, were markedly slower).
// 3. dQ kernel: a persistent grid walks (128-row q tile, head, batch) items,
//    q tiles fastest. A producer thread loads the item's Q and dO (the 64-row
//    boxes, one per consumer) and its 128 lse and delta values once, into one
//    of two item buffers, and K and V of every 128-key tile through a ring of
//    two stages that runs on across items. Each consumer warpgroup, for its 64
//    q rows, recomputes S = Q K^T and dP = dO V^T (m64n128 wgmma, both
//    operands K-major), P and dS = bf16(P (dP - delta)) in registers (P while
//    dP is in flight), and dQ += dS K (wgmma RS, K read MN-major), summed in
//    f32 registers over the key tiles in order; then dq = bf16(scale * dQ) at
//    the caller's strides.
//
// Determinism: dq, dk and dv depend only on the inputs, in eager calls and in
// CUDA-graph replays alike: every sum is taken in one CTA's registers in a
// fixed order (dK and dV over the q tiles, dQ over the key tiles), and nothing
// is added across CTAs. The design this replaces summed dQ's partial products
// of the key tiles with f32 bulk reduce-adds that arrived in any order (an
// element could differ by one bf16 step from one call to the next). That
// design with its adds put in key-tile order (a turn counter per q tile, one
// dQ writer thread per consumer; tools/flash_attn_bwd_ordered.cu at commit
// 4c62724, timed there by tools/profile_attn_bwd.py --designs) took
// 1.07-1.32x this one's device time on an H100, in turns at every shape
// timed (PERF.md): this one does seven
// tile products per tile pair where the TPU kernel has five, and the
// exponentials twice, but has no f32 accumulator to zero, add into and read
// back, and no CTA waits for another.
//
// Ragged L: TMA zero-fills rows past L. Keys past L get P = 0 explicitly (a
// zero K row gives S = 0, and exp(0 - lse) could overflow for very negative
// lse), and their dK and dV are not stored; q rows past L get P = 0 through
// lse = +inf in the dK/dV kernel and are never stored by the dQ kernel.
//
// Bound (the TPU kernel's work): 10*B*H*L^2*Dh FLOPs at 989 TFLOP/s against
// 16*B*H*L*Dh bytes + lse; at (32, 12, 589, 64) 85.3 GFLOP, 86 us: bound by
// operations. This design does 14*B*H*L^2*Dh FLOPs and two EX2 per score: at
// Dh = 64, 2*Dh*7 = 896 tensor-core operations per score at 4096 per clock
// per SM against two EX2 at 16 per clock, so the exponentials take more than
// half the products' time. One CTA fills an SM.
// The kernels allocate nothing.

#include <math.h>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int kBlockN = 128;  // keys per work item, 64 per consumer warpgroup
constexpr int kBlockM = 64;   // q rows per tile
constexpr int kStages = 3;    // Q/dO ring depth
constexpr int kThreads = 384;  // producer warpgroup + two consumer warpgroups
constexpr int kConsumerThreads = 256;
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr int kWideCols = 64;   // columns of the 128-byte-swizzled box
constexpr int kScratchWide = 64 * 128;  // a consumer's 64 epilogue rows, columns 0-63
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Tile {
  static_assert(D == 64 || D == 80, "head dims 64 and 80");
  static constexpr bool kNarrow = D == 80;
  static constexpr int kBoxes = kNarrow ? 2 : 1;
  static constexpr int kN = kNarrow ? 8 : 1;  // accumulators of an n16 product
  // K or V: 128 rows; Q or dO: 64 rows; 128 bytes per row in the wide box,
  // 32 in the narrow one. Every tile starts on a 1024-byte boundary.
  static constexpr int kKWide = kBlockN * 128;
  static constexpr int kKBytes = kKWide + (kNarrow ? kBlockN * 32 : 0);
  static constexpr int kQWide = kBlockM * 128;
  static constexpr int kQBytes = kQWide + (kNarrow ? kBlockM * 32 : 0);
  // A stage: Q, dO, then 64 lse and 64 delta values (1 KB kept for alignment).
  static constexpr int kStageBytes = 2 * kQBytes + 1024;
  static constexpr int kStageTx = 2 * kQBytes + 2 * kBlockM * 4;
  // Two K/V buffers (item n uses buffer n & 1), the ring, each consumer's
  // scratch for the epilogue (columns 64-79 after 0-63).
  static constexpr int kStageOff = 4 * kKBytes;
  static constexpr int kScratchOff = kStageOff + kStages * kStageBytes;
  static constexpr int kScratchBytes = kScratchWide + (kNarrow ? 64 * 32 : 0);
  static constexpr int kSmem = kScratchOff + 2 * kScratchBytes;
};

struct Maps {
  // [0]: columns 0-63, 128-byte swizzle; [1]: columns 64-79, 32-byte swizzle.
  CUtensorMap q[2], k[2], v[2], g[2];  // g: dO
};

struct Barriers {
  uint64_t kv_full[2], kv_empty[2];
  uint64_t q_full[kStages], q_empty[kStages];
};

struct Strides {
  long long dk[3], dv[3];  // element strides of (b, h, row)
};

// Work item w: (first key, head, batch), key tiles fastest.
struct Item {
  int k0, h, b;
};

__device__ __forceinline__ Item item_of(int w, int key_tiles, int H) {
  const int rest = w / key_tiles;
  return {(w % key_tiles) * kBlockN, rest % H, rest / H};
}

// acc (64 keys x 64 q) = A B^T over Dh: A = 64 rows of K or V, B = the Q or
// dO tile, both K-major; aw/bw the 128-byte-swizzled boxes, an/bn the
// 32-byte-swizzled ones (Dh = 80).
template <int D>
__device__ __forceinline__ void transposed_scores(float (&acc)[32], const uint8_t* aw,
                                                  const uint8_t* an, const uint8_t* bw,
                                                  const uint8_t* bn) {
  const uint64_t ad = make_desc(aw, 16, 1024, kSwizzle128);
  const uint64_t bd = make_desc(bw, 16, 1024, kSwizzle128);
#pragma unroll
  for (int kk = 0; kk < kWideCols / 16; ++kk) {
    wgmma_m64n64k16_ss<0, 0>(acc, desc_advance(ad, 32 * kk), desc_advance(bd, 32 * kk), kk > 0);
  }
  if constexpr (Tile<D>::kNarrow) {
    wgmma_m64n64k16_ss<0, 0>(acc, make_desc(an, 16, 256, kSwizzle32),
                             make_desc(bn, 16, 256, kSwizzle32), 1);
  }
}

// acc (64 keys x Dh) += F (64 keys x 64 q, bf16 A fragments in registers) B,
// B = the dO or Q tile read MN-major (4 k-steps of 16 q rows).
template <int D>
__device__ __forceinline__ void key_product(float (&acc)[32], float (&accn)[Tile<D>::kN],
                                            const uint32_t (&f)[16], const uint8_t* bw,
                                            const uint8_t* bn) {
  const uint64_t bd = make_desc(bw, Tile<D>::kQWide, 1024, kSwizzle128);
#pragma unroll
  for (int kk = 0; kk < kBlockM / 16; ++kk) {
    const uint32_t a[4] = {f[4 * kk], f[4 * kk + 1], f[4 * kk + 2], f[4 * kk + 3]};
    wgmma_m64n64k16_rs<1>(acc, a, desc_advance(bd, 16 * 128 * kk));
    if constexpr (Tile<D>::kNarrow) {
      const uint64_t nd = make_desc(bn, kBlockM * 32, 256, kSwizzle32);
      wgmma_m64n16k16_rs<1>(accn, a, desc_advance(nd, 16 * 32 * kk));
    }
  }
}

// A consumer's 64 x Dh accumulator, times `s`, as bf16 rows [k0, k0 + 64) at
// `base` + row * sl (rows at or past L are not stored), through the
// consumer's scratch `buf` in shared memory, so that each global store is 16
// bytes and 8 (Dh = 64) or 10 threads write a whole row: 128-byte rows of
// columns 0-63 with 16-byte chunk j at j ^ (row % 8), then 32-byte rows of
// columns 64-79 with chunk j at j ^ ((row / 4) % 2). All 128 threads of the
// consumer call it; `buf` is free again when it returns.
template <int D>
__device__ __forceinline__ void store_tile(__nv_bfloat16* base, long long sl,
                                           const float (&acc)[32],
                                           const float (&accn)[Tile<D>::kN], uint8_t* buf,
                                           int k0, int L, int c, int t, float s) {
  const int g = (t % 32) / 4, tq = t % 4;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = (t / 32) * 16 + g + 8 * half;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      *reinterpret_cast<uint32_t*>(buf + r * 128 + ((jj ^ (r & 7)) << 4) + 4 * tq) =
          pack_bf16(acc[4 * jj + 2 * half] * s, acc[4 * jj + 2 * half + 1] * s);
    }
    if constexpr (Tile<D>::kNarrow) {
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        *reinterpret_cast<uint32_t*>(buf + kScratchWide + r * 32 + ((jj ^ ((r >> 2) & 1)) << 4) +
                                     4 * tq) =
            pack_bf16(accn[4 * jj + 2 * half] * s, accn[4 * jj + 2 * half + 1] * s);
      }
    }
  }
  bar_sync(1 + c, 128);
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  for (int i = t; i < 64 * kChunks; i += 128) {
    const int r = i / kChunks, ch = i % kChunks, row = k0 + r;
    if (row >= L) continue;
    const uint8_t* src = ch < 8 ? buf + r * 128 + ((ch ^ (r & 7)) << 4)
                                : buf + kScratchWide + r * 32 + (((ch - 8) ^ ((r >> 2) & 1)) << 4);
    *reinterpret_cast<uint4*>(base + row * sl + 8 * ch) = *reinterpret_cast<const uint4*>(src);
  }
  bar_sync(1 + c, 128);
}

// Pre-pass: per (q tile, head, batch), four threads per row.
constexpr int kPrepassThreads = 4 * kBlockM;

__global__ void __launch_bounds__(kPrepassThreads)
flash_attn_bwd_sm90_prepass_kernel(const __nv_bfloat16* __restrict__ o,
                                   const __nv_bfloat16* __restrict__ dout,
                                   const float* __restrict__ lse, float* __restrict__ stats,
                                   int H, int L, int D,
                                   long long osb, long long osh, long long osl, long long gsb,
                                   long long gsh, long long gsl) {
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int Lp = gridDim.x * kBlockM;
  const int part = threadIdx.x % 4;
  const int r = qt * kBlockM + threadIdx.x / 4;
  const long long bh = (long long)b * H + h;
  float delta = 0.f;
  if (r < L) {
    const __nv_bfloat16* op = o + b * osb + h * osh + r * osl;
    const __nv_bfloat16* gp = dout + b * gsb + h * gsh + r * gsl;
    for (int c = 8 * part; c < D; c += 32) {
      const uint4 ov = *reinterpret_cast<const uint4*>(op + c);
      const uint4 gv = *reinterpret_cast<const uint4*>(gp + c);
      const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
      const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 of = __bfloat1622float2(o2[e]);
        const float2 gf = __bfloat1622float2(g2[e]);
        delta = fmaf(gf.x, of.x, delta);
        delta = fmaf(gf.y, of.y, delta);
      }
    }
  }
  delta += __shfl_xor_sync(0xffffffffu, delta, 1);
  delta += __shfl_xor_sync(0xffffffffu, delta, 2);
  if (part == 0) {
    stats[bh * Lp + r] = r < L ? lse[bh * L + r] * kLog2e : INFINITY;
    stats[(long long)gridDim.y * gridDim.z * Lp + bh * Lp + r] = delta;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_attn_bwd_sm90_kernel(const __grid_constant__ Maps maps, const float* __restrict__ stats,
                           __nv_bfloat16* __restrict__ dk,
                           __nv_bfloat16* __restrict__ dv, int B, int H, int L, float scale,
                           Strides st) {
  using T = Tile<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  auto k_buf = [&](int n) { return smem + (n & 1) * 2 * T::kKBytes; };  // V follows K
  auto stage = [&](int s) { return smem + T::kStageOff + s * T::kStageBytes; };
  Barriers* bars = reinterpret_cast<Barriers*>(smem + T::kSmem);

  const int key_tiles = (L + kBlockN - 1) / kBlockN;
  const int q_tiles = (L + kBlockM - 1) / kBlockM;
  const int Lp = q_tiles * kBlockM;
  const int work = key_tiles * H * B;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&bars->kv_full[i], 1);
      mbar_init(&bars->kv_empty[i], kConsumerThreads);
    }
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&bars->q_full[s], 1);
      mbar_init(&bars->q_empty[s], kConsumerThreads);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread keeps K, V and the Q/dO ring full; item
    // n + 1's K and V load into the other buffer while item n runs ---------
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      int it = 0, n = 0;
      for (int w = blockIdx.x; w < work; w += gridDim.x, ++n) {
        const Item item = item_of(w, key_tiles, H);
        uint8_t* k_s = k_buf(n);
        uint8_t* v_s = k_s + T::kKBytes;
        uint64_t* kv_full = &bars->kv_full[n & 1];
        mbar_wait(&bars->kv_empty[n & 1], ((n >> 1) & 1) ^ 1);
        mbar_arrive_expect_tx(kv_full, 2 * T::kKBytes);
        tma_load_4d(k_s, &maps.k[0], kv_full, 0, item.k0, item.h, item.b);
        tma_load_4d(v_s, &maps.v[0], kv_full, 0, item.k0, item.h, item.b);
        if constexpr (T::kNarrow) {
          tma_load_4d(k_s + T::kKWide, &maps.k[1], kv_full, kWideCols, item.k0, item.h, item.b);
          tma_load_4d(v_s + T::kKWide, &maps.v[1], kv_full, kWideCols, item.k0, item.h, item.b);
        }
        const float* lse2 = stats + ((long long)item.b * H + item.h) * Lp;
        const float* delta = lse2 + (long long)B * H * Lp;
        for (int t = 0; t < q_tiles; ++t, ++it) {
          const int s = it % kStages;
          uint8_t* qs = stage(s);
          uint8_t* gs = qs + T::kQBytes;
          uint64_t* full = &bars->q_full[s];
          mbar_wait(&bars->q_empty[s], ((it / kStages) & 1) ^ 1);
          mbar_arrive_expect_tx(full, T::kStageTx);
          const int q0 = t * kBlockM;
          tma_load_4d(qs, &maps.q[0], full, 0, q0, item.h, item.b);
          tma_load_4d(gs, &maps.g[0], full, 0, q0, item.h, item.b);
          if constexpr (T::kNarrow) {
            tma_load_4d(qs + T::kQWide, &maps.q[1], full, kWideCols, q0, item.h, item.b);
            tma_load_4d(gs + T::kQWide, &maps.g[1], full, kWideCols, q0, item.h, item.b);
          }
          bulk_load(gs + T::kQBytes, lse2 + q0, kBlockM * 4, full);
          bulk_load(gs + T::kQBytes + kBlockM * 4, delta + q0, kBlockM * 4, full);
        }
      }
    }
  } else {
    // ---- consumers: 64 keys each -----------------------------------------
    setmaxnreg_inc<kConsumerRegs>();
    const int c = wg - 1;
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int g = lane / 4, tq = lane % 4;  // accumulator row group, column pair
    const float sc = scale * kLog2e;
    // This consumer's scratch for the epilogue.
    uint8_t* sb = smem + T::kScratchOff + c * T::kScratchBytes;

    float sacc[32], pacc[32], dkacc[32], dvacc[32];
    float dkn[T::kN], dvn[T::kN];
    uint32_t pa[16], da[16];

    int it = 0, n = 0;
    for (int w = blockIdx.x; w < work; w += gridDim.x, ++n) {
      const Item item = item_of(w, key_tiles, H);
#pragma unroll
      for (int i = 0; i < 32; ++i) dkacc[i] = dvacc[i] = 0.f;
#pragma unroll
      for (int i = 0; i < T::kN; ++i) dkn[i] = dvn[i] = 0.f;
      const int r0 = c * 64 + warp * 16 + g;  // this thread's key rows r0, r0 + 8 of the item
      const bool key_ok0 = item.k0 + r0 < L, key_ok1 = item.k0 + r0 + 8 < L;
      // This consumer's 64 rows of the item's K and V.
      const uint8_t* k_s = k_buf(n);
      const uint8_t* kc = k_s + c * 64 * 128;
      const uint8_t* kcn = k_s + T::kKWide + c * 64 * 32;
      const uint8_t* vc = kc + T::kKBytes;
      const uint8_t* vcn = kcn + T::kKBytes;
      mbar_wait(&bars->kv_full[n & 1], (n >> 1) & 1);

      for (int qt = 0; qt < q_tiles; ++qt, ++it) {
        const int s = it % kStages;
        const uint8_t* qs = stage(s);
        const uint8_t* gs = qs + T::kQBytes;
        const float* lse_s = reinterpret_cast<const float*>(gs + T::kQBytes);
        const float* delta_s = lse_s + kBlockM;
        mbar_wait(&bars->q_full[s], (it / kStages) & 1);

        // S^T and dP^T, f32, as two wgmma groups: P^T is computed while dP^T
        // is still in flight, and dV's product runs while dS^T is computed.
        wgmma_fence();
        transposed_scores<D>(sacc, kc, kcn, qs, qs + T::kQWide);
        wgmma_commit();
        transposed_scores<D>(pacc, vc, vcn, gs, gs + T::kQWide);
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(sacc);

        // P^T = 2^(S^T c - lse log2 e): columns are q rows (lse = +inf past
        // L), rows are keys (masked past L on the item's last key tile).
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const float2 l2 = *reinterpret_cast<const float2*>(lse_s + 8 * jj + 2 * tq);
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const bool ok = half ? key_ok1 : key_ok0;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int i = 4 * jj + 2 * half + e;
              sacc[i] = ok ? exp2_approx(fmaf(sacc[i], sc, -(e ? l2.y : l2.x))) : 0.f;
            }
          }
        }
#pragma unroll
        for (int i = 0; i < 16; ++i) pa[i] = pack_bf16(sacc[2 * i], sacc[2 * i + 1]);

        // dV += P^T dO.
        fence_regs(dvacc);
        wgmma_fence();
        key_product<D>(dvacc, dvn, pa, gs, gs + T::kQWide);
        wgmma_commit();
        wgmma_wait<1>();  // dP^T is in; dV's product may still run
        fence_regs(pacc);

        // dS^T = P^T (dP^T - delta).
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const float2 d2 = *reinterpret_cast<const float2*>(delta_s + 8 * jj + 2 * tq);
#pragma unroll
          for (int i = 4 * jj; i < 4 * jj + 4; ++i) {
            pacc[i] = sacc[i] * (pacc[i] - ((i & 1) ? d2.y : d2.x));
          }
        }
#pragma unroll
        for (int i = 0; i < 16; ++i) da[i] = pack_bf16(pacc[2 * i], pacc[2 * i + 1]);

        // dK += dS^T Q.
        fence_regs(dkacc);
        wgmma_fence();
        key_product<D>(dkacc, dkn, da, qs, qs + T::kQWide);
        wgmma_commit();

        wgmma_wait<0>();
        fence_regs(dkacc);
        fence_regs(dvacc);
        fence_regs(dkn);
        fence_regs(dvn);
        mbar_arrive(&bars->q_empty[s]);
      }
      mbar_arrive(&bars->kv_empty[n & 1]);  // K and V read for the last time

      // ---- epilogue: dK * scale and dV, rounded once, through the scratch ----
      const int k0 = item.k0 + c * 64;
      store_tile<D>(dk + item.b * st.dk[0] + item.h * st.dk[1], st.dk[2], dkacc, dkn, sb, k0, L,
                    c, t, scale);
      store_tile<D>(dv + item.b * st.dv[0] + item.h * st.dv[1], st.dv[2], dvacc, dvn, sb, k0, L,
                    c, t, 1.f);
    }
  }
}

// ---- the dQ kernel ---------------------------------------------------------

constexpr int kDqRows = 2 * kBlockM;  // q rows per item, 64 per consumer
constexpr int kDqStages = 2;          // K/V ring depth

template <int D>
struct DqTile {
  using T = Tile<D>;
  // An item buffer: each consumer's Q tile, then each one's dO tile (the
  // backward's 64-row boxes), two buffers; then each buffer's 128 lse and 128
  // delta values; then the ring of K and V tiles. Every tile starts on a
  // 1024-byte boundary.
  static constexpr int kItemBytes = 4 * T::kQBytes;
  static constexpr int kStatsOff = 2 * kItemBytes;
  static constexpr int kRingOff = kStatsOff + 2 * 2 * kDqRows * 4;
  static constexpr int kSmem = kRingOff + kDqStages * 2 * T::kKBytes;
};

struct DqBarriers {
  uint64_t item_full[2], item_empty[2];
  uint64_t kv_full[kDqStages], kv_empty[kDqStages];
};

// acc (64 q x 128 keys) = A B^T over Dh: A = a consumer's Q or dO tile, B = a
// K or V tile, both K-major; aw/bw the 128-byte-swizzled boxes, an/bn the
// 32-byte-swizzled ones (Dh = 80).
template <int D>
__device__ __forceinline__ void row_scores(float (&acc)[64], const uint8_t* aw, const uint8_t* an,
                                           const uint8_t* bw, const uint8_t* bn) {
  const uint64_t ad = make_desc(aw, 16, 1024, kSwizzle128);
  const uint64_t bd = make_desc(bw, 16, 1024, kSwizzle128);
#pragma unroll
  for (int kk = 0; kk < kWideCols / 16; ++kk) {
    wgmma_m64n128k16_ss<0>(acc, desc_advance(ad, 32 * kk), desc_advance(bd, 32 * kk), kk > 0);
  }
  if constexpr (Tile<D>::kNarrow) {
    wgmma_m64n128k16_ss<0>(acc, make_desc(an, 16, 256, kSwizzle32),
                           make_desc(bn, 16, 256, kSwizzle32), 1);
  }
}

// dq (64 q x Dh) += F (64 q x 128 keys, bf16 A fragments in registers) K, K
// read MN-major from its tile (8 k-steps of 16 keys).
template <int D>
__device__ __forceinline__ void dq_keys_product(float (&dq)[32], float (&dqn)[Tile<D>::kN],
                                                const uint32_t (&f)[32], const uint8_t* kw,
                                                const uint8_t* kn) {
  const uint64_t kd = make_desc(kw, Tile<D>::kKWide, 1024, kSwizzle128);
#pragma unroll
  for (int kk = 0; kk < kBlockN / 16; ++kk) {
    const uint32_t a[4] = {f[4 * kk], f[4 * kk + 1], f[4 * kk + 2], f[4 * kk + 3]};
    wgmma_m64n64k16_rs<1>(dq, a, desc_advance(kd, 16 * 128 * kk));
    if constexpr (Tile<D>::kNarrow) {
      const uint64_t nd = make_desc(kn, kBlockN * 32, 256, kSwizzle32);
      wgmma_m64n16k16_rs<1>(dqn, a, desc_advance(nd, 16 * 32 * kk));
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_attn_bwd_sm90_dq_kernel(const __grid_constant__ Maps maps, const float* __restrict__ stats,
                         __nv_bfloat16* __restrict__ dq, int B, int H, int L, float scale,
                         long long sb, long long sh, long long sl) {
  using T = Tile<D>;
  using X = DqTile<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  auto item_buf = [&](int n) { return smem + (n & 1) * X::kItemBytes; };
  auto item_stats = [&](int n) {
    return reinterpret_cast<float*>(smem + X::kStatsOff + (n & 1) * 2 * kDqRows * 4);
  };
  auto kv_tile = [&](int s) { return smem + X::kRingOff + s * 2 * T::kKBytes; };  // V follows K
  DqBarriers* bars = reinterpret_cast<DqBarriers*>(smem + X::kSmem);

  const int key_tiles = (L + kBlockN - 1) / kBlockN;
  const int q_items = (L + kDqRows - 1) / kDqRows;
  const int Lp = (L + kBlockM - 1) / kBlockM * kBlockM;
  const int work = q_items * H * B;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&bars->item_full[i], 1);
      mbar_init(&bars->item_empty[i], kConsumerThreads);
    }
#pragma unroll
    for (int s = 0; s < kDqStages; ++s) {
      mbar_init(&bars->kv_full[s], 1);
      mbar_init(&bars->kv_empty[s], kConsumerThreads);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread; the item's Q, dO, lse and delta once, K and
    // V of every key tile through the ring, which runs on across items ------
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      int it = 0, n = 0;
      for (int w = blockIdx.x; w < work; w += gridDim.x, ++n) {
        const int q0 = (w % q_items) * kDqRows, rest = w / q_items, h = rest % H, b = rest / H;
        uint8_t* ib = item_buf(n);
        float* is = item_stats(n);
        uint64_t* full = &bars->item_full[n & 1];
        // The stats rows stop at Lp: consumer 1's are loaded only where they exist.
        const int halves = q0 + kBlockM < Lp ? 2 : 1;
        mbar_wait(&bars->item_empty[n & 1], ((n >> 1) & 1) ^ 1);
        mbar_arrive_expect_tx(full, 4 * T::kQBytes + halves * 2 * kBlockM * 4);
        for (int c = 0; c < 2; ++c) {
          uint8_t* qs = ib + c * T::kQBytes;
          uint8_t* gs = ib + (2 + c) * T::kQBytes;
          const int r = q0 + c * kBlockM;
          tma_load_4d(qs, &maps.q[0], full, 0, r, h, b);
          tma_load_4d(gs, &maps.g[0], full, 0, r, h, b);
          if constexpr (T::kNarrow) {
            tma_load_4d(qs + T::kQWide, &maps.q[1], full, kWideCols, r, h, b);
            tma_load_4d(gs + T::kQWide, &maps.g[1], full, kWideCols, r, h, b);
          }
        }
        const float* lse2 = stats + ((long long)b * H + h) * Lp + q0;
        const float* delta = lse2 + (long long)B * H * Lp;
        bulk_load(is, lse2, halves * kBlockM * 4, full);
        bulk_load(is + kDqRows, delta, halves * kBlockM * 4, full);
        for (int j = 0; j < key_tiles; ++j, ++it) {
          const int s = it % kDqStages;
          uint8_t* ks = kv_tile(s);
          uint8_t* vs = ks + T::kKBytes;
          uint64_t* kf = &bars->kv_full[s];
          mbar_wait(&bars->kv_empty[s], ((it / kDqStages) & 1) ^ 1);
          mbar_arrive_expect_tx(kf, 2 * T::kKBytes);
          tma_load_4d(ks, &maps.k[0], kf, 0, j * kBlockN, h, b);
          tma_load_4d(vs, &maps.v[0], kf, 0, j * kBlockN, h, b);
          if constexpr (T::kNarrow) {
            tma_load_4d(ks + T::kKWide, &maps.k[1], kf, kWideCols, j * kBlockN, h, b);
            tma_load_4d(vs + T::kKWide, &maps.v[1], kf, kWideCols, j * kBlockN, h, b);
          }
        }
      }
    }
  } else {
    // ---- consumers: 64 q rows each ----------------------------------------
    setmaxnreg_inc<kConsumerRegs>();
    const int c = wg - 1;
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int g = lane / 4, tq = lane % 4;  // accumulator row group, column pair
    const float sc = scale * kLog2e;
    float sacc[64], pacc[64], dqacc[32], dqn[T::kN];
    uint32_t da[32];

    int it = 0, n = 0;
    for (int w = blockIdx.x; w < work; w += gridDim.x, ++n) {
      const int q0 = (w % q_items) * kDqRows, rest = w / q_items, h = rest % H, b = rest / H;
#pragma unroll
      for (int i = 0; i < 32; ++i) dqacc[i] = 0.f;
#pragma unroll
      for (int i = 0; i < T::kN; ++i) dqn[i] = 0.f;
      const uint8_t* qs = item_buf(n) + c * T::kQBytes;
      const uint8_t* gs = item_buf(n) + (2 + c) * T::kQBytes;
      const float* is = item_stats(n);
      mbar_wait(&bars->item_full[n & 1], (n >> 1) & 1);
      // This thread's rows rr and rr + 8 of the item (past Lp: never stored).
      const int rr = c * kBlockM + warp * 16 + g;
      const float l0 = is[rr], l1 = is[rr + 8];
      const float d0 = is[kDqRows + rr], d1 = is[kDqRows + rr + 8];

      for (int j = 0; j < key_tiles; ++j, ++it) {
        const int s = it % kDqStages;
        const uint8_t* ks = kv_tile(s);
        const uint8_t* vs = ks + T::kKBytes;
        mbar_wait(&bars->kv_full[s], (it / kDqStages) & 1);
        // S and dP, f32, as two wgmma groups: P is computed while dP is in
        // flight.
        wgmma_fence();
        row_scores<D>(sacc, qs, qs + T::kQWide, ks, ks + T::kKWide);
        wgmma_commit();
        row_scores<D>(pacc, gs, gs + T::kQWide, vs, vs + T::kKWide);
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(sacc);
        // P = 2^(S c - lse log2 e): rows are q rows, columns keys (masked
        // past L on the last key tile).
        const int n0 = j * kBlockN;
#pragma unroll
        for (int jj = 0; jj < kBlockN / 8; ++jj) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const bool ok = n0 + 8 * jj + 2 * tq + e < L;
            sacc[4 * jj + e] = ok ? exp2_approx(fmaf(sacc[4 * jj + e], sc, -l0)) : 0.f;
            sacc[4 * jj + 2 + e] = ok ? exp2_approx(fmaf(sacc[4 * jj + 2 + e], sc, -l1)) : 0.f;
          }
        }
        wgmma_wait<0>();
        fence_regs(pacc);
        // dS = P (dP - delta), rounded to bf16 as the A fragments of dQ += dS K.
#pragma unroll
        for (int jj = 0; jj < kBlockN / 8; ++jj) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            pacc[4 * jj + e] = sacc[4 * jj + e] * (pacc[4 * jj + e] - d0);
            pacc[4 * jj + 2 + e] = sacc[4 * jj + 2 + e] * (pacc[4 * jj + 2 + e] - d1);
          }
        }
#pragma unroll
        for (int i = 0; i < 32; ++i) da[i] = pack_bf16(pacc[2 * i], pacc[2 * i + 1]);
        fence_regs(dqacc);
        fence_regs(dqn);
        wgmma_fence();
        dq_keys_product<D>(dqacc, dqn, da, ks, ks + T::kKWide);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dqacc);
        fence_regs(dqn);
        mbar_arrive(&bars->kv_empty[s]);
      }
      mbar_arrive(&bars->item_empty[n & 1]);

      // ---- epilogue: dq = bf16(scale * dQ) for rows below L ---------------
      __nv_bfloat16* base = dq + b * sb + h * sh;
      const int r0 = q0 + rr;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = r0 + 8 * half;
        if (r >= L) continue;
        __nv_bfloat16* row = base + r * sl + 2 * tq;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          *reinterpret_cast<uint32_t*>(row + 8 * jj) = pack_bf16(
              dqacc[4 * jj + 2 * half] * scale, dqacc[4 * jj + 2 * half + 1] * scale);
        }
        if constexpr (T::kNarrow) {
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            *reinterpret_cast<uint32_t*>(row + kWideCols + 8 * jj) = pack_bf16(
                dqn[4 * jj + 2 * half] * scale, dqn[4 * jj + 2 * half + 1] * scale);
          }
        }
      }
    }
  }
}

// ---- host side -----------------------------------------------------------

template <int D>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
           const void* lse, void* dq, void* dk, void* dv, void* stats, int B, int H, int L,
           const long long* desc, const long long* strides, cudaStream_t stream) {
  using T = Tile<D>;
  Maps maps;
  const void* bases[4] = {q, k, v, dout};
  CUtensorMap* dst[4] = {maps.q, maps.k, maps.v, maps.g};
  const int rows[4] = {kBlockM, kBlockN, kBlockN, kBlockM};
  for (int i = 0; i < 4; ++i) {
    const long long* f = desc + i * kMapFields;
    if (!boxes_match(D, f) || f[1] != L || f[2] != H || f[3] != B) return kErrDescription;
    for (int box = 0; box < T::kBoxes; ++box) {
      const int err = encode(&dst[i][box], bases[i], f, box, rows[i]);
      if (err != 0) return err;
    }
  }
  constexpr int smem = T::kSmem + (int)sizeof(Barriers) + 1024;  // + alignment slack
  constexpr int dq_smem = DqTile<D>::kSmem + (int)sizeof(DqBarriers) + 1024;
  // Per device, once: the raised shared-memory limit and the SM count.
  constexpr int kMaxDevices = 64;
  static int sm_count[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (sm_count[dev] == 0) {
    err = cudaFuncSetAttribute(flash_attn_bwd_sm90_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(flash_attn_bwd_sm90_dq_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, dq_smem);
    if (err != cudaSuccess) return err;
    int sms = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    sm_count[dev] = sms;
  }
  const int q_tiles = (L + kBlockM - 1) / kBlockM;
  const int key_tiles = (L + kBlockN - 1) / kBlockN;
  const long long work = (long long)key_tiles * H * B;
  if (work >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const float scale = (float)(1.0 / sqrt((double)D));
  const long long* so = strides;  // o, dout, dq, dk, dv: (b, h, row) each

  flash_attn_bwd_sm90_prepass_kernel<<<dim3(q_tiles, H, B), kPrepassThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(o), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<float*>(stats), H, L, D, so[0], so[1], so[2],
      so[3], so[4], so[5]);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.dk[i] = so[9 + i];
    st.dv[i] = so[12 + i];
  }
  const int grid = (int)(work < sm_count[dev] ? work : sm_count[dev]);
  flash_attn_bwd_sm90_kernel<D><<<grid, kThreads, smem, stream>>>(
      maps, static_cast<const float*>(stats), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), B, H, L, scale, st);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const long long dq_work = (long long)((L + kDqRows - 1) / kDqRows) * H * B;
  const int dq_grid = (int)(dq_work < sm_count[dev] ? dq_work : sm_count[dev]);
  flash_attn_bwd_sm90_dq_kernel<D><<<dq_grid, kThreads, dq_smem, stream>>>(
      maps, static_cast<const float*>(stats), static_cast<__nv_bfloat16*>(dq), B, H, L, scale,
      so[6], so[7], so[8]);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v, dout: (B, H, L, D) bf16 read through tensor maps built from `desc`
// (14 int64 fields each, in that order; see ops/attention.py:tma_description).
// o, dout, dq, dk, dv: element strides of (b, h, row) in `strides`, in that
// order (15 values), last dim contiguous, rows 16-byte aligned. lse: (B, H, L)
// f32 contiguous, from the forward. stats: (2, B, H, Lp) f32 scratch, Lp = L
// rounded up to 64. Returns 0, a CUDA error code, or a negative code (see
// flash_attn_bwd_sm90_error_string); D outside {64, 80} returns
// cudaErrorInvalidValue without launching.
int flash_attn_bwd_sm90_bf16(const void* q, const void* k, const void* v, const void* o,
                             const void* dout, const void* lse, void* dq, void* dk, void* dv,
                             void* stats, int B, int H, int L, int D, const long long* desc,
                             const long long* strides, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch<64>(q, k, v, o, dout, lse, dq, dk, dv, stats, B, H, L, desc, strides, s);
    case 80:
      return launch<80>(q, k, v, o, dout, lse, dq, dk, dv, stats, B, H, L, desc, strides, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* flash_attn_bwd_sm90_error_string(int err) { return sm90::error_string(err); }

}  // extern "C"
