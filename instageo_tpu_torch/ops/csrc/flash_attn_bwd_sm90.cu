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
//    those q rows: they add nothing to dK and dV); zeroes the tile's block of
//    the f32 dQ accumulator.
// 2. main: a persistent grid of one CTA per SM walks the work items (128-key
//    tile, head, batch), key tiles fastest, so that the CTAs running at one
//    time add into the same head's dQ, which stays in L2.
//    - Warpgroup 0 is the producer (24 registers; one thread issues): the
//      item's K and V once, into one of two buffers (a "full" and an "empty"
//      mbarrier each) so that the next item's load overlaps this one, then
//      every 64-row tile of Q and dO with its 64 lse and delta values (bulk
//      copies) through a ring of three stages that runs on across items.
//    - Warpgroups 1 and 2 are consumers of 64 keys each (240 registers). Per q
//      tile: S^T = K Q^T and dP^T = V dO^T (wgmma SS, both operands K-major
//      over Dh); P^T and dS^T in registers; dV += bf16(P^T) dO and dK +=
//      bf16(dS^T) Q (wgmma RS: the packed accumulator is the A fragment; dO and
//      Q read MN-major from their TMA tiles). bf16(dS^T) also goes to the
//      consumer's own shared-memory buffer, in the layout a 128-byte-swizzled
//      TMA tile of 64 keys x 64 q would have; after a named barrier across its
//      four warps, the consumer computes its part of the dQ tile, dS K over its
//      64 keys at full Dh, with A = dS read transposed (MN-major) from that
//      buffer and B = its rows of K read MN-major. Five tile products per
//      (q tile, key tile), as on the TPU. The consumers never wait for each
//      other: sharing dS across both, each on half of Dh, would halve the
//      reduce-adds but make them meet in the middle of every tile, and
//      summing their parts in shared memory before one reduce-add makes one
//      wait for the other at the end of it; both were slower at
//      (32, 12, 589, 64) on an H100 (tools/profile_attn_bwd.py's "lockstep"
//      variant times such a wait).
//    - Each warp adds its part of the f32 dQ tile into the accumulator with
//      one bulk reduce-add (cp.reduce.async.bulk .add.f32) from shared memory.
//      The accumulator is laid out in wgmma's fragment order, so each warp's
//      part is one contiguous run and its staging store is 16 bytes per
//      thread, bank-conflict free.
//    - dK and dV stay in f32 registers over all q tiles and are stored once,
//      through shared memory, 16 bytes per thread and whole rows per 8 or 10
//      threads (stores from registers, 4 bytes per thread and 16 bytes per
//      row, were markedly slower).
// 3. post-pass, one block per (q tile, head, batch): dq = bf16(scale *
//    dQ_acc), from fragment order through shared memory to the caller's
//    strides.
//
// Determinism: the reduce-adds into dQ_acc arrive in an order that changes
// from run to run, so an element of dq may differ by one bf16 step between two
// runs (the f32 sums round differently before the one cast). dk and dv are
// deterministic.
//
// Ragged L: TMA zero-fills rows past L. Keys past L get P = 0 explicitly (a
// zero K row gives S = 0, and exp(0 - lse) could overflow for very negative
// lse), and their dK and dV are not stored; q rows past L get P = 0 through
// lse = +inf and are never stored.
//
// Bound (the TPU kernel's work): 10*B*H*L^2*Dh FLOPs at 989 TFLOP/s against
// 16*B*H*L*Dh bytes + lse; at (32, 12, 589, 64) 85.3 GFLOP, 86 us: bound by
// operations. At Dh = 64 the exponentials are as costly as the products (one
// EX2 per score, 16 per clock per SM, against 2*Dh*5 = 640 tensor-core
// operations per score pair at 4096 per clock). The reduce-adds into dQ are
// real traffic: 2 * (L/128) * L * Dh * 4 bytes per head, 580 MB at
// (32, 12, 589, 64), to L2. One CTA fills an SM.
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
constexpr int kDSBytes = 64 * kBlockM * 2;  // a consumer's bf16 dS^T (64 keys x 64 q)
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
  // f32 values of a consumer's dQ tile (64 x Dh) per thread, and its staging.
  static constexpr int kDQRegs = D / 2;
  static constexpr int kStagingBytes = kDQRegs * 128 * 4;
  // Two K/V buffers (item n uses buffer n & 1), the ring, each consumer's
  // dS^T buffer and dQ staging.
  static constexpr int kStageOff = 4 * kKBytes;
  static constexpr int kDSOff = kStageOff + kStages * kStageBytes;
  // A consumer's dS^T buffer, with room for the epilogue's columns 64-79.
  static constexpr int kScratchBytes = kDSBytes + (kNarrow ? 64 * 32 : 0);
  static constexpr int kStagingOff = kDSOff + 2 * kScratchBytes;
  static constexpr int kSmem = kStagingOff + 2 * kStagingBytes;
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

// A consumer's part of the dQ tile (64 q x Dh) = dS K over its 64 keys:
// A = dS, read MN-major from its dS^T buffer (64 keys x 64 q, 128-byte
// swizzle); B = its 64 rows of K read MN-major (kw: the 128-byte-swizzled
// box, kn: the 32-byte-swizzled one at Dh = 80).
template <int D>
__device__ __forceinline__ void dq_product(float (&dq)[32], float (&dqn)[Tile<D>::kN],
                                           const uint8_t* ds, const uint8_t* kw,
                                           const uint8_t* kn) {
  const uint64_t ad = make_desc(ds, kDSBytes, 1024, kSwizzle128);
  const uint64_t bd = make_desc(kw, Tile<D>::kKWide, 1024, kSwizzle128);
#pragma unroll
  for (int kk = 0; kk < 64 / 16; ++kk) {
    wgmma_m64n64k16_ss<1, 1>(dq, desc_advance(ad, 16 * 128 * kk),
                             desc_advance(bd, 16 * 128 * kk), kk > 0);
    if constexpr (Tile<D>::kNarrow) {
      const uint64_t nd = make_desc(kn, kBlockN * 32, 256, kSwizzle32);
      wgmma_m64n16k16_ss<1, 1>(dqn, desc_advance(ad, 16 * 128 * kk),
                               desc_advance(nd, 16 * 32 * kk), kk > 0);
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
        *reinterpret_cast<uint32_t*>(buf + kDSBytes + r * 32 + ((jj ^ ((r >> 2) & 1)) << 4) +
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
                                : buf + kDSBytes + r * 32 + (((ch - 8) ^ ((r >> 2) & 1)) << 4);
    *reinterpret_cast<uint4*>(base + row * sl + 8 * ch) = *reinterpret_cast<const uint4*>(src);
  }
  bar_sync(1 + c, 128);
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Pre-pass: per (q tile, head, batch), four threads per row.
constexpr int kPrepassThreads = 4 * kBlockM;

__global__ void __launch_bounds__(kPrepassThreads)
flash_attn_bwd_sm90_prepass_kernel(const __nv_bfloat16* __restrict__ o,
                                   const __nv_bfloat16* __restrict__ dout,
                                   const float* __restrict__ lse, float* __restrict__ stats,
                                   float* __restrict__ dq_acc, int H, int L, int D,
                                   long long osb, long long osh, long long osl, long long gsb,
                                   long long gsh, long long gsl) {
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int q_tiles = gridDim.x, Lp = q_tiles * kBlockM;
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
  float4* z = reinterpret_cast<float4*>(dq_acc + (bh * q_tiles + qt) * kBlockM * D);
  for (int i = threadIdx.x; i < kBlockM * D / 4; i += kPrepassThreads) {
    z[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_attn_bwd_sm90_kernel(const __grid_constant__ Maps maps, const float* __restrict__ stats,
                           float* __restrict__ dq_acc, __nv_bfloat16* __restrict__ dk,
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
    // This consumer's dS^T buffer and its warp's staging run of the dQ tile.
    uint8_t* ds = smem + T::kDSOff + c * T::kScratchBytes;
    float* staging = reinterpret_cast<float*>(smem + T::kStagingOff + c * T::kStagingBytes) +
                     warp * 32 * T::kDQRegs;

    float sacc[32], pacc[32], dkacc[32], dvacc[32], dqacc[32];
    float dkn[T::kN], dvn[T::kN], dqn[T::kN];
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
      float* dq_item = dq_acc + ((long long)item.b * H + item.h) * q_tiles * kBlockM * D +
                       warp * 32 * T::kDQRegs;
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

        // bf16(dS^T) into this consumer's buffer as a 128-byte-swizzled tile:
        // row = key, 16-byte chunk jj of the row at chunk jj ^ (row % 8). The
        // previous tile's dQ product, its last reader, has completed.
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int r = warp * 16 + g + 8 * half;
            *reinterpret_cast<uint32_t*>(ds + r * 128 + ((jj ^ (r & 7)) << 4) + 4 * tq) =
                da[2 * jj + half];
          }
        }
        fence_proxy_async_shared();

        // dK += dS^T Q.
        fence_regs(dkacc);
        wgmma_fence();
        key_product<D>(dkacc, dkn, da, qs, qs + T::kQWide);
        wgmma_commit();

        // This consumer's dS^T is in shared memory (its four warps meet on
        // named barrier 1 + c): its part of the dQ tile over its 64 keys.
        bar_sync(1 + c, 128);
        wgmma_fence();
        dq_product<D>(dqacc, dqn, ds, kc, kcn);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dkacc);
        fence_regs(dvacc);
        fence_regs(dqacc);
        fence_regs(dkn);
        fence_regs(dvn);
        fence_regs(dqn);
        mbar_arrive(&bars->q_empty[s]);

        // This warp's part of the dQ tile: 16 bytes per thread into its
        // staging run, then one bulk reduce-add of the run.
        if (lane == 0) bulk_wait_read<0>();  // the previous run has been read
        __syncwarp();
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          *reinterpret_cast<float4*>(staging + (j * 32 + lane) * 4) =
              make_float4(dqacc[4 * j], dqacc[4 * j + 1], dqacc[4 * j + 2], dqacc[4 * j + 3]);
        }
        if constexpr (T::kNarrow) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            *reinterpret_cast<float4*>(staging + ((8 + j) * 32 + lane) * 4) =
                make_float4(dqn[4 * j], dqn[4 * j + 1], dqn[4 * j + 2], dqn[4 * j + 3]);
          }
        }
        fence_proxy_async_shared();
        __syncwarp();
        if (lane == 0) {
          bulk_reduce_add_f32(dq_item + (long long)qt * kBlockM * D, staging,
                              32 * T::kDQRegs * 4);
          bulk_commit();
        }
      }
      mbar_arrive(&bars->kv_empty[n & 1]);  // K and V read for the last time

      // ---- epilogue: dK * scale and dV, rounded once, through the dS^T
      // buffer (its last reader, the dQ product, has completed) -------------
      const int k0 = item.k0 + c * 64;
      store_tile<D>(dk + item.b * st.dk[0] + item.h * st.dk[1], st.dk[2], dkacc, dkn, ds, k0, L,
                    c, t, scale);
      store_tile<D>(dv + item.b * st.dv[0] + item.h * st.dv[1], st.dv[2], dvacc, dvn, ds, k0, L,
                    c, t, 1.f);
    }
    if (lane == 0) bulk_wait_all();  // every reduce-add done before the CTA ends
  }
}

// Post-pass, one block per (q tile, head, batch): dq = bf16(scale * dQ_acc),
// from the consumers' fragment order (see dq_accumulator_index in
// ops/attention.py) through a row-major tile in shared memory to the
// caller's strides, 16 bytes per store.
constexpr int kPostpassThreads = 256;

__global__ void __launch_bounds__(kPostpassThreads)
flash_attn_bwd_sm90_postpass_kernel(const float* __restrict__ dq_acc,
                                    __nv_bfloat16* __restrict__ dq, int H, int L, int D,
                                    float scale, long long sb, long long sh, long long sl) {
  __shared__ float tile[kBlockM * (80 + 4)];  // rows of D + 4 floats
  const int q_tiles = gridDim.x, qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int row_len = D + 4;
  const float4* src = reinterpret_cast<const float4*>(
      dq_acc + (((long long)b * H + h) * q_tiles + qt) * kBlockM * D);
  for (int i = threadIdx.x; i < kBlockM * D / 4; i += kPostpassThreads) {
    const float4 v = src[i];
    const int off = 4 * i, regs = D / 2;
    const int warp = off / (32 * regs), o2 = off % (32 * regs);
    const int j = o2 / 128, lane = (o2 / 4) % 32;
    float* t = tile + (warp * 16 + lane / 4) * row_len + 8 * j + 2 * (lane % 4);
    t[0] = v.x;
    t[1] = v.y;
    t[8 * row_len] = v.z;
    t[8 * row_len + 1] = v.w;
  }
  __syncthreads();
  const int chunks = D / 8;
  __nv_bfloat16* base = dq + b * sb + h * sh;
  for (int i = threadIdx.x; i < kBlockM * chunks; i += kPostpassThreads) {
    const int r = i / chunks, c8 = i % chunks;
    const int row = qt * kBlockM + r;
    if (row >= L) continue;
    const float* t = tile + r * row_len + 8 * c8;
    const uint4 out = make_uint4(pack_bf16(t[0] * scale, t[1] * scale),
                                 pack_bf16(t[2] * scale, t[3] * scale),
                                 pack_bf16(t[4] * scale, t[5] * scale),
                                 pack_bf16(t[6] * scale, t[7] * scale));
    *reinterpret_cast<uint4*>(base + row * sl + 8 * c8) = out;
  }
}

// ---- host side -----------------------------------------------------------

template <int D>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
           const void* lse, void* dq, void* dk, void* dv, void* stats, void* dq_acc, int B,
           int H, int L, const long long* desc, const long long* strides, cudaStream_t stream) {
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
    int sms = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    sm_count[dev] = sms;
  }
  const int q_tiles = (L + kBlockM - 1) / kBlockM;
  const long long work = (long long)((L + kBlockN - 1) / kBlockN) * H * B;
  if (work >= (1LL << 31) || (long long)B * H * q_tiles * kBlockM * D >= (1LL << 40)) {
    return (int)cudaErrorInvalidValue;
  }
  const float scale = (float)(1.0 / sqrt((double)D));
  const long long* so = strides;  // o, dout, dq, dk, dv: (b, h, row) each
  float* acc = static_cast<float*>(dq_acc);

  flash_attn_bwd_sm90_prepass_kernel<<<dim3(q_tiles, H, B), kPrepassThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(o), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<float*>(stats), acc, H, L, D, so[0], so[1],
      so[2], so[3], so[4], so[5]);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.dk[i] = so[9 + i];
    st.dv[i] = so[12 + i];
  }
  const int grid = (int)(work < sm_count[dev] ? work : sm_count[dev]);
  flash_attn_bwd_sm90_kernel<D><<<grid, kThreads, smem, stream>>>(
      maps, static_cast<const float*>(stats), acc, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), B, H, L, scale, st);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  flash_attn_bwd_sm90_postpass_kernel<<<dim3(q_tiles, H, B), kPostpassThreads, 0, stream>>>(
      acc, static_cast<__nv_bfloat16*>(dq), H, L, D, scale, so[6], so[7], so[8]);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v, dout: (B, H, L, D) bf16 read through tensor maps built from `desc`
// (14 int64 fields each, in that order; see ops/attention.py:tma_description).
// o, dout, dq, dk, dv: element strides of (b, h, row) in `strides`, in that
// order (15 values), last dim contiguous, rows 16-byte aligned. lse: (B, H, L)
// f32 contiguous, from the forward. stats: (2, B, H, Lp) f32 scratch and
// dq_acc: (B, H, Lp / 64, 64 * D) f32 scratch, Lp = L rounded up to 64. Returns
// 0, a CUDA error code, or a negative code (see flash_attn_bwd_sm90_error_string);
// D outside {64, 80} returns cudaErrorInvalidValue without launching.
int flash_attn_bwd_sm90_bf16(const void* q, const void* k, const void* v, const void* o,
                             const void* dout, const void* lse, void* dq, void* dk, void* dv,
                             void* stats, void* dq_acc, int B, int H, int L, int D,
                             const long long* desc, const long long* strides, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch<64>(q, k, v, o, dout, lse, dq, dk, dv, stats, dq_acc, B, H, L, desc,
                        strides, s);
    case 80:
      return launch<80>(q, k, v, o, dout, lse, dq, dk, dv, stats, dq_acc, B, H, L, desc,
                        strides, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* flash_attn_bwd_sm90_error_string(int err) { return sm90::error_string(err); }

}  // extern "C"
