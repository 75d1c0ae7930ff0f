// Flash-attention forward for Hopper (sm_90a) with TMA, wgmma and warp
// specialisation: bf16 q/k/v in, bf16 O and f32 lse out, head dims 64 and 80.
//
// Replaces the Pallas TPU kernels instageo_tpu/ops/attention.py:_attn_kernel_blo
// (merged-heads output, (B, L, H*Dh)) and instageo_tpu/ops/attention.py:_attn_kernel
// (heads-first output, (B, H, L, Dh)); the caller passes the output strides.
// flash_attn_fwd.cu computes the same function with mma.sync for the other
// head dims.
//
// Math per (b, h), the online-softmax form of the TPU kernel's single pass,
// with its rounding points: f32 scores S = Q K^T from bf16 products; f32 row
// max m and row sum l; P = 2^(S*c - m*c), c = scale*log2(e), one FFMA and one
// EX2 per score; O += bf16(P) V in f32; at the end O * (1/l) in f32 (one
// reciprocal per row), cast to bf16, and lse = m*scale + ln(l).
//
// Layout: a persistent grid of one CTA per SM, three warpgroups each, walks
// the work items (128-row q tile, head, batch), q tiles fastest.
// - Warpgroup 0 is the producer: it gives up its registers (setmaxnreg) and one
//   thread issues TMA loads: each item's Q into one of two buffers (a "full"
//   and an "empty" mbarrier each), and its K and V tiles of 128 keys into a
//   ring of four stages (full and empty mbarriers for K and for V). The ring
//   runs on from one item to the next, so the next item's loads overlap this
//   one's end.
// - Warpgroups 1 and 2 are consumers, 64 q rows each (wgmma's M). S is one
//   m64n128k16 wgmma per 16 columns of Dh with Q and K from shared memory,
//   both K-major. P is rounded to bf16 in registers and is the register A
//   operand of O += P V, where V is B read MN-major (transposed) from the same
//   TMA tile. The next tile's Q K^T and this tile's P V are issued together;
//   the next tile's softmax runs while P V does (wgmma.wait_group 1), and each
//   stage is released as soon as its K or V has been read. The two consumers
//   take turns to issue (named barriers), so one's exponentials run while the
//   other's products do.
// - Operands are read where they lie through 4-D tensor maps (Dh, L, H, B) with
//   the caller's byte strides, so the model's q/k/v views of its (B, L, 3, H,
//   Dh) projection need no copy. A box is 64 columns x 128 rows under a
//   128-byte swizzle (the wgmma descriptors use the same layout); Dh = 80 adds
//   a second box of columns 64-79 under a 32-byte swizzle, so Q K^T takes 4 + 1
//   k-steps and P V one n64 and one n16 product. Rows past L arrive as zeros
//   and the keys among them are masked to -inf on the last tile; q rows past L
//   are computed on zeros and not stored.
//
// Bound at the serving shape (B=64, H=12, L=589, Dh=64): 4*B*H*L^2*Dh = 68.2
// GFLOP (69 us at 989 TFLOP/s bf16) against q, k, v, O in bf16 plus lse in f32,
// 233.4 MB (70 us at 3.35 TB/s), balanced between bytes and operations. At
// Dh = 64 the exponentials are a third limit: a score costs 4*Dh = 256
// tensor-core operations and one EX2, and an SM does 4096 of the first and 16
// of the second per clock, so both take the same time. The design overlaps
// them (within a warpgroup and by ping-pong) and keeps TMA loads ahead of
// use; each K/V tile is read once per 128 q rows.
// One CTA fills an SM (producer 24 registers, consumers 240).
//
// The tensor maps are encoded on the host at every call, from the description
// the caller computes (ops/attention.py:tma_description), by sm90::encode.

#include <math.h>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int kBlockM = 128;  // q rows per CTA, 64 per consumer warpgroup
constexpr int kBlockN = 128;  // keys per K/V tile
constexpr int kStages = 4;    // K/V ring depth
constexpr int kThreads = 384;  // producer warpgroup + two consumer warpgroups
constexpr int kConsumerThreads = 256;
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr int kWideCols = 64;              // columns of the 128-byte-swizzled box
constexpr int kWideBytes = kBlockN * 128;  // one such box of 128 rows
constexpr int kNarrowBytes = kBlockN * 32;  // 16 columns under a 32-byte swizzle
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Tile {
  static_assert(D == 64 || D == 80, "head dims 64 and 80");
  static constexpr bool kNarrow = D == 80;
  static constexpr int kBoxes = kNarrow ? 2 : 1;
  static constexpr int kBytes = kWideBytes + (kNarrow ? kNarrowBytes : 0);  // one operand tile
  static constexpr int kONarrow = kNarrow ? 8 : 1;  // accumulators of the n16 product
  // Two Q buffers, then K and V of each stage; every tile starts on a
  // 1024-byte boundary.
  static constexpr int kTileSmem = (2 + 2 * kStages) * kBytes;
};

struct Maps {
  // [0]: columns 0-63, 128-byte swizzle; [1]: columns 64-79, 32-byte swizzle.
  CUtensorMap q[2], k[2], v[2];
};

struct Barriers {
  uint64_t q_full[2], q_empty[2];
  uint64_t k_full[kStages], v_full[kStages], k_empty[kStages], v_empty[kStages];
};

// S = Q K^T for one warpgroup's 64 rows: qw/kw the 128-byte-swizzled boxes,
// qn/kn the 32-byte-swizzled ones (Dh = 80).
template <int D>
__device__ __forceinline__ void qk_product(float (&s)[64], const uint8_t* qw, const uint8_t* qn,
                                           const uint8_t* kw, const uint8_t* kn) {
  const uint64_t qd = make_desc(qw, 16, 1024, kSwizzle128);
  const uint64_t kd = make_desc(kw, 16, 1024, kSwizzle128);
#pragma unroll
  for (int kk = 0; kk < kWideCols / 16; ++kk) {
    wgmma_m64n128k16_ss<0>(s, desc_advance(qd, 32 * kk), desc_advance(kd, 32 * kk), kk > 0);
  }
  if constexpr (Tile<D>::kNarrow) {
    wgmma_m64n128k16_ss<0>(s, make_desc(qn, 16, 256, kSwizzle32),
                           make_desc(kn, 16, 256, kSwizzle32), 1);
  }
}

// O += P V over one 128-key tile: P in registers (8 k-steps of 16 keys), V
// MN-major from the 128-byte-swizzled box (and the 32-byte one for Dh = 80).
template <int D>
__device__ __forceinline__ void pv_product(float (&o)[32], float (&on)[Tile<D>::kONarrow],
                                           const uint32_t (&p)[32], const uint8_t* vw,
                                           const uint8_t* vn) {
  const uint64_t vd = make_desc(vw, kWideBytes, 1024, kSwizzle128);
#pragma unroll
  for (int kk = 0; kk < kBlockN / 16; ++kk) {
    const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3]};
    wgmma_m64n64k16_rs<1>(o, a, desc_advance(vd, 16 * 128 * kk));
    if constexpr (Tile<D>::kNarrow) {
      const uint64_t nd = make_desc(vn, kNarrowBytes, 256, kSwizzle32);
      wgmma_m64n16k16_rs<1>(on, a, desc_advance(nd, 16 * 32 * kk));
    }
  }
}

// Work item w of the (q tile, head, batch) grid, q tiles fastest, so that
// the CTAs working at one time share each head's K and V in L2.
struct Item {
  int q0, h, b;
};

__device__ __forceinline__ Item item_of(int w, int q_tiles, int H) {
  const int rest = w / q_tiles;
  return {(w % q_tiles) * kBlockM, rest % H, rest / H};
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_attn_fwd_sm90_kernel(const __grid_constant__ Maps maps, __nv_bfloat16* __restrict__ o,
                           float* __restrict__ lse, int B, int H, int L, float scale,
                           long long sob, long long soh, long long sol) {
  using T = Tile<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  Barriers* bars = reinterpret_cast<Barriers*>(smem + T::kTileSmem);
  auto q_tile = [&](int n) { return smem + (n & 1) * T::kBytes; };  // item n's Q
  auto k_tile = [&](int s) { return smem + (2 + 2 * s) * T::kBytes; };

  const int num_tiles = (L + kBlockN - 1) / kBlockN;
  const int q_tiles = (L + kBlockM - 1) / kBlockM;
  const int work = q_tiles * H * B;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&bars->q_full[i], 1);
      mbar_init(&bars->q_empty[i], kConsumerThreads);
    }
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&bars->k_full[s], 1);
      mbar_init(&bars->v_full[s], 1);
      mbar_init(&bars->k_empty[s], kConsumerThreads);
      mbar_init(&bars->v_empty[s], kConsumerThreads);
    }
    fence_barrier_init();
  }
  __syncthreads();

  // Persistent: CTA x takes work items x, x + gridDim.x, ... The K/V ring runs
  // on across items (tile counter `it`), so the loads of one item overlap the
  // last products and the epilogue of the one before.
  if (wg == 0) {
    // ---- producer: one thread keeps the ring full ----------------------
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      int it = 0, n = 0;
      for (int w = blockIdx.x; w < work; w += gridDim.x, ++n) {
        const Item item = item_of(w, q_tiles, H);
        uint8_t* qs = q_tile(n);
        uint64_t* q_full = &bars->q_full[n & 1];
        mbar_wait(&bars->q_empty[n & 1], ((n >> 1) & 1) ^ 1);
        mbar_arrive_expect_tx(q_full, T::kBytes);
        tma_load_4d(qs, &maps.q[0], q_full, 0, item.q0, item.h, item.b);
        if constexpr (T::kNarrow) {
          tma_load_4d(qs + kWideBytes, &maps.q[1], q_full, kWideCols, item.q0, item.h,
                      item.b);
        }
        for (int j = 0; j < num_tiles; ++j, ++it) {
          const int s = it % kStages;
          const uint32_t round = it / kStages;
          uint8_t* kt = k_tile(s);
          uint8_t* vt = kt + T::kBytes;
          mbar_wait(&bars->k_empty[s], (round & 1) ^ 1);
          mbar_arrive_expect_tx(&bars->k_full[s], T::kBytes);
          tma_load_4d(kt, &maps.k[0], &bars->k_full[s], 0, j * kBlockN, item.h, item.b);
          if constexpr (T::kNarrow) {
            tma_load_4d(kt + kWideBytes, &maps.k[1], &bars->k_full[s], kWideCols, j * kBlockN,
                        item.h, item.b);
          }
          mbar_wait(&bars->v_empty[s], (round & 1) ^ 1);
          mbar_arrive_expect_tx(&bars->v_full[s], T::kBytes);
          tma_load_4d(vt, &maps.v[0], &bars->v_full[s], 0, j * kBlockN, item.h, item.b);
          if constexpr (T::kNarrow) {
            tma_load_4d(vt + kWideBytes, &maps.v[1], &bars->v_full[s], kWideCols, j * kBlockN,
                        item.h, item.b);
          }
        }
      }
    }
  } else {
    // ---- consumers: 64 q rows each --------------------------------------
    setmaxnreg_inc<kConsumerRegs>();
    const int c = wg - 1;
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int g = lane / 4, tq = lane % 4;  // accumulator row group, column pair
    const float sc = scale * kLog2e;

    float sacc[64];
    uint32_t p[32];
    float oacc[32];
    float onar[T::kONarrow];
    // Rows g and g + 8 of this warp's 16: running max of the raw scores and
    // this thread's part of the row sum.
    float m0, m1, l0, l1;

    // Softmax of tile j on sacc: mask, row max, rescale factors, exponentials.
    auto softmax = [&](int j, float& a0, float& a1) {
      const int n0 = j * kBlockN;
      float mx0 = -INFINITY, mx1 = -INFINITY;
      if (n0 + kBlockN > L) {
#pragma unroll
        for (int jj = 0; jj < kBlockN / 8; ++jj) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (n0 + 8 * jj + 2 * tq + e >= L) {
              sacc[4 * jj + e] = -INFINITY;
              sacc[4 * jj + 2 + e] = -INFINITY;
            }
          }
        }
      }
#pragma unroll
      for (int jj = 0; jj < kBlockN / 8; ++jj) {
        mx0 = fmaxf(mx0, fmaxf(sacc[4 * jj], sacc[4 * jj + 1]));
        mx1 = fmaxf(mx1, fmaxf(sacc[4 * jj + 2], sacc[4 * jj + 3]));
      }
      // The four threads of a row group hold the row's columns between them.
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      // Every tile holds at least one key below L, so the new max is finite.
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      a0 = exp2_approx((m0 - mn0) * sc);
      a1 = exp2_approx((m1 - mn1) * sc);
      m0 = mn0;
      m1 = mn1;
      const float b0 = mn0 * sc, b1 = mn1 * sc;
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int jj = 0; jj < kBlockN / 8; ++jj) {
        sacc[4 * jj] = exp2_approx(fmaf(sacc[4 * jj], sc, -b0));
        sacc[4 * jj + 1] = exp2_approx(fmaf(sacc[4 * jj + 1], sc, -b0));
        sacc[4 * jj + 2] = exp2_approx(fmaf(sacc[4 * jj + 2], sc, -b1));
        sacc[4 * jj + 3] = exp2_approx(fmaf(sacc[4 * jj + 3], sc, -b1));
        rs0 += sacc[4 * jj] + sacc[4 * jj + 1];
        rs1 += sacc[4 * jj + 2] + sacc[4 * jj + 3];
      }
      l0 = l0 * a0 + rs0;
      l1 = l1 * a1 + rs1;
    };
    auto rescale_and_pack = [&](float a0, float a1) {
#pragma unroll
      for (int i = 0; i < 32; i += 4) {
        oacc[i] *= a0;
        oacc[i + 1] *= a0;
        oacc[i + 2] *= a1;
        oacc[i + 3] *= a1;
      }
      if constexpr (T::kNarrow) {
#pragma unroll
        for (int i = 0; i < T::kONarrow; i += 4) {
          onar[i] *= a0;
          onar[i + 1] *= a0;
          onar[i + 2] *= a1;
          onar[i + 3] *= a1;
        }
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) p[i] = pack_bf16(sacc[2 * i], sacc[2 * i + 1]);
    };

    // Ping-pong: the two consumers take turns to issue their products, so
    // that one warpgroup's softmax runs while the other's wgmmas do. Each
    // turn is one named barrier (1 for consumer 0, 2 for consumer 1) that
    // the other consumer arrives on; consumer 0 goes first. Both issue
    // num_tiles + 1 times per item, and consumer 1 does not pass its very
    // last turn, so every arrival is waited for.
    const int my_turn = 1 + c, other_turn = 2 - c;
    if (c == 1) bar_arrive(1, kConsumerThreads);

    int it = 0, n = 0;
    for (int w = blockIdx.x; w < work; w += gridDim.x, ++n) {
      const Item item = item_of(w, q_tiles, H);
      const bool last_item = w + static_cast<int>(gridDim.x) >= work;
#pragma unroll
      for (int i = 0; i < 32; ++i) oacc[i] = 0.f;
#pragma unroll
      for (int i = 0; i < T::kONarrow; ++i) onar[i] = 0.f;
      m0 = m1 = -INFINITY;
      l0 = l1 = 0.f;

      // This consumer's 64 rows of the item's Q: both boxes.
      const uint8_t* qw = q_tile(n) + c * 64 * 128;
      const uint8_t* qn = q_tile(n) + kWideBytes + c * 64 * 32;
      mbar_wait(&bars->q_full[n & 1], (n >> 1) & 1);
      {
        const int s = it % kStages;
        mbar_wait(&bars->k_full[s], (it / kStages) & 1);
        bar_sync(my_turn, kConsumerThreads);
        wgmma_fence();
        qk_product<D>(sacc, qw, qn, k_tile(s), k_tile(s) + kWideBytes);
        wgmma_commit();
        bar_arrive(other_turn, kConsumerThreads);
        wgmma_wait<0>();
        fence_regs(sacc);
        mbar_arrive(&bars->k_empty[s]);
        if (num_tiles == 1) mbar_arrive(&bars->q_empty[n & 1]);
      }
      float a0, a1;
      softmax(0, a0, a1);
      rescale_and_pack(a0, a1);

      for (int j = 1; j < num_tiles; ++j) {
        const int s = (it + j) % kStages, sp = (it + j - 1) % kStages;
        const uint8_t* vp = k_tile(sp) + T::kBytes;
        mbar_wait(&bars->k_full[s], ((it + j) / kStages) & 1);
        mbar_wait(&bars->v_full[sp], ((it + j - 1) / kStages) & 1);
        fence_regs(oacc);
        fence_regs(onar);
        bar_sync(my_turn, kConsumerThreads);
        wgmma_fence();
        qk_product<D>(sacc, qw, qn, k_tile(s), k_tile(s) + kWideBytes);
        wgmma_commit();
        pv_product<D>(oacc, onar, p, vp, vp + kWideBytes);
        wgmma_commit();
        bar_arrive(other_turn, kConsumerThreads);
        wgmma_wait<1>();  // S of tile j is in; P V of tile j - 1 may still run
        fence_regs(sacc);
        mbar_arrive(&bars->k_empty[s]);
        if (j == num_tiles - 1) mbar_arrive(&bars->q_empty[n & 1]);  // Q read for the last time
        softmax(j, a0, a1);
        wgmma_wait<0>();
        fence_regs(oacc);
        fence_regs(onar);
        mbar_arrive(&bars->v_empty[sp]);
        rescale_and_pack(a0, a1);
      }
      {
        const int s = (it + num_tiles - 1) % kStages;
        const uint8_t* vp = k_tile(s) + T::kBytes;
        mbar_wait(&bars->v_full[s], ((it + num_tiles - 1) / kStages) & 1);
        fence_regs(oacc);
        fence_regs(onar);
        bar_sync(my_turn, kConsumerThreads);
        wgmma_fence();
        pv_product<D>(oacc, onar, p, vp, vp + kWideBytes);
        wgmma_commit();
        if (c == 0 || !last_item) bar_arrive(other_turn, kConsumerThreads);
        wgmma_wait<0>();
        fence_regs(oacc);
        fence_regs(onar);
        mbar_arrive(&bars->v_empty[s]);
      }
      it += num_tiles;

      // ---- epilogue: O * (1 / l) in f32, cast to bf16; lse = m*scale + ln(l).
      // One reciprocal per row: within an f32 rounding of O / l, and an IEEE
      // division per element cost 12% of the kernel's time at the serving shape.
      float r0l = l0, r1l = l1;
      r0l += __shfl_xor_sync(0xffffffffu, r0l, 1);
      r0l += __shfl_xor_sync(0xffffffffu, r0l, 2);
      r1l += __shfl_xor_sync(0xffffffffu, r1l, 1);
      r1l += __shfl_xor_sync(0xffffffffu, r1l, 2);
      const int r0 = item.q0 + c * 64 + warp * 16 + g;
      __nv_bfloat16* op = o + item.b * sob + item.h * soh;
      float* lp = lse + (static_cast<long long>(item.b) * H + item.h) * L;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = r0 + 8 * half;
        if (r >= L) continue;
        const float l = half ? r1l : r0l, inv = 1.f / l;
        __nv_bfloat16* row = op + r * sol + 2 * tq;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          *reinterpret_cast<uint32_t*>(row + 8 * jj) =
              pack_bf16(oacc[4 * jj + 2 * half] * inv, oacc[4 * jj + 2 * half + 1] * inv);
        }
        if constexpr (T::kNarrow) {
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            *reinterpret_cast<uint32_t*>(row + kWideCols + 8 * jj) =
                pack_bf16(onar[4 * jj + 2 * half] * inv, onar[4 * jj + 2 * half + 1] * inv);
          }
        }
        if (tq == 0) lp[r] = (half ? m1 : m0) * scale + logf(l);
      }
    }
  }
}

// ---- host side -----------------------------------------------------------

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse, int B, int H, int L,
           const long long* desc, long long sob, long long soh, long long sol,
           cudaStream_t stream) {
  using T = Tile<D>;
  Maps maps;
  const void* bases[3] = {q, k, v};
  CUtensorMap* dst[3] = {maps.q, maps.k, maps.v};
  for (int i = 0; i < 3; ++i) {
    const long long* f = desc + i * kMapFields;
    if (!boxes_match(D, f) || f[1] != L || f[2] != H || f[3] != B) return kErrDescription;
    for (int box = 0; box < T::kBoxes; ++box) {
      const int err = encode(&dst[i][box], bases[i], f, box, kBlockN);
      if (err != 0) return err;
    }
  }
  constexpr int smem = T::kTileSmem + (int)sizeof(Barriers) + 1024;  // + alignment slack
  // Per device, once: the raised shared-memory limit and the SM count.
  constexpr int kMaxDevices = 64;
  static int sm_count[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (sm_count[dev] == 0) {
    err = cudaFuncSetAttribute(flash_attn_fwd_sm90_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    int sms = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    sm_count[dev] = sms;
  }
  // One CTA per SM (or per work item, if there are fewer).
  const long long work = (long long)((L + kBlockM - 1) / kBlockM) * H * B;
  if (work >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const int grid = (int)(work < sm_count[dev] ? work : sm_count[dev]);
  const float scale = (float)(1.0 / sqrt((double)D));
  flash_attn_fwd_sm90_kernel<D><<<grid, kThreads, smem, stream>>>(
      maps, static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), B, H, L, scale, sob, soh,
      sol);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v: (B, H, L, D) bf16, read through tensor maps built from `desc`:
// for each of q, k, v in turn, 14 int64 fields (Dh, L, H, B; byte strides of
// L, H, B; the number of boxes; then (first column, columns, swizzle bytes) of
// each box, two boxes' room). o: bf16 at element strides (sob, soh, sol) of
// (b, h, row), last dim contiguous. lse: (B, H, L) f32, contiguous. Returns 0,
// a CUDA error code, or a negative code (see flash_attn_sm90_error_string); D
// outside {64, 80} returns cudaErrorInvalidValue without launching.
int flash_attn_fwd_sm90_bf16(const void* q, const void* k, const void* v, void* o, void* lse,
                             int B, int H, int L, int D, const long long* desc, long long sob,
                             long long soh, long long sol, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch<64>(q, k, v, o, lse, B, H, L, desc, sob, soh, sol, s);
    case 80: return launch<80>(q, k, v, o, lse, B, H, L, desc, sob, soh, sol, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* flash_attn_sm90_error_string(int err) { return sm90::error_string(err); }

}  // extern "C"
