// Flash-attention backward for Hopper (sm_90a): bf16 q, k, v, O, dO and f32 lse
// in, bf16 dq, dk, dv out.
//
// Replaces three Pallas TPU kernels of instageo_tpu/ops/attention.py:
//   _attn_bwd_kernel_blo  (O and dO merged (B, L, H*Dh), the training path),
//   _attn_bwd_kernel      (O and dO heads-first, the flat (B*H, L, Dh) entry),
//   _attn_bwd_kernel_bloq (q rows in blocks, dk/dv summed over the blocks in
//                          f32 and rounded once; rows past L add nothing).
// One kernel serves all three: every tensor comes with its (batch, head, row)
// element strides, so a layout is only a set of strides, and the q-row tiling
// that the TPU needed a separate kernel for is this kernel's ordinary tiling.
//
// Math (the TPU kernels' rounding points, per (b, h) pair):
//   S  = (Q K^T) * scale          bf16 products, f32 accumulation, scale after
//   P  = exp(S - lse)             f32, from the forward's row logsumexp
//   dP = dO V^T                   f32
//   d  = rowsum(dO * O)           f32
//   dS = bf16(P * (dP - d)),  Pb = bf16(P)
//   dQ = scale * (dS K),  dK = scale * (dS^T Q),  dV = Pb^T dO   (f32, cast once)
//
// Design: deterministic, no atomics, three launches on the caller's stream.
//   1. delta: d = rowsum(dO * O) into an f32 (B, H, L) scratch the caller owns.
//   2. dkdv: one block of 4 warps per (64-key tile, head, batch). Each warp
//      owns 16 keys and keeps their K and V rows as mma A fragments in
//      registers; the block walks every 64-row q tile (Q, dO, lse and d
//      double-buffered in shared memory by cp.async), recomputes S^T and dP^T
//      for its keys, and accumulates dK and dV in f32 registers across all q
//      tiles, so each is rounded to bf16 once, at the end.
//   3. dq: one block per (64-row q tile, head, batch). Each warp owns 16 q
//      rows (Q and dO as A fragments); the block walks the key tiles (K and V
//      double-buffered) and accumulates dQ in f32 registers.
// That is 7 tile products where the TPU kernel, which held all of L at once,
// did 5 (S and dP are computed in both passes): the price of no atomics and
// no cross-block reduction. All products are mma.sync m16n8k16 with ldmatrix
// fragments, as in flash_attn_fwd.cu.
//
// Ragged edges (L is never a multiple of 64): rows past L are zero-filled by
// cp.async and never stored. In the dkdv pass a q column past L gets P = 0,
// hence dS = 0, so padded q rows add nothing to dK and dV; in the dq pass a
// key past L gets P = 0. Dh must be a multiple of 16 up to 128; every
// instantiation needs more than 48 KB of shared memory and opts in.
//
// Bound (work of the TPU kernel): 10*B*H*L^2*Dh FLOPs at 989 TFLOP/s against
// 16*B*H*L*Dh bytes (q, k, v, O, dO read, dq, dk, dv written, bf16) plus lse;
// at the training shape (8, 12, 589, 64) 21.3 GFLOP, 21.6 us: bound by
// operations. mma.sync, the two extra products and the exponentials on the
// SFUs keep this simple kernel far from it; wgmma and TMA are the next steps.
// The kernel allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 64;  // rows of every tile: q rows and keys alike
constexpr int kWarps = 4;   // 16 rows each
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;     // bf16 elements of padding per shared-memory row

// Tensors whose strides the caller passes, in this order.
enum { kQ = 0, kK, kV, kO, kDO, kDQ, kDK, kDV, kNumTensors };

struct Strides {
  long long s[kNumTensors][3];  // element strides of (batch, head, row); dim 3 contiguous
};

__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices from shared memory; lane l gives the address of row
// l % 8 of matrix l / 8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s)
               : "memory");
}

// Global -> shared without passing through registers; zero-fills when !valid
// (then nothing is read).
__device__ __forceinline__ void cp_async16(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Start copying rows [row0, row0 + 64) of an (L, D) slice into shared memory,
// row stride D + kPad; rows past L become zeros.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long long row_stride, int row0, int L) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < kBlock * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const bool valid = row0 + r < L;
    cp_async16(dst + r * (D + kPad) + c * 8,
               src + (long long)(valid ? row0 + r : 0) * row_stride + c * 8, valid);
  }
}

// Start copying entries [row0, row0 + 64) of a contiguous f32 row vector;
// entries past L become zeros.
__device__ __forceinline__ void load_rows(float* dst, const float* src, int row0, int L) {
  for (int i = threadIdx.x; i < kBlock; i += kThreads) {
    const bool valid = row0 + i < L;
    cp_async4(dst + i, src + (valid ? row0 + i : 0), valid);
  }
}

// This warp's 16 rows of a staged tile as mma A fragments, for every k-step.
template <int D>
__device__ __forceinline__ void load_a_fragments(uint32_t (&f)[D / 16][4],
                                                 const __nv_bfloat16* tile, int wr) {
  const int lane = threadIdx.x % 32, mat = lane / 8, mrow = lane % 8;
#pragma unroll
  for (int s = 0; s < D / 16; ++s) {
    ldmatrix_x4(f[s], tile + (wr + mrow + (mat % 2) * 8) * (D + kPad) + s * 16 + (mat / 2) * 8);
  }
}

// Store one warp's 16 x D f32 accumulator, times `scale`, as bf16 rows
// [r0, r0 + 16) of an (L, D) slice; rows past L are not stored.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, long long row_stride,
                                           const float (&acc)[D / 8][4], int r0, int L,
                                           float scale) {
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  if (r0 + g < L) {
    __nv_bfloat16* row = dst + (long long)(r0 + g) * row_stride + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<uint32_t*>(row + j * 8) =
          pack_bf16(acc[j][0] * scale, acc[j][1] * scale);
    }
  }
  if (r0 + g + 8 < L) {
    __nv_bfloat16* row = dst + (long long)(r0 + g + 8) * row_stride + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<uint32_t*>(row + j * 8) =
          pack_bf16(acc[j][2] * scale, acc[j][3] * scale);
    }
  }
}

// d[b, h, r] = sum_c f32(dO[b, h, r, c]) * f32(O[b, h, r, c]); one thread per row.
__global__ void __launch_bounds__(kThreads)
flash_attn_bwd_delta_kernel(const __nv_bfloat16* __restrict__ o,
                            const __nv_bfloat16* __restrict__ dout, float* __restrict__ delta,
                            int H, int L, int D, Strides st) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  if (r >= L) return;
  const __nv_bfloat16* op = o + b * st.s[kO][0] + h * st.s[kO][1] + r * st.s[kO][2];
  const __nv_bfloat16* gp = dout + b * st.s[kDO][0] + h * st.s[kDO][1] + r * st.s[kDO][2];
  float acc = 0.f;
  for (int c = 0; c < D; c += 8) {
    const uint4 ov = *reinterpret_cast<const uint4*>(op + c);
    const uint4 gv = *reinterpret_cast<const uint4*>(gp + c);
    const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
    const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 of = __bfloat1622float2(o2[e]);
      const float2 gf = __bfloat1622float2(g2[e]);
      acc = fmaf(gf.x, of.x, acc);
      acc = fmaf(gf.y, of.y, acc);
    }
  }
  delta[((long long)b * H + h) * L + r] = acc;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_attn_bwd_dkdv_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           const __nv_bfloat16* __restrict__ dout,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                           int H, int L, float scale, Strides st) {
  constexpr int kRow = D + kPad;         // shared row stride of every tile
  constexpr int kTile = kBlock * kRow;   // elements of one staged tile
  constexpr int kSteps = D / 16;         // k-steps of the products over Dh
  constexpr int kDTiles = D / 8;         // 8-wide n-tiles of dK and dV
  constexpr int kSTiles = kBlock / 8;    // 8-wide n-tiles of S^T (q columns)

  extern __shared__ uint4 smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vs = ks + kTile;
  __nv_bfloat16* qs = vs + kTile;        // two Q tiles
  __nv_bfloat16* gs = qs + 2 * kTile;    // two dO tiles
  float* lse_s = reinterpret_cast<float*>(gs + 2 * kTile);  // two of kBlock
  float* delta_s = lse_s + 2 * kBlock;                      // two of kBlock

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t = lane & 3;                      // mma fragment column pair
  const int mat = lane / 8, mrow = lane % 8;   // ldmatrix: this lane's matrix and row
  const int k0 = blockIdx.x * kBlock;
  const int h = blockIdx.y, b = blockIdx.z;
  const int num_tiles = (L + kBlock - 1) / kBlock;

  const __nv_bfloat16* qp = q + b * st.s[kQ][0] + h * st.s[kQ][1];
  const __nv_bfloat16* kp = k + b * st.s[kK][0] + h * st.s[kK][1];
  const __nv_bfloat16* vp = v + b * st.s[kV][0] + h * st.s[kV][1];
  const __nv_bfloat16* gp = dout + b * st.s[kDO][0] + h * st.s[kDO][1];
  const float* lp = lse + ((long long)b * H + h) * L;
  const float* dp = delta + ((long long)b * H + h) * L;

  load_tile<D>(ks, kp, st.s[kK][2], k0, L);
  load_tile<D>(vs, vp, st.s[kV][2], k0, L);
  load_tile<D>(qs, qp, st.s[kQ][2], 0, L);
  load_tile<D>(gs, gp, st.s[kDO][2], 0, L);
  load_rows(lse_s, lp, 0, L);
  load_rows(delta_s, dp, 0, L);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  // This warp's 16 keys: K and V rows as A fragments of S^T = K Q^T and
  // dP^T = V dO^T.
  const int wr = warp * 16;
  uint32_t kf[kSteps][4], vf[kSteps][4];
  load_a_fragments<D>(kf, ks, wr);
  load_a_fragments<D>(vf, vs, wr);

  float dkacc[kDTiles][4], dvacc[kDTiles][4];
#pragma unroll
  for (int j = 0; j < kDTiles; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dkacc[j][e] = dvacc[j][e] = 0.f;
  }

  for (int it = 0; it < num_tiles; ++it) {
    const int q0 = it * kBlock;
    const __nv_bfloat16* qt = qs + (it & 1) * kTile;
    const __nv_bfloat16* gt = gs + (it & 1) * kTile;
    const float* lt = lse_s + (it & 1) * kBlock;
    const float* dt = delta_s + (it & 1) * kBlock;
    if (it + 1 < num_tiles) {  // prefetch the next q tile into the other buffers
      const int nb = (it + 1) & 1;
      load_tile<D>(qs + nb * kTile, qp, st.s[kQ][2], q0 + kBlock, L);
      load_tile<D>(gs + nb * kTile, gp, st.s[kDO][2], q0 + kBlock, L);
      load_rows(lse_s + nb * kBlock, lp, q0 + kBlock, L);
      load_rows(delta_s + nb * kBlock, dp, q0 + kBlock, L);
    }
    cp_async_commit();

    // S^T (16 keys x 64 q) and dP^T, f32.
    float sacc[kSTiles][4], pacc[kSTiles][4];
#pragma unroll
    for (int j = 0; j < kSTiles; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[j][e] = pacc[j][e] = 0.f;
    }
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
#pragma unroll
      for (int j = 0; j < kSTiles; j += 2) {
        // B fragments (Dh rows 2t.., q column g) of q n-tiles j and j + 1.
        const int off = ((j + mat / 2) * 8 + mrow) * kRow + s * 16 + (mat % 2) * 8;
        uint32_t qb[4], gb[4];
        ldmatrix_x4(qb, qt + off);
        mma_16816(sacc[j], kf[s], qb[0], qb[1]);
        mma_16816(sacc[j + 1], kf[s], qb[2], qb[3]);
        ldmatrix_x4(gb, gt + off);
        mma_16816(pacc[j], vf[s], gb[0], gb[1]);
        mma_16816(pacc[j + 1], vf[s], gb[2], gb[3]);
      }
    }

    // P^T = exp(S^T * scale - lse[q]) and dS^T = P^T (dP^T - d[q]); columns
    // are q rows, so q rows past L get P = 0 and dS = 0.
#pragma unroll
    for (int j = 0; j < kSTiles; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = j * 8 + 2 * t + e;
        const bool valid = q0 + c < L;
        const float lq = lt[c], dq = dt[c];
#pragma unroll
        for (int r = 0; r < 2; ++r) {  // key rows g and g + 8
          const int i = 2 * r + e;
          const float p = valid ? expf(sacc[j][i] * scale - lq) : 0.f;
          pacc[j][i] = p * (pacc[j][i] - dq);
          sacc[j][i] = p;
        }
      }
    }

    // dV += bf16(P^T) dO and dK += bf16(dS^T) Q: the accumulators of q n-tiles
    // 2s and 2s + 1 are the A fragment of k-step s.
#pragma unroll
    for (int s = 0; s < kBlock / 16; ++s) {
      const uint32_t pa[4] = {
          pack_bf16(sacc[2 * s][0], sacc[2 * s][1]),
          pack_bf16(sacc[2 * s][2], sacc[2 * s][3]),
          pack_bf16(sacc[2 * s + 1][0], sacc[2 * s + 1][1]),
          pack_bf16(sacc[2 * s + 1][2], sacc[2 * s + 1][3]),
      };
      const uint32_t da[4] = {
          pack_bf16(pacc[2 * s][0], pacc[2 * s][1]),
          pack_bf16(pacc[2 * s][2], pacc[2 * s][3]),
          pack_bf16(pacc[2 * s + 1][0], pacc[2 * s + 1][1]),
          pack_bf16(pacc[2 * s + 1][2], pacc[2 * s + 1][3]),
      };
#pragma unroll
      for (int j = 0; j < kDTiles; j += 2) {
        // B fragments (q rows 2t.., Dh column g) of Dh n-tiles j and j + 1.
        const int off = (s * 16 + (mat % 2) * 8 + mrow) * kRow + (j + mat / 2) * 8;
        uint32_t gb[4], qb[4];
        ldmatrix_x4_trans(gb, gt + off);
        mma_16816(dvacc[j], pa, gb[0], gb[1]);
        mma_16816(dvacc[j + 1], pa, gb[2], gb[3]);
        ldmatrix_x4_trans(qb, qt + off);
        mma_16816(dkacc[j], da, qb[0], qb[1]);
        mma_16816(dkacc[j + 1], da, qb[2], qb[3]);
      }
    }
    cp_async_wait_all();  // the next tile has landed ...
    __syncthreads();      // ... for every warp, and this one is free to refill
  }

  store_rows<D>(dk + b * st.s[kDK][0] + h * st.s[kDK][1], st.s[kDK][2], dkacc, k0 + wr, L,
                scale);
  store_rows<D>(dv + b * st.s[kDV][0] + h * st.s[kDV][1], st.s[kDV][2], dvacc, k0 + wr, L,
                1.f);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_attn_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dq, int H, int L, float scale,
                         Strides st) {
  constexpr int kRow = D + kPad;
  constexpr int kTile = kBlock * kRow;
  constexpr int kSteps = D / 16;
  constexpr int kDTiles = D / 8;         // 8-wide n-tiles of dQ
  constexpr int kSTiles = kBlock / 8;    // 8-wide n-tiles of S (key columns)

  extern __shared__ uint4 smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* gs = qs + kTile;
  __nv_bfloat16* ks = gs + kTile;        // two K tiles
  __nv_bfloat16* vs = ks + 2 * kTile;    // two V tiles

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int mat = lane / 8, mrow = lane % 8;
  const int q0 = blockIdx.x * kBlock;
  const int h = blockIdx.y, b = blockIdx.z;
  const int num_tiles = (L + kBlock - 1) / kBlock;

  const __nv_bfloat16* qp = q + b * st.s[kQ][0] + h * st.s[kQ][1];
  const __nv_bfloat16* kp = k + b * st.s[kK][0] + h * st.s[kK][1];
  const __nv_bfloat16* vp = v + b * st.s[kV][0] + h * st.s[kV][1];
  const __nv_bfloat16* gp = dout + b * st.s[kDO][0] + h * st.s[kDO][1];

  load_tile<D>(qs, qp, st.s[kQ][2], q0, L);
  load_tile<D>(gs, gp, st.s[kDO][2], q0, L);
  load_tile<D>(ks, kp, st.s[kK][2], 0, L);
  load_tile<D>(vs, vp, st.s[kV][2], 0, L);
  cp_async_commit();

  // Row statistics of rows g and g + 8 of this warp's 16; zero past L.
  const int wr = warp * 16;
  const int r0 = q0 + wr + g, r1 = r0 + 8;
  const long long row_base = ((long long)b * H + h) * L;
  const float lse0 = r0 < L ? lse[row_base + r0] : 0.f;
  const float lse1 = r1 < L ? lse[row_base + r1] : 0.f;
  const float d0 = r0 < L ? delta[row_base + r0] : 0.f;
  const float d1 = r1 < L ? delta[row_base + r1] : 0.f;

  cp_async_wait_all();
  __syncthreads();
  uint32_t qf[kSteps][4], gf[kSteps][4];
  load_a_fragments<D>(qf, qs, wr);
  load_a_fragments<D>(gf, gs, wr);

  float dqacc[kDTiles][4];
#pragma unroll
  for (int j = 0; j < kDTiles; ++j) dqacc[j][0] = dqacc[j][1] = dqacc[j][2] = dqacc[j][3] = 0.f;

  for (int it = 0; it < num_tiles; ++it) {
    const int n0 = it * kBlock;
    const __nv_bfloat16* kt = ks + (it & 1) * kTile;
    const __nv_bfloat16* vt = vs + (it & 1) * kTile;
    if (it + 1 < num_tiles) {  // prefetch the next key tile into the other buffers
      load_tile<D>(ks + ((it + 1) & 1) * kTile, kp, st.s[kK][2], n0 + kBlock, L);
      load_tile<D>(vs + ((it + 1) & 1) * kTile, vp, st.s[kV][2], n0 + kBlock, L);
    }
    cp_async_commit();

    // S (16 q x 64 keys) and dP = dO V^T, f32.
    float sacc[kSTiles][4], pacc[kSTiles][4];
#pragma unroll
    for (int j = 0; j < kSTiles; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[j][e] = pacc[j][e] = 0.f;
    }
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
#pragma unroll
      for (int j = 0; j < kSTiles; j += 2) {
        // B fragments (Dh rows 2t.., key g) of key n-tiles j and j + 1.
        const int off = ((j + mat / 2) * 8 + mrow) * kRow + s * 16 + (mat % 2) * 8;
        uint32_t kb[4], vb[4];
        ldmatrix_x4(kb, kt + off);
        mma_16816(sacc[j], qf[s], kb[0], kb[1]);
        mma_16816(sacc[j + 1], qf[s], kb[2], kb[3]);
        ldmatrix_x4(vb, vt + off);
        mma_16816(pacc[j], gf[s], vb[0], vb[1]);
        mma_16816(pacc[j + 1], gf[s], vb[2], vb[3]);
      }
    }

    // dS = P (dP - d), P = exp(S * scale - lse); keys past L get P = 0.
    const bool tail = n0 + kBlock > L;
#pragma unroll
    for (int j = 0; j < kSTiles; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool valid = !tail || n0 + j * 8 + 2 * t + e < L;
        const float p0 = valid ? expf(sacc[j][e] * scale - lse0) : 0.f;
        const float p1 = valid ? expf(sacc[j][2 + e] * scale - lse1) : 0.f;
        pacc[j][e] = p0 * (pacc[j][e] - d0);
        pacc[j][2 + e] = p1 * (pacc[j][2 + e] - d1);
      }
    }

    // dQ += bf16(dS) K.
#pragma unroll
    for (int s = 0; s < kBlock / 16; ++s) {
      const uint32_t da[4] = {
          pack_bf16(pacc[2 * s][0], pacc[2 * s][1]),
          pack_bf16(pacc[2 * s][2], pacc[2 * s][3]),
          pack_bf16(pacc[2 * s + 1][0], pacc[2 * s + 1][1]),
          pack_bf16(pacc[2 * s + 1][2], pacc[2 * s + 1][3]),
      };
#pragma unroll
      for (int j = 0; j < kDTiles; j += 2) {
        // B fragments (keys 2t.., Dh column g) of Dh n-tiles j and j + 1.
        uint32_t kb[4];
        ldmatrix_x4_trans(kb, kt + (s * 16 + (mat % 2) * 8 + mrow) * kRow + (j + mat / 2) * 8);
        mma_16816(dqacc[j], da, kb[0], kb[1]);
        mma_16816(dqacc[j + 1], da, kb[2], kb[3]);
      }
    }
    cp_async_wait_all();
    __syncthreads();
  }

  store_rows<D>(dq + b * st.s[kDQ][0] + h * st.s[kDQ][1], st.s[kDQ][2], dqacc, q0 + wr, L,
                scale);
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, const void* lse, void* dq, void* dk, void* dv,
                   void* delta, int B, int H, int L, const Strides& st, cudaStream_t stream) {
  // dkdv: K, V, two Q and two dO tiles, two lse and two d rows. dq: Q, dO,
  // two K and two V tiles. Both pass 48 KB at every Dh and opt in.
  const int tiles = 6 * kBlock * (D + kPad) * (int)sizeof(__nv_bfloat16);
  const int smem_dkdv = tiles + 4 * kBlock * (int)sizeof(float);
  const int smem_dq = tiles;
  cudaError_t err = cudaFuncSetAttribute(flash_attn_bwd_dkdv_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dkdv);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_attn_bwd_dq_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dq);
  if (err != cudaSuccess) return err;

  const float scale = (float)(1.0 / sqrt((double)D));
  const __nv_bfloat16* qb = static_cast<const __nv_bfloat16*>(q);
  const __nv_bfloat16* kb = static_cast<const __nv_bfloat16*>(k);
  const __nv_bfloat16* vb = static_cast<const __nv_bfloat16*>(v);
  const __nv_bfloat16* gb = static_cast<const __nv_bfloat16*>(dout);
  const float* lp = static_cast<const float*>(lse);
  float* dp = static_cast<float*>(delta);

  flash_attn_bwd_delta_kernel<<<dim3((L + kThreads - 1) / kThreads, H, B), kThreads, 0,
                                stream>>>(static_cast<const __nv_bfloat16*>(o), gb, dp, H, L,
                                          D, st);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid((L + kBlock - 1) / kBlock, H, B);
  flash_attn_bwd_dkdv_kernel<D><<<grid, kThreads, smem_dkdv, stream>>>(
      qb, kb, vb, gb, lp, dp, static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv),
      H, L, scale, st);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_attn_bwd_dq_kernel<D><<<grid, kThreads, smem_dq, stream>>>(
      qb, kb, vb, gb, lp, dp, static_cast<__nv_bfloat16*>(dq), H, L, scale, st);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v, o, dout, dq, dk, dv: (B, H, L, D) bf16 views given by their element
// strides of the first three dims (strides[3 * i + {0, 1, 2}] for tensor i in
// the order q, k, v, o, dout, dq, dk, dv) and a contiguous last dim; every
// pointer 16-byte aligned and every row stride a multiple of 8. lse: (B, H, L)
// f32 contiguous, from the forward. delta: (B, H, L) f32 scratch. Returns the
// launches' CUDA error code (0 on success); D outside {16, 32, ..., 128}
// returns cudaErrorInvalidValue without launching.
int flash_attn_bwd_bf16(const void* q, const void* k, const void* v, const void* o,
                        const void* dout, const void* lse, void* dq, void* dk, void* dv,
                        void* delta, int B, int H, int L, int D, const long long* strides,
                        void* stream) {
  Strides st;
  for (int i = 0; i < kNumTensors; ++i) {
    for (int j = 0; j < 3; ++j) st.s[i][j] = strides[3 * i + j];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<16>(q, k, v, o, dout, lse, dq, dk, dv, delta, B, H, L, st, s);
    case 32: return launch<32>(q, k, v, o, dout, lse, dq, dk, dv, delta, B, H, L, st, s);
    case 48: return launch<48>(q, k, v, o, dout, lse, dq, dk, dv, delta, B, H, L, st, s);
    case 64: return launch<64>(q, k, v, o, dout, lse, dq, dk, dv, delta, B, H, L, st, s);
    case 80: return launch<80>(q, k, v, o, dout, lse, dq, dk, dv, delta, B, H, L, st, s);
    case 96: return launch<96>(q, k, v, o, dout, lse, dq, dk, dv, delta, B, H, L, st, s);
    case 112: return launch<112>(q, k, v, o, dout, lse, dq, dk, dv, delta, B, H, L, st, s);
    case 128: return launch<128>(q, k, v, o, dout, lse, dq, dk, dv, delta, B, H, L, st, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* flash_attn_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
