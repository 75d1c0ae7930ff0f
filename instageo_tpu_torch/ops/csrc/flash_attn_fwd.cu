// Flash-attention forward for Hopper (sm_90a), bf16 in, bf16 out, f32 lse.
//
// Replaces the Pallas TPU kernels instageo_tpu/ops/attention.py:_attn_kernel_blo
// (merged-heads output, (B, L, H*Dh)) and instageo_tpu/ops/attention.py:_attn_kernel
// (heads-first output, (B, H, L, Dh)). One kernel serves both: the caller passes
// the output strides, so the merged layout is only a different column offset.
//
// Math (per (b, h) pair, online-softmax form of the TPU kernel's single pass):
//   S = Q K^T             bf16 products, f32 accumulation (mma.sync m16n8k16)
//   S = S * (1/sqrt(Dh))  scale on the f32 scores, as the TPU kernel does
//   m = running row max, l = running row sum of exp(S - m), both f32
//   O = O * exp(m_old - m_new) + bf16(P) V
//   O = O / l, cast to bf16;  lse = m + log(l) in f32
//
// Layout: one thread block of 4 warps per (64-row q tile, head, batch). Each
// warp owns 16 q rows and keeps its scores, probabilities and output
// accumulator in registers (the mma.sync accumulator layout is used directly
// as the A operand of the PV product). K and V tiles of 64 keys are staged in
// shared memory, row-major, two of each: while the warps multiply one tile,
// cp.async brings in the next. Fragments come from shared memory by ldmatrix
// (V's transposed, so V needs no transposing copy). Keys past L are zero-filled
// and masked to -inf before the row max; q rows past L are computed on zeros
// and not stored. Dh must be a multiple of 16 (Dh=80 is five 16-wide k-steps),
// at most 128.
//
// Bound at the serving shape (B=64, H=12, L=589, Dh=64): 4*B*H*L^2*Dh = 68.2
// GFLOP (69 us at 989 TFLOP/s bf16) against q, k, v, O in bf16 plus lse in f32,
// 233.4 MB (70 us at 3.35 TB/s): a balanced shape, bound by bytes by a hair.
// mma.sync reaches only part of the tensor cores' wgmma rate, and the softmax's
// exponentials run on the SFUs between the two products; TMA, wgmma and warp
// specialisation are the next steps. The kernel allocates nothing; the caller
// allocates O and lse.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockM = 64;  // q rows per block, 16 per warp
constexpr int kBlockN = 64;  // keys per K/V tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;  // bf16 elements of padding per shared-memory row
static_assert(kBlockM == kBlockN, "load_tile stages Q, K and V tiles of the same height");

struct Strides {
  // Element strides of the (batch, head, row) dims; the last dim is contiguous.
  long long qb, qh, ql;
  long long kb, kh, kl;
  long long vb, vh, vl;
  long long ob, oh, ol;
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

// 16 bytes global -> shared without passing through registers; zero-fills
// when !valid (then nothing is read).
__device__ __forceinline__ void cp_async16(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0)
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
  for (int i = threadIdx.x; i < kBlockM * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const bool valid = row0 + r < L;
    cp_async16(dst + r * (D + kPad) + c * 8,
               src + (long long)(valid ? row0 + r : 0) * row_stride + c * 8, valid);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_attn_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                      float* __restrict__ lse, int H, int L, float scale, Strides st) {
  constexpr int kRow = D + kPad;         // shared row stride of every tile
  constexpr int kTile = kBlockN * kRow;  // elements of one staged tile
  constexpr int kSteps = D / 16;         // k-steps of the QK^T product
  constexpr int kOTiles = D / 8;         // 8-wide n-tiles of the output
  constexpr int kSTiles = kBlockN / 8;   // 8-wide n-tiles of the scores

  extern __shared__ uint4 smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + kTile;       // two K tiles
  __nv_bfloat16* vs = ks + 2 * kTile;   // two V tiles

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row group / column pair
  const int mat = lane / 8, mrow = lane % 8;  // ldmatrix: this lane's matrix and row
  const int q0 = blockIdx.x * kBlockM;
  const int h = blockIdx.y, b = blockIdx.z;
  const int num_tiles = (L + kBlockN - 1) / kBlockN;

  const __nv_bfloat16* qp = q + b * st.qb + h * st.qh;
  const __nv_bfloat16* kp = k + b * st.kb + h * st.kh;
  const __nv_bfloat16* vp = v + b * st.vb + h * st.vh;

  load_tile<D>(qs, qp, st.ql, q0, L);
  load_tile<D>(ks, kp, st.kl, 0, L);
  load_tile<D>(vs, vp, st.vl, 0, L);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  // This warp's 16 q rows as mma A fragments, for every k-step.
  const int wr = warp * 16;
  uint32_t qf[kSteps][4];
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    ldmatrix_x4(qf[s], qs + (wr + mrow + (mat % 2) * 8) * kRow + s * 16 + (mat / 2) * 8);
  }

  float oacc[kOTiles][4];
#pragma unroll
  for (int j = 0; j < kOTiles; ++j) oacc[j][0] = oacc[j][1] = oacc[j][2] = oacc[j][3] = 0.f;
  // Row statistics of rows g and g + 8 of this warp's 16. The sums are partial
  // (this thread's columns only) until the end.
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int it = 0; it < num_tiles; ++it) {
    const int n0 = it * kBlockN;
    const __nv_bfloat16* kt = ks + (it & 1) * kTile;
    const __nv_bfloat16* vt = vs + (it & 1) * kTile;
    if (it + 1 < num_tiles) {  // prefetch the next tile into the other buffers
      load_tile<D>(ks + ((it + 1) & 1) * kTile, kp, st.kl, n0 + kBlockN, L);
      load_tile<D>(vs + ((it + 1) & 1) * kTile, vp, st.vl, n0 + kBlockN, L);
    }
    cp_async_commit();

    float sacc[kSTiles][4];
#pragma unroll
    for (int j = 0; j < kSTiles; ++j) sacc[j][0] = sacc[j][1] = sacc[j][2] = sacc[j][3] = 0.f;
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
#pragma unroll
      for (int j = 0; j < kSTiles; j += 2) {
        // B fragments (k rows 2t.., key g) of key n-tiles j and j + 1.
        uint32_t kf[4];
        ldmatrix_x4(kf, kt + ((j + mat / 2) * 8 + mrow) * kRow + s * 16 + (mat % 2) * 8);
        mma_16816(sacc[j], qf[s], kf[0], kf[1]);
        mma_16816(sacc[j + 1], qf[s], kf[2], kf[3]);
      }
    }

    float mx0 = -INFINITY, mx1 = -INFINITY;
    const bool tail = n0 + kBlockN > L;
#pragma unroll
    for (int j = 0; j < kSTiles; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool valid = !tail || n0 + j * 8 + 2 * t + e < L;
        sacc[j][e] = valid ? sacc[j][e] * scale : -INFINITY;
        sacc[j][2 + e] = valid ? sacc[j][2 + e] * scale : -INFINITY;
        mx0 = fmaxf(mx0, sacc[j][e]);
        mx1 = fmaxf(mx1, sacc[j][2 + e]);
      }
    }
    // The four threads of a row group hold the row's columns between them.
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    // Every tile holds at least one key below L, so the new max is finite.
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float a0 = expf(m0 - mn0), a1 = expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;

    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int j = 0; j < kSTiles; ++j) {
      sacc[j][0] = expf(sacc[j][0] - mn0);
      sacc[j][1] = expf(sacc[j][1] - mn0);
      sacc[j][2] = expf(sacc[j][2] - mn1);
      sacc[j][3] = expf(sacc[j][3] - mn1);
      rs0 += sacc[j][0] + sacc[j][1];
      rs1 += sacc[j][2] + sacc[j][3];
    }
    l0 = l0 * a0 + rs0;
    l1 = l1 * a1 + rs1;
#pragma unroll
    for (int j = 0; j < kOTiles; ++j) {
      oacc[j][0] *= a0;
      oacc[j][1] *= a0;
      oacc[j][2] *= a1;
      oacc[j][3] *= a1;
    }

    // O += bf16(P) V: the score accumulators of n-tiles 2s and 2s+1 are the A
    // fragment of k-step s.
#pragma unroll
    for (int s = 0; s < kBlockN / 16; ++s) {
      const uint32_t pa[4] = {
          pack_bf16(sacc[2 * s][0], sacc[2 * s][1]),
          pack_bf16(sacc[2 * s][2], sacc[2 * s][3]),
          pack_bf16(sacc[2 * s + 1][0], sacc[2 * s + 1][1]),
          pack_bf16(sacc[2 * s + 1][2], sacc[2 * s + 1][3]),
      };
#pragma unroll
      for (int j = 0; j < kOTiles; j += 2) {
        // B fragments (keys 2t.., column g) of output n-tiles j and j + 1.
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, vt + (s * 16 + (mat % 2) * 8 + mrow) * kRow + (j + mat / 2) * 8);
        mma_16816(oacc[j], pa, vf[0], vf[1]);
        mma_16816(oacc[j + 1], pa, vf[2], vf[3]);
      }
    }
    cp_async_wait_all();  // the next tile has landed ...
    __syncthreads();      // ... for every warp, and this one is free to refill
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);

  const int r0 = q0 + wr + g, r1 = r0 + 8;
  __nv_bfloat16* op = o + b * st.ob + h * st.oh;
  if (r0 < L) {
    __nv_bfloat16* row = op + r0 * st.ol + 2 * t;
#pragma unroll
    for (int j = 0; j < kOTiles; ++j) {
      *reinterpret_cast<uint32_t*>(row + j * 8) = pack_bf16(oacc[j][0] / l0, oacc[j][1] / l0);
    }
    if (t == 0) lse[((long long)b * H + h) * L + r0] = m0 + logf(l0);
  }
  if (r1 < L) {
    __nv_bfloat16* row = op + r1 * st.ol + 2 * t;
#pragma unroll
    for (int j = 0; j < kOTiles; ++j) {
      *reinterpret_cast<uint32_t*>(row + j * 8) = pack_bf16(oacc[j][2] / l1, oacc[j][3] / l1);
    }
    if (t == 0) lse[((long long)b * H + h) * L + r1] = m1 + logf(l1);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* lse, int B,
                   int H, int L, const Strides& st, cudaStream_t stream) {
  // One Q tile plus two K and two V tiles.
  const int smem = 5 * kBlockN * (D + kPad) * (int)sizeof(__nv_bfloat16);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attn_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((L + kBlockM - 1) / kBlockM, H, B);
  const float scale = (float)(1.0 / sqrt((double)D));
  flash_attn_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), H, L, scale, st);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v: (B, H, L, D) bf16 with the given element strides of the first three
// dims and a contiguous last dim; every pointer 16-byte aligned and every
// stride a multiple of 8. o: bf16 at the given output strides (merged or
// heads-first). lse: (B, H, L) f32, contiguous. Returns the launch's CUDA error
// code (0 on success); D outside {16, 32, ..., 128} returns
// cudaErrorInvalidValue without launching.
int flash_attn_fwd_bf16(const void* q, const void* k, const void* v, void* o, void* lse, int B,
                        int H, int L, int D, int sqb, int sqh, int sql, int skb, int skh, int skl,
                        int svb, int svh, int svl, int sob, int soh, int sol, void* stream) {
  const Strides st{sqb, sqh, sql, skb, skh, skl, svb, svh, svl, sob, soh, sol};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<16>(q, k, v, o, lse, B, H, L, st, s);
    case 32: return launch<32>(q, k, v, o, lse, B, H, L, st, s);
    case 48: return launch<48>(q, k, v, o, lse, B, H, L, st, s);
    case 64: return launch<64>(q, k, v, o, lse, B, H, L, st, s);
    case 80: return launch<80>(q, k, v, o, lse, B, H, L, st, s);
    case 96: return launch<96>(q, k, v, o, lse, B, H, L, st, s);
    case 112: return launch<112>(q, k, v, o, lse, B, H, L, st, s);
    case 128: return launch<128>(q, k, v, o, lse, B, H, L, st, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* flash_attn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
