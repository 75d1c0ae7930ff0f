// The encoder blocks' LayerNorm for Hopper (sm_90a): bf16 in, bf16 out,
// float32 arithmetic in registers, forward and backward.
//
// Replaces no TPU kernel: the JAX package leaves LayerNorm to XLA, which
// fuses the float32 casts into it. In eager PyTorch the same math was a cast
// to float32, a float32 op and a cast back, each through device memory (about
// 20 bytes per element; 4 bytes here). Every result is rounded to bf16 once,
// at the point where the float32 path rounded it (its `.to(bf16)`), so the
// two differ only by float32 summation order.
//
// Bound: bytes. The forward reads a bf16 element and writes one (4 bytes per
// element, and 8 bytes of statistics per row); the backward reads the
// gradient and the saved input and writes the input's gradient (6 bytes per
// element).
//
// ln_rows_bf16_fwd: one warp per row of D = 8 * 32 * k' elements (k' <= VPL);
// the row is read once with 16-byte loads and kept in registers; the mean and
// then the variance of the deviations (two passes over registers, not
// E[x^2] - E[x]^2) by butterfly shuffles, whose every lane ends on the same
// bits; y = w * (rstd * (x - mean)) + b, as PyTorch's vectorized LayerNorm
// writes it; rstd = rsqrtf(var + eps).
//
// ln_rows_bf16_bwd: one warp per row again, with a fixed share of the rows per
// warp (row = warp's index + k * warps of the grid); dx as PyTorch's LayerNorm
// backward forms it, (rstd / D) * (D * g - xhat * sum(g * xhat) - sum(g)),
// g = dy * w. Each lane sums dy * xhat and dy over its rows and columns in
// registers; the block adds its warps' sums in warp order through shared
// memory and writes one float32 row of partial sums per block.
// ln_rows_bf16_bwd_colsum then adds the blocks' rows in a fixed order. No
// atomics: a shape on one card gives the same bits on every call, captured
// or not. The grid is the card's SM count times the blocks that fit on an SM.
//
// The kernels allocate nothing; the caller allocates outputs and scratch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxVecs = 8;                 // 16-byte vectors per lane: D <= 2048
constexpr int kMaxD = 8 * 32 * kMaxVecs;

__device__ __forceinline__ void unpack(const uint4& u, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ uint4 pack(const float* f) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return u;
}

__device__ __forceinline__ void load8(const float* p, float* f) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Rows of d = 8 * nv bf16 elements; vector j of a row is lane j % 32's k-th,
// k = j / 32 < VPL.
template <int VPL>
__global__ void __launch_bounds__(kThreads)
ln_rows_bf16_fwd(const uint4* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ b, uint4* __restrict__ y,
                 float* __restrict__ mean_out, float* __restrict__ rstd_out, long long rows,
                 int nv, float eps) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const uint4* xr = x + row * nv;
  float v[VPL][8];
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < VPL; ++k) {
    const int j = lane + 32 * k;
    if (j < nv) {
      unpack(xr[j], v[k]);
#pragma unroll
      for (int e = 0; e < 8; ++e) s += v[k][e];
    }
  }
  const float d = (float)(8 * nv);
  const float mean = warp_sum(s) / d;
  float q = 0.f;
#pragma unroll
  for (int k = 0; k < VPL; ++k) {
    if (lane + 32 * k < nv) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float t = v[k][e] - mean;
        q += t * t;
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(q) / d + eps);
  uint4* yr = y + row * nv;
#pragma unroll
  for (int k = 0; k < VPL; ++k) {
    const int j = lane + 32 * k;
    if (j < nv) {
      float wv[8], bv[8], o[8];
      load8(w + 8 * j, wv);
      load8(b + 8 * j, bv);
#pragma unroll
      for (int e = 0; e < 8; ++e) o[e] = wv[e] * (rstd * (v[k][e] - mean)) + bv[e];
      yr[j] = pack(o);
    }
  }
  if (lane == 0) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
}

// At most this many backward blocks of a VPL are resident on one SM (their
// registers: each lane sums 16 * VPL floats besides the row in flight).
#define NORM_ACT_BWD_BLOCKS_PER_SM(V) ((V) <= 1 ? 4 : (V) <= 3 ? 2 : 1)

// partial: (2, gridDim.x, d) float32, this block's sums of dy * xhat (then dy)
// over its rows.
template <int VPL>
__global__ void __launch_bounds__(kThreads, NORM_ACT_BWD_BLOCKS_PER_SM(VPL))
ln_rows_bf16_bwd(const uint4* __restrict__ dy, const uint4* __restrict__ x,
                 const float* __restrict__ mean, const float* __restrict__ rstd,
                 const float* __restrict__ w, uint4* __restrict__ dx,
                 float* __restrict__ partial, long long rows, int nv) {
  __shared__ float s_dw[kMaxD];
  __shared__ float s_db[kMaxD];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int d = 8 * nv;
  const float fd = (float)d;
  float adw[VPL][8], adb[VPL][8];
#pragma unroll
  for (int k = 0; k < VPL; ++k)
#pragma unroll
    for (int e = 0; e < 8; ++e) adw[k][e] = adb[k][e] = 0.f;
  const long long stride = (long long)gridDim.x * kWarps;
  for (long long row = (long long)blockIdx.x * kWarps + warp; row < rows; row += stride) {
    uint4 gv[VPL], xv[VPL];
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
      const int j = lane + 32 * k;
      if (j < nv) {
        gv[k] = dy[row * nv + j];
        xv[k] = x[row * nv + j];
      }
    }
    const float m = mean[row], r = rstd[row];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
      const int j = lane + 32 * k;
      if (j < nv) {
        float g[8], xf[8], wv[8];
        unpack(gv[k], g);
        unpack(xv[k], xf);
        load8(w + 8 * j, wv);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float xh = (xf[e] - m) * r;
          const float gw = g[e] * wv[e];
          s1 += gw;
          s2 += gw * xh;
          adw[k][e] += g[e] * xh;
          adb[k][e] += g[e];
        }
      }
    }
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    const float term = (1.f / fd) * r;
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
      const int j = lane + 32 * k;
      if (j < nv) {
        float g[8], xf[8], wv[8], o[8];
        unpack(gv[k], g);
        unpack(xv[k], xf);
        load8(w + 8 * j, wv);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float xh = (xf[e] - m) * r;
          float t = fd * (g[e] * wv[e]);
          t -= xh * s2;
          t -= s1;
          o[e] = t * term;
        }
        dx[row * nv + j] = pack(o);
      }
    }
  }
  // The block's warps, added in warp order.
  for (int wi = 0; wi < kWarps; ++wi) {
    if (warp == wi) {
#pragma unroll
      for (int k = 0; k < VPL; ++k) {
        const int j = lane + 32 * k;
        if (j < nv) {
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const int c = 8 * j + e;
            s_dw[c] = wi == 0 ? adw[k][e] : s_dw[c] + adw[k][e];
            s_db[c] = wi == 0 ? adb[k][e] : s_db[c] + adb[k][e];
          }
        }
      }
    }
    __syncthreads();
  }
  float* pw = partial + (long long)blockIdx.x * d;
  float* pb = partial + ((long long)gridDim.x + blockIdx.x) * d;
  for (int c = threadIdx.x; c < d; c += kThreads) {
    pw[c] = s_dw[c];
    pb[c] = s_db[c];
  }
}

// dw[c] (c < d) and db[c - d] (d <= c < 2d): the sum over the blocks' partial
// rows, each thread of a column adding every 8th block in block order, then
// the 8 threads' sums added in order.
__global__ void __launch_bounds__(kThreads)
ln_rows_bf16_bwd_colsum(const float* __restrict__ partial, float* __restrict__ dw,
                        float* __restrict__ db, int blocks, int d) {
  __shared__ float s[kWarps][33];
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int col = blockIdx.x * 32 + tx;
  float acc = 0.f;
  if (col < 2 * d) {
    const int which = col >= d, c = col - which * d;
    const float* p = partial + (long long)which * blocks * d + c;
    for (int blk = ty; blk < blocks; blk += kWarps) acc += p[(long long)blk * d];
  }
  s[ty][tx] = acc;
  __syncthreads();
  if (ty == 0 && col < 2 * d) {
    float t = s[0][tx];
#pragma unroll
    for (int i = 1; i < kWarps; ++i) t += s[i][tx];
    if (col < d) dw[col] = t; else db[col - d] = t;
  }
}

int sm_count() {
  int device = 0, sms = 0;
  if (cudaGetDevice(&device) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    return 0;
  return sms;
}

template <int VPL>
int bwd_grid(long long rows) {
  const long long want = (rows + kWarps - 1) / kWarps;
  const long long most = (long long)sm_count() * NORM_ACT_BWD_BLOCKS_PER_SM(VPL);
  return (int)(want < most ? want : most);
}

template <int VPL>
cudaError_t ln_fwd(const void* x, const float* w, const float* b, void* y, float* mean,
                   float* rstd, long long rows, int nv, float eps, cudaStream_t s) {
  const long long blocks = (rows + kWarps - 1) / kWarps;
  ln_rows_bf16_fwd<VPL><<<(unsigned)blocks, kThreads, 0, s>>>(
      static_cast<const uint4*>(x), w, b, static_cast<uint4*>(y), mean, rstd, rows, nv, eps);
  return cudaGetLastError();
}

template <int VPL>
cudaError_t ln_bwd(const void* dy, const void* x, const float* mean, const float* rstd,
                   const float* w, void* dx, float* partial, float* dw, float* db,
                   long long rows, int nv, int blocks, cudaStream_t s) {
  ln_rows_bf16_bwd<VPL><<<blocks, kThreads, 0, s>>>(
      static_cast<const uint4*>(dy), static_cast<const uint4*>(x), mean, rstd, w,
      static_cast<uint4*>(dx), partial, rows, nv);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int d = 8 * nv;
  ln_rows_bf16_bwd_colsum<<<(2 * d + 31) / 32, kThreads, 0, s>>>(partial, dw, db, blocks, d);
  return cudaGetLastError();
}

#define NORM_ACT_BY_VPL(CALL) \
  switch (vpl) {              \
    case 1: CALL(1);          \
    case 2: CALL(2);          \
    case 3: CALL(3);          \
    case 4: CALL(4);          \
    case 5: CALL(5);          \
    case 6: CALL(6);          \
    case 7: CALL(7);          \
    case 8: CALL(8);          \
    default: return (int)cudaErrorInvalidValue; \
  }

}  // namespace

extern "C" {

// Rows of x and y: d contiguous bf16 (d a multiple of 8, at most 2048), the
// rows back to back, 16-byte aligned; w, b: d float32, 16-byte aligned; mean,
// rstd: one float32 per row. Returns the launch's CUDA error
// code (0 on success); rows == 0 launches nothing; another d returns
// cudaErrorInvalidValue.
int ln_rows_bf16_forward(const void* x, const float* w, const float* b, void* y, float* mean,
                         float* rstd, long long rows, int d, float eps, void* stream) {
  if (rows <= 0) return 0;
  if (d <= 0 || d % 8 || d > kMaxD) return (int)cudaErrorInvalidValue;
  const int nv = d / 8, vpl = (nv + 31) / 32;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define NORM_ACT_FWD(V) return (int)ln_fwd<V>(x, w, b, y, mean, rstd, rows, nv, eps, s)
  NORM_ACT_BY_VPL(NORM_ACT_FWD)
#undef NORM_ACT_FWD
}

// The blocks (rows of partial sums) that ln_rows_bf16_backward's scratch holds
// for `rows` rows of width d on the current device: partial is (2, blocks, d)
// float32. 0 for a d the kernels do not take.
int ln_rows_bf16_backward_blocks(long long rows, int d) {
  if (rows <= 0 || d <= 0 || d % 8 || d > kMaxD) return 0;
  const int vpl = (d / 8 + 31) / 32;
#define NORM_ACT_GRID(V) return bwd_grid<V>(rows)
  NORM_ACT_BY_VPL(NORM_ACT_GRID)
#undef NORM_ACT_GRID
}

// dy, x, dx as x above; mean, rstd: the forward's per-row float32 statistics;
// w: d float32; partial: (2, blocks, d) float32 scratch, blocks from
// ln_rows_bf16_backward_blocks; dw, db: d float32 each.
int ln_rows_bf16_backward(const void* dy, const void* x, const float* mean, const float* rstd,
                          const float* w, void* dx, float* partial, float* dw, float* db,
                          long long rows, int d, int blocks, void* stream) {
  if (rows <= 0) return 0;
  if (d <= 0 || d % 8 || d > kMaxD || blocks <= 0) return (int)cudaErrorInvalidValue;
  const int nv = d / 8, vpl = (nv + 31) / 32;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define NORM_ACT_BWD(V) \
  return (int)ln_bwd<V>(dy, x, mean, rstd, w, dx, partial, dw, db, rows, nv, blocks, s)
  NORM_ACT_BY_VPL(NORM_ACT_BWD)
#undef NORM_ACT_BWD
}

const char* norm_act_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
