// Fused dropout for Hopper (sm_90a): random bits, keep mask and scaled output
// in one pass over x; bf16 or f32 in, the same type out, one mask byte per
// element.
//
// Replaces the Pallas TPU kernel instageo_tpu/ops/dropout.py:_dropout_kernel
// (the core-local PRNG there; Philox4x32-10 here). Per element i of x:
//   bits = 32-bit word i % 4 of Philox4x32-10(counter = i / 4, key = seed)
//   keep = bits >= threshold,   threshold = min(round(p * 2^32), 2^32 - 1)
//   out  = keep ? T(f32(x) * scale) : 0,   scale = f32(1 / (1 - p))
//   mask = keep
// exactly _mask_and_scale of the TPU kernel. The stream is a function of
// (seed, element index) only, so any grid gives the same mask for a seed, as
// the TPU kernel's per-block seeding does; it is not JAX's stream.
//
// Bound: bytes. Each element reads x once and writes out and one mask byte,
// 5 bytes in bf16: 57.8 M elements (the head's largest tensor at batch 8,
// (8, 144, 224, 224)) take 86 us at 3.35 TB/s. One Philox call gives the
// bits of four neighbouring elements, which a thread loads and stores as one
// vector (8 or 16 bytes of x, 4 of mask) when the pointers allow it. The
// kernel allocates nothing; the caller allocates out and mask.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 key) {
  constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
  constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    const uint32_t hi0 = __umulhi(kM0, c.x), lo0 = kM0 * c.x;
    const uint32_t hi1 = __umulhi(kM1, c.z), lo1 = kM1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ key.x, lo1, hi0 ^ c.w ^ key.y, lo0);
    key.x += kW0;
    key.y += kW1;
  }
  return c;
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
struct alignas(4 * sizeof(T)) Vec4 {
  T v[4];
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_dropout_kernel(const T* __restrict__ x, T* __restrict__ out, uint8_t* __restrict__ mask,
                     long long n, uint32_t threshold, float scale, uint2 key, bool vec) {
  const long long groups = (n + 3) / 4;
  for (long long grp = (long long)blockIdx.x * kThreads + threadIdx.x; grp < groups;
       grp += (long long)gridDim.x * kThreads) {
    const uint4 r = philox4x32_10(
        make_uint4((uint32_t)grp, (uint32_t)((unsigned long long)grp >> 32), 0u, 0u), key);
    const uint32_t bits[4] = {r.x, r.y, r.z, r.w};
    const long long i0 = grp * 4;
    if (vec && i0 + 4 <= n) {
      const Vec4<T> xv = *reinterpret_cast<const Vec4<T>*>(x + i0);
      Vec4<T> ov;
      uchar4 mv;
      uint8_t* m = reinterpret_cast<uint8_t*>(&mv);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool keep = bits[e] >= threshold;
        ov.v[e] = from_float<T>(keep ? to_float(xv.v[e]) * scale : 0.f);
        m[e] = keep;
      }
      *reinterpret_cast<Vec4<T>*>(out + i0) = ov;
      *reinterpret_cast<uchar4*>(mask + i0) = mv;
    } else {
      for (int e = 0; e < 4 && i0 + e < n; ++e) {
        const bool keep = bits[e] >= threshold;
        out[i0 + e] = from_float<T>(keep ? to_float(x[i0 + e]) * scale : 0.f);
        mask[i0 + e] = keep;
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, void* out, void* mask, long long n, uint32_t threshold,
                   float scale, unsigned long long seed, bool vec, cudaStream_t stream) {
  const long long groups = (n + 3) / 4;
  const long long blocks = (groups + kThreads - 1) / kThreads;
  const int grid = (int)(blocks < (1 << 20) ? blocks : (1 << 20));
  const uint2 key = make_uint2((uint32_t)seed, (uint32_t)(seed >> 32));
  fused_dropout_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), static_cast<uint8_t*>(mask), n,
      threshold, scale, key, vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x, out: n contiguous elements of type `dtype` (0: float32, 1: bfloat16);
// mask: n bytes (0 or 1). vec != 0 promises that x, out and mask are aligned
// for 4-element vectors. Returns the launch's CUDA error code (0 on success);
// n == 0 launches nothing; another dtype returns cudaErrorInvalidValue.
int fused_dropout(int dtype, const void* x, void* out, void* mask, long long n,
                  unsigned int threshold, float scale, unsigned long long seed, int vec,
                  void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(x, out, mask, n, threshold, scale, seed, vec != 0, s);
    case 1: return launch<__nv_bfloat16>(x, out, mask, n, threshold, scale, seed, vec != 0, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* fused_dropout_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
