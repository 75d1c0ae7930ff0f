// The fused dropout's earlier design (4 elements per thread and step, one
// Philox call each), kept out of the package for timing beside the kernel
// of instageo_tpu_torch/ops/csrc/dropout.cu (8 elements per thread). Copied
// from that file as it stood before the design left it: the same Philox
// stream, so the same mask and output for a seed; the seed by value only,
// no element offset. Built and timed by tools/profile_dropout_designs.py.

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

__device__ __forceinline__ uint4 bits_of_group(unsigned long long grp, uint2 key) {
  return philox4x32_10(make_uint4((uint32_t)grp, (uint32_t)(grp >> 32), 0u, 0u), key);
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

template <typename T, int N>
struct alignas(N * sizeof(T) < 16 ? N * sizeof(T) : 16) Vec {
  T v[N];
};

template <typename T>
__device__ __forceinline__ T dropped(T x, uint32_t bits, uint32_t threshold, float scale) {
  return from_float<T>(bits >= threshold ? to_float(x) * scale : 0.f);
}

// The earlier design: 4 elements (one Philox call) per thread and step.
template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_dropout_x4_kernel(const T* __restrict__ x, T* __restrict__ out,
                        uint8_t* __restrict__ mask, long long n, uint32_t threshold,
                        float scale, uint2 key, bool vec) {
  const long long groups = (n + 3) / 4;
  for (long long grp = (long long)blockIdx.x * kThreads + threadIdx.x; grp < groups;
       grp += (long long)gridDim.x * kThreads) {
    const uint4 r = bits_of_group(grp, key);
    const uint32_t bits[4] = {r.x, r.y, r.z, r.w};
    const long long i0 = grp * 4;
    if (vec && i0 + 4 <= n) {
      const Vec<T, 4> xv = *reinterpret_cast<const Vec<T, 4>*>(x + i0);
      Vec<T, 4> ov;
      uchar4 mv;
      uint8_t* m = reinterpret_cast<uint8_t*>(&mv);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        ov.v[e] = dropped(xv.v[e], bits[e], threshold, scale);
        m[e] = bits[e] >= threshold;
      }
      *reinterpret_cast<Vec<T, 4>*>(out + i0) = ov;
      *reinterpret_cast<uchar4*>(mask + i0) = mv;
    } else {
      for (int e = 0; e < 4 && i0 + e < n; ++e) {
        out[i0 + e] = dropped(x[i0 + e], bits[e], threshold, scale);
        mask[i0 + e] = bits[e] >= threshold;
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, void* out, void* mask, long long n, uint32_t threshold,
                   float scale, unsigned long long seed, bool vec, cudaStream_t stream) {
  const uint2 key = make_uint2((uint32_t)seed, (uint32_t)(seed >> 32));
  const long long blocks = ((n + 3) / 4 + kThreads - 1) / kThreads;
  const int grid = (int)(blocks < (1 << 20) ? blocks : (1 << 20));
  fused_dropout_x4_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), static_cast<uint8_t*>(mask), n, threshold,
      scale, key, vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The arguments of ops/csrc/dropout.cu's fused_dropout without the device
// seed and the offset; vec != 0 promises x, out and mask aligned for
// 4-element vectors.
int fused_dropout_x4(int dtype, const void* x, void* out, void* mask, long long n,
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

}  // extern "C"
