// Fused dropout for Hopper (sm_90a): random bits, keep mask and scaled output
// in one pass over x; bf16 or f32 in, the same type out, one mask byte per
// element.
//
// Replaces the Pallas TPU kernel instageo_tpu/ops/dropout.py:_dropout_kernel
// (the core-local PRNG there; Philox4x32-10 here). Per element i of x:
//   bits = 32-bit word i % 4 of Philox4x32-10(counter = (i / 4 as (lo, hi), 0, 0),
//                                             key = seed as (lo, hi))
//   keep = bits >= threshold,   threshold = min(round(p * 2^32), 2^32 - 1)
//   out  = keep ? T(f32(x) * scale) : 0,   scale = f32(1 / (1 - p))
//   mask = keep
// exactly _mask_and_scale of the TPU kernel. The stream is a function of
// (seed, element index) only, so any grid and any vector width give the same
// mask for a seed (ops/dropout.py:philox_bits is the same stream in plain
// PyTorch); it is not JAX's stream.
//
// Bound: bytes. Each element reads x once and writes out and one mask byte,
// 5 bytes in bf16: 57.8 M elements (the head's largest tensor at batch 8,
// (8, 144, 224, 224)) take 86 us at 3.35 TB/s.
//
// Design: a thread takes 8 neighbouring elements, the bits of two Philox
// calls on consecutive counters: 16-byte loads and stores of bf16 (two of
// each for f32) and one 8-byte mask store, where the pointers allow it; the
// load is issued before the Philox rounds, which hide its latency. One unit
// per thread, up to 2^20 blocks (a grid-stride loop beyond); a grid of one
// wave striding over the tensor was slower at the largest tensor on an H100.
// (The earlier design, 4 elements per thread, was timed beside it; its source
// is tools/dropout_x4.cu at commit 0cdc76a.)
// The seed arrives by value, or, for a launch recorded into a CUDA graph,
// as a pointer to a 64-bit word in device memory that the kernel reads when
// it starts: each replay of the graph then takes the seed the host wrote
// there before it, so the graph does not replay one mask. The word holds
// the same 64 bits as the by-value seed and gives the same stream.
// An element offset (fused_dropout's `offset`) shifts the stream: element i of
// x takes element offset + i's bits, so a rank that holds rows r.. of a batch
// draws the mask those rows get in the whole batch. Offsets that are
// multiples of 8 keep the 8-element units on whole Philox calls; any other
// offset runs element by element (one Philox call per element).
// The kernels allocate nothing; the caller allocates out and mask.

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

template <typename T>
__device__ __forceinline__ void drop8(const Vec<T, 8>& xv, T* out, uint8_t* mask, long long u,
                                      unsigned long long g0, uint32_t threshold, float scale,
                                      uint2 key) {
  const unsigned long long g = 2ull * (u + g0);
  const uint4 r0 = bits_of_group(g, key), r1 = bits_of_group(g + 1, key);
  const uint32_t bits[8] = {r0.x, r0.y, r0.z, r0.w, r1.x, r1.y, r1.z, r1.w};
  Vec<T, 8> ov;
  uint2 mv;
  uint8_t* m = reinterpret_cast<uint8_t*>(&mv);
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    ov.v[e] = dropped(xv.v[e], bits[e], threshold, scale);
    m[e] = bits[e] >= threshold;
  }
  *reinterpret_cast<Vec<T, 8>*>(out + 8 * u) = ov;
  *reinterpret_cast<uint2*>(mask + 8 * u) = mv;
}

__device__ __forceinline__ uint32_t bits_of_element(unsigned long long e, uint2 key) {
  const uint4 r = bits_of_group(e >> 2, key);
  const uint32_t w = (uint32_t)(e & 3);
  return w == 0 ? r.x : w == 1 ? r.y : w == 2 ? r.z : r.w;
}

// 8 elements (a unit) per thread and step; `vec` promises x and out 16-byte
// aligned and mask 8-byte aligned. Whole units go through vectors (where the
// offset is a multiple of 8); the last partial unit, or every unit without
// `vec`, element by element.
template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_dropout_kernel(const T* __restrict__ x, T* __restrict__ out, uint8_t* __restrict__ mask,
                     long long n, uint32_t threshold, float scale, uint2 key,
                     const unsigned long long* __restrict__ seed_ptr,
                     unsigned long long offset, bool vec) {
  if (seed_ptr != nullptr) {  // the seed from device memory
    const unsigned long long seed = __ldg(seed_ptr);
    key = make_uint2((uint32_t)seed, (uint32_t)(seed >> 32));
  }
  const bool whole = (offset & 7) == 0;
  const unsigned long long g0 = offset >> 3;
  const long long units = (n + 7) / 8;
  for (long long u = (long long)blockIdx.x * kThreads + threadIdx.x; u < units;
       u += (long long)gridDim.x * kThreads) {
    if (vec && whole && 8 * u + 8 <= n) {
      const Vec<T, 8> xv = reinterpret_cast<const Vec<T, 8>*>(x)[u];  // load before the bits
      drop8(xv, out, mask, u, g0, threshold, scale, key);
      continue;
    }
    if (!whole) {
      for (int e = 0; e < 8; ++e) {
        const long long i = 8 * u + e;
        if (i < n) {
          const uint32_t b = bits_of_element(offset + i, key);
          out[i] = dropped(x[i], b, threshold, scale);
          mask[i] = b >= threshold;
        }
      }
      continue;
    }
    const unsigned long long g = 2ull * (u + g0);
    const uint4 r0 = bits_of_group(g, key), r1 = bits_of_group(g + 1, key);
    const uint32_t bits[8] = {r0.x, r0.y, r0.z, r0.w, r1.x, r1.y, r1.z, r1.w};
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const long long i = 8 * u + e;
      if (i < n) {
        out[i] = dropped(x[i], bits[e], threshold, scale);
        mask[i] = bits[e] >= threshold;
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, void* out, void* mask, long long n, uint32_t threshold,
                   float scale, unsigned long long seed, const unsigned long long* seed_ptr,
                   unsigned long long offset, bool vec, cudaStream_t stream) {
  const uint2 key = make_uint2((uint32_t)seed, (uint32_t)(seed >> 32));
  const long long blocks = ((n + 7) / 8 + kThreads - 1) / kThreads;
  const int grid = (int)(blocks < (1 << 20) ? blocks : (1 << 20));
  fused_dropout_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), static_cast<uint8_t*>(mask), n, threshold,
      scale, key, seed_ptr, offset, vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x, out: n contiguous elements of type `dtype` (0: float32, 1: bfloat16);
// mask: n bytes (0 or 1). seeds: null, and the stream's key is `seed`; or
// device memory holding 64-bit seeds, and the kernel reads seeds[slot] when
// it runs (`seed` unused). Element i takes the stream's element offset + i.
// vec != 0 promises that x and out are 16-byte
// aligned and mask 8-byte aligned. Returns the launch's CUDA error
// code (0 on success); n == 0 launches nothing; another dtype returns
// cudaErrorInvalidValue.
int fused_dropout(int dtype, const void* x, void* out, void* mask, long long n,
                  unsigned int threshold, float scale, unsigned long long seed,
                  const unsigned long long* seeds, int slot, unsigned long long offset, int vec,
                  void* stream) {
  if (n <= 0) return 0;
  const unsigned long long* seed_ptr = seeds == nullptr ? nullptr : seeds + slot;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(x, out, mask, n, threshold, scale, seed, seed_ptr, offset, vec != 0,
                           s);
    case 1:
      return launch<__nv_bfloat16>(x, out, mask, n, threshold, scale, seed, seed_ptr, offset,
                                   vec != 0, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* fused_dropout_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
