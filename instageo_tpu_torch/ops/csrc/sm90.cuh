// Hopper (sm_90a) building blocks in inline PTX, shared by the port's kernels:
// mbarriers with phase parity, TMA tensor loads, bulk copies and bulk f32
// reduce-adds, wgmma shared-memory descriptors and the wgmma instructions,
// fences, named barriers and register reallocation; on the host, the
// tensor-map encoder.
//
// Conventions:
// - An mbarrier's phase starts at 0. mbar_wait(bar, parity) returns once the
//   phase of that parity has completed: a consumer of a ring stage waits on its
//   "full" barrier with parity (round & 1), a producer on its "empty" barrier
//   with parity (round & 1) ^ 1, so that the first round passes at once.
// - Descriptors (make_desc) take byte offsets; a tile loaded by TMA with an
//   N-byte swizzle is read by wgmma with the matching layout (kSwizzle128,
//   kSwizzle32) and must start on an N*8-byte boundary.
// - wgmma accumulator layout (m64nN, f32): thread t of the warpgroup holds rows
//   16*(t/32) + (t%32)/4 and that + 8, columns 8*j + 2*(t%4) + {0, 1}; register
//   4*j + {0, 1} is the first row, 4*j + {2, 3} the second. The register A
//   fragment of one k16 step is the same rows with columns 2*(t%4) + {0, 1}
//   (a[0], a[1]: rows r, r + 8) and 8 + 2*(t%4) + {0, 1} (a[2], a[3]), so the
//   accumulator of a 16-column slice, packed to bf16, is an A fragment.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

// wgmma descriptor layout types (bits 62-63; 2 is the 64-byte swizzle).
constexpr uint32_t kSwizzle128 = 1;
constexpr uint32_t kSwizzle32 = 3;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers ---------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(arrivals)
               : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA); follow with
// a __syncthreads() before any thread uses them.
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// One arrival that also announces `bytes` of TMA traffic to wait for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// ---- TMA ---------------------------------------------------------------

// Copies one box of a 4-D tensor map, at coordinates (c0 innermost .. c3), into
// shared memory; completion is counted in bytes on `bar`. Elements outside
// the tensor arrive as zeros.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_addr(bar))
      : "memory");
}

// Copies `bytes` (a multiple of 16, both addresses 16-byte aligned) of
// contiguous global memory into shared memory; completion is counted in bytes
// on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes),
      "r"(smem_addr(bar))
      : "memory");
}

// Adds `bytes` (a multiple of 16, both addresses 16-byte aligned) of f32 from
// shared memory into global memory, element by element, atomically with
// respect to other reductions; tracked by the issuing thread's bulk groups.
__device__ __forceinline__ void bulk_reduce_add_f32(float* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], [%1], %2;\n"
               ::"l"(reinterpret_cast<uint64_t>(dst)), "r"(smem_addr(src)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Waits until at most N of the calling thread's bulk groups still read their
// shared-memory source.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// Makes this thread's ordinary shared-memory writes visible to the async
// proxy (wgmma operands read from shared memory, bulk copies).
__device__ __forceinline__ void fence_proxy_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- wgmma -------------------------------------------------------------

// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets (LBO, SBO; 16-byte units in the descriptor) and layout type. For a
// swizzled K-major operand SBO is the distance between 8-row groups; for a
// swizzled MN-major operand SBO is the distance between 8-deep k groups and
// LBO between swizzle-wide MN blocks.
__device__ __forceinline__ uint64_t make_desc(const void* p, uint32_t lbo_bytes,
                                              uint32_t sbo_bytes, uint32_t layout) {
  uint64_t d = (smem_addr(p) & 0x3FFFF) >> 4;
  d |= static_cast<uint64_t>((lbo_bytes >> 4) & 0x3FFF) << 16;
  d |= static_cast<uint64_t>((sbo_bytes >> 4) & 0x3FFF) << 32;
  d |= static_cast<uint64_t>(layout) << 62;
  return d;
}

// Moves a descriptor's start address by `bytes` (a multiple of 16).
__device__ __forceinline__ uint64_t desc_advance(uint64_t desc, uint32_t bytes) {
  return desc + (bytes >> 4);
}

// Orders register and shared-memory writes before the next wgmma reads them.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Waits until at most N committed wgmma groups of this warpgroup are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accesses of an accumulator register across
// the wgmma calls around it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Named barriers (ids 1-15; 0 is __syncthreads): `threads` of the CTA, a
// multiple of 32, take part; bar_arrive signals without waiting.
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Register budget of the calling warpgroup (a multiple of 8 in [24, 256]).
template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

// 2^x on the special-function unit (flushes results below 2^-126 to 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---- wgmma instructions (bf16 in, f32 accumulators) -----------------------

// D(64 x 128, f32) {=, +=} A(64 x 16) * B(16 x 128), A and B bf16 in shared memory
// (descriptors); scale_d = 0 overwrites D. TransB = 1 reads B MN-major.
template <int TransB>
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t desc_a,
                                                   uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TransB));
}

// D(64 x 64, f32) += A(64 x 16, bf16 in registers) * B(16 x 64, bf16 in shared
// memory). TransB = 1 reads B MN-major.
template <int TransB>
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1), "n"(TransB));
}

// D(64 x 16, f32) += A(64 x 16, bf16 in registers) * B(16 x 16, bf16 in shared
// memory). TransB = 1 reads B MN-major.
template <int TransB>
__device__ __forceinline__ void wgmma_m64n16k16_rs(float (&d)[8], const uint32_t (&a)[4],
                                                   uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1), "n"(TransB));
}

// D(64 x N, f32) {=, +=} A(64 x 16) * B(16 x N), A and B bf16 in shared memory;
// scale_d = 0 overwrites D. TransA = 1 reads A MN-major (M contiguous),
// TransB = 1 reads B MN-major (N contiguous).
template <int TransA, int TransB>
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t desc_a,
                                                  uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TransA), "n"(TransB));
}

template <int TransA, int TransB>
__device__ __forceinline__ void wgmma_m64n32k16_ss(float (&d)[16], uint64_t desc_a,
                                                  uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TransA), "n"(TransB));
}

template <int TransA, int TransB>
__device__ __forceinline__ void wgmma_m64n16k16_ss(float (&d)[8], uint64_t desc_a,
                                                  uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, %11, %12;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TransA), "n"(TransB));
}

// ---- host side: tensor maps ---------------------------------------------

// Error codes of the C entries besides cudaError_t values (which are >= 0).
constexpr int kErrNoEncoder = -1;    // cuTensorMapEncodeTiled not found
constexpr int kErrEncode = -2;       // the driver refused a tensor map
constexpr int kErrDescription = -3;  // the boxes do not match the kernel

// Fields of one operand's tensor-map description (ops/attention.py:
// tma_description): dims (Dh, L, H, B), byte strides of L, H and B, the number
// of boxes, then (first column, columns, swizzle bytes) of each, room for two.
constexpr int kMapFields = 14;

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, reached through the runtime so that a library built
// by nvcc alone needs no link against libcuda.
inline EncodeTiledFn encoder() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess && p != nullptr) {
      fn = reinterpret_cast<EncodeTiledFn>(p);
    }
  }
  return fn;
}

// The boxes the Dh 64 / 80 kernels load: columns 0-63 under a 128-byte
// swizzle, and for Dh = 80 columns 64-79 under a 32-byte swizzle.
inline bool boxes_match(int D, const long long* f) {
  const long long wide[3] = {0, 64, 128}, narrow[3] = {64, 16, 32};
  const int boxes = D == 80 ? 2 : 1;
  if (f[0] != D || f[7] != boxes) return false;
  for (int i = 0; i < 3; ++i) {
    if (f[8 + i] != wide[i]) return false;
    if (boxes == 2 && f[11 + i] != narrow[i]) return false;
  }
  return true;
}

// One bf16 operand's tensor map for box `box` of its description `f`, `rows`
// rows per box.
inline int encode(CUtensorMap* map, const void* base, const long long* f, int box, int rows) {
  const EncodeTiledFn fn = encoder();
  if (fn == nullptr) return kErrNoEncoder;
  const cuuint64_t dims[4] = {(cuuint64_t)f[0], (cuuint64_t)f[1], (cuuint64_t)f[2],
                              (cuuint64_t)f[3]};
  const cuuint64_t strides[3] = {(cuuint64_t)f[4], (cuuint64_t)f[5], (cuuint64_t)f[6]};
  const cuuint32_t box_dim[4] = {(cuuint32_t)f[9 + 3 * box], (cuuint32_t)rows, 1, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  // boxes_match allows the swizzles 128 (wide box) and 32 (narrow box).
  const CUtensorMapSwizzle mode =
      f[10 + 3 * box] == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                        strides, box_dim, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, mode,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncode;
}

inline const char* error_string(int err) {
  switch (err) {
    case kErrNoEncoder: return "cuTensorMapEncodeTiled not found in the CUDA driver";
    case kErrEncode: return "cuTensorMapEncodeTiled refused a tensor map";
    case kErrDescription: return "the tensor-map description does not match the kernel";
    default: return cudaGetErrorString(static_cast<cudaError_t>(err));
  }
}

}  // namespace sm90
