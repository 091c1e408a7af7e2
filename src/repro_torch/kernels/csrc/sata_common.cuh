// Device helpers shared by the port's CUDA kernels (sata_decode.cu,
// sata_attention.cu): dtype conversions, bf16 rounding, the tensor cores'
// m16n8k16 product and ldmatrix loads, cp.async copies, warp reductions and
// division by a runtime constant.
// Each kernel source includes this header once; kernels/build.py hashes it
// with the source, so an edit here rebuilds both libraries.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1073741824.0f;   // -2^30, the reference's NEG_INF

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float bf16_rn(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// two floats rounded to bf16 (round-to-nearest-even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// D (16x8 fp32) += A (16x16 bf16, row-major) * B (16x8 bf16, column-major)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))));
}

// the same four 8x8 matrices, each transposed on the way into registers
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&a)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// cp.async: `bytes` in {16, 8, 4} are asynchronous; 2 is a plain copy
__device__ __forceinline__ void copy_async(void* dst, const void* src, int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if (bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
  } else if (bytes == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src));
  } else if (bytes == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
  } else {
    *static_cast<uint16_t*>(dst) = *static_cast<const uint16_t*>(src);
  }
}

__device__ __forceinline__ void commit_group() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

#define SATA_WAIT_CASE(n) \
  case n: asm volatile("cp.async.wait_group " #n ";\n" ::: "memory"); break;

// wait until at most n (< 8) of this thread's commit groups are pending
__device__ __forceinline__ void wait_pending(int n) {
  switch (n) {
    SATA_WAIT_CASE(0) SATA_WAIT_CASE(1) SATA_WAIT_CASE(2) SATA_WAIT_CASE(3)
    SATA_WAIT_CASE(4) SATA_WAIT_CASE(5) SATA_WAIT_CASE(6)
    default: asm volatile("cp.async.wait_group 7;\n" ::: "memory");
  }
}
#undef SATA_WAIT_CASE

// n / d for 0 <= n < 2^32 / d, with m = ceil(2^32 / d): the error
// n * (m - 2^32 / d) / 2^32 < 1 / d never reaches the next integer
__device__ __forceinline__ int div_by(int n, unsigned long long m) {
  return static_cast<int>((static_cast<unsigned long long>(n) * m) >> 32);
}
__device__ __forceinline__ unsigned long long div_magic(int d) {
  return (0x100000000ull + d - 1) / d;
}

}  // namespace
