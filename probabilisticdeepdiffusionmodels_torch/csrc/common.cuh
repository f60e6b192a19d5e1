// Helpers shared by the kernels: dtype conversion, the bf16 tensor-core
// product (mma.sync m16n8k16, float32 accumulation), ldmatrix, cp.async and
// the shared-memory limit.
//
// Fragment layout of mma.sync.m16n8k16 (PTX ISA, "Matrix Fragments for
// mma.m16n8k16"), with g = lane / 4 and t = lane % 4:
//   A (16x16, row major), four 32-bit registers of two bf16 each:
//     a[0] = A[g][2t..2t+1]     a[1] = A[g+8][2t..2t+1]
//     a[2] = A[g][2t+8..2t+9]   a[3] = A[g+8][2t+8..2t+9]
//   B (16x8, "col": k pairs packed), two registers:
//     b[0] = B[2t..2t+1][g]     b[1] = B[2t+8..2t+9][g]
//   C/D (16x8 float32): c[0..1] = C[g][2t..2t+1], c[2..3] = C[g+8][2t..2t+1]
// The lower 16 bits of a register hold the element with the lower k index.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace pddm {

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even
}

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// c += A * B for one 16x8x16 tile.
__device__ __forceinline__ void mma_bf16_16816(float c[4], const uint32_t a[4],
                                               const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ldmatrix: lane l gives the address of row (l % 8) of 8x8 matrix l / 8 (16
// bytes of a row); register i receives this lane's pair of matrix i, in the
// A/B fragment order above (.trans: the pair runs down a column instead).
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// 16-byte asynchronous copy global -> shared; with valid == false nothing is
// read and the 16 bytes are zero-filled.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid = true) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(a), "l"(gmem),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups of this thread are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// bf16 pair <-> two floats
__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  __nv_bfloat162 h = *reinterpret_cast<__nv_bfloat162*>(&v);
  return __bfloat1622float2(h);
}

__device__ __forceinline__ float silu_f(float v) { return v / (1.f + expf(-v)); }

// SiLU with the fast exponential and division (a few ulp of float32): for
// an activation that is rounded to bf16 right after.
__device__ __forceinline__ float silu_fast(float v) { return __fdividef(v, 1.f + __expf(-v)); }

// Raise the dynamic shared-memory limit of `kernel` when it needs more than
// the default 48 KB; each kernel's limit is raised once to the most it has
// been asked for, so a launch on the host costs no driver call for it.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  static const void* kernels[64];
  static size_t allowed[64];
  static int n = 0;
  int i = 0;
  while (i < n && kernels[i] != reinterpret_cast<const void*>(kernel)) ++i;
  if (i < n && allowed[i] >= bytes) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err == cudaSuccess && i < 64) {
    kernels[i] = reinterpret_cast<const void*>(kernel);
    allowed[i] = bytes;
    if (i == n) ++n;
  }
  return err;
}

// The SM count of the current device, asked once: the grid of
// a persistent kernel, one block an SM or a few.
inline cudaError_t sm_count(int* sms) {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if ((err = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return err;
  }
  *sms = count;
  return cudaSuccess;
}

}  // namespace pddm
