// One 256x256 @ 256x256 product with float32 accumulation, on bf16 or float32
// operands, row major: out[m][n] = sum_k a[m][k] * b[k][n].
//
// Replaces scripts/probe_mosaic_bf16.py, _kernel via try_dtype: a toolchain
// probe that asks whether bf16 matmul operands reach the TPU's matrix unit.
// Here bf16 runs on the tensor cores with the instruction the port's other
// kernels use (mma.sync m16n8k16, float32 accumulation); float32 runs scalar
// FMAs (no TF32), like gn_conv.cu's float32 path.
//
// Bound on the H100: bf16 by bytes (two 128 KB inputs and a 256 KB output,
// about 0.16 us at 3.35 TB/s), float32 by operations (33.6 MFLOP, about
// 0.5 us at 67 TFLOP/s).  Both sit far below a launch's latency, so the design
// is the simplest that exercises the instruction: in bf16 one warp per 16x8
// output tile, its fragments loaded straight from device memory (no shared
// memory); in float32 one thread per output element.
#include "common.cuh"

using namespace pddm;

namespace {

constexpr int N = 256;

__global__ void probe_bf16(const __nv_bfloat16* __restrict__ a,
                           const __nv_bfloat16* __restrict__ b, float* __restrict__ out) {
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int m0 = (warp / (N / 8)) * 16, n0 = (warp % (N / 8)) * 8;
  float c[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k0 = 0; k0 < N; k0 += 16) {
    uint32_t af[4], bf[2];
    af[0] = ld_pair(a + (m0 + g) * N + k0 + 2 * t);
    af[1] = ld_pair(a + (m0 + g + 8) * N + k0 + 2 * t);
    af[2] = ld_pair(a + (m0 + g) * N + k0 + 2 * t + 8);
    af[3] = ld_pair(a + (m0 + g + 8) * N + k0 + 2 * t + 8);
    // b is row major (k, n): the k pair of one column is two loads
    const __nv_bfloat16* bc = b + n0 + g;
    __nv_bfloat162 b0 = __halves2bfloat162(bc[(k0 + 2 * t) * N], bc[(k0 + 2 * t + 1) * N]);
    __nv_bfloat162 b1 =
        __halves2bfloat162(bc[(k0 + 2 * t + 8) * N], bc[(k0 + 2 * t + 9) * N]);
    bf[0] = *reinterpret_cast<uint32_t*>(&b0);
    bf[1] = *reinterpret_cast<uint32_t*>(&b1);
    mma_bf16_16816(c, af, bf);
  }
  float* o = out + (m0 + g) * N + n0 + 2 * t;
  o[0] = c[0];
  o[1] = c[1];
  o[8 * N] = c[2];
  o[8 * N + 1] = c[3];
}

__global__ void probe_f32(const float* __restrict__ a, const float* __restrict__ b,
                          float* __restrict__ out) {
  const int row = blockIdx.y * 16 + threadIdx.y, col = blockIdx.x * 16 + threadIdx.x;
  float acc = 0.f;
  for (int k = 0; k < N; ++k) acc = fmaf(a[row * N + k], b[k * N + col], acc);
  out[row * N + col] = acc;
}

}  // namespace

extern "C" int pddm_probe_mma(const void* a, const void* b, void* out, int is_bf16,
                              void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (is_bf16) {
    constexpr int warps = (N / 16) * (N / 8);
    probe_bf16<<<warps / 4, 128, 0, stream>>>(static_cast<const __nv_bfloat16*>(a),
                                              static_cast<const __nv_bfloat16*>(b),
                                              static_cast<float*>(out));
  } else {
    probe_f32<<<dim3(N / 16, N / 16), dim3(16, 16), 0, stream>>>(
        static_cast<const float*>(a), static_cast<const float*>(b), static_cast<float*>(out));
  }
  return cudaGetLastError();
}
