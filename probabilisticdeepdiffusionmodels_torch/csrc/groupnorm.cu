// GroupNorm (+ optional SiLU) over a channels-last (B, N, C) tensor.
//
// Replaces probabilisticdeepdiffusionmodels_tpu/ops/groupnorm_pallas.py,
// group_norm_silu_pallas / _gn_kernel: float32 sum and sum of squares in
// one pass, var = E[x^2] - mean^2, eps inside the rsqrt, then the affine
// and the optional SiLU, stored in the input dtype.
//
// Bound on the H100: bytes (one read for the statistics, one write).
// Design: one block per (sample, group).  Pass 1 accumulates the sums of
// the group's N x C/G elements per thread, reduces them through warp
// shuffles and shared memory; pass 2 re-reads the same elements (from L1/L2:
// a group at the main path's shapes is at most 4 KB) and writes the output
// once.  Neighbouring threads take neighbouring channels of a row, so each
// row's group slice is one contiguous read.
#include "common.cuh"

using namespace pddm;

namespace {

constexpr int NT = 256;

template <typename T>
__global__ void __launch_bounds__(NT)
gn_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
          const float* __restrict__ beta, T* __restrict__ out, int N, int C, int G,
          float eps, int silu) {
  __shared__ float red[2][NT / 32];
  __shared__ float stats[2];
  const int b = blockIdx.x / G, grp = blockIdx.x % G;
  const int cg = C / G;
  const long count = (long)N * cg;
  const long base = (long)b * N * C + (long)grp * cg;

  float s = 0.f, ss = 0.f;
  for (long i = threadIdx.x; i < count; i += NT) {
    const long n = i / cg;
    const int c = (int)(i - n * cg);
    const float v = to_f(x[base + n * C + c]);
    s += v;
    ss += v * v;
  }
  for (int o = 16; o > 0; o >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, o);
    ss += __shfl_xor_sync(0xffffffffu, ss, o);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    red[0][warp] = s;
    red[1][warp] = ss;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float ts = 0.f, tss = 0.f;
    for (int w = 0; w < NT / 32; ++w) {
      ts += red[0][w];
      tss += red[1][w];
    }
    const float n = (float)count;
    const float mean = ts / n;
    const float var = tss / n - mean * mean;
    stats[0] = mean;
    stats[1] = rsqrtf(var + eps);
  }
  __syncthreads();
  const float mean = stats[0], rstd = stats[1];

  for (long i = threadIdx.x; i < count; i += NT) {
    const long n = i / cg;
    const int c = (int)(i - n * cg);
    const int ch = grp * cg + c;
    float y = (to_f(x[base + n * C + c]) - mean) * rstd;
    y = y * gamma[ch] + beta[ch];
    if (silu) y = silu_f(y);
    out[base + n * C + c] = from_f<T>(y);
  }
}

}  // namespace

extern "C" int pddm_group_norm_silu(const void* x, const void* gamma, const void* beta,
                                    void* out, int B, int N, int C, int G, float eps,
                                    int silu, int is_bf16, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const dim3 grid(B * G);
  const float* g = static_cast<const float*>(gamma);
  const float* bt = static_cast<const float*>(beta);
  if (is_bf16) {
    gn_kernel<__nv_bfloat16><<<grid, NT, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(x), g, bt, static_cast<__nv_bfloat16*>(out), N,
        C, G, eps, silu);
  } else {
    gn_kernel<float><<<grid, NT, 0, stream>>>(static_cast<const float*>(x), g, bt,
                                              static_cast<float*>(out), N, C, G, eps, silu);
  }
  return cudaGetLastError();
}
