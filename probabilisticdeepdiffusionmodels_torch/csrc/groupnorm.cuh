// Shared by groupnorm.cu (GroupNorm, gn_affine and its gradient, the fold
// alone) and groupnorm_grad.cu (GroupNorm's gradient): the launch geometry
// that ops/groupnorm.py computes, vector loads and stores, the block's
// fixed-order reduction and the fixed-order batch sums.  Two translation
// units, so nvcc builds the two halves of the GroupNorm kernels side by side.
#pragma once

#include "common.cuh"

namespace {

using namespace pddm;

constexpr int NT = 256;

// The launch geometry, from ops/groupnorm.py (moments_plan, affine_plan,
// grad_plan).
struct Plan {
  int B, N, C, G;
  int cvb;     // channel vectors of one block (its threads along the channels)
  int splits;  // blocks along N of one sample
  int rows;    // rows of one block
  int fold;    // where a block's sums meet: kLocal, kCluster or kWorkspace
};

// kLocal: a block covers whole groups over all N rows and folds them itself;
// kCluster: the splits of a sample are one thread-block cluster and meet in
// distributed shared memory; kWorkspace: they meet in a global workspace and
// the sample's last block folds every channel.
constexpr int kLocal = 0, kCluster = 1, kWorkspace = 2;
constexpr int kClusterMax = 8;  // blocks a portable cluster may hold

template <int BYTES> struct Raw;
template <> struct Raw<16> { using type = uint4; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<4> { using type = uint32_t; };
template <> struct Raw<2> { using type = uint16_t; };

// V neighbouring channels as one load or store of V * sizeof(T) bytes.
template <typename T, int V> using RawVec = typename Raw<V * sizeof(T)>::type;

template <typename T, int V>
__device__ __forceinline__ void unpack_vec(const RawVec<T, V>& r, float (&f)[V]) {
  const T* e = reinterpret_cast<const T*>(&r);
#pragma unroll
  for (int k = 0; k < V; ++k) f[k] = to_f(e[k]);
}

template <typename T, int V>
__device__ __forceinline__ void store_vec(T* p, const float (&f)[V]) {
  RawVec<T, V> r;
  T* e = reinterpret_cast<T*>(&r);
#pragma unroll
  for (int k = 0; k < V; ++k) e[k] = from_f<T>(f[k]);
  *reinterpret_cast<RawVec<T, V>*>(p) = r;
}

// The threads' per-vector partial sums s, ss (threads laid out as the plan's
// block: cvb vectors wide, NT / cvb rows tall) added per channel into
// csum[j], csq[j] for the nch local channels.  Where a warp holds whole rows
// of the block (cvb divides 32), the lanes of one channel vector meet by
// shuffles first, and one partial sum a warp is left; the rest meet in `red`
// (NT x 2V floats of shared memory), in row order.
template <int V>
__device__ __forceinline__ void block_reduce(const Plan& p, float (&s)[V], float (&ss)[V],
                                             int nch, float* red, float* csum, float* csq) {
  const int R = NT / p.cvb;
  int parts = R, slot = threadIdx.x;
  if (32 % p.cvb == 0) {
    for (int o = p.cvb; o < 32; o <<= 1) {
#pragma unroll
      for (int k = 0; k < V; ++k) {
        s[k] += __shfl_xor_sync(0xffffffffu, s[k], o);
        ss[k] += __shfl_xor_sync(0xffffffffu, ss[k], o);
      }
    }
    parts = NT / 32;
    const int lane = threadIdx.x & 31;
    slot = lane < p.cvb ? (threadIdx.x >> 5) * p.cvb + lane : -1;
  }
  if (slot >= 0) {
    float* mine = red + slot * 2 * V;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      mine[k] = s[k];
      mine[V + k] = ss[k];
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < nch; j += NT) {
    const int jx = j / V, k = j % V;
    float a = 0.f, q = 0.f;
    for (int y = 0; y < parts; ++y) {
      const float* o = red + (y * p.cvb + jx) * 2 * V;
      a += o[k];
      q += o[V + k];
    }
    csum[j] = a;
    csq[j] = q;
  }
  __syncthreads();
}

// The second launch of fused_bwd: dgamma[c], dbeta[c], the sums over the
// batch of the (B, 2, C) shares, in a fixed order, so two runs give the same
// bits.  A block takes CH channels, so 2 CH columns (dgamma's, then
// dbeta's) of NT / (2 CH) parts each: part q sums the samples q, q + parts,
// ... (four loads in flight, neighbouring threads on neighbouring columns);
// the parts meet in shared memory in part order.  (A tail run by the
// launch's last block instead, one block summing a chunk's columns, cost
// more than this launch at every site measured.)
template <int CH>
__device__ __forceinline__ void batch_sums(const float* __restrict__ shares,
                                           float* __restrict__ dgamma, float* __restrict__ dbeta,
                                           int B, int C) {
  constexpr int COLS = 2 * CH, PARTS = NT / COLS;
  __shared__ float acc[NT];
  const int c0 = blockIdx.x * CH, nch = CH < C - c0 ? CH : C - c0;
  const int col = threadIdx.x % COLS, part = threadIdx.x / COLS;
  float s = 0.f;
  if (col < 2 * nch) {
    const float* src = shares + (col < nch ? c0 + col : C + c0 + col - nch);
    int b = part;
    for (; b + 3 * PARTS < B; b += 4 * PARTS) {
      const float v0 = src[(long)b * 2 * C], v1 = src[(long)(b + PARTS) * 2 * C];
      const float v2 = src[(long)(b + 2 * PARTS) * 2 * C];
      const float v3 = src[(long)(b + 3 * PARTS) * 2 * C];
      s = (((s + v0) + v1) + v2) + v3;
    }
    for (; b < B; b += PARTS) s += src[(long)b * 2 * C];
  }
  acc[threadIdx.x] = s;
  __syncthreads();
  if ((int)threadIdx.x < 2 * nch) {
    float t = 0.f;
    for (int q = 0; q < PARTS; ++q) t += acc[q * COLS + threadIdx.x];
    if ((int)threadIdx.x < nch)
      dgamma[c0 + threadIdx.x] = t;
    else
      dbeta[c0 + threadIdx.x - nch] = t;
  }
}

__global__ void __launch_bounds__(NT)
gn_batch_sum_kernel(const float* __restrict__ shares, float* __restrict__ dgamma,
                    float* __restrict__ dbeta, int B, int C) {
  batch_sums<16>(shares, dgamma, dbeta, B, C);
}

bool plan_ok(const Plan& p, int V, size_t elem, const void* x, const void* y) {
  return p.B >= 1 && p.B <= 65535 && p.N >= 1 && p.C >= 1 && p.G >= 1 && p.C % p.G == 0 &&
         V >= 1 && p.C % V == 0 && p.cvb >= 1 && p.cvb <= NT && p.splits >= 1 && p.rows >= 1 &&
         (long)p.splits * p.rows >= p.N && reinterpret_cast<uintptr_t>(x) % (V * elem) == 0 &&
         reinterpret_cast<uintptr_t>(y) % (V * elem) == 0;
}

dim3 plan_grid(const Plan& p, int V) {
  const int cv = p.C / V;
  return dim3(p.splits, (cv + p.cvb - 1) / p.cvb, p.B);
}

// Whether a chunk of the plan's channels is whole groups (the last chunk
// is what is left of C, so whole groups too).
bool whole_groups(const Plan& p, int V) { return (p.cvb * V) % (p.C / p.G) == 0; }

}  // namespace
