// GroupNorm over a channels-last (B, N, C) tensor as moments + fold + apply.
//
// Replaces probabilisticdeepdiffusionmodels_tpu/ops/groupnorm_pallas.py,
// group_norm_silu_pallas / _gn_kernel (float32 sum and sum of squares in one
// pass, var = E[x^2] - mean^2, eps inside the rsqrt, the affine, an optional
// SiLU, stored in the input dtype), and the statistics pass of gn_affine in
// ops/gn_conv_pallas.py, which XLA fuses into one pass over x before every
// fused conv.  Both are one computation here:
//
//   moments  per-(sample, channel) float32 sum and sum of squares, x read once;
//   fold     the (B, C)-sized rest: the timestep-embedding correction
//            E[(x+e)^2] = E[x^2] + 2 e E[x] + e^2, channels reduced to groups,
//            rsqrt(var + eps), and gamma/beta with the embedding add or the
//            FiLM scale/shift folded into a scale `a` and an offset `off`,
//            so that the normalised, conditioned tensor is x * a + off;
//   apply    y = x * a + off (+ SiLU), stored in the input dtype.
//
// gn_affine's gradient is the same three parts backwards: the fold's backward
// is one small kernel that turns the gradients of (a, off) into dL/dS1 and
// dL/dS2 per (sample, channel), and dL/dx = 2 x dL/dS2 + dL/dS1 is one pass of
// the apply kernel.  (The JAX package differentiates the fold by recomputing
// it in XLA, one fused pass; recomputed in eager PyTorch it is some 70 small
// launches a site, which the host issues more slowly than the card runs them.)
//
// Bound on the H100: bytes.  Moments reads x once (3 flops an element),
// apply reads it again and writes y.  So every access is as wide as the
// shape allows: a thread owns one vector of V neighbouring channels (16
// bytes: 8 bf16 or 4 float32; 8, 4 or 2 bytes where C or the address is not
// a multiple of 16) and walks down the rows, its 2 V partial sums in
// registers, eight loads in flight at a time; no index is divided per
// element.  A block is cvb channel vectors wide and 256 / cvb rows tall, and
// takes `rows` rows of one sample; its partial sums meet by warp shuffles and
// in shared memory, in a fixed order.
//
// Enough blocks to fill 132 SMs: where B x (channel chunks) is too few, or N
// is long, N is split over `splits` blocks a sample.  Their partial sums go
// to a (B, splits, C, 2) workspace, and the block of a sample that finishes
// last (a counter per sample, which that block sets back to 0) adds them in
// split order and folds: no float atomicAdd, so two runs give the same bits.
// A sample that one block covers (the 4x4 and 8x8 sites) is folded by that
// block with no workspace and no counter.  gn_affine is this one launch.
//
// GroupNorm has two designs (ops/groupnorm.py::groupnorm_design):
//   fused  one launch: a block owns whole groups (a chunk of channels that
//          is a multiple of C/G and of V) over all N rows of a sample, folds
//          them itself and reads its rows again, from L1/L2, to apply.  For
//          the short sequences of the attention norms (a chunk is <= 48 KB).
//   split  moments + fold as above, then the apply kernel, for long inputs
//          (64x64 and larger), where one block per chunk would leave the
//          card idle and the second read would miss the cache anyway.
#include "common.cuh"

using namespace pddm;

namespace {

constexpr int NT = 256;

// The launch geometry, from ops/groupnorm.py::moments_plan.
struct Plan {
  int B, N, C, G;
  int cvb;     // channel vectors of one block (its threads along the channels)
  int splits;  // blocks along N of one sample
  int rows;    // rows of one block
};

// The conditioning folded into (a, off): nothing, the timestep embedding
// (B, C), or the FiLM pair (scale, shift), each (B, C); unit channel stride,
// `stride` elements between samples (the FiLM pair is two halves of one
// (B, 2C) tensor), float32 or bf16.
struct Cond {
  const void* p0;
  const void* p1;
  int stride0, stride1;
  int mode;  // 0 none, 1 embedding add, 2 FiLM
  int is_bf16;
};

__device__ __forceinline__ float cond_at(const void* p, long i, int is_bf16) {
  return is_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
                 : static_cast<const float*>(p)[i];
}

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

// Add `left / U * U` rows, `step` elements apart, into the sums: the U loads
// of a batch are all issued before the first is used, so a thread keeps U
// requests in flight instead of one.
template <typename T, int V, int U>
__device__ __forceinline__ void sum_rows(const T*& px, long step, int& left, float (&s)[V],
                                         float (&ss)[V]) {
  for (; left >= U; left -= U, px += U * step) {
    RawVec<T, V> raw[U];
#pragma unroll
    for (int u = 0; u < U; ++u) raw[u] = *reinterpret_cast<const RawVec<T, V>*>(px + u * step);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float f[V];
      unpack_vec<T, V>(raw[u], f);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        s[k] += f[k];
        ss[k] = fmaf(f[k], f[k], ss[k]);
      }
    }
  }
}

// y = x * a + off (+ SiLU) for `left / U * U` rows, loads batched as above.
template <typename T, int V, int U>
__device__ __forceinline__ void apply_batch(const T*& px, T*& py, long step, int& left,
                                            const float (&av)[V], const float (&ov)[V],
                                            int silu) {
  for (; left >= U; left -= U, px += U * step, py += U * step) {
    RawVec<T, V> raw[U];
#pragma unroll
    for (int u = 0; u < U; ++u) raw[u] = *reinterpret_cast<const RawVec<T, V>*>(px + u * step);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float f[V];
      unpack_vec<T, V>(raw[u], f);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        f[k] = fmaf(f[k], av[k], ov[k]);
        if (silu) f[k] = silu_f(f[k]);
      }
      store_vec<T, V>(py + u * step, f);
    }
  }
}

// Sum and sum of squares of rows [r0, r1) of sample b for the nch channels
// from channel vector cv0 on: csum[j], csq[j] for local channel j.  The
// threads' partial sums meet in `red` and are added in a fixed order.
template <typename T, int V>
__device__ __forceinline__ void block_moments(const T* __restrict__ x, const Plan& p, int b,
                                              int cv0, int r0, int r1, int nch, float* red,
                                              float* csum, float* csq) {
  const int tx = threadIdx.x % p.cvb, ty = threadIdx.x / p.cvb, R = NT / p.cvb;
  float s[V], ss[V];
#pragma unroll
  for (int k = 0; k < V; ++k) s[k] = ss[k] = 0.f;
  if (ty < R && (cv0 + tx) * V < p.C) {
    const T* px = x + ((long)b * p.N + r0 + ty) * p.C + (long)(cv0 + tx) * V;
    const long step = (long)R * p.C;
    int left = r0 + ty < r1 ? (r1 - r0 - ty + R - 1) / R : 0;  // this thread's rows
    sum_rows<T, V, 8>(px, step, left, s, ss);
    sum_rows<T, V, 2>(px, step, left, s, ss);
    sum_rows<T, V, 1>(px, step, left, s, ss);
  }
  // Where a warp holds whole rows of the block (cvb divides 32), the lanes of
  // one channel vector meet by shuffles first, and one partial sum a warp is
  // left; the rest meet in shared memory, in row order.
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

// The fold for sample b and the nch channels from c0 on (whole groups):
// csum/csq hold their sums over N on entry; a_out[j], off_out[j] receive the
// scale and offset of local channel j, and mean_out[j], m2_out[j] (where
// given) E[x] and E[x^2], which the backward starts from.
__device__ __forceinline__ void fold(const Plan& p, const Cond& cd,
                                     const float* __restrict__ gamma,
                                     const float* __restrict__ beta, float eps, int b, int c0,
                                     int nch, float* csum, float* csq, float* a_out,
                                     float* off_out, float* mean_out, float* m2_out) {
  const float n = (float)p.N;
  for (int j = threadIdx.x; j < nch; j += NT) {
    float mu = csum[j] / n, m2 = csq[j] / n;
    if (mean_out != nullptr) {
      mean_out[j] = mu;
      m2_out[j] = m2;
    }
    if (cd.mode == 1) {
      const float e = cond_at(cd.p0, (long)b * cd.stride0 + c0 + j, cd.is_bf16);
      m2 = m2 + 2.f * e * mu + e * e;
      mu = mu + e;
    }
    csum[j] = mu;
    csq[j] = m2;
  }
  __syncthreads();
  const int cg = p.C / p.G;
  for (int j = threadIdx.x; j < nch; j += NT) {
    const int c = c0 + j, g0 = (c / cg) * cg - c0;
    float mg = 0.f, qg = 0.f;
    for (int i = 0; i < cg; ++i) {
      mg += csum[g0 + i];
      qg += csq[g0 + i];
    }
    mg /= (float)cg;
    qg /= (float)cg;
    const float rstd = rsqrtf(qg - mg * mg + eps);
    float a = rstd * gamma[c];
    float off = beta[c] - mg * a;
    if (cd.mode == 1) off += cond_at(cd.p0, (long)b * cd.stride0 + c, cd.is_bf16) * a;
    if (cd.mode == 2) {
      const float sc = 1.f + cond_at(cd.p0, (long)b * cd.stride0 + c, cd.is_bf16);
      a *= sc;
      off = off * sc + cond_at(cd.p1, (long)b * cd.stride1 + c, cd.is_bf16);
    }
    a_out[j] = a;
    off_out[j] = off;
  }
}

// y = x * a + off (+ SiLU) over rows [r0, r1) of sample b for the channels
// from channel vector cv0 on; a_src/off_src are indexed from that channel.
template <typename T, int V>
__device__ __forceinline__ void apply_rows(const T* __restrict__ x, T* __restrict__ y,
                                           const Plan& p, int b, int cv0, int r0, int r1,
                                           const float* a_src, const float* off_src, int silu) {
  const int tx = threadIdx.x % p.cvb, ty = threadIdx.x / p.cvb, R = NT / p.cvb;
  if (ty >= R || (cv0 + tx) * V >= p.C) return;
  float av[V], ov[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    av[k] = a_src[tx * V + k];
    ov[k] = off_src[tx * V + k];
  }
  const long first = ((long)b * p.N + r0 + ty) * p.C + (long)(cv0 + tx) * V;
  const T* px = x + first;
  T* py = y + first;
  const long step = (long)R * p.C;
  int left = r0 + ty < r1 ? (r1 - r0 - ty + R - 1) / R : 0;
  apply_batch<T, V, 4>(px, py, step, left, av, ov, silu);
  apply_batch<T, V, 2>(px, py, step, left, av, ov, silu);
  apply_batch<T, V, 1>(px, py, step, left, av, ov, silu);
}

// Four blocks an SM (64 registers a thread): the batches above are sized for
// that, and the short fused launches need the residency, not the registers.
// Grid (splits, channel chunks, B).  APPLY (the fused GroupNorm): splits is
// 1 and a chunk is whole groups, so each block folds its own channels and
// applies them.  Otherwise a block that covers its whole sample folds it;
// any other grid meets in the workspace, and the sample's last block folds.
template <typename T, int V, bool APPLY>
__global__ void __launch_bounds__(NT, 4)
gn_moments_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                  const float* __restrict__ beta, Cond cd, float* __restrict__ ao,
                  T* __restrict__ y, float* ws, unsigned* counters, Plan p, float eps,
                  int silu) {
  extern __shared__ float smem[];
  __shared__ bool last;
  const int s = blockIdx.x, b = blockIdx.z;
  const int chb = p.cvb * V, c0 = blockIdx.y * chb;
  const int nch = chb < p.C - c0 ? chb : p.C - c0;
  const int r0 = s * p.rows, r1 = p.N < r0 + p.rows ? p.N : r0 + p.rows;
  const bool local = gridDim.x == 1 && (APPLY || gridDim.y == 1);
  const int cap = local ? chb : p.C;  // channels this block may fold
  float* red = smem;                  // [NT][2 V]
  float* csum = red + NT * 2 * V;     // [cap]
  float* csq = csum + cap;            // [cap]

  block_moments<T, V>(x, p, b, blockIdx.y * p.cvb, r0, r1, nch, red, csum, csq);
  int fc0 = c0, fn = nch;
  if (!local) {
    float* w = ws + (((long)b * gridDim.x + s) * p.C + c0) * 2;
    for (int j = threadIdx.x; j < nch; j += NT) {
      w[2 * j] = csum[j];
      w[2 * j + 1] = csq[j];
    }
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0)
      last = atomicAdd(counters + b, 1u) == gridDim.x * gridDim.y - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    for (int c = threadIdx.x; c < p.C; c += NT) {
      float a = 0.f, q = 0.f;
      for (int s2 = 0; s2 < (int)gridDim.x; ++s2) {
        const float2 v = __ldcg(
            reinterpret_cast<const float2*>(ws + (((long)b * gridDim.x + s2) * p.C + c) * 2));
        a += v.x;
        q += v.y;
      }
      csum[c] = a;
      csq[c] = q;
    }
    if (threadIdx.x == 0) counters[b] = 0u;  // ready for the next launch on this stream
    __syncthreads();
    fc0 = 0;
    fn = p.C;
  }
  if constexpr (APPLY) {
    float* sa = csq + cap;
    float* so = sa + cap;
    fold(p, cd, gamma, beta, eps, b, fc0, fn, csum, csq, sa, so, nullptr, nullptr);
    __syncthreads();
    apply_rows<T, V>(x, y, p, b, blockIdx.y * p.cvb, r0, r1, sa, so, silu);
  } else {
    float* o = ao + (long)b * p.C + fc0;  // ao is (4, B, C): a, off, E[x], E[x^2]
    const long bc = (long)p.B * p.C;
    fold(p, cd, gamma, beta, eps, b, fc0, fn, csum, csq, o, o + bc, o + 2 * bc, o + 3 * bc);
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(NT, 4)
gn_apply_kernel(const T* __restrict__ x, const float* __restrict__ ao, T* __restrict__ y, Plan p,
                int silu) {
  const int b = blockIdx.z, c0 = blockIdx.y * p.cvb * V;
  const int r0 = blockIdx.x * p.rows, r1 = p.N < r0 + p.rows ? p.N : r0 + p.rows;
  apply_rows<T, V>(x, y, p, b, blockIdx.y * p.cvb, r0, r1, ao + (long)b * p.C + c0,
                   ao + ((long)p.B + b) * p.C + c0, silu);
}

// The backward of the fold for sample b (one block a sample): from the
// gradients ga, goff (B, C) of the scale and the offset to
//   g[0] = 2 dL/dS2, g[1] = dL/dS1 with S1 = sum_n x, S2 = sum_n x^2, so that
//          dL/dx = x * g[0] + g[1] is one pass of the apply kernel;
//   g[2], g[3]: this sample's share of dL/dgamma and dL/dbeta;
//   g[4], g[5]: dL/d(emb), or dL/d(FiLM scale) and dL/d(FiLM shift).
// ao is the forward's (4, B, C) output; only its E[x] and E[x^2] are read, the
// group statistics are folded again.  All in float32; g is (6, B, C).
__global__ void __launch_bounds__(NT)
gn_fold_bwd_kernel(const float* __restrict__ ao, const float* __restrict__ gamma,
                   const float* __restrict__ beta, Cond cd, const float* __restrict__ ga,
                   const float* __restrict__ goff, float* __restrict__ g, int B, int N, int C,
                   int G, float eps) {
  extern __shared__ float smem[];
  float* mu = smem;     // E[x + e] per channel
  float* m2 = mu + C;   // E[(x + e)^2]
  float* tm = m2 + C;   // each channel's share of dL/d(group mean)
  float* tr = tm + C;   // ... of dL/d(group rstd)
  float* de = tr + C;   // dL/d(emb) through the offset
  const int b = blockIdx.x, cg = C / G;
  const long bc = (long)B * C, row = (long)b * C;
  const float* mean_raw = ao + 2 * bc + row;
  const float* m2_raw = ao + 3 * bc + row;
  for (int c = threadIdx.x; c < C; c += NT) {
    const float mr = mean_raw[c];
    const float e = cd.mode == 1 ? cond_at(cd.p0, (long)b * cd.stride0 + c, cd.is_bf16) : 0.f;
    mu[c] = mr + e;
    m2[c] = m2_raw[c] + 2.f * e * mr + e * e;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += NT) {
    const int g0 = (c / cg) * cg;
    float mg = 0.f, qg = 0.f;
    for (int i = 0; i < cg; ++i) {
      mg += mu[g0 + i];
      qg += m2[g0 + i];
    }
    mg /= (float)cg;
    qg /= (float)cg;
    const float rstd = rsqrtf(qg - mg * mg + eps);
    const float e = cd.mode == 1 ? cond_at(cd.p0, (long)b * cd.stride0 + c, cd.is_bf16) : 0.f;
    const float gam = gamma[c];
    const float a0 = rstd * gam, off0 = beta[c] - mg * a0 + e * a0;
    float da = ga[row + c], doff = goff[row + c];
    if (cd.mode == 2) {
      const float sc = 1.f + cond_at(cd.p0, (long)b * cd.stride0 + c, cd.is_bf16);
      g[4 * bc + row + c] = da * a0 + doff * off0;
      g[5 * bc + row + c] = doff;
      da *= sc;
      doff *= sc;
    }
    g[3 * bc + row + c] = doff;
    da += doff * (e - mg);
    tm[c] = -a0 * doff;
    de[c] = doff * a0;
    g[2 * bc + row + c] = da * rstd;
    tr[c] = da * gam;
  }
  __syncthreads();
  const float n = (float)N;
  for (int c = threadIdx.x; c < C; c += NT) {
    const int g0 = (c / cg) * cg;
    float mg = 0.f, qg = 0.f, sm = 0.f, sr = 0.f;
    for (int i = 0; i < cg; ++i) {
      mg += mu[g0 + i];
      qg += m2[g0 + i];
      sm += tm[g0 + i];
      sr += tr[g0 + i];
    }
    mg /= (float)cg;
    qg /= (float)cg;
    const float rstd = rsqrtf(qg - mg * mg + eps), r3 = rstd * rstd * rstd;
    const float dmu = (sm + r3 * mg * sr) / (float)cg, dm2 = -0.5f * r3 * sr / (float)cg;
    const float e = cd.mode == 1 ? cond_at(cd.p0, (long)b * cd.stride0 + c, cd.is_bf16) : 0.f;
    g[row + c] = 2.f * dm2 / n;
    g[bc + row + c] = (dmu + 2.f * e * dm2) / n;
    if (cd.mode == 1) g[4 * bc + row + c] = de[c] + dmu + dm2 * (2.f * mean_raw[c] + 2.f * e);
  }
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

template <typename T, int V, bool APPLY>
cudaError_t launch_moments(const void* x, const float* gamma, const float* beta, const Cond& cd,
                           float* ao, void* y, float* ws, unsigned* counters, const Plan& p,
                           float eps, int silu, cudaStream_t stream) {
  if (!plan_ok(p, V, sizeof(T), x, y)) return cudaErrorInvalidValue;
  const dim3 grid = plan_grid(p, V);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  const int chb = p.cvb * V;
  if (APPLY && (p.splits != 1 || chb % (p.C / p.G) != 0)) return cudaErrorInvalidValue;
  const bool local = p.splits == 1 && (APPLY || grid.y == 1);
  if (!local && (ws == nullptr || counters == nullptr)) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (NT * 2 * V + (APPLY ? 4 : 2) * (size_t)(local ? chb : p.C));
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  // (the kernel's few static bytes count against the same 48 KB default)
  const cudaError_t err = allow_smem(gn_moments_kernel<T, V, APPLY>, smem + 256);
  if (err != cudaSuccess) return err;
  gn_moments_kernel<T, V, APPLY><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(x), gamma, beta, cd, ao, static_cast<T*>(y), ws, counters, p, eps,
      silu);
  return cudaGetLastError();
}

template <bool APPLY>
cudaError_t moments_any(int is_bf16, int V, const void* x, const float* gamma, const float* beta,
                        const Cond& cd, float* ao, void* y, float* ws, unsigned* counters,
                        const Plan& p, float eps, int silu, cudaStream_t stream) {
#define PDDM_GN_CASE(T, W) \
  case W:                  \
    return launch_moments<T, W, APPLY>(x, gamma, beta, cd, ao, y, ws, counters, p, eps, silu, stream)
  if (is_bf16) {
    switch (V) {
      PDDM_GN_CASE(__nv_bfloat16, 8);
      PDDM_GN_CASE(__nv_bfloat16, 4);
      PDDM_GN_CASE(__nv_bfloat16, 2);
      PDDM_GN_CASE(__nv_bfloat16, 1);
    }
  } else {
    switch (V) {
      PDDM_GN_CASE(float, 4);
      PDDM_GN_CASE(float, 2);
      PDDM_GN_CASE(float, 1);
    }
  }
#undef PDDM_GN_CASE
  return cudaErrorInvalidValue;
}

template <typename T, int V>
cudaError_t launch_apply(const void* x, const float* ao, void* y, const Plan& p, int silu,
                         cudaStream_t stream) {
  if (!plan_ok(p, V, sizeof(T), x, y)) return cudaErrorInvalidValue;
  const dim3 grid = plan_grid(p, V);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  gn_apply_kernel<T, V><<<grid, NT, 0, stream>>>(static_cast<const T*>(x), ao,
                                                 static_cast<T*>(y), p, silu);
  return cudaGetLastError();
}

}  // namespace

// Moments + fold in one launch: ao (4, B, C) float32 receives the scale, the
// offset, E[x] and E[x^2] per (sample, channel).  ws (B, splits, C, 2)
// float32 and counters (B, zero on entry, zero again on exit) are read only
// where a sample takes more than one block.
extern "C" int pddm_gn_moments_fold(const void* x, const void* gamma, const void* beta,
                                    const void* cond0, const void* cond1, void* ao, void* ws,
                                    void* counters, int B, int N, int C, int G, float eps,
                                    int mode, int stride0, int stride1, int cond_is_bf16,
                                    int is_bf16, int V, int cvb, int splits, int rows,
                                    void* stream_ptr) {
  if (mode < 0 || mode > 2 || (mode >= 1 && cond0 == nullptr) || (mode == 2 && cond1 == nullptr))
    return cudaErrorInvalidValue;
  const Plan p{B, N, C, G, cvb, splits, rows};
  const Cond cd{cond0, cond1, stride0, stride1, mode, cond_is_bf16};
  return moments_any<false>(is_bf16, V, x, static_cast<const float*>(gamma),
                            static_cast<const float*>(beta), cd, static_cast<float*>(ao),
                            nullptr, static_cast<float*>(ws),
                            static_cast<unsigned*>(counters), p, eps, 0,
                            static_cast<cudaStream_t>(stream_ptr));
}

// The fold's backward (gn_fold_bwd_kernel): g (6, B, C) float32 from the
// forward's ao (4, B, C) and the gradients ga, goff (B, C) float32.
extern "C" int pddm_gn_fold_bwd(const void* ao, const void* gamma, const void* beta,
                                const void* cond0, const void* cond1, const void* ga,
                                const void* goff, void* g, int B, int N, int C, int G, float eps,
                                int mode, int stride0, int stride1, int cond_is_bf16,
                                void* stream_ptr) {
  if (mode < 0 || mode > 2 || (mode >= 1 && cond0 == nullptr) || B < 1 || N < 1 || G < 1 ||
      C < 1 || C % G != 0)
    return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * 5 * (size_t)C;
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  const cudaError_t err = allow_smem(gn_fold_bwd_kernel, smem + 256);
  if (err != cudaSuccess) return err;
  const Cond cd{cond0, cond1, stride0, stride1, mode, cond_is_bf16};
  gn_fold_bwd_kernel<<<B, NT, smem, static_cast<cudaStream_t>(stream_ptr)>>>(
      static_cast<const float*>(ao), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), cd, static_cast<const float*>(ga),
      static_cast<const float*>(goff), static_cast<float*>(g), B, N, C, G, eps);
  return cudaGetLastError();
}

// y = x * a + off (+ SiLU) with ao = (a, off, ...) as pddm_gn_moments_fold
// leaves it, or as pddm_gn_fold_bwd does (then y is dL/dx).
extern "C" int pddm_gn_apply(const void* x, const void* ao, void* y, int B, int N, int C,
                             int silu, int is_bf16, int V, int cvb, int splits, int rows,
                             void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const Plan p{B, N, C, 1, cvb, splits, rows};
  const float* f = static_cast<const float*>(ao);
#define PDDM_GN_CASE(T, W) \
  case W:                  \
    return launch_apply<T, W>(x, f, y, p, silu, stream)
  if (is_bf16) {
    switch (V) {
      PDDM_GN_CASE(__nv_bfloat16, 8);
      PDDM_GN_CASE(__nv_bfloat16, 4);
      PDDM_GN_CASE(__nv_bfloat16, 2);
      PDDM_GN_CASE(__nv_bfloat16, 1);
    }
  } else {
    switch (V) {
      PDDM_GN_CASE(float, 4);
      PDDM_GN_CASE(float, 2);
      PDDM_GN_CASE(float, 1);
    }
  }
#undef PDDM_GN_CASE
  return cudaErrorInvalidValue;
}

// The fused GroupNorm: moments, fold and apply in one launch, a block per
// (sample, chunk of cvb * V channels: whole groups).
extern "C" int pddm_group_norm_silu(const void* x, const void* gamma, const void* beta, void* y,
                                    int B, int N, int C, int G, float eps, int silu,
                                    int is_bf16, int V, int cvb, void* stream_ptr) {
  const Plan p{B, N, C, G, cvb, 1, N};
  const Cond cd{nullptr, nullptr, 0, 0, 0, 0};
  return moments_any<true>(is_bf16, V, x, static_cast<const float*>(gamma),
                           static_cast<const float*>(beta), cd, nullptr, y, nullptr, nullptr, p,
                           eps, silu, static_cast<cudaStream_t>(stream_ptr));
}
