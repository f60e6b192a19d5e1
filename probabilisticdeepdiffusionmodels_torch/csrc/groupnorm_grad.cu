// GroupNorm's gradient (+ SiLU): replaces _gns_bwd in
// probabilisticdeepdiffusionmodels_tpu/ops/groupnorm_pallas.py, the jax.vjp
// of group_norm_silu_xla.  groupnorm.cu's header has the design; this file
// holds its kernels so that nvcc builds them beside that file's.
#include "groupnorm.cuh"

namespace {

// ------------------------------------------------------------ GroupNorm's gradient
//
// y = silu(p), p = x * a + off with (a, off) the fold of the group
// statistics.  With g' = g * silu'(p) (g where there is no SiLU), the
// gradients of (a, off) are da = sum_n g' x and doff = sum_n g' per (sample,
// channel); the fold's backward (gn_affine_bwd_kernel's arithmetic, no
// conditioning) turns them into 2 dL/dS2, dL/dS1 and the sample's shares of
// dL/dgamma and dL/dbeta; dx = g' a + x 2 dL/dS2 + dL/dS1.

// g' for V channels: g * s * (1 + p (1 - s)) with s = sigmoid(p).
template <int V>
__device__ __forceinline__ void silu_grad_vec(const float (&xf)[V], float (&gf)[V],
                                              const float (&av)[V], const float (&ov)[V],
                                              int silu) {
  if (!silu) return;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const float pk = fmaf(xf[k], av[k], ov[k]);
    const float sk = 1.f / (1.f + expf(-pk));
    gf[k] = gf[k] * sk * (1.f + pk * (1.f - sk));
  }
}

// sum_n g' x and sum_n g' of rows [r0, r1) of sample b for the channel
// vectors from cv0 on, per thread; the rows are loaded in pairs of batches
// of U, as sum_rows does.
template <typename T, int V, int U>
__device__ __forceinline__ void grad_sum_rows(const T*& px, const T*& pg, long step, int& left,
                                              const float (&av)[V], const float (&ov)[V],
                                              int silu, float (&sx)[V], float (&sg)[V]) {
  for (; left >= U; left -= U, px += U * step, pg += U * step) {
    RawVec<T, V> rx[U], rg[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      rx[u] = *reinterpret_cast<const RawVec<T, V>*>(px + u * step);
      rg[u] = *reinterpret_cast<const RawVec<T, V>*>(pg + u * step);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float xf[V], gf[V];
      unpack_vec<T, V>(rx[u], xf);
      unpack_vec<T, V>(rg[u], gf);
      silu_grad_vec<V>(xf, gf, av, ov, silu);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        sg[k] += gf[k];
        sx[k] = fmaf(gf[k], xf[k], sx[k]);
      }
    }
  }
}

// dx = g' a + x g0 + g1 for `left / U * U` rows.
template <typename T, int V, int U>
__device__ __forceinline__ void grad_apply_rows(const T*& px, const T*& pg, T*& pd, long step,
                                                int& left, const float (&av)[V],
                                                const float (&ov)[V], const float (&g0)[V],
                                                const float (&g1)[V], int silu) {
  for (; left >= U; left -= U, px += U * step, pg += U * step, pd += U * step) {
    RawVec<T, V> rx[U], rg[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      rx[u] = *reinterpret_cast<const RawVec<T, V>*>(px + u * step);
      rg[u] = *reinterpret_cast<const RawVec<T, V>*>(pg + u * step);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float xf[V], gf[V];
      unpack_vec<T, V>(rx[u], xf);
      unpack_vec<T, V>(rg[u], gf);
      silu_grad_vec<V>(xf, gf, av, ov, silu);
#pragma unroll
      for (int k = 0; k < V; ++k) gf[k] = fmaf(gf[k], av[k], fmaf(xf[k], g0[k], g1[k]));
      store_vec<T, V>(pd + u * step, gf);
    }
  }
}

// This thread's (a, off) for its vector of channels from ao (4, B, C).
template <int V>
__device__ __forceinline__ void load_affine(const float* __restrict__ ao, const Plan& p, int b,
                                            int c, float (&av)[V], float (&ov)[V]) {
  const float* pa = ao + (long)b * p.C + c;
  const float* po = pa + (long)p.B * p.C;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    av[k] = pa[k];
    ov[k] = po[k];
  }
}

// The per-thread sums of grad_sum_rows over rows [r0, r1) of sample b for
// the channel vectors from cv0 on (zero for a thread off the channels).
template <typename T, int V>
__device__ __forceinline__ void thread_grad_sums(const T* __restrict__ x, const T* __restrict__ g,
                                                 const float* __restrict__ ao, const Plan& p,
                                                 int b, int cv0, int r0, int r1, int silu,
                                                 float (&sx)[V], float (&sg)[V]) {
  const int tx = threadIdx.x % p.cvb, ty = threadIdx.x / p.cvb, R = NT / p.cvb;
#pragma unroll
  for (int k = 0; k < V; ++k) sx[k] = sg[k] = 0.f;
  if (ty >= R || (cv0 + tx) * V >= p.C) return;
  float av[V], ov[V];
  load_affine<V>(ao, p, b, (cv0 + tx) * V, av, ov);
  const long first = ((long)b * p.N + r0 + ty) * p.C + (long)(cv0 + tx) * V;
  const T* px = x + first;
  const T* pg = g + first;
  const long step = (long)R * p.C;
  int left = r0 + ty < r1 ? (r1 - r0 - ty + R - 1) / R : 0;
  grad_sum_rows<T, V, 4>(px, pg, step, left, av, ov, silu, sx, sg);
  grad_sum_rows<T, V, 1>(px, pg, step, left, av, ov, silu, sx, sg);
}

// The split design's first launch: grid (splits, channel chunks, B); each
// block writes its rows' sums of g' x and g' per channel to ws (B, splits,
// C, 2), meeting its threads' partial sums in shared memory in a fixed
// order (block_moments's reduction).
template <typename T, int V>
__global__ void __launch_bounds__(NT, 2)
gn_silu_bwd_sums_kernel(const T* __restrict__ x, const T* __restrict__ g,
                        const float* __restrict__ ao, float* __restrict__ ws, Plan p, int silu) {
  extern __shared__ float smem[];
  const int s = blockIdx.x, b = blockIdx.z;
  const int chb = p.cvb * V, c0 = blockIdx.y * chb;
  const int nch = chb < p.C - c0 ? chb : p.C - c0;
  const int r0 = s * p.rows, r1 = p.N < r0 + p.rows ? p.N : r0 + p.rows;
  float sx[V], sg[V];
  thread_grad_sums<T, V>(x, g, ao, p, b, blockIdx.y * p.cvb, r0, r1, silu, sx, sg);
  float* red = smem;
  float* csx = red + NT * 2 * V;
  float* csg = csx + chb;
  block_reduce<V>(p, sx, sg, nch, red, csx, csg);
  float* w = ws + (((long)b * gridDim.x + s) * p.C + c0) * 2;
  for (int j = threadIdx.x; j < nch; j += NT) {
    w[2 * j] = csx[j];
    w[2 * j + 1] = csg[j];
  }
}

// GroupNorm's gradient, grid (splits, channel chunks, B).  LOCAL (design
// fused): one block a (sample, chunk of whole groups) over all N rows, which
// forms the sums of g' x and g' itself in a first pass over its rows; else
// (design split) the sums come from ws, added in split order, for every
// channel of the groups the chunk touches (a chunk narrower than a group
// folds its whole group).  Then the fold's backward in shared memory, the
// split-0 block's shares of dL/dgamma and dL/dbeta, and dx over its rows,
// which it reads again (from L1/L2 in the fused design).
template <typename T, int V, bool LOCAL>
__global__ void __launch_bounds__(NT, 2)
gn_silu_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
                   const float* __restrict__ ao, const float* __restrict__ gamma,
                   const float* __restrict__ ws, T* __restrict__ dx, float* __restrict__ shares,
                   Plan p, float eps, int silu, int nf_cap) {
  extern __shared__ float smem[];
  const int b = blockIdx.z, chb = p.cvb * V, c0 = blockIdx.y * chb;
  const int nch = chb < p.C - c0 ? chb : p.C - c0;
  const int cgr = p.C / p.G;
  const int f0 = (c0 / cgr) * cgr;
  const int f1e = ((c0 + nch + cgr - 1) / cgr) * cgr;
  const int f1 = f1e < p.C ? f1e : p.C, nf = f1 - f0;  // the groups the chunk touches
  const int r0 = blockIdx.x * p.rows, r1 = p.N < r0 + p.rows ? p.N : r0 + p.rows;
  float* sda = smem;      // sum g' x, then 2 dL/dS2
  float* sdo = sda + nf_cap;  // sum g', then dL/dS1
  float* mu = sdo + nf_cap;   // E[x]
  float* m2 = mu + nf_cap;    // E[x^2]
  float* tm = m2 + nf_cap;    // each channel's share of dL/d(group mean)
  float* tr = tm + nf_cap;    // ... of dL/d(group rstd)
  const long bc = (long)p.B * p.C, row = (long)b * p.C;
  if constexpr (LOCAL) {
    float sx[V], sg[V];
    thread_grad_sums<T, V>(x, g, ao, p, b, blockIdx.y * p.cvb, r0, r1, silu, sx, sg);
    block_reduce<V>(p, sx, sg, nch, tr + nf_cap, sda, sdo);  // the chunk is the region
  } else {
    for (int j = threadIdx.x; j < nf; j += NT) {
      float a = 0.f, q = 0.f;
      for (int s2 = 0; s2 < p.splits; ++s2) {
        const float2 v = *reinterpret_cast<const float2*>(
            ws + (((long)b * p.splits + s2) * p.C + f0 + j) * 2);
        a += v.x;
        q += v.y;
      }
      sda[j] = a;
      sdo[j] = q;
    }
  }
  for (int j = threadIdx.x; j < nf; j += NT) {
    mu[j] = ao[2 * bc + row + f0 + j];
    m2[j] = ao[3 * bc + row + f0 + j];
  }
  __syncthreads();
  for (int j = threadIdx.x; j < nf; j += NT) {
    const int c = f0 + j, gj = (c / cgr) * cgr - f0;
    float mg = 0.f, qg = 0.f;
    for (int i = 0; i < cgr; ++i) {
      mg += mu[gj + i];
      qg += m2[gj + i];
    }
    mg /= (float)cgr;
    qg /= (float)cgr;
    const float rstd = rsqrtf(qg - mg * mg + eps);
    const float gam = gamma[c];
    const float a0 = rstd * gam, doff = sdo[j];
    const float da = sda[j] - doff * mg;
    if (blockIdx.x == 0 && c >= c0 && c < c0 + nch) {
      shares[2 * row + c] = da * rstd;
      shares[2 * row + p.C + c] = doff;
    }
    tm[j] = -a0 * doff;
    tr[j] = da * gam;
  }
  __syncthreads();
  const float n = (float)p.N;
  for (int j = threadIdx.x; j < nf; j += NT) {
    const int c = f0 + j, gj = (c / cgr) * cgr - f0;
    float mg = 0.f, qg = 0.f, sm = 0.f, sr = 0.f;
    for (int i = 0; i < cgr; ++i) {
      mg += mu[gj + i];
      qg += m2[gj + i];
      sm += tm[gj + i];
      sr += tr[gj + i];
    }
    mg /= (float)cgr;
    qg /= (float)cgr;
    const float rstd = rsqrtf(qg - mg * mg + eps), r3 = rstd * rstd * rstd;
    const float dmu = (sm + r3 * mg * sr) / (float)cgr, dm2 = -0.5f * r3 * sr / (float)cgr;
    sda[j] = 2.f * dm2 / n;
    sdo[j] = dmu / n;
  }
  __syncthreads();
  const int tx = threadIdx.x % p.cvb, ty = threadIdx.x / p.cvb, R = NT / p.cvb;
  const int cv0 = blockIdx.y * p.cvb;
  if (ty >= R || (cv0 + tx) * V >= p.C) return;
  const int cl = (cv0 + tx) * V;  // this thread's first channel
  float av[V], ov[V], g0[V], g1[V];
  load_affine<V>(ao, p, b, cl, av, ov);
#pragma unroll
  for (int k = 0; k < V; ++k) {
    g0[k] = sda[cl - f0 + k];
    g1[k] = sdo[cl - f0 + k];
  }
  const long first = ((long)b * p.N + r0 + ty) * p.C + cl;
  const T* px = x + first;
  const T* pg = g + first;
  T* pd = dx + first;
  const long step = (long)R * p.C;
  int left = r0 + ty < r1 ? (r1 - r0 - ty + R - 1) / R : 0;
  grad_apply_rows<T, V, 4>(px, pg, pd, step, left, av, ov, g0, g1, silu);
  grad_apply_rows<T, V, 1>(px, pg, pd, step, left, av, ov, g0, g1, silu);
}

template <typename T, int V>
cudaError_t launch_silu_bwd(const void* x, const void* g, const float* ao, const float* gamma,
                            void* dx, float* ws, float* shares, float* dgamma, float* dbeta,
                            const Plan& p, float eps, int silu, int local, cudaStream_t stream) {
  if (!plan_ok(p, V, sizeof(T), x, dx) || !plan_ok(p, V, sizeof(T), g, dx))
    return cudaErrorInvalidValue;
  const dim3 grid = plan_grid(p, V);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  const int chb = p.cvb * V, cgr = p.C / p.G;
  // a local block folds its own chunk: whole groups over all rows
  if (local && (p.splits != 1 || !whole_groups(p, V))) return cudaErrorInvalidValue;
  // the widest run of whole groups a chunk touches
  const int span = ((chb + cgr - 1) / cgr + 1) * cgr;
  const int nf_cap = local ? chb : (span < p.C ? span : p.C);
  const size_t smem = sizeof(float) * (6 * (size_t)nf_cap + (local ? NT * 2 * V : 0));
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  const T* xs = static_cast<const T*>(x);
  const T* gs = static_cast<const T*>(g);
  T* ds = static_cast<T*>(dx);
  if (local) {
    const cudaError_t err = allow_smem(gn_silu_bwd_kernel<T, V, true>, smem + 256);
    if (err != cudaSuccess) return err;
    gn_silu_bwd_kernel<T, V, true><<<grid, NT, smem, stream>>>(xs, gs, ao, gamma, nullptr, ds,
                                                               shares, p, eps, silu, nf_cap);
  } else {
    const size_t smem_sums = sizeof(float) * (NT * 2 * V + 2 * (size_t)chb);
    cudaError_t err = allow_smem(gn_silu_bwd_sums_kernel<T, V>, smem_sums + 256);
    if (err != cudaSuccess) return err;
    gn_silu_bwd_sums_kernel<T, V><<<grid, NT, smem_sums, stream>>>(xs, gs, ao, ws, p, silu);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    err = allow_smem(gn_silu_bwd_kernel<T, V, false>, smem + 256);
    if (err != cudaSuccess) return err;
    gn_silu_bwd_kernel<T, V, false><<<grid, NT, smem, stream>>>(xs, gs, ao, gamma, ws, ds, shares,
                                                                p, eps, silu, nf_cap);
  }
  const cudaError_t launched = cudaGetLastError();
  if (launched != cudaSuccess) return launched;
  gn_batch_sum_kernel<<<(p.C + 15) / 16, NT, 0, stream>>>(shares, dgamma, dbeta, p.B, p.C);
  return cudaGetLastError();
}

}  // namespace

// GroupNorm's gradient (gn_silu_bwd_kernel, after gn_silu_bwd_sums_kernel
// where `local` is 0, then gn_batch_sum_kernel): from x, the output's
// gradient g (x's dtype) and the forward's ao (4, B, C), dx in x's dtype and
// dgamma, dbeta (C) float32.  shares is (B, 2, C) float32 scratch; ws
// (B, splits, C, 2) float32 scratch, read where `local` is 0.
extern "C" int pddm_group_norm_silu_grad(const void* x, const void* g, const void* ao,
                                         const void* gamma, void* dx, void* ws, void* shares,
                                         void* dgamma, void* dbeta, int B, int N, int C, int G,
                                         float eps, int silu, int is_bf16, int V, int cvb,
                                         int splits, int rows, int local, void* stream_ptr) {
  if (ao == nullptr || gamma == nullptr || dx == nullptr || shares == nullptr ||
      dgamma == nullptr || dbeta == nullptr || (!local && ws == nullptr))
    return cudaErrorInvalidValue;
  const Plan p{B, N, C, G, cvb, splits, rows, kLocal};
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const float* f[2] = {static_cast<const float*>(ao), static_cast<const float*>(gamma)};
  float* w = static_cast<float*>(ws);
  float* sh = static_cast<float*>(shares);
  float* dg = static_cast<float*>(dgamma);
  float* db = static_cast<float*>(dbeta);
#define PDDM_GN_CASE(T, W)                                                                    \
  case W:                                                                                     \
    return launch_silu_bwd<T, W>(x, g, f[0], f[1], dx, w, sh, dg, db, p, eps, silu, local, \
                                 stream)
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
