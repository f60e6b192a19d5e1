// GroupNorm's gradient (+ SiLU): replaces _gns_bwd in
// probabilisticdeepdiffusionmodels_tpu/ops/groupnorm_pallas.py, the jax.vjp
// of group_norm_silu_xla.  groupnorm.cu's header lists the designs; this
// file holds their kernels so that nvcc builds them beside that file's.
//
// Bound by bytes on the H100: x and g read once, dx written once (about 20
// float32 operations an element).  Three designs
// (ops/groupnorm.py::groupnorm_grad_design):
//
// tma_resident (bf16 where the fused design applies, 16-byte rows and
//   addresses; ops/groupnorm.py::resident_plan).  What bounded fused, timed
//   on an H100 80GB HBM3 at 700 W by time_groupnorm.py --grad: at the UNet's
//   4x4 and 8x8 attention norms (batch 128) its block kernel took 10.1 and
//   12.6 us for 1.1 and 3.9 us of bytes, the chain of its phases (two reads
//   of x and g, the second from L1/L2 after the fold's barriers, 4 chunks a
//   sample whatever N) and not its bytes; at 16x16 25.8 us for 15.2; its
//   batch sums' own launch 2.1-2.8 us a call.  Here an item is a chunk of
//   whole groups (chb channels) of spb samples over all N rows:
//   - x and g land once in shared memory by TMA: 4-D tensor maps over
//     (bw, C / bw, N, B) (bw: a box's inner width, <= 256, dividing chb),
//     boxes of (chb channels x srows rows x one sample), no swizzle, so a
//     stage's rows lie dense; each sample's rows in `stages` stages, each on
//     its own mbarrier (one stage a sample measured 0.8-1.5 us faster at
//     16x16, time_groupnorm.py --grad --vary STAGES=1; two are kept so the
//     sums start on the first); a, off, E[x], E[x^2] and gamma land by bulk
//     copies on the first stage's mbarrier (loaded from device memory by the
//     consumers, each load waited a round trip under the TMA traffic);
//   - the block is warp-specialised: one copying warp lands items and, once
//     the consumers have written an item's dx (an mbarrier, one arrival a
//     consumer warp), stores it by TMA from over g's stages and refills that
//     buffer; 256 consumer threads sum g' x and g' (8 channels a thread),
//     reduce by shuffles and the warps' partials in a fixed order, run the
//     fold's backward (group sums by shuffles where a group is a power of
//     two of at most 32 channels, else in shared memory), write the
//     sample's shares of dgamma and dbeta and dx, meeting at two named
//     barriers an item;
//   - the grid is sized to the card per site: where the items fit the card
//     at once, one block an item; else a persistent grid (the blocks an SM
//     whose rounds over the items leave the fewest block slots idle) with 3
//     (or 2) buffers a block, so the next items land while one is worked
//     (16x16, batch 128: 1,024 items of 32 channels, 264 blocks, two an SM,
//     3.88 items a block);
//   - shared memory is read and written by explicit 16-byte ld/st.shared:
//     through generic pointers the compiler split each 16-byte access into
//     eight 16-bit generic loads (about 1.25x the time at 16x16);
//   - the batch sums (gn_batch_sum_pdl_kernel) are a programmatic dependent
//     launch: griddepcontrol.launch_dependents once a block has nothing left
//     to load (copying warp) and its last shares are stored (consumers), and
//     the sums kernel waits in griddepcontrol.wait until every block has
//     completed and its writes are visible.  Its launch overlaps the main
//     kernel instead of following it; a captured CUDA graph keeps the edge
//     programmatic (chip_smoke.graph_edges).  A fixed-order tail in the main
//     kernel was not built: groupnorm.cuh records that one cost more than a
//     launch at every gn_affine site.
//   Two launches.
// fused (float32; bf16 by name): gn_silu_bwd_kernel<LOCAL>, the forward's
//   fused chunks: a block sums its rows, folds backwards in shared memory and
//   reads x and g again (from L1/L2) for dx; then gn_batch_sum_kernel.  Two
//   launches.
// split (long inputs): gn_silu_bwd_sums_kernel, then gn_silu_bwd_kernel
//   adds the splits' sums and writes dx; then gn_batch_sum_kernel.
// No float atomics, no counters: the same bits on every run.
#include "hopper.cuh"
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

// ------------------------------------------------------------ design tma_resident

// Launch geometry of tma_resident, from ops/groupnorm.py::resident_plan.  An
// item is spb samples and a chunk of chb channels (whole groups, a multiple
// of 8) over all N rows; each sample's rows land in `stages` boxes of srows
// rows.  `grid` blocks take the items in turn (block i items i, i + grid,
// ...), with `bufs` buffers of an item (up to 3 where a block takes more
// than one, so later items land while one is worked).  bw is a box's inner
// width (the launcher sets it).
struct ResidentPlan {
  int B, N, C, G;
  int chb, spb, srows, stages, grid, bufs, bw;
};

constexpr int kAux = 5;  // a buffer's rows of (sample, channel) floats: a, off, E[x], E[x^2], gamma
constexpr int kConsumers = 256;  // consumer threads of a tma_resident block
constexpr int kConsumerWarps = kConsumers / 32;
constexpr int kResidentThreads = kConsumers + 32;  // and one copying warp

// Threads and shared memory of a tma_resident block.  A consumer thread
// takes 8 channels (one 16-byte vector) of one sample: cvb vectors across, R
// thread rows a sample, the item's rows ty, ty + R, ... of its sample; the
// last warp copies.  Shared memory: `bufs` buffers, each the x stages, the g
// stages (each 128-byte aligned) and the item's a, off, E[x], E[x^2] and
// gamma (kAux floats a (sample, channel)); four floats a (sample, channel)
// for the fold's backward; the reduction's partials; a buffer's mbarriers:
// one a stage (landed) and one for its dx (written).  Mirrored by
// ops/groupnorm.py::resident_smem.
struct ResidentLayout {
  int cvb, R, per, S, SB, nf, nred, items, chunks;
  size_t buf;  // bytes of a buffer
  bool shfl;   // a warp's lanes hold whole thread rows of one sample
  size_t bytes;
  __host__ __device__ explicit ResidentLayout(const ResidentPlan& p) {
    cvb = p.chb / 8;
    R = kConsumers / (cvb * p.spb);
    per = cvb * R;
    S = p.spb * p.stages;
    SB = (p.srows * p.chb * 2 + 127) / 128 * 128;
    nf = p.spb * p.chb;
    shfl = 32 % cvb == 0 && per % 32 == 0;
    nred = shfl ? kConsumers / 32 * cvb * 16 : p.spb * per * 16;
    chunks = p.C / p.chb;
    items = chunks * ((p.B + p.spb - 1) / p.spb);
    buf = 2 * (size_t)S * SB + (4 * (size_t)kAux * nf + 127) / 128 * 128;
    bytes = 128 + p.bufs * buf + 4 * (4 * (size_t)nf + nred) + 8 * (size_t)p.bufs * (S + 1);
  }
};

// The first row of [lo, ...) that thread row ty of R takes.
__device__ __forceinline__ int first_row(int lo, int ty, int R) {
  return lo <= ty ? ty : ty + (lo - ty + R - 1) / R * R;
}

// 8 bf16 of shared memory as floats, and back: one 16-byte shared-memory
// access each (through a generic pointer the compiler splits the vector
// into 16-bit generic loads)
__device__ __forceinline__ void lds_bf16x8(const void* p, float (&f)[8]) {
  uint32_t r[4];
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    f[2 * k] = __uint_as_float(r[k] << 16);
    f[2 * k + 1] = __uint_as_float(r[k] & 0xffff0000u);
  }
}
__device__ __forceinline__ void sts_bf16x8(void* p, const float (&f)[8]) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(smem_u32(p)),
               "r"(pack_bf16(f[0], f[1])), "r"(pack_bf16(f[2], f[3])),
               "r"(pack_bf16(f[4], f[5])), "r"(pack_bf16(f[6], f[7]))
               : "memory");
}

// The sum of v over the aligned groups of `cg` lanes (a power of two).
__device__ __forceinline__ float group_sum(float v, int cg) {
  for (int o = 1; o < cg; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// GroupNorm's gradient, design tma_resident: `grid` blocks, each over its
// items in turn, warp-specialised.  The copying warp lands each item (x and
// g by TMA, the statistics and gamma by bulk copies), and once the
// consumers have written an item's dx it stores it by TMA and refills that
// buffer with the block's item `bufs` further on; the consumers sum,
// reduce, fold and write dx, meeting at two named barriers an item.
// GSHFL: the fold's group sums by shuffles (a group is a power of two of at
// most 32 channels, an item at most kConsumers entries), else in shared memory.
template <bool SHFL, bool GSHFL>
__global__ void __launch_bounds__(kResidentThreads)
gn_silu_bwd_resident_kernel(const float* __restrict__ ao, const float* __restrict__ gamma,
                            float* __restrict__ shares, ResidentPlan p, float eps, int silu,
                            const __grid_constant__ CUtensorMap xmap,
                            const __grid_constant__ CUtensorMap gmap,
                            const __grid_constant__ CUtensorMap dxmap) {
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // 128-byte aligned, and derived from smem_raw by arithmetic alone, so the
  // compiler keeps every access below in shared memory
  unsigned char* base = smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127);
  const ResidentLayout L(p);
  const int nf = L.nf;
  const int SBe = L.SB / 2;  // a stage, in elements
  // buffer u: x stages, g stages L.S stages further, then the aux rows
  auto xs = [&](int u) { return reinterpret_cast<bf16*>(base + u * L.buf); };
  auto aux = [&](int u) {
    return reinterpret_cast<float*>(base + u * L.buf + 2 * (size_t)L.S * L.SB);
  };
  float* sda = reinterpret_cast<float*>(base + p.bufs * L.buf);
  float* sdo = sda + nf;  // sda: sum g' x, then 2 dL/dS2; sdo: sum g', then dL/dS1
  float* tm = sdo + nf;   // each channel's share of dL/d(group mean)
  float* tr = tm + nf;    // ... of dL/d(group rstd)
  float* red = tr + nf;   // the threads' (or warps') partial sums
  uint64_t* full = reinterpret_cast<uint64_t*>(red + L.nred);  // L.S a buffer
  uint64_t* written = full + p.bufs * L.S;                      // one a buffer
  const int t = threadIdx.x;
  const long bc = (long)p.B * p.C;
  // item `it`: its first sample and channel, its samples
  auto first_sample = [&](int it) { return it / L.chunks * p.spb; };
  auto first_channel = [&](int it) { return it % L.chunks * p.chb; };
  auto samples = [&](int it) {
    const int b0 = first_sample(it);
    return p.spb < p.B - b0 ? p.spb : p.B - b0;
  };
  if (t == kConsumers) {
    for (int s = 0; s < p.bufs * L.S; ++s) mbar_init(full + s, 1);
    for (int u = 0; u < p.bufs; ++u) mbar_init(written + u, kConsumerWarps);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (t >= kConsumers) {
    // ------------------------------------------------ the copying warp
    if (t == kConsumers) {
      // item `it` into buffer u: a box of x and one of g a stage, in row
      // order (rows past N arrive zero-filled and count), and with each
      // sample's first stage its rows of a, off, E[x], E[x^2] (and gamma
      // with the first sample's)
      auto load = [&](int it, int u) {
        const uint32_t box = 2u * p.srows * p.chb * 2, row = 4u * p.chb;
        const int b0 = first_sample(it), c0 = first_channel(it), cb = c0 / p.bw;
        float* a = aux(u);
        for (int s = 0; s < samples(it) * p.stages; ++s) {
          const int j = s / p.stages, r0 = s % p.stages * p.srows;
          uint64_t* bar = full + u * L.S + s;
          if (r0 == 0) {
            mbar_expect_tx(bar, box + 4 * row + (j == 0 ? row : 0));
            for (int q = 0; q < 4; ++q)
              bulk_load(a + q * nf + j * p.chb, ao + q * bc + (long)(b0 + j) * p.C + c0, row,
                        bar);
            if (j == 0) bulk_load(a + 4 * nf, gamma + c0, row, bar);
          } else {
            mbar_expect_tx(bar, box);
          }
          tma_load_4d(xs(u) + (size_t)s * SBe, &xmap, bar, 0, cb, r0, b0 + j);
          tma_load_4d(xs(u) + (size_t)(L.S + s) * SBe, &gmap, bar, 0, cb, r0, b0 + j);
        }
      };
      for (int u = 0; u < p.bufs && blockIdx.x + u * gridDim.x < L.items; ++u)
        load(blockIdx.x + u * gridDim.x, u);
      for (int it = blockIdx.x, k = 0; it < L.items; it += gridDim.x, ++k) {
        const int u = k % p.bufs, b0 = first_sample(it), c0 = first_channel(it);
        if (it + (int)gridDim.x >= L.items) launch_dependents();  // nothing more to load
        mbar_wait(written + u, k / p.bufs & 1);  // the consumers' dx of item k
        bf16* gb = xs(u) + (size_t)L.S * SBe;
        for (int s = 0; s < samples(it) * p.stages; ++s)
          tma_store_4d(&dxmap, gb + (size_t)s * SBe, 0, c0 / p.bw, s % p.stages * p.srows,
                       b0 + s / p.stages);
        bulk_commit();
        if (it + p.bufs * (int)gridDim.x < L.items) {
          bulk_wait_read<0>();  // the stores have read the buffer
          load(it + p.bufs * gridDim.x, u);
        }
      }
      bulk_wait_read<0>();
    }
    return;
  }
  // -------------------------------------------------- the consumers
  const int j = t / L.per, ty = t % L.per / L.cvb, tx = t % L.cvb, cl = tx * 8;
  const int cg = p.C / p.G;
  const float inv_cg = 1.f / (float)cg, inv_n = 1.f / (float)p.N;
  const int step = L.R * p.chb;  // from one of this thread's rows to its next
  for (int it = blockIdx.x, k = 0; it < L.items; it += gridDim.x, ++k) {
    const int u = k % p.bufs, parity = k / p.bufs & 1;
    const int b0 = first_sample(it), c0 = first_channel(it), nsb = samples(it);
    bf16* xb = xs(u);
    const float* ax = aux(u);
    const float* mu = ax + 2 * nf;  // E[x]
    const float* m2 = ax + 3 * nf;  // E[x^2]
    const float* gm = ax + 4 * nf;  // gamma, the item's channels
    uint64_t* bar = full + u * L.S;
    const bool active = j < nsb;
    // this thread's first row in stage q of its sample (from `r`, the row's
    // index), or nullptr where it has none there; the stage's end in `r1`
    auto first = [&](int q, int& r, int& r1) -> bf16* {
      r1 = p.N < (q + 1) * p.srows ? p.N : (q + 1) * p.srows;
      r = first_row(q * p.srows, ty, L.R);
      if (r >= r1) return nullptr;
      return xb + (size_t)(j * p.stages + q) * SBe + (r - q * p.srows) * p.chb + cl;
    };
    float av[8], ov[8], sx[8], sg[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) sx[e] = sg[e] = 0.f;
    if (active) {
      mbar_wait(bar + j * p.stages, parity);  // the sample's aux rows and first stage
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        av[e] = ax[j * p.chb + cl + e];
        ov[e] = ax[nf + j * p.chb + cl + e];
      }
      for (int q = 0; q < p.stages; ++q) {
        int r, r1;
        const bf16* px = first(q, r, r1);
        if (px == nullptr) continue;
        const bf16* pg = px + (size_t)L.S * SBe;
        if (q > 0) mbar_wait(bar + j * p.stages + q, parity);
#pragma unroll 2
        for (; r < r1; r += L.R, px += step, pg += step) {
          float xf[8], gf[8];
          lds_bf16x8(px, xf);
          lds_bf16x8(pg, gf);
          silu_grad_vec<8>(xf, gf, av, ov, silu);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            sg[e] += gf[e];
            sx[e] = fmaf(gf[e], xf[e], sx[e]);
          }
        }
      }
    }
    // the partial sums of each (sample, channel), added in a fixed order
    if constexpr (SHFL) {
      for (int o = L.cvb; o < 32; o <<= 1) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          sx[e] += __shfl_xor_sync(0xffffffffu, sx[e], o);
          sg[e] += __shfl_xor_sync(0xffffffffu, sg[e], o);
        }
      }
      const int lane = t & 31;
      if (lane < L.cvb) {
        float* mine = red + ((t >> 5) * L.cvb + lane) * 16;
#pragma unroll
        for (int e = 0; e < 8; ++e) mine[e] = sx[e], mine[8 + e] = sg[e];
      }
    } else if (t < p.spb * L.per) {
      float* mine = red + t * 16;
#pragma unroll
      for (int e = 0; e < 8; ++e) mine[e] = sx[e], mine[8 + e] = sg[e];
    }
    bar_sync_named(1, kConsumers);
    // entry i's sums of g' x and g' (sample i / chb, channel i % chb)
    auto sums = [&](int i, float& a, float& q) {
      const int jj = i / p.chb, c = i % p.chb, cv = c / 8, e = c % 8;
      a = q = 0.f;
      if constexpr (SHFL) {
        const int wps = L.per / 32;  // warps of a sample
        for (int w = 0; w < wps; ++w) {
          const float* o = red + ((jj * wps + w) * L.cvb + cv) * 16;
          a += o[e];
          q += o[8 + e];
        }
      } else {
        for (int y = 0; y < L.R; ++y) {
          const float* o = red + (jj * L.per + y * L.cvb + cv) * 16;
          a += o[e];
          q += o[8 + e];
        }
      }
    };
    // the fold's backward on the item's groups (gn_silu_bwd_kernel's), with
    // the sample's shares of dL/dgamma and dL/dbeta stored
    if constexpr (GSHFL) {
      if (t < (nsb * p.chb + 31) / 32 * 32) {  // whole warps: the shuffles take every lane
        const int i = t < nsb * p.chb ? t : nsb * p.chb - 1, c = i % p.chb;
        float a, q;
        sums(i, a, q);
        const float mg = group_sum(mu[i], cg) * inv_cg;
        const float qg = group_sum(m2[i], cg) * inv_cg;
        const float rstd = rsqrtf(qg - mg * mg + eps), r3 = rstd * rstd * rstd;
        const float gam = gm[c];
        const float doff = q, da = a - doff * mg;
        const float sm = group_sum(-rstd * gam * doff, cg);
        const float sr = group_sum(da * gam, cg);
        if (t < nsb * p.chb) {
          const long sh = 2 * (long)(b0 + i / p.chb) * p.C + c0 + c;
          shares[sh] = da * rstd;
          shares[sh + p.C] = doff;
          const float dmu = (sm + r3 * mg * sr) * inv_cg, dm2 = -0.5f * r3 * sr * inv_cg;
          sda[i] = 2.f * dm2 * inv_n;
          sdo[i] = dmu * inv_n;
        }
      }
      bar_sync_named(1, kConsumers);
    } else {
      for (int i = t; i < nsb * p.chb; i += kConsumers) sums(i, sda[i], sdo[i]);
      bar_sync_named(1, kConsumers);
      for (int i = t; i < nsb * p.chb; i += kConsumers) {
        const int c = i % p.chb, gi = i - c + c / cg * cg;  // the first entry of i's group
        float mg = 0.f, qg = 0.f;
        for (int v = 0; v < cg; ++v) {
          mg += mu[gi + v];
          qg += m2[gi + v];
        }
        mg *= inv_cg;
        qg *= inv_cg;
        const float rstd = rsqrtf(qg - mg * mg + eps);
        const float gam = gm[c];
        const float a0 = rstd * gam, doff = sdo[i];
        const float da = sda[i] - doff * mg;
        const long sh = 2 * (long)(b0 + i / p.chb) * p.C + c0 + c;
        shares[sh] = da * rstd;
        shares[sh + p.C] = doff;
        tm[i] = -a0 * doff;
        tr[i] = da * gam;
      }
      bar_sync_named(1, kConsumers);
      for (int i = t; i < nsb * p.chb; i += kConsumers) {
        const int c = i % p.chb, gi = i - c + c / cg * cg;
        float mg = 0.f, qg = 0.f, sm = 0.f, sr = 0.f;
        for (int v = 0; v < cg; ++v) {
          mg += mu[gi + v];
          qg += m2[gi + v];
          sm += tm[gi + v];
          sr += tr[gi + v];
        }
        mg *= inv_cg;
        qg *= inv_cg;
        const float rstd = rsqrtf(qg - mg * mg + eps), r3 = rstd * rstd * rstd;
        const float dmu = (sm + r3 * mg * sr) * inv_cg, dm2 = -0.5f * r3 * sr * inv_cg;
        sda[i] = 2.f * dm2 * inv_n;
        sdo[i] = dmu * inv_n;
      }
      bar_sync_named(1, kConsumers);
    }
    if (it + (int)gridDim.x >= L.items) launch_dependents();  // the block's last shares are stored
    // dx = g' a + x 2 dL/dS2 + dL/dS1 from shared memory, over g's stages;
    // the copying warp stores them
    if (active) {
      float g0[8], g1[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        g0[e] = sda[j * p.chb + cl + e];
        g1[e] = sdo[j * p.chb + cl + e];
      }
      for (int q = 0; q < p.stages; ++q) {
        int r, r1;
        const bf16* px = first(q, r, r1);
        if (px == nullptr) continue;
        bf16* pg = const_cast<bf16*>(px) + (size_t)L.S * SBe;
#pragma unroll 2
        for (; r < r1; r += L.R, px += step, pg += step) {
          float xf[8], gf[8];
          lds_bf16x8(px, xf);
          lds_bf16x8(pg, gf);
          silu_grad_vec<8>(xf, gf, av, ov, silu);
#pragma unroll
          for (int e = 0; e < 8; ++e) gf[e] = fmaf(gf[e], av[e], fmaf(xf[e], g0[e], g1[e]));
          sts_bf16x8(pg, gf);
        }
      }
    }
    fence_async_shared();  // this thread's dx before the TMA stores read it
    __syncwarp();
    if ((t & 31) == 0) mbar_arrive(written + u);
  }
}

// The batch sums of tma_resident, a programmatic dependent of its main
// kernel: gn_batch_sum_kernel's sums with four channels a block (32 parts a
// column: more blocks and fewer dependent loads a thread, since after
// griddepcontrol.wait its time is the tail of the call).  (A warp a column
// with a tree of shuffles, its loads 32 samples apart, took longer.)
__global__ void __launch_bounds__(NT)
gn_batch_sum_pdl_kernel(const float* __restrict__ shares, float* __restrict__ dgamma,
                        float* __restrict__ dbeta, int B, int C) {
  grid_dependency_wait();
  batch_sums<4>(shares, dgamma, dbeta, B, C);
}

cudaError_t launch_silu_bwd_resident(const void* x, const void* g, const float* ao,
                                     const float* gamma, void* dx, float* shares, float* dgamma,
                                     float* dbeta, ResidentPlan p, float eps, int silu,
                                     cudaStream_t stream) {
  // refuse a plan whose tiling would overrun a buffer or a box
  if (p.B < 1 || p.N < 1 || p.G < 1 || p.C % p.G || p.C % 8 || p.chb < 8 || p.chb % 8 ||
      p.chb % (p.C / p.G) || p.C % p.chb || p.spb < 1 || p.spb > kConsumers / 32 ||
      p.chb / 8 * p.spb > kConsumers || p.srows < 1 || p.srows > 256 || p.stages < 1 ||
      (long)p.stages * p.srows < p.N || (long)(p.stages - 1) * p.srows >= p.N || p.grid < 1 ||
      p.bufs < 1 || p.bufs > 3)
    return cudaErrorInvalidValue;
  // TMA's boxes and the bulk copies of ao's and gamma's rows: 16-byte aligned
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(g) |
       reinterpret_cast<uintptr_t>(dx) | reinterpret_cast<uintptr_t>(ao) |
       reinterpret_cast<uintptr_t>(gamma)) % 16)
    return cudaErrorInvalidValue;
  p.bw = p.chb < 256 ? p.chb : 256;  // a box's inner width: <= 256, dividing chb
  while (p.chb % p.bw) p.bw -= 8;
  const ResidentLayout L(p);
  // a block over several items reloads a buffer only after its next item
  if (p.chb / p.bw > 256 || p.grid > L.items || (p.grid < L.items && p.bufs < 2) ||
      L.bytes > 227 * 1024)
    return cudaErrorInvalidValue;
  const cuuint64_t dims[4] = {(cuuint64_t)p.bw, (cuuint64_t)(p.C / p.bw), (cuuint64_t)p.N,
                              (cuuint64_t)p.B};
  const cuuint32_t box[4] = {(cuuint32_t)p.bw, (cuuint32_t)(p.chb / p.bw), (cuuint32_t)p.srows,
                             1};
  CUtensorMap xmap, gmap, dxmap;
  cudaError_t err = encode_bf16_map(&xmap, x, 4, dims, box, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err == cudaSuccess) err = encode_bf16_map(&gmap, g, 4, dims, box, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err == cudaSuccess)
    err = encode_bf16_map(&dxmap, dx, 4, dims, box, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err != cudaSuccess) return err;
  const int cg = p.C / p.G;
  const bool gshfl = (cg & (cg - 1)) == 0 && cg <= 32 && L.nf <= kConsumers;
  auto* kernel = L.shfl ? (gshfl ? gn_silu_bwd_resident_kernel<true, true>
                                 : gn_silu_bwd_resident_kernel<true, false>)
                        : (gshfl ? gn_silu_bwd_resident_kernel<false, true>
                                 : gn_silu_bwd_resident_kernel<false, false>);
  if ((err = allow_smem(kernel, L.bytes)) != cudaSuccess) return err;
  kernel<<<p.grid, kResidentThreads, L.bytes, stream>>>(ao, gamma, shares, p, eps, silu, xmap,
                                                        gmap, dxmap);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((p.C + 3) / 4);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, gn_batch_sum_pdl_kernel, static_cast<const float*>(shares),
                           dgamma, dbeta, p.B, p.C);
  return err != cudaSuccess ? err : cudaGetLastError();
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

// GroupNorm's gradient, design tma_resident (gn_silu_bwd_resident_kernel,
// then gn_batch_sum_pdl_kernel as its programmatic dependent): from bf16 x,
// the output's gradient g and the forward's ao (4, B, C), dx in bf16 and
// dgamma, dbeta (C) float32; shares is (B, 2, C) float32 scratch.  x, g and
// dx 16-byte aligned; (chb, spb, srows, stages, grid, bufs) from
// resident_plan.
extern "C" int pddm_group_norm_silu_grad_resident(const void* x, const void* g, const void* ao,
                                                  const void* gamma, void* dx, void* shares,
                                                  void* dgamma, void* dbeta, int B, int N,
                                                  int C, int G, float eps, int silu, int chb,
                                                  int spb, int srows, int stages, int grid,
                                                  int bufs, void* stream_ptr) {
  if (x == nullptr || g == nullptr || ao == nullptr || gamma == nullptr || dx == nullptr ||
      shares == nullptr || dgamma == nullptr || dbeta == nullptr)
    return cudaErrorInvalidValue;
  const ResidentPlan p{B, N, C, G, chb, spb, srows, stages, grid, bufs, 0};
  return launch_silu_bwd_resident(x, g, static_cast<const float*>(ao),
                                  static_cast<const float*>(gamma), dx,
                                  static_cast<float*>(shares), static_cast<float*>(dgamma),
                                  static_cast<float*>(dbeta), p, eps, silu,
                                  static_cast<cudaStream_t>(stream_ptr));
}
