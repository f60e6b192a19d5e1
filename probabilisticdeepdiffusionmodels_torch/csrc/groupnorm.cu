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
// turns the gradients of (a, off) into dL/dS1 and dL/dS2 per (sample,
// channel), and dL/dx = 2 x dL/dS2 + dL/dS1.  (The JAX package
// differentiates the fold by recomputing it in XLA, one fused pass;
// recomputed in eager PyTorch it is some 70 small launches a site, which
// the host issues more slowly than the card runs them.)
//
// Bound on the H100: bytes.  Moments reads x once (3 flops an element),
// apply reads it again and writes y.  So every access is as wide as the
// shape allows: a thread owns one vector of V neighbouring channels (16
// bytes: 8 bf16 or 4 float32; 8, 4 or 2 bytes where C or the address is not
// a multiple of 16) and walks down the rows, its 2 V partial sums in
// registers, eight loads in flight at a time; no index is divided per
// element.  A block is cvb channel vectors wide and 256 / cvb rows tall, and
// takes `rows` rows of one sample; its partial sums meet by warp shuffles and
// in shared memory, in a fixed order.  What is left beside the bytes is
// latency: at the UNet's small sites (4x4, 8x8: 1-4 MB at batch 128) a launch
// lasts a few microseconds whatever it reads, so every launch and every
// cross-block step that a site can do without is time.
//
// gn_affine has two designs (ops/groupnorm.py::affine_design):
//   cluster    the channels are cut into chunks of whole groups, about two
//              blocks an SM in all (ops/groupnorm.py::affine_plan).  A block
//              that takes all rows of its chunk folds its own groups: no
//              cross-block step at all; this is every site of the CIFAR-10
//              UNet at batch 128, and gives the small sites several blocks a
//              sample.  Where a chunk of a sample is long and the batch small,
//              its rows are split over at most 8 blocks launched as one
//              thread-block cluster (cudaLaunchKernelEx): each block keeps its
//              partial sums in its own shared memory, and after the cluster's
//              barrier each block reads every block's partials for its own
//              slice of whole groups through distributed shared memory, in
//              rank order, and folds them.  No workspace, no fence, no
//              counter, no atomic; the fold is spread over the cluster.
//   workspace  the first design, kept where a sample needs more blocks than
//              a cluster holds (the 256x256 sites) and, by name, for
//              measurement: N split over `splits` blocks a sample whose
//              partial sums go to a (B, splits, C, 2) workspace; the block of
//              a sample that finishes last (a counter per sample, which that
//              block sets back to 0) adds them in split order and folds every
//              channel alone.
// Neither adds floats with atomics, so two runs give the same bits.
//
// Its gradient has two designs (ops/gn_conv.py::grad_design):
//   fused_bwd       gn_affine_bwd_kernel over the chunks of whole groups: each
//                   block recomputes the fold's backward for its own sample
//                   and groups in shared memory (B x C work, repeated on each
//                   split, nothing beside the pass over x) and writes dL/dx;
//                   the split-0 block of a sample writes its shares of
//                   dL/dgamma and dL/dbeta and the conditioning's gradient in
//                   its dtype.  Then gn_batch_sum_kernel adds the shares over
//                   the batch in a fixed order.  Two launches a site.
//   fold_bwd+apply  the first design, kept for groups wider than a block and,
//                   by name, for measurement: gn_fold_bwd_kernel (one block a
//                   sample, all C channels), the apply kernel for dL/dx, and
//                   two torch sums over the batch (and a cast of the
//                   conditioning's gradient): four or five operations a site.
//
// A spatially sharded forward (each rank a slab of every image's rows)
// folds whole-image statistics: each rank's moments (this file's moments
// launch, its fold unused) are summed over the ranks in place by one
// all-reduce, and the kernel that consumes them folds them itself, with
// the rank count as the divisor (gn_fold.cuh holds the fold's arithmetic,
// which every consumer shares, so each gets gn_fold_kernel's bits).  The
// slab's GroupNorm is gn_fold_apply_kernel: each block folds the groups its
// chunk touches in shared memory and applies them, one launch in place of
// a fold launch and an apply launch; the fused conv folds in gn_conv.cu.
// The fold alone (gn_fold_kernel, one block a sample: from the (2, B, C)
// moments E[x], E[x^2] to the same (4, B, C) output) was the slab's first
// design; B x C work, bound by its launch (2.8 us on the H100 against
// 0.007 us of bytes), so the fold went into the consumers, which were
// launched anyway.
// It stays callable by name; no path launches it.
//
// GroupNorm has two designs (ops/groupnorm.py::groupnorm_design):
//   fused  one launch: a block owns whole groups (a chunk of channels that
//          is a multiple of C/G and of V) over all N rows of a sample, folds
//          them itself and reads its rows again, from L1/L2, to apply.  For
//          the short sequences of the attention norms (a chunk is <= 48 KB).
//          Where autograd records the op it also writes the (4, B, C) ao.
//   split  moments + fold as gn_affine runs them, then the apply kernel, for
//          long inputs (64x64 and larger), where one block per chunk would
//          leave the card idle and the second read would miss the cache.
//
// GroupNorm's gradient (replaces _gns_bwd in ops/groupnorm_pallas.py, the
// jax.vjp of the XLA form) reuses gn_affine's backward: with g' = g silu'(p),
// da = sum g' x and doff = sum g' are the gradients of the fold's (a, off),
// the fold's backward gives 2 dL/dS2, dL/dS1 and the shares of dL/dgamma and
// dL/dbeta, and dx = g' a + x 2 dL/dS2 + dL/dS1.  Its kernels are in
// groupnorm_grad.cu (what both files share: groupnorm.cuh).  Bound by bytes:
// x and g read, dx written.  Three designs (ops/groupnorm.py::groupnorm_grad_design):
//   tma_resident  (bf16 where fused applies) gn_silu_bwd_resident_kernel:
//          items of whole groups landed once in shared memory by TMA, a
//          copying warp and 256 consumers, the grid sized to the card
//          (persistent, 2-3 buffers a block, where the items outnumber what
//          the card holds at once); then gn_batch_sum_pdl_kernel as its
//          programmatic dependent.  2 launches.  groupnorm_grad.cu's header
//          has the design and what bounded fused.
//   fused  gn_silu_bwd_kernel<LOCAL>: the forward's fused chunks, a block
//          sums its rows, folds backwards in shared memory and reads x and g
//          again (from L1/L2) for dx; then gn_batch_sum_kernel.  2 launches.
//          float32, and bf16 by name.
//   split  gn_silu_bwd_sums_kernel (split rows' sums into a workspace), then
//          gn_silu_bwd_kernel adds them in split order for the groups its
//          chunk touches (a whole group where a chunk is narrower than one)
//          and writes dx over its rows; then gn_batch_sum_kernel.  3 launches.
// No float atomics: the same bits on every run.
#include <cooperative_groups.h>

#include "gn_fold.cuh"
#include "groupnorm.cuh"

using namespace pddm;
namespace cgs = cooperative_groups;

namespace {

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
  block_reduce<V>(p, s, ss, nch, red, csum, csq);
}

// The fold for sample b and the nch channels from c0 on (whole groups):
// csum/csq hold their sums over N on entry; a_out[j], off_out[j] receive the
// scale and offset of local channel j, and mean_out[j], m2_out[j] (where
// given) E[x] and E[x^2], which the backward starts from (gn_fold.cuh).
__device__ __forceinline__ void fold(const Plan& p, const Cond& cd,
                                     const float* __restrict__ gamma,
                                     const float* __restrict__ beta, float eps, int b, int c0,
                                     int nch, float* csum, float* csq, float* a_out,
                                     float* off_out, float* mean_out, float* m2_out) {
  fold_channels<NT>((float)p.N, p.C, p.G, cd, gamma, beta, eps, b, c0, nch, csum, csq, a_out,
                    off_out, mean_out, m2_out);
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

// The cluster's fold (CLUSTER launches): every block of the cluster holds
// the sums of its rows for the chunk's nch channels in csum/csq.  After the
// cluster's barrier, block `rank` takes its share of the chunk's groups,
// adds the partial sums of every block of the cluster for them in rank order
// (reads of the other blocks' shared memory), and folds them into ao; a
// second barrier keeps each block's shared memory until all have read it.
__device__ __forceinline__ void cluster_fold(const Plan& p, const Cond& cd,
                                             const float* __restrict__ gamma,
                                             const float* __restrict__ beta, float eps, int b,
                                             int c0, int nch, float* csum, float* csq,
                                             float* fsum, float* fsq, float* __restrict__ ao) {
  cgs::cluster_group cluster = cgs::this_cluster();
  cluster.sync();
  const int S = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int cgr = p.C / p.G, groups = nch / cgr, per = (groups + S - 1) / S;
  const int g_lo = min(groups, rank * per), g_hi = min(groups, g_lo + per);
  const int lo = g_lo * cgr, mine = (g_hi - g_lo) * cgr;
  for (int j = threadIdx.x; j < mine; j += NT) {
    float a = 0.f, q = 0.f;
    for (int r = 0; r < S; ++r) {
      a += *cluster.map_shared_rank(csum + lo + j, r);
      q += *cluster.map_shared_rank(csq + lo + j, r);
    }
    fsum[j] = a;
    fsq[j] = q;
  }
  __syncthreads();
  float* o = ao + (long)b * p.C + c0 + lo;  // ao is (4, B, C): a, off, E[x], E[x^2]
  const long bc = (long)p.B * p.C;
  fold(p, cd, gamma, beta, eps, b, c0 + lo, mine, fsum, fsq, o, o + bc, o + 2 * bc, o + 3 * bc);
  cluster.sync();
}

// Four blocks an SM (64 registers a thread): the batches above are sized for
// that, and the short fused launches need the residency, not the registers.
// Grid (splits, channel chunks, B).  APPLY (the fused GroupNorm): splits is
// 1 and a chunk is whole groups, so each block folds its own channels and
// applies them.  Otherwise p.fold says where a block's sums go: kLocal, the
// block folds its chunk (whole groups over all rows); kCluster (CLUSTER
// launches), the cluster of a sample's splits folds; kWorkspace, the blocks
// meet in the workspace, and the sample's last block folds.
template <typename T, int V, bool APPLY, bool CLUSTER>
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
  const bool local = APPLY || p.fold == kLocal;
  const int cap = p.fold == kWorkspace ? p.C : chb;  // channels this block may fold
  float* red = smem;                                 // [NT][2 V]
  float* csum = red + NT * 2 * V;                    // [cap]
  float* csq = csum + cap;                           // [cap]

  block_moments<T, V>(x, p, b, blockIdx.y * p.cvb, r0, r1, nch, red, csum, csq);
  if constexpr (CLUSTER) {
    cluster_fold(p, cd, gamma, beta, eps, b, c0, nch, csum, csq, csq + cap, csq + 2 * cap, ao);
    return;
  }
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
    // ao (where autograd records the op): a, off, E[x], E[x^2] for the backward
    float* o = ao == nullptr ? nullptr : ao + (long)b * p.C + fc0;
    const long bc = (long)p.B * p.C;
    fold(p, cd, gamma, beta, eps, b, fc0, fn, csum, csq, sa, so, o == nullptr ? nullptr : o + 2 * bc,
         o == nullptr ? nullptr : o + 3 * bc);
    __syncthreads();
    if (o != nullptr) {
      for (int j = threadIdx.x; j < fn; j += NT) {
        o[j] = sa[j];
        o[bc + j] = so[j];
      }
    }
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

__device__ __forceinline__ void cond_store(void* p, long i, float v, int is_bf16) {
  if (is_bf16)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(v);
  else
    static_cast<float*>(p)[i] = v;
}

// gn_affine's gradient (design fused_bwd), the first of its two launches.
// Grid (splits, channel chunks, B), every chunk whole groups.  Each block
// recomputes in shared memory the fold's backward for its sample and its
// channels, with the arithmetic of gn_fold_bwd_kernel (B x C work repeated on
// each split, nothing next to the pass over x), then writes dL/dx = x * 2
// dL/dS2 + dL/dS1 over its rows in x's dtype.  The split-0 block of a sample
// writes its shares of dL/dgamma and dL/dbeta to the (B, 2, C) `shares` and
// the emb or FiLM gradients in the conditioning's dtype; gn_batch_sum_kernel
// adds the shares over the batch.
template <typename T, int V>
__global__ void __launch_bounds__(NT, 4)
gn_affine_bwd_kernel(const T* __restrict__ x, const float* __restrict__ ao,
                     const float* __restrict__ gamma, const float* __restrict__ beta, Cond cd,
                     const float* __restrict__ ga, const float* __restrict__ goff,
                     T* __restrict__ dx, float* __restrict__ shares, void* dcond0, void* dcond1,
                     Plan p, float eps) {
  extern __shared__ float smem[];
  const int b = blockIdx.z, chb = p.cvb * V, c0 = blockIdx.y * chb;
  const int nch = chb < p.C - c0 ? chb : p.C - c0;
  const int cgr = p.C / p.G;
  const bool first = blockIdx.x == 0;
  float* mu = smem;      // E[x + e] per channel of the chunk
  float* m2 = mu + chb;  // E[(x + e)^2]
  float* tm = m2 + chb;  // each channel's share of dL/d(group mean)
  float* tr = tm + chb;  // ... of dL/d(group rstd)
  float* g0 = tr + chb;  // 2 dL/dS2
  float* g1 = g0 + chb;  // dL/dS1 (dL/d(emb) through the offset until then)
  const long bc = (long)p.B * p.C, row = (long)b * p.C;
  const float* mean_raw = ao + 2 * bc + row + c0;
  const float* m2_raw = ao + 3 * bc + row + c0;
  for (int j = threadIdx.x; j < nch; j += NT) {
    const float mr = mean_raw[j];
    const float e =
        cd.mode == 1 ? cond_at(cd.p0, (long)b * cd.stride0 + c0 + j, cd.is_bf16) : 0.f;
    mu[j] = mr + e;
    m2[j] = m2_raw[j] + 2.f * e * mr + e * e;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < nch; j += NT) {
    const int c = c0 + j, gj = (c / cgr) * cgr - c0;
    float mg = 0.f, qg = 0.f;
    for (int i = 0; i < cgr; ++i) {
      mg += mu[gj + i];
      qg += m2[gj + i];
    }
    mg /= (float)cgr;
    qg /= (float)cgr;
    const float rstd = rsqrtf(qg - mg * mg + eps);
    const float e = cd.mode == 1 ? cond_at(cd.p0, (long)b * cd.stride0 + c, cd.is_bf16) : 0.f;
    const float gam = gamma[c];
    const float a0 = rstd * gam, off0 = beta[c] - mg * a0 + e * a0;
    float da = ga[row + c], doff = goff[row + c];
    if (cd.mode == 2) {
      const float sc = 1.f + cond_at(cd.p0, (long)b * cd.stride0 + c, cd.is_bf16);
      if (first) {
        cond_store(dcond0, row + c, da * a0 + doff * off0, cd.is_bf16);
        cond_store(dcond1, row + c, doff, cd.is_bf16);
      }
      da *= sc;
      doff *= sc;
    }
    da += doff * (e - mg);
    if (first) {
      shares[2 * row + c] = da * rstd;
      shares[2 * row + p.C + c] = doff;
    }
    tm[j] = -a0 * doff;
    g1[j] = doff * a0;
    tr[j] = da * gam;
  }
  __syncthreads();
  const float n = (float)p.N;
  for (int j = threadIdx.x; j < nch; j += NT) {
    const int c = c0 + j, gj = (c / cgr) * cgr - c0;
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
    const float e = cd.mode == 1 ? cond_at(cd.p0, (long)b * cd.stride0 + c, cd.is_bf16) : 0.f;
    if (cd.mode == 1 && first)
      cond_store(dcond0, row + c, g1[j] + dmu + dm2 * (2.f * mean_raw[j] + 2.f * e), cd.is_bf16);
    g0[j] = 2.f * dm2 / n;
    g1[j] = (dmu + 2.f * e * dm2) / n;
  }
  __syncthreads();
  if (dx != nullptr) {
    const int r0 = blockIdx.x * p.rows, r1 = p.N < r0 + p.rows ? p.N : r0 + p.rows;
    apply_rows<T, V>(x, dx, p, b, blockIdx.y * p.cvb, r0, r1, g0, g1, 0);
  }
}

// The fold alone for sample b: mom is (2, B, C) float32 (E[x], E[x^2]), ao
// (4, B, C) as gn_moments_kernel writes it.  The moments go to shared memory
// and the shared fold reads them as sums over one row.
__global__ void __launch_bounds__(NT)
gn_fold_kernel(const float* __restrict__ mom, const float* __restrict__ gamma,
               const float* __restrict__ beta, Cond cd, float* __restrict__ ao, int B, int C,
               int G, float eps) {
  extern __shared__ float smem[];
  float* csum = smem;
  float* csq = smem + C;
  const int b = blockIdx.x;
  const long bc = (long)B * C, row = (long)b * C;
  for (int c = threadIdx.x; c < C; c += NT) {
    csum[c] = mom[row + c];
    csq[c] = mom[bc + row + c];
  }
  __syncthreads();
  const Plan p{B, 1, C, G, 1, 1, 1};
  fold(p, cd, gamma, beta, eps, b, 0, C, csum, csq, ao + row, ao + bc + row, ao + 2 * bc + row,
       ao + 3 * bc + row);
}

// The slab's GroupNorm (a spatially sharded forward): fold + apply in one
// launch, in place of gn_fold_kernel and gn_apply_kernel.  Grid (splits,
// channel chunks, B) as the apply kernel's.  mom (2, B, C) float32 holds the
// ranks' summed per-slab E[x], E[x^2]; each block loads them for the whole
// groups its chunk touches (a chunk may start or end inside a group) into
// shared memory, folds them there with n = ranks (fold_channels: the
// ranks' mean is sum / ranks, then gn_fold_kernel's arithmetic, so (a, off)
// have its bits) and applies (+ SiLU) to its rows.
template <typename T, int V>
__global__ void __launch_bounds__(NT, 4)
gn_fold_apply_kernel(const T* __restrict__ x, const float* __restrict__ mom,
                     const float* __restrict__ gamma, const float* __restrict__ beta,
                     T* __restrict__ y, Plan p, int ranks, float eps, int silu) {
  extern __shared__ float smem[];
  const int b = blockIdx.z, chb = p.cvb * V, c0 = blockIdx.y * chb;
  const int nch = chb < p.C - c0 ? chb : p.C - c0;
  const int cg = p.C / p.G, f0 = c0 / cg * cg;
  const int f1 = min(p.C, (c0 + nch + cg - 1) / cg * cg), span = f1 - f0;
  const int cap = chb + 2 * cg;  // channels of the groups a chunk touches, at most
  float* csum = smem;
  float* csq = csum + cap;
  float* sa = csq + cap;
  float* so = sa + cap;
  const long bc = (long)p.B * p.C, row = (long)b * p.C;
  for (int j = threadIdx.x; j < span; j += NT) {
    csum[j] = mom[row + f0 + j];
    csq[j] = mom[bc + row + f0 + j];
  }
  __syncthreads();
  const Cond cd{nullptr, nullptr, 0, 0, 0, 0};
  fold_channels<NT>((float)ranks, p.C, p.G, cd, gamma, beta, eps, b, f0, span, csum, csq, sa, so,
                    nullptr, nullptr);
  __syncthreads();
  const int r0 = blockIdx.x * p.rows, r1 = p.N < r0 + p.rows ? p.N : r0 + p.rows;
  apply_rows<T, V>(x, y, p, b, blockIdx.y * p.cvb, r0, r1, sa + (c0 - f0), so + (c0 - f0), silu);
}

template <typename T, int V>
cudaError_t launch_fold_apply(const void* x, const float* mom, const float* gamma,
                              const float* beta, void* y, const Plan& p, int ranks, float eps,
                              int silu, cudaStream_t stream) {
  if (!plan_ok(p, V, sizeof(T), x, y)) return cudaErrorInvalidValue;
  const dim3 grid = plan_grid(p, V);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  // csum, csq, a and off
  const size_t cap = p.cvb * V + 2 * (p.C / p.G);
  const size_t smem = sizeof(float) * 4 * cap;
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  const cudaError_t err = allow_smem(gn_fold_apply_kernel<T, V>, smem + 256);
  if (err != cudaSuccess) return err;
  gn_fold_apply_kernel<T, V><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(x), mom, gamma, beta, static_cast<T*>(y), p, ranks, eps, silu);
  return cudaGetLastError();
}

template <typename T, int V, bool APPLY>
cudaError_t launch_moments(const void* x, const float* gamma, const float* beta, const Cond& cd,
                           float* ao, void* y, float* ws, unsigned* counters, const Plan& p,
                           float eps, int silu, cudaStream_t stream) {
  if (!plan_ok(p, V, sizeof(T), x, y)) return cudaErrorInvalidValue;
  const dim3 grid = plan_grid(p, V);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  const int chb = p.cvb * V;
  if (p.fold < kLocal || p.fold > kWorkspace) return cudaErrorInvalidValue;
  if (APPLY && (p.splits != 1 || p.fold != kLocal)) return cudaErrorInvalidValue;
  // a block or a cluster folds only whole groups
  if (p.fold != kWorkspace && !whole_groups(p, V)) return cudaErrorInvalidValue;
  if (p.fold == kLocal && p.splits != 1) return cudaErrorInvalidValue;
  if (p.fold == kCluster && (p.splits < 2 || p.splits > kClusterMax)) return cudaErrorInvalidValue;
  if (p.fold == kWorkspace && (ws == nullptr || counters == nullptr)) return cudaErrorInvalidValue;
  const size_t cap = p.fold == kWorkspace ? p.C : chb;
  const size_t smem =
      sizeof(float) * (NT * 2 * V + (APPLY || p.fold == kCluster ? 4 : 2) * cap);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  const T* xs = static_cast<const T*>(x);
  T* ys = static_cast<T*>(y);
  if (p.fold == kCluster) {
    auto* kernel = gn_moments_kernel<T, V, false, true>;
    const cudaError_t err = allow_smem(kernel, smem + 256);
    if (err != cudaSuccess) return err;
    // the splits of one (sample, chunk) are one cluster, along grid x
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = p.splits;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(NT);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t launched =
        cudaLaunchKernelEx(&cfg, kernel, xs, gamma, beta, cd, ao, ys, ws, counters, p, eps, silu);
    return launched != cudaSuccess ? launched : cudaGetLastError();
  }
  // (the kernel's few static bytes count against the same 48 KB default)
  const cudaError_t err = allow_smem(gn_moments_kernel<T, V, APPLY, false>, smem + 256);
  if (err != cudaSuccess) return err;
  gn_moments_kernel<T, V, APPLY, false><<<grid, NT, smem, stream>>>(
      xs, gamma, beta, cd, ao, ys, ws, counters, p, eps, silu);
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t launch_affine_bwd(const void* x, const float* ao, const float* gamma,
                              const float* beta, const Cond& cd, const float* ga,
                              const float* goff, void* dx, float* shares, void* dcond0,
                              void* dcond1, float* dgamma, float* dbeta, const Plan& p, float eps,
                              cudaStream_t stream) {
  if (!plan_ok(p, V, sizeof(T), x, dx == nullptr ? x : dx) || !whole_groups(p, V))
    return cudaErrorInvalidValue;
  const dim3 grid = plan_grid(p, V);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * 6 * (size_t)(p.cvb * V);  // six floats a channel
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  const cudaError_t err = allow_smem(gn_affine_bwd_kernel<T, V>, smem + 256);
  if (err != cudaSuccess) return err;
  gn_affine_bwd_kernel<T, V><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(x), ao, gamma, beta, cd, ga, goff, static_cast<T*>(dx), shares,
      dcond0, dcond1, p, eps);
  const cudaError_t launched = cudaGetLastError();
  if (launched != cudaSuccess) return launched;
  gn_batch_sum_kernel<<<(p.C + 15) / 16, NT, 0, stream>>>(shares, dgamma, dbeta, p.B, p.C);
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
// offset, E[x] and E[x^2] per (sample, channel).  `fold` says where the
// blocks of a sample meet (kLocal, kCluster, kWorkspace); ws (B, splits, C,
// 2) float32 and counters (B, zero on entry, zero again on exit) are read
// only by kWorkspace.
extern "C" int pddm_gn_moments_fold(const void* x, const void* gamma, const void* beta,
                                    const void* cond0, const void* cond1, void* ao, void* ws,
                                    void* counters, int B, int N, int C, int G, float eps,
                                    int mode, int stride0, int stride1, int cond_is_bf16,
                                    int is_bf16, int V, int cvb, int splits, int rows, int fold,
                                    void* stream_ptr) {
  if (mode < 0 || mode > 2 || (mode >= 1 && cond0 == nullptr) || (mode == 2 && cond1 == nullptr))
    return cudaErrorInvalidValue;
  const Plan p{B, N, C, G, cvb, splits, rows, fold};
  const Cond cd{cond0, cond1, stride0, stride1, mode, cond_is_bf16};
  return moments_any<false>(is_bf16, V, x, static_cast<const float*>(gamma),
                            static_cast<const float*>(beta), cd, static_cast<float*>(ao),
                            nullptr, static_cast<float*>(ws),
                            static_cast<unsigned*>(counters), p, eps, 0,
                            static_cast<cudaStream_t>(stream_ptr));
}

// gn_affine's gradient in two launches (gn_affine_bwd_kernel, then
// gn_batch_sum_kernel): from x, the forward's ao (4, B, C) and the gradients
// ga, goff (B, C) float32 of its scale and offset, dx (x's dtype; null: not
// wanted), dgamma and dbeta (C) float32, and dcond0 (and dcond1 for FiLM)
// (B, C) contiguous in the conditioning's dtype.  shares is (B, 2, C) float32
// scratch.
extern "C" int pddm_gn_affine_bwd(const void* x, const void* ao, const void* gamma,
                                  const void* beta, const void* cond0, const void* cond1,
                                  const void* ga, const void* goff, void* dx, void* shares,
                                  void* dcond0, void* dcond1, void* dgamma, void* dbeta, int B,
                                  int N, int C, int G, float eps, int mode, int stride0,
                                  int stride1, int cond_is_bf16, int is_bf16, int V, int cvb,
                                  int splits, int rows, void* stream_ptr) {
  if (mode < 0 || mode > 2 || (mode >= 1 && (cond0 == nullptr || dcond0 == nullptr)) ||
      (mode == 2 && (cond1 == nullptr || dcond1 == nullptr)) || shares == nullptr ||
      dgamma == nullptr || dbeta == nullptr)
    return cudaErrorInvalidValue;
  const Plan p{B, N, C, G, cvb, splits, rows, kLocal};
  const Cond cd{cond0, cond1, stride0, stride1, mode, cond_is_bf16};
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const float* f[5] = {static_cast<const float*>(ao), static_cast<const float*>(gamma),
                       static_cast<const float*>(beta), static_cast<const float*>(ga),
                       static_cast<const float*>(goff)};
  float* sh = static_cast<float*>(shares);
  float* dg = static_cast<float*>(dgamma);
  float* db = static_cast<float*>(dbeta);
#define PDDM_GN_CASE(T, W)                                                                     \
  case W:                                                                                      \
    return launch_affine_bwd<T, W>(x, f[0], f[1], f[2], cd, f[3], f[4], dx, sh, dcond0, dcond1, \
                                   dg, db, p, eps, stream)
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

// The fold alone (gn_fold_kernel): ao (4, B, C) float32 from the moments
// mom (2, B, C) float32, E[x] and E[x^2] per (sample, channel).
extern "C" int pddm_gn_fold(const void* mom, const void* gamma, const void* beta,
                            const void* cond0, const void* cond1, void* ao, int B, int C, int G,
                            float eps, int mode, int stride0, int stride1, int cond_is_bf16,
                            void* stream_ptr) {
  if (mode < 0 || mode > 2 || (mode >= 1 && cond0 == nullptr) || (mode == 2 && cond1 == nullptr) ||
      B < 1 || B > 65535 || G < 1 || C < 1 || C % G != 0)
    return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * 2 * (size_t)C;
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  const cudaError_t err = allow_smem(gn_fold_kernel, smem + 256);
  if (err != cudaSuccess) return err;
  const Cond cd{cond0, cond1, stride0, stride1, mode, cond_is_bf16};
  gn_fold_kernel<<<B, NT, smem, static_cast<cudaStream_t>(stream_ptr)>>>(
      static_cast<const float*>(mom), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), cd, static_cast<float*>(ao), B, C, G, eps);
  return cudaGetLastError();
}

// The slab's GroupNorm, fold + apply (gn_fold_apply_kernel): y = x * a + off
// (+ SiLU) in x's dtype, (a, off) folded from mom (2, B, C) float32, the
// ranks' summed per-slab E[x] and E[x^2] (mom_len elements from mom on, at
// least 2 B C), divided by `ranks`.
extern "C" int pddm_gn_fold_apply(const void* x, const void* mom, const void* gamma,
                                  const void* beta, void* y, long long mom_len, int B,
                                  int N, int C, int G, int ranks, float eps, int silu,
                                  int is_bf16, int V, int cvb, int splits, int rows,
                                  void* stream_ptr) {
  if (mom == nullptr || gamma == nullptr || beta == nullptr || B < 1 || C < 1 || G < 1 ||
      C % G != 0 || ranks < 1 || mom_len < 2LL * B * C)
    return cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const Plan p{B, N, C, G, cvb, splits, rows};
  const float* f[3] = {static_cast<const float*>(mom), static_cast<const float*>(gamma),
                       static_cast<const float*>(beta)};
#define PDDM_GN_CASE(T, W) \
  case W:                  \
    return launch_fold_apply<T, W>(x, f[0], f[1], f[2], y, p, ranks, eps, silu, stream)
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
// ao (nullable): (4, B, C) float32 receives a, off, E[x] and E[x^2], which
// the backward reads (written only where autograd records the op).
extern "C" int pddm_group_norm_silu(const void* x, const void* gamma, const void* beta, void* y,
                                    void* ao, int B, int N, int C, int G, float eps, int silu,
                                    int is_bf16, int V, int cvb, void* stream_ptr) {
  const Plan p{B, N, C, G, cvb, 1, N};
  const Cond cd{nullptr, nullptr, 0, 0, 0, 0};
  return moments_any<true>(is_bf16, V, x, static_cast<const float*>(gamma),
                           static_cast<const float*>(beta), cd, static_cast<float*>(ao), y,
                           nullptr, nullptr, p, eps, silu, static_cast<cudaStream_t>(stream_ptr));
}
