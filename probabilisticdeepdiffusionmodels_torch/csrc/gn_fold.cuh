// The fold of GroupNorm's statistics into a per-(sample, channel) scale `a`
// and offset `off`, shared by groupnorm.cu (the tail of moments + fold, the
// fold alone, the slab's fold + apply) and gn_conv.cu (the folding conv of a
// spatially sharded forward).  Every consumer folds with these functions,
// so it computes (a, off) with the same float32 operations in the same
// order as gn_fold_kernel: the same bits.  Every operation is an explicit
// round-to-nearest intrinsic, so that no inlining site can let the compiler
// contract a product and a sum where another does not.
//
// From the sums S1, S2 of x and x^2 of channel c over n parts (n rows of a
// sample, or the n ranks' per-slab means):
//   mu = S1 / n, m2 = S2 / n, the timestep embedding e (mode 1) folded in as
//   E[(x+e)^2] = m2 + 2 e mu + e^2, E[x+e] = mu + e;
//   per group of cg channels: the mean mg and E[.^2] qg of its channels'
//   values, added in channel order, and rstd = rsqrt(qg - mg^2 + eps);
//   a = rstd gamma[c], off = beta[c] - mg a (+ e a), FiLM (mode 2):
//   a (1 + s), off (1 + s) + shift.
#pragma once

#include "common.cuh"

namespace pddm {

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

// (E[x + e], E[(x + e)^2]) from E[x], E[x^2] and the embedding value e.
__device__ __forceinline__ float2 embed_moments(float mu, float m2, float e) {
  return make_float2(__fadd_rn(mu, e), __fmaf_rn(e, e, __fmaf_rn(__fmul_rn(2.f, e), mu, m2)));
}

// (E[x + e], E[(x + e)^2]) of channel c of sample b from E[x], E[x^2].
__device__ __forceinline__ float2 cond_moments(float mu, float m2, const Cond& cd, int b, int c) {
  if (cd.mode != 1) return make_float2(mu, m2);
  return embed_moments(mu, m2, cond_at(cd.p0, (long)b * cd.stride0 + c, cd.is_bf16));
}

// (mean, rstd) of a group from its cg channels' (E[x + e], E[(x + e)^2]),
// `at(i)` giving channel i's, added in channel order.
template <typename At>
__device__ __forceinline__ float2 group_stats(At at, int cg, float eps) {
  float mg = 0.f, qg = 0.f;
#pragma unroll 4
  for (int i = 0; i < cg; ++i) {
    const float2 v = at(i);
    mg = __fadd_rn(mg, v.x);
    qg = __fadd_rn(qg, v.y);
  }
  mg = __fdiv_rn(mg, (float)cg);
  qg = __fdiv_rn(qg, (float)cg);
  return make_float2(mg, rsqrtf(__fadd_rn(__fmaf_rn(-mg, mg, qg), eps)));
}

// (a, off) of a channel from its group's (mean, rstd), its gamma and beta
// and its conditioning values e0 (the embedding, or the FiLM scale) and e1
// (the FiLM shift).
__device__ __forceinline__ float2 affine_of(float2 st, float gam, float bet, float e0, float e1,
                                            int mode) {
  float a = __fmul_rn(st.y, gam);
  float off = __fmaf_rn(-st.x, a, bet);
  if (mode == 1) off = __fmaf_rn(e0, a, off);
  if (mode == 2) {
    const float sc = __fadd_rn(1.f, e0);
    a = __fmul_rn(a, sc);
    off = __fmaf_rn(off, sc, e1);
  }
  return make_float2(a, off);
}

// Channel c of sample b's conditioning values (e0, e1), 0 where none.
__device__ __forceinline__ float2 cond_values(const Cond& cd, int b, int c) {
  const float e0 = cd.mode >= 1 ? cond_at(cd.p0, (long)b * cd.stride0 + c, cd.is_bf16) : 0.f;
  const float e1 = cd.mode == 2 ? cond_at(cd.p1, (long)b * cd.stride1 + c, cd.is_bf16) : 0.f;
  return make_float2(e0, e1);
}

// (a, off) of channel c of sample b from its group's (mean, rstd).
__device__ __forceinline__ float2 channel_affine(float2 st, const float* __restrict__ gamma,
                                                 const float* __restrict__ beta, const Cond& cd,
                                                 int b, int c) {
  const float2 e = cond_values(cd, b, c);
  return affine_of(st, gamma[c], beta[c], e.x, e.y, cd.mode);
}

// The fold for sample b and the nch channels from c0 on (whole groups), NTH
// threads taking part: csum/csq hold the channels' sums over n parts on
// entry (and their conditioned moments after); a_out[j], off_out[j] receive
// the scale and offset of local channel j, and mean_out[j], m2_out[j] (where
// given) E[x] and E[x^2], which the backward starts from.
template <int NTH>
__device__ __forceinline__ void fold_channels(float n, int C, int G, const Cond& cd,
                                              const float* __restrict__ gamma,
                                              const float* __restrict__ beta, float eps, int b,
                                              int c0, int nch, float* csum, float* csq,
                                              float* a_out, float* off_out, float* mean_out,
                                              float* m2_out) {
  for (int j = threadIdx.x; j < nch; j += NTH) {
    const float mu = __fdiv_rn(csum[j], n), m2 = __fdiv_rn(csq[j], n);
    if (mean_out != nullptr) {
      mean_out[j] = mu;
      m2_out[j] = m2;
    }
    const float2 v = cond_moments(mu, m2, cd, b, c0 + j);
    csum[j] = v.x;
    csq[j] = v.y;
  }
  __syncthreads();
  const int cg = C / G;
  for (int j = threadIdx.x; j < nch; j += NTH) {
    const int c = c0 + j, g0 = (c / cg) * cg - c0;
    const float2 st =
        group_stats([&](int i) { return make_float2(csum[g0 + i], csq[g0 + i]); }, cg, eps);
    const float2 r = channel_affine(st, gamma, beta, cd, b, c);
    a_out[j] = r.x;
    off_out[j] = r.y;
  }
}

// What a consumer of a spatially sharded forward folds from: the ranks'
// summed per-slab moments, `ranks` of them.
struct FoldArgs {
  const float* mom;  // (2, B, C) float32: the sums over the ranks of E[x], E[x^2]
  const float* gamma;
  const float* beta;
  Cond cd;
  int G, ranks;
  float eps;
};

// W consecutive floats from p (16-byte aligned where W is 4) into v.
template <int W>
__device__ __forceinline__ void load_w(const float* p, float* v) {
  if constexpr (W == 4) {
    const float4 z = *reinterpret_cast<const float4*>(p);
    v[0] = z.x, v[1] = z.y, v[2] = z.z, v[3] = z.w;
  } else {
#pragma unroll
    for (int w = 0; w < W; ++w) v[w] = p[w];
  }
}

// A consumer's fold of the images it will read, before its main loop, by
// threads t = 0 .. nth - 1 of the block (`sync` between the phases): table
// row r (image `image(r)` of B, or < 0 for none), 2C floats, first
// receives each channel's conditioned moments (E[x + e], E[(x + e)^2]) of
// the ranks' mean (fold_channels' first loop), then, once `gs` (two floats
// a (row, group)) holds its groups' (mean, rstd), its [a | off].  Each
// thread takes W consecutive channels at a time (W = 4 with VEC: C a
// multiple of 4, mom, gamma and beta 16-byte aligned, four floats a load),
// U such runs in flight; a channel's moments and conditioning are loaded
// together, so the group statistics read shared memory alone.
template <bool VEC = false, typename Image, typename Sync>
__device__ __forceinline__ void fold_table(const FoldArgs& f, int B, int C, int rows,
                                           Image image, float* table, float* gs, int t,
                                           int nth, Sync sync) {
  constexpr int U = 4, W = VEC ? 4 : 1;
  const int cg = C / f.G, runs = rows * C / W;
  const long bc = (long)B * C;
  const float n = (float)f.ranks;
  for (int q0 = t; q0 < runs; q0 += U * nth) {
    float s1[U][W], s2[U][W], e[U][W];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int q = (q0 + u * nth) * W, r = q / C, c = q % C;
      const int b = q < rows * C ? image(r) : -1;
#pragma unroll
      for (int w = 0; w < W; ++w) s1[u][w] = s2[u][w] = e[u][w] = 0.f;
      if (b < 0) continue;
      load_w<W>(f.mom + (long)b * C + c, s1[u]);
      load_w<W>(f.mom + bc + (long)b * C + c, s2[u]);
      if (f.cd.mode == 1) {
#pragma unroll
        for (int w = 0; w < W; ++w)
          e[u][w] = cond_at(f.cd.p0, (long)b * f.cd.stride0 + c + w, f.cd.is_bf16);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int q = (q0 + u * nth) * W, r = q / C, c = q % C;
      if (q >= rows * C) continue;
#pragma unroll
      for (int w = 0; w < W; ++w) {
        float2 v = make_float2(__fdiv_rn(s1[u][w], n), __fdiv_rn(s2[u][w], n));
        if (f.cd.mode == 1) v = embed_moments(v.x, v.y, e[u][w]);
        table[(long)r * 2 * C + c + w] = v.x;
        table[(long)r * 2 * C + C + c + w] = v.y;
      }
    }
  }
  sync();
  for (int q = t; q < rows * f.G; q += nth) {
    const int r = q / f.G, gr = q % f.G;
    if (image(r) < 0) continue;
    const float* m = table + (long)r * 2 * C + gr * cg;
    const float2 st = group_stats([&](int i) { return make_float2(m[i], m[C + i]); }, cg, f.eps);
    gs[2 * q] = st.x;
    gs[2 * q + 1] = st.y;
  }
  sync();
  for (int q0 = t; q0 < runs; q0 += U * nth) {
    float gam[U][W], bet[U][W], e0[U][W], e1[U][W];
    int b[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int q = (q0 + u * nth) * W, c = q % C;
      b[u] = q < rows * C ? image(q / C) : -1;
#pragma unroll
      for (int w = 0; w < W; ++w) gam[u][w] = bet[u][w] = e0[u][w] = e1[u][w] = 0.f;
      if (b[u] < 0) continue;
      load_w<W>(f.gamma + c, gam[u]);
      load_w<W>(f.beta + c, bet[u]);
#pragma unroll
      for (int w = 0; w < W; ++w) {
        const float2 ev = cond_values(f.cd, b[u], c + w);
        e0[u][w] = ev.x;
        e1[u][w] = ev.y;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int q = (q0 + u * nth) * W, r = q / C, c = q % C;
      if (b[u] < 0) continue;
#pragma unroll
      for (int w = 0; w < W; ++w) {
        const int k = r * f.G + (c + w) / cg;
        const float2 v = affine_of(make_float2(gs[2 * k], gs[2 * k + 1]), gam[u][w], bet[u][w],
                                   e0[u][w], e1[u][w], f.cd.mode);
        table[(long)r * 2 * C + c + w] = v.x;
        table[(long)r * 2 * C + C + c + w] = v.y;
      }
    }
  }
  sync();
}

}  // namespace pddm
