// The gradient of the fused-qkv self-attention (attention.cu).
//
// Replaces the gradient that the JAX package takes through
// probabilisticdeepdiffusionmodels_tpu/ops/attention.py, qkv_attention_xla
// (the Pallas kernel has no VJP of its own).  Given qkv (B, T, 3C), each
// row's log-sum-exp L (B, H, T) float32, which the forward writes where
// autograd records it, and the output's gradient dO (B, T, C), it writes
// dqkv (B, T, 3C) in qkv's dtype.  With qs = q ch^-1/4 and ks = k ch^-1/4
// (rounded to the input dtype, as the forward), S = qs ks^T and
// P = softmax(S) = exp(S - L):
//
//   dP  = dO V^T,  D = rowsum(P o dP),  dS = P o (dP - D)
//   dV  = P^T dO,  dqs = dS ks,  dks = dS^T qs,  dq = dqs ch^-1/4, dk = dks ch^-1/4
//
// No float atomics: every sum has a fixed order, a call gives the same bits
// twice, and the launches hold no host synchronisation (a CUDA graph can
// capture them).  Two bf16 designs, chosen by shape
// (ops/attention.py::attention_grad_design):
//
// wgmma (head widths 16..64, 64 <= T <= 256, heads x ch >= 64: every
// attention site of the CIFAR-10 UNet but its T = 16 one): one launch, a
// block a (head, sample) with the head's Q, K, V and dO resident in shared
// memory (one TMA box of 64 tokens x 64 channels each, 128 KB at T = 256),
// every product m64n64k16 wgmma with float32 accumulators.  Phase 1: each
// warpgroup takes query tiles and forms S and dP against every key tile,
// P = exp(S - L) and D = rowsum(P o dP) in float32 (the quad's and the key
// tiles' shares added in a fixed order).  Phase 2: rounds of two key tiles,
// each warpgroup keeping its tile's dK and dV in registers over every query
// tile: S^T and dP^T again, P^T and dS^T in registers, dV += bf16(P^T) dO
// and dK += bf16(dS^T) Q with A from registers; the warpgroups' dS^T rows
// meet in shared memory, where one warpgroup forms the query tile's dQ share
// of the round's keys and adds it to float32 sums (one warpgroup a query
// tile, rounds in order).  Seven products a (query, key) pair and two
// exponentials, against the two-pass design's nine and three; no pass over
// the keys is made twice for D.  What the register file allows: the dK and
// dV of 256 keys alone (64 K floats at ch = 64) would fill it, hence rounds
// of 128 keys and D first.  Wider heads and longer T (T > 256 does not fit)
// keep two_pass.
//
// two_pass (every other bf16 shape; the first design, by name everywhere):
// FlashAttention-2's backward with dQ split out.  Two launches:
//
//   dq   one block per (64-query tile, head, sample), as the forward: Q and
//        dO rows stay in shared memory, K and V tiles of 64 keys pass through
//        a ring of cp.async stages, twice: per tile S = Q K^T and dP = dO V^T
//        (two products into registers) and P recomputed from L; the first
//        pass sums D = rowsum(P o dP) in float32 and writes it (B, H, T) for
//        the second launch, the second forms dS and dQ += dS K (dS rounded
//        to bf16 as the A operand).
//
// Why D is summed from P o dP and not FlashAttention's rowsum(dO o O): with
// O stored in bf16, rowsum(dO o O) misses rowsum(P o dP) by about 2^-9 of
// D, so each row's dS no longer sums to zero over the keys.  The key bias's
// gradient, zero in exact arithmetic (softmax is invariant to a shift of
// every key), then carries that error, and Adam turns such a gradient into
// whole steps: a K = 4 fused replay against eager steps drifted 2.5e-5 to
// 2.9e-5 in the attention blocks' qkv bias (the gate holds lr / 10 = 2e-5),
// against 7.0e-6 to 7.3e-6 through the plain version, and 6.8e-6 to 7.2e-6
// with D summed from P o dP (NVIDIA H100, two seeds each, fused_drift.py at
// the repository's root).  The second pass
// costs two products more a tile of the dq launch; the backward reads no O.
//   dkv  one block per (64-key tile, head, sample): each warp owns 16 keys
//        and keeps their dK and dV accumulators in registers; Q, dO, L and D
//        of 32 queries at a time pass through the ring.  Per tile the
//        transposed products S^T = K Q^T and dP^T = V dO^T, then
//        dV += bf16(P)^T dO and dK += bf16(dS)^T Q.
//
// two_pass: every product is mma.sync m16n8k16 (bf16 operands, float32
// accumulation) with fragments from ldmatrix (.trans where the operand's k
// runs down the rows), as the forward's mma_ring; the head width is a
// template over every multiple of 16 up to 128.  float32 (scalar_f32): true
// float32 scalar FMAs, two threads a row, as the forward's scalar_f32.
//
// Bound on the H100 (the CIFAR-10 UNet's 15 sites at batch 128): bytes.
// qkv, dO and L read, dqkv written: about 1.0 GB against about 160 GFLOP of
// bf16 products (the five of FlashAttention-2's backward), 0.30 ms against
// 0.16 ms.  What held two_pass back: its dq launch passes over the keys
// twice and all three passes recompute S, dP and P (nine products and three
// exponentials a pair), on mma.sync from 4-warp blocks.
#include "common.cuh"
#include "hopper.cuh"

using namespace pddm;

namespace {

constexpr int BC = 64;        // keys per K/V tile (dq)
constexpr int BQ = 32;        // queries per Q/dO tile (dkv)
constexpr int WARPS = 4;      // bf16: 16 rows (dq: queries, dkv: keys) per warp
constexpr int STAGES = 2;     // bf16: tiles in flight
constexpr float LOG2E = 1.4426950408889634f;

// cp.async of `rows` rows of CH bf16, row r from src + r * stride (rows past
// `valid` zero-filled), into dst rows LD apart; each thread takes the 16-byte
// chunks idx = tid, tid + nthreads, ... (the same chunks scale_rows scales).
template <int CH>
__device__ __forceinline__ void copy_rows(__nv_bfloat16* dst, const __nv_bfloat16* src, long stride,
                                          int rows, int valid) {
  constexpr int LD = CH + 8, CPR = CH / 8;
  for (int idx = threadIdx.x; idx < rows * CPR; idx += blockDim.x) {
    const int r = idx / CPR, c = idx % CPR;
    const bool ok = r < valid;
    cp_async16(dst + r * LD + 8 * c, src + (long)(ok ? r : 0) * stride + 8 * c, ok);
  }
}

// Scale in place the chunks of `rows` rows that this thread copied.
template <int CH>
__device__ __forceinline__ void scale_rows(__nv_bfloat16* S, int rows, float scale) {
  constexpr int LD = CH + 8, CPR = CH / 8;
  for (int idx = threadIdx.x; idx < rows * CPR; idx += blockDim.x) {
    uint4* p = reinterpret_cast<uint4*>(S + (idx / CPR) * LD + 8 * (idx % CPR));
    uint4 v = *p;
    uint32_t* w = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = unpack_bf16(w[e]);
      w[e] = pack_bf16(f.x * scale, f.y * scale);
    }
    *p = v;
  }
}

// acc (16 x 8N) += A (this warp's 16 rows of `As`) B^T, with B's 8N rows
// from `Bs` (both row-major, k = the CH channels): S = Q K^T, dP = dO V^T.
template <int CH, int N8>
__device__ __forceinline__ void rows_times_rows(float (&acc)[N8][4], const __nv_bfloat16* As,
                                                const __nv_bfloat16* Bs, int lane) {
  constexpr int LD = CH + 8;
#pragma unroll
  for (int kk = 0; kk < CH / 16; ++kk) {
    uint32_t a[4];
    ldmatrix_x4(a, As + (lane & 15) * LD + kk * 16 + 8 * (lane >> 4));
#pragma unroll
    for (int jp = 0; jp < N8 / 2; ++jp) {
      uint32_t b[4];
      ldmatrix_x4(b, Bs + (16 * jp + (lane & 7) + 8 * (lane >> 4)) * LD + kk * 16 +
                         8 * ((lane >> 3) & 1));
      mma_bf16_16816(acc[2 * jp], a, b);
      mma_bf16_16816(acc[2 * jp + 1], a, b + 2);
    }
  }
}

// acc (16 x CH) += A (16 x 16K, in registers as score tiles: tiles 2kk and
// 2kk+1 form k-step kk, rounded to bf16) Bs (16K rows x CH, row-major, read
// with ldmatrix.trans): dQ += dS K, dV += P^T dO, dK += dS^T Q.
template <int CH, int K16>
__device__ __forceinline__ void tiles_times_rows(float (&acc)[CH / 8][4],
                                                 const float (&t)[2 * K16][4],
                                                 const __nv_bfloat16* Bs, int lane) {
  constexpr int LD = CH + 8;
#pragma unroll
  for (int kk = 0; kk < K16; ++kk) {
    const uint32_t a[4] = {pack_bf16(t[2 * kk][0], t[2 * kk][1]),
                           pack_bf16(t[2 * kk][2], t[2 * kk][3]),
                           pack_bf16(t[2 * kk + 1][0], t[2 * kk + 1][1]),
                           pack_bf16(t[2 * kk + 1][2], t[2 * kk + 1][3])};
#pragma unroll
    for (int np = 0; np < CH / 16; ++np) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, Bs + (16 * kk + (lane & 15)) * LD + 16 * np + 8 * (lane >> 4));
      mma_bf16_16816(acc[2 * np], a, b);
      mma_bf16_16816(acc[2 * np + 1], a, b + 2);
    }
  }
}

// Stage a warp's 16 x CH float32 accumulator, times `mul`, in bf16 into its
// 16 rows at S, then store them 16 bytes a lane to dst + r * stride for the
// rows r < valid.
template <int CH>
__device__ __forceinline__ void store_rows(const float (&acc)[CH / 8][4], float mul,
                                           __nv_bfloat16* S, __nv_bfloat16* dst, long stride,
                                           int valid, int lane) {
  constexpr int LD = CH + 8, CPR = CH / 8;
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int n = 0; n < CH / 8; ++n)
      *reinterpret_cast<uint32_t*>(S + (g + 8 * i) * LD + 8 * n + 2 * tq) =
          pack_bf16(acc[n][2 * i] * mul, acc[n][2 * i + 1] * mul);
  __syncwarp();
  for (int idx = lane; idx < 16 * CPR; idx += 32) {
    const int r = idx / CPR, c = idx % CPR;
    if (r < valid)
      *reinterpret_cast<uint4*>(dst + (long)r * stride + 8 * c) =
          *reinterpret_cast<const uint4*>(S + r * LD + 8 * c);
  }
}

// dq, bf16: grid (query tiles of 16 * warps, heads, B).  Two passes over
// the key tiles: the first forms D = rowsum(P o dP), the second dS and dQ.
// Where the head's K and V fit the ring (T <= 128) they stay resident and
// the second pass reads them again from shared memory.
template <int CH>
__global__ void __launch_bounds__(WARPS * 32)
attn_bwd_dq_bf16_kernel(const __nv_bfloat16* __restrict__ qkv,
                        const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                        float* __restrict__ delta, __nv_bfloat16* __restrict__ dqkv, int ntok,
                        int heads, float scale, int stages) {
  constexpr int LD = CH + 8;
  const int nq = blockDim.x / 2;  // 16 rows a warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // nq x LD
  __nv_bfloat16* dOs = Qs + nq * LD;                                // nq x LD
  __nv_bfloat16* KV = dOs + nq * LD;          // stages x (K: BC x LD, V: BC x LD)

  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * nq;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3, wrow = warp * 16;
  const long tok_stride = 3L * heads * CH, out_stride = (long)heads * CH;
  const __nv_bfloat16* base = qkv + (long)b * ntok * tok_stride + (long)h * 3 * CH;
  const long obase = (long)b * ntok * out_stride + (long)h * CH;
  const long lbase = ((long)b * heads + h) * ntok;
  const int ntiles = (ntok + BC - 1) / BC, total = 2 * ntiles;
  // every tile keeps its stage through both passes (stages == ntiles then)
  const bool resident = ntiles <= stages;

  // K and V of step jt (tile jt mod ntiles) into stage jt mod stages; one
  // group committed a step, empty where nothing is copied
  auto load_tile = [&](int jt) {
    if (jt < total && !(resident && jt >= ntiles)) {
      const int j = jt % ntiles;
      __nv_bfloat16* Ks = KV + (jt % stages) * 2 * BC * LD;
      const int valid = ntok - j * BC;
      copy_rows<CH>(Ks, base + (long)j * BC * tok_stride + CH, tok_stride, BC, valid);
      copy_rows<CH>(Ks + BC * LD, base + (long)j * BC * tok_stride + 2 * CH, tok_stride, BC,
                    valid);
    }
    cp_async_commit();
  };
  copy_rows<CH>(Qs, base + (long)q0 * tok_stride, tok_stride, nq, ntok - q0);
  copy_rows<CH>(dOs, dout + obase + (long)q0 * out_stride, out_stride, nq, ntok - q0);
  for (int jt = 0; jt < stages; ++jt) load_tile(jt);  // Q and dO join step 0's group

  float dq[CH / 8][4];
#pragma unroll
  for (int n = 0; n < CH / 8; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;
  float l_row[2], d_row[2] = {0.f, 0.f};  // rows g and g + 8 of the warp
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int q = q0 + wrow + g + 8 * i;
    l_row[i] = q < ntok ? lse[lbase + q] * LOG2E : 0.f;
  }

  for (int jt = 0; jt < total; ++jt) {
    const bool second = jt >= ntiles;
    if (stages == 1) cp_async_wait<0>(); else cp_async_wait<1>();
    __nv_bfloat16* Ks = KV + (jt % stages) * 2 * BC * LD;
    const __nv_bfloat16* Vs = Ks + BC * LD;
    if (jt == 0) scale_rows<CH>(Qs, nq, scale);
    if (!(resident && second)) scale_rows<CH>(Ks, BC, scale);
    __syncthreads();

    // S = Q K^T and dP = dO V^T: this warp's 16 rows x 64 keys
    float s[BC / 8][4], dp[BC / 8][4];
#pragma unroll
    for (int jj = 0; jj < BC / 8; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[jj][e] = dp[jj][e] = 0.f;
    rows_times_rows<CH, BC / 8>(s, Qs + wrow * LD, Ks, lane);
    rows_times_rows<CH, BC / 8>(dp, dOs + wrow * LD, Vs, lane);
    // P = exp(S - L), zero past the last key; first pass: D += P dP;
    // second: dS = P (dP - D)
    const int k0 = (jt - second * ntiles) * BC;
#pragma unroll
    for (int jj = 0; jj < BC / 8; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool key_ok = k0 + jj * 8 + 2 * tq + (e & 1) < ntok;
        const float p = key_ok ? exp2f(fmaf(s[jj][e], LOG2E, -l_row[e >> 1])) : 0.f;
        if (second)
          s[jj][e] = p * (dp[jj][e] - d_row[e >> 1]);
        else
          d_row[e >> 1] = fmaf(p, dp[jj][e], d_row[e >> 1]);
      }
    if (second) {
      tiles_times_rows<CH, BC / 16>(dq, s, Ks, lane);  // dQ += dS K
    } else if (jt == ntiles - 1) {
      // the quad's partial sums of each row, added in a fixed order; D for dkv
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        d_row[i] += __shfl_xor_sync(0xffffffffu, d_row[i], 1);
        d_row[i] += __shfl_xor_sync(0xffffffffu, d_row[i], 2);
        const int q = q0 + wrow + g + 8 * i;
        if (tq == 0 && q < ntok) delta[lbase + q] = d_row[i];
      }
    }
    __syncthreads();  // step jt is consumed: its stage takes step jt + stages
    load_tile(jt + stages);
  }
  // dq = dqs ch^-1/4, staged in the warp's own Q rows
  store_rows<CH>(dq, scale, Qs + wrow * LD, dqkv + ((long)b * ntok + q0 + wrow) * tok_stride +
                                                 (long)h * 3 * CH,
                 tok_stride, ntok - q0 - wrow, lane);
}

// dkv, bf16: grid (key tiles of 16 * warps, heads, B).
template <int CH>
__global__ void __launch_bounds__(WARPS * 32)
attn_bwd_dkv_bf16_kernel(const __nv_bfloat16* __restrict__ qkv,
                         const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                         const float* __restrict__ delta, __nv_bfloat16* __restrict__ dqkv,
                         int ntok, int heads, float scale, int stages) {
  constexpr int LD = CH + 8;
  const int nk = blockDim.x / 2;  // 16 keys a warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // nk x LD
  __nv_bfloat16* Vs = Ks + nk * LD;                                 // nk x LD
  __nv_bfloat16* QD = Vs + nk * LD;          // stages x (Q: BQ x LD, dO: BQ x LD)
  float* LDs = reinterpret_cast<float*>(QD + stages * 2 * BQ * LD);  // stages x (L: BQ, D: BQ)

  const int h = blockIdx.y, b = blockIdx.z, k0 = blockIdx.x * nk;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tq = lane & 3, wrow = warp * 16;
  const long tok_stride = 3L * heads * CH, out_stride = (long)heads * CH;
  const __nv_bfloat16* base = qkv + (long)b * ntok * tok_stride + (long)h * 3 * CH;
  const long obase = (long)b * ntok * out_stride + (long)h * CH;
  const long lbase = ((long)b * heads + h) * ntok;
  const int ntiles = (ntok + BQ - 1) / BQ;

  // Q and dO rows of query tile i by cp.async; its L (times log2 e) and D
  // by plain loads, read after the barrier that precedes the tile's use
  auto load_tile = [&](int i) {
    if (i < ntiles) {
      __nv_bfloat16* Qt = QD + (i % stages) * 2 * BQ * LD;
      const int valid = ntok - i * BQ;
      copy_rows<CH>(Qt, base + (long)i * BQ * tok_stride, tok_stride, BQ, valid);
      copy_rows<CH>(Qt + BQ * LD, dout + obase + (long)i * BQ * out_stride, out_stride, BQ,
                    valid);
      float* Lt = LDs + (i % stages) * 2 * BQ;
      for (int r = threadIdx.x; r < BQ; r += blockDim.x) {
        const bool ok = r < valid;
        Lt[r] = ok ? lse[lbase + i * BQ + r] * LOG2E : 0.f;
        Lt[BQ + r] = ok ? delta[lbase + i * BQ + r] : 0.f;
      }
    }
    cp_async_commit();
  };
  copy_rows<CH>(Ks, base + (long)k0 * tok_stride + CH, tok_stride, nk, ntok - k0);
  copy_rows<CH>(Vs, base + (long)k0 * tok_stride + 2 * CH, tok_stride, nk, ntok - k0);
  for (int i = 0; i < stages; ++i) load_tile(i);  // K and V join tile 0's group

  float dk[CH / 8][4], dv[CH / 8][4];
#pragma unroll
  for (int n = 0; n < CH / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  for (int i = 0; i < ntiles; ++i) {
    if (stages == 1) cp_async_wait<0>(); else cp_async_wait<1>();
    __nv_bfloat16* Qt = QD + (i % stages) * 2 * BQ * LD;
    const __nv_bfloat16* dOt = Qt + BQ * LD;
    const float* Lt = LDs + (i % stages) * 2 * BQ;
    if (i == 0) scale_rows<CH>(Ks, nk, scale);
    scale_rows<CH>(Qt, BQ, scale);
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys x 32 queries
    float st[BQ / 8][4], dpt[BQ / 8][4];
#pragma unroll
    for (int jj = 0; jj < BQ / 8; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[jj][e] = dpt[jj][e] = 0.f;
    rows_times_rows<CH, BQ / 8>(st, Ks + wrow * LD, Qt, lane);
    rows_times_rows<CH, BQ / 8>(dpt, Vs + wrow * LD, dOt, lane);
    // P^T = exp(S^T - L[query]), zero past the last query; dS^T = P^T (dP^T - D)
    const int qb = i * BQ;
#pragma unroll
    for (int jj = 0; jj < BQ / 8; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ql = jj * 8 + 2 * tq + (e & 1);
        const float p = qb + ql < ntok ? exp2f(fmaf(st[jj][e], LOG2E, -Lt[ql])) : 0.f;
        st[jj][e] = p;
        dpt[jj][e] = p * (dpt[jj][e] - Lt[BQ + ql]);
      }
    // dV += P^T dO, dK += dS^T Q
    tiles_times_rows<CH, BQ / 16>(dv, st, dOt, lane);
    tiles_times_rows<CH, BQ / 16>(dk, dpt, Qt, lane);
    __syncthreads();  // tile i is consumed: its stage takes tile i + stages
    load_tile(i + stages);
  }
  // dk = dks ch^-1/4 and dv, staged in the warp's own K and V rows
  __nv_bfloat16* dst = dqkv + ((long)b * ntok + k0 + wrow) * tok_stride + (long)h * 3 * CH;
  store_rows<CH>(dk, scale, Ks + wrow * LD, dst + CH, tok_stride, ntok - k0 - wrow, lane);
  store_rows<CH>(dv, 1.f, Vs + wrow * LD, dst + 2 * CH, tok_stride, ntok - k0 - wrow, lane);
}

constexpr int BR = 64;   // float32: rows (queries or keys) per block
constexpr int NT = 128;  // float32: threads per block, two a row
constexpr int BQF = 32;  // float32 dkv: queries per tile

// dq, float32: grid (64-query tiles, heads, B); the pair of threads of a row
// splits the keys of a tile, then the channels.  Two passes over the key
// tiles, as the bf16 kernel: D = rowsum(P o dP), then dS and dQ.
__global__ void __launch_bounds__(NT)
attn_bwd_dq_f32_kernel(const float* __restrict__ qkv, const float* __restrict__ dout,
                       const float* __restrict__ lse, float* __restrict__ delta,
                       float* __restrict__ dqkv, int ntok, int heads, int ch, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = ch + 1;
  constexpr int LDP = BC + 1;
  float* Qs = reinterpret_cast<float*>(smem_raw);  // BR x ld
  float* dOs = Qs + BR * ld;                       // BR x ld
  float* dQs = dOs + BR * ld;                      // BR x ld
  float* Ks = dQs + BR * ld;                       // BC x ld
  float* Vs = Ks + BC * ld;                        // BC x ld
  float* Ps = Vs + BC * ld;                        // BR x (BC + 1): dS

  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * BR;
  const int tid = threadIdx.x, row = tid >> 1, half = tid & 1;
  const long tok_stride = 3L * heads * ch, out_stride = (long)heads * ch;
  const float* base = qkv + (long)b * ntok * tok_stride + (long)h * 3 * ch;
  const long obase = (long)b * ntok * out_stride + (long)h * ch;
  const long lbase = ((long)b * heads + h) * ntok;

  for (int idx = tid; idx < BR * ch; idx += NT) {
    const int r = idx / ch, c = idx % ch, q = q0 + r;
    const bool ok = q < ntok;
    Qs[r * ld + c] = ok ? base[(long)q * tok_stride + c] * scale : 0.f;
    dOs[r * ld + c] = ok ? dout[obase + (long)q * out_stride + c] : 0.f;
    dQs[r * ld + c] = 0.f;
  }
  const int q = q0 + row;
  const float l = q < ntok ? lse[lbase + q] : 0.f;
  float d = 0.f;

  for (int pass = 0; pass < 2; ++pass) {
    for (int k0 = 0; k0 < ntok; k0 += BC) {
      __syncthreads();
      for (int idx = tid; idx < BC * ch; idx += NT) {
        const int r = idx / ch, c = idx % ch, key = k0 + r;
        float kv = 0.f, vv = 0.f;
        if (key < ntok) {
          const float* p = base + (long)key * tok_stride;
          kv = p[ch + c] * scale;
          vv = p[2 * ch + c];
        }
        Ks[r * ld + c] = kv;
        Vs[r * ld + c] = vv;
      }
      __syncthreads();
      for (int j = half; j < BC; j += 2) {
        float ds = 0.f;
        if (k0 + j < ntok) {
          float sc = 0.f, dp = 0.f;
          for (int c = 0; c < ch; ++c) {
            sc = fmaf(Qs[row * ld + c], Ks[j * ld + c], sc);
            dp = fmaf(dOs[row * ld + c], Vs[j * ld + c], dp);
          }
          const float p = expf(sc - l);
          if (pass == 0)
            d = fmaf(p, dp, d);
          else
            ds = p * (dp - d);
        }
        Ps[row * LDP + j] = ds;
      }
      if (pass == 0) continue;
      __syncwarp();  // both halves of the row's dS are written
      for (int c = half; c < ch; c += 2) {
        float acc = dQs[row * ld + c];
        for (int j = 0; j < BC; ++j) acc = fmaf(Ps[row * LDP + j], Ks[j * ld + c], acc);
        dQs[row * ld + c] = acc;
      }
    }
    if (pass == 0) {
      d += __shfl_xor_sync(0xffffffffu, d, 1);
      if (q < ntok && half == 0) delta[lbase + q] = d;
    }
  }
  if (q < ntok) {
    float* dst = dqkv + ((long)b * ntok + q) * tok_stride + (long)h * 3 * ch;
    for (int c = half; c < ch; c += 2) dst[c] = dQs[row * ld + c] * scale;
  }
}

// dkv, float32: grid (64-key tiles, heads, B); the pair of threads of a key
// splits the queries of a tile, then the channels.
__global__ void __launch_bounds__(NT)
attn_bwd_dkv_f32_kernel(const float* __restrict__ qkv, const float* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        float* __restrict__ dqkv, int ntok, int heads, int ch, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = ch + 1;
  constexpr int LDP = BQF + 1;
  float* Ks = reinterpret_cast<float*>(smem_raw);  // BR x ld
  float* Vs = Ks + BR * ld;                        // BR x ld
  float* dKs = Vs + BR * ld;                       // BR x ld
  float* dVs = dKs + BR * ld;                      // BR x ld
  float* Qs = dVs + BR * ld;                       // BQF x ld
  float* dOs = Qs + BQF * ld;                      // BQF x ld
  float* Pt = dOs + BQF * ld;                      // BR x (BQF + 1)
  float* dSt = Pt + BR * LDP;                      // BR x (BQF + 1)
  float* Lq = dSt + BR * LDP;                      // BQF
  float* Dq = Lq + BQF;                            // BQF

  const int h = blockIdx.y, b = blockIdx.z, k0 = blockIdx.x * BR;
  const int tid = threadIdx.x, row = tid >> 1, half = tid & 1;
  const long tok_stride = 3L * heads * ch, out_stride = (long)heads * ch;
  const float* base = qkv + (long)b * ntok * tok_stride + (long)h * 3 * ch;
  const long obase = (long)b * ntok * out_stride + (long)h * ch;
  const long lbase = ((long)b * heads + h) * ntok;

  for (int idx = tid; idx < BR * ch; idx += NT) {
    const int r = idx / ch, c = idx % ch, key = k0 + r;
    const bool ok = key < ntok;
    Ks[r * ld + c] = ok ? base[(long)key * tok_stride + ch + c] * scale : 0.f;
    Vs[r * ld + c] = ok ? base[(long)key * tok_stride + 2 * ch + c] : 0.f;
    dKs[r * ld + c] = 0.f;
    dVs[r * ld + c] = 0.f;
  }
  for (int q0 = 0; q0 < ntok; q0 += BQF) {
    __syncthreads();
    for (int idx = tid; idx < BQF * ch; idx += NT) {
      const int r = idx / ch, c = idx % ch, q = q0 + r;
      const bool ok = q < ntok;
      Qs[r * ld + c] = ok ? base[(long)q * tok_stride + c] * scale : 0.f;
      dOs[r * ld + c] = ok ? dout[obase + (long)q * out_stride + c] : 0.f;
    }
    for (int r = tid; r < BQF; r += NT) {
      const bool ok = q0 + r < ntok;
      Lq[r] = ok ? lse[lbase + q0 + r] : 0.f;
      Dq[r] = ok ? delta[lbase + q0 + r] : 0.f;
    }
    __syncthreads();
    for (int j = half; j < BQF; j += 2) {
      float p = 0.f, ds = 0.f;
      if (q0 + j < ntok) {
        float sc = 0.f, dp = 0.f;
        for (int c = 0; c < ch; ++c) {
          sc = fmaf(Ks[row * ld + c], Qs[j * ld + c], sc);
          dp = fmaf(Vs[row * ld + c], dOs[j * ld + c], dp);
        }
        p = expf(sc - Lq[j]);
        ds = p * (dp - Dq[j]);
      }
      Pt[row * LDP + j] = p;
      dSt[row * LDP + j] = ds;
    }
    __syncwarp();  // both halves of the key's P and dS are written
    for (int c = half; c < ch; c += 2) {
      float av = dVs[row * ld + c], ak = dKs[row * ld + c];
      for (int j = 0; j < BQF; ++j) {
        av = fmaf(Pt[row * LDP + j], dOs[j * ld + c], av);
        ak = fmaf(dSt[row * LDP + j], Qs[j * ld + c], ak);
      }
      dVs[row * ld + c] = av;
      dKs[row * ld + c] = ak;
    }
  }
  const int key = k0 + row;
  if (key < ntok) {
    float* dst = dqkv + ((long)b * ntok + key) * tok_stride + (long)h * 3 * ch;
    for (int c = half; c < ch; c += 2) {
      dst[ch + c] = dKs[row * ld + c] * scale;
      dst[2 * ch + c] = dVs[row * ld + c];
    }
  }
}

// ----------------------------------------------------------------- wgmma

constexpr int RT = 64;               // rows of a tile (queries or keys): wgmma's M
constexpr int RT_BYTES = RT * 128;   // one tile of one tensor, a 128-byte swizzled row a token
constexpr int LDQ = RT + 8;          // floats a row of the dQ sums (2-way bank conflicts)
constexpr int RES_THREADS = 256;     // at most two warpgroups

// d (64 x 64) += A (64 x 16) * B (16 x 64), both from shared memory
// (descriptors); TA / TB: 1 where the operand is MN-major (transposed)
template <int TA, int TB>
__device__ __forceinline__ void wgmma64_ss(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// Shared memory of the wgmma design for nt tiles of 64 tokens and nwg
// warpgroups, in order: Q, K, V and dO (each nt tiles of 64 swizzled 128-byte
// rows, the box TMA writes), the dS^T rows of one query tile (64 a
// warpgroup), the float32 sums of dQ (nt x 64 rows of LDQ), each query's L
// (times log2 e) and D, one mbarrier.  Mirrored by
// ops/attention.py::_wgmma_smem.
struct ResLayout {
  int k, v, o, ds, dq, l, d, bar, bytes;
  __host__ __device__ ResLayout(int nt, int nwg) {
    k = nt * RT_BYTES;
    v = 2 * k;
    o = 3 * k;
    ds = 4 * k;
    dq = ds + nwg * RT_BYTES;
    l = dq + nt * RT * LDQ * 4;
    d = l + nt * RT * 4;
    bar = d + nt * RT * 4;
    bytes = bar + 8;
  }
};

// One block a (head, sample) with the head's Q, K, V and dO resident in
// shared memory (T <= 256, CH <= 64: the box of a 64-channel row is CH
// channels of the head and, past them, its neighbours', which only the
// products' discarded columns read).  The products are m64n64k16 wgmma with
// float32 accumulators.  Phase 1, query tiles t = wg, wg + nwg, ...: S = Q_t
// K^T and dP = dO_t V^T (both operands K-major in shared memory), P = exp(S -
// L), D = rowsum(P o dP) over every key in float32, each quad's and key
// tile's share added in a fixed order.  Phase 2, rounds of nwg key tiles,
// warpgroup wg owning key tile j = round * nwg + wg with its dK and dV in
// registers, over every query tile t: S^T = K_j Q_t^T and dP^T = V_j dO_t^T
// again, P^T and dS^T = P^T o (dP^T - D) in registers; dV += bf16(P^T) dO_t
// and dK += bf16(dS^T) Q_t with A from registers and B = the same rows
// MN-major; the warpgroups' dS^T rows meet in shared memory and warpgroup
// t % nwg forms dQ_t += dS_t K_round (A = dS^T MN-major, B = the round's K
// rows MN-major), added to the float32 sums in shared memory round after
// round (one warpgroup a tile: a fixed order).  Seven products a (query,
// key) pair and two exponentials, against the two-pass design's nine and
// three.
template <int CH>
__global__ void __launch_bounds__(RES_THREADS, 1)
attn_bwd_wgmma_kernel(const float* __restrict__ lse, __nv_bfloat16* __restrict__ dqkv, int ntok,
                      int heads, float scale, const __grid_constant__ CUtensorMap qkvmap,
                      const __grid_constant__ CUtensorMap omap) {
  const int nt = (ntok + RT - 1) / RT, nwg = blockDim.x / 128;
  const ResLayout L(nt, nwg);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* Qs = base;
  unsigned char* Ks = base + L.k;
  unsigned char* Vs = base + L.v;
  unsigned char* Os = base + L.o;
  unsigned char* DS = base + L.ds;
  float* dQ = reinterpret_cast<float*>(base + L.dq);
  float* Ls = reinterpret_cast<float*>(base + L.l);
  float* Ds = reinterpret_cast<float*>(base + L.d);
  uint64_t* bar = reinterpret_cast<uint64_t*>(base + L.bar);

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int wg = warp >> 2, w4 = warp & 3, g = lane >> 2, tq = lane & 3;
  const long tok = 3L * heads * CH;
  const long lbase = ((long)b * heads + h) * ntok;

  if (tid == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar, 4 * nt * RT_BYTES);
    for (int i = 0; i < nt; ++i) {
      tma_load_3d(Qs + i * RT_BYTES, &qkvmap, bar, h * 3 * CH, i * RT, b);
      tma_load_3d(Ks + i * RT_BYTES, &qkvmap, bar, h * 3 * CH + CH, i * RT, b);
      tma_load_3d(Vs + i * RT_BYTES, &qkvmap, bar, h * 3 * CH + 2 * CH, i * RT, b);
      tma_load_3d(Os + i * RT_BYTES, &omap, bar, h * CH, i * RT, b);
    }
  }
  for (int q = tid; q < nt * RT; q += blockDim.x) Ls[q] = q < ntok ? lse[lbase + q] * LOG2E : 0.f;
  mbar_wait(bar, 0);
  // q and k scaled by ch^-1/4 and rounded to bf16 in place, as the forward
  // (the two regions are neighbours; the scale is per element, so the
  // swizzle does not matter)
  for (int idx = tid; idx < 2 * nt * RT * 8; idx += blockDim.x) {
    uint4* p = reinterpret_cast<uint4*>(Qs) + idx;
    uint4 v = *p;
    uint32_t* w = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = unpack_bf16(w[e]);
      w[e] = pack_bf16(f.x * scale, f.y * scale);
    }
    *p = v;
  }
  fence_async_shared();
  __syncthreads();

  // ------------------------------------------------------ phase 1: D
  for (int t = wg; t < nt; t += nwg) {
    float dsum[2] = {0.f, 0.f};  // rows g and g + 8 of the warp
    for (int j = 0; j < nt; ++j) {
      float s[32], dp[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < CH / 16; ++kk)
        wgmma64_ss<0, 0>(s, smem_desc_sw128(Qs + t * RT_BYTES) + 2 * kk,
                         smem_desc_sw128(Ks + j * RT_BYTES) + 2 * kk);
#pragma unroll
      for (int kk = 0; kk < CH / 16; ++kk)
        wgmma64_ss<0, 0>(dp, smem_desc_sw128(Os + t * RT_BYTES) + 2 * kk,
                         smem_desc_sw128(Vs + j * RT_BYTES) + 2 * kk);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        fence_reg(s[i]);
        fence_reg(dp[i]);
      }
#pragma unroll
      for (int nt8 = 0; nt8 < 8; ++nt8)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = j * RT + 8 * nt8 + 2 * tq + (e & 1);
          const int q = t * RT + 16 * w4 + g + 8 * (e >> 1);
          const float p = key < ntok ? exp2f(fmaf(s[4 * nt8 + e], LOG2E, -Ls[q])) : 0.f;
          dsum[e >> 1] = fmaf(p, dp[4 * nt8 + e], dsum[e >> 1]);
        }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      dsum[i] += __shfl_xor_sync(0xffffffffu, dsum[i], 1);
      dsum[i] += __shfl_xor_sync(0xffffffffu, dsum[i], 2);
      if (tq == 0) Ds[t * RT + 16 * w4 + g + 8 * i] = dsum[i];
    }
  }
  __syncthreads();

  // ------------------------------------------- phase 2: dK, dV and dQ
  const int rounds = (nt + nwg - 1) / nwg;
  for (int r = 0; r < rounds; ++r) {
    const int j = r * nwg + wg;
    const int in_round = nt - r * nwg < nwg ? nt - r * nwg : nwg;
    const bool active = j < nt;
    float dk[32], dv[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;
    for (int t = 0; t < nt; ++t) {
      uint32_t pa[4][4], da[4][4];  // bf16 P^T and dS^T as A fragments, k-step kk
      if (active) {
        float st[32], dpt[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.f;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < CH / 16; ++kk)
          wgmma64_ss<0, 0>(st, smem_desc_sw128(Ks + j * RT_BYTES) + 2 * kk,
                           smem_desc_sw128(Qs + t * RT_BYTES) + 2 * kk);
#pragma unroll
        for (int kk = 0; kk < CH / 16; ++kk)
          wgmma64_ss<0, 0>(dpt, smem_desc_sw128(Vs + j * RT_BYTES) + 2 * kk,
                           smem_desc_sw128(Os + t * RT_BYTES) + 2 * kk);
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          fence_reg(st[i]);
          fence_reg(dpt[i]);
        }
        // P^T = exp(S^T - L[query]), zero past the last query or key;
        // dS^T = P^T (dP^T - D[query])
#pragma unroll
        for (int nt8 = 0; nt8 < 8; ++nt8)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int q = t * RT + 8 * nt8 + 2 * tq + (e & 1);
            const int key = j * RT + 16 * w4 + g + 8 * (e >> 1);
            const float p =
                q < ntok && key < ntok ? exp2f(fmaf(st[4 * nt8 + e], LOG2E, -Ls[q])) : 0.f;
            dpt[4 * nt8 + e] = p * (dpt[4 * nt8 + e] - Ds[q]);
            st[4 * nt8 + e] = p;
          }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * (2 * kk + (e >> 1)) + 2 * (e & 1);
            pa[kk][e] = pack_bf16(st[i], st[i + 1]);
            da[kk][e] = pack_bf16(dpt[i], dpt[i + 1]);
          }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          WgmmaT<64>::mma(dv, pa[kk], smem_desc_sw128_mn(Os + t * RT_BYTES, RT_BYTES) + 128 * kk);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          WgmmaT<64>::mma(dk, da[kk], smem_desc_sw128_mn(Qs + t * RT_BYTES, RT_BYTES) + 128 * kk);
        wgmma_commit();
      }
      bar_sync_named(1, blockDim.x);  // the dQ product of query tile t - 1 has read DS
      if (active) {
        // dS^T rows of this warpgroup's keys: row wg * 64 + 16 w4 + g (+ 8),
        // queries 16 kk + 2 tq (+ 8) in chunks 2 kk (+ 1)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = wg * RT + 16 * w4 + g + 8 * (e & 1);
            const int chunk = 2 * kk + (e >> 1);
            *reinterpret_cast<uint32_t*>(DS + row * 128 + ((chunk ^ (row & 7)) << 4) + 4 * tq) =
                da[kk][e];
          }
      }
      fence_async_shared();
      bar_sync_named(2, blockDim.x);  // DS holds every key of the round
      if (wg == t % nwg) {
        float dq[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) dq[i] = 0.f;
        wgmma_fence();
        for (int kk = 0; kk < 4 * in_round; ++kk)
          wgmma64_ss<1, 1>(dq, smem_desc_sw128_mn(DS, RT_BYTES) + 128 * kk,
                           smem_desc_sw128_mn(Ks + r * nwg * RT_BYTES, RT_BYTES) + 128 * kk);
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int i = 0; i < 32; ++i) fence_reg(dq[i]);
#pragma unroll
        for (int nt8 = 0; nt8 < 8; ++nt8)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            float2* p = reinterpret_cast<float2*>(dQ + (t * RT + 16 * w4 + g + 8 * half) * LDQ +
                                                  8 * nt8 + 2 * tq);
            const float2 add = make_float2(dq[4 * nt8 + 2 * half], dq[4 * nt8 + 2 * half + 1]);
            if (r == 0) {
              *p = add;
            } else {
              const float2 was = *p;
              *p = make_float2(was.x + add.x, was.y + add.y);
            }
          }
      }
      wgmma_wait<0>();  // dV and dK of tile t: pa and da are rewritten next
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) asm volatile("" ::"r"(pa[kk][e]), "r"(da[kk][e]));
    }
    if (active) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        fence_reg(dk[i]);
        fence_reg(dv[i]);
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int key = j * RT + 16 * w4 + g + 8 * half;
        if (key >= ntok) continue;
        __nv_bfloat16* dst = dqkv + ((long)b * ntok + key) * tok + (long)h * 3 * CH;
#pragma unroll
        for (int nt8 = 0; nt8 < 8; ++nt8) {
          const int col = 8 * nt8 + 2 * tq;
          if (col >= CH) continue;
          const int i = 4 * nt8 + 2 * half;
          *reinterpret_cast<uint32_t*>(dst + CH + col) =
              pack_bf16(dk[i] * scale, dk[i + 1] * scale);
          *reinterpret_cast<uint32_t*>(dst + 2 * CH + col) = pack_bf16(dv[i], dv[i + 1]);
        }
      }
    }
  }
  __syncthreads();
  // dq = dqs ch^-1/4, 16 bytes a thread and step
  for (int idx = tid; idx < ntok * (CH / 8); idx += blockDim.x) {
    const int q = idx / (CH / 8), c = idx % (CH / 8);
    const float4* src = reinterpret_cast<const float4*>(dQ + q * LDQ + 8 * c);
    const float4 lo = src[0], hi = src[1];
    uint4 v;
    v.x = pack_bf16(lo.x * scale, lo.y * scale);
    v.y = pack_bf16(lo.z * scale, lo.w * scale);
    v.z = pack_bf16(hi.x * scale, hi.y * scale);
    v.w = pack_bf16(hi.z * scale, hi.w * scale);
    *reinterpret_cast<uint4*>(dqkv + ((long)b * ntok + q) * tok + (long)h * 3 * CH + 8 * c) = v;
  }
}

// Shared memory of the wgmma design at T tokens, or 0 where it does not
// take T (64 <= T and the layout within a block's 227 KB)
size_t wgmma_smem(int ntok) {
  if (ntok < RT) return 0;
  const int nt = (ntok + RT - 1) / RT;
  const size_t bytes = 1024 + ResLayout(nt, nt > 1 ? 2 : 1).bytes;
  return bytes <= 227 * 1024 ? bytes : 0;
}

template <int CH>
cudaError_t launch_grad_wgmma(const void* qkv, const void* dout, const float* lse, void* dqkv,
                              int B, int ntok, int heads, float scale, cudaStream_t stream) {
  const size_t smem = wgmma_smem(ntok);
  if (smem == 0 || heads * CH < RT) return cudaErrorInvalidValue;
  CUtensorMap qmap, omap;
  const cuuint64_t qdims[3] = {(cuuint64_t)3 * heads * CH, (cuuint64_t)ntok, (cuuint64_t)B};
  const cuuint64_t odims[3] = {(cuuint64_t)heads * CH, (cuuint64_t)ntok, (cuuint64_t)B};
  const cuuint32_t box[3] = {RT, RT, 1};
  cudaError_t err = encode_bf16_map(&qmap, qkv, 3, qdims, box);
  if (err != cudaSuccess) return err;
  if ((err = encode_bf16_map(&omap, dout, 3, odims, box)) != cudaSuccess) return err;
  if ((err = allow_smem(attn_bwd_wgmma_kernel<CH>, smem)) != cudaSuccess) return err;
  const int nt = (ntok + RT - 1) / RT;
  attn_bwd_wgmma_kernel<CH><<<dim3(heads, B), nt > 1 ? 256 : 128, smem, stream>>>(
      lse, static_cast<__nv_bfloat16*>(dqkv), ntok, heads, scale, qmap, omap);
  return cudaGetLastError();
}

template <int CH>
cudaError_t launch_grad_bf16(const void* qkv, const void* dout, const float* lse, float* delta,
                             void* dqkv, int B, int ntok, int heads, float scale,
                             cudaStream_t stream) {
  using bf = __nv_bfloat16;
  constexpr int LD = CH + 8;
  const int warps = (ntok + 15) / 16 < WARPS ? (ntok + 15) / 16 : WARPS;
  const int rows = 16 * warps;
  const int kv_tiles = (ntok + BC - 1) / BC, q_tiles = (ntok + BQ - 1) / BQ;
  const int st_q = kv_tiles < STAGES ? kv_tiles : STAGES;
  const int st_kv = q_tiles < STAGES ? q_tiles : STAGES;
  const size_t smem_q = sizeof(bf) * (size_t)(2 * rows + 2 * BC * st_q) * LD;
  const size_t smem_kv =
      sizeof(bf) * (size_t)(2 * rows + 2 * BQ * st_kv) * LD + 2 * BQ * st_kv * 4;
  cudaError_t err = allow_smem(attn_bwd_dq_bf16_kernel<CH>, smem_q);
  if (err != cudaSuccess) return err;
  err = allow_smem(attn_bwd_dkv_bf16_kernel<CH>, smem_kv);
  if (err != cudaSuccess) return err;
  const dim3 grid((ntok + rows - 1) / rows, heads, B);
  attn_bwd_dq_bf16_kernel<CH><<<grid, 32 * warps, smem_q, stream>>>(
      static_cast<const bf*>(qkv), static_cast<const bf*>(dout), lse, delta,
      static_cast<bf*>(dqkv), ntok, heads, scale, st_q);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attn_bwd_dkv_bf16_kernel<CH><<<grid, 32 * warps, smem_kv, stream>>>(
      static_cast<const bf*>(qkv), static_cast<const bf*>(dout), lse, delta,
      static_cast<bf*>(dqkv), ntok, heads, scale, st_kv);
  return cudaGetLastError();
}

}  // namespace

// dqkv (B, T, 3C) from qkv (B, T, 3C) and the output's gradient `dout`
// (B, T, C), contiguous in one dtype (bf16: 16-byte aligned), and the
// forward's log-sum-exp (B, H, T) float32.  design: 0 the two-launch design
// (two_pass in bf16, scalar_f32 in float32), whose delta (B, H, T) float32 is
// scratch (the rows' D, written by the first launch and read by the second);
// 1 wgmma (bf16, head widths 16..64, 64 <= T <= 256, heads x ch >= 64; delta
// unused).  A design, shape or buffer it does not take returns
// cudaErrorInvalidValue before any launch.
extern "C" int pddm_qkv_attention_grad(const void* qkv, const void* dout, const void* lse_ptr,
                                       void* delta_ptr, void* dqkv, int B, int ntok, int heads,
                                       int ch, float scale, int is_bf16, int design,
                                       void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const float* lse = static_cast<const float*>(lse_ptr);
  float* delta = static_cast<float*>(delta_ptr);
  if (B < 1 || ntok < 1 || heads < 1 || B > 65535 || heads > 65535 || lse == nullptr ||
      design < 0 || design > 1 || (design == 0 && delta == nullptr) || (design == 1 && !is_bf16))
    return cudaErrorInvalidValue;
  if (design == 1) {
    switch (ch) {
#define PDDM_ATTN_GRAD_CASE(W) \
  case W:                      \
    return launch_grad_wgmma<W>(qkv, dout, lse, dqkv, B, ntok, heads, scale, stream)
      PDDM_ATTN_GRAD_CASE(16);
      PDDM_ATTN_GRAD_CASE(32);
      PDDM_ATTN_GRAD_CASE(48);
      PDDM_ATTN_GRAD_CASE(64);
#undef PDDM_ATTN_GRAD_CASE
      default: return cudaErrorInvalidValue;
    }
  }
  if (is_bf16) {
    switch (ch) {  // every multiple of 16 up to 128, as the forward
#define PDDM_ATTN_GRAD_CASE(W) \
  case W:                      \
    return launch_grad_bf16<W>(qkv, dout, lse, delta, dqkv, B, ntok, heads, scale, stream)
      PDDM_ATTN_GRAD_CASE(16);
      PDDM_ATTN_GRAD_CASE(32);
      PDDM_ATTN_GRAD_CASE(48);
      PDDM_ATTN_GRAD_CASE(64);
      PDDM_ATTN_GRAD_CASE(80);
      PDDM_ATTN_GRAD_CASE(96);
      PDDM_ATTN_GRAD_CASE(112);
      PDDM_ATTN_GRAD_CASE(128);
#undef PDDM_ATTN_GRAD_CASE
      default: return cudaErrorInvalidValue;
    }
  }
  if (ch < 1 || ch > 128) return cudaErrorInvalidValue;
  const size_t smem_q = sizeof(float) * ((3 * BR + 2 * BC) * (size_t)(ch + 1) + BR * (BC + 1));
  const size_t smem_kv = sizeof(float) * ((4 * BR + 2 * BQF) * (size_t)(ch + 1) +
                                          2 * BR * (BQF + 1) + 2 * BQF);
  cudaError_t err = allow_smem(attn_bwd_dq_f32_kernel, smem_q);
  if (err != cudaSuccess) return err;
  err = allow_smem(attn_bwd_dkv_f32_kernel, smem_kv);
  if (err != cudaSuccess) return err;
  const dim3 grid((ntok + BR - 1) / BR, heads, B);
  attn_bwd_dq_f32_kernel<<<grid, NT, smem_q, stream>>>(
      static_cast<const float*>(qkv), static_cast<const float*>(dout), lse, delta,
      static_cast<float*>(dqkv), ntok, heads, ch, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attn_bwd_dkv_f32_kernel<<<grid, NT, smem_kv, stream>>>(
      static_cast<const float*>(qkv), static_cast<const float*>(dout), lse, delta,
      static_cast<float*>(dqkv), ntok, heads, ch, scale);
  return cudaGetLastError();
}
