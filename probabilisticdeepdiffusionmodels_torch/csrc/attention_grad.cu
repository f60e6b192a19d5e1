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
// Design: FlashAttention-2's backward with dQ split out, so no two blocks
// add into one element and no float atomic is needed: every sum has a fixed
// order, a call gives the same bits twice, and the launches hold no host
// synchronisation (a CUDA graph can capture them).  Two launches:
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
// bf16: every product is mma.sync m16n8k16 (bf16 operands, float32
// accumulation) with fragments from ldmatrix (.trans where the operand's k
// runs down the rows), as the forward's mma_ring; the head width is a
// template over every multiple of 16 up to 128.  float32: true float32
// scalar FMAs, two threads a row, as the forward's scalar_f32.
//
// Bound on the H100 (the CIFAR-10 UNet's 15 sites at batch 128): bytes.
// qkv, dO and L read, dqkv written: about 1.0 GB against about 160 GFLOP of
// bf16 products (the five of FlashAttention-2's backward), 0.30 ms against
// 0.16 ms.
#include "common.cuh"

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
// forward's log-sum-exp (B, H, T) float32; delta (B, H, T) float32 is
// scratch (the rows' D, written by the first launch and read by the second).
extern "C" int pddm_qkv_attention_grad(const void* qkv, const void* dout, const void* lse_ptr,
                                       void* delta_ptr, void* dqkv, int B, int ntok, int heads,
                                       int ch, float scale, int is_bf16, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const float* lse = static_cast<const float*>(lse_ptr);
  float* delta = static_cast<float*>(delta_ptr);
  if (B < 1 || ntok < 1 || heads < 1 || B > 65535 || heads > 65535 || lse == nullptr ||
      delta == nullptr)
    return cudaErrorInvalidValue;
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
