// Fused-qkv self-attention for the UNet's AttentionBlock.
//
// Replaces probabilisticdeepdiffusionmodels_tpu/ops/attention_pallas.py,
// qkv_attention_pallas / _attn_kernel.  Input (B, T, 3C), heads are
// contiguous [q|k|v] chunks of 3*ch channels; q and k are scaled by
// ch^-1/4 (rounded to the input dtype, as the reference does); scores and
// softmax in float32; output (B, T, C) in the input dtype.
//
// Bound on the H100: bytes.  At the CIFAR-10 UNet's sites (4 heads of 64,
// batch 128) a T = 256 site reads 50.3 MB and writes 16.8 MB: 20.0 us at
// 3.35 TB/s, against 8.6 GFLOP of products (8.7 us on the tensor cores) and
// 33.5 M exponentials; a T = 64 site 5.0 us, the T = 16 site 1.25 us.  So
// the kernel has to stream the input once at full rate and keep the
// products and the exponentials under the copies.
//
// wgmma (bf16, head widths 16..64, 64 <= T <= 256, heads x ch >= 64: the
// CIFAR-10 UNet's sites at T = 256 and 64): a persistent block an SM walks
// over the (head, sample) items.  A landing warpgroup copies each item's K,
// Q and V by TMA (64-token x 64-channel boxes of the fused tensor, 128-byte
// swizzled) into a ring of up to four stages, as far ahead as the ring
// allows, and scales k in shared memory as it lands; two consumer
// warpgroups take the 64-query tiles in turn.  The split of N: a tile's
// whole key row, N = T <= 256, is one accumulator set of S = Qs Ks^T, one
// m64nNk16 wgmma a k-step (q scaled and rounded in registers as the A
// operand, K from shared memory), so each row's maximum is exact before any
// exponential and nothing is rescaled, and each k-step reads q once for
// every key.  Then key tile by key tile: P = 2^(S log2 e - m log2 e) (one
// MUFU instruction each), its row sums in float32, P rounded to bf16 in
// registers as the A operand of O += P V (m64n64k16, V the transposed B
// operand), each tile's products issued behind its exponentials, so the
// next tile's exponentials run under them.  O accumulates over the score
// registers of key tile 0, so a T = 256 tile holds 128 + 64 registers a
// thread (S, P), not 224; ptxas then issues the products one at a time
// (its note C7511), where an O of its own spilled at T = 256 and ran
// slower.  O / l is staged in shared memory and stored by
// TMA (heads of 64) or in 16-byte rows; L = m + ln l where asked.  The two
// warpgroups run free: taking turns to issue their products
// (FlashAttention-3's ping-pong) measured slower at every CIFAR-10 site
// (PERF.md).  The block count is the SMs or the
// items, the fewer: with fewer (head, sample) items than half the SMs most
// of the card idles, so ops/attention.py chooses mma_ring there.
//
// mma_ring (every other bf16 shape, and by name wherever wgmma runs): T =
// 16, below wgmma's 64 rows; heads of 80..128, whose score row beside O and
// P does not fit the consumers' registers; T > 256, whose key row does not
// fit one accumulator set; fewer items than half the SMs, where its block
// per 128 query rows fills more of the card.  One block of up to 8 warps covers up to 128
// query rows of one (batch, head); each warp owns 16 rows (FlashAttention-2
// register layout).  q, k and v rows are copied straight from the fused
// tensor with 16-byte cp.async into rows padded by 16 bytes, so every
// ldmatrix below is free of bank conflicts.  K and V pass through a ring of
// up to 4 stages of 64 keys, all copies issued before the first product: at
// T <= 256 the whole head's K and V are in flight at once and each is read
// once per block; at longer T the copy of tile j+4 is issued as tile j is
// consumed and overlaps the math of tiles j+1 .. j+3.  After a tile lands,
// each thread scales the q and k chunks it copied, in place (bf16(x *
// ch^-1/4), the plain version's rounding).  Q and K fragments come from
// ldmatrix.x4, V's B fragments from ldmatrix.x4.trans (V stays row-major);
// S = Q K^T and O += P V are mma.sync m16n8k16 with float32 accumulation,
// the online softmax runs in float32 with exp2f, and P is rounded to bf16
// before P V.  The output is staged through the warp's own Q rows and
// written 16 bytes a lane.  The head width is a template over every
// multiple of 16 up to 128.
//
// float32 design (scalar_f32, not on the bf16 main path): one block of 4
// warps per (64-query tile, head, batch) with scalar FMAs; two threads per
// query row.
//
// Where autograd records the op, every design also writes each row's
// log-sum-exp (B, H, T) float32 for the backward (attention_grad.cu).
#include <limits.h>

#include "common.cuh"
#include "hopper.cuh"

using namespace pddm;

namespace {

constexpr int BC = 64;          // keys per K/V tile
constexpr int MAX_WARPS = 8;    // bf16: 16 query rows per warp
constexpr int MAX_STAGES = 4;   // bf16: K/V tiles in flight
constexpr float LOG2E = 1.4426950408889634f;

template <int CH>
__global__ void __launch_bounds__(MAX_WARPS * 32)
attn_bf16_kernel(const __nv_bfloat16* __restrict__ qkv, __nv_bfloat16* __restrict__ out,
                 float* __restrict__ lse, int ntok, int heads, float scale, int stages) {
  constexpr int LD = CH + 8;   // padded row (elements)
  constexpr int CPR = CH / 8;  // 16-byte chunks per row
  const int nthreads = blockDim.x, nq = nthreads / 2;  // 16 rows per warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // nq x LD
  __nv_bfloat16* KV = Qs + nq * LD;  // stages x (K: BC x LD, V: BC x LD)

  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * nq;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const long tok_stride = 3L * heads * CH;
  const __nv_bfloat16* base = qkv + (long)b * ntok * tok_stride + (long)h * 3 * CH;
  const int ntiles = (ntok + BC - 1) / BC;

  // Copy K and V of tile j into its stage (rows past T zero-filled), and
  // commit one group, empty past the last tile, so the counts stay uniform.
  auto load_tile = [&](int j) {
    if (j < ntiles) {
      __nv_bfloat16* Ks = KV + (j % stages) * 2 * BC * LD;
      for (int idx = tid; idx < BC * CPR; idx += nthreads) {
        const int r = idx / CPR, c = idx % CPR, key = j * BC + r;
        const bool ok = key < ntok;
        const __nv_bfloat16* src = base + (long)(ok ? key : 0) * tok_stride + 8 * c;
        cp_async16(Ks + r * LD + 8 * c, src + CH, ok);
        cp_async16(Ks + (BC + r) * LD + 8 * c, src + 2 * CH, ok);
      }
    }
    cp_async_commit();
  };
  // Scale in place the chunks of `rows` rows that this thread copied.
  auto scale_rows = [&](__nv_bfloat16* S, int rows) {
    for (int idx = tid; idx < rows * CPR; idx += nthreads) {
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
  };

  for (int idx = tid; idx < nq * CPR; idx += nthreads) {
    const int r = idx / CPR, c = idx % CPR, q = q0 + r;
    const bool ok = q < ntok;
    cp_async16(Qs + r * LD + 8 * c, base + (long)(ok ? q : 0) * tok_stride + 8 * c, ok);
  }
  for (int j = 0; j < stages; ++j) load_tile(j);  // Q joins tile 0's group

  const int wrow = warp * 16;
  uint32_t qf[CH / 16][4];
  float o[CH / 8][4];
#pragma unroll
  for (int n = 0; n < CH / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};

  for (int j = 0; j < ntiles; ++j) {
    switch (stages) {  // tile j's group is complete
      case 1: cp_async_wait<0>(); break;
      case 2: cp_async_wait<1>(); break;
      case 3: cp_async_wait<2>(); break;
      default: cp_async_wait<3>(); break;
    }
    __nv_bfloat16* Ks = KV + (j % stages) * 2 * BC * LD;
    const __nv_bfloat16* Vs = Ks + BC * LD;
    if (j == 0) scale_rows(Qs, nq);
    scale_rows(Ks, BC);
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < CH / 16; ++kk)
        ldmatrix_x4(qf[kk], Qs + (wrow + (lane & 15)) * LD + kk * 16 + 8 * (lane >> 4));
    }

    // S = Q K^T: this warp's 16 rows x 64 keys, eight 16x8 tiles.
    float s[BC / 8][4];
#pragma unroll
    for (int jj = 0; jj < BC / 8; ++jj) s[jj][0] = s[jj][1] = s[jj][2] = s[jj][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < CH / 16; ++kk) {
#pragma unroll
      for (int jp = 0; jp < BC / 16; ++jp) {
        uint32_t kb[4];
        ldmatrix_x4(kb, Ks + (16 * jp + (lane & 7) + 8 * (lane >> 4)) * LD + kk * 16 +
                            8 * ((lane >> 3) & 1));
        mma_bf16_16816(s[2 * jp], qf[kk], kb);
        mma_bf16_16816(s[2 * jp + 1], qf[kk], kb + 2);
      }
    }

    // Online softmax.  s[jj][0..1] belong to row g, s[jj][2..3] to row g+8;
    // the four lanes of a quad hold one row between them.
    const int k0 = j * BC;
    if (k0 + BC > ntok) {
#pragma unroll
      for (int jj = 0; jj < BC / 8; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + jj * 8 + 2 * tq + (e & 1) >= ntok) s[jj][e] = -INFINITY;
    }
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int jj = 0; jj < BC / 8; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[jj][e]);
    float alpha[2], mlog[2], rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      alpha[i] = exp2f((m_run[i] - mx[i]) * LOG2E);  // 0 on the first tile
      m_run[i] = mx[i];
      mlog[i] = mx[i] * LOG2E;
    }
#pragma unroll
    for (int jj = 0; jj < BC / 8; ++jj) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(fmaf(s[jj][e], LOG2E, -mlog[e >> 1]));
        s[jj][e] = p;
        rsum[e >> 1] += p;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rsum[i] += __shfl_xor_sync(0xffffffffu, rsum[i], 1);
      rsum[i] += __shfl_xor_sync(0xffffffffu, rsum[i], 2);
      l_run[i] = l_run[i] * alpha[i] + rsum[i];
    }
#pragma unroll
    for (int n = 0; n < CH / 8; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // O += P V: the score tiles 2kk and 2kk+1 form the A operand of k-step kk.
#pragma unroll
    for (int kk = 0; kk < BC / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < CH / 16; ++np) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, Vs + (16 * kk + (lane & 15)) * LD + 16 * np + 8 * (lane >> 4));
        mma_bf16_16816(o[2 * np], a, vb);
        mma_bf16_16816(o[2 * np + 1], a, vb + 2);
      }
    }
    __syncthreads();  // tile j is consumed: its stage takes tile j + stages
    load_tile(j + stages);
  }

  // Each row's log-sum-exp (natural log) for the backward, where asked.
  if (lse != nullptr && tq == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int q = q0 + wrow + g + 8 * i;
      if (q < ntok) lse[((long)b * heads + h) * ntok + q] = m_run[i] + logf(l_run[i]);
    }
  }
  // Normalise, stage the warp's 16 rows in its own Q rows, store 16 bytes a lane.
  __nv_bfloat16* Os = Qs + wrow * LD;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float inv = 1.f / l_run[i];
#pragma unroll
    for (int n = 0; n < CH / 8; ++n)
      *reinterpret_cast<uint32_t*>(Os + (g + 8 * i) * LD + 8 * n + 2 * tq) =
          pack_bf16(o[n][2 * i] * inv, o[n][2 * i + 1] * inv);
  }
  __syncwarp();
  const long out_stride = (long)heads * CH;
  for (int idx = lane; idx < 16 * CPR; idx += 32) {
    const int r = idx / CPR, c = idx % CPR, q = q0 + wrow + r;
    if (q < ntok)
      *reinterpret_cast<uint4*>(out + ((long)b * ntok + q) * out_stride + (long)h * CH + 8 * c) =
          *reinterpret_cast<const uint4*>(Os + r * LD + 8 * c);
  }
}

constexpr int BR = 64;   // float32: query rows per block
constexpr int NT = 128;  // float32: threads per block

// float32: two threads per query row (tid / 2); the pair splits the keys of
// a tile and the output channels between them.
__global__ void __launch_bounds__(NT)
attn_f32_kernel(const float* __restrict__ qkv, float* __restrict__ out, float* __restrict__ lse,
                int ntok, int heads, int ch, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = ch + 1;
  float* Qs = reinterpret_cast<float*>(smem_raw);  // BR x ld
  float* Ks = Qs + BR * ld;                        // BC x ld
  float* Vs = Ks + BC * ld;                        // BC x ld
  float* Os = Vs + BC * ld;                        // BR x ld
  float* Ps = Os + BR * ld;                        // BR x (BC + 1)
  constexpr int LDP = BC + 1;

  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * BR;
  const int tid = threadIdx.x, row = tid >> 1, half = tid & 1;
  const long tok_stride = 3L * heads * ch;
  const float* base = qkv + (long)b * ntok * tok_stride + (long)h * 3 * ch;

  for (int idx = tid; idx < BR * ch; idx += NT) {
    const int r = idx / ch, c = idx % ch, q = q0 + r;
    Qs[r * ld + c] = q < ntok ? base[(long)q * tok_stride + c] * scale : 0.f;
    Os[r * ld + c] = 0.f;
  }
  float m_run = -INFINITY, l_run = 0.f;

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

    float mx = m_run;
    for (int j = half; j < BC; j += 2) {
      float sc = -INFINITY;
      if (k0 + j < ntok) {
        sc = 0.f;
        for (int c = 0; c < ch; ++c) sc = fmaf(Qs[row * ld + c], Ks[j * ld + c], sc);
      }
      Ps[row * LDP + j] = sc;
      mx = fmaxf(mx, sc);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float alpha = expf(m_run - mx);
    m_run = mx;
    float rsum = 0.f;
    for (int j = half; j < BC; j += 2) {
      const float p = expf(Ps[row * LDP + j] - mx);
      Ps[row * LDP + j] = p;
      rsum += p;
    }
    rsum += __shfl_xor_sync(0xffffffffu, rsum, 1);
    l_run = l_run * alpha + rsum;
    __syncwarp();  // both halves of the row's P are written
    for (int c = half; c < ch; c += 2) {
      float acc = Os[row * ld + c] * alpha;
      for (int j = 0; j < BC; ++j) acc = fmaf(Ps[row * LDP + j], Vs[j * ld + c], acc);
      Os[row * ld + c] = acc;
    }
  }

  const int q = q0 + row;
  if (q < ntok && lse != nullptr && half == 0)
    lse[((long)b * heads + h) * ntok + q] = m_run + logf(l_run);
  if (q < ntok) {
    const float inv = 1.f / l_run;
    float* dst = out + ((long)b * ntok + q) * heads * ch + (long)h * ch;
    for (int c = half; c < ch; c += 2) dst[c] = Os[row * ld + c] * inv;
  }
}

// ----------------------------------------------------------------- wgmma

constexpr int RT = 64;               // rows of a tile (queries or keys): wgmma's M
constexpr int RT_BYTES = RT * 128;   // one tile of one tensor, a 128-byte swizzled row a token
constexpr int FW_THREADS = 384;      // warpgroups 0 and 1 consume; warpgroup 2 lands and scales
constexpr int FW_PRODUCER = 8;       // its first warp issues the copies, the other three scale
constexpr int FW_SCALERS = 96;
constexpr int FW_MAX_STAGES = 4;
// registers a thread once the landing warpgroup gives its surplus to the
// consumers: 24 x 128 + 240 x 256 <= 65,536 (a T = 256 score row alone is
// 128 float32 a thread)
constexpr int FW_PRODUCER_REGS = 24;
constexpr int FW_CONSUMER_REGS = 240;

// Shared memory of the wgmma forward: `stages` stages of one head (Q, K and
// V, each kt tiles of 64 tokens laid end to end), then four mbarriers a
// stage.  Mirrored by ops/attention.py::_fwd_wgmma_smem.
struct FwdLayout {
  int stage, bars, bytes;
  __host__ __device__ FwdLayout(int kt, int stages) {
    stage = 3 * kt * RT_BYTES;
    bars = stages * stage;
    bytes = bars + 4 * FW_MAX_STAGES * 8;
  }
};

// 2^x in one MUFU instruction (subnormal results flushed to 0: weights below
// 2^-126 of the row's largest, 1, which leave l unchanged and move O by less
// than 2^-126 |v|).  Volatile, as bf16_pair: each pair of P is packed right
// after its two exponentials, in the source's order, so a row's P never
// stands in float32 registers beside the packed fragments.
__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm volatile("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  uint32_t r;  // lo in the lower half, as pack_bf16
  asm volatile("cvt.rn.bf16x2.f32 %0, %2, %1;\n" : "=r"(r) : "f"(lo), "f"(hi));
  return r;
}

// Persistent block of 384 threads over the heads (items) blockIdx.x, +
// gridDim.x, ..., each item a (head, sample) with KT key tiles.  Lane 0 of
// warp 8 lands each item's K, Q and V by TMA into a ring of stages (K and Q
// on one mbarrier, V on another), as soon as the stage's last reader has
// released it; warps 9-11 scale the landed k by ch^-1/4 in place (the bf16
// rounding of the plain version), fence it for the async proxy and mark the
// stage ready.  The item's query tiles, counted through the block's items,
// alternate between consumer warpgroups 0 and 1 (tile gt to warpgroup
// gt % 2).  A tile: q from its landed rows into registers (ldmatrix),
// scaled and rounded there as the A fragments of S = Qs Ks^T over the whole
// key row (m64nNk16, N = 64 KT, one accumulator set: the whole row's
// maximum before any exponential, no rescaling), then, key tile by key
// tile, P = 2^(S log2 e - m log2 e) and its row sums in float32, P rounded
// to bf16 as the A fragments of O += P V (m64n64k16, B = V MN-major) issued
// behind them, so each key tile's exponentials run under the products of
// the one before; O / l staged over the tile's own Q rows and stored by TMA (or
// in 16-byte rows), with L = m + ln l where asked.  The two warpgroups run
// free of each other.
template <int CH, int KT>
__global__ void __launch_bounds__(FW_THREADS, 1)
attn_fwd_wgmma_kernel(__nv_bfloat16* __restrict__ out, float* __restrict__ lse, int ntok,
                      int heads, int items, float scale, int stages,
                      const __grid_constant__ CUtensorMap qkvmap,
                      const __grid_constant__ CUtensorMap omap) {
  constexpr int STAGE = 3 * KT * RT_BYTES;
  constexpr int N = KT * RT;  // keys of a score row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full_qk = reinterpret_cast<uint64_t*>(base + stages * STAGE);  // K and Q landed
  uint64_t* ready = full_qk + FW_MAX_STAGES;                              // k scaled
  uint64_t* full_v = ready + FW_MAX_STAGES;                               // V landed
  uint64_t* empty = full_v + FW_MAX_STAGES;                               // stage released

  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int mine = (items - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full_qk + s, 1);
      mbar_init(ready + s, 1);
      mbar_init(full_v + s, 1);
      mbar_init(empty + s, KT > 1 ? 2 : 1);  // the warpgroups that hold tiles of the item
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= FW_PRODUCER) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(FW_PRODUCER_REGS));
    if (warp == FW_PRODUCER) {
      if (lane != 0) return;
      for (int k = 0; k < mine; ++k) {
        const int item = blockIdx.x + k * gridDim.x, h = item % heads, b = item / heads;
        const int s = k % stages;
        if (k >= stages) mbar_wait(empty + s, (k / stages - 1) & 1);
        unsigned char* st = base + s * STAGE;
        mbar_expect_tx(full_qk + s, 2 * KT * RT_BYTES);
#pragma unroll
        for (int i = 0; i < KT; ++i)
          tma_load_3d(st + (KT + i) * RT_BYTES, &qkvmap, full_qk + s, h * 3 * CH + CH, i * RT, b);
#pragma unroll
        for (int i = 0; i < KT; ++i)
          tma_load_3d(st + i * RT_BYTES, &qkvmap, full_qk + s, h * 3 * CH, i * RT, b);
        mbar_expect_tx(full_v + s, KT * RT_BYTES);
#pragma unroll
        for (int i = 0; i < KT; ++i)
          tma_load_3d(st + (2 * KT + i) * RT_BYTES, &qkvmap, full_v + s, h * 3 * CH + 2 * CH,
                      i * RT, b);
      }
      return;
    }
    // k scaled and rounded to bf16 in place (per element: the swizzle does
    // not matter)
    const int sid = tid - (FW_PRODUCER + 1) * 32;
    for (int k = 0; k < mine; ++k) {
      const int s = k % stages;
      mbar_wait(full_qk + s, (k / stages) & 1);
      uint4* p = reinterpret_cast<uint4*>(base + s * STAGE + KT * RT_BYTES);
      for (int idx = sid; idx < KT * RT_BYTES / 16; idx += FW_SCALERS) {
        uint4 v = p[idx];
        uint32_t* w = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = unpack_bf16(w[e]);
          w[e] = pack_bf16(f.x * scale, f.y * scale);
        }
        p[idx] = v;
      }
      fence_async_shared();
      bar_sync_named(1, FW_SCALERS);
      if (sid == 0) mbar_arrive(ready + s);
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(FW_CONSUMER_REGS));

  const int c = warp >> 2, w4 = warp & 3, g = lane >> 2, tq = lane & 3, ct = tid & 127;
  // warpgroup c takes the block's tiles gt = c, c + 2, ...
  for (int gt = c; gt < mine * KT; gt += 2) {
    const int k = gt / KT, t = gt - k * KT;
    const int s = k % stages, ph = (k / stages) & 1;
    unsigned char* Qt = base + s * STAGE + t * RT_BYTES;
    const unsigned char* Ks = base + s * STAGE + KT * RT_BYTES;
    const unsigned char* Vs = Ks + KT * RT_BYTES;

    float sc[N / 2];  // S: rows 16 w4 + g (+ 8), keys 8 n8 + 2 tq (+ 1)
    mbar_wait(ready + s, ph);
    {
      // q rows 16 w4 + (lane & 15), channels 16 kk + 8 (lane >> 4): the A
      // fragments of k-step kk, scaled and rounded as the plain version
      uint32_t qa[CH / 16][4];
      const int qr = 16 * w4 + (lane & 15);
#pragma unroll
      for (int kk = 0; kk < CH / 16; ++kk) {
        ldmatrix_x4(qa[kk], Qt + sw128(qr, 2 * kk + (lane >> 4)));
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = unpack_bf16(qa[kk][e]);
          qa[kk][e] = pack_bf16(f.x * scale, f.y * scale);
        }
      }
      const uint64_t kdesc = smem_desc_sw128(Ks);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < CH / 16; ++kk) WgmmaRS<N, 0>::mma(sc, qa[kk], kdesc, 2 * kk, kk > 0);
      wgmma_commit();
    }
    wgmma_wait<0>();

    float mx[2] = {-INFINITY, -INFINITY}, mlog[2], l[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < N / 2; ++i) fence_reg(sc[i]);
    if (N > ntok) {  // keys past T (the map's zero fill) weigh nothing
#pragma unroll
      for (int n8 = 0; n8 < N / 8; ++n8)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (8 * n8 + 2 * tq + (e & 1) >= ntok) sc[4 * n8 + e] = -INFINITY;
    }
#pragma unroll
    for (int n8 = 0; n8 < N / 8; ++n8)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], sc[4 * n8 + e]);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      mlog[i] = mx[i] * LOG2E;
    }

    // O: rows 16 w4 + g (+ 8), channels 8 n8 + 2 tq (+ 1), accumulated over
    // the registers of key tile 0's scores, which its exponentials have
    // read first: the products' in-out operands tie the two, so O costs no
    // registers beside S and P (at T = 256, 128 + 64 a thread)
    float(&o)[32] = *reinterpret_cast<float(*)[32]>(sc);
    uint32_t pa[N / 16][4];  // bf16 P as the A fragments of k-step kk (16 keys)
    mbar_wait(full_v + s, ph);
    const uint64_t vdesc = smem_desc_sw128_mn(Vs, RT_BYTES);
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      // P of key tile j, exponent by exponent; each row's sum in key order
#pragma unroll
      for (int kk = 4 * j; kk < 4 * j + 4; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * (2 * kk + (e >> 1)) + 2 * (e & 1);  // row g + 8 (e & 1)
          const float p0 = ex2_ftz(fmaf(sc[i], LOG2E, -mlog[e & 1]));
          const float p1 = ex2_ftz(fmaf(sc[i + 1], LOG2E, -mlog[e & 1]));
          l[e & 1] += p0;
          l[e & 1] += p1;
          pa[kk][e] = bf16_pair(p0, p1);
        }
      wgmma_fence();
#pragma unroll
      for (int kk = 4 * j; kk < 4 * j + 4; ++kk)
        WgmmaRS<64, 1>::mma(o, pa[kk], vdesc, 128 * kk, kk > 0);
      wgmma_commit();
      // at most two key tiles' products in flight: the P fragments of
      // tile j - 1 are free again (32 registers of P in flight, not 64)
      if (j > 0) {
        wgmma_wait<1>();
#pragma unroll
        for (int kk = 4 * j - 4; kk < 4 * j; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e) asm volatile("" ::"r"(pa[kk][e]));
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int kk = N / 16 - 4; kk < N / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) asm volatile("" ::"r"(pa[kk][e]));

#pragma unroll
    for (int i = 0; i < 32; ++i) fence_reg(o[i]);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    }
    const int item = blockIdx.x + k * gridDim.x, h = item % heads, b = item / heads;
    if (lse != nullptr && tq == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int q = t * RT + 16 * w4 + g + 8 * i;
        if (q < ntok) lse[((long)b * heads + h) * ntok + q] = mx[i] + logf(l[i]);
      }
    }
    // O / l over the tile's Q rows (read into registers before S), swizzled
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float inv = 1.f / l[half];
      const int row = 16 * w4 + g + 8 * half;
#pragma unroll
      for (int n8 = 0; n8 < CH / 8; ++n8)
        *reinterpret_cast<uint32_t*>(Qt + sw128(row, n8) + 4 * tq) =
            pack_bf16(o[4 * n8 + 2 * half] * inv, o[4 * n8 + 2 * half + 1] * inv);
    }
    if constexpr (CH == 64) {
      // the staged rows are the output map's swizzled 64 x 64 box: one TMA
      // store (rows past T clipped), which reads them while the warpgroup
      // goes on; the stage is released once the stores have read it
      fence_async_shared();
      bar_sync_named(2 + c, 128);
      if (ct == 0) {
        tma_store_3d(&omap, Qt, h * CH, t * RT, b);
        bulk_commit();
        if (t + 2 >= KT) {
          bulk_wait_read<0>();
          mbar_arrive(empty + s);
        }
      }
    } else {
      bar_sync_named(2 + c, 128);
      for (int idx = ct; idx < RT * (CH / 8); idx += 128) {
        const int row = idx / (CH / 8), c8 = idx % (CH / 8), q = t * RT + row;
        if (q < ntok)
          *reinterpret_cast<uint4*>(out + (((long)b * ntok + q) * heads + h) * CH + 8 * c8) =
              *reinterpret_cast<const uint4*>(Qt + sw128(row, c8));
      }
      if (t + 2 >= KT) {  // this warpgroup's last tile of the item: release its stage
        fence_async_shared();
        bar_sync_named(2 + c, 128);
        if (ct == 0) mbar_arrive(empty + s);
      }
    }
  }
  if (CH == 64 && ct == 0) bulk_wait_all();
}

// The stages of the wgmma forward at kt key tiles: as many as fit, at most
// FW_MAX_STAGES, 0 where two do not.  At one tile the count is even: there
// the warpgroups take alternate items, so each keeps to its own stages and
// never waits on a barrier whose phase another warpgroup's item holds.
// Mirrored by ops/attention.py::_fwd_wgmma_stages.
int fwd_stages(int kt) {
  for (int s = FW_MAX_STAGES; s >= 2; --s)
    if ((kt > 1 || s % 2 == 0) && 1024 + FwdLayout(kt, s).bytes <= 227 * 1024) return s;
  return 0;
}

template <int CH, int KT>
cudaError_t launch_fwd_wgmma(const void* qkv, void* out, float* lse, int B, int ntok, int heads,
                             float scale, cudaStream_t stream) {
  const int stages = fwd_stages(KT);
  if (stages == 0) return cudaErrorInvalidValue;
  const size_t smem = 1024 + FwdLayout(KT, stages).bytes;
  CUtensorMap map, omap;
  const cuuint64_t dims[3] = {(cuuint64_t)3 * heads * CH, (cuuint64_t)ntok, (cuuint64_t)B};
  const cuuint64_t odims[3] = {(cuuint64_t)heads * CH, (cuuint64_t)ntok, (cuuint64_t)B};
  const cuuint32_t box[3] = {RT, RT, 1};
  cudaError_t err = encode_bf16_map(&map, qkv, 3, dims, box);
  if (err != cudaSuccess) return err;
  // the output's 64 x 64 boxes, stored by TMA at heads of 64 (narrower
  // heads store 16-byte rows; their map is never read)
  if ((err = encode_bf16_map(&omap, CH == 64 ? out : qkv, 3, CH == 64 ? odims : dims, box)) !=
      cudaSuccess)
    return err;
  if ((err = allow_smem(attn_fwd_wgmma_kernel<CH, KT>, smem)) != cudaSuccess) return err;
  int sms = 0;
  if ((err = sm_count(&sms)) != cudaSuccess) return err;
  // one block an SM (its registers allow no second), none without an item
  const long items = (long)B * heads;
  const int grid = items < sms ? (int)items : sms;
  attn_fwd_wgmma_kernel<CH, KT><<<grid, FW_THREADS, smem, stream>>>(
      static_cast<__nv_bfloat16*>(out), lse, ntok, heads, (int)items, scale, stages, map, omap);
  return cudaGetLastError();
}

template <int CH>
cudaError_t launch_fwd_wgmma_ch(const void* qkv, void* out, float* lse, int B, int ntok,
                                int heads, float scale, cudaStream_t stream) {
  switch ((ntok + RT - 1) / RT) {
    case 1: return launch_fwd_wgmma<CH, 1>(qkv, out, lse, B, ntok, heads, scale, stream);
    case 2: return launch_fwd_wgmma<CH, 2>(qkv, out, lse, B, ntok, heads, scale, stream);
    case 3: return launch_fwd_wgmma<CH, 3>(qkv, out, lse, B, ntok, heads, scale, stream);
    case 4: return launch_fwd_wgmma<CH, 4>(qkv, out, lse, B, ntok, heads, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <int CH>
cudaError_t launch_bf16(const void* qkv, void* out, float* lse, int B, int ntok, int heads,
                        float scale, cudaStream_t stream) {
  const int warps = (ntok + 15) / 16 < MAX_WARPS ? (ntok + 15) / 16 : MAX_WARPS;
  const int stages = (ntok + BC - 1) / BC < MAX_STAGES ? (ntok + BC - 1) / BC : MAX_STAGES;
  const size_t smem =
      sizeof(__nv_bfloat16) * (size_t)(16 * warps + 2 * BC * stages) * (CH + 8);
  cudaError_t err = allow_smem(attn_bf16_kernel<CH>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((ntok + 16 * warps - 1) / (16 * warps), heads, B);
  attn_bf16_kernel<CH><<<grid, 32 * warps, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<__nv_bfloat16*>(out), lse, ntok,
      heads, scale, stages);
  return cudaGetLastError();
}

}  // namespace

// out (B, T, C) from qkv (B, T, 3C), contiguous in one dtype (bf16: 16-byte
// aligned), and, where lse is not null, each row's log-sum-exp (B, H, T)
// float32.  design: 0 the first design of the dtype (mma_ring in bf16, every
// head width that is a multiple of 16 up to 128; scalar_f32 in float32), 1
// wgmma (bf16, head widths 16..64, 64 <= T <= 256, heads x ch >= 64).  A
// design or shape it does not take returns cudaErrorInvalidValue before any
// launch.
extern "C" int pddm_qkv_attention(const void* qkv, void* out, void* lse_ptr, int B, int ntok,
                                  int heads, int ch, float scale, int is_bf16, int design,
                                  void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  float* lse = static_cast<float*>(lse_ptr);
  if (design < 0 || design > 1 || (design == 1 && !is_bf16)) return cudaErrorInvalidValue;
  if (design == 1) {
    if (B < 1 || heads < 1 || ntok < RT || ntok > 4 * RT || heads * ch < RT ||
        (long)B * heads > INT_MAX)
      return cudaErrorInvalidValue;
    switch (ch) {
#define PDDM_ATTN_FWD_CASE(W) \
  case W:                     \
    return launch_fwd_wgmma_ch<W>(qkv, out, lse, B, ntok, heads, scale, stream)
      PDDM_ATTN_FWD_CASE(16);
      PDDM_ATTN_FWD_CASE(32);
      PDDM_ATTN_FWD_CASE(48);
      PDDM_ATTN_FWD_CASE(64);
#undef PDDM_ATTN_FWD_CASE
      default: return cudaErrorInvalidValue;
    }
  }
  if (is_bf16) {
    switch (ch) {  // every multiple of 16 up to 128
      case 16: return launch_bf16<16>(qkv, out, lse, B, ntok, heads, scale, stream);
      case 32: return launch_bf16<32>(qkv, out, lse, B, ntok, heads, scale, stream);
      case 48: return launch_bf16<48>(qkv, out, lse, B, ntok, heads, scale, stream);
      case 64: return launch_bf16<64>(qkv, out, lse, B, ntok, heads, scale, stream);
      case 80: return launch_bf16<80>(qkv, out, lse, B, ntok, heads, scale, stream);
      case 96: return launch_bf16<96>(qkv, out, lse, B, ntok, heads, scale, stream);
      case 112: return launch_bf16<112>(qkv, out, lse, B, ntok, heads, scale, stream);
      case 128: return launch_bf16<128>(qkv, out, lse, B, ntok, heads, scale, stream);
      default: return cudaErrorInvalidValue;
    }
  }
  if (ch > 128) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((2 * BR + 2 * BC) * (ch + 1) + BR * (BC + 1));
  cudaError_t err = allow_smem(attn_f32_kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((ntok + BR - 1) / BR, heads, B);
  attn_f32_kernel<<<grid, NT, smem, stream>>>(static_cast<const float*>(qkv),
                                              static_cast<float*>(out), lse, ntok, heads, ch,
                                              scale);
  return cudaGetLastError();
}
