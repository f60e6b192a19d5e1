// Fused-qkv self-attention for the UNet's AttentionBlock.
//
// Replaces probabilisticdeepdiffusionmodels_tpu/ops/attention_pallas.py,
// qkv_attention_pallas / _attn_kernel.  Input (B, T, 3C), heads are
// contiguous [q|k|v] chunks of 3*ch channels; q and k are scaled by
// ch^-1/4 (rounded to the input dtype, as the reference does); scores and
// softmax in float32; output (B, T, C) in the input dtype.
//
// Bound on the H100: bytes.  At T=256, ch=64 a site reads 50 MB and writes
// 17 MB (20 us at 3.35 TB/s) against 8.6 GFLOP (9 us on the tensor cores),
// so the kernel has to stream the input once at full rate and keep the
// math under the copies.
//
// bf16 design: one block of up to 8 warps covers up to 128 query rows of
// one (batch, head); each warp owns 16 rows (FlashAttention-2 register
// layout).  q, k and v rows are copied straight from the fused tensor with
// 16-byte cp.async into rows padded by 16 bytes, so every ldmatrix below is
// free of bank conflicts.  K and V pass through a ring of up to 4 stages of
// 64 keys, all copies issued before the first product: at T <= 256 the
// whole head's K and V are in flight at once and each is read once per
// block; at longer T the copy of tile j+4 is issued as tile j is consumed
// and overlaps the math of tiles j+1 .. j+3.  After a tile lands, each thread scales the q and k
// chunks it copied, in place (bf16(x * ch^-1/4), the plain version's
// rounding).  Q and K fragments come from ldmatrix.x4, V's B fragments from
// ldmatrix.x4.trans (V stays row-major); S = Q K^T and O += P V are
// mma.sync m16n8k16 with float32 accumulation, the online softmax runs in
// float32 with exp2f, and P is rounded to bf16 before P V.  The output is
// staged through the warp's own Q rows and written 16 bytes a lane.  The
// head width is a template over every multiple of 16 up to 128.
//
// float32 design (not on the bf16 main path): one block of 4 warps per
// (64-query tile, head, batch) with scalar FMAs; two threads per query row.
//
// Where autograd records the op, both designs also write each row's
// log-sum-exp (B, H, T) float32 for the backward (attention_grad.cu).
#include "common.cuh"

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

extern "C" int pddm_qkv_attention(const void* qkv, void* out, void* lse_ptr, int B, int ntok,
                                  int heads, int ch, float scale, int is_bf16,
                                  void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  float* lse = static_cast<float*>(lse_ptr);
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
