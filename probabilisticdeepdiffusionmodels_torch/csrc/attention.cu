// Fused-qkv self-attention for the UNet's AttentionBlock.
//
// Replaces probabilisticdeepdiffusionmodels_tpu/ops/attention_pallas.py,
// qkv_attention_pallas / _attn_kernel.  Input (B, T, 3C), heads are
// contiguous [q|k|v] chunks of 3*ch channels; q and k are scaled by
// ch^-1/4 (rounded to the input dtype, as the reference does); scores and
// softmax in float32; output (B, T, C) in the input dtype.
//
// Bound on the H100: bytes (one read of the input, one write of the
// output; the products are small at T <= 1024, ch <= 128).  Design: one
// block of 4 warps per (64-query tile, head, batch) reads its q, k, v
// slices straight from the fused tensor by stride, streams 64-key tiles of
// K and V through shared memory and keeps the running max, sum and output
// of an online softmax on chip, so nothing but the output is written.
//   bf16: each warp owns 16 query rows; S = Q K^T and O += P V are
//         mma.sync m16n8k16 products with the score tile kept in registers
//         and re-packed as the A operand of P V (P rounded to bf16 before
//         the product, float32 accumulation).
//   f32:  the same tiling with scalar FMAs; two threads per query row.
#include "common.cuh"

using namespace pddm;

namespace {

constexpr int BR = 64;    // query rows per block
constexpr int BC = 64;    // keys per K/V tile
constexpr int NT = 128;   // threads per block

template <int CH>
__global__ void __launch_bounds__(NT)
attn_bf16_kernel(const __nv_bfloat16* __restrict__ qkv, __nv_bfloat16* __restrict__ out,
                 int ntok, int heads, float scale) {
  constexpr int LDQ = CH + 8;  // row stride (elements) of Qs and Ks
  constexpr int LDV = BC + 8;  // row stride of Vt (V transposed: [ch][key])
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + BR * LDQ;
  __nv_bfloat16* Vt = Ks + BC * LDQ;

  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * BR;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const long tok_stride = 3L * heads * CH;
  const __nv_bfloat16* base = qkv + (long)b * ntok * tok_stride + (long)h * 3 * CH;

  for (int idx = tid; idx < BR * CH; idx += NT) {
    const int r = idx / CH, c = idx % CH, q = q0 + r;
    const float v = q < ntok ? __bfloat162float(base[(long)q * tok_stride + c]) * scale : 0.f;
    Qs[r * LDQ + c] = __float2bfloat16(v);
  }

  float o[CH / 8][4];
#pragma unroll
  for (int n = 0; n < CH / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};
  const int wrow = warp * 16;

  for (int k0 = 0; k0 < ntok; k0 += BC) {
    __syncthreads();  // Q is staged; the previous K/V tile is consumed
    for (int idx = tid; idx < BC * CH; idx += NT) {
      const int r = idx / CH, c = idx % CH, key = k0 + r;
      float kv = 0.f, vv = 0.f;
      if (key < ntok) {
        const __nv_bfloat16* p = base + (long)key * tok_stride;
        kv = __bfloat162float(p[CH + c]) * scale;
        vv = __bfloat162float(p[2 * CH + c]);
      }
      Ks[r * LDQ + c] = __float2bfloat16(kv);
      Vt[c * LDV + r] = __float2bfloat16(vv);
    }
    __syncthreads();

    // S = Q K^T: this warp's 16 rows x 64 keys, eight 16x8 tiles.
    float s[BC / 8][4];
#pragma unroll
    for (int j = 0; j < BC / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < CH / 16; ++kk) {
      const __nv_bfloat16* qa = Qs + (wrow + g) * LDQ + kk * 16 + 2 * tq;
      const uint32_t a[4] = {ld_pair(qa), ld_pair(qa + 8 * LDQ), ld_pair(qa + 8),
                             ld_pair(qa + 8 * LDQ + 8)};
#pragma unroll
      for (int j = 0; j < BC / 8; ++j) {
        const __nv_bfloat16* kb = Ks + (j * 8 + g) * LDQ + kk * 16 + 2 * tq;
        const uint32_t bb[2] = {ld_pair(kb), ld_pair(kb + 8)};
        mma_bf16_16816(s[j], a, bb);
      }
    }

    // Online softmax.  s[j][0..1] belong to row g, s[j][2..3] to row g+8;
    // the four lanes of a quad hold one row between them.
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int j = 0; j < BC / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (k0 + j * 8 + 2 * tq + (e & 1) >= ntok) s[j][e] = -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    }
    float alpha[2], rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      alpha[i] = expf(m_run[i] - mx[i]);  // 0 on the first tile
      m_run[i] = mx[i];
    }
#pragma unroll
    for (int j = 0; j < BC / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[j][e] - mx[e >> 1]);
        s[j][e] = p;
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
      for (int n = 0; n < CH / 8; ++n) {
        const __nv_bfloat16* vb = Vt + (n * 8 + g) * LDV + kk * 16 + 2 * tq;
        const uint32_t bb[2] = {ld_pair(vb), ld_pair(vb + 8)};
        mma_bf16_16816(o[n], a, bb);
      }
    }
  }

  const long out_stride = (long)heads * CH;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int q = q0 + wrow + g + 8 * i;
    if (q >= ntok) continue;
    const float inv = 1.f / l_run[i];
    __nv_bfloat16* dst = out + ((long)b * ntok + q) * out_stride + (long)h * CH + 2 * tq;
#pragma unroll
    for (int n = 0; n < CH / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dst + n * 8) =
          __floats2bfloat162_rn(o[n][2 * i] * inv, o[n][2 * i + 1] * inv);
    }
  }
}

// float32: two threads per query row (tid / 2); the pair splits the keys of
// a tile and the output channels between them.
__global__ void __launch_bounds__(NT)
attn_f32_kernel(const float* __restrict__ qkv, float* __restrict__ out, int ntok,
                int heads, int ch, float scale) {
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
  if (q < ntok) {
    const float inv = 1.f / l_run;
    float* dst = out + ((long)b * ntok + q) * heads * ch + (long)h * ch;
    for (int c = half; c < ch; c += 2) dst[c] = Os[row * ld + c] * inv;
  }
}

template <int CH>
cudaError_t launch_bf16(const void* qkv, void* out, int B, int ntok, int heads,
                        float scale, cudaStream_t stream) {
  const size_t smem = sizeof(__nv_bfloat16) * ((BR + BC) * (CH + 8) + CH * (BC + 8));
  cudaError_t err = allow_smem(attn_bf16_kernel<CH>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((ntok + BR - 1) / BR, heads, B);
  attn_bf16_kernel<CH><<<grid, NT, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<__nv_bfloat16*>(out), ntok,
      heads, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int pddm_qkv_attention(const void* qkv, void* out, int B, int ntok, int heads,
                                  int ch, float scale, int is_bf16, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (is_bf16) {
    switch (ch) {
      case 16: return launch_bf16<16>(qkv, out, B, ntok, heads, scale, stream);
      case 32: return launch_bf16<32>(qkv, out, B, ntok, heads, scale, stream);
      case 64: return launch_bf16<64>(qkv, out, B, ntok, heads, scale, stream);
      case 128: return launch_bf16<128>(qkv, out, B, ntok, heads, scale, stream);
      default: return cudaErrorInvalidValue;
    }
  }
  if (ch > 128) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((2 * BR + 2 * BC) * (ch + 1) + BR * (BC + 1));
  cudaError_t err = allow_smem(attn_f32_kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((ntok + BR - 1) / BR, heads, B);
  attn_f32_kernel<<<grid, NT, smem, stream>>>(static_cast<const float*>(qkv),
                                              static_cast<float*>(out), ntok, heads, ch,
                                              scale);
  return cudaGetLastError();
}
