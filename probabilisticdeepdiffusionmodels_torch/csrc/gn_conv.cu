// Fused affine + SiLU + 3x3 SAME conv + bias, channels last:
//   out[b, y, x, :] = bias + sum_{dy,dx,ci} silu(x[b, y+dy-1, x+dx-1, ci] * a[b, ci]
//                                               + off[b, ci]) * w[dy, dx, :, ci]
// with the taps outside the image contributing zero (the halo is zero AFTER
// the activation: silu(0*a + off) != 0).
//
// Replaces probabilisticdeepdiffusionmodels_tpu/ops/gn_conv_pallas.py,
// gn_silu_conv3x3_pallas / _kernel.  The activation is rounded to the input
// dtype before the product, the weight is in the input dtype, products
// accumulate in float32, the float32 bias is added and the result stored in
// the input dtype, as there.
//
// Weight layout: (3, 3, Cout, Cin) ("HWOI"): for one tap and one output
// channel the input channels are contiguous, so two neighbouring input
// channels are one 32-bit B operand of mma.sync.
//
// Bound on the H100: tensor-core operations (2 * 9 * Cin * Cout per output
// pixel).  Design: an implicit GEMM with M = output pixels, N = Cout,
// K = 9 * Cin.  A block of 4 warps computes 64 pixels x 64 output channels.
// The 64 pixels are whole images (H*W <= 64), whole rows of one image
// (W <= 64) or a 64-wide row segment, so their 3x3 neighbourhood is one
// small halo tile.  For each 32-channel slice of Cin the block stages that
// halo tile in shared memory, applying silu(x*a + off) once per element as
// it loads, and the slice of the weight for all 9 taps; the 9 taps are then
// shifted reads of the staged tile.
//   bf16: each warp computes 32 pixels x 32 channels with mma.sync m16n8k16,
//         reading its A fragments straight from the halo tile.
//   f32:  each thread computes 8 pixels x 4 channels with scalar FMAs.
#include "common.cuh"

using namespace pddm;

namespace {

constexpr int BM = 64;   // output pixels per block
constexpr int BN = 64;   // output channels per block
constexpr int KC = 32;   // input channels per staged slice
constexpr int NT = 128;  // threads per block

template <typename T> struct Ld;  // row stride of a staged pixel / weight row
template <> struct Ld<__nv_bfloat16> { static constexpr int v = KC + 8; };  // 80 B: conflict-free pairs
template <> struct Ld<float> { static constexpr int v = KC + 1; };

struct Geom {
  int B, H, W, Cin, Cout;
  int NI, TH, TW;        // images, rows and columns of a pixel tile
  int tiles_y, tiles_x;  // tiles per image along y and x
  int vec8;              // bf16, Cin % 8 == 0 and 16-byte aligned x, w: 16-byte loads
};

// Pixel p of the block's tile -> its image/row/column, and the index of its
// (dy, dx) = (0, 0) neighbour in the halo tile.  Returns false for padding
// pixels past the edge of the batch or the image; their halo index stays
// inside the tile.
__device__ __forceinline__ bool pixel(const Geom& g, int b0, int y0, int x0, int p, int& b,
                                      int& y, int& x, int& hb) {
  const int per_img = g.TH * g.TW;
  const int i = p / per_img, r = (p / g.TW) % g.TH, c = p % g.TW;
  b = b0 + i;
  y = y0 + r;
  x = x0 + c;
  const bool in_tile = i < g.NI;
  hb = in_tile ? (i * (g.TH + 2) + r) * (g.TW + 2) + c : 0;
  return in_tile && b < g.B && y < g.H && x < g.W;
}

// Stage the activated halo tile of channels [ci0, ci0 + KC): zero outside
// the batch, the image and Cin.
template <typename T>
__device__ __forceinline__ void stage_halo(const T* __restrict__ x, const float* __restrict__ a,
                                           const float* __restrict__ off, T* Xs, const Geom& g,
                                           int b0, int y0, int x0, int ci0, int halo_px) {
  constexpr int LD = Ld<T>::v;
  const int halo_w = g.TW + 2, halo_h = g.TH + 2;
  for (int idx = threadIdx.x; idx < halo_px * KC; idx += NT) {
    const int cc = idx % KC, pos = idx / KC;
    const int hx = pos % halo_w, t2 = pos / halo_w;
    const int hy = t2 % halo_h, i = t2 / halo_h;
    const int bb = b0 + i, yy = y0 - 1 + hy, xx = x0 - 1 + hx, ci = ci0 + cc;
    float v = 0.f;
    if (bb < g.B && yy >= 0 && yy < g.H && xx >= 0 && xx < g.W && ci < g.Cin) {
      const float xv = to_f(x[(((long)bb * g.H + yy) * g.W + xx) * g.Cin + ci]);
      v = silu_f(xv * a[(long)bb * g.Cin + ci] + off[(long)bb * g.Cin + ci]);
    }
    Xs[pos * LD + cc] = from_f<T>(v);
  }
}

// bf16 with Cin % 8 == 0: the same, 8 channels (16 bytes) per load.
__device__ __forceinline__ void stage_halo_vec8(const __nv_bfloat16* __restrict__ x,
                                                const float* __restrict__ a,
                                                const float* __restrict__ off,
                                                __nv_bfloat16* Xs, const Geom& g, int b0,
                                                int y0, int x0, int ci0, int halo_px) {
  constexpr int LD = Ld<__nv_bfloat16>::v;
  constexpr int V = KC / 8;
  const int halo_w = g.TW + 2, halo_h = g.TH + 2;
  for (int idx = threadIdx.x; idx < halo_px * V; idx += NT) {
    const int cv = idx % V, pos = idx / V;
    const int hx = pos % halo_w, t2 = pos / halo_w;
    const int hy = t2 % halo_h, i = t2 / halo_h;
    const int bb = b0 + i, yy = y0 - 1 + hy, xx = x0 - 1 + hx, ci = ci0 + 8 * cv;
    uint4 packed = make_uint4(0u, 0u, 0u, 0u);
    if (bb < g.B && yy >= 0 && yy < g.H && xx >= 0 && xx < g.W && ci < g.Cin) {
      const uint4 raw =
          *reinterpret_cast<const uint4*>(x + (((long)bb * g.H + yy) * g.W + xx) * g.Cin + ci);
      const __nv_bfloat16* xv = reinterpret_cast<const __nv_bfloat16*>(&raw);
      const float* ap = a + (long)bb * g.Cin + ci;
      const float* op = off + (long)bb * g.Cin + ci;
      uint32_t* out32 = reinterpret_cast<uint32_t*>(&packed);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float v0 = silu_f(__bfloat162float(xv[2 * e]) * ap[2 * e] + op[2 * e]);
        const float v1 = silu_f(__bfloat162float(xv[2 * e + 1]) * ap[2 * e + 1] + op[2 * e + 1]);
        out32[e] = pack_bf16(v0, v1);
      }
    }
    *reinterpret_cast<uint4*>(Xs + pos * LD + 8 * cv) = packed;
  }
}

// Stage w[tap, n0 + n, ci0 + k] as Ws[tap][n][k] for all 9 taps.
template <typename T>
__device__ __forceinline__ void stage_weight(const T* __restrict__ w, T* Ws, const Geom& g,
                                             int n0, int ci0) {
  constexpr int LD = Ld<T>::v;
  for (int idx = threadIdx.x; idx < 9 * BN * KC; idx += NT) {
    const int k = idx % KC, n = (idx / KC) % BN, tap = idx / (KC * BN);
    const int co = n0 + n, ci = ci0 + k;
    Ws[(tap * BN + n) * LD + k] =
        (co < g.Cout && ci < g.Cin) ? w[((long)tap * g.Cout + co) * g.Cin + ci] : from_f<T>(0.f);
  }
}

__device__ __forceinline__ void stage_weight_vec8(const __nv_bfloat16* __restrict__ w,
                                                  __nv_bfloat16* Ws, const Geom& g, int n0,
                                                  int ci0) {
  constexpr int LD = Ld<__nv_bfloat16>::v;
  constexpr int V = KC / 8;
  for (int idx = threadIdx.x; idx < 9 * BN * V; idx += NT) {
    const int cv = idx % V, n = (idx / V) % BN, tap = idx / (V * BN);
    const int co = n0 + n, ci = ci0 + 8 * cv;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (co < g.Cout && ci < g.Cin)
      v = *reinterpret_cast<const uint4*>(w + ((long)tap * g.Cout + co) * g.Cin + ci);
    *reinterpret_cast<uint4*>(Ws + (tap * BN + n) * LD + 8 * cv) = v;
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
conv_kernel(const T* __restrict__ x, const float* __restrict__ a,
            const float* __restrict__ off, const T* __restrict__ w,
            const float* __restrict__ bias, T* __restrict__ out, Geom g) {
  constexpr int LD = Ld<T>::v;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int halo_w = g.TW + 2, halo_h = g.TH + 2;
  const int halo_px = g.NI * halo_h * halo_w;
  T* Xs = reinterpret_cast<T*>(smem_raw);  // halo_px x LD
  T* Ws = Xs + halo_px * LD;               // 9 x BN x LD

  int tile = blockIdx.x;
  const int tx = tile % g.tiles_x;
  tile /= g.tiles_x;
  const int ty = tile % g.tiles_y;
  const int b0 = (tile / g.tiles_y) * g.NI, y0 = ty * g.TH, x0 = tx * g.TW;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;

  // bf16: warp (wm, wn) owns pixels 32*wm.. and channels 32*wn..; lane
  // (gq, tq) holds rows gq and gq+8 of each 16-row m-tile.
  // f32: thread owns pixels tid/16 + 8*i (i < 8) and channels tid%16 + 16*j (j < 4).
  constexpr bool kMma = sizeof(T) == 2;
  constexpr int NPIX = kMma ? 4 : 8;
  const int warp = tid >> 5, lane = tid & 31, gq = lane >> 2, tq = lane & 3;
  const int wm = warp & 1, wn = warp >> 1;
  int hb[NPIX];  // bf16: hb[2*mt + half] is pixel 32*wm + 16*mt + gq + 8*half
#pragma unroll
  for (int i = 0; i < NPIX; ++i) {
    const int p = kMma ? 32 * wm + 16 * (i >> 1) + gq + 8 * (i & 1) : (tid >> 4) + 8 * i;
    int pb, py, px;
    pixel(g, b0, y0, x0, p, pb, py, px, hb[i]);
  }
  float acc2[2][4][4];  // bf16: [m-tile][n-tile][mma accumulator]
  float accf[8][4];     // f32: [pixel][channel]
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc2[i][j][0] = acc2[i][j][1] = acc2[i][j][2] = acc2[i][j][3] = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) accf[i][0] = accf[i][1] = accf[i][2] = accf[i][3] = 0.f;

  for (int ci0 = 0; ci0 < g.Cin; ci0 += KC) {
    __syncthreads();  // the previous slice is consumed
    bool staged = false;
    if constexpr (kMma) {
      if (g.vec8) {
        stage_halo_vec8(x, a, off, Xs, g, b0, y0, x0, ci0, halo_px);
        stage_weight_vec8(w, Ws, g, n0, ci0);
        staged = true;
      }
    }
    if (!staged) {
      stage_halo(x, a, off, Xs, g, b0, y0, x0, ci0, halo_px);
      stage_weight(w, Ws, g, n0, ci0);
    }
    __syncthreads();

#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int shift = (tap / 3) * halo_w + (tap % 3);
      if constexpr (kMma) {
        const __nv_bfloat16* Xb = reinterpret_cast<const __nv_bfloat16*>(Xs);
        const __nv_bfloat16* Wb = reinterpret_cast<const __nv_bfloat16*>(Ws) + tap * BN * LD;
#pragma unroll
        for (int kk = 0; kk < KC / 16; ++kk) {
          uint32_t af[2][4];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            const __nv_bfloat16* lo = Xb + (hb[2 * mt] + shift) * LD + kk * 16 + 2 * tq;
            const __nv_bfloat16* hi = Xb + (hb[2 * mt + 1] + shift) * LD + kk * 16 + 2 * tq;
            af[mt][0] = ld_pair(lo);
            af[mt][1] = ld_pair(hi);
            af[mt][2] = ld_pair(lo + 8);
            af[mt][3] = ld_pair(hi + 8);
          }
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const __nv_bfloat16* wb = Wb + (32 * wn + 8 * nt + gq) * LD + kk * 16 + 2 * tq;
            const uint32_t bf[2] = {ld_pair(wb), ld_pair(wb + 8)};
            mma_bf16_16816(acc2[0][nt], af[0], bf);
            mma_bf16_16816(acc2[1][nt], af[1], bf);
          }
        }
      } else {
        const float* Xf = reinterpret_cast<const float*>(Xs);
        const float* Wf = reinterpret_cast<const float*>(Ws) + tap * BN * LD;
        const int nl = tid & 15;
#pragma unroll 4
        for (int k = 0; k < KC; ++k) {
          float wv[4], xv[8];
#pragma unroll
          for (int j = 0; j < 4; ++j) wv[j] = Wf[(nl + 16 * j) * LD + k];
#pragma unroll
          for (int i = 0; i < 8; ++i) xv[i] = Xf[(hb[i] + shift) * LD + k];
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) accf[i][j] = fmaf(xv[i], wv[j], accf[i][j]);
        }
      }
    }
  }

  // Epilogue: + bias (float32), store in T.
  if constexpr (kMma) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        int pb, py, px, h_unused;
        const int p = 32 * wm + 16 * mt + gq + 8 * half;
        if (!pixel(g, b0, y0, x0, p, pb, py, px, h_unused)) continue;
        T* dst = out + (((long)pb * g.H + py) * g.W + px) * g.Cout;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int co = n0 + 32 * wn + 8 * nt + 2 * tq + e;
            if (co < g.Cout) dst[co] = from_f<T>(acc2[mt][nt][2 * half + e] + bias[co]);
          }
        }
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      int pb, py, px, h_unused;
      if (!pixel(g, b0, y0, x0, (tid >> 4) + 8 * i, pb, py, px, h_unused)) continue;
      T* dst = out + (((long)pb * g.H + py) * g.W + px) * g.Cout;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int co = n0 + (tid & 15) + 16 * j;
        if (co < g.Cout) dst[co] = from_f<T>(accf[i][j] + bias[co]);
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* a, const void* off, const void* w,
                   const void* bias, void* out, Geom g, cudaStream_t stream) {
  const int hw = g.H * g.W;
  if (hw <= BM) {  // whole images
    g.NI = BM / hw;
    g.TH = g.H;
    g.TW = g.W;
  } else if (g.W <= BM) {  // whole rows of one image
    g.NI = 1;
    g.TW = g.W;
    g.TH = BM / g.W;
  } else {  // a 64-wide segment of one row
    g.NI = 1;
    g.TH = 1;
    g.TW = BM;
  }
  g.vec8 = sizeof(T) == 2 && g.Cin % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
           reinterpret_cast<uintptr_t>(w) % 16 == 0;
  g.tiles_y = (g.H + g.TH - 1) / g.TH;
  g.tiles_x = (g.W + g.TW - 1) / g.TW;
  const long groups = (g.B + g.NI - 1) / g.NI;
  const long halo_px = (long)g.NI * (g.TH + 2) * (g.TW + 2);
  const size_t smem = sizeof(T) * (size_t)(halo_px + 9 * BN) * Ld<T>::v;
  cudaError_t err = allow_smem(conv_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(groups * g.tiles_y * g.tiles_x), (g.Cout + BN - 1) / BN);
  conv_kernel<T><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(a), static_cast<const float*>(off),
      static_cast<const T*>(w), static_cast<const float*>(bias), static_cast<T*>(out), g);
  return cudaGetLastError();
}

}  // namespace

extern "C" int pddm_gn_silu_conv3x3(const void* x, const void* a, const void* off,
                                    const void* w, const void* bias, void* out, int B,
                                    int H, int W, int Cin, int Cout, int is_bf16,
                                    void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  Geom g{B, H, W, Cin, Cout, 0, 0, 0, 0, 0, 0};
  if (is_bf16) return launch<__nv_bfloat16>(x, a, off, w, bias, out, g, stream);
  return launch<float>(x, a, off, w, bias, out, g, stream);
}
