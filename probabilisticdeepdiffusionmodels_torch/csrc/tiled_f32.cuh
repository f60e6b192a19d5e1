// tiled_f32: the float32 fused conv's main loop for Hopper, in true float32
// on the FP32 pipes (no TF32, as JAX pins it), shared by the forward
// (gn_conv.cu: conv3x3_SAME(silu(x*a + off)) + bias, and its FOLD variant)
// and the input gradient (gn_conv_grad.cu: dh = conv3x3 of g with the
// flipped weight, the activation's backward in the epilogue).
//
// Replaces, for float32, the first design of both (conv_kernel<float> and
// dgrad_general_kernel<float>): a 64 x 64 tile of 128 threads with 8 x 4
// accumulators a thread and operands staged by synchronous scalar loads,
// 12 scalar shared loads for 32 FMAs, the halo activated again for every
// 64-channel block of the output.  Bound on the H100: operations (2 x 9 x
// Cin x Cout flops a pixel at 67 TFLOP/s; a 32x32x128->128 site at batch 128
// is 0.58 ms), so the FMAs have to run back to back and every operand must
// come from shared memory in wide loads.
//
// An implicit GEMM: M = 128 output pixels, N = 128 output channels, K = 9
// taps x the A operand's channels (x's Cin in the forward, g's Cout in the
// input gradient), in slices of KC = 4 channels.  A block of 256 threads:
// thread (m, n) = (tid / 16, tid % 16) holds 8 pixels x 8 channels (64
// float32 accumulators): the pixels are 8 neighbouring columns of one row
// (or 4 columns of two rows where the image is at most 4 wide), the channels 4n ..
// 4n + 3 and 64 + 4n .. 64 + 4n + 3, so a quarter warp's 16-byte weight
// loads cover 32 banks.  For each slice channel and tap row dy the thread
// loads its pixels' activated row with its two neighbours (3 16-byte loads)
// once and uses it for the three taps dx by register shifts; for each tap it
// loads its 8 weights in 2 16-byte loads: 27 shared loads a channel for 576
// FMAs, where the first design spent 12 scalar loads on 32.
//
// Pipeline, one barrier a slice: the raw halo slice (16 bytes a pixel) and
// the weight slice (16 bytes a copy) come by cp.async into a ring
// of two, two slices ahead; all threads then turn slice s + 1 into the
// operands of the products (the halo activated once a block, in float32,
// channel-major, zero outside the image after the activation; the forward's
// weight transposed to [k][tap][n]) while the products of slice s run from
// the other buffer.  The tile's halo position -> pixel table is made once.
//
// Tiles (tiled_tile mirrors them in ops/gn_conv.py): TW columns (the width
// rounded up to a power of two from 4, at most 128: row segments beyond),
// TH rows of one image, or NI whole images where an image has fewer rows
// than the 16 thread rows (x2 at 4 wide) hold: whole-image tiles at 8x8 and
// 4x4.  Where the tiles of a call would not fill the card (the 8x8 and 4x4
// sites), the K channels are split over a thread-block cluster of up to 8
// blocks (splits), each adding its share of the products; the blocks then
// add the cluster's partial tiles in rank order through distributed shared
// memory, each for its share of the columns, so a call gives the same bits
// every time and needs no workspace.  The bias (forward) is added in
// float32 after the products; the input gradient's epilogue forms dp =
// silu'(x*a + off) dh and dx = dp a and writes one partial of sum(dp*x) and
// of sum(dp) a (tile, image of the tile, channel), adding the tile's pixels
// in a fixed order, for grad_finish_kernel.
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"
#include "gn_fold.cuh"

namespace pddm {
namespace tiled {

namespace cgs = cooperative_groups;

constexpr int NT = 256;  // threads a block: 16 along the pixels x 16 along the channels
constexpr int KC = 4;    // K channels a slice: one 16-byte chunk a pixel
constexpr int BN = 128;  // output channels a block
constexpr int BM = 128;  // pixel slots a block: 16 threads x 8
constexpr int MAX_SPLITS = 8;          // a portable cluster
constexpr int WSLICE = KC * 9 * BN;    // floats of a weight slice
// floats of a raw weight slice: the forward's (tap, column) units of 4
// channels with one unit of padding after every 8, so the quarter warp of
// its transpose, each lane reading 4 neighbouring units, hits 32 banks
constexpr int RAW_WSLICE = WSLICE + WSLICE / 8;
constexpr int MAX_POS = 512;           // halo positions of a tile, at most

enum Mode { kForward = 0, kForwardFold = 1, kDgrad = 2 };

// One call's tiling.  K: channels of the A operand (x's Cin, or g's Cout);
// N: channels of the output (Cout, or Cin).
struct Tile {
  int B, H, W, K, N;
  int NI, TH, TW, HP;  // images, rows (HP: padded to the thread's rows), padded columns
  int tiles_y, tiles_x;
  int pitch, rows;     // a halo row's floats (TW + 4), halo rows an image (HP + 2)
  int npos;            // halo positions: NI x rows x pitch
  int splits;          // K split over a cluster of this many blocks
  // byte offsets of Layout's buffers, set by the launch: read from the
  // kernel's parameters, they hold no register through the main loop
  int raw_a, raw_w, act, wt, fold;
};

// Columns of a thread's pixels: 8 (one row), or 4 (two rows) at TW = 4.
inline __host__ __device__ int tile_pc(int tw) { return tw >= 8 ? 8 : 4; }

// The tiling of (B, H, W): see the header.  Mirrored by
// ops/gn_conv.py::tiled_tile.
inline void set_tile(Tile& t) {
  int tw = 4;
  while (tw < t.W && tw < 128) tw *= 2;
  const int pc = tile_pc(tw), pr = 8 / pc, cg = tw / pc;
  const int cap = 16 / cg * pr;  // tile rows the 16 thread rows hold
  t.TW = tw;
  if (t.H >= cap) {
    t.NI = 1;
    t.TH = t.HP = cap;
  } else {
    t.HP = (t.H + pr - 1) / pr * pr;
    t.NI = cap / t.HP;
    t.TH = t.H;
  }
  t.tiles_y = (t.H + t.TH - 1) / t.TH;
  t.tiles_x = (t.W + t.TW - 1) / t.TW;
  t.pitch = t.TW + 4;
  t.rows = t.HP + 2;
  t.npos = t.NI * t.rows * t.pitch;
}

inline long m_tiles(const Tile& t) {
  return (long)(t.B + t.NI - 1) / t.NI * t.tiles_y * t.tiles_x;
}

// Shared memory, in order: the halo position table (int2: pixel, image of
// the tile), two raw halo slices (16 bytes a position), two raw weight
// slices (RAW_WSLICE), two activated halos ([k][position]), two weight slices
// ([k][tap][n]), the FOLD table; after the main loop the partial tile
// [BM][BN] and the input gradient's row sums [16][BN][2] lie over them.
struct Layout {
  int raw_a, raw_w, act, wt, fold, bytes;
  Layout(const Tile& t, int fold_floats) {
    raw_a = (t.npos * 8 + 15) / 16 * 16;
    raw_w = raw_a + 2 * t.npos * 16;
    act = raw_w + 2 * RAW_WSLICE * 4;
    wt = act + 2 * KC * t.npos * 4;
    fold = wt + 2 * WSLICE * 4;
    const int main_loop = fold + fold_floats * 4;
    const int epilogue = (BM * BN + 16 * BN * 2) * 4;
    bytes = main_loop > epilogue ? main_loop : epilogue;
  }
};

// FOLD's table of images b0 .. b0 + rows - 1, by the whole block
// (fold_table).  Outlined, as gn_conv.cu's fold_images is: inlined, the
// fold's registers would change how ptxas allocates the main loop.
static __device__ __noinline__ void fold_tile(FoldArgs f, int B, int C, int b0, int rows,
                                              float* table, float* gs) {
  fold_table(f, B, C, rows, [&](int r) { return b0 + r; }, table, gs, (int)threadIdx.x, NT,
             []() { __syncthreads(); });
}

// dL/dp from dL/dh through h = p * sigmoid(p), in full float32
__device__ __forceinline__ float silu_backward(float dh, float p) {
  const float s = 1.f / (1.f + expf(-p));
  return dh * s * (1.f + p * (1.f - s));
}

// src: x (forward) or g (input gradient), (B, H, W, K); w: (3, 3, Cout, Cin);
// a, off: (B, Cin) (unread by the FOLD forward); bias: the forward's;
// x: the input gradient's epilogue's; out: y (B, H, W, Cout) or dx (B, H,
// W, Cin); ws_a: the input gradient's (tile, image, [dp*x | dp], Cin)
// partials.  Grid: (m-tiles x splits, N / BN); a cluster of `splits` along x.
template <int MODE, int PC>
__global__ void __launch_bounds__(NT, 2)
tiled_f32_kernel(const float* __restrict__ src, const float* __restrict__ w,
                 const float* __restrict__ a, const float* __restrict__ off,
                 const float* __restrict__ bias, const float* __restrict__ x,
                 float* __restrict__ out, float* __restrict__ ws_a, Tile t, FoldArgs f) {
  constexpr int PR = 8 / PC;              // rows of a thread's pixels
  constexpr int AW = PC == 8 ? 12 : 8;    // floats of a loaded halo row: PC + 2, 16-byte loads
  constexpr bool DGRAD = MODE == kDgrad;
  const int cin = DGRAD ? t.N : t.K, cout = DGRAD ? t.K : t.N;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int2* Tab = reinterpret_cast<int2*>(smem_raw);
  float* RawA = reinterpret_cast<float*>(smem_raw + t.raw_a);
  float* RawW = reinterpret_cast<float*>(smem_raw + t.raw_w);
  float* Act = reinterpret_cast<float*>(smem_raw + t.act);
  float* Wt = reinterpret_cast<float*>(smem_raw + t.wt);
  float* Fold = reinterpret_cast<float*>(smem_raw + t.fold);  // [image][a | off][Cin], stats

  // The tile's origin and this thread's pixels, as functions: the main loop
  // keeps none of them live (each costs a few integer operations where it
  // is used), so its 64 accumulators, 12 halo and 8 weight values and
  // addresses fit 128 registers.
  auto origin = [&](int& b0, int& y0, int& x0) {
    const long mt = (int)blockIdx.x / t.splits;
    const long r = mt / t.tiles_x;
    y0 = (int)(r % t.tiles_y) * t.TH;
    x0 = (int)(mt % t.tiles_x) * t.TW;
    b0 = (int)(r / t.tiles_y) * t.NI;
  };
  // thread row tr of cg = TW / PC column groups: its first tile row (valid
  // where below NI x HP), image of the tile, row in the image and column
  auto rows_of = [&](int m, bool& ok, int& img, int& yin, int& col) {
    const int cg = t.TW / PC, trow = m / cg * PR;
    ok = trow < t.NI * t.HP;
    img = ok ? trow / t.HP : 0;
    yin = ok ? trow % t.HP : 0;
    col = m % cg * PC;
  };
  const int tid = threadIdx.x;
  const int kper = t.K / t.splits, nsl = kper / KC;

  // the halo position -> (pixel b H W + y W + x, or -1; image of the batch,
  // or with FOLD of the tile) table
  {
    int b0, y0, x0;
    origin(b0, y0, x0);
    for (int pos = tid; pos < t.npos; pos += NT) {
      const int i = pos / (t.rows * t.pitch), hy = (pos / t.pitch) % t.rows, hx = pos % t.pitch;
      const int b = b0 + i, yy = y0 - 1 + hy, xx = x0 - 1 + hx;
      const bool in = hx < t.TW + 2 && b < t.B && yy >= 0 && yy < t.H && xx >= 0 && xx < t.W;
      Tab[pos] = make_int2(in ? (b * t.H + yy) * t.W + xx : -1, MODE == kForwardFold ? i : b);
    }
    if constexpr (MODE == kForwardFold)
      fold_tile(f, t.B, cin, b0, t.B - b0 < t.NI ? t.B - b0 : t.NI, Fold, Fold + t.NI * 2 * cin);
  }
  __syncthreads();

  // slice s's raw halo and weight into ring slot s & 1
  auto fetch = [&](int s) {
    const int n0 = (int)blockIdx.y * BN, slot = s & 1;
    const int kc = (int)blockIdx.x % t.splits * kper + s * KC;
    float* ra = RawA + slot * t.npos * 4;
    for (int pos = tid; pos < t.npos; pos += NT) {
      const int px = Tab[pos].x;
      if (px >= 0) cp_async16(ra + pos * 4, src + (long)px * t.K + kc);
    }
    float* rw = RawW + slot * RAW_WSLICE;
    for (int u = tid; u < 9 * BN; u += NT) {
      if constexpr (DGRAD) {
        // [k][tap][n] as it lands: w[8 - tap][co][ci .. ci + 3], ci along N
        const int tap = u / (KC * BN / 4), kk = (u / (BN / 4)) % KC, c4 = u % (BN / 4);
        const int ci = n0 + 4 * c4;
        const bool ok = ci < cin;
        cp_async16(rw + (kk * 9 + tap) * BN + 4 * c4,
                   w + (ok ? ((long)(8 - tap) * cout + kc + kk) * cin + ci : 0), ok);
      } else {
        // [tap][n][k], a unit of padding after every 8: w[tap][co][kc .. kc + 3]
        const int tap = u / BN, col = u % BN, co = n0 + col;
        const bool ok = co < cout;
        cp_async16(rw + (u + u / 8) * KC, w + (ok ? ((long)tap * cout + co) * cin + kc : 0), ok);
      }
    }
    cp_async_commit();
  };

  // slice s from ring slot s & 1 into operand buffer s & 1
  auto prep = [&](int s) {
    const int kc = (int)blockIdx.x % t.splits * kper + s * KC, slot = s & 1;
    const float* ra = RawA + slot * t.npos * 4;
    float* act = Act + slot * KC * t.npos;
    for (int pos = tid; pos < t.npos; pos += NT) {
      const int2 e = Tab[pos];
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (e.x >= 0) {
        v = *reinterpret_cast<const float4*>(ra + pos * 4);
        if constexpr (!DGRAD) {
          float4 av, ov;
          if constexpr (MODE == kForwardFold) {
            av = *reinterpret_cast<const float4*>(Fold + e.y * 2 * cin + kc);
            ov = *reinterpret_cast<const float4*>(Fold + (e.y * 2 + 1) * cin + kc);
          } else {
            const long at = (long)e.y * cin + kc;
            av = __ldg(reinterpret_cast<const float4*>(a + at));
            ov = __ldg(reinterpret_cast<const float4*>(off + at));
          }
          v = make_float4(silu_f(fmaf(v.x, av.x, ov.x)), silu_f(fmaf(v.y, av.y, ov.y)),
                          silu_f(fmaf(v.z, av.z, ov.z)), silu_f(fmaf(v.w, av.w, ov.w)));
        }
      }
      act[pos] = v.x;
      act[t.npos + pos] = v.y;
      act[2 * t.npos + pos] = v.z;
      act[3 * t.npos + pos] = v.w;
    }
    const float* rw = RawW + slot * RAW_WSLICE;
    float* wt = Wt + slot * WSLICE;
    if constexpr (DGRAD) {
      for (int u = tid; u < WSLICE / 4; u += NT)
        reinterpret_cast<float4*>(wt)[u] = reinterpret_cast<const float4*>(rw)[u];
    } else {
      // 4 x 4 transposes, (tap, 4 columns) x 4 channels, two columns at a
      // time (the 16 values of a whole one cost the main loop registers)
      for (int u = tid; u < 9 * BN / 4; u += NT) {
        const int tap = u / (BN / 4), c4 = u % (BN / 4), u0 = tap * BN + 4 * c4;
        const float4* r = reinterpret_cast<const float4*>(rw + (u0 + u0 / 8) * KC);
        float* d = wt + tap * BN + 4 * c4;
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const float4 r0 = r[2 * h2], r1 = r[2 * h2 + 1];
          *reinterpret_cast<float2*>(d + 2 * h2) = make_float2(r0.x, r1.x);
          *reinterpret_cast<float2*>(d + 9 * BN + 2 * h2) = make_float2(r0.y, r1.y);
          *reinterpret_cast<float2*>(d + 18 * BN + 2 * h2) = make_float2(r0.z, r1.z);
          *reinterpret_cast<float2*>(d + 27 * BN + 2 * h2) = make_float2(r0.w, r1.w);
        }
      }
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  auto compute = [&](int s) {
    bool ok;
    int img, yin, col;
    rows_of(tid >> 4, ok, img, yin, col);
    const float* act = Act + (s & 1) * KC * t.npos + (img * t.rows + yin) * t.pitch + col;
    const float* wt = Wt + (s & 1) * WSLICE + 4 * (tid & 15);
#pragma unroll 1
    for (int kk = 0; kk < KC; ++kk) {
      // not unrolled: with the tap rows unrolled ptxas hoisted the next
      // row's loads and spilled 16-64 bytes at the 128 registers that two
      // blocks an SM leave a thread
#pragma unroll 1
      for (int dy = 0; dy < 3; ++dy) {
        float av[PR][AW];
#pragma unroll
        for (int r = 0; r < PR; ++r)
#pragma unroll
          for (int j = 0; j < AW / 4; ++j) {
            const float4 v = *reinterpret_cast<const float4*>(act + (dy + r) * t.pitch + 4 * j);
            av[r][4 * j] = v.x;
            av[r][4 * j + 1] = v.y;
            av[r][4 * j + 2] = v.z;
            av[r][4 * j + 3] = v.w;
          }
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float* wp = wt + (dy * 3 + dx) * BN;
          const float4 w0 = *reinterpret_cast<const float4*>(wp);
          const float4 w1 = *reinterpret_cast<const float4*>(wp + 64);
          const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
          for (int r = 0; r < PR; ++r)
#pragma unroll
            for (int c = 0; c < PC; ++c)
#pragma unroll
              for (int j = 0; j < 8; ++j)
                acc[r * PC + c][j] = fmaf(av[r][c + dx], wv[j], acc[r * PC + c][j]);
        }
      }
      act += t.npos;
      wt += 9 * BN;
    }
  };

  fetch(0);
  if (nsl > 1) fetch(1);
  if (nsl > 1)
    cp_async_wait<1>();
  else
    cp_async_wait<0>();
  __syncthreads();
  prep(0);
  for (int s = 0; s < nsl; ++s) {
    cp_async_wait<0>();  // slice s + 1 landed (this thread's copies)
    __syncthreads();     // every copy of s + 1 and every operand of s in place; slot s & 1 free
    if (s + 2 < nsl) fetch(s + 2);
    if (s + 1 < nsl) prep(s + 1);
    compute(s);
  }

  // ---------------------------------------------------------- epilogue
  __syncthreads();  // every product read its operands: the buffers are free
  const int n = tid & 15, m = tid >> 4, n0 = (int)blockIdx.y * BN;
  const int split = (int)blockIdx.x % t.splits;
  const long mtile = (int)blockIdx.x / t.splits;
  int b0, y0, x0, img, yin, col0;
  bool row_ok;
  origin(b0, y0, x0);
  rows_of(m, row_ok, img, yin, col0);
  float* P = reinterpret_cast<float*>(smem_raw);  // [BM][BN]: this block's partial tile
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    float* row = P + (m * 8 + p) * BN + 4 * n;
    *reinterpret_cast<float4*>(row) = make_float4(acc[p][0], acc[p][1], acc[p][2], acc[p][3]);
    *reinterpret_cast<float4*>(row + 64) = make_float4(acc[p][4], acc[p][5], acc[p][6], acc[p][7]);
  }
  const int S = t.splits, cb = BN / S, c0 = split * cb;  // this block's columns
  if (S > 1)
    cgs::this_cluster().sync();
  else
    __syncthreads();

  // thread (m, n): columns c0 + n + 16 j (j < cb / 16) of its pixels m*8 ..
  // m*8 + 7, a column at a time (the input gradient's row sums in pixel order)
#pragma unroll 1
  for (int j = 0; j < cb / 16; ++j) {
    const int col = c0 + n + 16 * j, ch = n0 + col;
    float sx = 0.f, s1 = 0.f;
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      const int r = p / PC, c = p % PC;
      const int yy = y0 + yin + r, xx = x0 + col0 + c, b = b0 + img;
      float v = 0.f;
      if (S > 1) {
        for (int rk = 0; rk < S; ++rk)
          v += *cgs::this_cluster().map_shared_rank(P + (m * 8 + p) * BN + col, rk);
      } else {
        v = P[(m * 8 + p) * BN + col];
      }
      if (!(row_ok && yin + r < t.TH && yy < t.H && xx < t.W && b < t.B && ch < t.N)) continue;
      const long pix = ((long)b * t.H + yy) * t.W + xx;
      if constexpr (DGRAD) {
        const float xv = x[pix * cin + ch];
        const float av = a[(long)b * cin + ch];
        const float dp = silu_backward(v, fmaf(xv, av, off[(long)b * cin + ch]));
        out[pix * cin + ch] = dp * av;
        sx += dp * xv;
        s1 += dp;
      } else {
        out[pix * cout + ch] = v + bias[ch];
      }
    }
    if constexpr (DGRAD) {  // the row sums, [16][BN][2] after the partial tile
      P[BM * BN + (m * BN + n + 16 * j) * 2] = sx;
      P[BM * BN + (m * BN + n + 16 * j) * 2 + 1] = s1;
    }
  }
  if constexpr (DGRAD) {
    // each (image of the tile, channel)'s sums over the thread rows of that
    // image in order: one partial a (tile, image, channel)
    __syncthreads();
    for (int idx = tid; idx < t.NI * 2 * cb; idx += NT) {
      const int lc = idx % cb, qq = (idx / cb) & 1, i = idx / (2 * cb);
      const int ch = n0 + c0 + lc;
      if (b0 + i >= t.B || ch >= t.N) continue;
      float sum = 0.f;
      for (int mm = 0; mm < 16; ++mm) {
        bool ok;
        int im, yi, cl;
        rows_of(mm, ok, im, yi, cl);
        if (ok && im == i) sum += P[BM * BN + (mm * BN + lc) * 2 + qq];
      }
      ws_a[((mtile * t.NI + i) * 2 + qq) * t.N + ch] = sum;
    }
  }
  if (S > 1) cgs::this_cluster().sync();  // no block leaves while its tile is read
}

// Launch tiled_f32_kernel<MODE, PC> on one call: the tiling, the split that
// fills the card (the most K splits, up to a cluster of 8, whose blocks
// still fit one wave of two blocks an SM, the occupancy the kernel is built
// for), the cluster launch.  The split depends on the shape and the card
// alone, so the FOLD variant, whose table may lower its occupancy, sums in
// the same order as the conv fed (a, off): the same bits.
template <int MODE, int PC>
cudaError_t launch_pc(const float* src, const float* w, const float* a, const float* off,
                      const float* bias, const float* x, float* out, float* ws_a, Tile t,
                      const FoldArgs& f, cudaStream_t stream) {
  auto* kernel = tiled_f32_kernel<MODE, PC>;
  const Layout L(t, MODE == kForwardFold ? t.NI * 2 * (t.K + f.G) : 0);
  const size_t smem = L.bytes;
  t.raw_a = L.raw_a, t.raw_w = L.raw_w, t.act = L.act, t.wt = L.wt, t.fold = L.fold;
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  int sms = 0;
  if ((err = sm_count(&sms)) != cudaSuccess) return err;
  const long blocks = m_tiles(t) * ((t.N + BN - 1) / BN), fill = 2L * sms;
  int s = 1;
  while (s < MAX_SPLITS && blocks * s * 2 <= fill && t.K % (KC * s * 2) == 0) s *= 2;
  t.splits = s;
  const dim3 grid((unsigned)(m_tiles(t) * s), (unsigned)((t.N + BN - 1) / BN));
  if (s == 1) {
    kernel<<<grid, NT, smem, stream>>>(src, w, a, off, bias, x, out, ws_a, t, f);
    return cudaGetLastError();
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = s;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, src, w, a, off, bias, x, out, ws_a, t, f);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The call's tiling (K, N as in Tile) and its launch; cudaErrorInvalidValue
// for what the design does not take (channels not multiples of 4, operands
// not 16-byte aligned, shared memory).
template <int MODE>
cudaError_t launch(const float* src, const float* w, const float* a, const float* off,
                   const float* bias, const float* x, float* out, float* ws_a, int B, int H,
                   int W, int K, int N, const FoldArgs& f, cudaStream_t stream) {
  auto misaligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; };
  if (K % KC || N % 4 || misaligned(src) || misaligned(w) ||
      (MODE == kForward && (misaligned(a) || misaligned(off))))
    return cudaErrorInvalidValue;
  Tile t{B, H, W, K, N, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0};
  set_tile(t);
  if (t.npos > MAX_POS) return cudaErrorInvalidValue;
  if (tile_pc(t.TW) == 8)
    return launch_pc<MODE, 8>(src, w, a, off, bias, x, out, ws_a, t, f, stream);
  return launch_pc<MODE, 4>(src, w, a, off, bias, x, out, ws_a, t, f, stream);
}

}  // namespace tiled
}  // namespace pddm
