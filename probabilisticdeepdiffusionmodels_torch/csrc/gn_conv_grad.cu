// The gradient of the fused affine + SiLU + 3x3 SAME conv + bias
// (gn_conv.cu), channels last.  With p = x*a + off (float32), s = sigmoid(p),
// h = silu(p) rounded to x's dtype and zero outside the image (after the
// activation), and g = dL/dout:
//   dbias[co]        = sum_pixels g[., co]
//   dh[px, ci]       = sum_{tap, co} g[px - tap + 1, co] * w[tap, co, ci]
//   dp               = dh * s * (1 + p * (1 - s))
//   dx               = dp * a            (x's dtype)
//   da[b, ci]        = sum_pixels dp * x,   doff[b, ci] = sum_pixels dp
//   dw[tap, co, ci]  = sum_pixels g[px, co] * h[px + tap - 1, ci]   (w's dtype)
// dh stays float32 between the product and the activation's backward (the
// plain version rounds it to x's dtype, as the conv's input gradient is).
//
// Replaces the gradient of probabilisticdeepdiffusionmodels_tpu/ops/
// gn_conv_pallas.py (_fused_bwd, :238: jax.vjp of the XLA form, which XLA
// compiles into two conv transposes and fused elementwise passes).  Bound on
// the H100: tensor-core operations at the bf16 sites (two products each as
// large as the forward's: a 32x32x128->128 site at batch 128 is 2 x 39 us at
// 989 TFLOP/s), bytes at the float32 output head.  Every design is a fixed
// set of launches with no float atomics, so a call gives the same bits every
// time, and no host synchronisation, so a CUDA graph can hold it:
//   1. dgrad: dh as an implicit GEMM (M = output pixels, N = Cin,
//      K = 9 taps x Cout), the activation's backward in its epilogue, which
//      writes dx and one partial of sum(dp*x) and sum(dp) per (pixel tile,
//      image of the tile, channel) to a workspace;
//   2. wgrad: dw[tap] = h^T g, M x N = Cin x Cout over K = pixels, split over
//      blocks in a fixed assignment of pixel tiles, one partial a split;
//   3. finish: the partials added in a fixed order (da, doff, dw, dbias), dw
//      cast to its dtype.
// ops/gn_conv.py::conv_grad_design picks a design and grad_plan its tiles and
// split; the workspaces and the activation buffer are allocated there from
// them, and the entry point refuses any smaller than its own tiling fills.
//
// wgmma (bf16, Cin and Cout multiples of 8, images of at least 4x4 whose
// pixel count is over 64 or a multiple of 16, so no warp's 16 rows straddle
// two images): the ping-pong dgrad, whose epilogue also stores h =
// silu(x*a + off) in bf16 into a transient (B, H, W, Cin) buffer (where no dx
// is wanted, one elementwise launch writes h instead); then wgrad9.
//   What held the earlier dgrad (wgmma_sync_epilogue below) back: its two
//   consumer warpgroups shared one tile of 128 pixels, so both stopped their
//   products together for the epilogue, which loaded x with dependent 16-byte
//   loads and wrote h and dx with plain stores.  The ping-pong dgrad gives
//   each consumer warpgroup tiles of its own (64 pixels x 128 channels, or
//   128 x 64 where Cin is 64; 128 x 128 would hold 128 float32 accumulators
//   a thread, which serialised the products): tile k of a block goes to
//   warpgroup k % 2, so one warpgroup's products run while the other's
//   epilogue does.  One producer thread streams the weight ring (up to 16
//   stages, as many as fit) and the g halos (four buffers, up to three Cout
//   slices ahead); a second copies each tile's x by TMA through a 4-D (Cin,
//   W, H, B) map, with its images' scale and offset by bulk copies, as soon
//   as the warpgroup's tile before has left the buffer, so no copy of the
//   products waits for an epilogue.  The epilogue reads x from the landed
//   tile (all of a thread's pairs first, then the math, one exponential an
//   element for both h and dp), writes h over x and stores it by TMA (the
//   map clips a ragged tile), then dx over it once that store has read it,
//   and adds the rows' dp*x and dp by shuffles and, warps in order, into the
//   workspace.  A landed weight stage or halo is signalled on a full barrier
//   of the consuming warpgroup's own, waited on in that warpgroup's order
//   (its phase a bit a stage in a register): on a barrier shared by the two,
//   the warpgroup of tile k + 1 waits on a phase up to three ahead of the
//   barrier's, which a parity test takes for the one before.  Each step
//   keeps two groups of products in flight.
//   Measured (time_conv_grad.py, NVIDIA H100 80GB HBM3, 700 W, the CIFAR-10
//   UNet's 60 bf16 sites at batch 128, device-only): 4.11-4.19 ms against
//   the earlier 6.93-6.97 and the library's input product 2.79-2.81; 39-40%
//   of the 1.646 ms bound (operations).  The weight stream: each 64-pixel
//   tile reads its whole weight slice from L2, 5.6-7.2 TB/s at the sites;
//   tiles of 128 pixels x 64 channels halve it (2.4-3.3 TB/s) and made
//   dgrad 5-15% slower, not faster (time_conv_grad.py --dgrad-tile 2,64),
//   so the stream does not set the time and no cluster multicasts it.  A
//   lone warpgroup's step latency and the epilogue's exponentials,
//   reciprocals and bf16 packs, as long as the products they should hide,
//   are the likelier limits; no profiler reaches inside a kernel here.
// wgrad9:
//   What bounded the first design's wgrad (wgmma_taprow below) on this card
//   was not the products: each of its blocks re-activated the x halo for 3
//   taps x 64 channels and refetched its tiles for every (Cout slice, tap
//   row), so each x element was activated 3 x Cout/64 times and each g tile
//   read 3 x Cin/64 times.  wgrad9 activates nothing: it reads h by TMA
//   through a 4-D (Cin, W, H, B) map whose zero fill past the image is
//   exactly the padding after the activation (no halo row of a neighbouring
//   image is read), and one block owns all nine taps of its (pixel split,
//   64 Cin, 64 Cout): three consumer warpgroups, one a tap row, each hold
//   three 64x64 float32 accumulators and take their three shifted views of
//   the same landed h halo (ldmatrix.trans, A = h^T) against the same g tile
//   (B, N-major).  Each h element is read Cout/64 times, each g tile Cin/64
//   times.  One thread of a fourth warpgroup issues the copies into a ring of
//   up to four stages; in the blocks of Cin slice 0 that warpgroup also adds
//   up the landed g rows for dbias (one 16-byte chunk a row and thread, so
//   the sum keeps pace with the products: one warp adding 4 bytes a row held
//   those blocks to half the others' speed), one partial a split.  It gives
//   up registers (setmaxnreg) so that the consumers hold 152 a thread, for
//   96 accumulators and two sets of A fragments (each SM sub-partition holds
//   4 of a block's warps, so no block shape gives more without it).
// wgmma_sync_epilogue (by name only: the second design of this pair, kept so
// that both can be timed in one run): the dgrad of wgmma_taprow below, with
// h stored by its epilogue, then wgrad9.
// wgmma_taprow (by name only: the first design of this pair, kept so that both
// can be timed in one run):
//   dgrad: the forward's persistent, warp-specialised block (one thread
//     issues the TMA copies of the weight ring and of each 64-channel slice
//     of g's halo, whose border past the image arrives zero-filled as g's
//     gradient is zero there; one or two consumer warpgroups), with no
//     activation warps: g is taken as it is.  The weight tile of (Cout slice,
//     tap) lands exactly as the forward stores it, (co, ci) with ci
//     contiguous: an N-major B operand, which wgmma reads transposed
//     (tnspB = 1); the taps are walked flipped (8 - tap).  The epilogue
//     stages the warp's 16 rows of x through shared memory, forms dp from
//     the float32 accumulators, writes dx with 16-byte stores and reduces the
//     rows' dp*x and dp by shuffles; the warps of a tile add theirs in order.
//   wgrad: a block per (split of the pixel tiles, 64-channel slice of Cin,
//     64-channel slice of Cout, row dy of taps).  Warp 0 copies each tile's
//     raw x halo and its g tile (pixels x 64 Cout, Cout contiguous) by TMA;
//     the other 15 warps activate the halo in place (the activation, not the
//     products, bounds this kernel: an activated element feeds only 3 taps x
//     64 channels here); three consumer warpgroups, one per tap of the row,
//     read A = h^T (Cin x pixels) with ldmatrix.trans from the halo shifted
//     by their tap and multiply by B = the g tile, N-major (tnspB = 1),
//     while the next tile is activated.
// narrow_f32 (float32 with Cout <= 8 and Cin % 4 == 0: the UNet's output
// head, 128 -> 3, or 6 under learned sigma).  Bound on the H100: bytes (x
// read and dx written, 67 MB each at batch 128; the products are 2 x 9 x
// Cin x Cout flops a pixel).  general, its first design here, staged K 32
// at a time for a Cout of 3 and re-activated x once a tap.  This is one
// launch (and the finish) that reads x once: the whole weight and the
// tile's g halo stay in shared memory; a thread owns a run of 2 channels (1
// for Cout 7 and 8) and walks every 256 / (Cin / run)-th pixel of the
// tile; from each x value it forms dh (K = 9 Cout, the 9 Cout neighbouring
// g values read once and used twice), dp, dx, its shares of sum(dp*x) and
// sum(dp), h = silu(p) and h times the same g values into its 9 Cout x run
// partials of dw, and its share of dbias.  The block adds its threads'
// partials in a fixed order in shared memory: one partial of dw and dbias
// a tile, one of da and doff a (tile, channel).  True float32 throughout
// (no TF32, as JAX pins it).
// tiled_f32 (float32 with Cin and Cout multiples of 4, Cout > 8, 16-byte
// aligned x, w and g: every float32 site of the shipped configs but the
// head): the input product on the forward's tiled_f32 main loop
// (tiled_f32.cuh: g's halo in place of the activation, the weight flipped,
// read as it lies, (co, ci) with ci along N), its epilogue the activation's
// backward (dx, and one partial of sum(dp*x) and sum(dp) a (tile, image,
// channel)); then general's weight product, unchanged, and the finish.
// general (every other shape and dtype: bf16 with Cin or Cout not a
// multiple of 8, float32 with Cin or Cout not a multiple of 4; by name for
// measurement): 64 pixels x 64 channels a block of 4 warps with operands
// staged in shared memory as float32 and scalar FMAs in true float32.
#include "common.cuh"
#include "hopper.cuh"
#include "tiled_f32.cuh"

using namespace pddm;

namespace {

struct Geom {
  int B, H, W, Cin, Cout;
  int NI, TH, TW;        // images, rows and columns of a pixel tile
  int tiles_y, tiles_x;  // tiles per image along y and x
};

// The same tiling as the forward's (gn_conv.cu::set_tile), mirrored by
// ops/gn_conv.py::conv_tile: whole images, whole rows of one image or a
// segment of one row.
void set_tile(Geom& g, int pixels) {
  const int hw = g.H * g.W;
  if (hw <= pixels) {
    g.NI = pixels / hw;
    g.TH = g.H;
    g.TW = g.W;
  } else if (g.W <= pixels) {
    g.NI = 1;
    g.TW = g.W;
    g.TH = pixels / g.W;
  } else {
    g.NI = 1;
    g.TH = 1;
    g.TW = pixels;
  }
  g.tiles_y = (g.H + g.TH - 1) / g.TH;
  g.tiles_x = (g.W + g.TW - 1) / g.TW;
}

long n_tiles(const Geom& g) { return (long)(g.B + g.NI - 1) / g.NI * g.tiles_y * g.tiles_x; }

__device__ __forceinline__ void tile_origin(const Geom& g, int tile, int& b0, int& y0, int& x0) {
  const int tx = tile % g.tiles_x;
  tile /= g.tiles_x;
  const int ty = tile % g.tiles_y;
  b0 = (tile / g.tiles_y) * g.NI;
  y0 = ty * g.TH;
  x0 = tx * g.TW;
}

// Pixel p of the tile -> its image/row/column and the halo index of its
// tap-(0, 0) neighbour, the pixel up and left of it (0 for padding rows past
// the tile); false for padding pixels past the batch or the image.
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

// Halo position -> image, row, column; false outside the batch or the image.
__device__ __forceinline__ bool halo_at(const Geom& g, int b0, int y0, int x0, int pos, int& bb,
                                        int& yy, int& xx) {
  const int halo_w = g.TW + 2, halo_h = g.TH + 2;
  const int hx = pos % halo_w, t2 = pos / halo_w;
  const int hy = t2 % halo_h, i = t2 / halo_h;
  bb = b0 + i;
  yy = y0 - 1 + hy;
  xx = x0 - 1 + hx;
  return bb < g.B && yy >= 0 && yy < g.H && xx >= 0 && xx < g.W;
}

__device__ __forceinline__ float sigmoid_f(float v) { return 1.f / (1.f + expf(-v)); }

// dL/dp from dL/dh through h = p * sigmoid(p)
__device__ __forceinline__ float silu_grad(float dh, float p) {
  const float s = sigmoid_f(p);
  return dh * s * (1.f + p * (1.f - s));
}

// The same with the fast exponential and division (a few ulp of float32),
// for a gradient stored in bf16 right after.
__device__ __forceinline__ float silu_grad_fast(float dh, float p) {
  const float s = __fdividef(1.f, 1.f + __expf(-p));
  return dh * s * (1.f + p * (1.f - s));
}

// h = silu(x*a + off) of 8 neighbouring bf16 channels, rounded to bf16, as
// the forward's wgmma kernel activates its halo; a and off point at the
// first channel's scale and offset (16-byte aligned)
__device__ __forceinline__ uint4 activate8(uint4 xv, const float* a, const float* off) {
  const float4 a0 = reinterpret_cast<const float4*>(a)[0];
  const float4 a1 = reinterpret_cast<const float4*>(a)[1];
  const float4 o0 = reinterpret_cast<const float4*>(off)[0];
  const float4 o1 = reinterpret_cast<const float4*>(off)[1];
  const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
  const float ov[8] = {o0.x, o0.y, o0.z, o0.w, o1.x, o1.y, o1.z, o1.w};
  const uint32_t* xr = reinterpret_cast<const uint32_t*>(&xv);
  uint4 out;
  uint32_t* hr = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = unpack_bf16(xr[k]);
    hr[k] = pack_bf16(silu_fast(fmaf(f.x, av[2 * k], ov[2 * k])),
                      silu_fast(fmaf(f.y, av[2 * k + 1], ov[2 * k + 1])));
  }
  return out;
}

// h for the whole of x, 8 channels a thread and step: the wgmma design's
// activation where no dgrad runs to store it
__global__ void __launch_bounds__(256)
activate_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ a,
                const float* __restrict__ off, __nv_bfloat16* __restrict__ h, long n8, int hw,
                int Cin) {
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < n8;
       i += (long)gridDim.x * blockDim.x) {
    const long e = 8 * i, px = e / Cin;
    const long at = px / hw * Cin + (e - px * Cin);
    *reinterpret_cast<uint4*>(h + e) =
        activate8(*reinterpret_cast<const uint4*>(x + e), a + at, off + at);
  }
}

// ----------------------------------------------------------------- wgmma

constexpr int WK = 64;  // channels of one 128-byte swizzled row

// ---------------------------------------------------------- wgmma dgrad

constexpr int DSTAGES = 6;  // weight ring

// Shared memory of dgrad, in order: the weight ring, two halo buffers of g
// (each 1024-byte aligned), the consumer warps' epilogue rows, their
// per-channel partial sums, the mbarriers.  Mirrored by
// ops/gn_conv.py::_dgrad_smem.
template <int NWG, int BN>
struct DLayout {
  static constexpr int STAGE = BN * 128;  // bytes of one weight tile
  int halo_stride, ep, part, bars, bytes;
  __host__ __device__ DLayout(int halo_px) {
    halo_stride = (halo_px * 128 + 1023) / 1024 * 1024;
    ep = DSTAGES * STAGE + 2 * halo_stride;
    part = ep + NWG * 4 * 16 * (BN + 8) * 2;
    bars = part + NWG * 4 * 2 * BN * 4;
    bytes = bars + (2 * DSTAGES + 4) * 8;
  }
};

// Warpgroup 0: warp 0 (one lane) issues every copy (per step the weight tile
// of (Cout slice, flipped tap) by TMA, per slice the g halo by TMA), warps
// 1-3 have nothing to do; warpgroups 1 .. NWG compute, as the forward's.
// STORE_H: the epilogue also writes h of the x rows it stages (wgmma).
template <int NWG, int BN, bool STORE_H>
__global__ void __launch_bounds__(128 * (NWG + 1))
dgrad_wgmma_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ a,
                   const float* __restrict__ off, __nv_bfloat16* __restrict__ dx,
                   __nv_bfloat16* __restrict__ h, float* __restrict__ ws_a, Geom g,
                   const __grid_constant__ CUtensorMap wmap,
                   const __grid_constant__ CUtensorMap gmap) {
  constexpr int STAGE = DLayout<NWG, BN>::STAGE;
  constexpr int LDE = BN + 8;
  const int halo_w = g.TW + 2;
  const int halo_px = g.NI * (g.TH + 2) * halo_w;
  const DLayout<NWG, BN> L(halo_px);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* Wring = base;
  unsigned char* Halo = base + DSTAGES * STAGE;
  __nv_bfloat16* Ep = reinterpret_cast<__nv_bfloat16*>(base + L.ep);
  float* Part = reinterpret_cast<float*>(base + L.part);  // [warp][dp*x | dp][channel]
  uint64_t* wfull = reinterpret_cast<uint64_t*>(base + L.bars);
  uint64_t* wempty = wfull + DSTAGES;
  uint64_t* hfull = wempty + DSTAGES;
  uint64_t* hempty = hfull + 2;

  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int nslices = (g.Cout + WK - 1) / WK, per_tile = 9 * nslices;
  const int ntm = (g.B + g.NI - 1) / g.NI * g.tiles_y * g.tiles_x;
  const int mine = (ntm - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const int total = mine * per_tile, total_slices = mine * nslices;
  constexpr int CONSUMER_WARPS = 4 * NWG;

  if (tid == 0) {
    for (int i = 0; i < DSTAGES; ++i) {
      mbar_init(wfull + i, 1);
      mbar_init(wempty + i, CONSUMER_WARPS);
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(hfull + i, 1);
      mbar_init(hempty + i, CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 0) {
    if (lane != 0) return;
    auto load_halo = [&](int gs) {  // Cout slice gs of g's halo into buffer gs & 1
      int b0, y0, x0;
      tile_origin(g, blockIdx.x + (gs / nslices) * gridDim.x, b0, y0, x0);
      uint64_t* bar = hfull + (gs & 1);
      mbar_expect_tx(bar, halo_px * 128);
      tma_load_4d(Halo + (gs & 1) * L.halo_stride, &gmap, bar, (gs % nslices) * WK, x0 - 1, y0 - 1,
                  b0);
    };
    load_halo(0);
    if (total_slices > 1) load_halo(1);
    for (int u = 0; u < total; ++u) {
      const int gs = u / 9;
      if (u % 9 == 5 && gs >= 1 && gs + 1 < total_slices) {
        mbar_wait(hempty + ((gs - 1) & 1), ((gs - 1) >> 1) & 1);
        load_halo(gs + 1);
      }
      const int st = u % DSTAGES;
      if (u >= DSTAGES) mbar_wait(wempty + st, ((u / DSTAGES) - 1) & 1);
      mbar_expect_tx(wfull + st, STAGE);
      // (co slice, tap 8 - t): 64 co rows of 64 ci, BN / 64 boxes side by side
#pragma unroll
      for (int j = 0; j < BN / 64; ++j)
        tma_load_3d(Wring + st * STAGE + j * 8192, &wmap, wfull + st, n0 + 64 * j,
                    (gs % nslices) * WK, 8 - u % 9);
    }
    return;
  }
  if (warp < 4) return;

  // ------------------------------------------------------------ products
  const int cw = warp - 4;
  const int gq = lane >> 2, tq = lane & 3;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  int b0 = 0, y0 = 0, x0 = 0, hb = 0;

  // dp from the accumulators; dx out; the tile's per-(image, channel) sums of
  // dp*x and dp into the workspace, warps added in order
  auto epilogue = [&](int tile) {
    __nv_bfloat16* Ew = Ep + cw * 16 * LDE;
    const int per_img = g.TH * g.TW;
    const long first = ((long)b0 * g.H + y0) * g.W + x0;
    const int npix = g.NI > 1   ? (g.B - b0 < g.NI ? g.B - b0 : g.NI) * g.H * g.W
                     : g.TW == g.W ? (g.H - y0 < g.TH ? g.H - y0 : g.TH) * g.W
                                   : (g.W - x0 < g.TW ? g.W - x0 : g.TW);
    // the warp's 16 rows lie in one image (the design's rule)
    const int bw = b0 + (g.NI > 1 ? (16 * cw) / per_img : 0);
    for (int idx = lane; idx < 16 * (BN / 8); idx += 32) {
      const int r = idx / (BN / 8), c = idx % (BN / 8), ci = n0 + 8 * c, p = 16 * cw + r;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (ci < g.Cin && p < npix) {
        const long at = (first + p) * g.Cin + ci;
        v = *reinterpret_cast<const uint4*>(x + at);
        if (STORE_H)
          *reinterpret_cast<uint4*>(h + at) =
              activate8(v, a + (long)bw * g.Cin + ci, off + (long)bw * g.Cin + ci);
      }
      *reinterpret_cast<uint4*>(Ew + r * LDE + 8 * c) = v;
    }
    __syncwarp();
    float* Pw = Part + cw * 2 * BN;
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      const int c0 = 8 * nt + 2 * tq, ci = n0 + c0;
      const bool cin_ok = ci < g.Cin && bw < g.B;
      float2 av = make_float2(0.f, 0.f), ov = make_float2(0.f, 0.f);
      if (cin_ok) {
        av = *reinterpret_cast<const float2*>(a + (long)bw * g.Cin + ci);
        ov = *reinterpret_cast<const float2*>(off + (long)bw * g.Cin + ci);
      }
      float sx0 = 0.f, sx1 = 0.f, sd0 = 0.f, sd1 = 0.f;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = gq + 8 * half;
        const bool ok = cin_ok && 16 * cw + r < npix;
        uint32_t* slot = reinterpret_cast<uint32_t*>(Ew + r * LDE + c0);
        const float2 xv = unpack_bf16(*slot);
        const float dp0 =
            ok ? silu_grad_fast(acc[4 * nt + 2 * half], fmaf(xv.x, av.x, ov.x)) : 0.f;
        const float dp1 =
            ok ? silu_grad_fast(acc[4 * nt + 2 * half + 1], fmaf(xv.y, av.y, ov.y)) : 0.f;
        *slot = pack_bf16(dp0 * av.x, dp1 * av.y);
        sx0 = fmaf(dp0, xv.x, sx0);
        sx1 = fmaf(dp1, xv.y, sx1);
        sd0 += dp0;
        sd1 += dp1;
      }
#pragma unroll
      for (int m = 4; m < 32; m <<= 1) {
        sx0 += __shfl_xor_sync(0xffffffffu, sx0, m);
        sx1 += __shfl_xor_sync(0xffffffffu, sx1, m);
        sd0 += __shfl_xor_sync(0xffffffffu, sd0, m);
        sd1 += __shfl_xor_sync(0xffffffffu, sd1, m);
      }
      if (gq == 0) {
        Pw[c0] = sx0;
        Pw[c0 + 1] = sx1;
        Pw[BN + c0] = sd0;
        Pw[BN + c0 + 1] = sd1;
      }
    }
    __syncwarp();
    for (int idx = lane; idx < 16 * (BN / 8); idx += 32) {
      const int r = idx / (BN / 8), c = idx % (BN / 8), ci = n0 + 8 * c, p = 16 * cw + r;
      if (ci < g.Cin && p < npix)
        *reinterpret_cast<uint4*>(dx + (first + p) * g.Cin + ci) =
            *reinterpret_cast<const uint4*>(Ew + r * LDE + 8 * c);
    }
    bar_sync_named(1, 128 * NWG);  // every warp's partials are in
    const int ct = tid - 128;
    for (int idx = ct; idx < g.NI * 2 * BN; idx += 128 * NWG) {
      const int c = idx % BN, q = (idx / BN) & 1, i = idx / (2 * BN);
      if (b0 + i >= g.B || n0 + c >= g.Cin) continue;
      float s = 0.f;
      for (int w = 0; w < CONSUMER_WARPS; ++w)
        if (g.NI == 1 || (16 * w) / per_img == i) s += Part[(w * 2 + q) * BN + c];
      ws_a[((long)(tile * g.NI + i) * 2 + q) * g.Cin + n0 + c] = s;
    }
    bar_sync_named(1, 128 * NWG);  // Part is free for the next tile
  };

  auto step = [&](int u, uint32_t (&af)[WK / 16][4], uint32_t (&prev)[WK / 16][4]) {
    const int r = u % per_tile, tap = u % 9, gs = u / 9;
    const int tile = blockIdx.x + (u / per_tile) * gridDim.x;
    if (r == 0) {
      tile_origin(g, tile, b0, y0, x0);
      int pb, py, px;
      pixel(g, b0, y0, x0, 16 * cw + (lane & 15), pb, py, px, hb);
    }
    if (tap == 0) mbar_wait(hfull + (gs & 1), (gs >> 1) & 1);  // g slice gs landed
    const int pos = hb + (tap / 3) * halo_w + tap % 3;
    const unsigned char* row = Halo + (gs & 1) * L.halo_stride + pos * 128;
#pragma unroll
    for (int kk = 0; kk < WK / 16; ++kk)
      ldmatrix_x4(af[kk], row + (((2 * kk + (lane >> 4)) ^ (pos & 7)) << 4));
    __syncwarp();
    mbar_arrive_lane0(hempty + (gs & 1), lane, tap == 8);
    const int st = u % DSTAGES;
    mbar_wait(wfull + st, (u / DSTAGES) & 1);
    const uint64_t desc = smem_desc_sw128_mn(Wring + st * STAGE, 8192);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WK / 16; ++kk) WgmmaT<BN>::mma(acc, af[kk], desc + 128 * kk);
    wgmma_commit();
    if (r == per_tile - 1) {
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) fence_reg(acc[i]);
      epilogue(tile);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    } else {
      wgmma_wait<1>();
    }
    __syncwarp();
    mbar_arrive_lane0(wempty + (u + DSTAGES - 1) % DSTAGES, lane, r != 0);
    mbar_arrive_lane0(wempty + st, lane, r == per_tile - 1);
#pragma unroll
    for (int kk = 0; kk < WK / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) asm volatile("" ::"r"(prev[kk][e]));
  };
  uint32_t af0[WK / 16][4], af1[WK / 16][4];
  int u = 0;
  for (; u + 1 < total; u += 2) {
    step(u, af0, af1);
    step(u + 1, af1, af0);
  }
  if (u < total) step(u, af0, af1);
  wgmma_wait<0>();
}

template <int NWG, int BN>
size_t dgrad_smem(Geom g) {
  set_tile(g, 64 * NWG);
  return 1024 + DLayout<NWG, BN>(g.NI * (g.TH + 2) * (g.TW + 2)).bytes;
}

template <int NWG, int BN, bool STORE_H>
cudaError_t launch_dgrad_wgmma(const void* x, const void* a, const void* off, const void* w,
                               const void* gr, void* dx, void* h, float* ws_a, Geom g,
                               cudaStream_t stream) {
  const size_t smem = dgrad_smem<NWG, BN>(g);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  set_tile(g, 64 * NWG);
  CUtensorMap wmap, gmap;
  const cuuint64_t wdims[3] = {(cuuint64_t)g.Cin, (cuuint64_t)g.Cout, 9};
  const cuuint32_t wbox[3] = {WK, 64, 1};
  const cuuint64_t gdims[4] = {(cuuint64_t)g.Cout, (cuuint64_t)g.W, (cuuint64_t)g.H,
                               (cuuint64_t)g.B};
  const cuuint32_t gbox[4] = {WK, (cuuint32_t)g.TW + 2, (cuuint32_t)g.TH + 2, (cuuint32_t)g.NI};
  cudaError_t err = encode_bf16_map(&wmap, w, 3, wdims, wbox);
  if (err != cudaSuccess) return err;
  if ((err = encode_bf16_map(&gmap, gr, 4, gdims, gbox)) != cudaSuccess) return err;
  if ((err = allow_smem(dgrad_wgmma_kernel<NWG, BN, STORE_H>, smem)) != cudaSuccess) return err;
  int sms = 0;
  static int per_sm = 0;
  static size_t per_sm_smem = 0;
  if ((err = sm_count(&sms)) != cudaSuccess) return err;
  if (per_sm_smem != smem) {
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, dgrad_wgmma_kernel<NWG, BN, STORE_H>, 128 * (NWG + 1), smem)) !=
         cudaSuccess)
      return err;
    per_sm_smem = smem;
  }
  const long ntm = n_tiles(g), ntn = (g.Cin + BN - 1) / BN;
  long gx = (long)(per_sm > 0 ? per_sm : 1) * sms / ntn;
  gx = gx < 1 ? 1 : (gx > ntm ? ntm : gx);
  dgrad_wgmma_kernel<NWG, BN, STORE_H><<<dim3((unsigned)gx, (unsigned)ntn), 128 * (NWG + 1),
                                           smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(a),
      static_cast<const float*>(off), static_cast<__nv_bfloat16*>(dx),
      static_cast<__nv_bfloat16*>(h), ws_a, g, wmap, gmap);
  return cudaGetLastError();
}

// ------------------------------------------------- wgmma dgrad, ping-pong

constexpr int PP_THREADS = 384;  // warpgroups 0 and 1 consume; warpgroup 2 copies
constexpr int PP_PRODUCER = 8;   // its first warp: weights and halos; the second: x
constexpr int PP_HALOS = 4;      // g halo buffers
constexpr int PP_MAX_STAGES = 16;
constexpr int PP_MIN_STAGES = 3;
// registers a thread once the copying warpgroup gives its surplus to the
// consumers: 40 x 128 + 232 x 256 <= 65,536
constexpr int PP_PRODUCER_REGS = 40;
constexpr int PP_CONSUMER_REGS = 232;

// Shared memory of the ping-pong dgrad, in order: the weight ring (`stages`
// tiles of 64 Cout x BN Cin), PP_HALOS g halo buffers (each 1024-byte aligned),
// one x tile a consumer warpgroup (BN / 64 panels of the tile's 64 MT pixels,
// a 128-byte swizzled row a pixel: the box TMA writes; h and then dx are
// staged over it for the TMA stores), the per-(warpgroup, m-tile, warp)
// partial sums of dp*x and dp, each warpgroup's scale and offset of its
// tile's images and channels (copied with x), the mbarriers (a full barrier of each weight
// stage and halo buffer for each consumer warpgroup, one empty barrier of
// each, those of the x tiles).  Mirrored by ops/gn_conv.py::_pingpong_smem.
template <int MT, int BN>
struct PLayout {
  static constexpr int STAGE = BN * 128;
  static constexpr int PANEL = MT * 64 * 128;
  static constexpr int XTILE = (BN / 64) * PANEL;
  int halo_stride, halo, xt, part, ao, bars, bytes;
  __host__ __device__ PLayout(int halo_px, int ni, int stages) {
    halo_stride = (halo_px * 128 + 1023) / 1024 * 1024;
    halo = stages * STAGE;
    xt = halo + PP_HALOS * halo_stride;
    part = xt + 2 * XTILE;
    ao = part + 2 * MT * 4 * 2 * BN * 4;
    bars = ao + 2 * ni * 2 * BN * 4;
    bytes = bars + (3 * PP_MAX_STAGES + 3 * PP_HALOS + 4) * 8;
  }
};

// Block (persistent over tiles blockIdx.x, + gridDim.x, ...; Cin slice
// blockIdx.y) of 384 threads.  Lane 0 of warp 8 issues the copies of the
// products in the order they take them: per step the weight tile of (Cout
// slice, flipped tap), per Cout slice the g halo of the tile, up to
// PP_HALOS - 1 slices ahead; lane 0 of warp 9 copies each tile's x (the
// map's zero fill past the image and the channels) and its images' scale
// and offset as soon as the warpgroup's previous tile has left its buffer,
// so no copy of the products waits for an epilogue.  The
// tiles alternate between consumer warpgroups 1 and 2 (tile k of the block
// to warpgroup k % 2), each holding the tile's MT m64 x BN accumulators, so
// one warpgroup's products run while the other's epilogue does.  The two
// walk the same ring of weight stages and halo buffers, each step taken by
// the warpgroup of its tile; a landed stage or halo is signalled on a full
// barrier of that warpgroup's own, which it waits on in its own order (its
// phase a bit a stage in a register): on a barrier shared by both, the
// warpgroup of tile k + 1 would wait on a phase up to three ahead of the
// barrier's, which a parity test cannot tell from the one before it.
// The epilogue reads x from its landed tile, forms dp, writes h over x and
// stores it by TMA (STORE_H), writes dx over it once that store has read
// the tile and stores it by TMA, and adds the rows' dp*x and dp by shuffles
// and, in a fixed order, through shared memory into the workspace.
template <int MT, int BN, bool STORE_H>
__global__ void __launch_bounds__(PP_THREADS, 1)
dgrad_pingpong_kernel(const float* __restrict__ a, const float* __restrict__ off,
                      float* __restrict__ ws_a, Geom g, int stages,
                      const __grid_constant__ CUtensorMap wmap,
                      const __grid_constant__ CUtensorMap gmap,
                      const __grid_constant__ CUtensorMap xmap,
                      const __grid_constant__ CUtensorMap dxmap,
                      const __grid_constant__ CUtensorMap hmap) {
  using Lay = PLayout<MT, BN>;
  constexpr int STAGE = Lay::STAGE, PANEL = Lay::PANEL, XTILE = Lay::XTILE;
  const int halo_w = g.TW + 2;
  const int halo_px = g.NI * (g.TH + 2) * halo_w;
  const int count = g.NI * g.TH * g.TW;  // rows of an x tile that TMA writes
  const Lay L(halo_px, g.NI, stages);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* Wring = base;
  unsigned char* Halo = base + L.halo;
  unsigned char* Xt = base + L.xt;
  float* Part = reinterpret_cast<float*>(base + L.part);  // [wg][mt][warp][dp*x | dp][channel]
  float* AO = reinterpret_cast<float*>(base + L.ao);      // [wg][image][a | off][channel]
  uint64_t* wfull = reinterpret_cast<uint64_t*>(base + L.bars);  // [warpgroup][stage]
  uint64_t* wempty = wfull + 2 * PP_MAX_STAGES;
  uint64_t* hfull = wempty + PP_MAX_STAGES;  // [warpgroup][buffer]
  uint64_t* hempty = hfull + 2 * PP_HALOS;
  uint64_t* xfull = hempty + PP_HALOS;
  uint64_t* xempty = xfull + 2;

  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int nslices = (g.Cout + WK - 1) / WK, per_tile = 9 * nslices;
  const int ntm = (g.B + g.NI - 1) / g.NI * g.tiles_y * g.tiles_x;
  const int mine = (ntm - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const int total = mine * per_tile, total_slices = mine * nslices;

  if (tid == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(wfull + i, 1);
      mbar_init(wfull + PP_MAX_STAGES + i, 1);
      mbar_init(wempty + i, 4);
    }
    for (int i = 0; i < PP_HALOS; ++i) {
      mbar_init(hfull + i, 1);
      mbar_init(hfull + PP_HALOS + i, 1);
      mbar_init(hempty + i, 4);
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(xfull + i, 1);
      mbar_init(xempty + i, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= PP_PRODUCER) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PP_PRODUCER_REGS));
    if (lane != 0 || warp > PP_PRODUCER + 1) return;
    if (warp == PP_PRODUCER + 1) {
      // tile k's x and its images' scale and offset into its warpgroup's
      // buffer, once the tile before in that buffer has been stored
      const int nc = g.Cin - n0 < BN ? g.Cin - n0 : BN;
      for (int k = 0; k < mine; ++k) {
        int b0, y0, x0;
        tile_origin(g, blockIdx.x + k * gridDim.x, b0, y0, x0);
        const int ni = g.B - b0 < g.NI ? g.B - b0 : g.NI;
        uint64_t* bar = xfull + (k & 1);
        if (k >= 2) mbar_wait(xempty + (k & 1), ((k >> 1) - 1) & 1);
        mbar_expect_tx(bar, (BN / 64) * count * 128 + ni * 2 * nc * 4);
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          tma_load_4d(Xt + (k & 1) * XTILE + j * PANEL, &xmap, bar, n0 + 64 * j, x0, y0, b0);
        float* ao = AO + (k & 1) * g.NI * 2 * BN;
        for (int i = 0; i < ni; ++i) {
          bulk_load(ao + 2 * i * BN, a + (long)(b0 + i) * g.Cin + n0, nc * 4, bar);
          bulk_load(ao + (2 * i + 1) * BN, off + (long)(b0 + i) * g.Cin + n0, nc * 4, bar);
        }
      }
      return;
    }
    // Cout slice gs of g's halo into buffer gs % PP_HALOS
    auto load_halo = [&](int gs) {
      const int k = gs / nslices;
      int b0, y0, x0;
      tile_origin(g, blockIdx.x + k * gridDim.x, b0, y0, x0);
      uint64_t* bar = hfull + (k & 1) * PP_HALOS + gs % PP_HALOS;
      mbar_expect_tx(bar, halo_px * 128);
      tma_load_4d(Halo + (gs % PP_HALOS) * L.halo_stride, &gmap, bar, (gs % nslices) * WK, x0 - 1,
                  y0 - 1, b0);
    };
    for (int gs = 0; gs < PP_HALOS - 1 && gs < total_slices; ++gs) load_halo(gs);
    // step u: stage st of ring round `round`, tap `tap` of Cout slice gs
    // (slice `slice` of tile k); counted, not divided (the stages are a
    // runtime count)
    int st = 0, round = 0, tap = 0, gs = 0, slice = 0, k = 0;
    for (int u = 0; u < total; ++u) {
      // slice gs + PP_HALOS - 1 into the buffer of slice gs - 1 (slice
      // PP_HALOS - 1 into a free one)
      if (tap == 5 && gs + PP_HALOS - 1 < total_slices) {
        if (gs >= 1) mbar_wait(hempty + (gs - 1) % PP_HALOS, ((gs - 1) / PP_HALOS) & 1);
        load_halo(gs + PP_HALOS - 1);
      }
      uint64_t* full = wfull + (k & 1) * PP_MAX_STAGES + st;
      if (round > 0) mbar_wait(wempty + st, (round - 1) & 1);
      mbar_expect_tx(full, STAGE);
      // (co slice, tap 8 - t): 64 co rows of 64 ci, BN / 64 boxes side by side
#pragma unroll
      for (int j = 0; j < BN / 64; ++j)
        tma_load_3d(Wring + st * STAGE + j * 8192, &wmap, full, n0 + 64 * j, slice * WK, 8 - tap);
      if (++st == stages) st = 0, ++round;
      if (++tap == 9) {
        tap = 0, ++gs;
        if (++slice == nslices) slice = 0, ++k;
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(PP_CONSUMER_REGS));

  // ------------------------------------------------------------ products
  const int c = warp / 4, cw = warp & 3, ct = tid - 128 * c;
  const int gq = lane >> 2, tq = lane & 3;
  unsigned char* X = Xt + c * XTILE;
  float acc[MT][BN / 2];
  uint64_t* my_wfull = wfull + c * PP_MAX_STAGES;
  uint64_t* my_hfull = hfull + PP_HALOS * c;
  uint32_t wph = 0, hph = 0;  // the phase of each of this warpgroup's full barriers

  for (int k = c; k < mine; k += 2) {
    const int tile = blockIdx.x + k * gridDim.x;
    int b0, y0, x0, hb[MT];
    tile_origin(g, tile, b0, y0, x0);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      int pb, py, px;
      pixel(g, b0, y0, x0, 64 * mt + 16 * cw + (lane & 15), pb, py, px, hb[mt]);
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[mt][i] = 0.f;

    // step r of the tile (u of the block, ring stage st; s1 and s2 those of
    // the two steps before): A of the MT m-tiles from the g halo shifted by
    // the tap into af, while the two previous steps' products, which read
    // prev and the buffer before it, may still run; once this step's are
    // issued, those of step u - 2 have retired
    int st = k * per_tile % stages, s1 = 0, s2 = 0;
    auto step = [&](int r, uint32_t (&af)[MT][WK / 16][4], uint32_t (&prev)[MT][WK / 16][4]) {
      const int tap = r % 9, gs = k * nslices + r / 9;
      if (tap == 0) {  // g slice gs landed
        mbar_wait(my_hfull + gs % PP_HALOS, (hph >> (gs % PP_HALOS)) & 1);
        hph ^= 1u << (gs % PP_HALOS);
      }
      const unsigned char* hbuf = Halo + (gs % PP_HALOS) * L.halo_stride;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int pos = hb[mt] + (tap / 3) * halo_w + tap % 3;
        const unsigned char* row = hbuf + pos * 128;
#pragma unroll
        for (int kk = 0; kk < WK / 16; ++kk)
          ldmatrix_x4(af[mt][kk], row + (((2 * kk + (lane >> 4)) ^ (pos & 7)) << 4));
      }
      __syncwarp();
      mbar_arrive_lane0(hempty + gs % PP_HALOS, lane, tap == 8);
      mbar_wait(my_wfull + st, (wph >> st) & 1);
      wph ^= 1u << st;
      const uint64_t desc = smem_desc_sw128_mn(Wring + st * STAGE, 8192);
      wgmma_fence();
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int kk = 0; kk < WK / 16; ++kk) WgmmaT<BN>::mma(acc[mt], af[mt][kk], desc + 128 * kk);
      wgmma_commit();
      const bool last = r == per_tile - 1;
      if (last) {
        wgmma_wait<0>();
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int i = 0; i < BN / 2; ++i) fence_reg(acc[mt][i]);
      } else {
        wgmma_wait<2>();
      }
      __syncwarp();
      // the stages of the steps whose products have retired
      mbar_arrive_lane0(wempty + s2, lane, r >= 2);
      mbar_arrive_lane0(wempty + s1, lane, last && r >= 1);
      mbar_arrive_lane0(wempty + st, lane, last);
      s2 = s1;
      s1 = st;
      st = st + 1 == stages ? 0 : st + 1;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int kk = 0; kk < WK / 16; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e) asm volatile("" ::"r"(prev[mt][kk][e]), "r"(af[mt][kk][e]));
    };
    // three A buffers in turn (a tile's steps are a multiple of 9)
    uint32_t af0[MT][WK / 16][4], af1[MT][WK / 16][4], af2[MT][WK / 16][4];
    for (int r = 0; r < per_tile; r += 3) {
      step(r, af0, af2);
      step(r + 1, af1, af0);
      step(r + 2, af2, af1);
    }

    // ---------------------------------------------------------- epilogue
    const int per_img = g.TH * g.TW;
    const int npix = g.NI > 1   ? (g.B - b0 < g.NI ? g.B - b0 : g.NI) * g.H * g.W
                     : g.TW == g.W ? (g.H - y0 < g.TH ? g.H - y0 : g.TH) * g.W
                                   : (g.W - x0 < g.TW ? g.W - x0 : g.TW);
    mbar_wait(xfull + c, (k >> 1) & 1);  // the tile's x landed
    // the thread's pairs (pixel 64 mt + 16 w + gq (+ 8), channels c0, c0 + 1
    // with c0 = 8 nt + 2 tq) in the landed tile; every x read before any h
    // is written over it, so the reads are issued together
    auto slot = [&](int mt, int nt, int half) {
      const int p = 64 * mt + 16 * cw + gq + 8 * half, c0 = 8 * nt + 2 * tq;
      return reinterpret_cast<uint32_t*>(X + (c0 >> 6) * PANEL + p * 128 +
                                         ((((c0 & 63) >> 3) ^ (p & 7)) << 4) + 4 * tq);
    };
    uint32_t xr[MT][BN / 8][2], dxr[MT][BN / 8][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
        for (int half = 0; half < 2; ++half) xr[mt][nt][half] = *slot(mt, nt, half);
    float sums[MT][BN / 8][4];  // the thread's rows' dp*x and dp of channels c0, c0 + 1
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      // the warp's 16 rows of the m-tile lie in one image (the design's rule)
      const int iw = g.NI > 1 ? (64 * mt + 16 * cw) / per_img : 0;
      const float* aow = AO + (c * g.NI + iw) * 2 * BN;
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt) {
        const int c0 = 8 * nt + 2 * tq;
        const bool cin_ok = n0 + c0 < g.Cin && b0 + iw < g.B;
        float2 av = make_float2(0.f, 0.f), ov = make_float2(0.f, 0.f);
        if (cin_ok) {
          av = *reinterpret_cast<const float2*>(aow + c0);
          ov = *reinterpret_cast<const float2*>(aow + BN + c0);
        }
        float* sm = sums[mt][nt];
        sm[0] = sm[1] = sm[2] = sm[3] = 0.f;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const bool ok = cin_ok && 64 * mt + 16 * cw + gq + 8 * half < npix;
          const float2 xv = unpack_bf16(xr[mt][nt][half]);
          const float p0 = fmaf(xv.x, av.x, ov.x), p1 = fmaf(xv.y, av.y, ov.y);
          // one exponential a value for h = silu_fast(p) and dp =
          // silu_grad_fast(dh, p), each the same bits as those functions'
          const float e0 = __expf(-p0), e1 = __expf(-p1);
          const float s0 = __fdividef(1.f, 1.f + e0), s1 = __fdividef(1.f, 1.f + e1);
          const float dp0 = ok ? acc[mt][4 * nt + 2 * half] * s0 * (1.f + p0 * (1.f - s0)) : 0.f;
          const float dp1 =
              ok ? acc[mt][4 * nt + 2 * half + 1] * s1 * (1.f + p1 * (1.f - s1)) : 0.f;
          dxr[mt][nt][half] = pack_bf16(dp0 * av.x, dp1 * av.y);
          if (STORE_H)
            *slot(mt, nt, half) = pack_bf16(__fdividef(p0, 1.f + e0), __fdividef(p1, 1.f + e1));
          sm[0] = fmaf(dp0, xv.x, sm[0]);
          sm[1] = fmaf(dp1, xv.y, sm[1]);
          sm[2] += dp0;
          sm[3] += dp1;
        }
      }
    }
    // the rows' sums over the warp's 8 row groups, every chain at once
#pragma unroll
    for (int m = 4; m < 32; m <<= 1)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sums[mt][nt][e] += __shfl_xor_sync(0xffffffffu, sums[mt][nt][e], m);
    if (gq == 0) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        float* Pw = Part + ((c * MT + mt) * 4 + cw) * 2 * BN;
#pragma unroll
        for (int nt = 0; nt < BN / 8; ++nt) {
          const int c0 = 8 * nt + 2 * tq;
          *reinterpret_cast<float2*>(Pw + c0) = make_float2(sums[mt][nt][0], sums[mt][nt][1]);
          *reinterpret_cast<float2*>(Pw + BN + c0) = make_float2(sums[mt][nt][2], sums[mt][nt][3]);
        }
      }
    }
    if (STORE_H) {
      fence_async_shared();
      bar_sync_named(2 + c, 128);  // h is in the tile
      if (ct == 0) {
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          tma_store_4d(&hmap, X + j * PANEL, n0 + 64 * j, x0, y0, b0);
        bulk_commit();
        bulk_wait_read<0>();
      }
      bar_sync_named(2 + c, 128);  // the store has read h
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
        for (int half = 0; half < 2; ++half) *slot(mt, nt, half) = dxr[mt][nt][half];
    fence_async_shared();
    bar_sync_named(2 + c, 128);  // dx and every warp's partials are in
    if (ct == 0) {
#pragma unroll
      for (int j = 0; j < BN / 64; ++j)
        tma_store_4d(&dxmap, X + j * PANEL, n0 + 64 * j, x0, y0, b0);
      bulk_commit();
    }
    // the tile's per-(image, channel) sums, its warps and m-tiles in order
    for (int idx = ct; idx < g.NI * 2 * BN; idx += 128) {
      const int ch = idx % BN, q = (idx / BN) & 1, i = idx / (2 * BN);
      if (b0 + i >= g.B || n0 + ch >= g.Cin) continue;
      float s = 0.f;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        for (int w = 0; w < 4; ++w)
          if (g.NI == 1 || (64 * mt + 16 * w) / per_img == i)
            s += Part[((c * MT + mt) * 4 + w) * 2 * BN + q * BN + ch];
      ws_a[((long)(tile * g.NI + i) * 2 + q) * g.Cin + n0 + ch] = s;
    }
    bar_sync_named(2 + c, 128);  // Part is free for the next tile
    if (ct == 0) {
      bulk_wait_read<0>();  // the dx store has read the tile: x of tile k + 2 may land
      mbar_arrive(xempty + c);
    }
  }
}

// The weight ring's stages of the ping-pong dgrad: as many as fit the
// shared memory, at most 16; 0 where 3 do not fit.  Mirrored by
// ops/gn_conv.py::_pingpong_stages.
template <int MT, int BN>
int pingpong_stages(Geom g) {
  set_tile(g, 64 * MT);
  const int halo_px = g.NI * (g.TH + 2) * (g.TW + 2);
  for (int s = PP_MAX_STAGES; s >= PP_MIN_STAGES; --s)
    if (1024 + PLayout<MT, BN>(halo_px, g.NI, s).bytes <= 227 * 1024) return s;
  return 0;
}

template <int MT, int BN, bool STORE_H>
cudaError_t launch_dgrad_pingpong(const void* x, const void* a, const void* off, const void* w,
                                  const void* gr, void* dx, void* h, float* ws_a, Geom g,
                                  cudaStream_t stream) {
  const int stages = pingpong_stages<MT, BN>(g);
  if (stages == 0) return cudaErrorInvalidValue;
  set_tile(g, 64 * MT);
  const size_t smem =
      1024 + PLayout<MT, BN>(g.NI * (g.TH + 2) * (g.TW + 2), g.NI, stages).bytes;
  CUtensorMap wmap, gmap, xmap, dxmap, hmap;
  const cuuint64_t wdims[3] = {(cuuint64_t)g.Cin, (cuuint64_t)g.Cout, 9};
  const cuuint32_t wbox[3] = {WK, 64, 1};
  const cuuint64_t gdims[4] = {(cuuint64_t)g.Cout, (cuuint64_t)g.W, (cuuint64_t)g.H,
                               (cuuint64_t)g.B};
  const cuuint32_t gbox[4] = {WK, (cuuint32_t)g.TW + 2, (cuuint32_t)g.TH + 2, (cuuint32_t)g.NI};
  const cuuint64_t xdims[4] = {(cuuint64_t)g.Cin, (cuuint64_t)g.W, (cuuint64_t)g.H,
                               (cuuint64_t)g.B};
  const cuuint32_t xbox[4] = {WK, (cuuint32_t)g.TW, (cuuint32_t)g.TH, (cuuint32_t)g.NI};
  cudaError_t err = encode_bf16_map(&wmap, w, 3, wdims, wbox);
  if (err != cudaSuccess) return err;
  if ((err = encode_bf16_map(&gmap, gr, 4, gdims, gbox)) != cudaSuccess) return err;
  if ((err = encode_bf16_map(&xmap, x, 4, xdims, xbox)) != cudaSuccess) return err;
  if ((err = encode_bf16_map(&dxmap, dx, 4, xdims, xbox)) != cudaSuccess) return err;
  // no h where the weight product does not run: the map is never read
  if ((err = encode_bf16_map(&hmap, STORE_H ? h : dx, 4, xdims, xbox)) != cudaSuccess) return err;
  if ((err = allow_smem(dgrad_pingpong_kernel<MT, BN, STORE_H>, smem)) != cudaSuccess) return err;
  int sms = 0;
  if ((err = sm_count(&sms)) != cudaSuccess) return err;
  // one block an SM (its registers allow no second)
  const long ntm = n_tiles(g), ntn = (g.Cin + BN - 1) / BN;
  long gx = sms / ntn;
  gx = gx < 1 ? 1 : (gx > ntm ? ntm : gx);
  dgrad_pingpong_kernel<MT, BN, STORE_H><<<dim3((unsigned)gx, (unsigned)ntn), PP_THREADS, smem,
                                           stream>>>(static_cast<const float*>(a),
                                                     static_cast<const float*>(off), ws_a, g,
                                                     stages, wmap, gmap, xmap, dxmap, hmap);
  return cudaGetLastError();
}

// ---------------------------------------------------------- wgmma wgrad

constexpr int WG_PX = 128;        // pixels of a wgrad tile: 8 k-steps of 16
constexpr int WG_GBYTES = WG_PX * 128;  // one g tile: a 128-byte row a pixel
constexpr int WG_WORKERS = 480;   // warps 1-15: every warp but the copying one
constexpr int WG_STAGES = 3;      // tile buffers: a copy lands a whole tile ahead of its use

constexpr int WG_BIAS_ROWS = 7;  // dbias: 7 x 64 threads add a g tile's rows

// Shared memory of wgrad: WG_STAGES raw-then-activated x halo buffers, as
// many g tiles and buffers of the slice's scale and offset for each image of
// the tile, the dbias partials, the mbarriers.  Mirrored by
// ops/gn_conv.py::_wgrad_smem.
struct WGLayout {
  int halo_stride, gbuf, ao, bias, bars, bytes;
  __host__ __device__ WGLayout(int halo_px, int ni) {
    halo_stride = (halo_px * 128 + 1023) / 1024 * 1024;
    gbuf = WG_STAGES * halo_stride;
    ao = gbuf + WG_STAGES * WG_GBYTES;
    bias = ao + WG_STAGES * ni * 2 * WK * 4;
    bars = bias + WG_BIAS_ROWS * WK * 4;
    bytes = bars + 2 * WG_STAGES * 8;
  }
};

// Warp 0 (one lane) copies each tile's raw x halo, g tile, scale and offset
// into one of WG_STAGES buffers once the consumers have released it.  Every other
// warp activates: the 15 of them write silu(x*a + off) in place over a
// landed halo (0 outside the image and the batch), then meet at a named
// barrier.  Warpgroups 1-3 then take taps (dy, 0), (dy, 1), (dy, 2): each
// loads its A fragments and issues the tile's 8 products, and while the
// tensor cores run them, helps to activate the next tile before it waits
// for its products and releases the buffer.  dbias is spread evenly over the
// blocks of a (split, Cout slice): block part = dy * (Cin slices) + its Cin
// slice adds the g rows p == part (mod parts) of each tile, 448 of its
// workers taking column t % 64 and every 7th of those rows from t / 64;
// at the end the 7 partials of a column are added in order.
__global__ void __launch_bounds__(512)
wgrad_wgmma_kernel(const float* __restrict__ a, const float* __restrict__ off,
                   float* __restrict__ ws_w, float* __restrict__ ws_b, Geom g,
                   const __grid_constant__ CUtensorMap xmap,
                   const __grid_constant__ CUtensorMap gmap) {
  const int halo_w = g.TW + 2;
  const int halo_px = g.NI * (g.TH + 2) * halo_w;
  const int count = g.NI * g.TH * g.TW;  // rows of a g tile that TMA writes
  const WGLayout L(halo_px, g.NI);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* Halo = base;
  unsigned char* Gt = base + L.gbuf;
  float* AO = reinterpret_cast<float*>(base + L.ao);  // [buffer][image][a | off][channel]
  float* Bias = reinterpret_cast<float*>(base + L.bias);  // [row phase][channel]
  uint64_t* hfull = reinterpret_cast<uint64_t*>(base + L.bars);
  uint64_t* hempty = hfull + WG_STAGES;

  const int ci_slices = (g.Cin + WK - 1) / WK;
  const int cs = (blockIdx.y % ci_slices) * WK, n0 = (blockIdx.y / ci_slices) * WK;
  const int dy = blockIdx.z, z = blockIdx.x, splits = gridDim.x;
  const int ntm = (g.B + g.NI - 1) / g.NI * g.tiles_y * g.tiles_x;
  const int mine = (ntm - z + splits - 1) / splits;
  const int parts = 3 * ci_slices, part = dy * ci_slices + blockIdx.y % ci_slices;
  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);

  // the g rows past a tile's pixels stay zero: their products add nothing
  for (int idx = tid; idx < WG_STAGES * (WG_PX - count) * 32; idx += 512) {
    const int buf = idx / ((WG_PX - count) * 32), rest = idx % ((WG_PX - count) * 32);
    reinterpret_cast<uint32_t*>(Gt + buf * WG_GBYTES + count * 128)[rest] = 0u;
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  if (tid == 0) {
    for (int i = 0; i < WG_STAGES; ++i) {
      mbar_init(hfull + i, 1);
      mbar_init(hempty + i, 12);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 0) {
    if (lane != 0) return;
    const int nc = g.Cin - cs < WK ? g.Cin - cs : WK;
    for (int j = 0; j < mine; ++j) {
      const int buf = j % WG_STAGES;
      if (j >= WG_STAGES) mbar_wait(hempty + buf, ((j - WG_STAGES) / WG_STAGES) & 1);
      int b0, y0, x0;
      tile_origin(g, z + j * splits, b0, y0, x0);
      const int ni = g.B - b0 < g.NI ? g.B - b0 : g.NI;
      uint64_t* bar = hfull + buf;
      mbar_expect_tx(bar, halo_px * 128 + count * 128 + ni * 2 * nc * 4);
      tma_load_4d(Halo + buf * L.halo_stride, &xmap, bar, cs, x0 - 1, y0 - 1, b0);
      tma_load_4d(Gt + buf * WG_GBYTES, &gmap, bar, n0, x0, y0, b0);
      float* ao = AO + buf * g.NI * 2 * WK;
      for (int i = 0; i < ni; ++i) {
        bulk_load(ao + (2 * i) * WK, a + (long)(b0 + i) * g.Cin + cs, nc * 4, bar);
        bulk_load(ao + (2 * i + 1) * WK, off + (long)(b0 + i) * g.Cin + cs, nc * 4, bar);
      }
    }
    return;
  }

  // ---------------------------------------------------- activation
  // a thread always takes 16-byte chunk c of a position (480 % 8 == 0)
  const int wt = tid - 32, c = wt & 7, ci = cs + 8 * c;
  const float inv_w = 1.f / halo_w, inv_h = 1.f / (g.TH + 2);
  float bsum = 0.f;
  auto activate = [&](int j) {
    const int buf = j % WG_STAGES;
    int b0, y0, x0;
    tile_origin(g, z + j * splits, b0, y0, x0);
    mbar_wait(hfull + buf, (j / WG_STAGES) & 1);
    unsigned char* hbuf = Halo + buf * L.halo_stride;
    const float* ao = AO + buf * g.NI * 2 * WK;
    float av[8], ov[8];
    int loaded = -1;
    // two positions at a time, their loads issued together
    for (int idx0 = wt; idx0 < halo_px * 8; idx0 += 2 * WG_WORKERS) {
      uint4 raw[2];
      int img[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int idx = idx0 + q * WG_WORKERS, pos = idx >> 3;
        img[q] = -1;
        if (idx < halo_px * 8) {
          const int t2 = (int)((pos + 0.5f) * inv_w), hx = pos - t2 * halo_w;
          const int i = (int)((t2 + 0.5f) * inv_h), hy = t2 - i * (g.TH + 2);
          const int yy = y0 - 1 + hy, xx = x0 - 1 + hx;
          if (b0 + i < g.B && yy >= 0 && yy < g.H && xx >= 0 && xx < g.W && ci < g.Cin)
            img[q] = i;
          raw[q] = *reinterpret_cast<const uint4*>(hbuf + sw128(pos, c));
        }
      }
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int idx = idx0 + q * WG_WORKERS;
        if (idx >= halo_px * 8) break;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (img[q] >= 0) {
          if (img[q] != loaded) {
            loaded = img[q];
            const float4* ap = reinterpret_cast<const float4*>(ao + loaded * 2 * WK + 8 * c);
            const float4 a0 = ap[0], a1 = ap[1], o0 = ap[WK / 4], o1 = ap[WK / 4 + 1];
            av[0] = a0.x, av[1] = a0.y, av[2] = a0.z, av[3] = a0.w;
            av[4] = a1.x, av[5] = a1.y, av[6] = a1.z, av[7] = a1.w;
            ov[0] = o0.x, ov[1] = o0.y, ov[2] = o0.z, ov[3] = o0.w;
            ov[4] = o1.x, ov[5] = o1.y, ov[6] = o1.z, ov[7] = o1.w;
          }
          const uint32_t* xr = reinterpret_cast<const uint32_t*>(&raw[q]);
          uint32_t* vr = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float2 f = unpack_bf16(xr[k]);
            vr[k] = pack_bf16(silu_fast(fmaf(f.x, av[2 * k], ov[2 * k])),
                              silu_fast(fmaf(f.y, av[2 * k + 1], ov[2 * k + 1])));
          }
        }
        *reinterpret_cast<uint4*>(hbuf + sw128(idx >> 3, c)) = v;
      }
    }
    if (wt < WG_BIAS_ROWS * WK) {  // this block's share of the rows, column wt % 64
      const unsigned char* gt = Gt + buf * WG_GBYTES;
      const int col = wt % WK;
      for (int p = part + parts * (wt / WK); p < count; p += parts * WG_BIAS_ROWS)
        bsum += __bfloat162float(
            *reinterpret_cast<const __nv_bfloat16*>(gt + sw128(p, col >> 3) + (col & 7) * 2));
    }
    // order these generic writes before the TMA that later refills the buffer
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  };

  // ------------------------------------------------------------ products
  const bool consumer = warp >= 4;
  const int wg = warp / 4 - 1, w4 = warp & 3;
  const int tap = consumer ? 3 * dy + wg : 0, shift = (tap / 3) * halo_w + tap % 3;
  const int gq = lane >> 2, tq = lane & 3;
  // this lane's ldmatrix.trans rows: pixel 16 kk + 8 (lane / 16) + lane % 8
  // of the tile (its halo index the same in every tile), channel chunk
  // 2 w4 + (lane / 8) % 2 of the slice
  const int chunk = 2 * w4 + ((lane >> 3) & 1);
  int hbk[WG_PX / 16];
#pragma unroll
  for (int kk = 0; kk < WG_PX / 16; ++kk) {
    int pb, py, px;
    pixel(g, 0, 0, 0, 16 * kk + 8 * (lane >> 4) + (lane & 7), pb, py, px, hbk[kk]);
    hbk[kk] += shift;
  }
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  uint32_t af[WG_PX / 16][4];

  if (mine > 0) activate(0);
  bar_sync_named(1, WG_WORKERS);  // tile 0 activated
  for (int j = 0; j < mine; ++j) {
    const int buf = j % WG_STAGES;
    if (consumer) {
      const unsigned char* hbuf = Halo + buf * L.halo_stride;
#pragma unroll
      for (int kk = 0; kk < WG_PX / 16; ++kk)
        ldmatrix_x4_trans(af[kk], hbuf + hbk[kk] * 128 + ((chunk ^ (hbk[kk] & 7)) << 4));
      const uint64_t desc = smem_desc_sw128_mn(Gt + buf * WG_GBYTES, WG_GBYTES);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < WG_PX / 16; ++kk) WgmmaT<64>::mma(acc, af[kk], desc + 128 * kk);
      wgmma_commit();
    }
    if (j + 1 < mine) activate(j + 1);  // under tile j's products
    if (consumer) {
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < 32; ++i) fence_reg(acc[i]);
#pragma unroll
      for (int kk = 0; kk < WG_PX / 16; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) asm volatile("" ::"r"(af[kk][e]));
      __syncwarp();
      mbar_arrive_lane0(hempty + buf, lane);
    }
    bar_sync_named(1, WG_WORKERS);  // tile j + 1 activated
  }
  if (wt < WG_BIAS_ROWS * WK) Bias[wt] = bsum;
  bar_sync_named(1, WG_WORKERS);
  if (wt < WK && n0 + wt < g.Cout) {
    float s = 0.f;
    for (int r = 0; r < WG_BIAS_ROWS; ++r) s += Bias[r * WK + wt];
    ws_b[((long)z * parts + part) * g.Cout + n0 + wt] = s;
  }
  if (!consumer) return;
  // rows: ci = cs + 16 w4 + gq (+ 8); columns: co = n0 + 8 nt + 2 tq (+ 1)
  float* out = ws_w + (long)(z * 9 + tap) * g.Cout * g.Cin;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int ci = cs + 16 * w4 + gq + 8 * half, co = n0 + 8 * nt + 2 * tq + e;
        if (ci < g.Cin && co < g.Cout) out[(long)co * g.Cin + ci] = acc[4 * nt + 2 * half + e];
      }
}

cudaError_t launch_wgrad_wgmma(const void* x, const void* a, const void* off, const void* gr,
                               float* ws_w, float* ws_b, Geom g, int splits,
                               cudaStream_t stream) {
  set_tile(g, WG_PX);
  const size_t smem = 1024 + WGLayout(g.NI * (g.TH + 2) * (g.TW + 2), g.NI).bytes;
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  CUtensorMap xmap, gmap;
  const cuuint64_t xdims[4] = {(cuuint64_t)g.Cin, (cuuint64_t)g.W, (cuuint64_t)g.H,
                               (cuuint64_t)g.B};
  const cuuint32_t xbox[4] = {WK, (cuuint32_t)g.TW + 2, (cuuint32_t)g.TH + 2, (cuuint32_t)g.NI};
  const cuuint64_t gdims[4] = {(cuuint64_t)g.Cout, (cuuint64_t)g.W, (cuuint64_t)g.H,
                               (cuuint64_t)g.B};
  const cuuint32_t gbox[4] = {WK, (cuuint32_t)g.TW, (cuuint32_t)g.TH, (cuuint32_t)g.NI};
  cudaError_t err = encode_bf16_map(&xmap, x, 4, xdims, xbox);
  if (err != cudaSuccess) return err;
  if ((err = encode_bf16_map(&gmap, gr, 4, gdims, gbox)) != cudaSuccess) return err;
  if ((err = allow_smem(wgrad_wgmma_kernel, smem)) != cudaSuccess) return err;
  const dim3 grid((unsigned)splits,
                  (unsigned)(((g.Cin + WK - 1) / WK) * ((g.Cout + WK - 1) / WK)), 3);
  wgrad_wgmma_kernel<<<grid, 512, smem, stream>>>(static_cast<const float*>(a),
                                                  static_cast<const float*>(off), ws_w, ws_b, g,
                                                  xmap, gmap);
  return cudaGetLastError();
}

// -------------------------------------------------------- wgmma wgrad9

constexpr int W9_THREADS = 512;    // warpgroups 0-2 consume; warpgroup 3 copies (its warp 12)
constexpr int W9_PRODUCER = 12;
constexpr int W9_MAX_STAGES = 4;
// registers a thread after the copying warpgroup gives its surplus to the
// consumers: 40 x 128 + 152 x 384 <= 65,536, and each SM sub-partition's
// one copying and three consuming warps take 32 x (40 + 3 x 152) <= 16,384
constexpr int W9_PRODUCER_REGS = 40;
constexpr int W9_CONSUMER_REGS = 152;

constexpr int W9_BIAS_PHASES = 16;  // the copying warpgroup's 128 threads: 16 rows x 8 chunks

// Shared memory of wgrad9: `stages` h halo buffers (each 1024-byte aligned),
// as many g tiles, the dbias partials of the 16 row phases, the mbarriers.
// Mirrored by ops/gn_conv.py::_wgrad9_smem.
struct W9Layout {
  int halo_stride, gbuf, bias, bars, bytes;
  __host__ __device__ W9Layout(int halo_px, int stages) {
    halo_stride = (halo_px * 128 + 1023) / 1024 * 1024;
    gbuf = stages * halo_stride;
    bias = gbuf + stages * WG_GBYTES;
    bars = bias + W9_BIAS_PHASES * WK * 4;
    bytes = bars + 2 * W9_MAX_STAGES * 8;
  }
};

// Block (split z, Cin slice cs, Cout slice n0) walks tiles z, z + splits,
// ...; warpgroup dy holds taps (dy, 0..2).  A k-step is 16 pixels of the
// tile: the warpgroup loads its three taps' A fragments from the halo
// shifted by each tap and issues three products on the k-step's rows of the
// g tile; one k-step's products stay in flight while the next one's
// fragments load, and the buffer of tile j - 1 is released once the first
// k-step of tile j has retired tile j - 1's last products.
__global__ void __launch_bounds__(W9_THREADS, 1)
wgrad9_wgmma_kernel(float* __restrict__ ws_w, float* __restrict__ ws_b, Geom g, int stages,
                    const __grid_constant__ CUtensorMap hmap,
                    const __grid_constant__ CUtensorMap gmap) {
  const int halo_w = g.TW + 2;
  const int halo_px = g.NI * (g.TH + 2) * halo_w;
  const int count = g.NI * g.TH * g.TW;  // rows of a g tile that TMA writes
  const W9Layout L(halo_px, stages);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* Halo = base;
  unsigned char* Gt = base + L.gbuf;
  float* Bias = reinterpret_cast<float*>(base + L.bias);  // [row phase][channel]
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L.bars);
  uint64_t* empty = full + W9_MAX_STAGES;

  const int ci_slices = (g.Cin + WK - 1) / WK;
  const int cs = (blockIdx.y % ci_slices) * WK, n0 = (blockIdx.y / ci_slices) * WK;
  const bool bias_block = blockIdx.y % ci_slices == 0;
  const int z = blockIdx.x, splits = gridDim.x;
  const int ntm = (g.B + g.NI - 1) / g.NI * g.tiles_y * g.tiles_x;
  const int mine = (ntm - z + splits - 1) / splits;
  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);

  // the g rows past a tile's pixels stay zero: their products add nothing
  for (int idx = tid; idx < stages * (WG_PX - count) * 32; idx += W9_THREADS) {
    const int buf = idx / ((WG_PX - count) * 32), rest = idx % ((WG_PX - count) * 32);
    reinterpret_cast<uint32_t*>(Gt + buf * WG_GBYTES + count * 128)[rest] = 0u;
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  if (tid == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, 12 + (bias_block ? 4 : 0));
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= W9_PRODUCER) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(W9_PRODUCER_REGS));
    // thread 0 of the warpgroup keeps the ring full; in a Cin-slice-0 block
    // the warpgroup adds the g rows of each tile that has landed, `lag`
    // tiles behind the copies (thread t: the 8 channels of 16-byte chunk
    // t % 8 in rows t / 8, t / 8 + 16, ...), and then releases the buffer
    // too; at the end the 16 row phases of a channel are added in order
    const int pt = tid - 32 * W9_PRODUCER;
    if (!bias_block && pt != 0) return;
    const int lag = stages - 1, col = pt & 7, phase = pt >> 3;
    float sum[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) sum[k] = 0.f;
    for (int j = 0; j < mine + lag; ++j) {
      if (j < mine && pt == 0) {
        const int buf = j % stages;
        if (j >= stages) mbar_wait(empty + buf, ((j - stages) / stages) & 1);
        int b0, y0, x0;
        tile_origin(g, z + j * splits, b0, y0, x0);
        mbar_expect_tx(full + buf, halo_px * 128 + count * 128);
        tma_load_4d(Halo + buf * L.halo_stride, &hmap, full + buf, cs, x0 - 1, y0 - 1, b0);
        tma_load_4d(Gt + buf * WG_GBYTES, &gmap, full + buf, n0, x0, y0, b0);
      }
      if (bias_block && j >= lag) {
        const int jb = j - lag, buf = jb % stages;
        mbar_wait(full + buf, (jb / stages) & 1);
        const unsigned char* gt = Gt + buf * WG_GBYTES;
#pragma unroll 4
        for (int p = phase; p < count; p += W9_BIAS_PHASES) {
          const uint4 v = *reinterpret_cast<const uint4*>(gt + sw128(p, col));
          const uint32_t* vr = reinterpret_cast<const uint32_t*>(&v);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float2 f = unpack_bf16(vr[k]);
            sum[2 * k] += f.x;
            sum[2 * k + 1] += f.y;
          }
        }
        __syncwarp();
        mbar_arrive_lane0(empty + buf, lane);
      }
    }
    if (bias_block) {
#pragma unroll
      for (int k = 0; k < 8; ++k) Bias[phase * WK + 8 * col + k] = sum[k];
      bar_sync_named(1, 128);
      if (pt < WK && n0 + pt < g.Cout) {
        float t = 0.f;
        for (int ph = 0; ph < W9_BIAS_PHASES; ++ph) t += Bias[ph * WK + pt];
        ws_b[(long)z * g.Cout + n0 + pt] = t;
      }
    }
    return;
  }

  // ------------------------------------------------------------ products
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(W9_CONSUMER_REGS));
  const int dy = warp >> 2, w4 = warp & 3;
  const int gq = lane >> 2, tq = lane & 3;
  // this lane's ldmatrix.trans rows: pixel 16 kk + 8 (lane / 16) + lane % 8
  // of the tile (its halo index, shifted by the tap row, the same in every
  // tile), channel chunk 2 w4 + (lane / 8) % 2 of the slice
  const int chunk = 2 * w4 + ((lane >> 3) & 1);
  int hbk[WG_PX / 16];
#pragma unroll
  for (int kk = 0; kk < WG_PX / 16; ++kk) {
    int pb, py, px;
    pixel(g, 0, 0, 0, 16 * kk + 8 * (lane >> 4) + (lane & 7), pb, py, px, hbk[kk]);
    hbk[kk] += dy * halo_w;
  }
  float acc[3][32];
#pragma unroll
  for (int t = 0; t < 3; ++t)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[t][i] = 0.f;

  // k-step kk of tile j (buffer buf): A of taps (dy, 0..2) into af, while
  // the previous k-step's products, which read prev, may still run
  auto step = [&](int j, int buf, int kk, uint32_t (&af)[3][4], uint32_t (&prev)[3][4]) {
    const unsigned char* hbuf = Halo + buf * L.halo_stride;
#pragma unroll
    for (int t = 0; t < 3; ++t) {
      const int r = hbk[kk] + t;
      ldmatrix_x4_trans(af[t], hbuf + r * 128 + ((chunk ^ (r & 7)) << 4));
    }
    const uint64_t desc = smem_desc_sw128_mn(Gt + buf * WG_GBYTES, WG_GBYTES) + 128 * kk;
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < 3; ++t) WgmmaT<64>::mma(acc[t], af[t], desc);
    wgmma_commit();
    wgmma_wait<1>();
    __syncwarp();
    // tile j - 1's last products retired: its buffer may be refilled
    mbar_arrive_lane0(empty + (j + stages - 1) % stages, lane, kk == 0 && j > 0);
#pragma unroll
    for (int t = 0; t < 3; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) asm volatile("" ::"r"(prev[t][e]));
  };
  uint32_t af0[3][4], af1[3][4];
  for (int j = 0; j < mine; ++j) {
    const int buf = j % stages;
    mbar_wait(full + buf, (j / stages) & 1);
#pragma unroll
    for (int kk = 0; kk < WG_PX / 16; kk += 2) {
      step(j, buf, kk, af0, af1);
      step(j, buf, kk + 1, af1, af0);
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int t = 0; t < 3; ++t)
#pragma unroll
    for (int i = 0; i < 32; ++i) fence_reg(acc[t][i]);
  // rows: ci = cs + 16 w4 + gq (+ 8); columns: co = n0 + 8 nt + 2 tq (+ 1)
#pragma unroll
  for (int t = 0; t < 3; ++t) {
    float* out = ws_w + (long)(z * 9 + 3 * dy + t) * g.Cout * g.Cin;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int ci = cs + 16 * w4 + gq + 8 * half, co = n0 + 8 * nt + 2 * tq + e;
          if (ci < g.Cin && co < g.Cout) out[(long)co * g.Cin + ci] = acc[t][4 * nt + 2 * half + e];
        }
  }
}

// The ring's stages: as many as fit the shared memory, at most 4; 0 where
// two do not fit.  Mirrored by ops/gn_conv.py::_wgrad9_stages.
int wgrad9_stages(Geom g) {
  set_tile(g, WG_PX);
  const int halo_px = g.NI * (g.TH + 2) * (g.TW + 2);
  for (int s = W9_MAX_STAGES; s >= 2; --s)
    if (1024 + W9Layout(halo_px, s).bytes <= 227 * 1024) return s;
  return 0;
}

cudaError_t launch_wgrad9_wgmma(const void* h, const void* gr, float* ws_w, float* ws_b, Geom g,
                                int splits, cudaStream_t stream) {
  const int stages = wgrad9_stages(g);
  if (stages == 0) return cudaErrorInvalidValue;
  set_tile(g, WG_PX);
  const size_t smem = 1024 + W9Layout(g.NI * (g.TH + 2) * (g.TW + 2), stages).bytes;
  CUtensorMap hmap, gmap;
  const cuuint64_t hdims[4] = {(cuuint64_t)g.Cin, (cuuint64_t)g.W, (cuuint64_t)g.H,
                               (cuuint64_t)g.B};
  const cuuint32_t hbox[4] = {WK, (cuuint32_t)g.TW + 2, (cuuint32_t)g.TH + 2, (cuuint32_t)g.NI};
  const cuuint64_t gdims[4] = {(cuuint64_t)g.Cout, (cuuint64_t)g.W, (cuuint64_t)g.H,
                               (cuuint64_t)g.B};
  const cuuint32_t gbox[4] = {WK, (cuuint32_t)g.TW, (cuuint32_t)g.TH, (cuuint32_t)g.NI};
  cudaError_t err = encode_bf16_map(&hmap, h, 4, hdims, hbox);
  if (err != cudaSuccess) return err;
  if ((err = encode_bf16_map(&gmap, gr, 4, gdims, gbox)) != cudaSuccess) return err;
  if ((err = allow_smem(wgrad9_wgmma_kernel, smem)) != cudaSuccess) return err;
  const dim3 grid((unsigned)splits, (unsigned)(((g.Cin + WK - 1) / WK) * ((g.Cout + WK - 1) / WK)));
  wgrad9_wgmma_kernel<<<grid, W9_THREADS, smem, stream>>>(ws_w, ws_b, g, stages, hmap, gmap);
  return cudaGetLastError();
}

// --------------------------------------------------------------- general

constexpr int GP = 64;   // pixels a block
constexpr int GC = 64;   // channels a block
constexpr int GK = 32;   // K channels a staged slice (dgrad)
constexpr int GT = 128;  // threads a block
constexpr int GLD = GK + 1;

// dgrad: thread (tid / 16, tid % 16) owns pixels tid / 16 + 8 i (i < 8) and
// channels tid % 16 + 16 j (j < 4) of the block's 64 x 64 tile.
template <typename T>
__global__ void __launch_bounds__(GT)
dgrad_general_kernel(const T* __restrict__ x, const float* __restrict__ a,
                     const float* __restrict__ off, const T* __restrict__ w,
                     const T* __restrict__ gr, T* __restrict__ dx, float* __restrict__ ws_a,
                     Geom g) {
  extern __shared__ float sm[];
  const int halo_w = g.TW + 2, halo_px = g.NI * (g.TH + 2) * halo_w;
  float* Gs = sm;                  // [halo_px][GLD]: g, zero outside
  float* Ws = Gs + halo_px * GLD;  // [tap][ci][GLD]: w flipped, (co) along k
  int b0, y0, x0;
  tile_origin(g, blockIdx.x, b0, y0, x0);
  const int n0 = blockIdx.y * GC, tid = threadIdx.x, nl = tid & 15;
  int hb[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    int pb, py, px;
    pixel(g, b0, y0, x0, (tid >> 4) + 8 * i, pb, py, px, hb[i]);
  }
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int co0 = 0; co0 < g.Cout; co0 += GK) {
    __syncthreads();
    for (int idx = tid; idx < halo_px * GK; idx += GT) {
      const int k = idx % GK, pos = idx / GK, co = co0 + k;
      int bb, yy, xx;
      float v = 0.f;
      if (halo_at(g, b0, y0, x0, pos, bb, yy, xx) && co < g.Cout)
        v = to_f(gr[(((long)bb * g.H + yy) * g.W + xx) * g.Cout + co]);
      Gs[pos * GLD + k] = v;
    }
    for (int idx = tid; idx < 9 * GK * GC; idx += GT) {
      const int n = idx % GC, k = (idx / GC) % GK, tap = idx / (GC * GK);
      const int ci = n0 + n, co = co0 + k;
      Ws[(tap * GC + n) * GLD + k] =
          (ci < g.Cin && co < g.Cout) ? to_f(w[((long)(8 - tap) * g.Cout + co) * g.Cin + ci]) : 0.f;
    }
    __syncthreads();
    const int kc = g.Cout - co0 < GK ? g.Cout - co0 : GK;
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int shift = (tap / 3) * halo_w + tap % 3;
      const float* Wt = Ws + tap * GC * GLD;
#pragma unroll 4
      for (int k = 0; k < kc; ++k) {
        float wv[4], gv[8];
#pragma unroll
        for (int j = 0; j < 4; ++j) wv[j] = Wt[(nl + 16 * j) * GLD + k];
#pragma unroll
        for (int i = 0; i < 8; ++i) gv[i] = Gs[(hb[i] + shift) * GLD + k];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(gv[i], wv[j], acc[i][j]);
      }
    }
  }

  __syncthreads();
  float* Red = sm;  // [dp*x | dp][pixel][GC + 1]
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int p = (tid >> 4) + 8 * i;
    int pb, py, px, h_unused;
    const bool valid = pixel(g, b0, y0, x0, p, pb, py, px, h_unused);
    const long at = (((long)pb * g.H + py) * g.W + px) * g.Cin;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = nl + 16 * j, ci = n0 + c;
      float dp = 0.f, xv = 0.f;
      if (valid && ci < g.Cin) {
        xv = to_f(x[at + ci]);
        const float av = a[(long)pb * g.Cin + ci];
        dp = silu_grad(acc[i][j], fmaf(xv, av, off[(long)pb * g.Cin + ci]));
        dx[at + ci] = from_f<T>(dp * av);
      }
      Red[p * (GC + 1) + c] = dp * xv;
      Red[(GP + p) * (GC + 1) + c] = dp;
    }
  }
  __syncthreads();
  const int per_img = g.TH * g.TW;
  for (int idx = tid; idx < g.NI * 2 * GC; idx += GT) {
    const int c = idx % GC, q = (idx / GC) & 1, i = idx / (2 * GC);
    if (b0 + i >= g.B || n0 + c >= g.Cin) continue;
    const int hi = (i + 1) * per_img < GP ? (i + 1) * per_img : GP;
    float s = 0.f;
    for (int p = i * per_img; p < hi; ++p) s += Red[(q * GP + p) * (GC + 1) + c];
    ws_a[((long)(blockIdx.x * g.NI + i) * 2 + q) * g.Cin + n0 + c] = s;
  }
}

// wgrad: a block per (split, Cin tile x Cout tile, tap) walks the chunks of
// 64 flattened pixels split, split + splits, ...; thread (tid / 16, tid % 16)
// owns Cout rows tid / 16 + 8 i (i < BCO / 8) and Cin columns tid % 16 + 16 j.
template <typename T, int BCO>
__global__ void __launch_bounds__(GT)
wgrad_general_kernel(const T* __restrict__ x, const float* __restrict__ a,
                     const float* __restrict__ off, const T* __restrict__ gr,
                     float* __restrict__ ws_w, float* __restrict__ ws_b, Geom g) {
  __shared__ float Hs[GP][GC + 1];  // h at the pixel shifted by the tap
  __shared__ float Gs[GP][BCO + 1];
  const int tap = blockIdx.z, dy = tap / 3, dxp = tap % 3;
  const int ci_tiles = (g.Cin + GC - 1) / GC;
  const int c0 = (blockIdx.y % ci_tiles) * GC, co0 = (blockIdx.y / ci_tiles) * BCO;
  const int z = blockIdx.x, splits = gridDim.x, tid = threadIdx.x;
  const long npx = (long)g.B * g.H * g.W;
  const long chunks = (npx + GP - 1) / GP;
  const bool bias_block = tap == 0 && blockIdx.y % ci_tiles == 0;
  float acc[BCO / 8][4];
#pragma unroll
  for (int i = 0; i < BCO / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float bsum = 0.f;
  for (long ch = z; ch < chunks; ch += splits) {
    __syncthreads();
    for (int idx = tid; idx < GP * GC; idx += GT) {
      const int p = idx / GC, c = idx % GC, ci = c0 + c;
      const long P = ch * GP + p;
      float v = 0.f;
      if (P < npx && ci < g.Cin) {
        const int b = (int)(P / (g.H * g.W)), rem = (int)(P % (g.H * g.W));
        const int yy = rem / g.W + dy - 1, xx = rem % g.W + dxp - 1;
        if (yy >= 0 && yy < g.H && xx >= 0 && xx < g.W) {
          const float xv = to_f(x[(((long)b * g.H + yy) * g.W + xx) * g.Cin + ci]);
          v = to_f(from_f<T>(silu_f(fmaf(xv, a[(long)b * g.Cin + ci], off[(long)b * g.Cin + ci]))));
        }
      }
      Hs[p][c] = v;
    }
    for (int idx = tid; idx < GP * BCO; idx += GT) {
      const int p = idx / BCO, k = idx % BCO, co = co0 + k;
      const long P = ch * GP + p;
      Gs[p][k] = (P < npx && co < g.Cout) ? to_f(gr[P * g.Cout + co]) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int p = 0; p < GP; ++p) {
      float hv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) hv[j] = Hs[p][(tid & 15) + 16 * j];
#pragma unroll
      for (int i = 0; i < BCO / 8; ++i) {
        const float gv = Gs[p][(tid >> 4) + 8 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(gv, hv[j], acc[i][j]);
      }
    }
    if (bias_block && tid < BCO)
      for (int p = 0; p < GP; ++p) bsum += Gs[p][tid];
  }
  float* out = ws_w + (long)(z * 9 + tap) * g.Cout * g.Cin;
#pragma unroll
  for (int i = 0; i < BCO / 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = co0 + (tid >> 4) + 8 * i, ci = c0 + (tid & 15) + 16 * j;
      if (co < g.Cout && ci < g.Cin) out[(long)co * g.Cin + ci] = acc[i][j];
    }
  if (bias_block && tid < BCO && co0 + tid < g.Cout) ws_b[(long)z * g.Cout + co0 + tid] = bsum;
}

template <typename T>
cudaError_t launch_general(const void* x, const void* a, const void* off, const void* w,
                           const void* gr, void* dx, float* ws_a, float* ws_w, float* ws_b,
                           Geom g, bool want_d, bool want_w, int splits, cudaStream_t stream) {
  if (want_d) {
    Geom t = g;
    set_tile(t, GP);
    const size_t halo_px = (size_t)t.NI * (t.TH + 2) * (t.TW + 2);
    size_t smem = sizeof(float) * (halo_px * GLD + 9 * GC * GLD);
    const size_t red = sizeof(float) * 2 * GP * (GC + 1);
    smem = smem > red ? smem : red;
    if (smem > 227 * 1024) return cudaErrorInvalidValue;
    cudaError_t err = allow_smem(dgrad_general_kernel<T>, smem);
    if (err != cudaSuccess) return err;
    dgrad_general_kernel<T><<<dim3((unsigned)n_tiles(t), (g.Cin + GC - 1) / GC), GT, smem,
                               stream>>>(
        static_cast<const T*>(x), static_cast<const float*>(a), static_cast<const float*>(off),
        static_cast<const T*>(w), static_cast<const T*>(gr), static_cast<T*>(dx), ws_a, t);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (want_w) {
    const int ci_tiles = (g.Cin + GC - 1) / GC;
    if (g.Cout <= 16) {
      wgrad_general_kernel<T, 16><<<dim3(splits, ci_tiles * ((g.Cout + 15) / 16), 9), GT, 0,
                                    stream>>>(
          static_cast<const T*>(x), static_cast<const float*>(a), static_cast<const float*>(off),
          static_cast<const T*>(gr), ws_w, ws_b, g);
    } else {
      wgrad_general_kernel<T, 64><<<dim3(splits, ci_tiles * ((g.Cout + 63) / 64), 9), GT, 0,
                                    stream>>>(
          static_cast<const T*>(x), static_cast<const float*>(a), static_cast<const float*>(off),
          static_cast<const T*>(gr), ws_w, ws_b, g);
    }
    return cudaGetLastError();
  }
  return cudaSuccess;
}

// ------------------------------------------------------------ narrow_f32

constexpr int NG_THREADS = 256;
constexpr int NG_PIXELS = 1024;  // pixels of a tile, at most: whole rows of one image

// channels a thread owns: its 9 Cout x run partials of dw stay in registers
__host__ __device__ constexpr int narrow_run(int cout) { return cout <= 6 ? 2 : 1; }

// A tile of whole rows of one image, NG_PIXELS at most (one row where the
// row is longer).  Mirrored by ops/gn_conv.py::_narrow_tile.
void set_narrow_tile(Geom& g) {
  g.NI = 1;
  g.TW = g.W;
  g.TH = g.W >= NG_PIXELS ? 1 : (NG_PIXELS / g.W < g.H ? NG_PIXELS / g.W : g.H);
  g.tiles_y = (g.H + g.TH - 1) / g.TH;
  g.tiles_x = 1;
}

// Shared memory: the g halo and the weight, then (over them) the threads'
// partials.  Mirrored by ops/gn_conv.py::_narrow_grad_smem.
size_t narrow_grad_smem(Geom g) {
  set_narrow_tile(g);
  const size_t run = narrow_run(g.Cout), groups = NG_THREADS / (g.Cin / run);
  const size_t halo = ((size_t)(g.TH + 2) * (g.W + 2) * g.Cout + 3) / 4 * 4;
  const size_t first = halo + 9 * (size_t)g.Cout * g.Cin;
  const size_t parts = groups * (9 * (size_t)g.Cout + 2) * g.Cin + groups * g.Cout;
  return sizeof(float) * (first > parts ? first : parts);
}

template <int N>
__device__ __forceinline__ void load_run(float (&v)[N], const float* p) {
  if constexpr (N == 4) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
  } else if constexpr (N == 2) {
    const float2 f = *reinterpret_cast<const float2*>(p);
    v[0] = f.x, v[1] = f.y;
  } else {
    v[0] = *p;
  }
}

template <int N>
__device__ __forceinline__ void store_run(float* p, const float (&v)[N]) {
  if constexpr (N == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (N == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}

// Block = one tile (image b, rows y0 ..); thread (pg, cg) owns channels
// cg * RUN .. + RUN and pixels pg, pg + groups, ... of the tile, with x two
// pixels ahead in registers.
template <int COUT>
__global__ void __launch_bounds__(NG_THREADS, 1)
grad_narrow_f32_kernel(const float* __restrict__ x, const float* __restrict__ a,
                       const float* __restrict__ off, const float* __restrict__ w,
                       const float* __restrict__ gr, float* __restrict__ dx,
                       float* __restrict__ ws_a, float* __restrict__ ws_w,
                       float* __restrict__ ws_b, Geom g, int want_d, int want_w) {
  constexpr int K = 9 * COUT, RUN = narrow_run(COUT);
  extern __shared__ __align__(16) float smf[];
  const int halo_w = g.W + 2, halo_px = (g.TH + 2) * halo_w;
  float* Gs = smf;                                // [halo pixel][co], zero outside the image
  float* Ws = Gs + (halo_px * COUT + 3) / 4 * 4;  // [tap * Cout + co][ci], as w lies
  const int tile = blockIdx.x, b = tile / g.tiles_y, y0 = (tile % g.tiles_y) * g.TH;
  const int npix = (g.H - y0 < g.TH ? g.H - y0 : g.TH) * g.W;
  const int tpp = g.Cin / RUN, groups = NG_THREADS / tpp;
  const int tid = threadIdx.x, cg = tid % tpp, pg = tid / tpp, ci0 = cg * RUN;
  const bool active = pg < groups;

  for (int idx = tid; idx < halo_px * COUT; idx += NG_THREADS) {
    const int pos = idx / COUT, co = idx - pos * COUT;
    const int hy = pos / halo_w, yy = y0 - 1 + hy, xx = pos - hy * halo_w - 1;
    Gs[idx] = (yy >= 0 && yy < g.H && xx >= 0 && xx < g.W)
                  ? gr[(((long)b * g.H + yy) * g.W + xx) * COUT + co]
                  : 0.f;
  }
  for (int idx = tid; idx < K * g.Cin / 4; idx += NG_THREADS)
    reinterpret_cast<float4*>(Ws)[idx] = reinterpret_cast<const float4*>(w)[idx];
  __syncthreads();

  float dw[K][RUN], sx[RUN], sd[RUN], sb[COUT];
#pragma unroll
  for (int i = 0; i < RUN; ++i) {
    sx[i] = sd[i] = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) dw[k][i] = 0.f;
  }
#pragma unroll
  for (int co = 0; co < COUT; ++co) sb[co] = 0.f;
  if (active) {
    float av[RUN], ov[RUN], xa[RUN], xb[RUN];
    load_run(av, a + (long)b * g.Cin + ci0);
    load_run(ov, off + (long)b * g.Cin + ci0);
    const long first = ((long)b * g.H + y0) * g.W * g.Cin + ci0;
    if (pg < npix) load_run(xa, x + first + (long)pg * g.Cin);
    if (pg + groups < npix) load_run(xb, x + first + (long)(pg + groups) * g.Cin);
    int r = pg / g.W, c = pg - r * g.W;
    for (int q = pg; q < npix; q += groups) {
      float xv[RUN];
#pragma unroll
      for (int i = 0; i < RUN; ++i) xv[i] = xa[i], xa[i] = xb[i];
      if (q + 2 * groups < npix) load_run(xb, x + first + (long)(q + 2 * groups) * g.Cin);
      float p[RUN], s[RUN], hv[RUN], dh[RUN];
#pragma unroll
      for (int i = 0; i < RUN; ++i) {
        p[i] = fmaf(xv[i], av[i], ov[i]);
        s[i] = sigmoid_f(p[i]);
        hv[i] = silu_f(p[i]);
        dh[i] = 0.f;
      }
      // the 9 Cout g values whose products reach this pixel: dh reads them
      // against the weight, dw against h
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const float* gp = Gs + ((r + 2 - tap / 3) * halo_w + c + 2 - tap % 3) * COUT;
#pragma unroll
        for (int co = 0; co < COUT; ++co) {
          const float gv = gp[co];
          float wv[RUN];
          load_run(wv, Ws + (tap * COUT + co) * g.Cin + ci0);
#pragma unroll
          for (int i = 0; i < RUN; ++i) {
            dh[i] = fmaf(gv, wv[i], dh[i]);
            dw[tap * COUT + co][i] = fmaf(gv, hv[i], dw[tap * COUT + co][i]);
          }
        }
      }
      if (cg == 0) {
#pragma unroll
        for (int co = 0; co < COUT; ++co) sb[co] += Gs[((r + 1) * halo_w + c + 1) * COUT + co];
      }
      float dxv[RUN];
#pragma unroll
      for (int i = 0; i < RUN; ++i) {
        const float dp = dh[i] * s[i] * (1.f + p[i] * (1.f - s[i]));
        dxv[i] = dp * av[i];
        sx[i] = fmaf(dp, xv[i], sx[i]);
        sd[i] += dp;
      }
      if (want_d) store_run(dx + first + (long)q * g.Cin, dxv);
      for (c += groups; c >= g.W; c -= g.W) ++r;
    }
  }
  __syncthreads();  // Gs and Ws are read: the partials go over them
  float* Red = smf;                               // [group][tap * Cout + co][ci]
  float* RedA = Red + groups * K * g.Cin;         // [group][dp*x | dp][ci]
  float* RedB = RedA + groups * 2 * g.Cin;        // [group][co]
  if (active) {
#pragma unroll
    for (int k = 0; k < K; ++k) store_run(Red + (pg * K + k) * g.Cin + ci0, dw[k]);
    store_run(RedA + (2 * pg) * g.Cin + ci0, sx);
    store_run(RedA + (2 * pg + 1) * g.Cin + ci0, sd);
    if (cg == 0) {
#pragma unroll
      for (int co = 0; co < COUT; ++co) RedB[pg * COUT + co] = sb[co];
    }
  }
  __syncthreads();
  // the groups' partials added in order
  if (want_w) {
    for (int e = tid; e < K * g.Cin; e += NG_THREADS) {
      float t = 0.f;
      for (int q = 0; q < groups; ++q) t += Red[q * K * g.Cin + e];
      ws_w[(long)tile * K * g.Cin + e] = t;
    }
    if (tid < COUT) {
      float t = 0.f;
      for (int q = 0; q < groups; ++q) t += RedB[q * COUT + tid];
      ws_b[(long)tile * COUT + tid] = t;
    }
  }
  if (want_d) {
    for (int e = tid; e < 2 * g.Cin; e += NG_THREADS) {
      float t = 0.f;
      for (int q = 0; q < groups; ++q) t += RedA[2 * q * g.Cin + e];
      ws_a[(long)tile * 2 * g.Cin + e] = t;
    }
  }
}

template <int COUT>
cudaError_t launch_narrow_cout(const void* x, const void* a, const void* off, const void* w,
                               const void* gr, void* dx, float* ws_a, float* ws_w, float* ws_b,
                               Geom g, bool want_d, bool want_w, cudaStream_t stream) {
  const size_t smem = narrow_grad_smem(g);
  set_narrow_tile(g);
  cudaError_t err = allow_smem(grad_narrow_f32_kernel<COUT>, smem);
  if (err != cudaSuccess) return err;
  grad_narrow_f32_kernel<COUT><<<(unsigned)n_tiles(g), NG_THREADS, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(a), static_cast<const float*>(off),
      static_cast<const float*>(w), static_cast<const float*>(gr), static_cast<float*>(dx),
      ws_a, ws_w, ws_b, g, int(want_d), int(want_w));
  return cudaGetLastError();
}

cudaError_t launch_narrow(const void* x, const void* a, const void* off, const void* w,
                          const void* gr, void* dx, float* ws_a, float* ws_w, float* ws_b, Geom g,
                          bool want_d, bool want_w, cudaStream_t stream) {
  switch (g.Cout) {
#define PDDM_NARROW(C) \
  case C:              \
    return launch_narrow_cout<C>(x, a, off, w, gr, dx, ws_a, ws_w, ws_b, g, want_d, want_w, stream);
    PDDM_NARROW(1)
    PDDM_NARROW(2)
    PDDM_NARROW(3)
    PDDM_NARROW(4)
    PDDM_NARROW(5)
    PDDM_NARROW(6)
    PDDM_NARROW(7)
    PDDM_NARROW(8)
#undef PDDM_NARROW
  }
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------- finish

// One thread an output: da and doff (the sample's tiles in order), dw (the
// splits in order, cast to its dtype), dbias (its bias_parts partials in
// order).
template <typename T>
__global__ void __launch_bounds__(256)
grad_finish_kernel(const float* __restrict__ ws_a, const float* __restrict__ ws_w,
                   const float* __restrict__ ws_b, float* __restrict__ da,
                   float* __restrict__ doff, T* __restrict__ dw, float* __restrict__ dbias,
                   int B, int Cin, int Cout, int NI, int tiles_per_group, int splits,
                   int bias_parts, int na, int nw, int nb) {
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < na) {
    const int b = (int)(idx / Cin), c = (int)(idx % Cin);
    const long first = (long)(b / NI) * tiles_per_group;
    float s0 = 0.f, s1 = 0.f;
    for (int t = 0; t < tiles_per_group; ++t) {
      const long slot = ((first + t) * NI + b % NI) * 2;
      s0 += ws_a[slot * Cin + c];
      s1 += ws_a[(slot + 1) * Cin + c];
    }
    da[idx] = s0;
    doff[idx] = s1;
  } else if (idx < (long)na + nw) {
    const long e = idx - na;
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += ws_w[(long)z * nw + e];
    dw[e] = from_f<T>(s);
  } else if (idx < (long)na + nw + nb) {
    const int co = (int)(idx - na - nw);
    float s = 0.f;
    for (int z = 0; z < bias_parts; ++z) s += ws_b[(long)z * Cout + co];
    dbias[co] = s;
  }
}

}  // namespace

// design: 0 general, 1 wgmma (bf16), 2 narrow_f32 (float32, Cout <= 8), 3
// wgmma_taprow (bf16, by name), 4 wgmma_sync_epilogue (bf16, by name), 5
// tiled_f32 (float32, channels in multiples of 4: its dgrad's tiles are
// tiled_f32.cuh's, its wgrad general's);
// ops/gn_conv.py::conv_grad_design checks what each takes and grad_plan
// gives the tiles and the split (nwg: the tensor-core dgrad's tile in rows of
// 64 pixels, its consumer warpgroups in wgmma_sync_epilogue and wgmma_taprow,
// each consumer's m-tiles in wgmma; bn: its channels a block; splits: the
// weight product's blocks along the pixels, narrow_f32: its tiles).  The
// workspaces hold n_a, n_w and n_b float32 elements; the kernels fill ws_a
// (tiles x images of a tile x 2 x Cin), ws_w (splits x 9 x Cout x Cin) and
// ws_b (splits x Cout, wgmma_taprow: x 3 ceil(Cin / 64)); h, n_h bf16
// elements, holds the activation between the launches of wgmma and
// wgmma_sync_epilogue (B x H x W x Cin; unused by the other designs).  A
// smaller one is refused before any launch.  want_dgrad: dx, da and doff;
// want_wgrad: dw and dbias.  A design, shape, alignment or buffer it does
// not take returns cudaErrorInvalidValue.
extern "C" int pddm_gn_silu_conv3x3_grad(const void* x, const void* a, const void* off,
                                         const void* w, const void* gr, void* dx, void* da,
                                         void* doff, void* dw, void* dbias, void* ws_a,
                                         void* ws_w, void* ws_b, void* h, long long n_a,
                                         long long n_w, long long n_b, long long n_h, int B,
                                         int H, int W, int Cin, int Cout, int is_bf16,
                                         int design, int want_dgrad, int want_wgrad, int nwg,
                                         int bn, int splits, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  Geom g{B, H, W, Cin, Cout, 0, 0, 0, 0, 0};
  float* wsa = static_cast<float*>(ws_a);
  float* wsw = static_cast<float*>(ws_w);
  float* wsb = static_cast<float*>(ws_b);
  cudaError_t err = cudaSuccess;
  const bool tc = design == 1 || design == 3 || design == 4;  // the tensor-core pairs
  const bool h_pair = design == 1 || design == 4;             // dgrad stores h, wgrad9 reads it
  auto misaligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; };
  if (design < 0 || design > 5 || splits < 1 || (tc && want_dgrad && nwg != 1 && nwg != 2))
    return cudaErrorInvalidValue;
  // the tiles whose partials of da and doff the finish adds
  Geom t = g;
  if (design == 2) {
    set_narrow_tile(t);
  } else if (design == 5) {
    tiled::Tile tt{B, H, W, Cout, Cin, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1};
    tiled::set_tile(tt);
    t.NI = tt.NI, t.TH = tt.TH, t.TW = tt.TW, t.tiles_y = tt.tiles_y, t.tiles_x = tt.tiles_x;
  } else {
    set_tile(t, tc && want_dgrad ? 64 * nwg : GP);
  }
  // the dbias partials: one a split (narrow_f32: a tile), wgmma_taprow one a
  // split and weight-product block of the split's Cout slice
  const int bias_parts = splits * (design == 3 ? 3 * ((Cin + WK - 1) / WK) : 1);
  if ((want_dgrad && n_a < n_tiles(t) * t.NI * 2 * Cin) ||
      (want_wgrad && (n_w < (long long)splits * 9 * Cout * Cin ||
                      n_b < (long long)bias_parts * Cout)) ||
      (h_pair && want_wgrad && (n_h < (long long)B * H * W * Cin || misaligned(h))))
    return cudaErrorInvalidValue;
  if (tc) {
    if (!is_bf16 || Cin % 8 || Cout % 8 || (H * W <= 64 && (H * W) % 16) || misaligned(x) ||
        misaligned(w) || misaligned(gr) || (h_pair && (misaligned(a) || misaligned(off))) ||
        (design == 1 && want_dgrad && misaligned(dx)))
      return cudaErrorInvalidValue;
    if (h_pair && want_wgrad && wgrad9_stages(g) == 0) return cudaErrorInvalidValue;
    const bool store_h = h_pair && want_wgrad;
    if (want_dgrad) {
      void* hs = store_h ? h : nullptr;
      if (design == 1) {
#define PDDM_PINGPONG(MT, BN)                                                                  \
  err = store_h ? launch_dgrad_pingpong<MT, BN, true>(x, a, off, w, gr, dx, hs, wsa, g, stream) \
                : launch_dgrad_pingpong<MT, BN, false>(x, a, off, w, gr, dx, hs, wsa, g, stream)
        if (nwg == 2 && bn == 64)
          PDDM_PINGPONG(2, 64);
        else if (nwg == 1 && bn == 128)
          PDDM_PINGPONG(1, 128);
        else if (nwg == 1 && bn == 64)
          PDDM_PINGPONG(1, 64);
        else
          return cudaErrorInvalidValue;
#undef PDDM_PINGPONG
      } else if (nwg == 2 && bn == 128) {
        err = store_h ? launch_dgrad_wgmma<2, 128, true>(x, a, off, w, gr, dx, hs, wsa, g, stream)
                      : launch_dgrad_wgmma<2, 128, false>(x, a, off, w, gr, dx, hs, wsa, g, stream);
      } else if (nwg == 2 && bn == 64) {
        err = store_h ? launch_dgrad_wgmma<2, 64, true>(x, a, off, w, gr, dx, hs, wsa, g, stream)
                      : launch_dgrad_wgmma<2, 64, false>(x, a, off, w, gr, dx, hs, wsa, g, stream);
      } else if (nwg == 1 && bn == 64) {
        err = store_h ? launch_dgrad_wgmma<1, 64, true>(x, a, off, w, gr, dx, hs, wsa, g, stream)
                      : launch_dgrad_wgmma<1, 64, false>(x, a, off, w, gr, dx, hs, wsa, g, stream);
      } else {
        return cudaErrorInvalidValue;
      }
      if (err != cudaSuccess) return err;
    } else if (store_h) {
      const long n8 = (long)B * H * W * Cin / 8;
      const long blocks = (n8 + 255) / 256;
      activate_kernel<<<(unsigned)(blocks < 4096 ? blocks : 4096), 256, 0, stream>>>(
          static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(a),
          static_cast<const float*>(off), static_cast<__nv_bfloat16*>(h), n8, H * W, Cin);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
    if (want_wgrad) {
      err = h_pair ? launch_wgrad9_wgmma(h, gr, wsw, wsb, g, splits, stream)
                   : launch_wgrad_wgmma(x, a, off, gr, wsw, wsb, g, splits, stream);
      if (err != cudaSuccess) return err;
    }
  } else if (design == 2) {
    if (is_bf16 || Cout > 8 || Cin % 4 || Cin / narrow_run(Cout) > NG_THREADS || W > NG_PIXELS ||
        splits != n_tiles(t) || narrow_grad_smem(g) > 227 * 1024 || misaligned(x) ||
        misaligned(w) || misaligned(a) || misaligned(off))
      return cudaErrorInvalidValue;
    if ((err = launch_narrow(x, a, off, w, gr, dx, wsa, wsw, wsb, g, want_dgrad, want_wgrad,
                             stream)) != cudaSuccess)
      return err;
  } else if (design == 5) {
    if (is_bf16 || Cin % 4 || Cout % 4 || misaligned(w) || misaligned(gr))
      return cudaErrorInvalidValue;
    if (want_dgrad &&
        (err = tiled::launch<tiled::kDgrad>(
             static_cast<const float*>(gr), static_cast<const float*>(w),
             static_cast<const float*>(a), static_cast<const float*>(off), nullptr,
             static_cast<const float*>(x), static_cast<float*>(dx), wsa, B, H, W, Cout, Cin,
             FoldArgs{}, stream)) != cudaSuccess)
      return err;
    if (want_wgrad && (err = launch_general<float>(x, a, off, w, gr, dx, wsa, wsw, wsb, g, false,
                                                   true, splits, stream)) != cudaSuccess)
      return err;
  } else {
    err = is_bf16 ? launch_general<__nv_bfloat16>(x, a, off, w, gr, dx, wsa, wsw, wsb, g,
                                                  want_dgrad, want_wgrad, splits, stream)
                  : launch_general<float>(x, a, off, w, gr, dx, wsa, wsw, wsb, g, want_dgrad,
                                          want_wgrad, splits, stream);
    if (err != cudaSuccess) return err;
  }
  const int na = want_dgrad ? B * Cin : 0, nw = want_wgrad ? 9 * Cout * Cin : 0,
            nb = want_wgrad ? Cout : 0;
  const long total = (long)na + nw + nb;
  if (total == 0) return cudaSuccess;
  const unsigned blocks = (unsigned)((total + 255) / 256);
  if (is_bf16)
    grad_finish_kernel<__nv_bfloat16><<<blocks, 256, 0, stream>>>(
        wsa, wsw, wsb, static_cast<float*>(da), static_cast<float*>(doff),
        static_cast<__nv_bfloat16*>(dw), static_cast<float*>(dbias), B, Cin, Cout, t.NI,
        t.tiles_y * t.tiles_x, splits, bias_parts, na, nw, nb);
  else
    grad_finish_kernel<float><<<blocks, 256, 0, stream>>>(
        wsa, wsw, wsb, static_cast<float*>(da), static_cast<float*>(doff),
        static_cast<float*>(dw), static_cast<float*>(dbias), B, Cin, Cout, t.NI,
        t.tiles_y * t.tiles_x, splits, bias_parts, na, nw, nb);
  return cudaGetLastError();
}
