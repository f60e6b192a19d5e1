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
// channel the input channels are contiguous, which is the K-major B operand
// of an implicit GEMM with M = output pixels, N = Cout, K = 9 taps x Cin.
//
// Four designs; ops/gn_conv.py::conv_design picks one and passes it in.
//
// wgmma (bf16 with Cin % 8 == 0, Cout % 8 == 0, 16-byte aligned x and w:
// every bf16 site of the shipped configs).  Bound on the H100: tensor-core
// operations (2 * 9 * Cin * Cout per output pixel; a 32x32x128->128 site at
// batch 128 is 39 us at 989 TFLOP/s), so the products have to run on wgmma
// and nothing else may hold them up.  A persistent block walks over tiles
// of 64 or 128 output pixels (whole images, whole rows or a row segment, so
// their 3x3 neighbourhood is one small halo tile) x 64, 128 or 256 output
// channels; the K loop runs over (64-channel slice of Cin, tap).  The block
// is warp-specialised, its roles joined by mbarriers only:
//   - one thread issues the copies: per step the weight tile of the (slice,
//     tap) by TMA into a ring of 6 stages (4 of 256 channels), in wgmma's
//     K-major layout with the 128-byte swizzle; per slice the raw x halo by
//     TMA (the box starts one pixel before the tile, so the border past the
//     image arrives zero-filled) into one of two halo buffers, about ten
//     steps before its use, and the slice's scale and offset by bulk copy;
//   - three warps write silu(x*a + off) in bf16 over each landed halo, once
//     per element per block, and 0 at every position outside the image or
//     the batch (the zero-filled raw input would give silu(off), not 0);
//   - one or two consumer warpgroups read each tap's A operand with
//     ldmatrix.x4 from the halo shifted by (dy, dx) (the 16-byte chunks of
//     a halo pixel are XOR-swizzled, so the 8 rows of one ldmatrix hit 8
//     bank groups) and issue wgmma.mma_async m64nBNk16 with A from registers
//     and B from the stage, float32 accumulators in registers, one product
//     group left in flight while the next tap's fragments load.
// The epilogue adds the float32 bias, rounds to bf16, stages each warp's 16
// rows in shared memory and stores 16 bytes a lane.

// narrow_f32 (float32 with Cout <= 8 and Cin % 4 == 0: the UNet's output
// head).  Bound on the H100: bytes (the float32 input is read once; 2*9*
// Cin*Cout flops per pixel are few), so the copies must stay in flight.  A
// block of 256 threads covers up to 1024 pixels (a whole 32x32 image); the
// whole (9, Cout, Cin) weight stays in shared memory.  The raw halo of the
// next 8-channel slice is copied with cp.async while the current one is
// computed; one pass per slice activates it into a channel-major tile, and
// each thread computes 4 neighbouring pixels x all of Cout with scalar
// FMAs in true float32 (no TF32, as JAX pins it).
//
// tiled_f32 (float32 with Cin % 4 == 0, Cout % 4 == 0 and Cout > 8, 16-byte
// aligned x, w, a and off: every float32 site of the shipped configs but
// the head; tiled_f32.cuh holds its main loop, shared with the input
// gradient).  Bound on the H100: FP32 operations.  128 pixels x 128 channels
// a block of 256 threads, 8 x 8 accumulators a thread fed by 16-byte shared
// loads; the raw halo and weight slices by cp.async two slices ahead, each
// slice activated once a block; a thread-block cluster splits K where the
// tiles do not fill the card.
//
// general (everything else: bf16 with Cin % 8 != 0 or Cout % 8 != 0, as the
// card test's (3, 28, 28, 36, 24), float32 with Cin % 4 != 0).  The first
// design of this kernel, kept for shapes the three above do not take and by
// name for measurement: 64 pixels x 64 channels a block of 4 warps, the
// activated halo and the weight of a 32-channel slice staged with plain
// loads; bf16 on mma.sync m16n8k16, float32 with scalar FMAs.
//
// Each design has a folding variant (template FOLD; pddm_gn_silu_conv3x3_fold)
// for a spatially sharded forward's slab: in place of (a, off) it takes the
// ranks' summed (2, B, Cin) moments, the rank count, GroupNorm's gamma, beta
// and groups and the conditioning, and folds (a, off) itself with
// gn_fold_kernel's arithmetic (gn_fold.cuh).  Before its main loop a block
// stages the moments of every image it will read in shared memory, forms
// each image's group statistics (whole groups, whatever channels a slice
// cuts) and then a table of every channel's scale and offset, which its
// main loop reads where it read (a, off): wgmma for all its tiles (every
// warp but the copying one, which issues the first copies meanwhile; more
// blocks where the table would not fit), general and tiled_f32 for the
// images of their tile, narrow_f32 for its one image.  No fold launch runs before the conv, and the main
// loop is unchanged.  The instantiations without FOLD are the main path's.
#include <mutex>

#include "common.cuh"
#include "gn_fold.cuh"
#include "hopper.cuh"
#include "tiled_f32.cuh"

using namespace pddm;

namespace {

struct Geom {
  int B, H, W, Cin, Cout;
  int NI, TH, TW;        // images, rows and columns of a pixel tile
  int tiles_y, tiles_x;  // tiles per image along y and x
};

// Tile shape for `pixels` output pixels: whole images (H*W <= pixels),
// whole rows of one image (W <= pixels) or a segment of one row.
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

// Origin (first image, row, column) of pixel tile `tile`.
__device__ __forceinline__ void tile_origin(const Geom& g, int tile, int& b0, int& y0, int& x0) {
  const int tx = tile % g.tiles_x;
  tile /= g.tiles_x;
  const int ty = tile % g.tiles_y;
  b0 = (tile / g.tiles_y) * g.NI;
  y0 = ty * g.TH;
  x0 = tx * g.TW;
}

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

// Halo position -> element offset of its x pixel (channel 0); false outside
// the batch or the image.
__device__ __forceinline__ bool halo_pixel(const Geom& g, int b0, int y0, int x0, int pos,
                                           long& px, int& bb) {
  const int halo_w = g.TW + 2, halo_h = g.TH + 2;
  const int hx = pos % halo_w, t2 = pos / halo_w;
  const int hy = t2 % halo_h, i = t2 / halo_h;
  bb = b0 + i;
  const int yy = y0 - 1 + hy, xx = x0 - 1 + hx;
  px = (((long)bb * g.H + yy) * g.W + xx) * g.Cin;
  return bb < g.B && yy >= 0 && yy < g.H && xx >= 0 && xx < g.W;
}

// ----------------------------------------------------------------- wgmma

constexpr int WK = 64;      // input channels per slice: one 128-byte swizzle row
// weight ring: 6 tiles of 64 or 128 channels, 4 of 256
template <int BN>
constexpr int wstages() { return BN >= 256 ? 4 : 6; }

template <int BN> struct Wgmma;
template <> struct Wgmma<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <> struct Wgmma<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <> struct Wgmma<256> {
  static __device__ __forceinline__ void mma(float (&d)[128], const uint32_t (&a)[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
        "{%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

// Shared memory of the wgmma design, in order: the weight ring, two halo
// buffers (each 1024-byte aligned: the TMA's 128-byte swizzle is laid on
// the address bits), the consumer warps' epilogue rows, two buffers of the
// slice's scale and offset for each image of the tile, the folding variant's
// `fold` bytes (its table of every image of the block's tiles; none
// without FOLD), the halo table, the mbarriers.
template <int NWG, int BN>
struct WLayout {
  static constexpr int WSTAGES = wstages<BN>();
  static constexpr int STAGE = BN * 128;  // bytes of one weight tile
  int halo_stride, ep, ao, fold, tab, bars, bytes;
  __host__ __device__ WLayout(int halo_px, int ni, int fold_bytes = 0) {
    halo_stride = (halo_px * 128 + 1023) / 1024 * 1024;
    ep = WSTAGES * STAGE + 2 * halo_stride;
    ao = ep + NWG * 4 * 16 * (BN + 8) * 2;
    fold = ao + 2 * ni * 2 * WK * 4;
    tab = fold + fold_bytes;
    bars = (tab + halo_px * 8 + 7) / 8 * 8;
    bytes = bars + (2 * WSTAGES + 6) * 8;
  }
};

// Warp-specialised: warpgroup 0 feeds, warpgroups 1 .. NWG compute.
//   warp 0, one lane: issues every copy, each into a buffer its consumers
//     have released (mbarriers): per step the weight tile by TMA, per slice
//     the raw halo by TMA and the tile's scale and offset by bulk copy;
//   warps 1-3: activate each slice's halo in place once it lands, one slice
//     ahead of the products, and release it to the consumers;
//   the consumer warpgroups: per step wait for the weight tile, ldmatrix the
//     A fragments from the activated halo, issue the wgmma products and
//     release the stage of the previous step once it retires.
// FOLD (a spatially sharded forward's slab): no scale or offset is copied.
// Before the roles begin, every warp but the copying one (whose thread
// issues the first copies meanwhile) folds the scale and offset of every
// channel of every image of the block's tiles into a table in shared
// memory, from the ranks' summed moments (FoldArgs) with gn_fold_kernel's
// arithmetic (gn_fold.cuh: the moments staged, each image's group
// statistics over whole groups, then each channel's (a, off)); the
// activation warps read the table where they read the copied slice.  The
// main loop is the one without FOLD: work added to the activation warps'
// loop lengthened every slice (they set its pace), and so did folding each
// slice in the copying warp (both measured on the H100); landing the
// moments by bulk copies was no faster than these loads.
constexpr int ACT_THREADS = 96;
constexpr int FOLD_BARRIER = 1;  // the warps that fold the table

// FOLD's table slot of the block's tile k: one a distinct group of NI
// images among its tiles.  Where the grid is narrower than an image's tiles,
// consecutive tiles of a block (gridDim.x apart) hold the same images or the
// next ones, so the slots are the image groups from the first tile's on;
// else every tile holds other images and has a slot of its own.
__device__ __forceinline__ int fold_slot(const Geom& g, int k) {
  const int tpi = g.tiles_y * g.tiles_x, bx = blockIdx.x;
  return (int)gridDim.x >= tpi ? k : (bx + k * (int)gridDim.x) / tpi - bx / tpi;
}

// FOLD's table in conv_wgmma_kernel, by threads t < nth: row s NI + i holds
// image i of slot s's group (none past the batch), first its summed moments
// [S1 | S2], then its [a | off] over Cin channels; after the rows, each
// (row, group)'s (mean, rstd).  Outlined (noinline): inlined, its registers
// changed how ptxas allocated the main loop, which then ran slower on the
// H100.
__device__ __noinline__ void fold_fill(FoldArgs f, Geom g, int rows, float* table, int t,
                                       int nth) {
  auto image = [&](int r) {
    const int tpi = g.tiles_y * g.tiles_x, bx = blockIdx.x, s = r / g.NI;
    const int group = (int)gridDim.x >= tpi ? (bx + s * (int)gridDim.x) / tpi : bx / tpi + s;
    const int b = group * g.NI + r % g.NI;
    return b < g.B ? b : -1;
  };
  auto sync = [&]() { bar_sync_named(FOLD_BARRIER, nth); };
  // four floats a load where aligned (Cin is a multiple of 8 here)
  if (((reinterpret_cast<uintptr_t>(f.mom) | reinterpret_cast<uintptr_t>(f.gamma) |
        reinterpret_cast<uintptr_t>(f.beta)) & 15) == 0)
    fold_table<true>(f, g.B, g.Cin, rows, image, table, table + rows * 2 * g.Cin, t, nth, sync);
  else
    fold_table<false>(f, g.B, g.Cin, rows, image, table, table + rows * 2 * g.Cin, t, nth, sync);
}

template <int NWG, int BN, bool FOLD>
__global__ void __launch_bounds__(128 * (NWG + 1))
conv_wgmma_kernel(const float* __restrict__ a, const float* __restrict__ off,
                  const float* __restrict__ bias, __nv_bfloat16* __restrict__ out, Geom g,
                  const __grid_constant__ CUtensorMap wmap,
                  const __grid_constant__ CUtensorMap xmap, FoldArgs f) {
  constexpr int STAGE = WLayout<NWG, BN>::STAGE;
  constexpr int WSTAGES = WLayout<NWG, BN>::WSTAGES;
  constexpr int LDE = BN + 8;  // epilogue row (elements)
  const int halo_w = g.TW + 2;
  const int halo_px = g.NI * (g.TH + 2) * halo_w;
  // this block's pixel tiles: blockIdx.x, blockIdx.x + gridDim.x, ...
  const int ntm = (g.B + g.NI - 1) / g.NI * g.tiles_y * g.tiles_x;
  const int mine = (ntm - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const int slots = FOLD ? fold_slot(g, mine - 1) + 1 : 0;
  const WLayout<NWG, BN> L(halo_px, g.NI, slots * g.NI * 2 * (g.Cin + f.G) * 4);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* Wring = base;
  unsigned char* Halo = base + WSTAGES * STAGE;
  __nv_bfloat16* Ep = reinterpret_cast<__nv_bfloat16*>(base + L.ep);
  // [buffer][image of the tile][a | off][channel of the slice]
  float* AO = reinterpret_cast<float*>(base + L.ao);
  // halo position -> (1 inside the image, -1 outside; image of the tile)
  // of the tile being activated
  int2* Tab = reinterpret_cast<int2*>(base + L.tab);
  uint64_t* wfull = reinterpret_cast<uint64_t*>(base + L.bars);  // weight stage landed
  uint64_t* wempty = wfull + WSTAGES;                             // weight stage released
  uint64_t* hfull = wempty + WSTAGES;   // raw halo and scale/offset landed, per buffer
  uint64_t* hready = hfull + 2;         // halo activated
  uint64_t* hempty = hready + 2;        // halo read by every consumer warp

  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x, lane = tid & 31;
  // the warp index, broadcast so the compiler knows it is warp-uniform
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int nslices = (g.Cin + WK - 1) / WK, per_tile = 9 * nslices;
  const int total = mine * per_tile, total_slices = mine * nslices;
  constexpr int CONSUMER_WARPS = 4 * NWG;

  if (tid == 0) {
    for (int i = 0; i < WSTAGES; ++i) {
      mbar_init(wfull + i, 1);
      mbar_init(wempty + i, CONSUMER_WARPS);
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(hfull + i, 1);
      mbar_init(hready + i, ACT_THREADS);
      mbar_init(hempty + i, CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // FOLD: the table (fold_fill), by every warp but the copying one
  float* Tab_ao = reinterpret_cast<float*>(base + L.fold);
  if constexpr (FOLD) {
    if (warp > 0) fold_fill(f, g, slots * g.NI, Tab_ao, tid - 32, (int)blockDim.x - 32);
  }

  if (warp == 0) {
    // ---------------------------------------------------------- copies
    if (lane != 0) return;
    auto load_halo = [&](int gs) {  // slice gs into halo buffer gs & 1
      int b0, y0, x0;
      tile_origin(g, blockIdx.x + (gs / nslices) * gridDim.x, b0, y0, x0);
      const int cs = (gs % nslices) * WK;
      const int ni = g.B - b0 < g.NI ? g.B - b0 : g.NI;
      const int nc = g.Cin - cs < WK ? g.Cin - cs : WK;
      uint64_t* bar = hfull + (gs & 1);
      mbar_expect_tx(bar, halo_px * 128 + (FOLD ? 0 : ni * 2 * nc * 4));
      tma_load_4d(Halo + (gs & 1) * L.halo_stride, &xmap, bar, cs, x0 - 1, y0 - 1, b0);
      if constexpr (!FOLD) {
        float* ao = AO + (gs & 1) * g.NI * 2 * WK;
        for (int i = 0; i < ni; ++i) {
          bulk_load(ao + (2 * i) * WK, a + (long)(b0 + i) * g.Cin + cs, nc * 4, bar);
          bulk_load(ao + (2 * i + 1) * WK, off + (long)(b0 + i) * g.Cin + cs, nc * 4, bar);
        }
      }
    };
    load_halo(0);
    if (total_slices > 1) load_halo(1);
    for (int u = 0; u < total; ++u) {
      // halo gs + 1 goes into the buffer of slice gs - 1 as soon as the
      // consumers have read that slice, about ten steps before its use
      const int gs = u / 9;
      if (u % 9 == 5 && gs >= 1 && gs + 1 < total_slices) {
        mbar_wait(hempty + ((gs - 1) & 1), ((gs - 1) >> 1) & 1);
        load_halo(gs + 1);
      }
      // weight tile u, into a stage released by step u - WSTAGES
      const int st = u % WSTAGES;
      if (u >= WSTAGES) mbar_wait(wempty + st, ((u / WSTAGES) - 1) & 1);
      mbar_expect_tx(wfull + st, STAGE);
      tma_load_3d(Wring + st * STAGE, &wmap, wfull + st, (gs % nslices) * WK, n0, u % 9);
    }
    return;
  }

  if (warp < 4) {
    // ---------------------------------------------------- activation
    const int t = tid - 32;
    for (int gs = 0; gs < total_slices; ++gs) {
      const int buf = gs & 1, cs = (gs % nslices) * WK;
      int b0, y0, x0;
      tile_origin(g, blockIdx.x + (gs / nslices) * gridDim.x, b0, y0, x0);
      mbar_wait(hfull + buf, (gs >> 1) & 1);
      unsigned char* hbuf = Halo + buf * L.halo_stride;
      // the slice's scale and offset: the copied ones, or (FOLD) the table's
      const int img = FOLD ? 2 * g.Cin : 2 * WK, half = FOLD ? g.Cin : WK;
      const float* ao = FOLD ? Tab_ao + fold_slot(g, gs / nslices) * g.NI * img + cs
                             : AO + buf * g.NI * 2 * WK;
      const int c = t & 7, ci = cs + 8 * c;  // a thread always takes chunk t & 7
      // the chunk's scale and offset, for the tile's first image (the only
      // one, except at whole-image tiles, which reload per chunk)
      float av[8], ov[8];
      auto load_ao = [&](int i) {
        const float4* ap = reinterpret_cast<const float4*>(ao + i * img + 8 * c);
        const float4 a0 = ap[0], a1 = ap[1], o0 = ap[half / 4], o1 = ap[half / 4 + 1];
        av[0] = a0.x, av[1] = a0.y, av[2] = a0.z, av[3] = a0.w;
        av[4] = a1.x, av[5] = a1.y, av[6] = a1.z, av[7] = a1.w;
        ov[0] = o0.x, ov[1] = o0.y, ov[2] = o0.z, ov[3] = o0.w;
        ov[4] = o1.x, ov[5] = o1.y, ov[6] = o1.z, ov[7] = o1.w;
      };
      load_ao(0);
      const float inv_w = 1.f / halo_w, inv_h = 1.f / (g.TH + 2);
      // four chunks at a time, their loads issued together
      for (int idx0 = t; idx0 < halo_px * 8; idx0 += 4 * ACT_THREADS) {
        int2 e[4];
        uint4 raw[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int idx = idx0 + j * ACT_THREADS, pos = idx >> 3;
          e[j] = make_int2(-1, 0);
          if (idx < halo_px * 8) {
            if (cs == 0) {  // the tile's first slice: fill the table
              const int t2 = (int)((pos + 0.5f) * inv_w), hx = pos - t2 * halo_w;
              const int i = (int)((t2 + 0.5f) * inv_h), hy = t2 - i * (g.TH + 2);
              const int yy = y0 - 1 + hy, xx = x0 - 1 + hx;
              const bool in = b0 + i < g.B && yy >= 0 && yy < g.H && xx >= 0 && xx < g.W;
              e[j] = make_int2(in ? 1 : -1, i);
              Tab[pos] = e[j];
            } else {
              e[j] = Tab[pos];
            }
            raw[j] = *reinterpret_cast<const uint4*>(hbuf + sw128(pos, c));
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int idx = idx0 + j * ACT_THREADS;
          if (idx >= halo_px * 8) break;
          uint4 v = make_uint4(0u, 0u, 0u, 0u);
          if (e[j].x >= 0 && ci < g.Cin) {
            if (g.NI > 1) load_ao(e[j].y);
            const uint32_t* xr = reinterpret_cast<const uint32_t*>(&raw[j]);
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
      // order these generic writes before the TMA that later refills the buffer
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(hready + buf);
    }
    return;
  }

  // ------------------------------------------------------------ products
  const int cw = warp - 4;  // consumer warp: rows 16 * cw .. of the tile
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  int b0 = 0, y0 = 0, x0 = 0, hb = 0;  // the current tile, and this lane's ldmatrix row in it

  // + bias, bf16, staged in the warp's own rows of Ep, 16-byte stores
  auto epilogue = [&]() {
    __nv_bfloat16* Ew = Ep + cw * 16 * LDE;
    const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      const int co = n0 + 8 * nt + 2 * tq;
      const float b0f = co < g.Cout ? bias[co] : 0.f, b1f = co < g.Cout ? bias[co + 1] : 0.f;
#pragma unroll
      for (int half = 0; half < 2; ++half)
        *reinterpret_cast<uint32_t*>(Ew + (gq + 8 * half) * LDE + 8 * nt + 2 * tq) =
            pack_bf16(acc[4 * nt + 2 * half] + b0f, acc[4 * nt + 2 * half + 1] + b1f);
    }
    __syncwarp();
    // the tile's pixels are contiguous in memory (whole images, whole rows
    // or a row segment), its first `npix` of them inside the batch and image
    const long first = ((long)b0 * g.H + y0) * g.W + x0;
    const int npix = g.NI > 1   ? (g.B - b0 < g.NI ? g.B - b0 : g.NI) * g.H * g.W
                     : g.TW == g.W ? (g.H - y0 < g.TH ? g.H - y0 : g.TH) * g.W
                                   : (g.W - x0 < g.TW ? g.W - x0 : g.TW);
    for (int idx = lane; idx < 16 * (BN / 8); idx += 32) {
      const int r = idx / (BN / 8), c = idx % (BN / 8), co = n0 + 8 * c, p = 16 * cw + r;
      if (co < g.Cout && p < npix)
        *reinterpret_cast<uint4*>(out + (first + p) * g.Cout + co) =
            *reinterpret_cast<const uint4*>(Ew + r * LDE + 8 * c);
    }
    __syncwarp();
  };

  // One step.  The A fragments of a product in flight must keep their
  // registers until it completes, so the steps alternate between two
  // fragment arrays, and each step holds the previous step's array live
  // until its wgmma.wait_group has retired that product.
  auto step = [&](int u, uint32_t (&af)[WK / 16][4], uint32_t (&prev)[WK / 16][4]) {
    const int r = u % per_tile, tap = u % 9, gs = u / 9;
    if (r == 0) {
      tile_origin(g, blockIdx.x + (u / per_tile) * gridDim.x, b0, y0, x0);
      int pb, py, px;
      pixel(g, b0, y0, x0, 16 * cw + (lane & 15), pb, py, px, hb);
    }
    if (tap == 0) mbar_wait(hready + (gs & 1), (gs >> 1) & 1);  // slice gs activated
    const int pos = hb + (tap / 3) * halo_w + tap % 3;
    const unsigned char* row = Halo + (gs & 1) * L.halo_stride + pos * 128;
#pragma unroll
    for (int kk = 0; kk < WK / 16; ++kk)
      ldmatrix_x4(af[kk], row + (((2 * kk + (lane >> 4)) ^ (pos & 7)) << 4));
    __syncwarp();  // the last read of this halo buffer (tap 8): release it
    mbar_arrive_lane0(hempty + (gs & 1), lane, tap == 8);
    const int st = u % WSTAGES;
    mbar_wait(wfull + st, (u / WSTAGES) & 1);  // weight tile u landed
    const uint64_t desc = smem_desc_sw128(Wring + st * STAGE);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WK / 16; ++kk) Wgmma<BN>::mma(acc, af[kk], desc + 2 * kk);
    wgmma_commit();
    if (r == per_tile - 1) {  // the tile's last product: write it out, start the next
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) fence_reg(acc[i]);
      epilogue();
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    } else {
      // product u stays in flight; touching its accumulators here would
      // make the compiler wait for it
      wgmma_wait<1>();
    }
    // product u - 1 has retired (at a tile's end, u too): release its stage
    __syncwarp();
    mbar_arrive_lane0(wempty + (u + WSTAGES - 1) % WSTAGES, lane, r != 0);
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
  wgmma_wait<0>();  // (the last step retired everything; this tells the compiler)
}

template <int NWG, int BN>
size_t wgmma_smem(Geom g, int fold_bytes = 0) {
  set_tile(g, 64 * NWG);
  return 1024 + WLayout<NWG, BN>(g.NI * (g.TH + 2) * (g.TW + 2), g.NI, fold_bytes).bytes;
}

// FOLD: the table's bytes for each slot (fold_slot: a group of NI images'
// [a | off] and group statistics) at the tiling of NWG warpgroups.
int fold_slot_bytes(Geom g, int nwg, const FoldArgs& f) {
  set_tile(g, 64 * nwg);
  return g.NI * 2 * (g.Cin + f.G) * 4;
}

// FOLD: the most table slots a block of a grid gx wide takes (fold_slot),
// g tiled: ceil((mine - 1) gx / tiles an image) + 1 at most where the grid
// is narrower than an image's tiles, else one a tile.
long fold_slots(const Geom& g, long gx) {
  const long ntm = n_tiles(g), tpi = (long)g.tiles_y * g.tiles_x, mine = (ntm + gx - 1) / gx;
  if (gx >= tpi) return mine;
  const long s = ((mine - 1) * gx + tpi - 1) / tpi + 1;
  return s < mine ? s : mine;
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no -lcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

cudaError_t encode_bf16_map_uncached(CUtensorMap* map, const void* ptr, int rank,
                                     const cuuint64_t* dims, const cuuint32_t* box,
                                     CUtensorMapSwizzle swizzle) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault,
                                              &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return cudaErrorNotSupported;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  cuuint64_t strides[4];  // bytes, of dims 1 .. rank-1
  cuuint64_t stride = 2;
  for (int i = 0; i < rank - 1; ++i) strides[i] = stride *= dims[i];
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  auto run = [&]() {
    return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr), dims,
                  strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  };
  CUresult res = run();
  if (res == CUDA_ERROR_INVALID_CONTEXT) {
    // a host thread that has made no runtime call yet (PyTorch's autograd
    // thread, whose first call of this library can be a backward) has no
    // current context for cuTensorMapEncodeTiled: bind the primary context
    // of the device that holds the tensor, as the runtime would, and retry
    cudaPointerAttributes attr;
    cudaError_t err = cudaPointerGetAttributes(&attr, ptr);
    if (err == cudaSuccess) err = cudaSetDevice(attr.device);
    if (err != cudaSuccess) return err;
    res = run();
  }
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace

namespace pddm {

// The maps of recent (address, shape, box, swizzle) keys, reused: the
// caching allocator hands a forward's activations the same addresses call
// after call, and a model's weights keep theirs, so most calls encode nothing.
cudaError_t encode_bf16_map(CUtensorMap* map, const void* ptr, int rank, const cuuint64_t* dims,
                            const cuuint32_t* box, CUtensorMapSwizzle swizzle) {
  struct Entry {
    const void* ptr;
    int rank;
    CUtensorMapSwizzle swizzle;
    cuuint64_t dims[4];
    cuuint32_t box[4];
    CUtensorMap map;
  };
  constexpr int kEntries = 256;
  static Entry entries[kEntries];
  static int used = 0, next = 0;
  static std::mutex lock;
  std::lock_guard<std::mutex> guard(lock);
  for (int i = 0; i < used; ++i) {
    const Entry& e = entries[i];
    if (e.ptr != ptr || e.rank != rank || e.swizzle != swizzle) continue;
    bool same = true;
    for (int d = 0; d < rank; ++d) same = same && e.dims[d] == dims[d] && e.box[d] == box[d];
    if (same) {
      *map = e.map;
      return cudaSuccess;
    }
  }
  const cudaError_t err = encode_bf16_map_uncached(map, ptr, rank, dims, box, swizzle);
  if (err != cudaSuccess) return err;
  Entry& e = entries[next];
  e.ptr = ptr;
  e.rank = rank;
  e.swizzle = swizzle;
  for (int d = 0; d < rank; ++d) e.dims[d] = dims[d], e.box[d] = box[d];
  e.map = *map;
  next = (next + 1) % kEntries;
  if (used < kEntries) ++used;
  return cudaSuccess;
}

}  // namespace pddm

namespace {

// A persistent grid: as many blocks as fit on the card at once (for the N
// tiles of Cout along y), each walking over pixel tiles blockIdx.x,
// blockIdx.x + gridDim.x, ..., so a tile's halo copy and activation run
// under the previous tile's products.  Both operands come in by TMA: the
// weight as a (Cin, Cout, 9) map in 64 x BN boxes, x as a (Cin, W, H, B)
// map in 64 x (TW+2) x (TH+2) x NI boxes that start one pixel before the
// tile, so the halo's border past the image arrives zero-filled.
template <int NWG, int BN, bool FOLD>
cudaError_t launch_wgmma(const void* x, const void* a, const void* off, const void* w,
                         const void* bias, void* out, Geom g, const FoldArgs& f,
                         cudaStream_t stream) {
  size_t smem = wgmma_smem<NWG, BN>(g);
  const int per_slot = FOLD ? fold_slot_bytes(g, NWG, f) : 0;
  set_tile(g, 64 * NWG);
  CUtensorMap wmap, xmap;
  const cuuint64_t wdims[3] = {(cuuint64_t)g.Cin, (cuuint64_t)g.Cout, 9};
  const cuuint32_t wbox[3] = {WK, BN, 1};
  const cuuint64_t xdims[4] = {(cuuint64_t)g.Cin, (cuuint64_t)g.W, (cuuint64_t)g.H,
                               (cuuint64_t)g.B};
  const cuuint32_t xbox[4] = {WK, (cuuint32_t)g.TW + 2, (cuuint32_t)g.TH + 2, (cuuint32_t)g.NI};
  cudaError_t err = encode_bf16_map(&wmap, w, 3, wdims, wbox);
  if (err != cudaSuccess) return err;
  if ((err = encode_bf16_map(&xmap, x, 4, xdims, xbox)) != cudaSuccess) return err;
  if ((err = allow_smem(conv_wgmma_kernel<NWG, BN, FOLD>, smem)) != cudaSuccess) return err;
  // the card's SM count and the blocks of this size an SM holds, asked once
  int sms = 0;
  static int per_sm = 0;
  static size_t per_sm_smem = 0;
  if ((err = sm_count(&sms)) != cudaSuccess) return err;
  if (per_sm_smem != smem) {
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, conv_wgmma_kernel<NWG, BN, FOLD>, 128 * (NWG + 1), smem)) != cudaSuccess)
      return err;
    per_sm_smem = smem;
  }
  const long ntm = n_tiles(g), ntn = (g.Cout + BN - 1) / BN;
  long gx = (long)(per_sm > 0 ? per_sm : 1) * sms / ntn;
  gx = gx < 1 ? 1 : (gx > ntm ? ntm : gx);
  if constexpr (FOLD) {
    // The table adds to the block's shared memory, the more the fewer
    // blocks (fold_slots): the grid is sized at the occupancy of the whole,
    // the most blocks an SM holds with their tables (so no second wave),
    // and where one block's table does not fit, more blocks with fewer tiles.
    const size_t base = smem;
    constexpr size_t kMost = 227 * 1024;
    for (int want = per_sm > 1 ? per_sm : 1;; --want) {
      gx = (long)want * sms / ntn;
      gx = gx < 1 ? 1 : (gx > ntm ? ntm : gx);
      while (base + fold_slots(g, gx) * per_slot > kMost && gx < ntm)
        gx = gx + (gx + 7) / 8 < ntm ? gx + (gx + 7) / 8 : ntm;
      smem = base + (size_t)fold_slots(g, gx) * per_slot;
      if (smem > kMost) return cudaErrorInvalidValue;
      if ((err = allow_smem(conv_wgmma_kernel<NWG, BN, FOLD>, smem)) != cudaSuccess) return err;
      int fits = 0;
      if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
               &fits, conv_wgmma_kernel<NWG, BN, FOLD>, 128 * (NWG + 1), smem)) != cudaSuccess)
        return err;
      if (fits >= want || want == 1) break;
    }
  }
  const dim3 grid((unsigned)gx, (unsigned)ntn);
  conv_wgmma_kernel<NWG, BN, FOLD><<<grid, 128 * (NWG + 1), smem, stream>>>(
      static_cast<const float*>(a), static_cast<const float*>(off),
      static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(out), g, wmap, xmap, f);
  return cudaGetLastError();
}

// Two warpgroups and 128 channels a block where the tiles give most of a
// wave of the 132 SMs and fit in shared memory; narrower blocks for the
// small late sites (4x4, and Cout <= 64) and the wide rows, so their grids
// still fill the card.
template <bool FOLD>
cudaError_t launch_wgmma_any(const void* x, const void* a, const void* off, const void* w,
                             const void* bias, void* out, Geom g, const FoldArgs& f,
                             cudaStream_t stream) {
  constexpr long kFill = 128;
  constexpr size_t kSmem = 227 * 1024;
  // (FOLD: with the table of one tile a block, at least)
  const int fold1 = FOLD ? fold_slot_bytes(g, 1, f) : 0;
  const int fold2 = FOLD ? fold_slot_bytes(g, 2, f) : 0;
  Geom t = g;
  set_tile(t, 128);
  const long m128 = n_tiles(t);
  Geom t64 = g;
  set_tile(t64, 64);
  // Cout of 256 and more: one warpgroup of 64 pixels x 256 channels, so the
  // halo of a pixel tile is activated once for 256 channels, not twice
  if (g.Cout > 128 && n_tiles(t64) * ((g.Cout + 255) / 256) >= kFill &&
      wgmma_smem<1, 256>(g, fold1) <= kSmem)
    return launch_wgmma<1, 256, FOLD>(x, a, off, w, bias, out, g, f, stream);
  if (g.Cout > 64 && m128 * ((g.Cout + 127) / 128) >= kFill &&
      wgmma_smem<2, 128>(g, fold2) <= kSmem)
    return launch_wgmma<2, 128, FOLD>(x, a, off, w, bias, out, g, f, stream);
  if (m128 * ((g.Cout + 63) / 64) >= kFill && wgmma_smem<2, 64>(g, fold2) <= kSmem)
    return launch_wgmma<2, 64, FOLD>(x, a, off, w, bias, out, g, f, stream);
  if (wgmma_smem<1, 64>(g, fold1) <= kSmem)
    return launch_wgmma<1, 64, FOLD>(x, a, off, w, bias, out, g, f, stream);
  return cudaErrorInvalidValue;
}

// FOLD's table of images b0 .. b0 + rows - 1 in the narrow_f32 and general
// kernels, by all nth threads of the block (fold_table).  Outlined
// (noinline), as fold_fill is: inlined, the fold's registers changed how
// ptxas allocated the general kernel's main loop, which then spilled and
// ran slower than the kernel fed (a, off) on the H100.
__device__ __noinline__ void fold_images(FoldArgs f, Geom g, int b0, int rows, float* table,
                                         float* gs, int t, int nth) {
  fold_table(f, g.B, g.Cin, rows, [&](int r) { return b0 + r; }, table, gs, t, nth,
             []() { __syncthreads(); });
}

// ------------------------------------------------------------ narrow_f32

constexpr int NKC = 8;    // input channels per slice: two 16-byte chunks a pixel
constexpr int NNT = 256;  // threads per block: 4 pixels each

// FOLD (a slab): the tile's image's scale and offset for every channel are
// folded into shared memory first, from the ranks' summed moments
// (gn_fold.cuh), and read from there.
template <int CP, bool FOLD>  // Cout padded to 4 or 8
__global__ void __launch_bounds__(NNT)
conv_narrow_f32_kernel(const float* __restrict__ x, const float* __restrict__ a,
                       const float* __restrict__ off, const float* __restrict__ w,
                       const float* __restrict__ bias, float* __restrict__ out, Geom g,
                       FoldArgs f) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int halo_w = g.TW + 2, halo_px = (g.TH + 2) * halo_w;
  const int hs = halo_px | 1;                            // odd channel stride: no conflicts
  float* Raw = reinterpret_cast<float*>(smem_raw);      // 2 x [halo_px][NKC], pixel-major
  float* Xs = Raw + 2 * halo_px * NKC;                  // [NKC][hs], activated
  float* Wn = Xs + NKC * hs;                            // [Cin][9][CP]
  float* AOn = Wn + g.Cin * 9 * CP;                     // FOLD: [a | off][Cin]
  float* GSn = AOn + 2 * g.Cin;                         // FOLD: [group][mean, rstd]

  int b0, y0, x0;
  tile_origin(g, blockIdx.x, b0, y0, x0);
  const int tid = threadIdx.x;
  if constexpr (FOLD) fold_images(f, g, b0, 1, AOn, GSn, tid, NNT);  // one image a tile
  const int per_row = g.TW / 4, tr = tid / per_row, tc = tid % per_row;
  const bool active = tr < g.TH;
  const int nslices = (g.Cin + NKC - 1) / NKC;

  auto load_raw = [&](int s) {
    float* dst = Raw + (s & 1) * halo_px * NKC;
    for (int idx = tid; idx < halo_px * (NKC / 4); idx += NNT) {
      const int pos = idx / (NKC / 4), c4 = 4 * (idx % (NKC / 4)), ci = s * NKC + c4;
      long px;
      int bb;
      const bool ok = halo_pixel(g, b0, y0, x0, pos, px, bb) && ci < g.Cin;
      cp_async16(dst + pos * NKC + c4, x + (ok ? px + ci : 0), ok);
    }
    cp_async_commit();
  };

  load_raw(0);
  for (int idx = tid; idx < 9 * CP * g.Cin; idx += NNT) {
    const int ci = idx % g.Cin, co = (idx / g.Cin) % CP, tap = idx / (g.Cin * CP);
    Wn[(ci * 9 + tap) * CP + co] = co < g.Cout ? w[((long)tap * g.Cout + co) * g.Cin + ci] : 0.f;
  }
  float acc[4][CP];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int co = 0; co < CP; ++co) acc[p][co] = 0.f;

  for (int s = 0; s < nslices; ++s) {
    if (s + 1 < nslices) {
      load_raw(s + 1);  // its buffer's last reader, slice s-1's activation, is behind a barrier
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // slice s landed for every thread; slice s-1's products are done
    const float* src = Raw + (s & 1) * halo_px * NKC;
    for (int idx = tid; idx < halo_px * (NKC / 4); idx += NNT) {
      const int pos = idx / (NKC / 4), c4 = 4 * (idx % (NKC / 4)), ci = s * NKC + c4;
      long px;
      int bb;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (halo_pixel(g, b0, y0, x0, pos, px, bb) && ci < g.Cin) {
        const float4 r = *reinterpret_cast<const float4*>(src + pos * NKC + c4);
        float4 av, ov;
        if constexpr (FOLD) {  // (bb is b0: one image a tile)
          av = *reinterpret_cast<const float4*>(AOn + ci);
          ov = *reinterpret_cast<const float4*>(AOn + g.Cin + ci);
        } else {
          av = __ldg(reinterpret_cast<const float4*>(a + (long)bb * g.Cin + ci));
          ov = __ldg(reinterpret_cast<const float4*>(off + (long)bb * g.Cin + ci));
        }
        v = make_float4(silu_f(fmaf(r.x, av.x, ov.x)), silu_f(fmaf(r.y, av.y, ov.y)),
                        silu_f(fmaf(r.z, av.z, ov.z)), silu_f(fmaf(r.w, av.w, ov.w)));
      }
      Xs[c4 * hs + pos] = v.x;
      Xs[(c4 + 1) * hs + pos] = v.y;
      Xs[(c4 + 2) * hs + pos] = v.z;
      Xs[(c4 + 3) * hs + pos] = v.w;
    }
    __syncthreads();
    if (active) {
      const int nc = g.Cin - s * NKC < NKC ? g.Cin - s * NKC : NKC;
      for (int cc = 0; cc < nc; ++cc) {
        const float* wc = Wn + (s * NKC + cc) * 9 * CP;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          const float* xr = Xs + cc * hs + (tr + dy) * halo_w + 4 * tc;
          float xv[6];
#pragma unroll
          for (int j = 0; j < 6; ++j) xv[j] = xr[j];
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            float wv[CP];
#pragma unroll
            for (int q = 0; q < CP / 4; ++q) {
              const float4 f = *reinterpret_cast<const float4*>(wc + (dy * 3 + dx) * CP + 4 * q);
              wv[4 * q] = f.x;
              wv[4 * q + 1] = f.y;
              wv[4 * q + 2] = f.z;
              wv[4 * q + 3] = f.w;
            }
#pragma unroll
            for (int p = 0; p < 4; ++p)
#pragma unroll
              for (int co = 0; co < CP; ++co) acc[p][co] = fmaf(xv[p + dx], wv[co], acc[p][co]);
          }
        }
      }
    }
  }
  if (!active) return;
  const int b = b0, y = y0 + tr;
  if (b >= g.B || y >= g.H) return;
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int xx = x0 + 4 * tc + p;
    if (xx >= g.W) continue;
    float* dst = out + (((long)b * g.H + y) * g.W + xx) * g.Cout;
#pragma unroll
    for (int co = 0; co < CP; ++co)
      if (co < g.Cout) dst[co] = acc[p][co] + bias[co];
  }
}

template <int CP, bool FOLD>
cudaError_t launch_narrow(const void* x, const void* a, const void* off, const void* w,
                          const void* bias, void* out, Geom g, const FoldArgs& f,
                          cudaStream_t stream) {
  // one image per tile: TW columns (a multiple of 4, at most 128) by as many
  // rows as 256 threads of 4 pixels cover
  g.NI = 1;
  g.TW = g.W <= 128 ? (g.W + 3) / 4 * 4 : 128;
  g.TH = NNT / (g.TW / 4);
  g.tiles_y = (g.H + g.TH - 1) / g.TH;
  g.tiles_x = (g.W + g.TW - 1) / g.TW;
  const size_t halo_px = (size_t)(g.TH + 2) * (g.TW + 2);
  const size_t smem =
      sizeof(float) * (2 * halo_px * NKC + NKC * (halo_px | 1) + (size_t)g.Cin * 9 * CP +
                       (FOLD ? 2 * (size_t)(g.Cin + f.G) : 0));
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(conv_narrow_f32_kernel<CP, FOLD>, smem);
  if (err != cudaSuccess) return err;
  conv_narrow_f32_kernel<CP, FOLD><<<(unsigned)n_tiles(g), NNT, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(a),
      static_cast<const float*>(off), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<float*>(out), g, f);
  return cudaGetLastError();
}

// --------------------------------------------------------------- general

constexpr int BM = 64;   // output pixels per block
constexpr int BN = 64;   // output channels per block
constexpr int KC = 32;   // input channels per staged slice
constexpr int NT = 128;  // threads per block

template <typename T> struct Ld;  // row stride of a staged pixel / weight row
template <> struct Ld<__nv_bfloat16> { static constexpr int v = KC + 8; };  // 80 B: conflict-free pairs
template <> struct Ld<float> { static constexpr int v = KC + 1; };

// Stage the activated halo tile of channels [ci0, ci0 + KC): zero outside
// the batch, the image and Cin.  FOLD: the scale and offset of image b0 + i
// and channel c are AOs[2 i Cin + c], AOs[(2 i + 1) Cin + c].
template <typename T, bool FOLD>
__device__ __forceinline__ void stage_halo(const T* __restrict__ x, const float* __restrict__ a,
                                           const float* __restrict__ off, const float* AOs,
                                           T* Xs, const Geom& g, int b0, int y0, int x0, int ci0,
                                           int halo_px) {
  constexpr int LD = Ld<T>::v;
  for (int idx = threadIdx.x; idx < halo_px * KC; idx += NT) {
    const int cc = idx % KC, pos = idx / KC, ci = ci0 + cc;
    long px;
    int bb;
    float v = 0.f;
    if (halo_pixel(g, b0, y0, x0, pos, px, bb) && ci < g.Cin) {
      if constexpr (FOLD)
        v = silu_f(to_f(x[px + ci]) * AOs[2 * (bb - b0) * g.Cin + ci] +
                   AOs[(2 * (bb - b0) + 1) * g.Cin + ci]);
      else
        v = silu_f(to_f(x[px + ci]) * a[(long)bb * g.Cin + ci] + off[(long)bb * g.Cin + ci]);
    }
    Xs[pos * LD + cc] = from_f<T>(v);
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

// FOLD (a slab): the scale and offset of every channel of the tile's images
// are folded into a table in shared memory first, from the ranks' summed
// moments (gn_fold.cuh), and staging reads them there.
template <typename T, bool FOLD>
__global__ void __launch_bounds__(NT)
conv_kernel(const T* __restrict__ x, const float* __restrict__ a,
            const float* __restrict__ off, const T* __restrict__ w,
            const float* __restrict__ bias, T* __restrict__ out, Geom g, FoldArgs f) {
  constexpr int LD = Ld<T>::v;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int halo_w = g.TW + 2, halo_h = g.TH + 2;
  const int halo_px = g.NI * halo_h * halo_w;
  T* Xs = reinterpret_cast<T*>(smem_raw);  // halo_px x LD
  T* Ws = Xs + halo_px * LD;               // 9 x BN x LD
  float* AOs = reinterpret_cast<float*>(Ws + 9 * BN * LD);  // FOLD: [image][a | off][Cin]
  float* GSg = AOs + g.NI * 2 * g.Cin;                      // FOLD: [image][group][mean, rstd]

  int b0, y0, x0;
  tile_origin(g, blockIdx.x, b0, y0, x0);
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  if constexpr (FOLD)
    fold_images(f, g, b0, g.B - b0 < g.NI ? g.B - b0 : g.NI, AOs, GSg, tid, NT);

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
    stage_halo<T, FOLD>(x, a, off, AOs, Xs, g, b0, y0, x0, ci0, halo_px);
    stage_weight(w, Ws, g, n0, ci0);
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

template <typename T, bool FOLD>
cudaError_t launch_general(const void* x, const void* a, const void* off, const void* w,
                           const void* bias, void* out, Geom g, const FoldArgs& f,
                           cudaStream_t stream) {
  set_tile(g, BM);
  const long halo_px = (long)g.NI * (g.TH + 2) * (g.TW + 2);
  const size_t smem = sizeof(T) * (size_t)(halo_px + 9 * BN) * Ld<T>::v +
                      (FOLD ? sizeof(float) * (size_t)g.NI * 2 * (g.Cin + f.G) : 0);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(conv_kernel<T, FOLD>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)n_tiles(g), (g.Cout + BN - 1) / BN);
  conv_kernel<T, FOLD><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(a), static_cast<const float*>(off),
      static_cast<const T*>(w), static_cast<const float*>(bias), static_cast<T*>(out), g, f);
  return cudaGetLastError();
}

}  // namespace

namespace {

template <bool FOLD>
int conv_any(const void* x, const void* a, const void* off, const void* w, const void* bias,
             void* out, Geom g, int is_bf16, int design, const FoldArgs& f,
             cudaStream_t stream) {
  switch (design) {
    case 0:
      if (is_bf16)
        return launch_general<__nv_bfloat16, FOLD>(x, a, off, w, bias, out, g, f, stream);
      return launch_general<float, FOLD>(x, a, off, w, bias, out, g, f, stream);
    case 1:
      if (!is_bf16 || g.Cin % 8 || g.Cout % 8 || reinterpret_cast<uintptr_t>(x) % 16 ||
          reinterpret_cast<uintptr_t>(w) % 16)
        return cudaErrorInvalidValue;
      return launch_wgmma_any<FOLD>(x, a, off, w, bias, out, g, f, stream);
    case 2:
      if (is_bf16 || g.Cout > 8 || g.Cin % 4 || reinterpret_cast<uintptr_t>(x) % 16)
        return cudaErrorInvalidValue;
      if (g.Cout <= 4) return launch_narrow<4, FOLD>(x, a, off, w, bias, out, g, f, stream);
      return launch_narrow<8, FOLD>(x, a, off, w, bias, out, g, f, stream);
    case 3:
      if (is_bf16) return cudaErrorInvalidValue;
      return tiled::launch<FOLD ? tiled::kForwardFold : tiled::kForward>(
          static_cast<const float*>(x), static_cast<const float*>(w),
          static_cast<const float*>(a), static_cast<const float*>(off),
          static_cast<const float*>(bias), nullptr, static_cast<float*>(out), nullptr, g.B, g.H,
          g.W, g.Cin, g.Cout, f, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// design: 0 general, 1 wgmma (bf16), 2 narrow_f32 (float32, Cout <= 8), 3
// tiled_f32 (float32, Cin and Cout multiples of 4); the
// caller (ops/gn_conv.py::conv_design) checks what each one takes, and a
// design that does not take the call returns cudaErrorInvalidValue.
extern "C" int pddm_gn_silu_conv3x3(const void* x, const void* a, const void* off,
                                    const void* w, const void* bias, void* out, int B,
                                    int H, int W, int Cin, int Cout, int is_bf16,
                                    int design, void* stream_ptr) {
  const Geom g{B, H, W, Cin, Cout, 0, 0, 0, 0, 0};
  return conv_any<false>(x, a, off, w, bias, out, g, is_bf16, design, FoldArgs{},
                         static_cast<cudaStream_t>(stream_ptr));
}

// The folding conv of a spatially sharded forward's slab: the same designs,
// with (a, off) folded inside the kernel from mom (2, B, Cin) float32, the
// ranks' summed per-slab E[x], E[x^2] (mom_len elements from mom on, at
// least 2 B Cin), `ranks` of them, gamma and beta (Cin) float32, G groups,
// and the conditioning as pddm_gn_fold takes it (cond_len0 / cond_len1: the
// elements from cond0 / cond1 on, which must hold B rows of `stride`).
extern "C" int pddm_gn_silu_conv3x3_fold(const void* x, const void* mom, const void* gamma,
                                         const void* beta, const void* cond0, const void* cond1,
                                         const void* w, const void* bias, void* out,
                                         long long mom_len, long long cond_len0,
                                         long long cond_len1, int B, int H, int W, int Cin,
                                         int Cout, int G, int ranks, float eps, int mode,
                                         int stride0, int stride1, int cond_is_bf16,
                                         int is_bf16, int design, void* stream_ptr) {
  auto rows_fit = [&](const void* p, long long len, int stride) {
    return p != nullptr && stride >= Cin && len >= (long long)(B - 1) * stride + Cin;
  };
  if (mom == nullptr || gamma == nullptr || beta == nullptr || B < 1 || Cin < 1 || G < 1 ||
      Cin % G != 0 || ranks < 1 || mom_len < 2LL * B * Cin || mode < 0 || mode > 2 ||
      (mode >= 1 && !rows_fit(cond0, cond_len0, stride0)) ||
      (mode == 2 && !rows_fit(cond1, cond_len1, stride1)))
    return cudaErrorInvalidValue;
  const Geom g{B, H, W, Cin, Cout, 0, 0, 0, 0, 0};
  const FoldArgs f{static_cast<const float*>(mom), static_cast<const float*>(gamma),
                   static_cast<const float*>(beta),
                   Cond{cond0, cond1, stride0, stride1, mode, cond_is_bf16}, G, ranks, eps};
  return conv_any<true>(x, nullptr, nullptr, w, bias, out, g, is_bf16, design, f,
                        static_cast<cudaStream_t>(stream_ptr));
}
