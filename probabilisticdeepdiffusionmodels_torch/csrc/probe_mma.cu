// One 256x256 @ 256x256 product with float32 accumulation, on bf16 or float32
// operands, row major: out[m][n] = sum_k a[m][k] * b[k][n].
//
// Replaces scripts/probe_mosaic_bf16.py, _kernel via try_dtype: a toolchain
// probe that asks whether bf16 matmul operands reach the TPU's matrix unit.
// Here it asks the same of the card's own matrix instruction, the one the
// fused conv runs on: bf16 goes through wgmma.mma_async (m64n64k16, float32
// accumulation) with both operands read from shared memory, where TMA put
// them under the 128-byte swizzle.  float32 stays true float32 (no TF32:
// the TPU kernel's float32 mode adds float32 products).
//
// Bound on the H100: bf16 by bytes (two 128 KB inputs and a 256 KB output,
// about 0.16 us at 3.35 TB/s), float32 by operations (33.6 MFLOP, about
// 0.5 us at 67 TFLOP/s).  Both lie under the shortest kernel the card can
// run, so the design aims at a short chain of latencies, not at a rate:
//
// bf16: a block of one warpgroup per 64 x 64 output tile (16 blocks).  One
//   thread issues all eight TMA copies at once: for each 64-wide K slice the
//   A tile (64 rows of 128 bytes, K-major) and the B tile (64 k-rows of 128
//   bytes: b is row major (K, N), so its tile is N-major and the instruction
//   transposes it, tnspB = 1), each slice on its own mbarrier.  The
//   warpgroup starts the first slice's four products as soon as that slice
//   lands, while the other three are still in flight, and stores the
//   accumulators straight from registers.
// float32: a block of 64 threads per 32 x 32 output tile (64 blocks), K in
//   slices of 32 staged through shared memory with 16-byte loads, each
//   thread a 4 x 4 register block of scalar FMAs.
#include "common.cuh"
#include "hopper.cuh"

using namespace pddm;

namespace {

constexpr int N = 256;
constexpr int BT = 64;                  // bf16: the output tile and the K slice
constexpr int KSLICES = N / BT;         // 4
constexpr int TILE_BYTES = BT * 128;    // 64 rows of 64 bf16
constexpr size_t BF16_SMEM = 1024 + 2 * KSLICES * TILE_BYTES;

// Descriptor of an N-major (transposed) B tile under the 128-byte swizzle:
// rows of 128 bytes are 64 neighbouring n of one k; the 8-row groups along k
// lie 1024 bytes apart (SBO); the next 64 n would lie a whole tile further
// (LBO; not reached at n = 64).  A k-step of 16 rows advances the start
// address by 2048 bytes (+128 in the descriptor's 16-byte units).
__device__ __forceinline__ uint64_t smem_desc_sw128_mn(const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(TILE_BYTES >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// d (64 x 64 float32) += A (64 x 16, K-major) * B (16 x 64, N-major), both
// from shared memory.
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t desc_a,
                                                   uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

__global__ void __launch_bounds__(128)
probe_bf16(float* __restrict__ out, const __grid_constant__ CUtensorMap amap,
           const __grid_constant__ CUtensorMap bmap) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[KSLICES];
  unsigned char* As = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* Bs = As + KSLICES * TILE_BYTES;
  const int m0 = blockIdx.y * BT, n0 = blockIdx.x * BT;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < KSLICES; ++s) mbar_init(full + s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    for (int s = 0; s < KSLICES; ++s) {
      mbar_expect_tx(full + s, 2 * TILE_BYTES);
      tma_load_2d(As + s * TILE_BYTES, &amap, full + s, s * BT, m0);  // (k, m)
      tma_load_2d(Bs + s * TILE_BYTES, &bmap, full + s, n0, s * BT);  // (n, k)
    }
  }

  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
#pragma unroll
  for (int s = 0; s < KSLICES; ++s) {
    mbar_wait(full + s, 0);
    const uint64_t da = smem_desc_sw128(As + s * TILE_BYTES);
    const uint64_t db = smem_desc_sw128_mn(Bs + s * TILE_BYTES);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk) wgmma_m64n64k16_ss(acc, da + 2 * kk, db + 128 * kk);
    wgmma_commit();
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < 32; ++i) fence_reg(acc[i]);

  // accumulator layout: warp w holds rows 16 w .. 16 w + 15; lane (g, t)
  // holds rows g and g + 8, columns 8 j + 2 t and + 1 of every 8-wide j
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < BT / 8; ++j) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float* o = out + (m0 + 16 * warp + g + 8 * half) * N + n0 + 8 * j + 2 * t;
      *reinterpret_cast<float2*>(o) = make_float2(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
    }
  }
}

constexpr int FT = 32;  // float32: the output tile and the K slice

__global__ void __launch_bounds__(64)
probe_f32(const float* __restrict__ a, const float* __restrict__ b, float* __restrict__ out) {
  __shared__ float As[FT][FT + 1];               // [m][k], padded: a column read hits 32 banks
  __shared__ __align__(16) float Bs[FT][FT];     // [k][n]
  const int tid = threadIdx.x, ty = tid >> 3, tx = tid & 7;
  const int m0 = blockIdx.y * FT, n0 = blockIdx.x * FT;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < N; k0 += FT) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = tid + 64 * i, r = idx >> 3, c = 4 * (idx & 7);
      const float4 av = *reinterpret_cast<const float4*>(a + (m0 + r) * N + k0 + c);
      As[r][c] = av.x;
      As[r][c + 1] = av.y;
      As[r][c + 2] = av.z;
      As[r][c + 3] = av.w;
      *reinterpret_cast<float4*>(&Bs[r][c]) =
          *reinterpret_cast<const float4*>(b + (k0 + r) * N + n0 + c);
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < FT; ++k) {
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[k][4 * tx]);
      const float bw[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float av = As[4 * ty + i][k];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av, bw[j], acc[i][j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    *reinterpret_cast<float4*>(out + (m0 + 4 * ty + i) * N + n0 + 4 * tx) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
}

}  // namespace

extern "C" int pddm_probe_mma(const void* a, const void* b, void* out, int is_bf16,
                              void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (!is_bf16) {
    probe_f32<<<dim3(N / FT, N / FT), 64, 0, stream>>>(
        static_cast<const float*>(a), static_cast<const float*>(b), static_cast<float*>(out));
    return cudaGetLastError();
  }
  // a as (K, M) and b as (N, K), innermost first, both in 64 x 64 boxes
  CUtensorMap amap, bmap;
  const cuuint64_t dims[2] = {N, N};
  const cuuint32_t box[2] = {BT, BT};
  cudaError_t err = encode_bf16_map(&amap, a, 2, dims, box);
  if (err != cudaSuccess) return err;
  if ((err = encode_bf16_map(&bmap, b, 2, dims, box)) != cudaSuccess) return err;
  if ((err = allow_smem(probe_bf16, BF16_SMEM)) != cudaSuccess) return err;
  probe_bf16<<<dim3(N / BT, N / BT), 128, BF16_SMEM, stream>>>(static_cast<float*>(out), amap,
                                                               bmap);
  return cudaGetLastError();
}
