// Int8 matrix product on the tensor cores with the int8 head's dequantize in
// its epilogue, written for Hopper (sm_90a).
//
// Replaces: radnet_tpu/models/quant.py:59 int8_conv and :78 int8_dense, which
// the JAX package leaves to XLA (no Pallas kernel): the int8 RoI head's
// stage-5 convs (ResNet50: 1x1 and 3x3 SAME on 7 x 7 maps) and fc1 / fc2
// (VGG16).
//
//   out[m, n] = float(acc[m, n]) * (sx[m / rows_per_sample] * sw[n]) + bias[n]
//   acc[m, n] = sum_k A[m, k] * B[n, k]           (int8 x int8 -> int32)
//
// in float32, in that order, as JAX computes acc.astype(f32) * (sx * sw) and
// then adds the bias.  The file is built with --fmad=false and spells every
// rounding out (__int2float_rn, __fmul_rn, __fadd_rn), so the output is
// bit-equal to the plain version (radnet_torch/ops/quant.py::int8_gemm_plain).
// B holds the weights K-major: (N, K), one output channel a row.  A is read in
// one of two modes:
//   * dense rows: A (M, K) row-major, for the 1x1 convs over NHWC positions
//     (M = RoIs * 49, K = C) and the dense layers (M = RoIs);
//   * implicit 3x3 SAME im2col: A is an (R, H, W, C) map and row m = (r, y, x)
//     reads, at k = (ky * 3 + kx) * C + c, the value at (y + ky - 1, x + kx -
//     1, c), zero outside the map: K in (ky, kx, c) order, as HWIO flattens.
//     No im2col is written (at the ResNet50 head's width it would be 813 MB).
// With out_int32 the kernel writes acc itself as int32 (for checks).
//
// Bound on this card: at the ResNet50 head's 1x1 convs (M = 176 400, K = 512
// to 2048, N = 512 or 2048) the float32 output is as many bytes as the
// operations are time at the int8 peak: 2 * M * N * K operations at 1979
// TOPS against the M * N * 4 bytes written at 3.35 TB/s; VGG16's fc1 (M =
// 3600, K = 25 088, N = 4096) is bound by its operations.
//
// Design: a simple tiled kernel.  A block of 8 warps computes a 128 x 128
// output tile; K runs in steps of 64 bytes through a 4-stage ring in shared
// memory filled by 16-byte cp.async (zero-filled where a row is past M or a
// tap falls off the map), with 16-byte chunks XOR-swizzled so that ldmatrix
// reads them without bank conflicts.  Each warp owns 64 x 32 of the tile:
// per 32 of K, four ldmatrix.x4 for A, two for B and 16
// mma.sync.m16n8k32.s8.s8.s32.  The epilogue writes each pair of columns as
// one 8-byte store.  wgmma and TMA are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128, BN = 128, BK = 64, STAGES = 4, THREADS = 256;
constexpr int A_TILE = BM * BK;  // bytes
constexpr int B_TILE = BN * BK;
constexpr int SMEM_BYTES = STAGES * (A_TILE + B_TILE);

struct Args {
  const int8_t* a;
  const float* sx;
  const int8_t* b;
  const float* sw;
  const float* bias;  // may be null
  void* out;
  int M, N, K;
  int rows_per_sample;
  int conv_h, conv_w, conv_c;  // conv_h > 0: implicit 3x3 SAME im2col over (R, H, W, C)
  int out_int32;
};

// Byte offset of 16-byte chunk `chunk` (0..3) of tile row `row`.
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * BK + ((chunk ^ ((row >> 1) & 3)) << 4);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros, read nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                            uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Where one thread's A chunk comes from: a dense row, or the (sample, y, x)
// of an im2col row.
struct ARow {
  const int8_t* base;  // dense: the row; conv: the sample's map
  int y, x;
  bool valid;
};

__global__ void __launch_bounds__(THREADS, 2) int8_gemm_kernel(const Args args) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warp_m = warp >> 2, warp_n = warp & 3;  // 2 x 4 warps: 64 x 32 each
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int K = args.K;
  const bool conv = args.conv_h > 0;
  const int H = args.conv_h, W = args.conv_w, C = args.conv_c;

  // Each thread copies two 16-byte chunks of A and two of B a stage.
  ARow arow[2];
  const int8_t* brow[2];
  bool bvalid[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int idx = tid + i * THREADS, row = idx >> 2;
    const int m = m0 + row;
    arow[i].valid = m < args.M;
    const int mm = arow[i].valid ? m : 0;
    if (conv) {
      const int hw = H * W, r = mm / hw, p = mm - r * hw;
      arow[i].y = p / W;
      arow[i].x = p - arow[i].y * W;
      arow[i].base = args.a + (long long)r * hw * C;
    } else {
      arow[i].y = arow[i].x = 0;
      arow[i].base = args.a + (long long)mm * K;
    }
    const int n = n0 + row;
    bvalid[i] = n < args.N;
    brow[i] = args.b + (long long)(bvalid[i] ? n : 0) * K;
  }

  const uint32_t smem_base = (uint32_t)__cvta_generic_to_shared(smem);
  auto load_stage = [&](int stage, int kt) {
    const uint32_t sa = smem_base + stage * (A_TILE + B_TILE);
    const uint32_t sb = sa + A_TILE;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + i * THREADS, row = idx >> 2, chunk = idx & 3;
      const int k = kt * BK + chunk * 16;
      const int8_t* src = args.a;
      bool ok = arow[i].valid;
      if (conv) {
        const int tap = k / C, c = k - tap * C, ky = tap / 3, kx = tap - ky * 3;
        const int yy = arow[i].y + ky - 1, xx = arow[i].x + kx - 1;
        ok = ok && yy >= 0 && yy < H && xx >= 0 && xx < W;
        if (ok) src = arow[i].base + ((long long)yy * W + xx) * C + c;
      } else if (ok) {
        src = arow[i].base + k;
      }
      cp_async16(sa + swz(row, chunk), src, ok);
      cp_async16(sb + swz(row, chunk), bvalid[i] ? (const void*)(brow[i] + k) : (const void*)args.b,
                 bvalid[i]);
    }
  };

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int KT = K / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load_stage(s, s);
    asm volatile("cp.async.commit_group;\n" ::);
  }

  const int lrow = lane & 7, lmat = lane >> 3;
  for (int kt = 0; kt < KT; ++kt) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2));
    __syncthreads();  // stage kt has landed; every warp is done with stage kt - 1
    const int nk = kt + STAGES - 1;
    if (nk < KT) load_stage(nk % STAGES, nk);
    asm volatile("cp.async.commit_group;\n" ::);

    const uint32_t sa = smem_base + (kt % STAGES) * (A_TILE + B_TILE);
    const uint32_t sb = sa + A_TILE;
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {  // matrices: rows 0-7 / 8-15 x bytes 0-15 / 16-31
        const int row = warp_m * 64 + i * 16 + lrow + (lmat & 1) * 8;
        ldmatrix_x4(sa + swz(row, ks * 2 + (lmat >> 1)), af[i][0], af[i][1], af[i][2], af[i][3]);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {  // two n8 tiles, each k bytes 0-15 then 16-31
        const int row = warp_n * 32 + j * 16 + lrow + (lmat >> 1) * 8;
        ldmatrix_x4(sb + swz(row, ks * 2 + (lmat & 1)), bf[2 * j][0], bf[2 * j][1],
                    bf[2 * j + 1][0], bf[2 * j + 1][1]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], af[i], bf[j]);
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::);

  // Epilogue: thread holds rows g and g + 8, columns 2t and 2t + 1 of each
  // 16 x 8 tile.
  const int g = lane >> 2, t = lane & 3;
  float swv[4][2], biasv[4][2];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = n0 + warp_n * 32 + j * 8 + 2 * t + e;
      const bool ok = n < args.N;
      swv[j][e] = ok && !args.out_int32 ? args.sw[n] : 0.0f;
      biasv[j][e] = ok && args.bias != nullptr ? args.bias[n] : 0.0f;
    }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + warp_m * 64 + i * 16 + g + h * 8;
      if (m >= args.M) continue;
      const float sxv = args.out_int32 ? 0.0f : args.sx[m / args.rows_per_sample];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + warp_n * 32 + j * 8 + 2 * t;
        if (n >= args.N) continue;  // N is even, so n + 1 < N too
        const long long off = (long long)m * args.N + n;
        const int a0 = acc[i][j][2 * h], a1 = acc[i][j][2 * h + 1];
        if (args.out_int32) {
          *reinterpret_cast<int2*>(static_cast<int*>(args.out) + off) = make_int2(a0, a1);
        } else {
          float v0 = __fmul_rn(__int2float_rn(a0), __fmul_rn(sxv, swv[j][0]));
          float v1 = __fmul_rn(__int2float_rn(a1), __fmul_rn(sxv, swv[j][1]));
          if (args.bias != nullptr) {
            v0 = __fadd_rn(v0, biasv[j][0]);
            v1 = __fadd_rn(v1, biasv[j][1]);
          }
          *reinterpret_cast<float2*>(static_cast<float*>(args.out) + off) = make_float2(v0, v1);
        }
      }
    }
}

}  // namespace

// A (M, K) int8 rows, or with conv_h > 0 an (M / (conv_h * conv_w), conv_h,
// conv_w, conv_c) int8 map read as its 3x3 SAME im2col (K = 9 * conv_c); sx
// one float32 scale for each rows_per_sample rows of A; B (N, K) int8; sw (N,)
// and bias (N,) float32, bias may be null; out (M, N) float32, or int32 with
// out_int32 (sx and sw are then not read).  K % 64 == 0, N % 2 == 0, pointers
// 16-byte aligned, and in conv mode conv_c % 16 == 0 (the wrapper checks).
extern "C" int radnet_int8_gemm(const void* a, const void* sx, const void* b, const void* sw,
                                const void* bias, void* out, int M, int N, int K,
                                int rows_per_sample, int conv_h, int conv_w, int conv_c,
                                int out_int32, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % BK != 0 || N % 2 != 0 || rows_per_sample <= 0)
    return (int)cudaErrorInvalidValue;
  if (conv_h > 0 && (conv_w <= 0 || conv_c % 16 != 0 || K != 9 * conv_c ||
                     M % (conv_h * conv_w) != 0))
    return (int)cudaErrorInvalidValue;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        int8_gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const long long m_tiles = ((long long)M + BM - 1) / BM;
  if (m_tiles > 65535) return (int)cudaErrorInvalidValue;
  Args args{(const int8_t*)a, (const float*)sx,   (const int8_t*)b, (const float*)sw,
            (const float*)bias, out, M, N, K, rows_per_sample, conv_h, conv_w, conv_c,
            out_int32};
  // Column tiles fastest: the blocks in flight share their A rows through L2.
  const dim3 grid((N + BN - 1) / BN, (unsigned)m_tiles);
  int8_gemm_kernel<<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(args);
  return (int)cudaGetLastError();
}

extern "C" const char* radnet_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
