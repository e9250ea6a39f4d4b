// Int8 matrix product on Hopper's warpgroup tensor cores (wgmma), fed by TMA
// through a ring of shared-memory stages, with the int8 head's dequantize,
// bias, frozen batch norm, residual sum and ReLU in its epilogue (sm_90a).
//
// Replaces: radnet_tpu/models/quant.py:59 int8_conv and :78 int8_dense (the
// bias of QuantConv / QuantDense, :120-121 and :142), which the JAX package
// leaves to XLA (no Pallas kernel), together with what XLA fuses after them
// on the TPU: stage 5's FrozenBatchNorm (radnet_tpu/models/layers.py:26-43),
// the residual sum and the ReLUs of Bottleneck (radnet_tpu/models/resnet.py:
// 99-117), and VGG16's ReLU after fc1 / fc2.  For each output element:
//
//   acc    = sum_k A[m, k] * B[n, k]                       (int8 x int8 -> int32)
//   v      = float(acc) * (sx[m / rows_per_sample] * sw[n]) + bias[n]   (float32)
//   float: out = v, or max(v, 0) with relu
//   bn:    t = dt(v); t = dt(t * k[n]); t = dt(t + b[n]);
//          [t = dt(t + res[m, n])]; [t = max(t, 0)];  out = t, dt in {bf16, f32}
//   int32: out = acc (for checks)
//
// Each dt(.) rounds where the port's eager PyTorch ops round (a bf16 op
// computes in float32 and rounds once; the bf16x2 instructions give the same
// bits, see bn_bf16), and the file is built with --fmad=false with every
// float32 rounding spelled out, so the output is bit-equal to the plain
// composition (radnet_torch/ops/quant.py::int8_gemm_plain).
//
// B holds the weights K-major, (N, K).  A is read in one of two modes:
//   * dense rows: A (M, K) row-major (the 1x1 convs over NHWC positions, M =
//     RoIs * 49; the dense layers, M = RoIs), loaded by TMA;
//   * implicit 3x3 SAME im2col: A is an (R, H, W, C) map, row m = (r, y, x)
//     reads at k = (ky * 3 + kx) * C + c the value at (y + ky - 1, x + kx - 1,
//     c), zero outside the map (HWIO's K order).  A 128-row tile spans parts
//     of three 49-row samples, which no TMA box can fetch, so the producer
//     warps gather the taps with zero-filling 16-byte cp.async into the same
//     128-byte swizzle TMA writes.  No im2col is written (813 MB at the
//     ResNet50 head's width).
//
// Bound on this card (M = 176 400 rows a 12-tile batch; int8 at 1979 TOPS,
// bytes at 3.35 TB/s, each input read once and the output written once):
// s5a.conv2a 0.108 ms (bytes), conv_sc 0.374 (operations), each 3x3 conv2b
// 0.420 (operations), each conv2c 0.458 (bytes: it reads and writes the bf16
// residual), s5b / s5c conv2a 0.187 (operations): stage 5 of ResNet50 about
// 3.49 ms a batch.  VGG16's fc1 and fc2 (M = 3600): 0.435 ms, operations.
//
// Design: a block computes 128 x 256 output tiles with three warpgroups, and
// stays on its SM for the tiles b, b + #SMs, ... (column tiles fastest, so
// the blocks in flight share their A rows through L2).  Warpgroup 2
// produces: one thread keeps the TMA loads of B (and of A in dense mode) in
// flight, 128 bytes of K a stage, into a ring of 4 stages guarded by a full
// and an empty mbarrier each; in conv mode its 128 threads also gather A,
// each waiting for its copies two stages behind, then fencing them into the
// async proxy and arriving on the stage's full barrier.  The ring runs on
// from one tile to the next, so the next tile's stages fill while the
// epilogue runs.  Warpgroups 0 and 1 consume: each runs four
// wgmma.m64n256k32 a stage on its 64 rows from the 128-byte swizzled tiles,
// keeps one stage of wgmma in flight and releases the stage before it.
// setmaxnreg moves registers from the producer to the consumers' int32
// accumulators.  The epilogue works in wgmma's accumulator layout (rows 16 *
// warp + g and + 8, columns 8j + 2t and + 1), loads each group of columns'
// scales, batch norm and residual before its stores (the residual tile was
// prefetched into L2 at the tile's start), computes the bf16 batch norm with
// bf16x2 instructions, and writes each pair of columns once, in the output
// type, as one bf16x2 or float2 store: no float32 intermediate leaves the
// SM.  TMA zero-fills rows past M or N and K past its end; the tensor maps
// are encoded on the host by cuTensorMapEncodeTiled, looked up at run time
// (cudaGetDriverEntryPointByVersion), so the library needs no -lcuda.

#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BM = 128;  // two consumer warpgroups of 64 rows
constexpr int BN = 256;  // one wgmma.m64n256k32 a warpgroup and 32 bytes of K
constexpr int BK = 128;  // bytes of K a stage: one 128-byte swizzle row
constexpr int STAGES = 4;
constexpr int CONSUMERS = 256, PRODUCERS = 128, THREADS = CONSUMERS + PRODUCERS;
constexpr int A_STAGE = BM * BK, B_STAGE = BN * BK, STAGE = A_STAGE + B_STAGE;
constexpr int SMEM = STAGES * STAGE + 2 * STAGES * 8 + 1024;  // barriers, 1024 alignment
constexpr int LAG = 2;  // conv mode: stages of cp.async a producer thread keeps in flight

struct Args {
  const int8_t* a;  // conv mode: the (R, H, W, C) map; dense A comes by TMA
  const float* sx;
  const float* sw;
  const float* bias;  // may be null
  const void* bn_k;   // the batch norm's kinds: (N,) in the output type
  const void* bn_b;
  const void* residual;  // the batch norm's kinds, may be null: (M, N) in the output type
  void* out;
  int M, N, K, rows_per_sample;
  int conv_h, conv_w, conv_c;
  int kind, relu;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

// Wait for the phase of `parity` to complete.  A pipeline fault traps after
// 10 s instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const uint64_t t0 = global_ns();
  while (!mbar_try_wait(bar, parity)) {
    if (global_ns() - t0 > 10000000000ull) __trap();
  }
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"((uint64_t)map), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros, read nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n)
               : "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Shared-memory matrix descriptor of a K-major tile in the 128-byte swizzle:
// rows of 128 bytes, 8-row groups 1024 bytes apart (the leading offset is
// unused in this layout).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pin the accumulators at this point of the program: the compiler does not
// know that wgmma writes them asynchronously.
template <int R>
__device__ __forceinline__ void fence_operands(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma(int (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ float relu(float v) { return v < 0.0f ? 0.0f : v; }  // NaN stays NaN

// What the epilogue writes: float32 (ReLU optional), the int32 sums, or the
// batch norm in bf16 or float32 (residual and ReLU optional).
enum Kind { K_FLOAT = 0, K_INT32 = 1, K_BN_BF16 = 2, K_BN_F32 = 3 };

// The bf16 batch norm, residual sum and ReLU of a pair of float32 values, as
// PyTorch's bf16 ops compute them: each op in float32, rounded once to bf16.
// The bf16x2 instructions round the exact result once; that is the same
// value, since a product of two bf16 values is exact in float32 and a sum of
// two is rounded by float32 to 24 bits, at least the 2 * 8 + 2 that make a
// second rounding to bf16 innocuous.
__device__ __forceinline__ __nv_bfloat162 bn_bf16(float v0, float v1, __nv_bfloat162 k,
                                                  __nv_bfloat162 b, bool has_res,
                                                  __nv_bfloat162 res, bool do_relu) {
  __nv_bfloat162 t = __floats2bfloat162_rn(v0, v1);
  t = __hmul2(t, k);
  t = __hadd2(t, b);
  if (has_res) t = __hadd2(t, res);
  return do_relu ? __hmax2_nan(t, __float2bfloat162_rn(0.0f)) : t;  // NaN stays NaN
}

// The same in float32.
__device__ __forceinline__ float bn_f32(float v, float k, float b, bool has_res, float res,
                                       bool do_relu) {
  float t = __fadd_rn(__fmul_rn(v, k), b);
  if (has_res) t = __fadd_rn(t, res);
  return do_relu ? relu(t) : t;
}

// The epilogue of one consumer thread: rows `row` and `row + 8`, columns
// `col + 8j` and `+ 1` for j < BN / 8, acc[4j + 2h + e] at (row + 8h, col +
// 8j + e).  Columns go in groups of G: every read-only value of a group
// (scales, bias, the batch norm, the residual) is loaded before any of its
// stores, so the loads overlap.
template <int KIND>
__device__ __forceinline__ void epilogue(const Args& args, const int (&acc)[BN / 2], int row,
                                         int col) {
  constexpr bool IS_BN = KIND == K_BN_BF16 || KIND == K_BN_F32;
  constexpr int G = 4;
  using Pair = typename std::conditional<KIND == K_BN_BF16, __nv_bfloat162, float2>::type;
  const float* __restrict__ sw = args.sw;
  const float* __restrict__ bias = args.bias;
  const Pair* __restrict__ bn_k = static_cast<const Pair*>(args.bn_k);
  const Pair* __restrict__ bn_b = static_cast<const Pair*>(args.bn_b);
  const Pair* __restrict__ residual = static_cast<const Pair*>(args.residual);
  const bool has_bias = bias != nullptr, has_res = residual != nullptr, do_relu = args.relu != 0;
  const int M = args.M, N = args.N;
  bool row_ok[2];
  float sxv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = row + 8 * h;
    row_ok[h] = m < M;
    sxv[h] = row_ok[h] && KIND != K_INT32 ? __ldg(args.sx + m / args.rows_per_sample) : 0.0f;
  }
#pragma unroll
  for (int j0 = 0; j0 < BN / 8; j0 += G) {
    float2 swv[G], biasv[G];
    Pair kv[G], bv[G], res[G][2];
#pragma unroll
    for (int jj = 0; jj < G; ++jj) {  // every read-only value of the group first
      const int n = col + 8 * (j0 + jj);
      swv[jj] = biasv[jj] = make_float2(0.0f, 0.0f);
      if (KIND == K_INT32 || n >= N) continue;  // N is even, so n + 1 < N too
      swv[jj] = __ldg(reinterpret_cast<const float2*>(sw + n));
      if (has_bias) biasv[jj] = __ldg(reinterpret_cast<const float2*>(bias + n));
      if (IS_BN) {
        kv[jj] = __ldg(bn_k + n / 2);
        bv[jj] = __ldg(bn_b + n / 2);
        if (has_res) {
#pragma unroll
          for (int h = 0; h < 2; ++h)
            if (row_ok[h]) res[jj][h] = __ldg(residual + ((long long)(row + 8 * h) * N + n) / 2);
        }
      }
    }
#pragma unroll
    for (int jj = 0; jj < G; ++jj) {
      const int j = j0 + jj, n = col + 8 * j;
      if (n >= N) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (!row_ok[h]) continue;
        const long long off = (long long)(row + 8 * h) * N + n;
        const int a0 = acc[4 * j + 2 * h], a1 = acc[4 * j + 2 * h + 1];
        if (KIND == K_INT32) {
          *reinterpret_cast<int2*>(static_cast<int*>(args.out) + off) = make_int2(a0, a1);
          continue;
        }
        float v0 = __fmul_rn(__int2float_rn(a0), __fmul_rn(sxv[h], swv[jj].x));
        float v1 = __fmul_rn(__int2float_rn(a1), __fmul_rn(sxv[h], swv[jj].y));
        if (has_bias) {
          v0 = __fadd_rn(v0, biasv[jj].x);
          v1 = __fadd_rn(v1, biasv[jj].y);
        }
        if constexpr (KIND == K_FLOAT) {
          if (do_relu) {
            v0 = relu(v0);
            v1 = relu(v1);
          }
          *reinterpret_cast<float2*>(static_cast<float*>(args.out) + off) = make_float2(v0, v1);
        } else if constexpr (KIND == K_BN_BF16) {
          *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(args.out) + off) =
              bn_bf16(v0, v1, kv[jj], bv[jj], has_res, res[jj][h], do_relu);
        } else if constexpr (KIND == K_BN_F32) {
          *reinterpret_cast<float2*>(static_cast<float*>(args.out) + off) =
              make_float2(bn_f32(v0, kv[jj].x, bv[jj].x, has_res, res[jj][h].x, do_relu),
                          bn_f32(v1, kv[jj].y, bv[jj].y, has_res, res[jj][h].y, do_relu));
        }
      }
    }
  }
}

// Persistent: block b computes tiles b, b + gridDim.x, ... (column tiles
// fastest, so the blocks in flight share their A rows through L2).  The ring
// runs on across tiles, so the producer fills the next tile's stages while
// the consumers run the epilogue.
template <bool CONV>
__global__ void __launch_bounds__(THREADS, 1)
    int8_gemm_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                           const __grid_constant__ CUtensorMap map_b, const Args args) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // the swizzle needs 1024
  const uint32_t bars = base + STAGES * STAGE;
  auto stage_a = [&](int s) { return base + s * STAGE; };
  auto stage_b = [&](int s) { return base + s * STAGE + A_STAGE; };
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (STAGES + s); };

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int KT = (args.K + BK - 1) / BK;
  const int col_tiles = (args.N + BN - 1) / BN;
  const int tiles = col_tiles * ((args.M + BM - 1) / BM);

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), CONV ? 1 + PRODUCERS : 1);
      mbar_init(empty(s), CONSUMERS / 32);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= CONSUMERS / 32) {
    // ---------------- producer warpgroup ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(CONV ? 56 : 40));
    const int p = tid - CONSUMERS;
    if (p == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"((uint64_t)&map_b) : "memory");
      if (!CONV) asm volatile("prefetch.tensormap [%0];\n" ::"l"((uint64_t)&map_a) : "memory");
    }
    if (!CONV) {
      if (p == 0) {
        int it = 0;  // the ring position, counted across tiles
        for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
          const int n0 = (tile % col_tiles) * BN, m0 = (tile / col_tiles) * BM;
          for (int kt = 0; kt < KT; ++kt, ++it) {
            const int s = it % STAGES;
            mbar_wait(empty(s), ((it / STAGES) & 1) ^ 1);
            mbar_expect_tx(full(s), STAGE);
            tma_load_2d(stage_a(s), &map_a, full(s), kt * BK, m0);
            tma_load_2d(stage_b(s), &map_b, full(s), kt * BK, n0);
          }
        }
      }
    } else {
      // Thread p copies 16-byte column `chunk` of rows row0 + 16 i, i < 8.
      const int chunk = p & 7, row0 = p >> 3;
      const int H = args.conv_h, W = args.conv_w, C = args.conv_c, HW = H * W;
      const uint32_t swz = (uint32_t)((chunk ^ (row0 & 7)) << 4);  // row & 7 == row0 & 7
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int n0 = (tile % col_tiles) * BN, m0 = (tile / col_tiles) * BM;
        uint32_t info[8];  // (m << 9) | the taps of row m inside the map; 0 past M
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int m = m0 + row0 + 16 * i;
          uint32_t mask = 0;
          if (m < args.M) {
            const int pos = m % HW, y = pos / W, x = pos - (pos / W) * W;
#pragma unroll
            for (int t = 0; t < 9; ++t) {
              const int yy = y + t / 3 - 1, xx = x + t % 3 - 1;
              if (yy >= 0 && yy < H && xx >= 0 && xx < W) mask |= 1u << t;
            }
          }
          info[i] = ((uint32_t)m << 9) | mask;
        }
        for (int kt = 0; kt < KT; ++kt, ++it) {
          const int s = it % STAGES;
          mbar_wait(empty(s), ((it / STAGES) & 1) ^ 1);
          if (p == 0) {
            mbar_expect_tx(full(s), B_STAGE);
            tma_load_2d(stage_b(s), &map_b, full(s), kt * BK, n0);
          }
          const int k = kt * BK + chunk * 16;
          const bool k_ok = k < args.K;
          const int tap = k_ok ? k / C : 0, c = k - tap * C;
          const int shift = (tap / 3 - 1) * W + tap % 3 - 1;  // position offset of the tap
          const uint32_t sa = stage_a(s) + swz;
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const bool ok = k_ok && ((info[i] >> tap) & 1u);
            const int8_t* src =
                ok ? args.a + (long long)((int)(info[i] >> 9) + shift) * C + c : args.a;
            cp_async16(sa + (row0 + 16 * i) * BK, src, ok);
          }
          asm volatile("cp.async.commit_group;\n" ::: "memory");
          if (it >= LAG) {  // the copies of position it - LAG have landed: publish them
            cp_async_wait<LAG>();
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
            mbar_arrive(full((it - LAG) % STAGES));
          }
        }
      }
      cp_async_wait<0>();
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      for (int i = it > LAG ? it - LAG : 0; i < it; ++i) mbar_arrive(full(i % STAGES));
    }
  } else {
    // ---------------- consumer warpgroups ----------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONV ? 224 : 232));
    const int wg = warp >> 2;  // rows 64 wg .. 64 wg + 63 of the tile
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int n0 = (tile % col_tiles) * BN, m0 = (tile / col_tiles) * BM;
      if (args.residual != nullptr && n0 + BN <= args.N) {
        // Bring the tile's residual rows into L2 under the main loop.
        const int m = m0 + (tid >> 1);
        const int elt = args.kind == K_BN_BF16 ? 2 : 4;
        if (m < args.M) {
          const char* line = static_cast<const char*>(args.residual) +
                             ((long long)m * args.N + n0) * elt + (tid & 1) * (BN * elt / 2);
          asm volatile("prefetch.global.L2 [%0];\n" ::"l"(line));
          asm volatile("prefetch.global.L2 [%0];\n" ::"l"(line + 128));
          if (elt == 4) {
            asm volatile("prefetch.global.L2 [%0];\n" ::"l"(line + 256));
            asm volatile("prefetch.global.L2 [%0];\n" ::"l"(line + 384));
          }
        }
      }
      int acc[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
      fence_operands(acc);
      for (int kt = 0; kt < KT; ++kt, ++it) {
        const int s = it % STAGES;
        mbar_wait(full(s), (it / STAGES) & 1);
        wgmma_fence();
        const uint32_t a = stage_a(s) + wg * 64 * BK, b = stage_b(s);
#pragma unroll
        for (int kk = 0; kk < BK / 32; ++kk) wgmma(acc, smem_desc(a + 32 * kk), smem_desc(b + 32 * kk));
        wgmma_commit();
        if (kt > 0) {  // the position before this one is read: hand it back
          wgmma_wait<1>();
          if (lane == 0) mbar_arrive(empty((it - 1) % STAGES));
        }
      }
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(empty((it - 1) % STAGES));
      fence_operands(acc);
      const int row = m0 + wg * 64 + (warp & 3) * 16 + (lane >> 2), col = n0 + 2 * (lane & 3);
      switch (args.kind) {
        case K_FLOAT: epilogue<K_FLOAT>(args, acc, row, col); break;
        case K_INT32: epilogue<K_INT32>(args, acc, row, col); break;
        case K_BN_BF16: epilogue<K_BN_BF16>(args, acc, row, col); break;
        default: epilogue<K_BN_F32>(args, acc, row, col); break;
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

// A (rows, K) int8 row-major matrix as a TMA map of (box_rows, 128-byte) boxes
// in the 128-byte swizzle; out-of-bounds elements read as zero.
bool encode_rows(CUtensorMap* map, const void* ptr, int rows, int K, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)K};
  const cuuint32_t box[2] = {(cuuint32_t)BK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool CONV>
int launch(const Args& args, const void* a, const void* b, cudaStream_t stream) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(int8_gemm_wgmma_kernel<CONV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 SMEM);
    if (err != cudaSuccess) {
      sms = 0;
      return (int)err;
    }
  }
  CUtensorMap map_a, map_b;
  if (!encode_rows(&map_b, b, args.N, args.K, BN)) return (int)cudaErrorInvalidValue;
  if (CONV) {
    map_a = map_b;  // unused: the producers gather A
  } else if (!encode_rows(&map_a, a, args.M, args.K, BM)) {
    return (int)cudaErrorInvalidValue;
  }
  const long long tiles = (((long long)args.M + BM - 1) / BM) * ((args.N + BN - 1) / BN);
  const int grid = (int)(tiles < sms ? tiles : sms);
  int8_gemm_wgmma_kernel<CONV><<<grid, THREADS, SMEM, stream>>>(map_a, map_b, args);
  return (int)cudaGetLastError();
}

}  // namespace

// A (M, K) int8 rows, or with conv_h > 0 an (M / (conv_h * conv_w), conv_h,
// conv_w, conv_c) int8 map read as its 3x3 SAME im2col (K = 9 * conv_c); sx
// one float32 scale for each rows_per_sample rows of A; B (N, K) int8; sw (N,)
// and bias (N,) float32, bias may be null.  kind 0: out (M, N) float32, ReLU
// if relu; 1: out the int32 sums (sx, sw, bias not read, no relu); 2 / 3:
// the batch norm bn_k, bn_b (N,) and out (M, N) in bf16 / float32, plus
// residual (M, N) in that type if not null, then ReLU if relu.  K % 16 == 0,
// N % 2 == 0, pointers 16-byte aligned, conv_c % 16 == 0 (the wrapper
// checks).
extern "C" int radnet_int8_gemm(const void* a, const void* sx, const void* b, const void* sw,
                                const void* bias, const void* bn_k, const void* bn_b,
                                const void* residual, void* out, int M, int N, int K,
                                int rows_per_sample, int conv_h, int conv_w, int conv_c, int kind,
                                int relu, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 16 != 0 || N % 2 != 0 || rows_per_sample <= 0)
    return (int)cudaErrorInvalidValue;
  const bool conv = conv_h > 0;
  if (conv && (conv_w <= 0 || conv_c % 16 != 0 || K != 9 * conv_c || M % (conv_h * conv_w) != 0 ||
               M >= (1 << 23)))
    return (int)cudaErrorInvalidValue;
  const bool bn = kind == K_BN_BF16 || kind == K_BN_F32;
  if (kind < K_FLOAT || kind > K_BN_F32 || (kind == K_INT32 && relu) ||
      bn != (bn_k != nullptr && bn_b != nullptr) || (!bn && residual != nullptr))
    return (int)cudaErrorInvalidValue;
  Args args{(const int8_t*)a, (const float*)sx, (const float*)sw, (const float*)bias, bn_k, bn_b,
            residual, out, M, N, K, rows_per_sample, conv_h, conv_w, conv_c, kind, relu};
  const cudaStream_t s = (cudaStream_t)stream;
  return conv ? launch<true>(args, a, b, s) : launch<false>(args, a, b, s);
}

extern "C" const char* radnet_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
