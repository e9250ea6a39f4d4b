// Symmetric int8 quantization of rows, one scale a row, written for Hopper
// (sm_90a).
//
// Replaces: radnet_tpu/models/quant.py:45 quantize_sym, which the JAX package
// leaves to XLA (no Pallas kernel), at the axes the int8 RoI head uses: every
// value of one RoI's NHWC activation (a row of 49 * C), one row of a dense
// input, and one output channel of a weight (a row of kh * kw * C, K-major).
//
// x (R, L) bfloat16 or float32, contiguous -> q (R, L) int8 and scale (R,)
// float32, exactly as JAX computes them: amax = max |x| over the row in
// float32, scale = max(amax, 1e-12) / 127, q = clip(round_half_even(x /
// scale), -127, 127).  The division is IEEE (__fdiv_rn) and the rounding
// rintf, and the file is built without --use_fast_math, so q and scale are
// bit-equal to JAX's and to the plain version
// (radnet_torch/ops/quant.py::quantize_rows_plain).  A max is exact in any
// order, so any split of the row keeps the scale's bits; a zero quantizes to
// 0 whatever its sign, so it is written without a division.
//
// Bound on this card: bytes.  It reads each input once and writes one byte a
// value.  At the int8 ResNet50 head's widest input (3600 RoIs x 100 352 bf16
// values, 723 MB) the bound is ~0.32 ms at 3.35 TB/s.
//
// Design: each row is read from device memory once, into shared memory.
//   * A row is cut into slices of at most 112 KiB (two CTAs share an SM's
//     228 KB, so one's loads overlap the other's arithmetic), one slice a
//     CTA; a row of more than one slice takes a thread-block cluster of 2, 4
//     or 8 CTAs.  The plan (cluster size, values and threads a CTA: a thread
//     a group of 16 values, 64 to 512) comes from the wrapper
//     (radnet_torch/ops/quant.py::quantize_plan).
//   * One thread issues the slice as TMA bulk copies of kChunkBytes (the
//     whole slice), each completing on its own mbarrier; the CTA folds each
//     chunk into its running max as it lands, then reduces the max by warp
//     shuffles.
//   * In a cluster each CTA puts its partial max in shared memory, the
//     cluster barrier publishes it, and each CTA reads its peers' through
//     distributed shared memory.  A second cluster barrier, arrived after the
//     reads and waited before the CTA ends, keeps every partial alive until
//     its peers have read it.
//   * Each thread then quantizes 16 values at a time from shared memory and
//     writes them as one 16-byte store.  A zero skips the division: the IEEE
//     division's fast-path check (FCHK) sends a zero numerator to its slow
//     subroutine, and a warp then waits for the slowest lane.
// What bounds it beside the bytes: each value's division issues a MUFU.RCP
// and rintf an FRND, both on the SM's 16-a-clock conversion pipe, so the
// int8 is taken from the bits of a FADD rather than by F2I, a third.
// Row lengths must be multiples of 16 values, so every slice starts and ends
// on 16 bytes in both types.
//
// Two more modes serve a row that is split over the model axis of a
// tensor-parallel head (radnet_torch/parallel/tp.py), where JAX's GSPMD
// inserts an all-reduce-max into quantize_sym: amax-only writes each row's
// amax (radnet_quantize_rows_amax) and nothing else; given-amax
// (radnet_quantize_rows_given) skips the max, takes scale = max(amax, 1e-12)
// / 127 from an amax it is given (the all-reduced one) and quantizes.  A max
// is exact in any order, so a row split in pieces, each piece's amax reduced
// by MAX and then quantized by given-amax, is bit-equal to the whole row
// quantized at once.  The three modes are instances of one template, so the
// whole-row mode compiles as it did.  The port takes each piece's amax from
// row_amax.cu, which streams the row without staging it; the amax-only mode
// stays here as its earlier design, timed beside it by chip_smoke.py.  Its
// last fmaxf drops a NaN, in both types, where row_amax.cu keeps it.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxCluster = 8;
constexpr int kSliceBytes = 112 * 1024;  // the most a CTA stages
// One bulk copy and one mbarrier a chunk.  A chunk of the whole slice: chunks
// of 4-16 KiB, folded as each lands, measured 0-8% slower on this card
// (scripts/quantize_rows_probe.py --variants).
constexpr int kChunkBytes = kSliceBytes;
constexpr int kMaxChunks = (kSliceBytes + kChunkBytes - 1) / kChunkBytes;
// Shared memory: the chunks' mbarriers, the warps' maxima and the CTA's
// partial max, then the slice.
constexpr int kWarpMaxOffset = 8 * kMaxChunks;
constexpr int kPartOffset = kWarpMaxOffset + 4 * kMaxWarps;
constexpr int kDataOffset = 256;
static_assert(kPartOffset + 4 <= kDataOffset, "the header outgrows its room");

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

// Wait for the phase of `parity` to complete.  A lost copy traps after 10 s
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const uint64_t t0 = global_ns();
  while (!mbar_try_wait(bar, parity)) {
    if (global_ns() - t0 > 10000000000ull) __trap();
  }
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// The largest magnitude in 16 bytes of x, folded into m: float32 as floats;
// bf16 pairs as the integers of their magnitudes (for values with the sign
// bit cleared the integer order is the float order), kept as two halves.
__device__ __forceinline__ void fold16(const float*, uint4 u, float& m, uint32_t&) {
  m = fmaxf(m, fabsf(__uint_as_float(u.x)));
  m = fmaxf(m, fabsf(__uint_as_float(u.y)));
  m = fmaxf(m, fabsf(__uint_as_float(u.z)));
  m = fmaxf(m, fabsf(__uint_as_float(u.w)));
}

__device__ __forceinline__ void fold16(const __nv_bfloat16*, uint4 u, float&, uint32_t& m2) {
  m2 = __vmaxu2(m2, u.x & 0x7fff7fffu);
  m2 = __vmaxu2(m2, u.y & 0x7fff7fffu);
  m2 = __vmaxu2(m2, u.z & 0x7fff7fffu);
  m2 = __vmaxu2(m2, u.w & 0x7fff7fffu);
}

struct Vals {
  float v[16];
};

__device__ __forceinline__ void load16(const float* p, Vals& out) {
  const float4* p4 = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float4 f = p4[j];
    out.v[4 * j] = f.x;
    out.v[4 * j + 1] = f.y;
    out.v[4 * j + 2] = f.z;
    out.v[4 * j + 3] = f.w;
  }
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, Vals& out) {
  const uint4* p4 = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const uint4 u = p4[j];
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {  // a bf16 is the top half of its float32
      out.v[8 * j + 2 * k] = __uint_as_float(w[k] << 16);
      out.v[8 * j + 2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
}

// The bits of an integral float in [-127, 127] plus 1.5 * 2^23: the float's
// integer sits in the low mantissa bits, so its low byte is the int8.  A
// full-rate FADD, where F2I would share the 16-a-clock conversion pipe with
// the division's MUFU.RCP and rintf's FRND.
__device__ __forceinline__ uint32_t int8_in_low_byte(float r) {
  return __float_as_uint(__fadd_rn(r, 12582912.0f));
}

__device__ __forceinline__ uint32_t pack4(const Vals& x, int base, float s) {
  uint32_t b[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float v = x.v[base + k];
    b[k] = 0;
    if (v != 0.0f) {  // a zero of either sign quantizes to 0
      const float r = rintf(__fdiv_rn(v, s));
      b[k] = int8_in_low_byte(fminf(fmaxf(r, -127.0f), 127.0f));
    }
  }
  return __byte_perm(__byte_perm(b[0], b[1], 0x0040), __byte_perm(b[2], b[3], 0x0040), 0x5410);
}

// What a launch does with each row: the whole quantization, the amax alone,
// or the quantization with a given amax.
enum Mode { kWhole = 0, kAmaxOnly = 1, kGivenAmax = 2 };

// amax: written (kAmaxOnly) or read (kGivenAmax), (rows,) float32; unused by
// kWhole.  kAmaxOnly writes neither q nor scale.
template <typename T, int MODE>
__global__ void __launch_bounds__(kMaxThreads)
quantize_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ q, float* __restrict__ scale,
                     float* __restrict__ amax_io, long long L, int cluster, int slice) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* warp_max = reinterpret_cast<float*>(smem + kWarpMaxOffset);
  float* part = reinterpret_cast<float*>(smem + kPartOffset);
  const T* xs = reinterpret_cast<const T*>(smem + kDataOffset);
  const uint32_t bars = smem_u32(smem), data = smem_u32(smem + kDataOffset);
  const int tid = threadIdx.x, threads = blockDim.x;
  const int rank = (int)(blockIdx.x % (unsigned)cluster);
  const long long row = blockIdx.x / (unsigned)cluster;
  const long long v0 = (long long)rank * slice;
  const long long left = L - v0;
  const int n = left <= 0 ? 0 : (left < slice ? (int)left : slice);  // this CTA's values
  const int bytes = n * (int)sizeof(T);
  const int chunks = (bytes + kChunkBytes - 1) / kChunkBytes;
  const T* src = x + row * L + v0;

  if (tid == 0) {
    for (int c = 0; c < chunks; ++c) mbar_init(bars + 8 * c, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int c = 0; c < chunks; ++c) {
      const int off = c * kChunkBytes;
      const int nb = bytes - off < kChunkBytes ? bytes - off : kChunkBytes;
      mbar_expect_tx(bars + 8 * c, (uint32_t)nb);
      bulk_load(data + off, reinterpret_cast<const unsigned char*>(src) + off, (uint32_t)nb,
                bars + 8 * c);
    }
  }
  __syncthreads();  // the mbarriers are initialised before anyone waits on them

  float amax = 0.0f;
  if constexpr (MODE == kGivenAmax) {
    for (int c = 0; c < chunks; ++c) mbar_wait(bars + 8 * c, 0);
    amax = amax_io[row];
  } else {
    // The slice's max, chunk by chunk as the copies land.
    uint32_t amax2 = 0;
    for (int c = 0; c < chunks; ++c) {
      mbar_wait(bars + 8 * c, 0);
      const int off = c * kChunkBytes;
      const int units = (bytes - off < kChunkBytes ? bytes - off : kChunkBytes) / 16;
      const uint4* u = reinterpret_cast<const uint4*>(smem + kDataOffset + off);
      for (int i = tid; i < units; i += threads) fold16(xs, u[i], amax, amax2);
    }
    amax = fmaxf(amax, fmaxf(__uint_as_float(amax2 << 16), __uint_as_float(amax2 & 0xffff0000u)));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    if ((tid & 31) == 0) warp_max[tid >> 5] = amax;
    __syncthreads();
    amax = warp_max[0];
    for (int w = 1; w < threads / 32; ++w) amax = fmaxf(amax, warp_max[w]);

    if (cluster > 1) {  // the row's max over the cluster's partials
      if (tid == 0) *part = amax;
      cluster_arrive_release();
      cluster_wait();
      cg::cluster_group cl = cg::this_cluster();
      for (int r = 0; r < cluster; ++r) amax = fmaxf(amax, *cl.map_shared_rank(part, r));
      cluster_arrive_relaxed();  // done with the peers' partials
    }
  }
  if constexpr (MODE == kAmaxOnly) {
    if (rank == 0 && tid == 0) amax_io[row] = amax;
    if (cluster > 1) cluster_wait();  // no CTA ends while a peer may read its partial
    return;
  }
  const float s = __fdiv_rn(fmaxf(amax, 1e-12f), 127.0f);
  if (rank == 0 && tid == 0) scale[row] = s;

  int8_t* qr = q + row * L + v0;
  for (int g = tid; g < n / 16; g += threads) {
    Vals v;
    load16(xs + g * 16, v);
    uint4 out;
    out.x = pack4(v, 0, s);
    out.y = pack4(v, 4, s);
    out.z = pack4(v, 8, s);
    out.w = pack4(v, 12, s);
    reinterpret_cast<uint4*>(qr)[g] = out;
  }
  // No CTA ends while a peer may read its partial (given-amax reads none).
  if (MODE != kGivenAmax && cluster > 1) cluster_wait();
}

template <typename T, int MODE>
cudaError_t launch(const void* x, void* q, void* scale, void* amax, int rows, long long L,
                   int cluster, int slice, int threads, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(quantize_rows_kernel<T, MODE>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               kDataOffset + kSliceBytes);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)rows * (unsigned)cluster, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = kDataOffset + (size_t)slice * sizeof(T);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, quantize_rows_kernel<T, MODE>, (const T*)x, (int8_t*)q,
                            (float*)scale, (float*)amax, L, cluster, slice);
}

template <int MODE>
int launch_mode(const void* x, void* q, void* scale, void* amax, int rows, long long L, int dtype,
                int cluster, int slice, int threads, void* stream) {
  const long long item = dtype == 0 ? 4 : 2;
  if (rows <= 0 || L <= 0 || L % 16 != 0 || (dtype != 0 && dtype != 1) || slice <= 0 ||
      slice % 16 != 0 || slice * item > kSliceBytes || (long long)cluster * slice < L ||
      (cluster != 1 && cluster != 2 && cluster != 4 && cluster != kMaxCluster) ||
      threads < 32 || threads > kMaxThreads || threads % 32 != 0 ||
      (long long)rows * cluster > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err =
      dtype == 0
          ? launch<float, MODE>(x, q, scale, amax, rows, L, cluster, slice, threads, st)
          : launch<__nv_bfloat16, MODE>(x, q, scale, amax, rows, L, cluster, slice, threads, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// dtype of x: 0 = float32, 1 = bfloat16.  L must be a multiple of 16 and the
// pointers 16-byte aligned (the wrapper checks both); `cluster` CTAs of
// `slice` values each (a multiple of 16, at most 112 KiB) and `threads`
// threads (a multiple of 32, at most 1024) cover a row.
extern "C" int radnet_quantize_rows(const void* x, void* q, void* scale, int rows, long long L,
                                    int dtype, int cluster, int slice, int threads, void* stream) {
  return launch_mode<kWhole>(x, q, scale, nullptr, rows, L, dtype, cluster, slice, threads, stream);
}

// The same plan; amax (rows,) float32 is written, q and scale are not.
extern "C" int radnet_quantize_rows_amax(const void* x, void* amax, int rows, long long L, int dtype,
                                         int cluster, int slice, int threads, void* stream) {
  return launch_mode<kAmaxOnly>(x, nullptr, nullptr, amax, rows, L, dtype, cluster, slice, threads,
                                stream);
}

// The same plan; amax (rows,) float32 is read and q, scale written.
extern "C" int radnet_quantize_rows_given(const void* x, const void* amax, void* q, void* scale,
                                          int rows, long long L, int dtype, int cluster, int slice,
                                          int threads, void* stream) {
  return launch_mode<kGivenAmax>(x, q, scale, const_cast<void*>(amax), rows, L, dtype, cluster,
                                 slice, threads, stream);
}

extern "C" const char* radnet_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
