// Each row's largest magnitude, streamed from device memory, written for
// Hopper (sm_90a).
//
// Replaces: the max over a row in radnet_tpu/models/quant.py:45 quantize_sym
// where the row is split over the model axis of a tensor-parallel head
// (radnet_torch/parallel/tp.py), which JAX's GSPMD computes piece by piece and
// all-reduces (no Pallas kernel).  Each rank takes its piece's amax here; the
// all-reduced max is then quantized by quantize_rows.cu's given-amax mode.
//
// x (R, L) bfloat16 or float32, contiguous, L a multiple of 16 and x 16-byte
// aligned -> amax (R,) float32 = max |x| over the row, bit-equal to the plain
// version (radnet_torch/ops/quant.py::quantize_rows_amax_plain): a max is
// exact in any order.  The magnitudes are compared as integers (the sign bit
// cleared, the integer order of non-negative floats is their float order),
// so -0.0 gives +0.0, subnormals keep their bits, +inf is an inf, and a NaN
// anywhere in a row, whose magnitude bits lie above inf's, makes the row's
// amax a NaN, as jnp.max and torch.amax do.  (The earlier design folds
// through fmaxf, which returns the number of a NaN and a number, so it drops
// NaNs in both types.)
//
// Bound on this card: bytes.  It reads each value once and writes 4 bytes a
// row; a ResNet50 head's split activation piece (3600 x 50 176 bf16, 361 MB)
// is ~0.108 ms at 3.35 TB/s.
//
// Design: no staging.  The earlier design (quantize_rows.cu's amax-only mode)
// copied each row into shared memory by TMA and waited on an mbarrier before
// folding it, one CTA or cluster a row: on short rows 3600 small CTAs each
// paid the barrier's set-up, a serial copy issue and a 512-thread reduction.
// Here a group of `row_threads` threads (a power of two, 8 to 1024) owns a
// row and reads it straight from device memory in 16-byte loads, `UNROLL`
// loads in flight a thread, folding each as it lands: float32 by an integer
// max of the masked bits, bf16 pairs by __vmaxu2 on the masked halves.  A
// group within a warp reduces by shuffles, a larger one then across its warps
// through shared memory.  A CTA holds `threads / row_threads` rows.  The plan
// (row_threads, threads, unroll) comes from the wrapper
// (radnet_torch/ops/quant.py::row_amax_plan): short rows share a CTA, a warp
// or less a row; long rows take a CTA each.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;

// The largest magnitude in 16 bytes of x, folded into m as the bits of a
// non-negative float32 (float32), or as two bf16 magnitudes side by side.
__device__ __forceinline__ uint32_t fold16(const float*, uint4 u, uint32_t m) {
  m = max(m, u.x & 0x7fffffffu);
  m = max(m, u.y & 0x7fffffffu);
  m = max(m, u.z & 0x7fffffffu);
  return max(m, u.w & 0x7fffffffu);
}

__device__ __forceinline__ uint32_t fold16(const __nv_bfloat16*, uint4 u, uint32_t m) {
  m = __vmaxu2(m, u.x & 0x7fff7fffu);
  m = __vmaxu2(m, u.y & 0x7fff7fffu);
  m = __vmaxu2(m, u.z & 0x7fff7fffu);
  return __vmaxu2(m, u.w & 0x7fff7fffu);
}

// The float32 bits of a fold's result: a bf16 is the top half of its float32.
__device__ __forceinline__ uint32_t as_f32_bits(const float*, uint32_t m) { return m; }

__device__ __forceinline__ uint32_t as_f32_bits(const __nv_bfloat16*, uint32_t m) {
  return max(m << 16, m & 0xffff0000u);
}

template <typename T, int UNROLL>
__global__ void __launch_bounds__(kMaxThreads)
row_amax_kernel(const uint4* __restrict__ x, float* __restrict__ amax, int rows, int units,
                int row_threads) {
  __shared__ uint32_t warp_max[kMaxThreads / 32];
  const int tid = threadIdx.x;
  const int lane = tid & (row_threads - 1);  // this thread's place in its row's group
  const long long row = (long long)blockIdx.x * (blockDim.x / row_threads) + tid / row_threads;
  uint32_t m = 0;
  if (row < rows) {  // a thread past the last row still joins the reductions
    const uint4* p = x + row * units;
    int i = lane;
    for (; i + (UNROLL - 1) * row_threads < units; i += UNROLL * row_threads) {
      uint4 v[UNROLL];
#pragma unroll
      for (int k = 0; k < UNROLL; ++k) v[k] = __ldg(p + i + k * row_threads);
#pragma unroll
      for (int k = 0; k < UNROLL; ++k) m = fold16((const T*)nullptr, v[k], m);
    }
    for (; i < units; i += row_threads) m = fold16((const T*)nullptr, __ldg(p + i), m);
  }
  m = as_f32_bits((const T*)nullptr, m);
  const int in_warp = row_threads < 32 ? row_threads : 32;
  for (int off = in_warp >> 1; off > 0; off >>= 1) m = max(m, __shfl_xor_sync(0xffffffffu, m, off));
  if (row_threads > 32) {  // the group's warps, through shared memory
    if ((tid & 31) == 0) warp_max[tid >> 5] = m;
    __syncthreads();
    if (lane == 0)
      for (int w = 1; w < row_threads / 32; ++w) m = max(m, warp_max[(tid >> 5) + w]);
  }
  if (lane == 0 && row < rows) amax[row] = __uint_as_float(m);
}

template <typename T, int UNROLL>
cudaError_t launch(const void* x, void* amax, int rows, int units, int row_threads, int threads,
                   cudaStream_t stream) {
  const int rows_per_cta = threads / row_threads;
  const long long blocks = ((long long)rows + rows_per_cta - 1) / rows_per_cta;
  row_amax_kernel<T, UNROLL><<<(unsigned)blocks, threads, 0, stream>>>(
      (const uint4*)x, (float*)amax, rows, units, row_threads);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_unroll(const void* x, void* amax, int rows, int units, int row_threads,
                          int threads, int unroll, cudaStream_t stream) {
  switch (unroll) {
    case 4: return launch<T, 4>(x, amax, rows, units, row_threads, threads, stream);
    case 8: return launch<T, 8>(x, amax, rows, units, row_threads, threads, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype of x: 0 = float32, 1 = bfloat16.  L must be a multiple of 16 and x
// 16-byte aligned (the wrapper checks both); `row_threads` threads (a power
// of two, 8 to 1024) share a row, `threads` threads (a multiple of 32 and of
// row_threads, at most 1024) make a CTA, each thread keeps `unroll` (4 or 8)
// 16-byte loads in flight.
extern "C" int radnet_row_amax(const void* x, void* amax, int rows, long long L, int dtype,
                               int row_threads, int threads, int unroll, void* stream) {
  const long long item = dtype == 0 ? 4 : 2;
  const long long units = L * item / 16;
  if (rows <= 0 || L <= 0 || L % 16 != 0 || (dtype != 0 && dtype != 1) || units > 0x7fffffffLL ||
      row_threads < 8 || row_threads > kMaxThreads || (row_threads & (row_threads - 1)) != 0 ||
      threads < 32 || threads > kMaxThreads || threads % 32 != 0 || threads % row_threads != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)(dtype == 0
                   ? launch_unroll<float>(x, amax, rows, (int)units, row_threads, threads, unroll, st)
                   : launch_unroll<__nv_bfloat16>(x, amax, rows, (int)units, row_threads, threads,
                                                  unroll, st));
}

extern "C" const char* radnet_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
