// The earlier design of radnet_torch/csrc/quantize_rows.cu, kept to be timed
// beside it (chip_smoke.py int8_kernels, scripts/quantize_rows_probe.py):
// symmetric int8 quantization of rows, one scale a row, for Hopper (sm_90a).
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
// (radnet_torch/ops/quant.py::quantize_rows_plain).
//
// Design: one block per row.  Pass 1 reads the row 16 values a thread at a
// time (two or four 16-byte loads), keeps a running max, and reduces it over
// the block by warp shuffles; pass 2 reads the row again, divides every value
// (zeros too), rounds and writes 16 int8 values as one 16-byte store.  The
// row length must be a multiple of 16 values.  What holds it back: at 2048
// channels (rows of 200 KB bf16) the rows in flight outgrow the 50 MB L2, so
// pass 2 reads the row from device memory a second time; and the division of
// a zero takes the slow path of the IEEE division.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

struct Vals {
  float v[16];
};

__device__ __forceinline__ void load16(const float* p, Vals& out) {
  const float4* p4 = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float4 f = __ldg(p4 + j);
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
    const uint4 u = __ldg(p4 + j);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {  // a bf16 is the top half of its float32
      out.v[8 * j + 2 * k] = __uint_as_float(w[k] << 16);
      out.v[8 * j + 2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
}

__device__ __forceinline__ uint32_t pack4(const Vals& x, int base, float s) {
  uint32_t word = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float r = rintf(__fdiv_rn(x.v[base + k], s));
    r = fminf(fmaxf(r, -127.0f), 127.0f);
    word |= (uint32_t)(uint8_t)(int8_t)__float2int_rn(r) << (8 * k);
  }
  return word;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
quantize_rows_two_pass_kernel(const T* __restrict__ x, int8_t* __restrict__ q, float* __restrict__ scale,
                     long long L) {
  const long long row = blockIdx.x;
  const T* xr = x + row * L;
  int8_t* qr = q + row * L;
  const long long groups = L / 16;

  float amax = 0.0f;
  for (long long g = threadIdx.x; g < groups; g += kThreads) {
    Vals v;
    load16(xr + g * 16, v);
#pragma unroll
    for (int k = 0; k < 16; ++k) amax = fmaxf(amax, fabsf(v.v[k]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  __shared__ float warp_max[kWarps];
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = amax;
  __syncthreads();
  amax = warp_max[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) amax = fmaxf(amax, warp_max[w]);
  const float s = __fdiv_rn(fmaxf(amax, 1e-12f), 127.0f);
  if (threadIdx.x == 0) scale[row] = s;

  for (long long g = threadIdx.x; g < groups; g += kThreads) {
    Vals v;
    load16(xr + g * 16, v);
    uint4 out;
    out.x = pack4(v, 0, s);
    out.y = pack4(v, 4, s);
    out.z = pack4(v, 8, s);
    out.w = pack4(v, 12, s);
    reinterpret_cast<uint4*>(qr)[g] = out;
  }
}

}  // namespace

// dtype of x: 0 = float32, 1 = bfloat16.  L must be a multiple of 16 and the
// pointers 16-byte aligned (the wrapper checks both).
extern "C" int radnet_earlier_quantize_rows(const void* x, void* q, void* scale, int rows, long long L,
                                    int dtype, void* stream) {
  if (rows <= 0 || L <= 0 || L % 16 != 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    quantize_rows_two_pass_kernel<float><<<rows, kThreads, 0, st>>>((const float*)x, (int8_t*)q,
                                                          (float*)scale, L);
  else if (dtype == 1)
    quantize_rows_two_pass_kernel<__nv_bfloat16><<<rows, kThreads, 0, st>>>(
        (const __nv_bfloat16*)x, (int8_t*)q, (float*)scale, L);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" const char* radnet_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
