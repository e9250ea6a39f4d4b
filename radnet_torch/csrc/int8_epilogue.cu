// The int8 product's epilogue on int32 sums that were added up elsewhere: the
// dequantize, bias, frozen batch norm, residual sum and ReLU of
// csrc/int8_gemm.cu, as a kernel of its own (sm_90a).
//
// Replaces: the dequantize of radnet_tpu/models/quant.py:75 (int8_conv) and
// :85 (int8_dense), with the batch norm and ReLU XLA fuses after them, where
// the product is row-parallel over the model axis of a tensor-parallel head
// (radnet_torch/parallel/tp.py: ResNet50's conv2a, VGG16's fc2).  There each
// rank's product covers a slice of K, so JAX's GSPMD all-reduces the int32
// sums before the dequantize; the port does the same (an all-reduce of int32
// is exact in any order) and then runs this kernel on the sum.  For each
// output element, exactly as int8_gemm.cu's fused epilogue computes it:
//
//   v   = float(acc) * (sx[m / rows_per_sample] * sw[n]) + bias[n]   (float32)
//   float: out = v, or max(v, 0) with relu
//   bn:    t = dt(v); t = dt(t * k[n]); t = dt(t + b[n]);
//          [t = dt(t + res[m, n])]; [t = max(t, 0)];  out = t, dt in {bf16, f32}
//
// bn_bf16 and bn_f32 below are copies of int8_gemm.cu's, not shared through a
// header: the product's source stays as it was, so its SASS and its time
// cannot move.  The file is built with --fmad=false and spells out every
// float32 rounding, so the output is bit-equal to the fused epilogue on the
// same sums and to the plain version (radnet_torch/ops/quant.py::
// int8_epilogue_plain).
//
// Bound on this card: bytes.  It reads the int32 sums (4 bytes a value), the
// residual where there is one, and writes the output (2 or 4 bytes); at
// ResNet50's conv2a (176 400 x 512 a 12-tile batch, bf16 out) that is 542 MB,
// ~0.16 ms at 3.35 TB/s.
//
// Design: one thread a pair of columns, as the fused epilogue's stores: an
// 8-byte load of the two sums, the pair's scales, bias and batch norm through
// the read-only path, one bf16x2 or float2 store.  A grid-stride loop over the
// pairs in row-major order, so neighbouring threads touch neighbouring
// addresses.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;

// What the epilogue writes, as int8_gemm.cu's Kind (its K_INT32 is not an
// epilogue): float32 (ReLU optional), or the batch norm in bf16 or float32
// (residual and ReLU optional).
enum Kind { K_FLOAT = 0, K_BN_BF16 = 2, K_BN_F32 = 3 };

__device__ __forceinline__ float relu(float v) { return v < 0.0f ? 0.0f : v; }  // NaN stays NaN

// Copied from int8_gemm.cu: the bf16 batch norm, residual sum and ReLU of a
// pair of float32 values, as PyTorch's bf16 ops compute them (each op in
// float32, rounded once to bf16; the bf16x2 instructions give the same bits).
__device__ __forceinline__ __nv_bfloat162 bn_bf16(float v0, float v1, __nv_bfloat162 k,
                                                  __nv_bfloat162 b, bool has_res,
                                                  __nv_bfloat162 res, bool do_relu) {
  __nv_bfloat162 t = __floats2bfloat162_rn(v0, v1);
  t = __hmul2(t, k);
  t = __hadd2(t, b);
  if (has_res) t = __hadd2(t, res);
  return do_relu ? __hmax2_nan(t, __float2bfloat162_rn(0.0f)) : t;  // NaN stays NaN
}

// Copied from int8_gemm.cu: the same in float32.
__device__ __forceinline__ float bn_f32(float v, float k, float b, bool has_res, float res,
                                       bool do_relu) {
  float t = __fadd_rn(__fmul_rn(v, k), b);
  if (has_res) t = __fadd_rn(t, res);
  return do_relu ? relu(t) : t;
}

template <int KIND>
__global__ void __launch_bounds__(kThreads)
int8_epilogue_kernel(const int* __restrict__ acc, const float* __restrict__ sx,
                     const float* __restrict__ sw, const float* __restrict__ bias,
                     const void* __restrict__ bn_k_, const void* __restrict__ bn_b_,
                     const void* __restrict__ residual_, void* __restrict__ out, long long M,
                     int N, int rows_per_sample, int relu_flag) {
  using Pair = typename std::conditional<KIND == K_BN_BF16, __nv_bfloat162, float2>::type;
  const Pair* __restrict__ bn_k = static_cast<const Pair*>(bn_k_);
  const Pair* __restrict__ bn_b = static_cast<const Pair*>(bn_b_);
  const Pair* __restrict__ residual = static_cast<const Pair*>(residual_);
  const bool has_bias = bias != nullptr, has_res = residual != nullptr, do_relu = relu_flag != 0;
  const int pairs = N / 2;
  const long long total = M * pairs;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const long long m = i / pairs;
    const int p = (int)(i - m * pairs), n = 2 * p;
    const long long off = m * N + n;
    const int2 a = __ldg(reinterpret_cast<const int2*>(acc + off));
    const float sxv = __ldg(sx + m / rows_per_sample);
    const float2 swv = __ldg(reinterpret_cast<const float2*>(sw + n));
    float v0 = __fmul_rn(__int2float_rn(a.x), __fmul_rn(sxv, swv.x));
    float v1 = __fmul_rn(__int2float_rn(a.y), __fmul_rn(sxv, swv.y));
    if (has_bias) {
      const float2 bv = __ldg(reinterpret_cast<const float2*>(bias + n));
      v0 = __fadd_rn(v0, bv.x);
      v1 = __fadd_rn(v1, bv.y);
    }
    if constexpr (KIND == K_FLOAT) {
      if (do_relu) {
        v0 = relu(v0);
        v1 = relu(v1);
      }
      *reinterpret_cast<float2*>(static_cast<float*>(out) + off) = make_float2(v0, v1);
    } else {
      const Pair kv = __ldg(bn_k + p), bv = __ldg(bn_b + p);
      Pair res{};
      if (has_res) res = __ldg(residual + off / 2);
      if constexpr (KIND == K_BN_BF16) {
        *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) + off) =
            bn_bf16(v0, v1, kv, bv, has_res, res, do_relu);
      } else {
        *reinterpret_cast<float2*>(static_cast<float*>(out) + off) =
            make_float2(bn_f32(v0, kv.x, bv.x, has_res, res.x, do_relu),
                        bn_f32(v1, kv.y, bv.y, has_res, res.y, do_relu));
      }
    }
  }
}

template <int KIND>
cudaError_t launch(const int* acc, const float* sx, const float* sw, const float* bias,
                   const void* bn_k, const void* bn_b, const void* residual, void* out,
                   long long M, int N, int rows_per_sample, int relu, cudaStream_t stream) {
  int sms = 0, dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long total = M * (N / 2);
  const long long want = (total + kThreads - 1) / kThreads;
  const long long cap = (long long)sms * 16;  // 16 blocks an SM, a grid-stride loop beyond
  const int blocks = (int)(want < cap ? want : cap);
  int8_epilogue_kernel<KIND><<<blocks, kThreads, 0, stream>>>(
      acc, sx, sw, bias, bn_k, bn_b, residual, out, M, N, rows_per_sample, relu);
  return cudaSuccess;
}

}  // namespace

// acc (M, N) int32; sx one float32 scale for each rows_per_sample rows; sw (N,)
// and bias (N,) float32, bias may be null.  kind 0: out (M, N) float32, ReLU
// if relu; 2 / 3: the batch norm bn_k, bn_b (N,) and out (M, N) in bf16 /
// float32, plus residual (M, N) in that type if not null, then ReLU if relu.
// N % 2 == 0 and pointers 8-byte aligned (the wrapper checks 16).
extern "C" int radnet_int8_epilogue(const void* acc, const void* sx, const void* sw,
                                    const void* bias, const void* bn_k, const void* bn_b,
                                    const void* residual, void* out, long long M, int N,
                                    int rows_per_sample, int kind, int relu, void* stream) {
  if (M <= 0 || N <= 0 || N % 2 != 0 || rows_per_sample <= 0) return (int)cudaErrorInvalidValue;
  const bool bn = kind == K_BN_BF16 || kind == K_BN_F32;
  if ((kind != K_FLOAT && !bn) || bn != (bn_k != nullptr && bn_b != nullptr) ||
      (!bn && residual != nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int* a = (const int*)acc;
  const float *x = (const float*)sx, *w = (const float*)sw, *b = (const float*)bias;
  cudaError_t err =
      kind == K_FLOAT     ? launch<K_FLOAT>(a, x, w, b, bn_k, bn_b, residual, out, M, N, rows_per_sample, relu, s)
      : kind == K_BN_BF16 ? launch<K_BN_BF16>(a, x, w, b, bn_k, bn_b, residual, out, M, N, rows_per_sample, relu, s)
                          : launch<K_BN_F32>(a, x, w, b, bn_k, bn_b, residual, out, M, N, rows_per_sample, relu, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" const char* radnet_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
