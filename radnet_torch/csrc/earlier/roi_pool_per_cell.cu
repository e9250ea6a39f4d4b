// The earlier design of csrc/roi_pool.cu (one block per output cell, four
// taps read from L2 per cell).  Not on any path of the
// package: chip_smoke.py builds it and times it beside the current kernel
// on the same inputs, so the two are compared within one run.
//
// Bilinear crop-and-resize RoI pooling, written for Hopper (sm_90a).
//
// Replaces: radnet_tpu/ops/pallas_roi.py, _kernel / roi_pool_pallas, and adds
// the center_stride that the main path pools with (radnet_tpu/ops/
// roi_align.py::_sample_centers).
//
// fmap (B, H, W, C) channels-contiguous, bf16 or f32; rois (B, R, 4) xywh f32
// in feature units; out (B, R, P, P, C) in the fmap's type.  Each output cell
// samples the clamped half-pixel centre (cy, cx) of position (p * stride) of
// a virtual (P * stride) grid over the crop, with the weight profile
// relu(1 - |c - h|) of the matmul form Ry @ F @ Rx^T.  That profile is
// nonzero on at most rows floor(cy), floor(cy) + 1 and the same two columns,
// so the kernel reads four taps: out = wx0 * (wy0 F00 + wy1 F10) +
// wx1 * (wy0 F01 + wy1 F11), accumulated in float32 and rounded once to the
// output type.  The file is built with --fmad=false, so the centres, the
// weights and the sums round exactly as the plain version
// (radnet_torch/ops/roi_align.py::roi_pool_plain) does.
//
// Bound on this card: bytes.  At the main path's shape (12 tiles, 38 x 38 x
// 1024 bf16, 300 RoIs, P = 7) it writes 361 MB and reads a 35.5 MB map that
// L2 holds, about 118 us at 3.35 TB/s; the ~9 float operations per output
// value come to about 24 us.
//
// Design: one block per (tile, RoI, output row, output column); the block
// computes the two centres and four weights once, and its threads walk the
// channels, 16 bytes a thread (8 bf16 or 4 f32), so neighbouring threads read
// and write neighbouring addresses.  A channel count that is not a multiple
// of the vector width takes the scalar loop.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Taps {
  int i0, i1;
  float w0, w1;
};

// Clamped half-pixel sample centre along one axis and its two taps.
__device__ __forceinline__ Taps axis_taps(float origin, float size, int p, int pool,
                                          int stride, int extent) {
  const float s = fmaxf(size, 1.0f);
  const float grid = __fdiv_rn(__fadd_rn((float)(p * stride), 0.5f), (float)(pool * stride));
  float c = __fadd_rn(origin, fmaxf(__fsub_rn(__fmul_rn(grid, s), 0.5f), 0.0f));
  c = fminf(c, __fsub_rn(__fadd_rn(origin, s), 1.0f));
  c = fminf(fmaxf(c, 0.0f), (float)(extent - 1));
  const float f0 = floorf(c);
  const float f1 = __fadd_rn(f0, 1.0f);
  Taps t;
  t.w0 = fmaxf(__fsub_rn(1.0f, fabsf(__fsub_rn(c, f0))), 0.0f);
  t.w1 = fmaxf(__fsub_rn(1.0f, fabsf(__fsub_rn(c, f1))), 0.0f);
  t.i0 = (int)f0;
  t.i1 = min((int)f1, extent - 1);
  return t;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float bilerp(float f00, float f10, float f01, float f11,
                                        const Taps& ty, const Taps& tx) {
  const float r0 = __fadd_rn(__fmul_rn(ty.w0, f00), __fmul_rn(ty.w1, f10));
  const float r1 = __fadd_rn(__fmul_rn(ty.w0, f01), __fmul_rn(ty.w1, f11));
  return __fadd_rn(__fmul_rn(tx.w0, r0), __fmul_rn(tx.w1, r1));
}

// 16 bytes of T: 8 bf16 or 4 f32.
template <typename T>
struct alignas(16) Pack {
  static constexpr int kN = 16 / sizeof(T);
  T v[kN];
};

template <typename T>
__global__ void roi_pool_kernel(const T* __restrict__ fmap, const float* __restrict__ rois,
                                T* __restrict__ out, int H, int W, int C, int R, int P,
                                int stride) {
  // blockIdx.x = ((b * R + r) * P + py) * P + px
  const int cell = blockIdx.x;
  const int px = cell % P;
  const int py = (cell / P) % P;
  const int br = cell / (P * P);
  const int b = br / R;

  const float* roi = rois + (size_t)br * 4;
  const Taps tx = axis_taps(roi[0], roi[2], px, P, stride, W);
  const Taps ty = axis_taps(roi[1], roi[3], py, P, stride, H);

  const T* base = fmap + (size_t)b * H * W * C;
  const T* p00 = base + ((size_t)ty.i0 * W + tx.i0) * C;
  const T* p01 = base + ((size_t)ty.i0 * W + tx.i1) * C;
  const T* p10 = base + ((size_t)ty.i1 * W + tx.i0) * C;
  const T* p11 = base + ((size_t)ty.i1 * W + tx.i1) * C;
  T* o = out + (size_t)cell * C;

  constexpr int kN = Pack<T>::kN;
  if (C % kN == 0) {
    for (int c = threadIdx.x * kN; c < C; c += blockDim.x * kN) {
      const Pack<T> a = *reinterpret_cast<const Pack<T>*>(p00 + c);
      const Pack<T> bq = *reinterpret_cast<const Pack<T>*>(p10 + c);
      const Pack<T> d = *reinterpret_cast<const Pack<T>*>(p01 + c);
      const Pack<T> e = *reinterpret_cast<const Pack<T>*>(p11 + c);
      Pack<T> res;
#pragma unroll
      for (int k = 0; k < kN; ++k)
        res.v[k] = from_f32<T>(bilerp(to_f32(a.v[k]), to_f32(bq.v[k]), to_f32(d.v[k]),
                                      to_f32(e.v[k]), ty, tx));
      *reinterpret_cast<Pack<T>*>(o + c) = res;
    }
  } else {
    for (int c = threadIdx.x; c < C; c += blockDim.x)
      o[c] = from_f32<T>(bilerp(to_f32(p00[c]), to_f32(p10[c]), to_f32(p01[c]),
                                to_f32(p11[c]), ty, tx));
  }
}

template <typename T>
int launch(const void* fmap, const void* rois, void* out, int B, int H, int W, int C, int R,
           int P, int stride, cudaStream_t stream) {
  const long long cells = (long long)B * R * P * P;
  if (cells == 0 || C == 0) return 0;
  if (cells > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  constexpr int kN = Pack<T>::kN;
  const int lanes = (C % kN == 0) ? C / kN : C;
  int threads = ((lanes + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > 256 ? 256 : threads);
  roi_pool_kernel<T><<<(unsigned)cells, threads, 0, stream>>>(
      (const T*)fmap, (const float*)rois, (T*)out, H, W, C, R, P, stride);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.
extern "C" int radnet_earlier_roi_pool(const void* fmap, const void* rois, void* out, int B, int H,
                               int W, int C, int R, int P, int stride, int dtype,
                               void* stream) {
  if (dtype == 0)
    return launch<float>(fmap, rois, out, B, H, W, C, R, P, stride, (cudaStream_t)stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(fmap, rois, out, B, H, W, C, R, P, stride,
                                 (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* radnet_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
