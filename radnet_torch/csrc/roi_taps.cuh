// The sample taps of bilinear crop-and-resize RoI pooling, shared by the
// forward (roi_pool.cu) and its gradient (roi_pool_backward.cu).  The
// gradient is right only if both read the same taps with bit-equal weights,
// so both include this one definition and both are built with --fmad=false,
// which makes the weights round as radnet_torch/ops/roi_align.py::_taps does.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace radnet_roi {

constexpr int kThreads = 128;
constexpr int kChunkBytes = 1024;  // 512 bf16 or 256 f32 channels
constexpr int kMaxPool = 32;       // a warp's lanes compute the taps of an axis

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

// One RoI's P row taps and P column taps into shared memory: lanes 0..P-1 of
// warp 0 compute the rows, lanes 0..P-1 of warp 1 the columns.  The caller
// synchronises the block before reading them.
__device__ __forceinline__ void roi_taps(const float* roi, int P, int stride, int H, int W,
                                         Taps* ty, Taps* tx) {
  const int tid = threadIdx.x;
  if (tid < P) {
    ty[tid] = axis_taps(roi[1], roi[3], tid, P, stride, H);
  } else if (tid >= 32 && tid < 32 + P) {
    tx[tid - 32] = axis_taps(roi[0], roi[2], tid - 32, P, stride, W);
  }
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// 16 bytes of T: 8 bf16 or 4 f32.
template <typename T>
struct alignas(16) Pack {
  static constexpr int kN = 16 / sizeof(T);
  T v[kN];
};

template <typename T>
__device__ __forceinline__ Pack<T> ldg_pack(const T* p) {
  const int4 raw = __ldg(reinterpret_cast<const int4*>(p));
  return *reinterpret_cast<const Pack<T>*>(&raw);
}

}  // namespace radnet_roi
