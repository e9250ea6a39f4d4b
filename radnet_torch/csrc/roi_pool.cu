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
// so each cell reads four taps: out = wx0 * (wy0 F00 + wy1 F10) +
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
// Design: one block per (tile, RoI, chunk of 1024 bytes of channels: 512
// bf16 or 256 f32), 12 * 300 * 2 = 7200 blocks at the main path's shape.  The
// block computes the P row taps and P column taps once into shared memory;
// each thread then keeps one 16-byte channel vector and walks its share of
// the P * P cells, reading the four taps with ld.global.nc.  Neighbouring
// cells of a RoI narrower than about 2P feature units share taps, and the
// block's whole footprint (at most 2P x 2P pixels of its chunk: 196 KB at
// P = 7, far less for most RoIs) can stay in L1, so repeated taps hit L1.  Results go out with
// streaming stores (__stcs), so the output, ten times the map, does not evict
// the map from L2.  Measured on the card, this beat staging the distinct
// pixels in shared memory with cp.async first (the block then waits for all
// of them before computing any cell), and 1024-byte chunks on 128 threads
// beat 256-byte chunks on 256 (PERF.md).  The channel count must be a
// multiple of 16 bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "roi_taps.cuh"  // Taps, axis_taps, roi_taps, Pack: shared with the backward

namespace {

using namespace radnet_roi;

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
roi_pool_kernel(const T* __restrict__ fmap, const float* __restrict__ rois,
                T* __restrict__ out, int H, int W, int C, int R, int P, int stride,
                int n_chunks) {
  __shared__ Taps ty[kMaxPool], tx[kMaxPool];
  const int chunk = blockIdx.x % n_chunks;
  const int br = blockIdx.x / n_chunks;  // b * R + r
  const int b = br / R;
  const int tid = threadIdx.x;
  roi_taps(rois + (size_t)br * 4, P, stride, H, W, ty, tx);
  __syncthreads();

  constexpr int kN = Pack<T>::kN;
  constexpr int kChunkC = kChunkBytes / (int)sizeof(T);
  constexpr int kVecs = kChunkBytes / 16;        // 16-byte vectors of a full chunk
  constexpr int kGroups = kThreads / kVecs;      // threads that share a vector index
  const int c0 = chunk * kChunkC;
  const int nv = min(kChunkC, C - c0) / kN;      // vectors in this chunk
  const int v = tid % kVecs, grp = tid / kVecs;  // each thread keeps one vector index
  if (v >= nv) return;
  const T* base = fmap + (size_t)b * H * W * C + c0 + v * kN;
  T* o = out + (size_t)br * P * P * C + c0 + v * kN;
  for (int cell = grp; cell < P * P; cell += kGroups) {
    const int py = cell / P;
    const int px = cell - py * P;
    const Taps y = ty[py], x = tx[px];
    const size_t r0 = (size_t)y.i0 * W, r1 = (size_t)y.i1 * W;
    const Pack<T> a = ldg_pack(base + (r0 + x.i0) * C);
    const Pack<T> bq = ldg_pack(base + (r1 + x.i0) * C);
    const Pack<T> d = ldg_pack(base + (r0 + x.i1) * C);
    const Pack<T> e = ldg_pack(base + (r1 + x.i1) * C);
    Pack<T> res;
#pragma unroll
    for (int k = 0; k < kN; ++k)
      res.v[k] = from_f32<T>(
          bilerp(to_f32(a.v[k]), to_f32(bq.v[k]), to_f32(d.v[k]), to_f32(e.v[k]), y, x));
    __stcs(reinterpret_cast<int4*>(o + (size_t)cell * C), *reinterpret_cast<const int4*>(&res));
  }
}

template <typename T>
int launch(const void* fmap, const void* rois, void* out, int B, int H, int W, int C, int R,
           int P, int stride, cudaStream_t stream) {
  constexpr int kN = Pack<T>::kN;
  constexpr int kChunkC = kChunkBytes / (int)sizeof(T);
  if ((long long)B * R == 0 || C == 0) return 0;
  if (C % kN != 0 || P < 1 || P > kMaxPool || H < 1 || W < 1 || stride < 1)
    return (int)cudaErrorInvalidValue;
  const int n_chunks = (C + kChunkC - 1) / kChunkC;
  const long long blocks = (long long)B * R * n_chunks;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  roi_pool_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      (const T*)fmap, (const float*)rois, (T*)out, H, W, C, R, P, stride, n_chunks);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.
extern "C" int radnet_roi_pool(const void* fmap, const void* rois, void* out, int B, int H,
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
