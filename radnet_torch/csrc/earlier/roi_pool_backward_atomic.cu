// The earlier design of csrc/roi_pool_backward.cu (float32 atomics into a
// zeroed map, cast to the map's type by the caller).  Not on any path of
// the package: chip_smoke.py builds it and times it beside the current
// kernel on the same inputs, so the two are compared within one run.
//
// Gradient of bilinear crop-and-resize RoI pooling with respect to the
// feature map, written for Hopper (sm_90a).
//
// Replaces: the autodiff of radnet_tpu/ops/roi_align.py::roi_pool_matmul
// (roi_align.py:121-153), which XLA derives from the two einsums; the JAX
// package has no Pallas kernel for it.
//
// grad_out (B, R, P, P, C) channels-contiguous, bf16 or f32; rois (B, R, 4)
// xywh f32 in feature units; grad_map (B, H, W, C) float32, zeroed by the
// caller.  The forward (roi_pool.cu) gives cell (py, px) the value
// wx0 * (wy0 F00 + wy1 F10) + wx1 * (wy0 F01 + wy1 F11); its gradient g goes
// back as wy0 * (wx0 * g) to (y0, x0), wy1 * (wx0 * g) to (y1, x0),
// wy0 * (wx1 * g) to (y0, x1) and wy1 * (wx1 * g) to (y1, x1).  The taps and
// weights are computed by the forward's own code (roi_taps.cuh, which the
// forward includes too), and the file is built with
// --fmad=false, so they equal the forward's bit for bit and the products
// round as the plain version (radnet_torch/ops/roi_align.py::
// roi_pool_backward_plain) rounds them; only the order of the sums differs.
//
// Bound on this card: bytes.  At the training shape (8 tiles, 20 RoIs, P = 7,
// 38 x 38 x 1024 bf16) it reads 16.1 MB of gradient and writes the map's
// gradient, 23.7 MB in bf16 (47.3 MB in the float32 accumulator).
//
// Design (simple first): one block per (tile, RoI, chunk of 1024 bytes of
// channels), as the forward.  The block computes its P row taps and P column
// taps once into shared memory; each thread keeps one 16-byte vector of
// channels and walks its share of the P * P cells, adding the four weighted
// values of each channel with atomicAdd into the float32 map.  RoIs that
// overlap on one figure contend on those atomics; nothing here orders or
// merges them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../roi_taps.cuh"  // the forward's own taps and weights

namespace {

using namespace radnet_roi;

template <typename T>
__global__ void __launch_bounds__(kThreads)
roi_pool_backward_atomic_kernel(const T* __restrict__ grad_out, const float* __restrict__ rois,
                         float* __restrict__ grad_map, int H, int W, int C, int R, int P,
                         int stride, int n_chunks) {
  __shared__ Taps ty[kMaxPool], tx[kMaxPool];
  const int chunk = blockIdx.x % n_chunks;
  const int br = blockIdx.x / n_chunks;  // b * R + r
  const int b = br / R;
  const int tid = threadIdx.x;
  roi_taps(rois + (size_t)br * 4, P, stride, H, W, ty, tx);
  __syncthreads();

  constexpr int kN = Pack<T>::kN;
  constexpr int kChunkC = kChunkBytes / (int)sizeof(T);
  constexpr int kVecs = kChunkBytes / 16;
  constexpr int kGroups = kThreads / kVecs;
  const int c0 = chunk * kChunkC;
  const int nv = min(kChunkC, C - c0) / kN;
  const int v = tid % kVecs, grp = tid / kVecs;
  if (v >= nv) return;
  const T* g = grad_out + (size_t)br * P * P * C + c0 + v * kN;
  float* base = grad_map + (size_t)b * H * W * C + c0 + v * kN;
  for (int cell = grp; cell < P * P; cell += kGroups) {
    const int py = cell / P;
    const int px = cell - py * P;
    const Taps y = ty[py], x = tx[px];
    const Pack<T> gp = ldg_pack(g + (size_t)cell * C);
    float* p00 = base + ((size_t)y.i0 * W + x.i0) * C;
    float* p10 = base + ((size_t)y.i1 * W + x.i0) * C;
    float* p01 = base + ((size_t)y.i0 * W + x.i1) * C;
    float* p11 = base + ((size_t)y.i1 * W + x.i1) * C;
#pragma unroll
    for (int k = 0; k < kN; ++k) {
      const float gv = to_f32(gp.v[k]);
      const float gx0 = __fmul_rn(x.w0, gv);
      const float gx1 = __fmul_rn(x.w1, gv);
      atomicAdd(p00 + k, __fmul_rn(y.w0, gx0));
      atomicAdd(p10 + k, __fmul_rn(y.w1, gx0));
      atomicAdd(p01 + k, __fmul_rn(y.w0, gx1));
      atomicAdd(p11 + k, __fmul_rn(y.w1, gx1));
    }
  }
}

template <typename T>
int launch(const void* grad_out, const void* rois, void* grad_map, int B, int H, int W, int C,
           int R, int P, int stride, cudaStream_t stream) {
  constexpr int kN = Pack<T>::kN;
  constexpr int kChunkC = kChunkBytes / (int)sizeof(T);
  if ((long long)B * R == 0 || C == 0) return 0;
  if (C % kN != 0 || P < 1 || P > kMaxPool || H < 1 || W < 1 || stride < 1)
    return (int)cudaErrorInvalidValue;
  const int n_chunks = (C + kChunkC - 1) / kChunkC;
  const long long blocks = (long long)B * R * n_chunks;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  roi_pool_backward_atomic_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      (const T*)grad_out, (const float*)rois, (float*)grad_map, H, W, C, R, P, stride, n_chunks);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype of grad_out: 0 = float32, 1 = bfloat16.  grad_map is float32.
extern "C" int radnet_earlier_roi_pool_backward(const void* grad_out, const void* rois,
                                                void* grad_map, int B, int H, int W, int C,
                                                int R, int P, int stride, int dtype,
                                                void* stream) {
  if (dtype == 0)
    return launch<float>(grad_out, rois, grad_map, B, H, W, C, R, P, stride,
                         (cudaStream_t)stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(grad_out, rois, grad_map, B, H, W, C, R, P, stride,
                                 (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* radnet_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
