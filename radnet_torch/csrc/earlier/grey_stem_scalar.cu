// The earlier design of csrc/grey_stem.cu (products on the CUDA cores in
// float32, reading the full float32 centring map).  Not on any path of the
// package: chip_smoke.py builds it and times it beside the current kernel
// on the same inputs, so the two are compared within one run.
//
// Fused ResNet50 stem on grey canvases, written for Hopper (sm_90a).
//
// Replaces: radnet_tpu/ops/pallas_stem.py, _stem_kernel / GreyStem.
//
// grey (B, S, S) uint8; k7 (49, 64) f32, the channel-summed 7x7 kernel (already
// rounded to bf16 values for a bf16 output); b0 (CH, CH, 64) f32, the folded
// bias and centring map; scale (64,) f32, the frozen batch norm's scale; out
// (B, PH, PH, 64) in f32 or bf16, channels last.  With the canvas read as
// zero-padded by 3 on every side (the ZeroPadding2D ring), for conv output
// (i, j) and channel o:
//
//   z[i, j, o] = relu(scale[o] * sum_{dy, dx} g[2i + dy, 2j + dx] k7[dy * 7 + dx, o]
//                     + b0[i, j, o])
//   out[p, q, o] = max over conv rows 2p..2p+2 and columns 2q..2q+2 of z,
//
// rounded once to the output type (rounding commutes with the max).  CH =
// (S - 1) / 2 + 1 and PH = (CH - 3) / 2 + 1: 304 and 151 for a 608 canvas, so
// the last conv row and column are never read by the pool.  Grey values are
// integers up to 255, so with bf16 weights every product is exact in float32
// and only the order of the 49-term sum differs from the plain version
// (radnet_torch/ops/grey_stem.py::grey_stem_plain).
//
// Bound on this card: bytes.  At the main path's shape (12 canvases of 608)
// it reads 4.4 MB of canvases and the 23.7 MB map and writes 35.0 MB of bf16,
// about 19 us at 3.35 TB/s; its 6.96 GFLOP take 7 us at the bf16 tensor-core
// rate.  This first version runs the products on the CUDA cores in float32.
//
// Design: one block per (canvas, band of kTP pool rows, run of kQB pool
// columns).  The block stages the padded input slab its outputs read (4 kTP +
// 7 rows by 4 kQB + 7 columns) in shared memory as float32.  Each thread owns
// one output channel, keeps its 49 weights in registers, and walks kQT pool
// columns of the band: for each conv column it sums the 2 kTP + 1 conv rows of
// the band at once, so every shared-memory read feeds up to four rows, and it
// carries the last conv column into the next pool column, so every conv
// output of its run is computed once.  A warp's 32 threads read the same slab
// address (a broadcast) and write 32 neighbouring channels.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kC = 64;                 // stem output channels
constexpr int kTP = 4;                 // pool rows per block
constexpr int kQB = 32;                // pool columns per block
constexpr int kGroups = 4;             // column runs per block
constexpr int kThreads = kGroups * kC; // one thread per (run, channel)
constexpr int kQT = kQB / kGroups;     // pool columns per thread
constexpr int kRows = 2 * kTP + 1;     // conv rows per band
constexpr int kSlabH = 4 * kTP + 7;    // padded input rows per band
constexpr int kSlabW = 4 * kQB + 7;    // padded input columns per block

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// The band's kTP row-pooled values at conv column j: for pool row t, the max
// of relu(z) over conv rows 2t..2t+2 of the band.
__device__ __forceinline__ void pooled_column(const float (*slab)[kSlabW], const float* w,
                                              const float* __restrict__ b0, float sc, int j,
                                              int x0, int c0, int CH, int o, float* rp) {
  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
#pragma unroll
  for (int R = 0; R < kSlabH; ++R) {
#pragma unroll
    for (int dx = 0; dx < 7; ++dx) {
      const float v = slab[R][x0 + dx];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int dy = R - 2 * r;
        if (dy >= 0 && dy < 7) acc[r] = fmaf(v, w[dy * 7 + dx], acc[r]);
      }
    }
  }
  float z[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int c = c0 + r;
    // Rows past the map belong to no pool row that is written; relu >= 0,
    // so 0 leaves every max unchanged.
    z[r] = c < CH ? fmaxf(fmaf(acc[r], sc, __ldg(b0 + ((size_t)c * CH + j) * kC + o)), 0.0f)
                  : 0.0f;
  }
#pragma unroll
  for (int t = 0; t < kTP; ++t) rp[t] = fmaxf(fmaxf(z[2 * t], z[2 * t + 1]), z[2 * t + 2]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
grey_stem_kernel(const uint8_t* __restrict__ grey, const float* __restrict__ k7,
                 const float* __restrict__ b0, const float* __restrict__ scale,
                 T* __restrict__ out, int S, int CH, int PH) {
  __shared__ float slab[kSlabH][kSlabW];
  const int b = blockIdx.z;
  const int p0 = blockIdx.y * kTP;  // first pool row of the band
  const int q0 = blockIdx.x * kQB;  // first pool column of the block
  // Slab (r, x) is padded input (4 p0 + r, 4 q0 + x), i.e. canvas pixel
  // (4 p0 + r - 3, 4 q0 + x - 3), zero outside the canvas.
  const uint8_t* g = grey + (size_t)b * S * S;
  for (int i = threadIdx.x; i < kSlabH * kSlabW; i += kThreads) {
    const int r = i / kSlabW;
    const int x = i - r * kSlabW;
    const int gy = 4 * p0 + r - 3;
    const int gx = 4 * q0 + x - 3;
    float v = 0.0f;
    if (gy >= 0 && gy < S && gx >= 0 && gx < S) v = (float)g[(size_t)gy * S + gx];
    slab[r][x] = v;
  }
  __syncthreads();

  const int o = threadIdx.x % kC;
  const int qa = q0 + (threadIdx.x / kC) * kQT;
  const int qb = min(qa + kQT, PH);
  if (qa >= qb) return;
  float w[49];
#pragma unroll
  for (int k = 0; k < 49; ++k) w[k] = __ldg(k7 + k * kC + o);
  const float sc = __ldg(scale + o);
  const int c0 = 2 * p0;  // first conv row of the band

  // Conv column j reads slab columns 2 j - 4 q0 .. + 6.
  float prev[kTP], mid[kTP], next[kTP];
  pooled_column(slab, w, b0, sc, 2 * qa, 4 * qa - 4 * q0, c0, CH, o, prev);
  for (int q = qa; q < qb; ++q) {
    pooled_column(slab, w, b0, sc, 2 * q + 1, 4 * q + 2 - 4 * q0, c0, CH, o, mid);
    pooled_column(slab, w, b0, sc, 2 * q + 2, 4 * q + 4 - 4 * q0, c0, CH, o, next);
#pragma unroll
    for (int t = 0; t < kTP; ++t) {
      const int p = p0 + t;
      if (p < PH)
        out[(((size_t)b * PH + p) * PH + q) * kC + o] =
            from_f32<T>(fmaxf(fmaxf(prev[t], mid[t]), next[t]));
      prev[t] = next[t];
    }
  }
}

template <typename T>
int launch(const void* grey, const void* k7, const void* b0, const void* scale, void* out, int B,
           int S, cudaStream_t stream) {
  if (B <= 0 || S < 1) return (int)cudaErrorInvalidValue;
  const int CH = (S - 1) / 2 + 1;
  if (CH < 3) return (int)cudaErrorInvalidValue;
  const int PH = (CH - 3) / 2 + 1;
  const dim3 grid((PH + kQB - 1) / kQB, (PH + kTP - 1) / kTP, B);
  grey_stem_kernel<T><<<grid, kThreads, 0, stream>>>(
      (const uint8_t*)grey, (const float*)k7, (const float*)b0, (const float*)scale, (T*)out, S,
      CH, PH);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype of out: 0 = float32, 1 = bfloat16.
extern "C" int radnet_earlier_grey_stem(const void* grey, const void* k7, const void* b0,
                                const void* scale, void* out, int B, int S, int dtype,
                                void* stream) {
  if (dtype == 0) return launch<float>(grey, k7, b0, scale, out, B, S, (cudaStream_t)stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(grey, k7, b0, scale, out, B, S, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* radnet_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
