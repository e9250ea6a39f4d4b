// Gradient of bilinear crop-and-resize RoI pooling with respect to the
// feature map, written for Hopper (sm_90a).
//
// Replaces: the autodiff of radnet_tpu/ops/roi_align.py::roi_pool_matmul
// (roi_align.py:121-153), which XLA derives from the two einsums; the JAX
// package has no Pallas kernel for it.
//
// grad_out (B, R, P, P, C) channels-contiguous, bf16 or f32; rois (B, R, 4)
// xywh f32 in feature units; grad_map (B, H, W, C) in grad_out's type (the
// map's), every element written by the kernel: no zero fill before it and
// no cast after it.  The forward (roi_pool.cu) gives cell (py, px) the value
// wx0 * (wy0 F00 + wy1 F10) + wx1 * (wy0 F01 + wy1 F11); its gradient g goes
// back as wy0 * (wx0 * g) to (y0, x0), wy1 * (wx0 * g) to (y1, x0),
// wy0 * (wx1 * g) to (y0, x1) and wy1 * (wx1 * g) to (y1, x1).  The taps and
// weights come from the forward's own axis_taps (roi_taps.cuh), and the file
// is built with --fmad=false, so they equal the forward's bit for bit and
// the products round as the plain version (radnet_torch/ops/roi_align.py::
// roi_pool_backward_plain) rounds them; the sums are taken in float32 in
// another fixed order than its index_add_, and rounded once to the output
// type.
//
// Bound on this card: bytes.  At the training shape (8 tiles, 20 RoIs, P = 7,
// 38 x 38 x 1024 bf16) it reads 16.1 MB of gradient and writes the map's
// gradient once, 23.7 MB in bf16.
//
// Design: each output element is summed and written once, by its owner; no
// atomics.  One block per (tile b, map row h, 512 bytes of channels) keeps
// the float32 sums of row h's W columns for its channels in shared memory.
// Its eight warps split the columns (warp k owns the columns equal to k mod
// 8) and lane v owns the v-th 16-byte channel vector of each, so every sum
// has one thread that zeroes it, adds into it and writes it.  The block
// walks the tile's RoIs in rounds of 256 / P: a thread per (RoI, p)
// computes row tap p and column tap p (the forward's axis_taps), and the row
// taps that land on h are listed in (RoI, py) order by a ballot: i0 == h
// adds with wy0, i1 == h with wy1, and both where the clamp puts i1 on i0.
// The P cells of the listed rows are then streamed through shared memory in
// stages of 24 cells, double-buffered with cp.async so the next stage's
// reads are in flight while this one is summed; beside each cell the stage
// holds its column taps and row weights.  Every warp walks the stage's cells
// in order, and for a cell whose column taps it owns (a bit mask a warp,
// made by ballots as the stage is filled) adds wy * (wx * g) into those
// columns, keeping a column's sums in registers while the adds stay on it
// (a RoI clamped at the map's edge puts all its cells on one column).  So
// the reads of a row are many and in flight together, the adds read only
// shared memory, and every sum is taken in one fixed order: two launches
// give the same bits.  A cell is read by the row blocks of its two row
// taps, which are neighbours in launch order, so the second read can find
// it in L2.  Rows no RoI touches are written as zeros.
//
// What holds it back (scripts/roi_backward_probe.py on an H100): not bytes
// but the sums; a row block takes 1.0-1.5 us more for each row tap it lists,
// so the rows that many RoIs share (at the map's clamped edges, where every
// tap of a RoI past the border lands) finish last and set the kernel's time.
// Splitting such a row's list over the blocks of a cluster, summed in a
// fixed order, is the next step (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "roi_taps.cuh"  // the forward's own taps and weights

namespace {

using namespace radnet_roi;

constexpr int kRowChunkBytes = 512;  // channels of a block: 256 bf16 or 128 f32
constexpr int kLanes = 32;           // 16-byte vectors of a chunk: a warp spans one column
constexpr int kGroups = 8;           // warp k owns the columns k mod kGroups
constexpr int kBlock = kLanes * kGroups;
constexpr int kStageCells = 24;      // cells a stage streams in
// The float32 row may take this much of the 227 KB a block can address; the
// static arrays below take the rest.
constexpr int kMaxRowSmem = 192 * 1024;
static_assert(kRowChunkBytes == 16 * kLanes && (kGroups & (kGroups - 1)) == 0, "layout");
static_assert(kStageCells <= 32, "a stage's cells are the lanes of one warp");

struct Entry {  // a row tap on h
  int tap;      // (r - r0) * P + py: RoI r of the round from r0
  int flags;    // bit 0: i0 == h, bit 1: i1 == h
  float wy0, wy1;
};

struct CellMeta {  // a staged cell: its column taps and its row's weights on h
  Taps x;
  float wy0, wy1;
  int flags, pad;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void from_f32(float* d, float v) { *d = v; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* d, float v) { *d = __float2bfloat16_rn(v); }

// A lane's float32 sums of one owned column, kept in registers while
// consecutive adds land on that column (a RoI clamped at the map's edge puts
// all its cells there) and written back to the row when they move on; the
// sums are the same, in the same order, as adding in shared memory.
template <typename T>
struct ColumnSums {
  static constexpr int kN = Pack<T>::kN;
  static constexpr int kQ = kN / 4;
  float4* row;  // this lane's channels of column 0; column j at row + j * kQ * kLanes
  int col = -1;
  float4 s[kQ];

  __device__ __forceinline__ void flush() {
    if (col >= 0) {
#pragma unroll
      for (int q = 0; q < kQ; ++q) row[(col * kQ + q) * kLanes] = s[q];
    }
  }
  // s += wy * gx on column j, where gx = wx * g.
  __device__ __forceinline__ void add(int j, float wy, const float (&gx)[kN]) {
    if (j != col) {
      flush();
      col = j;
#pragma unroll
      for (int q = 0; q < kQ; ++q) s[q] = row[(col * kQ + q) * kLanes];
    }
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      s[q].x = __fadd_rn(s[q].x, __fmul_rn(wy, gx[4 * q + 0]));
      s[q].y = __fadd_rn(s[q].y, __fmul_rn(wy, gx[4 * q + 1]));
      s[q].z = __fadd_rn(s[q].z, __fmul_rn(wy, gx[4 * q + 2]));
      s[q].w = __fadd_rn(s[q].w, __fmul_rn(wy, gx[4 * q + 3]));
    }
  }
};

template <typename T>
__device__ __forceinline__ void times(float (&gx)[Pack<T>::kN], float wx, const Pack<T>& g) {
#pragma unroll
  for (int k = 0; k < Pack<T>::kN; ++k) gx[k] = __fmul_rn(wx, to_f32(g.v[k]));
}

template <typename T>
__global__ void __launch_bounds__(kBlock)
roi_pool_backward_kernel(const T* __restrict__ grad_out, const float* __restrict__ rois,
                         T* __restrict__ grad_map, int H, int W, int C, int R, int P,
                         int stride, int n_chunks) {
  constexpr int kN = Pack<T>::kN;
  constexpr int kQ = kN / 4;  // float4s of a lane's vector
  constexpr int kChunkC = kRowChunkBytes / (int)sizeof(T);
  extern __shared__ float4 row[];  // [W][kQ][kLanes]: row h's float32 sums
  __shared__ int4 stage[2][kStageCells][kLanes];
  __shared__ CellMeta meta[2][kStageCells];
  __shared__ unsigned owned[2][kGroups];  // bit c: warp k owns a column tap of cell c
  __shared__ Taps tx[kBlock];  // the round's column taps, (RoI, px)
  __shared__ Entry listed[kBlock];
  __shared__ int warp_count[kGroups];

  const int chunk = blockIdx.x % n_chunks;
  const int bh = blockIdx.x / n_chunks;  // b * H + h
  const int h = bh % H;
  const int b = bh / H;
  const int tid = threadIdx.x;
  const int lane = tid % kLanes;
  const int grp = tid / kLanes;
  const int c0 = chunk * kChunkC;
  const bool active = lane * kN < min(kChunkC, C - c0);

  for (int col = grp; col < W; col += kGroups) {
#pragma unroll
    for (int q = 0; q < kQ; ++q) row[(col * kQ + q) * kLanes + lane] = make_float4(0, 0, 0, 0);
  }

  ColumnSums<T> sums;
  sums.row = row + lane;
  const float* roi_b = rois + (size_t)b * R * 4;
  const T* g_b = grad_out + (size_t)b * R * P * P * C + c0 + lane * kN;
  const int per_round = kBlock / P;  // RoIs a round; P <= 32
  for (int r0 = 0; r0 < R; r0 += per_round) {
    // This round's row and column taps, a lane each; list the row taps on h
    // in (RoI, py) order.
    const int n_taps = min(per_round, R - r0) * P;
    Entry mine{tid, 0, 0.f, 0.f};
    if (tid < n_taps) {
      const int rr = tid / P, p = tid - rr * P;
      const float* roi = roi_b + (size_t)(r0 + rr) * 4;
      const Taps y = axis_taps(roi[1], roi[3], p, P, stride, H);
      tx[tid] = axis_taps(roi[0], roi[2], p, P, stride, W);
      mine.flags = (y.i0 == h) | ((y.i1 == h) << 1);
      mine.wy0 = y.w0;
      mine.wy1 = y.w1;
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, mine.flags != 0);
    if (lane == 0) warp_count[grp] = __popc(ballot);
    __syncthreads();
    int at = __popc(ballot & ((1u << lane) - 1u)), n_listed = 0;
#pragma unroll
    for (int k = 0; k < kGroups; ++k) {
      const int n = warp_count[k];
      at += k < grp ? n : 0;
      n_listed += n;
    }
    if (mine.flags) listed[at] = mine;
    __syncthreads();

    // Stream the listed rows' cells through shared memory, one stage ahead.
    const int n_cells = n_listed * P;
    auto stage_in = [&](int k0, int buf) {
      const int n = min(kStageCells, n_cells - k0);
      for (int c = grp; c < n; c += kGroups) {  // warp grp copies cells grp, grp + 8, ...
        const int e = (k0 + c) / P;
        const int px = k0 + c - e * P;
        if (active)
          cp_async16(&stage[buf][c][lane], g_b + ((size_t)(r0 * P + listed[e].tap) * P + px) * C);
      }
      if (grp == 0) {  // warp 0: a lane per cell, kStageCells <= 32
        int own0 = -1, own1 = -1;
        if (lane < n) {
          const int e = (k0 + lane) / P;
          const int px = k0 + lane - e * P;
          const Entry en = listed[e];
          const Taps x = tx[en.tap - en.tap % P + px];
          meta[buf][lane] = CellMeta{x, en.wy0, en.wy1, en.flags, 0};
          own0 = x.i0 & (kGroups - 1);
          own1 = x.i1 & (kGroups - 1);
        }
#pragma unroll
        for (int k = 0; k < kGroups; ++k) {
          const unsigned bits = __ballot_sync(0xffffffffu, own0 == k || own1 == k);
          if (lane == 0) owned[buf][k] = bits;
        }
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    };
    if (n_cells > 0) stage_in(0, 0);
    for (int k0 = 0, buf = 0; k0 < n_cells; k0 += kStageCells, buf ^= 1) {
      if (k0 + kStageCells < n_cells) {
        stage_in(k0 + kStageCells, buf ^ 1);
        asm volatile("cp.async.wait_group 1;\n" ::: "memory");
      } else {
        asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      }
      __syncthreads();
      for (unsigned bits = owned[buf][grp]; bits; bits &= bits - 1) {  // in cell order
        const int c = __ffs(bits) - 1;
        const CellMeta m = meta[buf][c];
        const bool own0 = (m.x.i0 & (kGroups - 1)) == grp;
        const bool own1 = (m.x.i1 & (kGroups - 1)) == grp;
        const int4 raw = stage[buf][c][lane];
        const Pack<T> gp = *reinterpret_cast<const Pack<T>*>(&raw);
        float gx0[kN], gx1[kN];
        if (own0) times(gx0, m.x.w0, gp);
        if (own1) times(gx1, m.x.w1, gp);
        if (m.flags & 1) {
          if (own0) sums.add(m.x.i0, m.wy0, gx0);
          if (own1) sums.add(m.x.i1, m.wy0, gx1);
        }
        if (m.flags & 2) {
          if (own0) sums.add(m.x.i0, m.wy1, gx0);
          if (own1) sums.add(m.x.i1, m.wy1, gx1);
        }
      }
      __syncthreads();  // the buffer is refilled two stages on
    }
  }

  sums.flush();
  if (!active) return;
  T* out = grad_map + ((size_t)b * H + h) * W * C + c0 + lane * kN;
  for (int col = grp; col < W; col += kGroups) {
    Pack<T> o;
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const float4 s = row[(col * kQ + q) * kLanes + lane];
      from_f32(&o.v[4 * q + 0], s.x);
      from_f32(&o.v[4 * q + 1], s.y);
      from_f32(&o.v[4 * q + 2], s.z);
      from_f32(&o.v[4 * q + 3], s.w);
    }
    *reinterpret_cast<int4*>(out + (size_t)col * C) = *reinterpret_cast<const int4*>(&o);
  }
}

template <typename T>
int launch(const void* grad_out, const void* rois, void* grad_map, int B, int H, int W, int C,
           int R, int P, int stride, cudaStream_t stream) {
  constexpr int kN = Pack<T>::kN;
  constexpr int kChunkC = kRowChunkBytes / (int)sizeof(T);
  if ((long long)B * H * W == 0 || C == 0) return 0;
  if (C % kN != 0 || P < 1 || P > kMaxPool || R < 0 || stride < 1)
    return (int)cudaErrorInvalidValue;
  if ((long long)W * kChunkC * sizeof(float) > kMaxRowSmem) return (int)cudaErrorInvalidValue;
  const int smem = W * kChunkC * (int)sizeof(float);
  const int n_chunks = (C + kChunkC - 1) / kChunkC;
  const long long blocks = (long long)B * H * n_chunks;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  // The static arrays take ~30 KB, so the row passes the default 48 KB in
  // all: raise the kernel's limit, once a device for each larger row.
  static int allowed[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64 || smem > allowed[dev]) {
    err = cudaFuncSetAttribute(roi_pool_backward_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) allowed[dev] = smem;
  }
  roi_pool_backward_kernel<T><<<(unsigned)blocks, kBlock, smem, stream>>>(
      (const T*)grad_out, (const float*)rois, (T*)grad_map, H, W, C, R, P, stride, n_chunks);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype of grad_out and grad_map: 0 = float32, 1 = bfloat16.
extern "C" int radnet_roi_pool_backward(const void* grad_out, const void* rois, void* grad_map,
                                        int B, int H, int W, int C, int R, int P, int stride,
                                        int dtype, void* stream) {
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
