// The earlier design of the NMS (csrc/nms_fused.cu now): the (B, N, N) byte
// relation in device memory, iterated by a host loop that synchronises every
// round.  Not on any path of the package: chip_smoke.py builds it and times
// the whole call it served beside the fused kernel on the same inputs.
//
// NMS dominance relation for the fixed-point NMS, written for Hopper (sm_90a).
//
// Replaces: radnet_tpu/ops/pallas_nms.py, _dominates_kernel / dominates_matrix.
//
// Computes, for every tile b and every pair (i, j) of its N candidates,
//   dom[b, i, j] = iou(box_i, box_j) > thresh  and
//                  (s_j > s_i  or  (s_j == s_i and j > i))
// with iou = inter / (area_i + area_j - inter + 1e-6) and IoU 0 for a
// degenerate box, in the same float32 operation order as the plain version
// (radnet_torch/ops/nms.py::dominates_plain).  The file is built with
// --fmad=false and the division is written as __fdiv_rn, so no multiply-add
// contraction or reassociation can move a knife-edge comparison: the output
// equals the plain version bit for bit.
//
// Bound on this card: the (B, N, N) byte output.  At the proposal NMS
// (12 x 2048) it writes 50.3 MB against 0.2 MB of input, about 15 us at
// 3.35 TB/s; the ~16 float operations per pair come to about 12 us at the
// card's 67 TFLOP/s of non-tensor float32.
//
// Design: one block per (tile, 32-row block, 256-column block).  The 32 row
// boxes and scores are staged in shared memory (each is read by every
// thread); each thread holds one column box in registers and walks the 32
// rows, so each warp stores 32 consecutive output bytes of a row at a time
// (full 32-byte sectors).  The rounded division, the costliest step, runs
// only for a pair that outranks and overlaps; any other pair's IoU is
// exactly 0 or irrelevant.  Rows and columns past N are masked, so any N
// works.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 32;
constexpr int kCols = 256;

__global__ void __launch_bounds__(kCols)
dominance_kernel(const float4* __restrict__ boxes, const float* __restrict__ scores,
                 uint8_t* __restrict__ out, int n, float thresh) {
  const int b = blockIdx.z;
  const int row0 = blockIdx.y * kRows;
  const int j = blockIdx.x * kCols + threadIdx.x;

  __shared__ float4 rbox[kRows];
  __shared__ float rarea[kRows];
  __shared__ float rscore[kRows];
  __shared__ bool rvalid[kRows];

  const float4* tb = boxes + (size_t)b * n;
  const float* ts = scores + (size_t)b * n;
  if (threadIdx.x < kRows) {
    const int i = row0 + threadIdx.x;
    float4 r = make_float4(0.f, 0.f, 0.f, 0.f);
    float s = 0.f;
    if (i < n) {
      r = tb[i];
      s = ts[i];
    }
    rbox[threadIdx.x] = r;
    rarea[threadIdx.x] = __fmul_rn(__fsub_rn(r.z, r.x), __fsub_rn(r.w, r.y));
    rscore[threadIdx.x] = s;
    rvalid[threadIdx.x] = (r.z > r.x) && (r.w > r.y);
  }
  __syncthreads();
  if (j >= n) return;

  const float4 c = tb[j];
  const float sc = ts[j];
  const float carea = __fmul_rn(__fsub_rn(c.z, c.x), __fsub_rn(c.w, c.y));
  const bool cvalid = (c.z > c.x) && (c.w > c.y);
  uint8_t* orow = out + ((size_t)b * n + row0) * n + j;
  const int rows = min(kRows, n - row0);

  for (int r = 0; r < rows; ++r) {
    const float sr = rscore[r];
    const bool higher = (sc > sr) || (sc == sr && j > row0 + r);
    bool dom = false;
    if (higher && rvalid[r] && cvalid) {
      const float4 a = rbox[r];
      const float iw = fmaxf(__fsub_rn(fminf(a.z, c.z), fmaxf(a.x, c.x)), 0.f);
      const float ih = fmaxf(__fsub_rn(fminf(a.w, c.w), fmaxf(a.y, c.y)), 0.f);
      const float inter = __fmul_rn(iw, ih);
      // Two valid boxes have union + 1e-6 > 0, so inter == 0 gives IoU +0
      // exactly: the division only runs for overlapping pairs.
      if (inter > 0.f) {
        const float uni = __fsub_rn(__fadd_rn(rarea[r], carea), inter);
        dom = __fdiv_rn(inter, __fadd_rn(uni, 1e-6f)) > thresh;
      } else {
        dom = 0.f > thresh;
      }
    }
    orow[(size_t)r * n] = (uint8_t)dom;
  }
}

}  // namespace

extern "C" int radnet_nms_dominance(const void* boxes, const void* scores, void* out,
                                    int batch, int n, float thresh, void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  dim3 grid((n + kCols - 1) / kCols, (n + kRows - 1) / kRows, batch);
  dominance_kernel<<<grid, kCols, 0, (cudaStream_t)stream>>>(
      (const float4*)boxes, (const float*)scores, (uint8_t*)out, n, thresh);
  return (int)cudaGetLastError();
}

extern "C" const char* radnet_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
