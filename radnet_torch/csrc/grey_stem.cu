// Fused ResNet50 stem on grey canvases, written for Hopper (sm_90a).
//
// Replaces: radnet_tpu/ops/pallas_stem.py, _stem_kernel / GreyStem.
//
// grey (B, S, S) uint8; w (NP, 64, 64) bf16, the channel-summed 7x7 kernel k7
// as NP bf16 pieces that sum to it exactly in float32, laid out [piece,
// channel, dy * 8 + dx] with zeros at dx == 7 and dy == 7; table (K, K, 64)
// f32 and cls (CH,) int32, the folded bias and centring map as a table over
// the K distinct tap patterns of a conv row or column: b0[i, j, o] =
// table[cls[i], cls[j], o]; scale (64,) f32, the frozen batch norm's scale;
// out (B, PH, PH, 64) in f32 or bf16, channels last.  With the canvas read as
// zero-padded by 3 on every side (the ZeroPadding2D ring), for conv output
// (i, j) and channel o:
//
//   z[i, j, o] = relu(scale[o] * sum_{dy, dx} g[2i + dy, 2j + dx] k7[dy * 7 + dx, o]
//                     + b0[i, j, o])
//   out[p, q, o] = max over conv rows 2p..2p+2 and columns 2q..2q+2 of z,
//
// rounded once to the output type (rounding is monotone, so it commutes with
// the max).  CH = (S - 1) / 2 + 1 and PH = (CH - 3) / 2 + 1: 304 and 151 for a
// 608 canvas.  Grey values are integers up to 255, exact in bf16, and each
// piece has 8 significant bits, so every product is exact in float32; the
// result differs from the plain version (radnet_torch/ops/grey_stem.py::
// grey_stem_plain) only in the order of the sum, which the tensor cores
// accumulate, and in scale and bias taking one rounding (an FMA) where the
// plain version takes two.  A bf16 output takes one piece (k7 is
// bf16-valued), a float32 output three.
//
// Bound on this card: bytes.  At the main path's shape (12 canvases of 608,
// bf16) it reads 4.4 MB of canvases and writes 35.0 MB, about 12 us at
// 3.35 TB/s; its 6.96 GFLOP take 7 us at the bf16 tensor-core rate.
//
// Design: one block per (canvas, band of kTP pool rows, run of kTQ pool
// columns), so no output is written twice.  The block's conv outputs (kCR
// rows by kCC columns, the pool's overlap row and column recomputed) are an
// implicit GEMM on the tensor cores with mma.sync m16n8k16 bf16 -> f32:
// M the conv positions, 16 at a time as two runs of 8 neighbouring columns;
// K the taps, as k = dy * 8 + dx (64, 49 used); N the 64 channels.  The block
// stages its padded input slab in shared memory as bf16 in canvas order:
// the A operand's pair of taps (dx, dx + 1) at conv column j is the pair of
// neighbouring pixels at 2j + dx, one aligned 32-bit word, so the fragments
// load straight from the slab with no deinterleave.  A warp keeps the
// weights' B fragments in registers for a bf16 output.  The epilogue applies
// scale and the table's bias, rounds, and stages the conv outputs in shared
// memory (16-byte chunks swizzled by column against bank conflicts); then
// each thread max-pools one 16-byte chunk of one output position, applies
// ReLU once (it commutes with the max and the rounding) and stores it, so
// each position's 64 channels are written as whole lines.  Block shapes with
// more blocks per SM, B fragments read from shared memory, and scale and bias
// interleaved in one shared table all measured slower (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kC = 64;                    // stem output channels
constexpr int kTP = 7;                    // pool rows per block
constexpr int kTQ = 19;                   // pool columns per block
constexpr int kCR = 2 * kTP + 1;          // conv rows per block (15)
constexpr int kRunsPerRow = 5;            // runs of 8 conv columns per row
constexpr int kCC = 8 * kRunsPerRow;      // conv columns per block (40 >= 2 kTQ + 1)
constexpr int kRuns = kCR * kRunsPerRow;  // 75
constexpr int kMTiles = (kRuns + 1) / 2;  // 16-row M tiles: two runs each
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kSlabH = 4 * kTP + 7;       // padded input rows per block (35)
constexpr int kSlabW = 88;                // >= 2 (kCC - 1) + 8, even
constexpr int kSlabWords = kSlabW / 2;
constexpr int kWRow = 36;                 // words per channel row of w in smem (32 + 4 pad)
constexpr int kPieceWords = kC * kWRow;
constexpr int kMaxPatterns = 8;

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// B fragments of one piece: for k tile kt and channel tile nt, rows k = kt *
// 16 + 2t (+1) and + 8 of channel nt * 8 + g.
__device__ __forceinline__ void load_b(uint32_t (*bw)[8][2], const uint32_t* w, int g, int t) {
#pragma unroll
  for (int kt = 0; kt < 4; ++kt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const uint32_t* p = w + (nt * 8 + g) * kWRow + kt * 8 + t;
      bw[kt][nt][0] = p[0];
      bw[kt][nt][1] = p[4];
    }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

template <typename T> struct Out;
template <> struct Out<float> {
  static __device__ __forceinline__ void store2(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
  static __device__ __forceinline__ uint4 max4(uint4 a, uint4 b) {
    return make_uint4(__float_as_uint(fmaxf(__uint_as_float(a.x), __uint_as_float(b.x))),
                      __float_as_uint(fmaxf(__uint_as_float(a.y), __uint_as_float(b.y))),
                      __float_as_uint(fmaxf(__uint_as_float(a.z), __uint_as_float(b.z))),
                      __float_as_uint(fmaxf(__uint_as_float(a.w), __uint_as_float(b.w))));
  }
};
template <> struct Out<__nv_bfloat16> {
  static __device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  }
  static __device__ __forceinline__ uint32_t max2(uint32_t a, uint32_t b) {
    __nv_bfloat162 m = __hmax2(*reinterpret_cast<__nv_bfloat162*>(&a),
                               *reinterpret_cast<__nv_bfloat162*>(&b));
    return *reinterpret_cast<uint32_t*>(&m);
  }
  static __device__ __forceinline__ uint4 max4(uint4 a, uint4 b) {
    return make_uint4(max2(a.x, b.x), max2(a.y, b.y), max2(a.z, b.z), max2(a.w, b.w));
  }
};

// Byte offset in the conv staging buffer of channel o at block-local conv
// (row r, column c): 16-byte chunks of a position's channels are XOR-swizzled
// by the column's low 3 bits.
template <typename T>
__device__ __forceinline__ int stage_offset(int r, int c, int o) {
  constexpr int kRowBytes = kC * (int)sizeof(T);
  const int byte = o * (int)sizeof(T);
  return (r * kCC + c) * kRowBytes + (((byte >> 4) ^ (c & 7)) << 4) + (byte & 15);
}

template <typename T>
__host__ __device__ constexpr int stage_bytes() { return kCR * kCC * kC * (int)sizeof(T); }
__host__ __device__ constexpr int slab_bytes() { return kSlabH * kSlabW * 2; }

constexpr int kSlabIters = (kSlabH * kSlabW + kThreads - 1) / kThreads;

// Tile = (canvas, band of kTP pool rows, run of kTQ pool columns).
struct Tile {
  int b, p0, q0;
};

__device__ __forceinline__ Tile tile_at(int tile, int tiles_x, int tiles_y) {
  Tile tl;
  tl.q0 = (tile % tiles_x) * kTQ;
  const int rest = tile / tiles_x;
  tl.p0 = (rest % tiles_y) * kTP;
  tl.b = rest / tiles_y;
  return tl;
}

// Issue the loads of this thread's slab elements (tid + it * kThreads) of a
// tile.  Slab (r, x) is padded input (4 p0 + r, 4 q0 + x), i.e. canvas pixel
// (4 p0 + r - 3, 4 q0 + x - 3), zero outside the canvas.
__device__ __forceinline__ void fetch_slab(uint8_t (&px)[kSlabIters], const uint8_t* grey,
                                           const Tile& tl, int S, int tid) {
  const uint8_t* gb = grey + (size_t)tl.b * S * S;
#pragma unroll
  for (int it = 0; it < kSlabIters; ++it) {
    const int i = tid + it * kThreads;
    const int r = i / kSlabW;
    const int x = i - r * kSlabW;
    const int gy = 4 * tl.p0 + r - 3;
    const int gx = 4 * tl.q0 + x - 3;
    px[it] = (i < kSlabH * kSlabW && gy >= 0 && gy < S && gx >= 0 && gx < S)
                 ? __ldg(gb + (size_t)gy * S + gx) : (uint8_t)0;
  }
}

__device__ __forceinline__ void store_slab(__nv_bfloat16* slab, const uint8_t (&px)[kSlabIters],
                                           int tid) {
#pragma unroll
  for (int it = 0; it < kSlabIters; ++it) {
    const int i = tid + it * kThreads;
    if (i < kSlabH * kSlabW) slab[i] = __float2bfloat16_rn((float)px[it]);
  }
}

// Tap pattern of a tile's conv row (threads 0 .. kCR - 1) or column (the next
// kCC threads); rows and columns past the map take the last one's.
__device__ __forceinline__ int fetch_class(const int* cls, const Tile& tl, int CH, int tid) {
  if (tid < kCR) return __ldg(cls + min(2 * tl.p0 + tid, CH - 1));
  if (tid < kCR + kCC) return __ldg(cls + min(2 * tl.q0 + tid - kCR, CH - 1));
  return 0;
}

template <typename T, int NP>
__global__ void __launch_bounds__(kThreads, 2)
grey_stem_kernel(const uint8_t* __restrict__ grey, const uint32_t* __restrict__ w,
                 const float* __restrict__ table, const int* __restrict__ cls,
                 const float* __restrict__ scale, T* __restrict__ out, int S, int CH, int PH,
                 int K, int tiles_x, int tiles_y) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* stage = smem;
  __nv_bfloat16* slab = reinterpret_cast<__nv_bfloat16*>(smem + stage_bytes<T>());
  uint32_t* ws = reinterpret_cast<uint32_t*>(smem + stage_bytes<T>() + slab_bytes());
  float* tab = reinterpret_cast<float*>(ws + NP * kPieceWords);
  __shared__ __align__(16) float sc[kC];
  __shared__ int classes[kCR + kCC];  // rows, then columns
  const int* rcls = classes;
  const int* ccls = classes + kCR;
  const int tid = threadIdx.x;

  // Weights, table and scale by 16-byte cp.async, in flight with the
  // tile's slab and tap patterns: the block waits on one round trip.
  for (int i = tid; i < NP * kC * 8; i += kThreads)
    cp_async16(ws + (i >> 3) * kWRow + (i & 7) * 4, w + i * 4);
  for (int i = tid; i < K * K * kC / 4; i += kThreads) cp_async16(tab + i * 4, table + i * 4);
  if (tid < kC / 4) cp_async16(sc + tid * 4, scale + tid * 4);
  asm volatile("cp.async.commit_group;\n" ::);
  const Tile tl = tile_at(blockIdx.x, tiles_x, tiles_y);
  uint8_t px[kSlabIters];
  fetch_slab(px, grey, tl, S, tid);
  const int cl = fetch_class(cls, tl, CH, tid);
  store_slab(slab, px, tid);
  if (tid < kCR + kCC) classes[tid] = cl;
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const uint32_t* s32 = reinterpret_cast<const uint32_t*>(slab);
  uint32_t bw[4][8][2];
  if (NP == 1) load_b(bw, ws, g, t);
  // Conv outputs: warp-wide 16 x 64 tiles on the tensor cores.
  for (int mt = warp; mt < kMTiles; mt += kWarps) {
    // Rows g and g + 8 of the tile: conv column 8 run + g of runs 2 mt and
    // 2 mt + 1 (a missing last run repeats the one before, same values).
    const int run[2] = {2 * mt, min(2 * mt + 1, kRuns - 1)};
    int cr[2], cc[2], base[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      cr[h] = run[h] / kRunsPerRow;
      cc[h] = (run[h] - cr[h] * kRunsPerRow) * 8 + g;
      // Word of slab (2 cr, 2 cc + 2 t): taps dy = 0, dx = 2t, 2t + 1.
      base[h] = 2 * cr[h] * kSlabWords + cc[h] + t;
    }
    float acc[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.0f;
#pragma unroll
    for (int pc = 0; pc < NP; ++pc) {
      if (NP > 1) load_b(bw, ws + pc * kPieceWords, g, t);
#pragma unroll
      for (int kt = 0; kt < 4; ++kt) {
        // k = kt * 16 + 2t: tap row dy = 2 kt; k + 8: dy = 2 kt + 1 (none for kt = 3).
        uint32_t a[4];
        a[0] = s32[base[0] + 2 * kt * kSlabWords];
        a[1] = s32[base[1] + 2 * kt * kSlabWords];
        a[2] = kt < 3 ? s32[base[0] + (2 * kt + 1) * kSlabWords] : 0u;
        a[3] = kt < 3 ? s32[base[1] + (2 * kt + 1) * kSlabWords] : 0u;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) mma_bf16(acc[nt], a, bw[kt][nt]);
      }
    }
    // Epilogue: z = acc * scale + b0, rounded, staged for the pool (ReLU
    // commutes with the max and the rounding, so the pool applies it once).
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float* bias = tab + (rcls[cr[h]] * K + ccls[cc[h]]) * kC;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int o = nt * 8 + 2 * t;
        const float2 s2 = *reinterpret_cast<const float2*>(sc + o);
        const float2 b2 = *reinterpret_cast<const float2*>(bias + o);
        Out<T>::store2(reinterpret_cast<T*>(stage + stage_offset<T>(cr[h], cc[h], o)),
                       __fmaf_rn(acc[nt][2 * h], s2.x, b2.x),
                       __fmaf_rn(acc[nt][2 * h + 1], s2.y, b2.y));
      }
    }
  }
  __syncthreads();

  // 3x3/2 max-pool and ReLU: one 16-byte chunk of one output position per item.
  constexpr int kChunks = kC * (int)sizeof(T) / 16;
  for (int i = tid; i < kTP * kTQ * kChunks; i += kThreads) {
    const int pos = i / kChunks;
    const int ck = i - pos * kChunks;
    const int p = pos / kTQ;
    const int q = pos - p * kTQ;
    if (tl.p0 + p >= PH || tl.q0 + q >= PH) continue;
    const int o = ck * 16 / (int)sizeof(T);
    uint4 m = *reinterpret_cast<const uint4*>(stage + stage_offset<T>(2 * p, 2 * q, o));
#pragma unroll
    for (int dr = 0; dr < 3; ++dr)
#pragma unroll
      for (int dc = 0; dc < 3; ++dc)
        if (dr | dc)
          m = Out<T>::max4(m, *reinterpret_cast<const uint4*>(
                                  stage + stage_offset<T>(2 * p + dr, 2 * q + dc, o)));
    *reinterpret_cast<uint4*>(out + (((size_t)tl.b * PH + tl.p0 + p) * PH + tl.q0 + q) * kC +
                              o) = Out<T>::max4(m, make_uint4(0, 0, 0, 0));  // +0: all bits 0
  }
}

template <typename T, int NP>
int launch(const void* grey, const void* w, const void* table, const void* cls,
           const void* scale, void* out, int B, int S, int K, cudaStream_t stream) {
  if (B <= 0 || S < 1 || K < 1 || K > kMaxPatterns) return (int)cudaErrorInvalidValue;
  const int CH = (S - 1) / 2 + 1;
  if (CH < 3) return (int)cudaErrorInvalidValue;
  const int PH = (CH - 3) / 2 + 1;
  const int smem = stage_bytes<T>() + slab_bytes() + NP * kPieceWords * 4 + K * K * kC * 4;
  static bool configured = false;
  if (!configured) {
    const int max_smem = stage_bytes<T>() + slab_bytes() + NP * kPieceWords * 4 +
                         kMaxPatterns * kMaxPatterns * kC * 4;
    const cudaError_t err = cudaFuncSetAttribute(
        grey_stem_kernel<T, NP>, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const int tiles_x = (PH + kTQ - 1) / kTQ, tiles_y = (PH + kTP - 1) / kTP;
  const long long n_tiles = (long long)B * tiles_x * tiles_y;
  if (n_tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  grey_stem_kernel<T, NP><<<(unsigned)n_tiles, kThreads, smem, stream>>>(
      (const uint8_t*)grey, (const uint32_t*)w, (const float*)table, (const int*)cls,
      (const float*)scale, (T*)out, S, CH, PH, K, tiles_x, tiles_y);
  return (int)cudaGetLastError();
}

}  // namespace

// n_pieces: 1 or 3; dtype of out: 0 = float32, 1 = bfloat16.
extern "C" int radnet_grey_stem(const void* grey, const void* w, const void* table,
                                const void* cls, const void* scale, void* out, int B, int S,
                                int n_pieces, int K, int dtype, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0 && n_pieces == 1)
    return launch<float, 1>(grey, w, table, cls, scale, out, B, S, K, st);
  if (dtype == 0 && n_pieces == 3)
    return launch<float, 3>(grey, w, table, cls, scale, out, B, S, K, st);
  if (dtype == 1 && n_pieces == 1)
    return launch<__nv_bfloat16, 1>(grey, w, table, cls, scale, out, B, S, K, st);
  if (dtype == 1 && n_pieces == 3)
    return launch<__nv_bfloat16, 3>(grey, w, table, cls, scale, out, B, S, K, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* radnet_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
