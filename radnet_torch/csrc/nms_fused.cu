// Fixed-point NMS as one kernel per call, written for Hopper (sm_90a).
//
// Replaces: radnet_tpu/ops/pallas_nms.py, _dominates_kernel /
// dominates_matrix (the dominance relation), and the Jacobi loop of
// radnet_tpu/ops/nms.py::nms_fixed_point (lines 151-162) that iterates over
// it.
//
// For each candidate set b of a batch (boxes (N, 4) xyxy f32, scores (N,)
// f32, valid (N,) bytes) it writes the greedy NMS kept set (N,) bytes and the
// number of Jacobi rounds it took.  The kept set is the unique fixed point of
//   kept[i] = valid[i] and no j with dom[i, j] and kept[j],
//   dom[i, j] = iou(i, j) > thresh and (s_j > s_i or (s_j == s_i and j > i)),
// with iou = inter / (area_i + area_j - inter + 1e-6) and IoU 0 for a
// degenerate box.  The kernel iterates it from kept = valid and stops at the
// first round that changes nothing, or after N rounds, as the reference loop
// does, so the round count equals the reference's.  No round returns to the
// host.
//
// Exactness: the relation equals the plain version's
// (radnet_torch/ops/nms.py::dominates_plain) bit for bit on every pair that
// can matter.  The file is built with --fmad=false and keeps the plain
// version's operation order.  A pair is only tested when both candidates are
// valid, non-degenerate and have a score that is not NaN: any other
// candidate is never kept (invalid) or has an all-zero row and column
// (degenerate, NaN score), so leaving its pairs out changes no kept bit.
// With a threshold >= 0 (the wrapper raises otherwise), a pair whose boxes do
// not meet has IoU +0 or NaN and never dominates.  The division is decided
// by two multiplies where they settle it (see Screen) and by __fdiv_rn
// otherwise.
//
// Bound on this card: operations.  The function reads 21 bytes and writes one
// per candidate (0.26 MB at 12 x 2048); its work is one IoU test for each
// pair of live candidates (~16 float operations), plus 2 * N * N / 32 word
// operations a round: 3-6 us at 12 x 2048 at the card's 67 TFLOP/s of
// non-tensor float32.  What holds the kernel is instruction issue: a warp
// tests a row against 32 columns in about thirty instructions (loads,
// votes and predicates besides the float operations), and each round ends
// in a cluster barrier.
//
// Design: the relation never leaves the SMs.  A set is cut into strips of 32
// rows; one cluster of C = ceil(strips / 8) blocks (at most 8) holds the set,
// block r owning strips r, r + C, ... (interleaved, so a score-sorted set
// spreads its dominated rows evenly).  Each block builds its rows of the
// relation bit-packed in shared memory, word-major ([word][row], 32 columns a
// word, so a round's reads are conflict-free): a warp holds one column word's
// 32 candidates in registers and walks the rows of its strips, one
// __ballot_sync a row.  Each (strip, word) tile is first classified from the
// largest and smallest (score, index) keys of its live rows and columns: no
// column outranks a row (a zero tile, skipped: about half the tiles of a
// score-sorted set, which is what the proposal NMS gets from the top-k),
// every column outranks every row (only the overlap is tested), or mixed.
// The pair test is branch-free but for the rare rounded division, so the
// unrolled rows pipeline; 1024 threads a block (512 for sets of at most 1024)
// keep enough warps in flight.  The kept set is a bit vector that every block
// holds whole, in three buffers.  A round ANDs each row's words with it (four
// threads a row), and each warp's new kept word is pushed into every block's
// next buffer through distributed shared memory (cluster.map_shared_rank);
// the round ends in one cluster.sync(), and the next round starts by
// comparing the new vector with the old, the same in every block.  Rows and
// columns past N are masked, so any N up to kMaxN works; the relation of a
// set at kMaxN fills 8 blocks' shared memory.  On request (a non-null
// relation pointer) the packed relation is also written to device memory,
// (B, N, ceil(N / 32)) words, for checking.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxCluster = 8;      // the portable cluster size
constexpr int kStripsPerBlock = 8;
constexpr int kSplit = 4;           // threads that share a row's words in a round
constexpr int kBigThreads = 1024;   // sets of more than kSmallStrips strips
constexpr int kSmallThreads = 512;
constexpr int kSmallStrips = 32;
constexpr int kMaxN = 3584;         // radnet_torch/ops/nms.py MAX_N
constexpr int kMaxSmem = 232448;    // a block's shared memory on Hopper
constexpr unsigned kFull = 0xffffffffu;

struct Plan {
  int strips;        // words of a row, strips of the set
  int cluster;       // blocks per set
  int local_strips;  // strips per block
  int rows;          // rows per block
  size_t rbox, rkey, skmin, skmax, rel, rarea, part, vword, kall, smem;  // byte offsets
};

__host__ __device__ inline Plan make_plan(int n) {
  Plan p;
  p.strips = (n + 31) / 32;
  const int c = (p.strips + kStripsPerBlock - 1) / kStripsPerBlock;
  p.cluster = c < kMaxCluster ? c : kMaxCluster;
  p.local_strips = (p.strips + p.cluster - 1) / p.cluster;
  p.rows = p.local_strips * 32;
  size_t o = 0;
  p.rbox = o;  o += (size_t)p.rows * 16;
  p.rkey = o;  o += (size_t)p.rows * 8;
  p.skmin = o; o += (size_t)p.local_strips * 8;
  p.skmax = o; o += (size_t)p.local_strips * 8;
  p.rel = o;   o += (size_t)p.strips * p.rows * 4;
  p.rarea = o; o += (size_t)p.rows * 4;
  p.part = o;  o += (size_t)kSplit * p.rows * 4;
  p.vword = o; o += (size_t)p.local_strips * 4;
  p.kall = o;  o += (size_t)3 * p.strips * 4;
  p.smem = o;
  return p;
}

// Orders candidates as the relation does: a larger key outranks a smaller
// one.  -0 and +0 compare equal, so both map to +0; NaN never gets here.
__device__ __forceinline__ uint64_t rank_key(float s, int i) {
  uint32_t u = __float_as_uint(s == 0.f ? 0.f : s);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((uint64_t)u << 32) | (uint32_t)i;
}

__device__ __forceinline__ void warp_min_max(uint64_t& lo, uint64_t& hi) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const uint64_t a = __shfl_xor_sync(kFull, lo, o);
    const uint64_t b = __shfl_xor_sync(kFull, hi, o);
    lo = a < lo ? a : lo;
    hi = b > hi ? b : hi;
  }
}

// The IoU test without the division where it can be decided without it.  hi
// and lo bracket the threshold by 2^-18 of it; inter > RN(hi * d) then proves
// RN(inter / d) > thresh, and inter < RN(lo * d) proves it is not (each
// product rounds by 2^-24 at most, far inside the bracket).  Only the pairs
// in between take the rounded division.  The bracket needs hi * d and lo * d
// in the normal range: every box coordinate of the set below 2^40 in
// magnitude (so d < 2^82) and 2^-100 <= thresh <= 2^40; otherwise hi = +inf
// and lo = -inf, and every meeting pair takes the division.
struct Screen {
  float thresh, hi, lo;
};

__device__ __forceinline__ Screen make_screen(float thresh, bool bounded) {
  const float inf = __int_as_float(0x7f800000);
  const bool ok = bounded && thresh >= 0x1p-100f && thresh <= 0x1p40f;
  return {thresh, ok ? thresh * (1.f + 0x1p-18f) : inf, ok ? thresh * (1.f - 0x1p-18f) : -inf};
}

struct Candidate {
  float4 box;
  float area;
  uint64_t key;
  bool valid, live;  // live: valid, non-degenerate, score not NaN
};

__device__ __forceinline__ Candidate load_candidate(const float4* boxes, const float* scores,
                                                    const uint8_t* valid, int i, int n) {
  const float inf = __int_as_float(0x7f800000);
  Candidate c{make_float4(inf, inf, -inf, -inf), 0.f, 0, false, false};
  if (i < n) {
    const float4 b = boxes[i];
    const float s = scores[i];
    c.valid = valid[i] != 0;
    c.live = c.valid && b.z > b.x && b.w > b.y && !isnan(s);
    if (c.live) {
      c.box = b;
      c.area = __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
      c.key = rank_key(s, i);
    }
  }
  return c;
}

// One row of a tile: bit (column lane) of the row's word is dom[row, column]
// (with kMixed, the score order is tested too; otherwise every column
// outranks the row).  The IoU follows the plain version's order; an empty
// box (x1 = y1 = +inf, x2 = y2 = -inf) meets nothing.  Branch-free but for
// the rounded division, which the warp takes only when a lane needs it.
template <bool kMixed>
__device__ __forceinline__ uint32_t tile_row(float4 a, float aarea, uint64_t akey,
                                             const Candidate& c, const Screen& sc) {
  const float x0 = fmaxf(a.x, c.box.x), x1 = fminf(a.z, c.box.z);
  const float y0 = fmaxf(a.y, c.box.y), y1 = fminf(a.w, c.box.w);
  const float iw = __fsub_rn(x1, x0);
  const float inter = __fmul_rn(iw, __fsub_rn(y1, y0));
  const float d = __fadd_rn(__fsub_rn(__fadd_rn(aarea, c.area), inter), 1e-6f);
  // The boxes meet when both extents are positive; otherwise one clamps to 0
  // and the IoU is +0 or NaN.  With iw > 0, a non-positive ih makes inter
  // <= 0, which the screen rejects (lo * d > 0) or the division does.
  const bool meet = (iw > 0.f) & (!kMixed || c.key > akey);
  const bool yes = inter > __fmul_rn(sc.hi, d);
  const bool no = inter < __fmul_rn(sc.lo, d);
  bool dom = meet & yes;
  const bool unsure = meet & !yes & !no;
  if (__any_sync(kFull, unsure)) {
    if (unsure) dom = __fdiv_rn(inter, d) > sc.thresh;
  }
  return __ballot_sync(kFull, dom);
}

template <int kThreads>
__global__ void __launch_bounds__(kThreads)
nms_fused_kernel(const float4* __restrict__ boxes, const float* __restrict__ scores,
                 const uint8_t* __restrict__ valid, uint8_t* __restrict__ kept_out,
                 int* __restrict__ rounds_out, uint32_t* __restrict__ relation_out, int n,
                 float thresh) {
  constexpr int kWarps = kThreads / 32;
  cg::cluster_group cluster = cg::this_cluster();
  const Plan p = make_plan(n);
  extern __shared__ __align__(16) unsigned char smem[];
  float4* rbox = reinterpret_cast<float4*>(smem + p.rbox);
  uint64_t* rkey = reinterpret_cast<uint64_t*>(smem + p.rkey);
  uint64_t* skmin = reinterpret_cast<uint64_t*>(smem + p.skmin);
  uint64_t* skmax = reinterpret_cast<uint64_t*>(smem + p.skmax);
  uint32_t* rel = reinterpret_cast<uint32_t*>(smem + p.rel);
  float* rarea = reinterpret_cast<float*>(smem + p.rarea);
  uint32_t* part = reinterpret_cast<uint32_t*>(smem + p.part);
  uint32_t* vword = reinterpret_cast<uint32_t*>(smem + p.vword);
  uint32_t* kall = reinterpret_cast<uint32_t*>(smem + p.kall);

  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.y;
  const int C = p.cluster, W = p.strips, R = p.rows, LS = p.local_strips;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float4* tb = boxes + (size_t)b * n;
  const float* ts = scores + (size_t)b * n;
  const uint8_t* tv = valid + (size_t)b * n;

  // 1. This block's rows: row t is candidate ((t / 32) * C + rank) * 32 + t % 32.
  //    Per strip: the smallest and largest key of its live rows, its valid bits.
  for (int t = tid; t < R; t += kThreads) {
    const int ls = t >> 5;
    const Candidate c = load_candidate(tb, ts, tv, (ls * C + rank) * 32 + lane, n);
    rbox[t] = c.box;
    rarea[t] = c.area;
    rkey[t] = c.key;
    uint64_t lo = c.live ? c.key : ~0ull, hi = c.live ? c.key : 0ull;
    warp_min_max(lo, hi);
    const uint32_t vw = __ballot_sync(kFull, c.valid);
    if (lane == 0) {
      skmin[ls] = lo;
      skmax[ls] = hi;
      vword[ls] = vw;
    }
  }
  // The first kept set (valid) of every strip of the set, and whether every
  // valid box of the set is bounded, for the IoU screen.
  bool bounded = true;
  for (int s = warp; s < W; s += kWarps) {
    const int j = s * 32 + lane;
    const bool v = j < n && tv[j] != 0;
    if (v) {
      const float4 x = tb[j];
      bounded &= fmaxf(fmaxf(fabsf(x.x), fabsf(x.y)), fmaxf(fabsf(x.z), fabsf(x.w))) < 0x1p40f;
    }
    const uint32_t w = __ballot_sync(kFull, v);
    if (lane == 0) kall[s] = w;
  }
  const Screen sc = make_screen(thresh, __syncthreads_and(bounded));

  // 2. The block's rows of the relation.  A warp holds a column word's 32
  //    candidates in registers and walks strips of rows: the words are
  //    dealt to the warps in turn (a score-sorted set puts its busy words
  //    first), and when there are fewer words than warps, several warps
  //    share a word and split its strips.
  const int groups = W >= kWarps ? 1 : kWarps / W;
  const int wstep = kWarps / groups;
  const int g = warp / wstep;
  if (g < groups) {
    for (int w = warp - g * wstep; w < W; w += wstep) {
      const Candidate c = load_candidate(tb, ts, tv, w * 32 + lane, n);
      uint64_t cmin = c.live ? c.key : ~0ull, cmax = c.live ? c.key : 0ull;
      warp_min_max(cmin, cmax);
      uint32_t* relw = rel + (size_t)w * R;
      for (int ls = g; ls < LS; ls += groups) {
        const int t0 = ls * 32;
        if (!(cmax > skmin[ls])) {  // no column of the word outranks a row
          relw[t0 + lane] = 0;
        } else if (cmin > skmax[ls]) {  // every live column outranks every live row
#pragma unroll 8
          for (int r = 0; r < 32; ++r) {
            const uint32_t word = tile_row<false>(rbox[t0 + r], rarea[t0 + r], 0, c, sc);
            if (lane == 0) relw[t0 + r] = word;
          }
        } else {
#pragma unroll 8
          for (int r = 0; r < 32; ++r) {
            const uint32_t word = tile_row<true>(rbox[t0 + r], rarea[t0 + r], rkey[t0 + r], c, sc);
            if (lane == 0) relw[t0 + r] = word;
          }
        }
      }
    }
  }
  if (relation_out != nullptr) {
    __syncthreads();
    for (int idx = tid; idx < R * W; idx += kThreads) {
      const int t = idx / W, w = idx - t * W;
      const int i = ((t >> 5) * C + rank) * 32 + (t & 31);
      if (i < n) relation_out[((size_t)b * n + i) * W + w] = rel[(size_t)w * R + t];
    }
  }
  // Every block of the cluster runs and has built its rows before any block
  // writes into another's shared memory.
  cluster.sync();

  // 3. Jacobi rounds over three kept buffers.  Round k reads buffer cur,
  //    compares it with the buffer before (did round k - 1 change it?), and
  //    writes the next buffer of every block; the cluster.sync() that ends
  //    the round orders those writes before round k + 1 reads them.  The
  //    buffer a round writes was last read two rounds before, so no block
  //    can still be reading it.
  int cur = 0, rounds = 0;
  for (;;) {
    const uint32_t* kc = kall + cur * W;
    const uint32_t* kp = kall + (cur == 0 ? 2 : cur - 1) * W;
    uint32_t* kn = kall + (cur == 2 ? 0 : cur + 1) * W;
    // kSplit threads share a row: each ORs every kSplit-th word.
    for (int idx = tid; idx < kSplit * R; idx += kThreads) {
      const int q = idx / R, t = idx - q * R;
      uint32_t hit = 0;
#pragma unroll 4
      for (int w = q; w < W; w += kSplit) hit |= rel[(size_t)w * R + t] & kc[w];
      part[idx] = hit;
    }
    bool changed = false;
    for (int s = tid; s < W; s += kThreads) changed |= kc[s] != kp[s];
    // Every block holds the same buffers, so every block decides alike.
    if (!__syncthreads_or(changed || rounds == 0) || rounds >= n) break;
    for (int t = tid; t < R; t += kThreads) {
      const int ls = t >> 5;
      const int s = ls * C + rank;
      uint32_t hit = 0;
#pragma unroll
      for (int q = 0; q < kSplit; ++q) hit |= part[q * R + t];
      const uint32_t word = __ballot_sync(kFull, ((vword[ls] >> lane) & 1u) && hit == 0);
      if (s < W && lane < C) cluster.map_shared_rank(kn, lane)[s] = word;
    }
    ++rounds;
    cluster.sync();
    cur = cur == 2 ? 0 : cur + 1;
  }

  const uint32_t* kf = kall + cur * W;
  for (int t = tid; t < R; t += kThreads) {
    const int i = ((t >> 5) * C + rank) * 32 + (t & 31);
    if (i < n) kept_out[(size_t)b * n + i] = (uint8_t)((kf[i >> 5] >> (i & 31)) & 1u);
  }
  if (rank == 0 && tid == 0) rounds_out[b] = rounds;
}

template <int kThreads>
cudaError_t launch(const Plan& p, const void* boxes, const void* scores, const void* valid,
                   void* kept, void* rounds, void* relation, int batch, int n, float thresh,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(nms_fused_kernel<kThreads>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.cluster, batch, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, nms_fused_kernel<kThreads>, (const float4*)boxes,
                            (const float*)scores, (const uint8_t*)valid, (uint8_t*)kept,
                            (int*)rounds, (uint32_t*)relation, n, thresh);
}

}  // namespace

extern "C" int radnet_nms_fused(const void* boxes, const void* scores, const void* valid,
                                void* kept, void* rounds, void* relation, int batch, int n,
                                float thresh, void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  if (n > kMaxN || batch > 65535) return (int)cudaErrorInvalidValue;
  const Plan p = make_plan(n);
  if (p.smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  const cudaError_t err =
      p.strips > kSmallStrips
          ? launch<kBigThreads>(p, boxes, scores, valid, kept, rounds, relation, batch, n, thresh,
                                (cudaStream_t)stream)
          : launch<kSmallThreads>(p, boxes, scores, valid, kept, rounds, relation, batch, n,
                                  thresh, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" const char* radnet_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
