// Greedy non-maximum suppression over score-sorted boxes, for a whole
// batch in one call: (B, N) boxes -> (B, N) keep mask.
//
// Replaces the Pallas kernel `_nms_kernel` / `nms_keep`
// (mxnet_tpu/ops/pallas_kernels.py:52-118), which walks i = 0..N-1 in a
// fori_loop over one (8, Np) lane-packed block per image and, for a kept
// box i, clears every later valid box j of the same class (any class
// under force_suppress) whose IoU with i exceeds the threshold. The TPU
// layout (lane packing, padding to 128 lanes, the class -2 of padded
// lanes, masked-sum scalar extraction) is not carried over.
//
// An invalid box is never kept and suppresses nothing, so the walk runs
// over the valid boxes only, compacted in order: it makes the same
// decisions as a walk over all N. Three launches, each grid fixed by
// (B, N) alone, and nothing read back on the host:
//
//   1. nms_keep_compact_kernel, a block of 512 threads per image: a
//      block-wide prefix sum over the valid flags writes the indices of
//      the valid boxes, in order, to idx[b, :count] and count to
//      counts[b], and every keep[b, :] = 0. An image of count <= kCap
//      (the SSD path: <= 100 valid boxes an image) is then finished by
//      the same block in shared memory: the compacted boxes, their
//      suppression mask (count x ceil(count / 64) words) and the greedy
//      walk; it writes keep = 1 for the kept boxes. A larger image's
//      block writes its compacted boxes, areas and classes instead.
//   2. nms_keep_mask_kernel, grid (mask_blocks, B) of 8 warps: for an
//      image above the cap, the upper-triangle 64 x 64 tiles of the
//      compacted boxes' suppression mask, a quarter tile (16 columns) a
//      warp in a grid-stride loop over 4 ceil(count / 64)^2 slots. Lane l
//      of tile (g, w) writes 16 bits of word w of compacted rows 64 g + l
//      and 64 g + l + 32: bit k is set when column 64 w + k is after the
//      row, the classes match (or force_suppress), and IoU > thresh. A
//      tile's 64 words are contiguous, tiles packed row-group by
//      row-group above the diagonal (tile_index).
//   3. nms_keep_scan_kernel, a block of 512 threads per image above the
//      cap: the greedy walk, 64 compacted boxes (a group) at a time. The
//      removed set is in shared memory. For group k, warp 0 resolves the
//      group in registers against its diagonal tile (k, k): it visits
//      only the group's live boxes whose diagonal word is non-zero, so
//      the chain is one shared load per kept box that suppresses a box
//      of its own group. It then ORs the kept rows' words of tile
//      (k, k + 1) (the "near" word) in a register for group k + 1.
//      Meanwhile warps 1..15 OR group k - 1's kept rows' far words
//      (tiles (k - 1, w), w >= k + 1), which they loaded into registers
//      during step k - 1, into the removed set, write keep for group
//      k - 1, and load group k's far tiles; warp 1 stages tiles
//      (k + 2, k + 2) and (k + 2, k + 3) with cp.async (a ring of three).
//      One barrier a group, and no global load on warp 0's chain.
//
// What bounds it on an H100: the inputs are 21 bytes a box and the pairs
// the greedy walk must test are few, so the bound is microseconds at the
// largest shapes. The time is the three launches (the mask pass and the
// scan cost a launch each even where every image is under the cap), the
// compaction's pass over N, the mask pass (every pair of compacted boxes, of any
// class) and, above the cap, the scan's ceil(count / 64) steps, in which
// one SM reads every far tile of a group: the far warps' loads and OR
// reductions, not warp 0's chain, set a step's length. The walk no longer
// waits on one dependent global load per kept box.
//
// Bit-for-bit decisions: the keep mask is boolean, so a pair whose IoU
// lies on the threshold must decide as the plain version
// (ops/nms.py: nms_keep_reference) decides. The IoU lines keep the Pallas
// order of operations and use the _rn intrinsics, so nvcc cannot contract
// a product and a sum into an FMA under -O3:
//   area  = max(x2 - x1, 0) * max(y2 - y1, 0)
//   inter = max(min(x2_i, x2_j) - max(x1_i, x1_j), 0) * (same in y)
//   iou   = inter / max(area_j + area_i - inter, 1e-12);  suppress if
//   iou > t
// and the last line is decided exactly without dividing (Threshold): a
// float32 division costs a slow-path call where the numerator is 0, which
// most pairs are.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

typedef unsigned long long u64;

constexpr int kGroup = 64;  // boxes a group: the bits of a mask word
// images of at most kCap valid boxes finish in the compaction block
// (ops/nms.py: CAP; chip_smoke.py --nms-sweep rewrites this line)
constexpr int kCap = 256;
constexpr int kCapWords = kCap / kGroup;
constexpr int kCompactThreads = 512;
constexpr int kItems = 8;  // boxes a thread flags in a compaction round
constexpr int kMaskWarps = 8;  // quarter tiles a mask block works on at once
constexpr int kQuarter = kGroup / 4;  // columns of a quarter tile
constexpr int kMaskThreads = 32 * kMaskWarps;
constexpr int kScanThreads = 512;
constexpr int kFarWarps = kScanThreads / 32 - 1;
// far tiles a warp of the scan holds in registers a group ahead (above
// kFarWarps * kFarHeld far tiles, the rest are loaded when needed)
constexpr int kFarHeld = 8;
constexpr int kFarUnroll = 8;  // far words past those a warp loads at once
constexpr int kStages = 3;     // staged groups: the walk's and two ahead
constexpr unsigned kFull = 0xffffffffu;
static_assert(kCap % kGroup == 0 && kCap >= kGroup && kCap <= 512,
              "kCap must be a multiple of 64 in 64..512");

__device__ __forceinline__ float box_area(float x1, float y1, float x2,
                                          float y2) {
  return __fmul_rn(fmaxf(__fsub_rn(x2, x1), 0.f),
                   fmaxf(__fsub_rn(y2, y1), 0.f));
}

// The threshold test fl(inter / denom) > t decided without the division:
// rounding to nearest is monotonic, so fl(q) > t exactly when q lies above
// mid = (t + the next float above t) / 2, or on mid when the tie rounds
// to that next float (t's last mantissa bit is 1: `tie_up`). mid has 25
// significant bits and denom 24, so mid * denom is exact in double.
struct Threshold {
  double mid;
  int tie_up;
};

// Does box i suppress box j (the caller keeps j after i)?
__device__ __forceinline__ bool suppresses(float xi1, float yi1, float xi2,
                                           float yi2, float ai, float ci,
                                           float xj1, float yj1, float xj2,
                                           float yj2, float aj, float cj,
                                           Threshold th, int force) {
  const float iw = fmaxf(__fsub_rn(fminf(xj2, xi2), fmaxf(xj1, xi1)), 0.f);
  const float ih = fmaxf(__fsub_rn(fminf(yj2, yi2), fmaxf(yj1, yi1)), 0.f);
  const float inter = __fmul_rn(iw, ih);
  const float denom = fmaxf(__fsub_rn(__fadd_rn(aj, ai), inter), 1e-12f);
  const double lhs = (double)inter;
  const double rhs = __dmul_rn(th.mid, (double)denom);
  // bitwise, not short-circuit: no branch inside the pair loops
  return ((lhs > rhs) | (th.tie_up & (lhs == rhs))) & (force | (cj == ci));
}

// Offset, in tiles of 64 words, of mask tile (g, w >= g) of an image of
// wc groups: row-group g holds wc - g tiles.
__device__ __forceinline__ long long tile_index(int g, int w, int wc) {
  return (long long)g * wc - (long long)g * (g - 1) / 2 + (w - g);
}

__device__ __forceinline__ u64 warp_or(u64 v) {
  const unsigned lo = __reduce_or_sync(kFull, (unsigned)v);
  const unsigned hi = __reduce_or_sync(kFull, (unsigned)(v >> 32));
  return ((u64)hi << 32) | lo;
}

// The live rows of group g of an image of count boxes, as bits.
__device__ __forceinline__ u64 live_rows(int g, int count) {
  const int rows = count - g * kGroup;
  return rows >= kGroup ? ~0ull : (1ull << rows) - 1ull;
}

// Greedy resolution of one group: the group's kept rows, given the
// removed bits `cur` of its rows and the diagonal words diag(r) of its
// live rows (bits only above r). Only live rows whose diagonal word is
// not 0 (`nz`) can remove a row of the group, so only they are visited.
template <typename Diag>
__device__ __forceinline__ u64 resolve(u64 cur, u64 live, u64 nz,
                                       const Diag& diag) {
  u64 cand = live & ~cur & nz;
  while (cand) {  // the same on every lane
    const u64 d = diag.word(__ffsll((long long)cand) - 1);
    cur |= d;
    cand = (cand & (cand - 1)) & ~d;
  }
  return live & ~cur;
}

// Exclusive prefix sum of v over the block; warp_sums[kWarps - 1] holds
// the block's sum until the next call.
__device__ __forceinline__ int block_exclusive_scan(int v, int* warp_sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int kWarps = kCompactThreads / 32;
  int inc = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc += t;
  }
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int s = lane < kWarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(kFull, s, o);
      if (lane >= o) s += t;
    }
    warp_sums[lane] = s;
  }
  __syncthreads();
  return (warp ? warp_sums[warp - 1] : 0) + inc - v;
}

// Mask words of the small path: row p's word w is u32 halves [2 w]
// (bits 0..31) and [2 w + 1] of its row in shared memory.
struct SharedRows {
  static constexpr int kStride = 2 * kCapWords;  // halves a row
  const unsigned* m;
  __device__ __forceinline__ u64 at(int p, int w) const {
    return ((u64)m[p * kStride + 2 * w + 1] << 32) | m[p * kStride + 2 * w];
  }
};

// The diagonal words of group g of the small path's mask.
struct SharedDiag {
  SharedRows rows;
  int g;
  __device__ __forceinline__ u64 word(int r) const {
    return rows.at(g * kGroup + r, g);
  }
};

// The diagonal words of a group staged from the global mask.
struct StagedDiag {
  const u64* d;
  __device__ __forceinline__ u64 word(int r) const { return d[r]; }
};

__global__ void __launch_bounds__(kCompactThreads)
    nms_keep_compact_kernel(const float* __restrict__ boxes,
                            const float* __restrict__ cls,
                            const uint8_t* __restrict__ valid,
                            int* __restrict__ idx, int* __restrict__ counts,
                            float4* __restrict__ cbox,
                            float2* __restrict__ cattr,
                            uint8_t* __restrict__ keep, int n, Threshold th,
                            int force) {
  __shared__ int warp_sums[32];
  __shared__ int sidx[kCap];
  __shared__ float sx1[kCap], sy1[kCap], sx2[kCap], sy2[kCap];
  __shared__ float sarea[kCap], scls[kCap];
  // row p's word w is halves [2 w] (bits 0..31) and [2 w + 1]
  __shared__ unsigned smask[kCap * kCapWords * 2];
  __shared__ u64 sremoved[kCapWords], skept[kCapWords];

  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const uint8_t* vb = valid + (size_t)b * n;
  int* ib = idx + (size_t)b * n;
  uint8_t* kb = keep + (size_t)b * n;

  int count = 0;
  for (int base = 0; base < n; base += kCompactThreads * kItems) {
    const int i0 = base + t * kItems;
    unsigned flags = 0u;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int i = i0 + k;
      if (i < n) {
        if (vb[i]) flags |= 1u << k;
        kb[i] = 0;
      }
    }
    int pos = count + block_exclusive_scan(__popc(flags), warp_sums);
    const int total = warp_sums[kCompactThreads / 32 - 1];
    while (flags) {
      const int i = i0 + __ffs(flags) - 1;
      flags &= flags - 1;
      ib[pos] = i;
      if (pos < kCap) sidx[pos] = i;
      ++pos;
    }
    count += total;
    __syncthreads();  // warp_sums is rewritten by the next round
  }
  if (t == 0) counts[b] = count;
  const float* bb = boxes + (size_t)b * n * 4;
  const float* cb = cls + (size_t)b * n;
  if (count > kCap) {  // the same on every thread: the mask pass's input
    float4* ob = cbox + (size_t)b * n;
    float2* oa = cattr + (size_t)b * n;
    for (int p = t; p < count; p += kCompactThreads) {
      const int i = ib[p];  // written by this block before the barrier
      const float x1 = bb[4 * i], y1 = bb[4 * i + 1];
      const float x2 = bb[4 * i + 2], y2 = bb[4 * i + 3];
      ob[p] = make_float4(x1, y1, x2, y2);
      oa[p] = make_float2(box_area(x1, y1, x2, y2), cb[i]);
    }
    return;
  }

  // ---- a small image, finished here ----
  const int wc = (count + kGroup - 1) / kGroup;
  constexpr int kStride = SharedRows::kStride;
  for (int p = t; p < count; p += kCompactThreads) {
    const int i = sidx[p];
    const float x1 = bb[4 * i], y1 = bb[4 * i + 1];
    const float x2 = bb[4 * i + 2], y2 = bb[4 * i + 3];
    sx1[p] = x1;
    sy1[p] = y1;
    sx2[p] = x2;
    sy2[p] = y2;
    sarea[p] = box_area(x1, y1, x2, y2);
    scls[p] = cb[i];
  }
  if (t < kCapWords) sremoved[t] = 0ull;
  __syncthreads();
  // one (row, 32 columns) half word a thread, rows fastest: a warp's
  // lanes read the same column or neighbouring ones (no bank conflict)
  const int halves = 2 * wc;
  for (int item = t; item < count * halves; item += kCompactThreads) {
    const int c = item / count, p = item - c * count;
    const int q0 = c * 32;
    unsigned bits = 0u;
    if (q0 + 31 > p) {
      const float xi1 = sx1[p], yi1 = sy1[p], xi2 = sx2[p], yi2 = sy2[p];
      const float ai = sarea[p], ci = scls[p];
      const int q1 = min(q0 + 32, count);
      for (int q = max(q0, p + 1); q < q1; ++q)
        bits |= (unsigned)suppresses(xi1, yi1, xi2, yi2, ai, ci, sx1[q],
                                     sy1[q], sx2[q], sy2[q], sarea[q],
                                     scls[q], th, force)
                << (q - q0);
    }
    smask[p * kStride + c] = bits;
  }
  __syncthreads();
  if (t < 32) {  // warp 0 walks the groups
    const int lane = t;
    const SharedRows rows{smask};
    for (int g = 0; g < wc; ++g) {
      const u64 live = live_rows(g, count);
      const int r0 = g * kGroup + lane, r1 = r0 + 32;
      const u64 d0 = (live >> lane) & 1ull ? rows.at(r0, g) : 0ull;
      const u64 d1 = (live >> (lane + 32)) & 1ull ? rows.at(r1, g) : 0ull;
      const u64 nz = (u64)__ballot_sync(kFull, d0 != 0ull) |
                     ((u64)__ballot_sync(kFull, d1 != 0ull) << 32);
      const u64 kept = resolve(sremoved[g], live, nz, SharedDiag{rows, g});
      for (int w = g + 1; w < wc; ++w) {
        u64 a = (kept >> lane) & 1ull ? rows.at(r0, w) : 0ull;
        if ((kept >> (lane + 32)) & 1ull) a |= rows.at(r1, w);
        a = warp_or(a);
        if (lane == 0) sremoved[w] |= a;
      }
      if (lane == 0) skept[g] = kept;
      __syncwarp();
    }
  }
  __syncthreads();
  for (int p = t; p < count; p += kCompactThreads)
    if ((skept[p / kGroup] >> (p % kGroup)) & 1ull) kb[sidx[p]] = 1;
}

__global__ void __launch_bounds__(kMaskThreads)
    nms_keep_mask_kernel(const float4* __restrict__ cbox,
                         const float2* __restrict__ cattr,
                         const int* __restrict__ counts,
                         u64* __restrict__ mask, int n,
                         long long tiles_per_image, Threshold th,
                         int force) {
  const int b = blockIdx.y;
  const int count = counts[b];
  if (count <= kCap) return;  // finished by the compaction block
  const int wc = (count + kGroup - 1) / kGroup;
  const int lane = threadIdx.x & 31;
  const float4* bx = cbox + (size_t)b * n;
  const float2* at = cattr + (size_t)b * n;
  u64* mb = mask + (size_t)b * tiles_per_image * kGroup;

  // one quarter tile (64 rows x 16 columns) a warp: lane holds rows lane
  // and lane + 32, the warp stages the 16 column boxes in its slice of
  // shared memory and writes 16 bits of each row's word (a 16-bit store:
  // the four quarters of a word never share a byte)
  __shared__ float4 scol[kMaskWarps][kQuarter];
  __shared__ float2 sattr[kMaskWarps][kQuarter];
  const int warp = threadIdx.x >> 5;
  const long long slots = (long long)wc * wc * 4;
  for (long long s = (long long)blockIdx.x * kMaskWarps + warp; s < slots;
       s += (long long)gridDim.x * kMaskWarps) {
    const long long tile = s >> 2;
    const int quarter = (int)(s & 3);
    const int g = (int)(tile / wc), w = (int)(tile - (long long)g * wc);
    if (w < g) continue;  // below the diagonal: the same on every lane
    const int p0 = g * kGroup + lane, p1 = p0 + 32;
    const int q0 = w * kGroup + kQuarter * quarter;
    const int k1 = max(0, min(kQuarter, count - q0));
    __syncwarp();  // the previous quarter's columns are read
    if (lane < k1) {
      scol[warp][lane] = __ldg(bx + q0 + lane);
      sattr[warp][lane] = __ldg(at + q0 + lane);
    }
    const float4 r0 = p0 < count ? __ldg(bx + p0) : make_float4(0, 0, 0, 0);
    const float4 r1 = p1 < count ? __ldg(bx + p1) : make_float4(0, 0, 0, 0);
    const float2 a0 = p0 < count ? __ldg(at + p0) : make_float2(0, 0);
    const float2 a1 = p1 < count ? __ldg(at + p1) : make_float2(0, 0);
    __syncwarp();
    unsigned bits0 = 0u, bits1 = 0u;
#pragma unroll 4
    for (int k = 0; k < k1; ++k) {
      const float4 c = scol[warp][k];
      const float2 ca = sattr[warp][k];
      bits0 |= (unsigned)((q0 + k > p0) &
                          suppresses(r0.x, r0.y, r0.z, r0.w, a0.x, a0.y, c.x,
                                     c.y, c.z, c.w, ca.x, ca.y, th, force))
               << k;
      bits1 |= (unsigned)((q0 + k > p1) &
                          suppresses(r1.x, r1.y, r1.z, r1.w, a1.x, a1.y, c.x,
                                     c.y, c.z, c.w, ca.x, ca.y, th, force))
               << k;
    }
    unsigned short* tl = reinterpret_cast<unsigned short*>(
        mb + tile_index(g, w, wc) * kGroup);
    tl[4 * lane + quarter] = p0 < count ? (unsigned short)bits0 : 0;
    tl[4 * (lane + 32) + quarter] = p1 < count ? (unsigned short)bits1 : 0;
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most `pending` of this thread's copy groups are in flight.
template <int pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending) : "memory");
}

// One warp copies tiles (g, g) and, if it exists, (g, g + 1) into dst,
// then commits the group of copies (empty past the last group, so that
// each walk step commits one group).
__device__ __forceinline__ void stage_group(u64 (*dst)[kGroup],
                                            const u64* mb, int g, int wc,
                                            int lane) {
  if (g < wc) {
    const u64* diag = mb + tile_index(g, g, wc) * kGroup;
    // 64 words are 32 copies of 16 bytes; the next tile follows the
    // diagonal one in memory (same row-group)
    cp_async16(&dst[0][2 * lane], diag + 2 * lane);
    if (g + 1 < wc) cp_async16(&dst[1][2 * lane], diag + kGroup + 2 * lane);
  }
  cp_async_commit();
}

__global__ void __launch_bounds__(kScanThreads)
    nms_keep_scan_kernel(const int* __restrict__ idx,
                         const int* __restrict__ counts,
                         const u64* __restrict__ mask,
                         uint8_t* __restrict__ keep, int n,
                         long long tiles_per_image) {
  extern __shared__ u64 sremoved[];  // ceil(N / 64) words
  // [stage][diagonal tile, next tile][row]
  __shared__ __align__(16) u64 stage[kStages][2][kGroup];
  __shared__ u64 skept[2];

  const int b = blockIdx.x;
  const int count = counts[b];
  if (count <= kCap) return;  // finished by the compaction block
  const int wc = (count + kGroup - 1) / kGroup;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int fw = warp - 1;  // far warps 0..kFarWarps - 1
  const u64* mb = mask + (size_t)b * tiles_per_image * kGroup;
  const int* ib = idx + (size_t)b * n;
  uint8_t* kb = keep + (size_t)b * n;

  for (int w = t; w < wc; w += kScanThreads) sremoved[w] = 0ull;
  if (warp == 1) {
    stage_group(stage[0], mb, 0, wc, lane);
    stage_group(stage[1], mb, 1, wc, lane);
    cp_async_wait<1>();
  }
  // far warps: rows lane and lane + 32 of far tile (g, g + 2 + fw + u *
  // kFarWarps) of the group the walk resolves, loaded a step ahead
  u64 held0[kFarHeld], held1[kFarHeld];
  int held_idx0 = 0, held_idx1 = 0;  // the last warp: the group's boxes
  auto load_held = [&](int g) {
#pragma unroll
    for (int u = 0; u < kFarHeld; ++u) {
      const int w = g + 2 + fw + u * kFarWarps;
      if (w < wc) {
        const u64* tl = mb + tile_index(g, w, wc) * kGroup;
        held0[u] = __ldg(tl + lane);
        held1[u] = __ldg(tl + lane + 32);
      }
    }
    if (warp == kFarWarps) {
      const int p0 = g * kGroup + lane;
      held_idx0 = p0 < count ? __ldg(ib + p0) : 0;
      held_idx1 = p0 + 32 < count ? __ldg(ib + p0 + 32) : 0;
    }
  };
  // group g's kept rows, resolved by the walk: their far words (tiles
  // (g, w), w >= g + 2) into the removed set, and keep = 1 for them (the
  // last warp). Word g + 1, the near word, warp 0 ORed when it resolved g.
  auto finish_group = [&](int g, u64 kept) {
    if (!kept) return;  // the same on every thread
    const bool k0 = (kept >> lane) & 1ull, k1 = (kept >> (lane + 32)) & 1ull;
#pragma unroll
    for (int u = 0; u < kFarHeld; ++u) {
      const int w = g + 2 + fw + u * kFarWarps;
      if (w < wc) {  // the same on every lane
        const u64 o = warp_or((k0 ? held0[u] : 0ull) | (k1 ? held1[u] : 0ull));
        if (lane == 0) sremoved[w] |= o;
      }
    }
    for (int w0 = g + 2 + fw + kFarHeld * kFarWarps; w0 < wc;
         w0 += kFarWarps * kFarUnroll) {
      u64 a[kFarUnroll];
#pragma unroll
      for (int u = 0; u < kFarUnroll; ++u) {
        const int w = w0 + u * kFarWarps;
        a[u] = 0ull;
        if (w < wc) {
          const u64* tl = mb + tile_index(g, w, wc) * kGroup;
          if (k0) a[u] = __ldg(tl + lane);
          if (k1) a[u] |= __ldg(tl + lane + 32);
        }
      }
#pragma unroll
      for (int u = 0; u < kFarUnroll; ++u) {
        const int w = w0 + u * kFarWarps;
        if (w < wc) {  // the same on every lane
          const u64 o = warp_or(a[u]);
          if (lane == 0) sremoved[w] |= o;
        }
      }
    }
    if (warp == kFarWarps) {
      if (k0) kb[held_idx0] = 1;
      if (k1) kb[held_idx1] = 1;
    }
  };
  if (warp > 0) load_held(0);
  __syncthreads();

  u64 near = 0ull;  // warp 0: group k - 1's kept rows' word k
  for (int k = 0; k < wc; ++k) {
    if (warp == 0) {
      const u64(*st)[kGroup] = stage[k % kStages];
      const u64 live = live_rows(k, count);
      const u64 d0 = st[0][lane], d1 = st[0][lane + 32];
      const u64 nz = ((u64)__ballot_sync(kFull, d0 != 0ull) |
                      ((u64)__ballot_sync(kFull, d1 != 0ull) << 32)) &
                     live;
      const u64 kept =
          resolve(sremoved[k] | near, live, nz, StagedDiag{st[0]});
      if (k + 1 < wc) {
        u64 a = (kept >> lane) & 1ull ? st[1][lane] : 0ull;
        if ((kept >> (lane + 32)) & 1ull) a |= st[1][lane + 32];
        near = warp_or(a);
      }
      if (lane == 0) skept[k & 1] = kept;
    } else {
      if (warp == 1) stage_group(stage[(k + 2) % kStages], mb, k + 2, wc,
                                 lane);
      if (k > 0) {
        finish_group(k - 1, skept[(k - 1) & 1]);
        load_held(k);
      }
      if (warp == 1) cp_async_wait<1>();  // group k + 1 has landed
    }
    __syncthreads();
  }
  if (warp > 0) finish_group(wc - 1, skept[(wc - 1) & 1]);
}

}  // namespace

// boxes (B, N, 4) f32 corner, cls (B, N) f32, valid (B, N) u8 (0/1), all
// contiguous on the device; workspaces idx (B, N) i32, counts (B,) i32,
// cbox (B, N) float4 and cattr (B, N) float2 (an image's compacted boxes,
// areas and classes, above the cap), mask (B, tiles * 64) u64 with tiles =
// W (W + 1) / 2, W = ceil(N / 64); keep (B, N) u8 output. cap and
// mask_blocks are the wrapper's plan (ops/nms.py: nms_plan): returns -1 if
// cap is not the built kCap or mask_blocks < 1, else the CUDA error of the
// launches.
extern "C" int nms_keep_f32(const float* boxes, const float* cls,
                            const uint8_t* valid, int* idx, int* counts,
                            float* cbox, float* cattr,
                            unsigned long long* mask, uint8_t* keep,
                            int batch, int n, float thresh, int force,
                            int cap, int mask_blocks, cudaStream_t stream) {
  if (cap != kCap || mask_blocks < 1) return -1;
  const int words = (n + kGroup - 1) / kGroup;
  const long long tiles = (long long)words * (words + 1) / 2;
  unsigned bits;
  memcpy(&bits, &thresh, sizeof bits);
  const Threshold th{
      0.5 * ((double)thresh + (double)nextafterf(thresh, INFINITY)),
      (int)(bits & 1u)};
  float4* cb4 = reinterpret_cast<float4*>(cbox);
  float2* ca2 = reinterpret_cast<float2*>(cattr);
  nms_keep_compact_kernel<<<batch, kCompactThreads, 0, stream>>>(
      boxes, cls, valid, idx, counts, cb4, ca2, keep, n, th, force);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  nms_keep_mask_kernel<<<dim3(mask_blocks, batch), kMaskThreads, 0,
                         stream>>>(cb4, ca2, counts, mask, n, tiles, th,
                                   force);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t removed_bytes = (size_t)words * sizeof(u64);
  if (removed_bytes > 40 * 1024) {
    err = cudaFuncSetAttribute(nms_keep_scan_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)removed_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  nms_keep_scan_kernel<<<batch, kScanThreads, removed_bytes, stream>>>(
      idx, counts, mask, keep, n, tiles);
  return (int)cudaGetLastError();
}
