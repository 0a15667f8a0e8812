// Multi-query ragged paged attention for Hopper (sm_90a), fp32, written by
// hand: the speculative decode's verify step.
//
// Replaces the TPU kernel mxnet_tpu/ops/pallas_kernels.py:_paged_spec_kernel
// (launched by ragged_spec_attention). Same function: each slot carries W
// query rows (its committed token and up to W-1 draft tokens, in position
// order) that all read ONE page-table row of a (P, page_size, KH, D) pool.
// Row w of slot s has its own limit seq_lens[s*W + w] (its absolute
// position + 1): it attends positions < that limit, so the ragged limits
// alone carry the causality between draft rows. GQA: query head h reads kv
// head h / (H / KH). A row whose limit is 0 (an inactive slot, a padded
// draft row) writes exact zeros, never 0/0. At W = 1 it is
// paged_attention.cu's decode function.
//
// What replaces what. The Pallas grid (S, max_pages) walked a slot's pages
// in order on one core with all W*H rows in VMEM scratch. The port's first
// design did the same walk in one block per (slot, kv head): a long slot
// ran serially on one SM while short ones finished, staging waited on
// every load, and at W = 5 three of the block's eight warps only staged.
// This design (paged_attention.cu's split, adapted to W rows sharing one
// table row):
//   * one block per (slot, kv head, row chunk, span of kSpan positions).
//     The query vectors ("units") of a (slot, kv head) are its W x groups
//     rows, unit = w * groups + g; a row chunk holds kMaxUnits of them
//     (more only where W x groups > 8). The grid, (S, KH x row chunks,
//     ceil(max_pages * page_size / kSpan)), comes from shapes alone, so a
//     shape always launches the same grid; span 0's blocks come first in
//     launch order, so a young batch's working blocks start at once. A
//     block whose span starts at or past every one of its units' limits
//     returns before it stages;
//   * K/V go through a 2-stage shared-memory ring of kTile-token tiles
//     filled with cp.async (16-byte cp.async.cg where D % 4 == 0 and the
//     pools are 16-byte aligned, 4-byte cp.async.ca otherwise; slots past
//     the span and columns past D zero-filled without a read). A tile may
//     span pages: the span's pool offsets sit in shared memory, from page
//     ids loaded beside the rows' limits. Each staged tile is read by every
//     unit of the block, so a slot's K/V crosses device memory once for
//     its W rows (per row chunk), which is the point of a multi-query
//     kernel;
//   * all 8 warps compute at any W x groups: warp i takes tokens
//     [4i, 4i + 4) of every tile for EVERY unit of the block, and the
//     warps' softmax states merge through shared memory at the span's end.
//     q (scaled, in log2 units) sits in shared memory and is read as a
//     broadcast. For q.k, DC lanes share a token, each owning kLD = 8
//     values of D, so a warp scores TG = 32 / DC tokens with log2(DC)
//     shuffles (the max across them only where a vote finds a score
//     above the running max); for p.v each lane owns D / 32 values of the
//     output (p broadcast by shuffles), so a unit's running state is
//     D / 32 + 2 registers and a block of 8 units stays in registers;
//   * merge in the same launch. A row whose limit is within span 0 is
//     finished by its span-0 block; a row of limit 0 gets its zeros from
//     its span-0 block; a block writes nothing for a row whose limit its
//     span starts at or past, so each output row is written exactly once.
//     The other rows' spans write partial (m, l, acc) to a workspace; then
//     each block fences, and thread 0 adds one to the (slot, kv head, row
//     chunk) tile's arrival counter. The block that sees the count of the
//     tile's active spans (ceil(largest limit / kSpan), the same in every
//     block of the tile) less one is the last: it merges those rows'
//     spans (weights exp(m_j - max m); a span with m = -inf weighs 0, never
//     exp(nan)) and resets the counter to 0. So a verify call is one launch
//     at every length, needs no host knowledge of the longest row, and a
//     replay of a captured launch finds its counters at 0.
//
// What bounds it on an H100: bytes. At the verify shape of the decode bench
// (16 slots, W = 5, 8 kv heads, D = 64) a layer reads 2 x 64 x 4 B = 512 B
// of K/V per token and head, against 5 x 4 x 64 flops: 2.5 flops a byte,
// far below the card's balance point, so the split (every SM streaming) and
// the ring (loads in flight during math) move it toward the bytes line.
// chip_smoke.py computes the bound from each run's own data.
//
// Shared memory: the ring (kStages x K and V tiles of kTile tokens of Ds
// floats; at the span's end the same space holds every warp's partial
// states), q of the block's units, and the span's kSpan token offsets:
// 26 KB at D <= 32, 35 KB at D <= 64, 69 KB at D <= 128, 137 KB at D <= 256.
// Above 48 KB the entry point first raises the kernel's dynamic
// shared-memory limit with cudaFuncSetAttribute, once per device and
// instance.
//
// Interface: a plain C entry point (bound with ctypes) that launches the
// kernel on the caller's stream and returns the CUDA error. The caller
// passes nsplit, which sizes its workspace, and the number of arrival
// counters, a zeroed int32 buffer it keeps (ops/paged_attention.py:
// _spec_plan mirrors this tiling); an entry point that finds either
// inconsistent with its grid returns -1 before any launch.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kWarp = 32;
constexpr int kWarps = 8;                  // warps per block
constexpr int kThreads = kWarps * kWarp;
constexpr int kMaxD = 256;
constexpr int kLD = 8;                     // D values a lane owns in q.k
constexpr int kTile = 32;                  // tokens per stage
constexpr int kStages = 2;
constexpr int kTPW = kTile / kWarps;       // tokens a warp takes of a tile
constexpr int kSpan = 128;                 // tokens per block
constexpr int kMaxUnits = kWarps;          // query vectors per block
constexpr int kMergeBatch = 8;             // spans a merge loads at once
constexpr int kMaxDevices = 64;
constexpr size_t kDefaultSmem = 48 * 1024;
static_assert(kSpan % kTile == 0, "a span is a whole number of tiles");
static_assert(kSpan <= kThreads, "a thread looks up one page of a span");

// The launch's shape.
struct Geo {
  int W, H, KH, D;
  int groups;      // query heads per kv head
  int units;       // W * groups: query vectors of one (slot, kv head)
  int rchunks;     // row chunks per (slot, kv head)
  int Ds;          // a staged token's stride in shared memory
  int page_size;
  int max_pages;
  int tokens;      // max_pages * page_size
  int nsplit;      // spans per row
  int vec;         // 16-byte staging
  float scale;     // softmax scale times log2(e): scores in log2 units
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy `bytes` (16 or 0: zero fill) from global to shared memory.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes));
}

// Copy `bytes` (4 or 0: zero fill) from global to shared memory.
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Start the copies of the span's tokens [t0, t0 + nt) into one stage (ks,
// vs: kTile tokens of Ds floats, kLD * DC of them staged); slots at or past
// nt, and columns at or past D, are zero-filled without a read. off[t] is
// the pool offset of the span's token t.
template <int DC>
__device__ __forceinline__ void stage_tile(float* ks, float* vs,
                                           const float* __restrict__ k_pool,
                                           const float* __restrict__ v_pool,
                                           const long long* off, int t0,
                                           int nt, const Geo& g) {
  if (g.vec) {
    constexpr int kPer = kLD * DC / 4;  // float4 chunks a token
    for (int idx = threadIdx.x; idx < kTile * kPer; idx += kThreads) {
      const int t = idx / kPer;
      const int d = (idx - t * kPer) * 4;
      const bool live = t < nt && d < g.D;
      const long long o = live ? off[t0 + t] + d : 0;
      cp_async16(ks + t * g.Ds + d, k_pool + o, live ? 16 : 0);
      cp_async16(vs + t * g.Ds + d, v_pool + o, live ? 16 : 0);
    }
  } else {
    constexpr int kPer = kLD * DC;  // floats a token
    for (int idx = threadIdx.x; idx < kTile * kPer; idx += kThreads) {
      const int t = idx / kPer;
      const int d = idx - t * kPer;
      const bool live = t < nt && d < g.D;
      const long long o = live ? off[t0 + t] + d : 0;
      cp_async4(ks + t * g.Ds + d, k_pool + o, live ? 4 : 0);
      cp_async4(vs + t * g.Ds + d, v_pool + o, live ? 4 : 0);
    }
  }
}

// The kLD values of D lane chunk dc owns in q.k: float4 chunks dc and
// dc + DC, so the DC lanes of a token read 16 DC contiguous bytes at once.
template <int DC>
__device__ __forceinline__ void load_lane(const float* rowp, int dc,
                                          float* x) {
#pragma unroll
  for (int c = 0; c < kLD / 4; ++c) {
    const float4 a = reinterpret_cast<const float4*>(rowp)[dc + c * DC];
    x[4 * c] = a.x;
    x[4 * c + 1] = a.y;
    x[4 * c + 2] = a.z;
    x[4 * c + 3] = a.w;
  }
}

// Lanes that share a token in q.k: each owns kLD values of D.
__host__ __device__ constexpr int lanes_per_token(int D) {
  return D <= 32 ? 4 : D <= 64 ? 8 : D <= 128 ? 16 : 32;
}

// A staged token's stride in floats. Where a quarter warp reads two tokens
// (DC = 4), the second starts 64 bytes further modulo 128, so the quarter
// warp's eight 16-byte reads land in eight bank groups.
__host__ __device__ constexpr int row_stride(int DC) {
  return kLD * DC + (DC < 8 ? 4 * DC : 0);
}

// The kernel's dynamic shared memory: the ring, q, the offsets.
__host__ __device__ constexpr size_t smem_bytes(int DC) {
  return (2 * kStages * static_cast<size_t>(kTile) * row_stride(DC) +
          static_cast<size_t>(kMaxUnits) * kLD * DC) * sizeof(float) +
         kSpan * sizeof(long long);
}

// The warps' partial states at the span's end fit in the ring.
static_assert(kWarps * kMaxUnits * (2 + kLD * 32) <=
                  2 * kStages * kTile * row_stride(32) &&
              kWarps * kMaxUnits * (2 + kLD * 4) <=
                  2 * kStages * kTile * row_stride(4),
              "the partial states fit in the ring");

// 2^x on the special-function unit (relative error about 2^-22); 0 at -inf.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ int unit_limit(const int* __restrict__ seq_lens,
                                          int s, int w, const Geo& g) {
  return max(0, min(__ldg(seq_lens + s * g.W + w), g.tokens));
}

// DC = lanes per token in q.k (D <= kLD * DC); PL = DC / 4 output values
// a lane owns (lane + 32 i).
// Shared memory: ks[kStages][kTile][Ds], vs[kStages][kTile][Ds] (at the
// span's end the same space holds part[kWarps][kMaxUnits][2 + Dpad]), then
// qs[kMaxUnits][Dpad], then off[kSpan]. Workspace cell (row s * W + w,
// head h, span j): acc at ws_acc[cell * D], (m, l) at ws_ml[2 * cell].
template <int DC>
__global__ void __launch_bounds__(kThreads, DC <= 8 ? 3 : DC <= 16 ? 2 : 1)
paged_spec_attention_kernel(const float* __restrict__ q,
                            const float* __restrict__ k_pool,
                            const float* __restrict__ v_pool,
                            const int* __restrict__ page_table,
                            const int* __restrict__ seq_lens,
                            float* __restrict__ out,
                            float* __restrict__ ws_acc,
                            float* __restrict__ ws_ml,
                            int* __restrict__ arrivals, Geo g) {
  constexpr int TG = kWarp / DC;             // tokens a q.k step scores
  constexpr int TS = TG < kTPW ? TG : kTPW;  // ... of the warp's share
  constexpr int PL = DC / 4;                 // output values a lane owns
  constexpr int Dpad = kLD * DC;             // = 32 * PL
  extern __shared__ float4 smem4[];
  __shared__ int is_last;
  float* smem = reinterpret_cast<float*>(smem4);
  const int stage_floats = kTile * g.Ds;
  float* ks = smem;
  float* vs = ks + kStages * stage_floats;
  float* qs = vs + kStages * stage_floats;
  long long* off = reinterpret_cast<long long*>(qs + kMaxUnits * Dpad);

  const int s = blockIdx.x;
  const int kh = blockIdx.y / g.rchunks;
  const int u0 = (blockIdx.y - kh * g.rchunks) * kMaxUnits;
  const int units = min(kMaxUnits, g.units - u0);
  const int span0 = blockIdx.z * kSpan;

  // the page id of the span's position threadIdx.x, loaded beside the
  // units' limits (a position inside the table row; no page is read yet)
  const int* pt = page_table + static_cast<size_t>(s) * g.max_pages;
  const int tok = span0 + threadIdx.x;
  const int page = threadIdx.x < kSpan && tok < g.tokens
                       ? __ldg(pt + tok / g.page_size)
                       : 0;
  // each unit's limit, and the block's (the largest): uniform across the
  // block, so every thread reaches every barrier
  int lim[kMaxUnits];
  int blk_limit = 0;
  int min_limit = g.tokens;
#pragma unroll
  for (int u = 0; u < kMaxUnits; ++u) {
    lim[u] = u < units ? unit_limit(seq_lens, s, (u0 + u) / g.groups, g) : 0;
    blk_limit = max(blk_limit, lim[u]);
    if (u < units) min_limit = min(min_limit, lim[u]);
  }
  // a row with no position is exact zeros, written by its span-0 block
  if (blockIdx.z == 0 && min_limit == 0) {
    for (int i = threadIdx.x; i < units * g.D; i += kThreads) {
      const int u = i / g.D;
      const int w = (u0 + u) / g.groups;
      if (unit_limit(seq_lens, s, w, g) == 0) {
        const int h = kh * g.groups + (u0 + u) - w * g.groups;
        out[(static_cast<size_t>(s * g.W + w) * g.H + h) * g.D + i -
            u * g.D] = 0.f;
      }
    }
  }
  if (span0 >= blk_limit) return;  // nothing to read: stage nothing
  const int span_len = min(kSpan, blk_limit - span0);
  const int ntiles = (span_len + kTile - 1) / kTile;

  // each position's offset in the pools
  if (threadIdx.x < span_len) {
    off[threadIdx.x] = (static_cast<long long>(page) * g.page_size +
                        tok % g.page_size) *
                           (static_cast<long long>(g.KH) * g.D) +
                       static_cast<long long>(kh) * g.D;
  }
  __syncthreads();
  stage_tile<DC>(ks, vs, k_pool, v_pool, off, 0, min(kTile, span_len), g);
  cp_async_commit();
  // q of the block's units, scaled, zero past D, while the tile lands
  // (visible after the loop's first barrier)
  for (int i = threadIdx.x; i < units * Dpad; i += kThreads) {
    const int u = i / Dpad;
    const int d = i - u * Dpad;
    const int w = (u0 + u) / g.groups;
    const int h = kh * g.groups + (u0 + u) - w * g.groups;
    qs[i] = d < g.D ? __ldg(q + (static_cast<size_t>(s * g.W + w) * g.H +
                                 h) * g.D + d) * g.scale
                    : 0.f;
  }

  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int dc = lane % DC;  // this lane's chunk of D in q.k
  const int tg = lane / DC;  // ... and its token within a step
  float acc[kMaxUnits][PL];
  float m[kMaxUnits];  // uniform across the warp
  float l[kMaxUnits];  // uniform across the warp
#pragma unroll
  for (int u = 0; u < kMaxUnits; ++u) {
    m[u] = -CUDART_INF_F;
    l[u] = 0.f;
#pragma unroll
    for (int i = 0; i < PL; ++i) acc[u][i] = 0.f;
  }

  for (int it = 0; it < ntiles; ++it) {
    const int t0 = it * kTile;  // within the span
    if (it + 1 < ntiles) {
      const int t1 = t0 + kTile;
      const int st = (it + 1) % kStages;
      stage_tile<DC>(ks + st * stage_floats, vs + st * stage_floats, k_pool,
                     v_pool, off, t1, min(kTile, span_len - t1), g);
      cp_async_commit();
      cp_async_wait<1>();  // this tile has landed, the next is in flight
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* kt = ks + (it % kStages) * stage_floats;
    const float* vt = vs + (it % kStages) * stage_floats;
    const int base = warp * kTPW;  // the warp's first token of the tile
    if (base < span_len - t0) {    // uniform across the warp
#pragma unroll
      for (int s0 = 0; s0 < kTPW; s0 += TS) {
        const int pos = span0 + t0 + base + s0;  // the step's first token
        float kv[kLD];
        load_lane<DC>(kt + (base + s0 + (tg < TS ? tg : 0)) * g.Ds, dc, kv);
        float vv[TS][PL];
#pragma unroll
        for (int j = 0; j < TS; ++j) {
#pragma unroll
          for (int i = 0; i < PL; ++i)
            vv[j][i] = vt[(base + s0 + j) * g.Ds + lane + i * kWarp];
        }
#pragma unroll
        for (int u = 0; u < kMaxUnits; ++u) {
          if (u >= units || pos >= lim[u]) continue;  // uniform
          float qv[kLD];
          load_lane<DC>(qs + u * Dpad, dc, qv);
          float d0 = 0.f;
          float d1 = 0.f;
#pragma unroll
          for (int i = 0; i < kLD; i += 2) {
            d0 += qv[i] * kv[i];
            d1 += qv[i + 1] * kv[i + 1];
          }
          float sc = d0 + d1;
#pragma unroll
          for (int o = 1; o < DC; o <<= 1)
            sc += __shfl_xor_sync(0xffffffffu, sc, o);
          const bool ok = tg < TS && pos + tg < lim[u];
          sc = ok ? sc : -CUDART_INF_F;
          if (__any_sync(0xffffffffu, sc > m[u])) {  // the max rises
            float mx = sc;
#pragma unroll
            for (int o = DC; o < kWarp; o <<= 1)
              mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
            const float alpha = fast_exp2(m[u] - mx);  // 0 while m is -inf
            l[u] *= alpha;
#pragma unroll
            for (int i = 0; i < PL; ++i) acc[u][i] *= alpha;
            m[u] = mx;
          }
          const float p = ok ? fast_exp2(sc - m[u]) : 0.f;
#pragma unroll
          for (int j = 0; j < TS; ++j) {
            const float pj = __shfl_sync(0xffffffffu, p, j * DC);
            l[u] += pj;
#pragma unroll
            for (int i = 0; i < PL; ++i) acc[u][i] += pj * vv[j][i];
          }
        }
      }
    }
    __syncthreads();  // the stage is consumed before it is refilled
  }

  // every warp's state of every unit into the ring's space (consumed: the
  // loop ended on a barrier), then warp u merges unit u's
  constexpr int part = 2 + Dpad;
#pragma unroll
  for (int u = 0; u < kMaxUnits; ++u) {
    if (u >= units) break;
    float* p = smem + (warp * kMaxUnits + u) * part;
    if (lane == 0) {
      p[0] = m[u];
      p[1] = l[u];
    }
#pragma unroll
    for (int i = 0; i < PL; ++i) p[2 + lane + i * kWarp] = acc[u][i];
  }
  int my_lim = 0;  // warp's unit's limit, picked without a dynamic index
#pragma unroll
  for (int u = 0; u < kMaxUnits; ++u) my_lim = u == warp ? lim[u] : my_lim;
  const int my_w = (u0 + warp) / g.groups;
  const size_t my_row =
      static_cast<size_t>(s * g.W + my_w) * g.H + kh * g.groups +
      (u0 + warp) - my_w * g.groups;  // (row, head) of the warp's unit
  __syncthreads();
  // a span at or past a unit's limit (the block ran for another of its
  // units) holds nothing of it: only the unit's own spans write
  if (warp < units && span0 < my_lim) {
    float mx = -CUDART_INF_F;
    for (int k = 0; k < kWarps; ++k)
      mx = fmaxf(mx, smem[(k * kMaxUnits + warp) * part]);
    float tot = 0.f;
    float o[PL];
#pragma unroll
    for (int i = 0; i < PL; ++i) o[i] = 0.f;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) {
      const float* p = smem + (k * kMaxUnits + warp) * part;
      // a warp that saw no token has m = -inf: weight 0, never exp(nan)
      const float w = p[0] == -CUDART_INF_F ? 0.f : fast_exp2(p[0] - mx);
      tot += p[1] * w;
#pragma unroll
      for (int i = 0; i < PL; ++i) o[i] += p[2 + lane + i * kWarp] * w;
    }
    if (my_lim <= kSpan) {
      // span 0 is the unit's only one: finish its row here
      const float inv = tot > 0.f ? 1.f / tot : 0.f;
      float* orow = out + my_row * g.D;
#pragma unroll
      for (int i = 0; i < PL; ++i) {
        const int d = lane + i * kWarp;
        if (d < g.D) orow[d] = o[i] * inv;
      }
    } else {
      const size_t cell = my_row * g.nsplit + blockIdx.z;
      float* a = ws_acc + cell * g.D;
#pragma unroll
      for (int i = 0; i < PL; ++i) {
        const int d = lane + i * kWarp;
        if (d < g.D) a[d] = o[i];
      }
      if (lane == 0) {
        ws_ml[2 * cell] = mx;
        ws_ml[2 * cell + 1] = tot;
      }
    }
  }

  // the tile's active spans; with one, span 0 finished every row
  const int nact = (blk_limit + kSpan - 1) / kSpan;
  if (nact <= 1) return;
  __threadfence();  // this block's partial states, before its arrival
  __syncthreads();
  if (threadIdx.x == 0) {
    int* c = arrivals + blockIdx.x * gridDim.y + blockIdx.y;
    const int last = atomicAdd(c, 1) == nact - 1;
    if (last) *c = 0;  // every span has arrived: ready for the next launch
    is_last = last;
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();

  // the last block: warp u combines unit u's spans below
  // ceil(limit / kSpan), kMergeBatch at a time (their loads in flight
  // together, through L2), if the unit has two spans or more
  if (warp >= units || my_lim <= kSpan) return;
  const int ns = (my_lim + kSpan - 1) / kSpan;
  const float* ml = ws_ml + my_row * g.nsplit * 2;
  const float* a = ws_acc + my_row * g.nsplit * g.D;
  float mx = -CUDART_INF_F;
  float total = 0.f;
  float o[PL];
#pragma unroll
  for (int i = 0; i < PL; ++i) o[i] = 0.f;
  for (int j0 = 0; j0 < ns; j0 += kMergeBatch) {
    float mj[kMergeBatch], lj[kMergeBatch], av[kMergeBatch][PL];
#pragma unroll
    for (int k = 0; k < kMergeBatch; ++k) {
      const int j = j0 + k;
      const bool in = j < ns;
      mj[k] = in ? __ldcg(ml + 2 * j) : -CUDART_INF_F;
      lj[k] = in ? __ldcg(ml + 2 * j + 1) : 0.f;
#pragma unroll
      for (int i = 0; i < PL; ++i) {
        const int d = lane + i * kWarp;
        av[k][i] = in && d < g.D
                       ? __ldcg(a + static_cast<size_t>(j) * g.D + d)
                       : 0.f;
      }
    }
    float bm = mx;
#pragma unroll
    for (int k = 0; k < kMergeBatch; ++k) bm = fmaxf(bm, mj[k]);
    if (bm == -CUDART_INF_F) continue;
    const float alpha = fast_exp2(mx - bm);  // 0 while mx is -inf
    total *= alpha;
#pragma unroll
    for (int i = 0; i < PL; ++i) o[i] *= alpha;
    mx = bm;
#pragma unroll
    for (int k = 0; k < kMergeBatch; ++k) {
      // a span that saw no token has m = -inf: weight 0, never exp(nan)
      const float w = mj[k] == -CUDART_INF_F ? 0.f : fast_exp2(mj[k] - mx);
      total += lj[k] * w;
#pragma unroll
      for (int i = 0; i < PL; ++i) o[i] += av[k][i] * w;
    }
  }
  // a total of 0 (no span weighed anything): exact zeros
  const float inv = total > 0.f ? 1.f / total : 0.f;
  float* orow = out + my_row * g.D;
#pragma unroll
  for (int i = 0; i < PL; ++i) {
    const int d = lane + i * kWarp;
    if (d < g.D) orow[d] = o[i] * inv;
  }
}

// Raise the kernel's dynamic shared-memory limit to what a launch of it
// asks, once per device.
template <int DC>
cudaError_t allow_smem() {
  static std::atomic<bool> done[kMaxDevices];
  if (smem_bytes(DC) <= kDefaultSmem) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev].load(std::memory_order_relaxed))
    return cudaSuccess;
  err = cudaFuncSetAttribute(paged_spec_attention_kernel<DC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_bytes(DC)));
  if (err == cudaSuccess && dev < kMaxDevices)
    done[dev].store(true, std::memory_order_relaxed);
  return err;
}

struct Launch {
  dim3 grid;
  cudaStream_t stream;
  const float* q;
  const float* k_pool;
  const float* v_pool;
  const int* page_table;
  const int* seq_lens;
  float* out;
  float* ws_acc;
  float* ws_ml;
  int* arrivals;
  Geo g;
};

template <int DC>
cudaError_t launch(const Launch& a) {
  cudaError_t err = allow_smem<DC>();
  if (err != cudaSuccess) return err;
  paged_spec_attention_kernel<DC>
      <<<a.grid, kThreads, smem_bytes(DC), a.stream>>>(
          a.q, a.k_pool, a.v_pool, a.page_table, a.seq_lens, a.out,
          a.ws_acc, a.ws_ml, a.arrivals, a.g);
  return cudaGetLastError();
}

}  // namespace

// q (S, W, H, D), k_pool/v_pool (P, page_size, KH, D), out (S, W, H, D):
// fp32, contiguous. page_table (S, max_pages), seq_lens (S*W,): int32,
// contiguous. workspace: S * W * H * nsplit * (D + 2) floats, any content;
// arrivals: `tiles` = S * KH * ceil(W * groups / 8) int32, zero before the
// launch and zero after it. Every page id below a slot's largest row limit
// must be < P.
extern "C" int paged_spec_attention_f32(
    const float* q, const float* k_pool, const float* v_pool,
    const int* page_table, const int* seq_lens, float* out, float* workspace,
    int* arrivals, int S, int W, int H, int KH, int D, int page_size,
    int max_pages, int nsplit, int tiles, float scale, void* stream) {
  if (S <= 0) return static_cast<int>(cudaSuccess);
  if (W < 1 || D < 1 || D > kMaxD || KH < 1 || H < KH || H % KH != 0 ||
      page_size < 1 || max_pages < 1 ||
      static_cast<long long>(max_pages) * page_size > (1LL << 30)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Launch a;
  Geo& g = a.g;
  g.W = W;
  g.H = H;
  g.KH = KH;
  g.D = D;
  g.groups = H / KH;
  g.units = W * g.groups;
  g.rchunks = (g.units + kMaxUnits - 1) / kMaxUnits;
  const int dc = lanes_per_token(D);
  g.Ds = row_stride(dc);
  g.page_size = page_size;
  g.max_pages = max_pages;
  g.tokens = max_pages * page_size;
  g.nsplit = nsplit;
  g.vec = D % 4 == 0 && reinterpret_cast<uintptr_t>(k_pool) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(v_pool) % 16 == 0;
  g.scale = scale * 1.4426950408889634f;  // log2(e): scores in log2 units
  // the caller's workspace and counters (ops/paged_attention.py:
  // _spec_plan) must match this build's span and row chunks
  if (nsplit != (g.tokens + kSpan - 1) / kSpan ||
      tiles != static_cast<long long>(S) * KH * g.rchunks) {
    return -1;
  }
  a.grid = dim3(S, KH * g.rchunks, nsplit);
  if (static_cast<long long>(KH) * g.rchunks > 65535 || nsplit > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  a.stream = static_cast<cudaStream_t>(stream);
  a.q = q;
  a.k_pool = k_pool;
  a.v_pool = v_pool;
  a.page_table = page_table;
  a.seq_lens = seq_lens;
  a.out = out;
  a.ws_acc = workspace;
  a.ws_ml = workspace + static_cast<size_t>(S) * W * H * nsplit * D;
  a.arrivals = arrivals;
  cudaError_t err;
  switch (dc) {
    case 4: err = launch<4>(a); break;
    case 8: err = launch<8>(a); break;
    case 16: err = launch<16>(a); break;
    default: err = launch<32>(a);
  }
  return static_cast<int>(err);
}
