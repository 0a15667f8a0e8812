// Paged attention for Hopper (sm_90a), fp32, written by hand: the decode
// tick's one-row attention and the prefill chunk's attention.
//
// Replaces the TPU kernel mxnet_tpu/ops/pallas_kernels.py:_paged_kernel
// (launched by ragged_paged_attention, and through it by
// paged_prefill_attention). Same function: a query row attends over its
// sequence's pages of a (P, page_size, KH, D) pool, read through a page
// table, with an online softmax. GQA: query head h reads kv head
// h / (H / KH). A row attends its first `limit` positions:
//   * decode (paged_attention_f32): row s = slot s, its own table row,
//     limit = min(seq_lens[s], q_pos[s] + 1) (q_pos optional);
//   * chunk (paged_prefill_attention_f32, or _dev_f32 with start and
//     length read on the device): C rows of ONE sequence share one table
//     row; row i sits at position start + i, so its limit is
//     start + i + 1, and a padding row (i >= length) has limit 0.
// A row with limit 0 returns exact zeros. Padded table entries point at
// the null page 0; no block reads a position at or past its rows' limit,
// so they are never loaded.
//
// What replaces what. The Pallas grid (S, max_pages) walked a slot's
// pages in order on one core, carrying m/l/acc in VMEM. The port's first
// design did the same walk in one block per (slot, kv head): one long
// slot ran serially on one SM while the short ones finished, staging
// waited on every load, and each row of a prefill chunk was its own block
// that read the sequence's K/V again. This design:
//   * splits each row's positions into spans of kSpan tokens, one block
//     per (row tile, kv head [, group chunk], span): flash-decoding. The
//     span count, ceil(max_pages * page_size / kSpan), comes from shapes
//     alone, so a shape always launches the same grid. A block whose span
//     starts at or past its rows' largest limit returns before it stages
//     anything. Each block writes, per query vector, its partial softmax
//     state (m, l, acc[D]) to a workspace the wrapper allocates;
//     paged_attention_merge_kernel then combines a row's spans below
//     ceil(limit / kSpan), weighting span j by exp(m_j - max m) (a span
//     with m = -inf weighs 0, never exp(nan)) and writing exact zeros
//     where the total is 0. A row that fits in one span (most decode
//     rows of a young batch) is finished by the block of span 0 alone,
//     as is a row with no position (exact zeros); the merge leaves both
//     alone, and is not launched where no row can reach a second span
//     (a decode table of at most kSpan positions, a chunk that ends by
//     position kSpan);
//   * stages K/V through a 2-stage shared-memory ring of kTile-token tiles
//     filled with cp.async (16-byte cp.async.cg where D % 4 == 0 and the
//     pools are 16-byte aligned, 4-byte cp.async.ca otherwise), so the
//     next tile's loads are in flight while the current tile's math runs.
//     A tile may span pages: every token's page comes from the table.
//     Slots past the span's end, and columns past D, are zero-filled
//     without a read;
//   * holds up to kMaxUnits = 8 query vectors ("units") per block, all of
//     one kv head and one table row: the groups query heads of a decode
//     row, or 8 / gpb chunk rows x gpb heads (gpb = min(groups, 8)).
//     Every staged K/V tile is read by all of them, so a chunk's K/V
//     crosses device memory once per tile of rows, not once per row;
//   * a warp owns one unit; a lane owns kLD = 16 values of D (four float4)
//     of one token: DC = ceil(D / 16) lanes share a token (rounded up to
//     a power of two), a warp steps through TG = 32 / DC tokens at once,
//     and q, scaled, sits in the lane's registers. Where a block has fewer
//     units than warps (a decode row), the ws warps of a unit split each
//     tile's tokens and merge their states through shared memory at the
//     span's end, so the warps of a one-vector block all compute;
//   * the online softmax keeps m uniform across the warp and l and acc
//     per lane (partial over the lane's tokens), rescales only when the
//     running max rises, takes exponentials in base 2 on the
//     special-function unit, and sums l and acc across token groups once
//     per span.
//
// What bounds it on an H100. Decode: bytes. At the decode bench shape
// (16 slots, 8 kv heads, D = 64) a layer reads 2 x 64 x 4 B = 512 B of
// K/V per token and head against 4 x 64 flops: 0.5 flop a byte, far below
// the card's balance point, so the split (every SM streaming) and the
// ring (loads in flight during math) are what move it toward the bytes
// line. A 64-row chunk: operations on the SIMT fp32 pipe by the card's
// peaks (4 * D flops per row, head and position, over K/V that fits in
// L2); each of a block's 8 warps reads the whole staged tile from shared
// memory, 8 x 16 KB a tile at D = 64.
// chip_smoke.py computes both bounds from each run's own data.
//
// Shared memory: kStages x (K and V) tiles of kTile tokens of Ds floats
// (the span's end reuses them for the warps' partial states) and the
// span's kSpan token offsets: 41 KB at D <= 64, 65 KB at D <= 128, 129 KB
// at D <= 256. Above 48 KB the entry point first raises the kernel's
// dynamic shared-memory limit with cudaFuncSetAttribute, once per device
// and instance. Residency: __launch_bounds__(256, 3) caps the split
// kernel at 80 registers a thread (ptxas uses 80, no spill), so three
// blocks, 24 warps, share an SM at D <= 128, each with a tile in flight.
//
// Interface: three plain C entry points (bound with ctypes): decode, a
// chunk with (start, length) as launch arguments, and a chunk with them
// on the device (what a captured CUDA graph replays). Each launches the
// split kernel and, where a row may cover two spans, the merge kernel on
// the caller's stream and returns the first CUDA error. A chunk
// block holds kMaxUnits / gpb rows. The caller passes nsplit, which sizes
// its workspace (ops/paged_attention.py:_split_plan mirrors this tiling);
// an entry point that finds it inconsistent with kSpan returns -1 before
// any launch.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kWarp = 32;
constexpr int kWarps = 8;                    // warps per split block
constexpr int kThreads = kWarps * kWarp;
constexpr int kMaxD = 256;
constexpr int kLD = 16;                      // D values a lane owns
constexpr int kTile = 32;                    // tokens per stage
constexpr int kStages = 2;
constexpr int kSpan = 128;                   // tokens per block
constexpr int kMaxUnits = kWarps;            // units per block, one a warp
constexpr int kMergeWarps = 8;               // (row, head) pairs per block
constexpr int kMergeBatch = 8;               // spans a merge loads at once
constexpr int kMaxDevices = 64;
constexpr size_t kDefaultSmem = 48 * 1024;
static_assert(kSpan % kTile == 0, "a span is a whole number of tiles");
static_assert(kSpan <= kThreads, "a thread looks up one page of a span");

// Which positions each row attends.
struct Rows {
  const int* seq_lens;  // decode: per-row lengths; null for a chunk
  const int* q_pos;     // decode: causal bound per row, or null
  int start;            // chunk: row i sits at position start + i
  int length;           // chunk: rows >= length are padding
  const int* chunk;     // chunk: (start, length) on the device, which
                        // then stand for the two above; or null
  int tokens;           // max_pages * page_size
};

// The launch's shape.
struct Geo {
  int rows;        // query rows (slots or chunk rows)
  int H, KH, D;
  int Dpad;        // D padded to kLD * DC: the floats staged per token
  int Ds;          // a staged token's stride in shared memory
  int page_size;
  int pt_stride;   // page-table ints between rows: max_pages, 0 for a chunk
  int groups;      // query heads per kv head
  int gpb;         // query heads per block
  int rows_tile;   // rows per block
  int nsplit;      // spans per row
  int ws;          // warps per unit set (they split a tile's tokens)
  int vec;         // 16-byte staging
  float scale;     // softmax scale times log2(e): scores in log2 units
};

__device__ __forceinline__ int row_limit(const Rows& r, int row) {
  int lim;
  if (r.seq_lens != nullptr) {
    lim = __ldg(r.seq_lens + row);
    if (r.q_pos != nullptr) lim = min(lim, __ldg(r.q_pos + row) + 1);
  } else {
    const int start = r.chunk != nullptr ? __ldg(r.chunk) : r.start;
    const int length = r.chunk != nullptr ? __ldg(r.chunk + 1) : r.length;
    lim = row < length ? start + row + 1 : 0;
  }
  return max(0, min(lim, r.tokens));
}

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

// Start the copies of tokens [t0, t0 + nt) of kv head kh into one stage
// (ks, vs: kTile tokens of Ds floats, Dpad = kLD * DC of them staged);
// slots at or past nt, and columns at or past D, are zero-filled without a
// read. off[t] is the pool offset of the span's token t (its page looked
// up in the table once per block). The one staging routine of both entry
// points.
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

// Where value i (< kLD) of lane chunk dc sits in a row: float4 chunks
// dc, dc + DC, dc + 2 DC, dc + 3 DC, so the DC lanes of a token read
// 16 DC contiguous bytes at a time.
template <int DC>
__device__ __forceinline__ int dim_of(int dc, int i) {
  return (dc + (i >> 2) * DC) * 4 + (i & 3);
}

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

// Lanes that share a token: each owns kLD values of D.
__host__ __device__ constexpr int lanes_per_token(int D) {
  return D <= 32 ? 2 : D <= 64 ? 4 : D <= 128 ? 8 : 16;
}

// A staged token's stride in floats. Where a quarter warp reads 8 / DC
// tokens (DC < 8), their rows start DC float4 apart modulo 8, so the
// quarter warp's eight 16-byte reads land in eight bank groups.
__host__ __device__ constexpr int row_stride(int DC) {
  return kLD * DC + (DC < 8 ? 4 * DC : 0);
}

// The split kernel's dynamic shared memory: the ring and the offsets.
__host__ __device__ constexpr size_t smem_bytes(int DC) {
  return 2 * kStages * static_cast<size_t>(kTile) * row_stride(DC) *
             sizeof(float) + kSpan * sizeof(long long);
}

// 2^x on the special-function unit (relative error about 2^-22); 0 at -inf.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// DC = lanes per token (D <= kLD * DC).
// Shared memory: ks[kStages][kTile][Ds], vs[kStages][kTile][Ds] (at the
// span's end the same space holds each warp's partial state,
// part[kWarps][2 + Dpad]), then off[kSpan], the span's token offsets.
// Scores are kept in log2 units (scale carries log2(e)).
template <int DC>
__global__ void __launch_bounds__(kThreads, 3)
paged_attention_split_kernel(const float* __restrict__ q,
                             const float* __restrict__ k_pool,
                             const float* __restrict__ v_pool,
                             const int* __restrict__ page_table, Rows rows,
                             float* __restrict__ out,
                             float* __restrict__ ws_acc,
                             float* __restrict__ ws_ml, Geo g) {
  constexpr int TG = kWarp / DC;  // tokens a warp steps through at once
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int stage_floats = kTile * g.Ds;
  float* ks = smem;
  float* vs = ks + kStages * stage_floats;
  long long* off = reinterpret_cast<long long*>(vs + kStages * stage_floats);

  const int r0 = blockIdx.x * g.rows_tile;
  const int gchunks = (g.groups + g.gpb - 1) / g.gpb;
  const int kh = blockIdx.y / gchunks;
  const int g0 = (blockIdx.y - kh * gchunks) * g.gpb;
  const int gpb = min(g.gpb, g.groups - g0);    // heads in this block
  const int nrows = min(g.rows_tile, g.rows - r0);
  const int units = nrows * gpb;
  const int span0 = blockIdx.z * kSpan;

  // the page id of the span's position threadIdx.x, loaded beside the
  // rows' limits (a position inside the table row; no page is read yet)
  const int* pt = page_table + static_cast<size_t>(r0) * g.pt_stride;
  const int tok = span0 + threadIdx.x;
  const int page = threadIdx.x < kSpan && tok < rows.tokens
                       ? __ldg(pt + tok / g.page_size)
                       : 0;
  // the block's limit, the largest of its rows': uniform across the
  // block, so every thread reaches every barrier
  int blk_limit = 0;
  int min_limit = rows.tokens;
  for (int i = 0; i < nrows; ++i) {
    const int lim_i = row_limit(rows, r0 + i);
    blk_limit = max(blk_limit, lim_i);
    min_limit = min(min_limit, lim_i);
  }
  // a row with no position is exact zeros, written by its span-0 block
  // (the merge sees only rows of two spans or more)
  if (blockIdx.z == 0 && min_limit == 0) {
    for (int i = threadIdx.x; i < units * g.D; i += kThreads) {
      const int uu = i / g.D;
      const int rr = r0 + uu / gpb;
      if (row_limit(rows, rr) == 0) {
        const int hh = kh * g.groups + g0 + uu % gpb;
        out[(static_cast<size_t>(rr) * g.H + hh) * g.D + i - uu * g.D] = 0.f;
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

  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int dc = lane % DC;             // this lane's chunk of D
  const int tg = lane / DC;             // ... and its token within a step
  const int u = warp / g.ws;            // this warp's unit
  const int slice = warp - u * g.ws;    // its share of each tile
  const int tpw = kTile / g.ws;         // tokens per warp and tile
  const bool computes = u < units;      // uniform across the warp
  const int r = r0 + (computes ? u / gpb : 0);
  const int h = kh * g.groups + g0 + (computes ? u % gpb : 0);
  const int lim = computes ? row_limit(rows, r) : 0;

  // q in registers (zero past D), the running state
  float qr[kLD];
  float acc[kLD];
  const float* qrow = q + (static_cast<size_t>(r) * g.H + h) * g.D;
#pragma unroll
  for (int i = 0; i < kLD; ++i) {
    const int d = dim_of<DC>(dc, i);
    qr[i] = computes && d < g.D ? __ldg(qrow + d) * g.scale : 0.f;
    acc[i] = 0.f;
  }
  float m = -CUDART_INF_F;  // uniform across the warp
  float l = 0.f;            // this lane's tokens only

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
    const int s_end = min(slice * tpw + tpw, span_len - t0);
    if (computes) {
      for (int s0 = slice * tpw; s0 < s_end; s0 += TG) {
        const int t = s0 + tg;  // this lane's token in the tile
        float kv[kLD];
        load_lane<DC>(kt + t * g.Ds, dc, kv);
        float d0 = 0.f;
        float d1 = 0.f;
#pragma unroll
        for (int i = 0; i < kLD; i += 2) {
          d0 += qr[i] * kv[i];
          d1 += qr[i + 1] * kv[i + 1];
        }
        float sc = d0 + d1;
#pragma unroll
        for (int o = 1; o < DC; o <<= 1)
          sc += __shfl_xor_sync(0xffffffffu, sc, o);
        const bool ok = span0 + t0 + t < lim;
        sc = ok ? sc : -CUDART_INF_F;
        float mx = sc;
#pragma unroll
        for (int o = DC; o < kWarp; o <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        if (mx > m) {  // uniform: the running max rises
          const float alpha = fast_exp2(m - mx);  // 0 while m is -inf
          l *= alpha;
#pragma unroll
          for (int i = 0; i < kLD; ++i) acc[i] *= alpha;
          m = mx;
        }
        const float p = ok ? fast_exp2(sc - m) : 0.f;
        l += p;
        float vv[kLD];
        load_lane<DC>(vt + t * g.Ds, dc, vv);
#pragma unroll
        for (int i = 0; i < kLD; ++i) acc[i] += p * vv[i];
      }
    }
    __syncthreads();  // the stage is consumed before it is refilled
  }

  // sum l and acc over the warp's token groups
#pragma unroll
  for (int o = DC; o < kWarp; o <<= 1) {
    l += __shfl_xor_sync(0xffffffffu, l, o);
#pragma unroll
    for (int i = 0; i < kLD; ++i)
      acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], o);
  }
  // merge the ws warps of each unit through shared memory (the stages
  // are consumed: the loop ended on a barrier), then write the span's
  // state
  const int part = 2 + g.Dpad;
  if (computes && tg == 0) {
    float* p = smem + warp * part;
    if (lane == 0) {
      p[0] = m;
      p[1] = l;
    }
#pragma unroll
    for (int i = 0; i < kLD; ++i) p[2 + dim_of<DC>(dc, i)] = acc[i];
  }
  __syncthreads();
  if (!computes || slice != 0) return;
  float mx = -CUDART_INF_F;
  for (int k = 0; k < g.ws; ++k) mx = fmaxf(mx, smem[(warp + k) * part]);
  float tot = 0.f;
  float o[kLD];
#pragma unroll
  for (int i = 0; i < kLD; ++i) o[i] = 0.f;
  for (int k = 0; k < g.ws; ++k) {
    const float* p = smem + (warp + k) * part;
    // a warp that saw no token has m = -inf: weight 0, never exp(nan)
    const float w = p[0] == -CUDART_INF_F ? 0.f : fast_exp2(p[0] - mx);
    tot += p[1] * w;
#pragma unroll
    for (int i = 0; i < kLD; ++i) o[i] += p[2 + dim_of<DC>(dc, i)] * w;
  }
  // a span at or past this row's limit (the block ran for another of its
  // rows) holds nothing of it: only the row's own spans write
  if (span0 >= lim) return;
  if (lim <= kSpan) {
    // span 0 is the row's only one: finish the row here, and the merge
    // leaves it alone
    if (tg == 0) {
      const float inv = tot > 0.f ? 1.f / tot : 0.f;
      float* orow = out + (static_cast<size_t>(r) * g.H + h) * g.D;
#pragma unroll
      for (int i = 0; i < kLD; ++i) {
        const int d = dim_of<DC>(dc, i);
        if (d < g.D) orow[d] = o[i] * inv;
      }
    }
    return;
  }
  const size_t cell =
      (static_cast<size_t>(r) * g.H + h) * g.nsplit + blockIdx.z;
  if (tg == 0) {
    float* a = ws_acc + cell * g.D;
#pragma unroll
    for (int i = 0; i < kLD; ++i) {
      const int d = dim_of<DC>(dc, i);
      if (d < g.D) a[d] = o[i];
    }
  }
  if (lane == 0) {
    ws_ml[2 * cell] = mx;
    ws_ml[2 * cell + 1] = tot;
  }
}

// One warp per (row, query head) of two spans or more (the split kernel
// writes the others): combine the row's spans below
// ceil(limit / kSpan) into the output row, kMergeBatch spans at a time
// (their loads all in flight together), rescaling the running sum when a
// batch raises the max.
__global__ void __launch_bounds__(kMergeWarps * kWarp)
paged_attention_merge_kernel(const float* __restrict__ ws_acc,
                             const float* __restrict__ ws_ml, Rows rows,
                             float* __restrict__ out, int n_rows, int H,
                             int D, int nsplit) {
  constexpr int kPL = kMaxD / kWarp;
  const int cell = blockIdx.x * kMergeWarps + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (cell >= n_rows * H) return;
  const int ns = (row_limit(rows, cell / H) + kSpan - 1) / kSpan;
  if (ns <= 1) return;  // the split kernel finished this row
  const float* ml = ws_ml + static_cast<size_t>(cell) * nsplit * 2;
  const float* a = ws_acc + static_cast<size_t>(cell) * nsplit * D;
  float mx = -CUDART_INF_F;
  float total = 0.f;
  float o[kPL];
#pragma unroll
  for (int i = 0; i < kPL; ++i) o[i] = 0.f;
  for (int j0 = 0; j0 < ns; j0 += kMergeBatch) {
    float mj[kMergeBatch], lj[kMergeBatch], av[kMergeBatch][kPL];
#pragma unroll
    for (int k = 0; k < kMergeBatch; ++k) {
      const int j = j0 + k;
      const bool in = j < ns;
      mj[k] = in ? ml[2 * j] : -CUDART_INF_F;
      lj[k] = in ? ml[2 * j + 1] : 0.f;
#pragma unroll
      for (int i = 0; i < kPL; ++i) {
        const int d = lane + i * kWarp;
        av[k][i] = in && d < D ? a[static_cast<size_t>(j) * D + d] : 0.f;
      }
    }
    float bm = mx;
#pragma unroll
    for (int k = 0; k < kMergeBatch; ++k) bm = fmaxf(bm, mj[k]);
    if (bm == -CUDART_INF_F) continue;
    const float alpha = fast_exp2(mx - bm);  // 0 while mx is -inf
    total *= alpha;
#pragma unroll
    for (int i = 0; i < kPL; ++i) o[i] *= alpha;
    mx = bm;
#pragma unroll
    for (int k = 0; k < kMergeBatch; ++k) {
      // a span that saw no token has m = -inf: weight 0, never exp(nan)
      const float w = mj[k] == -CUDART_INF_F ? 0.f : fast_exp2(mj[k] - mx);
      total += lj[k] * w;
#pragma unroll
      for (int i = 0; i < kPL; ++i) o[i] += av[k][i] * w;
    }
  }
  // a total of 0 (no span weighed anything): exact zeros
  const float inv = total > 0.f ? 1.f / total : 0.f;
  float* orow = out + static_cast<size_t>(cell) * D;
#pragma unroll
  for (int i = 0; i < kPL; ++i) {
    const int d = lane + i * kWarp;
    if (d < D) orow[d] = total > 0.f ? o[i] * inv : 0.f;
  }
}

// Raise the split kernel's dynamic shared-memory limit to the most any
// launch of it asks, once per device.
template <int DC>
cudaError_t allow_smem(size_t bytes) {
  static std::atomic<bool> done[kMaxDevices];
  if (bytes <= kDefaultSmem) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev].load(std::memory_order_relaxed))
    return cudaSuccess;
  err = cudaFuncSetAttribute(paged_attention_split_kernel<DC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_bytes(DC)));
  if (err == cudaSuccess && dev < kMaxDevices)
    done[dev].store(true, std::memory_order_relaxed);
  return err;
}

struct Launch {
  dim3 grid;
  size_t smem;
  cudaStream_t stream;
  const float* q;
  const float* k_pool;
  const float* v_pool;
  const int* page_table;
  Rows rows;
  float* out;
  float* ws_acc;
  float* ws_ml;
  Geo g;
};

template <int DC>
cudaError_t launch_split(const Launch& a) {
  cudaError_t err = allow_smem<DC>(a.smem);
  if (err != cudaSuccess) return err;
  paged_attention_split_kernel<DC><<<a.grid, kThreads, a.smem, a.stream>>>(
      a.q, a.k_pool, a.v_pool, a.page_table, a.rows, a.out, a.ws_acc,
      a.ws_ml, a.g);
  return cudaGetLastError();
}

// Both entry points: check, launch the split kernel, then the merge where
// some row's limit may pass kSpan (max_limit bounds every row's).
int launch(const float* q, const float* k_pool, const float* v_pool,
           const int* page_table, int pt_stride, const Rows& rows_in,
           float* out, float* workspace, int n_rows, int H, int KH, int D,
           int page_size, int max_pages, int nsplit, long long max_limit,
           float scale, cudaStream_t stream) {
  if (n_rows <= 0) return static_cast<int>(cudaSuccess);
  if (D < 1 || D > kMaxD || KH < 1 || H < KH || H % KH != 0 ||
      page_size < 1 || max_pages < 1 ||
      static_cast<long long>(max_pages) * page_size > (1LL << 30)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Launch a;
  a.rows = rows_in;
  a.rows.tokens = max_pages * page_size;
  Geo& g = a.g;
  g.rows = n_rows;
  g.H = H;
  g.KH = KH;
  g.D = D;
  const int dc = lanes_per_token(D);
  g.Dpad = kLD * dc;
  g.Ds = row_stride(dc);
  g.vec = D % 4 == 0 && reinterpret_cast<uintptr_t>(k_pool) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(v_pool) % 16 == 0;
  g.page_size = page_size;
  g.pt_stride = pt_stride;
  g.groups = H / KH;
  g.gpb = g.groups < kMaxUnits ? g.groups : kMaxUnits;
  // a decode row has its own table row; chunk rows share one, and a block
  // fills its kMaxUnits query vectors with them
  const int fill = kMaxUnits / g.gpb;
  const int rows_tile = pt_stride != 0 ? 1 : n_rows < fill ? n_rows : fill;
  g.rows_tile = rows_tile;
  g.nsplit = nsplit;
  g.scale = scale * 1.4426950408889634f;  // log2(e): scores in log2 units
  // the caller's workspace (ops/paged_attention.py:_split_plan) must
  // match this build's span
  if (nsplit != (a.rows.tokens + kSpan - 1) / kSpan) return -1;
  const int gchunks = (g.groups + g.gpb - 1) / g.gpb;
  a.grid = dim3((n_rows + rows_tile - 1) / rows_tile, KH * gchunks, nsplit);
  if (a.grid.y > 65535 || a.grid.z > 65535) return -1;
  // warps per unit: a power of two that leaves each warp at least one
  // step of TG = 32 / dc tokens a tile
  const int units = rows_tile * g.gpb;
  int ws = 1;
  while (2 * ws * units <= kWarps && 2 * ws * (kWarp / dc) <= kTile) ws *= 2;
  g.ws = ws;
  a.smem = smem_bytes(dc);
  a.stream = stream;
  a.q = q;
  a.k_pool = k_pool;
  a.v_pool = v_pool;
  a.page_table = page_table;
  a.out = out;
  a.ws_acc = workspace;
  a.ws_ml = workspace + static_cast<size_t>(n_rows) * H * nsplit * D;
  cudaError_t err;
  switch (dc) {
    case 2: err = launch_split<2>(a); break;
    case 4: err = launch_split<4>(a); break;
    case 8: err = launch_split<8>(a); break;
    default: err = launch_split<16>(a);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (max_limit <= kSpan) return static_cast<int>(cudaSuccess);
  const int cells = n_rows * H;
  paged_attention_merge_kernel<<<(cells + kMergeWarps - 1) / kMergeWarps,
                                 kMergeWarps * kWarp, 0, stream>>>(
      a.ws_acc, a.ws_ml, a.rows, out, n_rows, H, D, nsplit);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Decode. q (S, H, D), k_pool/v_pool (P, page_size, KH, D), out (S, H, D):
// fp32, contiguous. page_table (S, max_pages), seq_lens (S,), q_pos (S,)
// or null: int32, contiguous. workspace: S * H * nsplit * (D + 2) floats.
// Every page id in the table must be < P.
extern "C" int paged_attention_f32(const float* q, const float* k_pool,
                                   const float* v_pool,
                                   const int* page_table, const int* seq_lens,
                                   const int* q_pos, float* out,
                                   float* workspace, int S, int H, int KH,
                                   int D, int page_size, int max_pages,
                                   int nsplit, float scale, void* stream) {
  const Rows rows{seq_lens, q_pos, 0, 0, nullptr, 0};
  return launch(q, k_pool, v_pool, page_table, max_pages, rows, out,
                workspace, S, H, KH, D, page_size, max_pages, nsplit,
                static_cast<long long>(max_pages) * page_size, scale,
                static_cast<cudaStream_t>(stream));
}

// A prefill chunk of ONE sequence. q (C, H, D), out (C, H, D), pools as
// above; page_row (max_pages,) int32, the sequence's table row; row i sits
// at position start + i, rows >= length are padding (zeros). workspace:
// C * H * nsplit * (D + 2) floats.
extern "C" int paged_prefill_attention_f32(
    const float* q, const float* k_pool, const float* v_pool,
    const int* page_row, float* out, float* workspace, int C, int start,
    int length, int H, int KH, int D, int page_size, int max_pages,
    int nsplit, float scale, void* stream) {
  const Rows rows{nullptr, nullptr, start, length, nullptr, 0};
  // the last real row's limit bounds every row's
  const long long max_limit =
      static_cast<long long>(start) + (length < C ? length : C);
  return launch(q, k_pool, v_pool, page_row, 0, rows, out, workspace, C, H,
                KH, D, page_size, max_pages, nsplit, max_limit, scale,
                static_cast<cudaStream_t>(stream));
}

// The same chunk with (start, length) read on the device from `chunk`
// (two int32), so a CUDA graph can capture the launch once and replay it
// for any chunk of that shape: the grid depends on shapes alone, and the
// merge is launched wherever the table holds more than kSpan positions
// (it returns at once for rows of one span).
extern "C" int paged_prefill_attention_dev_f32(
    const float* q, const float* k_pool, const float* v_pool,
    const int* page_row, const int* chunk, float* out, float* workspace,
    int C, int H, int KH, int D, int page_size, int max_pages, int nsplit,
    float scale, void* stream) {
  const Rows rows{nullptr, nullptr, 0, 0, chunk, 0};
  return launch(q, k_pool, v_pool, page_row, 0, rows, out, workspace, C, H,
                KH, D, page_size, max_pages, nsplit,
                static_cast<long long>(max_pages) * page_size, scale,
                static_cast<cudaStream_t>(stream));
}
