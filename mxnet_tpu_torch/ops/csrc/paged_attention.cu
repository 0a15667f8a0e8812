// Paged decode attention for Hopper (sm_90a), fp32, written by hand.
//
// Replaces the TPU kernel mxnet_tpu/ops/pallas_kernels.py:_paged_kernel
// (launched by ragged_paged_attention). Same function: one query row per
// slot attends over that slot's pages of a (P, page_size, KH, D) pool,
// read through a (S, max_pages) page table, with an online softmax across
// pages. GQA: query head h reads kv head h / (H / KH). Positions >=
// seq_lens[s] are masked, and so are positions > q_pos[s] when a causal
// bound is given. A slot with nothing to attend to (seq_len 0) returns
// exact zeros. Padded page-table entries point at the null page 0; the
// loop below never reads past the slot's ragged end, so they are not even
// loaded.
//
// Design (simple and right first; its measured time is in PERF.md):
//   * the Pallas grid (S, max_pages) ran its page axis in order on one
//     core and carried m/l/acc in VMEM scratch. On Hopper blocks run in
//     parallel, so the page axis becomes a loop INSIDE the block;
//   * one block of 8 warps per (slot, kv head[, group chunk]). The
//     `groups` query heads that share the kv head (up to 8 per block,
//     grid.z covers more) each get 8 / groups warps, which split the
//     slot's tokens between them; each warp keeps its own online-softmax
//     state, and the block merges them at the end through shared memory
//     (the flash-decoding merge, inside one block);
//   * lanes stride over D (D <= 256: up to 8 values of q and of the
//     accumulator per lane, in registers); q.k is reduced with warp
//     shuffles, two tokens at a time so the two reductions overlap;
//   * K/V rows are staged in shared memory in tiles of up to 64 tokens
//     (32 KB of K+V at most) that may span several pages: each row's page
//     comes from the table, so one pair of barriers serves a whole tile.
//     All 256 threads stage, with 16-byte loads when D % 4 == 0;
//   * the loop covers the slot's first limit = min(seq_len, q_pos + 1)
//     tokens, so it touches no page past the ragged end.
//
// What bounds it on an H100: bytes. At the decode bench shape (16 slots,
// 8 kv heads, D = 64, fp32) one layer's tick reads
// 16 slots x L tokens x 8 kv heads x 64 x 4 B x 2 (K and V) = 65,536 * L
// bytes: about 75 MB at L = 1152, which is 22.5 us at 3.35 TB/s. Its
// 2 * 2 * 64 flops per head and token (38 MFLOP at L = 1152) take 0.6 us
// at the 67 TFLOP/s fp32 rate: 0.5 flop per byte, far below the card's
// balance point, so bytes bound it (chip_smoke.py computes the bound from
// each run's own data). Staging and compute do not overlap yet, and a
// long slot runs on one SM while short ones finish early: cp.async/TMA
// double buffering and splitting long slots across blocks are the next
// steps toward that line.
//
// Interface: a plain C entry point (bound with ctypes), launched on the
// caller's stream; returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarps = 8;        // warps per block
constexpr int kMaxD = 256;
constexpr int kPerLane = kMaxD / kWarp;
constexpr int kMaxTile = 64;     // tokens staged per tile
constexpr int kKVBytes = 32768;  // shared memory for one tile of K and V

__device__ __forceinline__ void warp_sum2(float& a, float& b) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
}

// Shared memory: ks[tile][D], vs[tile][D], then the per-warp partial
// softmax states m[kWarps], l[kWarps], acc[kWarps][D].
__global__ void __launch_bounds__(kWarps * kWarp)
paged_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k_pool,
                       const float* __restrict__ v_pool,
                       const int* __restrict__ page_table,
                       const int* __restrict__ seq_lens,
                       const int* __restrict__ q_pos,
                       float* __restrict__ out, int H, int KH, int D,
                       int page_size, int max_pages, int groups, int hpb,
                       int tile, int vec4, float scale) {
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + tile * D;
  float* part_m = vs + tile * D;
  float* part_l = part_m + kWarps;
  float* part_acc = part_l + kWarps;

  const int s = blockIdx.x;
  const int kh = blockIdx.y;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int split = kWarps / hpb;  // warps per query head
  const int gi = warp % hpb;       // this warp's head within the block
  const int r = warp / hpb;        // ... and its share of the tokens
  const int g = blockIdx.z * hpb + gi;
  // a warp past the last query head of the group still helps stage K/V
  const bool active = g < groups && r < split;
  const int h = kh * groups + (g < groups ? g : 0);

  // loop bounds depend only on the slot: uniform across the block, so
  // every thread reaches every __syncthreads
  int limit = seq_lens[s];
  if (q_pos != nullptr) limit = min(limit, q_pos[s] + 1);
  limit = min(limit, max_pages * page_size);

  float qr[kPerLane];
  float acc[kPerLane];
  const float* qrow = q + (static_cast<size_t>(s) * H + h) * D;
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int d = lane + i * kWarp;
    qr[i] = d < D ? qrow[d] : 0.f;
    acc[i] = 0.f;
  }
  float m = -CUDART_INF_F;
  float l = 0.f;

  const size_t row = static_cast<size_t>(KH) * D;  // one token, all heads
  const size_t head = static_cast<size_t>(kh) * D;
  const int* pt = page_table + static_cast<size_t>(s) * max_pages;
  for (int t0 = 0; t0 < limit; t0 += tile) {
    const int nt = min(tile, limit - t0);
    __syncthreads();  // the previous tile is fully consumed
    if (vec4) {
      const int dq = D >> 2;
#pragma unroll 4
      for (int idx = threadIdx.x; idx < nt * dq; idx += blockDim.x) {
        const int t = idx / dq;
        const int d = (idx - t * dq) << 2;
        const int tok = t0 + t;
        const size_t off =
            (static_cast<size_t>(__ldg(pt + tok / page_size)) * page_size +
             tok % page_size) * row + head + d;
        *reinterpret_cast<float4*>(ks + t * D + d) =
            __ldg(reinterpret_cast<const float4*>(k_pool + off));
        *reinterpret_cast<float4*>(vs + t * D + d) =
            __ldg(reinterpret_cast<const float4*>(v_pool + off));
      }
    } else {
      for (int idx = threadIdx.x; idx < nt * D; idx += blockDim.x) {
        const int t = idx / D;
        const int d = idx - t * D;
        const int tok = t0 + t;
        const size_t off =
            (static_cast<size_t>(__ldg(pt + tok / page_size)) * page_size +
             tok % page_size) * row + head + d;
        ks[t * D + d] = __ldg(k_pool + off);
        vs[t * D + d] = __ldg(v_pool + off);
      }
    }
    __syncthreads();
    if (!active) continue;
    // this warp's tokens of the tile: r, r + split, ... two at a time
    for (int t = r; t < nt; t += 2 * split) {
      const bool has1 = t + split < nt;
      const int t1 = has1 ? t + split : t;  // never read past the tile
      float d0 = 0.f;
      float d1 = 0.f;
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) {
        const int d = lane + i * kWarp;
        if (d < D) {
          d0 += qr[i] * ks[t * D + d];
          d1 += qr[i] * ks[t1 * D + d];
        }
      }
      warp_sum2(d0, d1);
      const float s0 = d0 * scale;
      const float s1 = has1 ? d1 * scale : -CUDART_INF_F;
      const float m_new = fmaxf(m, fmaxf(s0, s1));
      const float alpha = expf(m - m_new);
      const float e0 = expf(s0 - m_new);
      const float e1 = has1 ? expf(s1 - m_new) : 0.f;
      l = l * alpha + e0 + e1;
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) {
        const int d = lane + i * kWarp;
        if (d < D) {
          acc[i] = acc[i] * alpha + e0 * vs[t * D + d] + e1 * vs[t1 * D + d];
        }
      }
      m = m_new;
    }
  }

  // merge the partial states of the warps that split one head's tokens
  if (active) {
    if (lane == 0) {
      part_m[warp] = m;
      part_l[warp] = l;
    }
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const int d = lane + i * kWarp;
      if (d < D) part_acc[warp * D + d] = acc[i];
    }
  }
  __syncthreads();
  if (!active || r != 0) return;
  float mx = -CUDART_INF_F;
  for (int k = 0; k < split; ++k) mx = fmaxf(mx, part_m[gi + k * hpb]);
  float wts[kWarps];
  float total = 0.f;
#pragma unroll
  for (int k = 0; k < kWarps; ++k) {
    // a warp that saw no token has m = -inf: weight 0, never exp(nan)
    const float pm = k < split ? part_m[gi + k * hpb] : -CUDART_INF_F;
    wts[k] = pm == -CUDART_INF_F ? 0.f : expf(pm - mx);
    if (k < split) total += part_l[gi + k * hpb] * wts[k];
  }
  // nothing attended (seq_len 0, or a causal bound below 0): exact zeros
  const float inv = total > 0.f ? 1.f / total : 0.f;
  float* orow = out + (static_cast<size_t>(s) * H + h) * D;
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int d = lane + i * kWarp;
    if (d < D) {
      float sum = 0.f;
#pragma unroll
      for (int k = 0; k < kWarps; ++k) {
        if (k < split) sum += part_acc[(gi + k * hpb) * D + d] * wts[k];
      }
      orow[d] = total > 0.f ? sum * inv : 0.f;
    }
  }
}

}  // namespace

// q (S, H, D), k_pool/v_pool (P, page_size, KH, D), out (S, H, D): fp32,
// contiguous. page_table (S, max_pages), seq_lens (S,), q_pos (S,) or
// null: int32, contiguous. Every page id in the table must be < P.
extern "C" int paged_attention_f32(const float* q, const float* k_pool,
                                   const float* v_pool,
                                   const int* page_table, const int* seq_lens,
                                   const int* q_pos, float* out, int S, int H,
                                   int KH, int D, int page_size,
                                   int max_pages, float scale,
                                   void* stream) {
  if (S <= 0) return static_cast<int>(cudaSuccess);
  if (D < 1 || D > kMaxD || KH < 1 || H < KH || H % KH != 0 ||
      page_size < 1 || max_pages < 1 || KH > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int groups = H / KH;
  const int hpb = groups < kWarps ? groups : kWarps;  // heads per block
  int tile = kKVBytes / (2 * 4 * D);
  tile = tile < kMaxTile ? tile : kMaxTile;
  const size_t smem =
      (2 * static_cast<size_t>(tile) * D + 2 * kWarps + kWarps * D) *
      sizeof(float);
  const int vec4 = D % 4 == 0 &&
                   reinterpret_cast<size_t>(k_pool) % 16 == 0 &&
                   reinterpret_cast<size_t>(v_pool) % 16 == 0;
  const dim3 grid(S, KH, (groups + hpb - 1) / hpb);
  const dim3 block(kWarps * kWarp);
  paged_attention_kernel<<<grid, block, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      q, k_pool, v_pool, page_table, seq_lens, q_pos, out, H, KH, D,
      page_size, max_pages, groups, hpb, tile, vec4, scale);
  return static_cast<int>(cudaGetLastError());
}
