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
// draft row) writes exact zeros, never 0/0.
//
// Design (simple and right first; its measured time is in PERF.md):
//   * the Pallas grid (S, max_pages) ran its page axis in order on one
//     core, with all W*H rows of a slot in VMEM scratch. On Hopper blocks
//     run in parallel, so the page axis becomes a loop INSIDE the block;
//   * one block of 8 warps per (slot, kv head). It holds all W x groups
//     query rows of that kv head (row = w * groups + g). Each K/V tile is
//     staged in shared memory ONCE and read by every row: the slot's K/V
//     crosses device memory once for all W rows, which is the point of a
//     multi-query kernel (kernel 1 on S*W rows with a repeated page table
//     would read it W times);
//   * rows map onto warps: with fewer than 8 rows, 8 / rows warps share
//     one row's tokens and merge their online-softmax states through
//     shared memory at the end (the flash-decoding merge, inside one
//     block, as in paged_attention.cu); with 8 or more rows, warp i owns
//     rows i, i + 8, ... (up to kMaxRPW each, in registers). More than
//     8 * kMaxRPW = 32 rows per kv head (say W = 9 with 4 query heads per
//     kv head) split over grid.z, each z block re-reading the K/V;
//   * per row, q and the accumulator live in registers (lanes stride over
//     D <= 256). A warp loads two tokens' K and V from shared memory into
//     registers once and applies them to each of its rows, two q.k warp
//     reductions at a time;
//   * ragged per-row limits: the tile loop runs to the largest limit
//     among the block's rows, and each row stops at its own limit (a
//     prefix of the positions, so bounding the loop IS the mask). A block
//     whose rows all have limit 0 stages nothing: the null page 0 that
//     pads the table is never loaded;
//   * K/V tiles of up to 64 tokens (32 KB of K+V) may span pages: each
//     token's page comes from the table, so one pair of barriers serves a
//     whole tile. All 256 threads stage, with 16-byte loads when D % 4 == 0.
//
// What bounds it on an H100: bytes. At the verify shape of the decode bench
// (16 slots, W = 5, 8 kv heads, D = 64, fp32) one layer's tick reads each
// slot's K/V once: 16 x L x 8 x 64 x 4 B x 2 = 65,536 * L bytes, about
// 75.5 MB at L = 1152, which is 22.5 us at 3.35 TB/s. Its flops are W times
// kernel 1's (4 * D per head, row and token: 190 MFLOP at L = 1152, 2.8 us
// at the 67 TFLOP/s fp32 rate), still 2.5 flops a byte, well below the
// card's balance point (chip_smoke.py computes the bound from each run's
// own data). Staging does not overlap compute yet, and a long slot runs on
// one SM while short ones finish early: cp.async/TMA double buffering,
// tensor cores and splitting long slots are the next steps.
//
// Interface: a plain C entry point (bound with ctypes), launched on the
// caller's stream; returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarps = 8;        // warps per block
constexpr int kMaxD = 256;
constexpr int kMaxRPW = 4;       // query rows one warp carries
constexpr int kRowsPerBlock = kWarps * kMaxRPW;
constexpr int kMaxTile = 64;     // tokens staged per tile
constexpr int kKVBytes = 32768;  // shared memory for one tile of K and V

__device__ __forceinline__ void warp_sum2(float& a, float& b) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
}

// Stage tokens [t0, t0 + nt) of kv head `head` (an element offset) into
// ks/vs, looking each token's page up in the slot's table row `pt`.
__device__ __forceinline__ void stage_tile(
    float* ks, float* vs, const float* __restrict__ k_pool,
    const float* __restrict__ v_pool, const int* __restrict__ pt, int t0,
    int nt, int D, int page_size, size_t row, size_t head, int vec4) {
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
}

// PL = fp32 values of D per lane (D <= 32 * PL).
// Shared memory: ks[tile][D], vs[tile][D], then the per-warp partial
// softmax states m[kWarps], l[kWarps], acc[kWarps][D] (used when several
// warps share one row).
template <int PL>
__global__ void __launch_bounds__(kWarps * kWarp)
paged_spec_kernel(const float* __restrict__ q,
                  const float* __restrict__ k_pool,
                  const float* __restrict__ v_pool,
                  const int* __restrict__ page_table,
                  const int* __restrict__ seq_lens,
                  float* __restrict__ out, int W, int H, int KH, int D,
                  int page_size, int max_pages, int groups, int tile,
                  int vec4, float scale) {
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + tile * D;
  float* part_m = vs + tile * D;
  float* part_l = part_m + kWarps;
  float* part_acc = part_l + kWarps;

  const int s = blockIdx.x;
  const int kh = blockIdx.y;
  const int row0 = blockIdx.z * kRowsPerBlock;
  // rows of this block (block-uniform), warps that own a row, warps that
  // share one row's tokens, rows per owning warp
  const int R = min(kRowsPerBlock, W * groups - row0);
  const int owners = min(R, kWarps);
  const int split = kWarps / owners;
  const int rpw = (R + owners - 1) / owners;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int gi = warp % owners;  // this warp's first row
  const int r = warp / owners;   // ... and its share of the tokens
  // a warp past the last share (8 % owners != 0) only helps stage K/V
  const bool active = r < split;
  const int cap = max_pages * page_size;

  float qr[kMaxRPW][PL];
  float acc[kMaxRPW][PL];
  float m[kMaxRPW];
  float l[kMaxRPW];
  int lim[kMaxRPW];
  size_t qoff[kMaxRPW];
#pragma unroll
  for (int i = 0; i < kMaxRPW; ++i) {
    const int rr = gi + i * owners;
    const bool has = active && i < rpw && rr < R;
    lim[i] = 0;
    qoff[i] = 0;
    if (has) {
      const int w = (row0 + rr) / groups;
      const int g = (row0 + rr) - w * groups;
      lim[i] = min(max(seq_lens[s * W + w], 0), cap);
      qoff[i] = (static_cast<size_t>(s * W + w) * H + kh * groups + g) * D;
    }
    lim[i] = has ? lim[i] : -1;  // -1: no row here at all
#pragma unroll
    for (int j = 0; j < PL; ++j) {
      const int d = lane + j * kWarp;
      qr[i][j] = (has && d < D) ? q[qoff[i] + d] : 0.f;
      acc[i][j] = 0.f;
    }
    m[i] = -CUDART_INF_F;
    l[i] = 0.f;
  }

  // the tile loop's bound: the largest limit among the block's rows
  // (uniform across the block, so every thread reaches every barrier)
  int blim = 0;
  const int w_lo = row0 / groups;
  const int w_hi = (row0 + R - 1) / groups;
  for (int w = w_lo; w <= w_hi; ++w) {
    blim = max(blim, min(seq_lens[s * W + w], cap));
  }

  const size_t row = static_cast<size_t>(KH) * D;  // one token, all heads
  const size_t head = static_cast<size_t>(kh) * D;
  const int* pt = page_table + static_cast<size_t>(s) * max_pages;
  for (int t0 = 0; t0 < blim; t0 += tile) {
    const int nt = min(tile, blim - t0);
    __syncthreads();  // the previous tile is fully consumed
    stage_tile(ks, vs, k_pool, v_pool, pt, t0, nt, D, page_size, row, head,
               vec4);
    __syncthreads();
    if (!active) continue;
    // each row's tokens of this tile, and the furthest of them
    int nti[kMaxRPW];
    int horizon = 0;
#pragma unroll
    for (int i = 0; i < kMaxRPW; ++i) {
      nti[i] = min(nt, max(lim[i] - t0, 0));
      horizon = max(horizon, nti[i]);
    }
    // this warp's tokens of the tile: r, r + split, ... two at a time
    for (int t = r; t < horizon; t += 2 * split) {
      const int t1 = t + split;
      const int t1c = t1 < nt ? t1 : t;  // never read past the tile
      float k0[PL], k1[PL], v0[PL], v1[PL];
#pragma unroll
      for (int j = 0; j < PL; ++j) {
        const int d = lane + j * kWarp;
        const bool in = d < D;
        k0[j] = in ? ks[t * D + d] : 0.f;
        k1[j] = in ? ks[t1c * D + d] : 0.f;
        v0[j] = in ? vs[t * D + d] : 0.f;
        v1[j] = in ? vs[t1c * D + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kMaxRPW; ++i) {
        if (t >= nti[i]) continue;  // warp-uniform: past this row's limit
        const bool has1 = t1 < nti[i];
        float d0 = 0.f;
        float d1 = 0.f;
#pragma unroll
        for (int j = 0; j < PL; ++j) {
          d0 += qr[i][j] * k0[j];
          d1 += qr[i][j] * k1[j];
        }
        warp_sum2(d0, d1);
        const float s0 = d0 * scale;
        const float s1 = has1 ? d1 * scale : -CUDART_INF_F;
        const float m_new = fmaxf(m[i], fmaxf(s0, s1));
        const float alpha = expf(m[i] - m_new);
        const float e0 = expf(s0 - m_new);
        const float e1 = has1 ? expf(s1 - m_new) : 0.f;
        l[i] = l[i] * alpha + e0 + e1;
#pragma unroll
        for (int j = 0; j < PL; ++j) {
          acc[i][j] = acc[i][j] * alpha + e0 * v0[j] + e1 * v1[j];
        }
        m[i] = m_new;
      }
    }
  }

  if (split == 1) {
    // each row has one owner: write it (block-uniform branch)
    if (!active) return;
#pragma unroll
    for (int i = 0; i < kMaxRPW; ++i) {
      if (lim[i] < 0) continue;
      // nothing attended (limit 0): exact zeros
      const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
#pragma unroll
      for (int j = 0; j < PL; ++j) {
        const int d = lane + j * kWarp;
        if (d < D) out[qoff[i] + d] = l[i] > 0.f ? acc[i][j] * inv : 0.f;
      }
    }
    return;
  }

  // fewer rows than warps (rpw == 1): merge the partial states of the
  // warps that split one row's tokens
  if (active) {
    if (lane == 0) {
      part_m[warp] = m[0];
      part_l[warp] = l[0];
    }
#pragma unroll
    for (int j = 0; j < PL; ++j) {
      const int d = lane + j * kWarp;
      if (d < D) part_acc[warp * D + d] = acc[0][j];
    }
  }
  __syncthreads();
  if (!active || r != 0) return;
  float mx = -CUDART_INF_F;
  for (int k = 0; k < split; ++k) mx = fmaxf(mx, part_m[gi + k * owners]);
  float wts[kWarps];
  float total = 0.f;
#pragma unroll
  for (int k = 0; k < kWarps; ++k) {
    // a warp that saw no token has m = -inf: weight 0, never exp(nan)
    const float pm = k < split ? part_m[gi + k * owners] : -CUDART_INF_F;
    wts[k] = pm == -CUDART_INF_F ? 0.f : expf(pm - mx);
    if (k < split) total += part_l[gi + k * owners] * wts[k];
  }
  const float inv = total > 0.f ? 1.f / total : 0.f;
#pragma unroll
  for (int j = 0; j < PL; ++j) {
    const int d = lane + j * kWarp;
    if (d < D) {
      float sum = 0.f;
#pragma unroll
      for (int k = 0; k < kWarps; ++k) {
        if (k < split) sum += part_acc[(gi + k * owners) * D + d] * wts[k];
      }
      out[qoff[0] + d] = total > 0.f ? sum * inv : 0.f;
    }
  }
}

}  // namespace

// q (S, W, H, D), k_pool/v_pool (P, page_size, KH, D), out (S, W, H, D):
// fp32, contiguous. page_table (S, max_pages), seq_lens (S*W,): int32,
// contiguous. Every page id below a slot's largest row limit must be < P.
extern "C" int paged_spec_attention_f32(const float* q, const float* k_pool,
                                        const float* v_pool,
                                        const int* page_table,
                                        const int* seq_lens, float* out,
                                        int S, int W, int H, int KH, int D,
                                        int page_size, int max_pages,
                                        float scale, void* stream) {
  if (S <= 0) return static_cast<int>(cudaSuccess);
  if (W < 1 || D < 1 || D > kMaxD || KH < 1 || H < KH || H % KH != 0 ||
      page_size < 1 || max_pages < 1 || KH > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int groups = H / KH;
  const int zs = (W * groups + kRowsPerBlock - 1) / kRowsPerBlock;
  if (zs > 65535) return static_cast<int>(cudaErrorInvalidValue);
  int tile = kKVBytes / (2 * 4 * D);
  tile = tile < kMaxTile ? tile : kMaxTile;
  const size_t smem =
      (2 * static_cast<size_t>(tile) * D + 2 * kWarps + kWarps * D) *
      sizeof(float);
  const int vec4 = D % 4 == 0 &&
                   reinterpret_cast<size_t>(k_pool) % 16 == 0 &&
                   reinterpret_cast<size_t>(v_pool) % 16 == 0;
  const dim3 grid(S, KH, zs);
  const dim3 block(kWarps * kWarp);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 64) {
    paged_spec_kernel<2><<<grid, block, smem, st>>>(
        q, k_pool, v_pool, page_table, seq_lens, out, W, H, KH, D,
        page_size, max_pages, groups, tile, vec4, scale);
  } else if (D <= 128) {
    paged_spec_kernel<4><<<grid, block, smem, st>>>(
        q, k_pool, v_pool, page_table, seq_lens, out, W, H, KH, D,
        page_size, max_pages, groups, tile, vec4, scale);
  } else {
    paged_spec_kernel<8><<<grid, block, smem, st>>>(
        q, k_pool, v_pool, page_table, seq_lens, out, W, H, KH, D,
        page_size, max_pages, groups, tile, vec4, scale);
  }
  return static_cast<int>(cudaGetLastError());
}
