// Fused attention forward for Hopper (sm_90a), written by hand.
//
// Replaces the TPU kernel mxnet_tpu/ops/pallas_kernels.py:_flash_kernel
// (launched by _flash_forward, under flash_attention and the registered op
// _contrib_flash_attention). Same function: q, k, v (B, H, S, D) ->
// softmax(q k^T * scale) v, with an online softmax over kv tiles, an
// optional causal mask, and no (S, S) tensor in memory. Any S (the ragged
// tail is masked here, not padded by the caller), D <= 256, fp32 or bf16
// inputs, fp32 accumulation, output in the input type. Numerics as the
// Pallas kernel: the running max starts at the finite sentinel -1e30 and a
// masked score IS -1e30 (never -inf, so exp(m_prev - m_new) stays finite),
// and the normaliser is guarded with max(l, 1e-30).
//
// Design (simple and right first; its measured time is in PERF.md):
//   * the Pallas grid (B*H, q blocks, kv blocks) ran its kv axis
//     ("arbitrary") in order on one core and carried m/l/acc in VMEM
//     scratch. On Hopper blocks run in parallel, so the kv axis becomes a
//     loop INSIDE the block: one block of 256 threads per (b*h, q tile);
//   * TPR threads share one q row (4, 8 or 16 by D): each holds D / TPR of
//     q and of the accumulator in registers, so m, l and acc never leave
//     registers; q.k is summed within the row's TPR lanes by shuffles, four
//     kv tokens at a time so the reductions and the exps overlap;
//   * each kv tile (up to 64 tokens, 32 KB of K and V as fp32) is staged in
//     shared memory by all 256 threads (16-byte loads for fp32 when D % 4
//     == 0; bf16 is widened on the way in), and every q row of the block
//     reads it there: K/V come from device memory once per q tile;
//   * under causal the loop ends at the tile holding the block's last row,
//     so no tile above the diagonal is loaded, and each warp stops at its
//     own last row inside the diagonal tile;
//   * q tiles are issued longest first, so the diagonal's uneven work does
//     not leave a long block for the end of the grid.
//
// What bounds it on an H100. Bytes: q, k, v read once and the output
// written once, 4 * B*H*S*D * sizeof(type); at the GPT example's shape
// (32, 4, 64, 16) fp32 that is 2.1 MB, 0.63 us at 3.35 TB/s. Operations:
// 2 * S * S * D for q.k and as many for p.v per (b, h), 4 * B*H*S^2*D in
// all, about half of it under causal: 17 MFLOP there, 0.25 us at the
// 67 TFLOP/s fp32 rate outside the tensor cores, so the bytes bound it.
// Both are far below the few microseconds a launch takes, so at that
// shape the call is launch-bound.
// At long S the operations dominate (4 * 32 * 2048^2 * 64 / 2 = 17 GFLOP
// at (4, 8, 2048, 64) causal, 0.26 ms): this kernel does them with plain
// FMAs, each row's softmax costs shuffles and exps beside them, and K/V
// are re-read from L2 by every q tile. mma.sync/wgmma tensor-core tiles,
// TMA staging and pipelining are the steps toward that line.
//
// Interface: plain C entry points (bound with ctypes), launched on the
// caller's stream; each returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;    // threads per block
constexpr int kMaxTile = 64;     // kv tokens staged per tile
constexpr int kKVBytes = 32768;  // shared memory for one tile of K and V
constexpr float kNegBig = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// TPR threads per q row, PER values of D per thread (D <= TPR * PER).
// Shared memory: ks[tile][D], vs[tile][D] as fp32.
template <typename T, int TPR, int PER>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int S,
                       int D, int tile, int causal, int vec4, float scale) {
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + tile * D;
  constexpr int kRows = kThreads / TPR;       // q rows per block
  constexpr int kWarpRows = kWarp / TPR;      // q rows per warp

  const int n_qt = (S + kRows - 1) / kRows;
  const int bh = blockIdx.x / n_qt;
  const int q0 = (n_qt - 1 - blockIdx.x % n_qt) * kRows;  // longest first
  const int r = threadIdx.x / TPR;
  const int g = threadIdx.x % TPR;
  const int row = q0 + r;
  const bool active = row < S;
  const size_t base = static_cast<size_t>(bh) * S * D;

  float qr[PER];
  float acc[PER];
  const T* qrow = q + base + static_cast<size_t>(active ? row : 0) * D;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int d = g + i * TPR;
    qr[i] = active && d < D ? to_f32(qrow[d]) : 0.f;
    acc[i] = 0.f;
  }
  float m = kNegBig;
  float l = 0.f;

  // kv tokens the block needs: all S, or up to its last row under causal
  // (uniform across the block, so every thread reaches every barrier)
  const int kv_end = causal ? min(S, q0 + kRows) : S;
  // ... and this warp: up to its own last row (uniform across the warp, so
  // every lane joins every shuffle)
  const int warp_last =
      min(q0 + (static_cast<int>(threadIdx.x) / kWarp) * kWarpRows +
              kWarpRows - 1,
          S - 1);
  const T* kb = k + base;
  const T* vb = v + base;
  for (int t0 = 0; t0 < kv_end; t0 += tile) {
    const int nt = min(tile, kv_end - t0);
    __syncthreads();  // the previous tile is fully consumed
    const size_t off = static_cast<size_t>(t0) * D;
    if (vec4) {
      const float4* k4 = reinterpret_cast<const float4*>(kb + off);
      const float4* v4 = reinterpret_cast<const float4*>(vb + off);
      for (int idx = threadIdx.x; idx < (nt * D) >> 2; idx += kThreads) {
        reinterpret_cast<float4*>(ks)[idx] = __ldg(k4 + idx);
        reinterpret_cast<float4*>(vs)[idx] = __ldg(v4 + idx);
      }
    } else {
      for (int idx = threadIdx.x; idx < nt * D; idx += kThreads) {
        ks[idx] = to_f32(kb[off + idx]);
        vs[idx] = to_f32(vb[off + idx]);
      }
    }
    __syncthreads();
    const int nw = causal ? min(nt, max(0, warp_last - t0 + 1)) : nt;
    for (int t = 0; t < nw; t += 4) {
      float s[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int tj = min(t + j, nw - 1);  // never read past the tile
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < PER; ++i) {
          const int d = g + i * TPR;
          if (d < D) dot += qr[i] * ks[tj * D + d];
        }
        s[j] = dot;
      }
#pragma unroll
      for (int o = TPR / 2; o > 0; o >>= 1) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[j] += __shfl_xor_sync(0xffffffffu, s[j], o);
        }
      }
      float m_new = m;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float sc = s[j] * scale;
        if (causal && t0 + t + j > row) sc = kNegBig;  // the causal mask
        s[j] = sc;
        if (t + j < nw) m_new = fmaxf(m_new, sc);
      }
      const float alpha = expf(m - m_new);
      float p[4];
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[j] = t + j < nw ? expf(s[j] - m_new) : 0.f;
        psum += p[j];
      }
      l = l * alpha + psum;
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int d = g + i * TPR;
        if (d < D) {
          float a = acc[i] * alpha;
#pragma unroll
          for (int j = 0; j < 4; ++j) a += p[j] * vs[min(t + j, nw - 1) * D + d];
          acc[i] = a;
        }
      }
      m = m_new;
    }
  }

  if (!active) return;
  const float inv = 1.f / fmaxf(l, 1e-30f);
  T* orow = out + base + static_cast<size_t>(row) * D;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int d = g + i * TPR;
    if (d < D) store(orow + d, acc[i] * inv);
  }
}

template <typename T, int TPR, int PER>
int run(const T* q, const T* k, const T* v, T* out, int BH, int S, int D,
        int causal, int vec4, float scale, cudaStream_t stream) {
  constexpr int kRows = kThreads / TPR;
  int tile = kKVBytes / (2 * static_cast<int>(sizeof(float)) * D);
  tile = tile < kMaxTile ? tile : kMaxTile;
  const long long blocks =
      static_cast<long long>(BH) * ((S + kRows - 1) / kRows);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 2 * static_cast<size_t>(tile) * D * sizeof(float);
  flash_attention_kernel<T, TPR, PER>
      <<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
          q, k, v, out, S, D, tile, causal, vec4, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int BH,
             int S, int D, int causal, int vec4, float scale, void* stream) {
  if (BH <= 0 || S <= 0) return static_cast<int>(cudaSuccess);
  if (D < 1 || D > 256) return static_cast<int>(cudaErrorInvalidValue);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 16) return run<T, 4, 4>(qt, kt, vt, ot, BH, S, D, causal, vec4, scale, st);
  if (D <= 32) return run<T, 4, 8>(qt, kt, vt, ot, BH, S, D, causal, vec4, scale, st);
  if (D <= 64) return run<T, 8, 8>(qt, kt, vt, ot, BH, S, D, causal, vec4, scale, st);
  if (D <= 128) return run<T, 8, 16>(qt, kt, vt, ot, BH, S, D, causal, vec4, scale, st);
  return run<T, 16, 16>(qt, kt, vt, ot, BH, S, D, causal, vec4, scale, st);
}

}  // namespace

// q, k, v, out: (B*H, S, D) contiguous, all of one type. BH = B * H.
extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* out, int BH, int S,
                                   int D, int causal, float scale,
                                   void* stream) {
  const int vec4 = D % 4 == 0 && reinterpret_cast<size_t>(k) % 16 == 0 &&
                   reinterpret_cast<size_t>(v) % 16 == 0;
  return dispatch<float>(q, k, v, out, BH, S, D, causal, vec4, scale, stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* out, int BH, int S,
                                    int D, int causal, float scale,
                                    void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, out, BH, S, D, causal, 0, scale,
                                 stream);
}
