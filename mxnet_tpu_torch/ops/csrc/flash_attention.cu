// Fused attention forward for Hopper (sm_90a), written by hand.
//
// Replaces the TPU kernel mxnet_tpu/ops/pallas_kernels.py:_flash_kernel
// (launched by _flash_forward, under flash_attention and the registered op
// _contrib_flash_attention). Same function: q, k, v (B, H, S, D) ->
// softmax(q k^T * scale) v, with an online softmax over kv tiles, an
// optional causal mask, and no (S, S) tensor in memory. Any S (the ragged
// tail is masked here, not padded by the caller), 1 <= D <= 256, fp32 or
// bf16 inputs, fp32 accumulation, output in the input type. Numerics as
// the Pallas kernel: the running max starts at the finite sentinel -1e30
// and a masked score IS -1e30 (never -inf, so exp(m_prev - m_new) stays
// finite), and the normaliser is guarded with max(l, 1e-30).
//
// What bounds it on an H100. Bytes: q, k, v read once and the output
// written once, 4 * B*H*S*D * sizeof(type). Operations: 2 * D for q.k and
// as many for p.v per (row, key) pair, S^2 per (b, h), about half under
// causal. At the GPT example's shape (32, 4, 64, 16) the bytes bound it
// (2.1 MB, 0.63 us), far below a launch: the call is launch-bound there.
// At (4, 8, 2048, 64) causal the operations do (17 GFLOP): 0.26 ms at the
// 67 TFLOP/s fp32 rate outside the tensor cores, 0.10 ms on the tensor
// cores at fp32 accuracy (three TF32 products per fp32 product at 495
// TFLOP/s). This kernel is built for that second line:
//
//   * both products run on the tensor cores, mma.sync.m16n8k8 in TF32 with
//     fp32 accumulation: S = Q K^T, then O += P V. One TF32 product keeps
//     about three decimal digits, so an fp32 operand x is split into
//     big (x cut to TF32's 10 mantissa bits) and small = x - big, and each
//     product takes big*big + big*small + small*big (3xTF32, about fp32
//     accuracy). bf16
//     inputs are exact in TF32: Q K^T takes one product and P V two (P is
//     fp32). kTerms (3 or 1) selects this in one code path;
//   * one block per (b*h, q tile), 8 warps of 16 q rows (128 rows; 4 warps,
//     64 rows at D > 128, where the accumulator takes 128 registers a
//     thread), q tiles issued longest first. Each warp keeps its rows' m, l
//     and O in registers; P never leaves them: the accumulator of S holds
//     rows (g, g + 8) at columns (2t, 2t + 1), which is not the TF32
//     A-operand layout (columns t and t + 4), so P V sums the kv tokens of
//     each 8-token slice in the order (0, 2, 4, 6, 1, 3, 5, 7): A is then
//     exactly the accumulator's registers, and V's rows are read in that
//     order. No shuffle, no shared-memory slab;
//   * K and V pass through a ring of 2 stages in shared memory, so tile
//     t + 1 loads while tile t is computed. Each stage is filled by TMA
//     (cp.async.bulk.tensor over a 3-D map (B*H, S, D) of each input, its
//     out-of-bounds fill zeroing the ragged S tail and the padding of D;
//     no tile crosses a head) and completes on an mbarrier. TMA needs a
//     16-byte row stride: where D * sizeof(type) is not a multiple of 16
//     (D = 6 in fp32, D = 100 in bf16), the same kernel stages with
//     cp.async and zero fill (plain loads for 2-byte rows). Tiles are
//     128-byte rows in TMA's 128B swizzle, so every fragment load from
//     shared memory is free of bank conflicts;
//   * under causal, tiles above the block's last row are never loaded, a
//     warp skips the tiles above its own rows, and only a tile that
//     crosses a warp's diagonal (or the ragged tail) is masked.
// The tiling (rows, kv tile, stages, staging route, shared memory) is
// planned in Python (ops/flash_attention.py:flash_plan) and checked here.
//
// Interface: plain C entry points (bound with ctypes), launched on the
// caller's stream; each returns cudaGetLastError() after the launch, or a
// negative code (kPlanMismatch, kNoTensorMap) before it.

#include <cuda.h>  // CUtensorMap and the driver's types; libcuda is not linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cstring>
#include <type_traits>

namespace {

constexpr int kWarp = 32;
constexpr int kLine = 128;   // bytes of one swizzled shared-memory row
constexpr int kStages = 2;   // K/V stages in the ring
constexpr float kNegBig = -1e30f;
constexpr int kPlanMismatch = -1;  // the caller's plan is not this build's
constexpr int kNoTensorMap = -2;   // cuTensorMapEncodeTiled failed

template <int DMAX>
struct Cfg {
  static constexpr int kWarps = DMAX <= 128 ? 8 : 4;
  static constexpr int kThreads = kWarps * kWarp;
  static constexpr int kRows = kWarps * 16;      // q rows a block
  static constexpr int kN = DMAX <= 128 ? 64 : 32;  // kv tokens a stage
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of (row, byte column) in a tile of `rows` rows: 128-byte
// column blocks of `rows` rows each; in a row, the 16-byte chunk index is
// XORed with row % 8 (TMA's CU_TENSOR_MAP_SWIZZLE_128B on 1024-byte
// aligned tiles).
__device__ __forceinline__ int swz(int row, int bcol, int rows) {
  return (bcol >> 7) * rows * kLine + row * kLine +
         ((((bcol >> 4) & 7) ^ (row & 7)) << 4) + (bcol & 15);
}

template <typename T>
__device__ __forceinline__ float lds(const unsigned char* p);
template <>
__device__ __forceinline__ float lds<float>(const unsigned char* p) {
  return *reinterpret_cast<const float*>(p);
}
template <>
__device__ __forceinline__ float lds<__nv_bfloat16>(const unsigned char* p) {
  return __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(p));
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// x -> (big, small) TF32 operands: big keeps x's top 19 bits (sign,
// exponent, 10 mantissa bits; one LOP, where cvt.rna.tf32.f32 costs more
// for the same accuracy), small = x - big is exact in fp32 and the tensor
// core reads its top 19 bits: big*big + big*small + small*big then lose
// about 2^-20 of a product. Unsplit, x itself (exact in TF32 when it came
// from bf16).
template <bool kSplit>
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  if (kSplit) {
    big = __float_as_uint(x) & 0xffffe000u;
    small = __float_as_uint(x - __uint_as_float(big));
  } else {
    big = __float_as_uint(x);
    small = 0u;
  }
}

__device__ __forceinline__ void mma(float* c, const uint32_t* a, uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b with a and/or b split: the small products first, then big*big
template <bool kSplitA, bool kSplitB>
__device__ __forceinline__ void mma_terms(float* c, const uint32_t* a_big,
                                          const uint32_t* a_small,
                                          uint32_t b_big0, uint32_t b_big1,
                                          uint32_t b_small0,
                                          uint32_t b_small1) {
  if (kSplitA) mma(c, a_small, b_big0, b_big1);
  if (kSplitB) mma(c, a_big, b_small0, b_small1);
  mma(c, a_big, b_big0, b_big1);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// one box of a 3-D tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, int c2,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(bar)
      : "memory");
}

// `vec` bytes from global to shared memory, zeros where !ok
__device__ __forceinline__ void copy_unit(unsigned char* dst, const char* src,
                                          int vec, bool ok) {
  const uint32_t d = smem_addr(dst);
  const int n = ok ? vec : 0;
  if (vec == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(n)
                 : "memory");
  } else if (vec == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
                 "l"(src), "r"(n)
                 : "memory");
  } else if (vec == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(n)
                 : "memory");
  } else {  // 2-byte rows: cp.async moves 4 bytes at least
    *reinterpret_cast<uint16_t*>(dst) =
        ok ? *reinterpret_cast<const uint16_t*>(src) : uint16_t(0);
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_stages() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1) : "memory");
}

// rows [row0, row0 + rows) of one head (every column up to d_pad) into a
// swizzled tile, by every thread, through cp.async (zeros past S and D)
template <typename T, int kThreads>
__device__ __forceinline__ void copy_tile(unsigned char* dst, const T* src,
                                          int row0, int rows, int S, int D,
                                          int d_pad, int vec) {
  const int row_bytes = D * static_cast<int>(sizeof(T));
  const int units = d_pad * static_cast<int>(sizeof(T)) / vec;
  const char* s = reinterpret_cast<const char*>(src);
  for (int u = threadIdx.x; u < rows * units; u += kThreads) {
    const int r = u / units;
    const int bc = (u - r * units) * vec;
    const bool ok = row0 + r < S && bc < row_bytes;
    const char* g =
        ok ? s + static_cast<size_t>(row0 + r) * row_bytes + bc : s;
    copy_unit(dst + swz(r, bc, rows), g, vec, ok);
  }
}

template <typename T, int DMAX, int kTerms>
__global__ void __launch_bounds__(Cfg<DMAX>::kThreads)
    flash_attention_kernel(const __grid_constant__ CUtensorMap qmap,
                           const __grid_constant__ CUtensorMap kmap,
                           const __grid_constant__ CUtensorMap vmap,
                           const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out,
                           int BH, int S, int D, int causal, float scale,
                           int vec) {
  using C = Cfg<DMAX>;
  constexpr int kRows = C::kRows, kN = C::kN, kThreads = C::kThreads;
  constexpr int kDT = DMAX / 8;  // 8-column steps of D, at most
  constexpr int kNT = kN / 8;    // 8-token steps of a kv tile
  constexpr bool kSplit = kTerms == 3;
  constexpr int kCB = kLine / static_cast<int>(sizeof(T));  // columns a box

  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const int d_pad = (D + 7) & ~7;
  const int dsteps = d_pad / 8;
  const int nblk = (d_pad * static_cast<int>(sizeof(T)) + kLine - 1) / kLine;
  const int q_bytes = kRows * nblk * kLine;
  const int kv_bytes = kN * nblk * kLine;
  unsigned char* qs = base;
  unsigned char* kv0 = base + q_bytes;  // stage s: K, then V
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(kv0 + 2 * kStages * kv_bytes);

  const int n_qt = (S + kRows - 1) / kRows;
  const int bh = static_cast<int>(blockIdx.x) % BH;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x) / BH) * kRows;
  const int kv_end = causal ? min(S, q0 + kRows) : S;
  const int n_tiles = (kv_end + kN - 1) / kN;
  const size_t head = static_cast<size_t>(bh) * S * D;
  const bool tma = vec == 0;

  if (tma && threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(smem_addr(bars + s), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // fill stage s with kv tile `tile` (and the q tile with the first)
  auto load = [&](int tile, int s) {
    unsigned char* ks = kv0 + s * 2 * kv_bytes;
    unsigned char* vs = ks + kv_bytes;
    const int t0 = tile * kN;
    if (tma) {
      if (threadIdx.x == 0) {
        const uint32_t bar = smem_addr(bars + s);
        mbar_expect_tx(bar, 2 * kv_bytes + (tile == 0 ? q_bytes : 0));
        for (int j = 0; j < nblk; ++j) {
          if (tile == 0)
            tma_load(smem_addr(qs + j * kRows * kLine), &qmap, j * kCB, q0,
                     bh, bar);
          tma_load(smem_addr(ks + j * kN * kLine), &kmap, j * kCB, t0, bh,
                   bar);
          tma_load(smem_addr(vs + j * kN * kLine), &vmap, j * kCB, t0, bh,
                   bar);
        }
      }
    } else {
      if (tile == 0)
        copy_tile<T, kThreads>(qs, q + head, q0, kRows, S, D, d_pad, vec);
      copy_tile<T, kThreads>(ks, k + head, t0, kN, S, D, d_pad, vec);
      copy_tile<T, kThreads>(vs, v + head, t0, kN, S, D, d_pad, vec);
    }
  };

  for (int i = 0; i < kStages; ++i) {
    if (i < n_tiles) load(i, i);
    if (!tma) cp_async_commit();
  }

  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp * 16;  // the warp's first row in the q tile
  const int r0 = q0 + wr;    // ... and in the sequence
  const int row_a = r0 + g, row_b = row_a + 8;
  const bool live = r0 < S;  // a warp past S only keeps the barriers

  float o[kDT][4];
#pragma unroll
  for (int n = 0; n < kDT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_a = kNegBig, m_b = kNegBig, l_a = 0.f, l_b = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % kStages;
    if (tma) {
      mbar_wait(smem_addr(bars + s), (i / kStages) & 1);
    } else {
      cp_async_wait_stages();
      __syncthreads();
    }
    const unsigned char* ks = kv0 + s * 2 * kv_bytes;
    const unsigned char* vs = ks + kv_bytes;
    // kv tokens [t0, t0 + kN): skipped by a warp past S and, under causal,
    // by a warp whose rows all come before them
    const int t0 = i * kN;
    if (live && !(causal && t0 > r0 + 15)) {
      // S = Q K^T for this warp's 16 rows and the tile's kN tokens
      float sc[kNT][4];
#pragma unroll
      for (int n = 0; n < kNT; ++n)
        sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kDT; ++kk) {
        if (kk < dsteps) {
          const int bc0 = (kk * 8 + t) * static_cast<int>(sizeof(T));
          const int bc1 = bc0 + 4 * static_cast<int>(sizeof(T));
          uint32_t ab[4], as[4];
          split<kSplit>(lds<T>(qs + swz(wr + g, bc0, kRows)), ab[0], as[0]);
          split<kSplit>(lds<T>(qs + swz(wr + g + 8, bc0, kRows)), ab[1],
                        as[1]);
          split<kSplit>(lds<T>(qs + swz(wr + g, bc1, kRows)), ab[2], as[2]);
          split<kSplit>(lds<T>(qs + swz(wr + g + 8, bc1, kRows)), ab[3],
                        as[3]);
#pragma unroll
          for (int n = 0; n < kNT; ++n) {
            uint32_t bb0, bs0, bb1, bs1;
            split<kSplit>(lds<T>(ks + swz(n * 8 + g, bc0, kN)), bb0, bs0);
            split<kSplit>(lds<T>(ks + swz(n * 8 + g, bc1, kN)), bb1, bs1);
            mma_terms<kSplit, kSplit>(sc[n], ab, as, bb0, bb1, bs0, bs1);
          }
        }
      }

      // scale, mask (the ragged tail and, under causal, keys after the
      // row) to the sentinel, and the online softmax of rows a and b
      const bool edge = t0 + kN > S || (causal && t0 + kN - 1 > r0);
      float mx_a = kNegBig, mx_b = kNegBig;
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[n][e] * scale;
          if (edge) {
            const int col = t0 + n * 8 + 2 * t + (e & 1);
            const int row = e < 2 ? row_a : row_b;
            if (col >= S || (causal && col > row)) x = kNegBig;
          }
          sc[n][e] = x;
          if (e < 2)
            mx_a = fmaxf(mx_a, x);
          else
            mx_b = fmaxf(mx_b, x);
        }
      }
#pragma unroll
      for (int o_ = 1; o_ <= 2; o_ <<= 1) {  // the row's quad
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, o_));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, o_));
      }
      const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
      const float alpha_a = __expf(m_a - mn_a), alpha_b = __expf(m_b - mn_b);
      float ps_a = 0.f, ps_b = 0.f;
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        sc[n][0] = __expf(sc[n][0] - mn_a);
        sc[n][1] = __expf(sc[n][1] - mn_a);
        sc[n][2] = __expf(sc[n][2] - mn_b);
        sc[n][3] = __expf(sc[n][3] - mn_b);
        ps_a += sc[n][0] + sc[n][1];
        ps_b += sc[n][2] + sc[n][3];
      }
      l_a = l_a * alpha_a + ps_a;  // this thread's share; summed at the end
      l_b = l_b * alpha_b + ps_b;
      m_a = mn_a;
      m_b = mn_b;
#pragma unroll
      for (int n = 0; n < kDT; ++n) {
        o[n][0] *= alpha_a;
        o[n][1] *= alpha_a;
        o[n][2] *= alpha_b;
        o[n][3] *= alpha_b;
      }

      // O += P V, the 8 tokens of slice kk taken as (0, 2, 4, 6, 1, 3, 5,
      // 7): then A's (row g, k t), (g + 8, t), (g, t + 4), (g + 8, t + 4)
      // are this thread's P[g][2t], P[g+8][2t], P[g][2t+1], P[g+8][2t+1]
#pragma unroll
      for (int kk = 0; kk < kNT; ++kk) {
        uint32_t ab[4], as[4];
        split<true>(sc[kk][0], ab[0], as[0]);
        split<true>(sc[kk][2], ab[1], as[1]);
        split<true>(sc[kk][1], ab[2], as[2]);
        split<true>(sc[kk][3], ab[3], as[3]);
        const int tr0 = kk * 8 + 2 * t;
#pragma unroll
        for (int n = 0; n < kDT; ++n) {
          if (n < dsteps) {
            const int bc = (n * 8 + g) * static_cast<int>(sizeof(T));
            uint32_t bb0, bs0, bb1, bs1;
            split<kSplit>(lds<T>(vs + swz(tr0, bc, kN)), bb0, bs0);
            split<kSplit>(lds<T>(vs + swz(tr0 + 1, bc, kN)), bb1, bs1);
            mma_terms<true, kSplit>(o[n], ab, as, bb0, bb1, bs0, bs1);
          }
        }
      }
    }
    __syncthreads();  // stage s is consumed by every warp
    if (i + kStages < n_tiles) load(i + kStages, s);
    if (!tma) cp_async_commit();
  }

  if (!live) return;
#pragma unroll
  for (int o_ = 1; o_ <= 2; o_ <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, o_);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, o_);
  }
  const float inv_a = 1.f / fmaxf(l_a, 1e-30f);
  const float inv_b = 1.f / fmaxf(l_b, 1e-30f);
  T* ob = out + head;
#pragma unroll
  for (int n = 0; n < kDT; ++n) {
    if (n < dsteps) {
      const int col = n * 8 + 2 * t;
      if (row_a < S) {
        T* p = ob + static_cast<size_t>(row_a) * D;
        if (col < D) store(p + col, o[n][0] * inv_a);
        if (col + 1 < D) store(p + col + 1, o[n][1] * inv_a);
      }
      if (row_b < S) {
        T* p = ob + static_cast<size_t>(row_b) * D;
        if (col < D) store(p + col, o[n][2] * inv_b);
        if (col + 1 < D) store(p + col + 1, o[n][3] * inv_b);
      }
    }
  }
}

// cuTensorMapEncodeTiled from the driver, through the runtime's entry
// point query (the library links no libcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled lookup_encoder() {
  void* p = nullptr;
  cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
  const cudaError_t err = cudaGetDriverEntryPointByVersion(
      "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
  const cudaError_t err = cudaGetDriverEntryPoint(
      "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
  if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
    return nullptr;
  return reinterpret_cast<EncodeTiled>(p);
}

// a (B*H, S, D) map over one input, boxes of 128 bytes by `rows` rows,
// 128B swizzle, zeros out of bounds; encoded on the host at every call
template <typename T>
bool make_map(CUtensorMap* map, const void* ptr, int BH, int S, int D,
              int rows) {
  static const EncodeTiled enc = lookup_encoder();
  if (enc == nullptr) return false;
  const cuuint64_t elem = sizeof(T);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(BH)};
  const cuuint64_t strides[2] = {D * elem,
                                 static_cast<cuuint64_t>(S) * D * elem};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(kLine / elem),
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t ones[3] = {1, 1, 1};
  const CUtensorMapDataType dt = std::is_same<T, float>::value
                                     ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  return enc(map, dt, 3, const_cast<void*>(ptr), dims, strides, box, ones,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int DMAX>
int run(const T* q, const T* k, const T* v, T* out, int BH, int S, int D,
        int causal, float scale, cudaStream_t stream, int rows, int kv_tile,
        int stages, int vec, int smem) {
  using C = Cfg<DMAX>;
  if (rows != C::kRows || kv_tile != C::kN || stages != kStages)
    return kPlanMismatch;
  constexpr int kTerms = std::is_same<T, float>::value ? 3 : 1;
  const long long blocks =
      static_cast<long long>(BH) * ((S + C::kRows - 1) / C::kRows);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap qm, km, vm;
  if (vec == 0) {
    if (!make_map<T>(&qm, q, BH, S, D, C::kRows) ||
        !make_map<T>(&km, k, BH, S, D, C::kN) ||
        !make_map<T>(&vm, v, BH, S, D, C::kN))
      return kNoTensorMap;
  } else {
    memset(&qm, 0, sizeof(qm));
    memset(&km, 0, sizeof(km));
    memset(&vm, 0, sizeof(vm));
  }
  auto kernel = flash_attention_kernel<T, DMAX, kTerms>;
  // above 48 KB a kernel opts in, once per device and size
  static int smem_set[64] = {};
  int dev = 0;
  if (smem > 48 * 1024 && (cudaGetDevice(&dev) != cudaSuccess || dev >= 64 ||
                           smem > smem_set[dev])) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 64) smem_set[dev] = smem;
  }
  kernel<<<static_cast<unsigned>(blocks), C::kThreads, smem, stream>>>(
      qm, km, vm, q, k, v, out, BH, S, D, causal, scale, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int BH,
             int S, int D, int causal, float scale, void* stream, int rows,
             int kv_tile, int stages, int vec, int smem) {
  if (BH <= 0 || S <= 0) return static_cast<int>(cudaSuccess);
  if (D < 1 || D > 256) return static_cast<int>(cudaErrorInvalidValue);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int d_pad = (D + 7) & ~7;
#define FLASH_RUN(DM)                                                       \
  return run<T, DM>(qt, kt, vt, ot, BH, S, D, causal, scale, st, rows,      \
                    kv_tile, stages, vec, smem)
  if (d_pad <= 16) FLASH_RUN(16);
  if (d_pad <= 32) FLASH_RUN(32);
  if (d_pad <= 64) FLASH_RUN(64);
  if (d_pad <= 128) FLASH_RUN(128);
  FLASH_RUN(256);
#undef FLASH_RUN
}

}  // namespace

// q, k, v, out: (B*H, S, D) contiguous, all of one type. BH = B * H. The
// plan (rows, kv_tile, stages, vec, smem) is flash_plan's; vec = 0 stages
// through TMA (16-byte aligned pointers, D * itemsize a multiple of 16).
extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* out, int BH, int S,
                                   int D, int causal, float scale,
                                   void* stream, int rows, int kv_tile,
                                   int stages, int vec, int smem) {
  return dispatch<float>(q, k, v, out, BH, S, D, causal, scale, stream, rows,
                         kv_tile, stages, vec, smem);
}

extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* out, int BH, int S,
                                    int D, int causal, float scale,
                                    void* stream, int rows, int kv_tile,
                                    int stages, int vec, int smem) {
  return dispatch<__nv_bfloat16>(q, k, v, out, BH, S, D, causal, scale,
                                 stream, rows, kv_tile, stages, vec, smem);
}
