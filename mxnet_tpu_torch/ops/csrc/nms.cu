// Greedy non-maximum suppression over score-sorted boxes, for a whole
// batch in one call: (B, N) boxes -> (B, N) keep mask.
//
// Replaces the Pallas kernel `_nms_kernel` / `nms_keep`
// (mxnet_tpu/ops/pallas_kernels.py:52-118), which walks i = 0..N-1 in a
// fori_loop over one (8, Np) lane-packed block per image and, for a kept
// box i, clears every later valid box j of the same class (any class
// under force_suppress) whose IoU with i exceeds the threshold. The TPU
// layout (lane packing, padding to 128 lanes, the class -2 of padded
// lanes, masked-sum scalar extraction) is not carried over; the scheme is
// the reference MXNet's CUDA one (src/operator/contrib/bounding_box.cu):
//
//   1. nms_keep_mask_kernel, grid (W, W, B) with W = ceil(N / 64), one
//      thread per row i of a 64-row block against the 64 columns j of a
//      64-column block staged in shared memory: bit (j mod 64) of word
//      mask[b, i, j / 64] is set when j > i, the classes match (or
//      force_suppress), and IoU(i, j) > thresh. Blocks wholly below the
//      diagonal return at once, and an invalid row writes 0 without
//      computing an IoU (an invalid box suppresses nothing).
//   2. nms_keep_scan_kernel, one warp per image: the greedy walk. The
//      removed set (W words) lives in shared memory. The warp takes 32
//      boxes at a time, ballots the valid ones and visits them in order;
//      a visited box that is not removed is kept, and the warp ORs its
//      mask row (words i / 64 .. W - 1) into the removed set.
//
// The walk is exactly the Pallas fori_loop: a box suppresses only later
// boxes, and only when it is itself valid and not yet removed.
//
// What bounds it on an H100: the inputs are 21 bytes a box, and at the SSD
// shape (B = 8, N = 3840, <= 100 valid a image) the IoU work is a few
// thousand pairs, so the bound is a fraction of a microsecond and the two
// launches and the serial walk (one warp, one step per valid box) set the
// time. Phase 1 writes B * N * W * 8 bytes of mask (14.7 MB at the SSD
// shape), which the scan reads only for kept rows.
//
// Bit-for-bit decisions: the keep mask is boolean, so a pair whose IoU
// lies on the threshold must decide as the plain version
// (ops/nms.py: nms_keep_reference) decides. The IoU lines keep the Pallas
// order of operations and use the _rn intrinsics, so nvcc cannot contract
// a product and a sum into an FMA under -O3:
//   area  = max(x2 - x1, 0) * max(y2 - y1, 0)
//   inter = max(min(x2_i, x2_j) - max(x1_i, x1_j), 0) * (same in y)
//   iou   = inter / max(area_j + area_i - inter, 1e-12);  keep if iou > t
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 64;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float box_area(float x1, float y1, float x2,
                                          float y2) {
  return __fmul_rn(fmaxf(__fsub_rn(x2, x1), 0.f),
                   fmaxf(__fsub_rn(y2, y1), 0.f));
}

__global__ void nms_keep_mask_kernel(const float* __restrict__ boxes,
                                     const float* __restrict__ cls,
                                     const uint8_t* __restrict__ valid,
                                     unsigned long long* __restrict__ mask,
                                     int n, int words, float thresh,
                                     int force) {
  const int b = blockIdx.z;
  const int row_block = blockIdx.y;
  const int col_block = blockIdx.x;
  if (col_block < row_block) return;  // every j here is below every i

  __shared__ float sx1[kBlock], sy1[kBlock], sx2[kBlock], sy2[kBlock];
  __shared__ float sarea[kBlock], scls[kBlock];
  const int t = threadIdx.x;
  const int col0 = col_block * kBlock;
  const int ncols = min(kBlock, n - col0);
  const float* bb = boxes + (size_t)b * n * 4;
  const float* cb = cls + (size_t)b * n;
  if (t < ncols) {
    const int j = col0 + t;
    const float x1 = bb[4 * j], y1 = bb[4 * j + 1];
    const float x2 = bb[4 * j + 2], y2 = bb[4 * j + 3];
    sx1[t] = x1;
    sy1[t] = y1;
    sx2[t] = x2;
    sy2[t] = y2;
    sarea[t] = box_area(x1, y1, x2, y2);
    scls[t] = cb[j];
  }
  __syncthreads();

  const int i = row_block * kBlock + t;
  if (i >= n) return;
  unsigned long long bits = 0ull;
  if (valid[(size_t)b * n + i]) {
    const float xi1 = bb[4 * i], yi1 = bb[4 * i + 1];
    const float xi2 = bb[4 * i + 2], yi2 = bb[4 * i + 3];
    const float ai = box_area(xi1, yi1, xi2, yi2);
    const float ci = cb[i];
    // on the diagonal block only the columns after row i count
    const int start = col_block == row_block ? t + 1 : 0;
    for (int k = start; k < ncols; ++k) {
      if (!force && scls[k] != ci) continue;
      const float iw = fmaxf(
          __fsub_rn(fminf(sx2[k], xi2), fmaxf(sx1[k], xi1)), 0.f);
      const float ih = fmaxf(
          __fsub_rn(fminf(sy2[k], yi2), fmaxf(sy1[k], yi1)), 0.f);
      const float inter = __fmul_rn(iw, ih);
      const float denom =
          fmaxf(__fsub_rn(__fadd_rn(sarea[k], ai), inter), 1e-12f);
      if (__fdiv_rn(inter, denom) > thresh) bits |= 1ull << k;
    }
  }
  mask[((size_t)b * n + i) * words + col_block] = bits;
}

__global__ void nms_keep_scan_kernel(const uint8_t* __restrict__ valid,
                                     const unsigned long long* __restrict__ mask,
                                     uint8_t* __restrict__ keep, int n,
                                     int words) {
  extern __shared__ unsigned long long removed[];
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  for (int w = lane; w < words; w += 32) removed[w] = 0ull;
  __syncwarp();

  const uint8_t* vb = valid + (size_t)b * n;
  const unsigned long long* mb = mask + (size_t)b * n * words;
  uint8_t* kb = keep + (size_t)b * n;
  for (int base = 0; base < n; base += 32) {
    const int idx = base + lane;
    unsigned cand = __ballot_sync(kFull, idx < n && vb[idx]);
    unsigned kept = 0u;
    while (cand) {  // the same on every lane: the branch is uniform
      const int k = __ffs(cand) - 1;
      cand &= cand - 1;
      const int i = base + k;
      if ((removed[i >> 6] >> (i & 63)) & 1ull) continue;
      kept |= 1u << k;
      const unsigned long long* row = mb + (size_t)i * words;
      for (int w = (i >> 6) + lane; w < words; w += 32) removed[w] |= row[w];
      __syncwarp();  // the next box reads what the other lanes wrote
    }
    if (idx < n) kb[idx] = (kept >> lane) & 1u;
  }
}

}  // namespace

// boxes (B, N, 4) f32 corner, cls (B, N) f32, valid (B, N) u8 (0/1),
// mask (B, N, ceil(N / 64)) u64 scratch, keep (B, N) u8 output; all
// contiguous on the device. Returns the CUDA error of the launches.
extern "C" int nms_keep_f32(const float* boxes, const float* cls,
                            const uint8_t* valid, unsigned long long* mask,
                            uint8_t* keep, int batch, int n, float thresh,
                            int force, cudaStream_t stream) {
  const int words = (n + kBlock - 1) / kBlock;
  const dim3 grid(words, words, batch);
  nms_keep_mask_kernel<<<grid, kBlock, 0, stream>>>(
      boxes, cls, valid, mask, n, words, thresh, force);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  nms_keep_scan_kernel<<<batch, 32, words * sizeof(unsigned long long),
                         stream>>>(valid, mask, keep, n, words);
  return (int)cudaGetLastError();
}
