// Exact greedy NMS keep mask for the NVIDIA H100 (sm_90a).
//
// Replaces spectrogram_yolov11_tpu/ops/pallas_nms.py:70 pallas_greedy_keep.
// Inputs per image: k boxes (x1, y1, x2, y2) f32 sorted by descending score,
// class offset already added, and a validity byte each. Output: keep[i] =
// valid[i] && no kept j < i has IoU(j, i) > thres.
//
// Bound on the card: a k-step dependent scan, so latency, not bytes or FLOPs.
// Two launches on the caller's stream:
//   nms_mask_kernel  grid (words, words, b), 64 threads: all pair tests in
//                    parallel into mask[b][i][word] (bit j of a word set when
//                    column j > i and IoU > thres).
//   nms_scan_kernel  one warp per image: lane w holds word w of `removed`;
//                    k steps, each one shuffle plus, for a survivor, one
//                    64-bit load and OR per lane.
// Build with -fmad=false: the IoU must round exactly as the plain PyTorch
// version's (ops/iou.py:box_iou), whose ops run one kernel each and never
// contract a multiply into an add.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 64;

__device__ __forceinline__ float iou_of(float4 a, float4 b) {
  // box_iou operation order: inter / (area1 + area2 - inter + 1e-7)
  float iw = fmaxf(fminf(a.z, b.z) - fmaxf(a.x, b.x), 0.0f);
  float ih = fmaxf(fminf(a.w, b.w) - fmaxf(a.y, b.y), 0.0f);
  float inter = iw * ih;
  float area1 = fmaxf(a.z - a.x, 0.0f) * fmaxf(a.w - a.y, 0.0f);
  float area2 = fmaxf(b.z - b.x, 0.0f) * fmaxf(b.w - b.y, 0.0f);
  return inter / (((area1 + area2) - inter) + 1e-7f);
}

__global__ void nms_mask_kernel(const float4* __restrict__ boxes, unsigned long long* __restrict__ mask,
                                int k, int words, float thres) {
  const int col_block = blockIdx.x, row_block = blockIdx.y, img = blockIdx.z;
  const float4* bx = boxes + (size_t)img * k;
  __shared__ float4 cols[kBlock];
  const int c = col_block * kBlock + threadIdx.x;
  if (c < k) cols[threadIdx.x] = bx[c];
  __syncthreads();

  const int row = row_block * kBlock + threadIdx.x;
  if (row >= k) return;
  unsigned long long bits = 0ull;
  if (col_block >= row_block) {  // blocks left of the diagonal hold no j > i
    const float4 a = bx[row];
    const int n = min(kBlock, k - col_block * kBlock);
    for (int j = 0; j < n; ++j) {
      const int col = col_block * kBlock + j;
      if (col > row && iou_of(a, cols[j]) > thres) bits |= 1ull << j;
    }
  }
  mask[((size_t)img * k + row) * words + col_block] = bits;
}

__global__ void nms_scan_kernel(const unsigned long long* __restrict__ mask, const uint8_t* __restrict__ valid,
                                uint8_t* __restrict__ keep, int k, int words) {
  const int img = blockIdx.x, lane = threadIdx.x;  // one warp
  const unsigned long long* m = mask + (size_t)img * k * words;
  const uint8_t* v = valid + (size_t)img * k;
  unsigned long long removed = 0ull;
  for (int i = 0; i < k; ++i) {
    const unsigned long long w = __shfl_sync(0xffffffffu, removed, i >> 6);
    const bool alive = v[i] && !((w >> (i & 63)) & 1ull);  // same value in every lane
    if (alive && lane < words) removed |= m[(size_t)i * words + lane];
  }
  if (lane < words) {
    for (int j = 0; j < 64; ++j) {
      const int i = lane * 64 + j;
      if (i < k) keep[(size_t)img * k + i] = v[i] && !((removed >> j) & 1ull);
    }
  }
}

}  // namespace

extern "C" int greedy_nms_keep(const void* boxes, const void* valid, void* mask, void* keep, int b, int k,
                               float thres, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int words = (k + kBlock - 1) / kBlock;
  if (words > 32) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(words, words, b);
  nms_mask_kernel<<<grid, kBlock, 0, s>>>(static_cast<const float4*>(boxes),
                                          static_cast<unsigned long long*>(mask), k, words, thres);
  nms_scan_kernel<<<b, 32, 0, s>>>(static_cast<const unsigned long long*>(mask),
                                   static_cast<const uint8_t*>(valid), static_cast<uint8_t*>(keep), k, words);
  return static_cast<int>(cudaGetLastError());
}
