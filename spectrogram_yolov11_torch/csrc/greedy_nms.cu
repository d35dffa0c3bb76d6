// Exact greedy NMS keep mask for the NVIDIA H100 (sm_90a).
//
// Replaces spectrogram_yolov11_tpu/ops/pallas_nms.py:70 pallas_greedy_keep.
// Inputs per image: k boxes (x1, y1, x2, y2) f32 sorted by descending score,
// class offset already added, and a validity byte each. Output: keep[i] =
// valid[i] && no kept j < i has IoU(j, i) > thres.
//
// Bound on the card: a dependent scan, so latency, not bytes or FLOPs. The
// chain has one step per kept box, not one per candidate. Two launches on the
// caller's stream:
//   nms_mask_kernel  grid (words, words, b), 64 threads: the pair tests of
//                    valid rows in parallel into mask[b][i][word] (bit j of a
//                    word set when column j > i is valid and IoU > thres).
//                    Only blocks on or right of the diagonal whose rows and
//                    columns hold a valid candidate compute; the others return
//                    at once and write nothing.
//   nms_scan_kernel  one warp per image: lane w holds word w of `valid` (packed
//                    by ballots at the start) and of `removed`. A step finds
//                    the lowest candidate above the last one that is valid and
//                    not removed (ballot, __ffs, __ffsll): it is kept, and the
//                    lanes from its word on OR its mask row into `removed`.
// The scan reads the row of a valid candidate only, and only its words from
// the diagonal on; a word it reads that was never written covers invalid
// columns only, and `valid` masks every use of those bits.
// Build with -fmad=false: the IoU must round exactly as the plain PyTorch
// version's (ops/iou.py:box_iou), whose ops run one kernel each and never
// contract a multiply into an add.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 64;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float iou_of(float4 a, float4 b) {
  // box_iou operation order: inter / (area1 + area2 - inter + 1e-7)
  float iw = fmaxf(fminf(a.z, b.z) - fmaxf(a.x, b.x), 0.0f);
  float ih = fmaxf(fminf(a.w, b.w) - fmaxf(a.y, b.y), 0.0f);
  float inter = iw * ih;
  float area1 = fmaxf(a.z - a.x, 0.0f) * fmaxf(a.w - a.y, 0.0f);
  float area2 = fmaxf(b.z - b.x, 0.0f) * fmaxf(b.w - b.y, 0.0f);
  return inter / (((area1 + area2) - inter) + 1e-7f);
}

__global__ void nms_mask_kernel(const float4* __restrict__ boxes, const uint8_t* __restrict__ valid,
                                unsigned long long* __restrict__ mask, int k, int words, float thres) {
  const int col_block = blockIdx.x, row_block = blockIdx.y, img = blockIdx.z;
  if (col_block < row_block) return;  // no j > i left of the diagonal
  const float4* bx = boxes + (size_t)img * k;
  const uint8_t* v = valid + (size_t)img * k;
  __shared__ float4 cols[kBlock];
  __shared__ uint8_t col_valid[kBlock];
  const int c = col_block * kBlock + threadIdx.x, row = row_block * kBlock + threadIdx.x;
  const bool cv = c < k && v[c], rv = row < k && v[row];
  if (c < k) cols[threadIdx.x] = bx[c];
  col_valid[threadIdx.x] = cv;
  // block-uniform: both barriers are reached by every thread or by none
  if (!__syncthreads_or(rv) || !__syncthreads_or(cv) || !rv) return;

  const float4 a = bx[row];
  const int n = min(kBlock, k - col_block * kBlock);
  unsigned long long bits = 0ull;
  for (int j = 0; j < n; ++j) {
    const int col = col_block * kBlock + j;
    if (col_valid[j] && col > row && iou_of(a, cols[j]) > thres) bits |= 1ull << j;
  }
  mask[((size_t)img * k + row) * words + col_block] = bits;
}

__global__ void nms_scan_kernel(const unsigned long long* __restrict__ mask, const uint8_t* __restrict__ valid,
                                uint8_t* __restrict__ keep, int k, int words) {
  const int img = blockIdx.x, lane = threadIdx.x;  // one warp
  const unsigned long long* m = mask + (size_t)img * k * words;
  const uint8_t* v = valid + (size_t)img * k;

  unsigned long long valid_w = 0ull, removed = 0ull;
  for (int c = 0; c < 2 * words; ++c) {  // 32 candidates a ballot, coalesced
    const int i = 32 * c + lane;
    const unsigned bits = __ballot_sync(kFull, i < k && v[i]);
    if (lane == (c >> 1)) valid_w |= static_cast<unsigned long long>(bits) << (32 * (c & 1));
  }

  int last = -1;  // the last candidate kept
  while (true) {
    unsigned long long live = valid_w & ~removed;
    const int from = last + 1 - 64 * lane;  // first bit of this lane's word above `last`
    if (from >= 64)
      live = 0ull;
    else if (from > 0)
      live &= ~0ull << from;
    const unsigned owners = __ballot_sync(kFull, live != 0ull);
    if (owners == 0u) break;
    const int owner = __ffs(owners) - 1;
    const int i = 64 * owner + __shfl_sync(kFull, __ffsll(live) - 1, owner);
    if (lane >= owner && lane < words) removed |= m[(size_t)i * words + lane];
    last = i;
  }

  const unsigned long long kept = valid_w & ~removed;
  for (int c = 0; c < 2 * words; ++c) {
    const int i = 32 * c + lane;
    const unsigned long long w = __shfl_sync(kFull, kept, c >> 1);
    if (i < k) keep[(size_t)img * k + i] = static_cast<uint8_t>((w >> (32 * (c & 1) + lane)) & 1ull);
  }
}

}  // namespace

extern "C" int greedy_nms_keep(const void* boxes, const void* valid, void* mask, void* keep, int b, int k,
                               float thres, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int words = (k + kBlock - 1) / kBlock;
  if (words > 32) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(words, words, b);
  nms_mask_kernel<<<grid, kBlock, 0, s>>>(static_cast<const float4*>(boxes), static_cast<const uint8_t*>(valid),
                                          static_cast<unsigned long long*>(mask), k, words, thres);
  nms_scan_kernel<<<b, 32, 0, s>>>(static_cast<const unsigned long long*>(mask),
                                   static_cast<const uint8_t*>(valid), static_cast<uint8_t*>(keep), k, words);
  return static_cast<int>(cudaGetLastError());
}
