// Fused 3x3 -> 3x3 residual bottleneck, f32, for the NVIDIA H100 (sm_90a):
//     out = silu(conv3x3(silu(conv3x3(x) + b1)) + b2) + x
// with BN folded into (w, b). Replaces
// spectrogram_yolov11_tpu/ops/pallas_fused_conv.py:67 fused_bottleneck.
//
// Layouts: x and out (B, H, W, C) NHWC contiguous; w1, w2 (9, C, C) = HWIO
// (3, 3, Cin, Cout) flattened; b1, b2 (C,). C is 32 or 64.
//
// Bound on the card: 2 * 2 * 9 * H * W * C^2 FLOPs per image (59 MFLOP at
// both of the model's shapes, 40x40x32 and 20x20x64) against 2 * H*W*C*4
// bytes of activations, so it is bound by operations on the f32 CUDA cores.
// Design, simple first:
//   - one CTA of 256 threads per (T x T output tile, image), T = 8;
//   - the (T+4)^2 x C input halo goes to shared memory, zero outside the image;
//   - conv1 + b1 + SiLU over the (T+2)^2 intermediate into shared memory, then
//     every intermediate position outside the image is set to 0 (conv2 sees
//     zero padding there, as in the unfused chain);
//   - conv2 + b2 + SiLU + x, stored; the intermediate never touches HBM;
//   - thread (g, co) computes output channel co at positions g, g+G, ... of a
//     tile (G = 256 / C); each step reads 4 input channels as one float4
//     broadcast from shared memory and 4 weights from global memory (L1/L2
//     resident: 295 KB in all at C = 64), for 4 FMAs per position.
// Tensor cores (TF32/bf16 wgmma), TMA and a persistent grid are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kT = 8;             // output tile edge
constexpr int kMid = kT + 2;      // intermediate tile edge
constexpr int kHalo = kT + 4;     // input tile edge
constexpr int kThreads = 256;

__device__ __forceinline__ float silu(float v) { return v / (1.0f + expf(-v)); }

// acc[r] += sum over taps and input channels of src[pos_r + tap][ci] * w[tap][ci][co]
template <int C, int P, int SRC_EDGE>
__device__ __forceinline__ void conv3x3_acc(const float* __restrict__ src, const int (&base)[P],
                                            const float* __restrict__ w, int co, float (&acc)[P]) {
  const float4* src4 = reinterpret_cast<const float4*>(src);
#pragma unroll 1
  for (int tap = 0; tap < 9; ++tap) {
    const int shift = ((tap / 3) * SRC_EDGE + (tap % 3)) * (C / 4);
    const float* wt = w + tap * C * C + co;
#pragma unroll 2
    for (int c4 = 0; c4 < C / 4; ++c4) {
      const float w0 = __ldg(wt + (4 * c4 + 0) * C);
      const float w1 = __ldg(wt + (4 * c4 + 1) * C);
      const float w2 = __ldg(wt + (4 * c4 + 2) * C);
      const float w3 = __ldg(wt + (4 * c4 + 3) * C);
#pragma unroll
      for (int r = 0; r < P; ++r) {
        const float4 v = src4[base[r] + shift + c4];
        acc[r] += v.x * w0 + v.y * w1 + v.z * w2 + v.w * w3;
      }
    }
  }
}

template <int C>
__global__ void __launch_bounds__(kThreads) fused_bottleneck_kernel(
    const float* __restrict__ x, const float* __restrict__ w1, const float* __restrict__ b1,
    const float* __restrict__ w2, const float* __restrict__ b2, float* __restrict__ out, int H, int W, int tiles_x) {
  constexpr int G = kThreads / C;                      // position groups
  constexpr int P1 = (kMid * kMid + G - 1) / G;        // intermediate positions per thread
  constexpr int P2 = (kT * kT) / G;                    // output positions per thread
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);         // (kHalo*kHalo, C)
  float* ys = xs + kHalo * kHalo * C;                  // (kMid*kMid, C)

  const int n = blockIdx.y;
  const int oy0 = (blockIdx.x / tiles_x) * kT, ox0 = (blockIdx.x % tiles_x) * kT;
  const int tid = threadIdx.x, co = tid % C, g = tid / C;
  const float* xn = x + (size_t)n * H * W * C;

  // input halo, zero outside the image
  for (int i = tid; i < kHalo * kHalo * C; i += kThreads) {
    const int pos = i / C, ci = i % C;
    const int gy = oy0 - 2 + pos / kHalo, gx = ox0 - 2 + pos % kHalo;
    xs[i] = (gy >= 0 && gy < H && gx >= 0 && gx < W) ? xn[((size_t)gy * W + gx) * C + ci] : 0.0f;
  }
  __syncthreads();

  // conv1 over the (T+2)^2 intermediate
  {
    int base[P1];
    float acc[P1];
#pragma unroll
    for (int r = 0; r < P1; ++r) {
      const int q = min(g + G * r, kMid * kMid - 1);  // tail rows recompute the last position
      base[r] = ((q / kMid) * kHalo + q % kMid) * (C / 4);
      acc[r] = 0.0f;
    }
    conv3x3_acc<C, P1, kHalo>(xs, base, w1, co, acc);
    const float bias = __ldg(b1 + co);
#pragma unroll
    for (int r = 0; r < P1; ++r) {
      const int q = g + G * r;
      if (q < kMid * kMid) {
        const int gy = oy0 - 1 + q / kMid, gx = ox0 - 1 + q % kMid;
        const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
        ys[q * C + co] = inside ? silu(acc[r] + bias) : 0.0f;
      }
    }
  }
  __syncthreads();

  // conv2 + bias + SiLU + residual over the T x T output tile
  {
    int base[P2];
    float acc[P2];
#pragma unroll
    for (int r = 0; r < P2; ++r) {
      const int o = g + G * r;
      base[r] = ((o / kT) * kMid + o % kT) * (C / 4);
      acc[r] = 0.0f;
    }
    conv3x3_acc<C, P2, kMid>(ys, base, w2, co, acc);
    const float bias = __ldg(b2 + co);
    float* on = out + (size_t)n * H * W * C;
#pragma unroll
    for (int r = 0; r < P2; ++r) {
      const int o = g + G * r;
      const int ty = o / kT, tx = o % kT;
      const int gy = oy0 + ty, gx = ox0 + tx;
      if (gy < H && gx < W) {
        const float res = xs[((ty + 2) * kHalo + tx + 2) * C + co];
        on[((size_t)gy * W + gx) * C + co] = silu(acc[r] + bias) + res;
      }
    }
  }
}

template <int C>
int launch(const float* x, const float* w1, const float* b1, const float* w2, const float* b2, float* out, int B,
           int H, int W, cudaStream_t s) {
  constexpr int smem = (kHalo * kHalo + kMid * kMid) * C * sizeof(float);
  // above 48 KB of dynamic shared memory needs the opt-in (set per device, so on every launch)
  cudaError_t e = cudaFuncSetAttribute(fused_bottleneck_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles_x = (W + kT - 1) / kT, tiles_y = (H + kT - 1) / kT;
  dim3 grid(tiles_x * tiles_y, B);
  fused_bottleneck_kernel<C><<<grid, kThreads, smem, s>>>(x, w1, b1, w2, b2, out, H, W, tiles_x);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int fused_bottleneck_f32(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
                                    void* out, int B, int H, int W, int C, void* stream) {
  const float* xf = static_cast<const float*>(x);
  const float* w1f = static_cast<const float*>(w1);
  const float* b1f = static_cast<const float*>(b1);
  const float* w2f = static_cast<const float*>(w2);
  const float* b2f = static_cast<const float*>(b2);
  float* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0 || W <= 0 || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (C == 32) return launch<32>(xf, w1f, b1f, w2f, b2f, of, B, H, W, s);
  if (C == 64) return launch<64>(xf, w1f, b1f, w2f, b2f, of, B, H, W, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
