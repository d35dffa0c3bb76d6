// Fused 3x3 -> 3x3 residual bottleneck for the NVIDIA H100 (sm_90a), in f32
// and in bf16:
//     out = silu(conv3x3(silu(conv3x3(x) + b1)) + b2) + x
// with BN folded into (w, b). Replaces
// spectrogram_yolov11_tpu/ops/pallas_fused_conv.py:67 fused_bottleneck, which
// runs in x's dtype: f32 sums, the intermediate and the output in x's dtype.
//
// Layouts: x and out (B, H, W, C) NHWC contiguous, 16-byte aligned, f32 or
// bf16; b1, b2 (C,) f32; w1p, w2p the weight packs of ops/fused_conv.py, C_in
// contiguous: f32 (2, 9, C, C) = (hi|lo, tap, C_out, C_in) from
// pack_bottleneck_weights, bf16 (9, C, C) = (tap, C_out, C_in) from
// pack_bottleneck_weights_bf16. C is 32, 64 or 128 (the C3k widths of scales
// n, s, m and l).
//
// What bounds it: 2 * 2 * 9 * H * W * C^2 FLOPs per image against 8 * H * W * C
// bytes of activations in f32 (4 * H * W * C in bf16), i.e. operations; in
// bf16 at C = 32 the bytes weigh as much. Design:
//   - implicit GEMM on the tensor cores: each conv is 9 accumulating products
//     (M = positions, N = C_out, K = C_in per tap), as the Pallas `_conv_acc`.
//     The warpgroups of a CTA each own 64-row blocks of M and issue wgmma with
//     A (the activations) from registers and B (the weights) from shared
//     memory through descriptors: m64nCk8 TF32 in f32, m64nCk16 bf16 in bf16,
//     32 bytes of K either way. GK = 2 k slices' A fragments are loaded at
//     once, then their wgmmas issue back to back and are waited for once;
//   - f32, 3xTF32 for f32 accuracy: every operand a splits into hi =
//     rna_tf32(a) and lo = a - hi, and D = a_lo*b_hi + a_hi*b_lo + a_hi*b_hi in
//     f32 (a_lo*b_lo, ~2^-22 relative, is dropped). The activations split in
//     registers, lo rounded with cvt.rna; the weights come split from the pack,
//     where lo is the exact remainder and the tensor cores read its TF32 bits.
//     The tensor cores add into their accumulator with truncation, so over
//     K = 9C products in one accumulator the errors pile up in one direction
//     (past 1e-4 at C = 128): each weight step's products go to a zeroed
//     accumulator, which is then added to the f32 sum with FADDs that round to
//     nearest;
//   - bf16, the Pallas kernel's arithmetic: one product per k slice (exact in
//     f32), summed in the f32 accumulator itself: 9C / 16 truncating adds per
//     conv, far below the bf16 rounding that follows. The intermediate is
//     rounded to bf16 after + b1 and SiLU, the output is
//     bf16(bf16(silu(acc2 + b2)) + x), as Pallas (:60, :64);
//   - one TH x TW output tile at a time: its (TH+4) x (TW+4) input halo goes to
//     shared memory by cp.async with zero fill outside the image; conv1 + b1 +
//     SiLU over the (TH+2) x (TW+2) intermediate stays in shared memory and is
//     set to 0 at every position outside the image (conv2 sees zero padding
//     there, as in the unfused chain); conv2 + b2 + SiLU + the residual, read
//     exactly from the halo, is stored NHWC. The intermediate never reaches HBM.
//     The halo and intermediate rows are padded by 16 bytes so that the A
//     fragment loads of a warp hit 32 distinct banks;
//   - the weights stream through a ring of STAGES stages, one (tap, CK input
//     channels) step each, hi and lo (f32) for all C_out: one thread issues
//     TMA loads of (C_out x BOX) boxes of the pack, one swizzle row of BOX
//     input channels each (128 bytes; 64 in bf16 at C = 32), swizzled as the
//     wgmma B descriptor reads them, completing on the stage's mbarrier. Steps
//     run on across the two convs and across tiles, STAGES - 1 ahead of the
//     MMAs, and each CTA starts at its own tap so that the CTAs' reads of the
//     same weights spread over L2. The halo stays on cp.async: its rows are
//     padded in shared memory, which a TMA box cannot write;
//   - persistent grid: min(tiles, resident CTAs) CTAs loop over (image, tile);
//     the shared-memory opt-in and the occupancy are found once per device.
//
// Tiles (bytes of shared memory: weight ring + halo + intermediate, plus 1 KB
// to align the ring for the swizzle); 64-row blocks of conv1 / conv2; CTAs
// per SM (registers a thread at most):
//   type  C    tile   warpgroups  CK  stages  ring    halo    interm.  blocks  CTAs/SM
//   f32   32   8x8    2           32  4       32,768  20,736  14,400   2 / 1   3 (80)
//   f32   64   10x10  3           64  3       98,304  53,312  39,168   3 / 2   1
//   f32   128  8x8    2           32  3       98,304  76,032  52,800   2 / 1   1
//   bf16  32   8x8    2           32  4        8,192  11,520   8,000   2 / 1   3 (80)
//   bf16  64   10x10  3           64  3       24,576  28,224  20,736   3 / 2   1
//   bf16  128  8x8    2           64  3       49,152  39,168  27,200   2 / 1   1
// The tiles cover the main path's 40x40 (C = 32) and 20x20 (C = 64) maps
// exactly. conv1 recomputes 100 / 64 = 1.56x (8x8) or 144 / 100 = 1.44x
// (10x10) of the intermediate, and the 64-row blocks pad 100, 64, 144 and
// 100 rows to 128, 64, 192 and 128. At C = 32 three CTAs share an SM: the
// MMAs of one tile, a chain of small N = 32 wgmmas, cannot fill it alone.
// The bf16 tiles are the f32 ones, so the two forms run the same schedule.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

template <class E, int C_, int TH_, int TW_, int CK_, int WGS_, int STAGES_, int MINB_, int GK_>
struct Tile {
  using Elem = E;  // activations and weights: float (3xTF32) or bf16
  static constexpr bool BF16 = std::is_same<E, bf16>::value;
  static constexpr int C = C_, TH = TH_, TW = TW_, CK = CK_, WGS = WGS_, STAGES = STAGES_, MINB = MINB_, GK = GK_;
  static constexpr int THREADS = 128 * WGS;
  static constexpr int ES = static_cast<int>(sizeof(E));
  static constexpr int PARTS = BF16 ? 1 : 2;                   // weight planes: hi|lo in f32, one in bf16
  static constexpr int KS = 32 / ES;                           // k of one wgmma: 32 bytes (8 TF32, 16 bf16)
  static constexpr int BOX = CK * ES >= 128 ? 128 / ES : CK;  // input channels of one TMA box: one swizzle row
  static constexpr int SW = BOX * ES;                          // swizzle row in bytes: 128, or 64 (bf16, CK = 32)
  static constexpr int S = C + 16 / ES;                        // elements per position in shared memory
  static constexpr int HH = TH + 4, HW = TW + 4;               // input halo
  static constexpr int MH = TH + 2, MW = TW + 2;               // intermediate
  static constexpr int M1 = MH * MW, M2 = TH * TW;             // GEMM rows of conv1 and conv2
  static constexpr int MB1 = (M1 + 63) / 64, MB2 = (M2 + 63) / 64;              // 64-row blocks
  static constexpr int R1 = (MB1 + WGS - 1) / WGS, R2 = (MB2 + WGS - 1) / WGS;  // blocks per warpgroup
  static constexpr int CHUNKS = C / CK, STEPS = 9 * CHUNKS;  // weight steps per conv
  static constexpr int KSTEPS = CK / KS;                     // wgmma k slices per weight step
  // GK k slices' A fragments are loaded at once, then their wgmmas issue back to back
  static constexpr int STAGE = PARTS * C * CK;               // elements per stage: [part][CK / BOX][C][BOX]
  static constexpr int XS = HH * HW * S, YS = M1 * S;
  static constexpr int SMEM = ES * (STAGES * STAGE + XS + YS) + 1024;
  static_assert(C % 8 == 0 && C <= 256 && C % CK == 0 && CK % BOX == 0 && (SW == 64 || SW == 128) && WGS <= 3 &&
                    KSTEPS % GK == 0,
                "tile shape");
  static_assert(SMEM <= 232448, "shared memory of one block");
};

using Tile32 = Tile<float, 32, 8, 8, 32, 2, 4, 3, 2>;
using Tile64 = Tile<float, 64, 10, 10, 64, 3, 3, 1, 2>;
using Tile128 = Tile<float, 128, 8, 8, 32, 2, 3, 1, 2>;
using Tile32b = Tile<bf16, 32, 8, 8, 32, 2, 4, 3, 2>;
using Tile64b = Tile<bf16, 64, 10, 10, 64, 3, 3, 1, 2>;
using Tile128b = Tile<bf16, 128, 8, 8, 64, 2, 3, 1, 2>;

__device__ __forceinline__ float silu(float v) { return v / (1.0f + expf(-v)); }

// two adjacent elements to and from f32; bf16 rounds to nearest even
__device__ __forceinline__ float2 load2(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(float* p, float a, float b) { *reinterpret_cast<float2*>(p) = make_float2(a, b); }
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
// v rounded to E (the Pallas kernel's astype before its residual add)
template <class E>
__device__ __forceinline__ float rounded(float v) {
  if constexpr (std::is_same<E, bf16>::value) return __bfloat162float(__float2bfloat16_rn(v));
  return v;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// round to nearest, ties away from zero, to TF32 (the low 13 mantissa bits cleared)
__device__ __forceinline__ uint32_t tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

// 16 bytes global -> shared; zeros when !fill (src is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool fill) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src), "r"(fill ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT_%=;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}
// TMA: box (c0, c1) of a 2-D tensor map into shared memory, completing on bar
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// shared-memory matrix descriptor of a K-major operand in the SW-byte swizzle
// (128 or 64): rows of SW bytes, 8-row groups 8 * SW bytes apart
template <int SW>
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) | (1ull << 16) | (static_cast<uint64_t>((8 * SW) >> 4) << 32) |
         (static_cast<uint64_t>(SW == 128 ? 1 : 2) << 62);
}

// D (64 x N f32, the m16n8 accumulator layout per warp) += A (64 x 8 TF32 or
// 64 x 16 bf16, registers) * B (8 x N TF32 or 16 x N bf16, shared memory,
// K-major)
template <class E, int N>
struct Wgmma;

template <>
struct Wgmma<float, 32> {
  static __device__ __forceinline__ void mma(float (&d)[16], const uint32_t (&a)[4], uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
  }
};

template <>
struct Wgmma<float, 64> {
  static __device__ __forceinline__ void mma(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
  }
};

template <>
struct Wgmma<float, 128> {
  static __device__ __forceinline__ void mma(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
  }
};

template <>
struct Wgmma<bf16, 32> {
  static __device__ __forceinline__ void mma(float (&d)[16], const uint32_t (&a)[4], uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
  }
};

template <>
struct Wgmma<bf16, 64> {
  static __device__ __forceinline__ void mma(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
  }
};

template <>
struct Wgmma<bf16, 128> {
  static __device__ __forceinline__ void mma(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
  }
};

// Issue weight step `step` of this CTA's sequence (conv1's STEPS steps, then
// conv2's, tile after tile, each conv starting at tap `rot`) into its ring
// stage: each part (hi and lo in f32), CK / BOX boxes of (C_out rows x BOX C_in) each.
template <class T>
__device__ __forceinline__ void load_weights(typename T::Elem* ring, uint64_t* full, const CUtensorMap* m1,
                                             const CUtensorMap* m2, long step, int rot) {
  const int s = static_cast<int>(step % T::STEPS + rot) % T::STEPS, tap = s / T::CHUNKS, chunk = s % T::CHUNKS;
  const CUtensorMap* map = ((step / T::STEPS) & 1) ? m2 : m1;
  const int stage = static_cast<int>(step % T::STAGES);
  typename T::Elem* dst = ring + stage * T::STAGE;
  mbar_expect_tx(full + stage, T::STAGE * T::ES);
#pragma unroll
  for (int part = 0; part < T::PARTS; ++part)
#pragma unroll
    for (int b = 0; b < T::CK / T::BOX; ++b)
      tma_load_2d(dst + (part * (T::CK / T::BOX) + b) * T::C * T::BOX, map, full + stage, chunk * T::CK + T::BOX * b,
                  (part * 9 + tap) * T::C);
}

// This warpgroup's f32 A fragments of k slice ks for its NB blocks: rows
// row0/row1, shifted by the tap, split into hi and lo
template <class T, int NB, int R>
__device__ __forceinline__ void load_a(uint32_t (&ah)[NB][4], uint32_t (&al)[NB][4], const float* src,
                                       const int (&row0)[R], const int (&row1)[R], int shift, int ks) {
#pragma unroll
  for (int r = 0; r < NB; ++r) {
    const float* s0 = src + row0[r] + shift + 8 * ks;
    const float* s1 = src + row1[r] + shift + 8 * ks;
    const float a[4] = {s0[0], s1[0], s0[4], s1[4]};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      ah[r][q] = tf32(a[q]);
      al[r][q] = tf32(a[q] - __uint_as_float(ah[r][q]));
    }
  }
}

// The same in bf16: each 32-bit register holds the pair of columns 2t, 2t + 1
// (then 2t + 8, 2t + 9) of row g or g + 8, the lower column in the low half
template <class T, int NB, int R>
__device__ __forceinline__ void load_a(uint32_t (&a)[NB][4], const bf16* src, const int (&row0)[R],
                                       const int (&row1)[R], int shift, int ks) {
#pragma unroll
  for (int r = 0; r < NB; ++r) {
    const bf16* s0 = src + row0[r] + shift + 16 * ks;
    const bf16* s1 = src + row1[r] + shift + 16 * ks;
    a[r][0] = *reinterpret_cast<const uint32_t*>(s0);
    a[r][1] = *reinterpret_cast<const uint32_t*>(s1);
    a[r][2] = *reinterpret_cast<const uint32_t*>(s0 + 8);
    a[r][3] = *reinterpret_cast<const uint32_t*>(s1 + 8);
  }
}

// shared address of k slice ks in a stage part at `w`: box ks / (BOX / KS),
// 32 bytes per slice into its swizzle rows
template <class T>
__device__ __forceinline__ uint32_t k_slice(uint32_t w, int ks) {
  constexpr int PER_BOX = T::BOX / T::KS;
  return w + (ks / PER_BOX) * T::C * T::SW + (ks % PER_BOX) * 32;
}

// acc[r] += the products of weight step s for this warpgroup's NB blocks
// (block r is wg + r * WGS): source rows row0/row1 shifted by the tap, against
// the stage's weights at shared address `w`
template <class T, int NB, int R, int SRC_W>
__device__ __forceinline__ void conv_step(float (&acc)[R][T::C / 2], const typename T::Elem* src,
                                          const int (&row0)[R], const int (&row1)[R], uint32_t w, int s) {
  const int tap = s / T::CHUNKS, chunk = s % T::CHUNKS;
  const int shift = ((tap / 3) * SRC_W + tap % 3) * T::S + chunk * T::CK;
  if constexpr (T::BF16) {
#pragma unroll
    for (int k0 = 0; k0 < T::KSTEPS; k0 += T::GK) {
      uint32_t a[T::GK][NB][4];
#pragma unroll
      for (int j = 0; j < T::GK; ++j) load_a<T, NB, R>(a[j], src, row0, row1, shift, k0 + j);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < T::GK; ++j) {
        const uint64_t b = smem_desc<T::SW>(k_slice<T>(w, k0 + j));
#pragma unroll
        for (int r = 0; r < NB; ++r) Wgmma<bf16, T::C>::mma(acc[r], a[j][r], b);
      }
      wgmma_commit();
      wgmma_wait<0>();
    }
  } else {
    constexpr uint32_t kLo = 4 * T::C * T::CK;  // bytes from the hi to the lo weights
    float d[NB][T::C / 2];
#pragma unroll
    for (int r = 0; r < NB; ++r)
#pragma unroll
      for (int i = 0; i < T::C / 2; ++i) d[r][i] = 0.0f;
#pragma unroll
    for (int k0 = 0; k0 < T::KSTEPS; k0 += T::GK) {
      uint32_t ah[T::GK][NB][4], al[T::GK][NB][4];
#pragma unroll
      for (int j = 0; j < T::GK; ++j) load_a<T, NB, R>(ah[j], al[j], src, row0, row1, shift, k0 + j);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < T::GK; ++j) {
        const uint32_t b = k_slice<T>(w, k0 + j);
        const uint64_t bh = smem_desc<T::SW>(b), bl = smem_desc<T::SW>(b + kLo);
#pragma unroll
        for (int r = 0; r < NB; ++r) {
          Wgmma<float, T::C>::mma(d[r], al[j][r], bh);
          Wgmma<float, T::C>::mma(d[r], ah[j][r], bl);
          Wgmma<float, T::C>::mma(d[r], ah[j][r], bh);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
    }
#pragma unroll
    for (int r = 0; r < NB; ++r)
#pragma unroll
      for (int i = 0; i < T::C / 2; ++i) acc[r][i] += d[r][i];
  }
}

// conv_step for warpgroup wg, whose blocks are wg, wg + WGS, ... < MB (a
// compile-time count per branch, so no wgmma sits in a divergent path)
template <class T, int MB, int R, int SRC_W>
__device__ __forceinline__ void conv_step_wg(float (&acc)[R][T::C / 2], const typename T::Elem* src,
                                             const int (&row0)[R], const int (&row1)[R], uint32_t w, int s, int wg) {
  constexpr int NB0 = (MB + T::WGS - 1) / T::WGS, NB1 = (MB + T::WGS - 2) / T::WGS, NB2 = (MB + T::WGS - 3) / T::WGS;
  if (wg == 0) {
    conv_step<T, NB0, R, SRC_W>(acc, src, row0, row1, w, s);
  } else if (wg == 1) {
    if constexpr (NB1 > 0) conv_step<T, NB1, R, SRC_W>(acc, src, row0, row1, w, s);
  } else {
    if constexpr (T::WGS > 2 && NB2 > 0) conv_step<T, NB2, R, SRC_W>(acc, src, row0, row1, w, s);
  }
}

// Start of weight step `step`: every warp is done with step - 1 (and, at a
// tile's first step, every thread's halo copies have landed); one thread puts
// step + STAGES - 1 in flight into the stage step - 1 used; all wait for the
// step's stage. Returns its shared address.
template <class T>
__device__ __forceinline__ uint32_t next_stage(typename T::Elem* ring, uint64_t* full, const CUtensorMap* m1,
                                               const CUtensorMap* m2, long step, long last, int rot, bool first,
                                               int tid) {
  if (first) cp_async_wait_all();
  __syncthreads();
  if (tid == 0 && step + T::STAGES - 1 < last) load_weights<T>(ring, full, m1, m2, step + T::STAGES - 1, rot);
  const int stage = static_cast<int>(step % T::STAGES);
  mbar_wait(full + stage, static_cast<uint32_t>((step / T::STAGES) & 1));
  return smem_u32(ring + stage * T::STAGE);
}

template <class T>
__global__ void __launch_bounds__(T::THREADS, T::MINB) fused_bottleneck_kernel(
    const __grid_constant__ CUtensorMap map1, const __grid_constant__ CUtensorMap map2,
    const typename T::Elem* __restrict__ x, const float* __restrict__ b1, const float* __restrict__ b2,
    typename T::Elem* __restrict__ out, int B, int H, int W, int tiles_x, int tiles_per_img) {
  using E = typename T::Elem;
  extern __shared__ float4 smem4[];
  __shared__ uint64_t full[T::STAGES];
  // ring first, at a 1024-byte boundary (the swizzle's period)
  E* ring = reinterpret_cast<E*>(reinterpret_cast<char*>(smem4) + ((1024 - (smem_u32(smem4) & 1023)) & 1023));
  E* xs = ring + T::STAGES * T::STAGE;  // (HH * HW, S) input halo
  E* ys = xs + T::XS;                   // (M1, S) intermediate

  const int tid = threadIdx.x, lane = tid & 31, wrow = ((tid >> 5) & 3) * 16;
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);  // warpgroup, known uniform to the compiler
  const int g = lane >> 2, t = lane & 3;
  constexpr int TC = T::KS / 8;  // A columns of a thread per 8-column half: 1 (TF32) or 2 (bf16)

  // shared-memory offsets of this thread's A rows wrow + g and wrow + g + 8 of
  // block wg + r * WGS (clamped into the grid: rows past its end compute
  // values that are never stored)
  int r1a[T::R1], r1b[T::R1], r2a[T::R2], r2b[T::R2];
#pragma unroll
  for (int r = 0; r < T::R1; ++r) {
    const int q = (wg + r * T::WGS) * 64 + wrow + g;
    const int qa = min(q, T::M1 - 1), qb = min(q + 8, T::M1 - 1);
    r1a[r] = ((qa / T::MW) * T::HW + qa % T::MW) * T::S + TC * t;
    r1b[r] = ((qb / T::MW) * T::HW + qb % T::MW) * T::S + TC * t;
  }
#pragma unroll
  for (int r = 0; r < T::R2; ++r) {
    const int o = (wg + r * T::WGS) * 64 + wrow + g;
    const int oa = min(o, T::M2 - 1), ob = min(o + 8, T::M2 - 1);
    r2a[r] = ((oa / T::TW) * T::MW + oa % T::TW) * T::S + TC * t;
    r2b[r] = ((ob / T::TW) * T::MW + ob % T::TW) * T::S + TC * t;
  }

  const int total = B * tiles_per_img;
  const int my_tiles = (total - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;
  const long last = 2L * T::STEPS * my_tiles;  // weight steps this CTA runs
  const int rot = blockIdx.x % T::STEPS;
  if (tid == 0) {
    for (int i = 0; i < T::STAGES; ++i) mbar_init(full + i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (long i = 0; i < T::STAGES - 1 && i < last; ++i) load_weights<T>(ring, full, &map1, &map2, i, rot);
  }
  long step = 0;

  for (int it = 0; it < my_tiles; ++it) {
    const int tile = blockIdx.x + it * gridDim.x;
    const int n = tile / tiles_per_img, ty = (tile % tiles_per_img) / tiles_x, tx = tile % tiles_x;
    const int oy0 = ty * T::TH, ox0 = tx * T::TW;
    const E* xn = x + static_cast<size_t>(n) * H * W * T::C;

    // input halo, zero outside the image; every warp is done with the last tile's
    __syncthreads();
    constexpr int VE = 16 / T::ES, V = T::C / VE;  // elements per 16-byte copy, copies per position
    for (int i = tid; i < T::HH * T::HW * V; i += T::THREADS) {
      const int p = i / V, v = i % V;
      const int gy = oy0 - 2 + p / T::HW, gx = ox0 - 2 + p % T::HW;
      const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
      cp_async16(xs + p * T::S + VE * v, inside ? xn + (static_cast<size_t>(gy) * W + gx) * T::C + VE * v : x,
                 inside);
    }
    cp_async_commit();

    // conv1 over the intermediate grid
    {
      float acc[T::R1][T::C / 2] = {};
      for (int s = 0; s < T::STEPS; ++s, ++step) {
        const uint32_t w = next_stage<T>(ring, full, &map1, &map2, step, last, rot, s == 0, tid);
        conv_step_wg<T, T::MB1, T::R1, T::HW>(acc, xs, r1a, r1b, w, (s + rot) % T::STEPS, wg);
      }
#pragma unroll
      for (int r = 0; r < T::R1; ++r) {
        if (wg + r * T::WGS >= T::MB1) break;
#pragma unroll
        for (int j = 0; j < T::C / 8; ++j) {
          const int c = 8 * j + 2 * t;
          const float bias0 = __ldg(b1 + c), bias1 = __ldg(b1 + c + 1);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int q = (wg + r * T::WGS) * 64 + wrow + g + 8 * h;
            if (q < T::M1) {
              const int gy = oy0 - 1 + q / T::MW, gx = ox0 - 1 + q % T::MW;
              const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
              store2(ys + q * T::S + c, inside ? silu(acc[r][4 * j + 2 * h] + bias0) : 0.0f,
                     inside ? silu(acc[r][4 * j + 2 * h + 1] + bias1) : 0.0f);
            }
          }
        }
      }
    }

    // conv2 + bias + SiLU + residual over the output tile
    {
      float acc[T::R2][T::C / 2] = {};
      for (int s = 0; s < T::STEPS; ++s, ++step) {
        const uint32_t w = next_stage<T>(ring, full, &map1, &map2, step, last, rot, false, tid);
        conv_step_wg<T, T::MB2, T::R2, T::MW>(acc, ys, r2a, r2b, w, (s + rot) % T::STEPS, wg);
      }
      E* on = out + static_cast<size_t>(n) * H * W * T::C;
#pragma unroll
      for (int r = 0; r < T::R2; ++r) {
        if (wg + r * T::WGS >= T::MB2) break;
#pragma unroll
        for (int j = 0; j < T::C / 8; ++j) {
          const int c = 8 * j + 2 * t;
          const float bias0 = __ldg(b2 + c), bias1 = __ldg(b2 + c + 1);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int o = (wg + r * T::WGS) * 64 + wrow + g + 8 * h;
            const int oy = o / T::TW, ox = o % T::TW;
            if (o < T::M2 && oy0 + oy < H && ox0 + ox < W) {
              const float2 res = load2(xs + ((oy + 2) * T::HW + ox + 2) * T::S + c);
              store2(on + (static_cast<size_t>(oy0 + oy) * W + ox0 + ox) * T::C + c,
                     rounded<E>(silu(acc[r][4 * j + 2 * h] + bias0)) + res.x,
                     rounded<E>(silu(acc[r][4 * j + 2 * h + 1] + bias1)) + res.y);
            }
          }
        }
      }
    }
  }
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no -lcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static std::atomic<EncodeTiled> fn{nullptr};
  EncodeTiled f = fn.load(std::memory_order_acquire);
  if (f == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      return nullptr;
    f = reinterpret_cast<EncodeTiled>(p);
    fn.store(f, std::memory_order_release);
  }
  return f;
}

// the pack (PARTS * 9 * C rows of C elements) in (C_out x BOX) boxes, swizzled
// in rows of SW bytes
template <class T>
bool weight_map(CUtensorMap* map, const void* pack) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(T::C), static_cast<cuuint64_t>(T::PARTS * 9 * T::C)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(T::C) * T::ES};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(T::BOX), static_cast<cuuint32_t>(T::C)}, elem[2] = {1, 1};
  return encode(map, T::BF16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                const_cast<void*>(pack), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                T::SW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

constexpr int kMaxDevices = 64;

template <class T>
int launch(const void* x, const void* w1p, const float* b1, const void* w2p, const float* b2, void* out, int B,
           int H, int W, cudaStream_t s) {
  // resident CTAs on the whole card, found once per device (the shared-memory
  // opt-in above 48 KB is set with it)
  static std::atomic<int> slots[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  int n_slots = slots[dev].load(std::memory_order_acquire);
  if (n_slots == 0) {
    e = cudaFuncSetAttribute(fused_bottleneck_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    int per_sm = 0, sms = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_bottleneck_kernel<T>, T::THREADS, T::SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (per_sm <= 0) return static_cast<int>(cudaErrorLaunchOutOfResources);
    n_slots = per_sm * sms;
    slots[dev].store(n_slots, std::memory_order_release);
  }
  CUtensorMap m1, m2;
  if (!weight_map<T>(&m1, w1p) || !weight_map<T>(&m2, w2p)) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles_x = (W + T::TW - 1) / T::TW, tiles_y = (H + T::TH - 1) / T::TH;
  const long total = static_cast<long>(B) * tiles_x * tiles_y;
  if (total > 0x7fffffffL) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = static_cast<int>(total < n_slots ? total : n_slots);
  using E = typename T::Elem;
  fused_bottleneck_kernel<T><<<grid, T::THREADS, T::SMEM, s>>>(
      m1, m2, static_cast<const E*>(x), b1, b2, static_cast<E*>(out), B, H, W, tiles_x, tiles_x * tiles_y);
  return static_cast<int>(cudaGetLastError());
}

template <class T32, class T64, class T128>
int dispatch(const void* x, const void* w1p, const void* b1, const void* w2p, const void* b2, void* out, int B, int H,
             int W, int C, void* stream) {
  const float* b1f = static_cast<const float*>(b1);
  const float* b2f = static_cast<const float*>(b2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0 || W <= 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (C) {
    case 32: return launch<T32>(x, w1p, b1f, w2p, b2f, out, B, H, W, s);
    case 64: return launch<T64>(x, w1p, b1f, w2p, b2f, out, B, H, W, s);
    case 128: return launch<T128>(x, w1p, b1f, w2p, b2f, out, B, H, W, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int fused_bottleneck_f32(const void* x, const void* w1p, const void* b1, const void* w2p, const void* b2,
                                    void* out, int B, int H, int W, int C, void* stream) {
  return dispatch<Tile32, Tile64, Tile128>(x, w1p, b1, w2p, b2, out, B, H, W, C, stream);
}

extern "C" int fused_bottleneck_bf16(const void* x, const void* w1p, const void* b1, const void* w2p, const void* b2,
                                     void* out, int B, int H, int W, int C, void* stream) {
  return dispatch<Tile32b, Tile64b, Tile128b>(x, w1p, b1, w2p, b2, out, B, H, W, C, stream);
}
