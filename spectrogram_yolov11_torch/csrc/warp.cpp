// The host half of training-time augmentation, behind a plain C interface
// for ctypes: the bilinear warps and the 8-bit HSV conversions that the JAX
// package runs through cv2 (spectrogram_yolov11_tpu/data/augment.py:68
// augment_hsv, :211-214 cv2.warpAffine / cv2.warpPerspective), byte for byte
// as OpenCV 5.0.0 computes them on an x86-64 host (its AVX2 kernels).
//
// Warps (3-channel uint8, BORDER_CONSTANT). The forward matrix is inverted
// in double as cv2 inverts it (2x3: the explicit 1/det formula of
// imgwarp.cpp; 3x3: the cofactor formula of cv::invert for n = 3) and cast
// to float. Per output row y, columns [0, 16 * (W / 16)) are the vector
// blocks and the rest the scalar tail, whose source coordinates round
// differently:
//   blocks: bx = float(y) * m1 + m2 (two roundings), sx = fma(m0, x, bx);
//   tail:   sx = fma(x, m0, float(y) * m1) + m2;
// likewise sy (and the perspective's w, sx = nx / w). ix = floor(sx),
// a = sx - ix; a tap outside the source reads the border value; per channel
//   t = fma(a, p01 - p00, p00), u = fma(a, p11 - p10, p10), v = fma(b, u - t, t),
// rounded half to even. A non-finite coordinate, or one beyond the source
// by a pixel or more, gives the border value.
//
// HSV (hue in 0-180). BGR -> HSV is cv2's integer path: 12-bit tables
// sdiv[v] = round(255 * 4096 / v), hdiv[d] = round(180 * 4096 / (6 d)).
// HSV -> BGR is float: s = S * f(1/255), v = V * f(1/255), h = H * f(6/180),
// sector = floor(fmod(h, 6)), f = h - sector, and the four values v,
// v * (1 - s), v * fma(-s, f, 1), v * fma(-s, 1 - f, 1); each output is the
// value times 255, truncated in the 32-pixel vector blocks of a row and
// rounded half to even in its tail.
//
// Every multiply-add that cv2 fuses is an explicit fmaf here, and the file is
// built with -ffp-contract=off so that the compiler fuses nothing else (and
// -fno-math-errno, so that floorf and lrintf become instructions).
// data/warp.py holds a numpy twin of each function.

#include <cmath>
#include <cstdint>

namespace {

constexpr int kWarpBlock = 16;  // output columns per vector block of cv2's AVX2 warp kernels
constexpr int kHsvBlock = 32;   // pixels per vector block of cv2's AVX2 HSV -> BGR

// cv2's inverse of a 2x3 affine matrix (imgwarp.cpp, warpAffine without WARP_INVERSE_MAP), as float.
void invert_affine(const double* M, float* out) {
    double D = M[0] * M[4] - M[1] * M[3];
    D = D != 0 ? 1. / D : 0;
    const double A11 = M[4] * D, A22 = M[0] * D, A12 = M[1] * -D, A21 = M[3] * -D;
    const double b1 = -A11 * M[2] - A12 * M[5];
    const double b2 = -A21 * M[2] - A22 * M[5];
    const double inv[6] = {A11, A12, b1, A21, A22, b2};
    for (int i = 0; i < 6; i++) out[i] = static_cast<float>(inv[i]);
}

// cv::invert(DECOMP_LU) of a 3x3 matrix (the closed form cv2 uses for n <= 3), as float.
bool invert_perspective(const double* S, float* out) {
    const double d = S[0] * (S[4] * S[8] - S[7] * S[5]) - S[1] * (S[3] * S[8] - S[6] * S[5]) +
                     S[2] * (S[3] * S[7] - S[6] * S[4]);
    if (d == 0.) return false;
    const double r = 1. / d;
    const double t[9] = {
        (S[4] * S[8] - S[5] * S[7]) * r, (S[2] * S[7] - S[1] * S[8]) * r, (S[1] * S[5] - S[2] * S[4]) * r,
        (S[5] * S[6] - S[3] * S[8]) * r, (S[0] * S[8] - S[2] * S[6]) * r, (S[2] * S[3] - S[0] * S[5]) * r,
        (S[3] * S[7] - S[4] * S[6]) * r, (S[1] * S[6] - S[0] * S[7]) * r, (S[0] * S[4] - S[1] * S[3]) * r,
    };
    for (int i = 0; i < 9; i++) out[i] = static_cast<float>(t[i]);
    return true;
}

// Inlined into each clone of the row loops below, so its fmaf is an instruction where the host has FMA.
inline __attribute__((always_inline)) void sample_bilinear(const uint8_t* src, int sh, int sw, float sx, float sy, uint8_t border, uint8_t* out) {
    if (!(sx >= -1.f && sx < static_cast<float>(sw) && sy >= -1.f && sy < static_cast<float>(sh))) {
        out[0] = out[1] = out[2] = border;
        return;
    }
    const float fx = std::floor(sx), fy = std::floor(sy);
    const int ix = static_cast<int>(fx), iy = static_cast<int>(fy);
    const float a = sx - fx, b = sy - fy;
    const uint8_t* r0 = src + (static_cast<int64_t>(iy) * sw + ix) * 3;
    const uint8_t* r1 = r0 + static_cast<int64_t>(sw) * 3;
    float p[4][3];
    if (static_cast<unsigned>(ix) < static_cast<unsigned>(sw - 1) &&
        static_cast<unsigned>(iy) < static_cast<unsigned>(sh - 1)) {
        for (int c = 0; c < 3; c++) {
            p[0][c] = r0[c];
            p[1][c] = r0[3 + c];
            p[2][c] = r1[c];
            p[3][c] = r1[3 + c];
        }
    } else {
        const bool x0 = ix >= 0, x1 = ix + 1 < sw, y0 = iy >= 0, y1 = iy + 1 < sh;
        for (int c = 0; c < 3; c++) {
            p[0][c] = y0 && x0 ? r0[c] : border;
            p[1][c] = y0 && x1 ? r0[3 + c] : border;
            p[2][c] = y1 && x0 ? r1[c] : border;
            p[3][c] = y1 && x1 ? r1[3 + c] : border;
        }
    }
    for (int c = 0; c < 3; c++) {
        const float t = std::fmaf(a, p[1][c] - p[0][c], p[0][c]);
        const float u = std::fmaf(a, p[3][c] - p[2][c], p[2][c]);
        const long q = std::lrintf(std::fmaf(b, u - t, t));
        out[c] = static_cast<uint8_t>(q < 0 ? 0 : (q > 255 ? 255 : q));
    }
}

__attribute__((target_clones("fma", "default")))
void affine_rows(const uint8_t* src, int sh, int sw, uint8_t* dst, int dh, int dw, const float* m, uint8_t border) {
    const int nv = dw / kWarpBlock * kWarpBlock;
    for (int y = 0; y < dh; y++) {
        const float fy = static_cast<float>(y);
        const float bx = fy * m[1] + m[2], by = fy * m[4] + m[5];
        uint8_t* row = dst + static_cast<int64_t>(y) * dw * 3;
        for (int x = 0; x < dw; x++) {
            const float fx = static_cast<float>(x);
            float sx, sy;
            if (x < nv) {
                sx = std::fmaf(m[0], fx, bx);
                sy = std::fmaf(m[3], fx, by);
            } else {
                sx = std::fmaf(fx, m[0], fy * m[1]) + m[2];
                sy = std::fmaf(fx, m[3], fy * m[4]) + m[5];
            }
            sample_bilinear(src, sh, sw, sx, sy, border, row + x * 3);
        }
    }
}

__attribute__((target_clones("fma", "default")))
void perspective_rows(const uint8_t* src, int sh, int sw, uint8_t* dst, int dh, int dw, const float* m,
                      uint8_t border) {
    const int nv = dw / kWarpBlock * kWarpBlock;
    for (int y = 0; y < dh; y++) {
        const float fy = static_cast<float>(y);
        const float bx = fy * m[1] + m[2], by = fy * m[4] + m[5], bw = fy * m[7] + m[8];
        uint8_t* row = dst + static_cast<int64_t>(y) * dw * 3;
        for (int x = 0; x < dw; x++) {
            const float fx = static_cast<float>(x);
            float nx, ny, w;
            if (x < nv) {
                w = std::fmaf(m[6], fx, bw);
                nx = std::fmaf(m[0], fx, bx);
                ny = std::fmaf(m[3], fx, by);
            } else {
                w = std::fmaf(fx, m[6], fy * m[7]) + m[8];
                nx = std::fmaf(fx, m[0], fy * m[1]) + m[2];
                ny = std::fmaf(fx, m[3], fy * m[4]) + m[5];
            }
            sample_bilinear(src, sh, sw, nx / w, ny / w, border, row + x * 3);
        }
    }
}

struct HsvTables {
    int sdiv[256];
    int hdiv[256];
    float unit[256];    // k * f(1/255): S and V as floats
    int sector[256];    // per hue H: floor(fmod(H * f(6/180), 6)), and the fraction past it
    float frac[256];
    HsvTables() {
        const float inv255 = static_cast<float>(1.0 / 255.0), hscale = static_cast<float>(6.0 / 180.0);
        sdiv[0] = hdiv[0] = 0;
        for (int i = 1; i < 256; i++) {
            sdiv[i] = static_cast<int>(std::nearbyint((255 << 12) / (1. * i)));
            hdiv[i] = static_cast<int>(std::nearbyint((180 << 12) / (6. * i)));
        }
        for (int i = 0; i < 256; i++) {
            unit[i] = static_cast<float>(i) * inv255;
            const float h = std::fmod(static_cast<float>(i) * hscale, 6.f);
            sector[i] = static_cast<int>(std::floor(h));
            frac[i] = h - static_cast<float>(sector[i]);
            if (static_cast<unsigned>(sector[i]) >= 6u) {
                sector[i] = 0;
                frac[i] = 0.f;
            }
        }
    }
};

const HsvTables kHsv;

inline __attribute__((always_inline)) void bgr_to_hsv_px(const uint8_t* p, uint8_t* q) {
    const int b = p[0], g = p[1], r = p[2];
    int v = b, vmin = b;
    v = v > g ? v : g;
    v = v > r ? v : r;
    vmin = vmin < g ? vmin : g;
    vmin = vmin < r ? vmin : r;
    const int diff = v - vmin;
    const int s = (diff * kHsv.sdiv[v] + (1 << 11)) >> 12;
    int h = v == r ? g - b : (v == g ? b - r + 2 * diff : r - g + 4 * diff);
    h = (h * kHsv.hdiv[diff] + (1 << 11)) >> 12;
    h += h < 0 ? 180 : 0;
    q[0] = static_cast<uint8_t>(h);
    q[1] = static_cast<uint8_t>(s);
    q[2] = static_cast<uint8_t>(v);
}

// Truncated in a vector block (`truncate`), rounded half to even in the tail.
inline __attribute__((always_inline)) void hsv_to_bgr_px(const uint8_t* p, uint8_t* q, bool truncate) {
    static const int sector_data[6][3] = {{1, 3, 0}, {1, 0, 2}, {3, 0, 1}, {0, 2, 1}, {0, 1, 3}, {2, 1, 0}};
    const float s = kHsv.unit[p[1]], v = kHsv.unit[p[2]];
    float bgr[3];
    if (s == 0.f) {
        bgr[0] = bgr[1] = bgr[2] = v;
    } else {
        const int sector = kHsv.sector[p[0]];
        const float h = kHsv.frac[p[0]];
        const float tab[4] = {v, v * (1.f - s), v * std::fmaf(-s, h, 1.f), v * std::fmaf(-s, 1.f - h, 1.f)};
        for (int c = 0; c < 3; c++) bgr[c] = tab[sector_data[sector][c]];
    }
    for (int c = 0; c < 3; c++) {
        const float x = bgr[c] * 255.f;
        const long k = truncate ? static_cast<long>(x) : std::lrintf(x);
        q[c] = static_cast<uint8_t>(k < 0 ? 0 : (k > 255 ? 255 : k));
    }
}

// HSV -> BGR of rows x width pixels, each pixel's HSV first through `lut`
// (3 x 256: hue, saturation, value) when it is given, and from BGR when `bgr_in`.
__attribute__((target_clones("fma", "default")))
void hsv_rows(const uint8_t* src, uint8_t* dst, int rows, int width, const uint8_t* lut, bool bgr_in) {
    const int nv = width / kHsvBlock * kHsvBlock;
    for (int64_t y = 0; y < rows; y++)
        for (int x = 0; x < width; x++) {
            const int64_t o = (y * width + x) * 3;
            uint8_t hsv[3] = {src[o], src[o + 1], src[o + 2]};
            if (bgr_in) bgr_to_hsv_px(src + o, hsv);
            if (lut) {
                hsv[0] = lut[hsv[0]];
                hsv[1] = lut[256 + hsv[1]];
                hsv[2] = lut[512 + hsv[2]];
            }
            hsv_to_bgr_px(hsv, dst + o, x < nv);
        }
}

}  // namespace

extern "C" {

// dst (dh, dw, 3) = cv2.warpAffine(src (sh, sw, 3), M (2x3 row-major, forward), (dw, dh),
// borderValue=(border,) * 3). Returns 0.
int warp_affine_u8(const uint8_t* src, int sh, int sw, uint8_t* dst, int dh, int dw, const double* M, int border) {
    float m[6];
    invert_affine(M, m);
    affine_rows(src, sh, sw, dst, dh, dw, m, static_cast<uint8_t>(border));
    return 0;
}

// dst (dh, dw, 3) = cv2.warpPerspective(src, M (3x3 row-major, forward), (dw, dh),
// borderValue=(border,) * 3). Returns 0, or -1 for a singular M (dst untouched).
int warp_perspective_u8(const uint8_t* src, int sh, int sw, uint8_t* dst, int dh, int dw, const double* M,
                        int border) {
    float m[9];
    if (!invert_perspective(M, m)) return -1;
    perspective_rows(src, sh, sw, dst, dh, dw, m, static_cast<uint8_t>(border));
    return 0;
}

// cv2.cvtColor(BGR2HSV) of n 3-channel pixels. Returns 0.
int bgr_to_hsv_u8(const uint8_t* src, uint8_t* dst, int64_t n) {
    for (int64_t i = 0; i < n; i++) bgr_to_hsv_px(src + i * 3, dst + i * 3);
    return 0;
}

// cv2.cvtColor(HSV2BGR) of rows x width 3-channel pixels. Returns 0.
int hsv_to_bgr_u8(const uint8_t* src, uint8_t* dst, int rows, int width) {
    hsv_rows(src, dst, rows, width, nullptr, false);
    return 0;
}

// In place on rows x width BGR pixels: HSV, each channel through its 256-entry
// table (lut: hue, saturation, value), and back: augment_hsv's cv2 steps.
int augment_hsv_u8(uint8_t* img, int rows, int width, const uint8_t* lut) {
    hsv_rows(img, img, rows, width, lut, true);
    return 0;
}

}  // extern "C"
