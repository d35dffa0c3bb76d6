// Baseline JPEG encoding on the host: the entropy-coded scan of one frame,
// behind a plain C interface for ctypes.
//
// The JAX package writes predict's annotated images and crops, and the BYTES
// wire's frames, with cv2.imwrite / cv2.imencode (libjpeg-turbo); the port
// must write the same bytes. This file is written from ITU T.81 and from the
// integer arithmetic libjpeg documents; data/jpeg.py writes the markers and
// the quality-scaled tables and calls
//
//   jpeg_encode  one (H, W, 3) BGR or (H, W) gray uint8 frame -> the bytes
//                of its one interleaved scan:
//                - BGR -> YCbCr with libjpeg's 16-bit fixed-point tables;
//                - the luma plane, and a gray frame, edge-replicated to whole
//                  blocks;
//                - chroma (4:2:0) from the full-resolution planes replicated
//                  right to whole MCUs and down to an even row count,
//                  averaged over 2 x 2 with the biases 1, 2, 1, 2, ... along
//                  each row (libjpeg's h2v2_downsample), then replicated down
//                  to whole MCUs;
//                - the ISLOW forward DCT (CONST_BITS 13, PASS1_BITS 2);
//                - quantisation by libjpeg-turbo's reciprocal, correction and
//                  shift for divisors of 16-bit DCT elements (the SIMD
//                  build's: ((|x| + c) * r) >> s, sign restored);
//                - luma blocks of an MCU that lie past the frame's last block
//                  column or row: libjpeg's dummy blocks, zero but for a DC
//                  copied from the block before them;
//                - Huffman coding with the tables given, DC predicted per
//                  component, 0xFF stuffed with 0x00, the last byte padded
//                  with 1 bits.
//
// Returns 0 and the byte count in *written, -1 when `capacity` is too small,
// -2 for bad arguments or a symbol missing from a table. Nothing here keeps
// state between calls, so calls from several threads run in parallel
// (ctypes releases the GIL).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// zigzag index -> natural (row-major) index
const int kNatural[64] = {0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33, 40, 48,
                          41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23,
                          30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

struct HuffEnc {
    uint32_t code[256];
    uint8_t size[256];  // 0: the symbol has no code
};

// Figure C.1 and C.2: code lengths and codes from the 16 counts, indexed by symbol.
bool build_enc(const uint8_t* table, HuffEnc* e) {
    const uint8_t* bits = table + 1;
    const uint8_t* vals = table + 17;
    int huffsize[257];
    uint32_t huffcode[257];
    int p = 0;
    for (int l = 1; l <= 16; l++) {
        int n = bits[l - 1];
        if (p + n > 256) return false;
        while (n--) huffsize[p++] = l;
    }
    huffsize[p] = 0;
    const int nsym = p;
    uint32_t code = 0;
    int si = huffsize[0];
    p = 0;
    while (huffsize[p]) {
        while (huffsize[p] == si) {
            huffcode[p++] = code;
            code++;
        }
        if (code >= (1u << si)) return false;
        code <<= 1;
        si++;
    }
    std::memset(e->size, 0, sizeof(e->size));
    for (p = 0; p < nsym; p++) {
        e->code[vals[p]] = huffcode[p];
        e->size[vals[p]] = static_cast<uint8_t>(huffsize[p]);
    }
    return true;
}

// The entropy-coded bytes: bits gathered MSB first in a 64-bit word and
// written 32 at a time, a 0xFF byte followed by a stuffed 0x00.
struct Writer {
    uint8_t* out;
    int64_t cap, pos = 0;
    uint64_t buf = 0;
    int nbits = 0;  // bits in buf not yet written, right-aligned
    bool full = false;

    inline void byte(uint8_t b) {
        out[pos++] = b;
        if (b == 0xFF) out[pos++] = 0;
    }
    inline void put(uint32_t v, int n) {  // v < 2^n, n <= 32
        buf = (buf << n) | v;
        nbits += n;
        if (nbits >= 32) {
            nbits -= 32;
            const uint32_t w = static_cast<uint32_t>(buf >> nbits);
            if (pos + 8 > cap) {
                full = true;
                pos = 0;  // keep writing in bounds; the caller sees `full`
            }
            if (!((~w - 0x01010101u) & w & 0x80808080u)) {  // no 0xFF byte (no zero byte in ~w): four at once
                out[pos] = static_cast<uint8_t>(w >> 24);
                out[pos + 1] = static_cast<uint8_t>(w >> 16);
                out[pos + 2] = static_cast<uint8_t>(w >> 8);
                out[pos + 3] = static_cast<uint8_t>(w);
                pos += 4;
            } else {
                for (int k = 24; k >= 0; k -= 8) byte(static_cast<uint8_t>(w >> k));
            }
        }
    }
    void flush() {  // the whole bytes left, then the last bits padded with 1s
        if (pos + 16 > cap) {
            full = true;
            pos = 0;
        }
        while (nbits >= 8) {
            nbits -= 8;
            byte(static_cast<uint8_t>(buf >> nbits));
        }
        if (nbits) byte(static_cast<uint8_t>((buf << (8 - nbits)) | (0xFF >> nbits)));
        nbits = 0;
    }
};

// jfdctint.c jpeg_fdct_islow on one block of centred samples, in place.
constexpr int CONST_BITS = 13, PASS1_BITS = 2;
inline int32_t descale(int32_t x, int n) { return (x + (1 << (n - 1))) >> n; }

// One 1-D pass over 8 values at p[0], p[step], ..., p[7 * step].
template <int step, bool second>
inline void fdct_1d(int32_t* p) {
    constexpr int shift = second ? CONST_BITS + PASS1_BITS : CONST_BITS - PASS1_BITS;
    int32_t tmp0 = p[0] + p[7 * step], tmp7 = p[0] - p[7 * step];
    int32_t tmp1 = p[step] + p[6 * step], tmp6 = p[step] - p[6 * step];
    int32_t tmp2 = p[2 * step] + p[5 * step], tmp5 = p[2 * step] - p[5 * step];
    int32_t tmp3 = p[3 * step] + p[4 * step], tmp4 = p[3 * step] - p[4 * step];
    int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    if (second) {
        p[0] = descale(tmp10 + tmp11, PASS1_BITS);
        p[4 * step] = descale(tmp10 - tmp11, PASS1_BITS);
    } else {
        p[0] = (tmp10 + tmp11) * (1 << PASS1_BITS);
        p[4 * step] = (tmp10 - tmp11) * (1 << PASS1_BITS);
    }
    int32_t z1 = (tmp12 + tmp13) * 4433;
    p[2 * step] = descale(z1 + tmp13 * 6270, shift);
    p[6 * step] = descale(z1 - tmp12 * 15137, shift);
    z1 = tmp4 + tmp7;
    int32_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    int32_t z5 = (z3 + z4) * 9633;
    tmp4 *= 2446;
    tmp5 *= 16819;
    tmp6 *= 25172;
    tmp7 *= 12299;
    z1 *= -7373;
    z2 *= -20995;
    z3 = z3 * -16069 + z5;
    z4 = z4 * -3196 + z5;
    p[7 * step] = descale(tmp4 + z1 + z3, shift);
    p[5 * step] = descale(tmp5 + z2 + z4, shift);
    p[3 * step] = descale(tmp6 + z2 + z3, shift);
    p[step] = descale(tmp7 + z1 + z4, shift);
}

void fdct_islow(int32_t* d) {
    for (int k = 0; k < 8; k++) fdct_1d<1, false>(d + 8 * k);  // rows
    for (int k = 0; k < 8; k++) fdct_1d<8, true>(d + k);  // columns
}

// jcdctmgr.c compute_reciprocal for 16-bit DCT elements: x / divisor rounded
// as ((x + corr) * recip) >> shift on |x|.
struct Divisor {
    uint32_t recip, corr;
    int shift;
};

struct Quant {  // a table's 64 divisors, by field
    uint32_t recip[64], corr[64], shift[64];
};

Divisor reciprocal(uint32_t divisor) {
    int b = 31 - __builtin_clz(divisor);  // flss(divisor) - 1
    int r = 16 + b;
    uint32_t fq = (1u << r) / divisor, fr = (1u << r) % divisor, c = divisor / 2;
    if (fr == 0) {  // a power of two
        fq >>= 1;
        r--;
    } else if (fr <= divisor / 2) {
        c++;
    } else {
        fq++;
    }
    return {fq, c, r};
}

// One block of a plane (row stride `stride`) -> quantised coefficients in natural order. Built twice,
// for AVX2 and for any x86-64, the loader picking the one the CPU runs (the arithmetic is the same).
__attribute__((target_clones("avx2", "default"))) void dct_block(const uint8_t* plane, int64_t stride, const Quant& qt, int16_t* coef) {
    int32_t w[64];
    for (int y = 0; y < 8; y++)
        for (int x = 0; x < 8; x++) w[y * 8 + x] = static_cast<int32_t>(plane[y * stride + x]) - 128;
    fdct_islow(w);
    for (int i = 0; i < 64; i++) {
        const int32_t v = w[i];  // within the 16 bits of libjpeg-turbo's SIMD DCT elements
        const uint32_t a = static_cast<uint32_t>(v < 0 ? -v : v);
        const int32_t q = static_cast<int32_t>(((a + qt.corr[i]) * qt.recip[i]) >> qt.shift[i]);
        coef[i] = static_cast<int16_t>(v < 0 ? -q : q);
    }
}

inline int bit_length(uint32_t v) { return v ? 32 - __builtin_clz(v) : 0; }

// jchuff.c encode_one_block: the DC difference, then the AC run/size
// symbols over the nonzero coefficients in zigzag order, ZRL for each 16
// zeros before a nonzero one, EOB when zeros end the block. Each symbol's
// code and its value bits go out in one put.
bool encode_block(Writer& out, const int16_t* blk, int& last_dc, const HuffEnc& dc, const HuffEnc& ac) {
    Writer w = out;  // a local copy the compiler keeps in registers: stores through w.out cannot alias it
    int32_t zz[64];
    uint64_t nonzero = 0;
    for (int k = 1; k < 64; k++) {
        zz[k] = blk[kNatural[k]];
        nonzero |= static_cast<uint64_t>(zz[k] != 0) << k;
    }
    int t = blk[0] - last_dc;
    last_dc = blk[0];
    int nbits = bit_length(static_cast<uint32_t>(t < 0 ? -t : t));
    if (!dc.size[nbits]) return false;
    uint32_t bits = nbits ? static_cast<uint32_t>(t < 0 ? t - 1 : t) & ((1u << nbits) - 1) : 0;
    w.put((dc.code[nbits] << nbits) | bits, dc.size[nbits] + nbits);
    int k = 0;  // the last coefficient written
    while (nonzero) {
        const int next = __builtin_ctzll(nonzero);
        nonzero &= nonzero - 1;
        int run = next - k - 1;
        while (run > 15) {
            if (!ac.size[0xF0]) return false;
            w.put(ac.code[0xF0], ac.size[0xF0]);
            run -= 16;
        }
        const int v = zz[next];
        nbits = bit_length(static_cast<uint32_t>(v < 0 ? -v : v));
        const int sym = (run << 4) + nbits;
        if (!ac.size[sym]) return false;
        bits = static_cast<uint32_t>(v < 0 ? v - 1 : v) & ((1u << nbits) - 1);
        w.put((ac.code[sym] << nbits) | bits, ac.size[sym] + nbits);
        k = next;
    }
    if (k < 63) {
        if (!ac.size[0]) return false;
        w.put(ac.code[0], ac.size[0]);
    }
    out = w;
    return true;
}

// jccolor.c rgb_ycc_convert on n BGR pixels, in libjpeg's 16-bit fixed point.
__attribute__((target_clones("avx2", "default"))) void bgr_to_ycc(const uint8_t* bgr, int64_t n, uint8_t* y,
                                                                   uint8_t* cb, uint8_t* cr) {
    for (int64_t i = 0; i < n; i++) {
        const int32_t b = bgr[3 * i], g = bgr[3 * i + 1], r = bgr[3 * i + 2];
        y[i] = static_cast<uint8_t>((19595 * r + 38470 * g + 7471 * b + 32768) >> 16);
        cb[i] = static_cast<uint8_t>((-11059 * r - 21709 * g + 32768 * b + (128 << 16) + 32767) >> 16);
        cr[i] = static_cast<uint8_t>((32768 * r - 27439 * g - 5329 * b + (128 << 16) + 32767) >> 16);
    }
}

// jcsample.c h2v2_downsample of one output row from input rows r0 and r1:
// 2 x 2 sums with the biases 1, 2, 1, 2, ... along the row.
__attribute__((target_clones("avx2", "default"))) void h2v2_row(const uint8_t* r0, const uint8_t* r1, uint8_t* out,
                                                                 int cols) {
    for (int x = 0; x < cols; x++)
        out[x] = static_cast<uint8_t>((r0[2 * x] + r0[2 * x + 1] + r1[2 * x] + r1[2 * x + 1] + 1 + (x & 1)) >> 2);
}

// rows x cols plane from src (rows_in x cols_in valid), replicating the last column and row.
void replicate(const uint8_t* src, int rows_in, int cols_in, int64_t src_stride, uint8_t* dst, int rows, int cols) {
    for (int y = 0; y < rows; y++) {
        const uint8_t* s = src + static_cast<int64_t>(y < rows_in ? y : rows_in - 1) * src_stride;
        uint8_t* d = dst + static_cast<int64_t>(y) * cols;
        std::memcpy(d, s, cols_in);
        std::memset(d + cols_in, s[cols_in - 1], cols - cols_in);
    }
}

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

}  // namespace

extern "C" {

// Encode one frame's scan. img: height x width x channels uint8, rows
// contiguous, BGR for 3 channels, gray for 1. quant: 2 x 64 quantisation
// values in natural order (luma, chroma). huff: 4 tables of 273 bytes (a
// flag, the 16 code counts, 256 symbols): DC 0, AC 0, DC 1, AC 1. The scan's
// bytes go to out (capacity bytes), their count to *written.
int jpeg_encode(const uint8_t* img, int height, int width, int channels, const uint16_t* quant,
                const uint8_t* huff, uint8_t* out, int64_t capacity, int64_t* written) {
    if (height < 1 || width < 1 || (channels != 1 && channels != 3)) return -2;
    HuffEnc tables[4];
    for (int i = 0; i < 4; i++)
        if (!build_enc(huff + 273 * i, &tables[i])) return -2;
    Quant div[2];
    for (int t = 0; t < 2; t++)
        for (int i = 0; i < 64; i++) {
            if (quant[t * 64 + i] < 1) return -2;
            const Divisor d = reciprocal(static_cast<uint32_t>(quant[t * 64 + i]) << 3);
            div[t].recip[i] = d.recip;
            div[t].corr[i] = d.corr;
            div[t].shift[i] = static_cast<uint32_t>(d.shift);
        }
    Writer w{out, capacity};
    int16_t coef[64];

    if (channels == 1) {
        const int bw = cdiv(width, 8), bh = cdiv(height, 8);
        std::vector<uint8_t> y(static_cast<size_t>(bw) * 8 * bh * 8);
        replicate(img, height, width, width, y.data(), bh * 8, bw * 8);
        int last = 0;
        for (int by = 0; by < bh; by++)
            for (int bx = 0; bx < bw; bx++) {
                dct_block(y.data() + static_cast<int64_t>(by) * 8 * bw * 8 + bx * 8, bw * 8, div[0], coef);
                if (!encode_block(w, coef, last, tables[0], tables[1])) return -2;
            }
    } else {
        const int64_t n = static_cast<int64_t>(height) * width;
        std::vector<uint8_t> plane[3];
        for (auto& p : plane) p.resize(n);
        bgr_to_ycc(img, n, plane[0].data(), plane[1].data(), plane[2].data());
        const int mx = cdiv(width, 16), my = cdiv(height, 16);  // MCUs of 16 x 16 pixels
        const int lbw = cdiv(width, 8), lbh = cdiv(height, 8);  // the luma blocks that are not dummies
        const int lw = lbw * 8;
        std::vector<uint8_t> luma(static_cast<size_t>(lw) * lbh * 8);
        replicate(plane[0].data(), height, width, width, luma.data(), lbh * 8, lw);
        // chroma: replicate to 16 * mx columns and an even row count, then 2 x 2 averages, then down to 8 * my rows
        const int cw = mx * 8, ch = my * 8, crows = cdiv(height, 2);
        std::vector<uint8_t> wide(static_cast<size_t>(mx) * 16 * crows * 2), chroma[2];
        for (int c = 0; c < 2; c++) {
            replicate(plane[1 + c].data(), height, width, width, wide.data(), crows * 2, mx * 16);
            std::vector<uint8_t> small(static_cast<size_t>(cw) * crows);
            for (int y = 0; y < crows; y++) {
                const uint8_t* r0 = wide.data() + static_cast<int64_t>(2 * y) * mx * 16;
                h2v2_row(r0, r0 + mx * 16, small.data() + static_cast<int64_t>(y) * cw, cw);
            }
            chroma[c].resize(static_cast<size_t>(cw) * ch);
            replicate(small.data(), crows, cw, cw, chroma[c].data(), ch, cw);
        }
        int last[3] = {0, 0, 0};
        int16_t ymcu[4][64];
        for (int my_i = 0; my_i < my; my_i++)
            for (int mx_i = 0; mx_i < mx; mx_i++) {
                for (int k = 0; k < 4; k++) {
                    const int by = 2 * my_i + k / 2, bx = 2 * mx_i + k % 2;
                    if (by >= lbh) {  // a row of dummy blocks: the DC of the block before the row
                        std::memset(ymcu[k], 0, sizeof(ymcu[k]));
                        ymcu[k][0] = ymcu[1][0];
                    } else if (bx >= lbw) {  // a dummy block at the right: the DC of its left neighbour
                        std::memset(ymcu[k], 0, sizeof(ymcu[k]));
                        ymcu[k][0] = ymcu[k - 1][0];
                    } else {
                        dct_block(luma.data() + static_cast<int64_t>(by) * 8 * lw + bx * 8, lw, div[0], ymcu[k]);
                    }
                }
                for (int k = 0; k < 4; k++)
                    if (!encode_block(w, ymcu[k], last[0], tables[0], tables[1])) return -2;
                for (int c = 0; c < 2; c++) {
                    dct_block(chroma[c].data() + static_cast<int64_t>(my_i) * 8 * cw + mx_i * 8, cw, div[1], coef);
                    if (!encode_block(w, coef, last[1 + c], tables[2], tables[3])) return -2;
                }
            }
    }
    w.flush();
    if (w.full) return -1;
    *written = w.pos;
    return 0;
}

}  // extern "C"
