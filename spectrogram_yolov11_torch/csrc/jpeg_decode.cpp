// Baseline JPEG decoding on the host: the entropy-coded scans and the
// reconstruction of a frame, behind a plain C interface for ctypes.
//
// The port reads the JPEG files that the JAX package writes and reads with
// cv2 (cv2.imwrite / cv2.imread, libjpeg-turbo), and must give the image
// cv2.imread(path, IMREAD_COLOR) gives, byte for byte. This file is written
// from ITU T.81 and from the integer arithmetic libjpeg documents; the
// markers are parsed in Python (data/jpeg.py), which calls
//
//   jpeg_scan    one scan's entropy-coded segment -> quantised coefficients
//                (Huffman decode with 0xFF00 stuffing, DC prediction, RSTn
//                with the DRI interval resetting the predictors; where the
//                data ends early or a marker interrupts it, zero bits and
//                then zero blocks for the rest of the restart interval, as
//                libjpeg's entropy decoder does, and libjpeg's resync rules
//                for a restart marker out of order)
//   jpeg_render  coefficients -> BGR: dequantisation, the ISLOW integer IDCT
//                (CONST_BITS 13, PASS1_BITS 2, in the 16-bit lanes of
//                libjpeg-turbo's SIMD version), "fancy" (triangle) chroma
//                upsampling with its alternating rounding biases and
//                replicated edges (box upsampling for 4:1:1 and for chroma 2
//                samples wide or less), YCbCr -> BGR with 16-bit fixed-point
//                tables, gray replicated over three channels, the MCU
//                padding cropped.
//
// Both return 0, or a negative code that data/jpeg.py turns into ValueError
// (an input libjpeg refuses: cv2.imread returns None for it). Nothing here
// allocates memory the caller sees or keeps state between calls, so calls
// from several threads run in parallel (ctypes releases the GIL).

#include <climits>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

enum Err { OK = 0, ERR_HUFF_TABLE = -1, ERR_NO_HUFF_TABLE = -2, ERR_DC_OVERFLOW = -3, ERR_ARGS = -4 };

// zigzag index -> natural (row-major) index; 16 extra entries absorb a run
// that overshoots the block in corrupt data, as libjpeg's table does
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33, 40, 48,
    41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23,
    30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63, 63, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

constexpr int LOOKAHEAD = 9;

struct Huff {
    int32_t maxcode[18];
    int32_t valoffset[18];
    uint8_t vals[256];
    uint16_t lut[1 << LOOKAHEAD];  // (code length << 8) | symbol; 0 where the code is longer
};

// Figure C.1, C.2 and F.15, with libjpeg's checks: at most 256 symbols, every
// code fits its length (no all-ones code), DC symbols 0..15.
int build_huff(const uint8_t* bits, const uint8_t* vals, bool dc, Huff* t) {
    int huffsize[257], huffcode[257];
    int p = 0;
    for (int l = 1; l <= 16; l++) {
        int n = bits[l - 1];
        if (p + n > 256) return ERR_HUFF_TABLE;
        while (n--) huffsize[p++] = l;
    }
    huffsize[p] = 0;
    const int nsym = p;
    int code = 0, si = huffsize[0];
    p = 0;
    while (huffsize[p]) {
        while (huffsize[p] == si) {
            huffcode[p++] = code;
            code++;
        }
        if (code >= (1 << si)) return ERR_HUFF_TABLE;
        code <<= 1;
        si++;
    }
    p = 0;
    for (int l = 1; l <= 16; l++) {
        if (bits[l - 1]) {
            t->valoffset[l] = p - huffcode[p];
            p += bits[l - 1];
            t->maxcode[l] = huffcode[p - 1];
        } else {
            t->maxcode[l] = -1;
        }
    }
    t->valoffset[17] = 0;
    t->maxcode[17] = 0xFFFFF;
    std::memcpy(t->vals, vals, 256);
    std::memset(t->lut, 0, sizeof(t->lut));
    p = 0;
    for (int l = 1; l <= LOOKAHEAD; l++) {
        for (int i = 1; i <= bits[l - 1]; i++, p++) {
            int base = huffcode[p] << (LOOKAHEAD - l);
            for (int c = 0; c < (1 << (LOOKAHEAD - l)); c++)
                t->lut[base + c] = static_cast<uint16_t>((l << 8) | vals[p]);
        }
    }
    if (dc)
        for (int i = 0; i < nsym; i++)
            if (vals[i] > 15) return ERR_HUFF_TABLE;
    return OK;
}

// The entropy-coded bytes as libjpeg's stdio source and bit reader see them:
// 0xFF00 is a 0xFF data byte, other 0xFFxx stops the bits and is left unread,
// and past the end of the file the source supplies a fake EOI (FF D9 ...).
// Bits asked for past a marker are zeros, and mark the segment as out of
// data (libjpeg's insufficient_data).
struct Reader {
    const uint8_t* d;
    int64_t len, pos;
    uint64_t buf = 0;
    int nbits = 0;  // real bits in buf, right-aligned
    int marker = 0;  // unread marker code, 0 for none
    int64_t marker_pos = -1;  // its first 0xFF
    bool insufficient = false;

    int byte() {
        int64_t p = pos++;
        if (p < len) return d[p];
        return ((p - len) & 1) ? 0xD9 : 0xFF;
    }

    void fill() {
        while (nbits <= 56 && !marker) {
            int64_t p0 = pos;
            int c = byte();
            if (c == 0xFF) {
                do c = byte(); while (c == 0xFF);
                if (c != 0) {
                    marker = c;
                    marker_pos = p0;
                    return;
                }
                c = 0xFF;
            }
            buf = (buf << 8) | static_cast<uint64_t>(c);
            nbits += 8;
        }
    }

    inline void skip(int n) {
        if (n > nbits) {
            insufficient = true;
            nbits = 0;
        } else {
            nbits -= n;
        }
    }

    // jdmarker.c next_marker: skip to the next 0xFF that starts a marker
    void next_marker() {
        for (;;) {
            int64_t p0 = pos;
            int c = byte();
            while (c != 0xFF) {
                p0 = pos;
                c = byte();
            }
            do c = byte(); while (c == 0xFF);
            if (c != 0) {
                marker = c;
                marker_pos = p0;
                return;
            }
        }
    }

    // jdmarker.c jpeg_resync_to_restart, for a marker that is not the RSTn expected
    void resync(int desired) {
        for (;;) {
            int m = marker, action;
            if (m < 0xC0) {
                action = 2;
            } else if (m < 0xD0 || m > 0xD7) {
                action = 3;
            } else if (m == 0xD0 + ((desired + 1) & 7) || m == 0xD0 + ((desired + 2) & 7)) {
                action = 3;
            } else if (m == 0xD0 + ((desired - 1) & 7) || m == 0xD0 + ((desired - 2) & 7)) {
                action = 2;
            } else {
                action = 1;
            }
            if (action == 1) {
                marker = 0;
                return;
            }
            if (action == 3) return;
            next_marker();
        }
    }
};

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

// One Huffman symbol and its s = symbol & 15 value bits (the DC difference's
// size, or an AC coefficient's), taken from one look at 32 bits of the
// buffer: returns the symbol, *value the extended value (0 for s = 0). A code
// longer than 16 bits is what libjpeg calls a bad code: it reads 17 bits and
// takes symbol 0.
inline int decode(Reader& r, const Huff& t, int* value) {
    if (r.nbits < 32) r.fill();
    const uint32_t w = r.nbits >= 32 ? static_cast<uint32_t>(r.buf >> (r.nbits - 32))
                                     : static_cast<uint32_t>(r.buf << (32 - r.nbits));
    const uint16_t e = t.lut[w >> (32 - LOOKAHEAD)];
    int l = 17, sym = 0;
    if (e) {
        l = e >> 8;
        sym = e & 0xFF;
    } else {
        for (int n = LOOKAHEAD + 1; n <= 16; n++) {
            const int32_t c = static_cast<int32_t>(w >> (32 - n));
            if (c <= t.maxcode[n]) {
                l = n;
                sym = t.vals[(c + t.valoffset[n]) & 0xFF];
                break;
            }
        }
    }
    const int s = sym & 15;
    *value = s ? extend(static_cast<int>((w >> (32 - l - s)) & ((1u << s) - 1)), s) : 0;
    r.skip(l + s);
    return sym;
}

// libjpeg's ISLOW inverse DCT (jidctint.c: CONST_BITS 13, PASS1_BITS 2) as
// libjpeg-turbo's x86-64 SIMD version computes it, which is what cv2 runs on
// x86-64 (its build has SIMD on): the same products and sums, in 16-bit lanes
// where jidctint.c has ints. Dequantisation keeps the low 16 bits of the
// product (pmullw); in0 +- in4, in7 + in3 and in5 + in1 wrap to 16 bits
// (paddw); the products are summed in 32 bits (pmaddwd, paddd); each pass
// descales and saturates to 16 bits (packssdw), and the output saturates to
// -128..127 (packsswb) before the +128 level shift. jidctint.c's C path
// gives the same bytes wherever nothing leaves 16 bits, which holds for
// every file an encoder writes; where corrupt data push a coefficient past
// it, the C path's range-limit table (indexed with & 0x3FF) wraps where the
// SIMD path saturates, and cv2.imread shows the SIMD path.
constexpr int CONST_BITS = 13, PASS1_BITS = 2;
constexpr int32_t F054 = 4433, F130 = 4433 + 6270, F054_MF184 = 4433 - 15137, F117 = 9633,
                  F117_MF196 = 9633 - 16069, F117_MF039 = 9633 - 3196, F029_MF089 = 2446 - 7373, MF089 = -7373,
                  F150_MF089 = 12299 - 7373, F205_MF256 = 16819 - 20995, MF256 = -20995, F307_MF256 = 25172 - 20995;

inline int16_t w16(int32_t x) { return static_cast<int16_t>(static_cast<uint16_t>(static_cast<uint32_t>(x))); }
inline int32_t add32(int32_t a, int32_t b) {
    return static_cast<int32_t>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}
inline int32_t sub32(int32_t a, int32_t b) {
    return static_cast<int32_t>(static_cast<uint32_t>(a) - static_cast<uint32_t>(b));
}
inline int32_t madd(int16_t a, int32_t ca, int16_t b, int32_t cb) {  // pmaddwd: two 16x16 products summed in 32 bits
    return add32(int32_t(a) * ca, int32_t(b) * cb);
}
inline int16_t sat16(int32_t x) { return static_cast<int16_t>(x < -32768 ? -32768 : (x > 32767 ? 32767 : x)); }

// one 8-point pass over in[0..7] (a column in pass 1, a row in pass 2), descaled by `shift`, saturated to 16 bits
inline void idct_1d(const int16_t* in, int shift, int16_t* out) {
    const int32_t tmp3e = madd(in[2], F130, in[6], F054);
    const int32_t tmp2e = madd(in[2], F054, in[6], F054_MF184);
    const int32_t tmp0e = int32_t(w16(int32_t(in[0]) + in[4])) * (1 << CONST_BITS);
    const int32_t tmp1e = int32_t(w16(int32_t(in[0]) - in[4])) * (1 << CONST_BITS);
    const int32_t tmp10 = add32(tmp0e, tmp3e), tmp13 = sub32(tmp0e, tmp3e);
    const int32_t tmp11 = add32(tmp1e, tmp2e), tmp12 = sub32(tmp1e, tmp2e);
    const int16_t z3w = w16(int32_t(in[7]) + in[3]), z4w = w16(int32_t(in[5]) + in[1]);
    const int32_t z3 = madd(z3w, F117_MF196, z4w, F117), z4 = madd(z3w, F117, z4w, F117_MF039);
    const int32_t tmp0 = add32(madd(in[7], F029_MF089, in[1], MF089), z3);
    const int32_t tmp3 = add32(madd(in[7], MF089, in[1], F150_MF089), z4);
    const int32_t tmp1 = add32(madd(in[5], F205_MF256, in[3], MF256), z4);
    const int32_t tmp2 = add32(madd(in[5], MF256, in[3], F307_MF256), z3);
    const int32_t round = 1 << (shift - 1);
    out[0] = sat16(add32(add32(tmp10, tmp3), round) >> shift);
    out[7] = sat16(add32(sub32(tmp10, tmp3), round) >> shift);
    out[1] = sat16(add32(add32(tmp11, tmp2), round) >> shift);
    out[6] = sat16(add32(sub32(tmp11, tmp2), round) >> shift);
    out[2] = sat16(add32(add32(tmp12, tmp1), round) >> shift);
    out[5] = sat16(add32(sub32(tmp12, tmp1), round) >> shift);
    out[3] = sat16(add32(add32(tmp13, tmp0), round) >> shift);
    out[4] = sat16(add32(sub32(tmp13, tmp0), round) >> shift);
}

void idct_islow(const int16_t* coef, const int16_t* q, uint8_t* out, int stride) {
    int16_t ws[64];  // row-major
    bool ac_zero = true;  // the SIMD pass 1 tests rows 1-7 of the whole block at once
    for (int k = 8; k < 64 && ac_zero; k++) ac_zero = coef[k] == 0;
    if (ac_zero) {
        for (int c = 0; c < 8; c++) {
            const int16_t dc = w16(int32_t(w16(int32_t(coef[c]) * q[c])) * (1 << PASS1_BITS));  // psllw wraps
            for (int r = 0; r < 8; r++) ws[r * 8 + c] = dc;
        }
    } else {
        int16_t col[8], res[8];
        for (int c = 0; c < 8; c++) {
            for (int r = 0; r < 8; r++) col[r] = w16(int32_t(coef[r * 8 + c]) * q[r * 8 + c]);
            idct_1d(col, CONST_BITS - PASS1_BITS, res);
            for (int r = 0; r < 8; r++) ws[r * 8 + c] = res[r];
        }
    }
    int16_t res[8];
    for (int r = 0; r < 8; r++) {
        idct_1d(ws + r * 8, CONST_BITS + PASS1_BITS + 3, res);
        uint8_t* o = out + r * stride;
        for (int k = 0; k < 8; k++) o[k] = static_cast<uint8_t>((res[k] < -128 ? -128 : (res[k] > 127 ? 127 : res[k])) + 128);
    }
}

// One component's samples: the IDCT of its blocks, (bh * 8) x (bw * 8)
struct Plane {
    std::vector<uint8_t> px;
    int stride = 0, dw = 0, dh = 0;  // downsampled width and height: the samples that are not padding
    const uint8_t* row(int y) const { return px.data() + static_cast<size_t>(y) * stride; }
};

// Upsample row y of the full-size frame from plane p (factors hf x vf) into
// out[0 .. >= width), libjpeg-turbo's jdsample.c methods.
void upsample_row(const Plane& p, int hf, int vf, int y, uint8_t* out) {
    const int dw = p.dw;
    if (hf == 1 && vf == 1) {
        std::memcpy(out, p.row(y), dw);
    } else if (hf == 2 && vf == 1) {
        const uint8_t* in = p.row(y);
        if (dw > 2) {  // h2v1 fancy
            out[0] = in[0];
            out[1] = uint8_t((in[0] * 3 + in[1] + 2) >> 2);
            for (int i = 1; i < dw - 1; i++) {
                int v = in[i] * 3;
                out[2 * i] = uint8_t((v + in[i - 1] + 1) >> 2);
                out[2 * i + 1] = uint8_t((v + in[i + 1] + 2) >> 2);
            }
            out[2 * dw - 2] = uint8_t((in[dw - 1] * 3 + in[dw - 2] + 1) >> 2);
            out[2 * dw - 1] = in[dw - 1];
        } else {
            for (int i = 0; i < dw; i++) out[2 * i] = out[2 * i + 1] = in[i];
        }
    } else if (hf == 1 && vf == 2) {  // h1v2 fancy
        int iy = y >> 1;
        const uint8_t* in0 = p.row(iy);
        int bias;
        const uint8_t* in1;
        if ((y & 1) == 0) {
            in1 = p.row(iy > 0 ? iy - 1 : 0);
            bias = 1;
        } else {
            in1 = p.row(iy + 1 < p.dh ? iy + 1 : p.dh - 1);
            bias = 2;
        }
        for (int i = 0; i < dw; i++) out[i] = uint8_t((in0[i] * 3 + in1[i] + bias) >> 2);
    } else if (hf == 2 && vf == 2 && dw > 2) {  // h2v2 fancy
        int iy = y >> 1;
        const uint8_t* in0 = p.row(iy);
        const uint8_t* in1 = (y & 1) == 0 ? p.row(iy > 0 ? iy - 1 : 0) : p.row(iy + 1 < p.dh ? iy + 1 : p.dh - 1);
        int this_sum = in0[0] * 3 + in1[0];
        int next_sum = in0[1] * 3 + in1[1];
        out[0] = uint8_t((this_sum * 4 + 8) >> 4);
        out[1] = uint8_t((this_sum * 3 + next_sum + 7) >> 4);
        int last_sum = this_sum;
        this_sum = next_sum;
        for (int i = 1; i < dw - 1; i++) {
            next_sum = in0[i + 1] * 3 + in1[i + 1];
            out[2 * i] = uint8_t((this_sum * 3 + last_sum + 8) >> 4);
            out[2 * i + 1] = uint8_t((this_sum * 3 + next_sum + 7) >> 4);
            last_sum = this_sum;
            this_sum = next_sum;
        }
        out[2 * dw - 2] = uint8_t((this_sum * 3 + last_sum + 8) >> 4);
        out[2 * dw - 1] = uint8_t((this_sum * 4 + 7) >> 4);
    } else {  // box: h2v2 of a narrow plane, and every other integral factor
        const uint8_t* in = p.row(y / vf);
        for (int i = 0; i < dw; i++)
            for (int k = 0; k < hf; k++) out[i * hf + k] = in[i];
    }
}

struct ColorTables {  // jdcolor.c build_ycc_rgb_table, SCALEBITS 16
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    ColorTables() {
        const int64_t one_half = int64_t(1) << 15;
        auto fix = [](double x) { return static_cast<int64_t>(x * 65536.0 + 0.5); };
        for (int i = 0; i < 256; i++) {
            int64_t x = i - 128;
            cr_r[i] = int((fix(1.40200) * x + one_half) >> 16);
            cb_b[i] = int((fix(1.77200) * x + one_half) >> 16);
            cr_g[i] = -fix(0.71414) * x;
            cb_g[i] = -fix(0.34414) * x + one_half;
        }
    }
};
const ColorTables kColor;

inline uint8_t clamp255(int v) { return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v)); }

}  // namespace

extern "C" {

// Decode one scan. tables: 8 slots of 273 bytes (a defined flag, the 16 code
// counts, 256 symbols), DC tables 0-3 in slots 0-3, AC tables 0-3 in slots
// 4-7. comps: 6 int32 per
// scan component: DC slot, AC slot, h, v (blocks of the component in an MCU;
// 1, 1 for a scan of one component), blocks per row of its coefficient
// buffer, offset of that buffer in `coefs` (in blocks of 64). The scan has
// mcus_x by mcus_y MCUs. The data start at data[start]; out[0] is set to
// where parsing resumes (the 0xFF of the marker that ended the data, or the
// byte after the bits consumed), out[1] to 1 if the data ran out before the
// last MCU.
int jpeg_scan(const uint8_t* data, int64_t len, int64_t start, const uint8_t* tables, const int32_t* comps,
              int ncomps, int mcus_x, int mcus_y, int restart_interval, int16_t* coefs, int64_t* out) {
    if (ncomps < 1 || ncomps > 4 || mcus_x < 1 || mcus_y < 1) return ERR_ARGS;
    Huff tabs[8];  // built once per slot the scan uses
    bool built[8] = {};
    const Huff* dc[4];
    const Huff* ac[4];
    for (int i = 0; i < ncomps; i++) {
        const int32_t* c = comps + 6 * i;
        for (int k = 0; k < 2; k++) {
            const int slot = c[k];
            if (slot < 4 * k || slot > 3 + 4 * k || !tables[273 * slot]) return ERR_NO_HUFF_TABLE;
            if (!built[slot]) {
                const uint8_t* t = tables + 273 * slot;
                const int err = build_huff(t + 1, t + 17, k == 0, &tabs[slot]);
                if (err) return err;
                built[slot] = true;
            }
            (k == 0 ? dc : ac)[i] = &tabs[slot];
        }
    }
    Reader r{data, len, start};
    int last_dc[4] = {0, 0, 0, 0};
    int restarts_to_go = restart_interval, next_rst = 0;
    for (int my = 0; my < mcus_y; my++) {
        for (int mx = 0; mx < mcus_x; mx++) {
            if (restart_interval) {
                if (restarts_to_go == 0) {  // jdhuff.c process_restart
                    r.nbits = 0;
                    if (!r.marker) r.next_marker();
                    if (r.marker == 0xD0 + next_rst) {
                        r.marker = 0;
                    } else {
                        r.resync(next_rst);
                    }
                    next_rst = (next_rst + 1) & 7;
                    for (int i = 0; i < 4; i++) last_dc[i] = 0;
                    restarts_to_go = restart_interval;
                    if (!r.marker) r.insufficient = false;
                }
            }
            if (!r.insufficient) {
                for (int i = 0; i < ncomps; i++) {
                    const int32_t* c = comps + 6 * i;
                    const int h = c[2], v = c[3], stride = c[4];
                    int16_t* base = coefs + static_cast<int64_t>(c[5]) * 64;
                    for (int by = 0; by < v; by++) {
                        for (int bx = 0; bx < h; bx++) {
                            int64_t bidx = static_cast<int64_t>(my * v + by) * stride + (mx * h + bx);
                            int16_t* blk = base + bidx * 64;
                            int s;
                            decode(r, *dc[i], &s);
                            if ((last_dc[i] >= 0 && s > INT_MAX - last_dc[i]) ||
                                (last_dc[i] < 0 && s < INT_MIN - last_dc[i]))
                                return ERR_DC_OVERFLOW;
                            last_dc[i] += s;
                            blk[0] = static_cast<int16_t>(last_dc[i]);
                            for (int k = 1; k < 64; k++) {
                                int value;
                                const int rs = decode(r, *ac[i], &value);
                                const int run = rs >> 4;
                                if (rs & 15) {
                                    k += run;
                                    blk[kNatural[k]] = static_cast<int16_t>(value);
                                } else {
                                    if (run != 15) break;
                                    k += 15;
                                }
                            }
                        }
                    }
                }
            }
            if (restart_interval) restarts_to_go--;
        }
    }
    out[0] = r.marker ? r.marker_pos : r.pos;
    out[1] = r.insufficient ? 1 : 0;
    return OK;
}

// Reconstruct the frame into bgr (height, width, 3). comps: 4 int32 per
// component: h, v (sampling factors), blocks per row of its coefficient
// buffer, its offset in `coefs` (in blocks of 64). quant: one table of 64
// uint16 in natural order per component, as libjpeg latched it (all zero for
// a component no scan reached).
// color: 0 gray, 1 YCbCr, 2 RGB.
int jpeg_render(const int16_t* coefs, const uint16_t* quant, const int32_t* comps, int ncomp, int width,
                int height, int color, uint8_t* bgr) {
    if (ncomp < 1 || ncomp > 4 || (color == 0) != (ncomp == 1) || width < 1 || height < 1) return ERR_ARGS;
    int maxh = 1, maxv = 1;
    for (int i = 0; i < ncomp; i++) {
        maxh = comps[4 * i] > maxh ? comps[4 * i] : maxh;
        maxv = comps[4 * i + 1] > maxv ? comps[4 * i + 1] : maxv;
    }
    std::vector<Plane> planes(ncomp);
    int hf[4], vf[4];
    for (int i = 0; i < ncomp; i++) {
        const int32_t* c = comps + 4 * i;
        const int h = c[0], v = c[1], stride = c[2];
        if (maxh % h || maxv % v) return ERR_ARGS;
        hf[i] = maxh / h;
        vf[i] = maxv / v;
        Plane& p = planes[i];
        p.dw = static_cast<int>((static_cast<int64_t>(width) * h + maxh - 1) / maxh);
        p.dh = static_cast<int>((static_cast<int64_t>(height) * v + maxv - 1) / maxv);
        const int bw = (p.dw + 7) / 8, bh = (p.dh + 7) / 8;
        p.stride = bw * 8;
        p.px.resize(static_cast<size_t>(bh) * 8 * p.stride);
        int16_t q[64];
        for (int k = 0; k < 64; k++) q[k] = static_cast<int16_t>(quant[64 * i + k]);  // ISLOW_MULT_TYPE is short
        const int16_t* base = coefs + static_cast<int64_t>(c[3]) * 64;
        for (int by = 0; by < bh; by++)
            for (int bx = 0; bx < bw; bx++)
                idct_islow(base + (static_cast<int64_t>(by) * stride + bx) * 64, q,
                           p.px.data() + static_cast<size_t>(by) * 8 * p.stride + bx * 8, p.stride);
    }
    // one upsampled row per component, wide enough for the padding of the widest factor
    const int rw = width + 2 * maxh + 8;
    std::vector<uint8_t> rows(static_cast<size_t>(ncomp) * rw);
    for (int y = 0; y < height; y++) {
        uint8_t* o = bgr + static_cast<size_t>(y) * width * 3;
        for (int i = 0; i < ncomp; i++) upsample_row(planes[i], hf[i], vf[i], y, rows.data() + static_cast<size_t>(i) * rw);
        const uint8_t* c0 = rows.data();
        if (color == 0) {
            for (int x = 0; x < width; x++) o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = c0[x];
            continue;
        }
        const uint8_t* c1 = c0 + rw;
        const uint8_t* c2 = c1 + rw;
        if (color == 2) {
            for (int x = 0; x < width; x++) {
                o[3 * x] = c2[x];
                o[3 * x + 1] = c1[x];
                o[3 * x + 2] = c0[x];
            }
            continue;
        }
        for (int x = 0; x < width; x++) {
            const int yy = c0[x], cb = c1[x], cr = c2[x];
            o[3 * x] = clamp255(yy + kColor.cb_b[cb]);
            o[3 * x + 1] = clamp255(yy + static_cast<int>((kColor.cb_g[cb] + kColor.cr_g[cr]) >> 16));
            o[3 * x + 2] = clamp255(yy + kColor.cr_r[cr]);
        }
    }
    return OK;
}

}  // extern "C"
