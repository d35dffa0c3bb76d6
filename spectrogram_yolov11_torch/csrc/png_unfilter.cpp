// PNG row filters undone on the host (RFC 2083 §6), behind a plain C
// interface for ctypes: the rows data/imageio.py cannot undo with whole-row
// numpy operations. Average (3) and Paeth (4) predict each byte from the
// decoded byte bpp to its left, so a row is a chain of dependent bytes; here
// that chain is a C loop instead of the Python loop that stays in
// data/imageio.py as the plain version (_unfilter_loop).

#include <cstdint>
#include <cstdlib>

extern "C" {

// Undo filter `ftype` (3 Average or 4 Paeth) of one row of n bytes, bpp bytes
// per pixel, given the decoded row above (`prior`, zeros for the first row).
// Returns 0, or -1 for another filter type or a bpp outside 1..8.
int png_unfilter_row(int ftype, const uint8_t* row, const uint8_t* prior, uint8_t* out, int64_t n, int bpp) {
    if (bpp < 1 || bpp > 8) return -1;
    if (ftype == 3) {
        for (int64_t i = 0; i < n; i++) {
            int left = i >= bpp ? out[i - bpp] : 0;
            out[i] = static_cast<uint8_t>(row[i] + ((left + prior[i]) >> 1));
        }
        return 0;
    }
    if (ftype == 4) {
        for (int64_t i = 0; i < n; i++) {
            int a = 0, c = 0;
            if (i >= bpp) {
                a = out[i - bpp];
                c = prior[i - bpp];
            }
            const int b = prior[i];
            const int pa = std::abs(b - c), pb = std::abs(a - c), pc = std::abs(a + b - 2 * c);
            const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
            out[i] = static_cast<uint8_t>(row[i] + pred);
        }
        return 0;
    }
    return -1;
}

}  // extern "C"
