/* PNG scanline reconstruction for the two filter types whose bytes depend
 * on the bytes reconstructed just before them in the same row: Average (3)
 * and Paeth (4) (PNG specification, section 9). Host code: built with the
 * host C compiler by mv3d_tpu_torch/utils/png.py and called through ctypes;
 * utils/png.py holds the numpy twin that the tests compare it with.
 *
 * cur: the row's n filtered bytes, reconstructed in place; prev: the row
 * above, already reconstructed (zeros for the first row); bpp: bytes per
 * pixel. Returns 0, or -1 for another filter type. */
#include <stddef.h>
#include <stdint.h>

int mv3d_png_unfilter_row(int ftype, uint8_t *cur, const uint8_t *prev,
                          size_t n, size_t bpp) {
  size_t i;
  if (ftype == 3) {
    for (i = 0; i < bpp && i < n; ++i)
      cur[i] = (uint8_t)(cur[i] + (prev[i] >> 1));
    for (; i < n; ++i)
      cur[i] = (uint8_t)(cur[i] + ((cur[i - bpp] + prev[i]) >> 1));
    return 0;
  }
  if (ftype == 4) {
    for (i = 0; i < bpp && i < n; ++i)
      cur[i] = (uint8_t)(cur[i] + prev[i]);   /* a = c = 0: predicts b */
    for (; i < n; ++i) {
      int a = cur[i - bpp], b = prev[i], c = prev[i - bpp];
      int p = a + b - c;
      int pa = p > a ? p - a : a - p;
      int pb = p > b ? p - b : b - p;
      int pc = p > c ? p - c : c - p;
      int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
      cur[i] = (uint8_t)(cur[i] + pred);
    }
    return 0;
  }
  return -1;
}
