/* COCO run-length mask codec — native replacement for pycocotools' C core
 * (the reference depends on pycocotools for RLE decode during raw ingest,
 * reference data/blender.py:65-85). Built as a shared library under
 * build/native/ and loaded via ctypes (dropclip_tpu_torch/native/__init__.py,
 * used by dropclip_tpu_torch/data/rle.py); the pure-numpy codec there
 * implements the same format.
 *
 * Format: base-48 chars, 5 value bits + continuation bit per char, sign
 * extension on the last chunk, delta from counts[i-2] for i > 2;
 * column-major runs alternating 0/1.
 */

#include <stddef.h>
#include <stdint.h>
#include <string.h>

/* Decode the compressed counts string directly into an h*w column-major
 * mask buffer. Returns the number of runs parsed, or -1 on overflow. */
int rle_decode(const char *s, long slen, uint8_t *mask, long h, long w) {
    long total = h * w;
    long pos = 0;
    uint8_t val = 0;
    long i = 0;
    long prev2 = 0, prev1 = 0; /* counts[i-2], counts[i-1] */
    long n_runs = 0;

    memset(mask, 0, (size_t)total);
    while (i < slen) {
        long x = 0;
        int k = 0;
        int more = 1;
        while (more) {
            if (i >= slen) return -1;
            long c = (long)s[i] - 48;
            x |= (c & 0x1f) << (5 * k);
            more = (int)(c & 0x20);
            i++;
            k++;
            if (!more && (c & 0x10)) x |= -1L << (5 * k);
        }
        if (n_runs > 2) x += prev2;
        prev2 = prev1;
        prev1 = x;
        n_runs++;

        if (x < 0 || pos + x > total) return -1;
        if (val) memset(mask + pos, 1, (size_t)x);
        pos += x;
        val = (uint8_t)(1 - val);
    }
    return (int)n_runs;
}

/* Encode a column-major h*w binary mask into the compressed string.
 * Returns the encoded length, or -1 if out_cap is too small. */
long rle_encode(const uint8_t *mask, long h, long w, char *out, long out_cap) {
    long total = h * w;
    long counts_cap = total + 2;
    long n = 0;
    long i = 0;
    long run;
    long icnt;
    long olen = 0;
    /* first run counts zeros (possibly 0-length) */
    uint8_t val = 0;

    /* stream runs without materializing the counts array: we need
     * counts[i-2] for the delta, so keep a 2-slot history */
    long hist[2] = {0, 0};

    (void)counts_cap;
    for (icnt = 0; i < total; icnt++) {
        run = 0;
        while (i < total && mask[i] == val) {
            run++;
            i++;
        }
        /* delta encoding from counts[i-2] for i > 2 */
        long x = run;
        if (icnt > 2) x -= hist[0];
        hist[0] = hist[1];
        hist[1] = run;
        n++;

        int more = 1;
        while (more) {
            long c = x & 0x1f;
            x >>= 5;
            more = (c & 0x10) ? (x != -1) : (x != 0);
            if (more) c |= 0x20;
            if (olen >= out_cap) return -1;
            out[olen++] = (char)(c + 48);
        }
        val = (uint8_t)(1 - val);
    }
    (void)n;
    return olen;
}
