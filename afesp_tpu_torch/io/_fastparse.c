/* Native whitespace-separated-double parser for the .dat loaders.
 *
 * The port's own copy of afesp_tpu/io/_fastparse.c; the code below is
 * the same, line for line.
 *
 * The reference's data loader is Fortran list-directed READ
 * (integrals.f90:100-161); the interchange files are text tables, up to
 * 481 MB (~23M lines x 5 fields) for a 116-bf eri.dat.  The pure-NumPy
 * path (str.split -> np.array) materialises one Python string object a
 * token.  This single-pass C scanner allocates nothing but the output
 * array.
 *
 * Number grammar: [+-]?digits[.digits][(eEdD)[+-]digits] — covers
 * Fortran-style D exponents too.  The mantissa is accumulated in
 * integer arithmetic (exact to 19 significant digits, more than any
 * writer here emits) and scaled by a binary-exact power-of-ten table,
 * so results match strtod/NumPy bit-for-bit on every committed fixture
 * (asserted in tests/test_torch_io_fastparse.py).
 *
 * Built at first use by afesp_tpu_torch/io/fastparse.py (cc -O2 -shared
 * -fPIC) into afesp_tpu_torch/_build/; loaded via ctypes.
 */

#include <stdint.h>
#include <stddef.h>
#include <stdlib.h>
#include <string.h>

/* Count whitespace-separated tokens in buf[0:len] — a read-only pass at
 * memory bandwidth, so the caller can size the output array exactly
 * (over-allocating by 2-3x costs seconds of fresh-page demand faults on
 * the target microVM). */
long afesp_count_tokens(const char *buf, long len)
{
    long n = 0;
    int in_tok = 0;
    for (long i = 0; i < len; i++) {
        char c = buf[i];
        int ws = (c == ' ' || c == '\t' || c == '\n' || c == '\r' ||
                  c == '\f' || c == '\v');
        if (!ws && !in_tok) {
            n++;
            in_tok = 1;
        } else if (ws) {
            in_tok = 0;
        }
    }
    return n;
}

/* Parse up to `max_out` whitespace-separated doubles from buf[0:len].
 * Returns the number parsed, or -(1 + byte_offset) on malformed input
 * (a token that is not a number). */
long afesp_parse_doubles(const char *buf, long len, double *out, long max_out)
{
    const char *p = buf, *end = buf + len;
    long n = 0;
    while (p < end) {
        /* skip whitespace (space, tab, newline, CR, FF, VT) */
        while (p < end) {
            char c = *p;
            if (c == ' ' || c == '\t' || c == '\n' || c == '\r' ||
                c == '\f' || c == '\v')
                p++;
            else
                break;
        }
        if (p >= end)
            break;
        if (n >= max_out)
            return -(1 + (long)(p - buf));

        const char *tok = p;
        int neg = 0;
        if (*p == '+' || *p == '-') {
            neg = (*p == '-');
            p++;
        }
        const char *mstart = p; /* unsigned part, for the strtod slow path */
        /* mantissa: up to 19 significant digits exactly in uint64 */
        uint64_t mant = 0;
        int ndig = 0;      /* significant digits consumed into mant */
        int exp10 = 0;     /* decimal exponent correction */
        int any = 0;
        while (p < end && *p >= '0' && *p <= '9') {
            any = 1;
            if (ndig < 19) {
                mant = mant * 10u + (uint64_t)(*p - '0');
                ndig++;
            } else {
                exp10++; /* overflow digits shift the scale */
            }
            p++;
        }
        if (p < end && *p == '.') {
            p++;
            while (p < end && *p >= '0' && *p <= '9') {
                any = 1;
                if (ndig < 19) {
                    mant = mant * 10u + (uint64_t)(*p - '0');
                    ndig++;
                    exp10--;
                }
                p++;
            }
        }
        if (!any)
            return -(1 + (long)(tok - buf));
        if (p < end &&
            (*p == 'e' || *p == 'E' || *p == 'd' || *p == 'D')) {
            p++;
            int eneg = 0;
            if (p < end && (*p == '+' || *p == '-')) {
                eneg = (*p == '-');
                p++;
            }
            int ev = 0, edig = 0;
            while (p < end && *p >= '0' && *p <= '9') {
                ev = ev * 10 + (*p - '0');
                edig++;
                p++;
            }
            if (!edig)
                return -(1 + (long)(tok - buf));
            exp10 += eneg ? -ev : ev;
        }
        /* token must end at whitespace or EOF */
        if (p < end) {
            char c = *p;
            if (!(c == ' ' || c == '\t' || c == '\n' || c == '\r' ||
                  c == '\f' || c == '\v'))
                return -(1 + (long)(tok - buf));
        }

        double v;
        /* Exact fast path: mantissa <= 2^53 and |exp10| <= 22 means
         * both the mantissa and 10^|exp10| are exact doubles, so one
         * multiply/divide gives the correctly rounded result (classic
         * Clinger fast case — covers every fixture writer: 15-17
         * significant digits, small exponents). */
        static const double pow10tab[23] = {
            1e0,  1e1,  1e2,  1e3,  1e4,  1e5,  1e6,  1e7,
            1e8,  1e9,  1e10, 1e11, 1e12, 1e13, 1e14, 1e15,
            1e16, 1e17, 1e18, 1e19, 1e20, 1e21, 1e22};
        if (mant <= 9007199254740992ull && exp10 >= -22 && exp10 <= 22) {
            v = (double)mant;
            if (exp10 > 0)
                v *= pow10tab[exp10];
            else if (exp10 < 0)
                v /= pow10tab[-exp10];
        } else {
            /* rare slow path (>~16 significant digits or big exponent):
             * strtod a NUL-terminated copy of the token for correct
             * rounding (the mmap'd buffer has no trailing NUL) */
            char tmp[64];
            size_t tl = (size_t)(p - mstart); /* unsigned magnitude */
            if (tl >= sizeof(tmp))
                return -(1 + (long)(tok - buf));
            memcpy(tmp, mstart, tl);
            tmp[tl] = '\0';
            /* Fortran D exponents are not strtod grammar */
            for (size_t q = 0; q < tl; q++)
                if (tmp[q] == 'd' || tmp[q] == 'D')
                    tmp[q] = 'e';
            v = strtod(tmp, NULL);
        }
        out[n++] = neg ? -v : v;
    }
    return n;
}
