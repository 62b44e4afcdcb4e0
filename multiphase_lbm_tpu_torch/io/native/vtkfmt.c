/* The legacy-VTK writer's ASCII formatter: one call formats one field block.
 *
 * io/vtk.py builds this file with the host C compiler and calls it through
 * ctypes, which releases the interpreter lock for the call.  Each entry
 * writes into the caller's buffer and returns the bytes written, or -1 when
 * the buffer cannot hold the worst case of the next value.  The bytes are
 * those of the writer's plain numpy rendering:
 *
 *   float scalars  Python's "%g" of each value cast to float32 (a float32
 *                  block, or a float64 one when f64 is set), a space after
 *                  each value and a newline after each row of row_len;
 *   int scalars    "%d" of each int64, the same layout;
 *   vectors        "%g %g %g\n" a point, components from a component-first
 *                  (ncomp, n) block, float32 or float64 as above; ncomp 2
 *                  writes a z of "0".
 *
 * Python's "%g" is C's on finite values and infinities (6 significant
 * digits, trailing zeros stripped, exponent of at least two digits, ties to
 * even) and prints "nan" whatever a NaN's sign, where glibc prints "-nan".
 * fmt_g renders a finite value from its six-digit integer mantissa; when
 * the scaled value lies within 1e-6 of a rounding tie, where the double
 * arithmetic's error (under 1e-9 there) could round the wrong way, it asks
 * snprintf instead.  No libm call: the decimal exponent comes from the
 * binary one.
 */
#include <stdint.h>
#include <stdio.h>
#include <string.h>

#define FLOAT_TOKEN 12 /* "-3.40282e+38" */

/* 10^k for the scalings of float32's range: 5 - e for e in [-45, 39] */
static const double P10[] = {
    1e0,  1e1,  1e2,  1e3,  1e4,  1e5,  1e6,  1e7,  1e8,  1e9,  1e10,
    1e11, 1e12, 1e13, 1e14, 1e15, 1e16, 1e17, 1e18, 1e19, 1e20, 1e21,
    1e22, 1e23, 1e24, 1e25, 1e26, 1e27, 1e28, 1e29, 1e30, 1e31, 1e32,
    1e33, 1e34, 1e35, 1e36, 1e37, 1e38, 1e39, 1e40, 1e41, 1e42, 1e43,
    1e44, 1e45, 1e46, 1e47, 1e48, 1e49, 1e50};

static double scale10(double d, int k)
{
    return k >= 0 ? d * P10[k] : d / P10[-k];
}

/* Python's "%g" of (double)f into out, unterminated; returns its length
 * (at most FLOAT_TOKEN). */
static int fmt_g(float f, char *out)
{
    uint32_t bits;
    memcpy(&bits, &f, sizeof bits);
    uint32_t mag = bits & 0x7fffffffu;
    char *p = out;
    if (mag > 0x7f800000u) {
        memcpy(p, "nan", 3);
        return 3;
    }
    if (bits >> 31)
        *p++ = '-';
    if (mag == 0x7f800000u) {
        memcpy(p, "inf", 3);
        return (int)(p - out) + 3;
    }
    if (mag == 0) {
        *p++ = '0';
        return (int)(p - out);
    }
    float a;
    memcpy(&a, &mag, sizeof a);
    double d = a;
    uint64_t dbits;
    memcpy(&dbits, &d, sizeof dbits);
    /* floor(e2 log10 2): the decimal exponent, or one below it */
    int e2 = (int)((dbits >> 52) & 0x7ff) - 1023;
    int e = (e2 * 78913) >> 18;
    double s = scale10(d, 5 - e);
    while (s >= 1e6) {
        ++e;
        s = scale10(d, 5 - e);
    }
    long n = (long)s;
    double frac = s - (double)n;
    if (frac > 0.5 - 1e-6 && frac < 0.5 + 1e-6) {
        char tmp[32];
        int len = snprintf(tmp, sizeof tmp, "%g", d);
        memcpy(p, tmp, (size_t)len);
        return (int)(p - out) + len;
    }
    if (frac > 0.5)
        ++n;
    if (n >= 1000000) { /* rounded up across a decade: 9.999995 -> 10 */
        n /= 10;
        ++e;
    }
    char dig[6];
    for (int i = 5; i >= 0; --i) {
        dig[i] = (char)('0' + n % 10);
        n /= 10;
    }
    int last = 5; /* the last significant digit */
    while (last > 0 && dig[last] == '0')
        --last;
    if (e < -4 || e >= 6) {
        *p++ = dig[0];
        if (last > 0) {
            *p++ = '.';
            memcpy(p, dig + 1, (size_t)last);
            p += last;
        }
        *p++ = 'e';
        *p++ = e < 0 ? '-' : '+';
        int ae = e < 0 ? -e : e; /* at most 45 */
        *p++ = (char)('0' + ae / 10);
        *p++ = (char)('0' + ae % 10);
    } else if (e >= 0) {
        memcpy(p, dig, (size_t)e + 1);
        p += e + 1;
        if (last > e) {
            *p++ = '.';
            memcpy(p, dig + e + 1, (size_t)(last - e));
            p += last - e;
        }
    } else {
        *p++ = '0';
        *p++ = '.';
        for (int i = -1; i > e; --i)
            *p++ = '0';
        memcpy(p, dig, (size_t)last + 1);
        p += last + 1;
    }
    return (int)(p - out);
}

/* "%d" of v into out, unterminated; returns its length (at most 20) */
static int fmt_i64(int64_t v, char *out)
{
    char tmp[20];
    int len = 0;
    uint64_t u = v < 0 ? 0 - (uint64_t)v : (uint64_t)v;
    do {
        tmp[len++] = (char)('0' + u % 10);
        u /= 10;
    } while (u);
    char *p = out;
    if (v < 0)
        *p++ = '-';
    while (len)
        *p++ = tmp[--len];
    return (int)(p - out);
}

/* the i-th value of a float32 block, or of a float64 block cast to float32 */
static float value_at(const void *vals, int f64, long i)
{
    return f64 ? (float)((const double *)vals)[i] : ((const float *)vals)[i];
}

long vtk_format_float(const void *vals, int f64, long n, long row_len,
                      char *out, long cap)
{
    long pos = 0;
    long col = 0;
    if (row_len < 1)
        return -1;
    for (long i = 0; i < n; ++i) {
        if (cap - pos < FLOAT_TOKEN + 2)
            return -1;
        pos += fmt_g(value_at(vals, f64, i), out + pos);
        out[pos++] = ' ';
        if (++col == row_len) {
            out[pos++] = '\n';
            col = 0;
        }
    }
    return pos;
}

long vtk_format_int(const int64_t *vals, long n, long row_len, char *out,
                    long cap)
{
    long pos = 0;
    long col = 0;
    if (row_len < 1)
        return -1;
    for (long i = 0; i < n; ++i) {
        if (cap - pos < 20 + 2)
            return -1;
        pos += fmt_i64(vals[i], out + pos);
        out[pos++] = ' ';
        if (++col == row_len) {
            out[pos++] = '\n';
            col = 0;
        }
    }
    return pos;
}

long vtk_format_vector(const void *comps, int f64, long n, long ncomp,
                       char *out, long cap)
{
    long pos = 0;
    if (ncomp != 2 && ncomp != 3)
        return -1;
    for (long i = 0; i < n; ++i) {
        if (cap - pos < 3 * (FLOAT_TOKEN + 1))
            return -1;
        pos += fmt_g(value_at(comps, f64, i), out + pos);
        out[pos++] = ' ';
        pos += fmt_g(value_at(comps, f64, n + i), out + pos);
        out[pos++] = ' ';
        if (ncomp == 3)
            pos += fmt_g(value_at(comps, f64, 2 * n + i), out + pos);
        else
            out[pos++] = '0';
        out[pos++] = '\n';
    }
    return pos;
}
