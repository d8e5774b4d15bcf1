// Native BLS12-446 group arithmetic: Pippenger MSM + fixed-base power chains.
//
// The analog of tfhe-zk-pok's hand-rolled curve backend (tfhe-zk-pok/
// src/curve_446/ + curve_api/msm.rs) and of the zk-cuda-backend GPU MSM:
// the hot loops of ZK CRS generation and proving, behind a C ABI consumed
// from Python via ctypes (tfhe_tpu_torch/zk/curve446.py).  Field constants are
// injected at init time by the Python side, so this file contains only
// generic 7x64-limb Montgomery arithmetic.
//
// Point encodings on the ABI: affine, little-endian 56-byte coordinates.
// G1 = 112 bytes (x, y); G2 = 224 bytes (x.c0, x.c1, y.c0, y.c1).
// The all-zero encoding is the point at infinity.  Scalars: 40-byte LE.
//
// Built at first use by tfhe_tpu_torch/zk/curve446.py (utils/build.py):
// g++ -O3 -march=native -fopenmp -shared -fPIC

#include <cstdint>
#include <cstring>
#include <vector>

typedef uint64_t u64;
typedef unsigned __int128 u128;

static const int NL = 7; // 446-bit modulus in 7x64 limbs

struct Fp {
    u64 v[NL];
};

static Fp P_MOD;      // modulus p
static Fp R2;         // (2^448)^2 mod p
static Fp ONE_M;      // Montgomery one = 2^448 mod p
static u64 N0;        // -p^{-1} mod 2^64
static Fp P_MINUS_2;  // exponent for Fermat inversion

static inline bool fp_is_zero(const Fp &a) {
    u64 acc = 0;
    for (int i = 0; i < NL; i++) acc |= a.v[i];
    return acc == 0;
}

static inline bool fp_eq(const Fp &a, const Fp &b) {
    u64 acc = 0;
    for (int i = 0; i < NL; i++) acc |= a.v[i] ^ b.v[i];
    return acc == 0;
}

static inline bool fp_geq(const Fp &a, const Fp &b) {
    for (int i = NL - 1; i >= 0; i--) {
        if (a.v[i] != b.v[i]) return a.v[i] > b.v[i];
    }
    return true;
}

static inline void fp_sub_raw(Fp &r, const Fp &a, const Fp &b) {
    u64 borrow = 0;
    for (int i = 0; i < NL; i++) {
        u128 d = (u128)a.v[i] - b.v[i] - borrow;
        r.v[i] = (u64)d;
        borrow = (u64)(d >> 64) & 1;
    }
}

static inline void fp_add(Fp &r, const Fp &a, const Fp &b) {
    u64 carry = 0;
    for (int i = 0; i < NL; i++) {
        u128 s = (u128)a.v[i] + b.v[i] + carry;
        r.v[i] = (u64)s;
        carry = (u64)(s >> 64);
    }
    // p is 446-bit: a+b < 2^447 fits without limb overflow (carry==0 here)
    if (fp_geq(r, P_MOD)) fp_sub_raw(r, r, P_MOD);
}

static inline void fp_sub(Fp &r, const Fp &a, const Fp &b) {
    u64 borrow = 0;
    for (int i = 0; i < NL; i++) {
        u128 d = (u128)a.v[i] - b.v[i] - borrow;
        r.v[i] = (u64)d;
        borrow = (u64)(d >> 64) & 1;
    }
    if (borrow) {
        u64 carry = 0;
        for (int i = 0; i < NL; i++) {
            u128 s = (u128)r.v[i] + P_MOD.v[i] + carry;
            r.v[i] = (u64)s;
            carry = (u64)(s >> 64);
        }
    }
}

static inline void fp_dbl(Fp &r, const Fp &a) { fp_add(r, a, a); }

// CIOS Montgomery multiplication
static void fp_mul(Fp &r, const Fp &a, const Fp &b) {
    u64 t[NL + 2];
    memset(t, 0, sizeof(t));
    for (int i = 0; i < NL; i++) {
        u64 c = 0;
        for (int j = 0; j < NL; j++) {
            u128 x = (u128)a.v[j] * b.v[i] + t[j] + c;
            t[j] = (u64)x;
            c = (u64)(x >> 64);
        }
        u128 x = (u128)t[NL] + c;
        t[NL] = (u64)x;
        t[NL + 1] = (u64)(x >> 64);

        u64 m = t[0] * N0;
        u128 y = (u128)m * P_MOD.v[0] + t[0];
        c = (u64)(y >> 64);
        for (int j = 1; j < NL; j++) {
            u128 z = (u128)m * P_MOD.v[j] + t[j] + c;
            t[j - 1] = (u64)z;
            c = (u64)(z >> 64);
        }
        u128 z = (u128)t[NL] + c;
        t[NL - 1] = (u64)z;
        t[NL] = t[NL + 1] + (u64)(z >> 64);
        t[NL + 1] = 0;
    }
    Fp out;
    for (int i = 0; i < NL; i++) out.v[i] = t[i];
    if (t[NL] || fp_geq(out, P_MOD)) fp_sub_raw(out, out, P_MOD);
    r = out;
}

static inline void fp_sqr(Fp &r, const Fp &a) { fp_mul(r, a, a); }

static void fp_inv(Fp &r, const Fp &a) {
    // Fermat: a^(p-2), square-and-multiply MSB-first
    Fp acc = ONE_M;
    for (int i = NL - 1; i >= 0; i--) {
        for (int b = 63; b >= 0; b--) {
            fp_sqr(acc, acc);
            if ((P_MINUS_2.v[i] >> b) & 1) fp_mul(acc, acc, a);
        }
    }
    r = acc;
}

// --------------------------------------------------------------------------
// Fp2 = Fp[u]/(u^2+1)
// --------------------------------------------------------------------------

struct Fp2 {
    Fp c0, c1;
};

static inline bool fp2_is_zero(const Fp2 &a) {
    return fp_is_zero(a.c0) && fp_is_zero(a.c1);
}
static inline bool fp2_eq(const Fp2 &a, const Fp2 &b) {
    return fp_eq(a.c0, b.c0) && fp_eq(a.c1, b.c1);
}
static inline void fp2_add(Fp2 &r, const Fp2 &a, const Fp2 &b) {
    fp_add(r.c0, a.c0, b.c0);
    fp_add(r.c1, a.c1, b.c1);
}
static inline void fp2_sub(Fp2 &r, const Fp2 &a, const Fp2 &b) {
    fp_sub(r.c0, a.c0, b.c0);
    fp_sub(r.c1, a.c1, b.c1);
}
static inline void fp2_dbl(Fp2 &r, const Fp2 &a) { fp2_add(r, a, a); }
static void fp2_mul(Fp2 &r, const Fp2 &a, const Fp2 &b) {
    Fp ac, bd, s1, s2, t;
    fp_mul(ac, a.c0, b.c0);
    fp_mul(bd, a.c1, b.c1);
    fp_add(s1, a.c0, a.c1);
    fp_add(s2, b.c0, b.c1);
    fp_mul(t, s1, s2);
    fp_sub(t, t, ac);
    fp_sub(t, t, bd);
    fp_sub(r.c0, ac, bd);
    r.c1 = t;
}
static void fp2_sqr(Fp2 &r, const Fp2 &a) {
    Fp s, d, m;
    fp_add(s, a.c0, a.c1);
    fp_sub(d, a.c0, a.c1);
    fp_mul(m, a.c0, a.c1);
    fp_mul(r.c0, s, d);
    fp_dbl(r.c1, m);
}
static void fp2_inv(Fp2 &r, const Fp2 &a) {
    Fp t0, t1;
    fp_sqr(t0, a.c0);
    fp_sqr(t1, a.c1);
    fp_add(t0, t0, t1);
    fp_inv(t0, t0);
    fp_mul(r.c0, a.c0, t0);
    Fp neg;
    Fp zero;
    memset(&zero, 0, sizeof(zero));
    fp_sub(neg, zero, a.c1);
    fp_mul(r.c1, neg, t0);
}

// --------------------------------------------------------------------------
// Field trait dispatch (templates over Fp / Fp2)
// --------------------------------------------------------------------------

template <class F> struct FOps;

template <> struct FOps<Fp> {
    static void add(Fp &r, const Fp &a, const Fp &b) { fp_add(r, a, b); }
    static void sub(Fp &r, const Fp &a, const Fp &b) { fp_sub(r, a, b); }
    static void mul(Fp &r, const Fp &a, const Fp &b) { fp_mul(r, a, b); }
    static void sqr(Fp &r, const Fp &a) { fp_sqr(r, a); }
    static void inv(Fp &r, const Fp &a) { fp_inv(r, a); }
    static void neg(Fp &r, const Fp &a) {
        Fp z; memset(&z, 0, sizeof z); fp_sub(r, z, a);
    }
    static bool is_zero(const Fp &a) { return fp_is_zero(a); }
    static bool eq(const Fp &a, const Fp &b) { return fp_eq(a, b); }
    static void set_one(Fp &r) { r = ONE_M; }
    static const int NBYTES = 56;
};

template <> struct FOps<Fp2> {
    static void add(Fp2 &r, const Fp2 &a, const Fp2 &b) { fp2_add(r, a, b); }
    static void sub(Fp2 &r, const Fp2 &a, const Fp2 &b) { fp2_sub(r, a, b); }
    static void mul(Fp2 &r, const Fp2 &a, const Fp2 &b) { fp2_mul(r, a, b); }
    static void sqr(Fp2 &r, const Fp2 &a) { fp2_sqr(r, a); }
    static void inv(Fp2 &r, const Fp2 &a) { fp2_inv(r, a); }
    static void neg(Fp2 &r, const Fp2 &a) {
        Fp2 z; memset(&z, 0, sizeof z); fp2_sub(r, z, a);
    }
    static bool is_zero(const Fp2 &a) { return fp2_is_zero(a); }
    static bool eq(const Fp2 &a, const Fp2 &b) { return fp2_eq(a, b); }
    static void set_one(Fp2 &r) {
        r.c0 = ONE_M;
        memset(&r.c1, 0, sizeof(r.c1));
    }
    static const int NBYTES = 112;
};

// --------------------------------------------------------------------------
// Jacobian point arithmetic on y^2 = x^3 + b (a = 0 short Weierstrass)
// --------------------------------------------------------------------------

template <class F> struct Jac {
    F X, Y, Z; // Z == 0 -> infinity
};

template <class F> static inline bool jac_is_inf(const Jac<F> &p) {
    return FOps<F>::is_zero(p.Z);
}

template <class F> static void jac_dbl(Jac<F> &r, const Jac<F> &p) {
    typedef FOps<F> O;
    if (jac_is_inf(p)) {
        r = p;
        return;
    }
    F A, B, C, D, E, Ff, t;
    O::sqr(A, p.X);           // A = X^2
    O::sqr(B, p.Y);           // B = Y^2
    O::sqr(C, B);             // C = B^2
    O::add(t, p.X, B);
    O::sqr(t, t);
    O::sub(t, t, A);
    O::sub(t, t, C);
    O::add(D, t, t);          // D = 2((X+B)^2 - A - C)
    O::add(E, A, A);
    O::add(E, E, A);          // E = 3A
    O::sqr(Ff, E);            // F = E^2
    F X3, Y3, Z3;
    O::sub(X3, Ff, D);
    O::sub(X3, X3, D);        // X3 = F - 2D
    O::sub(t, D, X3);
    O::mul(t, E, t);
    F C8;
    O::add(C8, C, C);
    O::add(C8, C8, C8);
    O::add(C8, C8, C8);       // 8C
    O::sub(Y3, t, C8);        // Y3 = E(D - X3) - 8C
    O::mul(Z3, p.Y, p.Z);
    O::add(Z3, Z3, Z3);       // Z3 = 2YZ
    r.X = X3;
    r.Y = Y3;
    r.Z = Z3;
}

template <class F> static void jac_add(Jac<F> &r, const Jac<F> &p, const Jac<F> &q) {
    typedef FOps<F> O;
    if (jac_is_inf(p)) {
        r = q;
        return;
    }
    if (jac_is_inf(q)) {
        r = p;
        return;
    }
    F Z1Z1, Z2Z2, U1, U2, S1, S2, t;
    O::sqr(Z1Z1, p.Z);
    O::sqr(Z2Z2, q.Z);
    O::mul(U1, p.X, Z2Z2);
    O::mul(U2, q.X, Z1Z1);
    O::mul(t, q.Z, Z2Z2);
    O::mul(S1, p.Y, t);
    O::mul(t, p.Z, Z1Z1);
    O::mul(S2, q.Y, t);
    if (O::eq(U1, U2)) {
        if (O::eq(S1, S2)) {
            jac_dbl(r, p);
        } else {
            memset(&r, 0, sizeof(r)); // infinity
        }
        return;
    }
    F H, I, J, rr, V;
    O::sub(H, U2, U1);
    O::add(I, H, H);
    O::sqr(I, I);             // I = (2H)^2
    O::mul(J, H, I);
    O::sub(rr, S2, S1);
    O::add(rr, rr, rr);       // r = 2(S2 - S1)
    O::mul(V, U1, I);
    F X3, Y3, Z3;
    O::sqr(X3, rr);
    O::sub(X3, X3, J);
    O::sub(X3, X3, V);
    O::sub(X3, X3, V);        // X3 = r^2 - J - 2V
    O::sub(t, V, X3);
    O::mul(t, rr, t);
    F S1J;
    O::mul(S1J, S1, J);
    O::add(S1J, S1J, S1J);
    O::sub(Y3, t, S1J);       // Y3 = r(V - X3) - 2 S1 J
    O::add(Z3, p.Z, q.Z);
    O::sqr(Z3, Z3);
    O::sub(Z3, Z3, Z1Z1);
    O::sub(Z3, Z3, Z2Z2);
    O::mul(Z3, Z3, H);        // Z3 = ((Z1+Z2)^2 - Z1Z1 - Z2Z2) H
    r.X = X3;
    r.Y = Y3;
    r.Z = Z3;
}

// --------------------------------------------------------------------------
// byte <-> field conversions (LE bytes, Montgomery domain internally)
// --------------------------------------------------------------------------

static void fp_from_bytes(Fp &r, const uint8_t *b) {
    for (int i = 0; i < NL; i++) {
        u64 w = 0;
        for (int j = 7; j >= 0; j--) w = (w << 8) | b[i * 8 + j];
        r.v[i] = w;
    }
    fp_mul(r, r, R2); // into Montgomery domain
}

static void fp_to_bytes(uint8_t *b, const Fp &a) {
    Fp one;
    memset(&one, 0, sizeof(one));
    one.v[0] = 1;
    Fp n;
    fp_mul(n, a, one); // out of Montgomery domain (REDC by 1)
    for (int i = 0; i < NL; i++) {
        for (int j = 0; j < 8; j++) b[i * 8 + j] = (uint8_t)(n.v[i] >> (8 * j));
    }
}

template <class F> static void f_from_bytes(F &r, const uint8_t *b);
template <> void f_from_bytes<Fp>(Fp &r, const uint8_t *b) { fp_from_bytes(r, b); }
template <> void f_from_bytes<Fp2>(Fp2 &r, const uint8_t *b) {
    fp_from_bytes(r.c0, b);
    fp_from_bytes(r.c1, b + 56);
}
template <class F> static void f_to_bytes(uint8_t *b, const F &a);
template <> void f_to_bytes<Fp>(uint8_t *b, const Fp &a) { fp_to_bytes(b, a); }
template <> void f_to_bytes<Fp2>(uint8_t *b, const Fp2 &a) {
    fp_to_bytes(b, a.c0);
    fp_to_bytes(b + 56, a.c1);
}

template <class F> static bool bytes_all_zero(const uint8_t *b) {
    int n = 2 * FOps<F>::NBYTES;
    uint8_t acc = 0;
    for (int i = 0; i < n; i++) acc |= b[i];
    return acc == 0;
}

template <class F> static void point_from_bytes(Jac<F> &r, const uint8_t *b) {
    if (bytes_all_zero<F>(b)) {
        memset(&r, 0, sizeof(r));
        return;
    }
    f_from_bytes<F>(r.X, b);
    f_from_bytes<F>(r.Y, b + FOps<F>::NBYTES);
    FOps<F>::set_one(r.Z);
}

template <class F> static void point_to_bytes(uint8_t *b, const Jac<F> &p) {
    int n = 2 * FOps<F>::NBYTES;
    if (jac_is_inf(p)) {
        memset(b, 0, n);
        return;
    }
    F zi, zi2, zi3, x, y;
    FOps<F>::inv(zi, p.Z);
    FOps<F>::sqr(zi2, zi);
    FOps<F>::mul(zi3, zi2, zi);
    FOps<F>::mul(x, p.X, zi2);
    FOps<F>::mul(y, p.Y, zi3);
    f_to_bytes<F>(b, x);
    f_to_bytes<F>(b + FOps<F>::NBYTES, y);
}

// --------------------------------------------------------------------------
// scalar helpers (40-byte LE, up to 320 bits)
// --------------------------------------------------------------------------

static const int SC_BYTES = 40;
static const int SC_BITS = 320;

static inline u64 scalar_window(const uint8_t *s, int bit0, int width) {
    u64 w = 0;
    for (int i = width - 1; i >= 0; i--) {
        int bit = bit0 + i;
        int byte = bit >> 3;
        u64 b = (byte < SC_BYTES) ? ((s[byte] >> (bit & 7)) & 1) : 0;
        w = (w << 1) | b;
    }
    return w;
}

template <class F>
static void jac_scalar_mul(Jac<F> &r, const Jac<F> &p, const uint8_t *s) {
    Jac<F> acc;
    memset(&acc, 0, sizeof(acc));
    int top = SC_BITS - 1;
    while (top >= 0 && !((s[top >> 3] >> (top & 7)) & 1)) top--;
    for (int bit = top; bit >= 0; bit--) {
        jac_dbl(acc, acc);
        if ((s[bit >> 3] >> (bit & 7)) & 1) jac_add(acc, acc, p);
    }
    r = acc;
}

// --------------------------------------------------------------------------
// Pippenger MSM
// --------------------------------------------------------------------------

template <class F>
static void jac_neg(Jac<F> &r, const Jac<F> &p) {
    r = p;
    if (!jac_is_inf(p)) FOps<F>::neg(r.Y, p.Y);
}

template <class F>
static void msm(uint8_t *out, const uint8_t *pts, const uint8_t *scalars, u64 n) {
    int psz = 2 * FOps<F>::NBYTES;
    std::vector<Jac<F>> points(n);
    for (u64 i = 0; i < n; i++) point_from_bytes<F>(points[i], pts + i * psz);

    // window size minimizing ceil(320/c) * (n + 2^(c-1)): signed-digit
    // buckets (digits in [-2^(c-1), 2^(c-1)], negatives add the negated
    // point) halve the bucket count vs plain Pippenger
    int c = 2;
    double best = 1e30;
    for (int cc = 2; cc <= 17; cc++) {
        double cost = double((SC_BITS + cc - 1) / cc) *
                      (double(n) + double(1u << (cc - 1)));
        if (cost < best) { best = cost; c = cc; }
    }
    int nbuckets = 1 << (c - 1);                 // buckets for |digit| 1..2^(c-1)
    int nwin = (SC_BITS + c - 1) / c + 1;        // +1 for the carry spill

    // signed digits with carry: d_w in [-2^(c-1), 2^(c-1)]
    std::vector<int32_t> digits((size_t)n * nwin);
    for (u64 i = 0; i < n; i++) {
        int64_t carry = 0;
        for (int w = 0; w < nwin; w++) {
            int64_t d = (int64_t)scalar_window(scalars + i * SC_BYTES, w * c, c)
                        + carry;
            carry = 0;
            if (d > (1 << (c - 1))) { d -= (1 << c); carry = 1; }
            digits[(size_t)i * nwin + w] = (int32_t)d;
        }
    }

    std::vector<Jac<F>> win_sums(nwin);
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic)
#endif
    for (int w = 0; w < nwin; w++) {
        std::vector<Jac<F>> buckets(nbuckets);
        for (int k = 0; k < nbuckets; k++) memset(&buckets[k], 0, sizeof(Jac<F>));
        for (u64 i = 0; i < n; i++) {
            int32_t d = digits[(size_t)i * nwin + w];
            if (d > 0) {
                jac_add(buckets[d - 1], buckets[d - 1], points[i]);
            } else if (d < 0) {
                Jac<F> np;
                jac_neg(np, points[i]);
                jac_add(buckets[-d - 1], buckets[-d - 1], np);
            }
        }
        Jac<F> acc, sum;
        memset(&acc, 0, sizeof(acc));
        memset(&sum, 0, sizeof(sum));
        for (int k = nbuckets - 1; k >= 0; k--) {
            jac_add(acc, acc, buckets[k]);
            jac_add(sum, sum, acc);
        }
        win_sums[w] = sum;
    }

    Jac<F> total;
    memset(&total, 0, sizeof(total));
    for (int w = nwin - 1; w >= 0; w--) {
        for (int k = 0; k < c; k++) jac_dbl(total, total);
        jac_add(total, total, win_sums[w]);
    }
    point_to_bytes<F>(out, total);
}

// --------------------------------------------------------------------------
// fixed-base power chains: out[i] = alpha^(i+1) * base  (CRS generation)
// --------------------------------------------------------------------------

template <class F>
static void powers(uint8_t *out, const uint8_t *base, const uint8_t *alpha,
                   u64 count, int64_t skip) {
    int psz = 2 * FOps<F>::NBYTES;
    Jac<F> cur;
    point_from_bytes<F>(cur, base);
    std::vector<Jac<F>> res(count);
    for (u64 i = 0; i < count; i++) {
        jac_scalar_mul(cur, cur, alpha);
        res[i] = cur;
    }
    // batch inversion of the Z coordinates for affine output
    std::vector<F> zs, prefix;
    std::vector<u64> idx;
    for (u64 i = 0; i < count; i++) {
        if ((int64_t)i == skip || jac_is_inf(res[i])) continue;
        zs.push_back(res[i].Z);
        idx.push_back(i);
    }
    u64 m = zs.size();
    prefix.resize(m + 1);
    FOps<F>::set_one(prefix[0]);
    for (u64 i = 0; i < m; i++) FOps<F>::mul(prefix[i + 1], prefix[i], zs[i]);
    F inv_all;
    FOps<F>::inv(inv_all, prefix[m]);
    std::vector<F> zinv(m);
    for (u64 i = m; i-- > 0;) {
        FOps<F>::mul(zinv[i], inv_all, prefix[i]);
        FOps<F>::mul(inv_all, inv_all, zs[i]);
    }
    memset(out, 0, count * psz);
    for (u64 j = 0; j < m; j++) {
        u64 i = idx[j];
        F zi2, zi3, x, y;
        FOps<F>::sqr(zi2, zinv[j]);
        FOps<F>::mul(zi3, zi2, zinv[j]);
        FOps<F>::mul(x, res[i].X, zi2);
        FOps<F>::mul(y, res[i].Y, zi3);
        f_to_bytes<F>(out + i * psz, x);
        f_to_bytes<F>(out + i * psz + FOps<F>::NBYTES, y);
    }
}


// --------------------------------------------------------------------------
// Pairing: Fp6/Fp12 towers, Miller loop, final exponentiation
// (port of the Python tower in tfhe_tpu_torch/zk/curve446.py; M-type twist,
// xi = 1 + u, Fq6 = Fq2[v]/(v^3 - xi), Fq12 = Fq6[w]/(w^2 - v))
// --------------------------------------------------------------------------

struct Fp6 {
    Fp2 c0, c1, c2;
};
struct Fp12 {
    Fp6 c0, c1;
};

static Fp2 GAMMA[6];         // frobenius coefficients xi^((p-1)i/6)
static std::vector<uint8_t> HARD_EXP;  // (p^4-p^2+1)/r, big-endian bytes
static std::vector<uint8_t> X_ABS_BE;  // |x| big-endian bytes
static int X_NEG = 1;

static inline void fp2_neg(Fp2 &r, const Fp2 &a) {
    Fp z;
    memset(&z, 0, sizeof(z));
    fp_sub(r.c0, z, a.c0);
    fp_sub(r.c1, z, a.c1);
}

static inline void fp2_conj(Fp2 &r, const Fp2 &a) {
    Fp z;
    memset(&z, 0, sizeof(z));
    r.c0 = a.c0;
    fp_sub(r.c1, z, a.c1);
}

static inline void fp2_mul_xi(Fp2 &r, const Fp2 &a) {
    // (a+bu)(1+u) = (a-b) + (a+b)u
    Fp t0, t1;
    fp_sub(t0, a.c0, a.c1);
    fp_add(t1, a.c0, a.c1);
    r.c0 = t0;
    r.c1 = t1;
}

static void fp6_add(Fp6 &r, const Fp6 &a, const Fp6 &b) {
    fp2_add(r.c0, a.c0, b.c0);
    fp2_add(r.c1, a.c1, b.c1);
    fp2_add(r.c2, a.c2, b.c2);
}

static void fp6_sub(Fp6 &r, const Fp6 &a, const Fp6 &b) {
    fp2_sub(r.c0, a.c0, b.c0);
    fp2_sub(r.c1, a.c1, b.c1);
    fp2_sub(r.c2, a.c2, b.c2);
}

static void fp6_neg(Fp6 &r, const Fp6 &a) {
    fp2_neg(r.c0, a.c0);
    fp2_neg(r.c1, a.c1);
    fp2_neg(r.c2, a.c2);
}

static void fp6_mul(Fp6 &r, const Fp6 &x, const Fp6 &y) {
    Fp2 t0, t1, t2, s, u, w;
    fp2_mul(t0, x.c0, y.c0);
    fp2_mul(t1, x.c1, y.c1);
    fp2_mul(t2, x.c2, y.c2);
    // c0 = t0 + xi*((a1+a2)(b1+b2) - t1 - t2)
    Fp2 a12, b12, c0;
    fp2_add(a12, x.c1, x.c2);
    fp2_add(b12, y.c1, y.c2);
    fp2_mul(s, a12, b12);
    fp2_sub(s, s, t1);
    fp2_sub(s, s, t2);
    fp2_mul_xi(u, s);
    fp2_add(c0, t0, u);
    // c1 = (a0+a1)(b0+b1) - t0 - t1 + xi*t2
    Fp2 a01, b01, c1;
    fp2_add(a01, x.c0, x.c1);
    fp2_add(b01, y.c0, y.c1);
    fp2_mul(s, a01, b01);
    fp2_sub(s, s, t0);
    fp2_sub(s, s, t1);
    fp2_mul_xi(u, t2);
    fp2_add(c1, s, u);
    // c2 = (a0+a2)(b0+b2) - t0 - t2 + t1
    Fp2 a02, b02, c2;
    fp2_add(a02, x.c0, x.c2);
    fp2_add(b02, y.c0, y.c2);
    fp2_mul(s, a02, b02);
    fp2_sub(s, s, t0);
    fp2_sub(s, s, t2);
    fp2_add(c2, s, t1);
    r.c0 = c0;
    r.c1 = c1;
    r.c2 = c2;
}

static void fp6_mul_v(Fp6 &r, const Fp6 &a) {
    Fp2 t;
    fp2_mul_xi(t, a.c2);
    Fp2 c1 = a.c0, c2 = a.c1;
    r.c0 = t;
    r.c1 = c1;
    r.c2 = c2;
}

static void fp6_inv(Fp6 &r, const Fp6 &x) {
    Fp2 c0, c1, c2, t, u, w;
    fp2_sqr(t, x.c0);
    fp2_mul(u, x.c1, x.c2);
    fp2_mul_xi(w, u);
    fp2_sub(c0, t, w);
    fp2_sqr(t, x.c2);
    fp2_mul_xi(u, t);
    fp2_mul(w, x.c0, x.c1);
    fp2_sub(c1, u, w);
    fp2_sqr(t, x.c1);
    fp2_mul(u, x.c0, x.c2);
    fp2_sub(c2, t, u);
    Fp2 den, d1, d2;
    fp2_mul(den, x.c0, c0);
    fp2_mul(t, x.c2, c1);
    fp2_mul_xi(d1, t);
    fp2_mul(t, x.c1, c2);
    fp2_mul_xi(d2, t);
    fp2_add(den, den, d1);
    fp2_add(den, den, d2);
    fp2_inv(den, den);
    fp2_mul(r.c0, c0, den);
    fp2_mul(r.c1, c1, den);
    fp2_mul(r.c2, c2, den);
}

static void fp12_mul(Fp12 &r, const Fp12 &x, const Fp12 &y) {
    Fp6 t0, t1, s, u;
    fp6_mul(t0, x.c0, y.c0);
    fp6_mul(t1, x.c1, y.c1);
    Fp6 a01, b01;
    fp6_add(a01, x.c0, x.c1);
    fp6_add(b01, y.c0, y.c1);
    fp6_mul(s, a01, b01);
    fp6_sub(s, s, t0);
    fp6_sub(s, s, t1);
    fp6_mul_v(u, t1);
    fp6_add(r.c0, t0, u);
    r.c1 = s;
}

static void fp12_sqr(Fp12 &r, const Fp12 &x) {
    // mirror of f12_sq: c0 = (a0+a1)(a0+v*a1) - t - v*t; c1 = 2t
    Fp6 t, s0, s1, u, w;
    fp6_mul(t, x.c0, x.c1);
    fp6_add(s0, x.c0, x.c1);
    fp6_mul_v(u, x.c1);
    fp6_add(s1, x.c0, u);
    fp6_mul(w, s0, s1);
    fp6_mul_v(u, t);
    fp6_add(u, u, t);
    fp6_sub(r.c0, w, u);
    fp6_add(r.c1, t, t);
}

static void fp12_inv(Fp12 &r, const Fp12 &x) {
    Fp6 t0, t1, t;
    Fp6 a0sq, a1sq;
    fp6_mul(a0sq, x.c0, x.c0);
    fp6_mul(a1sq, x.c1, x.c1);
    fp6_mul_v(t1, a1sq);
    fp6_sub(t, a0sq, t1);
    fp6_inv(t, t);
    fp6_mul(r.c0, x.c0, t);
    fp6_mul(t0, x.c1, t);
    fp6_neg(r.c1, t0);
}

static void fp12_conj(Fp12 &r, const Fp12 &x) {
    r.c0 = x.c0;
    fp6_neg(r.c1, x.c1);
}

static void fp12_one(Fp12 &r) {
    memset(&r, 0, sizeof(r));
    r.c0.c0.c0 = ONE_M;
}

static void fp12_frobenius(Fp12 &r, const Fp12 &x) {
    Fp2 t;
    fp2_conj(r.c0.c0, x.c0.c0);
    fp2_conj(t, x.c0.c1);
    fp2_mul(r.c0.c1, t, GAMMA[2]);
    fp2_conj(t, x.c0.c2);
    fp2_mul(r.c0.c2, t, GAMMA[4]);
    fp2_conj(t, x.c1.c0);
    fp2_mul(r.c1.c0, t, GAMMA[1]);
    fp2_conj(t, x.c1.c1);
    fp2_mul(r.c1.c1, t, GAMMA[3]);
    fp2_conj(t, x.c1.c2);
    fp2_mul(r.c1.c2, t, GAMMA[5]);
}

static void fp12_pow_be(Fp12 &r, const Fp12 &x, const uint8_t *be, size_t n) {
    Fp12 acc;
    fp12_one(acc);
    bool started = false;
    for (size_t i = 0; i < n; i++) {
        for (int b = 7; b >= 0; b--) {
            if (started) fp12_sqr(acc, acc);
            if ((be[i] >> b) & 1) {
                if (!started) {
                    acc = x;
                    started = true;
                } else {
                    fp12_mul(acc, acc, x);
                }
            }
        }
    }
    r = acc;
}

// affine G2 helpers (infinity cannot occur inside the Miller loop for
// prime-order inputs; mirrors the Python affine path)
struct G2Aff {
    Fp2 x, y;
};

static void g2aff_dbl(G2Aff &r, const G2Aff &p) {
    Fp2 num, den, lam, t;
    fp2_sqr(t, p.x);
    fp2_add(num, t, t);
    fp2_add(num, num, t);         // 3x^2
    fp2_add(den, p.y, p.y);       // 2y
    fp2_inv(den, den);
    fp2_mul(lam, num, den);
    Fp2 x3, y3;
    fp2_sqr(x3, lam);
    fp2_sub(x3, x3, p.x);
    fp2_sub(x3, x3, p.x);
    fp2_sub(t, p.x, x3);
    fp2_mul(y3, lam, t);
    fp2_sub(y3, y3, p.y);
    r.x = x3;
    r.y = y3;
}

static void g2aff_add(G2Aff &r, const G2Aff &p, const G2Aff &q) {
    Fp2 num, den, lam, t;
    fp2_sub(num, q.y, p.y);
    fp2_sub(den, q.x, p.x);
    fp2_inv(den, den);
    fp2_mul(lam, num, den);
    Fp2 x3, y3;
    fp2_sqr(x3, lam);
    fp2_sub(x3, x3, p.x);
    fp2_sub(x3, x3, q.x);
    fp2_sub(t, p.x, x3);
    fp2_mul(y3, lam, t);
    fp2_sub(y3, y3, p.y);
    r.x = x3;
    r.y = y3;
}

// line through q1, q2 evaluated at (xp, yp), as a full Fp12
// (mirrors _line_eval: w^0 -> c0.c0, w^2 -> c0.c1, w^3 -> c1.c1)
static void line_eval(Fp12 &out, const G2Aff &q1, const G2Aff &q2,
                      const Fp &xp, const Fp &yp) {
    memset(&out, 0, sizeof(out));
    Fp2 lam_num, lam_den, t;
    bool same_x = fp2_eq(q1.x, q2.x);
    bool same_y = fp2_eq(q1.y, q2.y);
    if (same_x && same_y) {
        fp2_sqr(t, q1.x);
        fp2_add(lam_num, t, t);
        fp2_add(lam_num, lam_num, t);
        fp2_add(lam_den, q1.y, q1.y);
    } else if (same_x) {
        // vertical: (-x1) + xp * w^2
        fp2_neg(out.c0.c0, q1.x);
        out.c0.c1.c0 = xp;
        return;
    } else {
        fp2_sub(lam_num, q2.y, q1.y);
        fp2_sub(lam_den, q2.x, q1.x);
    }
    Fp2 a, b, c, u;
    fp2_mul(a, lam_num, q1.x);
    fp2_mul(u, lam_den, q1.y);
    fp2_sub(a, a, u);                    // w^0
    // b = -lam_num * xp  (xp in Fp)
    Fp2 xp2, yp2;
    memset(&xp2, 0, sizeof(xp2));
    memset(&yp2, 0, sizeof(yp2));
    xp2.c0 = xp;
    yp2.c0 = yp;
    fp2_mul(b, lam_num, xp2);
    fp2_neg(b, b);                       // w^2
    fp2_mul(c, lam_den, yp2);            // w^3
    out.c0.c0 = a;
    out.c0.c1 = b;
    out.c1.c1 = c;
}

static void miller_loop(Fp12 &f, const G2Aff &q, const Fp &xp, const Fp &yp) {
    fp12_one(f);
    G2Aff t = q;
    // iterate bits of |x| after the leading one
    bool lead = true;
    for (size_t i = 0; i < X_ABS_BE.size(); i++) {
        for (int b = 7; b >= 0; b--) {
            int bit = (X_ABS_BE[i] >> b) & 1;
            if (lead) {
                if (bit) lead = false;
                continue;
            }
            Fp12 l;
            fp12_sqr(f, f);
            line_eval(l, t, t, xp, yp);
            fp12_mul(f, f, l);
            g2aff_dbl(t, t);
            if (bit) {
                line_eval(l, t, q, xp, yp);
                fp12_mul(f, f, l);
                g2aff_add(t, t, q);
            }
        }
    }
    if (X_NEG) {
        Fp12 c;
        fp12_conj(c, f);
        f = c;
    }
}

// --------------------------------------------------------------------------
// Jacobian Miller loop (no per-step field inversions) + shared-squaring
// multi-pairing.  The affine loop above costs one Fp2 inversion (an Fp
// exponentiation, ~450 muls) per step — ~80% of the pairing; the Jacobian
// step is ~12 Fp2 muls.  Line values are scaled by Fp2 factors, which the
// final exponentiation kills (x^(p^6-1) = 1 for x in Fp2).  Exceptional
// cases (vertical line mid-loop, possible only for adversarial inputs)
// set a degenerate flag and the caller falls back to the affine loop.
// --------------------------------------------------------------------------

static inline void fp2_mul_fp(Fp2 &r, const Fp2 &a, const Fp &s) {
    fp_mul(r.c0, a.c0, s);
    fp_mul(r.c1, a.c1, s);
}

// x * (a, b, 0): 6 fp2 muls
static void fp6_mul_sp01(Fp6 &r, const Fp6 &x, const Fp2 &a, const Fp2 &b) {
    Fp2 t0, t1, t2, u;
    fp2_mul(t0, x.c0, a);
    fp2_mul(t1, x.c2, b);
    fp2_mul_xi(u, t1);
    fp2_add(r.c0, t0, u);        // x0 a + xi x2 b
    fp2_mul(t0, x.c0, b);
    fp2_mul(t1, x.c1, a);
    fp2_add(r.c1, t0, t1);       // x0 b + x1 a
    fp2_mul(t0, x.c1, b);
    fp2_mul(t2, x.c2, a);
    fp2_add(r.c2, t0, t2);       // x1 b + x2 a
}

// x * (0, c, 0): 3 fp2 muls
static void fp6_mul_sp1(Fp6 &r, const Fp6 &x, const Fp2 &c) {
    Fp2 t;
    fp2_mul(t, x.c2, c);
    Fp2 r1, r2;
    fp2_mul(r1, x.c0, c);
    fp2_mul(r2, x.c1, c);
    fp2_mul_xi(r.c0, t);
    r.c1 = r1;
    r.c2 = r2;
}

// f *= line(a + b w^2 + c w^3): Karatsuba with the sparse operand
// L = (L0=(a,b,0), L1=(0,c,0)) — 15 fp2 muls vs 18 for a full fp12_mul
static void fp12_mul_line(Fp12 &f, const Fp2 &a, const Fp2 &b, const Fp2 &c) {
    Fp6 t0, t1, s, f01, u;
    fp6_mul_sp01(t0, f.c0, a, b);
    fp6_mul_sp1(t1, f.c1, c);
    fp6_add(f01, f.c0, f.c1);
    Fp2 bc;
    fp2_add(bc, b, c);
    fp6_mul_sp01(s, f01, a, bc);
    fp6_sub(s, s, t0);
    fp6_sub(s, s, t1);
    fp6_mul_v(u, t1);
    fp6_add(f.c0, t0, u);
    f.c1 = s;
}

struct G2Jac {
    Fp2 X, Y, Z;
};

// T <- 2T; line coefficients scaled by Z_old^6 relative to the affine line
static void jac_dbl_step(G2Jac &T, Fp2 &la, Fp2 &lb, Fp2 &lc,
                         const Fp &xp, const Fp &yp) {
    Fp2 A, B, C, D, E, F, t, z2;
    fp2_sqr(A, T.X);                     // X^2
    fp2_sqr(B, T.Y);                     // Y^2
    fp2_sqr(C, B);                       // Y^4
    fp2_add(t, T.X, B);
    fp2_sqr(t, t);
    fp2_sub(t, t, A);
    fp2_sub(t, t, C);
    fp2_add(D, t, t);                    // 4 X Y^2
    fp2_add(E, A, A);
    fp2_add(E, E, A);                    // 3 X^2
    fp2_sqr(F, E);
    fp2_sqr(z2, T.Z);                    // Z_old^2
    // line: a = E*X - 2B ; b = -(E * Z^2) * xp ; c = (Z3 * Z^2) * yp
    Fp2 EX, twoB, EZ2;
    fp2_mul(EX, E, T.X);
    fp2_add(twoB, B, B);
    fp2_sub(la, EX, twoB);
    fp2_mul(EZ2, E, z2);
    fp2_mul_fp(lb, EZ2, xp);
    fp2_neg(lb, lb);
    Fp2 X3, Y3, Z3, eightC;
    fp2_sub(X3, F, D);
    fp2_sub(X3, X3, D);                  // F - 2D
    fp2_mul(Z3, T.Y, T.Z);
    fp2_add(Z3, Z3, Z3);                 // 2 Y Z
    fp2_sub(t, D, X3);
    fp2_mul(Y3, E, t);
    fp2_add(eightC, C, C);
    fp2_add(eightC, eightC, eightC);
    fp2_add(eightC, eightC, eightC);
    fp2_sub(Y3, Y3, eightC);             // E(D - X3) - 8C
    Fp2 Z3z2;
    fp2_mul(Z3z2, Z3, z2);
    fp2_mul_fp(lc, Z3z2, yp);
    T.X = X3;
    T.Y = Y3;
    T.Z = Z3;
}

// T <- T + Q (Q affine); line scaled by (Z_old * lambda) vs affine.
// Returns false on an exceptional case (T == +-Q): caller must fall back.
static bool jac_add_step(G2Jac &T, const G2Aff &q, Fp2 &la, Fp2 &lb, Fp2 &lc,
                         const Fp &xp, const Fp &yp) {
    Fp2 z2, z3, theta, lam, t;
    fp2_sqr(z2, T.Z);
    fp2_mul(z3, z2, T.Z);
    fp2_mul(t, q.y, z3);
    fp2_sub(theta, t, T.Y);              // yq Z^3 - Y
    fp2_mul(t, q.x, z2);
    fp2_sub(lam, t, T.X);                // xq Z^2 - X
    if (fp2_is_zero(lam)) return false;  // vertical or doubling: exceptional
    // line: a = theta*xq - (Z*lam)*yq ; b = -theta*xp ; c = (Z*lam)*yp
    Fp2 zl, u;
    fp2_mul(zl, T.Z, lam);
    fp2_mul(t, theta, q.x);
    fp2_mul(u, zl, q.y);
    fp2_sub(la, t, u);
    fp2_mul_fp(lb, theta, xp);
    fp2_neg(lb, lb);
    fp2_mul_fp(lc, zl, yp);
    Fp2 l2, l3, Xl2, X3, Y3;
    fp2_sqr(l2, lam);
    fp2_mul(l3, l2, lam);
    fp2_mul(Xl2, T.X, l2);
    fp2_sqr(t, theta);
    fp2_sub(t, t, l3);
    fp2_sub(t, t, Xl2);
    fp2_sub(X3, t, Xl2);                 // theta^2 - lam^3 - 2 X lam^2
    fp2_sub(t, Xl2, X3);
    fp2_mul(Y3, theta, t);
    fp2_mul(t, T.Y, l3);
    fp2_sub(Y3, Y3, t);                  // theta(X lam^2 - X3) - Y lam^3
    T.X = X3;
    T.Y = Y3;
    T.Z = zl;
    return true;
}

// shared-squaring product of n Miller loops; false -> exceptional case,
// caller must use the affine path
static bool multi_miller_jac(Fp12 &f, const std::vector<G2Aff> &qs,
                             const std::vector<Fp> &xps,
                             const std::vector<Fp> &yps) {
    size_t n = qs.size();
    fp12_one(f);
    std::vector<G2Jac> T(n);
    for (size_t i = 0; i < n; i++) {
        T[i].X = qs[i].x;
        T[i].Y = qs[i].y;
        memset(&T[i].Z, 0, sizeof(Fp2));
        T[i].Z.c0 = ONE_M;
    }
    Fp2 la, lb, lc;
    bool lead = true;
    for (size_t i = 0; i < X_ABS_BE.size(); i++) {
        for (int b = 7; b >= 0; b--) {
            int bit = (X_ABS_BE[i] >> b) & 1;
            if (lead) {
                if (bit) lead = false;
                continue;
            }
            fp12_sqr(f, f);
            for (size_t j = 0; j < n; j++) {
                jac_dbl_step(T[j], la, lb, lc, xps[j], yps[j]);
                fp12_mul_line(f, la, lb, lc);
            }
            if (bit) {
                for (size_t j = 0; j < n; j++) {
                    if (!jac_add_step(T[j], qs[j], la, lb, lc,
                                      xps[j], yps[j]))
                        return false;
                    fp12_mul_line(f, la, lb, lc);
                }
            }
        }
    }
    if (X_NEG) {
        Fp12 c;
        fp12_conj(c, f);
        f = c;
    }
    return true;
}

static void final_exponentiation(Fp12 &r, const Fp12 &f) {
    Fp12 fc, fi, f1, f2a, f2;
    fp12_conj(fc, f);
    fp12_inv(fi, f);
    fp12_mul(f1, fc, fi);                // f^(p^6 - 1)
    fp12_frobenius(f2a, f1);
    fp12_frobenius(f2a, f2a);
    fp12_mul(f2, f2a, f1);               // ^(p^2 + 1)
    fp12_pow_be(r, f2, HARD_EXP.data(), HARD_EXP.size());
}

// --------------------------------------------------------------------------
// C ABI
// --------------------------------------------------------------------------

extern "C" {

void bls446_init(const uint8_t *p56, const uint8_t *r2_56, u64 n0) {
    for (int i = 0; i < NL; i++) {
        u64 w = 0, w2 = 0;
        for (int j = 7; j >= 0; j--) {
            w = (w << 8) | p56[i * 8 + j];
            w2 = (w2 << 8) | r2_56[i * 8 + j];
        }
        P_MOD.v[i] = w;
        R2.v[i] = w2; // R2 arrives already reduced, raw (non-Montgomery) form
    }
    N0 = n0;
    // P_MINUS_2 = p - 2 (p is odd and > 2, no borrow past limb 0 structure)
    P_MINUS_2 = P_MOD;
    u64 borrow = 2;
    for (int i = 0; i < NL && borrow; i++) {
        u128 d = (u128)P_MINUS_2.v[i] - borrow;
        P_MINUS_2.v[i] = (u64)d;
        borrow = (u64)(d >> 64) & 1;
    }
    // Montgomery one = REDC(R2) = 2^448 mod p
    Fp one_raw;
    memset(&one_raw, 0, sizeof(one_raw));
    one_raw.v[0] = 1;
    fp_mul(ONE_M, one_raw, R2);
}

void bls446_g1_msm(const uint8_t *pts, const uint8_t *scalars, u64 n, uint8_t *out) {
    msm<Fp>(out, pts, scalars, n);
}

void bls446_g2_msm(const uint8_t *pts, const uint8_t *scalars, u64 n, uint8_t *out) {
    msm<Fp2>(out, pts, scalars, n);
}

void bls446_g1_powers(const uint8_t *base, const uint8_t *alpha, u64 count,
                      int64_t skip, uint8_t *out) {
    powers<Fp>(out, base, alpha, count, skip);
}

void bls446_g2_powers(const uint8_t *base, const uint8_t *alpha, u64 count,
                      int64_t skip, uint8_t *out) {
    powers<Fp2>(out, base, alpha, count, skip);
}

void bls446_g1_mul(const uint8_t *pt, const uint8_t *scalar, uint8_t *out) {
    Jac<Fp> p, r;
    point_from_bytes<Fp>(p, pt);
    jac_scalar_mul(r, p, scalar);
    point_to_bytes<Fp>(out, r);
}

void bls446_g2_mul(const uint8_t *pt, const uint8_t *scalar, uint8_t *out) {
    Jac<Fp2> p, r;
    point_from_bytes<Fp2>(p, pt);
    jac_scalar_mul(r, p, scalar);
    point_to_bytes<Fp2>(out, r);
}


void bls446_pairing_init(const uint8_t *gammas, const uint8_t *hard_be,
                         u64 hard_len, const uint8_t *x_be, u64 x_len,
                         int x_neg) {
    for (int i = 1; i <= 5; i++) f_from_bytes<Fp2>(GAMMA[i], gammas + (i - 1) * 112);
    HARD_EXP.assign(hard_be, hard_be + hard_len);
    X_ABS_BE.assign(x_be, x_be + x_len);
    X_NEG = x_neg;
}

void bls446_pairing(const uint8_t *p112, const uint8_t *q224, uint8_t *out672) {
    // infinity on either side -> 1
    bool p_inf = true, q_inf = true;
    for (int i = 0; i < 112; i++) if (p112[i]) { p_inf = false; break; }
    for (int i = 0; i < 224; i++) if (q224[i]) { q_inf = false; break; }
    Fp12 f;
    if (p_inf || q_inf) {
        fp12_one(f);
    } else {
        Fp xp, yp;
        fp_from_bytes(xp, p112);
        fp_from_bytes(yp, p112 + 56);
        G2Aff q;
        f_from_bytes<Fp2>(q.x, q224);
        f_from_bytes<Fp2>(q.y, q224 + 112);
        Fp12 m;
        std::vector<G2Aff> qs(1, q);
        std::vector<Fp> xps(1, xp), yps(1, yp);
        if (!multi_miller_jac(m, qs, xps, yps))
            miller_loop(m, q, xp, yp);   // exceptional input: affine path
        final_exponentiation(f, m);
    }
    const Fp2 *cs[6] = {&f.c0.c0, &f.c0.c1, &f.c0.c2,
                        &f.c1.c0, &f.c1.c1, &f.c1.c2};
    for (int i = 0; i < 6; i++) f_to_bytes<Fp2>(out672 + i * 112, *cs[i]);
}

// product of n pairings with ONE shared final exponentiation — the form
// every verification equation takes (prod e(P_i, Q_i) == 1 after moving the
// rhs across with negated G1 points).  ~halves per-pairing cost for the
// verifier (reference: pairing_check_two_steps, pke_v2/mod.rs:2545).
void bls446_pairing_product(const uint8_t *ps, const uint8_t *qs, u64 n,
                            uint8_t *out672) {
    std::vector<G2Aff> qv;
    std::vector<Fp> xv, yv;
    qv.reserve(n); xv.reserve(n); yv.reserve(n);
    for (u64 i = 0; i < n; i++) {
        const uint8_t *p112 = ps + i * 112;
        const uint8_t *q224 = qs + i * 224;
        bool p_inf = true, q_inf = true;
        for (int j = 0; j < 112; j++) if (p112[j]) { p_inf = false; break; }
        for (int j = 0; j < 224; j++) if (q224[j]) { q_inf = false; break; }
        if (p_inf || q_inf) continue;
        Fp xp, yp;
        fp_from_bytes(xp, p112);
        fp_from_bytes(yp, p112 + 56);
        G2Aff q;
        f_from_bytes<Fp2>(q.x, q224);
        f_from_bytes<Fp2>(q.y, q224 + 112);
        qv.push_back(q);
        xv.push_back(xp);
        yv.push_back(yp);
    }
    Fp12 acc;
    if (!multi_miller_jac(acc, qv, xv, yv)) {
        // exceptional input: per-pair affine loops (slow, always correct)
        fp12_one(acc);
        for (size_t i = 0; i < qv.size(); i++) {
            Fp12 m;
            miller_loop(m, qv[i], xv[i], yv[i]);
            fp12_mul(acc, acc, m);
        }
    }
    Fp12 f;
    final_exponentiation(f, acc);
    const Fp2 *cs[6] = {&f.c0.c0, &f.c0.c1, &f.c0.c2,
                        &f.c1.c0, &f.c1.c1, &f.c1.c2};
    for (int i = 0; i < 6; i++) f_to_bytes<Fp2>(out672 + i * 112, *cs[i]);
}

} // extern "C"
