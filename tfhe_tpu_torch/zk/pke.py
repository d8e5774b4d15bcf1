"""Zero-knowledge proof of correct compact-PKE encryption (pke v1 scheme).

Port of tfhe_tpu/zk/pke.py: the same CRS, proofs and verdicts from the
same inputs (host NumPy and Python bigints; no device work).

Faithful re-implementation of tfhe-zk-pok/src/proofs/pke/mod.rs over our own
BLS12-446 (zk/curve446.py): the prover shows knowledge of (r, e1, m, e2) with
bounded noise such that (c1, c2) is a well-formed compact-LWE encryption of m
under the public key (a, b) — the CPA-sanitization gate for untrusted client
inputs.  Structure (CRS with powers-of-alpha g-lists, bit-decomposition
commitment c_hat, y/theta/t/delta Fiat-Shamir challenges, pairing check, and
the optional ComputeLoad::Proof KZG-style fields) mirrors the reference
line by line; the Fiat-Shamir hash is SHAKE-256 (we do not need proof-level
byte compatibility — both ends are this framework).

Proof sizes/perf: pure-Python bigints; polynomial products use Kronecker
substitution (pack into one huge int, one multiply) so prove() stays
polynomial-practical at production sizes.
"""

from __future__ import annotations

import hashlib
import secrets
from dataclasses import dataclass

from . import curve446 as cv

R = cv.R

HASH_DS = {
    "hash": b"PKEv1/hash",
    "hash_t": b"PKEv1/hash_t",
    "hash_agg": b"PKEv1/hash_agg",
    "hash_lmap": b"PKEv1/hash_lmap",
    "hash_z": b"PKEv1/hash_z",
    "hash_w": b"PKEv1/hash_w",
    "hash_gamma": b"PKEv1/hash_gamma",
}


# ---------------------------------------------------------------------------
# Fiat-Shamir hashing (SHAKE-256 -> Zp), element serialization
# ---------------------------------------------------------------------------


def _zp_bytes(x: int) -> bytes:
    return int(x % R).to_bytes(40, "little")


def _g1_bytes(p) -> bytes:
    if p is None:
        return b"\x00" * 112
    return int(p[0]).to_bytes(56, "little") + int(p[1]).to_bytes(56, "little")


def _g2_bytes(p) -> bytes:
    if p is None:
        return b"\x00" * 224
    (x0, x1), (y0, y1) = p
    return b"".join(int(v).to_bytes(56, "little") for v in (x0, x1, y0, y1))


def _g1_from_bytes(b: bytes):
    if b == b"\x00" * 112:
        return None
    return (int.from_bytes(b[:56], "little"), int.from_bytes(b[56:], "little"))


def _g2_from_bytes(b: bytes):
    if b == b"\x00" * 224:
        return None
    v = [int.from_bytes(b[56 * i : 56 * (i + 1)], "little") for i in range(4)]
    return ((v[0], v[1]), (v[2], v[3]))


def hash_to_zp(count: int, *chunks: bytes) -> list:
    h = hashlib.shake_256()
    for c in chunks:
        h.update(len(c).to_bytes(8, "little"))
        h.update(c)
    raw = h.digest(48 * count)
    return [int.from_bytes(raw[48 * i : 48 * (i + 1)], "little") % R
            for i in range(count)]


def hash_128bit(count: int, *chunks: bytes) -> list:
    h = hashlib.shake_256()
    for c in chunks:
        h.update(len(c).to_bytes(8, "little"))
        h.update(c)
    raw = h.digest(16 * count)
    return [int.from_bytes(raw[16 * i : 16 * (i + 1)], "little")
            for i in range(count)]


# ---------------------------------------------------------------------------
# Zp polynomial products via Kronecker substitution
# ---------------------------------------------------------------------------


def poly_mul_zp(a: list, b: list) -> list:
    """Coefficient product over Zp. Packs into one bigint multiply
    (Kronecker substitution): slot width covers max coeff product sum
    (len * R^2).  Packing/unpacking goes through bytes — building the
    packed ints by shift-accumulate and slicing results with `>>` is
    O(n^2) in the bigint length and dominated the prover."""
    from . import gmp_bigint

    n_out = len(a) + len(b) - 1
    slot = (2 * R.bit_length() + max(len(a), len(b)).bit_length() + 7) // 8 * 8
    sb = slot // 8
    a_bytes = b"".join(int(c).to_bytes(sb, "little") for c in a)
    b_bytes = b"".join(int(c).to_bytes(sb, "little") for c in b)
    out_len = sb * (len(a) + len(b))
    if gmp_bigint.available():
        # GMP's Toom/FFT multiply is 10-30x CPython's Karatsuba at the
        # prover's ~1 MB Kronecker operand sizes
        C = gmp_bigint.mul_bytes(a_bytes, b_bytes, out_len)
    else:
        A = int.from_bytes(a_bytes, "little")
        B = int.from_bytes(b_bytes, "little")
        C = (A * B).to_bytes(out_len, "little")
    return [int.from_bytes(C[sb * i:sb * (i + 1)], "little") % R
            for i in range(n_out)]


def poly_sub_zp(a: list, b: list) -> list:
    n = max(len(a), len(b))
    a = a + [0] * (n - len(a))
    b = b + [0] * (n - len(b))
    return [(x - y) % R for x, y in zip(a, b)]


# ---------------------------------------------------------------------------
# CRS
# ---------------------------------------------------------------------------


def compute_crs_params(d: int, k: int, b: int, q: int, t: int,
                       msbs_zero_padding_bit_count: int):
    """pke/mod.rs:581."""
    b_r = d // 2 + 1
    t_eff = t >> msbs_zero_padding_bit_count
    big_d = (d + k * (t_eff.bit_length() - 1)
             + (d + k) * (2 + (b.bit_length() - 1) + (b_r.bit_length() - 1)))
    return big_d + 1, big_d, b_r


@dataclass
class PublicParams:
    g_list: list      # 2n G1 affine points (index n is the zero point)
    g_hat_list: list  # n G2 affine points
    big_d: int
    n: int
    d: int
    k: int
    b: int
    b_r: int
    q: int
    t: int
    msbs_zero_padding_bit_count: int
    sid: int

    def exclusive_max_noise(self) -> int:
        return self.b


def crs_gen(d: int, k: int, b: int, q: int, t: int,
            msbs_zero_padding_bit_count: int, seed: int | None = None) -> PublicParams:
    """Powers-of-alpha CRS (proofs/mod.rs:121 GroupElements::new)."""
    alpha = (secrets.randbelow(R - 1) + 1) if seed is None else (
        hash_to_zp(1, b"crs", seed.to_bytes(16, "little"))[0] or 1)
    n, big_d, b_r = compute_crs_params(d, k, b, q, t, msbs_zero_padding_bit_count)
    g_list = cv.g1_powers(cv.G1_GEN, alpha, 2 * n, skip=n)  # hole at alpha^(n+1)
    g_hat_list = cv.g2_powers(cv.G2_GEN, alpha, n)
    sid = (secrets.randbits(128) if seed is None
           else hash_128bit(1, b"sid", seed.to_bytes(16, "little"))[0])
    return PublicParams(g_list, g_hat_list, big_d, n, d, k, b, b_r, q, t,
                        msbs_zero_padding_bit_count, sid)


# ---------------------------------------------------------------------------
# Commitments (public = the ciphertext; private = the encryption randomness)
# ---------------------------------------------------------------------------


@dataclass
class PublicCommit:
    a: list   # d i64 (public key mask poly)
    b: list   # d i64 (public key body poly)
    c1: list  # d i64 (ciphertext mask)
    c2: list  # k i64 (ciphertext bodies)


@dataclass
class PrivateCommit:
    r: list   # d binary
    e1: list  # d bounded noise
    m: list   # k messages
    e2: list  # k bounded noise


@dataclass
class Proof:
    c_hat: tuple
    c_y: tuple
    pi: tuple
    c_hat_t: tuple | None = None
    c_h: tuple | None = None
    pi_kzg: tuple | None = None


def _bit_iter(x: int, nbits: int):
    x &= (1 << 64) - 1
    for i in range(nbits):
        yield (x >> i) & 1


def _decode_q(q: int) -> int:
    return 1 << 64 if q == 0 else q


def _i16_pieces(vals, n_pieces: int):
    """Centered ints -> balanced 16-bit piece rows (np.int64)."""
    import numpy as _np

    rows = []
    cur = list(vals)
    for _ in range(n_pieces):
        le = [((v + 0x8000) & 0xFFFF) - 0x8000 for v in cur]
        rows.append(_np.asarray(le, dtype=_np.int64))
        cur = [(v - l) >> 16 for v, l in zip(cur, le)]
    assert all(v == 0 for v in cur), "piece count too small"
    return rows


def compute_r1(e1, c1, a, r, d, decoded_q):
    """proofs/mod.rs:235 — exact division by q of the mask relation.

    The negacyclic a*rot(r) term is 5 exact int64 convolutions (binary r,
    16-bit pieces of a) instead of an O(d^2) Python loop."""
    import numpy as _np

    rr = _np.asarray([r[d - 1 - j] for j in range(d)], dtype=_np.int64)
    conv_groups = []
    for p, ap in enumerate(_i16_pieces(a, 5)):
        cv = _np.convolve(ap, rr)                       # len 2d-1
        neg = _np.zeros(d, dtype=_np.int64)
        neg[: d - 1] = cv[d:]
        conv_groups.append((p, cv[:d] - neg))
    r1 = [e1[i] - c1[i] for i in range(d)]
    for p, g in conv_groups:
        sh = 16 * p
        for i in _np.nonzero(g)[0]:
            r1[int(i)] += int(g[i]) << sh
    return [v // decoded_q for v in r1]


def compute_r2(e2, c2, m, b, r, d, delta, decoded_q):
    """proofs/mod.rs:275 — same vectorization for the body relation."""
    import numpy as _np

    k = len(c2)
    rr = _np.asarray([r[d - 1 - j] for j in range(d)], dtype=_np.int64)
    # dot_i = sum_j rr[j] * bs[i + j], bs[w] = b[d-1-w] (w<d), -b[2d-1-w]
    bs = [b[d - 1 - w] for w in range(d)] + \
         [-b[2 * d - 1 - w] for w in range(d, d + k - 1)]
    dots = [0] * k
    for p, bp in enumerate(_i16_pieces(bs, 5)):
        cv = _np.convolve(bp[::-1], rr)   # corr[i] = cv[len(bs)-1-i]
        sh = 16 * p
        for i in range(k):
            t = int(cv[len(bs) - 1 - i])
            if t:
                dots[i] += t << sh
    return [(delta * m[i] + e2[i] - c2[i] + dots[i]) // decoded_q
            for i in range(k)]


def _kron_conv_window(kern, vals, start, count, stride_bits):
    """Coefficients [start, start+count) of conv(kern, vals) via ONE GMP
    Kronecker-substitution bigint product per sign half.  kern: signed
    ints; vals: non-negative ints; every conv coefficient of each half
    must be < 2^stride_bits (no digit carry)."""
    from . import gmp_bigint as _g

    assert stride_bits % 8 == 0
    sb = stride_bits // 8
    vbytes = b"".join(int(v).to_bytes(sb, "little") for v in vals)
    zero = bytes(sb)
    halves = []
    for pos in (True, False):
        kb = b"".join(
            int(v if pos else -v).to_bytes(sb, "little")
            if (v > 0) == pos and v != 0 else zero
            for v in kern)
        # mul_bytes exports the FULL product; size the buffer accordingly
        prod = _g.mul_bytes(kb, vbytes, sb * (len(kern) + len(vals)))
        halves.append([int.from_bytes(
            prod[(start + i) * sb:(start + i + 1) * sb], "little")
            for i in range(count)])
    return [p - q for p, q in zip(halves[0], halves[1])]


def a_theta_head(theta1, theta2, a, b, d, k):
    """The rot(a).T/rot(b).T head block shared by pke v1 and pke_v2:
    head[i] = (sum_{j>=i} a[j-i] th1[j] - sum_{j<i} a[d+j-i] th1[j]
               + sum_j ±b[...] th2[j]) mod R, vectorized as exact int64
    correlations (theta split into 14 u32 limbs, kernels into 5 balanced
    16-bit pieces; |conv sums| < 2d * 2^15 * 2^32 < 2^60).  With GMP
    available the two convolutions run as Kronecker-substitution bigint
    products instead (~10x; the verifier's critical path)."""
    from . import gmp_bigint as _g

    if _g.available():
        return _a_theta_head_gmp(theta1, theta2, a, b, d, k)
    return _a_theta_head_np(theta1, theta2, a, b, d, k)


def _a_theta_head_gmp(theta1, theta2, a, b, d, k):
    """Kronecker path: conv coefficients are |.| < 2d * 2^63 * R < 2^523;
    stride 528 bits.  Signed kernels split into positive halves (two GMP
    products per convolution)."""
    kern = [-a[d + t] for t in range(-(d - 1), 0)] + list(a)
    bs = [b[d - 1 - w] for w in range(d)] + \
         [-b[2 * d - 1 - w] for w in range(d, d + k - 1)]
    stride = 528                     # > log2(2d * 2^63 * R) ~ 521
    g1 = _kron_conv_window(kern[::-1], theta1, d - 1, d, stride)
    g2r = _kron_conv_window(bs[::-1], theta2, k - 1, d, stride)
    return [(g1[i] + g2r[d - 1 - i]) % R for i in range(d)]


def _a_theta_head_np(theta1, theta2, a, b, d, k):
    import numpy as _np

    NL = 14
    th1 = [_np.asarray([(v >> (32 * l)) & 0xFFFFFFFF for v in theta1],
                       dtype=_np.int64) for l in range(NL)]
    th2 = [_np.asarray([(v >> (32 * l)) & 0xFFFFFFFF for v in theta2],
                       dtype=_np.int64) for l in range(NL)]
    kern = [-a[d + t] for t in range(-(d - 1), 0)] + list(a)
    bs = [b[d - 1 - w] for w in range(d)] + \
         [-b[2 * d - 1 - w] for w in range(d, d + k - 1)]
    kp = _i16_pieces(kern, 5)
    bp = _i16_pieces(bs, 5)
    buckets = [None] * (5 + 2 * NL - 1)
    for p in range(5):
        kr = kp[p][::-1]
        br = bp[p][::-1]
        for l in range(NL):
            g = _np.convolve(kr, th1[l])[d - 1:2 * d - 1]
            g = g + _np.convolve(br, th2[l])[k - 1:d + k - 1][::-1]
            w = p + 2 * l
            buckets[w] = g if buckets[w] is None else buckets[w] + g
    gs = [[int(x) for x in bk] if bk is not None else None for bk in buckets]
    head = [0] * d
    for i in range(d):
        acc = 0
        for w, bk in enumerate(gs):
            if bk is not None:
                acc += bk[i] << (16 * w)
        head[i] = acc % R
    return head


def _compute_a_theta(theta0, d, a, k, b, big_d, t_eff, delta, b_i, b_r, decoded_q):
    """pke/mod.rs:1046 compute_a_theta — the linear map A~.T applied to the
    theta challenge, laid out to match the w bit vector."""
    theta1 = theta0[:d]
    theta2 = theta0[d:]
    q = decoded_q % R
    a_theta = [0] * big_d
    a_theta[:d] = a_theta_head(theta1, theta2, a, b, d, k)
    off = d
    step = t_eff.bit_length() - 1
    for i in range(k):
        for j in range(step):
            a_theta[off + step * i + j] = delta * (1 << j) % R * theta2[i] % R
    off += k * step
    step = 1 + (b_i.bit_length() - 1)
    for i in range(d):
        for j in range(step):
            v = (1 << j) * theta1[i] % R
            a_theta[off + step * i + j] = (-v) % R if j == step - 1 else v
    off += d * step
    for i in range(k):
        for j in range(step):
            v = (1 << j) * theta2[i] % R
            a_theta[off + step * i + j] = (-v) % R if j == step - 1 else v
    off += k * step
    step = 1 + (b_r.bit_length() - 1)
    for i in range(d):
        for j in range(step):
            v = (-q) * (1 << j) % R * theta1[i] % R
            a_theta[off + step * i + j] = (-v) % R if j == step - 1 else v
    off += d * step
    for i in range(k):
        for j in range(step):
            v = (-q) * (1 << j) % R * theta2[i] % R
            a_theta[off + step * i + j] = (-v) % R if j == step - 1 else v
    return a_theta


def _x_bytes(pp: PublicParams, pc: PublicCommit) -> bytes:
    def i64s(v):
        return b"".join(int(x & ((1 << 64) - 1)).to_bytes(8, "little") for x in v)

    return (int(pp.q).to_bytes(8, "little") + int(pp.d).to_bytes(8, "little")
            + int(pp.b).to_bytes(8, "little") + int(pp.t).to_bytes(8, "little")
            + int(pp.msbs_zero_padding_bit_count).to_bytes(8, "little")
            + i64s(pc.a) + i64s(pc.b) + i64s(pc.c1) + i64s(pc.c2))


def _challenges_y_theta_t_delta(pp, x_bytes, metadata, c_hat, c_y):
    sid = pp.sid.to_bytes(16, "little")
    y = hash_to_zp(pp.n, HASH_DS["hash"], sid, metadata, x_bytes, _g2_bytes(c_hat))
    theta = hash_to_zp(pp.d + pp.k + 1, HASH_DS["hash_lmap"], sid, metadata,
                       x_bytes, _g2_bytes(c_hat), _g1_bytes(c_y))
    y_bytes = b"".join(_zp_bytes(v) for v in y)
    t = hash_128bit(pp.n, HASH_DS["hash_t"], sid, metadata, y_bytes, x_bytes,
                    _g2_bytes(c_hat), _g1_bytes(c_y))
    delta = hash_to_zp(2, HASH_DS["hash_agg"], sid, metadata, x_bytes,
                       _g2_bytes(c_hat), _g1_bytes(c_y))
    return y, theta, t, delta


def prove(pp: PublicParams, pc: PublicCommit, priv: PrivateCommit,
          metadata: bytes = b"", load: str = "proof",
          seed: bytes | None = None) -> Proof:
    d, k, n, big_d = pp.d, len(pc.c2), pp.n, None
    b_i, b_r = pp.b, pp.b_r
    t_eff = pp.t >> pp.msbs_zero_padding_bit_count
    decoded_q = _decode_q(pp.q)
    delta_enc = decoded_q // pp.t
    big_d = (d + k * (t_eff.bit_length() - 1)
             + (d + k) * (2 + (b_i.bit_length() - 1) + (b_r.bit_length() - 1)))
    assert big_d <= pp.big_d
    if seed is None:
        seed = secrets.token_bytes(32)
    gamma, gamma_y = hash_to_zp(2, HASH_DS["hash_gamma"], seed)

    r1 = compute_r1(priv.e1, pc.c1, pc.a, priv.r, d, decoded_q)
    r2 = compute_r2(priv.e2, pc.c2, priv.m, pc.b, priv.r, d, delta_enc, decoded_q)

    # the witness bit vector w (pke/mod.rs:739)
    bits = []
    for rv in reversed(priv.r):
        bits.extend(_bit_iter(rv, 1))
    for mv in priv.m:
        bits.extend(_bit_iter(mv, t_eff.bit_length() - 1))
    for ev in priv.e1:
        bits.extend(_bit_iter(ev, 1 + b_i.bit_length() - 1))
    for ev in priv.e2:
        bits.extend(_bit_iter(ev, 1 + b_i.bit_length() - 1))
    for rv in r1:
        bits.extend(_bit_iter(rv, 1 + b_r.bit_length() - 1))
    for rv in r2:
        bits.extend(_bit_iter(rv, 1 + b_r.bit_length() - 1))
    w = bits + [0] * (n - len(bits))
    assert len(bits) == big_d

    g_list, g_hat_list = pp.g_list, pp.g_hat_list

    c_hat = cv.g2_mul(cv.G2_GEN, gamma)
    for j in range(big_d):
        if w[j]:
            c_hat = cv.g2_add(c_hat, g_hat_list[j])

    x_bytes = _x_bytes(pp, pc)
    y, theta, t, delta2 = _challenges_y_theta_t_delta(pp, x_bytes, metadata, c_hat, None)
    # c_y depends on y only (c_y not yet known when hashing y)
    scalars = [y[big_d - 1 - i] * w[big_d - 1 - i] % R for i in range(big_d)]
    c_y = cv.g1_add(cv.g1_mul(cv.G1_GEN, gamma_y),
                    cv.msm_g1(g_list[n - big_d : n], scalars))
    # re-derive theta/t/delta now that c_y exists (y is c_y-independent)
    _, theta, t, delta2 = _challenges_y_theta_t_delta(pp, x_bytes, metadata, c_hat, c_y)
    theta0 = theta[: d + k]
    delta_theta = theta[d + k]
    delta_eq, delta_y = delta2

    a_theta = _compute_a_theta(theta0, d, pc.a, k, pc.b, big_d, t_eff,
                               delta_enc, b_i, b_r, decoded_q)

    # poly_0..poly_3 (pke/mod.rs:867)
    poly_0 = [0] * (n + 1)
    poly_1 = [0] * (big_d + 1)
    poly_2 = [0] * (n + 1)
    poly_3 = [0] * (n + 1)
    poly_0[0] = delta_y * gamma_y % R
    for i in range(1, n + 1):
        v = (delta_y * (y[i - 1] * w[i - 1]) + (delta_eq * t[i - 1] - delta_y) * y[i - 1]) % R
        if i < big_d + 1:
            v = (v + delta_theta * a_theta[i - 1]) % R
        poly_0[n + 1 - i] = v
    poly_1[0] = gamma
    for i in range(1, big_d + 1):
        poly_1[i] = w[i - 1]
    poly_2[0] = gamma_y
    for i in range(1, big_d + 1):
        poly_2[n + 1 - i] = y[i - 1] * w[i - 1] % R
    for i in range(1, n + 1):
        poly_3[i] = delta_eq * t[i - 1] % R

    t_theta = 0
    for i in range(d):
        t_theta += theta0[i] * pc.c1[i]
    for i in range(k):
        t_theta += theta0[d + i] * pc.c2[i]
    t_theta %= R

    poly = poly_sub_zp(poly_mul_zp(poly_0, poly_1), poly_mul_zp(poly_2, poly_3))
    if len(poly) > n + 1:
        poly[n + 1] = (poly[n + 1] - t_theta * delta_theta) % R

    pi = cv.g1_add(cv.g1_mul(cv.G1_GEN, poly[0]),
                   cv.msm_g1(g_list[: len(poly) - 1], poly[1:]))

    if load != "proof":
        return Proof(c_hat, c_y, pi)

    c_hat_t = cv.msm_g2(g_hat_list, t)
    scalars = []
    for i in range(1, n + 1):
        ii = n + 1 - i
        v = (delta_eq * t[ii - 1] - delta_y) * y[ii - 1] % R
        if ii < big_d + 1:
            v = (v + delta_theta * a_theta[ii - 1]) % R
        scalars.append(v)
    c_h = cv.msm_g1(g_list[:n], scalars)

    sid = pp.sid.to_bytes(16, "little")
    y_bytes = b"".join(_zp_bytes(v) for v in y)
    t_bytes = b"".join(_zp_bytes(v) for v in t)
    delta_bytes = b"".join(_zp_bytes(v) for v in (delta_eq, delta_y, delta_theta))
    z = hash_to_zp(1, HASH_DS["hash_z"], sid, metadata, x_bytes, _g2_bytes(c_hat),
                   _g1_bytes(c_y), _g1_bytes(pi), _g1_bytes(c_h), _g2_bytes(c_hat_t),
                   y_bytes, t_bytes, delta_bytes)[0]

    pow_, p_t, p_h = z, 0, 0
    for i in range(1, n + 1):
        p_t = (p_t + t[i - 1] * pow_) % R
        hterm = (delta_eq * t[n - i] - delta_y) * y[n - i] % R
        if n - i < big_d:
            hterm = (hterm + delta_theta * a_theta[n - i]) % R
        p_h = (p_h + hterm * pow_) % R
        pow_ = pow_ * z % R

    w_chal = hash_to_zp(1, HASH_DS["hash_w"], sid, metadata, x_bytes,
                        _g2_bytes(c_hat), _g1_bytes(c_y), _g1_bytes(pi),
                        _g1_bytes(c_h), _g2_bytes(c_hat_t), y_bytes, t_bytes,
                        delta_bytes, _zp_bytes(z), _zp_bytes(p_h), _zp_bytes(p_t))[0]

    poly = [0] * (n + 1)
    for i in range(1, n + 1):
        poly[i] = (poly[i] + w_chal * t[i - 1]) % R
        hterm = (delta_eq * t[i - 1] - delta_y) * y[i - 1] % R
        if i < big_d + 1:
            hterm = (hterm + delta_theta * a_theta[i - 1]) % R
        poly[n + 1 - i] = (poly[n + 1 - i] + hterm) % R
    qpoly = [0] * n
    for i in reversed(range(n)):
        poly[i] = (poly[i] + z * poly[i + 1]) % R
        qpoly[i] = poly[i + 1]
        poly[i + 1] = 0
    pi_kzg = cv.g1_add(cv.g1_mul(cv.G1_GEN, qpoly[0]),
                       cv.msm_g1(g_list[: n - 1], qpoly[1:n]))
    return Proof(c_hat, c_y, pi, c_hat_t, c_h, pi_kzg)


def _gt_mul(a, b):
    return cv.f12_mul(a, b)


def _gt_div(a, b):
    return cv.f12_mul(a, cv.f12_inv(b))


def verify(proof: Proof, pp: PublicParams, pc: PublicCommit,
           metadata: bytes = b"") -> bool:
    d, n = pp.d, pp.n
    k = len(pc.c2)
    if k > pp.k or len(pc.a) != d or len(pc.b) != d or len(pc.c1) != d:
        return False
    b_i, b_r = pp.b, pp.b_r
    t_eff = pp.t >> pp.msbs_zero_padding_bit_count
    decoded_q = _decode_q(pp.q)
    delta_enc = decoded_q // pp.t
    big_d = (d + k * (t_eff.bit_length() - 1)
             + (d + k) * (2 + (b_i.bit_length() - 1) + (b_r.bit_length() - 1)))
    if big_d > pp.big_d:
        return False

    x_bytes = _x_bytes(pp, pc)
    y, theta, t, delta2 = _challenges_y_theta_t_delta(pp, x_bytes, metadata,
                                                      proof.c_hat, proof.c_y)
    theta0 = theta[: d + k]
    delta_theta = theta[d + k]
    delta_eq, delta_y = delta2
    a_theta = _compute_a_theta(theta0, d, pc.a, k, pc.b, big_d, t_eff,
                               delta_enc, b_i, b_r, decoded_q)
    t_theta = 0
    for i in range(d):
        t_theta += theta0[i] * pc.c1[i]
    for i in range(k):
        t_theta += theta0[d + i] * pc.c2[i]
    t_theta %= R

    g_list, g_hat_list = pp.g_list, pp.g_hat_list
    e = cv.pairing

    if proof.c_hat_t is not None:
        sid = pp.sid.to_bytes(16, "little")
        y_bytes = b"".join(_zp_bytes(v) for v in y)
        t_bytes = b"".join(_zp_bytes(v) for v in t)
        delta_bytes = b"".join(_zp_bytes(v) for v in (delta_eq, delta_y, delta_theta))
        z = hash_to_zp(1, HASH_DS["hash_z"], sid, metadata, x_bytes,
                       _g2_bytes(proof.c_hat), _g1_bytes(proof.c_y),
                       _g1_bytes(proof.pi), _g1_bytes(proof.c_h),
                       _g2_bytes(proof.c_hat_t), y_bytes, t_bytes, delta_bytes)[0]
        pow_, p_t, p_h = z, 0, 0
        for i in range(1, n + 1):
            p_t = (p_t + t[i - 1] * pow_) % R
            hterm = (delta_eq * t[n - i] - delta_y) * y[n - i] % R
            if n - i < big_d:
                hterm = (hterm + delta_theta * a_theta[n - i]) % R
            p_h = (p_h + hterm * pow_) % R
            pow_ = pow_ * z % R

        lhs = e(proof.pi, cv.G2_GEN)
        rhs = e(cv.g1_add(cv.g1_mul(proof.c_y, delta_y), proof.c_h), proof.c_hat)
        rhs = _gt_div(rhs, e(cv.g1_mul(proof.c_y, delta_eq), proof.c_hat_t))
        rhs = _gt_div(rhs, cv.f12_pow(e(g_list[0], g_hat_list[n - 1]),
                                      t_theta * delta_theta % R))
        if lhs != rhs:
            return False

        w_chal = hash_to_zp(1, HASH_DS["hash_w"], sid, metadata, x_bytes,
                            _g2_bytes(proof.c_hat), _g1_bytes(proof.c_y),
                            _g1_bytes(proof.pi), _g1_bytes(proof.c_h),
                            _g2_bytes(proof.c_hat_t), y_bytes, t_bytes,
                            delta_bytes, _zp_bytes(z), _zp_bytes(p_h),
                            _zp_bytes(p_t))[0]
        lhs2 = _gt_mul(
            e(cv.g1_add(proof.c_h, cv.g1_neg(cv.g1_mul(cv.G1_GEN, p_h))), cv.G2_GEN),
            cv.f12_pow(e(cv.G1_GEN, cv.g2_add(proof.c_hat_t,
                                              cv.g2_neg(cv.g2_mul(cv.G2_GEN, p_t)))),
                       w_chal))
        rhs2 = e(proof.pi_kzg,
                 cv.g2_add(g_hat_list[0], cv.g2_neg(cv.g2_mul(cv.G2_GEN, z))))
        return lhs2 == rhs2

    # ComputeLoad::Verify branch — one aggregated equation
    scalars = []
    for i in range(1, n + 1):
        v = (delta_eq * t[i - 1] - delta_y) * y[i - 1] % R
        if i < big_d + 1:
            v = (v + delta_theta * a_theta[i - 1]) % R
        scalars.append(v)
    p = cv.g1_add(cv.g1_mul(proof.c_y, delta_y),
                  cv.msm_g1([g_list[n - i] for i in range(1, n + 1)], scalars))
    term0 = e(p, proof.c_hat)
    q_pt = cv.msm_g2(g_hat_list, [delta_eq * t[i] % R for i in range(n)])
    term1 = e(proof.c_y, q_pt)
    term2 = cv.f12_pow(e(g_list[0], g_hat_list[n - 1]), t_theta * delta_theta % R)
    lhs = e(proof.pi, cv.G2_GEN)
    rhs = _gt_div(_gt_div(term0, term1), term2)
    return lhs == rhs
