"""Zero-knowledge proof of correct compact-PKE encryption (pke_v2 scheme).

Port of tfhe_tpu/zk/pke_v2.py: the same CRS, proofs and verdicts from the
same inputs (host NumPy and Python bigints; no device work).

Re-implementation of the protocol of tfhe-zk-pok/src/proofs/pke_v2/mod.rs
(prove :1095, verify :2224) over our BLS12-446 (zk/curve446.py).  pke_v2 is
the reference's default proof system: compared with pke v1 it commits to the
noise vector with a *norm bound* proof (Lagrange four-square decomposition +
a 128-row random-sketch matrix R) instead of bit-decomposing every noise
coefficient, which shrinks the CRS (n = D + 128*m instead of bit-width-of-
everything) and the proof.

Protocol shape (same commitment/challenge sequence as the reference):
  C_hat_e/C_e  dual commitments to (e1, e2, v) where v = four_squares(B^2-|e|^2)
  C_r_tilde    commitment to (r1, r2), the exact-division witnesses
  R            Fiat-Shamir ternary sketch matrix (128 x (2(d+k)+4))
  C_R          commitment to w_R = R.(e1,e2,v,r1,r2)
  C_hat_bin    commitment to the bit vector (r reversed | m bits | w_R bits)
  C_y, C_h1, C_h2, C_hat_t, pi   the aggregated Schwartz-Zippel identity
  pi_kzg       KZG opening of the batched polynomial at z
Verification: two pairing-product equations (eq. (50)/(51) of the reference
paper; pairing_check_two_steps at pke_v2/mod.rs:2545).

Fiat-Shamir is SHAKE-256 over the running transcript (we do not need
proof-level byte compatibility with the Rust build - both ends are this
framework; the *math* is the same).
"""

from __future__ import annotations

import math
import random
import secrets
from dataclasses import dataclass

import numpy as np

from . import curve446 as cv
from .pke import (PrivateCommit, PublicCommit, _bit_iter, _decode_q,
                  _g1_bytes, _g2_bytes, _zp_bytes, compute_r1, compute_r2,
                  hash_128bit, hash_to_zp, poly_mul_zp)

R = cv.R

GHL, CS = "GHL", "CS"


# ---------------------------------------------------------------------------
# Lagrange four-square decomposition (four_squares.rs:193, Rabin-Shallit)
# ---------------------------------------------------------------------------


def _sqrt_minus_one(p: int, rng: random.Random):
    """One Miller-Rabin-style round: returns a square root of -1 mod p if the
    round both witnesses p prime and passes through -1, else None."""
    d, s = p - 1, 0
    while d % 2 == 0:
        d //= 2
        s += 1
    a = 2 + rng.randrange(p - 3)
    x = pow(a, d, p)
    sqrt = 0
    y = 0
    one, neg_one = 1, p - 1
    for _ in range(s):
        y = x * x % p
        if y == one and x != one and x != neg_one:
            return None  # composite
        if y == neg_one:
            sqrt = x
        x = y
    if y != one or sqrt == 0:
        return None
    return sqrt


def four_squares(v: int) -> list:
    """v = a^2 + b^2 + c^2 + d^2 with non-negative integers."""
    if v < 0:
        raise ValueError("four_squares of negative value")
    if v == 0:
        return [0, 0, 0, 0]
    if v == 2:
        return [1, 1, 0, 0]
    if v == 6:
        return [2, 1, 1, 0]
    f = v % 4
    if f == 0:
        return [2 * x for x in four_squares(v // 4)]
    if f != 2:
        # v odd: decompose 2v (which is = 2 mod 4) and recombine
        r = sorted(four_squares(2 * v), key=lambda x: (x % 2 != 0, x))
        ev0, ev1, od0, od1 = r  # two even then two odd
        return [(ev1 + ev0) // 2, (ev1 - ev0) // 2,
                (od1 + od0) // 2, (od1 - od0) // 2]
    # v = 2 mod 4: randomized search for v - x^2 - y^2 prime = 1 mod 4
    rng = random.Random(0)  # deterministic like the reference (StdRng seed 0)
    b = math.isqrt(v)
    sq_cache = {}
    while True:
        x = rng.randint(0, b)
        y = rng.randint(0, b)
        s = x * x + y * y
        if s > v:
            continue
        p = v - s
        if p in (0, 1):
            return [0, p, x, y]
        if p % 4 != 1:
            continue
        i = _sqrt_minus_one(p, rng)
        if i is None:
            continue
        if i <= p // 2:
            i = p - i
        # half-gcd: descend Euclid until the remainder is <= sqrt(p)
        sq_p = math.isqrt(p)
        a_, b_ = p, i
        while b_ > sq_p:
            a_, b_ = b_, a_ % b_
        z = b_
        w = math.isqrt(p - z * z)
        if p != z * z + w * w:
            continue
        return [x, y, z, w]


# ---------------------------------------------------------------------------
# CRS (pke_v2/mod.rs:897 compute_crs_params, :997 crs_gen_cs)
# ---------------------------------------------------------------------------


def _ceil_ilog2(v: int) -> int:
    return (v - 1).bit_length() if v > 1 else 0


def _bound_factor(bound_type: str, d: int, k: int) -> int:
    if bound_type == GHL:
        return 950625  # 9.75^2 scaled by 10^4 (divided back below)
    return 2 * (d + k) + 4


def inf_norm_bound_to_euclidean_squared(b_inf: int, dim: int) -> int:
    return b_inf * b_inf * dim


def compute_crs_params(d: int, k: int, b_squared: int, t: int,
                       msbs_zero_padding_bit_count: int, bound_type: str):
    """Returns (n, D, B_bound_squared, m)."""
    assert k <= d, "zk pke_v2 requires k <= d"
    bb = _bound_factor(bound_type, d, k) * (
        b_squared + ((d + 2) ** 2 * (d + k)) // 4)
    if bound_type == GHL:
        bb = -(-bb // 10000)
    m_bound = 1 + -(-_ceil_ilog2(bb) // 2)
    assert m_bound <= 64, "pke_v2 supports 64-bit sketch sums only"
    t_eff = t >> msbs_zero_padding_bit_count
    big_d = d + k * (t_eff.bit_length() - 1)
    n = big_d + 128 * m_bound
    return n, big_d, bb, m_bound


@dataclass
class PublicParams:
    g_list: list      # 2n G1 affine points (index n is the zero point)
    g_hat_list: list  # n G2 affine points
    big_d: int        # D at k = k_max
    n: int
    d: int
    k: int
    b_bound_squared: int
    b_inf: int
    q: int
    t: int
    msbs_zero_padding_bit_count: int
    bound_type: str
    sid: int

    def exclusive_max_noise(self) -> int:
        return self.b_inf + 1


def crs_gen(d: int, k: int, b_inf: int, q: int, t: int,
            msbs_zero_padding_bit_count: int, bound_type: str = CS,
            seed: int | None = None) -> PublicParams:
    alpha = (secrets.randbelow(R - 1) + 1) if seed is None else (
        hash_to_zp(1, b"PKEv2/crs", seed.to_bytes(16, "little"))[0] or 1)
    b_squared = inf_norm_bound_to_euclidean_squared(b_inf, d + k)
    n, big_d, bb, _m = compute_crs_params(
        d, k, b_squared, t, msbs_zero_padding_bit_count, bound_type)
    g_list = cv.g1_powers(cv.G1_GEN, alpha, 2 * n, skip=n)  # hole at alpha^(n+1)
    g_hat_list = cv.g2_powers(cv.G2_GEN, alpha, n)
    sid = (secrets.randbits(128) if seed is None
           else hash_128bit(1, b"PKEv2/sid", seed.to_bytes(16, "little"))[0])
    return PublicParams(g_list, g_hat_list, big_d, n, d, k, bb, b_inf, q, t,
                        msbs_zero_padding_bit_count, bound_type, sid)


# ---------------------------------------------------------------------------
# Proof object
# ---------------------------------------------------------------------------


@dataclass
class ProofV2:
    c_hat_e: tuple
    c_e: tuple
    c_r_tilde: tuple
    c_R: tuple
    c_hat_bin: tuple
    c_y: tuple
    c_h1: tuple
    c_h2: tuple
    c_hat_t: tuple
    pi: tuple
    pi_kzg: tuple
    c_hat_h3: tuple | None = None  # ComputeLoad::Proof only
    c_hat_w: tuple | None = None


Proof = ProofV2  # module-level alias: pke.Proof / pke_v2.Proof symmetry


# ---------------------------------------------------------------------------
# Fiat-Shamir transcript
# ---------------------------------------------------------------------------


class _Transcript:
    def __init__(self, *base: bytes):
        self.chunks = list(base)

    def absorb(self, *c: bytes):
        self.chunks.extend(c)

    def zp(self, ds: bytes, count: int) -> list:
        return hash_to_zp(count, ds, *self.chunks)

    def u128(self, ds: bytes, count: int) -> list:
        return hash_128bit(count, ds, *self.chunks)

    def ternary(self, ds: bytes, count: int):
        import hashlib

        import numpy as np
        h = hashlib.shake_256()
        h.update(ds)
        for c in self.chunks:
            h.update(len(c).to_bytes(8, "little"))
            h.update(c)
        raw = h.digest(count)
        # two bits per byte: {0,1} -> 0 (p=1/2), 2 -> +1, 3 -> -1 (p=1/4
        # each); vectorized — the verifier draws 541k of these and a Python
        # listcomp was ~15% of total verify time
        lut = np.array([0, 0, 1, -1], dtype=np.int8)
        return lut[np.frombuffer(raw, dtype=np.uint8) & 0b11]


def _x_bytes(pp: PublicParams, pc: PublicCommit, k: int) -> bytes:
    def i64s(v):
        return b"".join(int(x & ((1 << 64) - 1)).to_bytes(8, "little") for x in v)

    return b"".join((
        int(pp.q).to_bytes(8, "little"), int(pp.d).to_bytes(8, "little"),
        int(k).to_bytes(8, "little"), int(pp.b_inf).to_bytes(8, "little"),
        int(pp.t).to_bytes(8, "little"),
        int(pp.msbs_zero_padding_bit_count).to_bytes(8, "little"),
        i64s(pc.a), i64s(pc.b), i64s(pc.c1), i64s(pc.c2)))


# ---------------------------------------------------------------------------
# Shared prove/verify scalar derivations
# ---------------------------------------------------------------------------


def _phi_dot_R(phi: list, r_mat: list, j: int) -> int:
    """sum_i phi[i] * R(i, j) with R(i,j) = r_mat[i + 128*j] in {-1,0,1}."""
    acc = 0
    base = 128 * j
    row = r_mat[base:base + 128]
    if hasattr(row, "tolist"):
        row = row.tolist()
    for i, rij in enumerate(row):
        if rij == 1:
            acc += phi[i]
        elif rij == -1:
            acc -= phi[i]
    return acc % R


def _phi_dot_R_all(phi: list, r_mat, ncols: int) -> list:
    """[_phi_dot_R(phi, r_mat, j) for j in range(ncols)], vectorized: the
    128 phi bigints split into 32-bit limbs, the ternary R contracted as one
    int64 matmul (|entry| <= 128*(2^32-1) < 2^39), limbs recombined exactly."""
    L = (R.bit_length() + 31) // 32
    limbs = np.zeros((128, L), np.int64)
    for i, v in enumerate(phi):
        v = int(v)
        for l in range(L):
            limbs[i, l] = (v >> (32 * l)) & 0xFFFFFFFF
    r2 = np.asarray(r_mat[: 128 * ncols], np.int64).reshape(ncols, 128)
    m = r2 @ limbs
    out = []
    for j in range(ncols):
        row = m[j]
        acc = 0
        for l in range(L - 1, -1, -1):
            acc = (acc << 32) + int(row[l])
        out.append(acc % R)
    return out


def compute_a_theta(theta: list, a: list, d: int, k: int, b: list,
                    big_d: int, t_eff: int, delta: int) -> list:
    """pke_v2/mod.rs:2073 — A~.T theta: negacyclic rot(a).T/rot(b).T block
    then the delta-scaled binary-gadget block for the k messages.

    Vectorized through the shared pke.a_theta_head (exact int64
    correlations); compute_a_theta_scalar is the reference implementation
    (kept for the parity test)."""
    from .pke import a_theta_head

    theta1 = theta[:d]
    theta2 = theta[d:d + k]
    a_theta = [0] * big_d
    a_theta[:d] = a_theta_head(theta1, theta2, a, b, d, k)

    step = t_eff.bit_length() - 1
    for i in range(k):
        cur = delta % R * theta2[i] % R
        for j in range(step):
            a_theta[d + step * i + j] = cur
            cur = cur * 2 % R
    return a_theta


def compute_a_theta_scalar(theta: list, a: list, d: int, k: int, b: list,
                           big_d: int, t_eff: int, delta: int) -> list:
    """Reference scalar implementation of compute_a_theta (test oracle)."""
    theta1 = theta[:d]
    theta2 = theta[d:d + k]
    a_theta = [0] * big_d
    for i in range(d):
        dot = 0
        for j in range(d):
            if i <= j:
                dot += a[j - i] * theta1[j]
            else:
                dot -= a[(d + j) - i] * theta1[j]
        for j in range(k):
            if i + j < d:
                dot += b[d - i - j - 1] * theta2[j]
            else:
                dot -= b[2 * d - i - j - 1] * theta2[j]
        a_theta[i] = dot % R
    step = t_eff.bit_length() - 1
    for i in range(k):
        cur = delta % R * theta2[i] % R
        for j in range(step):
            a_theta[d + step * i + j] = cur
            cur = cur * 2 % R
    return a_theta


def _challenges(pp: PublicParams, pc: PublicCommit, metadata: bytes,
                big_d: int, m: int, c_hat_e_b: bytes, c_e_b: bytes,
                c_r_tilde_b: bytes):
    """R matrix + the transcript positioned right after C_r_tilde."""
    k = len(pc.c2)
    d = pp.d
    tr = _Transcript(pp.sid.to_bytes(16, "little"), metadata,
                     _x_bytes(pp, pc, k))
    tr.absorb(c_hat_e_b, c_e_b, c_r_tilde_b)
    r_mat = tr.ternary(b"PKEv2/R", 128 * (2 * (d + k) + 4))
    r_enc = np.asarray(r_mat).astype(np.uint8).tobytes()
    tr.absorb(r_enc)
    return tr, r_mat


# ---------------------------------------------------------------------------
# prove (pke_v2/mod.rs:1095)
# ---------------------------------------------------------------------------


def prove(pp: PublicParams, pc: PublicCommit, priv: PrivateCommit,
          metadata: bytes = b"", load: str = "proof",
          seed: bytes | None = None, _sanity_check: bool = True) -> Proof:
    """_sanity_check=False mimics the reference's ProofSanityCheckMode::Ignore
    (test-only): lets a dishonest witness through so tests can check that
    verification — not just the prover's preconditions — rejects it."""
    d, n = pp.d, pp.n
    k = len(pc.c2)
    t_eff = pp.t >> pp.msbs_zero_padding_bit_count
    decoded_q = _decode_q(pp.q)
    delta_enc = decoded_q // pp.t

    b_squared = inf_norm_bound_to_euclidean_squared(pp.b_inf, d + k)
    _, big_d, b_bound_sq, m = compute_crs_params(
        d, k, b_squared, pp.t, pp.msbs_zero_padding_bit_count, pp.bound_type)

    e_sqr_norm = sum(x * x for x in priv.e1) + sum(x * x for x in priv.e2)
    if _sanity_check:
        assert b_squared >= e_sqr_norm, "noise exceeds the CRS bound"

    if seed is None:
        seed = secrets.token_bytes(32)
    (gamma_e, gamma_hat_e, gamma_r, gamma_R, gamma_bin,
     gamma_y) = hash_to_zp(6, b"PKEv2/gamma", seed)

    r1 = compute_r1(priv.e1, pc.c1, pc.a, priv.r, d, decoded_q)
    r2 = compute_r2(priv.e2, pc.c2, priv.m, pc.b, priv.r, d, delta_enc,
                    decoded_q)
    v4 = four_squares(max(0, b_squared - e_sqr_norm))

    # witness bit vector prefix: reversed binary r, then message bits
    w_tilde = [1 if rv else 0 for rv in reversed(priv.r)]
    for mv in priv.m:
        w_tilde.extend(_bit_iter(mv, t_eff.bit_length() - 1))
    assert len(w_tilde) == big_d

    e_all = list(priv.e1) + list(priv.e2) + v4       # length d+k+4
    r_all = list(r1) + list(r2)                      # length d+k
    scalars_e = [x % R for x in e_all]

    g_list, g_hat_list = pp.g_list, pp.g_hat_list
    c_hat_e = cv.g2_add(cv.g2_mul(cv.G2_GEN, gamma_hat_e),
                        cv.msm_g2(g_hat_list[:d + k + 4], scalars_e))
    c_e = cv.g1_add(cv.g1_mul(cv.G1_GEN, gamma_e),
                    cv.msm_g1(g_list[n - (d + k + 4):n], scalars_e[::-1]))
    c_r_tilde = cv.g1_add(cv.g1_mul(cv.G1_GEN, gamma_r),
                          cv.msm_g1(g_list[:d + k], [x % R for x in r_all]))

    tr, r_mat = _challenges(pp, pc, metadata, big_d, m,
                            _g2_bytes(c_hat_e), _g1_bytes(c_e),
                            _g1_bytes(c_r_tilde))

    witness = e_all + r_all  # R sketch input, length 2(d+k)+4
    import numpy as _np

    wv = _np.asarray(witness, dtype=_np.int64)
    r2 = _np.asarray(r_mat, dtype=_np.int64).reshape(len(witness), 128)
    w_R = [int(v) for v in wv @ r2]
    if _sanity_check:
        assert all(v * v <= b_bound_sq for v in w_R), \
            "sketch sum escaped the bound"

    c_R = cv.g1_add(cv.g1_mul(cv.G1_GEN, gamma_R),
                    cv.msm_g1(g_list[:128], [x % R for x in w_R]))
    tr.absorb(_g1_bytes(c_R))
    phi = tr.zp(b"PKEv2/phi", 128)

    # signed m-bit decomposition of each sketch sum (top bit weight -2^(m-1))
    w_bin = list(w_tilde)
    for x in w_R:
        w_bin.extend(_bit_iter(x, m))
    assert len(w_bin) == big_d + 128 * m

    # sum of the w_bin-selected G2 basis points as ONE MSM (affine adds
    # cost an Fp2 inversion each — ~1.5 s of Python at prod size)
    sel = [g_hat_list[j] for j, wb in enumerate(w_bin) if wb]
    c_hat_bin = cv.g2_mul(cv.G2_GEN, gamma_bin)
    if sel:
        c_hat_bin = cv.g2_add(c_hat_bin, cv.msm_g2(sel, [1] * len(sel)))
    tr.absorb(_g2_bytes(c_hat_bin))
    xi = tr.zp(b"PKEv2/xi", 128)
    y = tr.zp(b"PKEv2/y", big_d + 128 * m)

    dm = big_d + 128 * m
    scalars = [(y[dm - 1 - i] if w_bin[dm - 1 - i] else 0) for i in range(dm)]
    c_y = cv.g1_add(cv.g1_mul(cv.G1_GEN, gamma_y),
                    cv.msm_g1(g_list[n - dm:n], scalars))
    tr.absorb(_g1_bytes(c_y))

    t_vec = tr.u128(b"PKEv2/t", n)
    theta = tr.zp(b"PKEv2/theta", d + k)
    omega = tr.zp(b"PKEv2/omega", n)
    (delta_r, delta_dec, delta_eq, delta_y, delta_theta, delta_e,
     delta_l) = tr.zp(b"PKEv2/delta", 7)

    a_theta = compute_a_theta(theta, pc.a, d, k, pc.b, big_d, t_eff,
                              delta_enc)
    t_theta = sum(th * (c % R) for th, c in
                  zip(theta, list(pc.c1) + list(pc.c2))) % R

    xi_powers = [(xi[j // m] << (j % m)) % R for j in range(128 * m)]
    delta_theta_q = delta_theta * (decoded_q % R) % R

    phi_R = _phi_dot_R_all(phi, r_mat, 2 * (d + k) + 4)

    # ---- the six polynomial pairs (pke_v2/mod.rs:1395) ------------------
    def h1_term(j: int) -> int:
        acc = 0
        if j < big_d:
            acc += delta_theta * a_theta[j]
        acc += delta_eq * t_vec[j] % R * y[j]
        if j >= big_d:
            ji = j - big_d
            rr = delta_dec * xi_powers[ji] % R
            acc += rr if ji % m < m - 1 else -rr
        return acc % R

    p0_lhs = [0] * (1 + n)
    p0_lhs[0] = delta_y * gamma_y % R
    for j in range(dm):
        acc = h1_term(j)
        if not w_bin[j]:
            acc -= delta_y * y[j]
        p0_lhs[n - j] = (p0_lhs[n - j] + acc) % R
    p0_rhs = [0] * (1 + dm)
    p0_rhs[0] = gamma_bin
    for j in range(dm):
        if w_bin[j]:
            p0_rhs[j + 1] = 1

    def h2_term(j: int) -> int:
        acc = delta_e * omega[j]
        if j < d + k:
            acc += delta_theta * theta[j]
        if j < d + k + 4:
            acc += delta_r * phi_R[j]
        return acc % R

    p1_lhs = [0] * (1 + n)
    p1_lhs[0] = delta_l * gamma_e % R
    for j in range(d + k + 4):
        p1_lhs[n - j] = delta_l * scalars_e[j] % R
    for j in range(n):
        p1_lhs[n - j] = (p1_lhs[n - j] + h2_term(j)) % R
    p1_rhs = [0] * (1 + d + k + 4)
    p1_rhs[0] = gamma_hat_e
    for j in range(d + k + 4):
        p1_rhs[1 + j] = scalars_e[j]

    def h3_term(j: int) -> int:
        return (delta_r * phi_R[d + k + 4 + j]
                - delta_theta_q * theta[j]) % R

    p2_lhs = [0] * (1 + d + k)
    p2_lhs[0] = gamma_r
    for j in range(d + k):
        p2_lhs[1 + j] = r_all[j] % R
    p2_rhs = [0] * (1 + n)
    for j in range(d + k):
        p2_rhs[n - j] = h3_term(j)

    p3_lhs = [0] * (1 + 128)
    p3_lhs[0] = gamma_R
    for j in range(128):
        p3_lhs[1 + j] = w_R[j] % R
    p3_rhs = [0] * (1 + n)
    for j in range(128):
        p3_rhs[n - j] = (delta_r * phi[j] + delta_dec * xi_powers[j * m]) % R

    p4_lhs = [0] * (1 + n)
    p4_lhs[0] = delta_e * gamma_e % R
    for j in range(d + k + 4):
        p4_lhs[n - j] = delta_e * scalars_e[j] % R
    p4_rhs = [0] * (1 + d + k + 4)
    for j in range(d + k + 4):
        p4_rhs[1 + j] = omega[j]

    p5_lhs = [0] * (1 + n)
    p5_lhs[0] = delta_eq * gamma_y % R
    for j in range(dm):
        if w_bin[j]:
            p5_lhs[n - j] = delta_eq * y[j] % R
    p5_rhs = [0] * (1 + n)
    for j in range(n):
        p5_rhs[1 + j] = t_vec[j]

    prods = [poly_mul_zp(lhs, rhs) for lhs, rhs in
             ((p0_lhs, p0_rhs), (p1_lhs, p1_rhs), (p2_lhs, p2_rhs),
              (p3_lhs, p3_rhs), (p4_lhs, p4_rhs), (p5_lhs, p5_rhs))]
    length = max(len(p) for p in prods)
    p_pi = [0] * length
    for idx, sign in ((0, 1), (1, 1), (2, 1), (3, -1), (4, -1), (5, -1)):
        for i, c in enumerate(prods[idx]):
            p_pi[i] = (p_pi[i] + sign * c) % R
    if length > n + 1:
        p_pi[n + 1] = (p_pi[n + 1] - delta_theta * t_theta
                       - delta_l * (b_squared % R)) % R

    pi = cv.g1_add(cv.g1_mul(cv.G1_GEN, p_pi[0]),
                   cv.msm_g1(g_list[:length - 1], p_pi[1:]))

    c_h1 = cv.msm_g1(g_list[n - dm:n],
                     [(h1_term(j) - delta_y * y[j]) % R
                      for j in range(dm - 1, -1, -1)])
    c_h2 = cv.msm_g1(g_list[:n], [h2_term(j) for j in range(n - 1, -1, -1)])
    c_hat_t = cv.msm_g2(g_hat_list[:n], t_vec)

    load_proof = load == "proof"
    c_hat_h3 = c_hat_w = None
    if load_proof:
        c_hat_h3 = cv.msm_g2(g_hat_list[n - (d + k):n],
                             [h3_term(j) for j in range(d + k - 1, -1, -1)])
        c_hat_w = cv.msm_g2(g_hat_list[:d + k + 4], omega[:d + k + 4])

    tr.absorb(_g1_bytes(c_h1), _g1_bytes(c_h2), _g2_bytes(c_hat_t),
              _g2_bytes(c_hat_h3) if load_proof else b"",
              _g2_bytes(c_hat_w) if load_proof else b"")
    z = tr.zp(b"PKEv2/z", 1)[0]

    # polynomials opened at z
    ph1 = [0] * (1 + n)
    for j in range(dm):
        ph1[n - j] = (h1_term(j) - delta_y * y[j]) % R
    ph2 = [0] * (1 + n)
    for j in range(n):
        ph2[n - j] = h2_term(j)
    pt = [0] + list(t_vec)
    ph3 = []
    pomega = []
    if load_proof:
        ph3 = [0] * (1 + n)
        for j in range(d + k):
            ph3[n - j] = h3_term(j)
        pomega = [0] + omega[:d + k + 4]

    def eval_at_z(poly):
        acc = 0
        for c in reversed(poly):
            acc = (acc * z + c) % R
        return acc

    e_h1, e_h2, e_t = eval_at_z(ph1), eval_at_z(ph2), eval_at_z(pt)
    e_h3 = eval_at_z(ph3) if ph3 else 0
    e_om = eval_at_z(pomega) if pomega else 0

    tr.absorb(_zp_bytes(e_h1), _zp_bytes(e_h2), _zp_bytes(e_t),
              _zp_bytes(e_h3) if load_proof else b"",
              _zp_bytes(e_om) if load_proof else b"")
    chi = tr.zp(b"PKEv2/chi", 1)[0]
    chi2 = chi * chi % R
    chi3 = chi2 * chi % R
    chi4 = chi3 * chi % R

    q_kzg = [0] * (1 + n)
    for j in range(1, n + 1):
        acc = ph1[j] + chi * ph2[j] + chi2 * pt[j]
        if j < len(ph3):
            acc += chi3 * ph3[j]
        if j < len(pomega):
            acc += chi4 * pomega[j]
        q_kzg[j] = acc % R
    q_kzg[0] = -(e_h1 + chi * e_h2 + chi2 * e_t + chi3 * e_h3
                 + chi4 * e_om) % R
    qq = [0] * n
    for j in range(n - 1, -1, -1):
        q_kzg[j] = (q_kzg[j] + z * q_kzg[j + 1]) % R
        qq[j] = q_kzg[j + 1]
    pi_kzg = cv.g1_add(cv.g1_mul(cv.G1_GEN, qq[0]),
                       cv.msm_g1(g_list[:n - 1], qq[1:n]))

    return Proof(c_hat_e, c_e, c_r_tilde, c_R, c_hat_bin, c_y, c_h1, c_h2,
                 c_hat_t, pi, pi_kzg, c_hat_h3, c_hat_w)


# ---------------------------------------------------------------------------
# verify (pke_v2/mod.rs:2224 + pairing_check_two_steps :2545)
# ---------------------------------------------------------------------------


def verify(proof: Proof, pp: PublicParams, pc: PublicCommit,
           metadata: bytes = b"") -> bool:
    d, n = pp.d, pp.n
    k = len(pc.c2)
    if k > pp.k or len(pc.a) != d or len(pc.b) != d or len(pc.c1) != d:
        return False
    t_eff = pp.t >> pp.msbs_zero_padding_bit_count
    decoded_q = _decode_q(pp.q)
    delta_enc = decoded_q // pp.t
    b_squared = inf_norm_bound_to_euclidean_squared(pp.b_inf, d + k)
    _, big_d, _, m = compute_crs_params(
        d, k, b_squared, pp.t, pp.msbs_zero_padding_bit_count, pp.bound_type)
    if big_d > pp.big_d:
        return False
    dm = big_d + 128 * m

    tr, r_mat = _challenges(pp, pc, metadata, big_d, m,
                            _g2_bytes(proof.c_hat_e), _g1_bytes(proof.c_e),
                            _g1_bytes(proof.c_r_tilde))
    tr.absorb(_g1_bytes(proof.c_R))
    phi = tr.zp(b"PKEv2/phi", 128)
    tr.absorb(_g2_bytes(proof.c_hat_bin))
    xi = tr.zp(b"PKEv2/xi", 128)
    y = tr.zp(b"PKEv2/y", dm)
    tr.absorb(_g1_bytes(proof.c_y))
    t_vec = tr.u128(b"PKEv2/t", n)
    theta = tr.zp(b"PKEv2/theta", d + k)
    omega = tr.zp(b"PKEv2/omega", n)
    (delta_r, delta_dec, delta_eq, delta_y, delta_theta, delta_e,
     delta_l) = tr.zp(b"PKEv2/delta", 7)

    a_theta = compute_a_theta(theta, pc.a, d, k, pc.b, big_d, t_eff,
                              delta_enc)
    t_theta = sum(th * (c % R) for th, c in
                  zip(theta, list(pc.c1) + list(pc.c2))) % R
    xi_powers = [(xi[j // m] << (j % m)) % R for j in range(128 * m)]
    delta_theta_q = delta_theta * (decoded_q % R) % R
    phi_R = _phi_dot_R_all(phi, r_mat, 2 * (d + k) + 4)

    def h1_term(j: int) -> int:
        acc = -delta_y * y[j]
        if j < big_d:
            acc += delta_theta * a_theta[j]
        acc += delta_eq * t_vec[j] % R * y[j]
        if j >= big_d:
            ji = j - big_d
            rr = delta_dec * xi_powers[ji] % R
            acc += rr if ji % m < m - 1 else -rr
        return acc % R

    def h2_term(j: int) -> int:
        acc = delta_e * omega[j]
        if j < d + k:
            acc += delta_theta * theta[j]
        if j < d + k + 4:
            acc += delta_r * phi_R[j]
        return acc % R

    def h3_term(j: int) -> int:
        return (delta_r * phi_R[d + k + 4 + j]
                - delta_theta_q * theta[j]) % R

    load_proof = proof.c_hat_h3 is not None
    tr.absorb(_g1_bytes(proof.c_h1), _g1_bytes(proof.c_h2),
              _g2_bytes(proof.c_hat_t),
              _g2_bytes(proof.c_hat_h3) if load_proof else b"",
              _g2_bytes(proof.c_hat_w) if load_proof else b"")
    z = tr.zp(b"PKEv2/z", 1)[0]

    # evaluations at z (Horner over the reconstructed public polynomials)
    ph1 = [0] * (1 + n)
    for j in range(dm):
        ph1[n - j] = h1_term(j)
    ph2 = [0] * (1 + n)
    for j in range(n):
        ph2[n - j] = h2_term(j)
    pt = [0] + list(t_vec)
    ph3 = []
    pomega = []
    if load_proof:
        ph3 = [0] * (1 + n)
        for j in range(d + k):
            ph3[n - j] = h3_term(j)
        pomega = [0] + omega[:d + k + 4]

    def eval_at_z(poly):
        acc = 0
        for c in reversed(poly):
            acc = (acc * z + c) % R
        return acc

    e_h1, e_h2, e_t = eval_at_z(ph1), eval_at_z(ph2), eval_at_z(pt)
    e_h3 = eval_at_z(ph3) if ph3 else 0
    e_om = eval_at_z(pomega) if pomega else 0
    tr.absorb(_zp_bytes(e_h1), _zp_bytes(e_h2), _zp_bytes(e_t),
              _zp_bytes(e_h3) if load_proof else b"",
              _zp_bytes(e_om) if load_proof else b"")
    chi = tr.zp(b"PKEv2/chi", 1)[0]
    chi2 = chi * chi % R
    chi3 = chi2 * chi % R
    chi4 = chi3 * chi % R

    g_list, g_hat_list = pp.g_list, pp.g_hat_list
    g1g, g2g = cv.G1_GEN, cv.G2_GEN

    # -- equation 1: e(pi, ghat) == prod of commitment pairings -----------
    # checked as ONE pairing product == 1 (inverse factors carry negated G1
    # points), sharing a single final exponentiation across all 8 pairings
    # (pairing_check_two_steps, pke_v2/mod.rs:2545)
    h3_point = proof.c_hat_h3 if load_proof else cv.msm_g2(
        g_hat_list[n - (d + k):n],
        [h3_term(j) for j in range(d + k - 1, -1, -1)])
    w_point = proof.c_hat_w if load_proof else cv.msm_g2(
        g_hat_list[:d + k + 4], omega[:d + k + 4])
    s6 = (delta_theta * t_theta + delta_l * (b_squared % R)) % R
    prod = cv.pairing_product([
        (cv.g1_add(cv.g1_mul(proof.c_y, delta_y), proof.c_h1),
         proof.c_hat_bin),
        (cv.g1_add(cv.g1_mul(proof.c_e, delta_l), proof.c_h2),
         proof.c_hat_e),
        (proof.c_r_tilde, h3_point),
        (cv.g1_neg(proof.c_R), cv.msm_g2(
            g_hat_list[n - 128:n],
            [(delta_r * phi[j] + delta_dec * xi[j]) % R
             for j in range(127, -1, -1)])),
        (cv.g1_neg(cv.g1_mul(proof.c_e, delta_e)), w_point),
        (cv.g1_neg(cv.g1_mul(proof.c_y, delta_eq)), proof.c_hat_t),
        (cv.g1_neg(cv.g1_mul(g_list[0], s6)), g_hat_list[n - 1]),
        (cv.g1_neg(proof.pi), g2g),
    ])
    if prod != cv.F12_ONE:
        return False

    # -- equation 2: the KZG opening (same one-product form) --------------
    p1 = cv.g1_add(
        cv.g1_add(proof.c_h1, cv.g1_mul(proof.c_h2, chi)),
        cv.g1_neg(cv.g1_mul(g1g, (e_h1 + chi * e_h2) % R)))
    chat = cv.g2_mul(proof.c_hat_t, chi2)
    if load_proof:
        chat = cv.g2_add(chat, cv.g2_mul(proof.c_hat_h3, chi3))
        chat = cv.g2_add(chat, cv.g2_mul(proof.c_hat_w, chi4))
    chat = cv.g2_add(chat, cv.g2_neg(cv.g2_mul(
        g2g, (e_t * chi2 + e_h3 * chi3 + e_om * chi4) % R)))
    prod2 = cv.pairing_product([
        (p1, g2g),
        (g1g, chat),
        (cv.g1_neg(proof.pi_kzg),
         cv.g2_add(g_hat_list[0], cv.g2_neg(cv.g2_mul(g2g, z)))),
    ])
    return prod2 == cv.F12_ONE
