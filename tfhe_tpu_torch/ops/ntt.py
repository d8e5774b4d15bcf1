"""Exact negacyclic polynomial multiplication mod 2^64 (and 2^128) via CRT-NTT.

The port of tfhe_tpu/ops/ntt.py, with the same primes, twiddle order,
Montgomery constants and Garner constants, so every NTT-domain value (the
bootstrapping key above all) is the same u32 in both packages:

  - Primes p < 2^30 with 2^14 | p-1, descending (Garner needs p_0 < 2 p_j).
  - Montgomery arithmetic with R = 2^32: twiddles and constants are stored in
    Montgomery form, data stays in the normal domain, every modmul is one
    REDC.
  - Forward: Cooley-Tukey DIT, natural -> bit-reversed, psi twist merged into
    the twiddles; inverse: Gentleman-Sande, bit-reversed -> natural, times
    N^-1.
  - Garner reconstructs a SIGNED integer |X| < P/2 mod 2^64, or mod 2^128
    as a (lo, hi) pair for the u128 torus of noise squashing (6-prime
    plans).

Two halves: numpy on the host (encryption, uint64), and torch on int64
tensors (the plain versions the CUDA kernels are held against, the CPU
path, and key generation's secret products and NTT-domain keys on the
key's device).
All residues stay below 2^31 and a Montgomery product below 2^63, so int64
holds every intermediate without a sign problem; only Garner's final sums
wrap, which is the result mod 2^64 (or, word by word with the carries taken
by unsigned compares, mod 2^128).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from .torus import s64, shr, ult

PRIMES = (1073692673, 1073643521, 1073479681, 1073430529,
          1073299457, 1073233921, 1073184769, 1073135617)

_U64 = np.uint64
_M64 = (1 << 64) - 1
_MASK32 = _U64(0xFFFFFFFF)
_R_BITS = _U64(32)


def _find_generator(p: int) -> int:
    n = p - 1
    factors = set()
    d = 2
    while d * d <= n:
        while n % d == 0:
            factors.add(d)
            n //= d
        d += 1
    if n > 1:
        factors.add(n)
    for g in range(2, 1000):
        if all(pow(g, (p - 1) // f, p) != 1 for f in factors):
            return g
    raise RuntimeError("no generator found")


def _bitrev_indices(n: int) -> np.ndarray:
    bits = n.bit_length() - 1
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev


@dataclass(frozen=True, eq=False)
class NttPlan:
    n: int
    primes: tuple
    ps: np.ndarray                # (P, 1) uint64
    pinvs: np.ndarray             # (P, 1) -p^-1 mod 2^32
    r2s: np.ndarray               # (P, 1) R^2 mod p
    n_invs: np.ndarray            # (P, 1) N^-1 in Montgomery form
    psi_br_stack: np.ndarray      # (P, N) psi^bitrev, Montgomery form
    psi_inv_br_stack: np.ndarray  # (P, N)

    @property
    def num_primes(self) -> int:
        return len(self.primes)


@lru_cache(maxsize=None)
def make_plan(n: int, num_primes: int = 4) -> NttPlan:
    assert n & (n - 1) == 0, "N must be a power of two"
    primes = PRIMES[:num_primes]
    rev = _bitrev_indices(n)
    cols = {k: [] for k in ("p", "pinv", "r2", "ninv", "psi", "psi_inv")}
    for p in primes:
        assert (p - 1) % (2 * n) == 0, f"prime {p} does not support size {n}"
        g = _find_generator(p)
        psi = pow(g, (p - 1) // (2 * n), p)
        assert pow(psi, n, p) == p - 1
        psi_inv = pow(psi, p - 2, p)
        r = (1 << 32) % p
        cols["p"].append(p)
        cols["pinv"].append(((1 << 32) - pow(p, -1, 1 << 32)) % (1 << 32))
        cols["r2"].append(r * r % p)
        cols["ninv"].append(pow(n, p - 2, p) * r % p)
        cols["psi"].append([pow(psi, int(e), p) * r % p for e in rev])
        cols["psi_inv"].append([pow(psi_inv, int(e), p) * r % p for e in rev])
    col = lambda k: np.array(cols[k], dtype=np.uint64).reshape(-1, 1)  # noqa: E731
    return NttPlan(
        n=n, primes=primes, ps=col("p"), pinvs=col("pinv"), r2s=col("r2"),
        n_invs=col("ninv"),
        psi_br_stack=np.array(cols["psi"], dtype=np.uint64),
        psi_inv_br_stack=np.array(cols["psi_inv"], dtype=np.uint64),
    )


@lru_cache(maxsize=None)
def garner_consts(primes: tuple) -> dict:
    """Garner mixed-radix constants as Python ints (division-free
    reconstruction): Montgomery inverses, partial products mod p_j, partial
    products mod 2^64 and as (lo, hi) pairs mod 2^128, P mod 2^64 and mod
    2^128, and the mixed-radix digits of floor(P/2) for the sign test."""
    k = len(primes)
    r = 1 << 32
    c = {"inv_mont": {}, "pm_mont": {}, "inv": {}, "pm": {}}
    for j in range(1, k):
        pj = primes[j]
        prod = 1
        for i in range(j):
            prod = prod * primes[i] % pj
            c["pm"][(i, j)] = prod
            c["pm_mont"][(i, j)] = prod * r % pj
        c["inv"][j] = pow(prod, -1, pj)
        c["inv_mont"][j] = c["inv"][j] * r % pj
    c["prods64"], c["prods128"] = [], []
    acc = 1
    for p in primes:
        c["prods64"].append(acc & _M64)
        c["prods128"].append((acc & _M64, (acc >> 64) & _M64))
        acc *= p
    c["P_mod64"] = acc & _M64
    c["P_mod128"] = (acc & _M64, (acc >> 64) & _M64)
    half = acc // 2
    c["half_digits"] = []
    for p in primes:
        c["half_digits"].append(half % p)
        half //= p
    return c


# ---------------------------------------------------------------------------
# Host (numpy uint64): key generation and encryption
# ---------------------------------------------------------------------------


def _mont_mul_np(a, b_mont, p, pinv):
    t = a * b_mont
    m = ((t & _MASK32) * pinv) & _MASK32
    u = (t + m * p) >> _R_BITS
    return np.where(u >= p, u - p, u)


def _np_add(a, b, p):
    s = a + b
    return np.where(s >= p, s - p, s)


def _np_sub(a, b, p):
    d = a + p - b
    return np.where(d >= p, d - p, d)


def _forward_np(x, plan: NttPlan):
    """(..., P, N) residues -> NTT domain (bit-reversed), all primes."""
    n, np_ = plan.n, plan.num_primes
    batch = x.shape[:-2]
    ones = (1,) * len(batch)
    p = plan.ps.reshape(ones + (np_, 1, 1))
    pinv = plan.pinvs.reshape(ones + (np_, 1, 1))
    m, t = 1, n
    while m < n:
        t //= 2
        xv = x.reshape(batch + (np_, m, 2, t))
        u = xv[..., 0, :]
        s = plan.psi_br_stack[:, m:2 * m].reshape(ones + (np_, m, 1))
        v = _mont_mul_np(xv[..., 1, :], s, p, pinv)
        x = np.stack([_np_add(u, v, p), _np_sub(u, v, p)], axis=-2
                     ).reshape(batch + (np_, n))
        m *= 2
    return x


def _inverse_np(x, plan: NttPlan):
    n, np_ = plan.n, plan.num_primes
    batch = x.shape[:-2]
    ones = (1,) * len(batch)
    p = plan.ps.reshape(ones + (np_, 1, 1))
    pinv = plan.pinvs.reshape(ones + (np_, 1, 1))
    t, m = 1, n
    while m > 1:
        h = m // 2
        xv = x.reshape(batch + (np_, h, 2, t))
        u, v = xv[..., 0, :], xv[..., 1, :]
        s = plan.psi_inv_br_stack[:, h:2 * h].reshape(ones + (np_, h, 1))
        x = np.stack([_np_add(u, v, p),
                      _mont_mul_np(_np_sub(u, v, p), s, p, pinv)], axis=-2
                     ).reshape(batch + (np_, n))
        t *= 2
        m = h
    return _mont_mul_np(x, plan.n_invs, plan.ps, plan.pinvs)


def forward_all(x, plan: NttPlan):
    """(..., N) uint64 -> (..., P, N) NTT-domain residues (normal form)."""
    res = np.stack([x % _U64(p) for p in plan.primes], axis=-2)
    return _forward_np(res, plan)


def to_mont_all(x_ntt, plan: NttPlan):
    """NTT-domain residues (..., P, N) -> Montgomery form."""
    return _mont_mul_np(x_ntt, plan.r2s, plan.ps, plan.pinvs)


def _garner_digits_np(residues, plan: NttPlan) -> list:
    """The mixed-radix digits a_0 .. a_{P-1} of the integer whose residues
    (..., P, N) these are (each a_j < p_j)."""
    c = garner_consts(plan.primes)
    a = [residues[..., 0, :]]
    for j in range(1, plan.num_primes):
        pj = _U64(plan.primes[j])
        pinv = plan.pinvs[j, 0]
        v = np.where(a[0] >= pj, a[0] - pj, a[0])
        for i in range(1, j):
            v = v + _mont_mul_np(a[i], _U64(c["pm_mont"][(i - 1, j)]), pj, pinv)
            v = np.where(v >= pj, v - pj, v)
        r = residues[..., j, :]
        d = np.where(r >= v, r - v, r + pj - v)
        a.append(_mont_mul_np(d, _U64(c["inv_mont"][j]), pj, pinv))
    return a


def _is_negative(a: list, primes: tuple):
    """Whether the mixed-radix digits a stand for an integer above P/2."""
    h = garner_consts(primes)["half_digits"]
    is_neg = a[0] > h[0]
    for i in range(1, len(a)):
        is_neg = (a[i] > h[i]) | ((a[i] == h[i]) & is_neg)
    return is_neg


def _garner_np(residues, plan: NttPlan):
    c = garner_consts(plan.primes)
    a = _garner_digits_np(residues, plan)
    out = a[0]
    for i in range(1, plan.num_primes):
        out = out + a[i] * _U64(c["prods64"][i])
    return np.where(_is_negative(a, plan.primes), out - _U64(c["P_mod64"]), out)


def negacyclic_polymul_u64(a, b, plan: NttPlan):
    """Exact negacyclic product mod 2^64 of uint64 polynomials, correct when
    every exact output coefficient (unsigned representatives) has
    |X| < P/2 — e.g. a binary secret key times a torus polynomial."""
    with np.errstate(over="ignore"):
        fa = forward_all(a, plan)
        fb = to_mont_all(forward_all(b, plan), plan)
        prod = _mont_mul_np(fa, fb, plan.ps, plan.pinvs)
        return _garner_np(_inverse_np(prod, plan), plan)


# ---------------------------------------------------------------------------
# Host u128 (numpy): values as (lo, hi) uint64 pairs, for the noise-squashing
# key (tfhe_tpu/ops/ntt.py:503-600)
# ---------------------------------------------------------------------------


def add128_np(alo, ahi, blo, bhi):
    lo = alo + blo
    return lo, ahi + bhi + (lo < alo).astype(_U64)


def sub128_np(alo, ahi, blo, bhi):
    return alo - blo, ahi - bhi - (alo < blo).astype(_U64)


def neg128_np(lo, hi):
    z = np.zeros_like(lo)
    return sub128_np(z, z, lo, hi)


def mul_u32_by_u128_np(a, c_lo: int, c_hi: int):
    """a (uint64 values < 2^32) times the constant (c_lo, c_hi), mod 2^128."""
    t0 = a * _U64(c_lo & 0xFFFFFFFF)
    t1 = a * _U64(c_lo >> 32)
    lo = t0 + ((t1 & _MASK32) << _R_BITS)
    hi = (t1 >> _R_BITS) + a * _U64(c_hi) + (lo < t0).astype(_U64)
    return lo, hi


def to_residues_u128_np(lo, hi, plan: NttPlan):
    """(lo, hi) pairs (..., N) -> (..., P, N) residues."""
    outs = []
    for p in plan.primes:
        p = _U64(p)
        two64 = _U64((1 << 64) % int(p))
        outs.append(((hi % p) * two64 + lo % p) % p)
    return np.stack(outs, axis=-2)


def forward_all_u128(lo, hi, plan: NttPlan):
    """(..., N) pairs -> (..., P, N) NTT-domain residues (normal form)."""
    return _forward_np(to_residues_u128_np(lo, hi, plan), plan)


def garner_to_u128_np(residues, plan: NttPlan) -> tuple:
    """(..., P, N) residues of a signed integer |X| < P/2 -> X mod 2^128 as
    a (lo, hi) pair (tfhe_tpu/ops/ntt.py garner_to_u128)."""
    c = garner_consts(plan.primes)
    a = _garner_digits_np(residues, plan)
    lo, hi = a[0], np.zeros_like(a[0])
    with np.errstate(over="ignore"):
        for i in range(1, plan.num_primes):
            lo, hi = add128_np(lo, hi, *mul_u32_by_u128_np(a[i], *c["prods128"][i]))
        pm_lo, pm_hi = c["P_mod128"]
        n_lo, n_hi = sub128_np(lo, hi, _U64(pm_lo), _U64(pm_hi))
    neg = _is_negative(a, plan.primes)
    return np.where(neg, n_lo, lo), np.where(neg, n_hi, hi)


def negacyclic_polymul_u128(a_lo, a_hi, b_lo, b_hi, plan: NttPlan) -> tuple:
    """Exact negacyclic product of u128 polynomials mod 2^128, correct when
    every exact output coefficient has |X| < P/2: six primes for a binary
    key times a u128 polynomial (2^140)."""
    with np.errstate(over="ignore"):
        fa = forward_all_u128(a_lo, a_hi, plan)
        fb = to_mont_all(forward_all_u128(b_lo, b_hi, plan), plan)
        prod = _mont_mul_np(fa, fb, plan.ps, plan.pinvs)
        return garner_to_u128_np(_inverse_np(prod, plan), plan)


# ---------------------------------------------------------------------------
# Device (torch int64): plain versions of the blind-rotation arithmetic
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


@dataclass(frozen=True, eq=False)
class DevicePlan:
    """An NttPlan's tables on one device: int64 for the torch code, u32
    twiddles and one packed int64 constant table for the CUDA kernels: the
    4-prime u64 table (K2-K4) or the 6-prime u128 table (K5), whichever the
    plan's prime count takes (the other is None)."""

    plan: NttPlan
    ps: torch.Tensor          # (P, 1) int64
    pinvs: torch.Tensor
    r2s: torch.Tensor
    n_invs: torch.Tensor
    psi: torch.Tensor         # (P, N) int64
    psi_inv: torch.Tensor
    psi32: torch.Tensor       # (P, N) int32 (values < 2^30)
    psi_inv32: torch.Tensor
    kernel_consts: torch.Tensor | None     # (KERNEL_CONSTS_LEN,) int64
    kernel_consts128: torch.Tensor | None  # (KERNEL128_CONSTS_LEN,) int64

    @property
    def n(self) -> int:
        return self.plan.n

    @property
    def num_primes(self) -> int:
        return self.plan.num_primes


# Packed constant table read by csrc/blind_rotate.cu (struct layout there):
# [0:4] p, [4:8] -p^-1 mod 2^32, [8:12] N^-1 (Montgomery), [12:16] Garner
# inverse for prime j (slot j), [16:32] partial product (i, j) at 16+4i+j,
# [32:36] partial products mod 2^64, [36] P mod 2^64, [40:44] digits of P/2.
KERNEL_PRIMES = 4
KERNEL_CONSTS_LEN = 44


def _kernel_consts(plan: NttPlan) -> np.ndarray:
    assert plan.num_primes <= KERNEL_PRIMES
    c = garner_consts(plan.primes)
    out = np.zeros(KERNEL_CONSTS_LEN, dtype=np.int64)
    for i, p in enumerate(plan.primes):
        out[i] = p
        out[4 + i] = int(plan.pinvs[i, 0])
        out[8 + i] = int(plan.n_invs[i, 0])
        out[32 + i] = s64(c["prods64"][i])
        out[40 + i] = c["half_digits"][i]
    for j, v in c["inv_mont"].items():
        out[12 + j] = v
    for (i, j), v in c["pm_mont"].items():
        out[16 + 4 * i + j] = v
    out[36] = s64(c["P_mod64"])
    return out


# The u128 table read by csrc/blind_rotate128.cu (struct Consts128 there),
# for 6-prime plans: [0:6] p, [6:12] -p^-1 mod 2^32, [12:18] N^-1
# (Montgomery), [18:24] Garner inverse for prime j (slot j), [24:60] partial
# product (i, j) at 24+6i+j, [60:72] partial products mod 2^128 as (lo, hi)
# at 60+2i, [72:74] P mod 2^128 (lo, hi), [74:80] digits of P/2.
KERNEL128_PRIMES = 6
KERNEL128_CONSTS_LEN = 80


def _kernel_consts128(plan: NttPlan) -> np.ndarray:
    assert plan.num_primes == KERNEL128_PRIMES
    np_ = KERNEL128_PRIMES
    c = garner_consts(plan.primes)
    out = np.zeros(KERNEL128_CONSTS_LEN, dtype=np.int64)
    for i, p in enumerate(plan.primes):
        out[i] = p
        out[np_ + i] = int(plan.pinvs[i, 0])
        out[2 * np_ + i] = int(plan.n_invs[i, 0])
        out[60 + 2 * i] = s64(c["prods128"][i][0])
        out[61 + 2 * i] = s64(c["prods128"][i][1])
        out[74 + i] = c["half_digits"][i]
    for j, v in c["inv_mont"].items():
        out[3 * np_ + j] = v
    for (i, j), v in c["pm_mont"].items():
        out[24 + np_ * i + j] = v
    out[72] = s64(c["P_mod128"][0])
    out[73] = s64(c["P_mod128"][1])
    return out


@lru_cache(maxsize=None)
def device_plan(plan: NttPlan, device: str) -> DevicePlan:
    """Upload an NttPlan's tables to ``device`` once (cached per device)."""
    t = lambda a, dt=torch.int64: torch.from_numpy(  # noqa: E731
        np.asarray(a).astype(np.int64)).to(device=device, dtype=dt)
    return DevicePlan(
        plan=plan, ps=t(plan.ps), pinvs=t(plan.pinvs), r2s=t(plan.r2s),
        n_invs=t(plan.n_invs),
        psi=t(plan.psi_br_stack), psi_inv=t(plan.psi_inv_br_stack),
        psi32=t(plan.psi_br_stack, torch.int32),
        psi_inv32=t(plan.psi_inv_br_stack, torch.int32),
        kernel_consts=(t(_kernel_consts(plan))
                       if plan.num_primes <= KERNEL_PRIMES else None),
        kernel_consts128=(t(_kernel_consts128(plan))
                          if plan.num_primes == KERNEL128_PRIMES else None),
    )


def _add_p_if_negative(d, p):
    """d + p where d < 0, else d (d in [-p, p)): branch-free, several times
    faster than torch.where on the CPU."""
    return d + (p & (d >> 63))


def redc(t, p, pinv):
    """REDC32 on int64 tensors: t 2^-32 mod p for 0 <= t < 2^62; result < p."""
    m = ((t & _M32) * pinv) & _M32
    return _add_p_if_negative(((t + m * p) >> 32) - p, p)


def mont_mul(a, b_mont, p, pinv):
    """a * b mod p for a, b < 2^31 (b in Montgomery form); result < p."""
    return redc(a * b_mont, p, pinv)


def add_mod(a, b, p):
    return _add_p_if_negative(a + b - p, p)


def sub_mod(a, b, p):
    return _add_p_if_negative(a - b, p)


@lru_cache(maxsize=None)
def normal_twiddles(dp: DevicePlan) -> tuple:
    """The forward and inverse twiddles and N^-1 of dp's plan in normal form
    (the plan keeps Montgomery form, W R mod p), on dp's device: what the
    plain transforms below multiply by, a product and one remainder a
    butterfly.  The twiddles come as one (P, m, 1) tensor a stage."""
    out = []
    for table in (dp.plan.psi_br_stack, dp.plan.psi_inv_br_stack, dp.plan.n_invs):
        norm = np.empty(table.shape, dtype=np.int64)
        for j, p in enumerate(dp.plan.primes):
            r_inv = pow(1 << 32, -1, p)
            norm[j] = [int(w) * r_inv % p for w in table[j]]
        out.append(torch.from_numpy(norm).to(dp.psi.device))
    stages = [out[k][:, m:2 * m, None].contiguous() for k in (0, 1)
              for m in (1 << e for e in range(dp.n.bit_length() - 1))]
    half = len(stages) // 2
    return stages[:half], stages[half:], out[2]


# Lazy reduction in the plain transforms: a value is kept below b p in
# magnitude and reduced once its bound would let a product by a twiddle
# (< p < 2^30) pass 2^63; a torch call's overhead outweighs its arithmetic
# on the CPU, so the fewer remainders the better.  Forward: u +- v grows the
# bound by one a stage, a product needs |x| < 8 p.  Inverse: u + v doubles
# it, (u - v) s needs |u - v| < 8 p.
_FWD_BOUND = 8
_INV_BOUND = 4


def ntt_forward(x: torch.Tensor, dp: DevicePlan) -> torch.Tensor:
    """(..., P, N) int64 values below p in magnitude (residues, or signed
    digits), natural order -> NTT domain, bit-reversed, each residue in
    [0, p)."""
    n, np_ = dp.n, dp.num_primes
    batch = tuple(x.shape[:-2])
    p = dp.ps[:, :, None]                                    # over (..., P, m, t)
    m, t, bound = 1, n, 1
    for s in normal_twiddles(dp)[0]:                         # (P, m, 1)
        t //= 2
        if bound > _FWD_BOUND:
            x, bound = torch.remainder(x, dp.ps), 1
        xv = x.reshape(batch + (np_, m, 2, t))
        u = xv[..., 0, :]
        v = torch.remainder(xv[..., 1, :] * s, p)
        x = torch.stack([u + v, u - v], dim=-2).reshape(batch + (np_, n))
        bound += 1
        m *= 2
    return torch.remainder(x, dp.ps)


def residues_u64(w: torch.Tensor, dp: DevicePlan) -> torch.Tensor:
    """(..., N) int64 tensor holding u64 words -> (..., P, N) residues of
    the unsigned words (host ``forward_all``'s first step)."""
    w = w[..., None, :]
    # 2^64 mod p: what a word read as signed int64 lacks where it is negative
    wrap = torch.tensor([(1 << 64) % q for q in dp.plan.primes], dtype=torch.int64,
                        device=w.device)[:, None]
    return torch.remainder(torch.remainder(w, dp.ps) + wrap * (w < 0), dp.ps)


def key_ntt(words: np.ndarray, dp: DevicePlan) -> torch.Tensor:
    """(..., N) uint64 key words -> (..., P, N) int32 on dp's device: each
    word's residues, forward NTT, Montgomery form; the words of host
    ``to_mont_all(forward_all(words))``, converted on the device in slices
    of about 2^22 coefficients."""
    n, np_ = dp.n, dp.num_primes
    flat = np.asarray(words).reshape(-1, n)
    out = torch.empty((flat.shape[0], np_, n), dtype=torch.int32, device=dp.ps.device)
    step = max(1, (1 << 22) // (np_ * n))
    for s in range(0, flat.shape[0], step):
        w = torch.from_numpy(np.ascontiguousarray(flat[s:s + step]).view(np.int64))
        out[s:s + step] = words_ntt(w.to(dp.ps.device), dp)
    return out.reshape(tuple(np.shape(words)[:-1]) + (np_, n))


def words_ntt(w: torch.Tensor, dp: DevicePlan) -> torch.Tensor:
    """(..., N) int64 tensor of u64 words -> (..., P, N) int32 on its
    device: residues, forward NTT, Montgomery form (key_ntt's words, for a
    key built on the device: the GGSWs of circuit bootstrapping)."""
    return mont_mul(ntt_forward(residues_u64(w, dp), dp), dp.r2s, dp.ps,
                    dp.pinvs).to(torch.int32)


def mask_times_binary_key(masks: torch.Tensor, key_mont: torch.Tensor,
                          dp: DevicePlan) -> torch.Tensor:
    """sum_i m_i * s_i mod (X^N + 1, 2^64) for masks (..., k, N) of u64
    words as int64 and a key (k, P, N) from ``key_ntt``: the products summed
    in the NTT domain and reconstructed once, which equals summing the
    reconstructed products, since the exact sum of a binary key's products
    (|X| <= k N 2^64) stays below P/2."""
    fm = ntt_forward(residues_u64(masks, dp), dp)                # (..., k, P, N)
    col = mont_mul(fm[..., 0, :, :], key_mont[0], dp.ps, dp.pinvs)
    for i in range(1, key_mont.shape[0]):
        col = add_mod(col, mont_mul(fm[..., i, :, :], key_mont[i], dp.ps, dp.pinvs), dp.ps)
    return garner_to_u64(ntt_inverse(col, dp), dp)


def ntt_inverse(x: torch.Tensor, dp: DevicePlan, scale: bool = True) -> torch.Tensor:
    """(..., P, N) NTT domain, bit-reversed, residues in [0, p) -> natural
    order, times N^-1 (without it where scale is False: a product with a
    key that holds N^-1, ops/bsk_prep.py RoundedKeyNtt); each residue in
    [0, p)."""
    n, np_ = dp.n, dp.num_primes
    batch = tuple(x.shape[:-2])
    p = dp.ps[:, :, None]                                    # over (..., P, h, t)
    _, psi_inv, n_inv = normal_twiddles(dp)
    t, m, bound = 1, n, 1
    for s in reversed(psi_inv):                              # (P, h, 1)
        h = m // 2
        xv = x.reshape(batch + (np_, h, 2, t))
        u, v = xv[..., 0, :], xv[..., 1, :]
        a, bound = u + v, 2 * bound
        if bound > _INV_BOUND:
            a, bound = torch.remainder(a, p), 1
        x = torch.stack([a, torch.remainder((u - v) * s, p)], dim=-2
                        ).reshape(batch + (np_, n))
        t *= 2
        m = h
    if scale:
        return torch.remainder(x * n_inv, dp.ps)
    return torch.remainder(x, dp.ps) if bound > 1 else x


@lru_cache(maxsize=None)
def shoup_twiddles(dp: DevicePlan) -> tuple:
    """The forward and inverse twiddles of dp's plan as Shoup pairs for the
    rounded-key kernels (csrc/ntt_common.cuh shoup_mul): (P, N, 2) int32
    tensors on dp's device holding (W, floor(W 2^32 / p)), W the twiddle
    in normal form (the plan keeps Montgomery form, W R mod p)."""
    out = []
    for table in (dp.plan.psi_br_stack, dp.plan.psi_inv_br_stack):
        pairs = np.empty(table.shape + (2,), dtype=np.uint64)
        for i, p in enumerate(dp.plan.primes):
            w = table[i] * _U64(pow(1 << 32, -1, p)) % _U64(p)
            pairs[i, :, 0] = w
            pairs[i, :, 1] = (w << _R_BITS) // _U64(p)
        out.append(torch.from_numpy(pairs.astype(np.uint32).view(np.int32)).to(dp.psi.device))
    return tuple(out)


def pointwise_mul_mont(a_normal, b_mont, dp: DevicePlan):
    """(..., P, N) x (..., P, N Montgomery) -> (..., P, N) normal domain."""
    return mont_mul(a_normal, b_mont, dp.ps, dp.pinvs)


def add_mod_stacked(a, b, dp: DevicePlan):
    return add_mod(a, b, dp.ps)


def _garner_digits(residues: torch.Tensor, dp: DevicePlan) -> list:
    """The mixed-radix digits a_0 .. a_{P-1} (each a_j < p_j) of the integer
    whose residues (..., P, N) these are: a_j = (r_j - sum_{i<j} a_i
    prod_{t<i} p_t) (prod_{t<j} p_t)^-1 mod p_j, each product below 2^60
    (and the sum below 2^63 for up to 8 primes), one remainder a product."""
    primes = dp.plan.primes
    c = garner_consts(primes)
    a = [residues[..., 0, :]]
    for j in range(1, len(primes)):
        v = residues[..., j, :] - a[0]
        for i in range(1, j):
            v = v - a[i] * c["pm"][(i - 1, j)]
        a.append(torch.remainder(torch.remainder(v, primes[j]) * c["inv"][j], primes[j]))
    return a


def garner_to_u64(residues: torch.Tensor, dp: DevicePlan) -> torch.Tensor:
    """(..., P, N) residues of a signed integer |X| < P/2 -> X mod 2^64 as
    (..., N) int64 (tfhe_tpu/ops/ntt.py garner_to_u64)."""
    primes = dp.plan.primes
    c = garner_consts(primes)
    a = _garner_digits(residues, dp)
    out = a[0]
    for i in range(1, len(primes)):
        out = out + a[i] * s64(c["prods64"][i])
    return torch.where(_is_negative(a, primes), out - s64(c["P_mod64"]), out)


# ---------------------------------------------------------------------------
# Device u128 (torch): values as (lo, hi) int64 pairs holding the u64 words;
# carries and borrows use the unsigned compare (ops/torus.py ult)
# ---------------------------------------------------------------------------


def add128(alo, ahi, blo, bhi) -> tuple:
    lo = alo + blo
    return lo, ahi + bhi + ult(lo, alo).to(torch.int64)


def sub128(alo, ahi, blo, bhi) -> tuple:
    return alo - blo, ahi - bhi - ult(alo, blo).to(torch.int64)


def neg128(lo, hi) -> tuple:
    z = torch.zeros_like(lo)
    return sub128(z, z, lo, hi)


def mul_u32_by_u128(a, c_lo: int, c_hi: int) -> tuple:
    """a (int64 values in [0, 2^32)) times the constant (c_lo, c_hi) mod
    2^128 (products wrap in int64, which is u64 arithmetic)."""
    t0 = a * (c_lo & _M32)
    t1 = a * (c_lo >> 32)
    lo = t0 + ((t1 & _M32) << 32)
    hi = shr(t1, 32) + a * s64(c_hi) + ult(lo, t0).to(torch.int64)
    return lo, hi


def to_residues_u128(lo, hi, dp: DevicePlan) -> torch.Tensor:
    """(lo, hi) pairs (..., N) -> (..., P, N) residues: the four 32-bit
    words, each below 2^32, times 2^(32 w) mod p (all below 2^62)."""
    words = (lo & _M32, shr(lo, 32), hi & _M32, shr(hi, 32))
    outs = []
    for p in dp.plan.primes:
        r = words[0] % p
        for w in range(1, 4):
            r = (r + (words[w] % p) * ((1 << (32 * w)) % p)) % p
        outs.append(r)
    return torch.stack(outs, dim=-2)


def garner_to_u128(residues: torch.Tensor, dp: DevicePlan) -> tuple:
    """(..., P, N) residues of a signed integer |X| < P/2 -> X mod 2^128 as
    a (lo, hi) int64 pair (tfhe_tpu/ops/ntt.py garner_to_u128)."""
    c = garner_consts(dp.plan.primes)
    a = _garner_digits(residues, dp)
    lo, hi = a[0], torch.zeros_like(a[0])
    for i in range(1, dp.num_primes):
        lo, hi = add128(lo, hi, *mul_u32_by_u128(a[i], *c["prods128"][i]))
    pm_lo, pm_hi = c["P_mod128"]
    n_lo, n_hi = sub128(lo, hi, torch.full_like(lo, s64(pm_lo)),
                        torch.full_like(hi, s64(pm_hi)))
    neg = _is_negative(a, dp.plan.primes)
    return torch.where(neg, n_lo, lo), torch.where(neg, n_hi, hi)


def forward_u128_mont(lo, hi, dp: DevicePlan) -> torch.Tensor:
    """(..., N) pairs -> (..., P, N) NTT-domain residues in Montgomery form:
    the layout of an NTT-domain u128 key (core/torus128.py
    bootstrap_key128_to_ntt gives the same words on the host)."""
    fwd = ntt_forward(to_residues_u128(lo, hi, dp), dp)
    return mont_mul(fwd, dp.r2s, dp.ps, dp.pinvs)


def mask_times_binary_key_u128(m_lo, m_hi, key_bits, dp: DevicePlan) -> tuple:
    """sum_i m_i * s_i mod (X^N + 1, 2^128) for masks (..., k, N) as int64
    pairs and a binary key (k, N): the products summed in the NTT domain and
    reconstructed once, which equals summing the reconstructed products,
    since the exact sum (|X| <= k N 2^128) stays below P/2."""
    fm = ntt_forward(to_residues_u128(m_lo, m_hi, dp), dp)      # (..., k, P, N)
    fs = forward_u128_mont(key_bits, torch.zeros_like(key_bits), dp)
    col = pointwise_mul_mont(fm[..., 0, :, :], fs[0], dp)
    for i in range(1, key_bits.shape[0]):
        col = add_mod_stacked(col, pointwise_mul_mont(fm[..., i, :, :], fs[i], dp), dp)
    return garner_to_u128(ntt_inverse(col, dp), dp)
