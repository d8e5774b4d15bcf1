"""u128-torus server path: the PBS128 of noise squashing, on int64 pairs.

The port of tfhe_tpu/ops/server128.py.  Each function is the plain PyTorch
version of its tfhe_tpu namesake, with the same exact integer arithmetic,
so the (lo, hi) words are the same.  ``blind_rotate128`` is also the plain
version of the CUDA kernel K5 (csrc/blind_rotate128.cu), and
``packing_keyswitch128`` that of K6 (csrc/packing_keyswitch128.cu):
``ks_pbs128_batch`` and squashed-noise compression go through the kernel
wrappers (ops/kernels.py), which run the plain
versions for CPU tensors.

A u128 tensor travels as a (lo, hi) pair of int64 tensors holding the two
u64 words (ops/torus.py); shifts and compares take their unsigned meaning
through ``shr`` and ``ult``.
"""

from __future__ import annotations

import numpy as np
import torch

from . import kernels, ntt
from .server import _product_sum, _roll_right, modulus_switch
from .torus import shr

# ---------------------------------------------------------------------------
# Pair helpers (static shift amounts; tfhe_tpu/ops/server128.py:30-78)
# ---------------------------------------------------------------------------


def _shr128(lo, hi, s: int) -> tuple:
    """Logical right shift of a pair by 0 <= s < 128."""
    if s == 0:
        return lo, hi
    if s < 64:
        return shr(lo, s) | (hi << (64 - s)), shr(hi, s)
    return shr(hi, s - 64), torch.zeros_like(hi)


def _sar128(lo, hi, s: int) -> tuple:
    """Arithmetic right shift of a pair by 0 <= s < 64."""
    if s == 0:
        return lo, hi
    return shr(lo, s) | (hi << (64 - s)), hi >> s


def _shl128(lo, hi, s: int) -> tuple:
    """Left shift of a pair by 0 <= s < 128."""
    if s == 0:
        return lo, hi
    if s < 64:
        return lo << s, (hi << s) | shr(lo, 64 - s)
    return torch.zeros_like(lo), lo << (s - 64)


def _bit128(lo, hi, i: int):
    """Bit i of the pair, as int64 0/1."""
    return shr(lo, i) & 1 if i < 64 else shr(hi, i - 64) & 1


def _mask128(lo, hi, nbits: int) -> tuple:
    """The low nbits of the pair."""
    if nbits >= 128:
        return lo, hi
    if nbits > 64:
        return lo, hi & ((1 << (nbits - 64)) - 1)
    if nbits == 64:
        return lo, torch.zeros_like(hi)
    return lo & ((1 << nbits) - 1), torch.zeros_like(hi)


# ---------------------------------------------------------------------------
# Signed gadget decomposition on the u128 torus
# ---------------------------------------------------------------------------


def signed_decompose128(lo, hi, base_log: int, levels: int) -> list:
    """decomposer.rs semantics on 128-bit values (tfhe_tpu/ops/server128.py:81):
    the digits, lowest level first, as sign-wrapped (lo, hi) pairs with
    |digit| <= B/2."""
    rep = base_log * levels
    assert rep < 128 and base_log <= 63
    r_lo, r_hi = _shr128(lo, hi, 128 - rep - 1)
    rounding = r_lo & 1
    one, zero = torch.ones_like(r_lo), torch.zeros_like(r_lo)
    r_lo, r_hi = _mask128(*_shr128(*ntt.add128(r_lo, r_hi, one, zero), 1), rep)
    # need-balance bit: (((res - 1) | (rounding << (rep-1))) & res) >> (rep-1)
    rm1_lo, rm1_hi = ntt.sub128(r_lo, r_hi, one, zero)
    rb_lo, rb_hi = _shl128(rounding, zero, rep - 1)
    nb = _bit128((rm1_lo | rb_lo) & r_lo, (rm1_hi | rb_hi) & r_hi, rep - 1)
    s_lo, s_hi = ntt.sub128(r_lo, r_hi, *_shl128(nb, zero, rep))
    mask = (1 << base_log) - 1
    digits = []
    for _ in range(levels):
        d = s_lo & mask
        s_lo, s_hi = _sar128(s_lo, s_hi, base_log)
        carry = shr(((d - 1) | s_lo) & d, base_log - 1)
        s_lo, s_hi = ntt.add128(s_lo, s_hi, carry, zero)
        digits.append(ntt.sub128(d, zero, *_shl128(carry, zero, base_log)))
    return digits


def _digit_residues128(d_lo, d_hi, dp: ntt.DevicePlan) -> torch.Tensor:
    """Sign-wrapped digits (|d| < 2^63) -> (..., P, N) residues, the
    magnitude reduced mod p (tfhe_tpu/ops/server128.py:117)."""
    neg = d_hi < 0
    mag = torch.where(neg, -d_lo, d_lo)
    outs = []
    for p in dp.plan.primes:
        m = mag % p
        outs.append(torch.where(neg & (m != 0), p - m, m))
    return torch.stack(outs, dim=-2)


# ---------------------------------------------------------------------------
# Negacyclic monomial rotations on pairs
# ---------------------------------------------------------------------------


def monomial_mul128(lo, hi, degree) -> tuple:
    """poly * X^degree (negacyclic), degree an int64 tensor in [0, 2N)
    broadcastable to the leading dimensions."""
    n = lo.shape[-1]
    cycles, r = degree // n, degree % n
    rl, rh = _roll_right(lo, r), _roll_right(hi, r)
    flip = (torch.arange(n, device=lo.device) < r) ^ (cycles % 2 == 1)
    nl, nh = ntt.neg128(rl, rh)
    return torch.where(flip, nl, rl), torch.where(flip, nh, rh)


def monomial_div128(lo, hi, degree) -> tuple:
    """poly / X^degree (negacyclic)."""
    n = lo.shape[-1]
    cycles, r = degree // n, degree % n
    shift = torch.remainder(n - r, n)
    rl, rh = _roll_right(lo, shift), _roll_right(hi, shift)
    flip = ((torch.arange(n, device=lo.device) >= shift) & (r != 0)) ^ (cycles % 2 == 1)
    nl, nh = ntt.neg128(rl, rh)
    return torch.where(flip, nl, rl), torch.where(flip, nh, rh)


# ---------------------------------------------------------------------------
# External product and blind rotation over u128 (plain version of K5)
# ---------------------------------------------------------------------------


def external_product128(g_lo, g_hi, ggsw, dp: ntt.DevicePlan, base_log: int,
                        levels: int) -> tuple:
    """GGSW (x) GLWE over the u128 torus: g (B, k+1, N) pairs; ggsw
    (l, k+1, k+1, P, N) Montgomery NTT domain.  Returns the (lo, hi) product
    (tfhe_tpu/ops/server128.py:166)."""
    fwd = torch.stack([ntt.ntt_forward(_digit_residues128(*d, dp), dp)
                       for d in signed_decompose128(g_lo, g_hi, base_log, levels)])
    col = _product_sum(fwd, ggsw, dp)
    return ntt.garner_to_u128(ntt.ntt_inverse(col, dp), dp)


def blind_rotate128(msed_mask, msed_body, lut_lo, lut_hi, bsk_ntt,
                    dp: ntt.DevicePlan, base_log: int, levels: int) -> tuple:
    """Batched exact 128-bit blind rotation (tfhe_tpu/ops/server128.py:185).

    msed_mask: (B, n) int64 in [0, 2N); msed_body: (B,); lut pair:
    (B, k+1, N); bsk_ntt: (n, l, k+1, k+1, P, N) int32 Montgomery NTT
    domain, P = 6.  Returns the (lo, hi) accumulator."""
    acc_lo, acc_hi = monomial_div128(lut_lo, lut_hi, msed_body[:, None, None])
    for i in range(msed_mask.shape[1]):
        r_lo, r_hi = monomial_mul128(acc_lo, acc_hi, msed_mask[:, i, None, None])
        c_lo, c_hi = ntt.sub128(r_lo, r_hi, acc_lo, acc_hi)
        p_lo, p_hi = external_product128(c_lo, c_hi, bsk_ntt[i], dp, base_log, levels)
        acc_lo, acc_hi = ntt.add128(acc_lo, acc_hi, p_lo, p_hi)
    return acc_lo, acc_hi


def sample_extract128(g_lo, g_hi) -> tuple:
    """Constant-coefficient extraction: (B, k+1, N) pairs -> (B, k N + 1)
    pairs; out[0] = m[0], out[j] = -m[N-j]."""
    b = g_lo.shape[0]
    m_lo, m_hi = g_lo[:, :-1, :], g_hi[:, :-1, :]
    f_lo, f_hi = ntt.neg128(torch.flip(m_lo, dims=[-1]), torch.flip(m_hi, dims=[-1]))
    outs = []
    for f, m, g in ((f_lo, m_lo, g_lo), (f_hi, m_hi, g_hi)):
        r = torch.roll(f, 1, dims=-1)
        r[:, :, 0] = m[:, :, 0]
        outs.append(torch.cat([r.reshape(b, -1), g[:, -1, :1]], dim=-1))
    return outs[0], outs[1]


def ks_pbs128_batch(ct, lut_lo, lut_hi, ksk, bsk128_ntt, dp128: ntt.DevicePlan,
                    ks_base_log: int, ks_levels: int, pbs_base_log: int,
                    pbs_levels: int) -> tuple:
    """Noise squashing's pipeline: u64 keyswitch (K1), the plain modulus
    switch to log 2N (no centered-mean correction, as tfhe_tpu's
    server128.py:265-266), the 128-bit blind rotation (K5) and sample
    extract (tfhe_tpu/ops/server128.py:249, without its Pallas arguments).

    ct: (B, n_big+1) int64; lut pair: (B, k+1, N); ksk u64 words as int64
    (or their kernels.KeyswitchKeyLimbs);
    bsk128_ntt: (n_small, l, k+1, k+1, 6, N) int32.  Returns the (lo, hi)
    pair of shape (B, k N + 1)."""
    log_mod = lut_lo.shape[-1].bit_length()
    ks = kernels.keyswitch(ct, ksk, ks_base_log, ks_levels)
    a_lo, a_hi = kernels.blind_rotate128(
        modulus_switch(ks[:, :-1], log_mod), modulus_switch(ks[:, -1], log_mod),
        lut_lo, lut_hi, bsk128_ntt, dp128, pbs_base_log, pbs_levels)
    return sample_extract128(a_lo, a_hi)


# input coefficients whose key rows the plain packing keyswitch transforms
# at once (bounds its NTT-domain products to about 10^8 int64 words)
PKS128_KEY_ROWS = 256


def packing_keyswitch128(lwe_lo, lwe_hi, key_lo, key_hi, dp: ntt.DevicePlan,
                         base_log: int, levels: int) -> tuple:
    """The u128 packing keyswitch of squashed-noise compression
    (tfhe_tpu/shortint/noise_squashing.py:299-342 compress, its formula on
    the torch half of the 8-prime CRT-NTT): the plain version of K6
    (kernels.packing_keyswitch128).

    lwe pair: (G, C, n+1), list g's LWEs at slots 0 .. C-1 (zero rows add
    nothing); key pair: (n, l, k+1, N) standard domain; dp: an 8-prime plan
    of N, where the exact sum (|X| < n l N 2^(base_log-1) 2^128) stays below
    P/2.  Returns the (lo, hi) pair (G, k+1, N):
        out = (0, B(X)) - sum_{i, lev} D_{i,lev}(X) * K_{i,lev}(X)
    mod (X^N + 1, 2^128), D_{i,lev} the signed digits of mask element i of
    LWE j at coefficient j, B(X) the bodies."""
    g, c, w = lwe_lo.shape
    n_in, _, k1, n_poly = key_lo.shape
    a_lo = lwe_lo.new_zeros((g, n_in, n_poly))
    a_hi = lwe_hi.new_zeros((g, n_in, n_poly))
    a_lo[:, :, :c] = lwe_lo[:, :, :-1].transpose(1, 2)
    a_hi[:, :, :c] = lwe_hi[:, :, :-1].transpose(1, 2)
    digits = signed_decompose128(a_lo, a_hi, base_log, levels)    # l x (G, n, N)
    col = torch.zeros((g, k1, dp.num_primes, n_poly), dtype=torch.int64, device=lwe_lo.device)
    for s in range(0, n_in, PKS128_KEY_ROWS):
        e = s + PKS128_KEY_ROWS
        kf = ntt.forward_u128_mont(key_lo[s:e], key_hi[s:e], dp)  # (r, l, k+1, P, N)
        for lev, (d_lo, d_hi) in enumerate(digits):
            fwd = ntt.ntt_forward(_digit_residues128(d_lo[:, s:e], d_hi[:, s:e], dp), dp)
            prod = ntt.pointwise_mul_mont(fwd[:, :, None], kf[None, :, lev], dp)
            col = torch.remainder(col + prod.sum(dim=1), dp.ps)
    s_lo, s_hi = ntt.garner_to_u128(ntt.ntt_inverse(col, dp), dp)
    out_lo, out_hi = ntt.neg128(s_lo, s_hi)
    b_lo, b_hi = ntt.add128(out_lo[:, -1, :c], out_hi[:, -1, :c], lwe_lo[:, :, -1],
                            lwe_hi[:, :, -1])
    out_lo[:, -1, :c], out_hi[:, -1, :c] = b_lo, b_hi
    return out_lo, out_hi


def generate_lut128(polynomial_size: int, glwe_size: int, cleartext_space: int,
                    delta128: int, f) -> tuple:
    """PBS LUT over the u128 torus as a (lo, hi) numpy uint64 pair of shape
    (glwe_size, N): a trivial GLWE, zero mask, redundant-box body
    (tfhe_tpu/ops/server128.py:279)."""
    n = polynomial_size
    box = n // cleartext_space
    m = (1 << 128) - 1
    acc = [0] * n
    for i in range(cleartext_space):
        v = (int(f(i)) * delta128) & m
        for j in range(i * box, (i + 1) * box):
            acc[j] = v
    half_box = box // 2
    for j in range(half_box):
        acc[j] = (-acc[j]) & m
    acc = acc[half_box:] + acc[:half_box]
    out_lo = np.zeros((glwe_size, n), dtype=np.uint64)
    out_hi = np.zeros((glwe_size, n), dtype=np.uint64)
    out_lo[-1] = [x & ((1 << 64) - 1) for x in acc]
    out_hi[-1] = [x >> 64 for x in acc]
    return out_lo, out_hi
