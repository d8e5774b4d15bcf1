"""Batched server-side compute path on int64 torus tensors.

The port of tfhe_tpu/ops/server.py for the shortint atomic patterns
(classic and multi-bit KS->PBS, KS32, PBS->KS, the drift modulus switch,
many-LUT) and for ciphertext compression.  Each function here is the plain
PyTorch version of its tfhe_tpu namesake: the same exact integer
arithmetic, so outputs are the same u64 words.  ``keyswitch``,
``keyswitch32``, ``blind_rotate``, ``cmux_step``, ``cmux_chain``, ``cmux``,
``rotate_accumulator``, the two multi-bit rotations, ``packing_keyswitch``,
``glwe_keyswitch_sum`` and ``blind_rotate_extended`` are also the plain
versions of the CUDA kernels (ops/kernels.py): the pipelines below
(``glwe_keyswitch`` among them) go through the kernel wrappers, which run
these plain versions for CPU tensors.

Torus words are int64 (ops/torus.py): ``shr`` is the logical shift that
u64 ``>>`` means; the one arithmetic shift (the decomposer's carry state)
is int64 ``>>``.  The KS32 pattern's u32 words are int64 in [0, 2^32),
from the keyswitch through the 32-bit modulus switch: every u32 sum and
difference is taken mod 2^32 with ``& M32``.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..core.multibit import monomial_ntt_tables
from . import kernels, ntt
from .bsk_prep import RoundedKeyNtt
from .torus import s64, shr

_HI32 = s64(0xFFFFFFFF00000000)
_HALF32 = 1 << 31
M32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Signed gadget decomposition (tfhe_tpu/ops/server.py:41-75)
# ---------------------------------------------------------------------------


def init_decomposer_state(x, base_log: int, levels: int):
    """Closest-representable rounding with balanced tie-breaking
    (decomposer.rs:156-185)."""
    rep = base_log * levels
    nonrep = 64 - rep
    res = shr(x, nonrep - 1)
    rounding_bit = res & 1
    res = shr(res + 1, 1)
    res = res & ((1 << rep) - 1)
    nb = shr(((res - 1) | (rounding_bit << (rep - 1))) & res, rep - 1)
    return res - (nb << rep)


def signed_decompose(x, base_log: int, levels: int):
    """(levels, ...) signed digits, lowest level first, |digit| <= B/2."""
    state = init_decomposer_state(x, base_log, levels)
    mask = (1 << base_log) - 1
    digits = []
    for _ in range(levels):
        res = state & mask
        state = state >> base_log           # arithmetic, as the reference
        carry = shr(((res - 1) | state) & res, base_log - 1)
        state = state + carry
        digits.append(res - (carry << base_log))
    return torch.stack(digits, dim=0)


# ---------------------------------------------------------------------------
# Keyswitch (plain version of K1)
# ---------------------------------------------------------------------------


def _matmul_wrapping(a, b, max_elems: int = 1 << 25):
    """(B, K) x (K, M) int64 product mod 2^64: torch's int64 matmul on the
    CPU (it wraps), a chunked multiply-reduce elsewhere (torch has no int64
    matmul on CUDA)."""
    if a.device.type == "cpu":
        return a @ b
    bsz, kdim = a.shape
    m = b.shape[1]
    chunk = max(1, max_elems // max(1, bsz * m))
    acc = torch.zeros((bsz, m), dtype=torch.int64, device=a.device)
    for s in range(0, kdim, chunk):
        acc += (a[:, s:s + chunk, None] * b[None, s:s + chunk, :]).sum(dim=1)
    return acc


def keyswitch(ct, ksk, base_log: int, levels: int):
    """Batched LWE keyswitch (tfhe_tpu/ops/server.py:84).

    ct: (B, n_in+1) int64; ksk: (n_in, l, n_out+1) int64.
    out = (0, ..., 0, body) - sum_{i,lev} digit_{i,lev}(ct[b, i]) * ksk[i, lev]
    """
    digits = signed_decompose(ct[:, :-1], base_log, levels)   # (l, B, n_in)
    b = ct.shape[0]
    d = digits.permute(1, 2, 0).reshape(b, -1)                 # (B, n_in*l)
    acc = _matmul_wrapping(d, ksk.reshape(-1, ksk.shape[-1]))
    out = -acc
    out[:, -1] += ct[:, -1]
    return out


def keyswitch32(ct, ksk32, base_log: int, levels: int):
    """The KS32 atomic pattern's keyswitch (tfhe_tpu/ops/server.py:110;
    shortint/atomic_pattern/ks32.rs): a u64 LWE under the big key to a u32
    LWE under the small key.

    ct: (B, n_in+1) int64; ksk32: (n_in, l, n_out+1) int64 holding u32 words.
    The u64 mask is decomposed as ``keyswitch`` decomposes it, the digits
    are contracted with the key mod 2^32, and the body is b >> 32 (logical):
    out = (0, ..., 0, b >> 32) - sum digit * ksk32 mod 2^32, (B, n_out+1)
    int64 in [0, 2^32)."""
    digits = signed_decompose(ct[:, :-1], base_log, levels)   # (l, B, n_in)
    b = ct.shape[0]
    d = digits.permute(1, 2, 0).reshape(b, -1)                 # (B, n_in*l)
    acc = _matmul_wrapping(d, ksk32.reshape(-1, ksk32.shape[-1]))
    out = -acc
    out[:, -1] += shr(ct[:, -1], 32)
    return out & M32


# ---------------------------------------------------------------------------
# Modulus switch
# ---------------------------------------------------------------------------


def modulus_switch(x, log_modulus: int, bits: int = 64):
    """(x + half) >> (bits - log_modulus): values in [0, 2^log_modulus).
    bits = 32 takes u32 words (int64 in [0, 2^32)): the half is added mod
    2^32 before the shift, as u32 arithmetic wraps."""
    if bits == 32:
        return ((x + (1 << (31 - log_modulus))) & M32) >> (32 - log_modulus)
    return shr(x + (1 << (63 - log_modulus)), 64 - log_modulus)


def drift_ms_improve(ct, zeros, log_modulus: int, r_sigma: float,
                     bound: float, input_variance_mod: float):
    """Drift-technique modulus-switch noise reduction
    (tfhe_tpu/ops/server.py:226; modulus_switch_noise_reduction.rs:202):
    among {ct} and {ct + z_i} for the public zero-encryptions z_i, pick per
    batch element the candidate minimising |E[ms error]| + r_sigma *
    std(ms error), computed in float32 from the rounding errors.

    ct: (B, n+1) int64; zeros: (Z, n+1).  Returns the chosen (B, n+1).
    The float32 sums run in one pinned order, column after column, on any
    device (tfhe_tpu's XLA CPU sums in that order for n <= 32, which every
    drift set of the tests has): a reduction in another order can round a
    near tie the other way.  bound is the reference's assertion that some
    candidate meets it; the argmin takes the first smallest measure."""
    shift = 64 - log_modulus
    half = 1 << (shift - 1)
    cands = torch.cat([torch.zeros_like(zeros[:1]), zeros])
    c = ct[None, :, :] + cands[:, None, :]                   # (Z+1, B, n+1)

    def round_err(x):
        return ((shr(x + half, shift) << shift) - x).to(torch.float32)

    mask_err = round_err(c[..., :-1])
    body_err = round_err(c[..., -1])
    total = torch.zeros_like(body_err)
    squares = torch.zeros_like(body_err)
    for i in range(mask_err.shape[-1]):
        col = mask_err[..., i]
        total = total + col
        squares = squares + col * col
    f32 = dict(dtype=torch.float32, device=ct.device)
    expectancy = body_err - total / 2.0
    variance = squares / 4.0
    measure = expectancy.abs() + torch.sqrt(
        variance + torch.tensor(input_variance_mod, **f32)) * torch.tensor(r_sigma, **f32)
    best = torch.argmin(measure, dim=0)                      # (B,)
    return torch.gather(c, 0, best[None, :, None].expand(1, -1, c.shape[-1]))[0]


def centered_binary_ms_correction(ct, log_modulus: int):
    """Body correction of the centered-binary modulus switch
    (tfhe_tpu/ops/server.py:257; modulus_switch.rs:57-120)."""
    mask = ct[..., :-1]
    shift = 64 - log_modulus
    err = (modulus_switch(mask, log_modulus) << shift) - mask
    half_err = torch.div(err, 2, rounding_mode="floor")
    # i64 division truncates toward zero: floor + 1 for odd negatives
    half_err = torch.where((err < 0) & (torch.remainder(err, 2) != 0),
                           half_err + 1, half_err)
    halving_err_doubled = err - 2 * half_err
    correction = (half_err.sum(dim=-1)
                  + torch.div(halving_err_doubled.sum(dim=-1), 2,
                              rounding_mode="floor"))
    return correction - (1 << (shift - 1))


# ---------------------------------------------------------------------------
# Negacyclic monomial rotations
# ---------------------------------------------------------------------------


def _roll_right(x, shift):
    n = x.shape[-1]
    idx = torch.arange(n, device=x.device)
    src = torch.remainder(idx - shift, n)
    return torch.gather(x, -1, src.expand(x.shape))


def monomial_mul(poly, degree):
    """poly * X^degree (negacyclic), degree an int64 tensor in [0, 2N)
    broadcastable to poly's leading dimensions."""
    n = poly.shape[-1]
    cycles, r = degree // n, degree % n
    rotated = _roll_right(poly, r)
    idx = torch.arange(n, device=poly.device)
    out = torch.where(idx < r, -rotated, rotated)
    return torch.where(cycles % 2 == 1, -out, out)


def monomial_div(poly, degree):
    """poly / X^degree (negacyclic): rotate left, negate the last r entries."""
    n = poly.shape[-1]
    cycles, r = degree // n, degree % n
    rotated = _roll_right(poly, torch.remainder(n - r, n))
    idx = torch.arange(n, device=poly.device)
    flip = (idx >= torch.remainder(n - r, n)) & (r != 0)
    out = torch.where(flip, -rotated, rotated)
    return torch.where(cycles % 2 == 1, -out, out)


# ---------------------------------------------------------------------------
# External product & blind rotation (plain version of K2)
# ---------------------------------------------------------------------------


def _forward_digits(glwe, dp: ntt.DevicePlan, base_log: int, levels: int):
    """Signed digits (|d| < p) of (B, k+1, N) words in the NTT domain:
    (l, B, k+1, P, N).  The forward transform takes the signed digits
    themselves, one copy a prime."""
    digits = signed_decompose(glwe, base_log, levels)
    return ntt.ntt_forward(digits.unsqueeze(-2).expand(
        digits.shape[:-1] + (dp.num_primes, digits.shape[-1])), dp)


def _product_sum(fwd, key, dp: ntt.DevicePlan):
    """sum_{lev, r} fwd[lev][:, r] . key[..., lev, r, :] in the NTT domain:
    fwd (l, B, k+1, P, N) normal form; key (l, k+1, k+1, P, N) or
    (B, l, k+1, k+1, P, N), Montgomery form.  Returns (B, k+1, P, N)."""
    key = key.to(torch.int64)
    if key.dim() == 5:
        key = key[None]
    # the key is in Montgomery form, so the sum of products is R times the
    # result: one Montgomery reduction at the end.  Each product < p^2 <
    # 2^60, and the reduction takes sums below 2^62: a longer sum is taken
    # mod p (its scale kept) every four terms
    col, terms = None, 0
    for lev in range(key.shape[1]):
        for r in range(key.shape[2]):
            if terms == 4:
                col, terms = torch.remainder(col, dp.ps), 1
            prod = fwd[lev][:, r, None] * key[:, lev, r]
            col = prod if col is None else col + prod
            terms += 1
    return ntt.redc(col, dp.ps, dp.pinvs)


def external_product(glwe, ggsw, dp: ntt.DevicePlan, base_log: int,
                     levels: int, round_bits: int = 0):
    """GGSW (x) GLWE, exact: glwe (B, k+1, N) int64; ggsw (l, k+1, k+1, P, N)
    Montgomery NTT domain.  Returns the (B, k+1, N) product to add to the
    accumulator (tfhe_tpu/ops/server.py:342).  round_bits > 0: ggsw holds
    N^-1 times the quotients b / 2^rb of a rounded key (RoundedKeyNtt), and
    the reconstructed word is shifted back left by rb."""
    col = _product_sum(_forward_digits(glwe, dp, base_log, levels), ggsw, dp)
    return _reconstruct(col, dp, round_bits)


def _reconstruct(col, dp: ntt.DevicePlan, round_bits: int):
    """The u64 words of NTT-domain sums (B, k+1, P, N): exact key (N^-1 in
    the inverse transform) or rounded key (N^-1 in the key, a left shift by
    round_bits after Garner)."""
    if not round_bits:
        return ntt.garner_to_u64(ntt.ntt_inverse(col, dp), dp)
    return ntt.garner_to_u64(ntt.ntt_inverse(col, dp, scale=False), dp) << round_bits


def _key_view(key, dp: ntt.DevicePlan, grid: bool):
    """(NTT-domain key in the exact layout, plan, round_bits) of an exact
    key tensor (on dp) or a RoundedKeyNtt (its own plan), which takes only
    the 2^32-grid rotations (grid)."""
    if not isinstance(key, RoundedKeyNtt):
        return key, dp, 0
    if not grid:
        raise ValueError("a rounded key runs only the 2^32-grid rotations (v7, v9)")
    return key.canonical(), key.dp, key.round_bits


def _round_to_hi32(x):
    return (x + _HALF32) & _HI32


def initial_accumulator(lut, msed_body, trunc_acc: bool):
    """LUT / X^body, rounded to the 2^32 grid in v7 mode."""
    acc = monomial_div(lut, msed_body[:, None, None])
    return _round_to_hi32(acc) if trunc_acc else acc


def blind_rotate(msed_mask, msed_body, lut, bsk_ntt, dp: ntt.DevicePlan,
                 base_log: int, levels: int, trunc_acc: bool = False):
    """Batched classic blind rotation.

    msed_mask: (B, n) int64 in [0, 2N); msed_body: (B,); lut: (B, k+1, N);
    bsk_ntt: (n, l, k+1, k+1, P, N) int32 Montgomery NTT-domain key.

    trunc_acc=False is the exact rotation (tfhe_tpu/ops/server.py:367).
    trunc_acc=True on a ``round_bsk``-rounded key is the v7 function
    (tfhe_tpu/ops/mxu.py:910 blind_rotate_mxu_trunc): the initial
    accumulator and each step's product rounded to the 2^32 grid.  The
    same function on a RoundedKeyNtt (trunc_acc=True only; dp is then the
    key's own) is the plain version of K2's rounded-key route: three
    primes on the quotients where the bound allows, the same words.
    """
    key, dp, rb = _key_view(bsk_ntt, dp, trunc_acc)
    acc = initial_accumulator(lut, msed_body, trunc_acc)
    for i in range(msed_mask.shape[1]):
        prod = _cmux_product(acc, msed_mask[:, i], key[i], dp, base_log, levels, rb)
        acc = acc + (_round_to_hi32(prod) if trunc_acc else prod)
    return acc


def _cmux_product(acc, a_col, ggsw, dp: ntt.DevicePlan, base_log: int, levels: int,
                  round_bits: int = 0):
    """GGSW (x) (acc * X^a - acc), a per batch element: (B,)."""
    ct1 = monomial_mul(acc, a_col[:, None, None]) - acc
    return external_product(ct1, ggsw, dp, base_log, levels, round_bits)


def cmux_step(acc, a_col, ggsw, dp: ntt.DevicePlan, base_log: int, levels: int):
    """One exact CMux step of the classic blind rotation on an initialised
    accumulator (B, k+1, N): acc + GGSW (x) (acc * X^a - acc), a_col (B,)
    in [0, 2N), ggsw (l, k+1, k+1, P, N).  The plain version of K2's
    single-step entry (kernels.cmux_step): the function of tfhe_tpu's
    build_cmux_step Pallas kernel (tfhe_tpu/ops/pallas_ntt.py:296)."""
    ggsw = _key_view(ggsw, dp, False)[0]
    return acc + _cmux_product(acc, a_col, ggsw, dp, base_log, levels)


def cmux_chain(acc, a_cols, ggsws, key_index, dp: ntt.DevicePlan, base_log: int,
               levels: int):
    """s exact CMux steps for a batch of accumulators, each on its own GGSW
    set: step i is acc_b + GGSW[key_index[b], i] (x) (acc_b * X^{a_cols[b,
    i]} - acc_b), a_cols (B, s) in [0, 2N), ggsws (G, s, l, k+1, k+1, P, N),
    key_index (B,) in [0, G): cmux_step on the gathered GGSWs, one step at
    a time (vertical packing's low bits, tfhe_tpu/shortint/wopbs.py
    vertical_packing, one _cmux a bit).  The plain version of K2's CMux
    chain (kernels.cmux_chain)."""
    index = torch.as_tensor(key_index, device=ggsws.device).long()
    for i in range(a_cols.shape[1]):
        acc = acc + _cmux_product(acc, a_cols[:, i], ggsws[index, i], dp, base_log, levels)
    return acc


def cmux(ct0, ct1, ggsw, dp: ntt.DevicePlan, base_log: int, levels: int):
    """ct0 + GGSW (x) (ct1 - ct0) for a batch sharing one GGSW, exact: the
    CMux of vertical packing (tfhe_tpu/shortint/wopbs.py:212 _cmux).  The
    plain version of K2's CMux entry (kernels.cmux).  ct0, ct1 (B, k+1, N);
    ggsw (l, k+1, k+1, P, N) Montgomery NTT domain."""
    return ct0 + external_product(ct1 - ct0, ggsw, dp, base_log, levels)


def rotate_accumulator(acc, msed_mask, bsk_ntt, dp: ntt.DevicePlan, base_log: int,
                       levels: int):
    """The exact rotation of an initialised accumulator (B, k+1, N): one
    CMux step a column of msed_mask (B, n) in [0, 2N), key (n, l, k+1, k+1,
    P, N).  The plain version of K2's accumulator entry
    (kernels.rotate_accumulator): the common-mask rotation, whose rows
    start at their own bodies (tfhe_tpu/core/cm.py:321-327)."""
    for i in range(msed_mask.shape[1]):
        acc = acc + _cmux_product(acc, msed_mask[:, i], bsk_ntt[i], dp, base_log, levels)
    return acc


def blind_rotate_extended(msed_mask, acc, bsk_ntt, dp: ntt.DevicePlan, base_log: int,
                          levels: int):
    """The extended blind rotation's steps (tfhe_tpu/core/experimental.py:
    297-344; eprint 2025/2214) on the E interleaved accumulators of each
    ciphertext: acc (B, E, k+1, N), E a power of two, msed_mask (B, n) in
    [0, 2 N E), key (n, l, k+1, k+1, P, N) of size N.  Step i: slot j takes
    slot (j - a_i) mod E times X^((E + a_i - 1 - j) >> log E), a degree in
    [0, 2N], then one CMux with GGSW_i advances every slot.  The plain
    version of K8 (kernels.blind_rotate_extended).  Returns the final
    (B, E, k+1, N)."""
    b, e, k1, n_poly = acc.shape
    log_e = e.bit_length() - 1
    slots = torch.arange(e, device=acc.device)
    for i in range(msed_mask.shape[1]):
        a = msed_mask[:, i, None]                                 # (B, 1)
        src = torch.remainder(slots[None, :] - a, e)
        gathered = torch.gather(acc, 1, src[:, :, None, None].expand(b, e, k1, n_poly))
        rotated = monomial_mul(gathered, ((e + a - 1 - slots[None, :]) >> log_e)[:, :, None, None])
        prod = external_product((rotated - acc).reshape(b * e, k1, n_poly), bsk_ntt[i], dp,
                                base_log, levels)
        acc = acc + prod.reshape(b, e, k1, n_poly)
    return acc


def blind_rotate_stepwise(msed_mask, msed_body, lut, bsk_ntt, dp: ntt.DevicePlan,
                          base_log: int, levels: int):
    """The exact blind rotation one CMux step a launch, through K2's
    single-step entry (tfhe_tpu/ops/server.py:488 blind_rotate_pallas): the
    initial monomial division, then ``kernels.cmux_step`` for each mask
    element.  Arguments and result as ``blind_rotate`` in exact mode; a
    RoundedKeyNtt is refused (it runs only the 2^32-grid rotations)."""
    if isinstance(bsk_ntt, RoundedKeyNtt):
        raise ValueError("the stepwise rotation runs the exact rotation on the exact key")
    acc = initial_accumulator(lut, msed_body, False).contiguous()
    for i in range(msed_mask.shape[1]):
        acc = kernels.cmux_step(acc, msed_mask[:, i], bsk_ntt[i], dp, base_log, levels)
    return acc


# ---------------------------------------------------------------------------
# Multi-bit blind rotation (plain versions of K3's two modes)
# ---------------------------------------------------------------------------


def multibit_switched_degrees(mask, grouping: int, log_mod: int,
                              raw: bool = True):
    """Per-group pattern degrees d_u: (B, n) -> (B, n/g, 2^g) int64 in
    [0, 2^log_mod) (tfhe_tpu/ops/server.py:388).

    raw=True: mask holds raw torus words and d_u is the modulus switch of
    the wrapping sum of the u-selected elements (one rounding per pattern).
    raw=False: mask holds switched values and d_u is their sum mod
    2^log_mod.  Selection bits are big-endian (the group's first element is
    u's most significant bit)."""
    b, n = mask.shape
    grouped = mask.reshape(b, n // grouping, grouping)
    sums = [torch.zeros((b, n // grouping), dtype=torch.int64, device=mask.device)]
    for u in range(1, 1 << grouping):
        low = u & (-u)
        sums.append(sums[u ^ low] + grouped[:, :, grouping - low.bit_length()])
    stacked = torch.stack(sums, dim=-1)
    if raw:
        return modulus_switch(stacked, log_mod)
    return stacked & ((1 << log_mod) - 1)


@lru_cache(maxsize=None)
def monomial_table(dp: ntt.DevicePlan) -> tuple:
    """On dp's device: the (P, 4N) int32 table with NTT(X^a)[t] =
    table[:, (2 br(t) + 1) a mod 4N] in Montgomery form
    (core/multibit.py monomial_ntt_tables; residues < 2^30), and the (N,)
    int64 odd exponents 2 br(t) + 1."""
    tables, br = monomial_ntt_tables(dp.n, dp.num_primes)
    device = dp.psi.device
    return (torch.from_numpy(tables.astype(np.int32)).to(device),
            torch.from_numpy(2 * br + 1).to(device))


def _monomial_ntt(degree, dp: ntt.DevicePlan):
    """NTT(X^degree) in Montgomery form: (B,) int64 -> (B, P, N)."""
    table, odd = monomial_table(dp)
    e = (odd[None, :] * degree[:, None]) & (4 * dp.n - 1)
    return table[:, e].permute(1, 0, 2)


def blind_rotate_multibit(degrees, msed_body, lut, mb_key_ntt,
                          dp: ntt.DevicePlan, base_log: int, levels: int):
    """Exact multi-bit blind rotation, the key-bundle form
    (tfhe_tpu/ops/server.py:425): per group j, the effective GGSW
    E_j0 + sum_{u>0} NTT(X^{d_u}) . E_ju is built pointwise in the NTT
    domain and one external product advances the accumulator.

    degrees: (B, n/g, 2^g) in [0, 2N); msed_body: (B,); lut: (B, k+1, N);
    mb_key_ntt: (n/g, 2^g, l, k+1, k+1, P, N) int32 Montgomery NTT domain."""
    mb_key_ntt = _key_view(mb_key_ntt, dp, False)[0]
    acc = initial_accumulator(lut, msed_body, False)
    for j in range(degrees.shape[1]):
        key = mb_key_ntt[j].to(torch.int64)
        eff = key[0]
        for u in range(1, key.shape[0]):
            w = _monomial_ntt(degrees[:, j, u], dp)[:, None, None, None]
            eff = ntt.add_mod_stacked(eff, ntt.pointwise_mul_mont(w, key[u][None], dp), dp)
        col = _product_sum(_forward_digits(acc, dp, base_log, levels), eff, dp)
        acc = ntt.garner_to_u64(ntt.ntt_inverse(col, dp), dp)
    return acc


def blind_rotate_multibit_v9(degrees, msed_body, lut, mb_key_ntt,
                             dp: ntt.DevicePlan, base_log: int, levels: int):
    """The v9 function, monomials on the data side, on a ``round_bsk``-rounded
    key (tfhe_tpu/ops/mxu.py:1133 blind_rotate_mxu_multibit, trunc=True):
    acc0 = round32(LUT / X^body), and per group j
        acc <- round32(sum_u EP(E_ju, X^{d_u} . acc))
    with the exact external product.  The patterns' products are summed in
    the NTT domain and reconstructed once, which equals summing the
    reconstructed products mod 2^64: the sum stays below P/2 (about 2^101
    at GROUP_4 2_2 against 2^119 for the four primes; on a RoundedKeyNtt,
    the plain version of K3's rounded-key route, about 2^83 against 2^89
    for three primes on the quotients).  Arguments as in
    ``blind_rotate_multibit``; mb_key_ntt may be a RoundedKeyNtt (dp is
    then the key's own)."""
    keys, dp, rb = _key_view(mb_key_ntt, dp, True)
    acc = initial_accumulator(lut, msed_body, True)
    for j in range(degrees.shape[1]):
        key = keys[j]
        col = None
        for u in range(key.shape[0]):
            rot = monomial_mul(acc, degrees[:, j, u, None, None])
            prod = _product_sum(_forward_digits(rot, dp, base_log, levels), key[u], dp)
            col = prod if col is None else ntt.add_mod_stacked(col, prod, dp)
        acc = _round_to_hi32(_reconstruct(col, dp, rb))
    return acc


def sample_extract(glwe):
    """Constant coefficient as an LWE: (B, k+1, N) -> (B, k*N + 1);
    out[0] = m[0], out[j] = -m[N-j] (glwe_sample_extraction.rs)."""
    b = glwe.shape[0]
    mask = glwe[:, :-1, :]
    rolled = torch.roll(-torch.flip(mask, dims=[-1]), 1, dims=-1)
    rolled[:, :, 0] = mask[:, :, 0]
    return torch.cat([rolled.reshape(b, -1), glwe[:, -1, :1]], dim=-1)


def extract_slots(glwe, degrees):
    """Coefficient degrees[j] of one (k+1, N) GLWE as LWE j, (B, k*N + 1):
    monomial_div by each degree, then sample_extract, in one batched call
    (tfhe_tpu makes one call of each a slot: compact lists, proven lists,
    re-randomization; the same words)."""
    deg = torch.as_tensor(degrees, dtype=torch.int64, device=glwe.device)
    return sample_extract(monomial_div(glwe.expand((len(deg),) + tuple(glwe.shape)),
                                       deg[:, None, None]))


# ---------------------------------------------------------------------------
# GLWE keyswitch (plain version of K7)
# ---------------------------------------------------------------------------


def glwe_keyswitch_sum(glwe, key, dp: ntt.DevicePlan, base_log: int, levels: int,
                       add_sum: bool = False):
    """sum_{i, lev} decomp_lev(mask_i) (*) key[i][lev] for a batch of GLWEs
    (B, k_in+1, N) and a non-square (k_in, l, k_out+1, P, N) Montgomery
    NTT-domain key, summed in the NTT domain on the four primes and
    reconstructed once with Garner; then the body: (0, body) - sum
    (tfhe_tpu/ops/server.py:862 glwe_keyswitch) or, with add_sum, sum +
    (0, body) (tfhe_tpu/core/experimental.py:218 glwe_fast_keyswitch, whose
    pseudo-GGSW encrypts -S_in).  The plain version of K7
    (kernels.glwe_keyswitch): tfhe_tpu's words at every shape, the CRT's
    wrap above P/2 included.  Returns (B, k_out+1, N)."""
    fwd = _forward_digits(glwe[:, :-1], dp, base_log, levels)     # (l, B, k_in, P, N)
    total = _reconstruct(_product_sum(fwd, key.transpose(0, 1), dp), dp, 0)
    out = total if add_sum else -total
    out[:, -1] += glwe[:, -1]
    return out


def glwe_keyswitch(glwe, gksk_ntt, dp: ntt.DevicePlan, base_log: int, levels: int):
    """GLWE-to-GLWE keyswitch (tfhe_tpu/ops/server.py:862;
    algorithms/glwe_keyswitch.rs), through K7: glwe (B, k_in+1, N) under
    S_in, gksk_ntt (k_in, l, k_out+1, P, N) from
    core/keygen.py generate_glwe_keyswitch_key.  Returns (B, k_out+1, N)
    under S_out: (0, body) - sum_{i,l} decomp_l(mask_i) (*) gksk[i][l]."""
    return kernels.glwe_keyswitch(glwe, gksk_ntt, dp, base_log, levels, add_sum=False)


# ---------------------------------------------------------------------------
# Packing keyswitch: LWE list -> GLWEs (plain version of K4)
# ---------------------------------------------------------------------------


def packing_keyswitch(lwes, pksk, base_log: int, levels: int,
                      lwe_per_glwe: int):
    """Pack each run of lwe_per_glwe LWEs into one GLWE encrypting
    sum_j m_j X^j (tfhe_tpu/ops/server.py:537 packing_keyswitch, called once
    per run by tfhe_tpu/shortint/compression.py:236-244).

    lwes: (B, n+1) int64; pksk: (n, l, k+1, N) int64, the standard-domain
    GLWE encryptions of each input key element.  Returns (ceil(B /
    lwe_per_glwe), k+1, N):
        out = (0, B(X)) - sum_{i, lev} D_{i,lev}(X) * PKSK_{i,lev}(X)
    mod (X^N + 1, 2^64), where D_{i,lev} holds the signed digit of mask
    element i of LWE j as its coefficient j and B(X) holds the bodies.
    tfhe_tpu takes the product exactly over a 4-prime CRT-NTT, whose
    integer (|X| < 8 * 2^64 * N n l) stays far below P/2, so it equals the
    product taken directly in wrapping int64, as here: coefficient t of
    D_j X^j * K(X) is D_j * Kx[t - j + N], with Kx = (-K, K) the negacyclic
    extension."""
    n_in, _, k1, n_poly = pksk.shape
    kx = torch.cat([-pksk, pksk], dim=-1).reshape(n_in * levels, k1 * 2 * n_poly)
    coeff = torch.arange(n_poly, device=lwes.device)
    out = []
    for start in range(0, lwes.shape[0], lwe_per_glwe):
        chunk = lwes[start:start + lwe_per_glwe]
        b = chunk.shape[0]
        digits = signed_decompose(chunk[:, :-1], base_log, levels)   # (l, b, n)
        w = _matmul_wrapping(digits.permute(1, 2, 0).reshape(b, -1), kx)
        src = coeff[None, :] - torch.arange(b, device=lwes.device)[:, None] + n_poly
        glwe = -torch.gather(w.reshape(b, k1, 2 * n_poly), 2,
                             src[:, None, :].expand(b, k1, n_poly)).sum(dim=0)
        glwe[-1, :b] += chunk[:, -1]
        out.append(glwe)
    return torch.stack(out)


# ---------------------------------------------------------------------------
# The fused KS -> MS -> BR -> SE pipeline and its two halves
# ---------------------------------------------------------------------------


def keyswitch_then_drift(ct, ksk, log_mod: int, ks_base_log: int, ks_levels: int,
                         drift_zeros=None, drift_r_sigma: float = 0.0,
                         drift_bound: float = 0.0, drift_input_variance: float = 0.0):
    """The u64 keyswitch (K1) and, with drift_zeros, the drift choice among
    the keyswitched ciphertext and its sums with the zero-encryptions."""
    ks = kernels.keyswitch(ct, ksk, ks_base_log, ks_levels)
    if drift_zeros is not None:
        ks = drift_ms_improve(ks, drift_zeros, log_mod, drift_r_sigma, drift_bound,
                              drift_input_variance)
    return ks


def ks_ms_batch(ct, ksk, log_mod: int, ks_base_log: int, ks_levels: int,
                centered_ms: bool = False, ks32: bool = False, drift_zeros=None,
                drift_r_sigma: float = 0.0, drift_bound: float = 0.0,
                drift_input_variance: float = 0.0):
    """First half of the atomic pattern, keyswitch then modulus switch
    (tfhe_tpu/ops/server.py:712 ks_ms_batch): (B, n_small+1) values in
    [0, 2^log_mod), what blind rotation takes and what a
    CompressedModulusSwitchedCiphertext stores.  ks32: the u32 keyswitch
    (K1-32) and the 32-bit modulus switch, with no centered-mean correction
    and no drift, as tfhe_tpu's KS32 branch; else the u64 keyswitch (K1),
    the drift choice where drift_zeros are given, and the centered-mean
    correction where asked."""
    if ks32:
        ks = kernels.keyswitch32(ct, ksk, ks_base_log, ks_levels)
        return modulus_switch(ks, log_mod, 32)
    ks = keyswitch_then_drift(ct, ksk, log_mod, ks_base_log, ks_levels, drift_zeros,
                              drift_r_sigma, drift_bound, drift_input_variance)
    body = ks[:, -1]
    if centered_ms:
        body = body + centered_binary_ms_correction(ks, log_mod)
    return torch.cat([modulus_switch(ks[:, :-1], log_mod),
                      modulus_switch(body, log_mod)[:, None]], dim=1)


def pbs_from_switched_batch(msed, lut, bsk_ntt, dp: ntt.DevicePlan,
                            pbs_base_log: int, pbs_levels: int,
                            trunc_acc: bool = False):
    """Second half: blind rotation (through K2) and sample extract of
    already switched (B, n+1) values (tfhe_tpu/ops/server.py:770
    pbs_from_switched_batch; with trunc_acc on a rounded key, :1026
    pbs_from_switched_batch_mxu, whose kernel="v8" is the v7 function)."""
    acc = kernels.blind_rotate(msed[:, :-1], msed[:, -1], lut, bsk_ntt, dp,
                               pbs_base_log, pbs_levels, trunc_acc)
    return sample_extract(acc)


def pbs_from_switched_batch_multibit(msed, lut, mb_key_ntt, dp: ntt.DevicePlan,
                                     pbs_base_log: int, pbs_levels: int,
                                     grouping: int):
    """The multi-bit second half (tfhe_tpu/ops/server.py:695): the pattern
    degrees are sums of the stored switched values (raw=False), and K3 runs
    in exact mode, as tfhe_tpu runs this path on every backend."""
    degrees = multibit_switched_degrees(msed[:, :-1], grouping,
                                        lut.shape[-1].bit_length(), raw=False)
    acc = kernels.blind_rotate_multibit(degrees, msed[:, -1], lut, mb_key_ntt,
                                        dp, pbs_base_log, pbs_levels, False)
    return sample_extract(acc)


def ks_pbs_batch(ct, lut, ksk, bsk_ntt, dp: ntt.DevicePlan, ks_base_log: int,
                 ks_levels: int, pbs_base_log: int, pbs_levels: int,
                 centered_ms: bool = False, trunc_acc: bool = False,
                 ks32: bool = False, drift_zeros=None, drift_r_sigma: float = 0.0,
                 drift_bound: float = 0.0, drift_input_variance: float = 0.0):
    """One batched KS->PBS (tfhe_tpu/ops/server.py:609 ks_pbs_batch; with
    trunc_acc and a rounded key, :920 ks_pbs_batch_mxu kernel="v7").

    ct: (B, n_big+1); lut: (B, k+1, N); ksk: (n_big, l_ks, n_small+1) or
    its kernels.KeyswitchKeyLimbs (ServerKey.ks_key);
    bsk_ntt: (n_small, l_pbs, k+1, k+1, P, N).  Returns (B, n_big+1).
    Keyswitch and blind rotation go through the kernel wrappers; ks32 and
    the drift arguments as in ``ks_ms_batch``.
    """
    msed = ks_ms_batch(ct, ksk, lut.shape[-1].bit_length(), ks_base_log,
                       ks_levels, centered_ms, ks32, drift_zeros, drift_r_sigma,
                       drift_bound, drift_input_variance)
    return pbs_from_switched_batch(msed, lut, bsk_ntt, dp, pbs_base_log,
                                   pbs_levels, trunc_acc)


def ks_pbs_batch_multibit(ct, lut, ksk, mb_key_ntt, dp: ntt.DevicePlan,
                          ks_base_log: int, ks_levels: int, pbs_base_log: int,
                          pbs_levels: int, grouping: int,
                          centered_ms: bool = False, v9: bool = False,
                          ks32: bool = False, drift_zeros=None,
                          drift_r_sigma: float = 0.0, drift_bound: float = 0.0,
                          drift_input_variance: float = 0.0):
    """The multi-bit atomic pattern KS -> MS -> multi-bit blind rotation ->
    SE (tfhe_tpu/ops/server.py:657 ks_pbs_batch_multibit; with v9 and a
    rounded key, :977 ks_pbs_batch_mxu_multibit).  The degrees are modulus
    switches of raw mask sums (ks32: of the u32 mask shifted to the u64
    torus, the body switched at 32 bits); keyswitch and blind rotation go
    through the kernel wrappers.  mb_key_ntt: (n/g, 2^g, l, k+1, k+1, P, N)."""
    log_mod = lut.shape[-1].bit_length()
    if ks32:
        ks = kernels.keyswitch32(ct, ksk, ks_base_log, ks_levels)
        mask, body = ks[:, :-1] << 32, modulus_switch(ks[:, -1], log_mod, 32)
    else:
        ks = keyswitch_then_drift(ct, ksk, log_mod, ks_base_log, ks_levels, drift_zeros,
                                  drift_r_sigma, drift_bound, drift_input_variance)
        mask, body = ks[:, :-1], ks[:, -1]
        if centered_ms:
            body = body + centered_binary_ms_correction(ks, log_mod)
        body = modulus_switch(body, log_mod)
    acc = kernels.blind_rotate_multibit(
        multibit_switched_degrees(mask, grouping, log_mod), body, lut, mb_key_ntt, dp,
        pbs_base_log, pbs_levels, v9)
    return sample_extract(acc)


def pbs_ks_batch(ct, lut, ksk, bsk_ntt, dp: ntt.DevicePlan, ks_base_log: int,
                 ks_levels: int, pbs_base_log: int, pbs_levels: int,
                 centered_ms: bool = False):
    """The PBS->KS order (tfhe_tpu/ops/server.py:741 pbs_ks_batch;
    PBSOrder::BootstrapKeyswitch, the SMALL-key sets): ciphertexts live
    under the small key, so a LUT is modulus switch -> exact blind rotation
    (K2) -> extract (onto the big key) -> keyswitch back down (K1).
    ct: (B, n_small+1); returns (B, n_small+1)."""
    log_mod = lut.shape[-1].bit_length()
    body = ct[:, -1]
    if centered_ms:
        body = body + centered_binary_ms_correction(ct, log_mod)
    msed = torch.cat([modulus_switch(ct[:, :-1], log_mod),
                      modulus_switch(body, log_mod)[:, None]], dim=1)
    big = pbs_from_switched_batch(msed, lut, bsk_ntt, dp, pbs_base_log, pbs_levels)
    return kernels.keyswitch(big, ksk, ks_base_log, ks_levels)


def extract_many(acc, extract_offsets) -> torch.Tensor:
    """One sample extraction at each coefficient offset of a rotated
    accumulator (B, k+1, N): (B, len(offsets), k N + 1)."""
    b = acc.shape[0]
    return torch.stack([sample_extract(monomial_div(
        acc, torch.full((b, 1, 1), off, dtype=torch.int64, device=acc.device)))
        for off in extract_offsets], dim=1)


def ks_pbs_many_batch(ct, lut, ksk, bsk_ntt, dp: ntt.DevicePlan, ks_base_log: int,
                      ks_levels: int, pbs_base_log: int, pbs_levels: int,
                      extract_offsets: tuple, centered_ms: bool = False,
                      ks32: bool = False, drift_zeros=None, drift_r_sigma: float = 0.0,
                      drift_bound: float = 0.0, drift_input_variance: float = 0.0):
    """Many-LUT (tfhe_tpu/ops/server.py:791; server_key/mod.rs:922): one
    KS -> MS (with the KS32, drift and centered-mean options of
    ``ks_ms_batch``) -> exact blind rotation on the unrounded key, then one
    sample extraction a function at its coefficient offset.  tfhe_tpu runs
    the exact rotation here on every backend, v7-family keys included (its
    TPU path, blind_rotate_pallas_v2): on the card, K2's exact mode.
    Returns (B, len(extract_offsets), n_big+1)."""
    msed = ks_ms_batch(ct, ksk, lut.shape[-1].bit_length(), ks_base_log, ks_levels,
                       centered_ms, ks32, drift_zeros, drift_r_sigma, drift_bound,
                       drift_input_variance)
    acc = kernels.blind_rotate(msed[:, :-1], msed[:, -1], lut, bsk_ntt, dp,
                               pbs_base_log, pbs_levels, False)
    return extract_many(acc, extract_offsets)


def pbs_many_from_switched_multibit(msed, lut, mb_key_ntt, dp: ntt.DevicePlan,
                                    pbs_base_log: int, pbs_levels: int, grouping: int,
                                    extract_offsets: tuple):
    """The multi-bit many-LUT tail (tfhe_tpu/ops/server.py:893): one exact
    multi-bit rotation (K3 exact mode) of switched values, the degrees sums
    of them (raw=False), then one extraction a function.
    Returns (B, len(extract_offsets), n_big+1)."""
    degrees = multibit_switched_degrees(msed[:, :-1], grouping,
                                        lut.shape[-1].bit_length(), raw=False)
    acc = kernels.blind_rotate_multibit(degrees, msed[:, -1], lut, mb_key_ntt, dp,
                                        pbs_base_log, pbs_levels, False)
    return extract_many(acc, extract_offsets)


# ---------------------------------------------------------------------------
# LUT generation (host)
# ---------------------------------------------------------------------------


def generate_lut(polynomial_size: int, glwe_size: int, message_modulus: int,
                 delta: int, f) -> np.ndarray:
    """Programmable-bootstrap LUT as a trivial GLWE (mod.rs:26-79):
    (glwe_size, N) uint64, zero mask, redundant-box body."""
    n = polynomial_size
    box = n // message_modulus
    acc = np.zeros(n, dtype=np.uint64)
    for i in range(message_modulus):
        acc[i * box:(i + 1) * box] = (int(f(i)) * delta) % (1 << 64)
    half_box = box // 2
    acc[:half_box] = (-acc[:half_box].astype(np.int64)).astype(np.uint64)
    acc = np.roll(acc, -half_box)
    out = np.zeros((glwe_size, n), dtype=np.uint64)
    out[-1] = acc
    return out
