"""Preparation of the bootstrapping key for the v7 and v9 blind rotations:
mask flooring at key generation, centered rounding, the multi-bit rounding
rule, and the rounded key in the kernels' layout.

Counterpart: tfhe_tpu/ops/mxu.py ``mask_floor_bsk``, ``round_bsk``,
``assert_crt_bound``, ``_prep_bsk_data`` (:201-300) and
``multibit_assert_crt_bound`` (:971-991).  Both packages must hold the same
key bytes, so the flooring keeps tfhe_tpu's float64 matrix product, which
is exact here (|sum| <= N * 2^rb < 2^53).  A multi-bit key is floored and
rounded flattened to (n/g 2^g, l, k+1, k+1, N).

``rounded_key_ntt`` builds, on the key's device, what K2 in v7 mode and K3
in v9 mode read (``RoundedKeyNtt``): the NTT of the signed quotients
b' = centered(round(b)) / 2^rb over the fewest of the port's primes whose
product clears the CRT bound (three at the production sets), N^-1 folded
in.  The rotation's product on it is 2^-rb times the product on the
rounded key, exactly, so shifting the reconstructed word left by rb gives
the same u64 words as the four-prime product on ``round_bsk(bsk, rb)``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..core.entities import LweBootstrapKey
from ..utils.device import resolve_device
from . import ntt

# the first three of tfhe_tpu's 28-bit MXU primes (tfhe_tpu/ops/mxu.py:44):
# the v9 rounding is sized for its 3-prime product
MXU_PRIMES_3 = (268369921, 268361729, 268271617)


def mask_floor_bsk(bsk: LweBootstrapKey, glwe_sk, round_bits: int,
                   device="cuda") -> LweBootstrapKey:
    """Exact, phase-preserving move of each GLWE row's low mask bits into its
    body: r_j = a_j mod 2^rb, a'_j = a_j - r_j, b' = b - sum_j r_j (*) s_j
    (negacyclic, mod 2^64).  b' - <a', s> = b - <a, s>, so no noise is added
    and a later ``round_bsk`` only perturbs the body.  Needs the GLWE secret
    key, so it runs at key generation; the float64 products are taken on
    ``device`` (exact there too: every partial sum is an integer below
    2^53)."""
    device = resolve_device(device)
    data = np.asarray(bsk.data)
    n = data.shape[-1]
    k = data.shape[3] - 1
    low = data[..., :k, :] & np.uint64((1 << round_bits) - 1)
    out = data.copy()
    out[..., :k, :] -= low
    corr = np.zeros(data.shape[:3] + (n,), dtype=np.uint64)
    idx = np.arange(n)
    assert round_bits + 11 < 52
    for j in range(k):
        s = glwe_sk.data[j].astype(np.int64)
        # negacyclic circulant: mat[i, o] = sign * s[o - i mod n]
        mat = s[(idx[None, :] - idx[:, None]) % n].astype(np.float64)
        mat = mat * np.where(idx[None, :] < idx[:, None], -1.0, 1.0)
        r = low[..., j, :].reshape(-1, n).astype(np.float64)
        prod = torch.from_numpy(r).to(device) @ torch.from_numpy(mat).to(device)
        corr += prod.to(torch.int64).cpu().numpy().astype(np.uint64).reshape(corr.shape)
    out[..., k, :] -= corr
    return LweBootstrapKey(out, bsk.decomp)


def mb_round_bits(p) -> int:
    """The multi-bit key rounding of the v9 blind rotation: the least rb in
    [10, 25) at which the CRT product of tfhe_tpu's first three MXU primes
    exceeds twice the summed-pattern bound 2^g l (k+1) N (B/2) 2^(63-rb)
    (tfhe_tpu/shortint/server_key.py:183-203 with its defaults); 0 if none.
    18 at GROUP_4 2_2, 16 at tfhe_tpu's GROUP_2 set."""
    prod = math.prod(MXU_PRIMES_3)
    for rb in range(10, 25):
        bmax = ((1 << 63) >> rb) + 1
        max_x = ((1 << p.grouping_factor) * p.pbs_level * (p.glwe_dimension + 1)
                 * p.polynomial_size * (1 << (p.pbs_base_log - 1)) * bmax)
        if prod > 2 * max_x:
            return rb
    return 0


def round_bsk(bsk: LweBootstrapKey, round_bits: int) -> LweBootstrapKey:
    """Centered-round every coefficient to a multiple of 2^round_bits (mod
    2^64): the v7 and v9 keys.  The exact external product on this key is
    what the TPU's 3-prime rounded-key kernels compute."""
    half = np.uint64(1 << (round_bits - 1))
    mask = np.uint64((1 << round_bits) - 1)
    with np.errstate(over="ignore"):
        d = (bsk.data.astype(np.uint64) + half) & ~mask
    return LweBootstrapKey(d, bsk.decomp)


def crt_bound(base_log: int, levels: int, glwe_size: int, n_poly: int,
              round_bits: int, grouping: int = 0) -> int:
    """The largest |X| of the integer product the rotation reconstructs:
    l (k+1) N (B/2) max|b'| with max|b'| = 2^(63-rb) + 1
    (tfhe_tpu/ops/mxu.py:270 assert_crt_bound), times 2^g for the v9 sum of
    2^g pattern products before one reconstruction
    (multibit_assert_crt_bound, :971)."""
    bmax = ((1 << 63) >> round_bits) + 1
    return ((1 << grouping) * levels * glwe_size * n_poly
            * (1 << (base_log - 1)) * bmax)


def crt_prime_count(max_x: int) -> int:
    """The fewest of the port's primes, three or four, whose product
    exceeds 2 max_x (the signed value must stay below P/2)."""
    for count in (3, 4):
        if math.prod(ntt.PRIMES[:count]) > 2 * max_x:
            return count
    raise ValueError(f"no CRT plan of 3 or 4 primes covers the bound 2^{(2 * max_x).bit_length()}")


def rounded_quotients(words: torch.Tensor, round_bits: int) -> torch.Tensor:
    """The signed quotients b' = centered(round_bsk(b)) / 2^rb of int64
    torus words (tfhe_tpu/ops/mxu.py:283 _prep_bsk_data): |b'| <= 2^(63-rb)."""
    half = 1 << (round_bits - 1)
    mask = (1 << round_bits) - 1
    return ((words + half) & ~mask) >> round_bits


@dataclass(frozen=True, eq=False)
class RoundedKeyNtt:
    """A rounded bootstrapping key in the layout K2 (v7) and K3 (v9) read:
    ``data`` (R, P, N, l (k+1) (k+1)) int32, for each GGSW (R = n classic,
    n/g 2^g multi-bit, in that order) and NTT position the l (k+1)^2 key
    words together, each the Montgomery form of N^-1 times the NTT of the
    quotients b / 2^rb over ``dp``'s P primes.  ``lead`` is the GGSW
    axes' shape and ``ggsw`` (l, k+1, k+1)."""

    data: torch.Tensor
    round_bits: int
    dp: ntt.DevicePlan
    lead: tuple
    ggsw: tuple

    @property
    def num_primes(self) -> int:
        return self.dp.num_primes

    @property
    def nbytes(self) -> int:
        return self.data.numel() * 4

    def canonical(self) -> torch.Tensor:
        """The key as a view (lead..., l, k+1, k+1, P, N), the layout of an
        exact NTT-domain key."""
        r, p, n, _ = self.data.shape
        v = self.data.reshape((r, p, n) + self.ggsw).permute(0, 3, 4, 5, 1, 2)
        return v.reshape(self.lead + self.ggsw + (p, n))


def rounded_key_ntt(bsk_data: np.ndarray, round_bits: int, base_log: int,
                    device, grouping: int = 0) -> RoundedKeyNtt:
    """Build the rounded key on ``device`` from the coefficient-domain
    (lead..., l, k+1, k+1, N) uint64 key: round, take the quotients, their
    residues over the primes ``crt_prime_count`` picks for the rotation's
    bound (``crt_bound``; grouping g > 0 for the v9 pattern sum), forward
    NTT, Montgomery form with N^-1 folded in, kernel layout.  Converted in
    slices of about 2^22 coefficients."""
    data = np.asarray(bsk_data)
    ggsw, n_poly = tuple(data.shape[-4:-1]), data.shape[-1]
    levels, glwe_size = ggsw[0], ggsw[1]
    count = crt_prime_count(crt_bound(base_log, levels, glwe_size, n_poly,
                                      round_bits, grouping))
    dp = ntt.device_plan(ntt.make_plan(n_poly, count), str(device))
    flat = data.reshape((-1,) + ggsw + (n_poly,))
    rows = flat.shape[0]
    out = torch.empty((rows, count, n_poly, math.prod(ggsw)), dtype=torch.int32,
                      device=device)
    step = max(1, (1 << 22) // (math.prod(ggsw) * n_poly))
    for s in range(0, rows, step):
        words = torch.from_numpy(np.ascontiguousarray(flat[s:s + step]).view(np.int64))
        q = rounded_quotients(words.to(device), round_bits)
        res = torch.stack([torch.remainder(q, p) for p in dp.plan.primes], dim=-2)
        f = ntt.ntt_forward(res, dp)
        f = ntt.mont_mul(ntt.mont_mul(f, dp.r2s, dp.ps, dp.pinvs), dp.n_invs,
                         dp.ps, dp.pinvs)
        out[s:s + step] = f.permute(0, 4, 5, 1, 2, 3).reshape(
            f.shape[0], count, n_poly, -1).to(torch.int32)
    return RoundedKeyNtt(out, round_bits, dp, tuple(data.shape[:-4]), ggsw)
