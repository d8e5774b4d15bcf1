"""WoPBS: circuit bootstrapping and vertical packing (large-LUT evaluation),
the port of tfhe_tpu/shortint/wopbs.py.

Mirrors core_crypto/algorithms/lwe_wopbs.rs and shortint/wopbs/ (the
experimental big-LUT path): message bits are extracted as boolean LWEs,
circuit-bootstrapped into GGSWs by per-level PBS (the ServerKey's batched
K1 then K2) followed by private functional packing keyswitches (PFPKS),
and a 2^kappa-entry LUT is evaluated by a GGSW-driven CMux tree (K2's CMux
entry, ``kernels.cmux``), low-bit rotations (K2's CMux chain,
``kernels.cmux_chain``: every low bit of every packing of a call in one
launch) and sample extraction.

The PFPKS multiplies each key polynomial by a scalar digit: no negacyclic
product, so in the coefficient domain it is K1's wrapping contraction
sum_l d_l(b) K[n, l] - sum_j sum_l d_l(a_j) K[j, l] mod 2^64 with (k+1)^2 N
output columns (the k+1 rows' keys side by side), fed (a_0 .. a_{n-1}, b)
as its n+1 input coefficients and a zero body, on a key whose row n is
negated.  tfhe_tpu takes it over a 4-prime CRT-NTT, exact (|sum| < 2^94,
under P/2 ~ 2^123), so the words are the same.
"""

from __future__ import annotations

import secrets
from dataclasses import dataclass

import numpy as np
import torch

from ..core.keygen import add_mask_times_secret
from ..ops import kernels, ntt, torus
from ..ops import server as srv
from ..utils.csprng import DeterministicSeeder, EncryptionRandomGenerator
from .ciphertext import Ciphertext
from .client_key import ClientKey
from .server_key import LookupTable, ServerKey, lazy_outputs, upload_batch


@dataclass(frozen=True)
class WopbsParams:
    """shortint/parameters/parameters_wopbs*.rs essentials."""

    cbs_base_log: int
    cbs_level: int
    pfks_base_log: int
    pfks_level: int

    def cbs_log_shift(self, l: int) -> int:
        """Scale exponent for GGSW slot l (pairs with decomposition level L-l)."""
        return self.cbs_base_log * (self.cbs_level - l)


# Decomposition budgets sized so the CMux-tree error stays well under
# delta/2: pfks rep 40 bits (GGSW noise ~2^29), cbs digits <= 2^5 so each
# external product contributes ~2^45 against the 2^58 threshold.
TEST_WOPBS_PARAM = WopbsParams(cbs_base_log=6, cbs_level=4,
                               pfks_base_log=20, pfks_level=2)


def ggsw_sets(ggsws: list) -> torch.Tensor:
    """A list of GGSWs (L_cbs, k+1, k+1, P, N) as one (len, ...) tensor: a
    view where they lie one after another in one storage, as
    circuit_bootstrap_bits returns them (no copy), else a stack."""
    first = ggsws[0]
    n = first.numel()
    if all(g.is_contiguous() and g.shape == first.shape and g.dtype == first.dtype
           and g.untyped_storage().data_ptr() == first.untyped_storage().data_ptr()
           and g.storage_offset() == first.storage_offset() + i * n
           for i, g in enumerate(ggsws)):
        return first.as_strided((len(ggsws),) + tuple(first.shape), (n,) + first.stride(),
                                first.storage_offset())
    return torch.stack(ggsws)


def low_bits_route(k1: int, n_poly: int, levels: int, base_log: int) -> str:
    """How vertical packing rotates by its low bits at a GGSW shape:
    "chain", all of a call's packings in one K2 CMux-chain launch, where
    the chain's kernel takes the shape (kernels.chain_shape: the TEST
    sets), else "step", one K2 step launch a bit and a GGSW set."""
    return "chain" if kernels.chain_shape(k1, n_poly, levels, base_log) else "step"


class WopbsKey:
    """Circuit-bootstrap key material: one private functional packing
    keyswitch key per output GLWE row (lwe_wopbs.rs pfpksk_list), generated
    with tfhe_tpu's words from the same seed, kept on the server key's
    device in K1's layout: ``pfpksk`` (n+1, l, (k+1) (k+1) N) int64, row r's
    key at columns r (k+1) N .. (r+1) (k+1) N, input row n negated."""

    def __init__(self, client_key: ClientKey, server_key: ServerKey,
                 params: WopbsParams = TEST_WOPBS_PARAM, seed: int | None = None):
        p = client_key.params
        if seed is None:
            seed = secrets.randbits(128)
        gen = EncryptionRandomGenerator(seed, DeterministicSeeder(seed ^ 0x30B5))
        glwe_sk = client_key.glwe_secret_key
        in_sk = client_key.big_lwe_secret_key  # PBS outputs live under the big key
        k, n_poly = glwe_sk.glwe_dimension, glwe_sk.polynomial_size
        n_in, levels = in_sk.dimension, params.pfks_level
        # entry (r, j, l) encrypts p_r(X) s_in_j q / B^(L-l) (last j: p_r(X)
        # q / B^(L-l)), p_r = -s_r(X) for r < k and p_k = 1; one generator,
        # row by row (wopbs.py:67-98): masks and noise drawn in that order,
        # the secret products then added in batches on the key's device
        rows = np.zeros((k + 1, n_in + 1, levels, k + 1, n_poly), dtype=np.uint64)
        with np.errstate(over="ignore"):
            for r in range(k + 1):
                if r < k:
                    p_poly = (-glwe_sk.data[r].astype(np.int64)).astype(np.uint64)
                else:
                    p_poly = np.zeros(n_poly, dtype=np.uint64)
                    p_poly[0] = 1
                for j in range(n_in + 1):
                    s_j = int(in_sk.data[j]) if j < n_in else 1
                    for lev in range(levels):
                        factor = (s_j << (64 - params.pfks_base_log * (levels - lev))) % (1 << 64)
                        row = rows[r, j, lev]
                        row[:k] = gen.mask.uniform_u64(k * n_poly).reshape(k, n_poly)
                        row[k] = p_poly * np.uint64(factor) + p.glwe_noise.sample(
                            gen.noise, n_poly)
        add_mask_times_secret(rows.reshape(-1, k + 1, n_poly), glwe_sk, server_key.device)
        self._init_key(server_key, params, rows)

    @classmethod
    def from_raw_keys(cls, server_key: ServerKey, pfpksk,
                      params: WopbsParams = TEST_WOPBS_PARAM) -> "WopbsKey":
        """Build from tfhe_tpu's stored key list ``pfpksk`` (wopbs.py:101):
        k+1 arrays (n+1, l, k+1, 4, N) uint32, 4-prime Montgomery NTT
        domain, brought back to the standard domain on the host by inverse
        NTT and Garner (exact: the words are below 2^64, under P/2)."""
        plan = ntt.make_plan(server_key.params.polynomial_size, 4)
        rows = []
        with np.errstate(over="ignore"):
            for key in pfpksk:
                mont = np.asarray(key, dtype=np.uint32).astype(np.uint64)
                normal = ntt._mont_mul_np(mont, np.uint64(1), plan.ps, plan.pinvs)
                rows.append(ntt._garner_np(ntt._inverse_np(normal, plan), plan))
        obj = cls.__new__(cls)
        obj._init_key(server_key, params, np.stack(rows))
        return obj

    def _init_key(self, server_key: ServerKey, params: WopbsParams, rows: np.ndarray) -> None:
        """rows: (k+1, n+1, l, k+1, N) uint64, the standard-domain keys."""
        self.params = params
        self.server_key = server_key
        self.shortint_params = server_key.params
        self.dp = server_key.dp
        k1, n1, levels, _, n_poly = rows.shape
        self.k, self.n_poly = k1 - 1, n_poly
        words = np.ascontiguousarray(rows.transpose(1, 2, 0, 3, 4)).reshape(n1, levels, -1)
        with np.errstate(over="ignore"):
            words[-1] = np.uint64(0) - words[-1]
        self.pfpksk = torus.from_u64(words, server_key.device)
        self.pfpks_key = kernels.keyswitch_key(self.pfpksk, params.pfks_base_log, levels)

    # ------------------------------------------------------------------
    # private functional packing keyswitch (LWEs -> GLWE rows), on K1
    # ------------------------------------------------------------------

    def _pfpks_rows(self, lwes: torch.Tensor) -> torch.Tensor:
        """All k+1 rows for each LWE of a batch (B, n+1): one K1 launch on
        (a_0 .. a_{n-1}, b, 0).  Returns (B, k+1, k+1, N) int64: row r is
        GLWE(p_r(X) x) for the LWE's plaintext x."""
        prm = self.params
        ext = torch.cat([lwes, lwes.new_zeros((lwes.shape[0], 1))], dim=1)
        out = kernels.keyswitch(ext, self.pfpks_key, prm.pfks_base_log, prm.pfks_level)
        return out.reshape(lwes.shape[0], self.k + 1, self.k + 1, self.n_poly)

    def _pfpks(self, lwe, r: int) -> torch.Tensor:
        """out = sum_l decomp_l(b) key[n] - sum_j sum_l decomp_l(a_j) key[j]
        for output row r: GLWE(p_r(X) x), (k+1, N) int64."""
        lwe = torch.as_tensor(np.asarray(lwe).view(np.int64) if isinstance(lwe, np.ndarray)
                              else lwe).to(self.server_key.device)
        return self._pfpks_rows(lwe[None])[0, r]

    # ------------------------------------------------------------------
    # circuit bootstrap: boolean LWE -> NTT-domain GGSW
    # ------------------------------------------------------------------

    def circuit_bootstrap_bits(self, ct_bits: list) -> list:
        """Batched CBS: the per-level PBS of every bit in one batch (K1,
        K2), the PFPKS of every (level, bit) in one K1 launch, the GGSWs'
        NTT on the device.  Returns one GGSW a bit, (L_cbs, k+1, k+1, P, N)
        int32 in K2's Montgomery NTT layout: views, one after another, of
        one tensor (ggsw_sets stacks them again without a copy)."""
        prm = self.params
        levels, nb = prm.cbs_level, len(ct_bits)
        luts = [self._bit_lut(1 << (64 - prm.cbs_log_shift(lev))) for lev in range(levels)]
        outs = self.server_key.apply_lookup_table_batch(
            [ct for _ in range(levels) for ct in ct_bits],
            [luts[lev] for lev in range(levels) for _ in ct_bits])
        lwes = upload_batch([o.data for o in outs], self.server_key.device)
        rows = self._pfpks_rows(lwes).reshape((levels, nb) + (self.k + 1,) * 2 + (self.n_poly,))
        ggsw = ntt.words_ntt(rows.transpose(0, 1).contiguous(), self.dp)
        return list(ggsw)

    def circuit_bootstrap_bit(self, ct_bit: Ciphertext) -> torch.Tensor:
        """GGSW(bit) as (L_cbs, k+1, k+1, P, N) int32 Montgomery NTT domain
        (lwe_wopbs.rs circuit_bootstrap_boolean)."""
        return self.circuit_bootstrap_bits([ct_bit])[0]

    def _bit_lut(self, scale: int) -> LookupTable:
        """LUT mapping a {0,1}-encoded shortint (bit at delta) to bit*scale
        on the raw torus: the accumulator built directly, f(x) = x * scale
        for the two boxes."""
        p = self.shortint_params
        n = p.polynomial_size
        total = p.total_modulus
        box = n // total
        acc = np.zeros(n, dtype=np.uint64)
        for i in range(total):
            acc[i * box:(i + 1) * box] = ((i & 1) * scale) & ((1 << 64) - 1)
        half_box = box // 2
        acc[:half_box] = (-acc[:half_box].astype(np.int64)).astype(np.uint64)
        acc = np.roll(acc, -half_box)
        out = np.zeros((p.glwe_dimension + 1, n), dtype=np.uint64)
        out[-1] = acc
        return LookupTable(out, degree=1)

    # ------------------------------------------------------------------
    # vertical packing: GGSW-driven LUT evaluation
    # ------------------------------------------------------------------

    def _cmux(self, ggsw, ct0, ct1):
        """ct0 + EP(ggsw, ct1 - ct0) for batches (B, k+1, N): K2's CMux entry."""
        prm = self.params
        return kernels.cmux(ct0, ct1, ggsw, self.dp, prm.cbs_base_log, prm.cbs_level)

    def vertical_packing(self, ggsw_bits: list, lut_values: list,
                         delta: int) -> Ciphertext:
        """Evaluate a 2^kappa-entry LUT; ggsw_bits MSB first
        (fft64/crypto/wop_pbs.rs vertical_packing).  The CMux tree over the
        high bits, one K2 CMux launch a level; the low bits' rotations,
        acc + EP(ggsw, X^-rot acc - acc) a bit, in one K2 CMux-chain launch
        (low_bits_route).  The output stays on the device."""
        return self._vertical_packing_many(ggsw_sets(ggsw_bits)[None], [0], [lut_values],
                                           delta)[0]

    def _vertical_packing_many(self, sets: torch.Tensor, set_of: list, tables: list,
                               delta: int) -> list:
        """Many vertical packings at once: packing j evaluates tables[j]
        (2^kappa entries) on GGSW set set_of[j] of sets (G, kappa, L_cbs,
        k+1, k+1, P, N), its bits MSB first.  Each packing's CMux tree runs
        on K2's CMux entry, one launch a level; then the low bits of every
        packing run in one K2 CMux-chain launch, each packing's chain on its
        own set (a view of sets: no GGSW is copied), or, at shapes the
        chain's kernel does not take (low_bits_route), one K2 step launch a
        bit and a set.  The same steps in the same order as
        ``vertical_packing`` for each packing, so the same words.  Returns
        one Ciphertext a packing, on the device."""
        p = self.shortint_params
        prm = self.params
        n = self.n_poly
        kappa = sets.shape[1]
        size = 1 << kappa
        n_polys = max(1, size // n)
        polys = np.zeros((len(tables), n_polys, p.glwe_dimension + 1, n), dtype=np.uint64)
        for j, lut_values in enumerate(tables):
            entries = np.array([(int(lut_values[i]) * delta) % (1 << 64) for i in range(size)],
                               dtype=np.uint64)
            for t in range(n_polys):
                chunk = entries[t * n:(t + 1) * n]
                polys[j, t, -1, :len(chunk)] = chunk
        accs = torus.from_u64(polys, self.server_key.device)
        # CMux tree over the high bits collapses each polynomial list
        n_tree = max(0, kappa - (n.bit_length() - 1))
        firsts = []
        for acc, g in zip(accs, set_of):
            for t in range(n_tree):  # MSB selects the upper half of the table
                half = acc.shape[0] // 2
                acc = self._cmux(sets[g, t], acc[:half], acc[half:])
            firsts.append(acc[0])
        acc = torch.stack(firsts)
        # blind rotation by the low bits: bit i selects rotation by 2^i slots,
        # MSB of the low group first
        n_low = kappa - n_tree
        shifts = torch.arange(n_low - 1, -1, -1, device=acc.device)
        a_cols = (2 * n - 2 ** shifts)[None].expand(len(set_of), n_low)
        if n_low and low_bits_route(self.k + 1, n, prm.cbs_level,
                                    prm.cbs_base_log) == "chain":
            acc = kernels.cmux_chain(acc, a_cols, sets[:, n_tree:],
                                     torch.tensor(set_of, dtype=torch.int64), self.dp,
                                     prm.cbs_base_log, prm.cbs_level)
        elif n_low:
            # one step launch a bit for the packings of each set
            for g in sorted(set(set_of)):
                rows = torch.tensor([j for j, h in enumerate(set_of) if h == g],
                                    device=acc.device)
                part = acc[rows].contiguous()
                for i in range(n_low):
                    part = kernels.cmux_step(part, a_cols[rows, i], sets[g, n_tree + i],
                                             self.dp, prm.cbs_base_log, prm.cbs_level)
                acc[rows] = part
        return lazy_outputs(srv.sample_extract(acc), [p.message_modulus - 1] * len(set_of),
                            [p] * len(set_of))

    # ------------------------------------------------------------------
    # the full WoPBS: arbitrary LUT over the full (msg x carry) space
    # ------------------------------------------------------------------

    def extract_bits(self, ct: Ciphertext, num_bits: int) -> list:
        """Bits of the value, MSB first, each a {0,1} shortint (one batched
        PBS round)."""
        sk = self.server_key
        luts = [sk.generate_lookup_table(lambda x, j=j: (x >> j) & 1)
                for j in range(num_bits - 1, -1, -1)]
        return sk.apply_lookup_table_batch([ct] * num_bits, luts)

    def apply_wopbs(self, ct: Ciphertext, f, num_bits: int | None = None) -> Ciphertext:
        """LUT of f over 2^num_bits inputs via extract-bits -> CBS -> VP."""
        p = self.shortint_params
        if num_bits is None:
            num_bits = (p.total_modulus - 1).bit_length()
        bits = self.extract_bits(ct, num_bits)
        ggsws = self.circuit_bootstrap_bits(bits)
        lut_values = [int(f(x)) % p.total_modulus for x in range(1 << num_bits)]
        return self.vertical_packing(ggsws, lut_values, p.delta)
