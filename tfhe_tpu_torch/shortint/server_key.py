"""shortint server key: batched LUT application + the four-flavor op set.

Port of tfhe_tpu/shortint/server_key.py for every atomic pattern it runs:
classic and multi-bit KS->PBS, KS32 (a u32 keyswitch key, K1-32), PBS->KS
(the SMALL-key sets) and the drift modulus switch, and many-LUT.  Keys are
generated on the host exactly as tfhe_tpu generates them (same seeds, same
bytes, the same BSK mask flooring) and uploaded to the device once, in
kernel layout.  ``apply_lookup_table_batch`` runs one batched KS -> MS ->
blind rotation -> sample extract (ops/server.py ks_pbs_batch, or
ks_pbs_batch_multibit for a multi-bit set, or pbs_ks_batch for a SMALL-key
set) through the CUDA kernels on a CUDA device, or through their plain
PyTorch versions on the CPU.  ``switch_modulus_and_compress`` stores a
ciphertext after the KS + MS half, and
``decompress_and_apply_lookup_table_batch`` runs the other half, always in
exact mode (the exact key is uploaded at its first use in v7 or v9 mode),
as does many-LUT (``apply_many_lookup_table_batch``).

With a latency mesh set (parallel/poly_shard.py ``set_latency_mesh``), a
batch of at most its threshold on a classic BIG-key set (no KS32, no
drift zeros) runs ``sharded_ks_pbs_poly`` instead: one PBS split over
the mesh's slots, in exact mode on the key's evaluation slices
(``_ensure_poly_shard``), as tfhe_tpu routes it.

Which blind rotation runs is fixed at construction, as tfhe_tpu's
``use_mxu`` and ``use_mxu_multibit`` fix it by backend.  Classic sets: v7
mode (the TPU production kernel's function: key centered-rounded to 2^15,
accumulator on the 2^32 grid; the key held as an ops/bsk_prep.py
RoundedKeyNtt built on the device) on a CUDA device for the MXU family (N =
2048, k = 1, l = 1) with a floored key.  Multi-bit sets: v9 mode (the TPU's
fused multi-bit kernel: monomials on the data side, key rounded to
``mb_round_bits``, 2^32-grid accumulator) on a CUDA device for the v9
family with a floored key.  Otherwise the exact rotation runs, which is
what tfhe_tpu runs on the CPU.

Op flavors follow the reference convention (server_key/add.rs:41-303):
  unchecked_* (no checks) / checked_* (error on overflow risk) /
  smart_* (bootstraps operands when needed) / default (clean carry in/out).
"""

from __future__ import annotations

import secrets
from dataclasses import dataclass

import numpy as np
import torch

from ..core import keygen as kg
from ..core import multibit as mb
from ..core import security
from ..core.encrypt import encrypt_lwe
from ..core.entities import LweBootstrapKey
from ..ops import kernels, ntt, torus
from ..ops import server as srv
from ..ops.bsk_prep import mask_floor_bsk, mb_round_bits, rounded_key_ntt
from ..utils.csprng import DeterministicSeeder, EncryptionRandomGenerator
from ..utils.device import resolve_device
from .ciphertext import (NOMINAL_NOISE, Ciphertext, DeviceLweBatch,
                         LazyLweData)
from .client_key import ClientKey
from .params import (EncryptionKeyChoice, MsNoiseReduction,
                     ShortintParams)

# BSK rounding of the v7 blind rotation: tfhe_tpu's default for its 3-prime
# MXU stack (server_key.py:160-166), fixed here.
ROUND_BITS = 15


class CarryFullError(Exception):
    """checked_* flavor failure (the reference's CheckError): the operation
    would exceed the degree or noise budget."""


_M64 = 1 << 64


def _stack_lazy_batch(datas, width, device):
    """Compile a round's input linear forms into ONE device gather+combine.

    datas: list of LazyLweData / np.ndarray.  Returns a (B, width) int64
    device tensor.  Rows referencing prior-round DeviceLweBatch parents
    never touch the host; fresh host ciphertexts ride the const upload.
    """
    lazies = [d if isinstance(d, LazyLweData)
              else LazyLweData((), np.asarray(d), width) for d in datas]
    parents: dict = {}
    for lz in lazies:
        for _, h, _ in lz.terms:
            parents.setdefault(id(h), h)
    plist = list(parents.values())
    offs, off = {}, 0
    for h in plist:
        offs[id(h)] = off
        off += int(h.arr.shape[0])
    t_max = max((len(lz.terms) for lz in lazies), default=0)
    b = len(lazies)
    consts = None
    for i, lz in enumerate(lazies):
        if lz.const is not None:
            if consts is None:
                consts = np.zeros((b, width), np.uint64)
            consts[i] = lz.const
    if not plist:
        return torus.from_u64(consts if consts is not None
                              else np.zeros((b, width), np.uint64), device)
    t_pad = 1 << (t_max - 1).bit_length() if t_max > 1 else 1
    idx = np.zeros((b, t_pad), np.int64)
    coef = np.zeros((b, t_pad), np.uint64)
    for i, lz in enumerate(lazies):
        for j, (c, h, r) in enumerate(lz.terms):
            idx[i, j] = offs[id(h)] + r
            coef[i, j] = c % _M64
    cat = (plist[0].arr if len(plist) == 1
           else torch.cat([h.arr for h in plist]))
    rows = cat[torch.from_numpy(idx).to(device)]             # (B, T, width)
    batch = (torus.from_u64(coef, device)[:, :, None] * rows).sum(dim=1)
    if consts is not None:
        batch = batch + torus.from_u64(consts, device)
    return batch


def upload_batch(datas, device) -> torch.Tensor:
    """Ciphertext words (LazyLweData or host arrays) as one (B, width) int64
    tensor on ``device``: device-resident rows are gathered there, host rows
    uploaded together."""
    if any(isinstance(d, LazyLweData) for d in datas):
        width = (datas[0].width if isinstance(datas[0], LazyLweData)
                 else np.asarray(datas[0]).shape[-1])
        return _stack_lazy_batch(datas, width, device)
    return torus.from_u64(np.stack([np.asarray(d) for d in datas]), device)


def pad_pow2(n: int) -> int:
    """The batch size a call of n ciphertexts runs at: the next power of
    two, as tfhe_tpu buckets it."""
    return 1 << (n - 1).bit_length() if n > 1 else 1


def lazy_outputs(out: torch.Tensor, degrees, sources) -> list:
    """The first len(degrees) rows of a device batch (B, width) as
    Ciphertexts that stay on the device (LazyLweData over one
    DeviceLweBatch), with the given degrees, nominal noise, and each
    source's message and carry moduli."""
    handle = DeviceLweBatch(out)
    w = int(out.shape[-1])
    return [Ciphertext(LazyLweData(((1, handle, i),), None, w), d, NOMINAL_NOISE,
                       s.message_modulus, s.carry_modulus)
            for i, (d, s) in enumerate(zip(degrees, sources))]


@dataclass
class LookupTable:
    acc: np.ndarray  # (k+1, N) uint64 trivial GLWE accumulator
    degree: int


@dataclass
class ManyLookupTable:
    """One accumulator evaluating several functions
    (tfhe_tpu/shortint/server_key.py:108; server_key/mod.rs
    ManyLookupTable): function i's outputs are extracted at coefficient
    i * stride; inputs must have degree <= input_max_degree."""

    acc: np.ndarray
    stride: int
    degrees: tuple
    input_max_degree: int


@dataclass
class CompressedModulusSwitchedCiphertext:
    """A ciphertext stored after keyswitch and modulus switch, log2(2N)
    bits a coefficient instead of 64 (tfhe_tpu/shortint/server_key.py:118;
    shortint/ciphertext/compressed_modulus_switched_ciphertext.rs).
    Decompression is the remaining blind rotation and extract, with any
    LUT."""

    packed: np.ndarray  # uint8 bit-packed little-endian stream
    count: int          # n_small + 1 stored values
    log_modulus: int    # values are in [0, 2N), 1 + log2(N) bits each
    degree: int
    message_modulus: int
    carry_modulus: int

    def switched(self) -> np.ndarray:
        """The stored switched values, (count,) uint64 in [0, 2N)."""
        return _unpack_bits(self.packed, self.log_modulus, self.count)


def _pack_bits(vals: np.ndarray, width: int) -> np.ndarray:
    """PackedIntegers analog: width-bit little-endian packing into bytes."""
    bits = ((vals[:, None].astype(np.uint64) >> np.arange(width, dtype=np.uint64))
            & np.uint64(1)).astype(np.uint8).reshape(-1)
    return np.packbits(bits, bitorder="little")


def _unpack_bits(packed: np.ndarray, width: int, count: int) -> np.ndarray:
    bits = np.unpackbits(packed, bitorder="little")[: width * count]
    weights = (np.uint64(1) << np.arange(width, dtype=np.uint64))
    return (bits.reshape(count, width).astype(np.uint64) * weights).sum(
        axis=1, dtype=np.uint64)


def _v7_family(p) -> bool:
    """Parameter families the v7 blind rotation covers (tfhe_tpu's
    ``_mxu_family``, server_key.py:148-157; static, so keys built for the
    CPU and the GPU are identical)."""
    return (p.polynomial_size == 2048 and p.glwe_dimension == 1
            and p.pbs_level == 1 and p.pbs_base_log <= 23
            and getattr(p, "grouping_factor", None) is None
            and p.encryption_key_choice == EncryptionKeyChoice.BIG)


def uses_v7(device: torch.device, p, bsk_floored: int) -> bool:
    """Whether a server key runs the v7 blind rotation: on a CUDA device, for
    the v7 family, with a BSK whose masks are floored to ROUND_BITS (as
    tfhe_tpu's ``use_mxu`` with the device in place of the backend test).
    Otherwise the exact rotation runs, as tfhe_tpu runs it on the CPU."""
    return (device.type == "cuda" and _v7_family(p)
            and bsk_floored >= ROUND_BITS)


def _v9_family(p) -> bool:
    """Multi-bit sets the v9 blind rotation covers (tfhe_tpu's
    ``_mxu_family_mb``, server_key.py:169-180; static, like _v7_family)."""
    g = getattr(p, "grouping_factor", None)
    return (g in (2, 3, 4) and p.polynomial_size == 2048
            and p.glwe_dimension == 1 and p.pbs_level == 1
            and p.pbs_base_log <= 23
            and p.lwe_dimension % g == 0 and 128 % (2 * (1 << g)) == 0
            and p.encryption_key_choice == EncryptionKeyChoice.BIG
            and not p.ks32)


def uses_v9(device: torch.device, p, mb_floored: int) -> bool:
    """Whether a multi-bit server key runs the v9 blind rotation: on a CUDA
    device, for the v9 family, with a key whose masks are floored to
    ``mb_round_bits`` (tfhe_tpu's ``use_mxu_multibit``, server_key.py:380-395,
    with the device in place of the backend test)."""
    rb = mb_round_bits(p) if _v9_family(p) else 0
    return device.type == "cuda" and rb > 0 and mb_floored >= rb


def _floor_rounds_securely(p, round_bits: int) -> None:
    """The estimator guard of mask flooring: the floored key is a GLWE
    instance over modulus 2^(64-rb) with the same absolute noise.  Raise
    where flooring would take a secure set below the estimator curve;
    flooring an insecure test set is harmless."""
    kn = p.glwe_dimension * p.polynomial_size
    ok_floored, detail = security.check_lwe_noise_secure(
        p.glwe_noise, kn, modulus_log2_shrink=round_bits)
    ok_plain, _ = security.check_lwe_noise_secure(p.glwe_noise, kn)
    if not (ok_floored or not ok_plain):
        raise ValueError(
            f"BSK mask flooring at rb={round_bits} would degrade a "
            f"secure parameter set below the estimator curve: {detail}")


class ServerKey:
    def __init__(self, client_key: ClientKey, seed: int | None = None,
                 device="cuda"):
        device = resolve_device(device)
        p = client_key.params
        if seed is None:
            seed = secrets.randbits(128)
        gen = EncryptionRandomGenerator(seed, DeterministicSeeder(seed ^ 0xB5297A4D))
        core = p.core
        # the KS32 pattern's key is drawn at 32 bits (u32 words, 4 mask bytes
        # a word), which shifts every later draw of the generator
        ksk = kg.generate_lwe_keyswitch_key(
            client_key.big_lwe_secret_key, client_key.lwe_secret_key,
            core.ks_decomp, p.lwe_noise, gen, 32 if p.ks32 else 64)
        glwe_sk = client_key.glwe_secret_key
        floored = 0
        drift_zeros = None
        # Keygen-side, phase-preserving mask alignment so that the rounded
        # key only perturbs bodies (ops/bsk_prep.mask_floor_bsk), where the
        # floored key still meets the estimator curves.
        if getattr(p, "grouping_factor", None) is not None:
            # MultiBit arm: 2^g indicator GGSWs per group of g key bits, from
            # the same generator after the KSK, floored flattened (no drift
            # zeros: tfhe_tpu's multi-bit arm draws none)
            bsk = mb.generate_multibit_bootstrap_key(
                client_key.lwe_secret_key, glwe_sk, core.pbs_decomp,
                p.grouping_factor, p.glwe_noise, gen, device)
            rb = mb_round_bits(p) if _v9_family(p) else 0
            if rb:
                _floor_rounds_securely(p, rb)
                flat = LweBootstrapKey(bsk.reshape((-1,) + bsk.shape[2:]),
                                       core.pbs_decomp)
                bsk = mask_floor_bsk(flat, glwe_sk, rb, device).data.reshape(bsk.shape)
                floored = rb
        else:
            bsk = kg.generate_lwe_bootstrap_key(
                client_key.lwe_secret_key, glwe_sk, core.pbs_decomp,
                p.glwe_noise, gen, device)
            if _v7_family(p):
                _floor_rounds_securely(p, ROUND_BITS)
                bsk = mask_floor_bsk(bsk, glwe_sk, ROUND_BITS, device)
                floored = ROUND_BITS
            if p.ms_noise_reduction == MsNoiseReduction.DRIFT:
                # the drift technique's public zero-encryptions under the small
                # key, drawn after the BSK (tfhe_tpu/shortint/server_key.py:303)
                drift_zeros = np.stack([
                    encrypt_lwe(client_key.lwe_secret_key, 0, p.lwe_noise, gen).data
                    for _ in range(p.drift_zeros_count)])
        self._init_from_raw(p, ksk.data, bsk, floored, device, drift_zeros)

    @classmethod
    def from_raw_keys(cls, params: ShortintParams, ksk_data, bsk_data,
                      bsk_floored: int = 0, device="cuda") -> "ServerKey":
        """Build from standard-domain KSK (n_big, l, n_small+1; u32 words for
        a KS32 set) and BSK uint64 arrays: (n_small, l, k+1, k+1, N) for a
        classic set, (n_small/g, 2^g, l, k+1, k+1, N) for a multi-bit set.
        bsk_floored: the rb the BSK masks are floored to (0 for a key that
        was not floored, which never takes the v7 or v9 rotation).  A key
        built so has no drift zeros, as in tfhe_tpu: a drift set's rounds
        then run the plain modulus switch."""
        device = resolve_device(device)
        obj = cls.__new__(cls)
        obj._init_from_raw(params, ksk_data, bsk_data, bsk_floored, device)
        return obj

    def _init_from_raw(self, p: ShortintParams, ksk_data, bsk_data,
                       bsk_floored: int, device: torch.device,
                       drift_zeros=None) -> None:
        self.params = p
        self.device = device
        self._bsk_floored = bsk_floored
        self.grouping = getattr(p, "grouping_factor", None)
        if self.grouping is not None:
            bsk = np.asarray(bsk_data)
            self.trunc_acc = uses_v9(device, p, bsk_floored)
            round_bits, grouping = mb_round_bits(p), self.grouping
        else:
            bsk = (bsk_data if isinstance(bsk_data, LweBootstrapKey)
                   else LweBootstrapKey(np.asarray(bsk_data), p.core.pbs_decomp))
            self.trunc_acc = uses_v7(device, p, bsk_floored)
            round_bits, grouping = ROUND_BITS, 0
        # coefficient-domain key, kept for building the exact key in v7/v9
        # mode (exact_bsk_ntt)
        self._bsk_coeff = bsk
        self._bsk_ntt_exact = None
        self.plan = ntt.make_plan(p.polynomial_size)
        self.dp = ntt.device_plan(self.plan, str(device))
        # uploaded once, in kernel layout: the KSK as int64 (u64 words, or a
        # KS32 key's u32 words), and on the card K1's (K1-32's) byte layout
        # of it (ks_key, what every keyswitch takes); the BSK as the rounded
        # key built on the device (v7, v9) or the exact NTT-domain residues
        # (< 2^30) as int32; the drift zeros (n_small+1 words each)
        self.ksk = torus.from_u64(np.asarray(ksk_data), device)
        self.ks_key = kernels.keyswitch_key(self.ksk, p.ks_base_log, p.ks_level,
                                            32 if p.ks32 else 64)
        self.drift_zeros = (None if drift_zeros is None
                            else torus.from_u64(np.asarray(drift_zeros), device))
        if self.trunc_acc:
            self.bsk_ntt = rounded_key_ntt(getattr(bsk, "data", bsk), round_bits,
                                           p.pbs_base_log, device, grouping)
        else:
            self.bsk_ntt = self._exact_key_ntt()
        self.max_degree = p.total_modulus - 1
        self.max_noise_level = p.max_noise_level
        self.pbs_count = 0  # pbs-stats analog (shortint/server_key/mod.rs:69)

    def _ks_options(self) -> dict:
        """The keyswitch half's options of this key's set, as tfhe_tpu passes
        them to every pipeline: centered-mean modulus switch, the KS32
        keyswitch, the drift zeros and their parameters (the input variance
        on the 2^64 scale)."""
        p = self.params
        return dict(centered_ms=p.ms_noise_reduction == MsNoiseReduction.CENTERED_MEAN,
                    ks32=p.ks32, drift_zeros=self.drift_zeros,
                    drift_r_sigma=p.drift_r_sigma, drift_bound=p.drift_ms_bound,
                    drift_input_variance=p.drift_input_variance * (2.0 ** 64) ** 2)

    # ------------------------------------------------------------------
    # Lookup tables
    # ------------------------------------------------------------------

    def generate_lookup_table(self, f) -> LookupTable:
        p = self.params
        total = p.total_modulus
        outputs = [int(f(x)) % total for x in range(total)]
        acc = srv.generate_lut(p.polynomial_size, p.glwe_dimension + 1, total,
                               p.delta, lambda x: outputs[x])
        return LookupTable(acc, degree=max(outputs))

    def generate_msg_lookup_table(self, f) -> LookupTable:
        """LUT of f(x % msg) % msg (clears carries)."""
        p = self.params
        m = p.message_modulus
        return self.generate_lookup_table(lambda x: int(f(x % m)) % m)

    def generate_lookup_table_bivariate(self, f) -> LookupTable:
        """Packed-operand LUT: input lhs*msg + rhs (bivariate_pbs.rs:110)."""
        p = self.params
        m = p.message_modulus

        def packed(x):
            return int(f((x // m) % m, x % m))

        return self.generate_lookup_table(packed)

    # ------------------------------------------------------------------
    # Batched PBS primitive
    # ------------------------------------------------------------------

    def apply_lookup_table_batch(self, cts: list[Ciphertext],
                                 luts) -> list[Ciphertext]:
        """One batched KS->PBS for a list of ciphertexts.

        luts: a single LookupTable (shared) or a list of per-element tables.
        Outputs stay on the device as LazyLweData; linear ops on them stay
        symbolic and the next round gathers them on the device.
        """
        p = self.params
        if isinstance(luts, LookupTable):
            luts = [luts] * len(cts)
        if len(luts) != len(cts):
            raise ValueError(f"{len(cts)} ciphertexts but {len(luts)} tables")
        n_real = len(cts)
        n_pad = pad_pow2(n_real)
        batch = upload_batch([c.data for c in cts] + [cts[0].data] * (n_pad - n_real),
                             self.device)
        lut_b = self._upload_luts(luts, n_pad)
        from ..parallel import poly_shard as ps

        lmesh = ps.latency_mesh()
        if (lmesh is not None and n_real <= ps.latency_threshold() and self.grouping is None
                and p.encryption_key_choice == EncryptionKeyChoice.BIG and not p.ks32
                and self.drift_zeros is None):
            # the latency route (tfhe_tpu/shortint/server_key.py:561-578): one
            # PBS split over every slot of the mesh, in exact mode
            mesh, axis = lmesh
            out = ps.sharded_ks_pbs_poly(
                mesh, batch, lut_b.contiguous(), self.ks_key, self._ensure_poly_shard(mesh, axis),
                p.ks_base_log, p.ks_level, p.pbs_base_log, p.pbs_level, p.bits,
                p.ms_noise_reduction == MsNoiseReduction.CENTERED_MEAN, axis_name=axis)
        elif p.encryption_key_choice == EncryptionKeyChoice.SMALL:
            # PBS->KS order: small-key ciphertexts bootstrap first (exact
            # rotation: the SMALL sets are outside the v7 family), then
            # keyswitch back down
            out = srv.pbs_ks_batch(
                batch, lut_b, self.ks_key, self.bsk_ntt, self.dp, p.ks_base_log,
                p.ks_level, p.pbs_base_log, p.pbs_level,
                p.ms_noise_reduction == MsNoiseReduction.CENTERED_MEAN)
        elif self.grouping is not None:
            out = srv.ks_pbs_batch_multibit(
                batch, lut_b, self.ks_key, self.bsk_ntt, self.dp,
                p.ks_base_log, p.ks_level, p.pbs_base_log, p.pbs_level,
                self.grouping, v9=self.trunc_acc, **self._ks_options())
        else:
            out = srv.ks_pbs_batch(
                batch, lut_b, self.ks_key, self.bsk_ntt, self.dp,
                p.ks_base_log, p.ks_level, p.pbs_base_log, p.pbs_level,
                trunc_acc=self.trunc_acc, **self._ks_options())
        self.pbs_count += n_real
        return lazy_outputs(out, [t.degree for t in luts], cts)

    def _upload_luts(self, luts: list, n_pad: int) -> torch.Tensor:
        """(n_pad, k+1, N) tables on the device, each distinct table uploaded
        once and gathered there; rows past the list repeat the first."""
        uniq: dict = {}
        lut_idx = []
        for t in luts:
            key = id(t.acc)
            if key not in uniq:
                uniq[key] = (len(uniq), t.acc)
            lut_idx.append(uniq[key][0])
        lut_idx += [lut_idx[0]] * (n_pad - len(luts))
        uniq_t = torus.from_u64(np.stack([acc for _, acc in uniq.values()]),
                                self.device)
        if len(uniq) == 1:
            return uniq_t[0].expand((n_pad,) + tuple(uniq_t.shape[1:]))
        return uniq_t[torch.tensor(lut_idx, device=self.device)]

    def apply_lookup_table(self, ct: Ciphertext, lut: LookupTable) -> Ciphertext:
        return self.apply_lookup_table_batch([ct], lut)[0]

    # ------------------------------------------------------------------
    # Many-LUT: several functions evaluated by one blind rotation
    # ------------------------------------------------------------------

    def generate_many_lookup_table(self, functions) -> ManyLookupTable:
        """Pack up to total/2 functions into one accumulator; the input
        degree budget shrinks to total/len - 1 (engine/mod.rs:170
        fill_many_lut_accumulator; tfhe_tpu/shortint/server_key.py:734)."""
        p = self.params
        total = p.total_modulus
        n = p.polynomial_size
        box = n // total
        fn_c = len(functions)
        if fn_c > total // 2:
            raise ValueError(f"at most {total // 2} functions")
        max_deg = total // fn_c - 1
        stride = (max_deg + 1) * box
        acc = np.zeros(n, dtype=np.uint64)
        degrees = []
        for i, f in enumerate(functions):
            deg = 0
            for v in range(max_deg + 1):
                out = int(f(v)) % total
                deg = max(deg, out)
                acc[i * stride + v * box:i * stride + (v + 1) * box] = (out * p.delta) % _M64
            degrees.append(deg)
        half_box = box // 2
        acc[:half_box] = (-acc[:half_box].astype(np.int64)).astype(np.uint64)
        acc = np.roll(acc, -half_box)
        glwe = np.zeros((p.glwe_dimension + 1, n), dtype=np.uint64)
        glwe[-1] = acc
        return ManyLookupTable(glwe, stride, tuple(degrees), max_deg)

    def apply_many_lookup_table(self, ct: Ciphertext, mlut: ManyLookupTable) -> list:
        return self.apply_many_lookup_table_batch([ct], mlut)[0]

    def apply_many_lookup_table_batch(self, cts: list, mlut: ManyLookupTable) -> list:
        """For each input ciphertext, one output a packed function, all from
        one batched blind rotation in exact mode on the unrounded key
        (``exact_bsk_ntt``), as tfhe_tpu runs it on every backend: classic,
        ops/server.py ks_pbs_many_batch (K1 or K1-32, then K2); multi-bit,
        ks_ms_batch then pbs_many_from_switched_multibit (K1, then K3).
        The outputs stay on the device."""
        p = self.params
        if p.encryption_key_choice == EncryptionKeyChoice.SMALL:
            raise ValueError("many-LUT keyswitches first (the KS->PBS order): a "
                             "SMALL-key set's ciphertexts do not fit its keyswitch, "
                             "as in tfhe_tpu")
        for c in cts:
            if c.degree > mlut.input_max_degree:
                raise ValueError(f"degree {c.degree} exceeds the many-LUT budget "
                                 f"{mlut.input_max_degree}")
        n_real = len(cts)
        n_pad = pad_pow2(n_real)
        batch = upload_batch([c.data for c in cts] + [cts[0].data] * (n_pad - n_real),
                             self.device)
        acc = torus.from_u64(mlut.acc, self.device)
        lut_b = acc.expand((n_pad,) + tuple(acc.shape))
        offsets = tuple(i * mlut.stride for i in range(len(mlut.degrees)))
        if self.grouping is not None:
            msed = srv.ks_ms_batch(batch, self.ks_key, p.polynomial_size.bit_length(),
                                   p.ks_base_log, p.ks_level, **self._ks_options())
            out = srv.pbs_many_from_switched_multibit(
                msed, lut_b, self.exact_bsk_ntt(), self.dp, p.pbs_base_log, p.pbs_level,
                self.grouping, offsets)
        else:
            out = srv.ks_pbs_many_batch(
                batch, lut_b, self.ks_key, self.exact_bsk_ntt(), self.dp, p.ks_base_log,
                p.ks_level, p.pbs_base_log, p.pbs_level, offsets, **self._ks_options())
        self.pbs_count += n_real
        per_fn = [lazy_outputs(out[:, j].contiguous(), [d] * n_real, cts)
                  for j, d in enumerate(mlut.degrees)]
        return [[fn_outs[i] for fn_outs in per_fn] for i in range(n_real)]

    # ------------------------------------------------------------------
    # Modulus-switched compression (server_key/modulus_switched_compression.rs)
    # ------------------------------------------------------------------

    def _ensure_poly_shard(self, mesh, axis_name: str = "poly"):
        """The key's evaluation slices for the latency route
        (parallel/poly_shard.prepare_bsk_poly_sharded, from the
        coefficient-domain key), built at first use and kept for each mesh
        and axis (tfhe_tpu/shortint/server_key.py:428-441)."""
        key = (id(mesh), axis_name)
        cache = self.__dict__.setdefault("_poly_shard_cache", {})
        if key not in cache or cache[key][0] is not mesh:
            from ..parallel import poly_shard as ps

            cache[key] = (mesh, ps.prepare_bsk_poly_sharded(
                mesh, torus.from_u64(getattr(self._bsk_coeff, "data", self._bsk_coeff),
                                     self.device), axis_name=axis_name))
        return cache[key][1]

    def exact_bsk_ntt(self) -> torch.Tensor:
        """The unrounded NTT-domain key on the device: ``bsk_ntt`` in exact
        mode; in v7 or v9 mode built from the coefficient-domain key at first
        use and kept (decompression runs the exact rotation, as tfhe_tpu's
        does on every backend, and the rounded key would give other words)."""
        if not self.trunc_acc:
            return self.bsk_ntt
        if self._bsk_ntt_exact is None:
            self._bsk_ntt_exact = self._exact_key_ntt()
        return self._bsk_ntt_exact

    def _exact_key_ntt(self) -> torch.Tensor:
        return ntt.key_ntt(getattr(self._bsk_coeff, "data", self._bsk_coeff), self.dp)

    def switch_modulus_and_compress(self, ct: Ciphertext) -> CompressedModulusSwitchedCiphertext:
        """Run the KS + MS half of the atomic pattern now (K1) and store the
        result in log2(2N) bits a coefficient.  Decompression performs the
        remaining blind rotation with a caller-chosen LUT."""
        p = self.params
        log_mod = p.polynomial_size.bit_length()
        msed = torus.to_u64(srv.ks_ms_batch(
            upload_batch([ct.data], self.device), self.ks_key, log_mod, p.ks_base_log,
            p.ks_level, **self._ks_options()))[0]
        return CompressedModulusSwitchedCiphertext(
            _pack_bits(msed, log_mod), len(msed), log_mod, ct.degree,
            p.message_modulus, p.carry_modulus)

    def decompress_and_apply_lookup_table(
            self, compressed: CompressedModulusSwitchedCiphertext,
            lut: LookupTable) -> Ciphertext:
        return self.decompress_and_apply_lookup_table_batch([compressed], lut)[0]

    def decompress_and_apply_lookup_table_batch(self, compressed_list: list,
                                                luts) -> list:
        """Unpack the stored switched values and run one blind rotation and
        extract for the whole list, padded to a power of two: K2 in exact
        mode on a classic key, K3 in exact mode on a multi-bit key, on the
        unrounded key (``exact_bsk_ntt``).  The outputs stay on the device."""
        p = self.params
        if isinstance(luts, LookupTable):
            luts = [luts] * len(compressed_list)
        n_real = len(compressed_list)
        n_pad = pad_pow2(n_real)
        msed = np.stack([c.switched() for c in compressed_list])
        msed = np.concatenate([msed, np.broadcast_to(msed[:1], (n_pad - n_real,)
                                                     + msed.shape[1:])])
        msed = torus.from_u64(msed, self.device)
        lut_b = self._upload_luts(luts, n_pad)
        if self.grouping is not None:
            out = srv.pbs_from_switched_batch_multibit(
                msed, lut_b, self.exact_bsk_ntt(), self.dp, p.pbs_base_log,
                p.pbs_level, self.grouping)
        else:
            out = srv.pbs_from_switched_batch(
                msed, lut_b, self.exact_bsk_ntt(), self.dp, p.pbs_base_log,
                p.pbs_level)
        self.pbs_count += n_real
        return lazy_outputs(out, [t.degree for t in luts], compressed_list)

    # ------------------------------------------------------------------
    # Linear (leveled) ops — no PBS
    # ------------------------------------------------------------------

    def unchecked_add(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        return a.with_data(a.data + b.data, degree=a.degree + b.degree,
                           noise_level=a.noise_level + b.noise_level)

    @staticmethod
    def _add_to_body(data, scalar: np.uint64):
        """Add a plaintext offset to the body element only (wrapping mod 2^64
        is the torus semantics — numpy's scalar-overflow warning is silenced
        deliberately so a real overflow bug elsewhere still warns).  Lazy
        device-resident data stays lazy (the offset rides the const term)."""
        if isinstance(data, LazyLweData):
            vec = np.zeros(data.width, np.uint64)
            with np.errstate(over="ignore"):
                vec[-1] = scalar
            return data + vec
        out = np.array(data)
        with np.errstate(over="ignore"):
            out[..., -1] = out[..., -1] + scalar
        return out

    def unchecked_sub(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        """a - b + z*msg*delta with z chosen so the result stays positive
        (server_key/sub.rs correcting-term trick)."""
        p = self.params
        msg = p.message_modulus
        z = (b.degree + msg) // msg * msg  # multiple of msg, > b.degree
        corr = np.uint64((z * p.delta) % _M64)
        data = self._add_to_body(a.data - b.data, corr)
        return a.with_data(data, degree=a.degree + z,
                           noise_level=a.noise_level + b.noise_level)

    def unchecked_neg(self, a: Ciphertext) -> Ciphertext:
        p = self.params
        msg = p.message_modulus
        z = (a.degree + msg) // msg * msg
        corr = np.uint64((z * p.delta) % _M64)
        if isinstance(a.data, LazyLweData):
            neg = -a.data
        else:
            neg = np.zeros_like(np.asarray(a.data)) - np.asarray(a.data)
        data = self._add_to_body(neg, corr)
        return a.with_data(data, degree=z, noise_level=a.noise_level)

    def unchecked_scalar_add(self, a: Ciphertext, scalar: int) -> Ciphertext:
        p = self.params
        shift = np.uint64((scalar * p.delta) % _M64)
        data = self._add_to_body(a.data if isinstance(a.data, LazyLweData)
                                 else np.asarray(a.data), shift)
        return a.with_data(data, degree=a.degree + scalar)

    def unchecked_scalar_mul(self, a: Ciphertext, scalar: int) -> Ciphertext:
        return a.with_data(a.data * np.uint64(scalar),
                           degree=a.degree * scalar,
                           noise_level=a.noise_level * scalar)

    def create_trivial(self, value: int) -> Ciphertext:
        p = self.params
        data = np.zeros(p.big_lwe_dimension + 1, dtype=np.uint64)
        v = value % p.total_modulus
        data[-1] = np.uint64((v * p.delta) % _M64)
        return Ciphertext(data, degree=v, noise_level=0,
                          message_modulus=p.message_modulus,
                          carry_modulus=p.carry_modulus)

    # ------------------------------------------------------------------
    # PBS-backed ops
    # ------------------------------------------------------------------

    def message_extract(self, a: Ciphertext) -> Ciphertext:
        return self.apply_lookup_table(a, self.generate_msg_lookup_table(lambda x: x))

    def carry_extract(self, a: Ciphertext) -> Ciphertext:
        p = self.params
        return self.apply_lookup_table(
            a, self.generate_lookup_table(lambda x: x // p.message_modulus))

    def _fits(self, degree: int, noise: int) -> bool:
        return degree <= self.max_degree and noise <= self.max_noise_level

    # ------------------------------------------------------------------
    # checked_* flavor (server_key/add.rs:131 CheckError convention): error
    # out when the operation would overflow the degree/noise budget, never
    # bootstrap implicitly.  Completes the four-flavor convention
    # unchecked_/checked_/smart_/default.
    # ------------------------------------------------------------------

    def _check(self, degree: int, noise: int) -> None:
        if not self._fits(degree, noise):
            raise CarryFullError(
                f"operation would exceed the budget: degree {degree} > "
                f"{self.max_degree} or noise {noise} > {self.max_noise_level}")

    def checked_add(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        self._check(a.degree + b.degree, a.noise_level + b.noise_level)
        return self.unchecked_add(a, b)

    def checked_sub(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        p = self.params
        z = (b.degree + p.message_modulus) // p.message_modulus * p.message_modulus
        self._check(a.degree + z, a.noise_level + b.noise_level)
        return self.unchecked_sub(a, b)

    def checked_neg(self, a: Ciphertext) -> Ciphertext:
        p = self.params
        z = (a.degree + p.message_modulus) // p.message_modulus * p.message_modulus
        self._check(z, a.noise_level)
        return self.unchecked_neg(a)

    def checked_scalar_add(self, a: Ciphertext, scalar: int) -> Ciphertext:
        self._check(a.degree + scalar, a.noise_level)
        return self.unchecked_scalar_add(a, scalar)

    def checked_scalar_mul(self, a: Ciphertext, scalar: int) -> Ciphertext:
        self._check(a.degree * scalar, a.noise_level * scalar)
        return self.unchecked_scalar_mul(a, scalar)

    def checked_apply_bivariate(self, a: Ciphertext, b: Ciphertext, f) -> Ciphertext:
        p = self.params
        msg = p.message_modulus
        if b.degree >= msg:
            raise CarryFullError(f"rhs degree {b.degree} >= {msg} cannot pack")
        self._check(a.degree * msg + b.degree, a.noise_level * msg + b.noise_level)
        return self.unchecked_apply_bivariate(a, b, f)

    def checked_mul(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        p = self.params
        return self.checked_apply_bivariate(
            a, b, lambda x, y: (x * y) % p.message_modulus)

    def smart_add(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        if not self._fits(a.degree + b.degree, a.noise_level + b.noise_level):
            a = self.message_extract(a)
            b = self.message_extract(b)
        return self.unchecked_add(a, b)

    def add(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        """Default flavor: clean-carry output (message part only)."""
        return self.message_extract(self.smart_add(a, b))

    def unchecked_apply_bivariate(self, a: Ciphertext, b: Ciphertext, f) -> Ciphertext:
        """packed = a*msg + b, then LUT(f) — requires b.degree < msg."""
        p = self.params
        packed = self.unchecked_add(self.unchecked_scalar_mul(a, p.message_modulus), b)
        return self.apply_lookup_table(packed, self.generate_lookup_table_bivariate(f))

    def smart_apply_bivariate(self, a: Ciphertext, b: Ciphertext, f) -> Ciphertext:
        p = self.params
        msg = p.message_modulus
        deg = a.degree * msg + b.degree
        noise = a.noise_level * msg + b.noise_level
        if b.degree >= msg or not self._fits(deg, noise):
            a = self.message_extract(a)
            b = self.message_extract(b)
        return self.unchecked_apply_bivariate(a, b, f)

    def mul(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        p = self.params
        return self.smart_apply_bivariate(a, b, lambda x, y: (x * y) % p.message_modulus)

    def bitand(self, a, b):
        return self.smart_apply_bivariate(a, b, lambda x, y: x & y)

    def bitor(self, a, b):
        return self.smart_apply_bivariate(a, b, lambda x, y: x | y)

    def bitxor(self, a, b):
        return self.smart_apply_bivariate(a, b, lambda x, y: x ^ y)

    def eq(self, a, b):
        return self.smart_apply_bivariate(a, b, lambda x, y: int(x == y))

    def lt(self, a, b):
        return self.smart_apply_bivariate(a, b, lambda x, y: int(x < y))
