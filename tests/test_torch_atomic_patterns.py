"""The remaining shortint atomic patterns on the CPU against tfhe_tpu, word
for word (tolerance 0; all arithmetic is integer but the drift choice's
float32 measure, whose chosen candidate is held to tfhe_tpu's): KS32 (the
u32 keyswitch key, ``keyswitch32``, a LUT round, modulus-switched storage
and an integer add), PBS->KS (the SMALL-key order), many-LUT on a classic
and a multi-bit key with its degree guard, the drift modulus switch (its
zeros, its choice on 272 rows, a round), the 32-bit TUniform and Gaussian
draws byte for byte, and every new parameter set's fields.

Keys: the TEST sets (n = 16, N = 512), built once per module from the same
seeds in both packages."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tfhe_tpu import integer as ref_integer
from tfhe_tpu import shortint as ref
from tfhe_tpu.core import encrypt as ref_encrypt
from tfhe_tpu.ops import server as ref_srv
from tfhe_tpu.shortint import params as ref_params
from tfhe_tpu.utils import csprng as ref_csprng
from tfhe_tpu_torch import integer, shortint
from tfhe_tpu_torch.core import encrypt
from tfhe_tpu_torch.ops import kernels, server, torus
from tfhe_tpu_torch.shortint import params as port_params
from tfhe_tpu_torch.utils import csprng

torch.set_num_threads(1)  # the suite runs in parallel processes: one thread each

NEW_SETS = ("TEST_PARAM_MESSAGE_2_CARRY_2_KS32",
            "V1_4_PARAM_MESSAGE_2_CARRY_2_KS32_PBS_TUNIFORM_2M128",
            "TEST_PARAM_MESSAGE_2_CARRY_2_PBS_KS",
            "V1_4_PARAM_MESSAGE_2_CARRY_2_PBS_KS_GAUSSIAN_2M128",
            "V1_4_PARAM_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M64",
            "V1_4_PARAM_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M40",
            "V1_4_PARAM_MESSAGE_2_CARRY_2_KS_PBS_GAUSSIAN_2M128")


def LUT(x):
    return (3 * x + 1) % 16


def words(cts) -> np.ndarray:
    return np.stack([np.asarray(c.data, dtype=np.uint64) for c in cts])


def fields(p) -> dict:
    """A set's fields, noise distributions by kind and value."""
    out = {}
    for f in dataclasses.fields(p):
        v = getattr(p, f.name)
        if hasattr(v, "bound_log2") or hasattr(v, "std"):
            v = (type(v).__name__, dataclasses.astuple(v))
        elif hasattr(v, "value"):
            v = v.value
        out[f.name] = v
    return out


class Pair:
    """tfhe_tpu's and the port's client and server keys of one set, from the
    same seeds."""

    def __init__(self, ref_p, port_p, seed: int):
        self.rck, self.pck = ref.ClientKey(ref_p, seed=seed), shortint.ClientKey(port_p, seed=seed)
        self.rsk = ref.ServerKey(self.rck, seed=seed + 1)
        self.psk = shortint.ServerKey(self.pck, seed=seed + 1, device="cpu")

    def encrypt(self, vals):
        return [self.rck.encrypt(v) for v in vals], [self.pck.encrypt(v) for v in vals]


def drift_set(mod):
    return dataclasses.replace(mod.TEST_PARAM_MESSAGE_2_CARRY_2, drift_zeros_count=16,
                               ms_noise_reduction=mod.MsNoiseReduction.DRIFT)


@pytest.fixture(scope="module")
def ks32():
    return Pair(ref_params.TEST_PARAM_MESSAGE_2_CARRY_2_KS32,
                port_params.TEST_PARAM_MESSAGE_2_CARRY_2_KS32, 0x32)


@pytest.fixture(scope="module")
def drift():
    return Pair(drift_set(ref_params), drift_set(port_params), 0xD21F7)


# ---------------------------------------------------------------------------
# Parameter sets
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", NEW_SETS)
def test_new_set_fields(name):
    r, p = getattr(ref_params, name), getattr(port_params, name)
    assert type(r).__name__ == type(p).__name__
    assert fields(r) == fields(p)
    assert (name in vars(shortint)) == (name in vars(ref))


def test_exports_are_tfhe_tpus():
    """The five new sets tfhe_tpu's shortint exports, and not the PBS->KS
    ones."""
    new = {n for n in NEW_SETS if n in vars(ref)}
    assert len(new) == 5 and new <= set(vars(shortint))
    assert not {n for n in NEW_SETS if "PBS_KS" in n} & set(vars(shortint))


# ---------------------------------------------------------------------------
# 32-bit draws and encryption
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dist", ["tuniform_45", "tuniform_3", "gaussian", "uniform"])
def test_32_bit_draws(dist):
    """The same bytes of the stream give the same u32 words (as uint64 in
    the port), and the stream ends at the same position."""
    rs, ps = ref_csprng.ByteStream(0x5EED), csprng.ByteStream(0x5EED)
    if dist == "uniform":
        want, got = rs.uniform_scalar(300, 32), ps.uniform_scalar(300, 32)
    else:
        if dist == "gaussian":
            rd, pd = ref_csprng.Gaussian(2.0 ** -20), csprng.Gaussian(2.0 ** -20)
        else:
            bound = int(dist.rsplit("_", 1)[1])
            rd, pd = ref_csprng.TUniform(bound), csprng.TUniform(bound)
        want, got = rd.sample(rs, 300, 32), pd.sample(ps, 300, 32)
    assert got.dtype == np.uint64 and (got < (1 << 32)).all()
    assert (np.asarray(want).astype(np.uint64) == got).all()
    assert rs.pos == ps.pos


def test_encrypt_lwe_32_bits():
    sk = np.random.default_rng(3).integers(0, 2, 40).astype(np.uint64)
    gens = [mod.EncryptionRandomGenerator(9, mod.DeterministicSeeder(10))
            for mod in (ref_csprng, csprng)]
    from tfhe_tpu.core.entities import LweSecretKey as RefKey
    from tfhe_tpu_torch.core.entities import LweSecretKey

    want = ref_encrypt.encrypt_lwe(RefKey(sk.astype(np.uint32), 32), 7 << 28,
                                   ref_csprng.TUniform(5), gens[0], 32)
    got = encrypt.encrypt_lwe(LweSecretKey(sk), 7 << 28, csprng.TUniform(5), gens[1], 32)
    assert (np.asarray(want.data).astype(np.uint64) == got.data).all()


# ---------------------------------------------------------------------------
# KS32
# ---------------------------------------------------------------------------


def test_ks32_ksk_words(ks32):
    """The u32 keyswitch key, drawn at 32 bits (4 mask bytes a word): every
    word, and so every later draw of the server key's generator."""
    want = np.asarray(ks32.rsk.ksk)
    assert want.dtype == np.uint32
    got = torus.to_u64(ks32.psk.ksk)
    assert (want.astype(np.uint64) == got).all() and got.max() < (1 << 32)
    assert isinstance(ks32.psk.ks_key, torch.Tensor)       # the CPU takes the words


@pytest.mark.parametrize("shape", [(37, 512, 3, 4, 17), (5, 64, 5, 4, 9), (9, 30, 2, 7, 33)])
def test_keyswitch32_matches(shape):
    """keyswitch32 (and its wrapper, K1-32's plain version on the CPU) and the
    32-bit modulus switch against tfhe_tpu's on random words: (B, n_in, l,
    base_log, n_out + 1)."""
    b, n_in, levels, base_log, m_out = shape
    rng = np.random.default_rng(sum(shape))
    ct = rng.integers(0, 1 << 64, (b, n_in + 1), dtype=np.uint64)
    ksk = rng.integers(0, 1 << 32, (n_in, levels, m_out), dtype=np.uint64)
    want = np.asarray(ref_srv.keyswitch32(jnp.asarray(ct), jnp.asarray(ksk.astype(np.uint32)),
                                          base_log, levels))
    got = kernels.keyswitch32(torus.from_u64(ct, "cpu"), torus.from_u64(ksk, "cpu"),
                              base_log, levels)
    assert (want.astype(np.uint64) == torus.to_u64(got)).all()
    for log_mod in (10, 12):
        ms = np.asarray(ref_srv.modulus_switch(jnp.asarray(want), log_mod, 32))
        assert (ms.astype(np.uint64) == torus.to_u64(server.modulus_switch(got, log_mod, 32))).all()


def test_ks32_round_and_storage(ks32):
    rc, pc = ks32.encrypt(range(4))
    assert (words(rc) == words(pc)).all()
    ro = ks32.rsk.apply_lookup_table_batch(rc, ks32.rsk.generate_lookup_table(LUT))
    po = ks32.psk.apply_lookup_table_batch(pc, ks32.psk.generate_lookup_table(LUT))
    assert (words(ro) == words(po)).all()
    assert [ks32.pck.decrypt_raw(c) for c in po] == [LUT(v) for v in range(4)]
    # the modulus-switched storage runs the KS32 half (no centered-mean
    # correction, the 32-bit switch)
    r, p = ks32.rsk.switch_modulus_and_compress(rc[2]), ks32.psk.switch_modulus_and_compress(pc[2])
    assert (r.packed == p.packed).all() and r.count == p.count == 17


def test_ks32_integer_add():
    """tests/test_shortint.py:135-140's add through the integer layer on the
    KS32 pattern, with no code of its own: the same blocks."""
    rck, rsk = ref_integer.gen_keys(ref_params.TEST_PARAM_MESSAGE_2_CARRY_2_KS32, seed=0x33)
    pck, psk = integer.gen_keys(port_params.TEST_PARAM_MESSAGE_2_CARRY_2_KS32, seed=0x33,
                                device="cpu")
    want = rsk.add_parallelized(rck.encrypt_radix(150, 4), rck.encrypt_radix(90, 4))
    got = psk.add_parallelized(pck.encrypt_radix(150, 4), pck.encrypt_radix(90, 4))
    assert (words(want.blocks) == words(got.blocks)).all()
    assert pck.decrypt_radix(got) == (150 + 90) % 256


# ---------------------------------------------------------------------------
# PBS->KS
# ---------------------------------------------------------------------------


def test_pbs_ks_round():
    """The SMALL-key order: modulus switch, exact rotation, extract onto the
    big key, keyswitch back to the small key."""
    pair = Pair(ref_params.TEST_PARAM_MESSAGE_2_CARRY_2_PBS_KS,
                port_params.TEST_PARAM_MESSAGE_2_CARRY_2_PBS_KS, 0x9B5)
    rc, pc = pair.encrypt([0, 1, 2, 3, 1])
    assert words(pc).shape[1] == 17 and (words(rc) == words(pc)).all()
    ro = pair.rsk.apply_lookup_table_batch(rc, pair.rsk.generate_lookup_table(LUT))
    po = pair.psk.apply_lookup_table_batch(pc, pair.psk.generate_lookup_table(LUT))
    assert (words(ro) == words(po)).all() and words(po).shape[1] == 17
    assert [pair.pck.decrypt_raw(c) for c in po] == [LUT(v) for v in (0, 1, 2, 3, 1)]
    with pytest.raises(ValueError, match="SMALL"):
        pair.psk.apply_many_lookup_table(pc[0], pair.psk.generate_many_lookup_table([LUT]))


# ---------------------------------------------------------------------------
# Many-LUT
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["classic", "multibit", "ks32"])
def test_many_lut(kind, ks32):
    """Two functions from one rotation (exact mode on the unrounded key),
    one extraction each; inputs above the degree budget are refused."""
    if kind == "ks32":
        pair = ks32
    else:
        name = ("TEST_PARAM_MESSAGE_2_CARRY_2" if kind == "classic"
                else "TEST_PARAM_MULTI_BIT_GROUP_2_MESSAGE_2_CARRY_2")
        pair = Pair(getattr(ref_params, name), getattr(port_params, name), 0x3A7)
    fns = [lambda x: x % 4, lambda x: (x + 1) % 4]
    rm = pair.rsk.generate_many_lookup_table(fns)
    pm = pair.psk.generate_many_lookup_table(fns)
    assert (rm.acc == pm.acc).all() and (rm.stride, rm.degrees, rm.input_max_degree) == (
        pm.stride, pm.degrees, pm.input_max_degree)
    rc, pc = pair.encrypt([2, 0, 3])
    ro = pair.rsk.apply_many_lookup_table_batch(rc, rm)
    po = pair.psk.apply_many_lookup_table_batch(pc, pm)
    for r, p, v in zip(ro, po, (2, 0, 3)):
        assert (words(r) == words(p)).all()
        assert [c.degree for c in p] == list(rm.degrees)
        assert [pair.pck.decrypt(c) for c in p] == [f(v) for f in fns]
    # the degree guard: a ciphertext of degree 9 exceeds the budget of 7
    big = pair.psk.unchecked_scalar_mul(pc[0], 3)
    with pytest.raises(ValueError, match="budget"):
        pair.psk.apply_many_lookup_table(big, pm)
    with pytest.raises(ValueError, match="at most"):
        pair.psk.generate_many_lookup_table([LUT] * 9)


# ---------------------------------------------------------------------------
# Drift
# ---------------------------------------------------------------------------


def test_drift_zeros_and_round(drift):
    """The 16 zero-encryptions drawn after the BSK, then a round whose
    keyswitched inputs take the drift choice."""
    assert (np.asarray(drift.rsk.drift_zeros) == torus.to_u64(drift.psk.drift_zeros)).all()
    assert drift.psk.drift_zeros.shape == (16, 17)
    rc, pc = drift.encrypt(range(4))
    f = lambda x: (x + 5) % 16                    # noqa: E731
    ro = drift.rsk.apply_lookup_table_batch(rc, drift.rsk.generate_lookup_table(f))
    po = drift.psk.apply_lookup_table_batch(pc, drift.psk.generate_lookup_table(f))
    assert (words(ro) == words(po)).all()
    assert [drift.pck.decrypt_raw(c) for c in po] == [f(v) for v in range(4)]


@pytest.mark.parametrize("spread", ["keyswitched", "uniform"])
def test_drift_choice_matches(drift, spread):
    """drift_ms_improve on 272 rows against tfhe_tpu's: the same candidate
    chosen for every row (its float32 measure summed in tfhe_tpu's CPU
    order), on keyswitched ciphertexts of the drift key and on uniform
    words."""
    p = drift.psk.params
    rng = np.random.default_rng(0xD1F7 + len(spread))
    if spread == "keyswitched":
        cts = np.stack([np.asarray(drift.pck.encrypt(int(v)).data)
                        for v in rng.integers(0, 4, 272)])
        ks = torus.to_u64(server.keyswitch(torus.from_u64(cts, "cpu"), drift.psk.ksk,
                                           p.ks_base_log, p.ks_level))
    else:
        ks = rng.integers(0, 1 << 64, (272, p.lwe_dimension + 1), dtype=np.uint64)
    zeros = np.asarray(drift.rsk.drift_zeros)
    log_mod = p.polynomial_size.bit_length()
    args = (log_mod, p.drift_r_sigma, p.drift_ms_bound,
            p.drift_input_variance * (2.0 ** 64) ** 2)
    want = np.asarray(ref_srv.drift_ms_improve(jnp.asarray(ks), jnp.asarray(zeros), *args))
    got = torus.to_u64(server.drift_ms_improve(torus.from_u64(ks, "cpu"),
                                               torus.from_u64(zeros, "cpu"), *args))
    assert (want == got).all()
    # the choice moved most rows off the keyswitched ciphertext itself
    assert (got != ks).any(axis=1).mean() > 0.5
