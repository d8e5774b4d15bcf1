"""The port's compact public key, compact lists, casting keys and
re-randomization against tfhe_tpu's on the CPU, word for word (tolerance 0;
all arithmetic is integer): the same keys from the same seeds, the same
encryptions from the same draws, and every expanded, cast and re-randomized
ciphertext with the same u64 words, degree and noise level.  Also the
queue-3 repairs: the compute-key OPRF draw and the restored config flag;
many-LUT and the drift cast.

Keys: the TEST set cut to n = 2, N = 64 (as tests/test_torch_strings.py
cuts it: the same moduli, decomposition and noise) and a dedicated PKE set
of the same shape (N = 64, TUniform(3)).  Keygen and tfhe_tpu's results are
built once per module; the compact public key and the casting keys' KSKs
are built by tfhe_tpu and handed to the port (after one check that the
port's own keygen gives the same words)."""

import dataclasses
import random

import numpy as np
import pytest
import torch

import tfhe_tpu as ref_t
from tfhe_tpu import shortint as ref_shortint
from tfhe_tpu.hlapi import compact_list as ref_cl
from tfhe_tpu.integer import key_switching_key as ref_iksk
from tfhe_tpu.shortint import key_switching_key as ref_ksk
from tfhe_tpu.shortint import oprf as ref_oprf
from tfhe_tpu.shortint import params as ref_params
from tfhe_tpu.shortint import re_randomization as ref_rr
import tfhe_tpu_torch as t
from tfhe_tpu_torch import integer, shortint
from tfhe_tpu_torch.hlapi import compact_list as cl
from tfhe_tpu_torch.integer import key_switching_key as iksk
from tfhe_tpu_torch.ops import torus
from tfhe_tpu_torch.shortint import key_switching_key as ksk_mod
from tfhe_tpu_torch.shortint import oprf
from tfhe_tpu_torch.shortint import params as port_params
from tfhe_tpu_torch.shortint import re_randomization as rr

torch.set_num_threads(1)  # the suite runs in parallel processes: one thread each

SEED = 0xC0A5
MESSAGES = [3, 0, 2, 1, 15, 7]
PKE_NAMES = [n for n in dir(ref_params) if n.startswith(("V1_4_PARAM_PKE",
                                                         "V1_4_PARAM_KEYSWITCH_PKE"))]


def cut(mod):
    return dataclasses.replace(mod.TEST_PARAM_MESSAGE_2_CARRY_2, lwe_dimension=2,
                               polynomial_size=64)


def pke_params(mod):
    return mod.CompactPublicKeyEncryptionParameters(
        encryption_lwe_dimension=64, encryption_noise=mod.TUniform(3), message_modulus=4,
        carry_modulus=4)


def words(cts) -> np.ndarray:
    return np.stack([np.asarray(c.data, dtype=np.uint64) for c in cts])


def same(r, p) -> None:
    """The same ciphertexts: u64 words, degrees, noise levels, moduli."""
    assert len(r) == len(p)
    assert (words(r) == words(p)).all()
    for x, y in zip(r, p):
        assert (x.degree, x.noise_level, x.message_modulus, x.carry_modulus) == (
            y.degree, y.noise_level, y.message_modulus, y.carry_modulus)


class FixedDraws:
    """A stand-in for the `secrets` module whose randbits returns a fixed
    sequence: patched into both packages' compact_list namespaces, the two
    encryptions draw the same r and noise."""

    def __init__(self, seed: int):
        self._rng = random.Random(seed)

    def randbits(self, k: int) -> int:
        return self._rng.getrandbits(k)


def port_cpk(ref_cpk, params) -> cl.CompactPublicKey:
    """tfhe_tpu's compact public key handed to the port."""
    return cl.CompactPublicKey.from_raw_parts(params, ref_cpk.a, ref_cpk.b,
                                              ref_cpk._requires_casting)


def port_casting_key(ref_cast, dst_params, casting_params, server_key=None):
    """tfhe_tpu's casting key (its KSK) handed to the port."""
    return cl.CompactPkeCastingKey.from_raw_parts(np.asarray(ref_cast.ksk), dst_params,
                                                  casting_params, server_key, device="cpu")


class Keys:
    def __init__(self):
        self.p, self.pp = cut(shortint), pke_params(port_params)
        self.rck = ref_shortint.ClientKey(cut(ref_shortint), seed=SEED)
        self.rsk = ref_shortint.ServerKey(self.rck, seed=SEED + 1)
        self.pck = shortint.ClientKey(self.p, seed=SEED)
        self.psk = shortint.ServerKey(self.pck, seed=SEED + 1, device="cpu")
        self.rpriv = ref_cl.CompactPrivateKey(pke_params(ref_params), seed=SEED + 2)
        self.ppriv = cl.CompactPrivateKey(self.pp, seed=SEED + 2)
        # the PKE-instance key and the compute-key one
        self.rcpk = ref_cl.CompactPublicKey(self.rpriv, seed=SEED + 3)
        self.rcpk_compute = ref_cl.CompactPublicKey(self.rck, seed=SEED + 4)
        self.cpk = port_cpk(self.rcpk, self.pp)
        self.cpk_compute = port_cpk(self.rcpk_compute, self.p)
        self.casts = {}
        for dest, name in (("big", "V1_4_PARAM_KEYSWITCH_PKE_TO_BIG_MESSAGE_2_CARRY_2_"
                                   "KS_PBS_TUNIFORM_2M128"),
                           ("small", "V1_4_PARAM_KEYSWITCH_PKE_TO_SMALL_MESSAGE_2_CARRY_2_"
                                     "KS_PBS_TUNIFORM_2M128")):
            ref_cast = ref_cl.CompactPkeCastingKey(
                self.rpriv, self.rck, getattr(ref_params, name),
                server_key=self.rsk if dest == "small" else None, seed=SEED + 5)
            self.casts[dest] = (ref_cast, port_casting_key(
                ref_cast, self.p, getattr(port_params, name),
                self.psk if dest == "small" else None))

    def encrypt_both(self, monkeypatch, ref_cpk, cpk, messages, draw_seed):
        monkeypatch.setattr(ref_cl, "secrets", FixedDraws(draw_seed))
        monkeypatch.setattr(cl, "secrets", FixedDraws(draw_seed))
        return ref_cpk.encrypt_list(messages), cpk.encrypt_list(messages)


@pytest.fixture(scope="module")
def keys():
    return Keys()


@pytest.fixture(scope="module")
def ref_casts(keys):
    """tfhe_tpu's expansions and casts of one list, to big and to small."""
    lst = keys.rcpk.encrypt_list(MESSAGES)
    return lst, {dest: lst.expand(casting_key=keys.casts[dest][0]) for dest in keys.casts}


@pytest.mark.parametrize("name", PKE_NAMES)
def test_pke_and_casting_sets_are_tfhe_tpus(name):
    r, p = getattr(ref_params, name), getattr(port_params, name)
    assert dataclasses.asdict(r) == dataclasses.asdict(p)
    assert getattr(shortint, name) is p
    if hasattr(r, "delta"):
        assert (r.polynomial_size, r.glwe_dimension, r.total_modulus, r.delta) == (
            p.polynomial_size, p.glwe_dimension, p.total_modulus, p.delta)


def test_port_keygen_gives_tfhe_tpus_words(keys):
    """The private key, both compact public keys and both casting KSKs that
    the port generates from the seeds are tfhe_tpu's words."""
    assert (keys.ppriv.glwe_secret_key.data == keys.rpriv.glwe_secret_key.data).all()
    for ref_cpk, owner in ((keys.rcpk, keys.ppriv), (keys.rcpk_compute, keys.pck)):
        cpk = cl.CompactPublicKey(owner, seed=SEED + (3 if owner is keys.ppriv else 4))
        assert (cpk.a == ref_cpk.a).all() and (cpk.b == ref_cpk.b).all()
        assert cpk._requires_casting == ref_cpk._requires_casting
    for dest, (ref_cast, _) in keys.casts.items():
        cast = cl.CompactPkeCastingKey(keys.ppriv, keys.pck, ref_cast.params,
                                       server_key=keys.psk if dest == "small" else None,
                                       seed=SEED + 5, device="cpu")
        assert (torus.to_u64(cast.ksk) == np.asarray(ref_cast.ksk)).all()


@pytest.mark.parametrize("owner", ["pke", "compute"])
def test_encrypt_list_words(keys, monkeypatch, owner):
    ref_cpk, cpk = ((keys.rcpk, keys.cpk) if owner == "pke"
                    else (keys.rcpk_compute, keys.cpk_compute))
    r, p = keys.encrypt_both(monkeypatch, ref_cpk, cpk, MESSAGES, 11)
    assert (r.glwe == p.glwe).all() and r.glwe.dtype == p.glwe.dtype
    assert (r.count, r.message_modulus, r.carry_modulus, r.needs_casting) == (
        p.count, p.message_modulus, p.carry_modulus, p.needs_casting)
    if owner == "pke":
        assert keys.ppriv.decrypt_list(p) == keys.rpriv.decrypt_list(r) == MESSAGES


def test_expand_on_the_compute_key(keys, monkeypatch):
    """A list under the compute key expands without casting: one batched
    extraction gives tfhe_tpu's per-slot words, and every slot decrypts."""
    r, p = keys.encrypt_both(monkeypatch, keys.rcpk_compute, keys.cpk_compute, MESSAGES, 12)
    got = p.expand(device="cpu")
    same(r.expand(), got)
    assert [keys.pck.decrypt_raw(c) for c in got] == [m % 16 for m in MESSAGES]


@pytest.mark.parametrize("dest", ["big", "small"])
def test_cast_words(keys, ref_casts, dest):
    """The PKE-domain list expanded and cast into the compute set (big: one
    keyswitch; small: keyswitch, centered modulus switch, exact rotation
    with the identity table) gives tfhe_tpu's words and degrees."""
    lst, outs = ref_casts
    p = cl.CompactCiphertextList(lst.glwe, lst.count, lst.message_modulus, lst.carry_modulus,
                                 lst.needs_casting)
    got = p.expand(casting_key=keys.casts[dest][1])
    same(outs[dest], got)
    assert [keys.pck.decrypt_raw(c) for c in got] == [m % 16 for m in MESSAGES]


def test_casting_refusals(keys, monkeypatch):
    _, p = keys.encrypt_both(monkeypatch, keys.rcpk, keys.cpk, [1], 13)
    with pytest.raises(ValueError, match="RequiresCasting"):
        p.expand(device="cpu")
    small = keys.casts["small"][1].params
    with pytest.raises(ValueError, match="small"):
        cl.CompactPkeCastingKey(keys.ppriv, keys.pck, small, seed=1, device="cpu")



def test_drift_cast_matches(keys, monkeypatch):
    """The cast to small under a compute key with drift zeros: the drift
    choice, the plain modulus switch and the refresh give tfhe_tpu's words
    (the drift arm of cast_batch, which no longer refuses)."""
    import copy

    r, p = keys.encrypt_both(monkeypatch, keys.rcpk, keys.cpk, [1, 2, 3], 13)
    drift = {mod: dataclasses.replace(cut(mod), drift_zeros_count=4,
                                      ms_noise_reduction=mod.MsNoiseReduction.DRIFT)
             for mod in (ref_params, port_params)}
    rsk = ref_shortint.ServerKey(ref_shortint.ClientKey(drift[ref_params], seed=SEED),
                                 seed=SEED + 9)
    psk = shortint.ServerKey(shortint.ClientKey(drift[port_params], seed=SEED),
                             seed=SEED + 9, device="cpu")
    assert (np.asarray(rsk.drift_zeros) == torus.to_u64(psk.drift_zeros)).all()
    rcast = copy.copy(keys.casts["small"][0])
    rcast.dst_params, rcast.server_key = drift[ref_params], rsk
    pcast = cl.CompactPkeCastingKey.from_raw_parts(
        torus.to_u64(keys.casts["small"][1].ksk), drift[port_params],
        keys.casts["small"][1].params, psk, device="cpu")
    got = pcast.cast_batch(p.expand(casting_key=keys.casts["big"][1]))
    same(rcast.cast_batch(r.expand(casting_key=keys.casts["big"][0])), got)


def test_re_randomize_batch(keys):
    """ct + a seeded compact-key encryption of zero: tfhe_tpu's words,
    degrees and noise levels (+1), deterministic in the seed, and the same
    plaintexts."""
    cts = [keys.rck.encrypt(m) for m in MESSAGES[:4]]
    pcts = [shortint.Ciphertext(np.asarray(c.data), c.degree, c.noise_level,
                                c.message_modulus, c.carry_modulus) for c in cts]
    ref_key, key = ref_rr.ReRandomizationKey(keys.rcpk_compute), \
        rr.ReRandomizationKey(keys.cpk_compute)
    want = ref_key.re_randomize_batch(cts, b"seed", b"ctx")
    got = key.re_randomize_batch(pcts, b"seed", b"ctx", device="cpu")
    same(want, got)
    assert (words(got) != words(pcts)).any()
    assert [keys.pck.decrypt(c) for c in got] == [m % 4 for m in MESSAGES[:4]]
    same([ref_key.re_randomize(cts[0], b"other")],
         [key.re_randomize(pcts[0], b"other", device="cpu")])


@pytest.mark.parametrize("level", ["shortint", "integer"])
def test_key_switching_key_cast(keys, level):
    """A casting key between two client keys of the cut set: tfhe_tpu's KSK
    and cast words (integer: blockwise, one call)."""
    other = dataclasses.replace(cut(shortint), polynomial_size=128)
    ref_other = dataclasses.replace(cut(ref_shortint), polynomial_size=128)
    rdst, pdst = ref_shortint.ClientKey(ref_other, seed=SEED + 7), \
        shortint.ClientKey(other, seed=SEED + 7)
    if level == "shortint":
        rk = ref_ksk.KeySwitchingKey(keys.rck, rdst, seed=SEED + 8)
        pk = ksk_mod.KeySwitchingKey(keys.pck, pdst, seed=SEED + 8, device="cpu")
        assert (torus.to_u64(pk.ksk) == np.asarray(rk.ksk)).all()
        cts = [keys.rck.encrypt(m) for m in (1, 2, 3)]
        got = pk.cast_batch([shortint.Ciphertext(np.asarray(c.data), c.degree, c.noise_level,
                                                 4, 4) for c in cts])
        same(rk.cast_batch(cts), got)
        assert [pdst.decrypt(c) for c in got] == [1, 2, 3]
        with pytest.raises(ValueError, match="moduli"):
            ksk_mod.KeySwitchingKey(keys.pck, shortint.ClientKey(
                dataclasses.replace(other, message_modulus=8), seed=1), device="cpu")
    else:
        from tfhe_tpu import integer as ref_integer

        rsrc = ref_integer.ClientKey(cut(ref_shortint), seed=SEED)
        psrc = integer.ClientKey(cut(shortint), seed=SEED)
        rdst_i = ref_integer.ClientKey(ref_other, seed=SEED + 7)
        pdst_i = integer.ClientKey(other, seed=SEED + 7)
        rk = ref_iksk.KeySwitchingKey(rsrc, rdst_i, seed=SEED + 9)
        pk = iksk.KeySwitchingKey(psrc, pdst_i, seed=SEED + 9, device="cpu")
        ct = rsrc.encrypt_radix(0xB5, 4)
        pct = integer.RadixCiphertext([shortint.Ciphertext(
            np.asarray(b.data), b.degree, b.noise_level, 4, 4) for b in ct.blocks])
        got = pk.cast(pct)
        same(rk.cast(ct).blocks, got.blocks)
        assert pdst_i.decrypt_radix(got) == 0xB5


def test_oprf_compute_key_draw(keys):
    """The restored compute-key draw: tfhe_tpu's pseudorandom LWE and its
    output words and degree, for two bit counts."""
    p = keys.p
    assert (oprf.pseudo_random_lwe(p, 77) == ref_oprf.pseudo_random_lwe(p, 77)).all()
    for bits in (None, 1):
        want = ref_oprf.generate_oblivious_pseudo_random(keys.rsk, 78, bits)
        got = oprf.generate_oblivious_pseudo_random(keys.psk, 78, bits)
        same([want], [got])
        assert keys.pck.decrypt(got) <= got.degree


def test_compression_flag_is_restored():
    """enable_compression sets a flag that nothing reads, as in tfhe_tpu."""
    for mod in (ref_t, t):
        cfg = mod.ConfigBuilder().enable_compression().build()
        assert cfg.enable_compression and not mod.Config().enable_compression
    assert [f.name for f in dataclasses.fields(t.Config)] == \
        [f.name for f in dataclasses.fields(ref_t.Config)]


@pytest.mark.parametrize("call", ["generate_many_lookup_table", "apply_many_lookup_table",
                                  "apply_many_lookup_table_batch"])
def test_many_lut_is_refused(keys, call):
    """Many-LUT runs (it refused until the atomic-pattern slice): each entry
    gives tfhe_tpu's tables and words on the cut set."""
    fns = [lambda x: x % 4, lambda x: (x * 3) % 4]
    rm, pm = keys.rsk.generate_many_lookup_table(fns), keys.psk.generate_many_lookup_table(fns)
    assert (rm.acc == pm.acc).all() and (rm.stride, rm.degrees, rm.input_max_degree) == (
        pm.stride, pm.degrees, pm.input_max_degree)
    if call == "generate_many_lookup_table":
        return
    vals = [1, 3, 0] if call.endswith("batch") else [2]
    # the same input words in both packages (the client keys' generators are
    # shared with the other tests of the module)
    rc = [keys.rck.encrypt(v) for v in vals]
    pc = [shortint.Ciphertext(np.asarray(c.data, dtype=np.uint64), c.degree, c.noise_level,
                              c.message_modulus, c.carry_modulus) for c in rc]
    if call.endswith("batch"):
        ro, po = keys.rsk.apply_many_lookup_table_batch(rc, rm), \
            keys.psk.apply_many_lookup_table_batch(pc, pm)
    else:
        ro, po = [keys.rsk.apply_many_lookup_table(rc[0], rm)], \
            [keys.psk.apply_many_lookup_table(pc[0], pm)]
    for r, p, v in zip(ro, po, vals):
        same(r, p)
        assert [keys.pck.decrypt(c) for c in p] == [f(v) for f in fns]
