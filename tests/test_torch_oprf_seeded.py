"""The port's OPRF and seeded (compressed) keys against tfhe_tpu on the CPU,
word for word (tolerance 0): OPRF keys from the same seeds, and every draw
(unsigned full and bounded, signed, custom range, the hlapi types'), the
OPRF-keyed bitonic shuffle, through the dedicated key and the compute key
(K2's exact function on the exact key); seeded KSKs, BSKs and ciphertexts
from one seed, their decompression byte for byte, the floored seeded BSK
of a v7-family shape and its refusal where tfhe_tpu refuses."""

import dataclasses

import numpy as np
import pytest
import torch

import tfhe_tpu as ref_t
import tfhe_tpu_torch as t
from tfhe_tpu import integer as ref_integer
from tfhe_tpu import shortint as ref_shortint
from tfhe_tpu.core import keygen as ref_kg
from tfhe_tpu.core import security as ref_security
from tfhe_tpu.core.params import DecompParams as RefDecompParams
from tfhe_tpu.integer import oprf as ref_ioprf
from tfhe_tpu.shortint import compressed_key as ref_ck
from tfhe_tpu.utils.csprng import DeterministicSeeder as RefSeeder
from tfhe_tpu.utils.csprng import EncryptionRandomGenerator as RefGen
from tfhe_tpu_torch import integer, shortint
from tfhe_tpu_torch.core import security
from tfhe_tpu_torch.integer import oprf as ioprf
from tfhe_tpu_torch.ops import torus
from tfhe_tpu_torch.shortint import compressed_key as ck_mod
from tfhe_tpu_torch.shortint import oprf as soprf

torch.set_num_threads(1)  # the suite runs in parallel processes: one thread each

SEED = 0x0F4F
NB = 4


def same(r, p) -> None:
    """The same blocks: u64 words, degrees and noise levels."""
    if isinstance(r, (list, tuple)):
        assert len(r) == len(p)
        for x, y in zip(r, p):
            same(x, y)
        return
    r, p = getattr(r, "inner", r), getattr(p, "inner", p)
    assert type(r).__name__ == type(p).__name__
    br = getattr(r, "blocks", [getattr(r, "block", r)])
    bp = getattr(p, "blocks", [getattr(p, "block", p)])
    got = np.stack([np.asarray(b.data) for b in bp])
    assert got.dtype == np.uint64 and (got == np.stack([np.asarray(b.data) for b in br])).all()
    assert [b.degree for b in bp] == [b.degree for b in br]
    assert [b.noise_level for b in bp] == [b.noise_level for b in br]


class Keys:
    def __init__(self):
        self.rck, self.rsk = ref_integer.gen_keys(ref_shortint.TEST_PARAM_MESSAGE_2_CARRY_2,
                                                  seed=SEED)
        self.pck, self.psk = integer.gen_keys(shortint.TEST_PARAM_MESSAGE_2_CARRY_2, seed=SEED,
                                              device="cpu")
        self.r_dedicated = ref_ioprf.OprfServerKey.new(
            ref_ioprf.OprfPrivateKey(self.rck, seed=SEED + 1), self.rck, seed=SEED + 2)
        self.p_dedicated = ioprf.OprfServerKey.new(
            ioprf.OprfPrivateKey(self.pck, seed=SEED + 1), self.pck, seed=SEED + 2,
            device="cpu")
        self.r_compute = ref_ioprf.OprfServerKey.from_compute_key(self.rsk)
        self.p_compute = ioprf.OprfServerKey.from_compute_key(self.psk)

    def draw(self, key: str, method: str, *args):
        """The same draw through tfhe_tpu's and the port's OPRF key (key:
        "dedicated" or "compute"), checked block for block."""
        r = getattr(getattr(self, f"r_{key}"), method)(*args, self.rsk)
        p = getattr(getattr(self, f"p_{key}"), method)(*args, self.psk)
        same(r, p)
        return r, p


@pytest.fixture(scope="module")
def keys():
    return Keys()


def test_oprf_keys_match(keys):
    """The OPRF secret key and the exact NTT-domain OPRF BSK are tfhe_tpu's,
    from the generator and from tfhe_tpu's standard-domain key
    (from_raw_key); the compute key view is the server key's exact key."""
    rpk = ref_ioprf.OprfPrivateKey(keys.rck, seed=SEED + 1)
    ppk = ioprf.OprfPrivateKey(keys.pck, seed=SEED + 1)
    assert (ppk.key.lwe_sk.data == np.asarray(rpk.key.lwe_sk.data)).all()
    want = np.asarray(keys.r_dedicated.key.bsk_mont)
    assert np.array_equal(keys.p_dedicated.key.bsk_ntt.numpy().view(np.uint32), want)
    p = ref_shortint.TEST_PARAM_MESSAGE_2_CARRY_2
    gen = RefGen(SEED + 2, RefSeeder((SEED + 2) ^ 0x9E3779B9))
    bsk = ref_kg.generate_lwe_bootstrap_key(
        rpk.key.lwe_sk, keys.rck.key.glwe_secret_key,
        RefDecompParams(p.pbs_base_log, p.pbs_level), p.glwe_noise, gen)
    raw = soprf.OprfServerKey.from_raw_key(np.asarray(bsk.data), keys.pck.params, device="cpu")
    assert np.array_equal(raw.bsk_ntt.numpy().view(np.uint32), want)
    assert keys.p_compute.key.bsk_ntt is keys.psk.key.exact_bsk_ntt()
    assert keys.p_dedicated.key.device.type == "cpu"


def test_unsigned_full_draw_matches_and_repeats(keys):
    r, p = keys.draw("dedicated", "generate_oblivious_pseudo_random_unsigned_integer", 7, NB)
    v = keys.pck.decrypt_radix(p)
    assert v == keys.rck.decrypt_radix(r) and 0 <= v < 4 ** NB
    _, again = keys.draw("dedicated", "generate_oblivious_pseudo_random_unsigned_integer", 7, NB)
    same(p, again)


@pytest.mark.parametrize("bits", [3, 5])
def test_unsigned_bounded_draw_matches(keys, bits):
    r, p = keys.draw("compute", "generate_oblivious_pseudo_random_unsigned_integer_bounded",
                     bits, bits, NB)
    v = keys.pck.decrypt_radix(p)
    assert v == keys.rck.decrypt_radix(r) and 0 <= v < 2 ** bits


def test_signed_draws_match(keys):
    r, p = keys.draw("compute", "generate_oblivious_pseudo_random_signed_integer", 3, 3)
    v = keys.pck.decrypt_signed_radix(p)
    assert v == keys.rck.decrypt_signed_radix(r) and -(2 ** 5) <= v < 2 ** 5
    r, p = keys.draw("compute", "generate_oblivious_pseudo_random_signed_integer_bounded",
                     4, 3, 3)
    assert keys.pck.decrypt_signed_radix(p) == keys.rck.decrypt_signed_radix(r)
    assert 0 <= keys.pck.decrypt_signed_radix(p) < 2 ** 3


def test_custom_range_draw_matches(keys):
    r, p = keys.draw("compute", "generate_oblivious_pseudo_random_unsigned_custom_range",
                     2, 4, 5, 2)
    v = keys.pck.decrypt_radix(p)
    assert v == keys.rck.decrypt_radix(r) and 0 <= v < 5


def test_bitonic_shuffle_matches(keys):
    """The OPRF-keyed bitonic shuffle of two 4-bit values: every output
    block, and a permutation of the inputs."""
    vals = [9, 4]
    r = keys.rsk.bitonic_shuffle(keys.r_compute, [keys.rck.encrypt_radix(v, 2) for v in vals],
                                 4, 3)
    p = keys.psk.bitonic_shuffle(keys.p_compute, [keys.pck.encrypt_radix(v, 2) for v in vals],
                                 4, 3)
    same(r, p)
    assert sorted(keys.pck.decrypt_radix(c) for c in p) == sorted(vals)


def test_hlapi_draws_match(keys):
    """FheUint8's draws through the hlapi (the compute key as OPRF key)."""
    def run(api, hck, hsk):
        with api.with_server_key_as_context(hsk):
            return [api.FheUint8.generate_oblivious_pseudo_random(5),
                    api.FheUint8.generate_oblivious_pseudo_random_bounded(5, 3)]

    rh = ref_t.hlapi.keys.ServerKey.__new__(ref_t.hlapi.keys.ServerKey)
    rh.integer_key, rh.config, rh.noise_squashing_key = keys.rsk, None, None
    ph = t.ServerKey.from_raw_parts(None, keys.psk)
    r, p = run(ref_t, keys.rck, rh), run(t, keys.pck, ph)
    same(r, p)
    got = [keys.pck.decrypt_radix(x.inner) for x in p]
    assert got == [keys.rck.decrypt_radix(x.inner) for x in r]
    assert got[0] < 256 and got[1] < 8


# ---------------------------------------------------------------------------
# Seeded keys and ciphertexts
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def compressed(keys):
    return (ref_ck.CompressedServerKey(keys.rck.key, seed=SEED + 3),
            ck_mod.CompressedServerKey(keys.pck.key, seed=SEED + 3))


def test_seeded_keys_match(compressed):
    """Seeds, stored bodies and the decompressed KSK and BSK, byte for byte;
    bodies only: (n+1) -> 1 for the KSK, (k+1) -> 1 for the BSK rows."""
    r, p = compressed
    for rs, ps in ((r.seeded_ksk, p.seeded_ksk), (r.seeded_bsk, p.seeded_bsk)):
        assert rs.seed == ps.seed
        assert (ps.bodies == np.asarray(rs.bodies)).all()
        assert (ps.decompress() == np.asarray(rs.decompress())).all()
    assert r.seeded_bsk.mask_floor_rb == p.seeded_bsk.mask_floor_rb == 0
    q = shortint.TEST_PARAM_MESSAGE_2_CARRY_2
    assert p.nbytes == (q.big_lwe_dimension * q.ks_level + q.lwe_dimension * q.pbs_level
                        * (q.glwe_dimension + 1) * q.polynomial_size) * 8 + 32


def test_decompressed_server_key_matches(keys, compressed):
    """The decompressed key on the asked device, and from the carried-in
    seeds and bodies (from_raw_parts): the same words through a LUT."""
    r, p = compressed
    rsk = r.decompress()
    carried = ck_mod.CompressedServerKey.from_raw_parts(
        keys.pck.params, r.seeded_ksk.seed, np.asarray(r.seeded_ksk.bodies),
        r.seeded_bsk.seed, np.asarray(r.seeded_bsk.bodies), r.seeded_bsk.mask_floor_rb)
    rct, pct = keys.rck.key.encrypt(2), keys.pck.key.encrypt(2)
    rlut = rsk.generate_lookup_table(lambda x: (3 * x) % 16)
    want = rsk.apply_lookup_table(rct, rlut)
    for psk in (p.decompress(device="cpu"), carried.decompress(device="cpu")):
        assert psk.device.type == "cpu"
        assert (torus.to_u64(psk.ksk) == np.asarray(rsk.ksk)).all()
        got = psk.apply_lookup_table(pct, psk.generate_lookup_table(lambda x: (3 * x) % 16))
        same(want, got)
    assert keys.pck.key.decrypt_raw(got) == 6


def test_compressed_ciphertext_matches(keys):
    for m in (0, 3):
        r = ref_ck.CompressedCiphertext(keys.rck.key, m, seed=SEED + 10 + m)
        p = ck_mod.CompressedCiphertext(keys.pck.key, m, seed=SEED + 10 + m)
        assert r.inner.seed == p.inner.seed and (p.inner.bodies == np.asarray(r.inner.bodies)).all()
        assert p.inner.bodies.size == 1
        same(r.decompress(), p.decompress())
        assert keys.pck.key.decrypt(p.decompress()) == m


def _v7_shape(mod):
    """The TEST set at the v7 family's shape (N = 2048, k = 1, l = 1)."""
    return dataclasses.replace(mod.TEST_PARAM_MESSAGE_2_CARRY_2, polynomial_size=2048)


def test_floored_seeded_bsk_matches_at_a_v7_shape():
    """A seeded key of the v7 family is floored at 15 bits as tfhe_tpu floors
    it: the same stored bodies and decompressed masks, floored."""
    rck = ref_shortint.ClientKey(_v7_shape(ref_shortint), seed=SEED + 4)
    pck = shortint.ClientKey(_v7_shape(shortint), seed=SEED + 4)
    r = ref_ck.CompressedServerKey(rck, seed=SEED + 5)
    p = ck_mod.CompressedServerKey(pck, seed=SEED + 5)
    assert r.seeded_bsk.mask_floor_rb == p.seeded_bsk.mask_floor_rb == 15
    assert (p.seeded_bsk.bodies == np.asarray(r.seeded_bsk.bodies)).all()
    data = p.seeded_bsk.decompress()
    assert (data == np.asarray(r.seeded_bsk.decompress())).all()
    assert (data[..., :1, :] & np.uint64((1 << 15) - 1) == 0).all()


def test_floored_seeded_bsk_refuses_where_tfhe_tpu_refuses(monkeypatch):
    """Where flooring would take a secure set below the estimator curve
    (made so here by an estimator that fails only the shrunk modulus), both
    packages refuse the seeded key."""
    for mod in (ref_security, security):
        real = mod.check_lwe_noise_secure
        monkeypatch.setattr(mod, "check_lwe_noise_secure",
                            lambda dist, n, *a, _real=real, **kw: (
                                (False, "floored") if kw.get("modulus_log2_shrink")
                                else (True, "")))
    with pytest.raises(ValueError, match="degrade"):
        ref_ck.CompressedServerKey(ref_shortint.ClientKey(_v7_shape(ref_shortint), seed=1),
                                   seed=2)
    with pytest.raises(ValueError, match="degrade"):
        ck_mod.CompressedServerKey(shortint.ClientKey(_v7_shape(shortint), seed=1), seed=2)


def test_oprf_server_key_defaults_to_cuda(keys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        soprf.OprfServerKey.new(soprf.OprfPrivateKey(keys.pck.key, seed=1), keys.pck.key, seed=2)
    with pytest.raises(RuntimeError, match="cuda"):
        ck_mod.CompressedServerKey(keys.pck.key, seed=3).decompress()
