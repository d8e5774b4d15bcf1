"""The port's wire format and host substrate against tfhe_tpu's, on the CPU
(tolerance 0): every registered type serializes to tfhe_tpu's bytes, and
each package reads the other's payloads; the safe limits, the conformance
predicate and the upgrade chain; tfhe_tpu's backward-compatibility corpus
(tests/compat_corpus/) read by the port and decrypted with the port's keys;
a client -> server -> client round trip through the wire (a seeded server
key, an add, modulus-switched storage); and the parameter snapshots, the
noise formulas and the security checks, equal on every parameter set.

Keys: the TEST set (n = 16, N = 512), from the same seeds in both packages,
built once per module."""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from tfhe_tpu import integer as ref_integer
from tfhe_tpu import shortint as ref_shortint
from tfhe_tpu.core import noise as ref_noise
from tfhe_tpu.core import security as ref_security
from tfhe_tpu.shortint import compressed_key as ref_ck
from tfhe_tpu.shortint import noise_squashing as ref_ns
from tfhe_tpu.shortint import params as ref_params
from tfhe_tpu.shortint import params_versions as ref_versions
from tfhe_tpu.shortint import server_key as ref_sk
from tfhe_tpu.integer import ciphertext as ref_ict
from tfhe_tpu.utils import serialization as ref_ser
from tfhe_tpu.zk import pke as ref_pke
from tfhe_tpu.zk import pke_v2 as ref_pke_v2
from tfhe_tpu.hlapi import proven_compact_list as ref_pcl
from tfhe_tpu_torch import integer, shortint
from tfhe_tpu_torch.core import noise, security
from tfhe_tpu_torch.hlapi import proven_compact_list as pcl
from tfhe_tpu_torch.integer import ciphertext as ict
from tfhe_tpu_torch.ops import torus
from tfhe_tpu_torch.shortint import compressed_key as port_ck
from tfhe_tpu_torch.shortint import noise_squashing as ns
from tfhe_tpu_torch.shortint import params as port_params
from tfhe_tpu_torch.shortint import params_versions
from tfhe_tpu_torch.shortint import server_key as port_sk
from tfhe_tpu_torch.shortint.ciphertext import DeviceLweBatch, LazyLweData
from tfhe_tpu_torch.utils import serialization as ser
from tfhe_tpu_torch.zk import curve446, pke, pke_v2

torch.set_num_threads(1)  # the suite runs in parallel processes: one thread each

SEED = 0x5E71
CORPUS = Path(__file__).parent / "compat_corpus"
CORPUS_SEED = 0xC04B05


class Keys:
    """Both packages' TEST integer client keys (from one seed), their seeded
    server keys and one seeded ciphertext."""

    def __init__(self):
        self.r = ref_integer.ClientKey(ref_shortint.TEST_PARAM_MESSAGE_2_CARRY_2, seed=SEED)
        self.p = integer.ClientKey(shortint.TEST_PARAM_MESSAGE_2_CARRY_2, seed=SEED)
        self.rcsk = ref_ck.CompressedServerKey(self.r.key, seed=SEED + 1)
        self.pcsk = port_ck.CompressedServerKey(self.p.key, seed=SEED + 1)
        self.rcct = ref_ck.CompressedCiphertext(self.r.key, 3, seed=SEED + 2)
        self.pcct = port_ck.CompressedCiphertext(self.p.key, 3, seed=SEED + 2)


@pytest.fixture(scope="module")
def keys():
    return Keys()


def _points(n: int):
    """n distinct curve points of each group, as both Proof classes hold
    them (bytes only: the wire format does not check them)."""
    g1 = [curve446.g1_mul(curve446.G1_GEN, 3 + i) for i in range(n)]
    return g1, [curve446.G2_GEN] * n


def _msc(mod, i: int):
    packed = np.random.default_rng(i).integers(0, 256, 22, dtype=np.uint8)
    return mod.CompressedModulusSwitchedCiphertext(packed, 17, 10, 3 + i, 4, 4)


def objects(keys) -> dict:
    """name -> (tfhe_tpu's object, the port's) of every registered type."""
    r, p = keys.r, keys.p
    g1, g2 = _points(8)
    rng = np.random.default_rng(SEED)
    lo, hi = (rng.integers(0, 1 << 64, 33, dtype=np.uint64) for _ in range(2))
    c1, c2 = (rng.integers(0, 1 << 64, m, dtype=np.uint64) for m in (64, 5))
    v2 = dict(c_hat_e=g2[0], c_e=g1[0], c_r_tilde=g1[1], c_R=g1[2], c_hat_bin=g2[1],
              c_y=g1[3], c_h1=g1[4], c_h2=g1[5], c_hat_t=g2[2], pi=g1[6], pi_kzg=g1[7])
    return {
        "Ciphertext": (r.key.encrypt(3), p.key.encrypt(3)),
        "RadixCiphertext": (r.encrypt_radix(201, 4), p.encrypt_radix(201, 4)),
        "SignedRadixCiphertext": (r.encrypt_signed_radix(-55, 4),
                                  p.encrypt_signed_radix(-55, 4)),
        "CrtCiphertext": (r.encrypt_crt(7, [3, 4]), p.encrypt_crt(7, [3, 4])),
        "BooleanBlock": (ref_ict.BooleanBlock(r.key.encrypt(1)),
                         ict.BooleanBlock(p.key.encrypt(1))),
        "SquashedNoiseCiphertext": (
            ref_ns.SquashedNoiseCiphertext(lo, hi, 3, 4, 4),
            ns.SquashedNoiseCiphertext(torus.from_u64(lo, "cpu"), torus.from_u64(hi, "cpu"),
                                       3, 4, 4)),
        "SeededLweCiphertextList": (keys.rcct.inner, keys.pcct.inner),
        "SeededLweKeyswitchKey": (keys.rcsk.seeded_ksk, keys.pcsk.seeded_ksk),
        "SeededLweBootstrapKey": (keys.rcsk.seeded_bsk, keys.pcsk.seeded_bsk),
        "CompressedModulusSwitchedCiphertext": (_msc(ref_sk, 0), _msc(port_sk, 0)),
        "CompressedModulusSwitchedRadixCiphertext": (
            ref_ict.CompressedModulusSwitchedRadixCiphertext(
                [_msc(ref_sk, 1), _msc(ref_sk, 2)], True),
            ict.CompressedModulusSwitchedRadixCiphertext(
                [_msc(port_sk, 1), _msc(port_sk, 2)], True)),
        "Proof": (ref_pke.Proof(g2[0], g1[0], g1[1], g2[1], g1[2], None),
                  pke.Proof(g2[0], g1[0], g1[1], g2[1], g1[2], None)),
        "ProofV2": (ref_pke_v2.ProofV2(**v2), pke_v2.ProofV2(**v2)),
        "ProvenCompactCiphertextList": (
            ref_pcl.ProvenCompactCiphertextList(c1, c2, ref_pke_v2.ProofV2(**v2), 4, 4),
            pcl.ProvenCompactCiphertextList(c1, c2, pke_v2.ProofV2(**v2), 4, 4)),
    }


def test_registries_are_tfhe_tpus():
    assert ser.MAGIC == ref_ser.MAGIC and ser.FORMAT_VERSION == ref_ser.FORMAT_VERSION
    assert {n: e["version"] for n, e in ser._REGISTRY.items()} == {
        n: e["version"] for n, e in ref_ser._REGISTRY.items()}


@pytest.mark.parametrize("name", sorted(ref_ser._REGISTRY))
def test_bytes_and_cross_reads(keys, name):
    """The port's bytes equal tfhe_tpu's; each package reads the other's
    payload back to an object that serializes to the same bytes."""
    robj, pobj = objects(keys)[name]
    want = ref_ser.serialize(robj)
    got = ser.serialize(pobj)
    assert got == want
    back = ser.deserialize(want)
    assert type(back).__name__ == name and ser.serialize(back) == want
    assert ref_ser.serialize(ref_ser.deserialize(got)) == want


def test_device_resident_round_output(keys):
    """A round's lazy device-resident output serializes to the bytes of its
    materialised words (tfhe_tpu's round output's bytes), one download
    counted."""
    rsk = ref_shortint.ServerKey(keys.r.key, seed=SEED + 3)
    psk = shortint.ServerKey(keys.p.key, seed=SEED + 3, device="cpu")
    f = lambda x: (x + 1) % 4                        # noqa: E731
    ro = rsk.apply_lookup_table_batch([keys.r.key.encrypt(2)], rsk.generate_lookup_table(f))
    po = psk.apply_lookup_table_batch([keys.p.key.encrypt(2)], psk.generate_lookup_table(f))
    assert isinstance(po[0].data, LazyLweData)
    before = DeviceLweBatch.downloads
    got = ser.serialize(po[0])
    assert DeviceLweBatch.downloads == before + 1
    assert got == ref_ser.serialize(ro[0])
    assert keys.p.key.decrypt(ser.deserialize(got)) == 3


def test_safe_limits_and_conformance(keys):
    ct = keys.p.key.encrypt(2)
    data = ser.safe_serialize(ct)
    with pytest.raises(ValueError, match="exceeds limit"):
        ser.safe_serialize(ct, size_limit=len(data) - 1)
    with pytest.raises(ValueError, match="exceeds limit"):
        ser.safe_deserialize(data, size_limit=len(data) - 1)
    with pytest.raises(ValueError, match="conformance"):
        ser.safe_deserialize(data, conformance=lambda c: c.message_modulus == 8)
    back = ser.safe_deserialize(data, size_limit=len(data),
                                conformance=lambda c: c.message_modulus == 4)
    assert keys.p.key.decrypt(back) == 2
    with pytest.raises(ValueError, match="not a tfhe_tpu payload"):
        ser.deserialize(ser.cbor_dumps({"magic": "other"}))
    with pytest.raises(TypeError, match="not registered"):
        ser.serialize(object())


def test_upgrade_chain(keys):
    """A payload stored at an older version is upgraded step by step; one
    with no path, or newer than supported, is refused (both packages)."""
    from tfhe_tpu_torch.utils import cbor

    data = ser.serialize(keys.p.key.encrypt(1))
    doc = cbor.loads(data)

    def stored(version, payload=None):
        return ser.cbor_dumps({**doc, "version": version, "payload": payload or doc["payload"]})

    for mod in (ser, ref_ser):
        with pytest.raises(ValueError, match="no upgrade path"):
            mod.deserialize(stored(-1))
        with pytest.raises(ValueError, match="newer"):
            mod.deserialize(stored(1))
    old = {k: v for k, v in doc["payload"].items() if k != "noise_level"}
    ser.register_upgrade("Ciphertext", -1, lambda p: {**p, "noise_level": 1})
    try:
        back = ser.deserialize(stored(-1, old))
    finally:
        del ser._REGISTRY["Ciphertext"]["upgrades"][-1]
    assert back.noise_level == 1 and keys.p.key.decrypt(back) == 1


def test_compat_corpus_reads_and_decrypts():
    """tfhe_tpu's stored v0 artifacts: the port reads each, re-serializes it
    to the same bytes, and decrypts it with its own keys from the corpus
    seed."""
    manifest = json.loads((CORPUS / "manifest.json").read_text())
    ck = integer.ClientKey(shortint.TEST_PARAM_MESSAGE_2_CARRY_2, seed=CORPUS_SEED)
    for name, meta in manifest.items():
        blob = (CORPUS / name).read_bytes()
        obj = ser.deserialize(blob)
        assert ser.serialize(obj) == blob, name
        if name.startswith("shortint"):
            got = ck.key.decrypt_raw(obj)
        elif name.startswith("signed"):
            got = ck.decrypt_signed_radix(obj)
        elif name.startswith("crt"):
            got = ck.decrypt_crt(obj)
        else:
            got = ck.decrypt_radix(obj)
        assert got == meta["value"], name


def test_wire_round_trip(keys):
    """Client: a seeded server key and two encrypted integers on the wire.
    Server (the CPU here, the card in chip_smoke.py): the key from its seeds
    and bodies (the BSK's mask floor is the set's, not in the payload), an
    add, modulus-switched storage on the wire and back, a decompression;
    the client decrypts the result."""
    p = shortint.TEST_PARAM_MESSAGE_2_CARRY_2
    key_bytes = [ser.serialize(keys.pcsk.seeded_ksk), ser.serialize(keys.pcsk.seeded_bsk)]
    ct_bytes = [ser.serialize(keys.p.encrypt_radix(v, 4)) for v in (150, 90)]
    # server
    sksk, sbsk = (ser.deserialize(b) for b in key_bytes)
    floor = port_sk.ROUND_BITS if port_sk._v7_family(p) else 0
    csk = port_ck.CompressedServerKey.from_raw_parts(p, sksk.seed, sksk.bodies, sbsk.seed,
                                                     sbsk.bodies, floor)
    sk = integer.ServerKey.from_shortint_key(csk.decompress(device="cpu"))
    want = keys.pcsk.decompress(device="cpu")
    assert (torus.to_u64(sk.key.ksk) == torus.to_u64(want.ksk)).all()
    assert (sk.key._bsk_coeff.data == want._bsk_coeff.data).all()
    total = sk.add_parallelized(*(ser.deserialize(b) for b in ct_bytes))
    stored = ser.serialize(sk.switch_modulus_and_compress(total))
    out = ser.serialize(sk.decompress(ser.deserialize(stored)))
    # client
    assert keys.p.decrypt_radix(ser.deserialize(out)) == 240
    # tfhe_tpu reads every payload of the round trip
    assert ref_ser.deserialize(stored).blocks[0].count == p.lwe_dimension + 1
    assert keys.r.decrypt_radix(ref_ser.deserialize(out)) == 240


# ---------------------------------------------------------------------------
# Parameter snapshots, noise formulas, security checks
# ---------------------------------------------------------------------------


def _fields(q) -> dict:
    out = {}
    for f in dataclasses.fields(q):
        v = getattr(q, f.name)
        if hasattr(v, "bound_log2") or hasattr(v, "std"):
            v = (type(v).__name__, dataclasses.astuple(v))
        elif hasattr(v, "value"):
            v = v.value
        out[f.name] = v
    return out


def test_params_versions_are_tfhe_tpus():
    assert params_versions.CURRENT_VERSION == ref_versions.CURRENT_VERSION
    assert set(params_versions.PARAMETER_VERSIONS) == set(ref_versions.PARAMETER_VERSIONS)
    snap, ref_snap = (m.PARAMETER_VERSIONS["v1_4"] for m in (params_versions, ref_versions))
    assert sorted(snap) == sorted(ref_snap)
    for name in ref_snap:
        assert _fields(params_versions.get(name)) == _fields(ref_versions.get(name)), name
        assert getattr(params_versions, name) is params_versions.get(name)
    assert sorted(params_versions.aliases()) == sorted(ref_versions.aliases())


SHORTINT_SETS = sorted(n for n, v in vars(ref_params).items()
                       if isinstance(v, ref_params.ShortintParams))


@pytest.mark.parametrize("name", SHORTINT_SETS)
def test_noise_and_security_are_tfhe_tpus(name):
    """check_shortint_params_secure and the noise formulas (keyswitch,
    modulus switch, centered MS, classic and multi-bit PBS with and without
    a rounded key, packing keyswitch, the symbolic simulation) give the same
    floats and verdicts on every set."""
    r, p = getattr(ref_params, name), getattr(port_params, name)
    assert ref_security.check_shortint_params_secure(r) == \
        security.check_shortint_params_secure(p)
    calls = []
    for mod, q in ((ref_noise, r), (noise, p)):
        var_ksk = mod.distribution_variance(q.lwe_noise, q.bits)
        var_bsk = mod.distribution_variance(q.glwe_noise, q.bits)
        log_mod = q.polynomial_size.bit_length()
        vals = [
            mod.keyswitch_additive_variance(q.big_lwe_dimension, q.ks_base_log, q.ks_level,
                                            var_ksk),
            mod.modulus_switch_additive_variance(q.lwe_dimension, log_mod),
            mod.centered_ms_additive_variance(q.lwe_dimension, log_mod),
            mod.pbs_output_variance(q.lwe_dimension, q.glwe_dimension, q.polynomial_size,
                                    q.pbs_base_log, q.pbs_level, var_bsk,
                                    bsk_round_bits=15, bsk_mask_floored=True),
            mod.multibit_pbs_output_variance(q.lwe_dimension, 4, q.glwe_dimension,
                                             q.polynomial_size, q.pbs_base_log,
                                             q.pbs_level, var_bsk, bsk_round_bits=18),
            mod.packing_keyswitch_additive_variance(q.lwe_dimension, q.ks_base_log,
                                                    q.ks_level, var_ksk, 256),
            mod.variance_to_std_log2(var_bsk),
        ]
        sim = mod.NoiseSimulationLwe.encrypt(q.glwe_noise, q.big_lwe_dimension)
        sim = sim.scalar_mul(3).add(sim).keyswitch(q.lwe_dimension, q.ks_base_log,
                                                   q.ks_level, q.lwe_noise).pbs(q.core)
        calls.append(vals + [sim.variance, sim.lwe_dimension])
    assert calls[0] == calls[1]


def test_minimal_variances_are_tfhe_tpus():
    for n in (16, 512, 630, 918, 2048, 4096):
        for bits in (32, 64, 128):
            q = 2.0 ** bits
            for fn in ("minimal_lwe_variance_gaussian", "minimal_lwe_bound_tuniform",
                       "minimal_lwe_variance_tuniform"):
                assert getattr(security, fn)(n, q) == getattr(ref_security, fn)(n, q)
