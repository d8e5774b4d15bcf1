"""The compression slice of the port against tfhe_tpu on the CPU, word for
word (tolerance 0; all arithmetic is integer): the compression parameters,
the packing and decompression keys (unfloored at TEST_PARAM_MESSAGE_2_CARRY_2
with TEST_COMP_PARAM, floored at N = 2048), the plain packing keyswitch,
compress and decompress, the decompression rotation against the TPU
kernels' XLA twins, modulus-switched compression on a classic and a
multi-bit key, and the K4 wrapper and the key's owner on CPU tensors."""

import dataclasses
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tfhe_tpu import shortint as ref
from tfhe_tpu.core import keygen as ref_kg
from tfhe_tpu.core.entities import LweSecretKey as RefLweSecretKey
from tfhe_tpu.core.params import DecompParams as RefDecomp
from tfhe_tpu.ops import mxu as ref_mxu
from tfhe_tpu.ops import ntt as ref_ntt
from tfhe_tpu.ops import server as ref_srv
from tfhe_tpu.shortint import compression as ref_comp
from tfhe_tpu.utils.csprng import (DeterministicSeeder, EncryptionRandomGenerator,
                                   SecretRandomGenerator)
from tfhe_tpu.utils.csprng import TUniform as RefTUniform
from tfhe_tpu_torch import shortint
from tfhe_tpu_torch.core.entities import LweBootstrapKey
from tfhe_tpu_torch.core import keygen as kg
from tfhe_tpu_torch.ops import bsk_prep, kernels, ntt, server, torus
from tfhe_tpu_torch.shortint import compression as comp
from tfhe_tpu_torch.shortint import server_key as sk_mod
from tfhe_tpu_torch.utils.csprng import TUniform

torch.set_num_threads(1)  # the suite runs in parallel processes: one thread each

SEED = 0xC0FF
BASE_LOG, LEVELS = 4, 3           # TEST_COMP_PARAM's packing keyswitch
# two storage GLWEs, 256 + 4: tfhe_tpu packs the second at the shape of the
# 4-element list, so its packing keyswitch compiles once for both
LIST_LEN = 260
SUBSET = [0, 255, 256, 259]       # crosses the GLWE boundary
PKSK_INPUTS = 16                  # of the 512 inputs of the test packing key


def _words(cts) -> np.ndarray:
    return np.stack([np.asarray(c.data) for c in cts])


def _t(a) -> torch.Tensor:
    return torus.from_u64(np.asarray(a, dtype=np.uint64), "cpu")


def _ntt_mont(data: np.ndarray, plan) -> jnp.ndarray:
    """A standard-domain packing key in tfhe_tpu's NTT-domain Montgomery
    form, as its CompressionKey converts it (compression.py:195-197)."""
    return jnp.asarray(ref_ntt.to_mont_all(ref_ntt.forward_all(data, plan, np), plan,
                                           np).astype(np.uint32))


def _ref_key(rck, seed: int, inputs: int, comp_params=None):
    """tfhe_tpu's CompressionKey from the same seed, with its packing key
    built for the first ``inputs`` elements of the big LWE key only.
    tfhe_tpu draws the packing key row by row from one generator, so these
    rows are the full key's first rows; the decompression key is whole."""
    prefix = types.SimpleNamespace(
        params=rck.params, glwe_secret_key=rck.glwe_secret_key,
        big_lwe_secret_key=RefLweSecretKey(rck.big_lwe_secret_key.data[:inputs]))
    return ref_comp.CompressionKey(prefix, seed=seed, comp_params=comp_params)


@pytest.fixture(scope="module")
def keys():
    """(reference client key, compression key; port client key, compression
    key) from the same seeds at TEST_PARAM_MESSAGE_2_CARRY_2.  The reference
    key's packing key is generated for the first PKSK_INPUTS inputs (kept
    as ``prefix_pksk_mont``, what test_compression_keys_match compares),
    then set to the port's full key in tfhe_tpu's form, so that both
    packages compress under one key."""
    rck = ref.ClientKey(ref.TEST_PARAM_MESSAGE_2_CARRY_2, seed=SEED)
    pck = shortint.ClientKey(shortint.TEST_PARAM_MESSAGE_2_CARRY_2, seed=SEED)
    pkey = shortint.CompressionKey(pck, seed=SEED + 1, device="cpu")
    rkey = _ref_key(rck, SEED + 1, PKSK_INPUTS)
    rkey.prefix_pksk_mont = rkey.pksk_mont
    rkey.pksk_mont = _ntt_mont(torus.to_u64(pkey.pksk), rkey.plan)
    return rck, rkey, pck, pkey


@pytest.fixture(scope="module")
def packed(keys):
    """A list of LIST_LEN and one of 4 ciphertexts, compressed by both
    packages: {length: (messages, reference list, port list, port
    ciphertexts)}."""
    rck, rkey, pck, pkey = keys
    out = {}
    for n in (LIST_LEN, 4):
        msgs = [(7 * i + n) % 4 for i in range(n)]
        rc, pc = [rck.encrypt(m) for m in msgs], [pck.encrypt(m) for m in msgs]
        assert (_words(rc) == _words(pc)).all()
        out[n] = (msgs, rkey.compress(rc), pkey.compress(pc), pc)
    return out


# ---------------------------------------------------------------------------
# Parameters and keys
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["TEST_COMP_PARAM",
                                  "V1_4_COMP_PARAM_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128"])
def test_compression_params_match(name):
    mine, theirs = getattr(comp, name), getattr(ref_comp, name)
    assert getattr(shortint, name) is mine
    for f in dataclasses.fields(theirs):
        a, b = getattr(mine, f.name), getattr(theirs, f.name)
        if dataclasses.is_dataclass(b):
            a, b = dataclasses.asdict(a), dataclasses.asdict(b)
        assert a == b, f.name
    for p, rp in ((shortint.TEST_PARAM_MESSAGE_2_CARRY_2, ref.TEST_PARAM_MESSAGE_2_CARRY_2),
                  (shortint.V1_4_PARAM_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128,
                   ref.V1_4_PARAM_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128)):
        assert (comp.default_compression_parameters(p).storage_log_modulus
                == ref_comp.default_compression_parameters(rp).storage_log_modulus)


def test_compression_keys_match(keys):
    """The storage key, the packing key's rows (the first PKSK_INPUTS
    inputs, in tfhe_tpu's NTT form) and the decompression BSK (not floored
    at N = 512) are the same bytes."""
    _, rkey, _, pkey = keys
    assert (pkey.private_keys.post_packing_ks_key.data
            == rkey.private_keys.post_packing_ks_key.data).all()
    pksk = torus.to_u64(pkey.pksk)
    assert pksk.shape == (512, 3, 2, 256)
    assert rkey.prefix_pksk_mont.shape[0] == PKSK_INPUTS
    assert (np.asarray(rkey.pksk_mont[:PKSK_INPUTS])
            == np.asarray(rkey.prefix_pksk_mont)).all()
    pd, rd = pkey.decompression, rkey.decompression
    assert pd._bsk_floored == rd._bsk_floored == 0 and not pd.trunc_acc
    assert (pd._bsk_coeff.data == rd._bsk_coeff.data).all()
    assert (pd.bsk_ntt.numpy().view(np.uint32) == np.asarray(rd.bsk_mont)).all()


def test_floored_decompression_key_matches(monkeypatch):
    """At N = 2048, k = 1 (the compute side of the production 2_2 set) the
    decompression BSK is mask-floored at rb = 15, as tfhe_tpu floors it; the
    storage side is cut to N_c = 16, one packing level, and tfhe_tpu's
    packing key to its first 8 inputs, so that its keygen takes a few
    seconds.  v7 mode is chosen on CUDA for this key."""
    for var in ("TFHE_TPU_MXU_PRIMES", "TFHE_TPU_MXU_ROUND_BITS"):
        monkeypatch.delenv(var, raising=False)
    kw = dict(br_level=1, br_base_log=23, packing_ks_level=1, packing_ks_base_log=4,
              packing_ks_polynomial_size=16, packing_ks_glwe_dimension=1,
              lwe_per_glwe=16, storage_log_modulus=12)
    rcp = ref_comp.CompressionParameters(packing_ks_key_noise=RefTUniform(43), **kw)
    pcp = comp.CompressionParameters(packing_ks_key_noise=TUniform(43), **kw)
    name = "V1_4_PARAM_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128"
    rkey = _ref_key(ref.ClientKey(getattr(ref, name), seed=SEED), SEED + 2, 8, rcp)
    p = getattr(shortint, name)
    pkey = shortint.CompressionKey(shortint.ClientKey(p, seed=SEED), seed=SEED + 2,
                                   comp_params=pcp, device="cpu")
    assert pkey.decompression._bsk_floored == rkey.decompression._bsk_floored == 15
    assert (pkey.decompression._bsk_coeff.data == rkey.decompression._bsk_coeff.data).all()
    assert (np.asarray(_ntt_mont(torus.to_u64(pkey.pksk[:8]), rkey.plan))
            == np.asarray(rkey.pksk_mont)).all()
    assert comp.decompression_uses_v7(torch.device("cuda"), p, pcp, 15)
    assert not pkey.decompression.trunc_acc                     # the CPU runs exact
    assert not comp.decompression_uses_v7(torch.device("cuda"), p, pcp, 0)
    assert not comp.decompression_uses_v7(torch.device("cuda"),
                                          shortint.TEST_PARAM_MESSAGE_2_CARRY_2, pcp, 15)


def test_keys_carried_in_through_from_raw_keys(keys, packed):
    """A CompressionKey built from the standard-domain packing key and
    tfhe_tpu's decompression BSK holds the same device keys and compresses
    to the same storage words."""
    _, rkey, _, pkey = keys
    raw = shortint.CompressionKey.from_raw_keys(
        shortint.TEST_PARAM_MESSAGE_2_CARRY_2, comp.TEST_COMP_PARAM,
        torus.to_u64(pkey.pksk), rkey.decompression._bsk_coeff.data,
        rkey.decompression._bsk_floored, device="cpu")
    assert torch.equal(raw.pksk, pkey.pksk)
    assert torch.equal(raw.decompression.bsk_ntt, pkey.decompression.bsk_ntt)
    _, want, _, cts = packed[4]
    assert (raw.compress(cts).glwes == want.glwes).all()


# ---------------------------------------------------------------------------
# The packing keyswitch, compress and decompress
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b", [1, 37, 256])
def test_plain_packing_keyswitch_matches(keys, b):
    _, rkey, _, pkey = keys
    lwes = np.random.default_rng(b).integers(0, 1 << 64, (b, 513), dtype=np.uint64)
    want = np.asarray(ref_srv.packing_keyswitch(jnp.asarray(lwes), rkey.pksk_mont,
                                                rkey.plan, BASE_LOG, LEVELS))
    got = server.packing_keyswitch(_t(lwes), pkey.pksk, BASE_LOG, LEVELS, 256)
    assert got.shape == (1, 2, 256) and (torus.to_u64(got[0]) == want).all()


@pytest.mark.parametrize("n", [LIST_LEN, 4])
def test_compress_matches(packed, n):
    _, want, got, _ = packed[n]
    assert got.glwes.dtype == np.uint16 and got.glwes.shape == want.glwes.shape
    assert (got.glwes == want.glwes).all()
    assert (got.count, got.degrees, got.storage_log_modulus) == \
        (want.count, want.degrees, want.storage_log_modulus)


@pytest.mark.parametrize("which", ["all_slots", "subset"])
def test_decompress_matches(keys, packed, which):
    """Every slot of a one-GLWE list, and slots on both sides of the GLWE
    boundary of a two-GLWE list: same words, and they decrypt."""
    _, rkey, pck, pkey = keys
    n, indices = (4, None) if which == "all_slots" else (LIST_LEN, SUBSET)
    msgs, rp, pp, _ = packed[n]
    want = rkey.decompress(rp, indices=indices)
    got = pkey.decompress(pp, indices=indices)
    assert (_words(got) == _words(want)).all()
    assert [c.degree for c in got] == [c.degree for c in want]
    picks = range(n) if indices is None else indices
    assert [pck.decrypt(c) for c in got] == [msgs[i] for i in picks]


# ---------------------------------------------------------------------------
# The decompression rotation against the TPU kernels' XLA twins
# ---------------------------------------------------------------------------


def test_v7_decompression_matches_the_v8_kernel_twin(keys, packed):
    """Row 3 (v8 = the v7 function): at the decompression shape (n = k_c N_c
    = 256 steps, N = 512), the port's plain v7 rotation (round_bsk key,
    2^32-grid accumulator) and sample extract == tfhe_tpu's
    mxu.blind_rotate_mxu_trunc on the 3-prime rb-15 plan and sample_extract,
    on two slots of a real list across the GLWE boundary."""
    _, rkey, _, pkey = keys
    rp = packed[LIST_LEN][1]
    msed = comp.extract_switched(torch.from_numpy(rp.glwes.astype(np.int64)),
                                 [255, 256], rp.storage_log_modulus)
    lut = server.generate_lut(512, 2, 16, 1 << 59, lambda x: x)
    lut_b = np.broadcast_to(lut, (2,) + lut.shape)
    bsk = rkey.decompression._bsk_coeff
    plan3 = ref_mxu.make_mxu_plan(512, num_primes=3, round_bits=15)
    m3, _ = ref_mxu.bsk_to_mxu(bsk, plan3)
    m = jnp.asarray(torus.to_u64(msed))
    want = np.asarray(ref_srv.sample_extract(ref_mxu.blind_rotate_mxu_trunc(
        m[:, :-1], m[:, -1], jnp.asarray(lut_b), jnp.asarray(m3), plan3, 23, 1)))
    key, plan = kg.bootstrap_key_to_ntt(bsk_prep.round_bsk(pkey.decompression._bsk_coeff, 15))
    got = server.pbs_from_switched_batch(
        msed, _t(lut_b), torch.from_numpy(key.view(np.int32)),
        ntt.device_plan(plan, "cpu"), 23, 1, trunc_acc=True)
    assert (torus.to_u64(got) == want).all()


def test_rounded_key_exact_rotation_matches_the_v3_v4_twin():
    """Rows 4, 5 (and 7, the exact rotation): the port's exact rotation on
    round_bsk(bsk, 15) == tfhe_tpu's mxu.blind_rotate_mxu on the 3-prime
    rb-15 plan, the XLA twin of the v3/v4 kernels (tests/test_mxu.py:174-198),
    at its toy shape."""
    n_in, n_poly = 4, 512
    gen_s = SecretRandomGenerator(123)
    lwe_sk = ref_kg.generate_binary_lwe_secret_key(n_in, gen_s)
    glwe_sk = ref_kg.generate_binary_glwe_secret_key(1, n_poly, gen_s)
    bsk = ref_kg.generate_lwe_bootstrap_key(
        lwe_sk, glwe_sk, RefDecomp(23, 1), RefTUniform(3),
        EncryptionRandomGenerator(7, DeterministicSeeder(99)))
    plan3 = ref_mxu.make_mxu_plan(n_poly, num_primes=3, round_bits=15)
    m3, _ = ref_mxu.bsk_to_mxu(bsk, plan3)
    rng = np.random.default_rng(9)
    mask = rng.integers(0, 2 * n_poly, (4, n_in), dtype=np.uint64)
    body = rng.integers(0, 2 * n_poly, (4,), dtype=np.uint64)
    lut = rng.integers(0, 1 << 64, (4, 2, n_poly), dtype=np.uint64)
    want = np.asarray(ref_mxu.blind_rotate_mxu(
        jnp.asarray(mask), jnp.asarray(body), jnp.asarray(lut), jnp.asarray(m3),
        plan3, 23, 1))
    rounded = bsk_prep.round_bsk(LweBootstrapKey(np.asarray(bsk.data), None), 15)
    key, plan = kg.bootstrap_key_to_ntt(rounded)
    got = server.blind_rotate(
        torch.from_numpy(mask.astype(np.int64)), torch.from_numpy(body.astype(np.int64)),
        _t(lut), torch.from_numpy(key.view(np.int32)), ntt.device_plan(plan, "cpu"),
        23, 1, trunc_acc=False)
    assert (torus.to_u64(got) == want).all()


# ---------------------------------------------------------------------------
# Modulus-switched compression on a classic and a multi-bit key
# ---------------------------------------------------------------------------


SERVER_SETS = {"classic": "TEST_PARAM_MESSAGE_2_CARRY_2",
               "multibit": "TEST_PARAM_MULTI_BIT_GROUP_2_MESSAGE_2_CARRY_2"}


@pytest.fixture(scope="module", params=sorted(SERVER_SETS))
def server_keys(request):
    name = SERVER_SETS[request.param]
    rck = ref.ClientKey(getattr(ref, name), seed=SEED + 3)
    pck = shortint.ClientKey(getattr(shortint, name), seed=SEED + 3)
    return (rck, ref.ServerKey(rck, seed=SEED + 4), pck,
            shortint.ServerKey(pck, seed=SEED + 4, device="cpu"))


def test_modulus_switched_compression_matches(server_keys):
    """switch_modulus_and_compress gives the same bytes; then
    decompress_and_apply_lookup_table_batch (three ciphertexts, padded to
    four; per-element LUTs) gives the same words, decrypts, and counts three
    PBS."""
    rck, rsk, pck, psk = server_keys
    vals = [3, 0, 2]
    rc = [rsk.switch_modulus_and_compress(rck.encrypt(v)) for v in vals]
    pc = [psk.switch_modulus_and_compress(pck.encrypt(v)) for v in vals]
    for r, p in zip(rc, pc):
        assert p.packed.dtype == np.uint8 and (p.packed == r.packed).all()
        assert (p.count, p.log_modulus, p.degree, p.message_modulus, p.carry_modulus) \
            == (r.count, r.log_modulus, r.degree, r.message_modulus, r.carry_modulus)
    fs = [lambda x: (3 * x + 1) % 16, lambda x: x % 4, lambda x: (3 * x + 1) % 16]
    want = rsk.decompress_and_apply_lookup_table_batch(
        rc, [rsk.generate_lookup_table(f) for f in fs])
    got = psk.decompress_and_apply_lookup_table_batch(
        pc, [psk.generate_lookup_table(f) for f in fs])
    assert (_words(got) == _words(want)).all()
    assert [c.degree for c in got] == [c.degree for c in want]
    assert [pck.decrypt_raw(c) for c in got] == [f(v) for f, v in zip(fs, vals)]
    assert psk.pbs_count == rsk.pbs_count == 3
    one = psk.decompress_and_apply_lookup_table(pc[0], psk.generate_lookup_table(fs[0]))
    assert (np.asarray(one.data) == np.asarray(got[0].data)).all()


def test_exact_key_in_v7_and_v9_mode_is_the_unrounded_key(server_keys, monkeypatch):
    """A server key in v7 or v9 mode holds the rounded key for its rounds;
    modulus-switched decompression rotates with ``exact_bsk_ntt``, which
    must be tfhe_tpu's unrounded NTT key, word for word, and not the
    rounded one.  The CPU never chooses those modes, so the test forces
    them on a key carried in through from_raw_keys."""
    _, rsk, _, psk = server_keys
    monkeypatch.setattr(sk_mod, "uses_v7", lambda *a: True)
    monkeypatch.setattr(sk_mod, "uses_v9", lambda *a: True)
    monkeypatch.setattr(sk_mod, "mb_round_bits", lambda p: 18)
    coeff = psk._bsk_coeff if psk.grouping is not None else psk._bsk_coeff.data
    forced = shortint.ServerKey.from_raw_keys(psk.params, torus.to_u64(psk.ksk), coeff,
                                              18, device="cpu")
    assert forced.trunc_acc and not psk.trunc_acc
    exact = forced.exact_bsk_ntt()
    want = rsk.mb_bsk_mont if psk.grouping is not None else rsk.bsk_mont
    assert (exact.numpy().view(np.uint32) == np.asarray(want)).all()
    assert torch.equal(exact, psk.bsk_ntt)
    # the rounds' key is the rounded kernel-layout key, not the exact one
    assert isinstance(forced.bsk_ntt, bsk_prep.RoundedKeyNtt)
    assert forced.bsk_ntt.round_bits == (18 if psk.grouping is not None else 15)
    assert forced.exact_bsk_ntt() is exact                      # built once, kept


# ---------------------------------------------------------------------------
# The K4 wrapper and the device rule
# ---------------------------------------------------------------------------


def test_k4_wrapper_takes_the_plain_version_on_cpu_only(keys):
    _, _, _, pkey = keys
    lwes = _t(np.random.default_rng(4).integers(0, 1 << 64, (40, 513), dtype=np.uint64))
    got = kernels.packing_keyswitch(lwes, pkey.pksk, BASE_LOG, LEVELS, 32)
    assert got.shape == (2, 2, 256)
    assert torch.equal(got, server.packing_keyswitch(lwes, pkey.pksk, BASE_LOG, LEVELS, 32))
    assert kernels.packing_keyswitch.launches == 0
    with pytest.raises(ValueError, match="no packing-keyswitch kernel"):
        kernels.packing_keyswitch(lwes.to("meta"), pkey.pksk.to("meta"), BASE_LOG, LEVELS, 32)


def test_compression_key_on_cpu_keeps_the_words(keys, packed):
    """On the CPU the CompressionKey's pks_key is its int64 packing key
    itself (the byte layout of K4's tensor-core kernel is built only on the
    card, where TEST_COMP_PARAM's shape takes that kernel), and compress,
    which passes it to K4's wrapper, gave tfhe_tpu's list."""
    _, _, _, pkey = keys
    assert pkey.pks_key is pkey.pksk
    assert pkey.pksk.dtype == torch.int64 and pkey.pksk.device.type == "cpu"
    assert pkey.pksk.shape == (512, LEVELS, 2, 256)
    _, want, got, _ = packed[LIST_LEN]
    assert (got.glwes == want.glwes).all()


def test_compression_key_defaults_to_the_card(monkeypatch, keys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, rkey, pck, pkey = keys
    with pytest.raises(RuntimeError, match="cuda"):
        shortint.CompressionKey(pck, seed=1)
    with pytest.raises(RuntimeError, match="cuda"):
        shortint.CompressionKey.from_raw_keys(
            shortint.TEST_PARAM_MESSAGE_2_CARRY_2, comp.TEST_COMP_PARAM,
            torus.to_u64(pkey.pksk), rkey.decompression._bsk_coeff.data)
    with pytest.raises(ValueError, match="storage modulus"):
        shortint.CompressionKey(pck, seed=1, device="cpu",
                                comp_params=comp.V1_4_COMP_PARAM_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128)
