"""Host substrate of the port against tfhe_tpu: the same seeds give the same
bytes (AES-CTR keystream, secret keys, ciphertexts, KSK, BSK floored and
unfloored, NTT-domain BSK), and the NTT plans and transforms agree word for
word."""

import dataclasses

import numpy as np
import pytest
import torch

from tfhe_tpu import shortint as ref_shortint
from tfhe_tpu.core import keygen as ref_kg
from tfhe_tpu.core.entities import LweBootstrapKey as RefBsk
from tfhe_tpu.core.params import DecompParams as RefDecomp
from tfhe_tpu.ops import mxu as ref_mxu
from tfhe_tpu.ops import ntt as ref_ntt
from tfhe_tpu.utils import csprng as ref_csprng
from tfhe_tpu_torch import shortint
from tfhe_tpu_torch.core.entities import LweBootstrapKey
from tfhe_tpu_torch.core.params import DecompParams
from tfhe_tpu_torch.ops import bsk_prep, ntt, torus
from tfhe_tpu_torch.utils import csprng

torch.set_num_threads(1)  # the suite runs in parallel processes: one thread each

SEED_CK, SEED_SK = 0x5EED, 0xB00


def _u64(t: torch.Tensor) -> np.ndarray:
    return torus.to_u64(t)


# ---------------------------------------------------------------------------
# CSPRNG
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,pos,count", [(0, 0, 64), (0xDEADBEEF, 13, 300),
                                            ((1 << 128) - 1, 1 << 20, 33)])
def test_keystream_matches(seed, pos, count):
    mine, ref = csprng.ByteStream(seed), ref_csprng.ByteStream(seed)
    mine.skip(pos)
    ref.skip(pos)
    assert (mine.take(count) == ref.take(count)).all()


def test_native_aes_matches_cryptography():
    """The port's own AES-CTR core (csrc/aes_ctr.cpp) against the
    `cryptography` fallback, across the 64-bit carry of the counter."""
    from cryptography.hazmat.primitives.ciphers import Cipher, algorithms, modes

    key = bytes(range(16))
    start = (1 << 64) - 3
    got = csprng._aes_ctr_blocks(key, start, 7)
    enc = Cipher(algorithms.AES(key), modes.ECB()).encryptor()
    raw = enc.update(csprng._counter_blocks(start, 7).tobytes()) + enc.finalize()
    assert (got == np.frombuffer(raw, dtype=np.uint8).reshape(7, 16)).all()


# ---------------------------------------------------------------------------
# NTT plans and transforms
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,primes", [(256, 3), (512, 4), (2048, 4)])
def test_plan_tables_match(n, primes):
    mine, ref = ntt.make_plan(n, primes), ref_ntt.make_plan(n, primes)
    assert mine.primes == ref.primes
    for name in ("ps", "pinvs", "r2s", "n_invs", "psi_br_stack",
                 "psi_inv_br_stack"):
        assert (np.asarray(getattr(mine, name), dtype=np.uint64)
                == np.asarray(getattr(ref, name), dtype=np.uint64)).all(), name


@pytest.fixture(scope="module")
def plan512():
    return ntt.make_plan(512, 4), ref_ntt.make_plan(512, 4)


def test_ntt_forward_inverse_garner_match(plan512):
    plan, ref_plan = plan512
    dp = ntt.device_plan(plan, "cpu")
    rng = np.random.default_rng(1)
    res = rng.integers(0, 1 << 29, (3, 4, 512), dtype=np.uint64) % plan.ps
    fwd_ref = ref_ntt.ntt_forward_stacked(res, ref_plan, np)
    fwd = ntt.ntt_forward(torch.from_numpy(res.astype(np.int64)), dp)
    assert (fwd.numpy().astype(np.uint64) == fwd_ref).all()
    inv_ref = ref_ntt.ntt_inverse_stacked(fwd_ref, ref_plan, np)
    inv = ntt.ntt_inverse(fwd, dp)
    assert (inv.numpy().astype(np.uint64) == inv_ref).all()
    assert (inv.numpy().astype(np.uint64) == res).all()
    with np.errstate(over="ignore"):
        g_ref = ref_ntt.garner_to_u64(res, ref_plan, np)
    g = ntt.garner_to_u64(torch.from_numpy(res.astype(np.int64)), dp)
    assert (_u64(g) == g_ref).all()


def test_host_negacyclic_polymul_matches(plan512):
    plan, ref_plan = plan512
    rng = np.random.default_rng(2)
    a = rng.integers(0, 1 << 64, (2, 512), dtype=np.uint64)
    s = rng.integers(0, 2, (2, 512), dtype=np.uint64)
    with np.errstate(over="ignore"):
        want = ref_ntt.negacyclic_polymul_u64(a, s, ref_plan, np)
    assert (ntt.negacyclic_polymul_u64(a, s, plan) == want).all()


# ---------------------------------------------------------------------------
# BSK preparation for the v7 rotation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("round_bits", [11, 15])
def test_round_bsk_matches(round_bits):
    rng = np.random.default_rng(round_bits)
    data = rng.integers(0, 1 << 64, (2, 1, 2, 2, 64), dtype=np.uint64)
    want = ref_mxu.round_bsk(RefBsk(data, RefDecomp(23, 1), 64), round_bits)
    got = bsk_prep.round_bsk(LweBootstrapKey(data, DecompParams(23, 1)),
                             round_bits)
    assert (got.data == want.data).all()


def test_mask_floor_bsk_matches():
    rng = np.random.default_rng(4)
    data = rng.integers(0, 1 << 64, (3, 1, 2, 2, 256), dtype=np.uint64)
    sk = np.random.default_rng(5).integers(0, 2, (1, 256), dtype=np.uint64)

    class _Glwe:     # the secret-key attribute both functions read
        pass

    glwe = _Glwe()
    glwe.data = sk
    want = ref_mxu.mask_floor_bsk(RefBsk(data, RefDecomp(23, 1), 64), glwe, 15)
    got = bsk_prep.mask_floor_bsk(
        LweBootstrapKey(data, DecompParams(23, 1)), glwe, 15, device="cpu")
    assert (got.data == want.data).all()
    assert (got.data[..., 0, :] & np.uint64((1 << 15) - 1) == 0).all()


# ---------------------------------------------------------------------------
# Keys and ciphertexts from the same seeds
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def test_param_keys():
    rp, pp = (ref_shortint.TEST_PARAM_MESSAGE_2_CARRY_2,
              shortint.TEST_PARAM_MESSAGE_2_CARRY_2)
    rck = ref_shortint.ClientKey(rp, seed=SEED_CK)
    pck = shortint.ClientKey(pp, seed=SEED_CK)
    rsk = ref_shortint.ServerKey(rck, seed=SEED_SK)
    psk = shortint.ServerKey(pck, seed=SEED_SK, device="cpu")
    return rck, pck, rsk, psk


def test_client_secrets_match(test_param_keys):
    rck, pck, _, _ = test_param_keys
    assert (pck.lwe_secret_key.data == rck.lwe_secret_key.data).all()
    assert (pck.glwe_secret_key.data == rck.glwe_secret_key.data).all()
    assert (pck.big_lwe_secret_key.data == rck.big_lwe_secret_key.data).all()


def test_ciphertexts_match():
    p = shortint.TEST_PARAM_MESSAGE_2_CARRY_2
    rck = ref_shortint.ClientKey(ref_shortint.TEST_PARAM_MESSAGE_2_CARRY_2, seed=9)
    pck = shortint.ClientKey(p, seed=9)
    for m in [0, 1, 2, 3, 7, 15]:
        a, b = rck.encrypt(m), pck.encrypt(m)
        assert (np.asarray(a.data) == np.asarray(b.data)).all()
        assert (a.degree, a.noise_level) == (b.degree, b.noise_level)
        assert pck.decrypt_raw(b) == rck.decrypt_raw(a) == m % 16
    a = rck.encrypt_without_padding_value(20)
    b = pck.encrypt_without_padding_value(20)
    assert (np.asarray(a.data) == np.asarray(b.data)).all()


def test_client_key_from_raw_keys_encrypts_the_same():
    p = shortint.TEST_PARAM_MESSAGE_2_CARRY_2
    rck = ref_shortint.ClientKey(ref_shortint.TEST_PARAM_MESSAGE_2_CARRY_2, seed=21)
    pck = shortint.ClientKey.from_raw_keys(
        p, rck.lwe_secret_key.data, rck.glwe_secret_key.data, seed=21)
    for m in [3, 11]:
        assert (np.asarray(pck.encrypt(m).data)
                == np.asarray(rck.encrypt(m).data)).all()


def test_unfloored_server_keys_match(test_param_keys):
    _, _, rsk, psk = test_param_keys
    assert rsk._bsk_floored == psk._bsk_floored == 0
    assert (_u64(psk.ksk) == np.asarray(rsk.ksk)).all()
    assert (psk._bsk_coeff.data == rsk._bsk_coeff.data).all()
    assert (psk.bsk_ntt.numpy().view(np.uint32) == np.asarray(rsk.bsk_mont)).all()


# a 2_2-shaped toy set: N = 2048, k = 1, l_pbs = 1, base_log 23 (the v7
# family, so both packages floor the BSK masks), with a tiny n
FLOOR_PARAMS = dict(lwe_dimension=3, ks_level=2, ks_base_log=8)


def test_floored_server_keys_match():
    rp = dataclasses.replace(ref_shortint.TEST_PARAM_MESSAGE_2_CARRY_2,
                             polynomial_size=2048, **FLOOR_PARAMS)
    pp = dataclasses.replace(shortint.TEST_PARAM_MESSAGE_2_CARRY_2,
                             polynomial_size=2048, **FLOOR_PARAMS)
    rsk = ref_shortint.ServerKey(ref_shortint.ClientKey(rp, seed=31), seed=32)
    psk = shortint.ServerKey(shortint.ClientKey(pp, seed=31), seed=32,
                             device="cpu")
    assert rsk._bsk_floored == psk._bsk_floored == 15
    assert (_u64(psk.ksk) == np.asarray(rsk.ksk)).all()
    assert (psk._bsk_coeff.data == rsk._bsk_coeff.data).all()
    # exact mode on the CPU: the NTT key of the floored (unrounded) BSK
    assert not psk.trunc_acc
    assert (psk.bsk_ntt.numpy().view(np.uint32) == np.asarray(rsk.bsk_mont)).all()


def test_bootstrap_key_to_ntt_matches(test_param_keys):
    _, _, rsk, _ = test_param_keys
    coeff = rsk._bsk_coeff
    want, _ = ref_kg.bootstrap_key_to_ntt(coeff)
    got, plan = shortint.server_key.kg.bootstrap_key_to_ntt(
        LweBootstrapKey(coeff.data, DecompParams(23, 1)))
    assert plan.num_primes == 4 and got.dtype == np.uint32
    assert (got == want).all()
