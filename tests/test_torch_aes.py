"""AES of the port on the CPU (the fast half of tests/test_aes.py): the
cleartext AES-128 and AES-256 against FIPS-197, against the port's native
AES-NI core (csrc/aes_ctr.cpp, the CSPRNG's) and against tfhe_tpu's
cleartext cipher; the S-box, the round constants and both key schedules
equal tfhe_tpu's; and one byte through the homomorphic S-box (the bits'
PBS, circuit bootstrapping, vertical packing and the refresh) equals
tfhe_tpu's words at the TEST set.  The FHE rounds run on the card
(chip_smoke.py phase aes), as tfhe_tpu marks them slow.  tfhe_tpu's
WoPBS _pfpks and _cmux run compiled by jax.jit (the same functions)."""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfhe_tpu import shortint as ref_shortint
from tfhe_tpu.apps import aes as ref_aes
from tfhe_tpu.integer.client_key import ClientKey as RefIntegerClientKey
from tfhe_tpu.integer.server_key import ServerKey as RefIntegerServerKey
from tfhe_tpu.ops import ntt as ref_ntt
from tfhe_tpu.shortint import wopbs as ref_wopbs
from tfhe_tpu_torch import integer, shortint
from tfhe_tpu_torch.apps import aes
from tfhe_tpu_torch.ops import ntt, torus
from tfhe_tpu_torch.shortint import wopbs
from tfhe_tpu_torch.utils import csprng

torch.set_num_threads(1)  # the suite runs in parallel processes: one thread each

SEED = 0xAE5


def test_cleartext_aes128_fips197():
    key = bytes(range(16))
    pt = bytes.fromhex("00112233445566778899aabbccddeeff")
    assert aes.aes128_encrypt_block(key, pt).hex() == "69c4e0d86a7b0430d8cdb78070b4c55a"


def test_cleartext_aes256_fips197():
    key = bytes(range(32))
    pt = bytes.fromhex("00112233445566778899aabbccddeeff")
    assert aes.aes256_encrypt_block(key, pt).hex() == "8ea2b7ca516745bfeafc49904b496089"


@pytest.mark.parametrize("counter", [0, 1, 0x0123456789ABCDEF, (1 << 128) - 1])
def test_cleartext_aes128_vs_the_native_core(counter):
    """The native AES-NI core's CTR block for a counter is AES-128 of the
    counter's 16 little-endian bytes."""
    assert csprng._backend().lib is not None, "the native AES core did not build"
    key = bytes(range(16, 32))
    native = csprng._aes_ctr_blocks(key, counter, 1).tobytes()
    assert aes.aes128_encrypt_block(key, counter.to_bytes(16, "little")) == native


def test_tables_and_key_schedules_equal_tfhe_tpu():
    assert aes.SBOX == ref_aes.SBOX and aes.RCON == ref_aes.RCON
    assert sorted(aes.SBOX) == list(range(256))
    rng = np.random.default_rng(SEED)
    for _ in range(4):
        k16, k32 = bytes(rng.integers(0, 256, 16).tolist()), bytes(rng.integers(0, 256, 32).tolist())
        assert aes.key_expansion(k16) == ref_aes.key_expansion(k16)
        assert aes.key_expansion_256(k32) == ref_aes.key_expansion_256(k32)
        block = bytes(rng.integers(0, 256, 16).tolist())
        assert aes.aes128_encrypt_block(k16, block) == ref_aes.aes128_encrypt_block(k16, block)
        assert aes.aes256_encrypt_block(k32, block) == ref_aes.aes256_encrypt_block(k32, block)


@pytest.fixture(scope="module")
def fhe():
    p = shortint.TEST_PARAM_MESSAGE_2_CARRY_2
    ck = integer.ClientKey(p, seed=SEED)
    sk = integer.ServerKey(ck, seed=SEED + 1, device="cpu")
    wk = wopbs.WopbsKey(ck.key, sk.key, wopbs.TEST_WOPBS_PARAM, seed=SEED + 2)
    ref_ck = RefIntegerClientKey(ref_shortint.TEST_PARAM_MESSAGE_2_CARRY_2, seed=SEED)
    ref_sk = RefIntegerServerKey(ref_ck, seed=SEED + 1)
    # tfhe_tpu's WoPBS key on the port key's words (tests/test_torch_wopbs.py
    # holds the keygen itself), its _pfpks and _cmux compiled
    ref_wk = ref_wopbs.WopbsKey.__new__(ref_wopbs.WopbsKey)
    ref_wk.params = ref_wopbs.TEST_WOPBS_PARAM
    ref_wk.shortint_params = ref_sk.key.params
    ref_wk.server_key = ref_sk.key
    ref_wk.k, ref_wk.n_poly = p.glwe_dimension, p.polynomial_size
    ref_wk.plan = ref_ntt.make_plan(p.polynomial_size, 4)
    words = torus.to_u64(wk.pfpksk).copy()
    with np.errstate(over="ignore"):
        words[-1] = np.uint64(0) - words[-1]
        rows = words.reshape(words.shape[:2] + (wk.k + 1, wk.k + 1, wk.n_poly))
        plan = ntt.make_plan(p.polynomial_size, 4)
        ref_wk.pfpksk = [jnp.asarray(ntt.to_mont_all(ntt.forward_all(rows[:, :, r], plan),
                                                     plan).astype(np.uint32))
                         for r in range(wk.k + 1)]

    def pfpks(keys_, lwe, r):
        obj = copy.copy(ref_wk)
        obj.pfpksk = list(keys_)
        return ref_wopbs.WopbsKey._pfpks(obj, lwe, r)

    compiled = jax.jit(pfpks, static_argnums=2)
    ref_wk._pfpks = lambda lwe, r: compiled(tuple(ref_wk.pfpksk), lwe, r)
    ref_wk._cmux = jax.jit(functools.partial(ref_wopbs.WopbsKey._cmux, ref_wk))
    return ck, sk, wk, ref_ck, ref_sk, ref_wk


def test_fhe_sbox_byte_matches_tfhe_tpu(fhe):
    ck, sk, wk, ref_ck, ref_sk, ref_wk = fhe
    value = 0x53
    ref_ct = ref_ck.encrypt_radix(value, 4)
    ct = integer.RadixCiphertext([
        shortint.Ciphertext(np.asarray(b.data).copy(), b.degree, b.noise_level,
                            b.message_modulus, b.carry_modulus) for b in ref_ct.blocks])
    ref_box = ref_aes.FheAes128.__new__(ref_aes.FheAes128)
    ref_box.sk, ref_box.wk = ref_sk, ref_wk
    box = aes.FheAes128.__new__(aes.FheAes128)
    box.sk, box.wk = sk, wk
    want = ref_box._sbox(ref_ct)
    got = box._sbox(ct)
    for a, b in zip(want.blocks, got.blocks):
        np.testing.assert_array_equal(np.asarray(b.data), np.asarray(a.data))
        assert (b.degree, b.noise_level) == (a.degree, a.noise_level)
    assert ck.decrypt_radix(got) == aes.SBOX[value] == 0xED
