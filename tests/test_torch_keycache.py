"""Device-memory admission and the key cache of the port on the CPU:
admit_chunk's arithmetic against tfhe_tpu's under the same free bytes,
device_free_bytes' override and default, a squash and a decompression
chunked under a forced small budget equal to the unchunked calls (more
launches, the same words), and the key cache: tfhe_tpu's tags, a round
trip of the shortint, squashing and squash-compression keys to the same
words, and a corrupt or stale file regenerated."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from tfhe_tpu import shortint as ref_shortint
from tfhe_tpu.utils import hbm as ref_hbm
from tfhe_tpu.utils import keycache as ref_keycache
from tfhe_tpu_torch import shortint
from tfhe_tpu_torch.ops import kernels
from tfhe_tpu_torch.shortint import compression
from tfhe_tpu_torch.shortint import noise_squashing as ns
from tfhe_tpu_torch.utils import hbm, keycache

torch.set_num_threads(1)  # the suite runs in parallel processes: one thread each

P = shortint.TEST_PARAM_MESSAGE_2_CARRY_2
SEED = 0x4B43


@pytest.mark.parametrize("free", [0, 1 << 20, 12 << 30, 80 << 30])
@pytest.mark.parametrize("items,per_item,fixed,min_items", [
    (512, 512 << 10, 0, 8), (512, 147456, 1 << 30, 1), (3, 1 << 30, 0, 8), (100, 0, 0, 8),
    (4096, 7 << 20, 50 << 20, 1)])
def test_admit_chunk_arithmetic_equals_tfhe_tpu(monkeypatch, free, items, per_item, fixed,
                                                min_items):
    monkeypatch.setenv("TFHE_TPU_HBM_BYTES", str(free))
    assert hbm.device_free_bytes("cpu") == ref_hbm.device_free_bytes() == free
    assert (hbm.admit_chunk(items, per_item, fixed, min_items=min_items)
            == ref_hbm.admit_chunk(items, per_item, fixed, min_items=min_items))


def test_device_free_bytes_default_without_stats(monkeypatch):
    monkeypatch.delenv("TFHE_TPU_HBM_BYTES", raising=False)
    assert hbm.device_free_bytes("cpu") == 12 << 30
    assert hbm.device_free_bytes("cpu", default=5) == 5


@pytest.fixture(scope="module")
def keys():
    ck = shortint.ClientKey(P, seed=SEED)
    sk = shortint.ServerKey(ck, seed=SEED + 1, device="cpu")
    return ck, sk


def _launch_sizes(monkeypatch, name: str) -> list:
    sizes = []
    real = getattr(kernels, name)

    def counting(*args, **kwargs):
        sizes.append(args[0].shape[0])
        return real(*args, **kwargs)

    monkeypatch.setattr(kernels, name, counting)
    return sizes


def test_chunked_squash_equals_unchunked(monkeypatch, keys):
    ck, sk = keys
    priv = ns.NoiseSquashingPrivateKey(ns.TEST_NOISE_SQUASHING_PARAM, seed=SEED + 2)
    nsk = ns.NoiseSquashingKey(ck, priv, seed=SEED + 3, device="cpu")
    cts = [ck.encrypt(m) for m in (0, 1, 2, 3, 1)]
    monkeypatch.delenv("TFHE_TPU_HBM_BYTES", raising=False)
    whole = nsk.squash_ciphertext_noise_batch(cts, sk)
    # a budget of two ciphertexts' working sets (after the 0.85 headroom)
    monkeypatch.setenv("TFHE_TPU_HBM_BYTES", str(-(-2 * nsk.bytes_per_ciphertext(sk) * 100 // 85)))
    sizes = _launch_sizes(monkeypatch, "blind_rotate128")
    chunked = nsk.squash_ciphertext_noise_batch(cts, sk)
    assert sizes == [2, 2, 1]
    for a, b in zip(whole, chunked):
        assert torch.equal(a.lo, b.lo) and torch.equal(a.hi, b.hi) and a.degree == b.degree
    assert [priv.decrypt_squashed_noise_ciphertext(c) for c in chunked] == [0, 1, 2, 3, 1]


def test_chunked_decompression_equals_unchunked(monkeypatch, keys):
    ck, sk = keys
    small = dataclasses.replace(compression.TEST_COMP_PARAM, packing_ks_polynomial_size=16,
                                lwe_per_glwe=16)
    ckey = shortint.CompressionKey(ck, seed=SEED + 4, comp_params=small, device="cpu")
    packed = ckey.compress([ck.encrypt(m) for m in (3, 0, 2, 1, 1, 2)])
    monkeypatch.delenv("TFHE_TPU_HBM_BYTES", raising=False)
    whole = ckey.decompress(packed)
    per_item = compression.decompression_bytes_per_item(P, small.packing_ks_glwe_dimension
                                                        * small.packing_ks_polynomial_size + 1)
    monkeypatch.setenv("TFHE_TPU_HBM_BYTES", str(-(-4 * per_item * 100 // 85)))
    sizes = _launch_sizes(monkeypatch, "blind_rotate")
    chunked = ckey.decompress(packed)
    assert sizes == [4, 2]
    for a, b in zip(whole, chunked):
        np.testing.assert_array_equal(np.asarray(a.data), np.asarray(b.data))
    assert [ck.decrypt(c) for c in chunked] == [3, 0, 2, 1, 1, 2]


def test_cache_tags_equal_tfhe_tpu():
    for params in (P, shortint.DEFAULT_PARAMS,
                   shortint.V1_4_PARAM_GPU_MULTI_BIT_GROUP_4_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128):
        ref_params = getattr(ref_shortint, next(
            name for name in dir(shortint) if getattr(shortint, name) is params))
        assert repr(params) == repr(ref_params)
        assert keycache._params_tag(params, 7) == ref_keycache._params_tag(ref_params, 7)


@pytest.fixture
def cache_dir(monkeypatch, tmp_path):
    monkeypatch.setattr(keycache, "CACHE_DIR", tmp_path)
    return tmp_path


def test_default_cache_dir_is_the_ports_own():
    assert (keycache.CACHE_DIR.name == ".keys_torch"
            or "TFHE_TPU_TORCH_KEY_CACHE" in os.environ)
    assert keycache.CACHE_DIR != ref_keycache.CACHE_DIR


def test_shortint_keys_round_trip_and_regenerate(cache_dir):
    ck, sk = keycache.get_shortint_keys(P, seed=SEED, device="cpu")
    (path,) = cache_dir.glob("shortint_*.npz")
    ck2, sk2 = keycache.get_shortint_keys(P, seed=SEED, device="cpu")
    fresh = shortint.ServerKey(shortint.ClientKey(P, seed=SEED), SEED, device="cpu")
    for key in (sk, sk2):
        assert torch.equal(key.ksk, fresh.ksk) and torch.equal(key.bsk_ntt, fresh.bsk_ntt)
    assert np.array_equal(ck2.lwe_secret_key.data, ck.lwe_secret_key.data)
    path.write_bytes(b"not an npz file")
    _, sk3 = keycache.get_shortint_keys(P, seed=SEED, device="cpu")
    assert torch.equal(sk3.bsk_ntt, fresh.bsk_ntt)
    assert path.stat().st_size > 1000
    with np.load(path) as data:
        stale = {k: data[k] for k in data.files}
    stale["format"] = np.asarray(keycache.FORMAT - 1)
    np.savez(path, **stale)
    _, sk4 = keycache.get_shortint_keys(P, seed=SEED, device="cpu")
    assert torch.equal(sk4.ksk, fresh.ksk)
    with np.load(path) as data:
        assert int(data["format"]) == keycache.FORMAT


def test_squashing_keys_round_trip(cache_dir):
    sq = ns.TEST_NOISE_SQUASHING_PARAM
    ck, sk, priv, nsk = keycache.get_squashing_keys(P, sq, seed=SEED, device="cpu")
    _, _, priv2, nsk2 = keycache.get_squashing_keys(P, sq, seed=SEED, device="cpu")
    fresh = ns.NoiseSquashingKey(ck, priv, seed=SEED ^ 0x5E2, device="cpu")
    assert torch.equal(nsk.bsk128_ntt, fresh.bsk128_ntt)
    assert torch.equal(nsk2.bsk128_ntt, fresh.bsk128_ntt)
    comp = ns.TEST_NOISE_SQUASHING_COMP_PARAM
    cpriv, ckey = keycache.get_squash_compression_keys(sq, comp, priv, seed=SEED, device="cpu")
    _, ckey2 = keycache.get_squash_compression_keys(sq, comp, priv2, seed=SEED, device="cpu")
    fresh_c = ns.NoiseSquashingCompressionKey(priv, cpriv, seed=SEED ^ 0x5E4, device="cpu")
    assert torch.equal(ckey.pksk, fresh_c.pksk) and torch.equal(ckey2.pksk, fresh_c.pksk)
    assert len(list(cache_dir.glob("*.npz"))) == 3
