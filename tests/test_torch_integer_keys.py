"""The integer layer of the port on its other keys, against tfhe_tpu on the
CPU, word for word (tolerance 0): add and mul on a multi-bit key
(TEST_PARAM_MULTI_BIT_GROUP_2_MESSAGE_2_CARRY_2, K3's function), and a
radix squash onto the u128 torus (TEST_NOISE_SQUASHING_PARAM over the
classic TEST set, K5's function) of a radix op's lazy outputs."""

import numpy as np
import pytest
import torch

from tfhe_tpu import integer as ref_integer
from tfhe_tpu import shortint as ref_shortint
from tfhe_tpu.integer import noise_squashing as ref_ins
from tfhe_tpu.shortint import noise_squashing as ref_ns
from tfhe_tpu_torch import integer, shortint
from tfhe_tpu_torch.integer import noise_squashing as ins
from tfhe_tpu_torch.ops import torus
from tfhe_tpu_torch.shortint import noise_squashing as ns

torch.set_num_threads(1)  # the suite runs in parallel processes: one thread each

NB = 4
MOD = 4 ** NB
A, B = 201, 183


def _words(ct) -> np.ndarray:
    return np.stack([np.asarray(b.data) for b in ct.blocks])


def _same(r, p) -> None:
    assert (_words(p) == _words(r)).all()
    assert [b.degree for b in p.blocks] == [b.degree for b in r.blocks]
    assert [b.noise_level for b in p.blocks] == [b.noise_level for b in r.blocks]


@pytest.fixture(scope="module")
def multibit_keys():
    rp = ref_shortint.TEST_PARAM_MULTI_BIT_GROUP_2_MESSAGE_2_CARRY_2
    pp = shortint.TEST_PARAM_MULTI_BIT_GROUP_2_MESSAGE_2_CARRY_2
    return (*ref_integer.gen_keys(rp, seed=0x3B17),
            *integer.gen_keys(pp, seed=0x3B17, device="cpu"))


@pytest.mark.parametrize("op,f", [("add_parallelized", lambda x, y: (x + y) % MOD),
                                  ("mul_parallelized", lambda x, y: (x * y) % MOD)])
def test_multibit_op_matches(multibit_keys, op, f):
    rck, rsk, pck, psk = multibit_keys
    r = getattr(rsk, op)(rck.encrypt_radix(A, NB), rck.encrypt_radix(B, NB))
    p = getattr(psk, op)(pck.encrypt_radix(A, NB), pck.encrypt_radix(B, NB))
    assert psk.key.grouping == 2
    _same(r, p)
    assert pck.decrypt_radix(p) == rck.decrypt_radix(r) == f(A, B)


def test_radix_squash_matches():
    """A radix add's lazy outputs squashed in one batch: lo and hi words,
    degrees, and the value under the squashing private key."""
    rck, rsk = ref_integer.gen_keys(ref_shortint.TEST_PARAM_MESSAGE_2_CARRY_2, seed=0x5C)
    pck, psk = integer.gen_keys(shortint.TEST_PARAM_MESSAGE_2_CARRY_2, seed=0x5C,
                                device="cpu")
    rpriv = ref_ins.NoiseSquashingPrivateKey(ref_ns.TEST_NOISE_SQUASHING_PARAM, seed=0x5D)
    ppriv = ins.NoiseSquashingPrivateKey(ns.TEST_NOISE_SQUASHING_PARAM, seed=0x5D)
    rnsk = ref_ins.NoiseSquashingKey(rck, rpriv, seed=0x5E)
    pnsk = ins.NoiseSquashingKey(pck, ppriv, seed=0x5E, device="cpu")
    r = rsk.add_parallelized(rck.encrypt_radix(A, NB), rck.encrypt_radix(B, NB))
    p = psk.add_parallelized(pck.encrypt_radix(A, NB), pck.encrypt_radix(B, NB))
    rs = rnsk.squash_radix_ciphertext_noise(rsk, r)
    ps = pnsk.squash_radix_ciphertext_noise(psk, p)
    for half in ("lo", "hi"):
        got = np.stack([torus.to_u64(getattr(b, half)) for b in ps.blocks])
        want = np.stack([np.asarray(getattr(b, half)) for b in rs.blocks])
        assert (got == want).all()
    assert [b.degree for b in ps.blocks] == [b.degree for b in rs.blocks]
    assert ppriv.decrypt_radix(ps) == rpriv.decrypt_radix(rs) == (A + B) % MOD
