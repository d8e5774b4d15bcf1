"""The core functions the port took last, against tfhe_tpu's on the CPU,
word for word (tolerance 0; all of it is integer arithmetic or the same
float formula): ``encode``/``decode`` over edge values, a bootstrap-key
chunk against the same GGSWs of tfhe_tpu's whole key and of its chunk at
the toy set, the noise variances and the keystream constant, the
test-vector parameter sets field by field, and ``pseudo_random_lwe`` at
16, 32 and 64 bits."""

import numpy as np
import pytest
import torch

from tfhe_tpu.core import encrypt as ref_enc
from tfhe_tpu.core import keygen as ref_kg
from tfhe_tpu.core import params as ref_params
from tfhe_tpu.shortint import oprf as ref_oprf
from tfhe_tpu.shortint import params as ref_sp
from tfhe_tpu.utils import csprng as ref_rng
from tfhe_tpu_torch.apps import test_vectors
from tfhe_tpu_torch.core import encrypt, keygen
from tfhe_tpu_torch.core import params as core_params
from tfhe_tpu_torch.shortint import oprf
from tfhe_tpu_torch.shortint import params as sp
from tfhe_tpu_torch.utils import csprng

torch.set_num_threads(1)  # the suite runs in parallel processes: one thread each

TOY = core_params.TEST_VECTOR_TOY_PARAMS
REF_TOY = ref_params.TEST_VECTOR_TOY_PARAMS
SEED = 0xC4A7


@pytest.mark.parametrize("msg_bits", [1, 2, 4, 7])
@pytest.mark.parametrize("bits", [32, 64])
def test_encode_decode_edges(msg_bits, bits):
    shift = bits - msg_bits - 1
    top = 1 << bits
    plaintexts = [0, 1, top - 1, top // 2, top // 2 - 1, (1 << shift) - 1,
                  (1 << (shift - 1)) - 1, 1 << (shift - 1), 3 << (shift - 1)]
    for pt in plaintexts:
        assert encrypt.decode(pt, msg_bits, bits) == ref_enc.decode(pt, msg_bits, bits)
    for msg in [0, 1, (1 << msg_bits) - 1, 1 << msg_bits, (1 << (msg_bits + 1)) + 1]:
        enc = encrypt.encode(msg, msg_bits, bits)
        assert enc == ref_enc.encode(msg, msg_bits, bits)
        assert encrypt.decode(enc, msg_bits, bits) == msg % (1 << msg_bits)


@pytest.fixture(scope="module")
def toy_keys():
    """The toy set's secret keys in both packages, from one seed."""
    ref_sec = ref_rng.SecretRandomGenerator(SEED)
    sec = csprng.SecretRandomGenerator(SEED)
    ref = (ref_kg.generate_binary_lwe_secret_key(REF_TOY.lwe_dimension, ref_sec),
           ref_kg.generate_binary_glwe_secret_key(REF_TOY.glwe_dimension,
                                                  REF_TOY.polynomial_size, ref_sec))
    port = (keygen.generate_binary_lwe_secret_key(TOY.lwe_dimension, sec),
            keygen.generate_binary_glwe_secret_key(TOY.glwe_dimension, TOY.polynomial_size, sec))
    return ref, port


def _ref_gen():
    return ref_rng.EncryptionRandomGenerator(SEED, ref_rng.DeterministicSeeder(SEED ^ 1))


def _gen():
    return csprng.EncryptionRandomGenerator(SEED, csprng.DeterministicSeeder(SEED ^ 1))


@pytest.mark.parametrize("start,count", [(0, 3), (4, 5), (9, 1)])
def test_bsk_chunk_is_the_same_slice_of_the_whole_key(toy_keys, start, count):
    (ref_lwe, ref_glwe), (lwe, glwe) = toy_keys
    whole = ref_kg.generate_lwe_bootstrap_key(ref_lwe, ref_glwe, REF_TOY.pbs_decomp,
                                              REF_TOY.glwe.noise, _ref_gen())
    ref_chunk = ref_kg.generate_lwe_bootstrap_key_chunk(
        ref_lwe, ref_glwe, REF_TOY.pbs_decomp, REF_TOY.glwe.noise, _ref_gen(), start, count)
    chunk = keygen.generate_lwe_bootstrap_key_chunk(lwe, glwe, TOY.pbs_decomp, TOY.glwe.noise,
                                                    _gen(), start, count, device="cpu")
    assert chunk.dtype == np.uint64 and chunk.shape == ref_chunk.shape
    assert (chunk == ref_chunk).all()
    assert (chunk == np.asarray(whole.data)[start:start + count]).all()
    port_whole = keygen.generate_lwe_bootstrap_key(lwe, glwe, TOY.pbs_decomp, TOY.glwe.noise,
                                                   _gen(), device="cpu")
    assert (chunk == port_whole.data[start:start + count]).all()


def test_bsk_chunk_bounds_and_default_device(toy_keys, monkeypatch):
    _, (lwe, glwe) = toy_keys
    with pytest.raises(ValueError):
        keygen.generate_lwe_bootstrap_key_chunk(lwe, glwe, TOY.pbs_decomp, TOY.glwe.noise,
                                                _gen(), 8, 3, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        keygen.generate_lwe_bootstrap_key_chunk(lwe, glwe, TOY.pbs_decomp, TOY.glwe.noise,
                                                _gen(), 0, 1)


@pytest.mark.parametrize("bits", [32, 64, 128])
def test_noise_variances_and_constant(bits):
    assert csprng.BYTES_PER_AES_CALL == ref_rng.BYTES_PER_AES_CALL == 16
    for std in (0.0, 2.845267479601915e-15, 3.6158408373309336e-06):
        assert csprng.Gaussian(std).variance(bits) == ref_rng.Gaussian(std).variance(bits)
    for bound in (0, 3, 17, 45):
        assert csprng.TUniform(bound).variance(bits) == ref_rng.TUniform(bound).variance(bits)


@pytest.mark.parametrize("name", ["TEST_VECTOR_VALID_PARAMS", "TEST_VECTOR_TOY_PARAMS"])
def test_test_vector_sets_field_by_field(name):
    ref, port = getattr(ref_params, name), getattr(core_params, name)
    assert (port.lwe_dimension, port.glwe_dimension, port.polynomial_size) == (
        ref.lwe_dimension, ref.glwe_dimension, ref.polynomial_size)
    for part in ("lwe", "glwe"):
        r, p = getattr(ref, part), getattr(port, part)
        assert type(p.noise).__name__ == type(r.noise).__name__ == "Gaussian"
        assert (p.noise.std, p.noise.mean) == (r.noise.std, r.noise.mean)
        assert p.modulus.bits == r.modulus.bits
    for part in ("pbs_decomp", "ks_decomp"):
        r, p = getattr(ref, part), getattr(port, part)
        assert (p.base_log, p.level_count) == (r.base_log, r.level_count)
    # the test-vector emitter's arguments are built from the same set
    args = (test_vectors.TOY_PARAMS if name.endswith("TOY_PARAMS")
            else test_vectors.VALID_PARAMS_128)
    assert args == dict(lwe_dimension=ref.lwe_dimension, glwe_dimension=ref.glwe_dimension,
                        polynomial_size=ref.polynomial_size, lwe_stddev=ref.lwe.noise.std,
                        glwe_stddev=ref.glwe.noise.std, pbs_base_log=ref.pbs_decomp.base_log,
                        pbs_level=ref.pbs_decomp.level_count,
                        ks_base_log=ref.ks_decomp.base_log, ks_level=ref.ks_decomp.level_count)


@pytest.mark.parametrize("bits", [16, 32, 64])
def test_pseudo_random_lwe_widths(bits):
    ref_p, p = ref_sp.TEST_PARAM_MESSAGE_2_CARRY_2, sp.TEST_PARAM_MESSAGE_2_CARRY_2
    if bits == 16:
        # neither package draws a 16-bit torus word
        with pytest.raises(ValueError):
            ref_oprf.pseudo_random_lwe(ref_p, SEED, bits)
        with pytest.raises(ValueError):
            oprf.pseudo_random_lwe(p, SEED, bits)
        return
    want = ref_oprf.pseudo_random_lwe(ref_p, SEED, bits)
    got = oprf.pseudo_random_lwe(p, SEED, bits)
    assert got.dtype == np.uint64 and got.shape == (p.big_lwe_dimension + 1,)
    assert (got == want).all()
    if bits == 32:
        assert int(got.max()) < 1 << 32
