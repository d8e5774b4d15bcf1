"""The port's test-vector emitter against tfhe_tpu's on the CPU: every file
of toy_params (keys, ciphertexts, the keyswitch through K1's plain version,
the modulus switch, both blind rotations through K2's exact plain version,
the sample extractions, the manifest) byte for byte."""

import os

import pytest
import torch

from tfhe_tpu.apps import test_vectors as ref_vectors
from tfhe_tpu_torch.apps import test_vectors

torch.set_num_threads(1)  # the suite runs in parallel processes: one thread each


@pytest.fixture(scope="module")
def emitted(tmp_path_factory):
    root = tmp_path_factory.mktemp("vectors")
    ref_dir, port_dir = root / "tfhe_tpu", root / "port"
    ref_vectors.generate(str(ref_dir), 10, 1, 256, 0.0, 0.0, 24, 1, 37, 1)
    test_vectors.generate(str(port_dir), **test_vectors.TOY_PARAMS, device="cpu")
    return ref_dir, port_dir


def test_toy_params_match_the_reference_sets():
    assert test_vectors.TOY_PARAMS == dict(
        lwe_dimension=10, glwe_dimension=1, polynomial_size=256, lwe_stddev=0.0,
        glwe_stddev=0.0, pbs_base_log=24, pbs_level=1, ks_base_log=37, ks_level=1)
    assert test_vectors.VALID_PARAMS_128["lwe_dimension"] == 833
    assert (test_vectors.RAND_SEED, test_vectors.MSG_A, test_vectors.MSG_B) == (
        ref_vectors.RAND_SEED, ref_vectors.MSG_A, ref_vectors.MSG_B)


def test_same_files(emitted):
    ref_dir, port_dir = emitted
    assert sorted(os.listdir(port_dir)) == sorted(os.listdir(ref_dir))
    assert len(os.listdir(port_dir)) == 19


@pytest.mark.parametrize("name", [
    "large_lwe_secret_key", "small_lwe_secret_key", "lwe_a", "lwe_b", "lwe_sum",
    "lwe_prod", "ksk", "lwe_ks", "bsk", "lwe_ms", "glwe_after_id_br",
    "glwe_after_id_br_karatsuba", "lwe_after_id_pbs", "lwe_after_id_pbs_karatsuba",
    "glwe_after_spec_br", "glwe_after_spec_br_karatsuba", "lwe_after_spec_pbs",
    "lwe_after_spec_pbs_karatsuba"])
def test_vector_bytes_equal(emitted, name):
    ref_dir, port_dir = emitted
    assert (port_dir / f"{name}.npz").read_bytes() == (ref_dir / f"{name}.npz").read_bytes()


def test_manifest_bytes_equal(emitted):
    ref_dir, port_dir = emitted
    assert (port_dir / "manifest.json").read_bytes() == (ref_dir / "manifest.json").read_bytes()
