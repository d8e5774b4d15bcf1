"""Deterministic test-vector emitter (apps/test-vectors/src/main.rs analog;
port of tfhe_tpu/apps/test_vectors.py).

Replays the reference's vector-generation flow: the same RAND_SEED
(0x74666865), the same generator fork structure (the CSPRNG is
bit-compatible with tfhe-csprng), the same parameter sets (toy and
valid_params_128), the same primitive chain (encrypt, add, cleartext mul,
keyswitch, modulus switch, blind rotate with identity and x*2 LUTs, sample
extract), and stores the results.  The keyswitch runs through K1 and the
blind rotation through K2's exact mode on the chosen device (the card
unless the caller asks for the CPU, where the plain versions run); all of
it is exact integer arithmetic, so the files are byte for byte tfhe_tpu's.

Output: <out>/[toy_params|valid_params_128]/<name>.npz with a ``data`` u64
array per vector (the flat container the reference serializes) and a
manifest.json of parameters.

Run:  python -m tfhe_tpu_torch.apps.test_vectors [out_dir] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from ..core.params import TEST_VECTOR_TOY_PARAMS, TEST_VECTOR_VALID_PARAMS, BootstrapParams

RAND_SEED = 0x74666865
MSG_A, MSG_B = 4, 3
MSG_BITS = 4


def _emit(path: str, name: str, data):
    os.makedirs(path, exist_ok=True)
    np.savez(os.path.join(path, f"{name}.npz"),
             data=np.asarray(data, dtype=np.uint64).reshape(-1))


def generate(path: str, lwe_dimension: int, glwe_dimension: int,
             polynomial_size: int, lwe_stddev: float, glwe_stddev: float,
             pbs_base_log: int, pbs_level: int, ks_base_log: int,
             ks_level: int, device="cuda"):
    from ..core import keygen as kg
    from ..core.encrypt import decrypt_lwe, encrypt_lwe
    from ..core.entities import LweCiphertext
    from ..core.params import DecompParams
    from ..ops import kernels, ntt, torus
    from ..ops import server as srv
    from ..utils.csprng import (DeterministicSeeder, EncryptionRandomGenerator,
                                Gaussian, SecretRandomGenerator)
    from ..utils.device import resolve_device

    device = resolve_device(device)
    delta_log = 64 - MSG_BITS - 1
    delta = 1 << delta_log
    msg_mod = 1 << MSG_BITS

    sec = SecretRandomGenerator(RAND_SEED)
    enc = EncryptionRandomGenerator(RAND_SEED, DeterministicSeeder(RAND_SEED))

    glwe_sk = kg.generate_binary_glwe_secret_key(glwe_dimension, polynomial_size, sec)
    large_sk = glwe_sk.as_lwe_secret_key()
    _emit(path, "large_lwe_secret_key", large_sk.data)
    small_sk = kg.generate_binary_lwe_secret_key(lwe_dimension, sec)
    _emit(path, "small_lwe_secret_key", small_sk.data)

    lwe_noise = Gaussian(lwe_stddev)
    glwe_noise = Gaussian(glwe_stddev)

    lwe_a = encrypt_lwe(large_sk, MSG_A * delta, glwe_noise, enc)
    _emit(path, "lwe_a", lwe_a.data)
    lwe_b = encrypt_lwe(large_sk, MSG_B * delta, glwe_noise, enc)
    _emit(path, "lwe_b", lwe_b.data)

    with np.errstate(over="ignore"):
        lwe_sum = lwe_a.data + lwe_b.data
        lwe_prod = lwe_a.data * np.uint64(MSG_B)
    _emit(path, "lwe_sum", lwe_sum)
    _emit(path, "lwe_prod", lwe_prod)

    ksk = kg.generate_lwe_keyswitch_key(
        large_sk, small_sk, DecompParams(ks_base_log, ks_level), lwe_noise, enc)
    _emit(path, "ksk", ksk.data)

    ksk_t = torus.from_u64(ksk.data, device)
    lwe_ks = kernels.keyswitch(torus.from_u64(lwe_a.data[None], device),
                               kernels.keyswitch_key(ksk_t, ks_base_log, ks_level),
                               ks_base_log, ks_level)
    _emit(path, "lwe_ks", torus.to_u64(lwe_ks[0]))

    bsk = kg.generate_lwe_bootstrap_key(
        small_sk, glwe_sk, DecompParams(pbs_base_log, pbs_level), glwe_noise, enc, device)
    _emit(path, "bsk", bsk.data)
    dp = ntt.device_plan(ntt.make_plan(polynomial_size), str(device))
    bsk_ntt = ntt.key_ntt(bsk.data, dp)

    log_modulus = polynomial_size.bit_length()  # log2(2N)
    msed = srv.modulus_switch(lwe_ks[0], log_modulus)
    # stored like the reference: power-of-two encoding in the top bits
    _emit(path, "lwe_ms", torus.to_u64(msed) << np.uint64(64 - log_modulus))

    for lut_name, f in (("id", lambda x: x), ("spec", lambda x: (x * 2) % msg_mod)):
        acc0 = srv.generate_lut(polynomial_size, glwe_dimension + 1, msg_mod, delta, f)
        acc_t = kernels.blind_rotate(msed[None, :-1], msed[None, -1],
                                     torus.from_u64(acc0[None], device), bsk_ntt, dp,
                                     pbs_base_log, pbs_level)
        acc = torus.to_u64(acc_t[0])
        _emit(path, f"glwe_after_{lut_name}_br", acc)
        _emit(path, f"glwe_after_{lut_name}_br_karatsuba", acc)
        lwe_out = torus.to_u64(srv.sample_extract(acc_t)[0])
        _emit(path, f"lwe_after_{lut_name}_pbs", lwe_out)
        _emit(path, f"lwe_after_{lut_name}_pbs_karatsuba", lwe_out)
        # self-check: decode
        pt = decrypt_lwe(large_sk, LweCiphertext(lwe_out))
        dec = ((int(pt) + (1 << (delta_log - 1))) >> delta_log) % (2 * msg_mod)
        assert dec % msg_mod == f(MSG_A) % msg_mod, (lut_name, dec)

    with open(os.path.join(path, "manifest.json"), "w") as fh:
        json.dump({
            "rand_seed": hex(RAND_SEED), "msg_a": MSG_A, "msg_b": MSG_B,
            "msg_bits": MSG_BITS, "lwe_dimension": lwe_dimension,
            "glwe_dimension": glwe_dimension,
            "polynomial_size": polynomial_size,
            "pbs": [pbs_base_log, pbs_level], "ks": [ks_base_log, ks_level],
            "note": "data arrays are the flat u64 containers the reference "
                    "serializes to CBOR; *_karatsuba outputs must match the "
                    "reference bit-for-bit (exact arithmetic both sides)",
        }, fh, indent=1)


def _generate_args(params: BootstrapParams) -> dict:
    """generate()'s keyword arguments of a core parameter set."""
    return dict(lwe_dimension=params.lwe_dimension, glwe_dimension=params.glwe_dimension,
                polynomial_size=params.polynomial_size, lwe_stddev=params.lwe.noise.std,
                glwe_stddev=params.glwe.noise.std,
                pbs_base_log=params.pbs_decomp.base_log,
                pbs_level=params.pbs_decomp.level_count,
                ks_base_log=params.ks_decomp.base_log, ks_level=params.ks_decomp.level_count)


TOY_PARAMS = _generate_args(TEST_VECTOR_TOY_PARAMS)
VALID_PARAMS_128 = _generate_args(TEST_VECTOR_VALID_PARAMS)


def main(out_dir: str = "test_vectors_out", device="cuda"):
    generate(os.path.join(out_dir, "toy_params"), **TOY_PARAMS, device=device)
    generate(os.path.join(out_dir, "valid_params_128"), **VALID_PARAMS_128, device=device)
    print(f"vectors written to {out_dir}/")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="Emit the test vectors (toy_params, "
                                             "valid_params_128).")
    ap.add_argument("out_dir", nargs="?", default="test_vectors_out")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(args.out_dir, args.device)
