"""The multi-bit slice of the port against tfhe_tpu on the CPU, word for word
(tolerance 0; all arithmetic is integer): the parameter sets, key bytes,
pattern degrees, the exact (key-bundle) rotation, the v9 rotation against
the TPU kernel's XLA twin, apply_lookup_table_batch end to end, the mode
choice, and the K3 wrapper on CPU tensors."""

import dataclasses
import enum

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tfhe_tpu import shortint as ref
from tfhe_tpu.core import keygen as ref_kg
from tfhe_tpu.core import multibit as ref_mb
from tfhe_tpu.core.params import DecompParams as RefDecomp
from tfhe_tpu.ops import mxu as ref_mxu
from tfhe_tpu.ops import server as ref_srv
from tfhe_tpu.shortint import server_key as ref_sk
from tfhe_tpu.utils.csprng import (DeterministicSeeder, EncryptionRandomGenerator,
                                   SecretRandomGenerator)
from tfhe_tpu.utils.csprng import TUniform as RefTUniform
from tfhe_tpu_torch import shortint
from tfhe_tpu_torch.core import multibit as mb
from tfhe_tpu_torch.core.entities import LweBootstrapKey
from tfhe_tpu_torch.ops import bsk_prep, kernels, ntt, server, torus
from tfhe_tpu_torch.shortint import server_key as port_sk
from tfhe_tpu_torch.utils.csprng import TUniform

torch.set_num_threads(1)  # the suite runs in parallel processes: one thread each

MB_SETS = sorted(name for name, v in vars(shortint).items()
                 if isinstance(v, shortint.MultiBitPBSParameters))
N, BASE_LOG, LEVELS = 512, 22, 1


def _words(cts) -> np.ndarray:
    return np.stack([np.asarray(c.data) for c in cts])


def _t(a) -> torch.Tensor:
    return torus.from_u64(np.asarray(a, dtype=np.uint64), "cpu")


def _plain(v):
    """A parameter field in a form both packages compare in."""
    if isinstance(v, enum.Enum):
        return v.value
    if dataclasses.is_dataclass(v):
        return (type(v).__name__, dataclasses.asdict(v))
    return v


def _ref_key(n_in, grouping, seed=11):
    """tfhe_tpu's toy multi-bit key at N = 512, base 2^22, one level."""
    gen_s = SecretRandomGenerator(seed)
    lwe_sk = ref_kg.generate_binary_lwe_secret_key(n_in, gen_s)
    glwe_sk = ref_kg.generate_binary_glwe_secret_key(1, N, gen_s)
    gen_e = EncryptionRandomGenerator(seed + 1, DeterministicSeeder(seed + 2))
    return ref_mb.generate_multibit_bootstrap_key(
        lwe_sk, glwe_sk, RefDecomp(BASE_LOG, LEVELS), grouping, RefTUniform(3), gen_e)


def _rotation_inputs(seed, b, n_in, grouping):
    """Degrees from random raw masks (so d_0 = 0), body, random LUT."""
    rng = np.random.default_rng(seed)
    mask = rng.integers(0, 1 << 64, (b, n_in), dtype=np.uint64)
    body = rng.integers(0, 2 * N, (b,), dtype=np.uint64)
    lut = rng.integers(0, 1 << 64, (b, 2, N), dtype=np.uint64)
    degrees = np.asarray(ref_srv.multibit_switched_degrees(
        jnp.asarray(mask), grouping, N.bit_length(), raw=True))
    return degrees, body, lut


# ---------------------------------------------------------------------------
# Parameters and keys
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", MB_SETS)
def test_multibit_params_match(name):
    mine, theirs = getattr(shortint, name), getattr(ref, name)
    fields = [f.name for f in dataclasses.fields(theirs)]
    assert fields == [f.name for f in dataclasses.fields(mine)]
    for f in fields:
        assert _plain(getattr(mine, f)) == _plain(getattr(theirs, f)), f


KEYGEN_SETS = {
    # outside the v9 family: unfloored
    "test_group_2": lambda m: m.TEST_PARAM_MULTI_BIT_GROUP_2_MESSAGE_2_CARRY_2,
    # GROUP_4 2_2 cut to n = 8: N = 2048, inside the family, floored at rb 18
    "group_4_n8": lambda m: dataclasses.replace(
        m.V1_4_PARAM_GPU_MULTI_BIT_GROUP_4_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128,
        lwe_dimension=8),
}


@pytest.mark.parametrize("which", sorted(KEYGEN_SETS))
def test_multibit_keys_match(which):
    rp, pp = KEYGEN_SETS[which](ref), KEYGEN_SETS[which](shortint)
    rsk = ref.ServerKey(ref.ClientKey(rp, seed=41), seed=42)
    psk = shortint.ServerKey(shortint.ClientKey(pp, seed=41), seed=42, device="cpu")
    assert psk._bsk_floored == rsk._mb_floored == (18 if which == "group_4_n8" else 0)
    assert (torus.to_u64(psk.ksk) == np.asarray(rsk.ksk)).all()
    assert psk._bsk_coeff.dtype == np.uint64
    assert (psk._bsk_coeff == rsk._mb_bsk_coeff).all()
    # the CPU runs exact mode: the unrounded NTT-domain key
    assert not psk.trunc_acc
    assert (psk.bsk_ntt.numpy().view(np.uint32) == np.asarray(rsk.mb_bsk_mont)).all()


def test_multibit_bsk_to_ntt_and_tables_match():
    key = _ref_key(4, 2)
    mine, plan = mb.multibit_bsk_to_ntt(key)
    theirs, ref_plan = ref_mb.multibit_bsk_to_ntt(key)
    assert plan.primes == ref_plan.primes and (mine == theirs).all()
    tables, br = mb.monomial_ntt_tables(N, 4)
    ref_tables, ref_br = ref_mb.monomial_ntt_tables(N, 4)
    assert (tables == ref_tables).all() and (br == ref_br).all()


# ---------------------------------------------------------------------------
# Degrees and the two rotations
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("grouping", [2, 3, 4])
@pytest.mark.parametrize("raw", [True, False])
def test_switched_degrees_match(grouping, raw):
    rng = np.random.default_rng(grouping)
    log_mod = 12
    hi = 1 << 64 if raw else 1 << log_mod
    mask = rng.integers(0, hi, (3, 4 * grouping), dtype=np.uint64)
    want = np.asarray(ref_srv.multibit_switched_degrees(
        jnp.asarray(mask), grouping, log_mod, raw=raw))
    got = server.multibit_switched_degrees(_t(mask), grouping, log_mod, raw=raw)
    assert got.dtype == torch.int64 and (got.numpy() == want.astype(np.int64)).all()


def test_exact_rotation_matches_key_bundle_form():
    grouping, n_in = 2, 8
    key = _ref_key(n_in, grouping)
    ref_mont, ref_plan = ref_mb.multibit_bsk_to_ntt(key)
    mine, plan = mb.multibit_bsk_to_ntt(key)
    degrees, body, lut = _rotation_inputs(3, 3, n_in, grouping)
    want = np.asarray(ref_srv.blind_rotate_multibit(
        jnp.asarray(degrees), jnp.asarray(body), jnp.asarray(lut),
        jnp.asarray(ref_mont), ref_plan, BASE_LOG, LEVELS, grouping))
    got = server.blind_rotate_multibit(
        torch.from_numpy(degrees.astype(np.int64)), torch.from_numpy(body.astype(np.int64)),
        _t(lut), torch.from_numpy(mine.view(np.int32)), ntt.device_plan(plan, "cpu"),
        BASE_LOG, LEVELS)
    assert (torus.to_u64(got) == want).all()


def test_v9_pipeline_matches_the_tpu_kernel_twin():
    """KS -> centered MS -> degrees -> v9 rotation -> SE on the rb = 18
    rounded key at g = 4 (ops/server.py ks_pbs_batch_multibit, v9) against
    tfhe_tpu's keyswitch, MS and mxu.blind_rotate_mxu_multibit(trunc=True)
    on a 3-prime rb = 18 plan; and it decrypts."""
    kw = dict(lwe_dimension=8, glwe_dimension=1, polynomial_size=N,
              pbs_base_log=BASE_LOG, pbs_level=LEVELS, ks_base_log=4, ks_level=4,
              message_modulus=4, carry_modulus=4, max_noise_level=5,
              log2_p_fail=-3.0, grouping_factor=4)
    rp = ref.MultiBitPBSParameters(lwe_noise=RefTUniform(3), glwe_noise=RefTUniform(3), **kw)
    pp = shortint.MultiBitPBSParameters(lwe_noise=TUniform(3), glwe_noise=TUniform(3), **kw)
    rsk = ref.ServerKey(ref.ClientKey(rp, seed=0x31), seed=0x32)
    pck = shortint.ClientKey(pp, seed=0x31)
    psk = shortint.ServerKey(pck, seed=0x32, device="cpu")
    vals = [0, 1, 2, 3]
    cts = _words([pck.encrypt(v) for v in vals])
    lut = psk.generate_lookup_table(lambda x: (3 * x + 1) % 16)
    lut_b = np.broadcast_to(lut.acc, (len(vals),) + lut.acc.shape)

    rb = 18
    plan3 = ref_mxu.make_mxu_plan(N, num_primes=3, round_bits=rb)
    m3 = ref_mxu.multibit_bsk_to_mxu(rsk._mb_bsk_coeff, RefDecomp(BASE_LOG, LEVELS),
                                     plan3, 4)
    log_mod = N.bit_length()
    ks = ref_srv.keyswitch(jnp.asarray(cts), rsk.ksk, 4, 4)
    body = ks[:, -1] + ref_srv.centered_binary_ms_correction(ks, log_mod)
    acc = ref_mxu.blind_rotate_mxu_multibit(
        ref_srv.multibit_switched_degrees(ks[:, :-1], 4, log_mod),
        ref_srv.modulus_switch(body, log_mod), jnp.asarray(lut_b), jnp.asarray(m3),
        plan3, BASE_LOG, LEVELS, 4, trunc=True)
    want = np.asarray(ref_srv.sample_extract(acc))

    flat = psk._bsk_coeff.reshape((-1,) + psk._bsk_coeff.shape[2:])
    rounded = bsk_prep.round_bsk(LweBootstrapKey(flat, pp.core.pbs_decomp), rb).data
    key, plan = mb.multibit_bsk_to_ntt(rounded.reshape(psk._bsk_coeff.shape))
    got = torus.to_u64(server.ks_pbs_batch_multibit(
        _t(cts), _t(lut_b), psk.ksk, torch.from_numpy(key.view(np.int32)),
        ntt.device_plan(plan, "cpu"), 4, 4, BASE_LOG, LEVELS, 4,
        centered_ms=True, v9=True))
    assert (got == want).all()
    assert [pck.decrypt_raw(shortint.Ciphertext(w, 15, 1, 4, 4)) for w in got] \
        == [(3 * v + 1) % 16 for v in vals]


# ---------------------------------------------------------------------------
# The slice end to end
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mb_keys():
    rp = ref.TEST_PARAM_MULTI_BIT_GROUP_2_MESSAGE_2_CARRY_2
    pp = shortint.TEST_PARAM_MULTI_BIT_GROUP_2_MESSAGE_2_CARRY_2
    rck, pck = ref.ClientKey(rp, seed=51), shortint.ClientKey(pp, seed=51)
    return (rck, ref.ServerKey(rck, seed=52), pck,
            shortint.ServerKey(pck, seed=52, device="cpu"))


def test_multibit_lut_batch_matches_and_chains(mb_keys):
    """5 ciphertexts (padded to 8) under a shared LUT, then a chained round
    on the lazy outputs after unchecked_add with one LUT per element."""
    rck, rsk, pck, psk = mb_keys
    vals = [0, 1, 2, 3, 2]
    rc = [rck.encrypt(v) for v in vals]
    pc = [pck.encrypt(v) for v in vals]
    assert (_words(rc) == _words(pc)).all()
    f = lambda x: (x + 1) % 4            # noqa: E731
    ro = rsk.apply_lookup_table_batch(rc, rsk.generate_lookup_table(f))
    po = psk.apply_lookup_table_batch(pc, psk.generate_lookup_table(f))
    assert all(isinstance(c.data, shortint.ciphertext.LazyLweData) for c in po)
    assert (_words(ro) == _words(po)).all()
    assert [pck.decrypt(c) for c in po] == [f(v) for v in vals]

    rs = [rsk.unchecked_add(ro[i], ro[(i + 1) % 5]) for i in range(5)]
    ps = [psk.unchecked_add(po[i], po[(i + 1) % 5]) for i in range(5)]
    fs = [lambda x: (3 * x + 1) % 16, lambda x: x % 4]
    ro2 = rsk.apply_lookup_table_batch(rs, [rsk.generate_lookup_table(fs[i % 2])
                                            for i in range(5)])
    po2 = psk.apply_lookup_table_batch(ps, [psk.generate_lookup_table(fs[i % 2])
                                            for i in range(5)])
    assert (_words(ro2) == _words(po2)).all()
    sums = [f(vals[i]) + f(vals[(i + 1) % 5]) for i in range(5)]
    assert [pck.decrypt_raw(c) for c in po2] == [fs[i % 2](s) for i, s in enumerate(sums)]


def test_multibit_keys_carried_in_through_from_raw_keys(mb_keys):
    rck, rsk, _, _ = mb_keys
    psk = shortint.ServerKey.from_raw_keys(
        shortint.TEST_PARAM_MULTI_BIT_GROUP_2_MESSAGE_2_CARRY_2, np.asarray(rsk.ksk),
        rsk._mb_bsk_coeff, rsk._mb_floored, device="cpu")
    cts = [rck.encrypt(v) for v in [3, 1, 0]]
    want = _words(rsk.apply_lookup_table_batch(
        cts, rsk.generate_lookup_table(lambda x: 15 - x)))
    got = _words(psk.apply_lookup_table_batch(
        [shortint.Ciphertext(np.asarray(c.data), c.degree, c.noise_level,
                             c.message_modulus, c.carry_modulus) for c in cts],
        psk.generate_lookup_table(lambda x: 15 - x)))
    assert (got == want).all()


# ---------------------------------------------------------------------------
# Mode choice and the K3 wrapper
# ---------------------------------------------------------------------------


def test_v9_mode_is_chosen_as_tfhe_tpu_chooses_the_fused_kernel(monkeypatch):
    for var in ("TFHE_TPU_MXU_MB_ROUND_BITS", "TFHE_TPU_MXU_PRIMES"):
        monkeypatch.delenv(var, raising=False)
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    g4 = shortint.V1_4_PARAM_GPU_MULTI_BIT_GROUP_4_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128
    tpu_g2 = shortint.TPU_PARAM_MULTI_BIT_GROUP_2_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128
    assert bsk_prep.mb_round_bits(g4) == 18 and bsk_prep.mb_round_bits(tpu_g2) == 16
    assert port_sk.uses_v9(cuda, g4, 18) and port_sk.uses_v9(cuda, tpu_g2, 16)
    assert not port_sk.uses_v9(cpu, g4, 18)          # the CPU runs exact
    assert not port_sk.uses_v9(cuda, g4, 0)          # unfloored key
    for name in MB_SETS:
        p, rp = getattr(shortint, name), getattr(ref, name)
        assert port_sk._v9_family(p) == ref_sk._mxu_family_mb(rp), name
        if port_sk._v9_family(p):
            assert bsk_prep.mb_round_bits(p) == ref_sk._mxu_mb_round_bits(rp), name
        else:
            assert not port_sk.uses_v9(cuda, p, 64), name


@pytest.mark.parametrize("v9", [False, True])
def test_k3_wrapper_takes_the_plain_versions_on_cpu(v9):
    grouping, n_in = 2, 4
    key, plan = mb.multibit_bsk_to_ntt(_ref_key(n_in, grouping))
    degrees, body, lut = _rotation_inputs(5, 2, n_in, grouping)
    args = (torch.from_numpy(degrees.astype(np.int64)),
            torch.from_numpy(body.astype(np.int64)), _t(lut),
            torch.from_numpy(key.view(np.int32)), ntt.device_plan(plan, "cpu"),
            BASE_LOG, LEVELS)
    before = kernels.blind_rotate_multibit.launches
    got = kernels.blind_rotate_multibit(*args, v9=v9)
    plain = server.blind_rotate_multibit_v9 if v9 else server.blind_rotate_multibit
    assert torch.equal(got, plain(*args))
    assert kernels.blind_rotate_multibit.launches == before == 0
