"""The slice end to end on the CPU: the port's shortint ServerKey against
tfhe_tpu's, word for word (tolerance 0): apply_lookup_table_batch under
both modulus-switch modes on a batch that pads, a chained round on the
lazy device-resident outputs, keys carried in through from_raw_keys, the
v7 pipeline against the TPU kernel's XLA twin, and the op set."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tfhe_tpu import shortint as ref
from tfhe_tpu.ops import mxu as ref_mxu
from tfhe_tpu.ops import server as ref_srv
from tfhe_tpu.shortint.params import MsNoiseReduction as RefMs
from tfhe_tpu.utils.csprng import TUniform as RefTUniform
from tfhe_tpu_torch import shortint
from tfhe_tpu_torch.core import keygen as kg
from tfhe_tpu_torch.ops import bsk_prep, ntt, server, torus
from tfhe_tpu_torch.shortint import server_key as port_sk
from tfhe_tpu_torch.shortint.params import (EncryptionKeyChoice,
                                            MsNoiseReduction)
from tfhe_tpu_torch.utils.csprng import TUniform

torch.set_num_threads(1)  # the suite runs in parallel processes: one thread each

MS_MODES = {"none": (RefMs.NONE, MsNoiseReduction.NONE),
            "centered_mean": (RefMs.CENTERED_MEAN, MsNoiseReduction.CENTERED_MEAN)}


def _words(cts) -> np.ndarray:
    return np.stack([np.asarray(c.data) for c in cts])


@pytest.fixture(scope="module", params=sorted(MS_MODES))
def keys(request):
    """(reference client, server; port client, server) from the same seeds
    at TEST_PARAM_MESSAGE_2_CARRY_2 under one modulus-switch mode."""
    ref_ms, port_ms = MS_MODES[request.param]
    rp = dataclasses.replace(ref.TEST_PARAM_MESSAGE_2_CARRY_2,
                             ms_noise_reduction=ref_ms)
    pp = dataclasses.replace(shortint.TEST_PARAM_MESSAGE_2_CARRY_2,
                             ms_noise_reduction=port_ms)
    rck = ref.ClientKey(rp, seed=71)
    pck = shortint.ClientKey(pp, seed=71)
    return (rck, ref.ServerKey(rck, seed=72), pck,
            shortint.ServerKey(pck, seed=72, device="cpu"))


def test_lut_batch_matches_and_chains(keys):
    """5 ciphertexts (padded to 8), a shared LUT; then a chained round on the
    lazy outputs after unchecked_add, with one LUT per element."""
    rck, rsk, pck, psk = keys
    vals = [0, 1, 2, 3, 2]
    rc = [rck.encrypt(v) for v in vals]
    pc = [pck.encrypt(v) for v in vals]
    assert (_words(rc) == _words(pc)).all()
    f = lambda x: (x + 1) % 4            # noqa: E731
    ro = rsk.apply_lookup_table_batch(rc, rsk.generate_lookup_table(f))
    po = psk.apply_lookup_table_batch(pc, psk.generate_lookup_table(f))
    assert all(isinstance(c.data, shortint.ciphertext.LazyLweData) for c in po)
    assert po[0].data.terms[0][1].arr.shape[0] == 8       # padded on device
    assert (_words(ro) == _words(po)).all()
    assert [pck.decrypt(c) for c in po] == [f(v) for v in vals]
    assert [c.degree for c in po] == [c.degree for c in ro] == [3] * 5

    rs = [rsk.unchecked_add(ro[i], ro[(i + 1) % 5]) for i in range(5)]
    ps = [psk.unchecked_add(po[i], po[(i + 1) % 5]) for i in range(5)]
    fs = [lambda x: (3 * x + 1) % 16, lambda x: x % 4]
    r_luts = [rsk.generate_lookup_table(fs[i % 2]) for i in range(5)]
    p_luts = [psk.generate_lookup_table(fs[i % 2]) for i in range(5)]
    ro2 = rsk.apply_lookup_table_batch(rs, r_luts)
    po2 = psk.apply_lookup_table_batch(ps, p_luts)
    assert (_words(ro2) == _words(po2)).all()
    sums = [f(vals[i]) + f(vals[(i + 1) % 5]) for i in range(5)]
    assert [pck.decrypt_raw(c) for c in po2] == [fs[i % 2](s) for i, s in enumerate(sums)]
    assert psk.pbs_count == rsk.pbs_count == 10


def test_keys_carried_in_through_from_raw_keys(keys):
    rck, rsk, _, _ = keys
    p = dataclasses.replace(shortint.TEST_PARAM_MESSAGE_2_CARRY_2,
                            ms_noise_reduction=MS_MODES[
                                rsk.params.ms_noise_reduction.value][1])
    psk = shortint.ServerKey.from_raw_keys(
        p, np.asarray(rsk.ksk), rsk._bsk_coeff.data, rsk._bsk_floored,
        device="cpu")
    cts = [rck.encrypt(v) for v in [3, 1, 0]]
    lut_r = rsk.generate_lookup_table(lambda x: 15 - x)
    lut_p = psk.generate_lookup_table(lambda x: 15 - x)
    want = _words(rsk.apply_lookup_table_batch(cts, lut_r))
    got = _words(psk.apply_lookup_table_batch(
        [shortint.Ciphertext(np.asarray(c.data), c.degree, c.noise_level,
                             c.message_modulus, c.carry_modulus) for c in cts],
        lut_p))
    assert (got == want).all()


# (name, op) over a server key and two fresh ciphertexts a = 3, b = 2
OPS = {
    "unchecked_add": lambda sk, a, b: sk.unchecked_add(a, b),
    "unchecked_sub": lambda sk, a, b: sk.unchecked_sub(a, b),
    "unchecked_neg": lambda sk, a, b: sk.unchecked_neg(a),
    "unchecked_scalar_add": lambda sk, a, b: sk.unchecked_scalar_add(a, 5),
    "unchecked_scalar_mul": lambda sk, a, b: sk.unchecked_scalar_mul(b, 3),
    "checked_add": lambda sk, a, b: sk.checked_add(a, b),
    "checked_sub": lambda sk, a, b: sk.checked_sub(a, b),
    "checked_scalar_mul": lambda sk, a, b: sk.checked_scalar_mul(a, 2),
    "create_trivial": lambda sk, a, b: sk.create_trivial(9),
    "message_extract": lambda sk, a, b: sk.message_extract(
        sk.unchecked_add(a, b)),
    "carry_extract": lambda sk, a, b: sk.carry_extract(sk.unchecked_add(a, b)),
    "smart_add": lambda sk, a, b: sk.smart_add(
        sk.unchecked_scalar_mul(a, 4), b),
    "add": lambda sk, a, b: sk.add(a, b),
    "mul": lambda sk, a, b: sk.mul(a, b),
    "checked_mul": lambda sk, a, b: sk.checked_mul(a, b),
    "bitand": lambda sk, a, b: sk.bitand(a, b),
    "bitxor": lambda sk, a, b: sk.bitxor(a, b),
    "lt": lambda sk, a, b: sk.lt(b, a),
}


@pytest.fixture(scope="module")
def op_keys():
    rck = ref.ClientKey(ref.TEST_PARAM_MESSAGE_2_CARRY_2, seed=81)
    pck = shortint.ClientKey(shortint.TEST_PARAM_MESSAGE_2_CARRY_2, seed=81)
    return (rck, ref.ServerKey(rck, seed=82), pck,
            shortint.ServerKey(pck, seed=82, device="cpu"))


@pytest.mark.parametrize("name", sorted(OPS))
def test_op_matches(op_keys, name):
    rck, rsk, pck, psk = op_keys
    want = OPS[name](rsk, rck.encrypt(3), rck.encrypt(2))
    got = OPS[name](psk, pck.encrypt(3), pck.encrypt(2))
    assert (np.asarray(got.data) == np.asarray(want.data)).all()
    assert (got.degree, got.noise_level) == (want.degree, want.noise_level)
    assert pck.decrypt_raw(got) == rck.decrypt_raw(want)


def test_checked_ops_refuse_as_the_reference(op_keys):
    rck, rsk, pck, psk = op_keys
    big_r = rsk.unchecked_scalar_mul(rck.encrypt(3), 5)      # degree 15
    big_p = psk.unchecked_scalar_mul(pck.encrypt(3), 5)
    with pytest.raises(ref.server_key.CarryFullError):
        rsk.checked_add(big_r, rck.encrypt(1))
    with pytest.raises(shortint.CarryFullError):
        psk.checked_add(big_p, pck.encrypt(1))
    with pytest.raises(shortint.CarryFullError):
        psk.checked_apply_bivariate(pck.encrypt(1), big_p, lambda x, y: x)


def test_batch_and_lut_lists_must_agree(op_keys):
    _, _, pck, psk = op_keys
    lut = psk.generate_lookup_table(lambda x: x)
    with pytest.raises(ValueError):
        psk.apply_lookup_table_batch([pck.encrypt(1)], [lut, lut])


# ---------------------------------------------------------------------------
# v7 mode
# ---------------------------------------------------------------------------


def test_v7_mode_is_chosen_as_tfhe_tpu_chooses_mxu():
    prod = shortint.V1_4_PARAM_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128
    test = shortint.TEST_PARAM_MESSAGE_2_CARRY_2
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert port_sk.uses_v7(cuda, prod, 15)
    assert not port_sk.uses_v7(cpu, prod, 15)        # the CPU runs exact
    assert not port_sk.uses_v7(cuda, prod, 0)        # unfloored key
    assert not port_sk.uses_v7(cuda, test, 15)       # N = 512
    for p in (prod, test, shortint.V1_4_PARAM_MESSAGE_1_CARRY_1_KS_PBS_TUNIFORM_2M128):
        rp = getattr(ref, [k for k, v in vars(shortint).items() if v is p][0])
        assert port_sk._v7_family(p) == ref.server_key._mxu_family(rp)


def test_v7_pipeline_matches_the_tpu_kernel_twin():
    """At the toy set of tests/test_trunc_acc.py: the port's KS->PBS in v7
    mode (round_bsk key, 2^32-grid accumulator) == tfhe_tpu keyswitch,
    modulus switch, mxu.blind_rotate_mxu_trunc (3 primes, rb 15), sample
    extract; and it decrypts."""
    kw = dict(lwe_dimension=64, glwe_dimension=1, polynomial_size=256,
              pbs_base_log=23, pbs_level=1, ks_base_log=4, ks_level=4,
              message_modulus=4, carry_modulus=4, max_noise_level=5,
              log2_p_fail=-3.0)
    rp = ref.ShortintParams(lwe_noise=RefTUniform(3), glwe_noise=RefTUniform(3),
                            ms_noise_reduction=RefMs.NONE, **kw)
    pp = shortint.ShortintParams(lwe_noise=TUniform(3), glwe_noise=TUniform(3),
                                 ms_noise_reduction=MsNoiseReduction.NONE, **kw)
    rck, pck = ref.ClientKey(rp, seed=0x77), shortint.ClientKey(pp, seed=0x77)
    rsk = ref.ServerKey(rck, seed=0x77)
    psk = shortint.ServerKey(pck, seed=0x77, device="cpu")
    vals = [i % 4 for i in range(8)]
    cts = _words([pck.encrypt(v) for v in vals])
    lut = psk.generate_lookup_table(lambda x: (3 * x + 1) % 16)
    lut_b = np.broadcast_to(lut.acc, (len(vals),) + lut.acc.shape)

    plan3 = ref_mxu.make_mxu_plan(256, num_primes=3, round_bits=15)
    m3, _ = ref_mxu.bsk_to_mxu(rsk._bsk_coeff, plan3)
    ks = ref_srv.keyswitch(jnp.asarray(cts), rsk.ksk, 4, 4)
    log_mod = 256 .bit_length()
    acc = ref_mxu.blind_rotate_mxu_trunc(
        ref_srv.modulus_switch(ks[:, :-1], log_mod),
        ref_srv.modulus_switch(ks[:, -1], log_mod), jnp.asarray(lut_b),
        jnp.asarray(m3), plan3, 23, 1)
    want = np.asarray(ref_srv.sample_extract(acc))

    key, plan = kg.bootstrap_key_to_ntt(bsk_prep.round_bsk(psk._bsk_coeff, 15))
    got = torus.to_u64(server.ks_pbs_batch(
        torus.from_u64(cts, "cpu"), torus.from_u64(lut_b, "cpu"), psk.ksk,
        torch.from_numpy(key.view(np.int32)), ntt.device_plan(plan, "cpu"),
        4, 4, 23, 1, centered_ms=False, trunc_acc=True))
    assert (got == want).all()
    assert [pck.decrypt_raw(shortint.Ciphertext(w, 15, 1, 4, 4)) for w in got] \
        == [(3 * v + 1) % 16 for v in vals]


# ---------------------------------------------------------------------------
# The other arms of tfhe_tpu's apply_lookup_table_batch (KS32, the SMALL key
# and the drift modulus switch, classic or multi-bit), which the port
# refused until the atomic-pattern slice; tests/test_torch_atomic_patterns.py
# holds each against tfhe_tpu at length
# ---------------------------------------------------------------------------


UNSUPPORTED = {
    "ks32": dict(ks32=True),
    "small_key": dict(encryption_key_choice=EncryptionKeyChoice.SMALL),
    "drift": dict(ms_noise_reduction=MsNoiseReduction.DRIFT, drift_zeros_count=4),
}
REF_ARMS = {
    "ks32": dict(ks32=True),
    "small_key": dict(encryption_key_choice=ref.params.EncryptionKeyChoice.SMALL),
    "drift": dict(ms_noise_reduction=RefMs.DRIFT, drift_zeros_count=4),
}


@pytest.mark.parametrize("arm", sorted(UNSUPPORTED))
def test_later_arms_raise(arm):
    """Each arm builds (from a client key and from raw keys) and runs a LUT
    round: the keys' round gives the words of the same round under the key
    carried in through from_raw_keys (no drift zeros there, as in
    tfhe_tpu: the drift key's round differs only by its drift choice) and
    decrypts right."""
    p = dataclasses.replace(shortint.TEST_PARAM_MESSAGE_2_CARRY_2,
                            **UNSUPPORTED[arm])
    ck = shortint.ClientKey(p, seed=1)
    sk = shortint.ServerKey(ck, seed=2, device="cpu")
    raw = shortint.ServerKey.from_raw_keys(p, torus.to_u64(sk.ksk), sk._bsk_coeff.data,
                                           device="cpu")
    assert (sk.drift_zeros is not None) == (arm == "drift") and raw.drift_zeros is None
    cts = [ck.encrypt(v) for v in range(4)]
    lut = sk.generate_lookup_table(lambda x: (x + 2) % 16)
    outs = [s.apply_lookup_table_batch(cts, lut) for s in (sk, raw)]
    for o in outs:
        assert [ck.decrypt_raw(c) for c in o] == [(v + 2) % 16 for v in range(4)]
    if arm != "drift":
        assert (_words(outs[0]) == _words(outs[1])).all()


def test_multi_bit_raises():
    """Multi-bit under the KS32 atomic pattern (a u32 keyswitch, degrees from
    the u32 mask on the u64 torus) and under the drift modulus switch (no
    zeros drawn in tfhe_tpu's multi-bit arm): tfhe_tpu's KSK and round
    words."""
    for arm in ("ks32", "drift"):
        rp = dataclasses.replace(ref.TEST_PARAM_MULTI_BIT_GROUP_2_MESSAGE_2_CARRY_2,
                                 **REF_ARMS[arm])
        pp = dataclasses.replace(shortint.TEST_PARAM_MULTI_BIT_GROUP_2_MESSAGE_2_CARRY_2,
                                 **UNSUPPORTED[arm])
        rck, pck = ref.ClientKey(rp, seed=1), shortint.ClientKey(pp, seed=1)
        rsk = ref.ServerKey(rck, seed=2)
        psk = shortint.ServerKey(pck, seed=2, device="cpu")
        assert (np.asarray(rsk.ksk).astype(np.uint64) == torus.to_u64(psk.ksk)).all()
        assert rsk.drift_zeros is None and psk.drift_zeros is None
        f = lambda x: (x + 3) % 16                # noqa: E731
        ro = rsk.apply_lookup_table_batch([rck.encrypt(v) for v in range(3)],
                                          rsk.generate_lookup_table(f))
        po = psk.apply_lookup_table_batch([pck.encrypt(v) for v in range(3)],
                                          psk.generate_lookup_table(f))
        assert (_words(ro) == _words(po)).all(), arm
        assert [pck.decrypt_raw(c) for c in po] == [f(v) for v in range(3)]
