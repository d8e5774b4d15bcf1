"""The rounded-key routes of K2 (v7) and K3 (v9) on the CPU, word for word
(tolerance 0; all arithmetic is integer): the kernel-layout key
(ops/bsk_prep.py RoundedKeyNtt: the NTT of the quotients b / 2^rb over
three primes, N^-1 folded in) against tfhe_tpu's prepared key data, the
plain three-prime rotations against tfhe_tpu's XLA twins of the v7 and v9
kernels and against the port's four-prime rotations on round_bsk(bsk, rb),
the CRT bound's choice of three or four primes, the wrappers' refusals,
the batch padding for C ciphertexts a block, and a server key forced into
each mode end to end."""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tfhe_tpu import shortint as ref
from tfhe_tpu.core import keygen as ref_kg
from tfhe_tpu.core import multibit as ref_mb
from tfhe_tpu.core.entities import LweBootstrapKey as RefBsk
from tfhe_tpu.core.params import DecompParams as RefDecomp
from tfhe_tpu.ops import mxu as ref_mxu
from tfhe_tpu.ops import server as ref_srv
from tfhe_tpu.shortint.params import MsNoiseReduction as RefMs
from tfhe_tpu.utils.csprng import (DeterministicSeeder, EncryptionRandomGenerator,
                                   SecretRandomGenerator)
from tfhe_tpu.utils.csprng import TUniform as RefTUniform
from tfhe_tpu_torch import shortint
from tfhe_tpu_torch.core import multibit as mb
from tfhe_tpu_torch.core.entities import LweBootstrapKey
from tfhe_tpu_torch.ops import bsk_prep, kernels, ntt, server, torus
from tfhe_tpu_torch.shortint import server_key as sk_mod
from tfhe_tpu_torch.shortint.params import MsNoiseReduction
from tfhe_tpu_torch.utils.csprng import TUniform

torch.set_num_threads(1)  # the suite runs in parallel processes: one thread each

N, N_IN = 512, 4


def _t(a) -> torch.Tensor:
    return torus.from_u64(np.asarray(a, dtype=np.uint64), "cpu")


def _i64(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).astype(np.int64))


@pytest.fixture(scope="module")
def classic_key():
    """tfhe_tpu's toy classic BSK at N = 512, base 2^23, one level."""
    gen_s = SecretRandomGenerator(123)
    lwe_sk = ref_kg.generate_binary_lwe_secret_key(N_IN, gen_s)
    glwe_sk = ref_kg.generate_binary_glwe_secret_key(1, N, gen_s)
    return ref_kg.generate_lwe_bootstrap_key(
        lwe_sk, glwe_sk, RefDecomp(23, 1), RefTUniform(3),
        EncryptionRandomGenerator(7, DeterministicSeeder(99)))


@pytest.fixture(scope="module")
def multibit_key():
    """tfhe_tpu's toy GROUP_2 multi-bit key at N = 512, base 2^22."""
    gen_s = SecretRandomGenerator(11)
    lwe_sk = ref_kg.generate_binary_lwe_secret_key(N_IN, gen_s)
    glwe_sk = ref_kg.generate_binary_glwe_secret_key(1, N, gen_s)
    gen_e = EncryptionRandomGenerator(12, DeterministicSeeder(13))
    return ref_mb.generate_multibit_bootstrap_key(
        lwe_sk, glwe_sk, RefDecomp(22, 1), 2, RefTUniform(3), gen_e)


def _four_prime(data: np.ndarray, rb: int):
    """The port's four-prime NTT key of round_bsk(data, rb) and its plan."""
    flat = LweBootstrapKey(data.reshape((-1,) + data.shape[-4:]), None)
    rounded = bsk_prep.round_bsk(flat, rb).data.reshape(data.shape)
    key, plan = mb.multibit_bsk_to_ntt(rounded)
    return torch.from_numpy(key.view(np.int32)), ntt.device_plan(plan, "cpu")


def _classic_inputs(seed, b=3):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 2 * N, (b, N_IN), dtype=np.uint64),
            rng.integers(0, 2 * N, (b,), dtype=np.uint64),
            rng.integers(0, 1 << 64, (b, 2, N), dtype=np.uint64))


# ---------------------------------------------------------------------------
# The kernel-layout key
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rb", [15, 18])
def test_quotients_are_tfhe_tpus_prepared_key_data(classic_key, rb):
    """The quotients the rounded key transforms == tfhe_tpu's _prep_bsk_data
    (round_bsk, then the signed value shifted right by rb)."""
    plan = ref_mxu.make_mxu_plan(N, num_primes=3, round_bits=rb)
    want = ref_mxu._prep_bsk_data(classic_key, plan)
    got = bsk_prep.rounded_quotients(_t(np.asarray(classic_key.data)), rb)
    assert want.dtype == np.int64 and (got.numpy() == want).all()


def test_rounded_key_is_the_ntt_of_the_quotients_with_n_inverse(classic_key):
    """Each kernel-layout word is N^-1 R times the forward NTT of the
    quotients' residues, on three primes, in (GGSW, prime, position,
    l (k+1)^2) order; canonical() gives the exact key's layout back."""
    data = np.asarray(classic_key.data)
    key = bsk_prep.rounded_key_ntt(data, 15, 23, "cpu")
    assert key.num_primes == 3 and key.data.shape == (N_IN, 3, N, 4)
    assert key.lead == (N_IN,) and key.ggsw == (1, 2, 2) and key.nbytes == N_IN * 3 * N * 16
    dp = key.dp
    q = bsk_prep.rounded_quotients(_t(data), 15)
    res = torch.stack([torch.remainder(q, p) for p in dp.plan.primes], dim=-2)
    fwd = ntt.ntt_forward(res, dp)
    back = ntt.mont_mul(key.canonical().to(torch.int64), 1, dp.ps, dp.pinvs)  # / R
    n_times = ntt.mont_mul(back, (N * (1 << 32)) % dp.ps, dp.ps, dp.pinvs)  # x N
    assert torch.equal(n_times, fwd)
    assert torch.equal(key.canonical()[:, 0, 1, 0], key.data[..., 2])


def test_shoup_twiddles_are_the_plan_twiddles_in_normal_form():
    dp = ntt.device_plan(ntt.make_plan(N, 3), "cpu")
    for pairs, table in zip(ntt.shoup_twiddles(dp),
                            (dp.plan.psi_br_stack, dp.plan.psi_inv_br_stack)):
        u = pairs.numpy().view(np.uint32).astype(object)
        for i, p in enumerate(dp.plan.primes):
            w, wq = u[i, :, 0], u[i, :, 1]
            assert all(x * (1 << 32) % p == int(t) for x, t in zip(w, table[i]))
            assert all(q == (x << 32) // p for x, q in zip(w, wq))


def test_three_prime_kernel_table_holds_the_three_prime_garner_constants():
    plan = ntt.make_plan(2048, 3)
    c = ntt.device_plan(plan, "cpu").kernel_consts.numpy()
    g = ntt.garner_consts(plan.primes)
    assert tuple(c[:3]) == plan.primes and c[3] == 0
    assert int(np.uint64(c[36].astype(np.uint64))) == math.prod(plan.primes) % (1 << 64)
    assert [int(c[40 + i]) for i in range(3)] == g["half_digits"]


# ---------------------------------------------------------------------------
# The CRT bound: three primes where it holds, four where it does not
# ---------------------------------------------------------------------------


def test_the_bound_takes_three_primes_at_the_production_sets():
    prod = shortint.V1_4_PARAM_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128
    g4 = shortint.V1_4_PARAM_GPU_MULTI_BIT_GROUP_4_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128
    v7 = bsk_prep.crt_bound(prod.pbs_base_log, 1, 2, 2048, 15)
    v9 = bsk_prep.crt_bound(g4.pbs_base_log, 1, 2, 2048, bsk_prep.mb_round_bits(g4), 4)
    assert v7.bit_length() == v9.bit_length() == 83        # below 2^83
    assert bsk_prep.crt_prime_count(v7) == bsk_prep.crt_prime_count(v9) == 3
    # tfhe_tpu's bound, on its own 3-prime rb-15 plan, with the same formula
    plan = ref_mxu.make_mxu_plan(2048, num_primes=3, round_bits=15)
    ref_mxu.assert_crt_bound(
        RefBsk(np.zeros((1, 1, 2, 2, 2048), np.uint64), RefDecomp(23, 1)),
        plan, 15)


@pytest.mark.parametrize("base_log, rb, primes", [(23, 4, 4), (30, 12, 4), (23, 15, 3)])
def test_the_bound_keeps_four_primes_where_three_do_not_hold(classic_key, base_log, rb,
                                                             primes):
    """A large base_log or a small rb puts the bound above three primes'
    product: the key keeps four, and its rotation still gives the words of
    the four-prime rotation on round_bsk(bsk, rb)."""
    data = np.asarray(classic_key.data)
    key = bsk_prep.rounded_key_ntt(data, rb, base_log, "cpu")
    assert key.num_primes == primes
    ref4, dp = _four_prime(data, rb)
    mask, body, lut = _classic_inputs(5)
    args = (_i64(mask), _i64(body), _t(lut))
    want = server.blind_rotate(*args, ref4, dp, 23, 1, trunc_acc=True)
    assert torch.equal(server.blind_rotate(*args, key, dp, 23, 1, trunc_acc=True), want)


def test_no_plan_covers_a_bound_beyond_four_primes():
    with pytest.raises(ValueError, match="no CRT plan"):
        bsk_prep.crt_prime_count(bsk_prep.crt_bound(63, 1, 5, 1 << 16, 0, 4))


# ---------------------------------------------------------------------------
# The plain rotations on the rounded key
# ---------------------------------------------------------------------------


def test_plain_v7_rotation_matches_the_tpu_twin_and_the_four_prime_rotation(classic_key):
    """server.blind_rotate on the rounded key (the plain version of K2's
    rounded-key route) == tfhe_tpu's mxu.blind_rotate_mxu_trunc (3 primes,
    rb 15) == the port's four-prime v7 rotation on round_bsk(bsk, 15)."""
    plan3 = ref_mxu.make_mxu_plan(N, num_primes=3, round_bits=15)
    m3, _ = ref_mxu.bsk_to_mxu(classic_key, plan3)
    mask, body, lut = _classic_inputs(9, b=4)
    want = np.asarray(ref_mxu.blind_rotate_mxu_trunc(
        jnp.asarray(mask), jnp.asarray(body), jnp.asarray(lut), jnp.asarray(m3), plan3, 23, 1))
    data = np.asarray(classic_key.data)
    key = bsk_prep.rounded_key_ntt(data, 15, 23, "cpu")
    args = (_i64(mask), _i64(body), _t(lut))
    got = server.blind_rotate(*args, key, None, 23, 1, trunc_acc=True)
    assert (torus.to_u64(got) == want).all()
    ref4, dp = _four_prime(data, 15)
    assert torch.equal(server.blind_rotate(*args, ref4, dp, 23, 1, trunc_acc=True), got)


def test_plain_v9_rotation_matches_the_tpu_twin_and_the_four_prime_rotation(multibit_key):
    """server.blind_rotate_multibit_v9 on the rounded key (the plain version
    of K3's rounded-key route) == tfhe_tpu's
    mxu.blind_rotate_mxu_multibit(trunc=True) on its 3-prime plan == the
    port's four-prime v9 rotation on round_bsk(key, rb)."""
    rb = 16
    plan3 = ref_mxu.make_mxu_plan(N, num_primes=3, round_bits=rb)
    m3 = ref_mxu.multibit_bsk_to_mxu(multibit_key, RefDecomp(22, 1), plan3, 2)
    rng = np.random.default_rng(21)
    raw = rng.integers(0, 1 << 64, (3, N_IN), dtype=np.uint64)
    degrees = np.asarray(ref_srv.multibit_switched_degrees(jnp.asarray(raw), 2,
                                                           N.bit_length(), raw=True))
    body = rng.integers(0, 2 * N, (3,), dtype=np.uint64)
    lut = rng.integers(0, 1 << 64, (3, 2, N), dtype=np.uint64)
    want = np.asarray(ref_mxu.blind_rotate_mxu_multibit(
        jnp.asarray(degrees), jnp.asarray(body), jnp.asarray(lut), jnp.asarray(m3), plan3,
        22, 1, 2, trunc=True))
    data = np.asarray(multibit_key)
    key = bsk_prep.rounded_key_ntt(data, rb, 22, "cpu", grouping=2)
    assert key.num_primes == 3 and key.lead == (N_IN // 2, 4)
    args = (_i64(degrees), _i64(body), _t(lut))
    got = server.blind_rotate_multibit_v9(*args, key, None, 22, 1)
    assert (torus.to_u64(got) == want).all()
    ref4, dp = _four_prime(data, rb)
    assert torch.equal(server.blind_rotate_multibit_v9(*args, ref4, dp, 22, 1), got)


# ---------------------------------------------------------------------------
# The wrappers: plain versions on the CPU, refusals, batch padding
# ---------------------------------------------------------------------------


def test_wrappers_take_the_rounded_plain_versions_on_cpu(classic_key, multibit_key):
    before = (kernels.blind_rotate.launches, kernels.blind_rotate_multibit.launches)
    key = bsk_prep.rounded_key_ntt(np.asarray(classic_key.data), 15, 23, "cpu")
    mask, body, lut = _classic_inputs(3, b=2)
    args = (_i64(mask), _i64(body), _t(lut), key, None, 23, 1)
    assert torch.equal(kernels.blind_rotate(*args, trunc_acc=True),
                       server.blind_rotate(*args, trunc_acc=True))
    mkey = bsk_prep.rounded_key_ntt(np.asarray(multibit_key), 16, 22, "cpu", grouping=2)
    deg = torch.from_numpy(np.random.default_rng(4).integers(0, 2 * N, (2, N_IN // 2, 4)))
    margs = (deg, _i64(body), _t(lut), mkey, None, 22, 1)
    assert torch.equal(kernels.blind_rotate_multibit(*margs, v9=True),
                       server.blind_rotate_multibit_v9(*margs))
    after = (kernels.blind_rotate.launches, kernels.blind_rotate_multibit.launches)
    assert after == before == (0, 0)


def test_wrappers_refuse_a_key_whose_layout_does_not_match_the_mode(classic_key,
                                                                    multibit_key):
    """A rounded key runs only the 2^32-grid rotations: exact mode, the
    single-step entry and K3's key-bundle mode refuse it, on any device."""
    key = bsk_prep.rounded_key_ntt(np.asarray(classic_key.data), 15, 23, "cpu")
    mask, body, lut = _classic_inputs(3, b=2)
    dp = ntt.device_plan(ntt.make_plan(N), "cpu")
    args = (_i64(mask), _i64(body), _t(lut), key, dp, 23, 1)
    with pytest.raises(ValueError, match="rounded key"):
        kernels.blind_rotate(*args, trunc_acc=False)
    with pytest.raises(ValueError, match="rounded key"):
        server.blind_rotate(*args, trunc_acc=False)
    with pytest.raises(ValueError, match="exact"):
        kernels.cmux_step(_t(lut), _i64(mask[:, 0]), key, dp, 23, 1)
    mkey = bsk_prep.rounded_key_ntt(np.asarray(multibit_key), 16, 22, "cpu", grouping=2)
    deg = torch.zeros((2, N_IN // 2, 4), dtype=torch.int64)
    margs = (deg, _i64(body), _t(lut), mkey, dp, 22, 1)
    with pytest.raises(ValueError, match="rounded key"):
        kernels.blind_rotate_multibit(*margs, v9=False)
    with pytest.raises(ValueError, match="rounded key"):
        server.blind_rotate_multibit(*margs)


def test_stepwise_rotation_refuses_a_rounded_key(classic_key):
    """blind_rotate_stepwise runs the exact rotation: given a server key's
    RoundedKeyNtt it raises the exact-key ValueError before any step, on
    the CPU as on the card, and launches nothing."""
    key = bsk_prep.rounded_key_ntt(np.asarray(classic_key.data), 15, 23, "cpu")
    mask, body, lut = _classic_inputs(3, b=2)
    dp = ntt.device_plan(ntt.make_plan(N), "cpu")
    before = kernels.cmux_step.launches
    with pytest.raises(ValueError, match="exact key"):
        server.blind_rotate_stepwise(_i64(mask), _i64(body), _t(lut), key, dp, 23, 1)
    meta = torch.empty((2, N_IN), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="exact key"):
        server.blind_rotate_stepwise(meta, meta[:, 0], meta, key, None, 23, 1)
    assert kernels.cmux_step.launches == before


def test_off_the_cpu_v7_and_v9_take_only_a_rounded_key():
    """Off the CPU the wrappers run v7 and v9 mode only on a RoundedKeyNtt:
    a four-prime key raises before any launch (the CPU's plain versions
    take it, as the reference)."""
    meta = torch.empty((2, N_IN), dtype=torch.int64, device="meta")
    key = torch.empty((N_IN, 1, 2, 2, 4, N), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="takes a rounded key"):
        kernels.blind_rotate(meta, meta[:, 0], meta, key, None, 23, 1, trunc_acc=True)
    deg = torch.empty((2, N_IN // 2, 4), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="takes a rounded key"):
        kernels.blind_rotate_multibit(deg, meta[:, 0], meta, key, None, 22, 1, v9=True)


def test_rounded_key_route_refuses_other_devices(classic_key):
    key = bsk_prep.rounded_key_ntt(np.asarray(classic_key.data), 15, 23, "cpu")
    meta = torch.empty((2, N_IN), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="no blind-rotation kernel"):
        kernels.blind_rotate(meta, meta[:, 0], meta, key, None, 23, 1, trunc_acc=True)


@pytest.mark.parametrize("b", [1, 2, 3, 5, 512, 513])
@pytest.mark.parametrize("per_block", [2, 4])
def test_pad_batch_fills_the_last_block_with_zero_rows(b, per_block):
    t = torch.arange(b * 6, dtype=torch.int64).reshape(b, 2, 3) + 1
    got = kernels.pad_batch(t, per_block)
    assert got.shape[0] % per_block == 0 and got.shape[0] - b < per_block
    assert got.is_contiguous() and torch.equal(got[:b], t)
    assert not got[b:].any()


# ---------------------------------------------------------------------------
# The slice: server keys forced into v7 and v9 mode on the CPU
# ---------------------------------------------------------------------------


_KW = dict(glwe_dimension=1, pbs_level=1, ks_base_log=4, ks_level=4,
           message_modulus=4, carry_modulus=4, max_noise_level=5, log2_p_fail=-3.0)


def test_server_key_in_v7_mode_matches_the_tpu_pipeline(monkeypatch):
    """A server key forced into v7 mode holds a three-prime rounded key and
    its apply_lookup_table_batch gives tfhe_tpu's v7 words (keyswitch,
    modulus switch, mxu.blind_rotate_mxu_trunc at rb 15, sample extract),
    which decrypt."""
    kw = dict(lwe_dimension=16, polynomial_size=256, pbs_base_log=23, **_KW)
    rp = ref.ShortintParams(lwe_noise=RefTUniform(3), glwe_noise=RefTUniform(3),
                            ms_noise_reduction=RefMs.NONE, **kw)
    pp = shortint.ShortintParams(lwe_noise=TUniform(3), glwe_noise=TUniform(3),
                                 ms_noise_reduction=MsNoiseReduction.NONE, **kw)
    monkeypatch.setattr(sk_mod, "uses_v7", lambda *a: True)
    rsk = ref.ServerKey(ref.ClientKey(rp, seed=0x51), seed=0x52)
    pck = shortint.ClientKey(pp, seed=0x51)
    psk = shortint.ServerKey(pck, seed=0x52, device="cpu")
    assert psk.trunc_acc and isinstance(psk.bsk_ntt, bsk_prep.RoundedKeyNtt)
    assert psk.bsk_ntt.num_primes == 3 and psk.bsk_ntt.round_bits == 15
    vals = [0, 1, 2, 3, 1]
    cts = [pck.encrypt(v) for v in vals]
    lut = psk.generate_lookup_table(lambda x: (3 * x + 1) % 16)
    outs = psk.apply_lookup_table_batch(cts, lut)
    plan3 = ref_mxu.make_mxu_plan(256, num_primes=3, round_bits=15)
    m3, _ = ref_mxu.bsk_to_mxu(rsk._bsk_coeff, plan3)
    words_in = np.stack([np.asarray(c.data) for c in cts])
    ks = ref_srv.keyswitch(jnp.asarray(words_in), rsk.ksk, 4, 4)
    lut_b = np.broadcast_to(lut.acc, (len(vals),) + lut.acc.shape)
    acc = ref_mxu.blind_rotate_mxu_trunc(
        ref_srv.modulus_switch(ks[:, :-1], 9), ref_srv.modulus_switch(ks[:, -1], 9),
        jnp.asarray(lut_b), jnp.asarray(m3), plan3, 23, 1)
    want = np.asarray(ref_srv.sample_extract(acc))
    assert [pck.decrypt_raw(o) for o in outs] == [(3 * v + 1) % 16 for v in vals]
    assert (np.stack([np.asarray(o.data) for o in outs]) == want).all()


def test_server_key_in_v9_mode_matches_the_tpu_pipeline(monkeypatch):
    """A multi-bit server key forced into v9 mode holds a three-prime
    rounded key of the flattened indicator GGSWs, and its
    apply_lookup_table_batch gives tfhe_tpu's v9 words (keyswitch, centered
    modulus switch, mxu.blind_rotate_mxu_multibit(trunc=True) on a 3-prime
    plan at the same rb, sample extract), which decrypt."""
    kw = dict(lwe_dimension=8, polynomial_size=N, pbs_base_log=22, grouping_factor=4,
              **_KW)
    rp = ref.MultiBitPBSParameters(lwe_noise=RefTUniform(3), glwe_noise=RefTUniform(3), **kw)
    pp = shortint.MultiBitPBSParameters(lwe_noise=TUniform(3), glwe_noise=TUniform(3), **kw)
    monkeypatch.setattr(sk_mod, "uses_v9", lambda *a: True)
    rsk = ref.ServerKey(ref.ClientKey(rp, seed=0x61), seed=0x62)
    pck = shortint.ClientKey(pp, seed=0x61)
    psk = shortint.ServerKey(pck, seed=0x62, device="cpu")
    rb = bsk_prep.mb_round_bits(pp)
    assert rb and psk.trunc_acc and isinstance(psk.bsk_ntt, bsk_prep.RoundedKeyNtt)
    assert psk.bsk_ntt.num_primes == 3 and psk.bsk_ntt.round_bits == rb
    assert psk.bsk_ntt.lead == (2, 16)
    vals = [0, 1, 2, 3]
    cts = [pck.encrypt(v) for v in vals]
    lut = psk.generate_lookup_table(lambda x: (3 * x + 1) % 16)
    outs = psk.apply_lookup_table_batch(cts, lut)
    plan3 = ref_mxu.make_mxu_plan(N, num_primes=3, round_bits=rb)
    m3 = ref_mxu.multibit_bsk_to_mxu(rsk._mb_bsk_coeff, RefDecomp(22, 1), plan3, 4)
    log_mod = N.bit_length()
    words_in = np.stack([np.asarray(c.data) for c in cts])
    ks = ref_srv.keyswitch(jnp.asarray(words_in), rsk.ksk, 4, 4)
    body = ks[:, -1] + ref_srv.centered_binary_ms_correction(ks, log_mod)
    lut_b = np.broadcast_to(lut.acc, (len(vals),) + lut.acc.shape)
    acc = ref_mxu.blind_rotate_mxu_multibit(
        ref_srv.multibit_switched_degrees(ks[:, :-1], 4, log_mod),
        ref_srv.modulus_switch(body, log_mod), jnp.asarray(lut_b), jnp.asarray(m3),
        plan3, 22, 1, 4, trunc=True)
    want = np.asarray(ref_srv.sample_extract(acc))
    assert (np.stack([np.asarray(o.data) for o in outs]) == want).all()
    assert [pck.decrypt_raw(o) for o in outs] == [(3 * v + 1) % 16 for v in vals]
