"""ops/server.py of the port against tfhe_tpu/ops/server.py (and the v7
twin in tfhe_tpu/ops/mxu.py), word for word: the same numpy inputs through
both, tolerance 0 on every u64 torus word.  Also: the kernel wrappers of
ops/kernels.py run the plain versions on CPU tensors and count nothing."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tfhe_tpu.core import keygen as ref_kg
from tfhe_tpu.core.params import DecompParams as RefDecomp
from tfhe_tpu.ops import mxu as ref_mxu
from tfhe_tpu.ops import server as ref_srv
from tfhe_tpu.utils.csprng import (DeterministicSeeder, EncryptionRandomGenerator,
                                   SecretRandomGenerator, TUniform)
from tfhe_tpu_torch.core import keygen as kg
from tfhe_tpu_torch.core.entities import LweBootstrapKey
from tfhe_tpu_torch.core.params import DecompParams
from tfhe_tpu_torch.ops import bsk_prep, kernels, ntt, server, torus

torch.set_num_threads(1)  # the suite runs in parallel processes: one thread each

# the toy blind-rotation set of tests/test_mxu.py and tests/test_trunc_acc.py
N, N_IN, K_GLWE = 512, 4, 1
BASE_LOG, LEVELS = 23, 1


def _t(a) -> torch.Tensor:
    return torus.from_u64(np.asarray(a, dtype=np.uint64), "cpu")


def _np(t) -> np.ndarray:
    return torus.to_u64(t)


def _rand_u64(rng, shape):
    return rng.integers(0, 1 << 64, shape, dtype=np.uint64)


@pytest.fixture(scope="module")
def bsk():
    """The reference's coefficient-domain toy BSK (same seeds as
    tests/test_mxu.py)."""
    gen_s = SecretRandomGenerator(123)
    lwe_sk = ref_kg.generate_binary_lwe_secret_key(N_IN, gen_s)
    glwe_sk = ref_kg.generate_binary_glwe_secret_key(K_GLWE, N, gen_s)
    gen_e = EncryptionRandomGenerator(7, DeterministicSeeder(99))
    return ref_kg.generate_lwe_bootstrap_key(
        lwe_sk, glwe_sk, RefDecomp(BASE_LOG, LEVELS), TUniform(3), gen_e)


@pytest.fixture(scope="module")
def exact_keys(bsk):
    """(reference NTT key + plan, port NTT key + device plan), exact mode."""
    ref_mont, ref_plan = ref_kg.bootstrap_key_to_ntt(bsk)
    mine, plan = kg.bootstrap_key_to_ntt(
        LweBootstrapKey(bsk.data, DecompParams(BASE_LOG, LEVELS)))
    key = torch.from_numpy(mine.view(np.int32))
    return ref_mont, ref_plan, key, ntt.device_plan(plan, "cpu")


# ---------------------------------------------------------------------------
# Decomposition, keyswitch, modulus switch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("base_log,levels", [(4, 4), (23, 1), (3, 5), (15, 2),
                                             (8, 2), (1, 1)])
def test_signed_decompose_matches(base_log, levels):
    rng = np.random.default_rng(base_log * 10 + levels)
    x = np.concatenate([_rand_u64(rng, 200), np.array(
        [0, 1, (1 << 63) - 1, 1 << 63, (1 << 64) - 1, 0xFFFF << 48],
        dtype=np.uint64)])
    want = np.asarray(ref_srv.signed_decompose(jnp.asarray(x), base_log, levels))
    got = server.signed_decompose(_t(x), base_log, levels)
    assert got.shape == (levels, x.size)
    assert (_np(got) == want).all()
    assert int(got.abs().max()) <= 1 << (base_log - 1)


@pytest.mark.parametrize("b,n_in,levels,base_log,n_out", [
    (3, 40, 4, 4, 16), (5, 32, 2, 8, 9), (1, 17, 5, 3, 4)])
def test_keyswitch_matches(b, n_in, levels, base_log, n_out):
    rng = np.random.default_rng(n_in)
    ct = _rand_u64(rng, (b, n_in + 1))
    ksk = _rand_u64(rng, (n_in, levels, n_out + 1))
    want = np.asarray(ref_srv.keyswitch(jnp.asarray(ct), jnp.asarray(ksk),
                                        base_log, levels))
    assert (_np(server.keyswitch(_t(ct), _t(ksk), base_log, levels)) == want).all()


@pytest.mark.parametrize("log_mod", [9, 10, 12])
def test_modulus_switch_matches(log_mod):
    rng = np.random.default_rng(log_mod)
    x = np.concatenate([_rand_u64(rng, 300),
                        np.array([0, (1 << 64) - 1, 1 << 63], dtype=np.uint64)])
    want = np.asarray(ref_srv.modulus_switch(jnp.asarray(x), log_mod))
    got = server.modulus_switch(_t(x), log_mod)
    assert (_np(got) == want).all()
    assert int(got.min()) >= 0 and int(got.max()) < 1 << log_mod


@pytest.mark.parametrize("log_mod", [10, 12])
def test_centered_ms_correction_both_parities(log_mod):
    """Mask coefficients a few units either side of the switched grid give
    signed rounding errors of both parities and both signs."""
    rng = np.random.default_rng(log_mod + 100)
    shift = 64 - log_mod
    offsets = np.array([-5, -4, -3, -2, -1, 0, 1, 2, 3, 4, 5,
                        (1 << (shift - 1)) - 1, -(1 << (shift - 1)) + 1],
                       dtype=np.int64)
    grid = rng.integers(0, 1 << log_mod, (6, offsets.size), dtype=np.uint64)
    with np.errstate(over="ignore"):
        mask = (grid << np.uint64(shift)) + rng.permuted(
            np.tile(offsets, (6, 1)), axis=1).astype(np.uint64)
    ct = np.concatenate([mask, _rand_u64(rng, (6, 1))], axis=1)
    err = ((np.asarray(ref_srv.modulus_switch(jnp.asarray(mask), log_mod))
            << np.uint64(shift)) - mask).astype(np.int64)
    assert (err % 2 == 1).any() and (err % 2 == 0).any()
    assert (err < 0).any() and (err > 0).any()
    want = np.asarray(ref_srv.centered_binary_ms_correction(jnp.asarray(ct), log_mod))
    got = server.centered_binary_ms_correction(_t(ct), log_mod)
    assert (_np(got) == want).all()


# ---------------------------------------------------------------------------
# Monomials, sample extract, LUT generation
# ---------------------------------------------------------------------------


DEGREES = [0, 1, 7, N - 1, N, N + 1, 2 * N - 1]


@pytest.mark.parametrize("op", ["monomial_mul", "monomial_div"])
def test_monomials_match(op):
    rng = np.random.default_rng(6)
    poly = _rand_u64(rng, (len(DEGREES), 2, N))
    deg = np.array(DEGREES, dtype=np.uint64)
    want = np.asarray(getattr(ref_srv, op)(jnp.asarray(poly),
                                           jnp.asarray(deg)[:, None, None]))
    got = getattr(server, op)(_t(poly), torch.from_numpy(deg.astype(np.int64))[:, None, None])
    assert (_np(got) == want).all()


def test_monomial_div_inverts_mul():
    rng = np.random.default_rng(7)
    poly = _t(_rand_u64(rng, (len(DEGREES), 1, N)))
    deg = torch.tensor(DEGREES)[:, None, None]
    assert torch.equal(server.monomial_div(server.monomial_mul(poly, deg), deg), poly)


@pytest.mark.parametrize("k1", [2, 3])
def test_sample_extract_matches(k1):
    glwe = _rand_u64(np.random.default_rng(k1), (3, k1, 64))
    want = np.asarray(ref_srv.sample_extract(jnp.asarray(glwe)))
    assert (_np(server.sample_extract(_t(glwe))) == want).all()


@pytest.mark.parametrize("n_poly,mod,f", [
    (512, 16, lambda x: (3 * x + 1) % 16), (512, 16, lambda x: x % 4),
    (2048, 16, lambda x: x), (256, 4, lambda x: 3 - x)])
def test_generate_lut_matches(n_poly, mod, f):
    delta = (1 << 64) // (2 * mod)
    want = ref_srv.generate_lut(n_poly, 2, mod, delta, f)
    got = server.generate_lut(n_poly, 2, mod, delta, f)
    assert got.dtype == np.uint64 and (got == np.asarray(want)).all()


# ---------------------------------------------------------------------------
# External product and the two blind rotations
# ---------------------------------------------------------------------------


def test_external_product_matches(exact_keys):
    ref_mont, ref_plan, key, dp = exact_keys
    glwe = _rand_u64(np.random.default_rng(8), (3, K_GLWE + 1, N))
    ref_ep = jax.jit(ref_srv.external_product_ntt,
                     static_argnames=("plan", "base_log", "levels"))
    want = np.asarray(ref_ep(
        jnp.asarray(glwe), jnp.asarray(ref_mont[1]).astype(jnp.uint64),
        plan=ref_plan, base_log=BASE_LOG, levels=LEVELS))
    got = server.external_product(_t(glwe), key[1], dp, BASE_LOG, LEVELS)
    assert (_np(got) == want).all()


def _rotation_inputs(seed, b=4, aligned=False):
    rng = np.random.default_rng(seed)
    mask = rng.integers(0, 2 * N, (b, N_IN), dtype=np.uint64)
    body = rng.integers(0, 2 * N, (b,), dtype=np.uint64)
    lut = _rand_u64(rng, (b, K_GLWE + 1, N))
    if aligned:   # delta-aligned, as real accumulators are
        lut &= np.uint64(0xFFFFFFFF00000000)
    return mask, body, lut


def _torch_rotation_args(mask, body, lut):
    return (torch.from_numpy(mask.astype(np.int64)),
            torch.from_numpy(body.astype(np.int64)), _t(lut))


def test_exact_blind_rotate_matches(exact_keys):
    ref_mont, ref_plan, key, dp = exact_keys
    mask, body, lut = _rotation_inputs(11)
    want = np.asarray(ref_srv.blind_rotate(
        jnp.asarray(mask), jnp.asarray(body), jnp.asarray(lut),
        jnp.asarray(ref_mont), ref_plan, BASE_LOG, LEVELS))
    got = server.blind_rotate(*_torch_rotation_args(mask, body, lut), key, dp,
                              BASE_LOG, LEVELS)
    assert (_np(got) == want).all()


def test_v7_blind_rotate_matches_mxu_trunc(bsk):
    """Exact rotation on round_bsk(bsk, 15) with the 2^32-grid rounding ==
    the TPU production kernel's twin, mxu.blind_rotate_mxu_trunc (3 primes)."""
    plan3 = ref_mxu.make_mxu_plan(N, num_primes=3, round_bits=15)
    m3, _ = ref_mxu.bsk_to_mxu(bsk, plan3)
    mask, body, lut = _rotation_inputs(21, aligned=True)
    want = np.asarray(ref_mxu.blind_rotate_mxu_trunc(
        jnp.asarray(mask), jnp.asarray(body), jnp.asarray(lut),
        jnp.asarray(m3), plan3, BASE_LOG, LEVELS))
    rounded = bsk_prep.round_bsk(
        LweBootstrapKey(bsk.data, DecompParams(BASE_LOG, LEVELS)), 15)
    key_np, plan = kg.bootstrap_key_to_ntt(rounded)
    got = server.blind_rotate(*_torch_rotation_args(mask, body, lut),
                              torch.from_numpy(key_np.view(np.int32)),
                              ntt.device_plan(plan, "cpu"), BASE_LOG, LEVELS,
                              trunc_acc=True)
    assert (_np(got) & np.uint64(0xFFFFFFFF) == 0).all()
    assert (_np(got) == want).all()


@pytest.mark.parametrize("centered", [False, True])
def test_ks_pbs_batch_matches(exact_keys, centered):
    ref_mont, ref_plan, key, dp = exact_keys
    rng = np.random.default_rng(30 + centered)
    n_big, b = K_GLWE * N, 4
    ct = _rand_u64(rng, (b, n_big + 1))
    ksk = _rand_u64(rng, (n_big, 2, N_IN + 1))
    lut = _rand_u64(rng, (b, K_GLWE + 1, N)) & np.uint64(0xFFFFFFFF00000000)
    want = np.asarray(ref_srv.ks_pbs_batch(
        jnp.asarray(ct), jnp.asarray(lut), jnp.asarray(ksk),
        jnp.asarray(ref_mont), ref_plan, 8, 2, BASE_LOG, LEVELS, 64, centered))
    got = server.ks_pbs_batch(_t(ct), _t(lut), _t(ksk), key, dp, 8, 2,
                              BASE_LOG, LEVELS, centered_ms=centered)
    assert got.shape == (b, n_big + 1)
    assert (_np(got) == want).all()


# ---------------------------------------------------------------------------
# Kernel wrappers on CPU tensors
# ---------------------------------------------------------------------------


def test_wrappers_take_the_plain_versions_on_cpu(exact_keys):
    _, _, key, dp = exact_keys
    before = (kernels.keyswitch.launches, kernels.blind_rotate.launches)
    rng = np.random.default_rng(40)
    ct, ksk = _t(_rand_u64(rng, (3, 33))), _t(_rand_u64(rng, (32, 4, 9)))
    assert torch.equal(kernels.keyswitch(ct, ksk, 4, 4),
                       server.keyswitch(ct, ksk, 4, 4))
    args = _torch_rotation_args(*_rotation_inputs(41, b=2)) + (key, dp,
                                                               BASE_LOG, LEVELS)
    for trunc in (False, True):
        assert torch.equal(kernels.blind_rotate(*args, trunc_acc=trunc),
                           server.blind_rotate(*args, trunc_acc=trunc))
    assert (kernels.keyswitch.launches, kernels.blind_rotate.launches) == before
    assert before == (0, 0)


def test_wrappers_refuse_other_devices():
    meta = torch.empty((2, 5), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="no keyswitch kernel"):
        kernels.keyswitch(meta, meta, 4, 1)


def test_kernel_constant_table_layout():
    """The packed table csrc/blind_rotate.cu reads: primes, -p^-1 mod 2^32,
    N^-1 and the Garner constants at their documented slots."""
    plan = ntt.make_plan(2048, 4)
    c = ntt.device_plan(plan, "cpu").kernel_consts.numpy()
    g = ntt.garner_consts(plan.primes)
    assert tuple(c[:4]) == plan.primes
    assert all((int(c[4 + i]) * p) % (1 << 32) == (1 << 32) - 1
               for i, p in enumerate(plan.primes))
    assert [int(c[12 + j]) for j in range(1, 4)] == [g["inv_mont"][j] for j in range(1, 4)]
    assert int(np.uint64(c[36].astype(np.uint64))) == g["P_mod64"]
    assert [int(c[40 + i]) for i in range(4)] == g["half_digits"]
