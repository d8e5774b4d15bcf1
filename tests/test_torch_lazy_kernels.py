"""The host-side pieces and the arithmetic of K5's and K3's exact lazy
kernels (csrc/blind_rotate128.cu, csrc/blind_rotate_multibit.cu) on the
CPU, word for word against tfhe_tpu (tolerance 0; all arithmetic is
integer): the Shoup twiddle pairs of the six- and four-prime plans, the
lazy butterfly schedule they drive (residues kept in [0, 4p)), the
64-bit sums reduced once every four products, the one-period monomial
table K3's kernel keeps in shared memory, and the zero rows that pad a
batch to the kernel's two ciphertexts a block."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tfhe_tpu.core import keygen as ref_kg
from tfhe_tpu.core import multibit as ref_mb
from tfhe_tpu.core.params import DecompParams as RefDecomp
from tfhe_tpu.ops import ntt as ref_ntt
from tfhe_tpu.ops import server as ref_srv
from tfhe_tpu.utils.csprng import (DeterministicSeeder, EncryptionRandomGenerator,
                                   SecretRandomGenerator)
from tfhe_tpu.utils.csprng import TUniform as RefTUniform
from tfhe_tpu_torch.core import multibit as mb
from tfhe_tpu_torch.ops import kernels, ntt, server, torus

torch.set_num_threads(1)  # the suite runs in parallel processes: one thread each

M32 = (1 << 32) - 1
# (N, primes): K5's production and TEST squashing plans, K3's exact plan
PLANS = ((2048, 6), (512, 6), (2048, 4))


def _pairs(n, nprimes):
    """The port's forward and inverse Shoup pairs as (P, N, 2) uint64."""
    dp = ntt.device_plan(ntt.make_plan(n, nprimes), "cpu")
    return tuple(t.numpy().view(np.uint32).astype(np.uint64) for t in ntt.shoup_twiddles(dp))


def _shoup(y, w, wq, p):
    """csrc/ntt_common.cuh shoup_mul: W y - floor(W' y / 2^32) p mod 2^32."""
    return ((w * y) - ((wq * y) >> 32) * p) & M32


def _reduce_to(x, m):
    """ntt_common.cuh reduce_to: [0, 2m) -> [0, m)."""
    return np.where(x >= m, x - m, x)


def _redc_lazy(t, p, pinv):
    """ntt_common.cuh redc_lazy on t < p 2^32 (Python ints or uint64 arrays
    whose sums stay below 2^64): t R^-1 mod p in [0, 2p)."""
    m = ((t & M32) * pinv) & M32
    return (t + m * p) >> 32


def _lazy_forward(x, w, wq, p):
    """Every forward stage as lazy_forward_stages runs it (Cooley-Tukey,
    natural -> bit-reversed), x (..., N) in [0, 4p); returns [0, 4p)."""
    n = x.shape[-1]
    m, t = 1, n
    while m < n:
        t //= 2
        xv = x.reshape(x.shape[:-1] + (m, 2, t))
        u = _reduce_to(xv[..., 0, :], 2 * p)
        s = _shoup(xv[..., 1, :], w[m:2 * m, None], wq[m:2 * m, None], p)
        x = np.stack([u + s, (u - s + 2 * p) & M32], axis=-2).reshape(x.shape)
        assert (x < 4 * p).all()
        m *= 2
    return x


def _lazy_inverse(x, w, wq, p):
    """Every inverse stage as lazy_inverse_stages runs it (Gentleman-Sande,
    bit-reversed -> natural, no N^-1), x in [0, 2p); returns [0, 2p)."""
    n = x.shape[-1]
    t, m = 1, n
    while m > 1:
        h = m // 2
        xv = x.reshape(x.shape[:-1] + (h, 2, t))
        a, b = xv[..., 0, :], xv[..., 1, :]
        lo = _reduce_to(a + b, 2 * p)
        hi = _shoup((a - b + 2 * p) & M32, w[h:2 * h, None], wq[h:2 * h, None], p)
        x = np.stack([lo, hi], axis=-2).reshape(x.shape)
        assert (x < 2 * p).all()
        t *= 2
        m = h
    return x


@pytest.mark.parametrize("n,nprimes", PLANS)
def test_shoup_pairs_match_tfhe_tpu_twiddles(n, nprimes):
    """(W, floor(W 2^32 / p)) with W the normal form of tfhe_tpu's
    Montgomery twiddle psi^br R, and W y mod p through the pair."""
    ref = ref_ntt.make_plan(n, nprimes)
    fwd, inv = _pairs(n, nprimes)
    rng = np.random.default_rng(n + nprimes)
    for i, p in enumerate(ref.primes):
        rinv = pow(1 << 32, -1, p)
        for pairs, table in ((fwd, ref.psi_br_stack), (inv, ref.psi_inv_br_stack)):
            w = np.array([int(v) * rinv % p for v in table[i]], dtype=np.uint64)
            assert (pairs[i, :, 0] == w).all()
            assert (pairs[i, :, 1] == (w << np.uint64(32)) // np.uint64(p)).all()
            y = rng.integers(0, 1 << 32, n, dtype=np.uint64)
            got = _shoup(y, pairs[i, :, 0], pairs[i, :, 1], np.uint64(p))
            assert (got < 2 * p).all()
            assert (got % np.uint64(p) == (w * (y % np.uint64(p))) % np.uint64(p)).all()


@pytest.mark.parametrize("n,nprimes", PLANS)
def test_lazy_stages_from_signed_digits_match_tfhe_tpu_transforms(n, nprimes):
    """The first pass's residues d + 2p of signed digits |d| <= 2^30, every
    forward stage lazy, reduced once: tfhe_tpu's forward NTT of the digits;
    the inverse stages on [0, 2p) inputs, reduced, times N^-1 in Garner's
    Montgomery product: tfhe_tpu's inverse NTT."""
    ref = ref_ntt.make_plan(n, nprimes)
    fwd, inv = _pairs(n, nprimes)
    rng = np.random.default_rng(7 * n + nprimes)
    digits = rng.integers(-(1 << 30), (1 << 30) + 1, (3, n))
    digits[0, :4] = (-(1 << 30), 1 << 30, 0, -1)
    for i, p in enumerate(ref.primes):
        pp = ref.plans[i]
        p64 = np.uint64(p)
        res = ((digits + 2 * p) & M32).astype(np.uint64)
        assert (res < 4 * p).all()
        got = _reduce_to(_reduce_to(_lazy_forward(res, fwd[i, :, 0], fwd[i, :, 1], p64),
                                    2 * p64), p64)
        want = ref_ntt.ntt_forward((digits % p).astype(np.uint64), ref, i, np)
        assert (got == want).all()
        x = rng.integers(0, 2 * p, (3, n), dtype=np.uint64)
        y = _reduce_to(_lazy_inverse(x, inv[i, :, 0], inv[i, :, 1], p64), p64)
        got = ref_ntt.mont_mul(y, pp.n_inv_mont, p64, pp.p_inv_neg32, np)
        want = ref_ntt.ntt_inverse(x % p64, ref, i, np)
        assert (got == want).all()


@pytest.mark.parametrize("p", ntt.PRIMES)
def test_lazy_sum_bounds_hold_for_every_prime(p):
    """What the lazy kernels assume of each port prime: d + 2p lies in
    [0, 4p) for every digit |d| <= 2^30, four products of canonical
    residues stay below p 2^32 (one redc_lazy a group of four), and a
    redc_lazy result plus a value below 2p stays below 4p < 2^32."""
    assert 2 * p >= 1 << 30 and 2 * p + (1 << 30) < 4 * p < 1 << 32
    assert 4 * (p - 1) ** 2 < p << 32
    assert 5 * (p - 1) ** 2 >= p << 32 or p < 1 << 29


def _chunked(products, p, pinv, start):
    """Sum the products four at a time in 64 bits, each group reduced once
    and added to the running [0, 2p) value start (the kernels' key product
    and bundle)."""
    acc = start
    for k in range(0, len(products), 4):
        t = sum(products[k:k + 4])
        assert t < p << 32
        acc = acc + _redc_lazy(t, p, pinv)
        acc = acc - 2 * p if acc >= 2 * p else acc
        assert acc < 2 * p
    return acc


@pytest.mark.parametrize("terms", [9, 15, 3])
def test_chunked_montgomery_sums_equal_the_fully_reduced_chain(terms):
    """K5's key product (nine rows), K3's bundle (fifteen patterns after
    E_0) and K3's GROUP_2 bundle (three): the chunked lazy sum is congruent
    to the chain of fully reduced Montgomery products and additions that
    the plain versions compute."""
    rng = np.random.default_rng(terms)
    for i, p in enumerate(ntt.PRIMES[:6]):
        pinv = (-pow(p, -1, 1 << 32)) % (1 << 32)
        rinv = pow(1 << 32, -1, p)
        for _ in range(20):
            a = [int(v) for v in rng.integers(0, p, terms)]
            b = [int(v) for v in rng.integers(0, p, terms)]
            e0 = int(rng.integers(0, p))
            got = _chunked([x * y for x, y in zip(a, b)], p, pinv, e0)
            want = (e0 + sum(x * y * rinv for x, y in zip(a, b))) % p
            assert got % p == want


def test_monomial_table_has_period_two_n():
    """K3's exact kernel copies the first 2N entries of each prime's row of
    the monomial table and indexes it mod 2N: psi has order 2N, so entry
    e and e + 2N agree; the table is tfhe_tpu's word for word."""
    n = 2048
    dp = ntt.device_plan(ntt.make_plan(n, 4), "cpu")
    table, odd = server.monomial_table(dp)
    table = table.numpy().astype(np.uint64)
    ref_table, ref_br = ref_mb.monomial_ntt_tables(n, 4)
    assert (table == np.asarray(ref_table)).all()
    assert (odd.numpy() == 2 * np.asarray(ref_br) + 1).all()
    assert (table[:, :2 * n] == table[:, 2 * n:]).all()


def _ref_key(n_in, grouping, n_poly, base_log, seed=11):
    gen_s = SecretRandomGenerator(seed)
    lwe_sk = ref_kg.generate_binary_lwe_secret_key(n_in, gen_s)
    glwe_sk = ref_kg.generate_binary_glwe_secret_key(1, n_poly, gen_s)
    gen_e = EncryptionRandomGenerator(seed + 1, DeterministicSeeder(seed + 2))
    return ref_mb.generate_multibit_bootstrap_key(
        lwe_sk, glwe_sk, RefDecomp(base_log, 1), grouping, RefTUniform(3), gen_e)


@pytest.mark.parametrize("b", [1, 3])
def test_zero_rows_padding_the_exact_multibit_batch_leave_the_rest_unchanged(b):
    """K3's exact wrapper pads the batch with zero rows to the lazy
    kernel's two ciphertexts a block and drops their results: the plain
    rotation of the padded batch, cut back, is tfhe_tpu's rotation of the
    batch."""
    n_poly, base_log, grouping, n_in = 256, 22, 2, 4
    key = _ref_key(n_in, grouping, n_poly, base_log)
    ref_mont, ref_plan = ref_mb.multibit_bsk_to_ntt(key)
    mine, plan = mb.multibit_bsk_to_ntt(key)
    rng = np.random.default_rng(b)
    mask = rng.integers(0, 1 << 64, (b, n_in), dtype=np.uint64)
    body = rng.integers(0, 2 * n_poly, (b,), dtype=np.uint64)
    lut = rng.integers(0, 1 << 64, (b, 2, n_poly), dtype=np.uint64)
    degrees = np.asarray(ref_srv.multibit_switched_degrees(
        jnp.asarray(mask), grouping, n_poly.bit_length(), raw=True))
    want = np.asarray(ref_srv.blind_rotate_multibit(
        jnp.asarray(degrees), jnp.asarray(body), jnp.asarray(lut), jnp.asarray(ref_mont),
        ref_plan, base_log, 1, grouping))
    pad = lambda a: kernels.pad_batch(a, 2)  # noqa: E731
    got = server.blind_rotate_multibit(
        pad(torch.from_numpy(degrees.astype(np.int64))),
        pad(torch.from_numpy(body.astype(np.int64))),
        pad(torus.from_u64(lut, "cpu")), torch.from_numpy(mine.view(np.int32)),
        ntt.device_plan(plan, "cpu"), base_log, 1)
    assert got.shape[0] == b + b % 2
    assert (torus.to_u64(got[:b]) == want).all()
