"""The arithmetic of K1's tensor-core kernel and K2's lazy exact kernel
(csrc/keyswitch.cu keyswitch_imma_kernel, csrc/blind_rotate.cu
blind_rotate_exact_lazy_kernel) as plain numpy models on the CPU, word for
word against tfhe_tpu (tolerance 0; all arithmetic is integer).

K1: signed digits decomposed in 32 bits from each word's high word, s8
digits times the u8 byte limbs of ops/kernels.py's key layout
(keyswitch_key_limbs), s32 sums chunk by chunk, recombined mod 2^64, for
every keyswitch (base_log, levels) pair of shortint/params.py; the s32
range guard of the model; and the key's owner form on the CPU
(keyswitch_key, KeyswitchKeyLimbs).  K2: the fused first pass (rotation,
one-level digit from the high word, residues d + 2p), lazy forward stages,
the two-product key sum reduced once, lazy inverse stages, N^-1 and Garner
added into the u64 accumulator, over whole rotations, on a batch padded
with zero rows to the kernel's two ciphertexts a block, and one step (the
step entry's n_steps = 1 launch).  The kernels' own shape predicates
(csrc/keyswitch.cu imma_shape, csrc/blind_rotate.cu exact_lazy_shape) live
in the CUDA sources; chip_smoke.py holds them against the same sets on the
card."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tfhe_tpu.ops import ntt as ref_ntt
from tfhe_tpu.ops import server as ref_srv
from tfhe_tpu_torch import shortint
from tfhe_tpu_torch.ops import kernels, ntt, server, torus

M32 = (1 << 32) - 1
PARAM_SETS = [v for k, v in vars(shortint.params).items()
              if isinstance(v, (shortint.params.ShortintParams,
                                shortint.params.MultiBitPBSParameters))]
KS_PAIRS = sorted({(p.ks_base_log, p.ks_level) for p in PARAM_SETS})
# K1's tensor-core kernel's digit positions a chunk and limb columns a
# block (csrc/keyswitch.cu IM_KC, IM_BN)
IM_KC, IM_BN = 128, 256


def _i64(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).astype(np.int64))


# ---------------------------------------------------------------------------
# K1: limb-form keyswitch
# ---------------------------------------------------------------------------


def _hi_digits(words, base_log, levels):
    """keyswitch.cu hi_decomposer_state / hi_next_digit: the signed digits
    (levels, ...) of u64 words, lowest level first, from their high words
    alone in 32-bit arithmetic (base_log levels <= 30)."""
    rep = base_log * levels
    res = (np.asarray(words, dtype=np.uint64) >> np.uint64(63 - rep)).astype(np.int64)
    rounding_bit = res & 1
    res = ((res + 1) >> 1) & ((1 << rep) - 1)
    nb = (((res - 1) | (rounding_bit << (rep - 1))) & res) >> (rep - 1)
    state = res - (nb << rep)
    assert (np.abs(state) < 1 << 31).all()
    digits = []
    for _ in range(levels):
        r = state & ((1 << base_log) - 1)
        state = state >> base_log
        carry = (((r - 1) | state) & r) >> (base_log - 1)
        state = state + carry
        digits.append(r - (carry << base_log))
    return np.stack(digits)


def _limb_guard(n_in, levels, base_log):
    """The shapes the limb model takes: s8 digits, a decomposition read
    from the high word (base_log l <= 30), 128 / l whole coefficients a
    chunk (2 <= l <= 8), and every limb sum exact in s32 with every digit
    at -2^(base_log-1) and every key byte 255."""
    return (1 <= base_log <= 7 and 2 <= levels <= 8 and base_log * levels <= 30
            and n_in * levels * (1 << (base_log - 1)) * 255 < 1 << 31)


def _limb_keyswitch(ct, ksk, base_log, levels):
    """The tensor-core kernel's function on numpy u64 inputs: digits into
    (B, chunks, 128) s8 tiles, key limbs from kernels.keyswitch_key_limbs,
    per-chunk s8 x u8 sums accumulated in s32 (checked), each output word
    body - sum_j sext(s_j) << 8j mod 2^64.  Returns (output, the largest
    |s32| partial sum)."""
    b = ct.shape[0]
    n_in, _, m_out = ksk.shape
    limbs = kernels.keyswitch_key_limbs(torus.from_u64(ksk, "cpu"), levels, IM_KC,
                                        IM_BN).numpy()
    chunks, cols, width = limbs.shape
    per = width // levels
    digits = _hi_digits(ct[:, :-1], base_log, levels)            # (l, B, n_in)
    assert (np.abs(digits) <= 1 << (base_log - 1)).all()
    tiles = np.zeros((b, chunks * per, levels), dtype=np.int64)
    tiles[:, :n_in] = digits.transpose(1, 2, 0)
    tiles = tiles.reshape(b, chunks, per * levels)
    assert (tiles.astype(np.int8) == tiles).all()
    sums = np.zeros((b, cols), dtype=np.int64)
    peak = 0
    for c in range(chunks):
        sums += tiles[:, c] @ limbs[c, :, :per * levels].astype(np.int64).T
        peak = max(peak, int(np.abs(sums).max()))
    assert peak < 1 << 31
    words = np.zeros((b, m_out), dtype=np.uint64)
    for j in range(8):
        words += sums[:, j:8 * m_out:8].astype(np.uint64) << np.uint64(8 * j)
    out = np.zeros((b, m_out), dtype=np.uint64) - words
    out[:, -1] += ct[:, -1]
    return out, peak


@pytest.mark.parametrize("base_log,levels", KS_PAIRS)
def test_limb_keyswitch_matches_tfhe_tpu(base_log, levels):
    """Every keyswitch pair of the port's sets: the limb form (two chunks,
    the second part-filled, and a part-filled last column tile) gives
    tfhe_tpu's keyswitch words, and the kernel's 32-bit digits are
    tfhe_tpu's signed decomposition."""
    rng = np.random.default_rng(100 * base_log + levels)
    b, n_in, m_out = 5, 150 // levels + 7, 37
    ct = rng.integers(0, 1 << 64, (b, n_in + 1), dtype=np.uint64)
    ct[0, :4] = (0, (1 << 64) - 1, 1 << 63, (1 << 63) - (1 << (63 - base_log * levels)))
    ksk = rng.integers(0, 1 << 64, (n_in, levels, m_out), dtype=np.uint64)
    want = np.asarray(ref_srv.keyswitch(jnp.asarray(ct), jnp.asarray(ksk), base_log, levels))
    got, _ = _limb_keyswitch(ct, ksk, base_log, levels)
    assert (got == want).all()
    ref_digits = np.asarray(ref_srv.signed_decompose(jnp.asarray(ct[:, :-1]), base_log, levels))
    assert (_hi_digits(ct[:, :-1], base_log, levels).astype(np.uint64) == ref_digits).all()
    assert _limb_guard(n_in, levels, base_log)


def test_limb_sum_range_guard():
    """The limb model's guard admits every set of shortint/params.py at its
    own n_in, and only shapes whose limb sums stay inside s32 even with
    every digit at -2^(base_log-1) and every key byte 255; the model's
    largest sum on the word whose digits are as large as the balanced
    decomposition makes them (-8, -7, -7, -7 at 2^4, 4 levels) is that
    sum exactly, below the guard's bound."""
    for p in PARAM_SETS:
        n_in = p.big_lwe_dimension
        assert _limb_guard(n_in, p.ks_level, p.ks_base_log), p
        assert n_in * p.ks_level * (1 << (p.ks_base_log - 1)) * 255 < 1 << 31
    assert not _limb_guard(2048, 2, 8)        # digits beyond s8
    assert not _limb_guard(2048, 1, 4)        # 128 coefficients a chunk
    assert not _limb_guard(2048, 4, 8)
    assert not _limb_guard(2048, 6, 6)        # 36 bits of decomposition
    n_max = ((1 << 31) - 1) // (4 * 8 * 255)
    assert _limb_guard(n_max, 4, 4)
    assert not _limb_guard(n_max + 1, 4, 4)
    base_log, levels, n_in = 4, 4, 70
    ct = np.full((1, n_in + 1), 0x8888 << 48, dtype=np.uint64)
    assert (_hi_digits(ct[:, :-1], base_log, levels)[:, 0, 0] == (-8, -7, -7, -7)).all()
    ksk = np.full((n_in, levels, 3), (1 << 64) - 1, dtype=np.uint64)
    got, peak = _limb_keyswitch(ct, ksk, base_log, levels)
    assert peak == n_in * (8 + 7 + 7 + 7) * 255 < n_in * levels * 8 * 255
    want = np.asarray(ref_srv.keyswitch(jnp.asarray(ct), jnp.asarray(ksk), base_log, levels))
    assert (got == want).all()


# ---------------------------------------------------------------------------
# K2: the lazy exact kernel
# ---------------------------------------------------------------------------

N, N_IN, K1, P = 256, 4, 2, 4


def _shoup(y, w, wq, p):
    return ((w * y) - ((wq * y) >> np.uint64(32)) * p) & np.uint64(M32)


def _reduce_to(x, m):
    return np.where(x >= m, x - m, x)


def _redc_lazy(t, p, pinv):
    m = ((t & np.uint64(M32)) * pinv) & np.uint64(M32)
    return (t + m * p) >> np.uint64(32)


def _lazy_forward(x, w, wq, p):
    """lazy_forward_stages over every stage, x in [0, 4p) -> [0, 4p)."""
    n = x.shape[-1]
    m, t = 1, n
    while m < n:
        t //= 2
        xv = x.reshape(x.shape[:-1] + (m, 2, t))
        u = _reduce_to(xv[..., 0, :], 2 * p)
        s = _shoup(xv[..., 1, :], w[m:2 * m, None], wq[m:2 * m, None], p)
        x = np.stack([u + s, (u - s + 2 * p) & np.uint64(M32)], axis=-2).reshape(x.shape)
        assert (x < 4 * p).all()
        m *= 2
    return x


def _lazy_inverse(x, w, wq, p):
    """lazy_inverse_stages over every stage, x in [0, 2p) -> [0, 2p)."""
    n = x.shape[-1]
    t, m = 1, n
    while m > 1:
        h = m // 2
        xv = x.reshape(x.shape[:-1] + (h, 2, t))
        a, b = xv[..., 0, :], xv[..., 1, :]
        lo = _reduce_to(a + b, 2 * p)
        hi = _shoup((a - b + 2 * p) & np.uint64(M32), w[h:2 * h, None], wq[h:2 * h, None], p)
        x = np.stack([lo, hi], axis=-2).reshape(x.shape)
        assert (x < 2 * p).all()
        t *= 2
        m = h
    return x


def _hi_word_digit(hi, base_log):
    """ntt_common.cuh hi_word_digit: the one-level signed digit of a word
    from its high word (base_log <= 30)."""
    res = hi.astype(np.int64) >> (31 - base_log)
    rounding_bit = res & 1
    res = ((res + 1) >> 1) & ((1 << base_log) - 1)
    nb = (((res - 1) | (rounding_bit << (base_log - 1))) & res) >> (base_log - 1)
    rest = -nb
    carry = (((res - 1) | rest) & res) >> (base_log - 1)
    return res - (carry << base_log)


def _rotate_minus(acc, a):
    """exact_first_forward's input: acc X^a - acc in u64, a (B,) in [0, 2N)."""
    n = acc.shape[-1]
    out = np.empty_like(acc)
    for i, ai in enumerate(a):
        rot, odd = int(ai) % n, int(ai) // n
        v = np.concatenate([np.uint64(0) - acc[i, :, n - rot:], acc[i, :, :n - rot]], axis=-1)
        out[i] = (np.uint64(0) - v if odd else v) - acc[i]
    return out


class _LazyStep:
    """One step of blind_rotate_exact_lazy_kernel on numpy u64 accumulators
    (B, 2, N): the kernel's arithmetic and its ranges, pass boundaries
    aside (a stage is the same butterfly in any pass)."""

    def __init__(self, base_log):
        self.base_log = base_log
        self.plan = ref_ntt.make_plan(N, P)
        self.dp = ntt.device_plan(ntt.make_plan(N, P), "cpu")
        self.fwd, self.inv = (t.numpy().view(np.uint32).astype(np.uint64)
                              for t in ntt.shoup_twiddles(self.dp))

    def digits(self, acc, a):
        ct1 = _rotate_minus(acc, a)
        return _hi_word_digit(ct1 >> np.uint64(32), self.base_log), ct1

    def __call__(self, acc, a, ggsw):
        """ggsw (1, 2, 2, P, N) Montgomery residues."""
        dig, _ = self.digits(acc, a)
        y = np.empty(acc.shape[:2] + (P, N), dtype=np.uint64)
        for i, p in enumerate(self.plan.primes):
            pp, p64 = self.plan.plans[i], np.uint64(p)
            pinv = np.uint64(pp.p_inv_neg32)
            res = ((dig + 2 * p) & M32).astype(np.uint64)           # lazy_digit_residue
            assert (res < 4 * p).all()
            x = _reduce_to(_lazy_forward(res, self.fwd[i, :, 0], self.fwd[i, :, 1], p64),
                           2 * p64)
            key = ggsw[0, :, :, i].astype(np.uint64)                # (r, cc, N)
            prod = np.empty_like(x)
            for cc in range(K1):
                t = x[:, 0] * key[0, cc] + x[:, 1] * key[1, cc]
                assert (t < p64 << np.uint64(32)).all()
                prod[:, cc] = _redc_lazy(t, p64, pinv)
            assert (prod < 2 * p).all()
            z = _reduce_to(_lazy_inverse(prod, self.inv[i, :, 0], self.inv[i, :, 1], p64), p64)
            y[:, :, i] = ref_ntt.mont_mul(z, pp.n_inv_mont, p64, pp.p_inv_neg32, np)
        word = torus.to_u64(ntt.garner_to_u64(_i64(y), self.dp))
        return acc + word


def _random_key(rng, plan, steps):
    return np.stack([rng.integers(0, p, (steps, 1, K1, K1, N), dtype=np.uint64)
                     for p in plan.primes], axis=-2).astype(np.uint32)


@pytest.mark.parametrize("base_log", [23, 30, 1])
def test_fused_first_pass_digits_are_tfhe_tpus(base_log):
    """The one-level digit the first pass takes from the high word of
    acc X^a - acc is tfhe_tpu's signed decomposition of the rotated
    difference (monomial_mul - acc), for every base_log up to 30, and its
    residues d + 2p lie in [0, 4p) for every prime."""
    rng = np.random.default_rng(base_log)
    acc = rng.integers(0, 1 << 64, (4, K1, N), dtype=np.uint64)
    acc[0, 0, :3] = (0, (1 << 64) - 1, 1 << 63)
    a = np.array([0, 1, N + 3, 2 * N - 1])
    model = _LazyStep(base_log)
    dig, ct1 = model.digits(acc, a)
    want_ct1 = np.asarray(ref_srv.monomial_mul(jnp.asarray(acc), jnp.asarray(a)[:, None, None])
                          - jnp.asarray(acc))
    assert (ct1 == want_ct1).all()
    ref = np.asarray(ref_srv.signed_decompose(jnp.asarray(ct1), base_log, 1))[0]
    assert (dig.astype(np.uint64) == ref).all()
    for p in model.plan.primes:
        assert (((dig + 2 * p) & M32) < 4 * p).all()


@pytest.fixture(scope="module")
def rotation_case():
    """Three ciphertexts' rotation inputs on a random key and tfhe_tpu's
    exact blind_rotate of them (rows are independent, so a head of the
    batch has the head of the result)."""
    rng = np.random.default_rng(41)
    model = _LazyStep(23)
    key = _random_key(rng, model.plan, N_IN)
    mask = rng.integers(0, 2 * N, (3, N_IN))
    body = rng.integers(0, 2 * N, (3,))
    lut = rng.integers(0, 1 << 64, (3, K1, N), dtype=np.uint64)
    want = np.asarray(ref_srv.blind_rotate(jnp.asarray(mask), jnp.asarray(body),
                                           jnp.asarray(lut), jnp.asarray(key), model.plan,
                                           23, 1))
    return model, key, mask, body, lut, want


@pytest.mark.parametrize("b", [1, 3])
def test_lazy_exact_rotation_on_padded_batch_matches_tfhe_tpu(rotation_case, b):
    """Whole rotations of the model, on the batch padded with zero rows to
    the lazy kernel's two ciphertexts a block (kernels.pad_batch) and cut
    back: tfhe_tpu's exact blind_rotate word for word."""
    model, key, mask, body, lut, want = rotation_case
    mask, body, lut, want = mask[:b], body[:b], lut[:b], want[:b]
    acc = server.initial_accumulator(torus.from_u64(lut, "cpu"), _i64(body), False)
    acc = torus.to_u64(kernels.pad_batch(acc, 2))
    mask_p = kernels.pad_batch(_i64(mask), 2).numpy()
    assert acc.shape[0] == b + b % 2 and not mask_p[b:].any()
    for i in range(N_IN):
        acc = model(acc, mask_p[:, i], key[i])
    assert not acc[b:].any()
    assert (acc[:b] == want).all()


def test_lazy_exact_single_step_matches_cmux_step():
    """The step entry's launch (n_steps = 1) on a random accumulator: the
    model's step is tfhe_tpu's one-step rotation (body 0, the accumulator
    as its LUT) and the port's plain cmux_step."""
    rng = np.random.default_rng(47)
    model = _LazyStep(23)
    key = _random_key(rng, model.plan, 1)
    acc = rng.integers(0, 1 << 64, (3, K1, N), dtype=np.uint64)
    a = rng.integers(0, 2 * N, (3,))
    want = np.asarray(ref_srv.blind_rotate(jnp.asarray(a[:, None]), jnp.zeros(3, jnp.uint64),
                                           jnp.asarray(acc), jnp.asarray(key), model.plan,
                                           23, 1))
    got = model(acc, a, key[0])
    assert (got == want).all()
    plain = server.cmux_step(torus.from_u64(acc, "cpu"), _i64(a),
                             torch.from_numpy(key[0].view(np.int32)), model.dp, 23, 1)
    assert (torus.to_u64(plain) == got).all()


def _lazy_shape(k1, n_poly, levels, base_log):
    """The shapes the lazy exact model takes: two GLWE rows of N = 2048, one
    level whose digit the fused first pass reads from the high word
    (base_log <= 30)."""
    return k1 == 2 and n_poly == 2048 and levels == 1 and 1 <= base_log <= 30


def test_exact_kernel_choice_by_shape():
    """The lazy exact model takes every set of the V1_4 2_2 shape (k+1 = 2,
    l = 1, N = 2048) and none of the others (the TEST sets, 1_1's k+1 = 5,
    l > 1, base_log > 30), and its one-level high-word digit is tfhe_tpu's
    at each such set's base_log."""
    rng = np.random.default_rng(9)
    words = rng.integers(0, 1 << 64, 64, dtype=np.uint64)
    for p in PARAM_SETS:
        want = p.glwe_dimension == 1 and p.polynomial_size == 2048 and p.pbs_level == 1
        assert _lazy_shape(p.glwe_dimension + 1, p.polynomial_size, p.pbs_level,
                           p.pbs_base_log) == want, p
        if want:
            ref = np.asarray(ref_srv.signed_decompose(jnp.asarray(words), p.pbs_base_log, 1))
            got = _hi_word_digit((words >> np.uint64(32)).astype(np.int64), p.pbs_base_log)
            assert (np.asarray(got).astype(np.uint64) == ref.reshape(-1)).all(), p
    assert _lazy_shape(2, 2048, 1, 30)
    assert not _lazy_shape(2, 2048, 1, 31)
    assert not _lazy_shape(2, 1024, 3, 7)
    assert not _lazy_shape(5, 512, 1, 23)


def test_keyswitch_key_on_cpu_is_the_words():
    """On the CPU a ServerKey's ks_key is its int64 keyswitch key (no byte
    layout is built there), and K1's wrapper given a KeyswitchKeyLimbs on
    CPU tensors runs the plain keyswitch on its words."""
    rng = np.random.default_rng(11)
    n_in, levels, base_log, m_out = 40, 4, 4, 9
    ksk = torus.from_u64(rng.integers(0, 1 << 64, (n_in, levels, m_out), dtype=np.uint64),
                         "cpu")
    assert kernels.keyswitch_key(ksk, base_log, levels) is ksk
    ct = torus.from_u64(rng.integers(0, 1 << 64, (3, n_in + 1), dtype=np.uint64), "cpu")
    both = kernels.KeyswitchKeyLimbs(ksk, kernels.keyswitch_key_limbs(ksk, levels, IM_KC,
                                                                      IM_BN))
    want = server.keyswitch(ct, ksk, base_log, levels)
    assert (kernels.keyswitch(ct, both, base_log, levels) == want).all()
    assert (kernels.keyswitch(ct, ksk, base_log, levels) == want).all()
