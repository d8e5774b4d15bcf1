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
step entry's n_steps = 1 launch).  K1 and K1-32 with the
contraction cut into slices of chunks summed in any order
(ops/kernels.py keyswitch_splits).  K2's cluster kernel
(csrc/blind_rotate_cluster.cu) at the 3_3 shape: each prime's digits,
transforms and key product in its own block, the accumulator in quarters,
Garner on each quarter from the four primes' residues; its small-N kernel
at the TEST shapes (N = 512: the rotation, l = 1, and vertical packing's
CMux chain, l = 4, a GGSW set a ciphertext) and 1_1's k+1 = 5, the
kernel's digits and ranges against tfhe_tpu and the plain cmux_chain, and
its route; the one-step CMux mode of both cluster kernels (K2's CMux entry:
d = ct1 - ct0 as the accumulator copy, each prime's digits, lazy
transforms and product in its own block, Garner on quarters added to
ct0's) at WoPBS's tree shape and at C = 3 and 7 on the 2_2 widths,
against tfhe_tpu's WopbsKey._cmux and cm_cmux, and the entry's routes.
K3's cluster kernel (csrc/blind_rotate_multibit_cluster.cu) at
the GPU multi-bit GROUP_2 and GROUP_3 shapes: each prime's bundle, lazy
transforms and product in its own block, the accumulator kept as its
words' decomposer states, Garner on each quarter from the four primes'
residues, against tfhe_tpu's blind_rotate_multibit; the routes of the
four sets that first ran on the card in phase 32.  K6's tensor-core
kernel: balanced byte limbs of d and of -d (the negacyclic wrap) times the
key's byte limbs, the pairs a + b <= 15 summed in s32 at shift 8 (a + b)
and folded into u128 words on its flush schedule.  K1's limb-row kernel
(csrc/keyswitch.cu keyswitch_limbs_kernel): 64-bit digits cut into T
balanced byte limbs on rows (b, t), s32 sums by slice, the fold at 2^(8 (t
+ j)), against tfhe_tpu's _pfpks at the TEST WoPBS shape and its
keyswitch at the cast's base 2^24; the s32 guard; the routes of every
keyswitch shape chip_smoke.py meets.  K7's cluster kernel
(csrc/glwe_keyswitch.cu): each prime's lazy transforms and product in its
own block, Garner on quarters, against tfhe_tpu's glwe_keyswitch and
glwe_fast_keyswitch.  The kernels' own shape
predicates (csrc/keyswitch.cu imma_shape, csrc/blind_rotate.cu
exact_lazy_shape) live in the CUDA sources; chip_smoke.py holds them
against the same sets on the card."""

import copy
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tfhe_tpu.core import cm as ref_cm
from tfhe_tpu.core import experimental as ref_exp
from tfhe_tpu.ops import ntt as ref_ntt
from tfhe_tpu.ops import server as ref_srv
from tfhe_tpu.shortint import wopbs as ref_wopbs
from tfhe_tpu_torch import shortint
from tfhe_tpu_torch.ops import kernels, ntt, server, torus

torch.set_num_threads(1)  # the suite runs in parallel processes: one thread each

M32 = (1 << 32) - 1
PARAM_SETS = [v for k, v in vars(shortint.params).items()
              if isinstance(v, (shortint.params.ShortintParams,
                                shortint.params.MultiBitPBSParameters))]
KS_PAIRS = sorted({(p.ks_base_log, p.ks_level) for p in PARAM_SETS})
# K1's tensor-core kernel's digit positions a chunk, limb columns and
# batch rows a block (csrc/keyswitch.cu IM_KC, IM_BN, IM_BM)
IM_KC, IM_BN, IM_BM = 128, 256, 128


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


def _split_limb_keyswitch(ct, ksk, base_log, levels, splits, word_bytes, order):
    """The tensor-core kernel cut into slices of chunks (ops/kernels.py
    keyswitch_splits; the launcher's per = ceil(chunks / splits)): each
    slice's s32 limb sums recombined at word_bytes limbs a word (8: mod
    2^64, K1; 4: mod 2^32, K1-32, the body ct >> 32) and added, slice 0 with
    the body, into a zeroed output in the given order of slices, as the
    kernel's atomics do."""
    b = ct.shape[0]
    n_in, _, m_out = ksk.shape
    limbs = kernels.keyswitch_key_limbs(torus.from_u64(ksk, "cpu"), levels, IM_KC, IM_BN,
                                        word_bytes).numpy()
    chunks, cols, width = limbs.shape
    per = width // levels
    digits = _hi_digits(ct[:, :-1], base_log, levels)
    tiles = np.zeros((b, chunks * per, levels), dtype=np.int64)
    tiles[:, :n_in] = digits.transpose(1, 2, 0)
    tiles = tiles.reshape(b, chunks, per * levels)
    span = -(-chunks // splits)
    slices = [range(c0, min(chunks, c0 + span)) for c0 in range(0, chunks, span)]
    mod = np.uint64((1 << (8 * word_bytes)) - 1) if word_bytes < 8 else None
    out = np.zeros((b, m_out), dtype=np.uint64)
    for z in order(len(slices)):
        sums = np.zeros((b, cols), dtype=np.int64)
        for c in slices[z]:
            sums += tiles[:, c] @ limbs[c, :, :per * levels].astype(np.int64).T
        assert np.abs(sums).max() < 1 << 31
        words = np.zeros((b, m_out), dtype=np.uint64)
        for j in range(word_bytes):
            words += (sums[:, j:word_bytes * m_out:word_bytes].astype(np.uint64)
                      << np.uint64(8 * j))
        add = np.zeros((b, m_out), dtype=np.uint64) - words
        if z == 0:
            add[:, -1] += ct[:, -1] >> np.uint64(64 - 8 * word_bytes)
        out += add
        if mod is not None:
            out &= mod
    return out, len(slices)


@pytest.mark.parametrize("word_bytes", [4, 8])
def test_split_keyswitch_matches_tfhe_tpu(word_bytes):
    """K1-32 (4 limbs a word, mod 2^32) and K1 cut into 5 slices of
    chunks, summed in any order: tfhe_tpu's keyswitch32 and keyswitch
    words, as one slice gives them, at the V1_4 KS32 decomposition (2^4 x
    5) on 60 input coefficients a chunk row (3 chunks)."""
    rng = np.random.default_rng(61 + word_bytes)
    base_log, levels, b, n_in, m_out = 4, 5, 3, 62, 21
    ct = rng.integers(0, 1 << 64, (b, n_in + 1), dtype=np.uint64)
    top = (1 << 64) if word_bytes == 8 else (1 << 32)
    ksk = rng.integers(0, top, (n_in, levels, m_out), dtype=np.uint64)
    ref_fn = ref_srv.keyswitch if word_bytes == 8 else ref_srv.keyswitch32
    key = jnp.asarray(ksk if word_bytes == 8 else ksk.astype(np.uint32))
    want = np.asarray(ref_fn(jnp.asarray(ct), key, base_log, levels)).astype(np.uint64)
    for splits, order in ((1, range), (2, lambda k: reversed(range(k))),
                          (5, lambda k: rng.permutation(k))):
        got, made = _split_limb_keyswitch(ct, ksk, base_log, levels, splits, word_bytes, order)
        assert made == min(splits, 3)
        assert (got == want).all()


def test_keyswitch_splits_fill_the_card():
    """The slices the wrapper asks for on 132 SMs: K1-32 at V1_4 KS32, B =
    512 (15 column blocks x 4 row blocks, 82 chunks) takes 5, so 300
    blocks cover more than two waves; K1 at the 2_2 keyswitch (29 x 4)
    stays whole, and at B <= 128 (29 x 1, 64 chunks) takes 8; 3_3's K1 at
    B = 64 (34 x 1, 328 chunks) takes 8; a short contraction keeps at
    least K1_MIN_SLICE chunks a slice (TEST KS32: 13 chunks, whole)."""
    assert kernels.keyswitch_splits(60, 82, 132) == 5
    assert 60 * 5 >= 2 * 132
    assert kernels.keyswitch_splits(116, 82, 132) == 1
    assert kernels.keyswitch_splits(34, 328, 132) == 8
    assert kernels.keyswitch_splits(4, 13, 132) == 1          # TEST KS32, B = 512
    assert kernels.keyswitch_splits(29, 64, 132) == 8         # 2_2's K1 at B <= 128


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


# ---------------------------------------------------------------------------
# K4: the tensor-core packing keyswitch
# ---------------------------------------------------------------------------

# csrc/packing_keyswitch.cu PK_N, PK_GLWES (GLWEs a block), PK_RS (bytes of
# a reversed digit vector); the H100's SMs, which the launcher fills once
PK_N, PK_GLWES, PK_RS = 256, 2, 2 * 256 + 16
H100_SMS = 132
PK_SHAPES = {   # (n_in, l, k+1, N, base_log): TEST_COMP_PARAM's; V1_4's with n_in cut
    "test_comp": (512, 3, 2, 256, 4),
    "v1_4_cut": (48, 3, 5, 256, 4),
}


def _pk_rows(base_log):
    """packing_keyswitch.cu pk_rows: rows (i, lev) whose s32 limb sums stay
    exact with every digit at -2^(base_log-1) and every key byte 255."""
    return ((1 << 31) - 1) // (PK_N * (1 << (base_log - 1)) * 255)


def _pk_shape(levels, k1, n_poly, base_log):
    """packing_keyswitch.cu pk_imma_shape."""
    return (n_poly == PK_N and 1 <= k1 <= 5 and 1 <= levels <= 8 and 1 <= base_log <= 7
            and base_log * levels <= 30 and levels <= _pk_rows(base_log))


def _pk_inputs(n_in, levels, base_log, n_glwe, sms=H100_SMS):
    """packing_keyswitch.cu pk_inputs_per_block: the input coefficients a
    block, so that the ranges fill the SMs once and stay within pk_rows."""
    splits = max(1, sms // -(-n_glwe // PK_GLWES))
    return min(-(-n_in // splits), _pk_rows(base_log) // levels)


def _pk_reversed(digits):
    """The kernel's reversed, extended digit vectors (..., N) -> (..., PK_RS):
    R[N - j] = d_j, R[2N - j] = -d_j, so that R[u] = Dx[N - u] with Dx the
    negacyclic extension; bytes the kernel never writes are 0 here."""
    n = digits.shape[-1]
    r = np.zeros(digits.shape[:-1] + (2 * n + 16,), dtype=np.int64)
    j = np.arange(n)
    r[..., n - j] = digits
    r[..., 2 * n - j] = -digits
    return r


def _pk_toeplitz(r):
    """A[..., t, m] = R[..., N - t + m] = Dx[t - m]: the digit Toeplitz
    matrix the kernel never writes."""
    n = (r.shape[-1] - 16) // 2
    idx = n - np.arange(n)[:, None] + np.arange(n)[None, :]
    return r[..., idx]


def _pk_window(words32, o, kp):
    """The kernel's fragment register: the 4 bytes of R at o + 8 k', one
    funnel shift of two aligned little-endian words."""
    w = (o >> 2) + 2 * kp
    assert 0 <= w and w + 1 < len(words32)
    return ((int(words32[w + 1]) << 32 | int(words32[w])) >> (8 * (o & 3))) & M32


def _le_word(byte_values):
    return int.from_bytes(np.asarray(byte_values, dtype=np.int64).astype(np.int8).tobytes(),
                          "little")


def _pk_limb_keyswitch(lwes, pksk, base_log, levels, per_glwe, inputs):
    """The tensor-core kernel's function on numpy u64 inputs: digits from
    the high words, reversed and extended per (GLWE, i, lev), the Toeplitz
    tile of byte windows times the key's u8 limbs (ops/kernels.py
    packing_keyswitch_key_limbs), s32 sums run over the ``inputs``
    coefficients of a block (checked, row by row), recombined mod 2^64 and
    negated, bodies added.  Returns (output (G, k+1, N), the largest |s32|
    running sum)."""
    b = lwes.shape[0]
    n_in, _, k1, n = pksk.shape
    limbs = kernels.packing_keyswitch_key_limbs(torus.from_u64(pksk, "cpu")).numpy()
    limbs = limbs.reshape(n_in * levels, 8 * k1, n).transpose(0, 2, 1).astype(np.float64)
    out = np.zeros((-(-b // per_glwe), k1, n), dtype=np.uint64)
    peak = 0
    for g in range(out.shape[0]):
        chunk = lwes[g * per_glwe:(g + 1) * per_glwe]
        d = np.zeros((n_in, levels, n), dtype=np.int64)
        d[:, :, :chunk.shape[0]] = _hi_digits(chunk[:, :-1], base_log, levels).transpose(2, 0, 1)
        assert (np.abs(d) <= 1 << (base_log - 1)).all()
        r = _pk_reversed(d).reshape(n_in * levels, -1)
        for start in range(0, n_in, inputs):
            run = np.zeros((n, 8 * k1))
            for row in range(start * levels, min(n_in, start + inputs) * levels):
                # float64 is exact: every partial sum stays below 2^31
                run += _pk_toeplitz(r[row]).astype(np.float64) @ limbs[row]
                peak = max(peak, int(np.abs(run).max()))
            s = run.astype(np.int64).astype(np.uint64).reshape(n, k1, 8)
            with np.errstate(over="ignore"):
                words = sum(s[:, :, j] << np.uint64(8 * j) for j in range(8))
                out[g] -= words.T
        with np.errstate(over="ignore"):
            out[g, -1, :chunk.shape[0]] += chunk[:, -1]
    assert peak < 1 << 31
    return out, peak


def _ref_pk_mont(pksk):
    """(tfhe_tpu's NTT-domain Montgomery form of a packing key, its plan),
    as its CompressionKey converts the key."""
    plan = ref_ntt.make_plan(pksk.shape[-1], 4)
    return jnp.asarray(ref_ntt.to_mont_all(ref_ntt.forward_all(pksk, plan, np), plan,
                                           np).astype(np.uint32)), plan


def _ref_packing_keyswitch(lwes, ref_key, base_log, levels, per_glwe):
    """tfhe_tpu's packing keyswitch, one call per GLWE as its
    CompressionKey makes them, on the key's NTT-domain Montgomery form
    (ref_key: _ref_pk_mont's pair)."""
    mont, plan = ref_key
    return np.stack([np.asarray(ref_srv.packing_keyswitch(
        jnp.asarray(lwes[s:s + per_glwe]), mont, plan, base_log, levels))
        for s in range(0, lwes.shape[0], per_glwe)])


@pytest.fixture(scope="module")
def pk_keys():
    """A random packing key of each PK_SHAPES shape (u64)."""
    rng = np.random.default_rng(21)
    return {name: rng.integers(0, 1 << 64, (n_in, lev, k1, n), dtype=np.uint64)
            for name, (n_in, lev, k1, n, _) in PK_SHAPES.items()}


@pytest.fixture(scope="module")
def pk_ref_keys(pk_keys):
    """Each pk_keys key in tfhe_tpu's form, converted once for the tests
    that share it."""
    return {name: _ref_pk_mont(key) for name, key in pk_keys.items()}


@pytest.mark.parametrize("shape", sorted(PK_SHAPES))
@pytest.mark.parametrize("b", [1, 37, 256])
def test_pk_limb_model_matches_tfhe_tpu(pk_keys, pk_ref_keys, shape, b):
    """K4's tensor-core arithmetic at TEST_COMP_PARAM's shape and at the
    V1_4 compression set's with n_in cut to 48 (its real l, k+1, N and
    base_log), with the s32 runs of the kernel's blocks at B = 512 on an
    H100: tfhe_tpu's words."""
    n_in, levels, k1, n, base_log = PK_SHAPES[shape]
    assert _pk_shape(levels, k1, n, base_log)
    lwes = np.random.default_rng(b).integers(0, 1 << 64, (b, n_in + 1), dtype=np.uint64)
    inputs = _pk_inputs(n_in, levels, base_log, 2)
    got, _ = _pk_limb_keyswitch(lwes, pk_keys[shape], base_log, levels, n, inputs)
    want = _ref_packing_keyswitch(lwes, pk_ref_keys[shape], base_log, levels, n)
    assert got.shape == (1, k1, n) and (got == want).all()


def test_pk_limb_model_on_a_partial_last_glwe(pk_keys, pk_ref_keys):
    """Three GLWEs of 100 LWEs (the last of 57: a part-filled row tile
    beside an empty GLWE), every coefficient in one s32 run: tfhe_tpu's
    words."""
    n_in, levels, k1, n, base_log = PK_SHAPES["v1_4_cut"]
    lwes = np.random.default_rng(7).integers(0, 1 << 64, (257, n_in + 1), dtype=np.uint64)
    got, _ = _pk_limb_keyswitch(lwes, pk_keys["v1_4_cut"], base_log, levels, 100, n_in)
    want = _ref_packing_keyswitch(lwes, pk_ref_keys["v1_4_cut"], base_log, levels, 100)
    assert got.shape == (3, k1, n) and (got == want).all()


def test_pk_fragments_are_the_toeplitz_tile():
    """The kernel's operand addressing: for every warp's rows (T), lane
    (g, q), m16 tile and 32-deep step, the four A registers, funnel shifts
    of aligned words of R at o + 8 k', are the s8 Toeplitz tile's bytes in
    mma.m16n8k32's A layout (a0: row g, columns 4q .. 4q+3; a1: row g + 8;
    a2: columns + 16; a3: both); and the B registers that ldmatrix.x4 gives
    from the swizzled key stage (16-byte unit u of limb row n at u ^ (n & 7),
    rows past 8 k1 - 1 clamped to it) are limb rows 8c + g, digit positions
    4q .. 4q+3 and 16 + 4q .. of output polynomial c, for every k+1 <= 5."""
    rng = np.random.default_rng(5)
    r = _pk_reversed(rng.integers(-64, 65, PK_N))
    words32 = r.astype(np.int8).view(np.uint32)
    a = _pk_toeplitz(r)
    for T in range(0, PK_N, 64):
        for lane in range(32):
            g, q = lane >> 2, lane & 3
            o = PK_N - T - g + 4 * q
            for st in range(PK_N // 32):
                for i in range(4):
                    k = 4 * st - 2 * i
                    regs = (_pk_window(words32, o, k), _pk_window(words32, o, k - 1),
                            _pk_window(words32, o, k + 2), _pk_window(words32, o, k + 1))
                    for reg, (dr, dc) in zip(regs, ((0, 0), (8, 0), (0, 16), (8, 16))):
                        t, m = T + 16 * i + g + dr, 32 * st + 4 * q + dc
                        assert reg == _le_word(a[t, m:m + 4])
    for k1 in range(1, 6):
        limb_rows = rng.integers(0, 256, (8 * k1, PK_N), dtype=np.uint8)
        stage = np.zeros(8 * k1 * PK_N, dtype=np.uint8)
        for n_row in range(8 * k1):
            for u in range(PK_N // 16):
                off = n_row * PK_N + ((u ^ (n_row & 7)) << 4)
                stage[off:off + 16] = limb_rows[n_row, 16 * u:16 * u + 16]
        for st in range(PK_N // 32):
            for p in range(0, k1, 2):
                addr = []
                for lane in range(32):
                    n_row = min(16 * p + (lane & 7) + ((lane >> 4) << 3), 8 * k1 - 1)
                    u = 2 * st + ((lane >> 3) & 1)
                    addr.append(n_row * PK_N + ((u ^ (n_row & 7)) << 4))
                for lane in range(32):
                    g, q = lane >> 2, lane & 3
                    # ldmatrix: matrix x's row g from lane 8x + g, bytes 4q .. 4q+3
                    r4 = [stage[addr[8 * x + g] + 4 * q:addr[8 * x + g] + 4 * q + 4]
                          for x in range(4)]
                    for c, (b0, b1) in ((2 * p, (r4[0], r4[1])), (2 * p + 1, (r4[2], r4[3]))):
                        if c < k1:
                            m = 32 * st + 4 * q
                            assert (b0 == limb_rows[8 * c + g, m:m + 4]).all()
                            assert (b1 == limb_rows[8 * c + g, m + 16:m + 20]).all()


def test_pk_s32_guard_at_the_extreme_digit():
    """The guard pk_rows: with every digit at -2^(base_log-1) (synthetic:
    the balanced decomposition never gives it at two levels in a row) and
    every key byte 0xFF, one row's limb sum peaks at t = N - 1 at exactly
    N 2^(base_log-1) 255, so pk_rows rows stay below 2^31 and one more
    does not.  The kernel's blocks at B = 512 and B = 4096 on the V1_4
    set run far fewer rows; the predicate takes both compression sets and
    leaves N != 256, k+1 > 5 and 8-bit digits to the generic kernel."""
    for base_log in range(1, 8):
        d = np.full(PK_N, -(1 << (base_log - 1)))
        row = _pk_toeplitz(_pk_reversed(d)) @ np.full(PK_N, 255)
        top = PK_N * (1 << (base_log - 1)) * 255
        assert np.abs(row).max() == abs(row[-1]) == top
        rows = _pk_rows(base_log)
        assert rows * top < 1 << 31 <= (rows + 1) * top
    assert _pk_rows(4) == 4112
    for b in (512, 4096):
        assert _pk_inputs(2048, 3, 4, -(-b // 256)) * 3 <= _pk_rows(4)
    for n_in, levels, k1, n, base_log in PK_SHAPES.values():
        assert _pk_shape(levels, k1, n, base_log)
    assert _pk_shape(1, 5, 256, 4) and _pk_shape(4, 3, 256, 7)
    assert not _pk_shape(3, 2, 32, 5)          # N = 32
    assert not _pk_shape(1, 1, 1024, 10)       # N = 1024, 10-bit digits
    assert not _pk_shape(3, 6, 256, 4)         # k+1 = 6
    assert not _pk_shape(2, 2, 256, 8)         # digits beyond s8
    assert not _pk_shape(5, 2, 256, 7)         # 35 bits of decomposition


def test_pk_extreme_decomposed_masks_match_tfhe_tpu(pk_keys):
    """The largest limb sums a real mask reaches: every mask word the one
    whose digits sum to the largest magnitude the balanced decomposition
    gives (-8, -7, -7 at 2^4, 3 levels; +8, 7, 7 the other way), every key
    word all ones, 256 LWEs,
    every coefficient in one s32 run and in the kernel's runs: the peak is
    that sum times N 255 per coefficient, and the words are tfhe_tpu's."""
    n_in, levels, k1, n, base_log = PK_SHAPES["v1_4_cut"]
    rep = base_log * levels
    tops = np.arange(1 << rep, dtype=np.uint64) << np.uint64(64 - rep)
    digits = _hi_digits(tops, base_log, levels)
    sums = digits.sum(axis=0)
    assert sums.min() == -sums.max() == -22
    word = tops[(sums == -22) & (digits[0] == -8)][0]
    assert tuple(_hi_digits(word[None], base_log, levels)[:, 0]) == (-8, -7, -7)
    lwes = np.full((n, n_in + 1), word, dtype=np.uint64)
    key = np.full((n_in, levels, k1, n), (1 << 64) - 1, dtype=np.uint64)
    want = _ref_packing_keyswitch(lwes, _ref_pk_mont(key), base_log, levels, n)
    for inputs in (n_in, _pk_inputs(n_in, levels, base_log, 2)):
        got, peak = _pk_limb_keyswitch(lwes, key, base_log, levels, n, inputs)
        assert peak == inputs * 22 * n * 255
        assert (got == want).all()


def test_pk_key_limbs_are_the_words_bytes():
    """packing_keyswitch_key_limbs on the CPU: [i, lev, c, b, m] is byte b of
    word m, each limb column's N bytes contiguous."""
    rng = np.random.default_rng(8)
    words = rng.integers(0, 1 << 64, (3, 2, 5, 256), dtype=np.uint64)
    limbs = kernels.packing_keyswitch_key_limbs(torus.from_u64(words, "cpu"))
    assert limbs.dtype == torch.uint8 and limbs.shape == (3, 2, 5, 8, 256)
    assert limbs.is_contiguous()
    for j in range(8):
        assert (limbs[:, :, :, j].numpy() == ((words >> np.uint64(8 * j)) & np.uint64(255))).all()


def test_packing_keyswitch_key_on_cpu_is_the_words():
    """On the CPU packing_keyswitch_key returns the int64 key itself (no
    byte layout is built there), and K4's wrapper given a
    PackingKeyswitchKeyLimbs on CPU tensors runs the plain packing
    keyswitch on its words."""
    rng = np.random.default_rng(12)
    n_in, levels, k1, n, base_log = PK_SHAPES["v1_4_cut"]
    pksk = torus.from_u64(rng.integers(0, 1 << 64, (n_in, levels, k1, n), dtype=np.uint64),
                          "cpu")
    assert kernels.packing_keyswitch_key(pksk, base_log, levels) is pksk
    lwes = torus.from_u64(rng.integers(0, 1 << 64, (40, n_in + 1), dtype=np.uint64), "cpu")
    both = kernels.PackingKeyswitchKeyLimbs(pksk, kernels.packing_keyswitch_key_limbs(pksk))
    want = server.packing_keyswitch(lwes, pksk, base_log, levels, 32)
    before = kernels.packing_keyswitch.launches, kernels.packing_keyswitch.imma_launches
    assert torch.equal(kernels.packing_keyswitch(lwes, both, base_log, levels, 32), want)
    assert torch.equal(kernels.packing_keyswitch(lwes, pksk, base_log, levels, 32), want)
    assert (kernels.packing_keyswitch.launches,
            kernels.packing_keyswitch.imma_launches) == before


# ---------------------------------------------------------------------------
# K2's cluster kernel (csrc/blind_rotate_cluster.cu) at the 3_3 shape: a
# cluster of four blocks, block p holding prime p's residues and a quarter
# of the u64 accumulator
# ---------------------------------------------------------------------------

CL_K1, CL_N, CL_LEVELS, CL_BASE_LOG = 2, 8192, 2, 15


def _cluster_step(acc, a, ggsw, dp):
    """One step of the cluster kernel on (B, k+1, N) int64 words: block pi
    reads the four accumulator quarters (the whole accumulator), forms acc
    X^a - acc, its signed digits' residues mod its prime, the forward
    transforms, the product with its prime's slice of the GGSW and the
    inverse transforms (N^-1 applied with Garner, as the kernel does); then
    block r reconstructs its quarter from the four blocks' residues at its
    positions (Garner) and adds it to its quarter."""
    b, k1, n = acc.shape
    quarter = k1 * n // 4
    ct1 = server.monomial_mul(acc, a[:, None, None]) - acc
    digits = server.signed_decompose(ct1, CL_BASE_LOG, CL_LEVELS)    # (l, B, k+1, N)
    out = []
    for pi in range(4):
        p = int(dp.plan.primes[pi])
        res = torch.zeros(digits.shape[:-1] + (4, n), dtype=torch.int64)
        res[..., pi, :] = torch.remainder(digits, p)
        fwd = ntt.ntt_forward(res, dp)[..., pi, :]                    # (l, B, k+1, N)
        key = ggsw[..., pi, :].to(torch.int64)                         # (l, k+1, k+1, N)
        col = torch.zeros((b, k1, n), dtype=torch.int64)
        for lev in range(CL_LEVELS):
            for r in range(k1):
                prod = ntt.redc(fwd[lev][:, r, None] * key[lev, r], dp.ps[pi], dp.pinvs[pi])
                col = torch.remainder(col + prod, p)
        inv = torch.zeros((b, k1, 4, n), dtype=torch.int64)
        inv[..., pi, :] = col
        out.append(ntt.ntt_inverse(inv, dp, scale=False)[..., pi, :].reshape(b, -1))
    words = acc.reshape(b, 4, quarter).clone()
    for r in range(4):
        at = slice(r * quarter, (r + 1) * quarter)
        exchanged = torch.stack([out[pi][:, at] for pi in range(4)], dim=1)   # (B, P, quarter)
        scaled = torch.remainder(exchanged * dp.n_invs[None].reshape(1, 4, 1), dp.ps)
        scaled = ntt.redc(scaled, dp.ps, dp.pinvs)
        words[:, r] += ntt.garner_to_u64(scaled, dp)
    return words.reshape(b, k1, n)


def test_cluster_step_matches_tfhe_tpu():
    """The cluster's per-prime split and Garner exchange at N = 8192, l = 2,
    base 2^15 (3_3) on a random key: one step is the port's plain cmux_step
    and tfhe_tpu's one-step exact rotation (body 0, the accumulator as its
    LUT), word for word."""
    rng = np.random.default_rng(53)
    plan = ref_ntt.make_plan(CL_N, 4)
    dp = ntt.device_plan(ntt.make_plan(CL_N, 4), "cpu")
    key = np.stack([rng.integers(0, p, (1, CL_LEVELS, CL_K1, CL_K1, CL_N), dtype=np.uint64)
                    for p in plan.primes], axis=-2).astype(np.uint32)
    acc = rng.integers(0, 1 << 64, (2, CL_K1, CL_N), dtype=np.uint64)
    a = np.array([3, CL_N + 4093])
    got = _cluster_step(torus.from_u64(acc, "cpu"), _i64(a),
                        torch.from_numpy(key[0].view(np.int32)), dp)
    plain = server.cmux_step(torus.from_u64(acc, "cpu"), _i64(a),
                             torch.from_numpy(key[0].view(np.int32)), dp, CL_BASE_LOG,
                             CL_LEVELS)
    assert (torus.to_u64(got) == torus.to_u64(plain)).all()
    want = np.asarray(ref_srv.blind_rotate(jnp.asarray(a[:, None]), jnp.zeros(2, jnp.uint64),
                                           jnp.asarray(acc), jnp.asarray(key), plan,
                                           CL_BASE_LOG, CL_LEVELS))
    assert (torus.to_u64(got) == want).all()


# ---------------------------------------------------------------------------
# K2's cluster kernel at N = 512, its small-N kernel
# (csrc/blind_rotate_cluster.cu blind_rotate_cluster_small_kernel): the TEST
# rotation (l = 1, base 2^23, the digit from the high word) and the CMux
# chain of vertical packing (l = 4, base 2^6, the 64-bit decomposer; a key
# set a ciphertext by key_index)
# ---------------------------------------------------------------------------

SN_N, SN_K1 = 512, 2
SN_SHAPES = ((1, 23), (4, 6))


class _SmallStep:
    """One step of the small-N kernel on numpy u64 accumulators (B, k+1, N)
    (k+1 = 2, or 5 at l = 1: 1_1), each ciphertext on its own GGSW (B, l,
    k+1, k+1, P, N): per prime, the
    digits' residues d + 2p, lazy forward stages (a stage is the same
    butterfly in any pass, so the kernel's 4 + 3 + 2 split and its fused
    inverse 2 + 4 + 3 are these transforms), canonical inputs to the key
    product, the l (k+1) products summed in 64 bits and reduced once a four
    into [0, 2p), lazy inverse stages, N^-1 and Garner into the
    accumulator, with each range the kernel relies on asserted."""

    def __init__(self, levels, base_log, k1=SN_K1):
        self.levels, self.base_log, self.k1 = levels, base_log, k1
        self.plan = ref_ntt.make_plan(SN_N, P)
        self.dp = ntt.device_plan(ntt.make_plan(SN_N, P), "cpu")
        self.fwd, self.inv = (t.numpy().view(np.uint32).astype(np.uint64)
                              for t in ntt.shoup_twiddles(self.dp))

    def digits(self, acc, a):
        """(l, B, k+1, N) signed digits of acc X^a - acc, lowest level first:
        from the high word at l = 1 (hi_word_digit) and wherever base_log l
        <= 30 (hi_decomposer_state, hi_next_digit), else the 64-bit
        decomposer (decomposer_state, next_digit)."""
        ct1 = _rotate_minus(acc, a)
        if self.levels == 1:
            return _hi_word_digit(ct1 >> np.uint64(32), self.base_log)[None]
        if self.base_log * self.levels <= 30:
            return _hi_digits(ct1, self.base_log, self.levels)
        return np.asarray(ref_srv.signed_decompose(jnp.asarray(ct1), self.base_log,
                                                   self.levels)).astype(np.int64)

    def __call__(self, acc, a, keys):
        dig = self.digits(acc, a)
        rows = dig.transpose(1, 0, 2, 3).reshape(acc.shape[0], -1, SN_N)   # (B, (lev, r), N)
        y = np.empty(acc.shape[:2] + (P, SN_N), dtype=np.uint64)
        for i, p in enumerate(self.plan.primes):
            pp, p64 = self.plan.plans[i], np.uint64(p)
            pinv = np.uint64(pp.p_inv_neg32)
            res = ((rows + 2 * p) & M32).astype(np.uint64)
            assert (res < 4 * p).all()
            x = _reduce_to(_reduce_to(_lazy_forward(res, self.fwd[i, :, 0], self.fwd[i, :, 1],
                                                    p64), 2 * p64), p64)
            key = keys[:, :, :, :, i].astype(np.uint64).reshape(
                acc.shape[0], -1, self.k1, SN_N)                            # (B, (lev, r), cc, N)
            prod = np.zeros((acc.shape[0], self.k1, SN_N), dtype=np.uint64)
            for cc in range(self.k1):
                for r0 in range(0, rows.shape[1], 4):
                    t = sum(x[:, r] * key[:, r, cc] for r in range(r0, min(r0 + 4, rows.shape[1])))
                    assert (t < p64 << np.uint64(32)).all()
                    prod[:, cc] = _reduce_to(prod[:, cc] + _redc_lazy(t, p64, pinv), 2 * p64)
            assert (prod < 2 * p).all()
            z = _reduce_to(_lazy_inverse(prod, self.inv[i, :, 0], self.inv[i, :, 1], p64), p64)
            y[:, :, i] = ref_ntt.mont_mul(z, pp.n_inv_mont, p64, pp.p_inv_neg32, np)
        return acc + torus.to_u64(ntt.garner_to_u64(_i64(y), self.dp))


@pytest.mark.parametrize("levels,base_log", SN_SHAPES)
def test_small_n_cluster_chain_matches_tfhe_tpu(levels, base_log):
    """Three ciphertexts over two GGSW sets (key_index 1, 0, 1) at the TEST
    rotation and chain shapes, four steps on random keys: the model's steps
    are, ciphertext by ciphertext, tfhe_tpu's exact blind_rotate on the
    ciphertext's set (body 0, the accumulator as its LUT), and the port's
    plain cmux_chain, word for word."""
    rng = np.random.default_rng(59 + levels)
    model = _SmallStep(levels, base_log)
    steps, index = 4, np.array([1, 0, 1])
    sets = np.stack([rng.integers(0, p, (2, steps, levels, SN_K1, SN_K1, SN_N),
                                  dtype=np.uint64) for p in model.plan.primes],
                    axis=-2).astype(np.uint32)
    acc = rng.integers(0, 1 << 64, (3, SN_K1, SN_N), dtype=np.uint64)
    acc[0, 0, :3] = (0, (1 << 64) - 1, 1 << 63)
    a = rng.integers(0, 2 * SN_N, (3, steps))
    got = acc
    for i in range(steps):
        got = model(got, a[:, i], sets[index, i])
    for b in range(3):
        want = np.asarray(ref_srv.blind_rotate(
            jnp.asarray(a[b:b + 1]), jnp.zeros(1, jnp.uint64), jnp.asarray(acc[b:b + 1]),
            jnp.asarray(sets[index[b]]), model.plan, base_log, levels))
        assert (got[b:b + 1] == want).all(), b
    plain = kernels.cmux_chain(torus.from_u64(acc, "cpu"), _i64(a),
                               torch.from_numpy(sets.view(np.int32)), torch.from_numpy(index),
                               model.dp, base_log, levels)
    assert (torus.to_u64(plain) == got).all()


def test_small_n_1_1_steps_match_tfhe_tpu():
    """1_1's shape (k+1 = 5, N = 512, l = 1, base 2^23): three steps of the
    model on two ciphertexts and a random key are tfhe_tpu's exact
    blind_rotate (body 0, the accumulator as its LUT) and the port's plain
    rotation (kernels.rotate_accumulator on the CPU), word for word."""
    rng = np.random.default_rng(61)
    k1, steps, base_log = 5, 3, 23
    model = _SmallStep(1, base_log, k1)
    key = np.stack([rng.integers(0, p, (steps, 1, k1, k1, SN_N), dtype=np.uint64)
                    for p in model.plan.primes], axis=-2).astype(np.uint32)
    acc = rng.integers(0, 1 << 64, (2, k1, SN_N), dtype=np.uint64)
    acc[0, 0, :3] = (0, (1 << 64) - 1, 1 << 63)
    a = rng.integers(0, 2 * SN_N, (2, steps))
    got = acc
    for i in range(steps):
        got = model(got, a[:, i], np.broadcast_to(key[i], (2,) + key.shape[1:]))
    want = np.asarray(ref_srv.blind_rotate(jnp.asarray(a), jnp.zeros(2, jnp.uint64),
                                           jnp.asarray(acc), jnp.asarray(key), model.plan,
                                           base_log, 1))
    assert (got == want).all()
    plain = kernels.rotate_accumulator(torus.from_u64(acc, "cpu"), _i64(a),
                                       torch.from_numpy(key.view(np.int32)), model.dp,
                                       base_log, 1)
    assert (torus.to_u64(plain) == got).all()


@pytest.mark.parametrize("shape,route", [
    ((2, 512, 1, 23), "cluster"),       # the TEST sets' PBS: WoPBS, AES, KS32, PBS->KS
    ((2, 512, 4, 6), "cluster"),        # vertical packing's CMux chain
    ((2, 512, 2, 15), "cluster"),
    ((2, 512, 3, 10), "cluster"),
    ((2, 512, 1, 30), "cluster"),
    ((2, 512, 1, 31), "generic"),       # past the lazy residues' base_log 30
    ((2, 512, 5, 6), "generic"),        # past l = 4
    ((3, 512, 1, 23), "cluster"),
    ((5, 512, 1, 23), "cluster"),       # 1_1
    ((5, 512, 2, 15), "generic"),       # past l = 1 at k+1 > 2
    ((2, 256, 1, 23), "generic"),       # the toy vectors
    ((2, 1024, 1, 23), "generic"),
    ((2, 1024, 3, 7), "generic"),       # TFHE_LIB
])
def test_small_n_route(shape, route):
    """K2's exact rotation takes the small-N cluster kernel exactly at the
    N = 512 entries of CLUSTER_SHAPES (k+1 = 2, l <= 4, and 3 <= k+1 <= 5,
    l = 1, base_log <= 30): the TEST rotation and chain shapes and 1_1's;
    every other shape the generic kernel takes stays on it.  cmux_chain
    takes those at k+1 = 2 (chain_shape)."""
    assert kernels.exact_rotation_route(*shape, False) == route
    assert kernels.small_shape(*shape) == (route == "cluster")
    assert kernels.cluster_shape(*shape) == (route == "cluster")
    assert kernels.chain_shape(*shape) == (route == "cluster" and shape[0] == 2)


def test_small_n_route_takes_the_test_sets_and_the_wopbs_chain():
    """Every parameter set at k+1 = 2, N = 512 (the TEST sets) routes its
    exact rotation to the small-N kernel, and TEST_WOPBS_PARAM's CMux chain
    (l = 4, base 2^6) is a shape cmux_chain takes."""
    from tfhe_tpu_torch.shortint import wopbs

    test_sets = [p for p in PARAM_SETS if p.glwe_dimension == 1 and p.polynomial_size == 512]
    assert test_sets
    for p in test_sets:
        assert kernels.exact_rotation_route(2, 512, p.pbs_level, p.pbs_base_log,
                                            False) == "cluster", p
    w = wopbs.TEST_WOPBS_PARAM
    assert kernels.small_shape(2, 512, w.cbs_level, w.cbs_base_log)


# ---------------------------------------------------------------------------
# K2's CMux entry on the cluster kernels (csrc/blind_rotate_cluster.cu, their
# one-step CMux mode; ops/kernels.py cmux_route): out = ct0 + GGSW (x) (ct1 -
# ct0), the small-N kernel at WoPBS's tree (k+1 = 2, N = 512, l = 4, base
# 2^6) and the N = 2048 kernel at the common-mask CMux's widths (l = 1, base
# 2^23, k+1 = k + C)
# ---------------------------------------------------------------------------

CMUX_SHAPES = {"wopbs_tree": (2, 512, 4, 6), "cm_c3": (4, 2048, 1, 23),
               "cm_c7": (8, 2048, 1, 23)}
REF_CM_CMUX = jax.jit(ref_cm.cm_cmux, static_argnums=(3, 4, 5))


def _ref_wopbs_cmux(plan, base_log, levels):
    """tfhe_tpu's WopbsKey._cmux at the given plan and CBS decomposition,
    compiled whole (its eager external product compiles each operation on
    its own)."""
    stub = types.SimpleNamespace(plan=plan, params=types.SimpleNamespace(
        cbs_base_log=base_log, cbs_level=levels))
    return jax.jit(lambda ggsw, ct0, ct1: ref_wopbs.WopbsKey._cmux(stub, ggsw, ct0, ct1))


class _CmuxStep:
    """One launch of the cluster kernels' CMux mode on numpy u64 (B, k+1, N)
    operands and a GGSW (l, k+1, k+1, P, N) of Montgomery residues: d = ct1
    - ct0 (the accumulator copy the kernel loads), then block p of a
    ciphertext's cluster: the digits' residues d + 2p mod its prime (from
    the high word: hi_word_digit at l = 1, hi_decomposer_state where
    base_log l <= 30), lazy forward stages, canonical inputs to the key
    product, the l (k+1) products summed in 64 bits and reduced once a
    four into [0, 2p), lazy inverse stages and N^-1; then block r's Garner
    on quarter r of the (k+1) N coefficients from the four blocks'
    residues there, added to ct0's quarter r, with each range the kernels
    rely on asserted."""

    def __init__(self, n_poly, levels, base_log):
        self.n, self.levels, self.base_log = n_poly, levels, base_log
        self.plan = ref_ntt.make_plan(n_poly, P)
        self.dp = ntt.device_plan(ntt.make_plan(n_poly, P), "cpu")
        self.fwd, self.inv = (t.numpy().view(np.uint32).astype(np.uint64)
                              for t in ntt.shoup_twiddles(self.dp))

    def digits(self, d):
        if self.levels == 1:
            return _hi_word_digit(d >> np.uint64(32), self.base_log)[None]
        assert self.base_log * self.levels <= 30
        return _hi_digits(d, self.base_log, self.levels)

    def block(self, i, rows, ggsw):
        """Prime i's block: (B, k+1, N) canonical residues of the product
        times N^-1 (the Garner inputs it stores into their owners)."""
        b, k1 = rows.shape[0], ggsw.shape[1]
        pp, p = self.plan.plans[i], int(self.plan.primes[i])
        p64, pinv = np.uint64(p), np.uint64(pp.p_inv_neg32)
        res = ((rows + 2 * p) & M32).astype(np.uint64)
        assert (res < 4 * p).all()
        x = _reduce_to(_reduce_to(_lazy_forward(res, self.fwd[i, :, 0], self.fwd[i, :, 1], p64),
                                  2 * p64), p64)
        key = ggsw[..., i, :].astype(np.uint64).reshape(-1, k1, self.n)   # ((lev, r), cc, N)
        prod = np.zeros((b, k1, self.n), dtype=np.uint64)
        for cc in range(k1):
            for r0 in range(0, rows.shape[1], 4):
                t = sum(x[:, r] * key[r, cc] for r in range(r0, min(r0 + 4, rows.shape[1])))
                assert (t < p64 << np.uint64(32)).all()
                prod[:, cc] = _reduce_to(prod[:, cc] + _redc_lazy(t, p64, pinv), 2 * p64)
        assert (prod < 2 * p).all()
        z = _reduce_to(_lazy_inverse(prod, self.inv[i, :, 0], self.inv[i, :, 1], p64), p64)
        return ref_ntt.mont_mul(z, pp.n_inv_mont, p64, pp.p_inv_neg32, np)

    def __call__(self, ct0, ct1, ggsw):
        b, k1, n = ct0.shape
        d = ct1 - ct0
        rows = self.digits(d).transpose(1, 0, 2, 3).reshape(b, -1, n)     # (B, (lev, r), N)
        y = np.stack([self.block(i, rows, ggsw).reshape(b, -1) for i in range(P)], axis=1)
        quarter = k1 * n // 4
        out = ct0.reshape(b, -1).copy()
        for r in range(4):
            at = slice(r * quarter, (r + 1) * quarter)
            out[:, at] += torus.to_u64(ntt.garner_to_u64(_i64(y[:, :, at]), self.dp))
        return out.reshape(ct0.shape)


@pytest.mark.parametrize("tag", sorted(CMUX_SHAPES))
def test_cmux_mode_matches_tfhe_tpu(tag):
    """The CMux mode's model at WoPBS's tree shape and at C = 3 and 7 on the
    2_2 widths, B = 2 on a random GGSW: tfhe_tpu's WopbsKey._cmux (the tree)
    or cm_cmux (the common mask), and the port's plain kernels.cmux, word
    for word."""
    k1, n, levels, base_log = CMUX_SHAPES[tag]
    rng = np.random.default_rng(67 + k1)
    model = _CmuxStep(n, levels, base_log)
    ggsw = np.stack([rng.integers(0, p, (levels, k1, k1, n), dtype=np.uint64)
                     for p in model.plan.primes], axis=-2).astype(np.uint32)
    ct0, ct1 = (rng.integers(0, 1 << 64, (2, k1, n), dtype=np.uint64) for _ in range(2))
    ct1[0, 0, :3] = ct0[0, 0, :3] + np.array([0, (1 << 64) - 1, 1 << 63], dtype=np.uint64)
    got = model(ct0, ct1, ggsw)
    if tag == "wopbs_tree":
        want = _ref_wopbs_cmux(model.plan, base_log, levels)(jnp.asarray(ggsw), jnp.asarray(ct0),
                                                              jnp.asarray(ct1))
    else:
        want = REF_CM_CMUX(jnp.asarray(ct0), jnp.asarray(ct1), jnp.asarray(ggsw), model.plan,
                           base_log, levels)
    assert (got == np.asarray(want)).all()
    plain = kernels.cmux(torus.from_u64(ct0, "cpu"), torus.from_u64(ct1, "cpu"),
                         torch.from_numpy(ggsw.view(np.int32)), model.dp, base_log, levels)
    assert (torus.to_u64(plain) == got).all()


@pytest.mark.parametrize("shape,route", [
    ((2, 512, 4, 6), "small"),          # WoPBS's tree (TEST_WOPBS_PARAM's CBS)
    ((2, 512, 1, 23), "small"),
    ((5, 512, 1, 23), "small"),         # 1_1's widths
    ((2, 512, 5, 6), "generic"),        # past l = 4
    ((2, 2048, 1, 23), "generic"),      # C = 1 at the 2_2 widths
    ((2, 1024, 1, 23), "generic"),      # N = 1024
    ((2, 1024, 3, 7), "generic"),
    ((3, 2048, 1, 23), "cluster"),      # the common mask at C = 2 .. 7
    ((4, 2048, 1, 23), "cluster"),
    ((5, 2048, 1, 23), "cluster"),
    ((6, 2048, 1, 23), "cluster"),
    ((7, 2048, 1, 23), "cluster"),
    ((8, 2048, 1, 23), "cluster"),
    ((2, 2048, 2, 15), "generic"),      # past l = 1 at N = 2048 (its block fits)
])
def test_cmux_route(shape, route):
    """K2's CMux entry takes the small-N kernel's CMux mode at the small-N
    shapes, the N = 2048 cluster kernel's at 3 <= k+1 <= 8, l = 1 (CLUSTER_
    SHAPES below N = 8192), and its generic kernel at every other shape it
    fits: every shape chip_smoke.py gives it."""
    assert kernels.cmux_route(*shape) == route
    assert (route == "small") == kernels.small_shape(*shape)


@pytest.mark.parametrize("shape", [(9, 2048, 1, 23), (4, 2048, 2, 15), (2, 8192, 2, 15),
                                   (6, 1024, 1, 23)])
def test_cmux_route_refuses_what_no_kernel_takes(shape):
    """k+1 = 9 at N = 2048 passes the cluster kernel's 8 rows and the
    generic kernel's 5; 3_3's shape has no CMux mode and passes a block;
    k+1 = 6 at N = 1024 takes no kernel: a ValueError naming the limits."""
    with pytest.raises(ValueError, match="CMux entry at k\\+1 = .*generic kernel takes k\\+1 <= 5"
                                         ".*cluster kernels take 3 <= k\\+1 <= 8, N = 2048"):
        kernels.cmux_route(*shape)


def test_cmux_route_takes_the_wopbs_tree():
    """TEST_WOPBS_PARAM's CMux tree at the TEST sets' widths is the small
    route's shape."""
    from tfhe_tpu_torch.shortint import wopbs

    w = wopbs.TEST_WOPBS_PARAM
    assert kernels.cmux_route(2, 512, w.cbs_level, w.cbs_base_log) == "small"


# ---------------------------------------------------------------------------
# K3's cluster kernel (csrc/blind_rotate_multibit_cluster.cu) at the GPU
# multi-bit sets: a cluster of four blocks a ciphertext, block p holding
# prime p; the accumulator kept as each word's decomposer state
# ---------------------------------------------------------------------------

MC_SHAPES = {"gpu_group_2": (4096, 1, 2, 21, 2), "gpu_group_3": (2048, 2, 3, 14, 3)}


def _hi_state(words, base_log, levels):
    """ntt_common.cuh hi_decomposer_state of u64 words (base_log l <= 30)."""
    rep = base_log * levels
    res = (np.asarray(words, dtype=np.uint64) >> np.uint64(63 - rep)).astype(np.int64)
    rounding_bit = res & 1
    res = ((res + 1) >> 1) & ((1 << rep) - 1)
    nb = (((res - 1) | (rounding_bit << (rep - 1))) & res) >> (rep - 1)
    return res - (nb << rep)


def _state_digits(state, base_log, levels):
    """The kernel's first pass: level lev's digit is the (lev + 1)-th
    hi_next_digit of the state (lowest level first); (l, ...)."""
    state, digits = state.copy(), []
    for _ in range(levels):
        r = state & ((1 << base_log) - 1)
        state = state >> base_log
        carry = (((r - 1) | state) & r) >> (base_log - 1)
        state = state + carry
        digits.append(r - (carry << base_log))
    return np.stack(digits)


class _MultibitClusterGroup:
    """One group of the cluster kernel on the (B, 2, N) decomposer states:
    block pi forms the digits' residues d + 2p, the lazy forward transform
    (a stage is the same butterfly in any pass), canonical inputs; the
    bundle eff = E_0 + sum_u w_u E_u of each entry with w_u from the
    port's one-period monomial table, its products summed in 64 bits and
    reduced once a four into [0, 2p); the product over the l (k+1) rows,
    reduced once a four; the lazy inverse transform and N^-1.  Then block
    r's quarter of the flattened (2, N) coefficients is reconstructed
    from the four blocks' residues there (Garner), giving the words; each
    range the kernel relies on is asserted."""

    def __init__(self, n_poly, levels, grouping, base_log):
        self.n, self.levels, self.g, self.base_log = n_poly, levels, grouping, base_log
        self.plan = ref_ntt.make_plan(n_poly, P)
        self.dp = ntt.device_plan(ntt.make_plan(n_poly, P), "cpu")
        self.fwd, self.inv = (t.numpy().view(np.uint32).astype(np.uint64)
                              for t in ntt.shoup_twiddles(self.dp))
        table, odd = server.monomial_table(self.dp)
        self.mono = table.numpy().astype(np.uint64)[:, :2 * n_poly]   # psi has order 2N
        self.odd = odd.numpy().astype(np.uint64)                      # 2 br(t) + 1

    def __call__(self, states, deg, key):
        """states (B, 2, N) int64; deg (B, 2^g) in [0, 2N); key (2^g, l, 2,
        2, P, N) u32.  Returns the group's (B, 2, N) u64 words."""
        b, n, k1 = states.shape[0], self.n, 2
        dig = _state_digits(states, self.base_log, self.levels)           # (l, B, 2, N)
        rows = dig.transpose(1, 0, 2, 3).reshape(b, -1, n)                # (B, (lev, r), N)
        y = np.empty((b, k1, P, n), dtype=np.uint64)
        for i, p in enumerate(self.plan.primes):
            pp, p64 = self.plan.plans[i], np.uint64(p)
            pinv = np.uint64(pp.p_inv_neg32)
            res = ((rows + 2 * p) & M32).astype(np.uint64)
            assert (res < 4 * p).all()
            x = _reduce_to(_reduce_to(_lazy_forward(res, self.fwd[i, :, 0], self.fwd[i, :, 1],
                                                    p64), 2 * p64), p64)
            e = key[:, :, :, :, i].astype(np.uint64).reshape(1 << self.g, -1, k1, n)
            w = self.mono[i][(self.odd[None, :] * deg[:, :, None].astype(np.uint64))
                             & np.uint64(2 * n - 1)]                          # (B, 2^g, N)
            eff = np.broadcast_to(e[0], (b,) + e.shape[1:]).copy()        # (B, (lev, r), cc, N)
            for u0 in range(1, 1 << self.g, 4):
                t = sum(w[:, u, None, None] * e[u] for u in range(u0, min(u0 + 4, 1 << self.g)))
                assert (t < p64 << np.uint64(32)).all()
                eff = _reduce_to(eff + _redc_lazy(t, p64, pinv), 2 * p64)
            eff = _reduce_to(eff, p64)
            prod = np.zeros((b, k1, n), dtype=np.uint64)
            for cc in range(k1):
                for r0 in range(0, rows.shape[1], 4):
                    t = sum(x[:, r] * eff[:, r, cc] for r in range(r0, min(r0 + 4, rows.shape[1])))
                    assert (t < p64 << np.uint64(32)).all()
                    prod[:, cc] = _reduce_to(prod[:, cc] + _redc_lazy(t, p64, pinv), 2 * p64)
            z = _reduce_to(_lazy_inverse(prod, self.inv[i, :, 0], self.inv[i, :, 1], p64), p64)
            y[:, :, i] = ref_ntt.mont_mul(z, pp.n_inv_mont, p64, pp.p_inv_neg32, np)
        # block r reconstructs coefficients r Q .. (r + 1) Q - 1 of the
        # flattened (2, N) from the four primes' residues there
        quarter = k1 * n // P
        flat = y.transpose(0, 2, 1, 3).reshape(b, P, k1 * n)
        words = np.empty((b, k1 * n), dtype=np.uint64)
        for r in range(P):
            at = slice(r * quarter, (r + 1) * quarter)
            words[:, at] = torus.to_u64(ntt.garner_to_u64(_i64(flat[:, :, at]), self.dp))
        return words.reshape(b, k1, n)

    def rotate(self, acc, degrees, keys):
        """Whole rotation of (B, 2, N) u64 accumulators over degrees (B, G,
        2^g), keys (G, 2^g, l, 2, 2, P, N): states from the input words,
        each group's words to states for the next, the last group's words
        out."""
        words = acc
        for j in range(degrees.shape[1]):
            states = _hi_state(words, self.base_log, self.levels)
            words = self(states, degrees[:, j], keys[j])
        return words


@pytest.fixture(scope="module", params=sorted(MC_SHAPES))
def multibit_cluster_case(request):
    """A GPU multi-bit shape with n cut to two or three groups: the model,
    a random key, degrees of random masks, accumulators (extreme words in
    one row) and tfhe_tpu's blind_rotate_multibit of them (body 0, the
    accumulator as its LUT)."""
    n_poly, levels, g, base_log, groups = MC_SHAPES[request.param]
    rng = np.random.default_rng(67 + n_poly)
    model = _MultibitClusterGroup(n_poly, levels, g, base_log)
    key = np.stack([rng.integers(0, p, (groups, 1 << g, levels, 2, 2, n_poly), dtype=np.uint64)
                    for p in model.plan.primes], axis=-2).astype(np.uint32)
    raw = torus.from_u64(rng.integers(0, 1 << 64, (2, groups * g), dtype=np.uint64), "cpu")
    deg = server.multibit_switched_degrees(raw, g, n_poly.bit_length()).numpy()
    acc = rng.integers(0, 1 << 64, (2, 2, n_poly), dtype=np.uint64)
    acc[0, 0, :3] = (0, (1 << 64) - 1, 1 << 63)
    want = np.asarray(ref_srv.blind_rotate_multibit(
        jnp.asarray(deg.astype(np.uint64)), jnp.zeros(2, jnp.uint64), jnp.asarray(acc),
        jnp.asarray(key), model.plan, base_log, levels, g))
    return request.param, model, key, deg, acc, want


def test_multibit_cluster_matches_tfhe_tpu(multibit_cluster_case):
    """The cluster kernel's per-prime bundle, lazy passes and Garner
    exchange over two (GROUP_2: N = 4096, g = 2) or three (GROUP_3: l = 2,
    g = 3, base 2^14) groups: tfhe_tpu's blind_rotate_multibit word for
    word, and the port's plain blind_rotate_multibit (the wrapper on the
    CPU)."""
    tag, model, key, deg, acc, want = multibit_cluster_case
    got = model.rotate(acc, deg, key)
    assert (got == want).all(), tag
    plain = kernels.blind_rotate_multibit(
        _i64(deg), torch.zeros(2, dtype=torch.int64), torus.from_u64(acc, "cpu"),
        torch.from_numpy(key.view(np.int32)), model.dp, model.base_log, model.levels)
    assert (torus.to_u64(plain) == got).all(), tag


def test_multibit_cluster_states_give_tfhe_tpus_digits(multibit_cluster_case):
    """The int decomposer state a block keeps for each word gives, level by
    level, tfhe_tpu's signed decomposition of the word (base_log l <= 30:
    21 at GROUP_2, 28 at GROUP_3), the extreme words included."""
    tag, model, _, _, acc, _ = multibit_cluster_case
    state = _hi_state(acc, model.base_log, model.levels)
    assert (np.abs(state) < 1 << 31).all()
    got = _state_digits(state, model.base_log, model.levels)
    ref = np.asarray(ref_srv.signed_decompose(jnp.asarray(acc), model.base_log, model.levels))
    assert (got.astype(np.uint64) == ref).all(), tag


@pytest.mark.parametrize("shape,route", [
    ((2, 4096, 1, 2, 21), "cluster"),   # GPU GROUP_2
    ((2, 2048, 2, 3, 14), "cluster"),   # GPU GROUP_3
    ((2, 2048, 1, 4, 22), "lazy"),      # GROUP_4 2_2, GROUP_4 1_1
    ((2, 2048, 1, 2, 23), "lazy"),      # tfhe_tpu's GROUP_2 at the 2_2 widths
    ((2, 2048, 2, 3, 16), "generic"),   # base_log l = 32 > 30
    ((2, 2048, 2, 2, 14), "generic"),   # l = 2 at g = 2
    ((2, 4096, 1, 3, 21), "generic"),
    ((2, 2048, 1, 1, 22), "generic"),
    ((2, 512, 1, 2, 23), "generic"),    # the TEST multi-bit sets
])
def test_multibit_exact_route(shape, route):
    """K3's exact rotation: the lazy kernel at MULTIBIT_LAZY_SHAPE, the
    cluster kernel exactly at MULTIBIT_CLUSTER_SHAPES (k+1 = 2, base_log l
    <= 30), the generic kernel elsewhere."""
    assert kernels.multibit_exact_route(*shape) == route
    assert kernels.multibit_cluster_shape(*shape) == (route == "cluster")


def test_multibit_exact_route_refuses_what_no_kernel_takes():
    """A shape whose generic block passes shared memory and that neither
    other kernel takes raises, naming the limits."""
    with pytest.raises(ValueError, match="above the 232448 B a block may use.*cluster kernel "
                                         "takes k\\+1 = 2"):
        kernels.multibit_exact_route(2, 4096, 2, 2, 14)


def test_param_sets_rotation_routes():
    """The four sets that first ran on the card in phase 32: 1_1 on K2's
    small-N cluster kernel, the GPU GROUP_2 and GROUP_3 sets on K3's
    cluster kernel (neither on a generic kernel), GROUP_4 1_1's exact mode
    on K3's lazy kernel."""
    sp = shortint.params
    p = sp.V1_4_PARAM_MESSAGE_1_CARRY_1_KS_PBS_TUNIFORM_2M128
    assert kernels.exact_rotation_route(5, 512, 1, 23, False) == "cluster"
    assert kernels.exact_rotation_route(p.glwe_dimension + 1, p.polynomial_size, p.pbs_level,
                                        p.pbs_base_log, False) == "cluster"
    for name, route in (("V1_4_PARAM_GPU_MULTI_BIT_GROUP_2_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128",
                         "cluster"),
                        ("V1_4_PARAM_GPU_MULTI_BIT_GROUP_3_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128",
                         "cluster"),
                        ("V1_4_PARAM_GPU_MULTI_BIT_GROUP_4_MESSAGE_1_CARRY_1_KS_PBS_TUNIFORM_2M128",
                         "lazy")):
        q = getattr(sp, name)
        assert kernels.multibit_exact_route(q.glwe_dimension + 1, q.polynomial_size, q.pbs_level,
                                            q.grouping_factor, q.pbs_base_log) == route, name


# ---------------------------------------------------------------------------
# K6's tensor-core kernel (csrc/packing_keyswitch128.cu
# packing_keyswitch128_imma_kernel): eight balanced byte limbs of a signed
# digit (of d, and of -d on the negacyclic wrap) times sixteen byte limbs of
# a u128 key word, the limb pairs a + b <= 15 summed in s32 at shift 8 (a+b),
# folded into u128 words every flush_rows rows
# ---------------------------------------------------------------------------

TC_TERM = 8 * 128 * 255
M128 = (1 << 128) - 1


def _balanced_bytes(d):
    """(8, ...) int64 limbs e_a in [-128, 127], d = sum_a e_a 2^(8a)."""
    v = np.asarray(d, dtype=np.int64).copy()
    out = []
    for _ in range(8):
        e = ((v & 0xFF) ^ 0x80) - 0x80
        out.append(e)
        v = (v - e) >> 8
    assert not v.any()
    return np.stack(out)


def _k6_flush_rows(count):
    """Rows of s32 limb sums between two flushes: a row adds at most count
    positions x 8 limb pairs x 128 x 255 to a sum."""
    return ((1 << 31) - 1) // (count * TC_TERM)


def _k6_limb_product(digits, counts, key):
    """sum_{i, lev} D_{i,lev}(X) K_{i,lev}(X) mod (X^N + 1, 2^128) the
    tensor-core kernel's way: digits (G, C, n, l) int64, key (n, l, k+1, N)
    u128 as Python ints.  Returns ((G, k+1, N) Python ints, the largest
    |s32| sum)."""
    g_n, _, n_in, levels = digits.shape
    _, _, k1, n_poly = key.shape
    limbs = kernels.packing_keyswitch128_key_limbs(torch.from_numpy(
        np.array([[[[[w & (2**64 - 1), w >> 64] for w in poly] for poly in row]
                   for row in rows] for rows in key], dtype=np.uint64).view(np.int64)))
    limbs = limbs.numpy().astype(np.int64)                       # (n, l, k+1, 16, N)
    t = np.arange(n_poly)[:, None]
    e = t - np.arange(n_poly)[None, :]                             # t - m
    words = np.zeros((g_n, k1, n_poly), dtype=object)
    peak = 0
    for g in range(g_n):
        count = counts[g]
        flush = _k6_flush_rows(count)
        sums = np.zeros((k1, n_poly, 16), dtype=np.int64)
        rows = 0
        for i in range(n_in):
            for lev in range(levels):
                d = digits[g, :count, i, lev]
                pos, neg = _balanced_bytes(d), _balanced_bytes(-d)
                for a in range(8):
                    tp = np.zeros((n_poly, n_poly), dtype=np.int64)
                    inside = (e >= 0) & (e < count)
                    tp[inside] = pos[a][e[inside]]
                    wrap = (e < 0) & (e + n_poly < count)
                    tp[wrap] = neg[a][e[wrap] + n_poly]
                    for c in range(k1):
                        prod = tp @ limbs[i, lev, c].T               # (N, 16): [t, b]
                        sums[c, :, a:] += prod[:, :16 - a]
                rows += 1
                if rows == flush or (i, lev) == (n_in - 1, levels - 1):
                    peak = max(peak, int(np.abs(sums).max()))
                    assert peak < 1 << 31
                    for s in range(16):
                        words[g] += sums[:, :, s].astype(object) * (1 << (8 * s))
                    sums[:] = 0
                    rows = 0
    return np.vectorize(lambda x: x & M128, otypes=[object])(words), peak


def _k6_u128_formula(digits, counts, key):
    """The same sum directly on Python integers, negacyclic wrap by sign."""
    g_n, _, n_in, levels = digits.shape
    _, _, k1, n_poly = key.shape
    out = np.zeros((g_n, k1, n_poly), dtype=object)
    for g in range(g_n):
        for i in range(n_in):
            for lev in range(levels):
                for j in range(counts[g]):
                    d = int(digits[g, j, i, lev])
                    for c in range(k1):
                        row = key[i, lev, c]
                        for t in range(n_poly):
                            m = t - j
                            out[g, c, t] += d * row[m] if m >= 0 else -d * row[m + n_poly]
    return np.vectorize(lambda x: x & M128, otypes=[object])(out)


def test_k6_flush_rows():
    """V1_4's 128 slots fold every 64 rows; a full list of N = 1024 slots
    every 8; the bound holds at the extreme (every sum at its largest)."""
    assert _k6_flush_rows(128) == 64 and _k6_flush_rows(1024) == 8
    for count in (1, 16, 128, 256, 1024):
        assert _k6_flush_rows(count) * count * TC_TERM < 1 << 31


def _k6_case(rng, counts, levels, base_log, n_in=3, k1=2, n_poly=256):
    """Random u128 LWE lists (slots past a list's count zero), their signed
    digits (G, C, n, l) int64 (ops/server128.py signed_decompose128: |d| <=
    2^(base_log-1), held in the low word) and a random u128 key."""
    from tfhe_tpu_torch.ops import server128
    c_max = max(counts)
    lo = rng.integers(0, 1 << 64, (len(counts), c_max, n_in + 1), dtype=np.uint64)
    hi = rng.integers(0, 1 << 64, (len(counts), c_max, n_in + 1), dtype=np.uint64)
    for g, c in enumerate(counts):
        lo[g, c:], hi[g, c:] = 0, 0
    parts = server128.signed_decompose128(torch.from_numpy(lo[..., :-1].view(np.int64)),
                                          torch.from_numpy(hi[..., :-1].view(np.int64)),
                                          base_log, levels)
    digits = torch.stack([d_lo for d_lo, _ in parts], dim=-1).numpy()
    assert (np.abs(digits) <= 1 << (base_log - 1)).all()
    k_lo = rng.integers(0, 1 << 64, (n_in, levels, k1, n_poly), dtype=np.uint64)
    k_hi = rng.integers(0, 1 << 64, (n_in, levels, k1, n_poly), dtype=np.uint64)
    key = np.vectorize(lambda a, b: int(a) | int(b) << 64, otypes=[object])(k_lo, k_hi)
    return lo, hi, digits, key, k_lo, k_hi


@pytest.mark.parametrize("levels,base_log,counts", [(1, 61, (16, 256)), (2, 30, (5,))])
def test_k6_limb_model_matches_u128_formula(levels, base_log, counts):
    """The limb model on N = 256, k+1 = 2, n = 3 (one list filling N, so
    the wrap takes the limbs of -d): the u128 formula's words; with the
    bodies and the negation, the plain version's (kernels.packing_keyswitch128
    on the CPU: tfhe_tpu's 8-prime formula) on the same LWEs."""
    rng = np.random.default_rng(71 + levels)
    lo, hi, digits, key, k_lo, k_hi = _k6_case(rng, counts, levels, base_log)
    got, _ = _k6_limb_product(digits, counts, key)
    assert (got == _k6_u128_formula(digits, counts, key)).all()
    lwes = torch.from_numpy(np.stack([lo, hi], axis=-1).view(np.int64))
    words = torch.from_numpy(np.stack([k_lo, k_hi], axis=-1).view(np.int64))
    dp8 = ntt.device_plan(ntt.make_plan(256, 8), "cpu")
    plain = torus.to_u64(kernels.packing_keyswitch128(lwes, words, list(counts), base_log,
                                                      levels, dp8))
    for g, count in enumerate(counts):
        want = (-got[g]) & M128
        body = lo[g, :count, -1].astype(object) | hi[g, :count, -1].astype(object) << 64
        want[-1, :count] = (want[-1, :count] + body) & M128
        have = plain[g, ..., 0].astype(object) | plain[g, ..., 1].astype(object) << 64
        assert (have == want).all()


def test_k6_s32_sums_at_the_extreme_digits():
    """Every digit -2^60 (limbs 0 .. 0, -16) and every key byte 255, a list
    of 128 slots over 70 rows: the sums before the fold at 64 rows stay
    inside s32 and the words are the u128 formula's."""
    n_in, k1, n_poly, count = 70, 1, 256, 128
    digits = np.full((1, count, n_in, 1), -(1 << 60), dtype=np.int64)
    key = np.full((n_in, 1, k1, n_poly), M128, dtype=object)
    got, peak = _k6_limb_product(digits, (count,), key)
    assert _k6_flush_rows(count) == 64 and peak < 1 << 31
    assert peak >= 64 * count * 16 * 255          # the top limb at every position
    assert (got == _k6_u128_formula(digits, (count,), key)).all()


def test_k6_key_byte_layout_round_trips():
    """The card holds only K6's byte layout of the u128 key: byte b of word
    m of polynomial c at [i, lev, c, b, m], and the words come back from it
    (NoiseSquashingCompressionKey.standard_key)."""
    rng = np.random.default_rng(73)
    words = torch.from_numpy(rng.integers(0, 1 << 64, (3, 2, 2, 256, 2),
                                          dtype=np.uint64).view(np.int64))
    limbs = kernels.packing_keyswitch128_key_limbs(words)
    assert limbs.shape == (3, 2, 2, 16, 256) and limbs.dtype == torch.uint8
    u = words.numpy().view(np.uint64)
    for b in (0, 7, 8, 15):
        want = (u[..., b // 8] >> np.uint64(8 * (b % 8))) & np.uint64(255)
        assert (limbs[:, :, :, b].numpy() == want).all()
    assert torch.equal(kernels.packing_keyswitch128_key_words(limbs), words)
    assert kernels.packing_keyswitch128_key(words) is words     # the CPU keeps the words


# ---------------------------------------------------------------------------
# K1's limb-row kernel (csrc/keyswitch.cu keyswitch_limbs_kernel): digits
# wider than s8 (the WoPBS PFPKS, base 2^20 x 2; the cast to the big key,
# base 2^24 x 1) decomposed from the whole u64 word, each cut into T
# balanced byte limbs put on rows (b, t) of the s8 operand, the key's byte
# layout read once, s32 sums by slice of chunks, each row's word sum times
# 2^(8t) and a ciphertext's T rows added into its output word
# ---------------------------------------------------------------------------


def _full_digits(words, base_log, levels):
    """keyswitch.cu decomposer_state / next_digit on whole u64 words: the
    signed digits (levels, ...) lowest level first, in 64-bit arithmetic
    (base_log l may pass 30)."""
    rep = base_log * levels
    one = np.uint64(1)
    res = np.asarray(words, dtype=np.uint64) >> np.uint64(64 - rep - 1)
    rounding_bit = res & one
    with np.errstate(over="ignore"):
        res = ((res + one) >> one) & np.uint64((1 << rep) - 1)
        nb = (((res - one) | (rounding_bit << np.uint64(rep - 1))) & res) >> np.uint64(rep - 1)
        state = (res - (nb << np.uint64(rep))).view(np.int64)
    digits = []
    for _ in range(levels):
        r = state & ((1 << base_log) - 1)
        state = state >> base_log
        carry = (((r - 1) | state) & r) >> (base_log - 1)
        state = state + carry
        digits.append(r - (carry << base_log))
    return np.stack(digits)


def _balanced_limbs(d, limbs):
    """The T balanced byte limbs of signed digits: d = sum_t 2^(8t) e_t,
    e_t in [-128, 127] (keyswitch_limb_rows_kernel)."""
    out, x = [], np.asarray(d, dtype=np.int64)
    for _ in range(limbs):
        e = ((x + 128) & 255) - 128
        x = (x - e) >> 8
        out.append(e)
    assert (x == 0).all()
    return np.stack(out)


def _k1_route(n_in, levels, base_log):
    """csrc/keyswitch.cu's routing, as the test's copy: "imma" where
    imma_shape holds, ("limbs", T) where limb_shape holds, else
    "generic"."""
    if _limb_guard(n_in, levels, base_log):
        return "imma"
    if (1 <= base_log <= 31 and 1 <= levels <= 8 and base_log * levels < 64
            and n_in * levels * 128 * 255 < 1 << 31):
        return ("limbs", (base_log + 8) // 8)
    return "generic"


def _limb_row_keyswitch(ct, ksk, base_log, levels, splits=1, order=range):
    """The limb-row kernel's function on numpy u64 inputs: the limb rows
    of a (row blocks 128, chunks, 128) s8 scratch (row (b, t) = block b //
    (128 // T), row (b mod (128 // T)) T + t), the key's byte layout from
    kernels.keyswitch_key_limbs, s32 sums over each slice of chunks
    (checked), each row's word sum_j 2^(8j) S times 2^(8t), a ciphertext's
    rows added, the slices added into zeros in the given order, slice 0
    with the body.  Returns (output, the largest |s32| sum, slices)."""
    b = ct.shape[0]
    n_in, _, m_out = ksk.shape
    t_limbs = (base_log + 8) // 8
    per = IM_BM // t_limbs
    key = kernels.keyswitch_key_limbs(torus.from_u64(ksk, "cpu"), levels, IM_KC,
                                      IM_BN).numpy()
    chunks, cols, width = key.shape
    coef = width // levels
    limbs = _balanced_limbs(_full_digits(ct[:, :-1], base_log, levels), t_limbs)  # (T, l, B, n)
    rows = np.array([(i // per) * IM_BM + (i % per) * t_limbs + t
                     for i in range(b) for t in range(t_limbs)])
    tiles = np.zeros((b * t_limbs, chunks * coef, levels), dtype=np.int64)
    tiles[:, :n_in] = limbs.transpose(2, 0, 3, 1).reshape(b * t_limbs, n_in, levels)
    tiles = tiles.reshape(b * t_limbs, chunks, coef * levels)
    assert (tiles.astype(np.int8) == tiles).all() and rows.max() < -(-b // per) * IM_BM
    span = -(-chunks // splits)
    slices = [range(c0, min(chunks, c0 + span)) for c0 in range(0, chunks, span)]
    out = np.zeros((b, m_out), dtype=np.uint64)
    peak = 0
    for z in order(len(slices)):
        sums = np.zeros((b * t_limbs, cols), dtype=np.int64)
        for c in slices[z]:
            sums += tiles[:, c] @ key[c, :, :coef * levels].astype(np.int64).T
            peak = max(peak, int(np.abs(sums).max()))
        assert peak < 1 << 31
        with np.errstate(over="ignore"):
            part = np.zeros((b * t_limbs, m_out), dtype=np.uint64)
            for j in range(8):
                part += sums[:, j:8 * m_out:8].astype(np.uint64) << np.uint64(8 * j)
            shifted = part << np.uint64(8) * (rows % t_limbs).astype(np.uint64)[:, None]
            word = shifted.reshape(b, t_limbs, m_out).sum(axis=1, dtype=np.uint64)
            add = np.zeros((b, m_out), dtype=np.uint64) - word
            if z == 0:
                add[:, -1] += ct[:, -1]
            out += add
    return out, peak, len(slices)


@pytest.fixture(scope="module")
def pfpks_case():
    """A random PFPKS key at the TEST WoPBS shape (k+1 = 2, N = 512, n+1 =
    513 rows, base 2^20 x 2) in both packages' forms: the port's words
    (n+1, l, (k+1)^2 N) with row n negated (WopbsKey._init_key) and
    tfhe_tpu's k+1 Montgomery NTT-domain rows, with its _pfpks compiled."""
    rng = np.random.default_rng(191)
    prm = ref_wopbs.TEST_WOPBS_PARAM
    k1, n_poly, n1 = 2, 512, 513
    rows = rng.integers(0, 1 << 64, (k1, n1, prm.pfks_level, k1, n_poly), dtype=np.uint64)
    words = np.ascontiguousarray(rows.transpose(1, 2, 0, 3, 4)).reshape(n1, prm.pfks_level, -1)
    with np.errstate(over="ignore"):
        words[-1] = np.uint64(0) - words[-1]
    plan = ntt.make_plan(n_poly, 4)
    with np.errstate(over="ignore"):
        ref_keys = tuple(jnp.asarray(ntt.to_mont_all(ntt.forward_all(rows[r], plan), plan)
                                     .astype(np.uint32)) for r in range(k1))
    ref_wk = ref_wopbs.WopbsKey.__new__(ref_wopbs.WopbsKey)
    ref_wk.params, ref_wk.plan = prm, ref_ntt.make_plan(n_poly, 4)

    def pfpks(keys_, lwe, r):
        obj = copy.copy(ref_wk)
        obj.pfpksk = list(keys_)
        return ref_wopbs.WopbsKey._pfpks(obj, lwe, r)

    compiled = jax.jit(pfpks, static_argnums=2)
    lwes = rng.integers(0, 1 << 64, (3, n1), dtype=np.uint64)
    lwes[0, :3] = (1 << 63, (1 << 63) + (1 << 43), (1 << 64) - (1 << 43))
    return words, lambda lwe, r: np.asarray(compiled(ref_keys, jnp.asarray(lwe), r)), lwes, prm


@pytest.mark.parametrize("b", [1, 3])
def test_limb_row_pfpks_matches_tfhe_tpu(pfpks_case, b):
    """K1's limb-row model on (LWE, 0) against tfhe_tpu's _pfpks at the
    TEST WoPBS shape: every output row r of every LWE, word for word (one
    row block of 42 ciphertexts, T = 3, 9 chunks, cut into 4 slices summed
    in reverse)."""
    words, ref_pfpks, lwes, prm = pfpks_case
    ext = np.concatenate([lwes[:b], np.zeros((b, 1), dtype=np.uint64)], axis=1)
    got, peak, made = _limb_row_keyswitch(ext, words, prm.pfks_base_log, prm.pfks_level,
                                          splits=4, order=lambda k: reversed(range(k)))
    assert made == 3 and peak < 1 << 31
    got = got.reshape(b, 2, 2, 512)
    for i in range(b):
        for r in range(2):
            assert (got[i, r] == ref_pfpks(lwes[i], r)).all()


@pytest.mark.parametrize("splits", [1, 2, 5])
def test_limb_row_cast_matches_tfhe_tpu(splits):
    """The cast to the big key's decomposition (base 2^24, one level: T =
    4, 32 ciphertexts a row block) at n_in cut to 300 (3 chunks), B = 37
    (two row blocks), 70 output words, the slices summed in a random
    order: tfhe_tpu's keyswitch words; its 64-bit digits are tfhe_tpu's
    signed decomposition."""
    rng = np.random.default_rng(240 + splits)
    base_log, levels, b, n_in, m_out = 24, 1, 37, 300, 70
    ct = rng.integers(0, 1 << 64, (b, n_in + 1), dtype=np.uint64)
    ct[0, :3] = (1 << 63, (1 << 64) - (1 << 39), 1 << 39)
    ksk = rng.integers(0, 1 << 64, (n_in, levels, m_out), dtype=np.uint64)
    want = np.asarray(ref_srv.keyswitch(jnp.asarray(ct), jnp.asarray(ksk), base_log, levels))
    got, _, made = _limb_row_keyswitch(ct, ksk, base_log, levels, splits,
                                       lambda k: rng.permutation(k))
    assert made == min(splits, 3)
    assert (got == want).all()
    ref_digits = np.asarray(ref_srv.signed_decompose(jnp.asarray(ct[:, :-1]), base_log, levels))
    assert (_full_digits(ct[:, :-1], base_log, levels).astype(np.uint64) == ref_digits).all()


def test_limb_row_s32_guard_at_the_extreme_digit():
    """At every base_log of the limb route (1 .. 31) the extreme digits
    +-2^(base_log-1) fit T = ceil((base_log+1) / 8) balanced s8 limbs;
    the digit +2^23 of the word 2^63 at base 2^24 is (0, 0, -128, 1); with
    every input word 2^63 and every key byte 255 the model's largest sum
    is exactly n_in 128 255 (the limb -128's row), under the route's bound
    n_in l 128 255 < 2^31 at the cast's n_in = 2048, and the words are
    tfhe_tpu's."""
    for base_log in range(1, 32):
        t_limbs = (base_log + 8) // 8
        ext = np.array([1 << (base_log - 1), -(1 << (base_log - 1))])
        limbs = _balanced_limbs(ext, t_limbs)
        assert limbs.shape[0] == t_limbs and (np.abs(limbs) <= 128).all()
        assert ((limbs[-1] >= -128) & (limbs[-1] <= 127)).all()
    base_log, levels, n_in = 24, 1, 2048
    assert (_full_digits(np.array([1 << 63], dtype=np.uint64), base_log, levels)
            == 1 << 23).all()
    assert (_balanced_limbs(np.array([1 << 23]), 4)[:, 0] == (0, 0, -128, 1)).all()
    assert _k1_route(n_in, levels, base_log) == ("limbs", 4)
    assert n_in * levels * 128 * 255 < 1 << 31
    n_small = 140
    ct = np.full((2, n_small + 1), 1 << 63, dtype=np.uint64)
    ksk = np.full((n_small, levels, 3), (1 << 64) - 1, dtype=np.uint64)
    got, peak, _ = _limb_row_keyswitch(ct, ksk, base_log, levels)
    assert peak == n_small * 128 * 255
    want = np.asarray(ref_srv.keyswitch(jnp.asarray(ct), jnp.asarray(ksk), base_log, levels))
    assert (got == want).all()
    assert not _k1_route(65794, 1, 24) == ("limbs", 4)      # past the s32 guard


# (n_in, l, base_log) of every keyswitch kernels.keyswitch meets in
# chip_smoke.py's phases, by where it comes from, and its route
K1_PHASE_SHAPES = {
    "wopbs PFPKS (TEST_WOPBS_PARAM, (k N + 1) rows)": ((513, 2, 20), ("limbs", 3)),
    "cast to big (V1_4 PKE to big, ZKV2)": ((2048, 1, 24), ("limbs", 4)),
    "cast to small (V1_4 PKE to small)": ((2048, 4, 4), "imma"),
    "test vectors toy_params": ((256, 1, 37), "generic"),
    "test vectors valid_params_128": ((2048, 5, 3), "imma"),
    "shrinking keyswitch tail (2_2)": ((1130, 4, 4), "imma"),
    "CM keyswitch (2_2, C = 3)": ((2048, 4, 4), "imma"),
}


def test_k1_routes_at_the_phase_shapes():
    """The route of K1 at every keyswitch shape of chip_smoke.py's phases:
    every set of shortint/params.py (its own n_in, imma), the PFPKS and the
    cast to big on the limb-row kernel (T = 3 and 4, one row block at B =
    40 and 32), the test vectors' base 2^37 on the generic kernel; the
    wrapper's rows and splits there (kernels.limb_rows,
    keyswitch_limb_splits on 132 SMs: 64 column blocks x 9 chunks and 65 x
    16 -> 2 slices, one wave; two row blocks -> whole)."""
    for p in PARAM_SETS:
        assert _k1_route(p.big_lwe_dimension, p.ks_level, p.ks_base_log) == "imma", p
    for what, (shape, route) in K1_PHASE_SHAPES.items():
        assert _k1_route(*shape) == route, what
    from tfhe_tpu_torch.shortint.params import (
        V1_4_PARAM_KEYSWITCH_PKE_TO_BIG_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128_ZKV2 as to_big)
    assert (to_big.ks_level, to_big.ks_base_log) == (1, 24)
    from tfhe_tpu_torch.shortint import wopbs as port_wopbs
    prm = port_wopbs.TEST_WOPBS_PARAM
    assert (prm.pfks_level, prm.pfks_base_log) == (2, 20)
    assert kernels.limb_rows(40, 3) == IM_BM and kernels.limb_rows(32, 4) == IM_BM
    assert kernels.limb_rows(43, 3) == 2 * IM_BM and kernels.limb_rows(1, 4) == IM_BM
    assert kernels.keyswitch_limb_splits(64, 9, 132) == 2
    assert kernels.keyswitch_limb_splits(65, 16, 132) == 2
    assert kernels.keyswitch_limb_splits(128, 9, 132) == 1
    assert kernels.keyswitch_limb_splits(8, 3, 132) == 1       # a slice keeps 2 chunks
    assert kernels.keyswitch_limb_splits(8, 40, 132) == 16


# ---------------------------------------------------------------------------
# K7's cluster kernel (csrc/glwe_keyswitch.cu glwe_keyswitch_cluster_kernel):
# block p of a GLWE's cluster holds prime p; each mask word decomposed once,
# residues d + 2p through lazy forward stages, the key product reduced once
# in four, lazy inverse stages, N^-1; then Garner on each quarter of the
# words from the four primes' residues
# ---------------------------------------------------------------------------


K7_N = 256                      # tfhe_tpu's TEST_VECTOR_TOY_PARAMS polynomial size
REF_FAST_KS = jax.jit(ref_exp.glwe_fast_keyswitch, static_argnums=(2, 3, 4))


def _k7_cluster(glwe, key, dp, base_log, levels, add_sum):
    """The cluster kernel's function on numpy inputs: glwe (B, k_in+1, N)
    u64, key (k_in, l, k_out+1, P, N) u32 Montgomery NTT domain."""
    b, kin1, n = glwe.shape
    k_in, _, kout1, nprimes, _ = key.shape
    plan = ref_ntt.make_plan(n, nprimes)
    fwd, inv = (t.numpy().view(np.uint32).astype(np.uint64) for t in ntt.shoup_twiddles(dp))
    digits = _full_digits(glwe[:, :-1], base_log, levels)                 # (l, B, k_in, N)
    rows = digits.transpose(1, 2, 0, 3).reshape(b, k_in * levels, n)      # row i l + lev
    nrows = k_in * levels
    per_prime = []
    for pi, p in enumerate(plan.primes):
        pp, p64 = plan.plans[pi], np.uint64(p)
        pinv = np.uint64(pp.p_inv_neg32)
        res = (rows + 2 * int(p)).astype(np.uint64)                       # lazy_digit_residue
        assert (res < 4 * p64).all()
        x = _reduce_to(_reduce_to(_lazy_forward(res, fwd[pi, :, 0], fwd[pi, :, 1], p64),
                                  2 * p64), p64)
        k = key[:, :, :, pi].astype(np.uint64).reshape(nrows, kout1, n)
        o = np.zeros((b, kout1, n), dtype=np.uint64)
        for cc in range(kout1):
            acc = np.zeros((b, n), dtype=np.uint64)
            for r in range(nrows):
                acc += x[:, r] * k[r, cc]
                if r % 4 == 3 or r == nrows - 1:
                    assert (acc < p64 << np.uint64(32)).all()
                    o[:, cc] = _reduce_to(o[:, cc] + _redc_lazy(acc, p64, pinv), 2 * p64)
                    acc[:] = 0
        z = _reduce_to(_lazy_inverse(o, inv[pi, :, 0], inv[pi, :, 1], p64), p64)
        y = ref_ntt.mont_mul(z, pp.n_inv_mont, p64, pp.p_inv_neg32, np)
        per_prime.append(np.asarray(y).reshape(b, kout1 * n))
    quarter = kout1 * n // 4
    out = np.empty((b, kout1 * n), dtype=np.uint64)
    for rank in range(4):
        at = slice(rank * quarter, (rank + 1) * quarter)
        exchanged = np.stack([per_prime[pi][:, at] for pi in range(4)], axis=1)
        word = torus.to_u64(ntt.garner_to_u64(_i64(exchanged), dp))
        with np.errstate(over="ignore"):
            out[:, at] = word if add_sum else np.uint64(0) - word
    out = out.reshape(b, kout1, n)
    with np.errstate(over="ignore"):
        out[:, -1] += glwe[:, -1]
    return out


@pytest.fixture(scope="module")
def k7_case():
    rng = np.random.default_rng(77)
    plan = ref_ntt.make_plan(K7_N, 4)
    dp = ntt.device_plan(ntt.make_plan(K7_N, 4), "cpu")
    return rng, plan, dp


@pytest.mark.parametrize("tag,k_in,add_sum", [("glwe_keyswitch", 1, False),
                                              ("fast_keyswitch", 2, True)])
def test_k7_cluster_model_matches_tfhe_tpu(k7_case, tag, k_in, add_sum):
    """The cluster kernel's per-prime split and Garner on quarters at the
    toy set's N = 256, base 2^8 x 4 (K7's research decomposition), random
    Montgomery keys of k_in l = 4 and 8 rows, k_out+1 = 2, B = 3:
    tfhe_tpu's glwe_keyswitch and glwe_fast_keyswitch words, and the plain
    version's (kernels.glwe_keyswitch on the CPU)."""
    rng, plan, dp = k7_case
    base_log, levels, kout1, b = 8, 4, 2, 3
    key = np.stack([rng.integers(0, p, (k_in, levels, kout1, K7_N), dtype=np.uint64)
                    for p in plan.primes], axis=-2).astype(np.uint32)
    glwe = rng.integers(0, 1 << 64, (b, k_in + 1, K7_N), dtype=np.uint64)
    glwe[0, 0, :3] = (1 << 63, (1 << 63) - (1 << 31), (1 << 64) - (1 << 32))
    got = _k7_cluster(glwe, key, dp, base_log, levels, add_sum)
    ref_fn = REF_FAST_KS if add_sum else ref_srv.glwe_keyswitch
    want = np.asarray(ref_fn(jnp.asarray(glwe), jnp.asarray(key), plan, base_log, levels))
    assert (got == want).all()
    plain = kernels.glwe_keyswitch(torus.from_u64(glwe, "cpu"),
                                   torch.from_numpy(key.view(np.int32)), dp, base_log, levels,
                                   add_sum)
    assert (torus.to_u64(plain) == got).all()
