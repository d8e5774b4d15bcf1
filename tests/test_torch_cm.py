"""core/cm.py of the port against tfhe_tpu/core/cm.py on the CPU, word for
word (tolerance 0: all of it is exact integer arithmetic; the drift
measure, a float32 sum, must choose the same candidate): CM LWE and GLWE
encryption and linear algebra, the CM keyswitch key and keyswitch (K1's
plain version on (mask, 0)), the CM GGSW, its CMux and external product
(K2's CMux entry's plain version), the CM bootstrap key and bootstrap (K2's
accumulator entry's plain version), the CM packing key and packing, the CM
drift choice; and the routes and refusals of the CM rotation by shape.  At
the toy set (TEST_VECTOR_TOY_PARAMS: n = 10, N = 256, noiseless), C
= 2 slots (the CMux also at C = 5), and one bootstrap at C = 4; the keys from module-scoped
fixtures, built once in each package from the same seeds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfhe_tpu.core import cm as ref_cm
from tfhe_tpu.core import encrypt as ref_enc
from tfhe_tpu.core import keygen as ref_kg
from tfhe_tpu.core.params import TEST_VECTOR_TOY_PARAMS as REF_TOY
from tfhe_tpu.core.params import DecompParams as RefDecomp
from tfhe_tpu.ops import server as ref_srv
from tfhe_tpu.utils import csprng as ref_rng
from tfhe_tpu_torch.core import cm
from tfhe_tpu_torch.core import keygen as kg
from tfhe_tpu_torch.core.params import TEST_VECTOR_TOY_PARAMS as TOY
from tfhe_tpu_torch.core.params import DecompParams
from tfhe_tpu_torch.ops import kernels, torus
from tfhe_tpu_torch.utils import csprng

torch.set_num_threads(1)  # the suite runs in parallel processes: one thread each

SEED = 0xC0FFEE
MSG_BITS = 4
DELTA = 1 << (64 - MSG_BITS - 1)
C = 2
N, K, SMALL = TOY.polynomial_size, TOY.glwe_dimension, TOY.lwe_dimension
NOISE = csprng.Gaussian(0.0)                  # TOY's noise, noiseless
KS = DecompParams(TOY.ks_decomp.base_log, TOY.ks_decomp.level_count)
PBS = DecompParams(TOY.pbs_decomp.base_log, TOY.pbs_decomp.level_count)
# tfhe_tpu's CM bootstrap compiled whole (its eager scan compiles each step's
# operations on their own)
REF_CM_BOOTSTRAP = jax.jit(ref_cm.cm_bootstrap, static_argnums=(3, 4, 5, 6))
REF_CM_CMUX = jax.jit(ref_cm.cm_cmux, static_argnums=(3, 4, 5))
REF_CM_EXTERNAL_PRODUCT = jax.jit(ref_cm.cm_external_product, static_argnums=(2, 3, 4))


def _t(a) -> torch.Tensor:
    return torus.from_u64(np.asarray(a, dtype=np.uint64), "cpu")


def _np(t) -> np.ndarray:
    return torus.to_u64(t)


def _gens(pkg, seed: int = SEED):
    return (pkg.SecretRandomGenerator(seed),
            pkg.EncryptionRandomGenerator(seed, pkg.DeterministicSeeder(seed ^ 0x99)))


def _enc_gens(seed: int) -> tuple:
    """tfhe_tpu's and the port's encryption generators from one seed (the
    same streams), fresh for each test."""
    return _gens(ref_rng, seed)[1], _gens(csprng, seed)[1]


def _enc(msgs) -> list:
    return [ref_enc.encode(m, MSG_BITS) for m in msgs]


def _dec(sks, ct) -> list:
    return [ref_enc.decode(v % (1 << 64), MSG_BITS) for v in cm.decrypt_cm_lwe(sks, ct)]


@pytest.fixture(scope="module")
def lwe_keys():
    """C LWE keys at n = 10 and at k N = 256 in both packages."""
    out = {}
    for tag, pkg, keygen in (("ref", ref_rng, ref_kg), ("port", csprng, kg)):
        sec, _ = _gens(pkg)
        small = [keygen.generate_binary_lwe_secret_key(SMALL, sec) for _ in range(C)]
        big = [keygen.generate_binary_lwe_secret_key(K * N, sec) for _ in range(C)]
        out[tag] = (small, big)
    return out


def test_cm_lwe_words_and_linear_algebra(lwe_keys):
    small, _ = lwe_keys["port"]
    ref_small, _ = lwe_keys["ref"]
    ref_gen, gen = _enc_gens(SEED + 10)
    for msgs in ([4, 3], [1, 5]):
        ref_ct = ref_cm.encrypt_cm_lwe(ref_small, _enc(msgs), REF_TOY.lwe.noise, ref_gen)
        ct = cm.encrypt_cm_lwe(small, _enc(msgs), NOISE, gen)
        assert ct.shape == (SMALL + C,) and (ct == ref_ct).all()
        assert cm.decrypt_cm_lwe(small, ct) == ref_cm.decrypt_cm_lwe(ref_small, ref_ct)
        assert _dec(small, ct) == msgs
    first = cm.encrypt_cm_lwe(small, _enc([4, 3]), NOISE, gen)
    assert (first == ref_cm.encrypt_cm_lwe(ref_small, _enc([4, 3]), REF_TOY.lwe.noise,
                                           ref_gen)).all()
    with np.errstate(over="ignore"):
        assert (cm.cm_lwe_add(first, ct) == ref_cm.cm_lwe_add(first, ct)).all()
        assert (cm.cm_lwe_scalar_mul(ct, 3) == ref_cm.cm_lwe_scalar_mul(ct, 3)).all()
        assert _dec(small, cm.cm_lwe_add(first, ct)) == [5, 8]
    assert (_np(cm.cm_lwe_scalar_mul(_t(ct), 3)) == cm.cm_lwe_scalar_mul(ct, 3)).all()


def test_cm_keyswitch(lwe_keys):
    """The CM keyswitch key from k N = 256 to n = 10 (its words; from_raw_keys
    of tfhe_tpu's) and the keyswitch of three CmLwes against tfhe_tpu."""
    small, big = lwe_keys["port"]
    ref_small, ref_big = lwe_keys["ref"]
    ref_gen, gen = _enc_gens(SEED + 11)
    ref_key = ref_cm.generate_cm_lwe_keyswitch_key(ref_big, ref_small, REF_TOY.ks_decomp,
                                                   REF_TOY.lwe.noise, ref_gen)
    key = cm.generate_cm_lwe_keyswitch_key(big, small, KS, NOISE, gen, device="cpu")
    assert key.data.shape == (K * N, 1, SMALL + C) and (key.data == ref_key.data).all()
    assert key.input_lwe_dimension == K * N
    msgs = [[7, 2], [0, 15], [9, 9]]
    cts = np.stack([ref_cm.encrypt_cm_lwe(ref_big, _enc(row), REF_TOY.lwe.noise, ref_gen)
                    for row in msgs])
    want = np.asarray(ref_cm.cm_keyswitch(jnp.asarray(cts), ref_key))
    for k in (key, cm.CmLweKeyswitchKey.from_raw_keys(ref_key.data, KS, device="cpu")):
        got = _np(cm.cm_keyswitch(_t(cts), k))
        assert (got == want).all()
    assert [_dec(small, row) for row in got] == msgs


@pytest.fixture(scope="module")
def glwe_keys():
    out = {}
    for tag, pkg, keygen in (("ref", ref_rng, ref_kg), ("port", csprng, kg)):
        sec, _ = _gens(pkg, SEED + 1)
        out[tag] = [keygen.generate_binary_glwe_secret_key(K, N, sec) for _ in range(C)]
    return out


@pytest.fixture(scope="module")
def wide_glwe_keys(glwe_keys):
    """The C = 2 GLWE keys and three more in each package: C = 5."""
    out = {}
    for tag, pkg, keygen in (("ref", ref_rng, ref_kg), ("port", csprng, kg)):
        sec, _ = _gens(pkg, SEED + 5)
        out[tag] = glwe_keys[tag] + [keygen.generate_binary_glwe_secret_key(K, N, sec)
                                     for _ in range(3)]
    return out


# the GGSW's per-slot cleartext bits at each C
CMUX_BITS = {2: [0, 1], 5: [0, 1, 1, 0, 1]}


@pytest.mark.parametrize("c_dim", sorted(CMUX_BITS))
def test_cm_glwe_and_cmux(glwe_keys, wide_glwe_keys, c_dim):
    """CM GLWE encryption and decryption, the CM GGSW of per-slot cleartext
    bits and its NTT form, and one CMux (and external product) of two CM
    GLWEs at C = 2 and 5 (k + C = 6: a width whose CMux the card refused
    at the 2_2 widths before its cluster route): tfhe_tpu's words; a slot
    whose bit is 0 keeps ct0, one whose bit is 1 takes ct1, every slot
    decrypted."""
    keys = glwe_keys if c_dim == 2 else wide_glwe_keys
    sks, ref_sks = keys["port"][:c_dim], keys["ref"][:c_dim]
    bits = CMUX_BITS[c_dim]
    ref_gen, gen = _enc_gens(SEED + 12)
    rng = np.random.default_rng(5)
    body = rng.integers(0, 16, size=(c_dim, N)).astype(np.uint64) * np.uint64(DELTA)
    ref_ct = ref_cm.encrypt_cm_glwe(ref_sks, body, REF_TOY.glwe.noise, ref_gen)
    ct = cm.encrypt_cm_glwe(sks, body, NOISE, gen, device="cpu")
    assert ct.shape == (K + c_dim, N) and (ct == ref_ct).all()
    assert (cm.decrypt_cm_glwe(sks, ct) == body).all()
    decomp = DecompParams(24, 1)
    ref_ggsw = ref_cm.encrypt_cm_ggsw(ref_sks, bits, RefDecomp(24, 1), REF_TOY.glwe.noise, ref_gen)
    ggsw = cm.encrypt_cm_ggsw(sks, bits, decomp, NOISE, gen, device="cpu")
    assert ggsw.shape == (1, K + c_dim, K + c_dim, N) and (ggsw == ref_ggsw).all()
    ref_mont, plan = ref_cm.cm_ggsw_to_ntt(ref_ggsw)
    key = cm.cm_ggsw_to_ntt(ggsw, device="cpu")
    assert (key.data.numpy().view(np.uint32) == ref_mont).all()
    p0 = np.full((c_dim, N), 3 * DELTA, dtype=np.uint64)
    p1 = np.full((c_dim, N), 12 * DELTA, dtype=np.uint64)
    ct0 = cm.encrypt_cm_glwe(sks, p0, NOISE, gen, device="cpu")
    ct1 = cm.encrypt_cm_glwe(sks, p1, NOISE, gen, device="cpu")
    want = np.asarray(REF_CM_CMUX(jnp.asarray(ct0)[None], jnp.asarray(ct1)[None],
                                  jnp.asarray(ref_mont), plan, 24, 1))
    got = _np(cm.cm_cmux(_t(ct0)[None], _t(ct1)[None], key.data, key.dp, 24, 1))
    assert (got == want).all()
    with np.errstate(over="ignore"):
        dec = (cm.decrypt_cm_glwe(sks, got[0]) + np.uint64(DELTA // 2)) >> np.uint64(59)
    for slot, bit in enumerate(bits):
        assert (dec[slot] % 16 == (12 if bit else 3)).all(), slot
    want_ep = np.asarray(REF_CM_EXTERNAL_PRODUCT(jnp.asarray(ct1)[None], jnp.asarray(ref_mont),
                                                 plan, 24, 1))
    assert (_np(cm.cm_external_product(_t(ct1)[None], key.data, key.dp, 24, 1)) == want_ep).all()


@pytest.fixture(scope="module")
def bootstrap_keys(lwe_keys, glwe_keys):
    """The CM bootstrap key (n = 10, k + C = 3, N = 256) in both packages and
    its NTT form, with three CmLwes under the small keys."""
    small, ref_small = lwe_keys["port"][0], lwe_keys["ref"][0]
    sks, ref_sks = glwe_keys["port"], glwe_keys["ref"]
    ref_gen, gen = _enc_gens(SEED + 13)
    ref_bsk = ref_cm.generate_cm_lwe_bootstrap_key(ref_small, ref_sks, REF_TOY.pbs_decomp,
                                                   REF_TOY.glwe.noise, ref_gen)
    bsk = cm.generate_cm_lwe_bootstrap_key(small, sks, PBS, NOISE, gen, device="cpu")
    ref_mont, plan = ref_cm.cm_bootstrap_key_to_ntt(ref_bsk)
    msgs = [[4, 11], [0, 7], [15, 1]]
    cts = np.stack([ref_cm.encrypt_cm_lwe(ref_small, _enc(row), REF_TOY.lwe.noise, ref_gen)
                    for row in msgs])
    return ref_bsk, bsk, ref_mont, plan, msgs, cts, [sk.as_lwe_secret_key() for sk in sks]


def test_cm_bootstrap_key_words(bootstrap_keys):
    ref_bsk, bsk, ref_mont, _, _, _, _ = bootstrap_keys
    assert bsk.shape == (SMALL, 1, K + C, K + C, N) and (bsk == ref_bsk).all()
    key = cm.cm_bootstrap_key_to_ntt(bsk, device="cpu")
    assert (key.data.numpy().view(np.uint32) == ref_mont).all()
    raw = kg.NttKey.from_raw_keys(ref_mont, device="cpu")
    assert torch.equal(raw.data, key.data)


def test_cm_bootstrap(bootstrap_keys):
    """One CM bootstrap of three CmLwes (K2's accumulator entry's plain
    version at k+1 = k + C = 3) with f(x) = (3x + 1) % 16: tfhe_tpu's
    words, every slot decrypted under its flattened GLWE key."""
    _, _, ref_mont, plan, msgs, cts, flat = bootstrap_keys
    key = kg.NttKey.from_raw_keys(ref_mont, device="cpu")
    f = lambda x: (3 * x + 1) % 16  # noqa: E731
    lut = ref_srv.generate_lut(N, K + 1, 16, DELTA, f)[-1]
    want = np.asarray(REF_CM_BOOTSTRAP(jnp.asarray(cts), lut, jnp.asarray(ref_mont), plan, 24, 1,
                                       K))
    got = _np(cm.cm_bootstrap(_t(cts), _t(lut), key.data, key.dp, 24, 1, K))
    assert got.shape == (len(msgs), K * N + C) and (got == want).all()
    assert [_dec(flat, row) for row in got] == [[f(m) for m in row] for row in msgs]


def test_cm_packing(lwe_keys):
    """C standard LWEs under one key into one CmLwe (a K1 plain launch a
    part): the packing key's words (from_raw_keys of tfhe_tpu's) and the
    packed words against tfhe_tpu, slot i holding message i."""
    ref_sec, ref_gen = _gens(ref_rng, SEED + 2)
    sec, gen = _gens(csprng, SEED + 2)
    ref_in = ref_kg.generate_binary_lwe_secret_key(SMALL, ref_sec)
    ref_out = [ref_kg.generate_binary_lwe_secret_key(SMALL, ref_sec) for _ in range(C)]
    in_sk = kg.generate_binary_lwe_secret_key(SMALL, sec)
    out_sks = [kg.generate_binary_lwe_secret_key(SMALL, sec) for _ in range(C)]
    ref_pk = ref_cm.generate_cm_lwe_packing_key(ref_in, ref_out, REF_TOY.ks_decomp,
                                                REF_TOY.lwe.noise,
                                                ref_gen)
    pk = cm.generate_cm_lwe_packing_key(in_sk, out_sks, KS, NOISE, gen, device="cpu")
    assert pk.data.shape == (C, SMALL, 1, SMALL + C) and (pk.data == ref_pk.data).all()
    msgs = [[6, 13], [2, 2]]
    cts = np.stack([np.stack([ref_enc.encrypt_lwe(ref_in, v, REF_TOY.lwe.noise, ref_gen).data
                              for v in _enc(row)]) for row in msgs])
    want = np.asarray(ref_cm.pack_lwe_ciphertexts_into_cm(jnp.asarray(cts), ref_pk))
    for key in (pk, cm.CmLwePackingKey.from_raw_keys(ref_pk.data, KS, device="cpu")):
        got = _np(cm.pack_lwe_ciphertexts_into_cm(_t(cts), key))
        assert (got == want).all()
    assert [_dec(out_sks, row) for row in got] == msgs


def test_cm_drift_choice(lwe_keys):
    """The CM drift choice among a CmLwe and its sums with 4 zero
    encryptions, at B = 3 (noisy masks, so the candidates differ): the
    candidate tfhe_tpu chooses, every slot still decrypting."""
    small = lwe_keys["ref"][0]
    _, ref_gen = _gens(ref_rng, SEED + 3)
    cts = np.stack([ref_cm.encrypt_cm_lwe(small, _enc(row), ref_rng.TUniform(40), ref_gen)
                    for row in ([9, 6], [1, 2], [15, 0])])
    zeros = np.stack([ref_cm.encrypt_cm_lwe(small, [0] * C, ref_rng.TUniform(40), ref_gen)
                      for _ in range(4)])
    log_mod = (2 * N).bit_length() - 1
    want = np.asarray(ref_cm.cm_drift_ms_improve(jnp.asarray(cts), jnp.asarray(zeros), log_mod,
                                                 r_sigma=3.0, input_variance_mod=0.0, c_dim=C))
    got = _np(cm.cm_drift_ms_improve(_t(cts), _t(zeros), log_mod, 3.0, 0.0, C))
    assert (got == want).all()
    assert _dec(small, got[0]) == [9, 6]
    chosen = {int(np.flatnonzero([(g - c == z).all() for z in np.concatenate(
        [np.zeros((1, SMALL + C), np.uint64), zeros])])[0]) for g, c in zip(got, cts)}
    assert chosen != {0}, "the test's inputs must make the drift choose a zero encryption"


@pytest.mark.parametrize("c_dim,route", [(1, "lazy"), (2, "cluster"), (3, "cluster"),
                                         (4, "cluster"), (5, "cluster"), (6, "cluster"),
                                         (7, "cluster")])
def test_cm_rotation_routes_at_2_2(c_dim, route):
    """The CM rotation at the 2_2 shape (k = 1, N = 2048, l = 1): K2's lazy
    kernel at C = 1, its cluster kernel at C = 2 .. 7 (k + C = 3 .. 8: four
    blocks a ciphertext of 12,544 (k + C) B each, where one block of the
    generic kernel would need 200,704 B at k + C = 4 and more than a block
    may use from k + C = 5)."""
    k1 = 1 + c_dim
    assert kernels.exact_rotation_route(k1, 2048, 1, 23, k1 == 2) == route
    assert kernels.exact_smem_bytes(4, 2048, 1) == 200_704
    assert kernels.exact_smem_bytes(k1, 2048, 1, cluster=True) == 12_544 * k1
    if c_dim >= 4:
        assert kernels.exact_smem_bytes(k1, 2048, 1) > kernels.SMEM_LIMIT


@pytest.mark.parametrize("k1,n_poly", [(9, 2048), (6, 256), (9, 256)])
def test_cm_rotation_refuses_above_its_limit(k1, n_poly):
    """k + C = 9 at the 2_2 shape passes the cluster kernel's 8 rows; at
    small N no cluster shape applies and k + C > 5 passes the generic
    kernel's MAXK1: a ValueError naming both kernels' limits."""
    with pytest.raises(ValueError, match="generic kernel takes k\\+1 <= 5.*cluster kernel takes "
                                         "k\\+1 = 2, N = 8192, l <= 2 and 3 <= k\\+1 <= 8, "
                                         "N = 2048, l = 1"):
        kernels.exact_rotation_route(k1, n_poly, 1, 23, False)


@pytest.fixture(scope="module")
def wide_bootstrap_keys(lwe_keys, glwe_keys):
    """A CM bootstrap key at C = 4 (n = 10, k + C = 5, N = 256), the first C
    whose rotation no block of K2's generic kernel holds at the 2_2 widths:
    the C = 2 keys (LWE and GLWE) and two more of each in each package, and
    two CmLwes."""
    ref_gen, gen = _enc_gens(SEED + 14)
    ref_sec, sec = _gens(ref_rng, SEED + 4)[0], _gens(csprng, SEED + 4)[0]
    ref_small = lwe_keys["ref"][0] + [ref_kg.generate_binary_lwe_secret_key(SMALL, ref_sec)
                                      for _ in range(2)]
    small = lwe_keys["port"][0] + [kg.generate_binary_lwe_secret_key(SMALL, sec)
                                   for _ in range(2)]
    ref_sks = glwe_keys["ref"] + [ref_kg.generate_binary_glwe_secret_key(K, N, ref_sec)
                                  for _ in range(2)]
    sks = glwe_keys["port"] + [kg.generate_binary_glwe_secret_key(K, N, sec) for _ in range(2)]
    ref_bsk = ref_cm.generate_cm_lwe_bootstrap_key(ref_small, ref_sks, REF_TOY.pbs_decomp,
                                                   REF_TOY.glwe.noise, ref_gen)
    bsk = cm.generate_cm_lwe_bootstrap_key(small, sks, PBS, NOISE, gen, device="cpu")
    assert bsk.shape == (SMALL, 1, K + 4, K + 4, N) and (bsk == ref_bsk).all()
    ref_mont, plan = ref_cm.cm_bootstrap_key_to_ntt(ref_bsk)
    msgs = [[4, 11, 0, 9], [15, 7, 2, 1]]
    cts = np.stack([ref_cm.encrypt_cm_lwe(ref_small, _enc(row), REF_TOY.lwe.noise, ref_gen)
                    for row in msgs])
    return ref_mont, plan, msgs, cts, [sk.as_lwe_secret_key() for sk in sks]


def test_cm_bootstrap_c4(wide_bootstrap_keys):
    """One CM bootstrap at C = 4 (K2's accumulator entry's plain version at
    k+1 = 5, the cluster kernel's shape on the card) of two CmLwes with
    f(x) = (3x + 1) % 16: tfhe_tpu's words, every slot decrypted."""
    ref_mont, plan, msgs, cts, flat = wide_bootstrap_keys
    key = kg.NttKey.from_raw_keys(ref_mont, device="cpu")
    f = lambda x: (3 * x + 1) % 16  # noqa: E731
    lut = ref_srv.generate_lut(N, K + 1, 16, DELTA, f)[-1]
    want = np.asarray(REF_CM_BOOTSTRAP(jnp.asarray(cts), lut, jnp.asarray(ref_mont), plan, 24, 1,
                                       K))
    got = _np(cm.cm_bootstrap(_t(cts), _t(lut), key.data, key.dp, 24, 1, K))
    assert got.shape == (len(msgs), K * N + 4) and (got == want).all()
    assert [_dec(flat, row) for row in got] == [[f(m) for m in row] for row in msgs]
