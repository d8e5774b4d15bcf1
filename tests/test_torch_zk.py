"""The port's ZK stack against tfhe_tpu's on the CPU, word for word
(tolerance 0): the CRS of pke v1 (at tests/test_zk.py's D = 64) and of pke
v2 (at tests/test_zk_v2.py's D = 32, K = 2), proofs from the same seed,
proofs of either package verified by the other, the rejections (tampered
ciphertext, oversized noise, wrong metadata), the native curve
(csrc/bls446.cpp, built with g++ at first use) against the port's
pure-Python curve, and proven compact lists on the TEST set cut to n = 2,
N = 64 (tests/test_torch_compact_list.py's cut).

Each CRS is built once a module: the two parity CRSs by both packages; the
proven lists' v1 CRS is the D = 64 one (tfhe_tpu's, handed to the port),
their v2 CRS (D = 64) the port's, handed to tfhe_tpu.  Proofs are built
once and handed across through the conversion helpers."""

import dataclasses
import random

import numpy as np
import pytest
import torch

from tfhe_tpu import shortint as ref_shortint
from tfhe_tpu.hlapi import compact_list as ref_cl
from tfhe_tpu.hlapi import proven_compact_list as ref_pcl
from tfhe_tpu.zk import pke as ref_pke
from tfhe_tpu.zk import pke_v2 as ref_pke_v2
from tfhe_tpu_torch import shortint
from tfhe_tpu_torch.hlapi import compact_list as cl
from tfhe_tpu_torch.hlapi import proven_compact_list as pcl
from tfhe_tpu_torch.zk import curve446 as cv
from tfhe_tpu_torch.zk import pke, pke_v2

torch.set_num_threads(1)  # the suite runs in parallel processes: one thread each

M64 = 1 << 64
T, MSBS = 32, 1
SCHEMES = {"v1": (ref_pke, pke, 64, 2, 1 << 6), "v2": (ref_pke_v2, pke_v2, 32, 2, 1 << 5)}
SEED = 0x2C


def center(x: int) -> int:
    x &= M64 - 1
    return x - M64 if x >= M64 // 2 else x


def polymul_rev(a, b):
    d = len(a)
    c = [0] * d
    for i in range(d):
        for j in range(d):
            t = a[i] * b[d - j - 1]
            if i + j < d:
                c[i + j] += t
            else:
                c[i + j - d] -= t
    return c


def gen_testcase(rng: random.Random, d: int, k: int, b: int):
    """tests/test_zk.py's honest encryption (q = 2^64), in the port's
    commit types."""
    delta = M64 // T
    a = [center(rng.randrange(M64)) for _ in range(d)]
    s = [rng.randrange(2) for _ in range(d)]
    bb = [center(x + rng.randrange(-b, b)) for x in polymul_rev(a, s)]
    r = [rng.randrange(2) for _ in range(d)]
    e1 = [rng.randrange(-b, b) for _ in range(d)]
    e2 = [rng.randrange(-b, b) for _ in range(k)]
    m = [rng.randrange(T >> MSBS) for _ in range(k)]
    c1 = [center(x + e) for x, e in zip(polymul_rev(a, r), e1)]
    c2 = []
    for i in range(k):
        dot = sum(r[d - j - 1] * (bb[d - j - i - 1] if i + j < d else -bb[2 * d - j - i - 1])
                  for j in range(d))
        c2.append(center(dot + e2[i] + delta * m[i]))
    return pke.PublicCommit(a, bb, c1, c2), pke.PrivateCommit(r, e1, m, e2)


def convert(obj, cls):
    """A zk dataclass (CRS, proof, commit) handed to the other package."""
    return cls(**{f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)})


def as_tuple(obj) -> tuple:
    return tuple(getattr(obj, f.name) for f in dataclasses.fields(obj))


@pytest.fixture(scope="module")
def crs_pairs():
    """(tfhe_tpu's CRS, the port's) for each scheme.  The four generations
    run in threads: their power chains are native calls that release the
    GIL, and tfhe_tpu's run as one chain each."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(4) as pool:
        futures = {name: [pool.submit(m.crs_gen, d, k, b, 0, T, MSBS, seed=0x2A)
                          for m in (ref_mod, mod)]
                   for name, (ref_mod, mod, d, k, b) in SCHEMES.items()}
        return {name: tuple(f.result() for f in pair) for name, pair in futures.items()}


@pytest.fixture(scope="module", params=list(SCHEMES))
def scheme(request, crs_pairs):
    """Per scheme: both packages' CRS, the test case, and one proof of each
    package from the same seed (compute load "proof")."""
    ref_mod, mod, d, k, b = SCHEMES[request.param]
    ref_crs, crs = crs_pairs[request.param]
    pc, priv = gen_testcase(random.Random(7), d, k, b)
    ref_pc = convert(pc, ref_pke.PublicCommit)
    ref_priv = convert(priv, ref_pke.PrivateCommit)
    ref_proof = ref_mod.prove(ref_crs, ref_pc, ref_priv, metadata=b"meta", load="proof",
                              seed=b"s1")
    proof = mod.prove(crs, pc, priv, metadata=b"meta", load="proof", seed=b"s1")
    return {"name": request.param, "ref_mod": ref_mod, "mod": mod, "b": b, "k": k,
            "ref_crs": ref_crs, "crs": crs, "pc": pc, "priv": priv, "ref_pc": ref_pc,
            "ref_proof": ref_proof, "proof": proof}


def test_crs_is_tfhe_tpus(scheme):
    assert as_tuple(scheme["crs"]) == as_tuple(scheme["ref_crs"])


def test_same_seed_proofs_are_equal(scheme):
    assert as_tuple(scheme["proof"]) == as_tuple(scheme["ref_proof"])


def test_proofs_verify_across_packages(scheme):
    """Either package's proof verifies in the other (its CRS and commits
    handed across)."""
    s = scheme
    ref_proof_cls = type(s["ref_proof"])
    assert s["mod"].verify(convert(s["ref_proof"], type(s["proof"])),
                           convert(s["ref_crs"], type(s["crs"])), s["pc"], metadata=b"meta")
    assert s["ref_mod"].verify(convert(s["proof"], ref_proof_cls),
                               convert(s["crs"], type(s["ref_crs"])), s["ref_pc"],
                               metadata=b"meta")


def test_rejections(scheme):
    """Wrong metadata, a tampered ciphertext and an out-of-bound noise are
    rejected by the port, as by tfhe_tpu (the forged proof in compute load
    "verify")."""
    s = scheme
    mod, crs, pc, priv, proof = s["mod"], s["crs"], s["pc"], s["priv"], s["proof"]
    assert not mod.verify(proof, crs, pc, metadata=b"other")
    bad = pke.PublicCommit(pc.a, pc.b, pc.c1, [center(pc.c2[0] + 1)] + pc.c2[1:])
    assert not mod.verify(proof, crs, bad, metadata=b"meta")
    # a dishonest encryption: noise beyond the bound, c1 recomputed
    e1 = [priv.e1[0] + 40 * s["b"]] + priv.e1[1:]
    c1 = [center(x + e) for x, e in zip(polymul_rev(pc.a, priv.r), e1)]
    pc_big = pke.PublicCommit(pc.a, pc.b, c1, pc.c2)
    priv_big = pke.PrivateCommit(priv.r, e1, priv.m, priv.e2)
    if s["name"] == "v2":
        with pytest.raises(AssertionError):
            mod.prove(crs, pc_big, priv_big, metadata=b"m", load="verify", seed=b"s5")
        forged = mod.prove(crs, pc_big, priv_big, metadata=b"m", load="verify", seed=b"s5",
                           _sanity_check=False)
    else:
        forged = mod.prove(crs, pc_big, priv_big, metadata=b"m", load="verify", seed=b"s5")
    assert not mod.verify(forged, crs, pc_big, metadata=b"m")


def test_native_curve_against_plain():
    """csrc/bls446.cpp's scalar multiplication, MSMs, power chains and
    pairings against the pure-Python curve; the power chain cut into
    threads against one native chain."""
    import ctypes

    rng = random.Random(11)
    k = rng.randrange(cv.R)
    g1 = [cv.g1_mul(cv.G1_GEN, rng.randrange(cv.R)) for _ in range(6)]
    g2 = [cv.g2_mul(cv.G2_GEN, rng.randrange(cv.R)) for _ in range(4)]
    scalars = [rng.randrange(cv.R) for _ in range(6)]
    assert cv.g1_mul(cv.G1_GEN, k) == cv.g1_mul_plain(cv.G1_GEN, k)
    assert cv.g2_mul(cv.G2_GEN, k) == cv.g2_mul_plain(cv.G2_GEN, k)
    assert cv.msm_g1(g1, scalars) == cv.msm_g1_plain(g1, scalars)
    assert cv.msm_g2(g2, scalars[:4]) == cv.msm_g2_plain(g2, scalars[:4])
    assert cv.g1_powers(cv.G1_GEN, k, 5, 2) == cv.g1_powers_plain(cv.G1_GEN, k, 5, 2)
    assert cv.g2_powers(cv.G2_GEN, k, 4, 1) == cv.g2_powers_plain(cv.G2_GEN, k, 4, 1)
    one = ctypes.create_string_buffer(112 * 300)
    cv.native().bls446_g1_powers(cv._pt1_pack(g1[0]), cv._sc_pack(k), 300, 131, one)
    assert cv.g1_powers(g1[0], k, 300, 131) == [
        cv._pt1_unpack(one.raw[112 * i:112 * (i + 1)]) for i in range(300)]
    pairs = list(zip(g1[:2], g2[:2])) + [(None, g2[2])]
    assert cv.pairing_product(pairs) == cv.pairing_product_plain(pairs)
    assert cv.pairing(g1[0], None) == cv.pairing_plain(g1[0], None) == cv.F12_ONE


def test_native_curve_is_built_here_and_a_failed_build_raises(monkeypatch):
    """The library is the port's own build of csrc/bls446.cpp (never
    native/libtfhe_bls446.so); if the build fails, native() raises and
    nothing falls back to the pure-Python curve."""
    import pathlib

    from tfhe_tpu_torch.utils import build

    assert pathlib.Path(cv.native()._name).parent == build.BUILD_DIR
    assert "libtfhe_bls446" not in cv.native()._name

    def failed_build(specs):
        raise RuntimeError("building tfhe_torch_bls446 failed")

    monkeypatch.setattr(cv._Native, "lib", None)
    monkeypatch.setattr(build, "build_shared_libraries", failed_build)
    with pytest.raises(RuntimeError, match="building"):
        cv.native()
    with pytest.raises(RuntimeError, match="building"):
        cv.g1_mul(cv.G1_GEN, 3)


# ---------------------------------------------------------------------------
# Proven compact lists on the cut TEST set
# ---------------------------------------------------------------------------


def cut(mod):
    return dataclasses.replace(mod.TEST_PARAM_MESSAGE_2_CARRY_2, lwe_dimension=2,
                               polynomial_size=64)


@pytest.fixture(scope="module")
def lists(scheme):
    """One proven list of each package from one seed under tfhe_tpu's compact
    public key (handed to the port), on a CRS handed across."""
    rck = ref_shortint.ClientKey(cut(ref_shortint), seed=SEED)
    ref_cpk = ref_cl.CompactPublicKey(rck, seed=SEED + 1)
    cpk = cl.CompactPublicKey.from_raw_parts(cut(shortint), ref_cpk.a, ref_cpk.b, False)
    if scheme["name"] == "v1":
        ref_crs = ref_pcl.CompactPkeCrs(scheme["ref_crs"], "v1")
        crs = pcl.CompactPkeCrs(convert(scheme["ref_crs"], pke.PublicParams), "v1")
    else:
        crs = pcl.CompactPkeCrs.new(cut(shortint), 2, seed=SEED + 2, scheme="v2")
        ref_crs = ref_pcl.CompactPkeCrs(convert(crs.params, ref_pke_v2.PublicParams), "v2")
    msgs = [13, 6]
    ref_lst = ref_pcl.build_with_proof(ref_cpk, msgs, ref_crs, b"md", seed=SEED + 3)
    lst = pcl.build_with_proof(cpk, msgs, crs, b"md", seed=SEED + 3)
    return {"rck": rck, "ref_cpk": ref_cpk, "cpk": cpk, "ref_crs": ref_crs, "crs": crs,
            "ref_lst": ref_lst, "lst": lst, "msgs": msgs}


def test_proven_list_words_and_proof(lists):
    r, p = lists["ref_lst"], lists["lst"]
    assert (p.c1 == r.c1).all() and (p.c2 == r.c2).all()
    assert as_tuple(p.proof) == as_tuple(r.proof)
    assert (p.message_modulus, p.carry_modulus) == (r.message_modulus, r.carry_modulus)


def test_proven_list_verify_and_expand(lists, scheme):
    """The port verifies its list (the same words and proof as tfhe_tpu's)
    and expands it in one batched extraction (slot i at coefficient d-1-i)
    to tfhe_tpu's words; tfhe_tpu verifies the port's list; a tampered body
    is refused."""
    r, p, crs = lists["ref_lst"], lists["lst"], lists["crs"]
    got = p.verify_and_expand(crs, lists["cpk"], b"md", device="cpu")
    want = r.expand_without_verification()
    assert (np.stack([np.asarray(c.data) for c in got])
            == np.stack([np.asarray(c.data) for c in want])).all()
    assert [(c.degree, c.noise_level) for c in got] == [(c.degree, c.noise_level)
                                                      for c in want]
    assert [lists["rck"].decrypt_raw(c) for c in got] == lists["msgs"]
    ported = ref_pcl.ProvenCompactCiphertextList(
        p.c1, p.c2, convert(p.proof, type(r.proof)), p.message_modulus, p.carry_modulus)
    assert ported.verify(lists["ref_crs"], lists["ref_cpk"], b"md")
    bad = dataclasses.replace(p, c2=p.c2 + np.uint64(1))
    with pytest.raises(ValueError, match="invalid"):
        bad.verify_and_expand(crs, lists["cpk"], b"md", device="cpu")
