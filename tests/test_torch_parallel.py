"""Multi-device on the CPU: the port's parallel/ against tfhe_tpu's, word for
word (tolerance 0; all arithmetic is integer).  The port's meshes are D
"cpu" slots driven by this one process; tfhe_tpu's run on its 8-device
virtual CPU mesh (tests/conftest.py).

- the split's tables, and the poly-sharded product at N = 64, D = 2, 4, 8
  against tfhe_tpu's on its 8-device mesh;
  the key's evaluation slices in tfhe_tpu's layout at N = 64, D = 2, 4, 8;
- the poly-sharded blind rotation at tests/test_poly_shard.py's shapes
  (n_in = 4, N = 512) at D = 1, 2, 4 and 8 against tfhe_tpu's ops/server.py
  blind_rotate, on both routes; a numpy model of K9's fused kernel (its
  blocks' index arithmetic, phase by phase) against the same words and,
  at l = 2, k+1 = 3, against the plain step loop; the route and plan of
  the fused entry;
- the batch mesh's three entries on 3 and 4 slots (an uneven batch)
  against the unsharded pipeline at the TEST set cut to n = 2, N = 64, and
  sharded_ks_pbs against tfhe_tpu's on 4 devices;
- the latency route's FheUint8 add against tfhe_tpu's with its latency
  mesh set, the pod scaffolding, and K9's plain entries against a model of
  the four steps in Python integers."""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfhe_tpu import integer as ref_integer
from tfhe_tpu import shortint as ref_shortint
from tfhe_tpu.core import keygen as ref_kg
from tfhe_tpu.core.params import DecompParams as RefDecomp
from tfhe_tpu.ops import ntt as ref_ntt
from tfhe_tpu.ops import server as ref_srv
from tfhe_tpu.parallel import mesh as ref_mesh
from tfhe_tpu.parallel import multihost as ref_mh
from tfhe_tpu.parallel import poly_shard as ref_ps
from tfhe_tpu.utils import csprng as ref_rng
from tfhe_tpu_torch import integer, shortint
from tfhe_tpu_torch.ops import bsk_prep, four_step, kernels, ntt, torus
from tfhe_tpu_torch.ops import server as srv
from tfhe_tpu_torch.parallel import mesh, multihost
from tfhe_tpu_torch.parallel import poly_shard as ps

torch.set_num_threads(1)  # the suite runs in parallel processes: one thread each

SEED = 0x9E5


def cpu_mesh(d: int, axis: str = "poly"):
    return mesh.make_mesh(["cpu"] * d, axis)


def ref_cpu_mesh(d: int, axis: str = "poly"):
    return ref_mesh.make_mesh(jax.devices()[:d], axis_name=axis)


def words(x) -> np.ndarray:
    return torus.to_u64(x)


# ---------------------------------------------------------------------------
# the four-step split
# ---------------------------------------------------------------------------


def test_tables_equal_tfhe_tpus():
    got, want = ps.make_poly_shard_tables(64, 4), ref_ps.make_poly_shard_tables(64, 4)
    for key in ("tw_f", "tw_i", "twd_f", "twd_i", "vc_f", "vc_i", "vd_f", "vd_i"):
        assert got[key].dtype == torch.int64
        assert (got[key].numpy() == want[key].astype(np.int64)).all(), key
    assert got["plan"].primes == want["plan"].primes


@pytest.fixture(scope="module")
def polymul_case():
    """Two batches of random u64 polynomials at N = 64 and tfhe_tpu's
    poly-sharded product of them on its 8-device CPU mesh (the product's
    words do not depend on the split)."""
    rng = np.random.default_rng(3)
    a = rng.integers(0, 1 << 64, (3, 64), dtype=np.uint64)
    b = rng.integers(0, 1 << 64, (3, 64), dtype=np.uint64)
    want = np.asarray(ref_ps.sharded_negacyclic_polymul(ref_cpu_mesh(8), jnp.asarray(a),
                                                        jnp.asarray(b), 4))
    return a, b, want


@pytest.mark.parametrize("d", [2, 4, 8])
def test_sharded_polymul(polymul_case, d):
    a, b, want = polymul_case
    got = ps.sharded_negacyclic_polymul(cpu_mesh(d), torus.from_u64(a, "cpu"),
                                        torus.from_u64(b, "cpu"))
    assert (words(got) == want).all()
    assert (words(got) == ntt.negacyclic_polymul_u64(a, b, ntt.make_plan(64, 4))).all()


@pytest.mark.parametrize("d", [2, 4, 8])
def test_prepare_bsk_layout(d):
    rng = np.random.default_rng(10 + d)
    bsk = rng.integers(0, 1 << 64, (3, 1, 2, 2, 64), dtype=np.uint64)
    want = np.asarray(ref_ps.prepare_bsk_poly_sharded(ref_cpu_mesh(d), jnp.asarray(bsk), 4))
    key = ps.prepare_bsk_poly_sharded(cpu_mesh(d), bsk)
    assert len(key.parts) == d and key.parts[0].shape == (3, 1, 2, 2, 4, 64 // d)
    assert (key.gather().numpy() == want.astype(np.int64)).all()
    # the slots share the CPU: one tensor, the parts views of it
    assert key.whole.shape == (d, 3, 1, 2, 2, 4, 64 // d)
    storage = key.whole.untyped_storage().data_ptr()
    assert all(p.untyped_storage().data_ptr() == storage for p in key.parts)
    assert key.nbytes == key.whole.numel() * 4 == bsk.size * 4 * 4   # 4 primes, int32


N_ROT = 512


@pytest.fixture(scope="module")
def rotation():
    """tests/test_poly_shard.py's shapes: a real key at n_in = 4, N = 512,
    three random inputs and tfhe_tpu's exact rotation of them
    (ops/server.py blind_rotate)."""
    n_in, k_glwe, bl, lev = 4, 1, 23, 1
    gen_s = ref_rng.SecretRandomGenerator(123)
    lwe_sk = ref_kg.generate_binary_lwe_secret_key(n_in, gen_s)
    glwe_sk = ref_kg.generate_binary_glwe_secret_key(k_glwe, N_ROT, gen_s)
    gen_e = ref_rng.EncryptionRandomGenerator(7, ref_rng.DeterministicSeeder(99))
    bsk = ref_kg.generate_lwe_bootstrap_key(lwe_sk, glwe_sk, RefDecomp(bl, lev),
                                            ref_rng.TUniform(3), gen_e)
    bsk_mont, plan = ref_kg.bootstrap_key_to_ntt(bsk)
    rng = np.random.default_rng(5)
    mask = rng.integers(0, 2 * N_ROT, (3, n_in), dtype=np.uint64)
    body = rng.integers(0, 2 * N_ROT, (3,), dtype=np.uint64)
    lut = rng.integers(0, 1 << 64, (3, k_glwe + 1, N_ROT), dtype=np.uint64)
    want = np.asarray(ref_srv.blind_rotate(
        jnp.asarray(mask), jnp.asarray(body), jnp.asarray(lut),
        jnp.asarray(bsk_mont).astype(jnp.uint64), plan, bl, lev))
    return dict(bsk=np.asarray(bsk.data), mask=mask, body=body, lut=lut, want=want, bl=bl,
                lev=lev)


@pytest.mark.parametrize("d", [1, 2, 4, 8])
def test_sharded_blind_rotate(rotation, d):
    r = rotation
    key = ps.prepare_bsk_poly_sharded(cpu_mesh(d), r["bsk"])
    got = ps.sharded_blind_rotate_poly(
        cpu_mesh(d), torch.from_numpy(r["mask"].astype(np.int64)),
        torch.from_numpy(r["body"].astype(np.int64)), torus.from_u64(r["lut"], "cpu"), key,
        r["bl"], r["lev"])
    assert (words(got) == r["want"]).all()


def test_sharded_blind_rotate_steps_route(rotation, monkeypatch):
    """The route of slots on distinct devices (K9's step entries, on the CPU
    their plain versions), forced on a CPU mesh."""
    r = rotation
    calls = []

    def steps(*a):
        calls.append(a)
        return "steps"

    monkeypatch.setattr(kernels, "poly_rotation_route", steps)
    key = ps.prepare_bsk_poly_sharded(cpu_mesh(4), r["bsk"])
    got = ps.sharded_blind_rotate_poly(
        cpu_mesh(4), torch.from_numpy(r["mask"].astype(np.int64)),
        torch.from_numpy(r["body"].astype(np.int64)), torus.from_u64(r["lut"], "cpu"), key,
        r["bl"], r["lev"])
    assert len(calls) == 1 and (words(got) == r["want"]).all()


# ---------------------------------------------------------------------------
# K9's fused entry: its route, its plan and a model of its kernel
# ---------------------------------------------------------------------------


def test_poly_rotation_route():
    cuda0, cuda1 = torch.device("cuda", 0), torch.device("cuda", 1)
    for d in (1, 2, 4, 8):
        assert kernels.poly_rotation_route([cuda0] * d, d, 2, 1, 2048) == "fused"
    assert kernels.poly_rotation_route(["cuda:0", "cuda:1"], 2, 2, 1, 2048) == "steps"
    assert kernels.poly_rotation_route([cuda0, cuda1] * 2, 4, 9, 9, 2048) == "steps"
    assert kernels.poly_rotation_route(["cpu"] * 4, 4, 2, 1, 512) == "fused"
    for args, limit in (((16, 2, 1, 2048), "D in 1, 2, 4, 8"), ((4, 9, 1, 2048), "k+1 <= 8"),
                        ((4, 2, 9, 2048), "l <= 8"), ((8, 2, 1, 32), "D^2 must divide N"),
                        ((4, 2, 1, 1 << 16), "C = N / D from 8 to 8192"),
                        ((2, 2, 1, 8), "C = N / D from 8 to 8192")):
        with pytest.raises(ValueError, match=limit.replace("^", r"\^").replace("+", r"\+")):
            kernels.poly_rotation_route([cuda0] * args[0], *args)


def test_poly_rotate_plan(monkeypatch):
    """kernels.poly_rotate_plan reads the fused kernel's own plan
    (csrc/poly_shard.cu rotate_plan, through its C query) once a device and
    shape, and refuses a shape of which the card holds no cluster (the
    plan's figures are checked on the card by chip_smoke.py)."""
    asked = []

    class Lib:
        clusters = 9

        def tfhe_torch_poly_shard_rotate_plan(self, d, k1, levels, log_c, out):
            asked.append((d, k1, levels, log_c))
            for i, v in enumerate((1, 4, 4 * d, 0, 180224 // d, 4096, self.clusters)):
                out[i] = v
            return 0

    lib = Lib()
    monkeypatch.setattr(kernels, "load", lambda: {"poly_shard": lib})
    monkeypatch.setattr(torch.cuda, "device", lambda index: contextlib.nullcontext())
    kernels.poly_rotate_plan.cache_clear()
    try:
        plan = kernels.poly_rotate_plan(0, 2, 2, 1, 2048)
        assert plan == {"primes_per_block": 1, "blocks_per_slot": 4, "cluster": 8, "tier": 0,
                        "shared_memory_bytes": 90112, "block_bytes": 4096,
                        "active_clusters": 9, "threads": 512}
        assert kernels.poly_rotate_plan(0, 2, 2, 1, 2048) == plan and asked == [(2, 2, 1, 10)]
        lib.clusters = 0
        with pytest.raises(RuntimeError, match="holds 0 clusters .* D = 4, k\\+1 = 7, l = 3"):
            kernels.poly_rotate_plan(0, 4, 7, 3, 2048)
    finally:
        kernels.poly_rotate_plan.cache_clear()


def _bit_reverse(log_c: int) -> np.ndarray:
    i = np.arange(1 << log_c)
    out = np.zeros_like(i)
    for b in range(log_c):
        out |= ((i >> b) & 1) << (log_c - 1 - b)
    return out


def fused_model(mask, body, lut, key, t, base_log: int, levels: int) -> np.ndarray:
    """csrc/poly_shard.cu ps_rotate_kernel's arithmetic in numpy: each
    block's (slot a, prime group q) state and index formulas, each phase
    run on every block of the cluster before the next (the barriers), the
    Montgomery products as x y R^-1 mod p.  mask (B, n), body (B,), lut
    (B, k+1, N) u64, key (D, n, l, k+1, k+1, P, C); returns the words."""
    d, c_len, n_poly = t.d, t.c, t.n
    b_n, k1, _ = lut.shape
    primes = np.array(t.dp.plan.primes, dtype=np.int64)
    # the kernel's placement (rotate_plan): one prime a block, two where D P
    # blocks pass the 16 a cluster holds (D = 8)
    ppb = max(1, d * len(primes) // 16)
    bps, csize = len(primes) // ppb, d * len(primes) // ppb
    rows, cd, cq, log_c = levels * k1, c_len // d, c_len // bps, c_len.bit_length() - 1
    rinv = np.array([pow(1 << 32, -1, int(p)) for p in primes], dtype=np.int64)
    tab = t.packed.numpy().astype(np.int64)                       # (D, P, 6, C)
    cross = t.packed_cross.numpy().astype(np.int64)               # (P, 2, D)
    key = np.asarray(key, dtype=np.int64)
    rev = _bit_reverse(log_c)

    def mm(x, y, pi):
        p = primes[pi]
        return x * y % p * rinv[pi] % p

    slot_of = lambda rank: (rank // bps, rank % bps, rank % bps * ppb)  # noqa: E731
    out = np.empty_like(lut)
    for ct in range(b_n):
        words = np.empty((csize, k1, c_len), dtype=np.uint64)
        bd = int(body[ct]) % (2 * n_poly)
        for rank in range(csize):
            a = slot_of(rank)[0]
            s = a + d * np.arange(c_len) + bd % n_poly
            neg = (bd >= n_poly) ^ (s >= n_poly)
            v = lut[ct][:, np.where(s >= n_poly, s - n_poly, s)]
            words[rank] = np.where(neg, np.uint64(0) - v, v)
        fr = np.zeros((csize, ppb * rows * c_len), dtype=np.int64)
        xr = np.zeros_like(fr)
        for step in range(mask.shape[1]):
            m = int(mask[ct, step]) % (2 * n_poly)
            rot, odd = m % n_poly, m >= n_poly
            e = np.arange(k1 * c_len)
            r, c = e // c_len, e % c_len
            for rank in range(csize):                    # 1. rotation, digits, twist
                a, q, p0 = slot_of(rank)
                s = a + d * c - rot
                neg = odd ^ (s < 0)
                s = np.where(s < 0, s + n_poly, s)
                v = words[(s % d) * bps + q, r, s // d]
                diff = np.where(neg, np.uint64(0) - v, v) - words[rank, r, c]
                digits = srv.signed_decompose(torch.from_numpy(diff.view(np.int64)), base_log,
                                              levels).numpy()
                for lev in range(levels):
                    for lp in range(ppb):
                        res = digits[lev] % primes[p0 + lp]
                        fr[rank, (lp * rows + lev * k1 + r) * c_len + rev[c]] = mm(
                            res, tab[a, p0 + lp, 0, c], p0 + lp)
            for rank in range(csize):                    # 2. size-C butterflies
                a, q, p0 = slot_of(rank)
                f = fr[rank].reshape(ppb, rows, c_len)
                for s in range(1, log_c + 1):
                    half, stride = 1 << (s - 1), c_len >> s
                    u = np.arange(c_len // 2)
                    j = u & (half - 1)
                    b0 = ((u >> (s - 1)) << s) + j
                    for lp in range(ppb):
                        x = f[lp][:, b0]
                        y = mm(f[lp][:, b0 + half], tab[a, p0 + lp, 2, j * stride], p0 + lp)
                        f[lp][:, b0] = (x + y) % primes[p0 + lp]
                        f[lp][:, b0 + half] = (x - y) % primes[p0 + lp]
            for rank in range(csize):                    # 3. twiddle, first exchange
                a, q, p0 = slot_of(rank)
                e3 = np.arange(ppb * rows * c_len)
                row, k2 = e3 // c_len, e3 % c_len
                lp = row // rows
                v = mm(fr[rank], tab[a, p0 + lp, 1, k2], p0 + lp)
                xr[(k2 // cd) * bps + q, row * c_len + (k2 % cd) * d + a] = v
            for rank in range(csize):                    # 4. size-D transform
                a, q, p0 = slot_of(rank)
                x = xr[rank].reshape(ppb, rows, cd, d).copy()
                for lp in range(ppb):
                    for kk in range(d):
                        acc = sum(mm(x[lp][..., i], cross[p0 + lp, 0, (i * kk) % d], p0 + lp)
                                  for i in range(d))
                        xr[rank].reshape(ppb, rows, cd, d)[lp][..., kk] = acc % primes[p0 + lp]
            for rank in range(csize):                    # 5. key product
                a, q, p0 = slot_of(rank)
                x = xr[rank].reshape(ppb, rows, c_len)
                for lp in range(ppb):
                    kk = key[a, step][..., p0 + lp, :].reshape(rows, k1, c_len)
                    prod = [sum(mm(x[lp][row], kk[row, ro], p0 + lp) for row in range(rows))
                            % primes[p0 + lp] for ro in range(k1)]
                    x[lp][:k1] = prod
            for rank in range(csize):                    # 6. size-D inverse, second exchange
                a, q, p0 = slot_of(rank)
                x = xr[rank].reshape(ppb, rows, cd, d)
                for lp in range(ppb):
                    for t_ in range(d):
                        acc = sum(mm(x[lp][:k1, :, i], cross[p0 + lp, 1, (i * t_) % d], p0 + lp)
                                  for i in range(d)) % primes[p0 + lp]
                        y = fr[t_ * bps + q][:ppb * k1 * c_len].reshape(ppb, k1, c_len)
                        y[lp][:, a * cd:(a + 1) * cd] = acc
            for rank in range(csize):                    # 7. inverse butterflies
                a, q, p0 = slot_of(rank)
                f = fr[rank][:ppb * k1 * c_len].reshape(ppb, k1, c_len)
                for s in range(log_c, 0, -1):
                    half, stride = 1 << (s - 1), c_len >> s
                    u = np.arange(c_len // 2)
                    j = u & (half - 1)
                    b0 = ((u >> (s - 1)) << s) + j
                    for lp in range(ppb):
                        x, y = f[lp][:, b0], f[lp][:, b0 + half]
                        if s == log_c:
                            x = mm(x, tab[a, p0 + lp, 3, b0], p0 + lp)
                            y = mm(y, tab[a, p0 + lp, 3, b0 + half], p0 + lp)
                        f[lp][:, b0] = (x + y) % primes[p0 + lp]
                        f[lp][:, b0 + half] = mm((x - y) % primes[p0 + lp],
                                                 tab[a, p0 + lp, 5, j * stride], p0 + lp)
            for rank in range(csize):                    # 8. inverse twist, to Garner
                a, q, p0 = slot_of(rank)
                e8 = np.arange(ppb * k1 * c_len)
                row, c8 = e8 // c_len, e8 % c_len
                lp, ro = row // k1, row % k1
                v = mm(fr[rank][row * c_len + rev[c8]], tab[a, p0 + lp, 4, c8], p0 + lp)
                xr[a * bps + c8 // cq, (ro * cq + c8 % cq) * 4 + p0 + lp] = v
            new = words.copy()
            for rank in range(csize):                    # 9. Garner into every copy
                a, q, p0 = slot_of(rank)
                g = xr[rank][:k1 * cq * 4].reshape(k1 * cq, 4).T.copy()
                add = ntt.garner_to_u64(torch.from_numpy(g), t.dp).numpy().view(np.uint64)
                w = words[rank][:, q * cq:(q + 1) * cq] + add.reshape(k1, cq)
                for t_ in range(bps):
                    new[a * bps + t_][:, q * cq:(q + 1) * cq] = w
            words = new
        for rank in range(csize):
            a, q, _ = slot_of(rank)
            out[ct][:, a + d * (q * cq + np.arange(cq))] = words[rank][:, q * cq:(q + 1) * cq]
    return out


@pytest.mark.parametrize("d", [1, 2, 4, 8])
def test_fused_kernel_model(rotation, d):
    r = rotation
    key = ps.prepare_bsk_poly_sharded(cpu_mesh(d), r["bsk"])
    got = fused_model(r["mask"], r["body"], r["lut"], key.whole.numpy(),
                      four_step.device_tables(N_ROT, d, "cpu"), r["bl"], r["lev"])
    assert (got == r["want"]).all()


def test_fused_kernel_model_levels():
    """l = 2, k+1 = 3 at N = 64 (D = 4; and D = 8, two primes a block): the
    model against the fused entry's plain version, the step loop."""
    rng = np.random.default_rng(21)
    n_poly, k1, levels, base_log, n_steps = 64, 3, 2, 9, 3
    bsk = rng.integers(0, 1 << 64, (n_steps, levels, k1, k1, n_poly), dtype=np.uint64)
    mask = rng.integers(0, 2 * n_poly, (2, n_steps))
    body = rng.integers(0, 2 * n_poly, (2,))
    lut = rng.integers(0, 1 << 64, (2, k1, n_poly), dtype=np.uint64)
    for d in (4, 8):
        key = ps.prepare_bsk_poly_sharded(cpu_mesh(d), bsk)
        t = four_step.device_tables(n_poly, d, "cpu")
        want = kernels.poly_shard_rotate(torch.from_numpy(mask), torch.from_numpy(body),
                                         torus.from_u64(lut, "cpu"), key.whole, t, base_log,
                                         levels)
        got = fused_model(mask, body, lut, key.whole.numpy(), t, base_log, levels)
        assert (got == words(want)).all()


def test_k9_phase_copy_marks_every_cluster_barrier(tmp_path, monkeypatch):
    """tools/phase_cycles.py k9 tables the fused kernel from a copy of
    csrc/poly_shard.cu with a block barrier on each side of each of its
    cluster barriers (so each barrier's wait is a row of its own); the copy
    changes nothing else."""
    import importlib.util
    import re

    from tfhe_tpu_torch.utils.build import CSRC

    spec = importlib.util.spec_from_file_location(
        "phase_cycles", CSRC.parents[1] / "tools" / "phase_cycles.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    monkeypatch.setattr(tool, "HERE", tmp_path)
    src = (CSRC / "poly_shard.cu").read_text()
    got = tool.marked_cluster_source("poly_shard", "ps_rotate_kernel(const RotateArgs g)",
                                     "// The fused kernel's attributes",
                                     r"cluster_barrier\(global\);").read_text()
    marked = r"\n( *)__syncthreads\(\);\n\1(cluster_barrier\(global\);)\n\1__syncthreads\(\);"
    assert len(re.findall(marked, got)) == src.count("cluster_barrier(global);") == 5
    assert re.sub(marked, r"\n\1\2", got) == src


# ---------------------------------------------------------------------------
# K9's plain entries against a model of the four steps in Python integers
# ---------------------------------------------------------------------------


def _roots(n: int, p: int) -> tuple:
    psi = pow(ref_ntt._find_generator(p), (p - 1) // (2 * n), p)
    return psi, psi * psi % p


def test_k9_plain_entries_against_a_model():
    n, d, levels, base_log = 64, 4, 2, 12
    c, cd = n // d, n // d // d
    t = four_step.device_tables(n, d, "cpu")
    primes = t.dp.plan.primes
    rng = np.random.default_rng(7)
    slot = 3
    x = rng.integers(0, 1 << 64, (2, c), dtype=np.uint64)
    digits = np.asarray(ref_srv.signed_decompose(jnp.asarray(x), base_log, levels, 64))
    digits = digits.view(np.int64)                                     # (L, M, C)
    got = kernels.poly_shard_forward(torus.from_u64(x, "cpu"), t, slot, levels, base_log)
    for pi, p in enumerate(primes):
        psi, om = _roots(n, p)
        for lev in range(levels):
            for m in range(2):
                for k2 in range(c):
                    s = sum(int(digits[lev, m, cc]) * pow(psi, slot + d * cc, p)
                            * pow(om, d * cc * k2, p) for cc in range(c))
                    assert int(got[lev, m, pi, k2]) == s * pow(om, slot * k2, p) % p
    # entry (b): batch 2, k+1 = 2, one level, a random key slice
    ya = np.stack([rng.integers(0, p, (d, 1, 4, cd)) for p in primes], axis=3)
    key = np.stack([rng.integers(0, p, (1, 2, 2, c)) for p in primes], axis=3)
    out = kernels.poly_shard_cross(torch.from_numpy(ya.astype(np.int32)), t,
                                   torch.from_numpy(key.astype(np.int32)), batch=2, k1=2)
    for pi, p in enumerate(primes):
        _, om = _roots(n, p)
        r_inv = pow(1 << 32, -1, p)
        omc, omc_i = pow(om, c, p), pow(om, -c, p)
        for bb in range(2):
            for k2loc in range(cd):
                prod = [[0] * d for _ in range(2)]
                for k1 in range(d):
                    x2 = [sum(int(ya[a, 0, bb * 2 + r, pi, k2loc]) * pow(omc, a * k1, p)
                              for a in range(d)) % p for r in range(2)]
                    for ro in range(2):
                        prod[ro][k1] = sum(x2[r] * int(key[0, r, ro, pi, k2loc * d + k1])
                                           * r_inv for r in range(2)) % p
                for ro in range(2):
                    for a in range(d):
                        want = sum(prod[ro][k1] * pow(omc_i, k1 * a, p)
                                   for k1 in range(d)) * pow(d, -1, p) % p
                        assert int(out[a, bb, ro, pi, k2loc]) == want
    # entry (c): Garner of the slot's inverse
    yb = np.stack([rng.integers(0, p, (d, 2, cd)) for p in primes], axis=2)
    got = words(kernels.poly_shard_inverse(torch.from_numpy(yb.astype(np.int32)), t, slot))
    prod_p = int(np.prod([int(p) for p in primes], dtype=object))
    for m in range(2):
        for cc in range(c):
            res = []
            for pi, p in enumerate(primes):
                psi, om = _roots(n, p)
                s = sum(int(yb[k2 // cd, m, pi, k2 % cd]) * pow(om, -slot * k2, p)
                        * pow(om, -d * k2 * cc, p) for k2 in range(c))
                res.append(s * pow(c, -1, p) * pow(psi, -(slot + d * cc), p) % p)
            crt = sum(r * (prod_p // p) * pow(prod_p // p, -1, p)
                      for r, p in zip(res, primes)) % prod_p
            if crt > prod_p // 2:
                crt -= prod_p
            assert int(got[m, cc]) == crt % (1 << 64)


# ---------------------------------------------------------------------------
# the batch mesh
# ---------------------------------------------------------------------------

CUT = dict(lwe_dimension=2, polynomial_size=64)


@pytest.fixture(scope="module")
def batch_case():
    """A server key of the cut TEST set in both packages, 7 ciphertexts and
    a LUT; the port's unsharded exact and v7 outputs."""
    p = dataclasses.replace(shortint.TEST_PARAM_MESSAGE_2_CARRY_2, **CUT)
    ck = shortint.ClientKey(p, seed=SEED)
    sk = shortint.ServerKey(ck, seed=SEED + 1, device="cpu")
    cts = torch.stack([torus.from_u64(ck.encrypt(m % 4).data, "cpu") for m in range(8)])
    lut = torus.from_u64(sk.generate_lookup_table(lambda v: (3 * v + 1) % 4).acc, "cpu")
    luts = lut[None].expand(8, -1, -1).contiguous()
    args = (p.ks_base_log, p.ks_level, p.pbs_base_log, p.pbs_level)
    centered = p.ms_noise_reduction == shortint.MsNoiseReduction.CENTERED_MEAN
    rounded = bsk_prep.rounded_key_ntt(sk._bsk_coeff.data, 15, p.pbs_base_log, "cpu")
    exact = srv.ks_pbs_batch(cts, luts, sk.ks_key, sk.bsk_ntt, sk.dp, *args,
                             centered_ms=centered)
    v7 = srv.ks_pbs_batch(cts, luts, sk.ks_key, rounded, rounded.dp, *args,
                          centered_ms=centered, trunc_acc=True)
    return dict(p=p, ck=ck, sk=sk, cts=cts, luts=luts, args=args, centered=centered,
                rounded=rounded, exact=exact, v7=v7)


@pytest.mark.parametrize("slots,batch", [(3, 7), (4, 8)])
@pytest.mark.parametrize("entry", ["sharded_ks_pbs", "sharded_ks_pbs_shard_map",
                                   "sharded_ks_pbs_mxu"])
def test_batch_mesh_entries(batch_case, entry, slots, batch):
    c = batch_case
    m = cpu_mesh(slots, "batch")
    before = mesh.replicate.uploads
    mxu = entry.endswith("mxu")
    key, dp = (c["rounded"], c["rounded"].dp) if mxu else (c["sk"].bsk_ntt, c["sk"].dp)
    got = getattr(mesh, entry)(m, c["cts"][:batch], c["luts"][:batch], c["sk"].ks_key, key, dp,
                               *c["args"], centered_ms=c["centered"])
    want = c["v7" if mxu else "exact"][:batch]
    assert (got == want).all()
    assert mesh.replicate.uploads == before         # every slot on the keys' device
    p = c["p"]
    for row, msg in zip(words(got), range(batch)):
        dec = c["ck"].decrypt(shortint.Ciphertext(
            row, degree=3, noise_level=1, message_modulus=p.message_modulus,
            carry_modulus=p.carry_modulus))
        assert dec == (3 * (msg % 4) + 1) % 4


def test_sharded_ks_pbs_equals_tfhe_tpus(batch_case):
    c = batch_case
    ref_p = dataclasses.replace(ref_shortint.TEST_PARAM_MESSAGE_2_CARRY_2, **CUT)
    ref_sk = ref_shortint.ServerKey(ref_shortint.ClientKey(ref_p, seed=SEED), seed=SEED + 1)
    want = np.asarray(ref_mesh.sharded_ks_pbs(
        ref_cpu_mesh(4, "batch"), jnp.asarray(words(c["cts"])), jnp.asarray(words(c["luts"])),
        ref_sk.ksk, ref_sk.bsk_mont, ref_sk.plan, *c["args"], 64, c["centered"]))
    got = mesh.sharded_ks_pbs(cpu_mesh(4, "batch"), c["cts"], c["luts"], c["sk"].ks_key,
                              c["sk"].bsk_ntt, c["sk"].dp, *c["args"],
                              centered_ms=c["centered"])
    assert (words(got) == want).all()


def test_mesh_places_keys_once_a_device():
    m = cpu_mesh(3, "batch")
    key = torch.arange(6)
    assert all(x is key for x in mesh.replicate(m, key))
    shards = mesh.shard_batch(m, torch.arange(7)[:, None])
    assert [s.shape[0] for s in shards] == [3, 2, 2]
    assert m.distinct_devices() == [torch.device("cpu")]


# ---------------------------------------------------------------------------
# the latency route and the pod scaffolding
# ---------------------------------------------------------------------------


def test_latency_route_fheuint8_add():
    """A FheUint8 add whose every round is one PBS split over 4 slots, the
    words of tfhe_tpu's with its latency mesh set (4 devices)."""
    ref_ck, ref_sk = ref_integer.gen_keys(
        dataclasses.replace(ref_shortint.TEST_PARAM_MESSAGE_2_CARRY_2, **CUT), seed=SEED)
    ck, sk = integer.gen_keys(dataclasses.replace(shortint.TEST_PARAM_MESSAGE_2_CARRY_2, **CUT),
                              seed=SEED, device="cpu")
    ref_ps.set_latency_mesh(ref_cpu_mesh(4), threshold=16)
    try:
        want = ref_sk.add_parallelized(ref_ck.encrypt_radix(173, 4), ref_ck.encrypt_radix(62, 4))
    finally:
        ref_ps.set_latency_mesh(None)
    calls = {"n": 0}
    route = ps.sharded_ks_pbs_poly

    def counted(*a, **k):
        calls["n"] += 1
        return route(*a, **k)

    ps.set_latency_mesh(cpu_mesh(4), threshold=16)
    try:
        ps.sharded_ks_pbs_poly = counted
        got = sk.add_parallelized(ck.encrypt_radix(173, 4), ck.encrypt_radix(62, 4))
    finally:
        ps.sharded_ks_pbs_poly = route
        ps.set_latency_mesh(None)
    assert calls["n"] > 0
    assert ps.latency_mesh() is None and ps.latency_threshold() == 16
    assert ck.decrypt_radix(got) == ref_ck.decrypt_radix(want) == (173 + 62) % 256
    for r, b in zip(want.blocks, got.blocks):
        assert (np.asarray(b.data) == np.asarray(r.data)).all()
        assert (b.degree, b.noise_level) == (r.degree, r.noise_level)


def test_pod_scaffolding():
    assert multihost.init_distributed(num_processes=1) is False
    assert ref_mh.init_distributed(num_processes=1) is False
    pod = multihost.make_pod_mesh(2, 2, ["cpu"] * 4)
    assert pod.axis_names == ("batch", "poly") and pod.shape == {"batch": 2, "poly": 2}
    assert [s.shape[0] for s in multihost.shard_batch_pod(pod, torch.zeros(5, 3))] == [3, 2]
    key = torch.ones(4)
    assert all(x is key for x in multihost.replicate_pod(pod, key))
    with pytest.raises(ValueError):
        multihost.make_pod_mesh(3, 2, ["cpu"] * 4)


def test_derive_pod_keys_words():
    p = dataclasses.replace(shortint.TEST_PARAM_MESSAGE_2_CARRY_2, **CUT)
    ref_p = dataclasses.replace(ref_shortint.TEST_PARAM_MESSAGE_2_CARRY_2, **CUT)
    ck, sk = multihost.derive_pod_keys(p, SEED, device="cpu")
    ref_ck, _ = ref_mh.derive_pod_keys(ref_p, SEED)
    assert (ck.lwe_secret_key.data == np.asarray(ref_ck.lwe_secret_key.data)).all()
    assert (ck.glwe_secret_key.data == np.asarray(ref_ck.glwe_secret_key.data)).all()
    # tfhe_tpu's server key is drawn from a random seed; the port's from the
    # pod's seed, the words of tfhe_tpu's ServerKey at that seed
    ref_sk = ref_shortint.ServerKey(ref_ck, seed=SEED)
    assert (words(sk.ksk) == np.asarray(ref_sk.ksk)).all()
    assert (sk._bsk_coeff.data == np.asarray(ref_sk._bsk_coeff.data)).all()
    _, again = multihost.derive_pod_keys(p, SEED, device="cpu")
    assert (again._bsk_coeff.data == sk._bsk_coeff.data).all()


def test_mesh_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (mesh.make_mesh, multihost.make_pod_mesh,
                 lambda: multihost.derive_pod_keys(shortint.TEST_PARAM_MESSAGE_2_CARRY_2, 1)):
        with pytest.raises(RuntimeError):
            call()
