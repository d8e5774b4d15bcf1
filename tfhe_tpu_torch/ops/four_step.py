"""The four-step split of one negacyclic NTT over D slots: its tables and
the plain PyTorch versions of K9's three entries (csrc/poly_shard.cu).

tfhe_tpu/parallel/poly_shard.py computes these stages as XLA mod-p matmuls
(``_mat_mod`` :107, ``_fwd_local`` :118, ``_inv_local`` :137).  Math, for
each prime p with a root psi of order 2N and om = psi^2, C = N / D:
coefficient i = a + D c lives on slot a; the negacyclic twist psi^i is
slot-local; the cyclic N-point transform factors as

    X[k2 + C k1] = sum_a (om^C)^(a k1) om^(a k2) CyclicNTT_C(x'_a)[k2]

so a slot runs a cyclic size-C transform (root om^D) and the twiddle
om^(a k2) (entry a), the slots exchange blocks of C / D values of k2
(slot b receives every slot's block b), and slot b runs the size-D
transform (root om^C), the product with its slice of the other operand
and the size-D inverse (entry b); after the exchange back, slot a runs the
inverse twiddle, the inverse cyclic size-C transform, the inverse twist
and Garner to u64 (entry c).  Slot b's evaluation slice is laid out
(k2 - b C / D)-major, k1-minor, the layout of tfhe_tpu's; both operands
of a product go through the same forward split, so the layout cancels.

All arithmetic is exact mod p, so the kernel's butterflies and the dense
sums of these plain versions give the same residues.  Words are int64
tensors; residues (in [0, p), p < 2^30) and evaluation slices int32, as
the port's other NTT-domain keys; tables int64 in Montgomery form (times
R = 2^32).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from . import ntt, server

_R = 1 << 32


def _powers(w: int, count: int, p: int, scale: int = 1) -> list:
    """[scale w^j mod p for j < count]."""
    out, x = [], scale % p
    for _ in range(count):
        out.append(x)
        x = x * w % p
    return out


@lru_cache(maxsize=None)
def make_poly_shard_tables(n: int, n_dev: int, num_primes: int = 4) -> dict:
    """The per-prime tables of the D-slot split of size N
    (tfhe_tpu/parallel/poly_shard.py:45, the same values), as int64
    tensors on the CPU, Montgomery form: ``tw_f``/``tw_i`` (D, P, C) the
    negacyclic twists psi^(a + D c) and psi^-(a + D c); ``twd_f``/``twd_i``
    (D, P, C) the twiddles om^(+-a k2); ``vc_f``/``vc_i`` (P, C, C) the
    cyclic size-C matrices (the inverse times C^-1); ``vd_f``/``vd_i``
    (P, D, D) the size-D matrices (the inverse times D^-1); ``plan``."""
    plan = ntt.make_plan(n, num_primes)
    d, c = n_dev, n // n_dev
    if n % n_dev or c % n_dev:
        raise ValueError(f"N = {n} does not split over D = {n_dev} slots (D^2 must divide N)")
    cols = {k: [] for k in ("tw_f", "tw_i", "twd_f", "twd_i", "vc_f", "vc_i", "vd_f", "vd_i")}
    for p in plan.primes:
        g = ntt._find_generator(p)
        psi = pow(g, (p - 1) // (2 * n), p)
        om = psi * psi % p
        psi_i, om_i = pow(psi, p - 2, p), pow(om, p - 2, p)
        cinv, dinv = pow(c, p - 2, p), pow(d, p - 2, p)
        r = _R % p
        tw_f = np.array(_powers(psi, n, p, r), dtype=np.int64).reshape(c, d).T
        tw_i = np.array(_powers(psi_i, n, p, r), dtype=np.int64).reshape(c, d).T
        cols["tw_f"].append(tw_f)
        cols["tw_i"].append(tw_i)
        # om^(a k2) for a < D, k2 < C: om^j for j < D C = N, indexed
        om_pow = np.array(_powers(om, n, p, r), dtype=np.int64)
        om_i_pow = np.array(_powers(om_i, n, p, r), dtype=np.int64)
        ak = np.arange(d)[:, None] * np.arange(c)[None, :]
        cols["twd_f"].append(om_pow[ak])
        cols["twd_i"].append(om_i_pow[ak])
        # om^D has order C, om^C order D
        ck = (np.arange(c)[:, None] * np.arange(c)[None, :]) % c
        cols["vc_f"].append(np.array(_powers(pow(om, d, p), c, p, r), dtype=np.int64)[ck])
        cols["vc_i"].append(np.array(_powers(pow(om_i, d, p), c, p, cinv * r), dtype=np.int64)[ck])
        dk = (np.arange(d)[:, None] * np.arange(d)[None, :]) % d
        cols["vd_f"].append(np.array(_powers(pow(om, c, p), d, p, r), dtype=np.int64)[dk])
        cols["vd_i"].append(np.array(_powers(pow(om_i, c, p), d, p, dinv * r), dtype=np.int64)[dk])
    out = {"plan": plan}
    for k in ("tw_f", "tw_i", "twd_f", "twd_i"):
        out[k] = torch.from_numpy(np.ascontiguousarray(np.stack(cols[k], axis=1)))
    for k in ("vc_f", "vc_i", "vd_f", "vd_i"):
        out[k] = torch.from_numpy(np.ascontiguousarray(np.stack(cols[k])))
    return out


@dataclass(frozen=True, eq=False)
class PolyShardTables:
    """make_poly_shard_tables on one device, with what K9 reads besides:
    ``pw_f``/``pw_i`` (P, C) om^(+-D j) (the butterflies' powers, no
    scale), ``tw_ci`` (D, P, C) the inverse twist times C^-1 (where the
    butterflies take the scale), ``pwd_f``/``pwd_i`` (P, D) om^(C j) and
    om^-(C j) D^-1, ``r2`` (P,) R^2 mod p, and ``consts`` the kernels'
    packed constant table (ops/ntt.py _kernel_consts) with R in place of
    N^-1, so that its Garner takes the residues as they are.  K9's fused
    entry reads ``packed`` (D, P, 6, C) int32: each slot's tw_f, twd_f,
    pw_f, twd_i, tw_ci, pw_i, and ``packed_cross`` (P, 2, D) int32:
    pwd_f, pwd_i."""

    n: int
    d: int
    dp: ntt.DevicePlan
    tw_f: torch.Tensor
    tw_i: torch.Tensor
    twd_f: torch.Tensor
    twd_i: torch.Tensor
    vc_f: torch.Tensor
    vc_i: torch.Tensor
    vd_f: torch.Tensor
    vd_i: torch.Tensor
    pw_f: torch.Tensor
    pw_i: torch.Tensor
    tw_ci: torch.Tensor
    pwd_f: torch.Tensor
    pwd_i: torch.Tensor
    r2: torch.Tensor
    consts: torch.Tensor
    packed: torch.Tensor
    packed_cross: torch.Tensor

    @property
    def c(self) -> int:
        return self.n // self.d


@lru_cache(maxsize=None)
def device_tables(n: int, n_dev: int, device: str, num_primes: int = 4) -> PolyShardTables:
    """The split's tables on ``device`` (cached per device)."""
    t = make_poly_shard_tables(n, n_dev, num_primes)
    plan = t["plan"]
    c = n // n_dev
    pw_i, tw_ci = [], []
    for j, p in enumerate(plan.primes):
        g = ntt._find_generator(p)
        psi_i = pow(pow(g, (p - 1) // (2 * n), p), p - 2, p)
        pw_i.append(_powers(pow(psi_i, 2 * n_dev, p), c, p, _R))
        cinv = pow(c, p - 2, p)
        tw_ci.append(np.array(_powers(psi_i, n, p, cinv * _R), dtype=np.int64).reshape(c, n_dev).T)
    consts = ntt._kernel_consts(plan) if plan.num_primes == ntt.KERNEL_PRIMES else None
    if consts is not None:
        consts[8:8 + plan.num_primes] = [_R % p for p in plan.primes]
    to = lambda x: x.to(device)  # noqa: E731
    pw_f = t["vc_f"][:, 1 % c, :].contiguous()
    pw_i_t = torch.tensor(pw_i, dtype=torch.int64)
    tw_ci_t = torch.from_numpy(np.ascontiguousarray(np.stack(tw_ci, axis=1)))
    pwd_f = t["vd_f"][:, 1 % n_dev, :].contiguous()
    pwd_i = t["vd_i"][:, 1 % n_dev, :].contiguous()
    slots = (n_dev,) + tuple(pw_f.shape)
    packed = torch.stack([t["tw_f"], t["twd_f"], pw_f.expand(slots), t["twd_i"], tw_ci_t,
                          pw_i_t.expand(slots)], dim=2)
    return PolyShardTables(
        n=n, d=n_dev, dp=ntt.device_plan(plan, device),
        **{k: to(t[k]) for k in ("tw_f", "tw_i", "twd_f", "twd_i", "vc_f", "vc_i", "vd_f",
                                 "vd_i")},
        pw_f=to(pw_f), pw_i=to(pw_i_t), tw_ci=to(tw_ci_t), pwd_f=to(pwd_f), pwd_i=to(pwd_i),
        r2=to(torch.from_numpy(plan.r2s[:, 0].astype(np.int64))),
        consts=None if consts is None else to(torch.from_numpy(consts)),
        packed=to(packed.to(torch.int32).contiguous()),
        packed_cross=to(torch.stack([pwd_f, pwd_i], dim=1).to(torch.int32).contiguous()))


# ---------------------------------------------------------------------------
# Plain versions of K9's entries
# ---------------------------------------------------------------------------


def _dense(x, mat, p, pinv, rows: int = 1 << 22):
    """x (..., P, K) times mat (P, K, M) mod p, mat in Montgomery form:
    sum_k x_k mat_km R^-1 mod p, (..., P, M): each product reduced
    (Montgomery) and summed (< K p), as torch has no int64 matmul on CUDA,
    in slices of the leading rows to bound the broadcast's memory."""
    lead = tuple(x.shape[:-2])
    np_, k = x.shape[-2:]
    flat = x.reshape(-1, np_, k)
    step = max(1, rows // max(1, np_ * k * mat.shape[-1]))
    pb, pib = p[:, :, None], pinv[:, :, None]
    out = [torch.remainder(ntt.mont_mul(flat[s:s + step, :, :, None], mat, pb, pib)
                           .sum(dim=-2), p) for s in range(0, flat.shape[0], step)]
    return torch.cat(out).reshape(lead + (np_, mat.shape[-1]))


def forward_plain(x: torch.Tensor, t: PolyShardTables, slot: int, levels: int = 0,
                  base_log: int = 0) -> torch.Tensor:
    """Entry (a) on slot ``slot``: x (M, C) int64 u64 words (the slot's
    coefficients a + D c) -> (L, M, P, C) int32 residues: with levels > 0 each
    word's signed gadget digits (L = levels, lowest level first), else the
    word's residues (L = 1); the negacyclic twist, the cyclic size-C
    transform, the twiddle om^(a k2) (tfhe_tpu's ``_fwd_local`` before its
    exchange)."""
    dp = t.dp
    p, pinv = dp.ps, dp.pinvs                          # (P, 1)
    if levels:
        digits = server.signed_decompose(x, base_log, levels)            # (L, M, C)
        res = torch.remainder(digits[:, :, None, :], p)
    else:
        res = ntt.residues_u64(x, dp)[None]                        # (1, M, P, C)
    z = ntt.mont_mul(res, t.tw_f[slot], p, pinv)
    return ntt.mont_mul(_dense(z, t.vc_f, p, pinv), t.twd_f[slot], p, pinv).to(torch.int32)


def cross_plain(ya: torch.Tensor, t: PolyShardTables, key: torch.Tensor | None = None,
                batch: int = 0, k1: int = 1, key_per_row: bool = False) -> torch.Tensor:
    """Entry (b) on slot b after the exchange: ya (D, L, M, P, C/D) int32,
    block b of every slot a's entry (a).  The size-D transform gives the slice
    (L, M, P, C), k1-minor.  Without ``key``: that slice in Montgomery form
    (an operand's evaluation slice: prepare_bsk_poly_sharded's).  With
    ``key`` (L, k+1, k+1, P, C) int32 Montgomery, M = batch (k+1) rows: the
    product summed over the levels and the input rows, (batch, k+1, P, C),
    then the size-D inverse, returned (D, batch, k+1, P, C/D) with slot
    a's block at a.  key_per_row: key (M, P, C), one slice a row (k+1 = 1,
    L = 1), the pointwise product of sharded_negacyclic_polymul."""
    dp = t.dp
    p, pinv = dp.ps, dp.pinvs
    d, levels, m, np_, cd = ya.shape
    x2 = _cross_forward(ya.long(), t)                              # (L, M, P, C)
    if key is None:
        return ntt.mont_mul(x2, dp.r2s, p, pinv).to(torch.int32)   # (L, M, P, C)
    key = key.long()
    if key_per_row:
        prod = ntt.mont_mul(x2[0], key, p, pinv)[:, None]          # (M, 1, P, C)
    else:
        xb = x2.reshape(levels, batch, k1, np_, cd * d)
        prod = None
        for lev in range(levels):
            for r in range(k1):
                term = ntt.mont_mul(xb[lev, :, r, None], key[lev, r][None], p, pinv)
                prod = term if prod is None else prod + term
        prod = torch.remainder(prod, p)                            # (B, k+1, P, C)
    # size-D inverse over k1: (..., P, C/D, D_k1) against vd_i (P, D_k1, D_a)
    pv = prod.reshape(prod.shape[:-1] + (cd, d)).transpose(-3, -2)  # (..., C/D, P, D)
    inv = _dense(pv, t.vd_i, p, pinv)                              # (..., C/D, P, D_a)
    return inv.permute(-1, *range(inv.dim() - 3), -2, -3).to(torch.int32).contiguous()


def _cross_forward(ya: torch.Tensor, t: PolyShardTables) -> torch.Tensor:
    """The size-D transform of entry (b): ya (D_a, L, M, P, C/D) ->
    (L, M, P, C), index (k2 - b C/D) D + k1."""
    dp = t.dp
    d, levels, m, np_, cd = ya.shape
    v = ya.permute(1, 2, 4, 3, 0)                                  # (L, M, C/D, P, D_a)
    x2 = _dense(v, t.vd_f, dp.ps, dp.pinvs)                        # (L, M, C/D, P, D_k1)
    return x2.transpose(-3, -2).reshape(levels, m, np_, cd * d)


def inverse_plain(yb: torch.Tensor, t: PolyShardTables, slot: int) -> torch.Tensor:
    """Entry (c) on slot a after the exchange back: yb (D_b, M, P, C/D)
    int32 -> (M, C) int64 u64 words of the slot's coefficients: the inverse
    twiddle, the inverse cyclic size-C transform (times C^-1), the inverse
    twist, Garner (tfhe_tpu's ``_inv_local`` after its exchange, and
    ``garner_to_u64``)."""
    dp = t.dp
    p, pinv = dp.ps, dp.pinvs
    d, m, np_, cd = yb.shape
    y = yb.long().permute(1, 2, 0, 3).reshape(m, np_, d * cd)      # k2 = b C/D + k2loc
    y = ntt.mont_mul(y, t.twd_i[slot], p, pinv)
    z = ntt.mont_mul(_dense(y, t.vc_i, p, pinv), t.tw_i[slot], p, pinv)
    return ntt.garner_to_u64(z, dp)


# ---------------------------------------------------------------------------
# The rotation as a loop of steps over the slots
# ---------------------------------------------------------------------------


def all_to_all(parts: list, devs: list) -> list:
    """parts[a]: (D, ...) on slot a, block b for slot b -> on slot b the
    (D, ...) stack of every slot a's block b."""
    return [torch.stack([p[b].to(dev) for p in parts]) for b, dev in enumerate(devs)]


def all_gather(slices: list, devices: list) -> dict:
    """The (D, ...) stack of every slot's slice on each of ``devices``."""
    return {dev: torch.stack([s.to(dev) for s in slices]) for dev in devices}


def forward_split(rows_by_slot: list, tabs: list, levels: int = 0, base_log: int = 0,
                  forward=forward_plain) -> list:
    """Entry (a) on each slot and the exchange: slot b's (D, L, M, P, C/D)."""
    d = len(tabs)
    parts = []
    for a, (x, t) in enumerate(zip(rows_by_slot, tabs)):
        f = forward(x, t, a, levels, base_log)                          # (L, M, P, C)
        parts.append(f.reshape(f.shape[:-1] + (d, t.c // d)).movedim(-2, 0))
    return all_to_all(parts, [t.pw_f.device for t in tabs])


def inverse_split(outs: list, tabs: list, inverse=inverse_plain) -> list:
    """The exchange back and entry (c) on each slot: slot a's (M, C) words."""
    devs = [t.pw_f.device for t in tabs]
    back = all_to_all([o.reshape((o.shape[0], -1) + tuple(o.shape[-2:])) for o in outs], devs)
    return [inverse(y, t, a) for a, (y, t) in enumerate(zip(back, tabs))]


def interleave(stack: torch.Tensor, shape: tuple) -> torch.Tensor:
    """(D, rows, C) slices -> (..., N) with slot a's c-th value at a + D c."""
    return stack.permute(1, 2, 0).reshape(shape)


def rotate_steps(msed_mask, msed_body, lut, parts: list, tabs: list, base_log: int,
                 levels: int, forward=forward_plain, cross=cross_plain,
                 inverse=inverse_plain) -> torch.Tensor:
    """The blind rotation one CMux step at a time over the D slots of
    ``tabs`` (slot a's tables on its device; ``parts[a]`` its key slices
    (n, l, k+1, k+1, P, C)): the plain version of K9's fused entry, and,
    with K9's three step entries as the stages, the route of a mesh whose
    slots lie on distinct devices.  The accumulator is kept on each
    distinct device; each step rotates it, takes each slot's coefficients,
    runs the forward split with the digits, the cross stage with the slot's
    key slice and the inverse split, and adds the gathered slices:
    (B, k+1, N) on the first slot's device, the words of ops/server.py
    ``blind_rotate``."""
    d = len(tabs)
    devs = [t.pw_f.device for t in tabs]
    b, k1, n_poly = lut.shape
    homes = list(dict.fromkeys(devs))          # one accumulator a distinct device
    acc0 = server.monomial_div(lut, msed_body[:, None, None])
    acc = {dev: acc0.to(dev) for dev in homes}
    mask = {dev: msed_mask.to(dev) for dev in homes}
    for i in range(msed_mask.shape[1]):
        ct1 = {dev: server.monomial_mul(acc[dev], mask[dev][:, i, None, None]) - acc[dev]
               for dev in homes}
        rows = [ct1[dev][..., a::d].reshape(b * k1, -1).contiguous()
                for a, dev in enumerate(devs)]
        ya = forward_split(rows, tabs, levels, base_log, forward)
        outs = [cross(y, t, parts[s][i], batch=b, k1=k1)
                for s, (y, t) in enumerate(zip(ya, tabs))]
        full = all_gather(inverse_split(outs, tabs, inverse), homes)
        for dev in homes:
            acc[dev] = acc[dev] + interleave(full[dev], (b, k1, n_poly))
    return acc[devs[0]]
