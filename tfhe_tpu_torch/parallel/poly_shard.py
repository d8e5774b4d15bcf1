"""One negacyclic product, and one PBS, split along the polynomial axis over
the slots of a mesh (tfhe_tpu/parallel/poly_shard.py; SURVEY §2.13 P5).

The four-step split (ops/four_step.py): slot a holds coefficients a::D;
each transform is a slot-local stage, an exchange of blocks between the
slots, and another slot-local stage.  The slot-local stages are K9's three
entries (csrc/poly_shard.cu, through ops/kernels.py; on CPU tensors their
plain versions); the exchanges are copies between the slots' tensors,
``all_to_all`` and ``all_gather`` below, on the current stream of each
slot's device.  One process drives every slot, and slots may share a
device: one card runs D slots in turn.

``sharded_blind_rotate_poly`` keeps the accumulator replicated (one copy
on each distinct device) and the bootstrap key's evaluation slices
sharded (1/D a slot).  Each CMux step: rotate and take each slot's
coefficients (torch), entry (a) with the gadget digits, all_to_all, entry
(b) with the slot's key slice, all_to_all back, entry (c) with Garner,
all_gather of the slices, added to the accumulator: 3 D K9 launches a
step, and the words of ops/server.py ``blind_rotate``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops import kernels, torus
from ..ops import server as srv
from ..ops.four_step import device_tables, make_poly_shard_tables  # noqa: F401 (public)
from .mesh import Mesh, place


def _tables(n: int, devs: list, n_primes: int) -> list:
    return [device_tables(n, len(devs), str(dev), n_primes) for dev in devs]


def all_to_all(parts: list, devs: list) -> list:
    """parts[a]: (D, ...) on slot a, block b for slot b -> on slot b the
    (D, ...) stack of every slot a's block b."""
    return [torch.stack([p[b].to(dev) for p in parts]) for b, dev in enumerate(devs)]


def all_gather(slices: list, devices: list) -> dict:
    """The (D, ...) stack of every slot's slice on each of ``devices``."""
    return {dev: torch.stack([s.to(dev) for s in slices]) for dev in devices}


def _forward_split(rows_by_slot: list, tabs: list, levels: int = 0, base_log: int = 0) -> list:
    """Entry (a) on each slot and the exchange: slot b's (D, L, M, P, C/D)."""
    d = len(tabs)
    parts = []
    for a, (x, t) in enumerate(zip(rows_by_slot, tabs)):
        f = kernels.poly_shard_forward(x, t, a, levels, base_log)     # (L, M, P, C)
        parts.append(f.reshape(f.shape[:-1] + (d, t.c // d)).movedim(-2, 0))
    return all_to_all(parts, [t.pw_f.device for t in tabs])


def _inverse_split(outs: list, tabs: list) -> list:
    """The exchange back and entry (c) on each slot: slot a's (M, C) words."""
    devs = [t.pw_f.device for t in tabs]
    back = all_to_all([o.reshape((o.shape[0], -1) + tuple(o.shape[-2:])) for o in outs], devs)
    return [kernels.poly_shard_inverse(y, t, a) for a, (y, t) in enumerate(zip(back, tabs))]


def _strided(x: torch.Tensor, d: int, devs: list) -> list:
    """x (..., N) -> slot a's (rows, N/D) coefficients a::D on its device."""
    n = x.shape[-1]
    return [x[..., a::d].reshape(-1, n // d).contiguous().to(dev) for a, dev in enumerate(devs)]


def _interleave(stack: torch.Tensor, shape: tuple) -> torch.Tensor:
    """(D, rows, C) slices -> (..., N) with slot a's c-th value at a + D c."""
    return stack.permute(1, 2, 0).reshape(shape)


def sharded_negacyclic_polymul(mesh: Mesh, a: torch.Tensor, b: torch.Tensor,
                               n_primes: int = 4, axis_name: str = "poly") -> torch.Tensor:
    """The exact negacyclic u64 product of a, b (..., N) int64 words, the
    polynomial axis split over the mesh's slots (tfhe_tpu
    poly_shard.py:153): both operands through the forward split, the
    pointwise product on each slot (entry (b) with b's slice a row), the
    inverse split, the slices gathered onto a's device."""
    devs = mesh.axis_devices(axis_name)
    d = len(devs)
    tabs = _tables(a.shape[-1], devs, n_primes)
    ya = _forward_split(_strided(a, d, devs), tabs)
    yb = _forward_split(_strided(b, d, devs), tabs)
    outs = []
    for t, xa, xb in zip(tabs, ya, yb):
        key = kernels.poly_shard_cross(xb, t)[0]                         # (M, P, C)
        outs.append(kernels.poly_shard_cross(xa, t, key, batch=key.shape[0], k1=1,
                                             key_per_row=True))
    slices = _inverse_split(outs, tabs)
    full = all_gather(slices, [a.device])[a.device]
    return _interleave(full, a.shape)


@dataclass(frozen=True, eq=False)
class PolyShardedKey:
    """A bootstrap key's evaluation slices: ``parts[b]`` (n, l, k+1, k+1,
    P, C) int32 Montgomery form on slot b's device."""

    parts: list

    def gather(self) -> torch.Tensor:
        """tfhe_tpu's layout (n, l, k+1, k+1, P, D, C) on the CPU."""
        return torch.stack([p.cpu() for p in self.parts], dim=-2)

    @property
    def nbytes(self) -> int:
        return sum(p.numel() * p.element_size() for p in self.parts)


def prepare_bsk_poly_sharded(mesh: Mesh, bsk_u64, n_primes: int = 4,
                             axis_name: str = "poly") -> PolyShardedKey:
    """(n, l, k+1, k+1, N) u64 GGSW rows (a uint64 array or int64 words)
    -> their evaluation slices, one part a slot (tfhe_tpu
    poly_shard.py:239): produced by the same forward split the rotation
    runs, so no layout bookkeeping can drift."""
    words = bsk_u64 if isinstance(bsk_u64, torch.Tensor) else torus.from_u64(bsk_u64, "cpu")
    devs = mesh.axis_devices(axis_name)
    d = len(devs)
    lead = tuple(words.shape[:-1])
    tabs = _tables(words.shape[-1], devs, n_primes)
    parts = []
    for t, ya in zip(tabs, _forward_split(_strided(words, d, devs), tabs)):
        ev = kernels.poly_shard_cross(ya, t)[0]                          # (rows, P, C)
        parts.append(ev.reshape(lead + tuple(ev.shape[-2:])))
    return PolyShardedKey(parts)


def sharded_blind_rotate_poly(mesh: Mesh, msed_mask, msed_body, lut,
                              bsk_evals: PolyShardedKey, base_log: int, levels: int,
                              n_primes: int = 4, bits: int = 64,
                              axis_name: str = "poly") -> torch.Tensor:
    """Batched blind rotation with the key's polynomial axis split over the
    mesh (tfhe_tpu poly_shard.py:285), the words of ops/server.py
    ``blind_rotate``.  msed_mask (B, n) in [0, 2N), msed_body (B,), lut
    (B, k+1, N) int64; bsk_evals from ``prepare_bsk_poly_sharded``.
    Returns the accumulator (B, k+1, N) on lut's device."""
    if bits != 64:
        raise ValueError("the poly-sharded rotation runs the 2^64 torus")
    devs = mesh.axis_devices(axis_name)
    d = len(devs)
    b, k1, n_poly = lut.shape
    tabs = _tables(n_poly, devs, n_primes)
    homes = list(dict.fromkeys(devs))          # one accumulator a distinct device
    acc0 = srv.monomial_div(lut, msed_body[:, None, None])
    acc = {dev: acc0.to(dev) for dev in homes}
    mask = {dev: msed_mask.to(dev) for dev in homes}
    for i in range(msed_mask.shape[1]):
        ct1 = {dev: srv.monomial_mul(acc[dev], mask[dev][:, i, None, None]) - acc[dev]
               for dev in homes}
        rows = [ct1[dev][..., a::d].reshape(b * k1, -1).contiguous()
                for a, dev in enumerate(devs)]
        ya = _forward_split(rows, tabs, levels, base_log)
        outs = [kernels.poly_shard_cross(y, t, bsk_evals.parts[s][i], batch=b, k1=k1)
                for s, (y, t) in enumerate(zip(ya, tabs))]
        full = all_gather(_inverse_split(outs, tabs), homes)
        for dev in homes:
            acc[dev] = acc[dev] + _interleave(full[dev], (b, k1, n_poly))
    return acc[devs[0]].to(lut.device)


def sharded_ks_pbs_poly(mesh: Mesh, ct, lut, ksk, bsk_evals: PolyShardedKey,
                        ks_base_log: int, ks_levels: int, pbs_base_log: int, pbs_levels: int,
                        bits: int = 64, centered_ms: bool = False, n_primes: int = 4,
                        axis_name: str = "poly") -> torch.Tensor:
    """The atomic pattern with one PBS split over the mesh (tfhe_tpu
    poly_shard.py:361), the latency lever for small batches: keyswitch and
    modulus switch once on ct's device (K1 on the card), the sharded
    rotation, sample extract.  ct (B, n_big+1), lut (B, k+1, N) int64; ksk
    as ``ServerKey.ks_key``.  With a full batch, mesh.sharded_ks_pbs scales
    throughput instead."""
    if bits != 64:
        raise ValueError("the poly-sharded pattern runs the 2^64 torus")
    msed = srv.ks_ms_batch(ct, place(ksk, ct.device), lut.shape[-1].bit_length(),
                           ks_base_log, ks_levels, centered_ms)
    acc = sharded_blind_rotate_poly(mesh, msed[:, :-1], msed[:, -1], lut, bsk_evals,
                                    pbs_base_log, pbs_levels, n_primes, bits, axis_name)
    return srv.sample_extract(acc)


# ---------------------------------------------------------------------------
# Latency-mesh routing: an opt-in mesh that the shortint ServerKey consults
# for small batches
# ---------------------------------------------------------------------------

_LATENCY_MESH = None
_LATENCY_THRESHOLD = 16


def set_latency_mesh(mesh: Mesh | None, threshold: int = 16, axis_name: str = "poly") -> None:
    """Route LUT batches of at most ``threshold`` ciphertexts through the
    poly-sharded pattern on ``mesh`` (one PBS then uses every slot); None
    turns it off.  Larger batches keep the batch path."""
    global _LATENCY_MESH, _LATENCY_THRESHOLD
    _LATENCY_MESH = (mesh, axis_name) if mesh is not None else None
    _LATENCY_THRESHOLD = threshold


def latency_mesh():
    return _LATENCY_MESH


def latency_threshold() -> int:
    return _LATENCY_THRESHOLD
