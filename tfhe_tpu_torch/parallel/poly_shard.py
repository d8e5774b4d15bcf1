"""One negacyclic product, and one PBS, split along the polynomial axis over
the slots of a mesh (tfhe_tpu/parallel/poly_shard.py; SURVEY §2.13 P5).

The four-step split (ops/four_step.py): slot a holds coefficients a::D;
each transform is a slot-local stage, an exchange of blocks between the
slots, and another slot-local stage.  One process drives every slot, and
slots may share a device.

``sharded_blind_rotate_poly`` follows ``kernels.poly_rotation_route``:
- "fused", every slot the same card: K9's fused entry
  (``kernels.poly_shard_rotate``, csrc/poly_shard.cu), the whole rotation
  in one launch, one thread-block cluster a ciphertext whose blocks hold
  the slots, the exchanges through distributed shared memory; on the CPU
  its plain version, the step loop below on the plain stages;
- "steps", slots on distinct devices: the step loop
  (ops/four_step.py ``rotate_steps``) on K9's three step entries, the
  accumulator kept on each distinct device, the exchanges copies between
  the slots' tensors (``all_to_all``, ``all_gather``) on the current
  stream of each slot's device: 3 D launches a step.
Both give the words of ops/server.py ``blind_rotate``.  The key's
evaluation slices are sharded (1/D a slot); where every slot shares one
device they are one tensor, the slots' parts views of it.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import torch

from ..ops import four_step, kernels, torus
from ..ops import server as srv
from ..ops.four_step import (all_gather, all_to_all, device_tables,  # noqa: F401 (public)
                             interleave, make_poly_shard_tables, rotate_steps)
from .mesh import Mesh, place


def _tables(n: int, devs: list, n_primes: int) -> list:
    return [device_tables(n, len(devs), str(dev), n_primes) for dev in devs]


_forward_split = partial(four_step.forward_split, forward=kernels.poly_shard_forward)
_inverse_split = partial(four_step.inverse_split, inverse=kernels.poly_shard_inverse)


def _strided(x: torch.Tensor, d: int, devs: list) -> list:
    """x (..., N) -> slot a's (rows, N/D) coefficients a::D on its device."""
    n = x.shape[-1]
    return [x[..., a::d].reshape(-1, n // d).contiguous().to(dev) for a, dev in enumerate(devs)]


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
    return interleave(full, a.shape)


@dataclass(frozen=True, eq=False)
class PolyShardedKey:
    """A bootstrap key's evaluation slices: ``parts[b]`` (n, l, k+1, k+1,
    P, C) int32 Montgomery form on slot b's device; ``whole`` (D, n, l,
    k+1, k+1, P, C), the one tensor the parts are views of, where every
    slot shares a device (K9's fused entry reads it), else None."""

    parts: list
    whole: torch.Tensor | None = None

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
    runs, so no layout bookkeeping can drift.  Where the slots share one
    device the parts are written into one (D, ...) tensor."""
    words = bsk_u64 if isinstance(bsk_u64, torch.Tensor) else torus.from_u64(bsk_u64, "cpu")
    devs = mesh.axis_devices(axis_name)
    d = len(devs)
    lead = tuple(words.shape[:-1])
    tabs = _tables(words.shape[-1], devs, n_primes)
    one = len(set(devs)) == 1
    whole = (torch.empty((d,) + lead + (n_primes, words.shape[-1] // d), dtype=torch.int32,
                         device=devs[0]) if one else None)
    parts = []
    for s, (t, ya) in enumerate(zip(tabs, _forward_split(_strided(words, d, devs), tabs))):
        ev = kernels.poly_shard_cross(ya, t)[0].reshape(lead + (n_primes, t.c))
        if one:
            whole[s].copy_(ev)
            ev = whole[s]
        parts.append(ev)
    return PolyShardedKey(parts, whole)


def sharded_blind_rotate_poly(mesh: Mesh, msed_mask, msed_body, lut,
                              bsk_evals: PolyShardedKey, base_log: int, levels: int,
                              n_primes: int = 4, bits: int = 64,
                              axis_name: str = "poly") -> torch.Tensor:
    """Batched blind rotation with the key's polynomial axis split over the
    mesh (tfhe_tpu poly_shard.py:285), the words of ops/server.py
    ``blind_rotate``, by ``kernels.poly_rotation_route``: K9's fused entry
    where every slot is the same device, else the step loop on K9's step
    entries.  msed_mask (B, n) in [0, 2N), msed_body (B,), lut (B, k+1, N)
    int64; bsk_evals from ``prepare_bsk_poly_sharded``.  Returns the
    accumulator (B, k+1, N) on lut's device."""
    if bits != 64:
        raise ValueError("the poly-sharded rotation runs the 2^64 torus")
    devs = mesh.axis_devices(axis_name)
    d = len(devs)
    b, k1, n_poly = lut.shape
    route = kernels.poly_rotation_route(devs, d, k1, levels, n_poly)
    if route == "fused":
        dev = devs[0]
        t = device_tables(n_poly, d, str(dev), n_primes)
        acc = kernels.poly_shard_rotate(msed_mask.to(dev), msed_body.to(dev), lut.to(dev),
                                        bsk_evals.whole, t, base_log, levels)
    else:
        acc = rotate_steps(msed_mask, msed_body, lut, bsk_evals.parts,
                           _tables(n_poly, devs, n_primes), base_log, levels,
                           kernels.poly_shard_forward, kernels.poly_shard_cross,
                           kernels.poly_shard_inverse)
    return acc.to(lut.device)


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
