"""Sharding of the PBS batch axis over a mesh of devices.

The reference's multi-GPU layer scatters LWE arrays across GPUs inside one
host and gathers the results (backends/tfhe-cuda-backend/cuda/include/
helper_multi_gpu.h:1-80, integer.cuh:945-988).  The port does the same
with one process driving every device, as tfhe_tpu's single-controller
GSPMD program does (tfhe_tpu/parallel/mesh.py): a ``Mesh`` is an array of
``torch.device``s with named axes; a batch is split over the slots of an
axis, each slot runs the whole KS->PBS on its shard (K1, then K2) with the
keys replicated, and the results are gathered in order.  No collective
runs in the steady state.

A device may appear more than once in a mesh: the CPU tests run D "cpu"
slots, and one card runs D slots on "cuda:0".  Keys are placed once on
each distinct device (``replicate``) and the copies kept as long as the
key lives, so a second call uploads nothing (``replicate.uploads`` counts
the copies made); a mesh that repeats a device holds one copy there.

The "poly" axis, one PBS split over the slots, lives in
parallel/poly_shard.py.
"""

from __future__ import annotations

import dataclasses
import weakref

import numpy as np
import torch

from ..ops import kernels, ntt
from ..ops import server as srv
from ..ops.bsk_prep import RoundedKeyNtt
from ..utils.device import resolve_device


def _indexed(device) -> torch.device:
    """``device`` with its index: "cuda" is the current card, so that it
    equals a tensor's device there."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


class Mesh:
    """Devices in an array with named axes (tfhe_tpu's jax.sharding.Mesh):
    ``devices`` an object array of torch.device, ``axis_names`` one name an
    axis.  One process drives every slot; slots may share a device."""

    def __init__(self, devices, axis_names: tuple):
        arr = np.empty(np.shape(devices), dtype=object)
        for idx in np.ndindex(arr.shape):
            arr[idx] = _indexed(resolve_device(np.asarray(devices, dtype=object)[idx]))
        if arr.ndim != len(axis_names):
            raise ValueError(f"{arr.ndim} axes of devices, names {axis_names}")
        self.devices = arr
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    def axis_devices(self, axis_name: str) -> list:
        """The slots along ``axis_name``, at index 0 of every other axis."""
        ax = self.axis_names.index(axis_name)
        idx = [0] * self.devices.ndim
        idx[ax] = slice(None)
        return list(self.devices[tuple(idx)])

    def distinct_devices(self) -> list:
        """Each device of the mesh once, in the order of first appearance."""
        seen = []
        for dev in self.devices.flat:
            if dev not in seen:
                seen.append(dev)
        return seen


def make_mesh(devices=None, axis_name: str = "batch") -> Mesh:
    """A one-axis mesh: ``devices`` (names or torch.devices, repeats
    allowed), every visible card by default; without a card the default
    raises."""
    if devices is None:
        resolve_device("cuda")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return Mesh(list(devices), (axis_name,))


def shard_batch(mesh: Mesh, x: torch.Tensor, axis_name: str = "batch") -> list:
    """x's leading (batch) axis split over the slots of ``axis_name``, each
    shard on its slot's device; the first B mod D shards take one row more
    (a batch the slots do not divide is split, not refused)."""
    devs = mesh.axis_devices(axis_name)
    return [s.to(dev) for s, dev in zip(torch.tensor_split(x, len(devs)), devs)]


_PLACED: dict = {}       # id(key) -> (weakref to the key, {device: copy})


def _move(x, device: torch.device):
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, kernels.KeyswitchKeyLimbs):
        return dataclasses.replace(x, words=x.words.to(device), limbs=x.limbs.to(device))
    if isinstance(x, RoundedKeyNtt):
        return dataclasses.replace(x, data=x.data.to(device),
                                   dp=ntt.device_plan(x.dp.plan, str(device)))
    raise TypeError(f"cannot place a {type(x).__name__}")


def _device_of(x) -> torch.device:
    if isinstance(x, kernels.KeyswitchKeyLimbs):
        return x.words.device
    return x.data.device if isinstance(x, RoundedKeyNtt) else x.device


def place(x, device: torch.device):
    """x (a tensor, a KeyswitchKeyLimbs or a RoundedKeyNtt) on ``device``:
    x itself where it lies there, else its copy there, made once and kept
    as long as x lives."""
    device = _indexed(device)
    if _device_of(x) == device:
        return x
    key = id(x)
    entry = _PLACED.get(key)
    if entry is None or entry[0]() is not x:
        entry = (weakref.ref(x, lambda _r, k=key: _PLACED.pop(k, None)), {})
        _PLACED[key] = entry
    copies = entry[1]
    if device not in copies:
        copies[device] = _move(x, device)
        replicate.uploads += 1
    return copies[device]


def replicate(mesh: Mesh, x) -> list:
    """x on every slot of the mesh (one entry a slot, in ``mesh.devices``'
    flat order): placed once on each distinct device (``place``)."""
    return [place(x, dev) for dev in mesh.devices.flat]


replicate.uploads = 0       # copies of a key made on a device


def _sharded(mesh: Mesh, ct, lut, ksk, bsk_ntt, dp, ks_base_log: int, ks_levels: int,
             pbs_base_log: int, pbs_levels: int, bits: int, centered_ms: bool,
             trunc_acc: bool, axis_name: str) -> torch.Tensor:
    if bits != 64:
        raise ValueError("the batch mesh runs the u64 pattern (a KS32 key is another pattern)")
    outs = []
    for ct_s, lut_s in zip(shard_batch(mesh, ct, axis_name), shard_batch(mesh, lut, axis_name)):
        if not ct_s.shape[0]:
            continue
        dev = ct_s.device
        outs.append(srv.ks_pbs_batch(
            ct_s, lut_s.contiguous(), place(ksk, dev), place(bsk_ntt, dev),
            ntt.device_plan(dp.plan, str(dev)), ks_base_log, ks_levels, pbs_base_log,
            pbs_levels, centered_ms=centered_ms, trunc_acc=trunc_acc))
    return torch.cat([o.to(ct.device) for o in outs])


def sharded_ks_pbs(mesh: Mesh, ct, lut, ksk, bsk_ntt, dp: ntt.DevicePlan,
                   ks_base_log: int, ks_levels: int, pbs_base_log: int, pbs_levels: int,
                   bits: int = 64, centered_ms: bool = False,
                   axis_name: str = "batch") -> torch.Tensor:
    """Batched KS->PBS with the batch split over the mesh's slots
    (tfhe_tpu/parallel/mesh.py:45): ct (B, n_big+1), lut (B, k+1, N) on
    the caller's device; ksk as ``ServerKey.ks_key``, bsk_ntt the exact
    NTT-domain key, both replicated once a device.  Each slot runs
    ops/server.py ks_pbs_batch on its shard (K1, then K2's exact rotation
    on the card); returns (B, n_big+1) on ct's device, in order."""
    return _sharded(mesh, ct, lut, ksk, bsk_ntt, dp, ks_base_log, ks_levels, pbs_base_log,
                    pbs_levels, bits, centered_ms, False, axis_name)


# tfhe_tpu's explicit per-device variant (mesh.py:72): each slot runs the
# fused pipeline on its shard, which is what sharded_ks_pbs already does
# here.  Its use_pallas and pallas_interpret flags pick a JAX interpreter
# and have no counterpart: the card always runs the kernels.
sharded_ks_pbs_shard_map = sharded_ks_pbs


def sharded_ks_pbs_mxu(mesh: Mesh, ct, lut, ksk, bsk_rounded: RoundedKeyNtt, dp=None,
                       ks_base_log: int = 0, ks_levels: int = 0, pbs_base_log: int = 0,
                       pbs_levels: int = 0, bits: int = 64, centered_ms: bool = False,
                       axis_name: str = "batch") -> torch.Tensor:
    """The production rotation over the mesh (mesh.py:109): as
    ``sharded_ks_pbs`` on the rounded key (ops/bsk_prep.py RoundedKeyNtt,
    ``ServerKey.bsk_ntt`` in v7 mode), each slot running K2's v7 kernel
    (trunc_acc), the port's counterpart of tfhe_tpu's v3/v4/v5 MXU
    kernels; dp defaults to the key's own plan.  tfhe_tpu's ``tb``,
    ``fold_mode``, ``kernel``, ``interpret`` and ``corr_mid`` pick an MXU
    variant or a JAX interpreter and have no counterpart."""
    return _sharded(mesh, ct, lut, ksk, bsk_rounded, dp or bsk_rounded.dp, ks_base_log,
                    ks_levels, pbs_base_log, pbs_levels, bits, centered_ms, True, axis_name)
