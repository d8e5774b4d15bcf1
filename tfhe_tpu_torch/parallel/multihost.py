"""Multi-host scaffolding: one card -> one host -> N hosts.

The reference has no multi-node backend (SURVEY.md §2.13: a "node" is one
process; multi-GPU is copies inside one host).  The port follows
tfhe_tpu/parallel/multihost.py:

* **Runtime**: ``init_distributed`` joins the hosts' processes with
  ``torch.distributed`` (NCCL between cards, gloo on the CPU); a single
  process needs none, and one process drives every card of its host
  (parallel/mesh.py).
* **Mesh**: a 2-axis (batch, poly) mesh (``make_pod_mesh``): "batch"
  splits ciphertexts (parallel/mesh.py), "poly" splits one PBS
  (parallel/poly_shard.py).
* **Key "broadcast"**: none.  Keygen is deterministic from a seed (the
  fork-tree AES-CTR generator, utils/csprng.py), so every host derives the
  same keys from one shared seed (``derive_pod_keys``) instead of shipping
  a multi-GB key.
"""

from __future__ import annotations

import numpy as np
import torch

from .mesh import Mesh, make_mesh, replicate, shard_batch


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     local_device_ids=None) -> bool:
    """Join a multi-process group: a no-op returning False for a single
    process; else ``torch.distributed.init_process_group`` at
    tcp://coordinator_address with this process's rank (NCCL where the
    host has a card, on its first local device, else gloo), returning
    True."""
    if num_processes in (None, 0, 1):
        return False
    cuda = torch.cuda.is_available()
    if cuda and local_device_ids:
        torch.cuda.set_device(int(list(local_device_ids)[0]))
    torch.distributed.init_process_group(
        backend="nccl" if cuda else "gloo", init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id)
    return True


def make_pod_mesh(batch: int | None = None, poly: int | None = None, devices=None) -> Mesh:
    """The (batch, poly) mesh over ``devices`` (every visible card by
    default): poly defaults to 1 (pure data parallelism, right where one
    card holds a whole PBS), batch to the devices left over."""
    devices = list(make_mesh(devices).devices.flat)
    poly = poly or 1
    if batch is None:
        batch = len(devices) // poly
    if batch * poly != len(devices):
        raise ValueError(f"{batch} x {poly} does not cover {len(devices)} devices")
    arr = np.empty(len(devices), dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(batch, poly), ("batch", "poly"))


def derive_pod_keys(params, seed: int, device="cuda"):
    """The (client, server) shortint key pair from ``seed``, the same words
    on every host: the client key as tfhe_tpu's derive_pod_keys draws it,
    and the server key from the same seed.  tfhe_tpu's draws its server key
    from a random seed (``ServerKey(ck)``, shortint/server_key.py:209), so
    two of its hosts would not agree; here the seed fixes both."""
    from ..shortint import ClientKey, ServerKey

    ck = ClientKey(params, seed=seed)
    return ck, ServerKey(ck, seed=seed, device=device)


def shard_batch_pod(mesh: Mesh, x: torch.Tensor) -> list:
    """x's leading axis split over the pod's batch axis (one shard a row of
    the mesh, on the row's first device; the poly axis holds it
    replicated): a list of shards."""
    return shard_batch(mesh, x, "batch")


def replicate_pod(mesh: Mesh, x) -> list:
    """x on every slot of the pod, placed once a distinct device."""
    return replicate(mesh, x)
