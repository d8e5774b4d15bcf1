"""Device-memory admission (port of tfhe_tpu/utils/hbm.py; the analog of
the reference's check_valid_cuda_malloc, core_crypto/gpu/mod.rs:234): size
batched work to the card's free memory instead of discovering an
out-of-memory error in the middle of it.

Callers chunk a batch by ``admit_chunk``: the batched decompression
(shortint/compression.py), the squash (K5's per-call scratch of B x 6 x
(k+1) x N int32, shortint/noise_squashing.py) and squashed-noise
compression (K6's partial sums).  A chunk's outputs are the words the
unchunked call gives: every element of these batches is computed on its
own.
"""

from __future__ import annotations

import os

import torch


def device_free_bytes(device=None, default: int = 12 << 30) -> int:
    """Free memory on ``device`` (bytes): on a CUDA card the free bytes
    torch.cuda.mem_get_info reports plus what PyTorch's caching allocator
    holds unused; ``default`` on a device without memory stats (the CPU),
    as tfhe_tpu's.  TFHE_TPU_HBM_BYTES overrides both."""
    env = os.environ.get("TFHE_TPU_HBM_BYTES")
    if env:
        return int(env)
    dev = torch.device(device) if device is not None else None
    if dev is not None and dev.type == "cuda":
        free, _ = torch.cuda.mem_get_info(dev)
        cached = torch.cuda.memory_reserved(dev) - torch.cuda.memory_allocated(dev)
        return int(free + max(0, cached))
    return default


def admit_chunk(n_items: int, bytes_per_item: int, fixed_bytes: int = 0,
                headroom: float = 0.85, min_items: int = 8, device=None) -> int:
    """Largest chunk of a batched device op that fits the free memory
    (tfhe_tpu/utils/hbm.py:36-49, the same arithmetic).

    bytes_per_item: the op's peak working set a batch element;
    fixed_bytes: batch-independent residents the op needs (keys already on
    the device do NOT count: they are not free).  Returns a chunk size in
    [min_items, n_items]."""
    free = device_free_bytes(device)
    budget = max(0, int(free * headroom) - fixed_bytes)
    if bytes_per_item <= 0:
        return n_items
    c = budget // bytes_per_item
    return int(max(min_items, min(n_items, c)))
