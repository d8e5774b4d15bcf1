"""Torus words as ``torch.int64``.

torch has no add, shift or compare for ``uint64`` on the CPU, so the port
keeps every u64 torus word in an int64 tensor: two's-complement add, sub,
neg and mul are exactly arithmetic mod 2^64, and the same 64 bits cross to
numpy's uint64 through a view.  What differs from unsigned arithmetic is
``>>`` (arithmetic on int64), comparison, and floor division; the helpers
below give the unsigned meaning where the torus code needs it.
"""

from __future__ import annotations

import numpy as np
import torch

MIN64 = -(1 << 63)
_M64 = (1 << 64) - 1


def s64(value: int) -> int:
    """A u64 constant as the int64 with the same 64 bits."""
    value &= _M64
    return value - (1 << 64) if value >> 63 else value


def from_u64(a, device="cuda") -> torch.Tensor:
    """numpy uint64 (or anything numpy takes) -> int64 tensor on ``device``,
    same bits."""
    arr = np.ascontiguousarray(np.asarray(a, dtype=np.uint64)).view(np.int64)
    return torch.from_numpy(arr.copy()).to(device)


def to_u64(t: torch.Tensor) -> np.ndarray:
    """int64 tensor -> numpy uint64 array with the same bits (host copy)."""
    return t.detach().to("cpu").contiguous().numpy().view(np.uint64)


def shr(x: torch.Tensor, shift: int) -> torch.Tensor:
    """Logical right shift of u64 words held in int64."""
    if shift == 0:
        return x
    return (x >> shift) & ((1 << (64 - shift)) - 1)


def ult(a: torch.Tensor, b) -> torch.Tensor:
    """Unsigned a < b of u64 words held in int64 (b a tensor or an int)."""
    if isinstance(b, int):
        return (a ^ MIN64) < s64(b) ^ MIN64
    return (a ^ MIN64) < (b ^ MIN64)


def uge(a: torch.Tensor, b) -> torch.Tensor:
    """Unsigned a >= b of u64 words held in int64."""
    return ~ult(a, b)
