"""tfhe_tpu_torch: the PyTorch/CUDA port of tfhe_tpu for NVIDIA Hopper.

A package of its own beside tfhe_tpu (the JAX reference, which it never
imports).  Keys and ciphertexts are made on the host with numpy and are
byte-identical to tfhe_tpu's from the same seeds; the server-side KS->PBS
runs on the device through hand-written CUDA kernels (ops/kernels.py)
and gives the same u64 words as tfhe_tpu; the integer (radix) layer and the
boolean gate API, encrypted strings and the high-level API (re-exported
here, as tfhe_tpu re-exports its hlapi) are host orchestration over it.
Torus words are torch.int64 (ops/torus.py).  Entry points run on CUDA
unless given device="cpu", which runs the kernels' plain PyTorch versions.
"""

from . import boolean, hlapi, integer, shortint, strings  # noqa: F401
from .hlapi import *  # noqa: F401,F403

__version__ = "0.1.0"
