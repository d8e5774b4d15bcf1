"""Cryptographic entity containers.

Mirrors the reference's entities/algorithms split
(tfhe/src/core_crypto/entities/): entities are dumb containers over arrays;
algorithms are free functions (keygen.py, encrypt.py, ../ops/server.py).

Memory layouts follow the reference conventions:
  - LWE ciphertext: [mask (n), body] — one flat vector of n+1 scalars.
  - GLWE ciphertext: (k+1, N) — k mask polynomials then the body polynomial.
  - KSK: (n_in, l, n_out+1) — per input-key element, per level (level l
    stored first, matching the decomposition iteration order), one LWE.
  - BSK: (n_in, l, k+1, k+1, N) — per input-key element one GGSW of l level
    matrices, each (k+1) rows of GLWE ciphertexts ((k+1) polys each).
    Stored level index j corresponds to decomposition level l-j.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .params import DecompParams


@dataclass
class LweSecretKey:
    data: np.ndarray  # (n,) binary in {0,1}

    @property
    def dimension(self) -> int:
        return self.data.shape[-1]


@dataclass
class GlweSecretKey:
    data: np.ndarray  # (k, N) binary

    @property
    def glwe_dimension(self) -> int:
        return self.data.shape[0]

    @property
    def polynomial_size(self) -> int:
        return self.data.shape[1]

    def as_lwe_secret_key(self) -> LweSecretKey:
        """Flatten (k, N) -> (k*N,), matching GlweSecretKey::as_lwe_secret_key."""
        return LweSecretKey(self.data.reshape(-1))


@dataclass
class LweCiphertext:
    data: np.ndarray  # (n+1,): mask then body

    @property
    def lwe_dimension(self) -> int:
        return self.data.shape[-1] - 1

    @property
    def mask(self) -> np.ndarray:
        return self.data[..., :-1]

    @property
    def body(self) -> np.ndarray:
        return self.data[..., -1]


@dataclass
class GlweCiphertext:
    data: np.ndarray  # (k+1, N)

    @property
    def glwe_dimension(self) -> int:
        return self.data.shape[-2] - 1

    @property
    def polynomial_size(self) -> int:
        return self.data.shape[-1]

    @property
    def mask(self) -> np.ndarray:
        return self.data[..., :-1, :]

    @property
    def body(self) -> np.ndarray:
        return self.data[..., -1, :]


@dataclass
class LweKeyswitchKey:
    data: np.ndarray  # (n_in, l, n_out+1)
    decomp: DecompParams

    @property
    def input_lwe_dimension(self) -> int:
        return self.data.shape[0]

    @property
    def output_lwe_dimension(self) -> int:
        return self.data.shape[2] - 1


@dataclass
class LweBootstrapKey:
    data: np.ndarray  # (n_in, l, k+1, k+1, N)
    decomp: DecompParams

    @property
    def input_lwe_dimension(self) -> int:
        return self.data.shape[0]

    @property
    def level_count(self) -> int:
        return self.data.shape[1]

    @property
    def glwe_size(self) -> int:
        return self.data.shape[2]

    @property
    def polynomial_size(self) -> int:
        return self.data.shape[4]
