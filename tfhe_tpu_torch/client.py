"""Client-role surface: everything a key-holding client needs, on the host
(port of tfhe_tpu/client.py).

The reference ships this role as js_on_wasm_api/ (wasm-bindgen over the
client primitives).  Here the client role is host Python, NumPy and
PyTorch's CPU build: keygen, encryption and decryption, compact public-key
lists, ZK proofs of encryption and the versioned wire format, with
``device="cpu"`` wherever an entry point takes a device.  None of it
imports JAX or tfhe_tpu, or builds a CUDA source: a client runs on a
machine with no GPU, and its payloads (``serialize``) are what the server
reads on the card, and the server's are what it decrypts.  The wire format
is tfhe_tpu's (utils/serialization.py), so either package reads the
other's payloads.  tests/test_torch_client_only.py runs this facade with
JAX, tfhe_tpu and CUDA hidden.
"""

from __future__ import annotations

# compact public-key lists and their proofs (host encryption, pure-Python
# proofs over the native curve core)
from .hlapi.compact_list import (  # noqa: F401
    CompactCiphertextList,
    CompactPrivateKey,
    CompactPublicKey,
)
from .hlapi.proven_compact_list import (  # noqa: F401
    CompactPkeCrs,
    ProvenCompactCiphertextList,
)

# integer client role
from .integer.ciphertext import (  # noqa: F401
    BooleanBlock,
    RadixCiphertext,
    SignedRadixCiphertext,
)
from .integer.client_key import ClientKey as IntegerClientKey  # noqa: F401

# shortint client role
from .shortint.ciphertext import Ciphertext  # noqa: F401
from .shortint.client_key import ClientKey as ShortintClientKey  # noqa: F401
from .shortint.params import (  # noqa: F401
    DEFAULT_PARAMS,
    TEST_PARAM_MESSAGE_2_CARRY_2,
    V1_4_PARAM_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128,
    MultiBitPBSParameters,
    ShortintParams,
)

# serialization (versioned CBOR, safe limits)
from .utils.serialization import (  # noqa: F401
    deserialize,
    safe_deserialize,
    safe_serialize,
    serialize,
)

# ZK proofs of encryption (prove on the client)
from .zk import pke, pke_v2  # noqa: F401

__all__ = [
    "Ciphertext",
    "ShortintClientKey",
    "IntegerClientKey",
    "RadixCiphertext",
    "SignedRadixCiphertext",
    "BooleanBlock",
    "ShortintParams",
    "MultiBitPBSParameters",
    "DEFAULT_PARAMS",
    "TEST_PARAM_MESSAGE_2_CARRY_2",
    "V1_4_PARAM_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128",
    "CompactPublicKey",
    "CompactPrivateKey",
    "CompactCiphertextList",
    "CompactPkeCrs",
    "ProvenCompactCiphertextList",
    "serialize",
    "deserialize",
    "safe_serialize",
    "safe_deserialize",
    "pke",
    "pke_v2",
]
