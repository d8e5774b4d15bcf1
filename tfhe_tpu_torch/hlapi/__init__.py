"""High-level API: FheUint/FheInt/FheBool with operator overloads, encrypted
ASCII strings, arrays and a key-value store (port of tfhe_tpu.hlapi).

Analog of tfhe::high_level_api (SURVEY.md §2.7): `generate_keys(config)`,
`set_server_key` thread-global state (global_state.rs:66), typed integers
with Python operator overloads dispatching to the batched integer layer.
Host orchestration only: every op is the integer layer's rounds on the
device of the server key in use (K1, then K2 or K3 on the card).
"""

from .config import Config, ConfigBuilder
from .array import FheUintArray
from .strings import FheAsciiString
from .tag import Tag
from .xof_key_set import CompressedXofKeySet, XofKeySet
from .keys import ClientKey, CompressedServerKey, PublicKey, ServerKey, generate_keys
from .global_state import (set_server_key, unset_server_key,
                           with_server_key_as_context)
from .types import (ALL_INT_TYPES, ALL_UINT_TYPES, FHE_WIDTHS, FheBool,
                    bitonic_shuffle, match_value, match_value_or)

# re-export every generated width (FheUint2..FheUint2048, FheInt2..FheInt2048:
# the reference's full 82-type surface, high_level_api/mod.rs pub use list)
for _t in ALL_UINT_TYPES + ALL_INT_TYPES:
    globals()[_t.__name__] = _t

__all__ = [
    "Config", "ConfigBuilder", "ClientKey", "ServerKey", "CompressedServerKey",
    "PublicKey", "generate_keys", "set_server_key", "unset_server_key",
    "with_server_key_as_context",
    "FheUintArray", "FheAsciiString", "Tag", "CompressedXofKeySet", "XofKeySet",
    "FheBool", "FHE_WIDTHS", "ALL_UINT_TYPES", "ALL_INT_TYPES",
    "bitonic_shuffle", "match_value", "match_value_or",
] + [_t.__name__ for _t in ALL_UINT_TYPES + ALL_INT_TYPES]
del _t
