"""FheAsciiString: the high-level encrypted string type
(high_level_api/strings/): a thin operator facade over strings/server_key
through the thread-global server key.

Port of tfhe_tpu/hlapi/strings.py."""

from __future__ import annotations

from ..strings.ciphertext import FheString, decrypt_string, encrypt_string
from ..strings.server_key import StringServerKey
from .global_state import internal_server_key
from .types import FheBool, FheUint16


class FheAsciiString:
    def __init__(self, inner: FheString):
        self.inner = inner

    @classmethod
    def encrypt(cls, s: str, client_key, padding: int = 0) -> "FheAsciiString":
        if any(ord(c) > 127 for c in s):
            raise ValueError("FheAsciiString only holds ASCII")
        return cls(encrypt_string(client_key.integer_key, s, padding))

    def decrypt(self, client_key) -> str:
        return decrypt_string(client_key.integer_key, self.inner)

    def _ssk(self) -> StringServerKey:
        return StringServerKey(internal_server_key().integer_key)

    def eq(self, other) -> FheBool:
        if isinstance(other, str):
            return FheBool(self._ssk().eq_clear(self.inner, other))
        return FheBool(self._ssk().eq(self.inner, other.inner))

    def ne(self, other) -> FheBool:
        ssk = self._ssk()
        if isinstance(other, str):
            return FheBool(ssk.sk.boolean_not(ssk.eq_clear(self.inner, other)))
        return FheBool(ssk.ne(self.inner, other.inner))

    def eq_ignore_case(self, other: "FheAsciiString") -> FheBool:
        return FheBool(self._ssk().eq_ignore_case(self.inner, other.inner))

    def contains(self, pat) -> FheBool:
        pat = pat if isinstance(pat, str) else pat.inner
        return FheBool(self._ssk().contains(self.inner, pat))

    def starts_with(self, pat) -> FheBool:
        pat = pat if isinstance(pat, str) else pat.inner
        return FheBool(self._ssk().starts_with(self.inner, pat))

    def ends_with(self, pat) -> FheBool:
        pat = pat if isinstance(pat, str) else pat.inner
        return FheBool(self._ssk().ends_with(self.inner, pat))

    def find(self, pat):
        found, idx = self._ssk().find(self.inner, pat if isinstance(pat, str) else pat.inner)
        return FheBool(found), FheUint16(idx)

    def rfind(self, pat):
        found, idx = self._ssk().rfind(self.inner, pat if isinstance(pat, str) else pat.inner)
        return FheBool(found), FheUint16(idx)

    def len(self):
        return FheUint16(self._ssk().len_(self.inner))

    def is_empty(self) -> FheBool:
        return FheBool(self._ssk().is_empty(self.inner))

    def to_uppercase(self) -> "FheAsciiString":
        return FheAsciiString(self._ssk().to_uppercase(self.inner))

    def to_lowercase(self) -> "FheAsciiString":
        return FheAsciiString(self._ssk().to_lowercase(self.inner))

    def trim(self) -> "FheAsciiString":
        return FheAsciiString(self._ssk().trim(self.inner))

    def trim_start(self) -> "FheAsciiString":
        return FheAsciiString(self._ssk().trim_start(self.inner))

    def trim_end(self) -> "FheAsciiString":
        return FheAsciiString(self._ssk().trim_end(self.inner))

    def replace(self, from_pat: str, to_pat: str) -> "FheAsciiString":
        return FheAsciiString(self._ssk().replace_clear(self.inner, from_pat, to_pat))

    def concat(self, other: "FheAsciiString") -> "FheAsciiString":
        return FheAsciiString(self._ssk().concat(self.inner, other.inner))

    def repeat(self, n: int) -> "FheAsciiString":
        return FheAsciiString(self._ssk().repeat(self.inner, n))

    def strip_prefix(self, pat: str):
        out, found = self._ssk().strip_prefix(self.inner, pat)
        return FheAsciiString(out), FheBool(found)
