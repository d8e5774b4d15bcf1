"""Tag: small user metadata propagated key -> ciphertext -> result
(high_level_api/tag.rs:319).  An opaque byte string; operations propagate
the left operand's tag (the reference's convention).

Port of tfhe_tpu/hlapi/tag.py."""

from __future__ import annotations


class Tag:
    __slots__ = ("data",)

    def __init__(self, data: bytes = b""):
        self.data = bytes(data)

    @classmethod
    def from_u64(cls, v: int) -> "Tag":
        return cls(int(v).to_bytes(8, "little"))

    def as_u64(self) -> int:
        return int.from_bytes((self.data + b"\0" * 8)[:8], "little")

    def __eq__(self, other) -> bool:
        return isinstance(other, Tag) and self.data == other.data

    def __repr__(self) -> str:
        return f"Tag({self.data!r})"

    def __bool__(self) -> bool:
        return bool(self.data)
