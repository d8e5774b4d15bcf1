"""Applications over the boolean gate API (port of tfhe_tpu.apps: Trivium and
Kreyvium transciphering)."""

from . import trivium  # noqa: F401
