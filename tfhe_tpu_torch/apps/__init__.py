"""Applications (port of tfhe_tpu.apps): Trivium and Kreyvium
transciphering over the boolean gate API; AES-128 and AES-256 over the
integer layer and WoPBS (``aes``, imported by name); the test-vector
emitter (``test_vectors``)."""

from . import trivium  # noqa: F401
