"""Encrypted ASCII strings over the integer layer (port of
tfhe_tpu.strings)."""

from .ciphertext import FheString, decrypt_string, encrypt_string
from .server_key import StringServerKey
