"""Thread-local server-key state (high_level_api/global_state.rs:18,66).

Port of tfhe_tpu/hlapi/global_state.py."""

from __future__ import annotations

import threading

_state = threading.local()


def set_server_key(server_key) -> None:
    _state.key = server_key


def unset_server_key() -> None:
    _state.key = None


def internal_server_key():
    key = getattr(_state, "key", None)
    if key is None:
        raise RuntimeError(
            "No server key set. Call tfhe_tpu_torch.set_server_key(server_key) first."
        )
    return key


class with_server_key_as_context:
    """Scoped server-key binding (global_state.rs
    with_server_key_as_context): installs the key on entry, restores the
    previous binding on exit.

        with with_server_key_as_context(sk):
            c = a + b
    """

    def __init__(self, server_key):
        self._key = server_key

    def __enter__(self):
        self._prev = getattr(_state, "key", None)
        _state.key = self._key
        return self._key

    def __exit__(self, *exc):
        _state.key = self._prev
        return False
