"""Integer-level casting keys (port of tfhe_tpu/integer/key_switching_key.py;
integer/key_switching_key/): cast whole radix ciphertexts between parameter
sets blockwise in one K1 launch."""

from __future__ import annotations

from ..shortint.key_switching_key import KeySwitchingKey as ShortintKeySwitchingKey


class KeySwitchingKey:
    def __init__(self, src_client_key, dst_client_key, params=None,
                 seed: int | None = None, device="cuda"):
        src = src_client_key.key if hasattr(src_client_key, "key") else src_client_key
        dst = dst_client_key.key if hasattr(dst_client_key, "key") else dst_client_key
        self.key = ShortintKeySwitchingKey(src, dst, params, seed, device)

    def cast(self, ct):
        return type(ct)(self.key.cast_batch(ct.blocks))
