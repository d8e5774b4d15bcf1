"""Config / ConfigBuilder (high_level_api/config.rs:14,41).

Port of tfhe_tpu/hlapi/config.py.  ``enable_compression`` is a flag that
nothing reads, as in tfhe_tpu; ``enable_compact_public_key`` makes
CompressedXofKeySet.expand derive a CompactPublicKey."""

from __future__ import annotations

from dataclasses import dataclass

from ..shortint.params import DEFAULT_PARAMS, ShortintParams


@dataclass
class Config:
    shortint_params: ShortintParams = DEFAULT_PARAMS
    enable_compression: bool = False
    enable_noise_squashing: bool = False
    enable_compact_public_key: bool = False
    noise_squashing_params: object = None


class ConfigBuilder:
    def __init__(self):
        self._config = Config()

    @staticmethod
    def default() -> "ConfigBuilder":
        return ConfigBuilder()

    def use_custom_parameters(self, params: ShortintParams) -> "ConfigBuilder":
        self._config.shortint_params = params
        return self

    def enable_compression(self) -> "ConfigBuilder":
        self._config.enable_compression = True
        return self

    def enable_noise_squashing(self, params=None) -> "ConfigBuilder":
        from ..shortint.noise_squashing import (
            V1_4_NOISE_SQUASHING_PARAM_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128,
        )

        self._config.enable_noise_squashing = True
        self._config.noise_squashing_params = (
            params or V1_4_NOISE_SQUASHING_PARAM_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128)
        return self

    def enable_compact_public_key(self) -> "ConfigBuilder":
        self._config.enable_compact_public_key = True
        return self

    def build(self) -> Config:
        return self._config
