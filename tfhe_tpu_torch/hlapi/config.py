"""Config / ConfigBuilder (high_level_api/config.rs:14,41).

Port of tfhe_tpu/hlapi/config.py.  The compact public key (with its
compact lists and ZK proofs) comes with ROADMAP queue 1 item 15: asking
for it raises."""

from __future__ import annotations

from dataclasses import dataclass

from ..shortint.params import DEFAULT_PARAMS, ShortintParams

COMPACT_PUBLIC_KEY_PENDING = (
    "the compact public key, compact lists and ZK proofs: ROADMAP queue 1 item 15")


@dataclass
class Config:
    shortint_params: ShortintParams = DEFAULT_PARAMS
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

    def enable_noise_squashing(self, params=None) -> "ConfigBuilder":
        from ..shortint.noise_squashing import (
            V1_4_NOISE_SQUASHING_PARAM_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128,
        )

        self._config.enable_noise_squashing = True
        self._config.noise_squashing_params = (
            params or V1_4_NOISE_SQUASHING_PARAM_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128)
        return self

    def enable_compact_public_key(self) -> "ConfigBuilder":
        raise NotImplementedError(COMPACT_PUBLIC_KEY_PENDING)

    def build(self) -> Config:
        return self._config
