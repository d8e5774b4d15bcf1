"""Versioned parameter snapshots + alias discipline (port of
tfhe_tpu/shortint/params_versions.py: the same snapshot of the same sets).

Analog of shortint/parameters/{v0_10..v1_7}/ + aliases.rs: every shipped
parameter set lives in an immutable per-version snapshot registry, and the
UNVERSIONED `PARAM_*` names are aliases into the CURRENT version.  Adding a
new tuning creates a new snapshot version; old versions stay importable so
serialized data referencing them keeps deserializing (the upgrade-chain
muscle of utils/serialization).

The reference ships eight historical snapshots (v0_10..v1_7) because it has
eight releases of history; this framework starts at the v1_4-generation
tunings (the reference's current recommended values), registered as its
first snapshot.
"""

from __future__ import annotations

from types import MappingProxyType

from . import params as _p

CURRENT_VERSION = "v1_4"

# immutable per-version snapshot: name (without version prefix) -> set
_V1_4 = {
    name[len("V1_4_"):]: getattr(_p, name)
    for name in dir(_p)
    if name.startswith("V1_4_") and not callable(getattr(_p, name))
}

PARAMETER_VERSIONS = MappingProxyType({
    "v1_4": MappingProxyType(_V1_4),
})


def get(name: str, version: str = CURRENT_VERSION):
    """Look up a parameter set by unversioned name in a snapshot, e.g.
    get("PARAM_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128")."""
    return PARAMETER_VERSIONS[version][name]


def aliases() -> dict:
    """Unversioned PARAM_* names -> current-version sets (aliases.rs)."""
    return {name: get(name) for name in PARAMETER_VERSIONS[CURRENT_VERSION]}


# materialize the aliases at module level (PARAM_MESSAGE_2_CARRY_2_... etc.)
for _name, _val in aliases().items():
    globals()[_name] = _val
del _name, _val
