"""Boolean gate parameters (port of tfhe_tpu/boolean/params.py).

The reference's boolean layer runs a dedicated u32-torus parameter set
(boolean/parameters/params.rs:10-22, n=805 k=3 N=512 Gaussian).  tfhe_tpu,
and so the port, shares the u64 pipeline of shortint, so boolean gates use
64-bit-torus parameter sets with equivalent security/noise margins; the
+-1/8 encoding is unchanged (boolean/mod.rs:72-78 PLAINTEXT_TRUE = q/8).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..core.params import BootstrapParams, DecompParams, GlweParams, LweParams
from ..utils.csprng import Gaussian, TUniform


@dataclass(frozen=True)
class BooleanParameters:
    lwe_dimension: int
    glwe_dimension: int
    polynomial_size: int
    lwe_noise: object
    glwe_noise: object
    pbs_base_log: int
    pbs_level: int
    ks_base_log: int
    ks_level: int
    bits: int = 64

    @property
    def core(self) -> BootstrapParams:
        return BootstrapParams(
            lwe=LweParams(self.lwe_dimension, self.lwe_noise),
            glwe=GlweParams(self.glwe_dimension, self.polynomial_size, self.glwe_noise),
            pbs_decomp=DecompParams(self.pbs_base_log, self.pbs_level),
            ks_decomp=DecompParams(self.ks_base_log, self.ks_level),
        )

    @property
    def big_lwe_dimension(self) -> int:
        return self.glwe_dimension * self.polynomial_size


# 128-bit-secure parameters on the u64 torus (matching the 2_2 compute set's
# security level; boolean needs far less precision than it provides).
DEFAULT_PARAMETERS = BooleanParameters(
    lwe_dimension=918,
    glwe_dimension=1,
    polynomial_size=2048,
    lwe_noise=TUniform(45),
    glwe_noise=TUniform(17),
    pbs_base_log=23,
    pbs_level=1,
    ks_base_log=4,
    ks_level=4,
)

# KS->PBS ordering variant (boolean/parameters/mod.rs DEFAULT_PARAMETERS_KS_PBS
# analog; same dims on the u64 torus — ordering is handled by the engine).
DEFAULT_PARAMETERS_KS_PBS = DEFAULT_PARAMETERS

# TFHE-lib historical parameters (boolean/parameters/mod.rs:131), mapped to
# the u64 torus with Gaussian noise of the same RELATIVE standard deviation
# (the reference values are torus fractions, torus-width independent).
# tfhe_tpu scales them by 2^64 before the sampler scales them again; the
# port keeps its values for byte-identical keys (ROADMAP queue 3).
def _tfhe_lib_params():
    return BooleanParameters(
        lwe_dimension=630,
        glwe_dimension=1,
        polynomial_size=1024,
        lwe_noise=Gaussian(0.000030517578125 * 2.0 ** 64),
        glwe_noise=Gaussian(0.00000002980232238769531 * 2.0 ** 64),
        pbs_base_log=7,
        pbs_level=3,
        ks_base_log=2,
        ks_level=8,
    )


TFHE_LIB_PARAMETERS = _tfhe_lib_params()

# Higher-assurance variant (PARAMETERS_ERROR_PROB_2_POW_MINUS_165 analog).
# TUniform(43) is the estimator minimum at n=1024/q=2^64
# (core/security.minimal_lwe_bound_tuniform; the round-3 security gate
# caught the earlier TUniform(42) as one bit short).
PARAMETERS_ERROR_PROB_2_POW_MINUS_165 = BooleanParameters(
    lwe_dimension=1024,
    glwe_dimension=1,
    polynomial_size=2048,
    lwe_noise=TUniform(43),
    glwe_noise=TUniform(17),
    pbs_base_log=23,
    pbs_level=1,
    ks_base_log=4,
    ks_level=5,
)

# Fast insecure parameters for unit tests.
TEST_PARAMETERS = BooleanParameters(
    lwe_dimension=16,
    glwe_dimension=1,
    polynomial_size=512,
    lwe_noise=TUniform(3),
    glwe_noise=TUniform(3),
    pbs_base_log=23,
    pbs_level=1,
    ks_base_log=4,
    ks_level=4,
)
