"""Device compute: int64 torus helpers, the CRT-NTT, the KS->PBS path and
its CUDA kernels."""
