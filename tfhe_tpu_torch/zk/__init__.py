"""Zero-knowledge proofs of compact-PKE encryption over BLS12-446 (port of
tfhe_tpu/zk/): host code, with the curve's hot loops in csrc/bls446.cpp."""
