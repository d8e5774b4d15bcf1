"""Multi-device execution: one process driving a mesh of devices (the
port of tfhe_tpu/parallel/)."""

from .mesh import Mesh, make_mesh, replicate, shard_batch, sharded_ks_pbs
