"""The port's client role on a machine with no GPU: tfhe_tpu_torch.client
runs keygen, encryption and decryption (shortint, integer), a compact
public-key list (encrypted and expanded with device="cpu") and the wire
format, in a subprocess where jax, jaxlib and tfhe_tpu cannot be imported
and CUDA is hidden (no visible device, torch.cuda.is_available() False);
no CUDA source is built (the kernels' libraries are never loaded, and the
native builder is asked for no .cu source)."""

import os
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]

SCRIPT = r"""
import importlib.abc
import sys

class _Blocker(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "tfhe_tpu"):
            raise ImportError(f"{name} blocked: the client role must not need it")
        return None

sys.meta_path.insert(0, _Blocker())
import torch
torch.cuda.is_available = lambda: False

from tfhe_tpu_torch.utils import build
built = []
_real_build = build.build_shared_libraries
def _recording(specs):
    built.extend(str(s) for _, sources, _ in specs for s in sources)
    return _real_build(specs)
build.build_shared_libraries = _recording

import tfhe_tpu_torch.client as c
from tfhe_tpu_torch.ops import kernels
kernels.build_shared_libraries = _recording

p = c.TEST_PARAM_MESSAGE_2_CARRY_2
ck = c.ShortintClientKey(p, seed=42)
assert ck.decrypt(c.safe_deserialize(c.safe_serialize(ck.encrypt(3)))) == 3
ick = c.IntegerClientKey(p, seed=43)
r = c.deserialize(c.serialize(ick.encrypt_radix(123, 4)))
assert isinstance(r, c.RadixCiphertext) and ick.decrypt_radix(r) == 123
s = c.deserialize(c.serialize(ick.encrypt_signed_radix(-7, 4)))
assert ick.decrypt_signed_radix(s) == -7
lst = c.CompactPublicKey(ick, seed=44).encrypt_list([1, 2, 3])
assert [ick.key.decrypt(x) for x in lst.expand(device="cpu")] == [1, 2, 3]
assert c.pke.Proof and c.pke_v2.ProofV2 and c.CompactPkeCrs and c.ProvenCompactCiphertextList
assert kernels._Libs.loaded is None, "a CUDA kernel library was loaded"
assert not [s for s in built if s.endswith((".cu", ".cuh"))], built
assert not any(m.split(".")[0] in ("jax", "jaxlib", "tfhe_tpu") for m in sys.modules)
print("TORCH-CLIENT-ONLY OK")
"""


def test_client_role_without_gpu_jax_or_tfhe_tpu():
    # one intra-op thread: the suite runs in parallel processes
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "1"}
    out = subprocess.run([sys.executable, "-c", SCRIPT], capture_output=True, text=True,
                         timeout=300, cwd=str(REPO), env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "TORCH-CLIENT-ONLY OK" in out.stdout
