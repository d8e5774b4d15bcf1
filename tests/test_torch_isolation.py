"""tfhe_tpu_torch stands alone: it imports with JAX blocked (and runs a
round of each slice, the integer and boolean layers, the high-level API and
the strings, compact lists and Trivium, the KS32, PBS->KS, drift and
many-LUT arms, the wire format, squashed-noise compression, a PFPKS, a
CmLwe and a GLWE keyswitch included, and imports the ZK modules, AES, the
test vectors, the key cache and the experimental core),
no source of the port (nor chip_smoke.py) imports jax or
tfhe_tpu, and its entry points run on CUDA unless asked for the CPU,
raising where there is no GPU."""

import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

import tfhe_tpu_torch
from tfhe_tpu_torch import shortint
from tfhe_tpu_torch.ops import ntt, torus
from tfhe_tpu_torch.utils.device import resolve_device

torch.set_num_threads(1)  # the suite runs in parallel processes: one thread each

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT_SOURCES = sorted(
    str(p.relative_to(REPO))
    for p in [*(REPO / "tfhe_tpu_torch").rglob("*.py"), *(REPO / "tools").glob("*.py"),
              *(REPO / "c_api_torch").glob("*.py")]
) + ["chip_smoke.py"]
C_API_SOURCES = sorted(str(p.relative_to(REPO)) for p in (REPO / "c_api_torch").glob("*.c"))

# an import statement naming jax/jaxlib or the JAX package (not the port)
_FORBIDDEN = re.compile(
    r"^\s*(?:from|import)\s+(?:jax|jaxlib|tfhe_tpu(?!_torch))\b", re.M)
_FORBIDDEN_DYNAMIC = re.compile(
    r"import_module\(\s*['\"](?:jax|jaxlib|tfhe_tpu(?!_torch))\b")

SCRIPT = r"""
import dataclasses
import importlib.abc
import sys

class _Blocker(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib", "tfhe_tpu"):
            raise ImportError(f"{name} blocked: the port must not need it")
        return None

sys.meta_path.insert(0, _Blocker())
for m in list(sys.modules):
    if m.split(".")[0] in ("jax", "jaxlib", "tfhe_tpu"):
        del sys.modules[m]

import tfhe_tpu_torch
from tfhe_tpu_torch import shortint
from tfhe_tpu_torch.core import multibit, torus128
from tfhe_tpu_torch.ops import kernels, server, server128, ntt, torus, bsk_prep
from tfhe_tpu_torch.shortint import compression, noise_squashing

p = shortint.TEST_PARAM_MESSAGE_2_CARRY_2
ck = shortint.ClientKey(p, seed=3)
assert ck.decrypt(ck.encrypt(2)) == 2
# the multi-bit slice: keygen, one KS -> multi-bit PBS round, decrypt
mp = shortint.TEST_PARAM_MULTI_BIT_GROUP_2_MESSAGE_2_CARRY_2
mck = shortint.ClientKey(mp, seed=3)
msk = shortint.ServerKey(mck, seed=4, device="cpu")
out = msk.apply_lookup_table(mck.encrypt(2), msk.generate_lookup_table(lambda x: x + 1))
assert mck.decrypt(out) == 3
# the compression slice: compress a list, decompress it, decrypt (storage
# GLWEs cut to N_c = 16, so the decompression rotation takes 16 steps)
small = dataclasses.replace(compression.TEST_COMP_PARAM, packing_ks_polynomial_size=16,
                            lwe_per_glwe=16)
ckey = shortint.CompressionKey(ck, seed=5, comp_params=small, device="cpu")
packed = ckey.compress([ck.encrypt(m) for m in (1, 3)])
assert [ck.decrypt(c) for c in ckey.decompress(packed)] == [1, 3]
# the noise-squashing slice: squash two ciphertexts onto the u128 torus
sk = shortint.ServerKey(ck, seed=6, device="cpu")
priv = noise_squashing.NoiseSquashingPrivateKey(noise_squashing.TEST_NOISE_SQUASHING_PARAM,
                                                seed=7)
nsk = noise_squashing.NoiseSquashingKey(ck, priv, seed=8, device="cpu")
squashed = nsk.squash_ciphertext_noise_batch([ck.encrypt(m) for m in (2, 1)], sk)
assert [priv.decrypt_squashed_noise_ciphertext(s) for s in squashed] == [2, 1]
# the integer and boolean slices: one radix add, one gate
from tfhe_tpu_torch import boolean, integer
ick, isk = integer.gen_keys(p, seed=9, device="cpu")
total = isk.add_parallelized(ick.encrypt_radix(9, 2), ick.encrypt_radix(5, 2))
assert ick.decrypt_radix(total) == 14
bck, bsk = boolean.gen_keys(boolean.TEST_PARAMETERS, seed=10, device="cpu")
assert bck.decrypt(bsk.and_(bck.encrypt(True), bck.encrypt(True))) is True
# the hlapi and string slice: one FheUint8 add, one contains
cfg = tfhe_tpu_torch.ConfigBuilder().use_custom_parameters(p).build()
hck, hsk = tfhe_tpu_torch.generate_keys(cfg, seed=11, device="cpu")
tfhe_tpu_torch.set_server_key(hsk)
a8 = tfhe_tpu_torch.FheUint8.encrypt(200, hck)
assert (a8 + tfhe_tpu_torch.FheUint8.encrypt(30, hck)).decrypt(hck) == 230
assert tfhe_tpu_torch.FheAsciiString.encrypt("ab", hck).contains("b").decrypt(hck) is True
# config 5: a compact list under the compute key, expanded; clear Trivium;
# the ZK modules import (their curve builds at first use)
from tfhe_tpu_torch.apps import trivium
from tfhe_tpu_torch.hlapi import compact_list, proven_compact_list
from tfhe_tpu_torch.zk import curve446, pke, pke_v2
lst = compact_list.CompactPublicKey(hck, seed=12).encrypt_list([1, 2])
assert [hck.integer_key.key.decrypt(c) for c in lst.expand(device="cpu")] == [1, 2]
assert len(trivium.TriviumStream([False] * 80, [True] * 80).next_bits(8)) == 8
# the atomic patterns: a KS32 round (K1-32's plain version), a PBS->KS round,
# many-LUT and a drift round; the wire format, the client facade, the
# parameter snapshots, noise formulas and security checks
from tfhe_tpu_torch import client
from tfhe_tpu_torch.core import noise, security
from tfhe_tpu_torch.shortint import params_versions
from tfhe_tpu_torch.utils import cbor, serialization
for q in (shortint.TEST_PARAM_MESSAGE_2_CARRY_2_KS32,
          shortint.params.TEST_PARAM_MESSAGE_2_CARRY_2_PBS_KS,
          dataclasses.replace(p, ms_noise_reduction=shortint.MsNoiseReduction.DRIFT,
                              drift_zeros_count=4)):
    qck = shortint.ClientKey(q, seed=13)
    qsk = shortint.ServerKey(qck, seed=14, device="cpu")
    out = qsk.apply_lookup_table(qck.encrypt(1), qsk.generate_lookup_table(lambda x: x + 2))
    assert qck.decrypt(out) == 3
many = sk.apply_many_lookup_table(ck.encrypt(2), sk.generate_many_lookup_table(
    [lambda x: x, lambda x: x + 1]))
assert [ck.decrypt(c) for c in many] == [2, 3]
assert ck.decrypt(client.deserialize(client.serialize(ck.encrypt(1)))) == 1
assert params_versions.get("PARAM_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128").lwe_dimension == 918
assert all(ok for _, ok, _ in security.check_shortint_params_secure(shortint.DEFAULT_PARAMS))
assert noise.variance_to_std_log2(4.0) == 1.0
# squashed-noise compression (K6's plain version), one PFPKS (K1's plain
# version at its shape), the AES tables, the key cache and admission
from tfhe_tpu_torch.apps import aes, test_vectors
from tfhe_tpu_torch.shortint import wopbs
from tfhe_tpu_torch.utils import hbm, keycache
cpriv = noise_squashing.NoiseSquashingCompressionPrivateKey(
    noise_squashing.TEST_NOISE_SQUASHING_COMP_PARAM, seed=15)
ckey = noise_squashing.NoiseSquashingCompressionKey(priv, cpriv, seed=16, device="cpu")
assert cpriv.decrypt_list(ckey.compress(squashed)) == [2, 1]
cut = dataclasses.replace(p, polynomial_size=64)
wck = shortint.ClientKey(cut, seed=17)
wsk = shortint.ServerKey(wck, seed=18, device="cpu")
wk = wopbs.WopbsKey(wck, wsk, seed=19)
assert tuple(wk._pfpks(wck.encrypt(1).data, 0).shape) == (2, 64)
assert aes.aes128_encrypt_block(bytes(16), bytes(16)).hex() == "66e94bd4ef8a2c3b884cfa59ca342b2e"
assert hbm.admit_chunk(10, 1 << 40, min_items=1) == 1 and keycache.FORMAT >= 1
# the GLWE keyswitch (K7's plain version), the common mask and the
# experimental core: a CmLwe round trip, a GLWE keyswitch key and a switch
from tfhe_tpu_torch.core import cm, experimental, keygen
from tfhe_tpu_torch.core.params import DecompParams
from tfhe_tpu_torch.ops import polymul_ref
from tfhe_tpu_torch.utils import csprng
sec = csprng.SecretRandomGenerator(20)
gen = csprng.EncryptionRandomGenerator(21, csprng.DeterministicSeeder(22))
lwe_sks = [keygen.generate_binary_lwe_secret_key(4, sec) for _ in range(2)]
assert cm.decrypt_cm_lwe(lwe_sks, cm.encrypt_cm_lwe(lwe_sks, [5, 7], csprng.Gaussian(0.0),
                                                    gen)) == [5, 7]
g_in = experimental.generate_partial_binary_glwe_secret_key(2, 16, 20, sec)
g_out = keygen.generate_binary_glwe_secret_key(1, 16, sec)
gksk = keygen.generate_glwe_keyswitch_key(g_in, g_out, DecompParams(8, 4),
                                          csprng.Gaussian(0.0), gen, device="cpu")
out = server.glwe_keyswitch(torus.from_u64([[[0] * 16] * 3], "cpu"), gksk.data, gksk.dp, 8, 4)
assert tuple(out.shape) == (1, 2, 16) and not out.any()
assert polymul_ref.negacyclic_polymul_exact([1, 1], [1, 1])[0] == 0
assert not any(m.split(".")[0] in ("jax", "jaxlib", "tfhe_tpu")
               for m in sys.modules)
print("PORT-ISOLATED OK")
"""


def test_port_imports_with_jax_blocked():
    # one intra-op thread: the suite runs in parallel processes
    out = subprocess.run([sys.executable, "-c", SCRIPT], capture_output=True,
                         text=True, timeout=300, cwd=str(REPO),
                         env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert "PORT-ISOLATED OK" in out.stdout


@pytest.mark.parametrize("path", PORT_SOURCES)
def test_source_imports_neither_jax_nor_tfhe_tpu(path):
    text = (REPO / path).read_text()
    assert not _FORBIDDEN.findall(text), path
    assert not _FORBIDDEN_DYNAMIC.findall(text), path


@pytest.mark.parametrize("path", C_API_SOURCES)
def test_c_api_imports_only_the_port(path):
    """The C API over the port embeds an interpreter that imports the port's
    modules and nothing of tfhe_tpu."""
    text = (REPO / path).read_text()
    modules = re.findall(r'PyImport_ImportModule\(\s*"([\w.]+)"', text)
    assert all(m.split(".")[0] == "tfhe_tpu_torch" for m in modules), modules
    if path.endswith("tfhe_c.c"):
        assert {"tfhe_tpu_torch", "tfhe_tpu_torch.utils.serialization"} <= set(modules)


def test_version_and_package_doc():
    assert tfhe_tpu_torch.__version__
    assert "tfhe_tpu" in tfhe_tpu_torch.__doc__


@pytest.fixture
def no_gpu(monkeypatch):
    """Pretend the host has no CUDA device, whatever it has."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.fixture(scope="module")
def client_key():
    return shortint.ClientKey(shortint.TEST_PARAM_MESSAGE_2_CARRY_2, seed=5)


def test_server_key_default_device_raises(no_gpu, client_key):
    with pytest.raises(RuntimeError, match="cuda"):
        shortint.ServerKey(client_key, seed=6)


def test_from_raw_keys_default_device_raises(no_gpu):
    p = shortint.TEST_PARAM_MESSAGE_2_CARRY_2
    with pytest.raises(RuntimeError, match="cuda"):
        shortint.ServerKey.from_raw_keys(p, None, None)


def test_gen_keys_default_device_raises(no_gpu):
    with pytest.raises(RuntimeError, match="cuda"):
        shortint.gen_keys(shortint.TEST_PARAM_MESSAGE_2_CARRY_2, seed=1)


@pytest.mark.parametrize("layer", ["integer", "boolean"])
def test_integer_and_boolean_entry_points_default_to_cuda(no_gpu, layer):
    """gen_keys and the ServerKeys of the integer and boolean layers run on
    the card unless asked for the CPU, and raise without one."""
    from tfhe_tpu_torch import boolean, integer

    mod = integer if layer == "integer" else boolean
    params = (shortint.TEST_PARAM_MESSAGE_2_CARRY_2 if layer == "integer"
              else boolean.TEST_PARAMETERS)
    with pytest.raises(RuntimeError, match="cuda"):
        mod.gen_keys(params, seed=1)
    with pytest.raises(RuntimeError, match="cuda"):
        mod.ServerKey(mod.ClientKey(params, seed=1), seed=2)


def test_config5_entry_points_default_to_cuda(no_gpu, client_key):
    """Compact-list expansion, the casting keys, proven-list expansion and
    re-randomization run on the card unless asked for the CPU, and raise
    without one."""
    import numpy as np

    from tfhe_tpu_torch.hlapi import compact_list as cl
    from tfhe_tpu_torch.hlapi import proven_compact_list as pcl
    from tfhe_tpu_torch.shortint import key_switching_key, re_randomization

    cpk = cl.CompactPublicKey(client_key, seed=1)
    lst = cpk.encrypt_list([1])
    big = shortint.V1_4_PARAM_KEYSWITCH_PKE_TO_BIG_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128
    proven = pcl.ProvenCompactCiphertextList(lst.glwe[0], lst.glwe[1, :1], None, 4, 4)
    for call in (lambda: lst.expand(), proven.expand_without_verification,
                 lambda: cl.CompactPkeCastingKey.from_raw_parts(
                     np.zeros((1, 1, 2), np.uint64), client_key.params, big),
                 lambda: key_switching_key.KeySwitchingKey(client_key, client_key, seed=2),
                 lambda: re_randomization.ReRandomizationKey(cpk).re_randomize_batch(
                     [client_key.encrypt(1)], b"s")):
        with pytest.raises(RuntimeError, match="cuda"):
            call()


def test_slice13_entry_points_default_to_cuda(no_gpu, client_key, tmp_path, monkeypatch):
    """Squashed-noise compression keys (keygen, from_raw_keys,
    from_standard_keys), the key cache's getters and the test-vector
    emitter run on the card unless asked for the CPU, and raise without
    one; the WoPBS key and AES take their server key's device."""
    import numpy as np

    from tfhe_tpu_torch.apps import test_vectors
    from tfhe_tpu_torch.shortint import noise_squashing as ns
    from tfhe_tpu_torch.utils import keycache

    monkeypatch.setattr(keycache, "CACHE_DIR", tmp_path)
    comp = ns.TEST_NOISE_SQUASHING_COMP_PARAM
    priv = ns.NoiseSquashingPrivateKey(ns.TEST_NOISE_SQUASHING_PARAM, seed=1)
    cpriv = ns.NoiseSquashingCompressionPrivateKey(comp, seed=2)
    zeros = np.zeros((1, 1, comp.packing_ks_glwe_dimension + 1,
                      comp.packing_ks_polynomial_size), np.uint64)
    for call in (lambda: ns.NoiseSquashingCompressionKey(priv, cpriv, seed=3),
                 lambda: ns.NoiseSquashingCompressionKey.from_raw_keys(
                     np.zeros(zeros.shape[:3] + (8, zeros.shape[3]), np.uint32), comp),
                 lambda: ns.NoiseSquashingCompressionKey.from_standard_keys(zeros, zeros, comp),
                 lambda: keycache.get_shortint_keys(client_key.params, seed=4),
                 lambda: keycache.get_squashing_keys(client_key.params,
                                                     ns.TEST_NOISE_SQUASHING_PARAM, seed=4),
                 lambda: keycache.get_squash_compression_keys(
                     ns.TEST_NOISE_SQUASHING_PARAM, comp, priv, seed=4),
                 lambda: test_vectors.generate(str(tmp_path / "v"), **test_vectors.TOY_PARAMS)):
        with pytest.raises(RuntimeError, match="cuda"):
            call()


def test_cpu_is_taken_only_when_asked(no_gpu, client_key):
    assert resolve_device("cpu").type == "cpu"
    with pytest.raises(RuntimeError):
        resolve_device()
    sk = shortint.ServerKey(client_key, seed=6, device="cpu")
    assert sk.device.type == "cpu" and sk.ksk.device.type == "cpu"
    assert sk.bsk_ntt.device.type == "cpu" and not sk.trunc_acc


def test_device_plan_lives_on_the_asked_device():
    dp = ntt.device_plan(ntt.make_plan(64, 4), "cpu")
    assert dp.psi.device.type == "cpu" and dp.kernel_consts.numel() == 44
    assert torus.from_u64([1, 2], "cpu").dtype == torch.int64


def test_slice15_entry_points_default_to_cuda(no_gpu):
    """The GLWE keyswitch key, the pseudo-GGSW, the shrinking, CM keyswitch,
    CM packing and CM bootstrap keys and their NTT forms run on the card
    unless asked for the CPU, and raise without one."""
    import numpy as np

    from tfhe_tpu_torch.core import cm, experimental, keygen
    from tfhe_tpu_torch.core.params import DecompParams
    from tfhe_tpu_torch.utils import csprng

    sec = csprng.SecretRandomGenerator(1)
    gen = csprng.EncryptionRandomGenerator(2, csprng.DeterministicSeeder(3))
    noise, decomp = csprng.TUniform(0), DecompParams(8, 2)
    lwe = [keygen.generate_binary_lwe_secret_key(4, sec) for _ in range(2)]
    glwe = [keygen.generate_binary_glwe_secret_key(1, 16, sec) for _ in range(2)]
    words = np.zeros((1, 1, 2, 16), np.uint64)
    for call in (lambda: keygen.generate_glwe_keyswitch_key(glwe[0], glwe[1], decomp, noise, gen),
                 lambda: keygen.NttKey.from_raw_keys(np.zeros((1, 4, 16), np.uint32)),
                 lambda: experimental.encrypt_pseudo_ggsw(glwe[0], glwe[1], decomp, noise, gen),
                 lambda: experimental.pseudo_ggsw_to_ntt(
                     experimental.PseudoGgswCiphertext(words, decomp)),
                 lambda: experimental.generate_lwe_shrinking_keyswitch_key(lwe[0], 2, decomp,
                                                                           noise, gen),
                 lambda: cm.generate_cm_lwe_keyswitch_key(lwe, lwe, decomp, noise, gen),
                 lambda: cm.generate_cm_lwe_packing_key(lwe[0], lwe, decomp, noise, gen),
                 lambda: cm.encrypt_cm_ggsw(glwe, [0, 1], decomp, noise, gen),
                 lambda: cm.generate_cm_lwe_bootstrap_key(lwe, glwe, decomp, noise, gen),
                 lambda: cm.cm_bootstrap_key_to_ntt(np.zeros((1, 1, 3, 3, 16), np.uint64))):
        with pytest.raises(RuntimeError, match="cuda"):
            call()


# the public keygen functions that defaulted to the CPU until they were
# made to default to the card (module under tfhe_tpu_torch, name)
REPAIRED_DEFAULTS = (("core.keygen", "add_mask_times_secret"),
                     ("core.keygen", "generate_lwe_bootstrap_key"),
                     ("core.multibit", "generate_multibit_bootstrap_key"),
                     ("shortint.compression", "generate_packing_keyswitch_key"),
                     ("ops.bsk_prep", "mask_floor_bsk"),
                     ("core.cm", "encrypt_cm_lwe_batch"),
                     ("core.cm", "encrypt_cm_glwe"))


def _device_defaults():
    """(qualified name, default) of every public function, class __init__
    and public method of every tfhe_tpu_torch module whose ``device``
    parameter defaults to a string or a torch.device."""
    import importlib
    import inspect
    import pkgutil

    found = {}
    for info in pkgutil.walk_packages(tfhe_tpu_torch.__path__, "tfhe_tpu_torch."):
        mod = importlib.import_module(info.name)
        for name, obj in vars(mod).items():
            if name.startswith("_") or getattr(obj, "__module__", None) != mod.__name__:
                continue
            if inspect.isfunction(obj):
                fns = [(f"{mod.__name__}.{name}", obj)]
            elif inspect.isclass(obj):
                fns = [(f"{mod.__name__}.{name}.{attr}", inspect.unwrap(fn))
                       for attr, fn in vars(obj).items()
                       if attr == "__init__" or not attr.startswith("_")]
                fns = [(q, getattr(fn, "__func__", fn)) for q, fn in fns]
                fns = [(q, fn) for q, fn in fns if inspect.isfunction(fn)]
            else:
                continue
            for qual, fn in fns:
                param = inspect.signature(fn).parameters.get("device")
                if param is not None and isinstance(param.default, (str, torch.device)):
                    found[qual] = param.default
    return found


def test_no_public_device_default_is_the_cpu():
    """Every entry point runs on the card unless the caller asks for the
    CPU: no public function, class __init__ or public method of the port
    defaults ``device`` to the CPU.  The seven keygen functions that once
    did are named, so that a regression names its culprit."""
    defaults = _device_defaults()
    for mod, name in REPAIRED_DEFAULTS:
        qual = f"tfhe_tpu_torch.{mod}.{name}"
        assert qual in defaults, f"{qual} lost its device parameter"
        assert torch.device(defaults[qual]).type == "cuda", f"{qual} defaults to {defaults[qual]}"
    on_cpu = sorted(q for q, d in defaults.items() if torch.device(d).type == "cpu")
    assert not on_cpu, f"device defaults to the CPU in {on_cpu}"
    assert len(defaults) > 2 * len(REPAIRED_DEFAULTS)


def test_repaired_keygen_defaults_raise_without_a_gpu(no_gpu):
    """The seven repaired functions, called without a device where there is
    no card, raise before any arithmetic instead of running on the host."""
    import numpy as np

    from tfhe_tpu_torch.core import cm, keygen, multibit
    from tfhe_tpu_torch.core.entities import LweBootstrapKey
    from tfhe_tpu_torch.core.params import DecompParams
    from tfhe_tpu_torch.ops import bsk_prep
    from tfhe_tpu_torch.shortint import compression
    from tfhe_tpu_torch.utils import csprng

    sec = csprng.SecretRandomGenerator(1)
    gen = csprng.EncryptionRandomGenerator(2, csprng.DeterministicSeeder(3))
    noise, decomp = csprng.TUniform(0), DecompParams(8, 2)
    lwe = [keygen.generate_binary_lwe_secret_key(4, sec) for _ in range(2)]
    glwe = [keygen.generate_binary_glwe_secret_key(1, 16, sec) for _ in range(2)]
    for call in (lambda: keygen.add_mask_times_secret(np.zeros((1, 2, 16), np.uint64), glwe[0]),
                 lambda: keygen.generate_lwe_bootstrap_key(lwe[0], glwe[0], decomp, noise, gen),
                 lambda: multibit.generate_multibit_bootstrap_key(lwe[0], glwe[0], decomp, 2,
                                                                  noise, gen),
                 lambda: compression.generate_packing_keyswitch_key(lwe[0], glwe[0], 8, 2,
                                                                    noise, gen),
                 lambda: bsk_prep.mask_floor_bsk(
                     LweBootstrapKey(np.zeros((1, 1, 2, 2, 16), np.uint64), decomp), glwe[0], 4),
                 lambda: cm.encrypt_cm_lwe_batch(lwe, np.zeros((1, 2), np.uint64), noise, gen),
                 lambda: cm.encrypt_cm_glwe(glwe, np.zeros((2, 16), np.uint64), noise, gen)):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
