"""The hand-written CUDA kernels of the port: build, load, wrappers.

K1 ``keyswitch`` (csrc/keyswitch.cu; by ``keyswitch_route``: its
tensor-core kernel where ``keyswitch_imma_shape`` holds, its limb-row
kernel at the wide-digit shapes (the WoPBS PFPKS, the cast to the big
key: each digit's balanced byte limbs on rows of the same int8 product),
both on a ``KeyswitchKeyLimbs`` and with the contraction cut into slices
(``keyswitch_splits``: two waves where the tensor-core kernel's grid would
fill less than half the card; ``keyswitch_limb_splits``: one full wave),
else its generic kernel), K1-32 ``keyswitch32`` (the KS32 pattern's u32
keyswitch, the same source: the tensor-core kernel on 4 byte limbs a key
word, and a u32 twin of the generic kernel), K2 ``blind_rotate``
(csrc/blind_rotate.cu; ``cmux_step`` is its single-step entry; exact mode
takes the lazy exact kernel, the cluster kernel of
csrc/blind_rotate_cluster.cu (four blocks a ciphertext, one a CRT prime:
3_3, the common-mask rotation at N = 2048, and its small-N kernel at the
TEST shapes, N = 512) or the generic kernel, by
``exact_rotation_route``), K3
``blind_rotate_multibit`` (csrc/blind_rotate_multibit.cu; exact mode takes
its lazy kernel, the cluster kernel of csrc/blind_rotate_multibit_cluster.cu
at the GPU multi-bit GROUP_2 and GROUP_3 shapes or its generic kernel, by
``multibit_exact_route``; K2 and K3 take
their rounded-key kernels, C ciphertexts a block, on an
ops/bsk_prep.py RoundedKeyNtt in v7 and v9 mode), K4
``packing_keyswitch`` (csrc/packing_keyswitch.cu; its tensor-core kernel
where ``packing_keyswitch_imma_shape`` holds, on a
``PackingKeyswitchKeyLimbs``), K5
``blind_rotate128`` (csrc/blind_rotate128.cu; K2-K5 include
csrc/ntt_common.cuh) and K6 ``packing_keyswitch128``
(csrc/packing_keyswitch128.cu, the u128 packing keyswitch of squashed-noise
compression, on the int8 tensor cores, on the key's byte layout
``packing_keyswitch128_key``; ``cmux`` is K2's
CMux entry, vertical packing's tree, and the common mask's CMux (by
``cmux_route``: the cluster kernels' one-step CMux mode at N = 512 and at
N = 2048, 3 <= k+1 <= 8, else the generic kernel's external product);
``rotate_accumulator`` its exact rotation of a given accumulator, the
common-mask rotation's; ``cmux_chain`` its CMux chain, vertical packing's
low bits for many packings in one launch, each on its own GGSW set, on
the cluster kernel's small-N kernel), K7 ``glwe_keyswitch``
(csrc/glwe_keyswitch.cu, the GLWE keyswitch and the fast keyswitch: its
cluster kernel, four blocks a GLWE, one a CRT prime, where
``glwe_keyswitch_route`` says so, else its first kernel) and K8
``blind_rotate_extended``
(csrc/blind_rotate_extended.cu, the extended PBS's rotation: its lazy
kernel at the 2_2 shape, ``extended_route``, else its generic kernel; the
E slots of a ciphertext in one cluster) and K9 ``poly_shard_forward``,
``poly_shard_cross`` and ``poly_shard_inverse`` (csrc/poly_shard.cu, the
slot-local stages of the four-step split of parallel/poly_shard.py; plain
versions in ops/four_step.py) and its fused entry ``poly_shard_rotate``
(the whole poly-sharded rotation in one launch, one thread-block cluster a
ciphertext, where every slot is the same card: ``poly_rotation_route``) are
compiled with nvcc for sm_90a into shared libraries with a plain C interface at first use (utils/build.py, all
compilers started together) and called through ctypes on PyTorch's current
stream.

Each wrapper runs its plain PyTorch version (ops/server.py,
ops/server128.py) when given CPU tensors, and launches its kernel on CUDA
tensors or raises: there is no fallback; where a wrapper has two kernels
it chooses by shape.  ``<wrapper>.launches`` counts kernel launches, and
nothing else; ``keyswitch.imma_launches``, ``keyswitch.limb_launches``,
``keyswitch32.imma_launches``, ``glwe_keyswitch.cluster_launches``,
``packing_keyswitch.imma_launches``, ``blind_rotate`` /
``cmux_step.lazy_exact_launches``, ``blind_rotate.cluster_launches``,
``cmux.small_launches``, ``cmux.cluster_launches``,
``blind_rotate_multibit.cluster_launches`` and
``blind_rotate_extended.lazy_launches`` count those of the redesigned and
new kernels among them.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from functools import lru_cache

import torch

from ..utils.build import CSRC, build_shared_libraries
from . import four_step, server, server128
from .bsk_prep import RoundedKeyNtt
from .ntt import (KERNEL128_CONSTS_LEN, KERNEL128_PRIMES, KERNEL_CONSTS_LEN,
                  KERNEL_PRIMES, DevicePlan, shoup_twiddles)

SMEM_LIMIT = 232448   # bytes of shared memory one block may use on Hopper
_NVCC = ["nvcc", "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
         "-O3", "-shared", "-Xcompiler", "-fPIC"]
_SOURCES = {"keyswitch": "keyswitch.cu", "blind_rotate": "blind_rotate.cu",
            "blind_rotate_cluster": "blind_rotate_cluster.cu",
            "blind_rotate_multibit": "blind_rotate_multibit.cu",
            "blind_rotate_multibit_cluster": "blind_rotate_multibit_cluster.cu",
            "packing_keyswitch": "packing_keyswitch.cu",
            "blind_rotate128": "blind_rotate128.cu",
            "packing_keyswitch128": "packing_keyswitch128.cu",
            "glwe_keyswitch": "glwe_keyswitch.cu",
            "blind_rotate_extended": "blind_rotate_extended.cu",
            "poly_shard": "poly_shard.cu"}


class _Libs:
    loaded = None      # {name in _SOURCES: CDLL}


def nvcc_command() -> list:
    """The nvcc invocation the kernels are built with (PATH, then the
    toolkit's default /usr/local/cuda/bin)."""
    import os
    import shutil

    if shutil.which("nvcc"):
        return _NVCC
    cuda_nvcc = os.path.join("/usr/local/cuda/bin", "nvcc")
    if os.path.exists(cuda_nvcc):
        return [cuda_nvcc] + _NVCC[1:]
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def source_paths() -> list:
    """The kernels' sources, relative to the checkout."""
    return [str((CSRC / src).relative_to(CSRC.parents[1]))
            for src in _SOURCES.values()]


def load() -> dict:
    """Build (first use only) and load the kernel libraries."""
    if _Libs.loaded is None:
        cmd = nvcc_command()
        paths = build_shared_libraries(
            [(f"tfhe_torch_{name}", [CSRC / src], cmd)
             for name, src in _SOURCES.items()])
        libs = {name: ctypes.CDLL(str(p)) for name, p in zip(_SOURCES, paths)}
        vp, i = ctypes.c_void_p, ctypes.c_int
        for fn in (libs["keyswitch"].tfhe_torch_keyswitch,
                   libs["keyswitch"].tfhe_torch_keyswitch32):
            fn.argtypes = [vp, vp, vp, i, i, i, i, i, vp]
            fn.restype = i
        for fn in (libs["keyswitch"].tfhe_torch_keyswitch_imma,
                   libs["keyswitch"].tfhe_torch_keyswitch32_imma):
            fn.argtypes = [vp] * 4 + [i] * 8 + [vp]
            fn.restype = i
        for fn in (libs["keyswitch"].tfhe_torch_keyswitch_imma_shape,
                   libs["keyswitch"].tfhe_torch_keyswitch_limb_shape):
            fn.argtypes = [i] * 3
            fn.restype = i
        fn = libs["keyswitch"].tfhe_torch_keyswitch_limbs
        fn.argtypes = [vp] * 4 + [i] * 8 + [vp]
        fn.restype = i
        for fn in (libs["keyswitch"].tfhe_torch_keyswitch_imma_chunk,
                   libs["keyswitch"].tfhe_torch_keyswitch_imma_columns):
            fn.argtypes = []
            fn.restype = i
        fn = libs["blind_rotate"].tfhe_torch_blind_rotate
        fn.argtypes = [vp] * 6 + [i] * 7 + [vp]
        fn.restype = i
        fn = libs["blind_rotate_cluster"].tfhe_torch_blind_rotate_cluster
        fn.argtypes = [vp] * 4 + [ctypes.c_longlong] + [vp] * 3 + [i] * 7 + [vp]
        fn.restype = i
        for fn in (libs["blind_rotate"].tfhe_torch_cmux,
                   libs["blind_rotate_cluster"].tfhe_torch_cmux_cluster):
            fn.argtypes = [vp] * 7 + [i] * 6 + [vp]
            fn.restype = i
        fn = libs["blind_rotate"].tfhe_torch_blind_rotate_exact_lazy
        fn.argtypes = [vp] * 6 + [i] * 7 + [vp]
        fn.restype = i
        fn = libs["blind_rotate"].tfhe_torch_blind_rotate_exact_cts_per_block
        fn.argtypes = []
        fn.restype = i
        fn = libs["blind_rotate"].tfhe_torch_blind_rotate_exact_lazy_shape
        fn.argtypes = [i] * 4
        fn.restype = i
        fn = libs["blind_rotate"].tfhe_torch_blind_rotate_rounded
        fn.argtypes = [vp] * 6 + [i] * 8 + [vp]
        fn.restype = i
        fn = libs["blind_rotate_multibit"].tfhe_torch_blind_rotate_multibit_rounded
        fn.argtypes = [vp] * 6 + [i] * 9 + [vp]
        fn.restype = i
        fn = libs["blind_rotate"].tfhe_torch_rounded_cts_per_block
        fn.argtypes = []
        fn.restype = i
        fn = libs["blind_rotate"].tfhe_torch_rounded_smem_bytes
        fn.argtypes = [i]
        fn.restype = i
        fn = libs["blind_rotate_multibit"].tfhe_torch_blind_rotate_multibit
        fn.argtypes = [vp] * 9 + [i] * 8 + [vp]
        fn.restype = i
        fn = libs["blind_rotate_multibit"].tfhe_torch_blind_rotate_multibit_cts_per_block
        fn.argtypes = [i] * 5
        fn.restype = i
        fn = libs["blind_rotate_multibit"].tfhe_torch_blind_rotate_multibit_smem_bytes
        fn.argtypes = [i] * 3
        fn.restype = i
        mc = libs["blind_rotate_multibit_cluster"]
        mc.tfhe_torch_blind_rotate_multibit_cluster.argtypes = [vp] * 7 + [i] * 8 + [vp]
        mc.tfhe_torch_blind_rotate_multibit_cluster.restype = i
        mc.tfhe_torch_blind_rotate_multibit_cluster_shape.argtypes = [i] * 5
        mc.tfhe_torch_blind_rotate_multibit_cluster_shape.restype = i
        for fn in (mc.tfhe_torch_blind_rotate_multibit_cluster_smem,
                   mc.tfhe_torch_blind_rotate_multibit_cluster_occupancy):
            fn.argtypes = [i] * 3
            fn.restype = i
        for fn in (libs["packing_keyswitch"].tfhe_torch_packing_keyswitch,
                   libs["packing_keyswitch"].tfhe_torch_packing_keyswitch_imma):
            fn.argtypes = [vp] * 3 + [i] * 7 + [vp]
            fn.restype = i
        for fn in (libs["packing_keyswitch"].tfhe_torch_packing_keyswitch_imma_shape,
                   libs["packing_keyswitch"].tfhe_torch_packing_keyswitch_imma_inputs):
            fn.argtypes = [i] * 5
            fn.restype = i
        fn = libs["blind_rotate128"].tfhe_torch_blind_rotate128
        fn.argtypes = [vp] * 9 + [i] * 7 + [vp]
        fn.restype = i
        fn = libs["blind_rotate128"].tfhe_torch_blind_rotate128_smem_bytes
        fn.argtypes = [i] * 3
        fn.restype = i
        fn = libs["packing_keyswitch128"].tfhe_torch_packing_keyswitch128_imma
        fn.argtypes = [vp] * 5 + [i] * 8 + [vp]
        fn.restype = i
        fn = libs["packing_keyswitch128"].tfhe_torch_packing_keyswitch128_imma_smem
        fn.argtypes = [i] * 5
        fn.restype = i
        gk = libs["glwe_keyswitch"]
        gk.tfhe_torch_glwe_keyswitch.argtypes = [vp] * 6 + [i] * 8 + [vp]
        gk.tfhe_torch_glwe_keyswitch.restype = i
        gk.tfhe_torch_glwe_keyswitch_cluster.argtypes = [vp] * 6 + [i] * 7 + [vp]
        gk.tfhe_torch_glwe_keyswitch_cluster.restype = i
        gk.tfhe_torch_glwe_keyswitch_cluster_shape.argtypes = [i] * 5
        gk.tfhe_torch_glwe_keyswitch_cluster_shape.restype = i
        for fn in (gk.tfhe_torch_glwe_keyswitch_cluster_smem,
                   gk.tfhe_torch_glwe_keyswitch_cluster_occupancy):
            fn.argtypes = [i] * 3
            fn.restype = i
        fn = libs["blind_rotate_extended"].tfhe_torch_blind_rotate_extended
        fn.argtypes = [vp] * 6 + [i] * 8 + [vp]
        fn.restype = i
        fn = libs["blind_rotate_extended"].tfhe_torch_blind_rotate_extended_lazy
        fn.argtypes = [vp] * 6 + [i] * 8 + [vp]
        fn.restype = i
        for name, n_args in (("blind_rotate_extended_lazy_smem", 1),
                             ("blind_rotate_extended_lazy_clusters", 2),
                             ("blind_rotate_extended_clusters", 2)):
            fn = getattr(libs["blind_rotate_extended"], f"tfhe_torch_{name}")
            fn.argtypes = [i] * n_args
            fn.restype = i
        ps = libs["poly_shard"]
        ps.tfhe_torch_poly_shard_forward.argtypes = [vp] * 6 + [i] * 4 + [vp]
        ps.tfhe_torch_poly_shard_cross.argtypes = ([vp] * 7 + [i] * 5 + [ctypes.c_longlong, i]
                                                   + [vp])
        ps.tfhe_torch_poly_shard_inverse.argtypes = [vp] * 6 + [i] * 3 + [vp]
        ps.tfhe_torch_poly_shard_rotate.argtypes = [vp] * 9 + [i] * 7 + [vp]
        ps.tfhe_torch_poly_shard_rotate_plan.argtypes = [i] * 4 + [vp]
        for fn in (ps.tfhe_torch_poly_shard_forward, ps.tfhe_torch_poly_shard_cross,
                   ps.tfhe_torch_poly_shard_inverse, ps.tfhe_torch_poly_shard_rotate,
                   ps.tfhe_torch_poly_shard_rotate_plan):
            fn.restype = i
        for name, n_args in (("blind_rotate_cluster_occupancy", 3),
                             ("blind_rotate_cluster_smem", 3),
                             ("blind_rotate_cluster_min_blocks", 3),
                             ("cmux_cluster_occupancy", 3), ("cmux_cluster_smem", 3)):
            fn = getattr(libs["blind_rotate_cluster"], f"tfhe_torch_{name}")
            fn.argtypes = [i] * n_args
            fn.restype = i
        _Libs.loaded = libs
    return _Libs.loaded


def _stream(t: torch.Tensor):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(what)


def _check_cuda(*tensors_and_dtypes) -> None:
    dev = tensors_and_dtypes[0][0].device
    for t, dtype in tensors_and_dtypes:
        _require(t.device == dev, f"tensors on {t.device} and {dev}")
        _require(t.dtype == dtype, f"expected {dtype}, got {t.dtype}")
        _require(t.is_contiguous(), "kernel inputs must be contiguous")


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def pad_batch(t: torch.Tensor, multiple: int) -> torch.Tensor:
    """t (B, ...) contiguous with zero rows appended up to a multiple of
    ``multiple`` rows: the rounded-key kernels take C ciphertexts a block,
    and a batch that C does not divide runs its last block on zero rows,
    whose results are dropped."""
    extra = -t.shape[0] % multiple
    if not extra:
        return t.contiguous()
    return torch.cat([t, t.new_zeros((extra,) + tuple(t.shape[1:]))])


def rounded_kernel_shape(nprimes: int) -> dict:
    """The ciphertexts a block and the dynamic shared memory a block of
    the rounded-key kernels (K2 v7 and K3 v9 share them:
    csrc/ntt_common.cuh RK_C, rk_smem_bytes)."""
    lib = load()["blind_rotate"]
    return {"ciphertexts_per_block": lib.tfhe_torch_rounded_cts_per_block(),
            "shared_memory_bytes": lib.tfhe_torch_rounded_smem_bytes(nprimes)}


def _launch_rounded(name: str, acc, shifts, key: RoundedKeyNtt, base_log: int,
                    levels: int, *shape_args):
    """K2 (v7) or K3 (v9) on a rounded key: the initialised accumulator
    (B, k+1, N) int64 on the 2^32 grid and the int32 shifts (B, ...),
    padded to the kernel's C ciphertexts a block.  Returns the new
    accumulator (B, k+1, N)."""
    b, k1, n_poly = acc.shape
    _require(key.ggsw == (levels, k1, k1) and key.data.shape[2] == n_poly,
             f"key GGSWs {key.ggsw} of N = {key.data.shape[2]} do not fit the batch")
    _require(k1 == 2 and levels == 1 and n_poly == 2048 and base_log <= 30,
             f"the rounded-key kernels take k+1 = 2, one level, N = 2048 and "
             f"base_log <= 30, not k+1 = {k1}, l = {levels}, N = {n_poly}, "
             f"base_log = {base_log} (ROADMAP.md queue 3)")
    _require(key.num_primes in (3, 4) and key.dp.kernel_consts is not None,
             f"a rounded key of {key.num_primes} primes")
    lib = load()[name]
    per_block = rounded_kernel_shape(key.num_primes)["ciphertexts_per_block"]
    acc_p, shifts_p = pad_batch(acc, per_block), pad_batch(shifts, per_block)
    tw_fwd, tw_inv = shoup_twiddles(key.dp)
    _check_cuda((acc_p, torch.int64), (shifts_p, torch.int32), (key.data, torch.int32),
                (tw_fwd, torch.int32), (tw_inv, torch.int32),
                (key.dp.kernel_consts, torch.int64))
    err = getattr(lib, f"tfhe_torch_{name}_rounded")(
        acc_p.data_ptr(), shifts_p.data_ptr(), key.data.data_ptr(), tw_fwd.data_ptr(),
        tw_inv.data_ptr(), key.dp.kernel_consts.data_ptr(), acc_p.shape[0], *shape_args,
        k1, n_poly.bit_length() - 1, levels, key.num_primes, base_log, key.round_bits,
        _stream(acc))
    _raise_on(err, f"{name} (rounded key)")
    return acc_p[:b]


@dataclass(frozen=True, eq=False)
class KeyswitchKeyLimbs:
    """A keyswitch key as K1's tensor-core kernel reads it: ``words`` the
    (n_in, l, n_out+1) int64 key, ``limbs`` its byte layout
    (keyswitch_key_limbs) on the same card, ``word_bytes`` the limbs a key
    word: 8 for the u64 key (K1), 4 for the KS32 key's u32 words (K1-32).
    Built once by the key's owner (keyswitch_key; ServerKey.ks_key) and
    passed to every keyswitch."""

    words: torch.Tensor
    limbs: torch.Tensor
    word_bytes: int = 8


def keyswitch_key_limbs(ksk, levels: int, chunk: int, columns: int,
                        word_bytes: int = 8) -> torch.Tensor:
    """The byte layout of a keyswitch key for K1's tensor-core kernel:
    (n_in, l, m) int64 -> (chunks, cols, chunk) uint8 on ksk's device.
    Chunk c holds the l levels of input coefficients c chunk // l ..
    (c+1) chunk // l - 1 at byte positions (i - c chunk // l) l + lev (zero
    past them and past n_in); limb column word_bytes col + j holds byte j
    (little-endian) of key word col (zero columns up to a multiple of
    ``columns``): the 8 bytes of a u64 word, the low 4 of a KS32 key's u32
    word (held in an int64).  Each column's ``chunk`` bytes are contiguous:
    the K-major operand of the s8 x u8 tensor-core product.  The kernel's
    widths are csrc/keyswitch.cu IM_KC and IM_BN (keyswitch_key reads
    them)."""
    n_in, lev, m_out = ksk.shape
    _require(lev == levels, "ksk levels disagree")
    per = chunk // levels
    chunks = -(-n_in // per)
    cols = -(-word_bytes * m_out // columns) * columns
    full = torch.zeros((chunks * per, levels, cols), dtype=torch.uint8, device=ksk.device)
    full[:n_in, :, :word_bytes * m_out] = ksk.contiguous().view(torch.uint8).reshape(
        n_in, levels, m_out, 8)[..., :word_bytes].reshape(n_in, levels, -1)
    out = torch.zeros((chunks, cols, chunk), dtype=torch.uint8, device=ksk.device)
    out[:, :, :per * levels] = full.reshape(chunks, per * levels, cols).transpose(1, 2)
    return out


def keyswitch_imma_shape(n_in: int, levels: int, base_log: int) -> bool:
    """Whether K1 (and K1-32) runs its tensor-core kernel at this shape, as
    csrc/keyswitch.cu imma_shape decides it (s8 digits, a decomposition read
    from the high word, s32-exact limb sums): at the keyswitch of every set
    of shortint/params.py."""
    return keyswitch_route(n_in, levels, base_log) == "imma"


def keyswitch_limb_count(n_in: int, levels: int, base_log: int) -> int:
    """The balanced byte limbs T a digit of K1's limb-row kernel at this
    shape, as csrc/keyswitch.cu limb_shape decides it (digits wider than s8
    or shapes the tensor-core kernel refuses, base_log <= 31, l <= 8,
    s32-exact limb sums: the WoPBS PFPKS, T = 3, and the cast to the big
    key, T = 4); 0 where the kernel does not take the shape."""
    return load()["keyswitch"].tfhe_torch_keyswitch_limb_shape(n_in, levels, base_log)


def keyswitch_route(n_in: int, levels: int, base_log: int) -> str:
    """K1's kernel at a shape, from csrc/keyswitch.cu's predicates (asked
    once a shape): "imma" (the tensor-core kernel), "limbs" (the limb-row
    kernel) or "generic" (the test vectors' base 2^37)."""
    shape = (n_in, levels, base_log)
    if shape not in _K1_ROUTES:
        lib = load()["keyswitch"]
        _K1_ROUTES[shape] = ("imma" if lib.tfhe_torch_keyswitch_imma_shape(*shape)
                             else "limbs" if lib.tfhe_torch_keyswitch_limb_shape(*shape)
                             else "generic")
    return _K1_ROUTES[shape]


_K1_ROUTES = {}


def keyswitch_key(ksk, base_log: int, levels: int, bits: int = 64):
    """The keyswitch key as ``keyswitch`` (bits = 64) or ``keyswitch32``
    (bits = 32, a KS32 key of u32 words) takes it: on a CUDA device at a
    shape of K1's tensor-core kernel (or, for bits = 64, of its limb-row
    kernel), a KeyswitchKeyLimbs (its byte layout built here, on the card,
    8 or 4 limbs a word); else ksk itself."""
    if ksk.device.type != "cuda":
        return ksk
    route = keyswitch_route(ksk.shape[0], levels, base_log)
    if route != "imma" and (route != "limbs" or bits != 64):
        return ksk
    lib = load()["keyswitch"]
    word_bytes = bits // 8
    return KeyswitchKeyLimbs(ksk, keyswitch_key_limbs(ksk, levels,
                                                      lib.tfhe_torch_keyswitch_imma_chunk(),
                                                      lib.tfhe_torch_keyswitch_imma_columns(),
                                                      word_bytes), word_bytes)


# K1's tensor-core kernel: batch rows and limb columns a block
# (csrc/keyswitch.cu IM_BM, IM_BN)
IM_BM, IM_BN = 128, 256
# the fewest chunks a slice of the split contraction walks: the tensor-core
# kernel's, and the limb-row kernel's (its contractions are 9 chunks at the
# PFPKS and 16 at the cast)
K1_MIN_SLICE = 8
K1_LIMB_MIN_SLICE = 2


def keyswitch_splits(blocks: int, n_chunks: int, sms: int) -> int:
    """The slices K1's tensor-core kernel cuts its contraction into: a
    grid of ``blocks`` (column, row) blocks that fills less than half of the
    card's ``sms`` is cut so that it covers at least two waves (K1-32 at
    V1_4 KS32: 60 blocks, 5 slices), each slice at least K1_MIN_SLICE of
    the n_chunks chunks; else 1 (K1 at the 2_2 keyswitch: 116 blocks)."""
    if 2 * blocks >= sms:
        return 1
    return max(1, min(-(-2 * sms // blocks), n_chunks // K1_MIN_SLICE))


def keyswitch_limb_splits(blocks: int, n_chunks: int, sms: int) -> int:
    """The slices K1's limb-row kernel cuts its contraction into: as many
    as keep its grid of blocks x slices within one wave of the card's sms
    (one block an SM), each at least K1_LIMB_MIN_SLICE chunks: 2 at the
    PFPKS (64 column blocks, 9 chunks) and at the cast to big (65, 16).
    Timed in turns from CUDA graphs on the H100 (tools/phase_cycles.py k1g;
    NVIDIA H100 80GB HBM3, 700 W): at the PFPKS 0.0144-0.0147 ms at 2
    slices, 0.0183-0.0185 at 3-4 (two waves), 0.0201-0.0204 whole; at the
    cast 0.0199 at 2, 0.0236 at 5, 0.0316 whole."""
    return max(1, min(sms // blocks, n_chunks // K1_LIMB_MIN_SLICE))


def limb_rows(batch: int, limbs: int) -> int:
    """The rows of the limb-row kernel's byte scratch: IM_BM // T
    ciphertexts of T limb rows a row block (csrc/keyswitch.cu
    keyswitch_limb_rows_kernel)."""
    return -(-batch // (IM_BM // limbs)) * IM_BM


def sm_count(device) -> int:
    """The card's multiprocessors (asked once a device)."""
    index = torch.device(device).index or 0
    if index not in _SMS:
        _SMS[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _SMS[index]


_SMS = {}


@lru_cache(maxsize=None)
def _tile_plan(route: str, b: int, n_in: int, levels: int, base_log: int, n_chunks: int,
               key_cols: int, device_index: int) -> tuple:
    """(rows of the digit scratch, slices) of K1's tensor-core ("imma") or
    limb-row ("limbs") kernel at a batch and key layout, asked once."""
    sms = sm_count(torch.device("cuda", device_index))
    if route == "imma":
        rows = -(-b // IM_BM) * IM_BM
        return rows, keyswitch_splits(key_cols // IM_BN * (rows // IM_BM), n_chunks, sms)
    rows = limb_rows(b, keyswitch_limb_count(n_in, levels, base_log))
    return rows, keyswitch_limb_splits(key_cols // IM_BN * (rows // IM_BM), n_chunks, sms)


def _launch_keyswitch(ct, ksk, base_log: int, levels: int, word_bytes: int):
    """K1 (word_bytes 8) or K1-32 (word_bytes 4) on the card: the
    tensor-core kernel where keyswitch_route says "imma", for K1 the
    limb-row kernel where it says "limbs" (both on the key's byte layout of
    that width), else the generic kernel.  Returns (out, route)."""
    limbs = ksk.limbs if isinstance(ksk, KeyswitchKeyLimbs) else None
    words = ksk.words if limbs is not None else ksk
    name = "keyswitch" if word_bytes == 8 else "keyswitch32"
    _require(ct.device.type == "cuda", f"no {name} kernel for {ct.device}")
    ct, words = ct.contiguous(), words.contiguous()
    b, w = ct.shape
    n_in, lev, m_out = words.shape
    _require(w == n_in + 1 and lev == levels, "ct / ksk shapes disagree")
    _require(word_bytes == 8 or base_log <= 31,
             f"{name} takes base_log <= 31, not {base_log}")
    lib = load()["keyswitch"]
    route = keyswitch_route(n_in, levels, base_log)
    if route == "limbs" and word_bytes == 4:
        route = "generic"
    if route == "generic":
        _check_cuda((ct, torch.int64), (words, torch.int64))
        out = torch.empty((b, m_out), dtype=torch.int64, device=ct.device)
        err = getattr(lib, f"tfhe_torch_{name}")(
            out.data_ptr(), ct.data_ptr(), words.data_ptr(), b, n_in, levels, m_out,
            base_log, _stream(ct))
        _raise_on(err, name)
        return out, route
    _require(limbs is not None and ksk.word_bytes == word_bytes,
             f"{name}'s {'tensor-core' if route == 'imma' else 'limb-row'} kernel takes the "
             f"key's byte layout at {word_bytes} limbs a word: build it once with "
             f"kernels.keyswitch_key")
    _check_cuda((ct, torch.int64), (words, torch.int64), (limbs, torch.uint8))
    n_chunks, key_cols = limbs.shape[0], limbs.shape[1]
    rows, splits = _tile_plan(route, b, n_in, levels, base_log, n_chunks, key_cols,
                              ct.device.index or 0)
    # the slices of a split contraction add their words into zeros (the
    # limb-row kernel's digits kernel writes them)
    out = (torch.zeros if splits > 1 and route == "imma" else torch.empty)(
        (b, m_out), dtype=torch.int64, device=ct.device)
    # the digit (limb) tiles, decomposed once by the launch's first kernel
    digits = torch.empty((rows, n_chunks, limbs.shape[2]), dtype=torch.int8, device=ct.device)
    entry = f"tfhe_torch_{name}_imma" if route == "imma" else "tfhe_torch_keyswitch_limbs"
    err = getattr(lib, entry)(
        out.data_ptr(), ct.data_ptr(), limbs.data_ptr(), digits.data_ptr(), b, n_in,
        levels, m_out, base_log, n_chunks, key_cols, splits, _stream(ct))
    _raise_on(err, f"{name} ({'tensor cores' if route == 'imma' else 'limb rows'})")
    return out, route


def keyswitch(ct, ksk, base_log: int, levels: int):
    """K1: batched LWE keyswitch (see ops/server.py keyswitch).

    ct: (B, n_in+1) int64; ksk: the (n_in, l, n_out+1) int64 key or its
    KeyswitchKeyLimbs.  On the card the kernel is chosen by shape
    (keyswitch_route): the tensor-core kernel or the limb-row kernel, which
    take only a KeyswitchKeyLimbs, else the generic kernel."""
    if ct.device.type == "cpu":
        words = ksk.words if isinstance(ksk, KeyswitchKeyLimbs) else ksk
        return server.keyswitch(ct, words, base_log, levels)
    out, route = _launch_keyswitch(ct, ksk, base_log, levels, 8)
    keyswitch.imma_launches += route == "imma"
    keyswitch.limb_launches += route == "limbs"
    keyswitch.launches += 1
    return out


keyswitch.launches = 0
keyswitch.imma_launches = 0     # of them, K1's tensor-core kernel
keyswitch.limb_launches = 0     # and its limb-row kernel


def keyswitch32(ct, ksk32, base_log: int, levels: int):
    """K1-32: the KS32 pattern's keyswitch (see ops/server.py keyswitch32),
    a u64 LWE to a u32 LWE (int64 in [0, 2^32)).

    ct: (B, n_in+1) int64; ksk32: the (n_in, l, n_out+1) int64 key of u32
    words or its KeyswitchKeyLimbs at 4 limbs a word.  On the card the
    tensor-core kernel at keyswitch_imma_shape, else the generic kernel's
    u32 twin."""
    if ct.device.type == "cpu":
        words = ksk32.words if isinstance(ksk32, KeyswitchKeyLimbs) else ksk32
        return server.keyswitch32(ct, words, base_log, levels)
    out, route = _launch_keyswitch(ct, ksk32, base_log, levels, 4)
    keyswitch32.imma_launches += route == "imma"
    keyswitch32.launches += 1
    return out


keyswitch32.launches = 0
keyswitch32.imma_launches = 0   # of them, the tensor-core kernel


def exact_lazy_shape(k1: int, n_poly: int, levels: int, base_log: int) -> bool:
    """Which kernel K2's exact rotation (and its step entry) runs, by shape
    (csrc/blind_rotate.cu exact_lazy_shape): the lazy kernel at k+1 = 2,
    l = 1, N = 2048, 1 <= base_log <= 30 (the V1_4 2_2 shape, and every set
    of that shape); the generic kernel at every other shape the wrapper
    takes: the TEST sets (N = 512, 1024), 1_1's k+1 = 5, l > 1 (TFHE_LIB's
    N = 1024, l = 3)."""
    return bool(load()["blind_rotate"].tfhe_torch_blind_rotate_exact_lazy_shape(
        k1, n_poly.bit_length() - 1, levels, base_log))


def exact_cts_per_block() -> int:
    """The ciphertexts a block of K2's lazy exact kernel (csrc/blind_rotate.cu
    XC): the wrapper pads the batch to a multiple of it."""
    return load()["blind_rotate"].tfhe_torch_blind_rotate_exact_cts_per_block()


def exact_smem_bytes(k1: int, n_poly: int, levels: int, cluster: bool = False) -> int:
    """Dynamic shared memory of one block of K2's generic exact kernel (the
    (k+1, N) u64 accumulator and the 4-prime residue rows of l (k+1) digit
    polynomials: csrc/blind_rotate.cu tfhe_torch_blind_rotate_smem_bytes)
    or, where cluster, of one block of its cluster kernel at N = 2048 and
    8192 (a quarter of the accumulator and one prime's rows:
    csrc/blind_rotate_cluster.cu Cluster::SMEM; the small-N kernel's is
    cluster_figures')."""
    row = n_poly + n_poly // 32
    if cluster:
        return k1 * n_poly // KERNEL_PRIMES * 8 + levels * k1 * row * 4
    return k1 * n_poly * 8 + levels * k1 * KERNEL_PRIMES * row * 4


# K2's generic exact kernel (and its CMux entry's generic kernel, and K8's
# generic kernel) take k+1 <= 5 (csrc/ntt_common.cuh MAXK1)
GENERIC_MAX_K1 = 5


# The cluster kernel's shapes, the routing's one predicate (the kernel's
# entry point refuses others: csrc/blind_rotate_cluster.cu cluster_shape):
# k+1 = 2, l <= 2 at N = 8192 (3_3); 3 <= k+1 <= 8, l = 1 at N = 2048 (the
# common-mask rotation at the 2_2 widths, C <= 7); at N = 512 its small-N
# kernel (small_shape): k+1 = 2, l <= 4 (the TEST shapes: WoPBS's and AES's
# PBS at l = 1, vertical packing's CMux chain at l = 4; the only shapes
# that take a key a ciphertext, chain_shape) and 3 <= k+1 <= 5, l = 1 (1_1:
# k+1 = 5, base 2^23); base_log <= 30 and base_log l < 64
CLUSTER_SHAPES = ({"n_poly": 8192, "k1": (2, 2), "max_levels": 2, "max_base_log": 30},
                  {"n_poly": 2048, "k1": (3, 8), "max_levels": 1, "max_base_log": 30},
                  {"n_poly": 512, "k1": (2, 2), "max_levels": 4, "max_base_log": 30},
                  {"n_poly": 512, "k1": (3, 5), "max_levels": 1, "max_base_log": 30})
SMALL_N = 512


def cluster_shape(k1: int, n_poly: int, levels: int, base_log: int) -> bool:
    """Whether K2's cluster kernel takes the shape (CLUSTER_SHAPES)."""
    return base_log * levels < 64 and any(
        n_poly == cs["n_poly"] and cs["k1"][0] <= k1 <= cs["k1"][1]
        and 1 <= levels <= cs["max_levels"] and 1 <= base_log <= cs["max_base_log"]
        for cs in CLUSTER_SHAPES)


def small_shape(k1: int, n_poly: int, levels: int, base_log: int) -> bool:
    """Whether the cluster kernel's small-N kernel takes the shape (the
    N = 512 entries of CLUSTER_SHAPES: csrc/blind_rotate_cluster.cu
    small_shape)."""
    return n_poly == SMALL_N and cluster_shape(k1, n_poly, levels, base_log)


def chain_shape(k1: int, n_poly: int, levels: int, base_log: int) -> bool:
    """The small-N kernel's shapes at k+1 = 2 (l <= 4): the only shapes that
    take a key a ciphertext, so the only ones ``cmux_chain`` takes
    (csrc/blind_rotate_cluster.cu chain_shape)."""
    return k1 == 2 and small_shape(k1, n_poly, levels, base_log)


def exact_rotation_route(k1: int, n_poly: int, levels: int, base_log: int,
                         lazy: bool) -> str:
    """Which kernel K2's exact rotation (and its step entry) runs at a
    shape: "lazy" where exact_lazy_shape holds (``lazy``), else "cluster"
    where the cluster kernel takes the shape (CLUSTER_SHAPES: a cluster of
    four blocks a ciphertext, one a prime; 3_3, the common-mask rotation at
    N = 2048, where it is also the faster of the two at k+1 = 3 and 4,
    which the generic kernel's block also fits, and the TEST shapes and
    1_1's k+1 = 5 at N = 512, its small-N kernel, faster than the generic
    one there), else "generic"
    where k+1 <= GENERIC_MAX_K1 and the generic kernel's block fits shared
    memory.  Raises a ValueError elsewhere: no set of shortint/params.py is
    there, nor the common-mask rotation at the 2_2 widths for C <= 7, and
    above N = 8192 no 4-prime NTT plan exists (ops/ntt.py make_plan: the
    primes' 2-adic orders are 14, 15, 18 and 14)."""
    if lazy:
        return "lazy"
    if cluster_shape(k1, n_poly, levels, base_log):
        return "cluster"
    smem = exact_smem_bytes(k1, n_poly, levels)
    _require(k1 <= GENERIC_MAX_K1 and smem <= SMEM_LIMIT,
             f"K2's exact rotation at k+1 = {k1}, N = {n_poly}, l = {levels}, base_log = "
             f"{base_log}: its generic kernel takes k+1 <= {GENERIC_MAX_K1} within the "
             f"{SMEM_LIMIT} B of shared memory a block may use (this shape needs {smem} B), "
             f"and its cluster kernel takes k+1 = 2, N = 8192, l <= 2 and 3 <= k+1 <= 8, "
             f"N = 2048, l = 1, and k+1 = 2, N = 512, l <= 4 and 3 <= k+1 <= 5, N = 512, "
             f"l = 1, base_log <= 30; no 4-prime NTT plan exists above N = 8192")
    return "generic"


def cluster_figures(k1: int, n_poly: int, levels: int) -> dict:
    """A block of K2's cluster kernel at a shape it takes: its dynamic
    shared memory, the blocks an SM it is compiled for, and the clusters of
    four the card holds at once (cudaOccupancyMaxActiveClusters)."""
    lib = load()["blind_rotate_cluster"]
    log_n = n_poly.bit_length() - 1
    return {"shared_memory_bytes": lib.tfhe_torch_blind_rotate_cluster_smem(k1, log_n, levels),
            "blocks_per_sm": lib.tfhe_torch_blind_rotate_cluster_min_blocks(k1, log_n, levels),
            "active_clusters": lib.tfhe_torch_blind_rotate_cluster_occupancy(k1, log_n, levels)}


def _launch_blind_rotate(acc, mask32, bsk_ntt, dp: DevicePlan, base_log: int,
                         levels: int, entry: str, key_index=None) -> str:
    """K2's exact rotation on an initialised accumulator (B, k+1, N) int64,
    in place: one step per column of mask32 (B, n) int32, key (n, l, k+1,
    k+1, P, N), for the wrapper named entry ("blind_rotate", "cmux_step" or
    "cmux_chain"), which a failure names.  The kernel is chosen by shape
    (exact_rotation_route): the lazy kernel, on the batch padded to its C
    ciphertexts a block; the generic kernel; or the cluster kernel.  With
    key_index, (B,) int32 on the card, bsk_ntt holds G keys (G, n, l, ...),
    each contiguous, and ciphertext b runs on key key_index[b]: the cluster
    kernel's small-N shapes at k+1 = 2 only (chain_shape).  Returns the
    route taken."""
    b, n_steps = mask32.shape
    k1, n_poly = acc.shape[1], acc.shape[2]
    nprimes = dp.num_primes
    key_shape = bsk_ntt.shape if key_index is None else bsk_ntt.shape[1:]
    _require(key_shape == (n_steps, levels, k1, k1, nprimes, n_poly),
             f"key shape {tuple(bsk_ntt.shape)} does not fit the batch")
    _require(nprimes == KERNEL_PRIMES and n_poly & (n_poly - 1) == 0,
             "the kernel takes a 4-prime plan and a power-of-two N")
    _require(dp.kernel_consts.numel() == KERNEL_CONSTS_LEN, "bad plan table")
    lib = load()["blind_rotate"]
    route = exact_rotation_route(k1, n_poly, levels, base_log,
                                 exact_lazy_shape(k1, n_poly, levels, base_log))
    log_n = n_poly.bit_length() - 1
    _require(key_index is None or (route == "cluster" and chain_shape(k1, n_poly, levels,
                                                                      base_log)),
             f"a key a ciphertext runs on the cluster kernel's small-N kernel only (k+1 = 2, "
             f"N = {SMALL_N}, l <= 4, base_log <= 30, base_log l < 64); k+1 = {k1}, N = "
             f"{n_poly}, l = {levels}, base_log = {base_log}")
    if route == "generic":
        _check_cuda((acc, torch.int64), (mask32, torch.int32),
                    (bsk_ntt, torch.int32), (dp.psi32, torch.int32),
                    (dp.psi_inv32, torch.int32), (dp.kernel_consts, torch.int64))
        err = lib.tfhe_torch_blind_rotate(
            acc.data_ptr(), mask32.data_ptr(), bsk_ntt.data_ptr(),
            dp.psi32.data_ptr(), dp.psi_inv32.data_ptr(),
            dp.kernel_consts.data_ptr(), b, n_steps, k1, log_n, levels, nprimes, base_log,
            _stream(acc))
        _raise_on(err, entry)
        return route
    # the lazy and the cluster kernel: Shoup twiddles, the key in 16-byte loads
    per_block = exact_cts_per_block() if route == "lazy" else 1
    acc_p, mask_p = pad_batch(acc, per_block), pad_batch(mask32, per_block)
    tw_fwd, tw_inv = shoup_twiddles(dp)
    # with key_index, keys 16 bytes apart, each contiguous (a view along G)
    _check_cuda((acc_p, torch.int64), (mask_p, torch.int32),
                (bsk_ntt if key_index is None else bsk_ntt[:1], torch.int32),
                (tw_fwd, torch.int32), (tw_inv, torch.int32),
                (dp.kernel_consts, torch.int64),
                *(() if key_index is None else ((key_index, torch.int32),)))
    _require(bsk_ntt.data_ptr() % 16 == 0 and (key_index is None or bsk_ntt.stride(0) % 4 == 0),
             "the key must be 16-byte aligned")
    shape_args = (acc_p.shape[0], n_steps, k1, log_n, levels, nprimes, base_log, _stream(acc))
    if route == "lazy":
        err = lib.tfhe_torch_blind_rotate_exact_lazy(
            acc_p.data_ptr(), mask_p.data_ptr(), bsk_ntt.data_ptr(), tw_fwd.data_ptr(),
            tw_inv.data_ptr(), dp.kernel_consts.data_ptr(), *shape_args)
    else:
        set_words = bsk_ntt.stride(0) if key_index is not None and bsk_ntt.shape[0] > 1 else 0
        err = load()["blind_rotate_cluster"].tfhe_torch_blind_rotate_cluster(
            acc_p.data_ptr(), mask_p.data_ptr(), bsk_ntt.data_ptr(),
            None if key_index is None else key_index.data_ptr(), set_words, tw_fwd.data_ptr(),
            tw_inv.data_ptr(), dp.kernel_consts.data_ptr(), *shape_args)
    _raise_on(err, f"{entry} ({route} exact)")
    if acc_p.data_ptr() != acc.data_ptr():
        acc.copy_(acc_p[:b])
    return route


def blind_rotate(msed_mask, msed_body, lut, bsk_ntt, dp: DevicePlan,
                 base_log: int, levels: int, trunc_acc: bool = False):
    """K2: batched classic blind rotation (see ops/server.py blind_rotate).

    msed_mask: (B, n) in [0, 2N); msed_body: (B,); lut: (B, k+1, N) int64;
    bsk_ntt: (n, l, k+1, k+1, P, N) int32 Montgomery NTT-domain key (on
    dp's four primes), or a RoundedKeyNtt, which runs v7 mode only
    (trunc_acc) on its own plan, in the rounded-key kernel.  On the card
    v7 mode takes only a RoundedKeyNtt; on the CPU the plain version also
    takes a four-prime key (the reference the rounded route is held to)."""
    rounded = isinstance(bsk_ntt, RoundedKeyNtt)
    _require(trunc_acc or not rounded,
             "a rounded key runs only v7 mode (trunc_acc): exact mode takes the exact key")
    if msed_mask.device.type == "cpu":
        return server.blind_rotate(msed_mask, msed_body, lut, bsk_ntt, dp,
                                   base_log, levels, trunc_acc)
    _require(rounded or not trunc_acc,
             "v7 mode on the card takes a rounded key (ops/bsk_prep.py RoundedKeyNtt)")
    _require(msed_mask.device.type == "cuda",
             f"no blind-rotation kernel for {msed_mask.device}")
    acc = server.initial_accumulator(lut, msed_body, trunc_acc).contiguous()
    if not rounded:
        return _rotate_exact(acc, msed_mask, bsk_ntt, dp, base_log, levels)
    mask32 = msed_mask.to(torch.int32).contiguous()
    _require(bsk_ntt.lead == (mask32.shape[1],),
             f"key of {bsk_ntt.lead} GGSWs for {mask32.shape[1]} steps")
    acc = _launch_rounded("blind_rotate", acc, mask32, bsk_ntt, base_log, levels,
                          mask32.shape[1])
    blind_rotate.launches += 1
    return acc


def _rotate_exact(acc, msed_mask, bsk_ntt, dp: DevicePlan, base_log: int, levels: int):
    """K2's exact rotation of the contiguous CUDA accumulator acc, in place,
    counted as blind_rotate's launches (and its lazy or cluster kernel's)."""
    route = _launch_blind_rotate(acc, msed_mask.to(torch.int32).contiguous(),
                                 bsk_ntt.contiguous(), dp, base_log, levels, "blind_rotate")
    blind_rotate.lazy_exact_launches += route == "lazy"
    blind_rotate.cluster_launches += route == "cluster"
    blind_rotate.launches += 1
    return acc


blind_rotate.launches = 0
blind_rotate.lazy_exact_launches = 0    # of them, K2's lazy exact kernel
blind_rotate.cluster_launches = 0       # and its cluster kernel (3_3, CM rotation, N = 512)


def rotate_accumulator(acc, msed_mask, bsk_ntt, dp: DevicePlan, base_log: int, levels: int):
    """K2's exact rotation of a given initialised accumulator (see
    ops/server.py rotate_accumulator): the common-mask blind rotation's
    entry (core/cm.py cm_blind_rotate), at k+1 = k + C.  The kernel is
    chosen by shape as ``blind_rotate``'s exact mode chooses it
    (exact_rotation_route: at the 2_2 widths the lazy kernel at C = 1, the
    cluster kernel at C = 2 .. 7), and its launches count as
    blind_rotate's.

    acc: (B, k+1, N) int64; msed_mask: (B, n) in [0, 2N); bsk_ntt: (n, l,
    k+1, k+1, P, N) int32 Montgomery NTT domain.  Returns the final
    accumulator (a new tensor)."""
    _require(not isinstance(bsk_ntt, RoundedKeyNtt),
             "the accumulator entry runs the exact rotation on the exact key")
    if acc.device.type == "cpu":
        return server.rotate_accumulator(acc, msed_mask, bsk_ntt, dp, base_log, levels)
    _require(acc.device.type == "cuda", f"no blind-rotation kernel for {acc.device}")
    return _rotate_exact(acc.clone(memory_format=torch.contiguous_format), msed_mask, bsk_ntt,
                         dp, base_log, levels)


def cmux_step(acc, a_col, bsk_slice, dp: DevicePlan, base_log: int, levels: int):
    """K2's single-step entry: one exact CMux step acc + GGSW (x)
    (acc * X^a - acc) on an initialised accumulator, for the whole batch
    (see ops/server.py cmux_step; the function of tfhe_tpu's
    build_cmux_step Pallas kernel).  K2 launched with n_steps = 1, in
    place on a CUDA accumulator.

    acc: (B, k+1, N) int64; a_col: (B,) in [0, 2N); bsk_slice:
    (l, k+1, k+1, P, N) int32 Montgomery NTT domain.  Returns the new
    accumulator."""
    _require(not isinstance(bsk_slice, RoundedKeyNtt),
             "the single-step entry runs the exact rotation on the exact key")
    if acc.device.type == "cpu":
        return server.cmux_step(acc, a_col, bsk_slice, dp, base_log, levels)
    _require(acc.device.type == "cuda", f"no blind-rotation kernel for {acc.device}")
    _require(acc.is_contiguous(), "the accumulator must be contiguous (updated in place)")
    route = _launch_blind_rotate(acc, a_col.to(torch.int32).reshape(-1, 1).contiguous(),
                                 bsk_slice.contiguous()[None], dp, base_log, levels,
                                 "cmux_step")
    cmux_step.lazy_exact_launches += route == "lazy"
    cmux_step.launches += 1
    return acc


cmux_step.launches = 0
cmux_step.lazy_exact_launches = 0       # of them, K2's lazy exact kernel


def cmux_chain(acc, a_cols, ggsws, key_index, dp: DevicePlan, base_log: int, levels: int):
    """K2's CMux chain: s exact CMux steps for a batch of B accumulators in
    one launch, each on its own GGSW set (see ops/server.py cmux_chain;
    vertical packing's low-bit rotations, tfhe_tpu/shortint/wopbs.py
    vertical_packing, one _cmux a bit there).  Step i: acc_b += GGSW[
    key_index[b], i] (x) (acc_b X^{a_cols[b, i]} - acc_b).  Runs the
    cluster kernel's small-N kernel (csrc/blind_rotate_cluster.cu
    tfhe_torch_blind_rotate_cluster with a key_index), each cluster at its
    set's offset in ggsws: no key is gathered or copied; raises at any
    shape it does not take (chain_shape: k+1 = 2, N = 512, l <= 4).

    acc: (B, k+1, N) int64; a_cols: (B, s) in [0, 2N); ggsws: (G, s, l,
    k+1, k+1, P, N) int32 Montgomery NTT domain on dp's four primes, each
    set contiguous (a view along G, such as ggsws[:, t:] of a contiguous
    tensor, is taken as it is); key_index: (B,) int tensor in [0, G)
    (checked where it lies on the CPU).  Returns the final accumulator (a
    new tensor)."""
    _require(not isinstance(ggsws, RoundedKeyNtt), "the CMux chain takes exact GGSWs")
    if acc.device.type == "cpu":
        return server.cmux_chain(acc, a_cols, ggsws, key_index, dp, base_log, levels)
    _require(acc.device.type == "cuda", f"no CMux chain kernel for {acc.device}")
    b, k1, n_poly = acc.shape
    g, s = ggsws.shape[:2]
    _require(a_cols.shape == (b, s) and tuple(key_index.shape) == (b,),
             f"a_cols {tuple(a_cols.shape)} / key_index {tuple(key_index.shape)} do not fit "
             f"{b} accumulators and {s} steps")
    _require(ggsws.device == acc.device,
             f"expected GGSW sets on {acc.device}, got them on {ggsws.device}")
    if key_index.device.type == "cpu":
        _require(0 <= int(key_index.min()) and int(key_index.max()) < g,
                 f"key_index outside the {g} GGSW sets")
    acc = acc.clone(memory_format=torch.contiguous_format)
    # a host key_index goes up without the stream synchronisation of a
    # blocking copy, which would wait for every launch queued before it
    index = key_index.to(dtype=torch.int32).to(acc.device, non_blocking=True).contiguous()
    _launch_blind_rotate(acc, a_cols.to(torch.int32).contiguous(), ggsws, dp, base_log, levels,
                         "cmux_chain", index)
    cmux_chain.launches += 1
    return acc


cmux_chain.launches = 0


@lru_cache(maxsize=None)
def cmux_route(k1: int, n_poly: int, levels: int, base_log: int) -> str:
    """Which kernel K2's CMux entry runs at a shape: "small", the cluster
    kernel's small-N kernel in its one-step CMux mode, at its shapes
    (small_shape: N = 512, k+1 = 2, l <= 4, WoPBS's tree; 3 <= k+1 <= 5,
    l = 1); "cluster", the N = 2048 cluster kernel in that mode, at its
    shapes there (3 <= k+1 <= 8, l = 1: the common-mask CMux and external
    product at C <= 7 on the 2_2 widths); both are CLUSTER_SHAPES' entries
    below N = 8192 (csrc/blind_rotate_cluster.cu cmux_shape).  Else
    "generic", the generic exact kernel's external product (cmux_kernel),
    where k+1 <= GENERIC_MAX_K1 and its block fits shared memory; a
    ValueError elsewhere."""
    if cluster_shape(k1, n_poly, levels, base_log) and n_poly < 8192:
        return "small" if n_poly == SMALL_N else "cluster"
    smem = exact_smem_bytes(k1, n_poly, levels)
    _require(k1 <= GENERIC_MAX_K1 and smem <= SMEM_LIMIT,
             f"K2's CMux entry at k+1 = {k1}, N = {n_poly}, l = {levels}, base_log = "
             f"{base_log}: its generic kernel takes k+1 <= {GENERIC_MAX_K1} within the "
             f"{SMEM_LIMIT} B of shared memory a block may use (this shape needs {smem} B), "
             f"and its cluster kernels take 3 <= k+1 <= 8, N = 2048, l = 1 and k+1 = 2, "
             f"N = {SMALL_N}, l <= 4 and 3 <= k+1 <= 5, N = {SMALL_N}, l = 1, base_log <= 30")
    return "generic"


def cmux_figures(k1: int, n_poly: int, levels: int) -> dict:
    """A block of the cluster kernels' CMux mode at a shape its routes take:
    its dynamic shared memory and the clusters of four the card holds at
    once (cudaOccupancyMaxActiveClusters)."""
    lib = load()["blind_rotate_cluster"]
    log_n = n_poly.bit_length() - 1
    return {"shared_memory_bytes": lib.tfhe_torch_cmux_cluster_smem(k1, log_n, levels),
            "active_clusters": lib.tfhe_torch_cmux_cluster_occupancy(k1, log_n, levels)}


def cmux(ct0, ct1, ggsw, dp: DevicePlan, base_log: int, levels: int):
    """K2's CMux entry: ct0 + GGSW (x) (ct1 - ct0) for a batch sharing one
    GGSW (see ops/server.py cmux; the CMux tree of vertical packing, the
    common mask's CMux and external product).

    ct0, ct1: (B, k+1, N) int64; ggsw: (l, k+1, k+1, P, N) int32 Montgomery
    NTT domain on dp's four primes.  The kernel is chosen by shape
    (cmux_route): one step of the cluster kernels in their CMux mode, four
    blocks a ciphertext, one a prime ("small", "cluster"), else the generic
    exact kernel's external product, one block a ciphertext; a ValueError
    where none takes the shape.  One launch, nothing else on the card.
    Returns the new (B, k+1, N) int64."""
    _require(not isinstance(ggsw, RoundedKeyNtt), "the CMux entry takes an exact GGSW")
    if ct0.device.type == "cpu":
        return server.cmux(ct0, ct1, ggsw, dp, base_log, levels)
    _require(ct0.device.type == "cuda", f"no CMux kernel for {ct0.device}")
    ct0, ct1, ggsw = ct0.contiguous(), ct1.contiguous(), ggsw.contiguous()
    b, k1, n_poly = ct0.shape
    _require(ct1.shape == ct0.shape, "ct0 / ct1 shapes disagree")
    _require(ggsw.shape == (levels, k1, k1, dp.num_primes, n_poly),
             f"GGSW shape {tuple(ggsw.shape)} does not fit the batch")
    _require(dp.num_primes == KERNEL_PRIMES and n_poly & (n_poly - 1) == 0,
             "the kernel takes a 4-prime plan and a power-of-two N")
    route = cmux_route(k1, n_poly, levels, base_log)
    out = torch.empty_like(ct0)
    shape_args = (b, k1, n_poly.bit_length() - 1, levels, dp.num_primes, base_log, _stream(ct0))
    if route == "generic":
        _check_cuda((ct0, torch.int64), (ct1, torch.int64), (ggsw, torch.int32),
                    (dp.psi32, torch.int32), (dp.psi_inv32, torch.int32),
                    (dp.kernel_consts, torch.int64))
        err = load()["blind_rotate"].tfhe_torch_cmux(
            out.data_ptr(), ct0.data_ptr(), ct1.data_ptr(), ggsw.data_ptr(), dp.psi32.data_ptr(),
            dp.psi_inv32.data_ptr(), dp.kernel_consts.data_ptr(), *shape_args)
    else:
        # the plan's tables (its twiddles, its constants) are the port's own,
        # made on the plan's device: only where they lie is checked
        tw_fwd, tw_inv = shoup_twiddles(dp)
        _check_cuda((ct0, torch.int64), (ct1, torch.int64), (ggsw, torch.int32))
        _require(dp.kernel_consts.device == ct0.device,
                 f"the plan lies on {dp.kernel_consts.device}, the operands on {ct0.device}")
        _require(ggsw.data_ptr() % 16 == 0, "the GGSW must be 16-byte aligned")
        err = load()["blind_rotate_cluster"].tfhe_torch_cmux_cluster(
            out.data_ptr(), ct0.data_ptr(), ct1.data_ptr(), ggsw.data_ptr(), tw_fwd.data_ptr(),
            tw_inv.data_ptr(), dp.kernel_consts.data_ptr(), *shape_args)
    _raise_on(err, f"cmux ({route})")
    cmux.small_launches += route == "small"
    cmux.cluster_launches += route == "cluster"
    cmux.launches += 1
    return out


cmux.launches = 0
cmux.small_launches = 0         # of them, the small-N cluster kernel's CMux mode
cmux.cluster_launches = 0       # and the N = 2048 cluster kernel's


def exact_multibit_cts_per_block(k1: int, n_poly: int, levels: int, grouping: int,
                                 base_log: int) -> int:
    """The ciphertexts a block of K3's exact kernel at this shape (its lazy
    kernel's C at GROUP_4 and GROUP_2 2_2-like shapes, else 1:
    csrc/blind_rotate_multibit.cu lazy_exact_shape); the wrapper pads the
    batch to a multiple of it."""
    return load()["blind_rotate_multibit"].tfhe_torch_blind_rotate_multibit_cts_per_block(
        k1, n_poly.bit_length() - 1, levels, grouping, base_log)


# K3's exact kernels by shape, the routing's one predicate (each entry point
# refuses what its kernel does not take): the lazy kernel at k+1 = 2, l = 1,
# N = 2048, g = 2 or 4, base_log <= 30 (csrc/blind_rotate_multibit.cu
# lazy_exact_shape: GROUP_4 and tfhe_tpu's GROUP_2 at the 2_2 widths); the
# cluster kernel at k+1 = 2, base_log l <= 30 and these (N, l, g): the GPU
# multi-bit GROUP_2 and GROUP_3 sets (csrc/blind_rotate_multibit_cluster.cu
# mb_cluster_shape); the generic kernel elsewhere
MULTIBIT_LAZY_SHAPE = {"k1": 2, "n_poly": 2048, "levels": 1, "groupings": (2, 4),
                       "max_base_log": 30}
MULTIBIT_CLUSTER_SHAPES = ({"n_poly": 4096, "levels": 1, "grouping": 2},
                           {"n_poly": 2048, "levels": 2, "grouping": 3})


def multibit_cluster_shape(k1: int, n_poly: int, levels: int, grouping: int,
                           base_log: int) -> bool:
    """Whether K3's cluster kernel takes the shape (MULTIBIT_CLUSTER_SHAPES)."""
    return k1 == 2 and base_log >= 1 and base_log * levels <= 30 and any(
        (n_poly, levels, grouping) == (cs["n_poly"], cs["levels"], cs["grouping"])
        for cs in MULTIBIT_CLUSTER_SHAPES)


def multibit_exact_route(k1: int, n_poly: int, levels: int, grouping: int,
                         base_log: int) -> str:
    """Which kernel K3's exact rotation runs at a shape: "lazy" at
    MULTIBIT_LAZY_SHAPE (two ciphertexts a block), else "cluster" where
    multibit_cluster_shape holds (a cluster of four blocks a ciphertext,
    one a CRT prime: the GPU multi-bit GROUP_2 at N = 4096 and GROUP_3 at
    l = 2, g = 3), else "generic" where the generic kernel's block (the (k+1,
    N) u64 accumulator and the 4-prime residues of l (k+1) digit rows) fits
    shared memory and k+1 <= GENERIC_MAX_K1.  Raises a ValueError
    elsewhere."""
    ls = MULTIBIT_LAZY_SHAPE
    if (k1 == ls["k1"] and n_poly == ls["n_poly"] and levels == ls["levels"]
            and grouping in ls["groupings"] and 1 <= base_log <= ls["max_base_log"]):
        return "lazy"
    if multibit_cluster_shape(k1, n_poly, levels, grouping, base_log):
        return "cluster"
    smem = exact_smem_bytes(k1, n_poly, levels)
    _require(k1 <= GENERIC_MAX_K1 and smem <= SMEM_LIMIT,
             f"multi-bit blind rotation with k+1 = {k1}, N = {n_poly}, "
             f"l = {levels} needs {smem} B of shared memory, above the "
             f"{SMEM_LIMIT} B a block may use (ROADMAP.md queue 3), or k+1 > "
             f"{GENERIC_MAX_K1}; the cluster kernel takes k+1 = 2, base_log l <= 30 at "
             f"(N, l, g) = (4096, 1, 2) and (2048, 2, 3)")
    return "generic"


def multibit_cluster_figures(n_poly: int, levels: int, grouping: int) -> dict:
    """A block of K3's cluster kernel at a shape it takes: its dynamic
    shared memory and the clusters of four the card holds at once
    (cudaOccupancyMaxActiveClusters); it is compiled for two blocks an
    SM."""
    lib = load()["blind_rotate_multibit_cluster"]
    log_n = n_poly.bit_length() - 1
    return {"shared_memory_bytes":
                lib.tfhe_torch_blind_rotate_multibit_cluster_smem(log_n, levels, grouping),
            "blocks_per_sm": 2,
            "active_clusters":
                lib.tfhe_torch_blind_rotate_multibit_cluster_occupancy(log_n, levels, grouping)}


def blind_rotate_multibit(degrees, msed_body, lut, mb_key_ntt, dp: DevicePlan,
                          base_log: int, levels: int, v9: bool = False):
    """K3: batched multi-bit blind rotation, in v9 mode (monomials on the
    data side, 2^32-grid accumulator, rounded key: ops/server.py
    blind_rotate_multibit_v9) or in exact mode (the key-bundle form:
    blind_rotate_multibit).

    degrees: (B, n/g, 2^g) in [0, 2N); msed_body: (B,); lut: (B, k+1, N)
    int64; mb_key_ntt: (n/g, 2^g, l, k+1, k+1, P, N) int32 Montgomery NTT
    domain (on dp's four primes), or a RoundedKeyNtt, which runs v9 mode
    only, on its own plan, in the rounded-key kernel.  On the card v9 mode
    takes only a RoundedKeyNtt; on the CPU the plain version also takes a
    four-prime key (the reference the rounded route is held to).  Exact
    mode takes the kernel multibit_exact_route names."""
    rounded = isinstance(mb_key_ntt, RoundedKeyNtt)
    _require(v9 or not rounded,
             "a rounded key runs only v9 mode: exact mode takes the exact key")
    if degrees.device.type == "cpu":
        plain = (server.blind_rotate_multibit_v9 if v9
                 else server.blind_rotate_multibit)
        return plain(degrees, msed_body, lut, mb_key_ntt, dp, base_log, levels)
    _require(rounded or not v9,
             "v9 mode on the card takes a rounded key (ops/bsk_prep.py RoundedKeyNtt)")
    _require(degrees.device.type == "cuda",
             f"no multi-bit blind-rotation kernel for {degrees.device}")
    b, n_groups, n_sub = degrees.shape
    k1, n_poly = lut.shape[1], lut.shape[2]
    nprimes = dp.num_primes
    grouping = n_sub.bit_length() - 1
    _require(n_sub == 1 << grouping and 1 <= grouping <= 4,
             f"{n_sub} patterns a group: the kernel takes grouping 1 to 4")
    if rounded:
        _require(mb_key_ntt.lead == (n_groups, n_sub),
                 f"key of {mb_key_ntt.lead} GGSWs for {n_groups} groups of {n_sub}")
        acc = server.initial_accumulator(lut, msed_body, True).contiguous()
        acc = _launch_rounded("blind_rotate_multibit", acc,
                              degrees.to(torch.int32).contiguous(), mb_key_ntt,
                              base_log, levels, n_groups, grouping)
        blind_rotate_multibit.launches += 1
        return acc
    _require(mb_key_ntt.shape == (n_groups, n_sub, levels, k1, k1, nprimes, n_poly),
             f"key shape {tuple(mb_key_ntt.shape)} does not fit the batch")
    _require(nprimes == KERNEL_PRIMES and n_poly & (n_poly - 1) == 0,
             "the kernel takes a 4-prime plan and a power-of-two N")
    _require(dp.kernel_consts.numel() == KERNEL_CONSTS_LEN, "bad plan table")
    route = multibit_exact_route(k1, n_poly, levels, grouping, base_log)
    log_n = n_poly.bit_length() - 1
    mono = server.monomial_table(dp)[0]
    tw_fwd, tw_inv = shoup_twiddles(dp)
    if route == "cluster":
        acc = server.initial_accumulator(lut, msed_body, False).contiguous()
        deg32 = degrees.to(torch.int32).contiguous()
        mb_key_ntt = mb_key_ntt.contiguous()
        _check_cuda((acc, torch.int64), (deg32, torch.int32), (mb_key_ntt, torch.int32),
                    (tw_fwd, torch.int32), (tw_inv, torch.int32), (mono, torch.int32),
                    (dp.kernel_consts, torch.int64))
        _require(mb_key_ntt.data_ptr() % 16 == 0, "the key must be 16-byte aligned")
        err = load()["blind_rotate_multibit_cluster"].tfhe_torch_blind_rotate_multibit_cluster(
            acc.data_ptr(), deg32.data_ptr(), mb_key_ntt.data_ptr(), tw_fwd.data_ptr(),
            tw_inv.data_ptr(), mono.data_ptr(), dp.kernel_consts.data_ptr(), b, n_groups,
            grouping, k1, log_n, levels, nprimes, base_log, _stream(acc))
        _raise_on(err, "blind_rotate_multibit (cluster exact)")
        blind_rotate_multibit.cluster_launches += 1
        blind_rotate_multibit.launches += 1
        return acc
    lib = load()["blind_rotate_multibit"]
    per_block = exact_multibit_cts_per_block(k1, n_poly, levels, grouping, base_log)
    acc = pad_batch(server.initial_accumulator(lut, msed_body, False), per_block)
    deg32 = pad_batch(degrees.to(torch.int32), per_block)
    mb_key_ntt = mb_key_ntt.contiguous()
    _check_cuda((acc, torch.int64), (deg32, torch.int32),
                (mb_key_ntt, torch.int32), (dp.psi32, torch.int32),
                (dp.psi_inv32, torch.int32), (tw_fwd, torch.int32), (tw_inv, torch.int32),
                (mono, torch.int32), (dp.kernel_consts, torch.int64))
    err = lib.tfhe_torch_blind_rotate_multibit(
        acc.data_ptr(), deg32.data_ptr(), mb_key_ntt.data_ptr(),
        dp.psi32.data_ptr(), dp.psi_inv32.data_ptr(), tw_fwd.data_ptr(), tw_inv.data_ptr(),
        mono.data_ptr(), dp.kernel_consts.data_ptr(), acc.shape[0], n_groups, grouping, k1,
        log_n, levels, nprimes, base_log, _stream(acc))
    _raise_on(err, "blind_rotate_multibit")
    blind_rotate_multibit.launches += 1
    return acc[:b]


blind_rotate_multibit.launches = 0
blind_rotate_multibit.cluster_launches = 0   # of them, its cluster kernel (GPU GROUP_2, GROUP_3)


@dataclass(frozen=True, eq=False)
class PackingKeyswitchKeyLimbs:
    """A packing keyswitch key as K4's tensor-core kernel reads it: ``words``
    the (n_in, l, k+1, N) int64 key, ``limbs`` its byte layout
    (packing_keyswitch_key_limbs) on the same card.  Built once by the key's
    owner (packing_keyswitch_key; CompressionKey.pks_key) and passed to
    every packing keyswitch."""

    words: torch.Tensor
    limbs: torch.Tensor


def packing_keyswitch_key_limbs(pksk) -> torch.Tensor:
    """The byte layout of a packing keyswitch key for K4's tensor-core
    kernel: (n_in, l, k+1, N) int64 -> (n_in, l, k+1, 8, N) uint8 on pksk's
    device, [i, lev, c, b, m] = byte b (little-endian) of key word m of
    polynomial c of row (i, lev).  Each limb column's N bytes of a row are
    contiguous: the K-major operand of the s8 x u8 tensor-core product, a
    row (i, lev) one contiguous tile of 8 (k+1) N bytes."""
    n_in, levels, k1, n_poly = pksk.shape
    return (pksk.contiguous().view(torch.uint8).reshape(n_in, levels, k1, n_poly, 8)
            .transpose(-1, -2).contiguous())


def packing_keyswitch_imma_shape(n_in: int, levels: int, k1: int, n_poly: int,
                                 base_log: int) -> bool:
    """Whether K4 runs its tensor-core kernel at this shape, as
    csrc/packing_keyswitch.cu pk_imma_shape decides it (N = 256, k+1 <= 5,
    s8 digits read from the high word, s32-exact limb sums): the V1_4
    compression set's packing keyswitch and TEST_COMP_PARAM's; other
    shapes run the generic kernel."""
    return bool(load()["packing_keyswitch"].tfhe_torch_packing_keyswitch_imma_shape(
        n_in, levels, k1, n_poly.bit_length() - 1, base_log))


def packing_keyswitch_key(pksk, base_log: int, levels: int):
    """The packing keyswitch key as ``packing_keyswitch`` takes it: on a
    CUDA device at a shape of K4's tensor-core kernel, a
    PackingKeyswitchKeyLimbs (its byte layout built here, on the card);
    else pksk itself."""
    n_in, lev, k1, n_poly = pksk.shape
    if pksk.device.type != "cuda" or not packing_keyswitch_imma_shape(n_in, lev, k1, n_poly,
                                                                      base_log):
        return pksk
    _require(lev == levels, "pksk levels disagree")
    return PackingKeyswitchKeyLimbs(pksk, packing_keyswitch_key_limbs(pksk))


def packing_keyswitch(lwes, pksk, base_log: int, levels: int, lwe_per_glwe: int):
    """K4: pack each run of lwe_per_glwe LWEs into one GLWE, all runs in one
    launch (see ops/server.py packing_keyswitch).

    lwes: (B, n+1) int64; pksk: the (n, l, k+1, N) int64 standard-domain
    key or its PackingKeyswitchKeyLimbs.  On the card the kernel is chosen
    by shape (packing_keyswitch_imma_shape): the tensor-core kernel, which
    takes only a PackingKeyswitchKeyLimbs, else the generic kernel.
    Returns (ceil(B / lwe_per_glwe), k+1, N) int64."""
    limbs = pksk.limbs if isinstance(pksk, PackingKeyswitchKeyLimbs) else None
    words = pksk.words if limbs is not None else pksk
    if lwes.device.type == "cpu":
        return server.packing_keyswitch(lwes, words, base_log, levels, lwe_per_glwe)
    _require(lwes.device.type == "cuda", f"no packing-keyswitch kernel for {lwes.device}")
    lwes, words = lwes.contiguous(), words.contiguous()
    _check_cuda((lwes, torch.int64), (words, torch.int64))
    b, w = lwes.shape
    n_in, lev, k1, n_poly = words.shape
    _require(w == n_in + 1 and lev == levels, "lwes / pksk shapes disagree")
    _require(n_poly & (n_poly - 1) == 0 and 16 <= n_poly <= 1024,
             f"the kernel takes a power-of-two N in [16, 1024], not {n_poly}")
    _require(1 <= lwe_per_glwe <= n_poly, f"{lwe_per_glwe} LWEs do not fit N = {n_poly}")
    out = torch.zeros((-(-b // lwe_per_glwe), k1, n_poly), dtype=torch.int64,
                      device=lwes.device)
    lib = load()["packing_keyswitch"]
    args = (b, n_in, levels, k1, n_poly.bit_length() - 1, lwe_per_glwe, base_log,
            _stream(lwes))
    if packing_keyswitch_imma_shape(n_in, levels, k1, n_poly, base_log):
        _require(limbs is not None, "K4's tensor-core kernel takes the key's byte layout: "
                 "build it once with kernels.packing_keyswitch_key")
        _check_cuda((lwes, torch.int64), (limbs, torch.uint8))
        _require(limbs.shape == (n_in, levels, k1, 8, n_poly), "key limbs / words disagree")
        err = lib.tfhe_torch_packing_keyswitch_imma(out.data_ptr(), lwes.data_ptr(),
                                                    limbs.data_ptr(), *args)
        _raise_on(err, "packing_keyswitch (tensor cores)")
        packing_keyswitch.imma_launches += 1
    else:
        err = lib.tfhe_torch_packing_keyswitch(out.data_ptr(), lwes.data_ptr(),
                                               words.data_ptr(), *args)
        _raise_on(err, "packing_keyswitch")
    packing_keyswitch.launches += 1
    return out


packing_keyswitch.launches = 0
packing_keyswitch.imma_launches = 0    # of them, K4's tensor-core kernel


def blind_rotate128(msed_mask, msed_body, lut_lo, lut_hi, bsk_ntt, dp: DevicePlan,
                    base_log: int, levels: int):
    """K5: batched exact u128 blind rotation (see ops/server128.py
    blind_rotate128).

    msed_mask: (B, n) in [0, 2N); msed_body: (B,); lut pair: (B, k+1, N)
    int64; bsk_ntt: (n, l, k+1, k+1, 6, N) int32 Montgomery NTT-domain key.
    Returns the (lo, hi) accumulator.  Takes k+1 <= 3, base_log <= 31,
    base_log * l < 128, a power-of-two N and the shapes whose accumulator
    and one prime's digit residues fit one block's shared memory; raises on
    others (ROADMAP.md queue 3)."""
    if msed_mask.device.type == "cpu":
        return server128.blind_rotate128(msed_mask, msed_body, lut_lo, lut_hi,
                                         bsk_ntt, dp, base_log, levels)
    _require(msed_mask.device.type == "cuda",
             f"no u128 blind-rotation kernel for {msed_mask.device}")
    b, n_steps = msed_mask.shape
    k1, n_poly = lut_lo.shape[1], lut_lo.shape[2]
    nprimes = dp.num_primes
    _require(bsk_ntt.shape == (n_steps, levels, k1, k1, nprimes, n_poly),
             f"key shape {tuple(bsk_ntt.shape)} does not fit the batch")
    _require(nprimes == KERNEL128_PRIMES and n_poly & (n_poly - 1) == 0,
             "the u128 kernel takes a 6-prime plan and a power-of-two N")
    _require(dp.kernel_consts128 is not None
             and dp.kernel_consts128.numel() == KERNEL128_CONSTS_LEN, "bad plan table")
    _require(1 <= k1 <= 3 and 1 <= base_log <= 31 and base_log * levels < 128,
             f"the u128 kernel takes k+1 <= 3, base_log <= 31 and base_log * l < 128, "
             f"not k+1 = {k1}, base_log = {base_log}, l = {levels} (ROADMAP.md queue 3)")
    lib = load()["blind_rotate128"]
    smem = lib.tfhe_torch_blind_rotate128_smem_bytes(k1, n_poly, levels)
    _require(smem <= SMEM_LIMIT,
             f"u128 blind rotation with k+1 = {k1}, N = {n_poly}, l = {levels} needs "
             f"{smem} B of shared memory, above the {SMEM_LIMIT} B a block may use "
             f"(ROADMAP.md queue 3)")
    acc_lo, acc_hi = server128.monomial_div128(lut_lo, lut_hi, msed_body[:, None, None])
    acc = torch.stack([acc_lo, acc_hi], dim=-1).contiguous()   # little-endian u128
    mask32 = msed_mask.to(torch.int32).contiguous()
    bsk_ntt = bsk_ntt.contiguous()
    scratch = torch.empty((b, nprimes, k1, n_poly), dtype=torch.int32, device=acc.device)
    tw_fwd, tw_inv = shoup_twiddles(dp)
    _check_cuda((acc, torch.int64), (mask32, torch.int32), (bsk_ntt, torch.int32),
                (dp.psi32, torch.int32), (dp.psi_inv32, torch.int32), (tw_fwd, torch.int32),
                (tw_inv, torch.int32), (dp.kernel_consts128, torch.int64),
                (scratch, torch.int32))
    err = lib.tfhe_torch_blind_rotate128(
        acc.data_ptr(), mask32.data_ptr(), bsk_ntt.data_ptr(), dp.psi32.data_ptr(),
        dp.psi_inv32.data_ptr(), tw_fwd.data_ptr(), tw_inv.data_ptr(),
        dp.kernel_consts128.data_ptr(), scratch.data_ptr(), b, n_steps, k1,
        n_poly.bit_length() - 1, levels, nprimes, base_log, _stream(acc))
    _raise_on(err, "blind_rotate128")
    blind_rotate128.launches += 1
    return acc[..., 0], acc[..., 1]


blind_rotate128.launches = 0


# K6's output coefficients a block (csrc/packing_keyswitch128.cu TC_ROWS)
K6_TC_ROWS = 256


def packing_keyswitch128_key_limbs(key) -> torch.Tensor:
    """The byte layout of a u128 packing keyswitch key that K6 reads:
    (n, l, k+1, N, 2) int64 (lo, hi) -> (n, l, k+1, 16, N) uint8 on key's
    device, [i, lev, c, b, m] = byte b (little-endian) of the u128 key word
    m of polynomial c of row (i, lev): each limb row's N bytes contiguous,
    the K-major operand of the s8 x u8 tensor-core product."""
    n_in, levels, k1, n_poly, _ = key.shape
    return (key.contiguous().view(torch.uint8).reshape(n_in, levels, k1, n_poly, 16)
            .transpose(-1, -2).contiguous())


def packing_keyswitch128_key_words(limbs) -> torch.Tensor:
    """The words of a byte layout (packing_keyswitch128_key_limbs' inverse):
    (n, l, k+1, 16, N) uint8 -> (n, l, k+1, N, 2) int64 on its device."""
    n_in, levels, k1, _, n_poly = limbs.shape
    return (limbs.transpose(-1, -2).contiguous().view(torch.int64)
            .reshape(n_in, levels, k1, n_poly, 2))


def packing_keyswitch128_key(key):
    """The u128 packing keyswitch key as ``packing_keyswitch128`` takes it,
    from the (n, l, k+1, N, 2) int64 words: on a CUDA device its byte layout
    (packing_keyswitch128_key_limbs, built here on the card, the only copy
    the key's owner keeps there); else the words themselves."""
    return packing_keyswitch128_key_limbs(key) if key.device.type == "cuda" else key


def packing_keyswitch128_imma_smem(k1: int, n_poly: int, levels: int, base_log: int,
                                   max_count: int) -> int:
    """K6's dynamic shared memory for lists of up to max_count slots, or -1
    where it does not take the shape (csrc/packing_keyswitch128.cu
    tc_shape: N in 256, 512, 1024, k+1 <= 8, l <= 4, base_log <= 62); the
    wrapper refuses the shapes where this is -1 or above a block's shared
    memory (128,128 B at V1_4's 128 slots)."""
    return load()["packing_keyswitch128"].tfhe_torch_packing_keyswitch128_imma_smem(
        k1, n_poly.bit_length() - 1, levels, base_log, max_count)


def k6_imma_chunk(n_in: int, n_poly: int, lists: int, sms: int) -> int:
    """The input coefficients a block of K6 sums: its grid (N / K6_TC_ROWS,
    lists, chunks) fills two waves of ``sms`` (one block an SM) and no more:
    a third, part-filled wave would take as long as a full one."""
    tiles = n_poly // K6_TC_ROWS * lists
    chunks = max(1, min(n_in, 2 * sms // tiles))
    return -(-n_in // chunks)


def packing_keyswitch128(lwes, key, counts, base_log: int, levels: int,
                         dp: DevicePlan | None = None):
    """K6: the u128 packing keyswitch of squashed-noise compression, every
    list in one launch (see ops/server128.py packing_keyswitch128).

    lwes: (G, C, n+1, 2) int64, list g's u128 LWEs (lo, hi) at slots 0 ..
    counts[g]-1 (rows past them are ignored); key: on the CPU the (n, l,
    k+1, N, 2) int64 standard-domain u128 key, on the card its byte layout
    (packing_keyswitch128_key); counts: G ints in [1, C], C <= N.  On the
    CPU the plain version runs on dp (an 8-prime plan of N).  Returns (G,
    k+1, N, 2) int64.  Shapes K6 cannot take (packing_keyswitch128_imma_smem)
    raise a ValueError."""
    g, c, w, two = lwes.shape
    cuda = lwes.device.type == "cuda"
    if cuda:
        _require(key.dtype == torch.uint8 and key.dim() == 5 and key.shape[3] == 16,
                 "K6 takes the key's byte layout on the card: build it once with "
                 "kernels.packing_keyswitch128_key")
        n_in, lev, k1, _, n_poly = key.shape
    else:
        n_in, lev, k1, n_poly, _ = key.shape
    _require(two == 2 and w == n_in + 1 and lev == levels, "lwes / key shapes disagree")
    _require(len(counts) == g and all(1 <= int(x) <= c for x in counts),
             f"counts {list(counts)} do not fit {c} slots")
    _require(c <= n_poly, f"{c} slots do not fit N = {n_poly}")
    if lwes.device.type == "cpu":
        _require(dp is not None and dp.num_primes == 8, "the plain version takes an 8-prime plan")
        keep = torch.arange(c)[None, :] < torch.as_tensor(list(counts))[:, None]
        lwes = lwes * keep[:, :, None, None]
        lo, hi = server128.packing_keyswitch128(lwes[..., 0], lwes[..., 1], key[..., 0],
                                                key[..., 1], dp, base_log, levels)
        return torch.stack([lo, hi], dim=-1)
    _require(cuda, f"no u128 packing-keyswitch kernel for {lwes.device}")
    smem = (packing_keyswitch128_imma_smem(k1, n_poly, levels, base_log, max(counts))
            if n_poly & (n_poly - 1) == 0 else -1)
    _require(0 <= smem <= SMEM_LIMIT,
             f"K6 takes N in 256, 512, 1024, k+1 <= 8, l <= 4 and base_log <= 62, with its "
             f"lists' shared memory within a block's, not N = {n_poly}, k+1 = {k1}, "
             f"l = {levels}, base_log = {base_log}, {max(counts)} slots")
    lwes, key = lwes.contiguous(), key.contiguous()
    counts_t = torch.tensor([int(x) for x in counts], dtype=torch.int32, device=lwes.device)
    out = torch.empty((g, k1, n_poly, 2), dtype=torch.int64, device=lwes.device)
    _check_cuda((lwes, torch.int64), (key, torch.uint8), (counts_t, torch.int32))
    per_chunk = k6_imma_chunk(n_in, n_poly, g, torch.cuda.get_device_properties(
        lwes.device).multi_processor_count)
    chunks = -(-n_in // per_chunk)
    partial = torch.empty((g, chunks, k1, n_poly, 2), dtype=torch.int64, device=lwes.device)
    err = load()["packing_keyswitch128"].tfhe_torch_packing_keyswitch128_imma(
        out.data_ptr(), partial.data_ptr(), lwes.data_ptr(), key.data_ptr(),
        counts_t.data_ptr(), g, c, n_in, levels, k1, n_poly.bit_length() - 1, base_log,
        per_chunk, _stream(lwes))
    _raise_on(err, "packing_keyswitch128")
    packing_keyswitch128.launches += 1
    return out


packing_keyswitch128.launches = 0


# ---------------------------------------------------------------------------
# K7: the GLWE keyswitch (csrc/glwe_keyswitch.cu)
# ---------------------------------------------------------------------------

# K7 takes k_out + 1 <= 8 output rows (csrc/glwe_keyswitch.cu GK_MAX_OUT)
K7_MAX_OUT = 8


def glwe_keyswitch_rows(kout1: int, n_poly: int) -> int:
    """The input rows (input polynomial, level) K7's first kernel
    transforms at once: as many 4-prime residue rows as fit a block's
    shared memory beside the k_out+1 output rows' NTT-domain sums
    (csrc/glwe_keyswitch.cu glwe_keyswitch_kernel: one block a GLWE); 0
    where not one fits."""
    row_bytes = KERNEL_PRIMES * (n_poly + n_poly // 32) * 4
    return max(0, (SMEM_LIMIT - kout1 * row_bytes) // row_bytes)


def glwe_keyswitch_route(k_in: int, kout1: int, n_poly: int, levels: int,
                         base_log: int) -> str:
    """K7's kernel at a shape: "cluster" where csrc/glwe_keyswitch.cu
    gk_cluster_shape takes it (N = 2048, k_in l <= 8, k_out+1 <= 8, base_log
    <= 30: both research shapes), else "first" (one block a GLWE) where
    k_out+1 <= K7_MAX_OUT, base_log l < 64 and one input row fits beside the
    sums; raises elsewhere."""
    shape = (k_in, kout1, n_poly.bit_length() - 1, levels, base_log)
    if shape not in _K7_ROUTES:
        cluster = (n_poly & (n_poly - 1) == 0 and load()["glwe_keyswitch"]
                   .tfhe_torch_glwe_keyswitch_cluster_shape(*shape))
        _K7_ROUTES[shape] = "cluster" if cluster else "first"
    if _K7_ROUTES[shape] == "first":
        _require(1 <= base_log and base_log * levels < 64,
                 f"K7 takes base_log l < 64, not {base_log} x {levels}")
        _require(1 <= kout1 <= K7_MAX_OUT and glwe_keyswitch_rows(kout1, n_poly) >= 1,
                 f"K7 takes k_out+1 <= {K7_MAX_OUT} rows whose NTT-domain sums and one "
                 f"input row fit the {SMEM_LIMIT} B of shared memory a block may use, not "
                 f"k_out+1 = {kout1} at N = {n_poly}")
    return _K7_ROUTES[shape]


_K7_ROUTES = {}


def glwe_keyswitch_figures(k_in: int, kout1: int, n_poly: int, levels: int,
                           base_log: int) -> dict:
    """K7's route at a shape, a block's dynamic shared memory and, for the
    cluster kernel, the clusters of four blocks the card holds at once
    (cudaOccupancyMaxActiveClusters)."""
    route = glwe_keyswitch_route(k_in, kout1, n_poly, levels, base_log)
    if route == "first":
        chunk = min(glwe_keyswitch_rows(kout1, n_poly), k_in * levels)
        return {"route": route, "rows_a_chunk": chunk,
                "shared_memory_bytes": (kout1 + chunk) * KERNEL_PRIMES
                * (n_poly + n_poly // 32) * 4}
    lib = load()["glwe_keyswitch"]
    return {"route": route,
            "shared_memory_bytes": lib.tfhe_torch_glwe_keyswitch_cluster_smem(k_in, kout1,
                                                                              levels),
            "active_clusters": lib.tfhe_torch_glwe_keyswitch_cluster_occupancy(k_in, kout1,
                                                                               levels)}


def glwe_keyswitch(glwe, key, dp: DevicePlan, base_log: int, levels: int,
                   add_sum: bool = False):
    """K7: the GLWE keyswitch sum of a batch with a non-square NTT-domain key
    (see ops/server.py glwe_keyswitch_sum): (0, body) - sum, or with
    add_sum sum + (0, body) (the fast keyswitch on a pseudo-GGSW).

    glwe: (B, k_in+1, N) int64; key: (k_in, l, k_out+1, P, N) int32
    Montgomery NTT domain on dp's four primes.  The kernel is chosen by
    shape (glwe_keyswitch_route): the cluster kernel, four blocks a GLWE,
    one a CRT prime, else the first kernel, one block a GLWE, the input
    rows in chunks of glwe_keyswitch_rows; raises elsewhere.  Returns (B,
    k_out+1, N) int64."""
    if glwe.device.type == "cpu":
        return server.glwe_keyswitch_sum(glwe, key, dp, base_log, levels, add_sum)
    _require(glwe.device.type == "cuda", f"no GLWE-keyswitch kernel for {glwe.device}")
    glwe, key = glwe.contiguous(), key.contiguous()
    b, kin1, n_poly = glwe.shape
    k_in, lev, kout1, nprimes, n_key = key.shape
    _require(k_in == kin1 - 1 and lev == levels and n_key == n_poly,
             f"key shape {tuple(key.shape)} does not fit GLWEs {tuple(glwe.shape)}")
    _require(nprimes == KERNEL_PRIMES and n_poly & (n_poly - 1) == 0,
             "K7 takes a 4-prime plan and a power-of-two N")
    route = glwe_keyswitch_route(k_in, kout1, n_poly, levels, base_log)
    out = torch.empty((b, kout1, n_poly), dtype=torch.int64, device=glwe.device)
    lib = load()["glwe_keyswitch"]
    if route == "cluster":
        tw_fwd, tw_inv = shoup_twiddles(dp)
        _check_cuda((glwe, torch.int64), (key, torch.int32), (tw_fwd, torch.int32),
                    (tw_inv, torch.int32), (dp.kernel_consts, torch.int64))
        _require(key.data_ptr() % 16 == 0, "the key must be 16-byte aligned")
        err = lib.tfhe_torch_glwe_keyswitch_cluster(
            out.data_ptr(), glwe.data_ptr(), key.data_ptr(), tw_fwd.data_ptr(),
            tw_inv.data_ptr(), dp.kernel_consts.data_ptr(), b, k_in, kout1,
            n_poly.bit_length() - 1, levels, base_log, int(add_sum), _stream(glwe))
        _raise_on(err, "glwe_keyswitch (cluster)")
        glwe_keyswitch.cluster_launches += 1
    else:
        _check_cuda((glwe, torch.int64), (key, torch.int32), (dp.psi32, torch.int32),
                    (dp.psi_inv32, torch.int32), (dp.kernel_consts, torch.int64))
        err = lib.tfhe_torch_glwe_keyswitch(
            out.data_ptr(), glwe.data_ptr(), key.data_ptr(), dp.psi32.data_ptr(),
            dp.psi_inv32.data_ptr(), dp.kernel_consts.data_ptr(), b, k_in, kout1,
            n_poly.bit_length() - 1, levels, base_log, int(add_sum),
            min(glwe_keyswitch_rows(kout1, n_poly), k_in * levels), _stream(glwe))
        _raise_on(err, "glwe_keyswitch")
    glwe_keyswitch.launches += 1
    return out


glwe_keyswitch.launches = 0
glwe_keyswitch.cluster_launches = 0    # of them, K7's cluster kernel


# ---------------------------------------------------------------------------
# K8: the extended blind rotation (csrc/blind_rotate_extended.cu)
# ---------------------------------------------------------------------------

# the extension factors K8 takes: a cluster of E blocks a ciphertext, at
# most the portable cluster size of 8
K8_FACTORS = (1, 2, 4, 8)

# K8's lazy kernel's shape, the routing's one predicate (its entry point
# refuses others: csrc/blind_rotate_extended.cu extended_lazy_shape): K2's
# lazy exact shape, every 2_2 set
K8_LAZY_SHAPE = {"k1": 2, "n_poly": 2048, "levels": 1, "max_base_log": 30}


def extended_route(k1: int, n_poly: int, levels: int, base_log: int) -> str:
    """Which kernel K8 runs at a shape: "lazy" at K8_LAZY_SHAPE (the six
    fused lazy passes of K2's lazy exact kernel, SB slots a block),
    else "generic" (the first design, one slot of one ciphertext a block)
    where k+1 <= GENERIC_MAX_K1, base_log l < 64, l <= 8 and its block fits
    shared memory.  Raises a ValueError elsewhere."""
    s = K8_LAZY_SHAPE
    if (k1 == s["k1"] and n_poly == s["n_poly"] and levels == s["levels"]
            and 1 <= base_log <= s["max_base_log"]):
        return "lazy"
    smem = exact_smem_bytes(k1, n_poly, levels)
    _require(k1 <= GENERIC_MAX_K1 and smem <= SMEM_LIMIT and 1 <= base_log
             and base_log * levels < 64 and levels <= 8,
             f"K8 at k+1 = {k1}, N = {n_poly}, l = {levels}, base_log = {base_log}: its lazy "
             f"kernel takes k+1 = 2, N = 2048, l = 1, base_log <= 30, its generic kernel "
             f"k+1 <= {GENERIC_MAX_K1}, l <= 8, base_log l < 64 within the {SMEM_LIMIT} B of "
             f"shared memory a block may use (this shape needs {smem} B)")
    return "generic"


# the slots a block of K8's lazy kernel takes, SB, and the time of one
# wave of two-slot blocks against one of one-slot blocks
# (tools/rotation_probe.py: 38.51 against 22.68 ms at E = 2, B = 64, one
# wave each; NVIDIA H100 80GB HBM3, 700 W)
K8_SLOTS = (1, 2)
K8_TWO_SLOT_WAVE_COST = 1.70


def _k8_active_clusters(log_e: int, sb: int) -> int:
    """The clusters of K8's lazy kernel at SB slots a block the card holds
    at once (cudaOccupancyMaxActiveClusters), asked once."""
    if (log_e, sb) not in _K8_CLUSTERS:
        n = load()["blind_rotate_extended"].tfhe_torch_blind_rotate_extended_lazy_clusters(
            log_e, sb)
        _require(n > 0, f"K8's lazy kernel fits no cluster of {1 << log_e} slots: {n}")
        _K8_CLUSTERS[log_e, sb] = n
    return _K8_CLUSTERS[log_e, sb]


_K8_CLUSTERS = {}


def extended_slots(e: int, batch: int) -> int:
    """The slots SB a block of K8's lazy kernel takes at extension factor E
    and batch B: of K8_SLOTS (SB <= E), the fewest waves of B clusters of
    E / SB blocks, a two-slot wave weighted by K8_TWO_SLOT_WAVE_COST, one
    slot on a tie.  Two slots share each key load and halve a cluster; a
    cluster of 4 blocks fits only 30 times on the H100, one of 2 blocks 66
    times."""
    log_e = e.bit_length() - 1

    def cost(sb):
        waves = -(-batch // _k8_active_clusters(log_e, sb))
        return waves * (1.0 if sb == 1 else K8_TWO_SLOT_WAVE_COST)

    return min((sb for sb in K8_SLOTS if sb <= e), key=cost)


def extended_figures(e: int, batch: int, k1: int, n_poly: int, levels: int,
                     base_log: int) -> dict:
    """K8's route at a shape, extension factor E and batch B, its slots a
    block, a block's dynamic shared memory and the clusters the card holds
    at once (cudaOccupancyMaxActiveClusters)."""
    lib = load()["blind_rotate_extended"]
    route = extended_route(k1, n_poly, levels, base_log)
    log_e = e.bit_length() - 1
    if route == "lazy":
        sb = extended_slots(e, batch)
        smem = lib.tfhe_torch_blind_rotate_extended_lazy_smem(sb)
        clusters = _k8_active_clusters(log_e, sb)
    else:
        sb, smem = 1, exact_smem_bytes(k1, n_poly, levels)
        clusters = lib.tfhe_torch_blind_rotate_extended_clusters(log_e, smem)
    return {"route": route, "slots_per_block": sb,
            "cluster_blocks": e // sb, "shared_memory_bytes": smem,
            "active_clusters": clusters}


def blind_rotate_extended(msed_mask, acc, bsk_ntt, dp: DevicePlan, base_log: int,
                          levels: int):
    """K8: the extended blind rotation's n steps in one launch (see
    ops/server.py blind_rotate_extended), on E interleaved accumulators a
    ciphertext.

    msed_mask: (B, n) in [0, 2 N E); acc: (B, E, k+1, N) int64, the split
    initial accumulator; bsk_ntt: (n, l, k+1, k+1, P, N) int32 Montgomery
    NTT-domain key of size N on dp's four primes.  A cluster of E blocks, one
    a slot (the lazy kernel: E / SB blocks of SB slots); takes E in
    K8_FACTORS.  The kernel is chosen by shape (extended_route): the lazy
    kernel, its slots a block by extended_slots; else the generic kernel;
    raises elsewhere.  Returns the final (B, E, k+1, N)."""
    _require(not isinstance(bsk_ntt, RoundedKeyNtt),
             "the extended rotation runs on the exact key")
    if acc.device.type == "cpu":
        return server.blind_rotate_extended(msed_mask, acc, bsk_ntt, dp, base_log, levels)
    _require(acc.device.type == "cuda", f"no extended-rotation kernel for {acc.device}")
    b, e, k1, n_poly = acc.shape
    n_steps = msed_mask.shape[1]
    _require(e in K8_FACTORS, f"K8 takes an extension factor in {K8_FACTORS}, not {e}")
    _require(bsk_ntt.shape == (n_steps, levels, k1, k1, dp.num_primes, n_poly),
             f"key shape {tuple(bsk_ntt.shape)} does not fit the batch")
    _require(dp.num_primes == KERNEL_PRIMES and n_poly & (n_poly - 1) == 0,
             "K8 takes a 4-prime plan and a power-of-two N")
    route = extended_route(k1, n_poly, levels, base_log)
    lib = load()["blind_rotate_extended"]
    mask32 = msed_mask.to(torch.int32).contiguous()
    bsk_ntt = bsk_ntt.contiguous()
    log_n, log_e = n_poly.bit_length() - 1, e.bit_length() - 1
    acc = acc.clone(memory_format=torch.contiguous_format)
    if route == "lazy":
        tw_fwd, tw_inv = shoup_twiddles(dp)
        _check_cuda((acc, torch.int64), (mask32, torch.int32), (bsk_ntt, torch.int32),
                    (tw_fwd, torch.int32), (tw_inv, torch.int32),
                    (dp.kernel_consts, torch.int64))
        _require(bsk_ntt.data_ptr() % 16 == 0, "the key must be 16-byte aligned")
        err = lib.tfhe_torch_blind_rotate_extended_lazy(
            acc.data_ptr(), mask32.data_ptr(), bsk_ntt.data_ptr(), tw_fwd.data_ptr(),
            tw_inv.data_ptr(), dp.kernel_consts.data_ptr(), b, n_steps, k1, log_n, levels,
            base_log, log_e, extended_slots(e, b), _stream(acc))
        _raise_on(err, "blind_rotate_extended (lazy)")
        blind_rotate_extended.lazy_launches += 1
        blind_rotate_extended.launches += 1
        return acc
    smem = exact_smem_bytes(k1, n_poly, levels)
    _check_cuda((acc, torch.int64), (mask32, torch.int32), (bsk_ntt, torch.int32),
                (dp.psi32, torch.int32), (dp.psi_inv32, torch.int32),
                (dp.kernel_consts, torch.int64))
    err = lib.tfhe_torch_blind_rotate_extended(
        acc.data_ptr(), mask32.data_ptr(), bsk_ntt.data_ptr(), dp.psi32.data_ptr(),
        dp.psi_inv32.data_ptr(), dp.kernel_consts.data_ptr(), b, n_steps, k1, log_n, levels,
        base_log, log_e, smem, _stream(acc))
    _raise_on(err, "blind_rotate_extended")
    blind_rotate_extended.launches += 1
    return acc


blind_rotate_extended.launches = 0
blind_rotate_extended.lazy_launches = 0     # of them, K8's lazy kernel


# ---------------------------------------------------------------------------
# K9: the slot-local stages of the four-step split (csrc/poly_shard.cu)
# ---------------------------------------------------------------------------


def _k9_tables(t: four_step.PolyShardTables, dev: torch.device) -> None:
    _require(t.consts is not None, "K9 runs the 4-prime plan only")
    _require(t.pw_f.device == dev, f"tables on {t.pw_f.device}, tensors on {dev}")


def poly_shard_forward(x, t: four_step.PolyShardTables, slot: int, levels: int = 0,
                       base_log: int = 0) -> torch.Tensor:
    """K9 entry (a) on slot ``slot``: x (M, C) int64 u64 words -> (L, M,
    P, C) int32 residues after the digits (levels > 0) or the words' residues,
    the twist, the cyclic size-C transform and the twiddle
    (four_step.forward_plain, which runs for CPU tensors)."""
    if x.device.type == "cpu":
        return four_step.forward_plain(x, t, slot, levels, base_log)
    _require(x.device.type == "cuda", f"no K9 kernel for {x.device}")
    _check_cuda((x, torch.int64))
    _k9_tables(t, x.device)
    rows, c = x.shape
    _require(c == t.c, f"{c} coefficients a slot, the tables split N = {t.n} into {t.c}")
    out = torch.empty((max(levels, 1), rows, KERNEL_PRIMES, c), dtype=torch.int32,
                      device=x.device)
    err = load()["poly_shard"].tfhe_torch_poly_shard_forward(
        x.data_ptr(), out.data_ptr(), t.consts.data_ptr(), t.tw_f[slot].data_ptr(),
        t.twd_f[slot].data_ptr(), t.pw_f.data_ptr(), rows, c.bit_length() - 1, levels,
        base_log, _stream(x))
    _raise_on(err, "poly_shard_forward")
    poly_shard_forward.launches += 1
    return out


poly_shard_forward.launches = 0


def poly_shard_cross(ya, t: four_step.PolyShardTables, key=None, batch: int = 0, k1: int = 1,
                     key_per_row: bool = False) -> torch.Tensor:
    """K9 entry (b) on a slot after the exchange: ya (D, L, M, P, C/D)
    int32 residues -> without a key the slot's evaluation slice (L, M, P,
    C), Montgomery form; with a key (L, k+1, k+1, P, C) int32 (or one (P,
    C) slice a row, key_per_row) the product summed over the levels and input rows, after
    the size-D inverse: (D, batch, k+1, P, C/D) (four_step.cross_plain,
    which runs for CPU tensors)."""
    if ya.device.type == "cpu":
        return four_step.cross_plain(ya, t, key, batch, k1, key_per_row)
    _require(ya.device.type == "cuda", f"no K9 kernel for {ya.device}")
    _check_cuda((ya, torch.int32), *(() if key is None else ((key, torch.int32),)))
    _k9_tables(t, ya.device)
    d, levels, m, np_, cd = ya.shape
    _require(d == t.d and cd * d == t.c and np_ == KERNEL_PRIMES, "ya does not fit the tables")
    if key is None:
        out = torch.empty((levels, m, np_, t.c), dtype=torch.int32, device=ya.device)
        batch, k1, stride, key_ptr = m, 1, 0, None
    else:
        _require(m == batch * k1, "rows are not batch (k+1)")
        if key_per_row:
            _require(levels == 1 and k1 == 1 and key.shape == (m, np_, t.c), "row keys")
            stride = np_ * t.c
        else:
            _require(tuple(key.shape) == (levels, k1, k1, np_, t.c), "key slice shape")
            stride = 0
        out = torch.empty((d, batch, k1, np_, cd), dtype=torch.int32, device=ya.device)
        key_ptr = key.data_ptr()
    err = load()["poly_shard"].tfhe_torch_poly_shard_cross(
        ya.data_ptr(), key_ptr, out.data_ptr(), t.consts.data_ptr(), t.pwd_f.data_ptr(),
        t.pwd_i.data_ptr(), t.r2.data_ptr(), d, cd, levels, batch, k1, stride,
        int(key is None), _stream(ya))
    _raise_on(err, "poly_shard_cross")
    poly_shard_cross.launches += 1
    return out


poly_shard_cross.launches = 0


def poly_shard_inverse(yb, t: four_step.PolyShardTables, slot: int) -> torch.Tensor:
    """K9 entry (c) on slot ``slot`` after the exchange back: yb (D, M, P,
    C/D) int32 residues -> (M, C) int64 u64 words: the inverse twiddle, the inverse
    cyclic size-C transform, the inverse twist and Garner
    (four_step.inverse_plain, which runs for CPU tensors)."""
    if yb.device.type == "cpu":
        return four_step.inverse_plain(yb, t, slot)
    _require(yb.device.type == "cuda", f"no K9 kernel for {yb.device}")
    _check_cuda((yb, torch.int32))
    _k9_tables(t, yb.device)
    d, m, np_, cd = yb.shape
    _require(d == t.d and cd * d == t.c and np_ == KERNEL_PRIMES, "yb does not fit the tables")
    out = torch.empty((m, t.c), dtype=torch.int64, device=yb.device)
    err = load()["poly_shard"].tfhe_torch_poly_shard_inverse(
        yb.data_ptr(), out.data_ptr(), t.consts.data_ptr(), t.twd_i[slot].data_ptr(),
        t.tw_ci[slot].data_ptr(), t.pw_i.data_ptr(), m, d, t.c.bit_length() - 1, _stream(yb))
    _raise_on(err, "poly_shard_inverse")
    poly_shard_inverse.launches += 1
    return out


poly_shard_inverse.launches = 0


# The fused entry's limits (csrc/poly_shard.cu rotate_shape): D slots of a
# power of two up to 8 with D^2 dividing N, k+1 and l up to 8, C = N / D
# from 8 to 8192, base_log up to 30.
K9_MAX_SLOTS = 8
K9_MAX_K1 = 8
K9_MAX_LEVELS = 8
K9_MAX_LOG_C = 13


def poly_rotation_route(devices, d: int, k1: int, levels: int, n_poly: int) -> str:
    """How parallel/poly_shard.py sharded_blind_rotate_poly runs a mesh's
    slots (pure Python, no card needed): "fused" where every slot is the
    same CUDA device and the shape is one K9's fused entry takes (or every
    slot the CPU, where that entry's plain version runs), "steps" where the
    slots lie on distinct devices (K9's three step entries a CMux step a
    slot, the exchanges between devices); a ValueError naming the limit
    for a one-card shape the fused entry does not take."""
    devs = [torch.device(x) for x in devices]
    _require(len(devs) == d, f"{len(devs)} devices for {d} slots")
    if len(set(devs)) > 1:
        return "steps"
    if devs[0].type == "cpu":
        return "fused"
    _require(devs[0].type == "cuda", f"no K9 kernel for {devs[0]}")
    _require(d in (1, 2, 4, K9_MAX_SLOTS),
             f"the fused K9 entry takes D in 1, 2, 4, {K9_MAX_SLOTS} slots, not {d}")
    _require(n_poly % (d * d) == 0 and n_poly & (n_poly - 1) == 0,
             f"N = {n_poly} does not split over D = {d} slots (D^2 must divide N)")
    log_c = (n_poly // d).bit_length() - 1
    _require(3 <= log_c <= K9_MAX_LOG_C,
             f"the fused K9 entry takes C = N / D from 8 to {1 << K9_MAX_LOG_C}, "
             f"not {n_poly // d}")
    _require(1 <= k1 <= K9_MAX_K1, f"the fused K9 entry takes k+1 <= {K9_MAX_K1}, not {k1}")
    _require(1 <= levels <= K9_MAX_LEVELS,
             f"the fused K9 entry takes l <= {K9_MAX_LEVELS}, not {levels}")
    return "fused"


@lru_cache(maxsize=None)
def poly_rotate_plan(device_index: int, d: int, k1: int, levels: int, n_poly: int) -> dict:
    """How K9's fused kernel runs a shape on card ``device_index``, from the
    kernel's own plan (csrc/poly_shard.cu rotate_plan, asked once a device
    and shape): primes a block (1, or 2 at D = 8), blocks a slot and a
    cluster (one cluster a ciphertext), where the state lives (tier 0 words,
    rows, tables and the double-buffered key slice in shared memory; 1 the
    key slice read from global memory; 2 the tables too; 3 the words and
    rows in a global scratch of ``block_bytes`` a block), its shared memory
    a block and the clusters the card holds at once; raises where that is
    0 or an error."""
    plan = (ctypes.c_longlong * 7)()
    with torch.cuda.device(device_index):
        err = load()["poly_shard"].tfhe_torch_poly_shard_rotate_plan(
            d, k1, levels, (n_poly // d).bit_length() - 1, plan)
    _raise_on(err, "poly_shard_rotate_plan")
    keys = ("primes_per_block", "blocks_per_slot", "cluster", "tier", "shared_memory_bytes",
            "block_bytes", "active_clusters")
    out = dict(zip(keys, plan), threads=512)
    if out["active_clusters"] <= 0:
        raise RuntimeError(
            f"the card holds 0 clusters of K9's fused kernel at D = {d}, k+1 = {k1}, "
            f"l = {levels}, N = {n_poly}: {out['cluster']} blocks of {out['threads']} "
            f"threads and {out['shared_memory_bytes']} B of shared memory a block")
    return out


def poly_shard_rotate(msed_mask, msed_body, lut, key, t: four_step.PolyShardTables,
                      base_log: int, levels: int) -> torch.Tensor:
    """K9's fused entry: the blind rotation of lut (B, k+1, N) int64 by
    msed_body (B,) and msed_mask (B, n) in [0, 2N) on the key's evaluation
    slices key (D, n, l, k+1, k+1, P, C) int32 (PolyShardedKey.whole) with
    the split's tables t of D slots: all n CMux steps in one launch, one
    cluster a ciphertext (``poly_rotate_plan``), the words of ops/server.py
    ``blind_rotate``.  On CPU tensors its plain version, the step loop
    (four_step.rotate_steps) on the plain stages, runs."""
    if lut.device.type == "cpu":
        return four_step.rotate_steps(msed_mask, msed_body, lut, list(key.unbind(0)),
                                      [t] * t.d, base_log, levels)
    _require(lut.device.type == "cuda", f"no K9 kernel for {lut.device}")
    b, k1, n_poly = lut.shape
    d, n_steps = t.d, msed_mask.shape[1]
    _require(poly_rotation_route([lut.device] * d, d, k1, levels, n_poly) == "fused",
             "the fused entry runs one device")
    _require(1 <= base_log <= 30 and base_log * levels < 64,
             f"the fused K9 entry takes base_log <= 30, not {base_log}")
    _require(n_poly == t.n and msed_mask.shape[0] == b and msed_body.shape == (b,),
             "mask, body and LUT do not fit the tables")
    _require(key is not None and tuple(key.shape) == (d, n_steps, levels, k1, k1, KERNEL_PRIMES,
                                                      t.c),
             f"key slices {None if key is None else tuple(key.shape)} do not fit the batch")
    _k9_tables(t, lut.device)
    plan = poly_rotate_plan(lut.device.index, d, k1, levels, n_poly)
    lut = lut.contiguous()
    mask32 = msed_mask.to(torch.int32).contiguous()
    body32 = msed_body.to(torch.int32).contiguous()
    _check_cuda((lut, torch.int64), (mask32, torch.int32), (body32, torch.int32),
                (key, torch.int32), (t.packed, torch.int32), (t.packed_cross, torch.int32),
                (t.consts, torch.int64))
    _require(key.data_ptr() % 16 == 0, "the key must be 16-byte aligned")
    scratch = (torch.empty(b * plan["cluster"] * plan["block_bytes"], dtype=torch.uint8,
                           device=lut.device) if plan["tier"] == 3 else None)
    out = torch.empty_like(lut)
    err = load()["poly_shard"].tfhe_torch_poly_shard_rotate(
        out.data_ptr(), lut.data_ptr(), body32.data_ptr(), mask32.data_ptr(), key.data_ptr(),
        t.packed.data_ptr(), t.packed_cross.data_ptr(), t.consts.data_ptr(),
        None if scratch is None else scratch.data_ptr(), b, n_steps, k1, levels, base_log, d,
        t.c.bit_length() - 1, _stream(lut))
    _raise_on(err, "poly_shard_rotate")
    poly_shard_rotate.launches += 1
    return out


poly_shard_rotate.launches = 0
