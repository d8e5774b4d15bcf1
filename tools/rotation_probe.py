#!/usr/bin/env python3
"""K8's lazy kernel (csrc/blind_rotate_extended.cu) and K2's cluster kernel
at the common-mask shapes (csrc/blind_rotate_cluster.cu at N = 2048) on one
CUDA card: held against their plain versions, and timed beside the kernels
they replace with each design choice, in one call.

    python3 tools/rotation_probe.py [--batch 64] [--steps 918]

From the root of a checkout.  On random keys at the 2_2 widths (k = 1,
N = 2048, l = 1, base 2^23):

- checks: K8's lazy kernel at each of its slots a block (SB = 1, 2; SB <=
  E), its one-copy variant at SB = 1, and its generic kernel at E =
  1, 2, 4, 8, and the cluster kernel at k+1 = 3 .. 8 compiled for one and
  for two blocks an SM, at B = 4 over 16 steps against ops/server.py's
  plain versions (it raises where a word differs);
- K8: the lazy kernel at each SB, the one-copy variant at SB = 1 (timed
  in the order shipped, variant, variant, shipped) and the generic
  kernel (the first design, through its C entry) at E = 1, 2, 4, 8, B =
  --batch over --steps steps (CUDA events), with
  cudaOccupancyMaxActiveClusters and the SB ops/kernels.py extended_slots
  chooses;
- the CM rotation: the cluster kernel compiled for one and for two blocks
  an SM, and K2's generic kernel at k+1 = 3 and 4 (the shapes whose block
  fits), B = --batch over --steps steps.

The design variants are built from copies of the shipped sources with the
edits below (VARIANTS) under build/rotation_probe/, beside the libraries
the port builds; the shipped sources are not changed.  Prints one JSON
object with the card's name and power limit and writes it to
build/rotation_probe.json.
"""
import argparse
import ctypes
import json
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from tfhe_tpu_torch.ops import kernels, ntt, server, torus  # noqa: E402
from tfhe_tpu_torch.utils.build import CSRC, build_shared_libraries  # noqa: E402

N_POLY, BASE_LOG, LEVELS = 2048, 23, 1
FACTORS = (1, 2, 4, 8)
CM_K1 = (3, 4, 5, 6, 7, 8)
CHECK_BATCH, CHECK_STEPS = 4, 16

# K8's lazy kernel with one copy of the accumulators at SB = 1 as at SB =
# 2 (the shipped kernel keeps two at SB = 1): written in place behind a
# split cluster barrier.
_K8_ONE_COPY = {"blind_rotate_extended.cu": [
    ("  static constexpr int BUFS = SB == 1 ? 2 : 1;", "  static constexpr int BUFS = 1;")]}


def _cluster_blocks(m):
    """K2's cluster kernel compiled for m blocks an SM at N = 2048."""
    return {"blind_rotate_cluster.cu": [("  return log_n == CM_LOG_N ? 2 : 1;",
                                         f"  return log_n == CM_LOG_N ? {m} : 1;")]}


# variant -> (source built, {file: [(old, new), ...]}); each old occurs once
VARIANTS = {
    "k8_one_copy": ("blind_rotate_extended.cu", _K8_ONE_COPY),
    "cluster_mb1": ("blind_rotate_cluster.cu", _cluster_blocks(1)),
    "cluster_mb2": ("blind_rotate_cluster.cu", _cluster_blocks(2)),
}


def build_variants() -> dict:
    """Each variant's library, built from patched copies of csrc/ under
    build/rotation_probe/<variant>/ (all compilers started together)."""
    specs = []
    for name, (source, edits) in VARIANTS.items():
        where = ROOT / "build" / "rotation_probe" / name
        where.mkdir(parents=True, exist_ok=True)
        for f in [source] + [h.name for h in CSRC.glob("*.cuh")]:
            text = (CSRC / f).read_text()
            for old, new in edits.get(f, []):
                if text.count(old) != 1:
                    raise SystemExit(f"{name}: the edit of {f} does not apply: {old[:60]!r}")
                text = text.replace(old, new)
            (where / f).write_text(text)
        specs.append((f"tfhe_torch_probe_{name}", [where / source], kernels.nvcc_command()))
    paths = build_shared_libraries(specs)
    vp, i = ctypes.c_void_p, ctypes.c_int
    libs = {}
    for name, path in zip(VARIANTS, paths):
        lib = libs[name] = ctypes.CDLL(str(path))
        if name.startswith("cluster"):
            lib.tfhe_torch_blind_rotate_cluster.argtypes = ([vp] * 4 + [ctypes.c_longlong]
                                                            + [vp] * 3 + [i] * 7 + [vp])
            lib.tfhe_torch_blind_rotate_cluster.restype = i
            lib.tfhe_torch_blind_rotate_cluster_occupancy.argtypes = [i] * 3
            lib.tfhe_torch_blind_rotate_cluster_occupancy.restype = i
        else:
            lib.tfhe_torch_blind_rotate_extended_lazy.argtypes = [vp] * 6 + [i] * 8 + [vp]
            lib.tfhe_torch_blind_rotate_extended_lazy.restype = i
            lib.tfhe_torch_blind_rotate_extended_lazy_clusters.argtypes = [i] * 2
            lib.tfhe_torch_blind_rotate_extended_lazy_clusters.restype = i
    shutil.rmtree(ROOT / "build" / "rotation_probe")
    return libs


def ms(fn, reps=2):
    """Mean milliseconds of fn() over reps launches after one warm-up."""
    fn()
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / reps


def random_key(steps, k1, dp, gen):
    return torch.stack([torch.randint(0, q, (steps, LEVELS, k1, k1, N_POLY), generator=gen,
                                      device="cuda") for q in dp.plan.primes],
                       dim=-2).to(torch.int32)


def random_words(shape, rng):
    return torus.from_u64(rng.integers(0, 1 << 64, shape, dtype=np.uint64), "cuda")


def run_cluster(lib, acc, mask, key, dp):
    acc = acc.clone()
    tw_fwd, tw_inv = ntt.shoup_twiddles(dp)
    mask32 = mask.to(torch.int32).contiguous()
    err = lib.tfhe_torch_blind_rotate_cluster(
        acc.data_ptr(), mask32.data_ptr(), key.data_ptr(), None, 0, tw_fwd.data_ptr(),
        tw_inv.data_ptr(), dp.kernel_consts.data_ptr(), acc.shape[0], mask.shape[1], acc.shape[1],
        N_POLY.bit_length() - 1, LEVELS, 4, BASE_LOG, kernels._stream(acc))
    if err:
        raise RuntimeError(f"cluster kernel: cudaError {err}")
    return acc


def run_generic(acc, mask, key, dp):
    acc = acc.clone()
    mask32 = mask.to(torch.int32).contiguous()
    err = kernels.load()["blind_rotate"].tfhe_torch_blind_rotate(
        acc.data_ptr(), mask32.data_ptr(), key.data_ptr(), dp.psi32.data_ptr(),
        dp.psi_inv32.data_ptr(), dp.kernel_consts.data_ptr(), acc.shape[0], mask.shape[1],
        acc.shape[1], N_POLY.bit_length() - 1, LEVELS, 4, BASE_LOG, kernels._stream(acc))
    if err:
        raise RuntimeError(f"K2's generic kernel: cudaError {err}")
    return acc


def run_k8(acc, mask, key, dp, sb, lib=None):
    """K8 through its C entries: sb the lazy kernel's slots a block (from
    lib, the shipped library by default), None the generic kernel."""
    lib = lib or kernels.load()["blind_rotate_extended"]
    b, e, k1, _ = acc.shape
    acc = acc.clone()
    mask32 = mask.to(torch.int32).contiguous()
    log_n, log_e = N_POLY.bit_length() - 1, e.bit_length() - 1
    if sb:
        tw_fwd, tw_inv = ntt.shoup_twiddles(dp)
        err = lib.tfhe_torch_blind_rotate_extended_lazy(
            acc.data_ptr(), mask32.data_ptr(), key.data_ptr(), tw_fwd.data_ptr(),
            tw_inv.data_ptr(), dp.kernel_consts.data_ptr(), b, mask.shape[1], k1, log_n,
            LEVELS, BASE_LOG, log_e, sb, kernels._stream(acc))
    else:
        err = lib.tfhe_torch_blind_rotate_extended(
            acc.data_ptr(), mask32.data_ptr(), key.data_ptr(), dp.psi32.data_ptr(),
            dp.psi_inv32.data_ptr(), dp.kernel_consts.data_ptr(), b, mask.shape[1], k1,
            log_n, LEVELS, BASE_LOG, log_e, kernels.exact_smem_bytes(k1, N_POLY, LEVELS),
            kernels._stream(acc))
    if err:
        raise RuntimeError(f"K8 (SB {sb}): cudaError {err}")
    return acc


def slot_choices(e):
    return [sb for sb in kernels.K8_SLOTS if sb <= e]


def words_differing(got, want) -> int:
    return int((got != want).sum())


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--steps", type=int, default=918)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card")
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    kernels.load()
    variants = build_variants()
    one = variants["k8_one_copy"]
    clusters = {m: variants[f"cluster_mb{m}"] for m in (1, 2)}
    dp = ntt.device_plan(ntt.make_plan(N_POLY, 4), "cuda")
    gen = torch.Generator(device="cuda").manual_seed(7)
    rng = np.random.default_rng(7)
    out = {"gpu": gpu.strip(), "batch": args.batch, "steps": args.steps, "checks": {},
           "k8": {}, "cm": {}}

    # checks against the plain versions
    key2 = random_key(CHECK_STEPS, 2, dp, gen)
    for e in FACTORS:
        mask = torch.from_numpy(rng.integers(0, 2 * N_POLY * e, (CHECK_BATCH, CHECK_STEPS))).cuda()
        acc = random_words((CHECK_BATCH, e, 2, N_POLY), rng)
        want = server.blind_rotate_extended(mask, acc, key2, dp, BASE_LOG, LEVELS)
        for sb in slot_choices(e) + [None]:
            out["checks"][f"k8_e{e}_{f'sb{sb}' if sb else 'generic'}"] = words_differing(
                run_k8(acc, mask, key2, dp, sb), want)
        out["checks"][f"k8_e{e}_sb1_one_copy"] = words_differing(
            run_k8(acc, mask, key2, dp, 1, one), want)
    for k1 in CM_K1:
        key = random_key(CHECK_STEPS, k1, dp, gen)
        mask = torch.from_numpy(rng.integers(0, 2 * N_POLY, (CHECK_BATCH, CHECK_STEPS))).cuda()
        acc = random_words((CHECK_BATCH, k1, N_POLY), rng)
        want = server.rotate_accumulator(acc, mask, key, dp, BASE_LOG, LEVELS)
        for m, lib in clusters.items():
            out["checks"][f"cluster_k{k1}_mb{m}"] = words_differing(
                run_cluster(lib, acc, mask, key, dp), want)
        if k1 <= 4:
            out["checks"][f"generic_k{k1}"] = words_differing(run_generic(acc, mask, key, dp),
                                                               want)
    bad = {k: v for k, v in out["checks"].items() if v}
    if bad:
        print(json.dumps(out))
        raise SystemExit(f"words differ from the plain versions: {bad}")
    del key2

    # K8 at full width
    b, steps = args.batch, args.steps
    key2 = random_key(steps, 2, dp, gen)
    lib8 = kernels.load()["blind_rotate_extended"]
    for e in FACTORS:
        mask = torch.from_numpy(rng.integers(0, 2 * N_POLY * e, (b, steps))).cuda()
        acc = random_words((b, e, 2, N_POLY), rng)
        row = {f"sb{sb}": ms(lambda: run_k8(acc, mask, key2, dp, sb)) for sb in slot_choices(e)}
        row["sb1_one_copy"] = ms(lambda: run_k8(acc, mask, key2, dp, 1, one))
        row["sb1_one_copy_again"] = ms(lambda: run_k8(acc, mask, key2, dp, 1, one))
        row["sb1_again"] = ms(lambda: run_k8(acc, mask, key2, dp, 1))
        row["generic"] = ms(lambda: run_k8(acc, mask, key2, dp, None))
        row["chosen"] = f"sb{kernels.extended_slots(e, b)}"
        log_e = e.bit_length() - 1
        row["active_clusters"] = {
            f"sb{sb}": lib8.tfhe_torch_blind_rotate_extended_lazy_clusters(log_e, sb)
            for sb in slot_choices(e)}
        row["active_clusters"]["sb1_one_copy"] = (
            one.tfhe_torch_blind_rotate_extended_lazy_clusters(log_e, 1))
        row["active_clusters"]["generic"] = lib8.tfhe_torch_blind_rotate_extended_clusters(
            log_e, kernels.exact_smem_bytes(2, N_POLY, LEVELS))
        out["k8"][e] = row
        print(json.dumps({"k8": {e: row}}), flush=True)
    del key2
    torch.cuda.empty_cache()

    # the CM rotation at full width
    for k1 in CM_K1:
        key = random_key(steps, k1, dp, gen)
        mask = torch.from_numpy(rng.integers(0, 2 * N_POLY, (b, steps))).cuda()
        acc = random_words((b, k1, N_POLY), rng)
        row = {f"cluster_mb{m}": ms(lambda: run_cluster(lib, acc, mask, key, dp))
               for m, lib in clusters.items()}
        row["active_clusters"] = {f"mb{m}": lib.tfhe_torch_blind_rotate_cluster_occupancy(
            k1, N_POLY.bit_length() - 1, LEVELS) for m, lib in clusters.items()}
        if k1 <= 4:
            row["generic"] = ms(lambda: run_generic(acc, mask, key, dp))
        out["cm"][k1] = row
        print(json.dumps({"cm": {k1: row}}), flush=True)
        del key
        torch.cuda.empty_cache()

    text = json.dumps(out)
    (ROOT / "build" / "rotation_probe.json").write_text(text + "\n")
    print(text)


if __name__ == "__main__":
    main()
