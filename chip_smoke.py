#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (tfhe_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed S]

From the root of a checkout, on a machine with one CUDA card and nvcc
(/usr/local/cuda/bin is searched too).  Phases, one JSON line each:

  1. the card (nvidia-smi name and power limit) and the torch, CUDA and nvcc
     versions;
  2. build the hand-written kernels from tfhe_tpu_torch/csrc/ (nvcc, sm_90a);
  3. keygen at V1_4_PARAM_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128 (floored
     BSK, so the server key runs the v7 blind rotation) and key upload;
  4. serve: three rounds of ServerKey.apply_lookup_table_batch at B = 512
     with LUT (3x+1) % 16, then one chained round on the device-resident
     outputs; every output is decrypted and checked;
  5. each kernel against its plain PyTorch version, bit-exact: K1 keyswitch
     and K2 blind rotation (v7 mode) on the main path's own B = 512 inputs,
     K2 at B = 4 over the full n = 918 in v7 and in exact mode, for the 2_2
     shape (k + 1 = 2, l = 1: K2's specialised instance) and for k + 1 = 2,
     l = 2 on a random key (its generic instance); times of the kernel, the
     plain version and, for K1, the int8-limb torch._int_mm formulation the
     TPU uses (a yardstick the port never calls);
  6. the launch counts of phase 4 and one {"kernels": [...]} line.

Every torus comparison is exact (tolerance 0): all arithmetic on the path
is integer.  Any failure raises and exits non-zero; the last line
{"ok": true, "device": {...}} is printed only when every phase passed.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet): HBM 3.35 TB/s, int8 tensor cores
# 1979 TOP/s.  32-bit integer multiply-add on the CUDA cores: 64 per clock
# per SM (CUDA C++ programming guide, throughput table, compute capability
# 9.0) x 132 SMs x 1.98 GHz boost, half the data sheet's 67 TFLOP/s fp32
# rate counted in multiply-adds.
HBM_BYTES_PER_S = 3.35e12
INT8_TC_OPS_PER_S = 1979e12
INT32_MUL_PER_S = 64 * 132 * 1.98e9

BATCH = 512
ROUNDS = 3
K2_CHECK_BATCH = 4
K2_GENERIC_LEVELS = 2     # l != 1 takes K2's generic (run-time shape) instance
# CRT primes the blind rotation needs on this key: tfhe_tpu's v7 kernel runs
# three on the 2^15-rounded key (tfhe_tpu/ops/mxu.py:253), the exact
# rotation four.  K2 runs four in both modes; the bound counts what the
# function needs.
V7_PRIMES = 3
EXACT_PRIMES = 4
# tfhe_tpu's MXU four-step split N = N1 * N2 (tfhe_tpu/ops/mxu.py:8)
FOUR_STEP_N1 = 128


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def nvcc_version(kernels) -> str:
    out = subprocess.run(kernels.nvcc_command()[:1] + ["--version"],
                         capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[-1]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() over reps launches, after one warm-up."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(got, want) -> int:
    """Largest |got - want| of int64 torus words (the wrapped difference)."""
    return int((got - want).abs().max().item())


def int_mm_keyswitch(ct, ksk, base_log: int, levels: int):
    """The TPU's keyswitch formulation (tfhe_tpu/ops/server.py:157): the
    signed digits times 10 seven-bit limbs of the key, each an int8 GEMM
    (torch._int_mm), recombined mod 2^64.  A library yardstick for K1."""
    import torch
    from tfhe_tpu_torch.ops import server

    b = ct.shape[0]
    n_in, lev, m_out = ksk.shape
    digits = server.signed_decompose(ct[:, :-1], base_log, levels)
    d8 = digits.permute(1, 2, 0).reshape(b, -1).to(torch.int8)
    key = ksk.reshape(-1, m_out)
    pad = (-m_out) % 8
    acc = torch.zeros((b, m_out), dtype=torch.int64, device=ct.device)
    for e in range(10):
        limb = ((key >> (7 * e)) & 127).to(torch.int8)
        limb = torch.nn.functional.pad(limb, (0, pad))
        acc += torch._int_mm(d8, limb)[:, :m_out].to(torch.int64) << (7 * e)
    out = -acc
    out[:, -1] += ct[:, -1]
    return out


def k1_bound(ct, ksk, out) -> tuple:
    """Least time for the keyswitch: every input byte read once and the
    output written once, against the multiply-adds done as 8 byte limbs of
    each key word on the int8 tensor cores."""
    nbytes = 8 * (ct.numel() + ksk.numel() + out.numel())
    n_in, levels, m_out = ksk.shape
    macs = ct.shape[0] * n_in * levels * m_out
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 2 * 8 * macs / INT8_TC_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def k2_bound(mask, lut, levels: int, base_log: int, nprimes: int) -> dict:
    """Least time for the blind rotation with nprimes CRT primes: the key
    (NTT domain, u32 residues), mask, body, LUT and output moved once,
    against the cheaper of two ways to do its products.

    ntt: radix-2 NTTs, pointwise products and Garner, each a Montgomery
    product of 32-bit residues (three 32-bit multiplies) on the CUDA cores'
    integer rate; N^-1 is taken as folded into the key, so no pass of its own.
    four_step: tfhe_tpu's MXU formulation (tfhe_tpu/ops/mxu.py:1-18), dense
    N1 x N1 stage-1 DFTs and the key's collapsed N2 x N2 middle maps as
    byte-limb int8 products on the tensor cores, ceil(base_log / 8) bytes a
    digit and 4 bytes a residue."""
    b, n_steps = mask.shape
    k1, n_poly = lut.shape[1], lut.shape[2]
    log_n = n_poly.bit_length() - 1
    butterflies = (n_poly // 2) * log_n
    modmuls = (levels * k1 * nprimes * butterflies           # forward NTTs
               + levels * k1 * k1 * nprimes * n_poly          # pointwise MACs
               + k1 * nprimes * butterflies                   # inverse NTTs
               + k1 * n_poly * nprimes * (nprimes - 1) // 2)  # Garner
    t_ntt = b * n_steps * 3 * modmuls / INT32_MUL_PER_S
    n1 = FOUR_STEP_N1
    n2 = n_poly // n1
    digit_bytes = -(-base_log // 8)
    limb_macs = nprimes * (levels * k1 * n2 * n1 * n1 * 4 * digit_bytes  # stage 1
                           + n1 * levels * k1 * n2 * k1 * n2 * 16        # middle
                           + k1 * n2 * n1 * n1 * 16)                     # inverse
    t_four_step = b * n_steps * 2 * limb_macs / INT8_TC_OPS_PER_S
    key_bytes = 4 * n_steps * levels * k1 * k1 * nprimes * n_poly
    t_bytes = (key_bytes + 4 * mask.numel() + 8 * b
               + 2 * 8 * lut.numel()) / HBM_BYTES_PER_S
    t_ops = min(t_ntt, t_four_step)
    return {"ms": max(t_bytes, t_ops) * 1e3,
            "by": "bytes" if t_bytes >= t_ops else "operations",
            "ntt_ms": t_ntt * 1e3, "four_step_ms": t_four_step * 1e3,
            "bytes_ms": t_bytes * 1e3}


def kernel_ms_by_name(prof, names) -> dict:
    """Mean device milliseconds per launch of each named kernel in a
    torch.profiler trace (None where the trace shows no device time)."""
    out = {n: None for n in names}
    for evt in prof.key_averages():
        for n in names:
            if n in evt.key and evt.count:
                total = getattr(evt, "device_time_total",
                                getattr(evt, "cuda_time_total", 0))
                if total:
                    out[n] = total / evt.count / 1e3
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=20261016)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; this "
                 "script runs only on a CUDA card")

    from tfhe_tpu_torch.core import keygen as kg
    from tfhe_tpu_torch.ops import kernels, server, torus
    from tfhe_tpu_torch.shortint import (
        V1_4_PARAM_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128 as PARAMS,
        ClientKey, ServerKey)

    dev = torch.device("cuda")
    card = gpu_line()

    # 1. the card and the toolchain
    emit({"phase": "device", "gpu": card,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "nvcc": nvcc_version(kernels),
          "python": sys.version.split()[0]})

    # 2. build both kernels (one nvcc per source, started together)
    t0 = time.perf_counter()
    kernels.load()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "sources": kernels.source_paths()})

    # 3. keygen and key upload
    p = PARAMS
    t0 = time.perf_counter()
    ck = ClientKey(p, seed=args.seed)
    sk = ServerKey(ck, seed=args.seed + 1, device="cuda")
    torch.cuda.synchronize()
    keygen_s = time.perf_counter() - t0
    if not sk.trunc_acc:
        raise RuntimeError("the production 2_2 key did not select v7 mode")
    emit({"phase": "keygen", "params": "V1_4_PARAM_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128",
          "n": p.lwe_dimension, "N": p.polynomial_size, "k": p.glwe_dimension,
          "pbs_level": p.pbs_level, "pbs_base_log": p.pbs_base_log,
          "ks_level": p.ks_level, "ks_base_log": p.ks_base_log,
          "bsk_floored": sk._bsk_floored, "v7_mode": sk.trunc_acc,
          "seconds": keygen_s,
          "device_key_bytes": sk.ksk.numel() * 8 + sk.bsk_ntt.numel() * 4})

    # 4. serve: ROUNDS batched rounds, then one chained round
    rng = np.random.default_rng(args.seed)
    msg = p.message_modulus
    inputs = [rng.integers(0, msg, BATCH) for _ in range(ROUNDS)]
    cts = [[ck.encrypt(int(v)) for v in vals] for vals in inputs]
    lut = sk.generate_lookup_table(lambda x: (3 * x + 1) % 16)
    lut_msg = sk.generate_msg_lookup_table(lambda x: x)
    kernels.keyswitch.launches = 0
    kernels.blind_rotate.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    round_s, outs = [], []
    for r in range(ROUNDS):
        t1 = time.perf_counter()
        outs.append(sk.apply_lookup_table_batch(cts[r], lut))
        torch.cuda.synchronize()
        round_s.append(time.perf_counter() - t1)
    serve_s = time.perf_counter() - t0
    # chained round: the last round's outputs plus 5 (a linear op that stays
    # lazy), message extracted; the batch is gathered on the device from the
    # resident outputs.  It runs under the profiler, which splits it into
    # kernel times (the timed rounds above run without it).
    shifted = [sk.unchecked_scalar_add(ct, 5) for ct in outs[-1]]
    trace = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA])
    with trace:
        t1 = time.perf_counter()
        chained = sk.apply_lookup_table_batch(shifted, lut_msg)
        torch.cuda.synchronize()
        chained_s = time.perf_counter() - t1
    launches = {"keyswitch": kernels.keyswitch.launches,
                "blind_rotate": kernels.blind_rotate.launches}
    wrong = 0
    for r in range(ROUNDS):
        for ct, v in zip(outs[r], inputs[r]):
            wrong += ck.decrypt_raw(ct) != (3 * int(v) + 1) % 16
    for i, ct in enumerate(chained):
        want = ((3 * int(inputs[-1][i]) + 1) % 16 + 5) % msg
        wrong += ck.decrypt(ct) != want
    per_launch = kernel_ms_by_name(trace, ("keyswitch_kernel",
                                           "blind_rotate_kernel"))
    emit({"phase": "serve", "batch": BATCH, "rounds": ROUNDS,
          "round_seconds": round_s, "pbs_per_s": ROUNDS * BATCH / serve_s,
          "pbs_per_s_after_first": (ROUNDS - 1) * BATCH / sum(round_s[1:]),
          "chained_round_seconds_traced": chained_s,
          "k1_ms_traced_round": per_launch["keyswitch_kernel"],
          "k2_ms_traced_round": per_launch["blind_rotate_kernel"],
          "outputs_checked": (ROUNDS + 1) * BATCH, "wrong": wrong})
    if wrong:
        raise RuntimeError(f"{wrong} outputs decrypted wrong")

    # 5. kernels against their plain versions
    # K1 on round 0's own input batch
    ct0 = torus.from_u64(np.stack([np.asarray(c.data) for c in cts[0]]), dev)
    ks_args = (ct0, sk.ksk, p.ks_base_log, p.ks_level)
    k1_got = kernels.keyswitch(*ks_args)
    k1_want = server.keyswitch(*ks_args)
    k1_lib = int_mm_keyswitch(*ks_args)
    torch.cuda.synchronize()
    k1_err = max_abs_err(k1_got, k1_want)
    k1_lib_err = max_abs_err(k1_lib, k1_want)
    k1_ms = cuda_ms(lambda: kernels.keyswitch(*ks_args), 10)
    k1_plain_ms = cuda_ms(lambda: server.keyswitch(*ks_args), 3)
    k1_lib_ms = cuda_ms(lambda: int_mm_keyswitch(*ks_args), 10)
    k1_bound_ms, k1_bound_by = k1_bound(ct0, sk.ksk, k1_got)

    # K2 (v7 mode) on round 0's own switched inputs
    log_mod = p.polynomial_size.bit_length()
    body = k1_want[:, -1] + server.centered_binary_ms_correction(k1_want, log_mod)
    mask = server.modulus_switch(k1_want[:, :-1], log_mod)
    body = server.modulus_switch(body, log_mod)
    lut_b = torus.from_u64(lut.acc, dev).expand(BATCH, -1, -1)
    br_args = (mask, body, lut_b, sk.bsk_ntt, sk.dp, p.pbs_base_log,
               p.pbs_level, True)
    k2_got = kernels.blind_rotate(*br_args)
    t0 = time.perf_counter()
    k2_want = server.blind_rotate(*br_args)
    torch.cuda.synchronize()
    k2_plain_ms = (time.perf_counter() - t0) * 1e3
    k2_err = max_abs_err(k2_got, k2_want)
    k2_ms = cuda_ms(lambda: kernels.blind_rotate(*br_args), 3)
    k2_bound_v7 = k2_bound(mask, lut_b, p.pbs_level, p.pbs_base_log, V7_PRIMES)
    k2_bound_exact = k2_bound(mask, lut_b, p.pbs_level, p.pbs_base_log,
                              EXACT_PRIMES)

    # K2 at B = 4, full n, random inputs, in both modes
    bsk_exact = torch.from_numpy(
        kg.bootstrap_key_to_ntt(sk._bsk_coeff)[0].view(np.int32)).to(dev)
    n_poly = p.polynomial_size
    chk = np.random.default_rng(args.seed + 2)
    m4 = torch.from_numpy(chk.integers(0, 2 * n_poly, (K2_CHECK_BATCH, p.lwe_dimension))).to(dev)
    b4 = torch.from_numpy(chk.integers(0, 2 * n_poly, (K2_CHECK_BATCH,))).to(dev)
    l4 = torus.from_u64(chk.integers(0, 1 << 64, (K2_CHECK_BATCH, p.glwe_dimension + 1, n_poly),
                                     dtype=np.uint64), dev)
    k2_exact_ms = cuda_ms(lambda: kernels.blind_rotate(
        mask, body, lut_b, bsk_exact, sk.dp, p.pbs_base_log, p.pbs_level, False), 3)
    # a random NTT-domain key (residues below each prime) at l = 2
    gen = torch.Generator(device=dev).manual_seed(args.seed + 3)
    shape = (p.lwe_dimension, K2_GENERIC_LEVELS, p.glwe_dimension + 1,
             p.glwe_dimension + 1)
    bsk_generic = torch.stack(
        [torch.randint(0, q, shape + (n_poly,), generator=gen, device=dev)
         for q in sk.dp.plan.primes], dim=-2).to(torch.int32)
    small_err = {}
    for mode, key, levels, trunc in (
            ("v7", sk.bsk_ntt, p.pbs_level, True),
            ("exact", bsk_exact, p.pbs_level, False),
            ("generic_v7", bsk_generic, K2_GENERIC_LEVELS, True),
            ("generic_exact", bsk_generic, K2_GENERIC_LEVELS, False)):
        a = (m4, b4, l4, key, sk.dp, p.pbs_base_log, levels, trunc)
        got, want = kernels.blind_rotate(*a), server.blind_rotate(*a)
        torch.cuda.synchronize()
        small_err[mode] = max_abs_err(got, want)
    del bsk_generic
    emit({"phase": "kernels_vs_plain", "tolerance": 0,
          "k1_max_abs_err": k1_err, "k1_int_mm_max_abs_err": k1_lib_err,
          "k2_v7_b512_max_abs_err": k2_err,
          **{f"k2_{mode}_b4_max_abs_err": err
             for mode, err in small_err.items()},
          "k2_generic_levels": K2_GENERIC_LEVELS})
    if k1_err or k1_lib_err or k2_err or any(small_err.values()):
        raise RuntimeError("a kernel disagrees with its plain version")

    # 6. launches of the main path (phase 4) and the kernel table
    if not (launches["keyswitch"] and launches["blind_rotate"]):
        raise RuntimeError(f"the main path skipped a kernel: {launches}")
    emit({"phase": "launches", **launches, "rounds": ROUNDS + 1})
    print(card, flush=True)
    emit({"kernels": [
        {"name": "keyswitch", "route": "cuda",
         "source": "tfhe_tpu_torch/csrc/keyswitch.cu",
         "replaces": "tfhe_tpu/ops/server.py:84",
         "launches": launches["keyswitch"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound_ms,
         "bound_by": k1_bound_by, "library_ms": k1_lib_ms,
         "library_call": "10 int8-limb torch._int_mm GEMMs (the TPU's formulation)",
         "shape": [BATCH, p.big_lwe_dimension, p.ks_level, p.lwe_dimension + 1]},
        {"name": "blind_rotate", "route": "cuda",
         "source": "tfhe_tpu_torch/csrc/blind_rotate.cu",
         "replaces": "tfhe_tpu/ops/pallas_mxu.py:1289",
         "also_replaces": "tfhe_tpu/ops/pallas_ntt.py:794",
         "launches": launches["blind_rotate"],
         "max_abs_err": max(k2_err, *small_err.values()),
         "ms": k2_ms, "exact_mode_ms": k2_exact_ms, "plain_ms": k2_plain_ms,
         "bound_ms": k2_bound_v7["ms"], "bound_by": k2_bound_v7["by"],
         "library_ms": None,
         "bound_primes": V7_PRIMES,
         "bound_ntt_int32_ms": k2_bound_v7["ntt_ms"],
         "bound_four_step_int8_ms": k2_bound_v7["four_step_ms"],
         "bound_bytes_ms": k2_bound_v7["bytes_ms"],
         "exact_mode_bound_ms": k2_bound_exact["ms"],
         "exact_mode_bound_by": k2_bound_exact["by"],
         "shape": [BATCH, p.lwe_dimension, p.glwe_dimension + 1,
                   p.polynomial_size]},
    ]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
