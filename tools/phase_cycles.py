#!/usr/bin/env python3
"""Cycles by phase of K5 (csrc/blind_rotate128.cu), K3's exact kernels
(csrc/blind_rotate_multibit.cu, csrc/blind_rotate_multibit_cluster.cu) and
K2's exact kernels (csrc/blind_rotate.cu, csrc/blind_rotate_cluster.cu) on
one CUDA card.

    python3 tools/phase_cycles.py [checks] [step] [k5] [k3x] [k3c] [k2x] [cmux] [k9] [nophase]

From the root of a checkout.  For each kernel it times the real library
(CUDA events, a head of the production shape's steps or groups on a
random key, scaled to the full rotation), then builds into
build/phase_cycles/ a copy of the kernel's source whose __syncthreads()
has block 0, thread 0 add the clock64() cycles before and after each
barrier into a table by source line, runs it once and prints the work
and the wait a step (a group) at each barrier: a phase is the code that
ends at that barrier.  ``checks`` first holds both kernels against their
plain versions at their production, TEST and generic shapes; ``step``
times K2's step entry (kernels.cmux_step) at B = 512.  ``k2x`` times
and tables K2's exact rotation over 64 steps of the V1_4 2_2 shape (times
also scaled to n = 918) twice, from one library: through
``kernels.blind_rotate`` (the lazy kernel, which the wrapper chooses for
that shape), and through the generic C entry ``tfhe_torch_blind_rotate``
(the generic kernel, the first design at that shape); then at the TEST
shapes (k+1 = 2, N = 512: the rotation, l = 1, base 2^23, 16 steps, at
B = 4 and 128; the low-bit chain of vertical packing, l = 4, base 2^6, 8
steps, at B = 1 and 64) through the generic C entry and, where
``kernels.cluster_shape`` takes the shape, the cluster C entry
``tfhe_torch_blind_rotate_cluster``, each held against
``server.rotate_accumulator`` and tabled from instrumented copies of both
sources (the small-N kernel's copy with a block barrier on each side of
each cluster barrier, so that each cluster barrier's wait is a row of its
own); at 1_1's shape (k+1 = 5, N = 512, l = 1, base 2^23, 16 steps, B = 4
and 32) the same two entries.  ``k3c`` does the same for K3's exact
rotation at the GPU multi-bit shapes (GROUP_2: k+1 = 2, N = 4096, l = 1,
g = 2, base 2^21, 459 groups; GROUP_3: N = 2048, l = 2, g = 3, base 2^14,
293 groups; whole rotations on random keys at B = 4 and 32): the generic C
entry ``tfhe_torch_blind_rotate_multibit`` and the cluster C entry
``tfhe_torch_blind_rotate_multibit_cluster`` in turns, each held against
``server.blind_rotate_multibit`` at B = 2, the wrapper's route and host
milliseconds a launch, ``kernels.multibit_cluster_figures``, and both
phase tables a group at B = 4 (the cluster kernel's copy marked as the
small-N kernel's is).  ``cmux`` does the same for K2's CMux entry
(kernels.cmux, out = ct0 + GGSW (x) (ct1 - ct0)) at CMUX_SHAPES on random
GGSWs and operands: WoPBS's tree (k+1 = 2, N = 512, l = 4, base 2^6) at
B = 1 and 64 and the common-mask CMux at C = 3 (k+1 = 4, N = 2048, l = 1,
base 2^23) at B = 64: the generic C entry ``tfhe_torch_cmux`` (the first
design, cmux_kernel) and, where the library has it and ``kernels.cmux_route``
says so, the cluster C entry ``tfhe_torch_cmux_cluster``, each held
against ``server.cmux``, timed in turns (CUDA events and CUDA graphs), the
wrapper's route, time and host ms a call, and each kernel's phase table
(one step).  ``k9`` does the same for K9's fused entry
(kernels.poly_shard_rotate, csrc/poly_shard.cu ps_rotate_kernel: the
whole poly-sharded rotation in one launch) at the 2_2 widths (k+1 = 2,
N = 2048, l = 1, base 2^23) on random keys of 918 steps at K9_SHAPES (D,
B): its plan, its first 16 steps held against the plain step loop
(four_step.rotate_steps), the whole rotation's time (CUDA events over 3
launches) and its phase table a step from a copy of the source whose
fused kernel has a block barrier on each side of each cluster barrier
(block 0 is slot 0's first prime).  Writes build/phase_cycles/phase.json.
"""
import ctypes
import json
import re
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from tfhe_tpu_torch.ops import kernels, ntt, torus, server  # noqa: E402
from tfhe_tpu_torch.utils.build import CSRC  # noqa: E402

HERE = ROOT / "build" / "phase_cycles"
SLOTS = 20000
FUNCS = ["tfhe_torch_blind_rotate", "tfhe_torch_blind_rotate_smem_bytes",
         "tfhe_torch_blind_rotate_multibit_cluster",
         "tfhe_torch_blind_rotate_exact_lazy", "tfhe_torch_blind_rotate_exact_cts_per_block",
         "tfhe_torch_blind_rotate_exact_lazy_shape",
         "tfhe_torch_blind_rotate128", "tfhe_torch_blind_rotate128_smem_bytes",
         "tfhe_torch_blind_rotate_multibit", "tfhe_torch_blind_rotate_multibit_smem_bytes",
         "tfhe_torch_blind_rotate_multibit_cts_per_block", "tfhe_torch_blind_rotate_cluster",
         "tfhe_torch_cmux", "tfhe_torch_cmux_cluster", "tfhe_torch_poly_shard_rotate",
         "tfhe_torch_poly_shard_rotate_plan"]
B = 512


HARNESS = r"""// Phase-cycle harness: block 0, thread 0 adds clock64() deltas before and
// after every barrier into arrays indexed by (file tag, line).
#include <cuda_runtime.h>
#define PH_SLOTS 20000
__device__ unsigned long long ph_work[PH_SLOTS];
__device__ unsigned long long ph_wait[PH_SLOTS];
__device__ unsigned long long ph_cnt[PH_SLOTS];
__device__ long long ph_last;
__host__ __device__ constexpr int ph_tag(const char* f, int i = 0) {
  return f[i] == 0 ? 0
         : (f[i] == '.' && f[i + 1] == 'c' && f[i + 2] == 'u' && f[i + 3] == 'h') ? 10000
                                                                                   : ph_tag(f, i + 1);
}
__device__ __forceinline__ void ph_sync(int slot) {
  const bool me = blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0 && threadIdx.x == 0;
  long long t0 = 0;
  if (me) t0 = clock64();
  asm volatile("bar.sync 0;" ::: "memory");
  if (me) {
    const long long t1 = clock64();
    if (ph_last != 0) {
      ph_work[slot] += (unsigned long long)(t0 - ph_last);
      ph_wait[slot] += (unsigned long long)(t1 - t0);
      ph_cnt[slot] += 1;
    }
    ph_last = t1;
  }
}
#define __syncthreads() ph_sync(__LINE__ + ph_tag(__FILE__))
"""

WRAPPER = r"""#include "harness.cuh"
#include "{source}"
extern "C" int ph_read(unsigned long long* out) {
  cudaDeviceSynchronize();
  cudaMemcpyFromSymbol(out, ph_work, sizeof(unsigned long long) * PH_SLOTS);
  cudaMemcpyFromSymbol(out + PH_SLOTS, ph_wait, sizeof(unsigned long long) * PH_SLOTS);
  cudaMemcpyFromSymbol(out + 2 * PH_SLOTS, ph_cnt, sizeof(unsigned long long) * PH_SLOTS);
  return (int)cudaGetLastError();
}
extern "C" int ph_reset() {
  static unsigned long long z[PH_SLOTS] = {0};
  long long zl = 0;
  cudaMemcpyToSymbol(ph_work, z, sizeof z);
  cudaMemcpyToSymbol(ph_wait, z, sizeof z);
  cudaMemcpyToSymbol(ph_cnt, z, sizeof z);
  cudaMemcpyToSymbol(ph_last, &zl, sizeof zl);
  return (int)cudaDeviceSynchronize();
}
"""


def marked_cluster_source(name="blind_rotate_cluster", first="blind_rotate_cluster_kernel(",
                          last="struct Operands {",
                          barrier=r"cluster\.sync\(\);(?=   //)") -> pathlib.Path:
    """A copy of csrc/<name>.cu whose kernels (the text from first to last:
    K2's cluster and small-N kernels, or K3's cluster kernel) have a block barrier on
    each side of each cluster barrier, so that the table shows the last
    inverse pass, each cluster barrier's wait and Garner apart (the extra
    barriers cost a few hundred cycles a step)."""
    text = (CSRC / f"{name}.cu").read_text()
    if first not in text:
        return CSRC / f"{name}.cu"
    start = text.index(first)
    end = text.index(last)
    body = re.sub(r"\n( *)(" + barrier + ")", r"\n\1__syncthreads();\n\1\2\n\1__syncthreads();",
                  text[start:end])
    out = HERE / f"{name}_marked.cu"
    out.write_text(text[:start] + body + text[end:])
    return out


def variant_source(name, old, new) -> pathlib.Path:
    """A copy of csrc/<name>.cu with one line changed (a design variant
    timed beside the shipped kernel; the shipped source has no switch)."""
    text = (CSRC / f"{name}.cu").read_text()
    assert old in text, old
    out = HERE / f"{name}_variant.cu"
    out.write_text(text.replace(old, new))
    return out


def write_sources(names):
    """The harness header and one wrapper a kernel source named in names,
    in HERE."""
    HERE.mkdir(parents=True, exist_ok=True)
    (HERE / "harness.cuh").write_text(HARNESS)
    sources = {"h_k5": lambda: CSRC / "blind_rotate128.cu",
               "h_k3": lambda: CSRC / "blind_rotate_multibit.cu",
               "h_k2": lambda: CSRC / "blind_rotate.cu", "h_kc": marked_cluster_source,
               "h_k3c": lambda: marked_cluster_source(
                   "blind_rotate_multibit_cluster", "blind_rotate_multibit_cluster_kernel(",
                   "cudaError_t mc_launch("),
               "h_k1": lambda: CSRC / "keyswitch.cu",
               "v_k7m3": lambda: variant_source("glwe_keyswitch",
                                                "constexpr int GC_MIN_BLOCKS = 4;",
                                                "constexpr int GC_MIN_BLOCKS = 3;"),
               "h_k7": lambda: marked_cluster_source(
                   "glwe_keyswitch", "glwe_keyswitch_cluster_kernel(",
                   "cudaError_t gk_cluster_launch("),
               "h_k9": lambda: marked_cluster_source(
                   "poly_shard", "ps_rotate_kernel(const RotateArgs g)",
                   "// The fused kernel's attributes", r"cluster_barrier\(global\);")}
    for name in names:
        src = str(sources[name]())
        (HERE / f"{name}.cu").write_text(WRAPPER.replace("{source}", src) if name.startswith("h_")
                                         else f'#include "{src}"\n')


def build(names):
    write_sources(names)
    cmd = kernels.nvcc_command() + ["-Xptxas", "-v", "-I", str(CSRC)]
    procs = [(n, subprocess.Popen(cmd + ["-o", str(HERE / f"lib{n}.so"), str(HERE / f"{n}.cu")],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
             for n in names]
    libs = {}
    for n, p in procs:
        log, _ = p.communicate()
        print(f"== {n} rc={p.returncode}\n" + "\n".join(
            l for l in log.splitlines() if "registers" in l or "spill" in l or "error" in l
            or "Compiling entry" in l)[-3000:], flush=True)
        if p.returncode:
            print(log[-5000:])
            raise SystemExit(1)
        libs[n] = ctypes.CDLL(str(HERE / f"lib{n}.so"))
    return libs


def swap(name, lib):
    orig = kernels.load()[name]
    for f in FUNCS:
        if hasattr(orig, f) and hasattr(lib, f):
            getattr(lib, f).argtypes = getattr(orig, f).argtypes
            getattr(lib, f).restype = getattr(orig, f).restype
    kernels._Libs.loaded[name] = lib
    return orig


def src_line(slot, src):
    """The source line of a barrier's slot (10000 and up: ntt_common.cuh)."""
    return f"{'ntt_common.cuh' if slot >= 10000 else src}:{slot % 10000}"


def ms(fn, reps=2):
    fn()
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / reps


def graph_ms(fn, reps=20, replays=5):
    """The device's ms a launch of fn: reps calls captured in one CUDA
    graph, replayed replays times between CUDA events (no host time)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(replays):
        graph.replay()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / (replays * reps)


def phases(lib, fn, src, units):
    lib.ph_reset()
    fn()
    torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * (3 * SLOTS))()
    lib.ph_read(buf)
    a = np.frombuffer(buf, dtype=np.uint64).reshape(3, SLOTS)
    rows = []
    for slot in np.nonzero(a[2])[0]:
        rows.append({"at": src_line(int(slot), src), "count": int(a[2, slot]),
                     "work_per_unit": a[0, slot] / units, "wait_per_unit": a[1, slot] / units})
    rows.sort(key=lambda r: (r["at"].startswith("ntt"), int(r["at"].split(":")[1])))
    tot = sum(r["work_per_unit"] + r["wait_per_unit"] for r in rows)
    wait = sum(r["wait_per_unit"] for r in rows)
    return {"rows": rows, "total_per_unit": tot, "wait_per_unit": wait}


def k5(libs, out, steps=64, check=True):
    gen = torch.Generator(device="cuda").manual_seed(5)
    rng = np.random.default_rng(5)
    n, k1, lev, bl = 2048, 3, 3, 24
    dp = ntt.device_plan(ntt.make_plan(n, 6), "cuda")
    key = torch.stack([torch.randint(0, q, (steps, lev, k1, k1, n), generator=gen, device="cuda")
                       for q in dp.plan.primes], dim=-2).to(torch.int32)
    mask = torch.from_numpy(rng.integers(0, 2 * n, (B, steps))).cuda()
    body = torch.from_numpy(rng.integers(0, 2 * n, (B,))).cuda()
    lo, hi = (torus.from_u64(rng.integers(0, 1 << 64, (B, k1, n), dtype=np.uint64), "cuda")
              for _ in range(2))
    args = (mask, body, lo, hi, key, dp, bl, lev)
    run = lambda: kernels.blind_rotate128(*args)  # noqa: E731
    t = ms(run)
    out["k5"] = {"steps": steps, "ms": t, "ms_scaled_918": t * 918 / steps}
    if check:
        sub = tuple(x[:2] for x in args[:4]) + args[4:]
        g = kernels.blind_rotate128(*sub)
        from tfhe_tpu_torch.ops import server128
        w = server128.blind_rotate128(*sub)
        out["k5"]["err"] = max(int((x - y).abs().max()) for x, y in zip(g, w))
    if "h_k5" in libs:
        swap("blind_rotate128", libs["h_k5"])
        out["k5"]["phases"] = phases(libs["h_k5"], run, "blind_rotate128.cu", steps)
        out["k5"]["ms_instrumented"] = ms(run, 1)


def k3x(libs, out, groups=32, check=True):
    gen = torch.Generator(device="cuda").manual_seed(3)
    rng = np.random.default_rng(3)
    n, k1, lev, bl, g = 2048, 2, 1, 22, 4
    dp = ntt.device_plan(ntt.make_plan(n, 4), "cuda")
    key = torch.stack([torch.randint(0, q, (groups, 1 << g, lev, k1, k1, n), generator=gen,
                                     device="cuda") for q in dp.plan.primes],
                      dim=-2).to(torch.int32)
    raw = torus.from_u64(rng.integers(0, 1 << 64, (B, groups * g), dtype=np.uint64), "cuda")
    deg = server.multibit_switched_degrees(raw, g, 12)
    body = torch.from_numpy(rng.integers(0, 2 * n, (B,))).cuda()
    lut = torus.from_u64(rng.integers(0, 1 << 64, (B, k1, n), dtype=np.uint64), "cuda")
    args = (deg, body, lut, key, dp, bl, lev)
    run = lambda: kernels.blind_rotate_multibit(*args, v9=False)  # noqa: E731
    t = ms(run)
    out["k3x"] = {"groups": groups, "ms": t, "ms_scaled_230": t * 230 / groups}
    if check:
        sub = tuple(x[:3] for x in args[:3]) + args[3:]
        out["k3x"]["err"] = int((kernels.blind_rotate_multibit(*sub, v9=False)
                                 - server.blind_rotate_multibit(*sub)).abs().max())
    if "h_k3" in libs:
        real = swap("blind_rotate_multibit", libs["h_k3"])
        out["k3x"]["phases"] = phases(libs["h_k3"], run, "blind_rotate_multibit.cu", groups)
        out["k3x"]["ms_instrumented"] = ms(run, 1)
        kernels._Libs.loaded["blind_rotate_multibit"] = real


def k2x(libs, out, steps=64):
    """K2's exact rotation at the V1_4 2_2 shape (k+1 = 2, l = 1, N = 2048,
    base_log 23, four primes) on a random key: the wrapper's kernel (the
    lazy kernel) and the generic C entry (the generic kernel), times and
    phase tables."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    rng = np.random.default_rng(2)
    n, k1, lev, bl = 2048, 2, 1, 23
    dp = ntt.device_plan(ntt.make_plan(n, 4), "cuda")
    key = torch.stack([torch.randint(0, q, (steps, lev, k1, k1, n), generator=gen,
                                     device="cuda") for q in dp.plan.primes],
                      dim=-2).to(torch.int32)
    mask = torch.from_numpy(rng.integers(0, 2 * n, (B, steps))).cuda()
    body = torch.from_numpy(rng.integers(0, 2 * n, (B,))).cuda()
    lut = torus.from_u64(rng.integers(0, 1 << 64, (B, k1, n), dtype=np.uint64), "cuda")
    acc0 = server.initial_accumulator(lut, body, False).contiguous()
    mask32 = mask.to(torch.int32).contiguous()

    def generic(lib):
        def run():
            acc = acc0.clone()
            err = lib.tfhe_torch_blind_rotate(
                acc.data_ptr(), mask32.data_ptr(), key.data_ptr(), dp.psi32.data_ptr(),
                dp.psi_inv32.data_ptr(), dp.kernel_consts.data_ptr(), B, steps, k1,
                n.bit_length() - 1, lev, 4, bl, kernels._stream(acc))
            assert err == 0, f"generic K2 launch failed: cudaError {err}"
            return acc
        return run

    run = lambda: kernels.blind_rotate(mask, body, lut, key, dp, bl, lev)  # noqa: E731
    res = {"steps": steps}
    t = ms(run)
    res.update(ms=t, ms_scaled_918=t * 918 / steps)
    t = ms(generic(kernels.load()["blind_rotate"]))
    res.update(generic_ms=t, generic_ms_scaled_918=t * 918 / steps)
    if "h_k2" in libs:
        lib = libs["h_k2"]
        real = swap("blind_rotate", lib)
        res["phases"] = phases(lib, run, "blind_rotate.cu", steps)
        res["ms_instrumented"] = ms(run, 1)
        res["generic_phases"] = phases(lib, generic(lib), "blind_rotate.cu", steps)
        res["generic_ms_instrumented"] = ms(generic(lib), 1)
        kernels._Libs.loaded["blind_rotate"] = real
    out["k2x"] = res
    out["k2x_test"] = k2x_test(libs)


# K2's exact rotation at N = 512, four primes: (tag, k+1, l, base_log,
# steps, batches): the TEST shapes and 1_1's
K2_TEST_SHAPES = (("rotation", 2, 1, 23, 16, (4, 128)), ("chain", 2, 4, 6, 8, (1, 64)),
                  ("rotation_1_1", 5, 1, 23, 16, (4, 32)))


def k2x_test(libs, reps=20):
    """The TEST shapes: for each (shape, B) the generic C entry's and, where
    the cluster kernel takes the shape, the cluster C entry's time (CUDA
    events over reps launches, taken in turns: generic, cluster, cluster,
    generic), words differing from the plain rotation, and both phase
    tables a step."""
    gen = torch.Generator(device="cuda").manual_seed(17)
    rng = np.random.default_rng(17)
    n = 512
    dp = ntt.device_plan(ntt.make_plan(n, 4), "cuda")
    tw_fwd, tw_inv = ntt.shoup_twiddles(dp)
    res = {}
    for tag, k1, lev, bl, steps, batches in K2_TEST_SHAPES:
        key = torch.stack([torch.randint(0, q, (steps, lev, k1, k1, n), generator=gen,
                                         device="cuda") for q in dp.plan.primes],
                          dim=-2).to(torch.int32)
        for b in batches:
            acc0 = torus.from_u64(rng.integers(0, 1 << 64, (b, k1, n), dtype=np.uint64), "cuda")
            mask32 = torch.from_numpy(rng.integers(0, 2 * n, (b, steps))).cuda().to(torch.int32)

            def entry(lib, cluster):
                def run():
                    acc = acc0.clone()
                    if cluster:
                        err = lib.tfhe_torch_blind_rotate_cluster(
                            acc.data_ptr(), mask32.data_ptr(), key.data_ptr(), None, 0,
                            tw_fwd.data_ptr(), tw_inv.data_ptr(), dp.kernel_consts.data_ptr(), b, steps, k1,
                            n.bit_length() - 1, lev, 4, bl, kernels._stream(acc))
                    else:
                        err = lib.tfhe_torch_blind_rotate(
                            acc.data_ptr(), mask32.data_ptr(), key.data_ptr(), dp.psi32.data_ptr(),
                            dp.psi_inv32.data_ptr(), dp.kernel_consts.data_ptr(), b, steps, k1,
                            n.bit_length() - 1, lev, 4, bl, kernels._stream(acc))
                    assert err == 0, f"K2 launch failed ({tag}, cluster {cluster}): cudaError {err}"
                    return acc
                return run

            want = server.rotate_accumulator(acc0, mask32.long(), key, dp, bl, lev)
            runs = {"generic": (entry(kernels.load()["blind_rotate"], False), "h_k2",
                                "blind_rotate.cu")}
            if kernels.cluster_shape(k1, n, lev, bl):
                runs["cluster"] = (entry(kernels.load()["blind_rotate_cluster"], True), "h_kc",
                                   "blind_rotate_cluster.cu")
            row = {"batch": b, "k1": k1, "levels": lev, "base_log": bl, "steps": steps}
            for name, (run, _, _) in runs.items():
                row[f"{name}_err"] = int((run() - want).abs().max())
            order = list(runs) + list(reversed(runs))
            times = {name: [] for name in runs}
            for name in order:
                times[name].append(ms(runs[name][0], reps))
            for name, t in times.items():
                row[f"{name}_ms"] = t
                row[f"{name}_us_per_step"] = min(t) * 1e3 / steps
            for name, (_, hname, src) in runs.items():
                if hname in libs:
                    hlib = libs[hname]
                    real = kernels.load()["blind_rotate_cluster" if name == "cluster"
                                          else "blind_rotate"]
                    for f in FUNCS:
                        if hasattr(real, f) and hasattr(hlib, f):
                            getattr(hlib, f).argtypes = getattr(real, f).argtypes
                            getattr(hlib, f).restype = getattr(real, f).restype
                    fn = entry(hlib, name == "cluster")
                    row[f"{name}_phases"] = phases(
                        hlib, fn, "blind_rotate_cluster_marked.cu" if name == "cluster" else src,
                        steps)
            res[f"{tag}_b{b}"] = row
            print("k2x_test", tag, b, {k: v for k, v in row.items() if not k.endswith("phases")},
                  flush=True)
    return res


# K2's CMux entry: (tag, k+1, N, l, base_log, batches): WoPBS's tree at the
# TEST sets and the common-mask CMux at C = 3 on the 2_2 widths
CMUX_SHAPES = (("test", 2, 512, 4, 6, (1, 64)), ("cm_c3", 4, 2048, 1, 23, (64,)))


def cmux_entries(generic_lib, cluster_lib, ct0, ct1, ggsw, dp, bl, lev):
    """K2's CMux C entries on one input (name -> run): the generic kernel's
    and, where cluster_lib has it and the route is a cluster one, the
    cluster kernels' CMux mode."""
    b, k1, n = ct0.shape
    tw_fwd, tw_inv = ntt.shoup_twiddles(dp)
    shape = (b, k1, n.bit_length() - 1, lev, 4, bl)

    def entry(cluster):
        def run():
            out = torch.empty_like(ct0)
            if cluster:
                err = cluster_lib.tfhe_torch_cmux_cluster(
                    out.data_ptr(), ct0.data_ptr(), ct1.data_ptr(), ggsw.data_ptr(),
                    tw_fwd.data_ptr(), tw_inv.data_ptr(), dp.kernel_consts.data_ptr(), *shape,
                    kernels._stream(ct0))
            else:
                err = generic_lib.tfhe_torch_cmux(
                    out.data_ptr(), ct0.data_ptr(), ct1.data_ptr(), ggsw.data_ptr(),
                    dp.psi32.data_ptr(), dp.psi_inv32.data_ptr(), dp.kernel_consts.data_ptr(),
                    *shape, kernels._stream(ct0))
            assert err == 0, f"K2's CMux entry failed (cluster {cluster}): cudaError {err}"
            return out
        return run

    runs = {"generic": entry(False)}
    if (cluster_lib is not None and hasattr(cluster_lib, "tfhe_torch_cmux_cluster")
            and hasattr(kernels, "cmux_route") and kernels.cmux_route(k1, n, lev, bl) != "generic"):
        runs["cluster"] = entry(True)
    return runs


def cmux(libs, out, reps=20):
    """K2's CMux entry at CMUX_SHAPES (see the module's docstring)."""
    gen = torch.Generator(device="cuda").manual_seed(20)
    rng = np.random.default_rng(20)
    res = {}
    real = kernels.load()
    for tag, k1, n, lev, bl, batches in CMUX_SHAPES:
        dp = ntt.device_plan(ntt.make_plan(n, 4), "cuda")
        ggsw = torch.stack([torch.randint(0, q, (lev, k1, k1, n), generator=gen, device="cuda")
                            for q in dp.plan.primes], dim=-2).to(torch.int32)
        for b in batches:
            ct0, ct1 = (torus.from_u64(rng.integers(0, 1 << 64, (b, k1, n), dtype=np.uint64),
                                       "cuda") for _ in range(2))
            want = server.cmux(ct0, ct1, ggsw, dp, bl, lev)
            runs = cmux_entries(real["blind_rotate"], real["blind_rotate_cluster"], ct0, ct1,
                                ggsw, dp, bl, lev)
            runs["wrapper"] = lambda: kernels.cmux(ct0, ct1, ggsw, dp, bl, lev)  # noqa: B023
            row = {"batch": b, "k1": k1, "N": n, "levels": lev, "base_log": bl}
            if hasattr(kernels, "cmux_route"):
                row["route"] = kernels.cmux_route(k1, n, lev, bl)
                if row["route"] != "generic" and hasattr(kernels, "cmux_figures"):
                    row.update(kernels.cmux_figures(k1, n, lev))
            for name, run in runs.items():
                row[f"{name}_err"] = int((run() - want).abs().max())
            order = list(runs) + list(reversed(runs))
            row["ms"] = {name: [] for name in runs}
            for name in order:
                row["ms"][name].append(ms(runs[name], reps))
            row["graph_ms"] = {name: [] for name in runs}
            for name in order:
                row["graph_ms"][name].append(graph_ms(runs[name]))
            row["host_ms"] = {}
            for name, run in runs.items():      # the host's time to enqueue a call
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(reps):
                    run()
                row["host_ms"][name] = (time.perf_counter() - t0) * 1e3 / reps
                torch.cuda.synchronize()
            hruns = cmux_entries(libs.get("h_k2"), libs.get("h_kc"), ct0, ct1, ggsw, dp, bl, lev)
            for name, hname, src in (("generic", "h_k2", "blind_rotate.cu"),
                                     ("cluster", "h_kc", "blind_rotate_cluster_marked.cu")):
                if hname in libs and name in hruns:
                    hlib = libs[hname]
                    lib = real["blind_rotate_cluster" if name == "cluster" else "blind_rotate"]
                    for f in FUNCS:
                        if hasattr(lib, f) and hasattr(hlib, f):
                            getattr(hlib, f).argtypes = getattr(lib, f).argtypes
                            getattr(hlib, f).restype = getattr(lib, f).restype
                    row[f"{name}_phases"] = phases(hlib, hruns[name], src, 1)
            res[f"{tag}_b{b}"] = row
            print("cmux", tag, b, {k: v for k, v in row.items() if not k.endswith("phases")},
                  flush=True)
        del ggsw
    out["cmux"] = res


# K3's exact rotation at the GPU multi-bit sets: (tag, N, l, g, base_log,
# groups)
K3_GPU_SHAPES = (("gpu_group_2", 4096, 1, 2, 21, 459), ("gpu_group_3", 2048, 2, 3, 14, 293))


def k3c(libs, out, reps=3):
    """K3's exact rotation at K3_GPU_SHAPES on random keys (every group):
    for B = 4 and 32 the generic and the cluster C entries in turns
    (generic, cluster, cluster, generic; CUDA events over reps launches),
    the wrapper's route and its host ms a launch, a check of both entries
    and the wrapper against the plain rotation at B = 2, the cluster
    kernel's figures, and both phase tables a group at B = 4."""
    gen = torch.Generator(device="cuda").manual_seed(18)
    rng = np.random.default_rng(18)
    res = {}
    for tag, n, lev, g, bl, groups in K3_GPU_SHAPES:
        dp = ntt.device_plan(ntt.make_plan(n, 4), "cuda")
        tw_fwd, tw_inv = ntt.shoup_twiddles(dp)
        mono = server.monomial_table(dp)[0]
        key = torch.stack([torch.randint(0, q, (groups, 1 << g, lev, 2, 2, n), generator=gen,
                                         device="cuda") for q in dp.plan.primes],
                          dim=-2).to(torch.int32)
        log_mod = n.bit_length()
        row = {"N": n, "levels": lev, "grouping": g, "base_log": bl, "groups": groups,
               "route": kernels.multibit_exact_route(2, n, lev, g, bl),
               **kernels.multibit_cluster_figures(n, lev, g)}
        for b in (2, 4, 32):
            raw = torus.from_u64(rng.integers(0, 1 << 64, (b, groups * g), dtype=np.uint64),
                                 "cuda")
            deg = server.multibit_switched_degrees(raw, g, log_mod)
            body = torch.from_numpy(rng.integers(0, 2 * n, (b,))).cuda()
            lut = torus.from_u64(rng.integers(0, 1 << 64, (b, 2, n), dtype=np.uint64), "cuda")
            acc0 = server.initial_accumulator(lut, body, False).contiguous()
            deg32 = deg.to(torch.int32).contiguous()

            def entry(lib, cluster):
                def run():
                    acc = acc0.clone()
                    if cluster:
                        err = lib.tfhe_torch_blind_rotate_multibit_cluster(
                            acc.data_ptr(), deg32.data_ptr(), key.data_ptr(), tw_fwd.data_ptr(),
                            tw_inv.data_ptr(), mono.data_ptr(), dp.kernel_consts.data_ptr(), b,
                            groups, g, 2, n.bit_length() - 1, lev, 4, bl, kernels._stream(acc))
                    else:
                        err = lib.tfhe_torch_blind_rotate_multibit(
                            acc.data_ptr(), deg32.data_ptr(), key.data_ptr(), dp.psi32.data_ptr(),
                            dp.psi_inv32.data_ptr(), tw_fwd.data_ptr(), tw_inv.data_ptr(),
                            mono.data_ptr(), dp.kernel_consts.data_ptr(), b, groups, g, 2,
                            n.bit_length() - 1, lev, 4, bl, kernels._stream(acc))
                    assert err == 0, f"K3 launch failed ({tag}, cluster {cluster}): cudaError {err}"
                    return acc
                return run

            runs = {"generic": entry(kernels.load()["blind_rotate_multibit"], False),
                    "cluster": entry(kernels.load()["blind_rotate_multibit_cluster"], True)}
            wrapper = lambda: kernels.blind_rotate_multibit(deg, body, lut, key, dp, bl, lev)  # noqa: E731
            if b == 2:
                want = server.blind_rotate_multibit(deg, body, lut, key, dp, bl, lev)
                for name, run in runs.items():
                    row[f"{name}_err_b2"] = int((run() - want).abs().max())
                before = kernels.blind_rotate_multibit.cluster_launches
                row["wrapper_err_b2"] = int((wrapper() - want).abs().max())
                row["wrapper_cluster_launches"] = (kernels.blind_rotate_multibit.cluster_launches
                                                   - before)
                print("k3c", tag, {k: v for k, v in row.items()}, flush=True)
                continue
            times = {name: [] for name in runs}
            for name in ("generic", "cluster", "cluster", "generic"):
                times[name].append(ms(runs[name], reps))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                wrapper()
            host_ms = (time.perf_counter() - t0) * 1e3 / reps
            torch.cuda.synchronize()
            row[f"b{b}"] = {"generic_ms": times["generic"], "cluster_ms": times["cluster"],
                            "wrapper_host_ms": host_ms,
                            "cluster_us_per_group": min(times["cluster"]) * 1e3 / groups,
                            "generic_us_per_group": min(times["generic"]) * 1e3 / groups}
            print("k3c", tag, b, row[f"b{b}"], flush=True)
            if b == 4:
                for name, hname, src in (("generic", "h_k3", "blind_rotate_multibit.cu"),
                                         ("cluster", "h_k3c",
                                          "blind_rotate_multibit_cluster_marked.cu")):
                    if hname in libs:
                        hlib = libs[hname]
                        real = kernels.load()["blind_rotate_multibit_cluster" if name == "cluster"
                                              else "blind_rotate_multibit"]
                        for f in FUNCS:
                            if hasattr(real, f) and hasattr(hlib, f):
                                getattr(hlib, f).argtypes = getattr(real, f).argtypes
                                getattr(hlib, f).restype = getattr(real, f).restype
                        row[f"{name}_phases"] = phases(hlib, entry(hlib, name == "cluster"), src,
                                                       groups)
        res[tag] = row
        del key
        torch.cuda.empty_cache()
    out["k3c"] = res


# K1 at the wide-digit, small-batch shapes: (tag, B, n_in, l, base_log,
# m_out): the WoPBS PFPKS (TEST_WOPBS_PARAM: n_in = k N + 1 = 513 with the
# appended zero, 2048 = (k+1)^2 N columns) and the compact list's cast to
# the big key (V1_4 PKE 2048 -> big 2048, base 2^24, one level)
K1_WIDE_SHAPES = (("pfpks", 40, 513, 2, 20, 2048), ("cast_big", 32, 2048, 1, 24, 2049))


def k1_entries(lib, ct, ksk, limbs, bl, lev):
    """K1's C entries on one input: the generic kernel and, where the
    library has it and takes the shape, the limb-row kernel at each split
    count (splits -> run)."""
    b, m_out = ct.shape[0], ksk.shape[2]
    n_in = ksk.shape[0]

    def generic():
        out = torch.empty((b, m_out), dtype=torch.int64, device="cuda")
        err = lib.tfhe_torch_keyswitch(out.data_ptr(), ct.data_ptr(), ksk.data_ptr(), b, n_in,
                                       lev, m_out, bl, kernels._stream(ct))
        assert err == 0, f"K1's generic kernel failed: cudaError {err}"
        return out

    runs = {"generic": generic}
    if limbs is None or not hasattr(lib, "tfhe_torch_keyswitch_limbs"):
        return runs
    lib.tfhe_torch_keyswitch_limbs.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [
        ctypes.c_void_p]
    n_chunks, key_cols = limbs.shape[0], limbs.shape[1]
    rows = kernels.limb_rows(b, kernels.keyswitch_limb_count(n_in, lev, bl))

    def limb(splits):
        def run():
            out = torch.empty((b, m_out), dtype=torch.int64, device="cuda")
            digits = torch.empty((rows, n_chunks, limbs.shape[2]), dtype=torch.int8,
                                 device="cuda")
            err = lib.tfhe_torch_keyswitch_limbs(out.data_ptr(), ct.data_ptr(), limbs.data_ptr(),
                                                 digits.data_ptr(), b, n_in, lev, m_out, bl,
                                                 n_chunks, key_cols, splits, kernels._stream(ct))
            assert err == 0, f"K1's limb-row kernel failed: cudaError {err}"
            return out
        return run

    for splits in sorted({1, 2, 3, 5, 9, kernels.keyswitch_limb_splits(
            key_cols // kernels.IM_BN * rows // kernels.IM_BM, n_chunks,
            kernels.sm_count(ct.device))}):
        if splits <= n_chunks:
            runs[f"limbs_s{splits}"] = limb(splits)
    return runs


def k1g(libs, out, reps=20):
    """K1 at K1_WIDE_SHAPES on random words: each C entry (k1_entries) held
    against server.keyswitch and timed in turns (CUDA events over reps
    launches), the wrapper's time and host ms a launch, and the phase table
    of each kernel's block (0, 0, 0) a chunk, from an instrumented copy of
    csrc/keyswitch.cu."""
    rng = np.random.default_rng(19)
    res = {}
    for tag, b, n_in, lev, bl, m_out in K1_WIDE_SHAPES:
        ct = torus.from_u64(rng.integers(0, 1 << 64, (b, n_in + 1), dtype=np.uint64), "cuda")
        ksk = torus.from_u64(rng.integers(0, 1 << 64, (n_in, lev, m_out), dtype=np.uint64),
                             "cuda")
        key = kernels.keyswitch_key(ksk, bl, lev)
        limbs = key.limbs if isinstance(key, kernels.KeyswitchKeyLimbs) else None
        want = server.keyswitch(ct, ksk, bl, lev)
        runs = k1_entries(kernels.load()["keyswitch"], ct, ksk, limbs, bl, lev)
        wrapper = lambda: kernels.keyswitch(ct, key, bl, lev)  # noqa: E731
        runs["wrapper"] = wrapper
        row = {"batch": b, "n_in": n_in, "levels": lev, "base_log": bl, "m_out": m_out}
        if hasattr(kernels, "keyswitch_route"):
            row["route"] = kernels.keyswitch_route(n_in, lev, bl)
        for name, run in runs.items():
            row[f"{name}_err"] = int((run() - want).abs().max())
        order = list(runs) + list(reversed(runs))
        times = {name: [] for name in runs}
        for name in order:
            times[name].append(ms(runs[name], reps))
        row["ms"] = times
        row["graph_ms"] = {name: [] for name in runs if name != "wrapper"}
        for name in list(row["graph_ms"]) + list(reversed(list(row["graph_ms"]))):
            row["graph_ms"][name].append(graph_ms(runs[name]))
        row["host_ms"] = {}
        for name, run in runs.items():      # the host's time to enqueue a launch
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                run()
            row["host_ms"][name] = (time.perf_counter() - t0) * 1e3 / reps
            torch.cuda.synchronize()
        if "h_k1" in libs:
            hlib = libs["h_k1"]
            for f in ("tfhe_torch_keyswitch",):
                getattr(hlib, f).argtypes = getattr(kernels.load()["keyswitch"], f).argtypes
                getattr(hlib, f).restype = ctypes.c_int
            hruns = k1_entries(hlib, ct, ksk, limbs, bl, lev)
            chunks = {"generic": -(-n_in // (64 // lev))}
            for name in hruns:
                if name.startswith("limbs_s"):     # block (0, 0, 0) walks one slice
                    chunks[name] = -(-limbs.shape[0] // int(name[len("limbs_s"):]))
                row[f"{name}_phases"] = phases(hlib, hruns[name], "keyswitch.cu",
                                               chunks.get(name, 1))
        res[tag] = row
        print("k1g", tag, {k: v for k, v in row.items() if not k.endswith("phases")}, flush=True)
    out["k1g"] = res


# K7 at the research phase's shapes (2_2 widths, base 2^8, l = 4): (tag,
# k_in, k_out + 1): the GLWE keyswitch and the fast keyswitch
K7_SHAPES = (("glwe_keyswitch", 1, 2, False), ("fast_keyswitch", 2, 2, True))


def k7_entries(lib, glwe, key, dp, bl, lev, add_sum):
    """K7's C entries on one input: today's kernel and, where the library
    has it, the cluster kernel (name -> run)."""
    b, kin1, n = glwe.shape
    kout1 = key.shape[2]
    tw_fwd, tw_inv = ntt.shoup_twiddles(dp)

    def first():
        out = torch.empty((b, kout1, n), dtype=torch.int64, device="cuda")
        chunk = min(kernels.glwe_keyswitch_rows(kout1, n), (kin1 - 1) * lev)
        err = lib.tfhe_torch_glwe_keyswitch(
            out.data_ptr(), glwe.data_ptr(), key.data_ptr(), dp.psi32.data_ptr(),
            dp.psi_inv32.data_ptr(), dp.kernel_consts.data_ptr(), b, kin1 - 1, kout1,
            n.bit_length() - 1, lev, bl, int(add_sum), chunk, kernels._stream(glwe))
        assert err == 0, f"K7's first kernel failed: cudaError {err}"
        return out

    runs = {"first": first}
    if hasattr(lib, "tfhe_torch_glwe_keyswitch_cluster"):
        lib.tfhe_torch_glwe_keyswitch_cluster.argtypes = [ctypes.c_void_p] * 6 + [
            ctypes.c_int] * 7 + [ctypes.c_void_p]

        def cluster():
            out = torch.empty((b, kout1, n), dtype=torch.int64, device="cuda")
            err = lib.tfhe_torch_glwe_keyswitch_cluster(
                out.data_ptr(), glwe.data_ptr(), key.data_ptr(), tw_fwd.data_ptr(),
                tw_inv.data_ptr(), dp.kernel_consts.data_ptr(), b, kin1 - 1, kout1,
                n.bit_length() - 1, lev, bl, int(add_sum), kernels._stream(glwe))
            assert err == 0, f"K7's cluster kernel failed: cudaError {err}"
            return out

        runs["cluster"] = cluster
    return runs


def k7(libs, out, reps=10):
    """K7 at K7_SHAPES, B = 512, on random words and a random key: each C
    entry (k7_entries) held against server.glwe_keyswitch_sum at B = 3 and
    timed in turns at B = 512 (CUDA events over reps launches), the
    wrapper's time, and each kernel's phase table a GLWE (block 0 takes
    one) from an instrumented copy of its source."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    rng = np.random.default_rng(7)
    n, bl, lev = 2048, 8, 4
    dp = ntt.device_plan(ntt.make_plan(n, 4), "cuda")
    res = {}
    for tag, k_in, kout1, add_sum in K7_SHAPES:
        key = torch.stack([torch.randint(0, q, (k_in, lev, kout1, n), generator=gen,
                                         device="cuda") for q in dp.plan.primes],
                          dim=-2).to(torch.int32).contiguous()
        glwe = torus.from_u64(rng.integers(0, 1 << 64, (B, k_in + 1, n), dtype=np.uint64),
                              "cuda")
        row = {"batch": B, "k_in": k_in, "kout1": kout1, "N": n, "base_log": bl, "levels": lev}
        if hasattr(kernels, "glwe_keyswitch_route"):
            row["route"] = kernels.glwe_keyswitch_route(k_in, kout1, n, lev, bl)
            row.update(kernels.glwe_keyswitch_figures(k_in, kout1, n, lev, bl))
        small = glwe[:3].contiguous()
        want = server.glwe_keyswitch_sum(small, key, dp, bl, lev, add_sum)
        for name, run in k7_entries(kernels.load()["glwe_keyswitch"], small, key, dp, bl, lev,
                                    add_sum).items():
            row[f"{name}_err_b3"] = int((run() - want).abs().max())
        runs = k7_entries(kernels.load()["glwe_keyswitch"], glwe, key, dp, bl, lev, add_sum)
        runs["wrapper"] = lambda: kernels.glwe_keyswitch(glwe, key, dp, bl, lev, add_sum)
        if "v_k7m3" in libs:     # the cluster kernel at three blocks an SM
            vlib = libs["v_k7m3"]
            f = "tfhe_torch_glwe_keyswitch"
            getattr(vlib, f).argtypes = getattr(kernels.load()["glwe_keyswitch"], f).argtypes
            variant = k7_entries(vlib, glwe, key, dp, bl, lev, add_sum).get("cluster")
            if variant is not None:
                runs["cluster_min3"] = variant
                row["cluster_min3_err_b512"] = int((variant() - runs["first"]()).abs().max())
        order = list(runs) + list(reversed(runs))
        times = {name: [] for name in runs}
        for name in order:
            times[name].append(ms(runs[name], reps))
        row["ms"] = times
        if "h_k7" in libs:
            hlib = libs["h_k7"]
            f = "tfhe_torch_glwe_keyswitch"
            getattr(hlib, f).argtypes = getattr(kernels.load()["glwe_keyswitch"], f).argtypes
            getattr(hlib, f).restype = ctypes.c_int
            for name, run in k7_entries(hlib, glwe, key, dp, bl, lev, add_sum).items():
                row[f"{name}_phases"] = phases(hlib, run, "glwe_keyswitch_marked.cu"
                                               if name == "cluster" else "glwe_keyswitch.cu", 1)
        res[tag] = row
        print("k7", tag, {k: v for k, v in row.items() if not k.endswith("phases")}, flush=True)
        del key
    out["k7"] = res


K9_SHAPES = ((1, 1), (4, 1), (8, 1), (4, 4))   # (D, B)


def k9(libs, out, steps=918, head=16):
    """K9's fused entry at K9_SHAPES (see the module's docstring)."""
    from tfhe_tpu_torch.ops import four_step

    gen = torch.Generator(device="cuda").manual_seed(9)
    n, k1, lev, bl = 2048, 2, 1, 23
    res = {}
    for d, b in K9_SHAPES:
        t = four_step.device_tables(n, d, "cuda:0")
        key = torch.remainder(torch.randint(0, 1 << 62, (d, steps, lev, k1, k1, 4, t.c),
                                            generator=gen, device="cuda"),
                              t.dp.ps.view(-1, 1)).to(torch.int32)
        lut = torch.randint(-(1 << 62), 1 << 62, (b, k1, n), generator=gen, device="cuda")
        mask = torch.randint(0, 2 * n, (b, steps), generator=gen, device="cuda")
        body = torch.randint(0, 2 * n, (b,), generator=gen, device="cuda")
        run = lambda: kernels.poly_shard_rotate(mask, body, lut, key, t, bl, lev)  # noqa: E731
        h_mask, h_key = mask[:, :head].contiguous(), key[:, :head].contiguous()
        got = kernels.poly_shard_rotate(h_mask, body, lut, h_key, t, bl, lev)
        want = four_step.rotate_steps(h_mask, body, lut, list(h_key.unbind(0)), [t] * d, bl, lev)
        row = {"slots": d, "batch": b, "steps": steps,
               "plan": kernels.poly_rotate_plan(0, d, k1, lev, n),
               f"words_differing_first_{head}_steps": int((got != want).sum())}
        row["ms"] = ms(run, 3)
        row["us_a_step"] = row["ms"] * 1e3 / steps
        if "h_k9" in libs:
            ref = run()
            real = swap("poly_shard", libs["h_k9"])
            try:
                row["fused_phases"] = phases(libs["h_k9"], run, "poly_shard_marked.cu", steps)
                row["ms_instrumented"] = ms(run, 1)
                row["words_differing_instrumented"] = int((run() != ref).sum())
            finally:
                kernels._Libs.loaded["poly_shard"] = real
        res[f"d{d}_b{b}"] = row
        print("k9", f"d{d}_b{b}", {k: v for k, v in row.items() if not k.endswith("phases")},
              flush=True)
        del key
    out["k9"] = res


def generic_checks(out):
    """Shapes off the lazy kernels' main instances, B small, against plain."""
    from tfhe_tpu_torch.ops import server128
    gen = torch.Generator(device="cuda").manual_seed(7)
    rng = np.random.default_rng(7)
    res = {}
    for tag, k1, n, lev, bl, steps in (("k5_test", 2, 512, 3, 24, 16), ("k5_generic", 3, 1024, 2, 20, 8),
                                       ("k5_prod", 3, 2048, 3, 24, 8)):
        dp = ntt.device_plan(ntt.make_plan(n, 6), "cuda")
        key = torch.stack([torch.randint(0, q, (steps, lev, k1, k1, n), generator=gen, device="cuda")
                           for q in dp.plan.primes], dim=-2).to(torch.int32)
        for b in (1, 3):
            a = (torch.from_numpy(rng.integers(0, 2 * n, (b, steps))).cuda(),
                 torch.from_numpy(rng.integers(0, 2 * n, (b,))).cuda()) + tuple(
                torus.from_u64(rng.integers(0, 1 << 64, (b, k1, n), dtype=np.uint64), "cuda")
                for _ in range(2)) + (key, dp, bl, lev)
            g, w = kernels.blind_rotate128(*a), server128.blind_rotate128(*a)
            res[f"{tag}_b{b}"] = max(int((x - y).abs().max()) for x, y in zip(g, w))
    dp = ntt.device_plan(ntt.make_plan(2048, 4), "cuda")
    for tag, g_, lev, bl, groups in (("k3x_g4", 4, 1, 22, 4), ("k3x_g2", 2, 1, 23, 6),
                                     ("k3x_g3_l2", 3, 2, 14, 3), ("k3x_g1", 1, 1, 22, 5)):
        key = torch.stack([torch.randint(0, q, (groups, 1 << g_, lev, 2, 2, 2048), generator=gen,
                                         device="cuda") for q in dp.plan.primes], dim=-2).to(torch.int32)
        for b in (1, 3, 5):
            raw = torus.from_u64(rng.integers(0, 1 << 64, (b, groups * g_), dtype=np.uint64), "cuda")
            a = (server.multibit_switched_degrees(raw, g_, 12),
                 torch.from_numpy(rng.integers(0, 4096, (b,))).cuda(),
                 torus.from_u64(rng.integers(0, 1 << 64, (b, 2, 2048), dtype=np.uint64), "cuda"),
                 key, dp, bl, lev)
            res[f"{tag}_b{b}"] = int((kernels.blind_rotate_multibit(*a, v9=False)
                                      - server.blind_rotate_multibit(*a)).abs().max())
    out["generic_checks"] = res
    print("generic checks", res, flush=True)


def step_entry(out, reps=200):
    """K2's step entry (kernels.cmux_step) at B = 512 on the 2_2 shape and
    a random key, CUDA events over reps launches, three times."""
    gen = torch.Generator(device="cuda").manual_seed(13)
    rng = np.random.default_rng(13)
    n = 2048
    dp = ntt.device_plan(ntt.make_plan(n, 4), "cuda")
    key = torch.stack([torch.randint(0, q, (1, 2, 2, n), generator=gen, device="cuda")
                       for q in dp.plan.primes], dim=-2).to(torch.int32)
    acc = torus.from_u64(rng.integers(0, 1 << 64, (B, 2, n), dtype=np.uint64), "cuda")
    a = torch.from_numpy(rng.integers(0, 2 * n, (B,))).cuda()
    out["step_entry_ms"] = [ms(lambda: kernels.cmux_step(acc, a, key, dp, 23, 1), reps)
                            for _ in range(3)]
    print("step entry ms", out["step_entry_ms"], flush=True)


def main():
    which = sys.argv[1:] or ["k5", "k3x"]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    t0 = time.time()
    kernels.load()
    want = sorted({n for n, w in (("h_k5", "k5"), ("h_k3", "k3x"), ("h_k3", "k3c"),
                                  ("h_k3c", "k3c"), ("h_k2", "k2x"), ("h_kc", "k2x"),
                                  ("h_k1", "k1g"), ("h_k7", "k7"), ("v_k7m3", "k7"),
                                  ("h_k2", "cmux"), ("h_kc", "cmux"), ("h_k9", "k9"))
                   if w in which and "nophase" not in which})
    libs = build(want)
    out = {"card": card, "build_s": time.time() - t0}
    if "checks" in which:
        generic_checks(out)
    if "step" in which:
        step_entry(out)
    if "k5" in which:
        k5(libs, out)
    if "k3x" in which:
        k3x(libs, out)
    if "k3c" in which:
        k3c(libs, out)
    if "k2x" in which:
        k2x(libs, out)
    if "k1g" in which:
        k1g(libs, out)
    if "k7" in which:
        k7(libs, out)
    if "cmux" in which:
        cmux(libs, out)
    if "k9" in which:
        k9(libs, out)
    out["seconds"] = time.time() - t0
    HERE.mkdir(parents=True, exist_ok=True)
    (HERE / "phase.json").write_text(json.dumps(out, indent=1))
    tables = (list(out.get("k2x_test", {}).items()) + list(out.get("k3c", {}).items())
              + list(out.get("k1g", {}).items()) + list(out.get("k7", {}).items())
              + list(out.get("cmux", {}).items()) + list(out.get("k9", {}).items()))
    for tag, row in tables:
        for name in [k[:-len("_phases")] for k in row if k.endswith("_phases")]:
            ph = row.get(f"{name}_phases")
            if ph:
                print(f"{tag} {name}: total/step (group) {ph['total_per_unit']:.0f} "
                      f"wait {ph['wait_per_unit']:.0f}")
                for r in ph["rows"]:
                    print(f"  {r['at']:30s} n={r['count']:6d} work "
                          f"{r['work_per_unit']:10.0f} wait {r['wait_per_unit']:8.0f}")
    for k in ("k5", "k3x", "k2x"):
        if k in out:
            d = out[k]
            print(k, {x: d[x] for x in d if not x.endswith("phases")})
            for tag in ("phases", "generic_phases"):
                if tag in d:
                    ph = d[tag]
                    print(f"  {tag}: total/unit {ph['total_per_unit']:.0f} "
                          f"wait {ph['wait_per_unit']:.0f}")
                    for r in ph["rows"]:
                        print(f"  {r['at']:28s} n={r['count']:6d} work "
                              f"{r['work_per_unit']:10.0f} wait {r['wait_per_unit']:8.0f}")
    print(card)


if __name__ == "__main__":
    main()
