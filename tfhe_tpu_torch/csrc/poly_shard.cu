// K9: the four-step split of one negacyclic product over D slots, and the
// poly-sharded blind rotation built on it (parallel/poly_shard.py; plain
// versions in ops/four_step.py).  It replaces no pallas_call: tfhe_tpu
// computes the split's slot-local stages as XLA mod-p matmuls in a
// shard_map program (tfhe_tpu/parallel/poly_shard.py _mat_mod :108,
// _fwd_local :118, _inv_local :137), as sharded_blind_rotate_poly (:285)
// uses them, and torch has no int64 matmul on CUDA.  Math, for each CRT
// prime: slot a holds coefficients a + D c (c < C = N / D); a forward
// transform is the twist psi^(a + D c), a cyclic size-C transform (root
// om^D) and the twiddle om^(a k2) on each slot, an exchange of blocks of
// C / D values of k2, and a size-D transform (root om^C) on each slot;
// the inverse runs the same stages backwards.  Residues and key slices are
// u32 (the primes are below 2^30), words u64; all arithmetic is exact mod
// p (Montgomery products of values below p, every sum reduced), so every
// entry gives the plain versions' words whatever the order.
//
// The fused entry, tfhe_torch_poly_shard_rotate: all n CMux steps of B
// ciphertexts in one launch, the words of ops/server.py blind_rotate, when
// every slot of the mesh is the same card (ops/kernels.py
// poly_rotation_route "fused").  What bounds it is a chain of n dependent
// steps, each a few cluster barriers apart; the key's evaluation slices
// (120,324,096 B at 2_2) are read once a PBS, and its arithmetic (about
// 0.07 ms a PBS on the CUDA cores at D = 4, B = 1) is far below the
// chain's latency.  Design: one thread-block cluster a ciphertext, one
// block of 512 threads a (slot, prime) (D NP blocks, 16 at D = 4; at D = 8
// one block a slot and two primes, 16 blocks; the non-portable cluster
// size allowed), so the slots' exchanges are stores into the peers' shared
// memory (distributed shared memory) and the host enqueues nothing between
// steps.  A block keeps for the whole launch its slot's u64 words (every
// block of a slot a copy), its digit rows, the rows it receives, and its
// primes' twist, twiddle and power tables as u32.  A step:
//   1. the first pass: acc X^m - acc at 2 or 4 of the slot's coefficients
//      a thread (the rotated words read from the slot that holds them), the
//      gadget digits, the twist and the first one or two stages of the
//      size-C butterflies, stored in bit-reversed order;
//   2. radix-4 passes (two stages in registers); the last takes the
//      twiddle and stores each value into the block of the slot that owns
//      its k2 (the first all-to-all); cluster barrier;
//   3. one thread a (prime, position of the slot's evaluation slice): the
//      size-D transform of the D received values, the product with the
//      step's key slice (double buffered in shared memory by cp.async one
//      step ahead where it fits) summed over the levels and input rows,
//      and the size-D inverse across the D lanes of a block of positions by
//      warp shuffles, each value stored into the block of the slot it
//      belongs to (the second all-to-all); cluster barrier;
//   4. the inverse passes (decimation in frequency, natural order in): the
//      first takes the inverse twiddle, the last the inverse twist times
//      C^-1 and stores each residue into the block of the slot that
//      reconstructs its coefficient; cluster barrier;
//   5. Garner of the block's C / NP coefficients (C / 2 at D = 8) from the
//      NP primes' residues, added into every copy of the slot's words;
//      cluster barrier.
// Four cluster barriers and about log C block barriers a step.  Buffers
// alias by lifetime (the received rows hold Garner's inputs, the digit rows
// the second exchange's values).  Where a shape's state passes a block's
// shared memory the key slice is read from global memory (tier 1), then the
// tables (tier 2), then the words and rows live in a global scratch a block
// (tier 3, ordered by the same barriers with fences around them), so no
// shape the step entries take is refused for its size.  Measured
// (chip_smoke.py's poly_shard_rotate row, NVIDIA H100 80GB HBM3, 700 W):
// 11.6 ms a rotation at D = 4, B = 1 (12.6 us a step); tools/phase_cycles.py
// k9 tables its cycles by barrier.
//
// The step entries, three launches a CMux step on each slot, remain for
// meshes whose slots lie on distinct cards (route "steps"), the key's
// preparation and the sharded product:
//   (a) tfhe_torch_poly_shard_forward: a slot's C coefficients of M
//       polynomials -> their signed gadget digits (or the u64 words'
//       residues), the twist, the cyclic size-C transform, the twiddle:
//       (L, M, NP, C) u32 residues.  One block a (row, prime).
//   (b) tfhe_torch_poly_shard_cross: after the exchange, slot b's
//       (D, L, M, NP, C/D) blocks -> the size-D transform, the product
//       with the slot's key slice summed over the levels and the k+1 input
//       rows, and the size-D inverse: (D, B, k+1, NP, C/D).  Without a key
//       it returns the evaluation slice in Montgomery form (a key's,
//       prepare_bsk_poly_sharded).  One block a (ciphertext, prime).
//   (c) tfhe_torch_poly_shard_inverse: after the exchange back, slot a's
//       (D, M, NP, C/D) -> the inverse twiddle, the inverse cyclic size-C
//       transform, the inverse twist times C^-1, Garner to u64: (M, C).
// At the main path's shapes a step's grids are a few dozen blocks, so the
// launches and the host's exchanges between them set their time (0.66 ms
// of host time a step at D = 4, against 0.1 ms on the card, NVIDIA H100
// 80GB HBM3, 700 W): the reason for the fused entry.

#include <cooperative_groups.h>

#include "ntt_common.cuh"

namespace cg = cooperative_groups;
using namespace ntt_common;

namespace {

constexpr int K9_THREADS = 256;
constexpr int K9_MAX_K1 = 8;
constexpr int K9_MAX_LEVELS = 8;
constexpr int K9_MAX_LOG_C = 13;
constexpr int K9_SMEM = 232448;
// ps_inverse_kernel's static Consts comes out of the same per-block limit
constexpr int K9_INVERSE_SMEM = K9_SMEM - 1024;

__device__ __forceinline__ int bit_reverse(int i, int log_c) {
  return log_c == 0 ? 0 : (int)(__brev((unsigned)i) >> (32 - log_c));
}

// In place, the cyclic transform v[k] <- sum_c v[c] w^(c k) of size
// C = 2^log_c over a row of shared memory loaded in bit-reversed order:
// Cooley-Tukey stages, the stage of half-length h taking w^(j C / 2h) =
// pw[j C / 2h] (pw[j] = w^j R, Montgomery form).  Every thread of the block
// calls it; it synchronises after each stage.
__device__ __forceinline__ void cyclic_ntt(u32* v, const u32* pw, int log_c, u32 p, u32 pinv) {
  const int c_len = 1 << log_c;
  for (int s = 1; s <= log_c; ++s) {
    const int half = 1 << (s - 1);
    const int stride = c_len >> s;
    for (int t = threadIdx.x; t < c_len / 2; t += blockDim.x) {
      const int j = t & (half - 1);
      const int base = ((t >> (s - 1)) << s) + j;
      const u32 u = v[base];
      const u32 x = mont_mul(v[base + half], pw[j * stride], p, pinv);
      v[base] = add_mod(u, x, p);
      v[base + half] = sub_mod(u, x, p);
    }
    __syncthreads();
  }
}

// Entry (a).  x (rows, C) u64 words; tw, twd, pw (NP, C) Montgomery
// (this slot's twist and twiddle, om^(D j)); out (L, rows, NP, C) u32.
__global__ void __launch_bounds__(K9_THREADS)
ps_forward_kernel(const long long* __restrict__ x, u32* __restrict__ out,
                  const long long* __restrict__ consts, const long long* __restrict__ tw,
                  const long long* __restrict__ twd, const long long* __restrict__ pw,
                  int rows, int log_c, int levels, int base_log) {
  extern __shared__ u32 sm[];
  const int c_len = 1 << log_c;
  const int nl = levels > 0 ? levels : 1;
  const int row = blockIdx.x / NP;
  const int pi = blockIdx.x % NP;
  const u32 p = (u32)consts[pi];
  const u32 pinv = (u32)consts[4 + pi];
  u32* w = sm;                     // C powers
  u32* z = sm + c_len;             // nl rows of C
  const long long* xr = x + (long long)row * c_len;
  for (int c = threadIdx.x; c < c_len; c += blockDim.x) {
    w[c] = (u32)pw[pi * c_len + c];
    const u32 t = (u32)tw[pi * c_len + c];
    const int at = bit_reverse(c, log_c);
    const u64 v = (u64)xr[c];
    if (levels == 0) {
      z[at] = mont_mul((u32)(v % p), t, p, pinv);
    } else {
      u64 state = decomposer_state(v, base_log, levels);
      for (int lev = 0; lev < levels; ++lev) {
        const long long d = next_digit(state, base_log);
        const u32 r = d < 0 ? (u32)((long long)p + d) : (u32)d;
        z[lev * c_len + at] = mont_mul(r, t, p, pinv);
      }
    }
  }
  __syncthreads();
  for (int lev = 0; lev < nl; ++lev) cyclic_ntt(z + lev * c_len, w, log_c, p, pinv);
  for (int lev = 0; lev < nl; ++lev) {
    u32* o = out + (((long long)lev * rows + row) * NP + pi) * c_len;
    for (int k2 = threadIdx.x; k2 < c_len; k2 += blockDim.x) {
      o[k2] = mont_mul(z[lev * c_len + k2], (u32)twd[pi * c_len + k2], p, pinv);
    }
  }
}

// Entry (b).  ya (D, L, rows, NP, cd) u32, rows = batch k1.  With a key
// (L, k1, k1, NP, C) u32 Montgomery (the key of batch element b at key + b
// key_stride): out (D, batch, k1, NP, cd) u32.  Without (forward_only):
// out (L, rows, NP, C), Montgomery form, one block a (level-row, prime).
__global__ void __launch_bounds__(K9_THREADS)
ps_cross_kernel(const u32* __restrict__ ya, const u32* __restrict__ key,
                u32* __restrict__ out, const long long* __restrict__ consts,
                const long long* __restrict__ pwd_f, const long long* __restrict__ pwd_i,
                const long long* __restrict__ r2, int d, int cd, int levels, int batch, int k1,
                long long key_stride, int forward_only) {
  extern __shared__ u32 sm[];      // k1 rows of C
  const int c_len = cd * d;
  const int pi = blockIdx.x % NP;
  const int unit = blockIdx.x / NP;
  const u32 p = (u32)consts[pi];
  const u32 pinv = (u32)consts[4 + pi];
  const long long rows = (long long)batch * k1;
  // element (a, level-row u, k2loc) of ya for this prime
  auto at = [&](int a, long long u, int k2loc) {
    return ya[(((long long)a * levels * rows + u) * NP + pi) * cd + k2loc];
  };
  if (forward_only) {
    const u32 rr = (u32)r2[pi];
    u32* o = out + ((long long)unit * NP + pi) * c_len;
    for (int j = threadIdx.x; j < c_len; j += blockDim.x) {
      const int k2loc = j / d, kk = j % d;
      u64 s = 0;
      for (int a = 0; a < d; ++a) {
        s += mont_mul(at(a, unit, k2loc), (u32)pwd_f[pi * d + (a * kk) % d], p, pinv);
      }
      o[j] = mont_mul((u32)(s % p), rr, p, pinv);
    }
    return;
  }
  const u32* kb = key + (long long)unit * key_stride;
  for (int j = threadIdx.x; j < c_len; j += blockDim.x) {
    const int k2loc = j / d, kk = j % d;
    u64 acc[K9_MAX_K1];
#pragma unroll
    for (int ro = 0; ro < K9_MAX_K1; ++ro) acc[ro] = 0;
    for (int lev = 0; lev < levels; ++lev) {
      for (int r = 0; r < k1; ++r) {
        const long long u = (long long)lev * rows + (long long)unit * k1 + r;
        u64 s = 0;
        for (int a = 0; a < d; ++a) {
          s += mont_mul(at(a, u, k2loc), (u32)pwd_f[pi * d + (a * kk) % d], p, pinv);
        }
        const u32 x2 = (u32)(s % p);
        const u32* kr = kb + (((long long)lev * k1 + r) * k1 * NP + pi) * c_len + j;
#pragma unroll
        for (int ro = 0; ro < K9_MAX_K1; ++ro) {
          if (ro < k1) acc[ro] += mont_mul(x2, kr[(long long)ro * NP * c_len], p, pinv);
        }
      }
    }
#pragma unroll
    for (int ro = 0; ro < K9_MAX_K1; ++ro) {
      if (ro < k1) sm[ro * c_len + j] = (u32)(acc[ro] % p);
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < k1 * c_len; t += blockDim.x) {
    const int ro = t / c_len, rem = t % c_len, k2loc = rem / d, a = rem % d;
    u64 s = 0;
    for (int kk = 0; kk < d; ++kk) {
      s += mont_mul(sm[ro * c_len + k2loc * d + kk], (u32)pwd_i[pi * d + (kk * a) % d], p, pinv);
    }
    out[((((long long)a * batch + unit) * k1 + ro) * NP + pi) * cd + k2loc] = (u32)(s % p);
  }
}

// Entry (c).  yb (D, rows, NP, cd) u32; twd_i, tw_ci, pw_i (NP, C) Montgomery
// (this slot's inverse twiddle, inverse twist times C^-1, om^-(D j));
// out (rows, C) u64 words.  consts holds R in place of N^-1.
__global__ void __launch_bounds__(K9_THREADS)
ps_inverse_kernel(const u32* __restrict__ yb, long long* __restrict__ out,
                  const long long* __restrict__ consts, const long long* __restrict__ twd_i,
                  const long long* __restrict__ tw_ci, const long long* __restrict__ pw_i,
                  int rows, int d, int log_c) {
  extern __shared__ u32 sm[];      // C powers, C scratch, NP rows of C
  __shared__ Consts cs;
  if (threadIdx.x == 0) load_consts(cs, consts);
  const int c_len = 1 << log_c;
  const int cd = c_len / d;
  const int m = blockIdx.x;
  u32* w = sm;
  u32* v = sm + c_len;
  u32* z = sm + 2 * c_len;
  __syncthreads();
  for (int pi = 0; pi < NP; ++pi) {
    const u32 p = cs.p[pi], pinv = cs.pinv[pi];
    for (int k2 = threadIdx.x; k2 < c_len; k2 += blockDim.x) {
      const int b = k2 / cd, k2loc = k2 % cd;
      const u32 y = yb[(((long long)b * rows + m) * NP + pi) * cd + k2loc];
      v[bit_reverse(k2, log_c)] = mont_mul(y, (u32)twd_i[pi * c_len + k2], p, pinv);
      w[k2] = (u32)pw_i[pi * c_len + k2];
    }
    __syncthreads();
    cyclic_ntt(v, w, log_c, p, pinv);
    for (int c = threadIdx.x; c < c_len; c += blockDim.x) {
      z[pi * c_len + c] = mont_mul(v[c], (u32)tw_ci[pi * c_len + c], p, pinv);
    }
    __syncthreads();
  }
  long long* o = out + (long long)m * c_len;
  for (int c = threadIdx.x; c < c_len; c += blockDim.x) {
    o[c] = (long long)garner_u64(z + c, c_len, cs);
  }
}

// Each kernel's dynamic shared memory limit is raised to the most it can
// take (K9_SMEM, less the inverse's static part) once a device
// (set_smem_once), not on every launch: the attribute call costs the host
// more than a small launch does.
std::atomic<unsigned> forward_sized{0}, cross_sized{0}, inverse_sized{0};

// ---------------------------------------------------------------------------
// The fused entry: the whole rotation, one cluster a ciphertext
// ---------------------------------------------------------------------------

constexpr int K9R_THREADS = 512;
constexpr int K9R_MAX_D = 8;
constexpr int K9R_MAX_CLUSTER = 16;   // blocks a cluster may hold (non-portable)
constexpr int K9R_TABLES = 6;         // tw_f, twd_f, pw_f, twd_i, tw_ci, pw_i
constexpr int K9R_SMEM = K9_SMEM - 1024;   // less the static constants

// How a shape runs: primes a block (one, or two at D = 8), blocks a slot
// and a ciphertext, and where the state lives.  Tier 0: words, rows,
// tables and the double-buffered key slice in shared memory; 1: the key
// read from global memory; 2: the tables too; 3: the words and rows in a
// global scratch of block_bytes a block.  The one copy of the plan:
// ops/kernels.py poly_rotate_plan reads it (tfhe_torch_poly_shard_rotate_plan).
struct RotatePlan {
  int ppb, bps, cluster, tier, smem;
  long long words_bytes, rows_bytes, tables_bytes, key_bytes, block_bytes;
};

RotatePlan rotate_plan(int d, int k1, int levels, int log_c) {
  RotatePlan s;
  const long long c = 1ll << log_c;
  s.ppb = d * NP <= K9R_MAX_CLUSTER ? 1 : d * NP / K9R_MAX_CLUSTER;
  s.bps = NP / s.ppb;
  s.cluster = d * s.bps;
  s.words_bytes = 8ll * k1 * c;
  s.rows_bytes = 4ll * levels * k1 * c * s.ppb;
  s.tables_bytes = 4ll * K9R_TABLES * c * s.ppb;
  s.key_bytes = 2ll * 4 * levels * k1 * k1 * c * s.ppb;
  s.block_bytes = s.words_bytes + 2 * s.rows_bytes;
  const long long need[3] = {s.block_bytes + s.tables_bytes + s.key_bytes,
                             s.block_bytes + s.tables_bytes, s.block_bytes};
  s.tier = 3;
  s.smem = 0;
  for (int t = 0; t < 3; ++t) {
    if (need[t] <= K9R_SMEM) {
      s.tier = t;
      s.smem = (int)need[t];
      break;
    }
  }
  return s;
}

struct RotateArgs {
  long long* out;              // (B, k1, N) words
  const long long* lut;        // (B, k1, N) words
  const int* body;             // (B,) in [0, 2N)
  const int* mask;             // (B, n_steps) in [0, 2N)
  const u32* key;              // (D, n_steps, L, k1, k1, NP, C) Montgomery
  const u32* tables;           // (D, NP, 6, C) Montgomery
  const u32* cross;            // (NP, 2, D): om^(C j) and om^-(C j) D^-1, Montgomery
  const long long* consts;     // the packed constants, R in place of N^-1
  unsigned char* scratch;      // tier 3: (B, cluster, block_bytes)
  long long words_bytes, rows_bytes, block_bytes;
  int n_steps, k1, levels, base_log, d, log_c, ppb, tier;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src));
}

// Block r's copy of a buffer of this block: its shared memory through the
// cluster's map, or (tier 3) its slice of the global scratch.
template <class T>
__device__ __forceinline__ T* peer(T* own, int r, int rank, long long block_bytes, bool global) {
  if (global) return (T*)((unsigned char*)own + (long long)(r - rank) * block_bytes);
  return cg::this_cluster().map_shared_rank(own, (unsigned)r);
}

// A cluster barrier; in tier 3 with fences around it, so the peers' global
// stores are seen past every L1.
__device__ __forceinline__ void cluster_barrier(bool global) {
  if (global) __threadfence();
  cg::this_cluster().sync();
  if (global) __threadfence();
}

// Butterflies of the size-C transforms: decimation in time (x, y) -> (x +
// w y, x - w y), and in frequency (x, y) -> (x + y, (x - y) w).
__device__ __forceinline__ void dit(u32& x, u32& y, u32 w, u32 p, u32 pinv) {
  const u32 t = mont_mul(y, w, p, pinv);
  y = sub_mod(x, t, p);
  x = add_mod(x, t, p);
}

__device__ __forceinline__ void dif(u32& x, u32& y, u32 w, u32 p, u32 pinv) {
  const u32 s = add_mod(x, y, p);
  y = mont_mul(sub_mod(x, y, p), w, p, pinv);
  x = s;
}

__global__ void __launch_bounds__(K9R_THREADS) ps_rotate_kernel(const RotateArgs g) {
  extern __shared__ __align__(16) unsigned char rsm[];
  __shared__ Consts cs;
  __shared__ u32 dtab[NP][2][K9R_MAX_D];     // the block's primes' size-D powers
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int csize = (int)cluster.num_blocks();
  const int ppb = g.ppb, bps = NP / ppb;      // ppb <= 2: lp = row >= rows
  const int a = rank / bps, q = rank % bps, p0 = q * ppb;   // slot, prime group
  const long long ct = blockIdx.x / csize;
  const int d = g.d, k1 = g.k1, levels = g.levels, rows = levels * k1, log_c = g.log_c;
  const int log_d = __ffs(d) - 1, log_cd = log_c - log_d, log_cq = log_c - (__ffs(bps) - 1);
  const int c_len = 1 << log_c, cd = 1 << log_cd, cq = 1 << log_cq, n_poly = c_len << log_d;
  const int n_steps = g.n_steps, base_log = g.base_log;
  const bool global = g.tier == 3;
  const long long bb = g.block_bytes;
  const int tid = threadIdx.x;

  unsigned char* base = global ? g.scratch + (ct * csize + rank) * bb : rsm;
  u64* words = (u64*)base;                                   // (k1, C), the slot's
  u32* fr = (u32*)(base + g.words_bytes);                     // (ppb, rows, C); later (ppb, k1, C)
  u32* xr = (u32*)(base + g.words_bytes + g.rows_bytes);      // (ppb, rows, C); later Garner's
  const u32* tab_g = g.tables + ((long long)a * NP + p0) * K9R_TABLES * c_len;
  const u32* tab = tab_g;                                     // (ppb, 6, C)
  u32* keys = nullptr;                                        // (2, rows k1, ppb, C)
  if (g.tier <= 1) {
    u32* ts = (u32*)(base + g.words_bytes + 2 * g.rows_bytes);
    for (int e = tid; e < ppb * K9R_TABLES * c_len; e += K9R_THREADS) ts[e] = tab_g[e];
    tab = ts;
    if (g.tier == 0) keys = ts + ppb * K9R_TABLES * c_len;
  }
  // table t of the block's prime lp
  auto table = [&](int lp, int t) { return tab + (lp * K9R_TABLES + t) * c_len; };
  if (tid == 0) load_consts(cs, g.consts);
  for (int e = tid; e < ppb * 2 * d; e += K9R_THREADS) {
    const int lp = e / (2 * d), which = (e >> log_d) & 1, j = e & (d - 1);
    dtab[lp][which][j] = g.cross[((p0 + lp) * 2 + which) * d + j];
  }
  // the accumulator lut / X^body at the slot's coefficients a + D c
  {
    const int body = g.body[ct] & (2 * n_poly - 1);
    const int br = body & (n_poly - 1);
    const long long* lut = g.lut + ct * k1 * n_poly;
    for (int e = tid; e < k1 * c_len; e += K9R_THREADS) {
      const int r = e >> log_c, c = e & (c_len - 1);
      int s = a + (c << log_d) + br;
      bool neg = body >= n_poly;
      if (s >= n_poly) {
        s -= n_poly;
        neg = !neg;
      }
      const u64 v = (u64)lut[r * n_poly + s];
      words[e] = neg ? 0ull - v : v;
    }
  }
  // the step's key slice of the slot and the block's primes, rows (lev, r,
  // ro) of ppb C words, into buffer step & 1; one commit group a call
  auto prefetch = [&](int step) {
    if (g.tier != 0) return;
    if (step < n_steps) {
      const u32* src = g.key + ((long long)a * n_steps + step) * rows * k1 * NP * c_len +
                       (long long)p0 * c_len;
      u32* dst = keys + (step & 1) * rows * k1 * ppb * c_len;
      const int log_row4 = log_c - 2 + (ppb - 1);          // 16-byte words a row, log
      for (int e = tid; e < (rows * k1) << log_row4; e += K9R_THREADS) {
        const int row = e >> log_row4, off = e & ((1 << log_row4) - 1);
        cp_async16(dst + row * ppb * c_len + off * 4, src + (long long)row * NP * c_len + off * 4);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  prefetch(0);
  cluster_barrier(global);   // constants, tables and every copy of the words loaded

  const int* mask = g.mask + ct * n_steps;
  for (int step = 0; step < n_steps; ++step) {
    prefetch(step + 1);
    const int m = mask[step] & (2 * n_poly - 1);
    const int rot = m & (n_poly - 1);
    const bool odd = m >= n_poly;

    // 1-2. the forward cyclic transforms (root om^D): stage s pairs x[i],
    // x[i + 2^(s-1)] (bit-reversed order in, natural out) with
    // pw[i << (log C - s)].  The first pass forms acc X^m - acc at G = 2
    // (log C odd) or 4 of the slot's coefficients, c0 + {0, C/2, C/4, 3C/4}
    // at positions bit_reverse(c0) + {0, 1, 2, 3} (the rotated words read
    // from the slots that hold them), their digits and the twist, and runs
    // stage 1 (and 2); radix-4 passes follow; the last takes the twiddle
    // om^(a k2) and stores each value into the block of the slot that owns
    // block k2 / (C / D), at k2loc D + a of its row (the first all-to-all)
    {
      const int lg = 2 - (log_c & 1);                       // log G
      for (int e = tid; e < k1 << (log_c - lg); e += K9R_THREADS) {
        const int r = e >> (log_c - lg), c0 = e & ((c_len >> lg) - 1);
        const int at = bit_reverse(c0, log_c);
        u64 state[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (i < (1 << lg)) {
            const int c = c0 + (i == 1 ? c_len >> 1 : i == 2 ? c_len >> 2 : i == 3 ? 3 * (c_len >> 2) : 0);
            int s = a + (c << log_d) - rot;
            bool neg = odd;
            if (s < 0) {
              s += n_poly;
              neg = !neg;
            }
            u64 v = peer(words, (s & (d - 1)) * bps + q, rank, bb, global)
                        [(r << log_c) + (s >> log_d)];
            if (neg) v = 0ull - v;
            state[i] = decomposer_state(v - words[(r << log_c) + c], base_log, levels);
          }
        }
        for (int lev = 0; lev < levels; ++lev) {
          long long dig[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if (i < (1 << lg)) dig[i] = next_digit(state[i], base_log);
          }
          for (int lp = 0; lp < ppb; ++lp) {
            const u32 p = cs.p[p0 + lp], pinv = cs.pinv[p0 + lp];
            const u32* tw = table(lp, 0);
            const u32* pw = table(lp, 2);
            u32 x[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              if (i < (1 << lg)) {
                const int c = c0 + (i == 1 ? c_len >> 1 : i == 2 ? c_len >> 2 : i == 3 ? 3 * (c_len >> 2) : 0);
                const u32 res = dig[i] < 0 ? (u32)((long long)p + dig[i]) : (u32)dig[i];
                x[i] = mont_mul(res, tw[c], p, pinv);
              }
            }
            u32* v = fr + ((lp * rows + lev * k1 + r) << log_c) + at;
            dit(x[0], x[1], pw[0], p, pinv);
            if (lg == 2) {
              dit(x[2], x[3], pw[0], p, pinv);
              dit(x[0], x[2], pw[0], p, pinv);
              dit(x[1], x[3], pw[c_len >> 2], p, pinv);
              v[2] = x[2];
              v[3] = x[3];
            }
            v[0] = x[0];
            v[1] = x[1];
          }
        }
      }
      __syncthreads();
      for (int s = lg + 1; s < log_c; s += 2) {
        const int h = 1 << (s - 1);
        const bool last = s + 1 == log_c;
        for (int e = tid; e < (ppb * rows) << (log_c - 2); e += K9R_THREADS) {
          const int row = e >> (log_c - 2), u = e & ((c_len >> 2) - 1), lp = row >= rows;
          const u32 p = cs.p[p0 + lp], pinv = cs.pinv[p0 + lp];
          const u32* pw = table(lp, 2);
          const int j = u & (h - 1);
          const int b0 = ((u >> (s - 1)) << (s + 1)) + j;
          u32* v = fr + (row << log_c);
          u32 x0 = v[b0], x1 = v[b0 + h], x2 = v[b0 + 2 * h], x3 = v[b0 + 3 * h];
          const u32 w1 = pw[j << (log_c - s)];
          dit(x0, x1, w1, p, pinv);
          dit(x2, x3, w1, p, pinv);
          dit(x0, x2, pw[j << (log_c - s - 1)], p, pinv);
          dit(x1, x3, pw[(j + h) << (log_c - s - 1)], p, pinv);
          if (!last) {
            v[b0] = x0;
            v[b0 + h] = x1;
            v[b0 + 2 * h] = x2;
            v[b0 + 3 * h] = x3;
          } else {
            const u32* twd = table(lp, 1);
            const u32 xs[4] = {x0, x1, x2, x3};
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int k2 = b0 + i * h;
              peer(xr, (k2 >> log_cd) * bps + q, rank, bb, global)
                  [(row << log_c) + ((k2 & (cd - 1)) << log_d) + a] = mont_mul(xs[i], twd[k2], p, pinv);
            }
          }
        }
        if (!last) __syncthreads();
      }
    }
    if (g.tier == 0) asm volatile("cp.async.wait_group 1;\n" ::);   // this step's key slice
    cluster_barrier(global);

    // 3. one thread a (prime, position j = k2loc D + kk of the slot's
    // evaluation slice): for each row, the size-D transform (root om^C) of
    // the D received values of k2loc at kk, and its product with the step's
    // key slice, summed over the levels and the input rows into k+1 sums;
    // then the size-D inverse (root om^-C, times D^-1) across the D lanes of
    // k2loc by warp shuffles, lane t's value stored into slot t's row at k2
    // = a C / D + k2loc (the second all-to-all).  Every lane takes part in
    // the shuffles; only those with a position store.
    {
      const u32* kb;
      int kstride;             // between two (lev, r, ro) rows
      if (g.tier == 0) {
        kb = keys + (step & 1) * rows * k1 * ppb * c_len;
        kstride = ppb * c_len;
      } else {
        kb = g.key + ((long long)a * n_steps + step) * rows * k1 * NP * c_len + (long long)p0 * c_len;
        kstride = NP * c_len;
      }
      for (int e0 = 0; e0 < ppb << log_c; e0 += K9R_THREADS) {
        const int e = e0 + tid;
        const bool on = e < (ppb << log_c);
        const int lp = on ? e >> log_c : 0, j = e & (c_len - 1);
        const int k2loc = j >> log_d, kk = j & (d - 1);
        const u32 p = cs.p[p0 + lp], pinv = cs.pinv[p0 + lp];
        u32 acc[K9_MAX_K1];
#pragma unroll
        for (int ro = 0; ro < K9_MAX_K1; ++ro) acc[ro] = 0;
        if (on) {
          for (int row = 0; row < rows; ++row) {
            const u32* v = xr + ((lp * rows + row) << log_c) + (k2loc << log_d);
            u32 x = 0;
#pragma unroll
            for (int i = 0; i < K9R_MAX_D; ++i) {
              if (i < d) x = add_mod(x, mont_mul(v[i], dtab[lp][0][(i * kk) & (d - 1)], p, pinv), p);
            }
            const u32* kr = kb + row * k1 * kstride + (lp << log_c) + j;
#pragma unroll
            for (int ro = 0; ro < K9_MAX_K1; ++ro) {
              if (ro < k1) acc[ro] = add_mod(acc[ro], mont_mul(x, kr[ro * kstride], p, pinv), p);
            }
          }
        }
#pragma unroll
        for (int ro = 0; ro < K9_MAX_K1; ++ro) {
          if (ro < k1) {
            u32 sum = 0;
#pragma unroll
            for (int i = 0; i < K9R_MAX_D; ++i) {
              if (i < d) {
                const u32 y = __shfl_sync(0xffffffffu, acc[ro], i, d);
                sum = add_mod(sum, mont_mul(y, dtab[lp][1][(i * kk) & (d - 1)], p, pinv), p);
              }
            }
            if (on) {
              peer(fr, kk * bps + q, rank, bb, global)
                  [((lp * k1 + ro) << log_c) + (a << log_cd) + k2loc] = sum;
            }
          }
        }
      }
    }
    cluster_barrier(global);

    // 4. the inverse cyclic transforms (root om^-D), natural in,
    // bit-reversed out: stage s pairs x[i], x[i + 2^(s-1)] with
    // pw_i[i << (log C - s)], from s = log C down, in radix-4 passes (the
    // first takes the inverse twiddle om^-(a k2)), a radix-2 stage last
    // where log C is odd; the last pass takes the inverse twist times C^-1
    // and stores each residue into the block of the slot that reconstructs
    // its coefficient, at (row, c mod C / bps, prime)
    {
      auto to_garner = [&](int lp, int ro, int pos, u32 x, u32 p, u32 pinv) {
        const int c = bit_reverse(pos, log_c);
        peer(xr, a * bps + (c >> log_cq), rank, bb, global)
            [(((ro << log_cq) + (c & (cq - 1))) << 2) + p0 + lp] = mont_mul(x, table(lp, 4)[c], p, pinv);
      };
      int s = log_c;
      for (; s >= 2; s -= 2) {
        const int qh = 1 << (s - 2);
        const bool first = s == log_c, last = s == 2;
        for (int e = tid; e < (ppb * k1) << (log_c - 2); e += K9R_THREADS) {
          const int row = e >> (log_c - 2), u = e & ((c_len >> 2) - 1), lp = row >= k1;
          const u32 p = cs.p[p0 + lp], pinv = cs.pinv[p0 + lp];
          const u32* pw = table(lp, 5);
          const int j = u & (qh - 1);
          const int b0 = ((u >> (s - 2)) << s) + j;
          u32* v = fr + (row << log_c);
          u32 x0 = v[b0], x1 = v[b0 + qh], x2 = v[b0 + 2 * qh], x3 = v[b0 + 3 * qh];
          if (first) {
            const u32* twd = table(lp, 3);
            x0 = mont_mul(x0, twd[b0], p, pinv);
            x1 = mont_mul(x1, twd[b0 + qh], p, pinv);
            x2 = mont_mul(x2, twd[b0 + 2 * qh], p, pinv);
            x3 = mont_mul(x3, twd[b0 + 3 * qh], p, pinv);
          }
          dif(x0, x2, pw[j << (log_c - s)], p, pinv);
          dif(x1, x3, pw[(j + qh) << (log_c - s)], p, pinv);
          const u32 w = pw[j << (log_c - s + 1)];
          dif(x0, x1, w, p, pinv);
          dif(x2, x3, w, p, pinv);
          if (!last) {
            v[b0] = x0;
            v[b0 + qh] = x1;
            v[b0 + 2 * qh] = x2;
            v[b0 + 3 * qh] = x3;
          } else {
            const int ro = row - lp * k1;
            to_garner(lp, ro, b0, x0, p, pinv);
            to_garner(lp, ro, b0 + qh, x1, p, pinv);
            to_garner(lp, ro, b0 + 2 * qh, x2, p, pinv);
            to_garner(lp, ro, b0 + 3 * qh, x3, p, pinv);
          }
        }
        if (!last) __syncthreads();
      }
      if (s == 1) {    // log C odd: the last stage, radix 2
        for (int e = tid; e < (ppb * k1) << (log_c - 1); e += K9R_THREADS) {
          const int row = e >> (log_c - 1), lp = row >= k1, ro = row - lp * k1;
          const u32 p = cs.p[p0 + lp], pinv = cs.pinv[p0 + lp];
          const int b0 = 2 * (e & ((c_len >> 1) - 1));
          u32* v = fr + (row << log_c);
          u32 x = v[b0], y = v[b0 + 1];
          dif(x, y, table(lp, 5)[0], p, pinv);
          to_garner(lp, ro, b0, x, p, pinv);
          to_garner(lp, ro, b0 + 1, y, p, pinv);
        }
      }
    }
    cluster_barrier(global);

    // 5. Garner of the block's coefficients, added into every copy of the
    // slot's words
    for (int e = tid; e < k1 << log_cq; e += K9R_THREADS) {
      const int ro = e >> log_cq, c = (q << log_cq) + (e & (cq - 1));
      const u64 w = words[(ro << log_c) + c] + garner_u64(xr + e * NP, 1, cs);
      for (int t = 0; t < bps; ++t) peer(words, a * bps + t, rank, bb, global)[(ro << log_c) + c] = w;
    }
    cluster_barrier(global);
  }

  long long* out = g.out + ct * k1 * n_poly;
  for (int e = tid; e < k1 << log_cq; e += K9R_THREADS) {
    const int ro = e >> log_cq, c = (q << log_cq) + (e & (cq - 1));
    out[ro * n_poly + a + (c << log_d)] = (long long)words[(ro << log_c) + c];
  }
}

// The fused kernel's attributes, set once a device: the most dynamic
// shared memory a block may take, clusters above 8 blocks, the carveout
// to shared memory.
std::atomic<unsigned> rotate_prepared{0};

cudaError_t prepare_rotate() {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = dev < 32 ? 1u << dev : 0u;
  if (rotate_prepared.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(ps_rotate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             K9R_SMEM);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(ps_rotate_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(ps_rotate_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  }
  if (err == cudaSuccess) rotate_prepared.fetch_or(bit, std::memory_order_release);
  return err;
}

bool rotate_shape(int d, int k1, int levels, int base_log, int log_c) {
  return (d == 1 || d == 2 || d == 4 || d == K9R_MAX_D) && log_c >= 3 &&
         log_c <= K9_MAX_LOG_C && (1 << log_c) % d == 0 && k1 >= 1 && k1 <= K9_MAX_K1 &&
         levels >= 1 && levels <= K9_MAX_LEVELS && base_log >= 1 && base_log <= 30 &&
         base_log * levels < 64;
}

cudaLaunchConfig_t rotate_config(const RotatePlan& s, int batch, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(batch * s.cluster, 1, 1);
  cfg.blockDim = dim3(K9R_THREADS, 1, 1);
  cfg.dynamicSmemBytes = s.smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = s.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

extern "C" {

int tfhe_torch_poly_shard_forward(const long long* x, unsigned* out, const long long* consts,
                                  const long long* tw, const long long* twd, const long long* pw,
                                  int rows, int log_c, int levels, int base_log, void* stream) {
  if (rows <= 0 || log_c < 0 || log_c > K9_MAX_LOG_C || levels < 0 || levels > K9_MAX_LEVELS ||
      (levels > 0 && (base_log < 1 || base_log > 30 || base_log * levels >= 64))) {
    return cudaErrorInvalidValue;
  }
  const int nl = levels > 0 ? levels : 1;
  const int smem = (nl + 1) * (1 << log_c) * 4;
  if (smem > K9_SMEM) return cudaErrorInvalidValue;
  cudaError_t err = set_smem_once(ps_forward_kernel, K9_SMEM, false, forward_sized);
  if (err != cudaSuccess) return err;
  ps_forward_kernel<<<rows * NP, K9_THREADS, smem, (cudaStream_t)stream>>>(
      x, out, consts, tw, twd, pw, rows, log_c, levels, base_log);
  return cudaGetLastError();
}

int tfhe_torch_poly_shard_cross(const unsigned* ya, const unsigned* key, unsigned* out,
                                const long long* consts, const long long* pwd_f,
                                const long long* pwd_i, const long long* r2, int d, int cd,
                                int levels, int batch, int k1, long long key_stride,
                                int forward_only, void* stream) {
  if (d < 1 || d > 8 || cd < 1 || levels < 1 || batch < 1 || k1 < 1 || k1 > K9_MAX_K1 ||
      (!forward_only && key == nullptr)) {
    return cudaErrorInvalidValue;
  }
  const int smem = forward_only ? 0 : k1 * cd * d * 4;
  const int blocks = (forward_only ? levels * batch * k1 : batch) * NP;
  if (smem > K9_SMEM) return cudaErrorInvalidValue;
  cudaError_t err = set_smem_once(ps_cross_kernel, K9_SMEM, false, cross_sized);
  if (err != cudaSuccess) return err;
  ps_cross_kernel<<<blocks, K9_THREADS, smem, (cudaStream_t)stream>>>(
      ya, key, out, consts, pwd_f, pwd_i, r2, d, cd, levels, batch, k1, key_stride,
      forward_only);
  return cudaGetLastError();
}

int tfhe_torch_poly_shard_inverse(const unsigned* yb, long long* out, const long long* consts,
                                  const long long* twd_i, const long long* tw_ci,
                                  const long long* pw_i, int rows, int d, int log_c,
                                  void* stream) {
  if (rows <= 0 || d < 1 || log_c < 0 || log_c > K9_MAX_LOG_C || (1 << log_c) % d) {
    return cudaErrorInvalidValue;
  }
  const int smem = (2 + NP) * (1 << log_c) * 4;
  if (smem > K9_INVERSE_SMEM) return cudaErrorInvalidValue;
  cudaError_t err = set_smem_once(ps_inverse_kernel, K9_INVERSE_SMEM, false, inverse_sized);
  if (err != cudaSuccess) return err;
  ps_inverse_kernel<<<rows, K9_THREADS, smem, (cudaStream_t)stream>>>(
      yb, out, consts, twd_i, tw_ci, pw_i, rows, d, log_c);
  return cudaGetLastError();
}

// The fused entry (see the note above): out (B, k1, N) words of the
// rotation of lut (B, k1, N) by body (B,) and mask (B, n_steps), both
// int32 in [0, 2N), on the key (D, n_steps, l, k1, k1, NP, C) u32; tables
// (D, NP, 6, C), cross (NP, 2, D) u32; consts with R in place of N^-1;
// scratch (B, cluster, block_bytes) bytes where rotate_plan puts the shape
// in tier 3 (tfhe_torch_poly_shard_rotate_plan gives both), else null.
int tfhe_torch_poly_shard_rotate(long long* out, const long long* lut, const int* body,
                                 const int* mask, const unsigned* key, const unsigned* tables,
                                 const unsigned* cross, const long long* consts,
                                 unsigned char* scratch, int batch, int n_steps, int k1,
                                 int levels, int base_log, int d, int log_c, void* stream) {
  if (batch < 1 || n_steps < 0 || !rotate_shape(d, k1, levels, base_log, log_c)) {
    return cudaErrorInvalidValue;
  }
  const RotatePlan s = rotate_plan(d, k1, levels, log_c);
  if ((s.tier == 3 && scratch == nullptr) || (n_steps > 0 && key == nullptr)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = prepare_rotate();
  if (err != cudaSuccess) return err;
  RotateArgs g;
  g.out = out;
  g.lut = lut;
  g.body = body;
  g.mask = mask;
  g.key = key;
  g.tables = tables;
  g.cross = cross;
  g.consts = consts;
  g.scratch = scratch;
  g.words_bytes = s.words_bytes;
  g.rows_bytes = s.rows_bytes;
  g.block_bytes = s.block_bytes;
  g.n_steps = n_steps;
  g.k1 = k1;
  g.levels = levels;
  g.base_log = base_log;
  g.d = d;
  g.log_c = log_c;
  g.ppb = s.ppb;
  g.tier = s.tier;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = rotate_config(s, batch, (cudaStream_t)stream, attr);
  err = cudaLaunchKernelEx(&cfg, ps_rotate_kernel, g);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The fused kernel's plan at a shape on the current card, into plan[7]:
// primes a block, blocks a slot, blocks a cluster, tier, dynamic shared
// memory a block, block_bytes (the tier-3 scratch a block) and the clusters
// the card holds at once (cudaOccupancyMaxActiveClusters).  Returns 0 or
// the CUDA error.
int tfhe_torch_poly_shard_rotate_plan(int d, int k1, int levels, int log_c, long long* plan) {
  if (!rotate_shape(d, k1, levels, 1, log_c)) return cudaErrorInvalidValue;
  const RotatePlan s = rotate_plan(d, k1, levels, log_c);
  cudaError_t err = prepare_rotate();
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = rotate_config(s, 64, nullptr, attr);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, (void*)ps_rotate_kernel, &cfg);
  if (err != cudaSuccess) return err;
  const long long v[7] = {s.ppb, s.bps, s.cluster, s.tier, s.smem, s.block_bytes, clusters};
  for (int i = 0; i < 7; ++i) plan[i] = v[i];
  return cudaSuccess;
}

}  // extern "C"
