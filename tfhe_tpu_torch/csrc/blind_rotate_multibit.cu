// K3: multi-bit blind rotation, for sm_90a.
//
// Replaces: tfhe_tpu/ops/pallas_mxu.py:2631 `build_blind_rotate_v9g` and
// :2178 `build_blind_rotate_v9` (the same function, unrolled; meaning
// tfhe_tpu/ops/mxu.py:1133 blind_rotate_mxu_multibit with trunc=True), in
// the rounded-key kernel (v9 mode); in the exact kernel, the key-bundle
// rotation tfhe_tpu/ops/server.py:425 blind_rotate_multibit, which the TPU
// runs in XLA.  Plain versions: tfhe_tpu_torch/ops/server.py
// `blind_rotate_multibit_v9` and `blind_rotate_multibit`.
//
// The key holds, per group j of g mask elements, 2^g indicator GGSWs E_ju;
// degrees d_ju in [0, 2N) come from ops/server.py multibit_switched_degrees
// (d_j0 = 0).  Per batch element and group j = 0 .. n/g - 1:
//   v9:    acc <- round32( sum_u EP(E_ju, X^{d_ju} . acc) )
//          (the monomial on the data side: each pattern decomposes its own
//          rotated accumulator, so a negated coefficient is decomposed as it
//          is, never as the negated digits of its opposite);
//   exact: acc <- EP( E_j0 + sum_{u>0} NTT(X^{d_ju}) . E_ju, acc )
//          (the effective GGSW built pointwise in the NTT domain from the
//          monomial table, psi^{(2 br(t) + 1) d mod 4N}).
// Both modes sum the patterns' products in the CRT domain and reconstruct
// once; that equals summing the reconstructed products mod 2^64 while
// |sum| < P/2.  The rounded-key kernel runs on ops/bsk_prep.py's
// RoundedKeyNtt (the NTT of the quotients b / 2^rb, rb = mb_round_bits, 18
// at GROUP_4, N^-1 folded in): the sum's bound 2^g l (k+1) N 2^(base_log-1)
// 2^(63-rb) is 2^83 at GROUP_4 2_2, so three primes (P/2 = 2^89) hold it,
// and Garner's word shifted left by rb is the four-prime product's word.
//
// What bounds it on the H100: integer issue.  A group of one ciphertext in
// v9 mode is 2^g = 16 decompositions and 6-NTT forward sets, 16 key
// products, one inverse set and Garner, 230 groups a ciphertext at GROUP_4.
// The first design of v9 mode (the exact kernel's: one ciphertext a block,
// four primes on round_bsk(key), the pattern sum in shared memory, fully
// reduced butterflies) spent two fifths of a group in the key product (the
// 482 MB key streamed from L2 by every block) and ran at 456.93 ms for
// B = 512 (NVIDIA H100 80GB HBM3, 700 W).
// Design here (rounded-key kernel): K2's core (ntt_common.cuh) with C = 2
// ciphertexts a block of 512 threads, one block an SM, every 16-byte key
// load feeding both; the NTT-domain pattern sum stays in the registers of
// the thread whose task owns each position (three tasks of 8 positions, 48
// words a thread), so shared memory holds only the residues and the
// accumulator's high words (134,144 B); each pattern is three passes (the
// first forward pass fused with the rotation and decomposition, the
// second, the last fused with the key product), each group ends with
// three inverse passes, the last fused with Garner.  The exact kernel
// below keeps its design for the exact (key-bundle) mode.
//
// Exact kernel (blind_rotate_multibit_kernel): one thread block per batch
// element looping over the groups, all blocks in the same order so that one
// group's key slice is served from L2 to the blocks in flight.  The
// accumulator ((k+1) N u64) and the digit residues (l (k+1) P rows) stay in
// shared memory: 100,352 B at GROUP_4 2_2.  NTTs, decomposition and Garner
// are ntt_common.cuh's four-prime passes.

#include "ntt_common.cuh"

using namespace ntt_common;

namespace {

constexpr int MAXK1 = 5;        // k + 1 <= 5
constexpr int MAX_LEVELS = 8;
constexpr int MAX_SUB = 16;     // 2^g patterns a group, g <= 4

// Exact mode: at every NTT position t of prime pi, the effective GGSW entry
// eff = E_0 + sum_{u>0} w_u . E_u with w_u = NTT(X^{d_u})[t], and
// res[(cc, pi)] = sum_{lev, r} res[(lev, r, pi)] . eff[lev][r][cc], in place
// (a position's reads all come before its writes, and no other thread
// touches it).
template <int K1T, int LVT>
__device__ __forceinline__ void bundle_product(u32* res, const u32* __restrict__ key,
                                               const u32* __restrict__ mono,
                                               const int* d_s, int n_sub,
                                               size_t pattern_words, int k1_arg,
                                               int levels_arg, int log_n, int row,
                                               const Consts& c) {
  const int k1 = K1T > 0 ? K1T : k1_arg;
  const int levels = LVT > 0 ? LVT : levels_arg;
  const int n_poly = 1 << log_n;
  const u32 four_n_mask = 4u * n_poly - 1u;
  for (int q = threadIdx.x; q < NP * n_poly; q += THREADS) {
    const int pi = q >> log_n;
    const int t = q & (n_poly - 1);
    const u32 p = c.p[pi];
    const u32 pinv = c.pinv[pi];
    // NTT(X^d)[t] = psi^{(2 br(t) + 1) d mod 4N}; 4N divides 2^32, so the
    // product may wrap
    const u32 odd = 2u * (__brev((u32)t) >> (32 - log_n)) + 1u;
    const u32* mono_p = mono + (size_t)pi * 4 * n_poly;
    u32 w[MAX_SUB];
#pragma unroll
    for (int u = 1; u < MAX_SUB; ++u) {
      w[u] = u < n_sub ? __ldg(mono_p + ((odd * (u32)d_s[u]) & four_n_mask)) : 0u;
    }
    u32 out[MAXK1];
#pragma unroll
    for (int cc = 0; cc < MAXK1; ++cc) out[cc] = 0u;
    for (int r = 0; r < levels * k1; ++r) {
      const u32 x = res[(r * NP + pi) * row + pad(t)];
#pragma unroll
      for (int cc = 0; cc < MAXK1; ++cc) {
        if (cc < k1) {
          const u32* kq = key + ((size_t)(r * k1 + cc) * NP + pi) * n_poly + t;
          u32 eff = __ldg(kq);
#pragma unroll
          for (int u = 1; u < MAX_SUB; ++u) {
            if (u < n_sub) {
              eff = add_mod(eff, mont_mul(w[u], __ldg(kq + u * pattern_words), p, pinv), p);
            }
          }
          out[cc] = add_mod(out[cc], mont_mul(x, eff, p, pinv), p);
        }
      }
    }
#pragma unroll
    for (int cc = 0; cc < MAXK1; ++cc) {
      if (cc < k1) res[(cc * NP + pi) * row + pad(t)] = out[cc];
    }
  }
}

// K1T, LVT > 0 fix k + 1 and the level count at compile time (the GROUP_4
// 2_2 main path); 0 takes them from the arguments.  112 registers a thread
// at most (one block of THREADS an SM either way): left free, ptxas takes
// 119-122 and the kernel runs about 5 % slower (GROUP_4 2_2, B = 512, on an
// NVIDIA H100 80GB HBM3 at 700 W).
template <int K1T, int LVT>
__global__ void __maxnreg__(112)
blind_rotate_multibit_kernel(long long* __restrict__ acc_g, const int* __restrict__ deg_g,
                             const u32* __restrict__ bsk, const u32* __restrict__ psi,
                             const u32* __restrict__ psi_inv,
                             const u32* __restrict__ mono,
                             const long long* __restrict__ consts_g, int n_groups,
                             int grouping, int k1_arg, int log_n, int levels_arg,
                             int base_log) {
  const int k1 = K1T > 0 ? K1T : k1_arg;
  const int levels = LVT > 0 ? LVT : levels_arg;
  extern __shared__ u64 smem[];
  __shared__ Consts c;
  __shared__ int d_s[MAX_SUB];
  const int n_poly = 1 << log_n;
  const int n_sub = 1 << grouping;
  const int row = padded_len(n_poly);       // padded residue row
  const int coeffs = k1 * n_poly;
  const int level_stride = k1 * NP * row;
  u64* acc = smem;                          // (k1, N)
  u32* res = (u32*)(smem + coeffs);         // (levels, k1, NP, row)
  const int tid = threadIdx.x;
  long long* acc_b = acc_g + (size_t)blockIdx.x * coeffs;
  const int* deg_b = deg_g + (size_t)blockIdx.x * n_groups * n_sub;

  if (tid == 0) load_consts(c, consts_g);
  for (int q = tid; q < coeffs; q += THREADS) acc[q] = (u64)acc_b[q];

  const int in_polys = levels * k1 * NP;
  const int out_polys = k1 * NP;
  const size_t pattern_words = (size_t)levels * k1 * k1 * NP * n_poly;

  for (int grp = 0; grp < n_groups; ++grp) {
    if (tid < n_sub) d_s[tid] = deg_b[grp * n_sub + tid];
    __syncthreads();
    const u32* key = bsk + (size_t)grp * n_sub * pattern_words;

    // 1. signed digits of acc, residues per prime; forward NTT
    for (int q = tid; q < coeffs; q += THREADS) {
      const int cpoly = q >> log_n;
      const int j = q & (n_poly - 1);
      write_digit_residues(res + cpoly * NP * row + pad(j), acc[q], base_log, levels,
                           level_stride, row, c);
    }
    __syncthreads();
    forward_ntt(res, in_polys, log_n, row, psi, c);
    // 2. product with the effective GGSW, into slots (0, cc)
    bundle_product<K1T, LVT>(res, key, mono, d_s, n_sub, pattern_words, k1, levels,
                             log_n, row, c);
    __syncthreads();
    // 3. inverse NTT, Garner; replaces acc
    inverse_ntt(res, out_polys, log_n, row, psi_inv, c);
    for (int q = tid; q < coeffs; q += THREADS) {
      const int cpoly = q >> log_n;
      acc[q] = garner_u64(res + cpoly * NP * row + pad(q & (n_poly - 1)), row, c);
    }
    __syncthreads();
  }

  for (int q = tid; q < coeffs; q += THREADS) acc_b[q] = (long long)acc[q];
}

}  // namespace

extern "C" int tfhe_torch_blind_rotate_multibit_smem_bytes(int k1, int n_poly, int levels) {
  return k1 * n_poly * 8 + levels * k1 * NP * padded_len(n_poly) * 4;
}

namespace {

template <int K1T, int LVT>
cudaError_t launch(long long* acc, const int* deg, const u32* bsk, const u32* psi,
                   const u32* psi_inv, const u32* mono, const long long* consts,
                   int batch, int n_groups, int grouping, int k1, int log_n, int levels,
                   int base_log, int smem, cudaStream_t stream) {
  auto kernel = blind_rotate_multibit_kernel<K1T, LVT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  kernel<<<batch, THREADS, smem, stream>>>(acc, deg, bsk, psi, psi_inv, mono, consts,
                                           n_groups, grouping, k1, log_n, levels,
                                           base_log);
  return cudaGetLastError();
}

}  // namespace

extern "C" int tfhe_torch_blind_rotate_multibit(void* acc, const void* deg, const void* bsk,
                                                const void* psi, const void* psi_inv,
                                                const void* mono, const void* consts,
                                                int batch, int n_groups, int grouping,
                                                int k1, int log_n, int levels, int nprimes,
                                                int base_log, void* stream) {
  if (nprimes != NP || grouping < 1 || (1 << grouping) > MAX_SUB || k1 < 1 ||
      k1 > MAXK1 || levels < 1 || levels > MAX_LEVELS || base_log < 1 ||
      base_log * levels >= 64 || log_n < 1 || log_n > 15 || batch < 1 ||
      n_groups < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int smem = tfhe_torch_blind_rotate_multibit_smem_bytes(k1, 1 << log_n, levels);
  auto run = (k1 == 2 && levels == 1) ? launch<2, 1> : launch<0, 0>;
  return (int)run((long long*)acc, (const int*)deg, (const u32*)bsk, (const u32*)psi,
                  (const u32*)psi_inv, (const u32*)mono, (const long long*)consts, batch,
                  n_groups, grouping, k1, log_n, levels, base_log, smem,
                  (cudaStream_t)stream);
}


// ---------------------------------------------------------------------------
// v9 mode on a rounded kernel-layout key (ops/bsk_prep.py RoundedKeyNtt):
// NPT = 3 primes (4 where the CRT bound asks for them), C ciphertexts a
// block sharing every key load, the NTT-domain pattern sum in registers,
// the 2^32-grid accumulator's high words in shared memory, and the fused
// first and last passes and lazy butterflies of ntt_common.cuh.  Shape:
// k + 1 = 2, one level, N = 2048, g <= 4.
// ---------------------------------------------------------------------------

namespace {

template <int NPT>
__global__ void __launch_bounds__(RK_THREADS, 1)
blind_rotate_multibit_rounded_kernel(long long* __restrict__ acc_g,
                                     const int* __restrict__ deg_g,
                                     const uint4* __restrict__ key,
                                     const uint2* __restrict__ tw_fwd,
                                     const uint2* __restrict__ tw_inv,
                                     const long long* __restrict__ consts_g, int n_groups,
                                     int n_sub, int base_log, int rb) {
  extern __shared__ u32 rk_smem[];
  __shared__ Consts c;
  constexpr int ROWS = RK_C * RK_K1 * NPT;
  constexpr int ACC = RK_C * RK_K1 * RK_N;
  u32* res = rk_smem;
  u32* acc = rk_smem + ROWS * RK_ROW;           // (C, K1, N) high words
  long long* acc_b = acc_g + (size_t)blockIdx.x * ACC;
  const int deg_stride = n_groups * n_sub;      // one ciphertext's degrees
  const int* deg_b = deg_g + (size_t)blockIdx.x * RK_C * deg_stride;
  const int tid = threadIdx.x;
  if (tid == 0) load_consts(c, consts_g);
  for (int q = tid; q < ACC; q += RK_THREADS) acc[q] = (u32)((u64)acc_b[q] >> 32);
  __syncthreads();

  static_assert(rk_tasks_per_thread<NPT>() * RK_THREADS == RK_C * NPT * (RK_N / 8),
                "tasks must divide evenly among the threads");
  u32 sum[rk_tasks_per_thread<NPT>()][8][RK_K1];
  for (int grp = 0; grp < n_groups; ++grp) {
    const uint4* gkey = key + (size_t)grp * n_sub * NPT * RK_N;
    for (int u = 0; u < n_sub; ++u) {
      fused_first_forward<RK_LOG_N, RK_K1, NPT, RK_C, RK_THREADS, false>(
          res, acc, deg_b + grp * n_sub + u, deg_stride, base_log, tw_fwd, c);
      __syncthreads();
      lazy_pass<4, RK_LOG_N, NPT, RK_THREADS, true>(res, ROWS, 4, tw_fwd, c);
      __syncthreads();
      // the last forward pass fused with this pattern's key product, into
      // the sum (in the registers of the thread whose task owns each
      // position); the last pattern writes it over the residue rows
      const uint4* pkey = gkey + (size_t)u * NPT * RK_N;
#pragma unroll
      for (int i = 0; i < rk_tasks_per_thread<NPT>(); ++i) {
        rk_key_product<NPT>(res, i * RK_THREADS + tid, pkey, tw_fwd, sum[i], u > 0,
                            u == n_sub - 1, c);
      }
      __syncthreads();
    }
    lazy_pass<4, RK_LOG_N, NPT, RK_THREADS, false>(res, ROWS, 0, tw_inv, c);
    __syncthreads();
    lazy_pass<4, RK_LOG_N, NPT, RK_THREADS, false>(res, ROWS, 4, tw_inv, c);
    __syncthreads();
    fused_last_inverse<RK_LOG_N, RK_K1, NPT, RK_C, RK_THREADS, false>(res, acc, rb, tw_inv, c);
    __syncthreads();
  }

  for (int q = tid; q < ACC; q += RK_THREADS) acc_b[q] = (long long)((u64)acc[q] << 32);
}

}  // namespace

extern "C" int tfhe_torch_blind_rotate_multibit_rounded(
    void* acc, const void* deg, const void* key, const void* tw_fwd, const void* tw_inv,
    const void* consts, int batch, int n_groups, int grouping, int k1, int log_n, int levels,
    int nprimes, int base_log, int round_bits, void* stream) {
  if (k1 != RK_K1 || log_n != RK_LOG_N || levels != 1 || (nprimes != 3 && nprimes != 4) ||
      grouping < 1 || grouping > 4 || base_log < 1 || base_log > 30 || round_bits < 0 ||
      round_bits > 32 || batch < RK_C || batch % RK_C != 0 || n_groups < 1) {
    return (int)cudaErrorInvalidValue;
  }
  auto run = [&](auto kernel, int smem) {
    return (int)rk_launch(kernel, smem, batch, (cudaStream_t)stream, (long long*)acc,
                          (const int*)deg, (const uint4*)key, (const uint2*)tw_fwd,
                          (const uint2*)tw_inv, (const long long*)consts, n_groups,
                          1 << grouping, base_log, round_bits);
  };
  return nprimes == 3 ? run(blind_rotate_multibit_rounded_kernel<3>, rk_smem_bytes<3>())
                      : run(blind_rotate_multibit_rounded_kernel<4>, rk_smem_bytes<4>());
}
