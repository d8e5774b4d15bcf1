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
// three inverse passes, the last fused with Garner.
//
// Exact mode (the key bundle) bounds differently: what held the first exact
// kernel (one ciphertext a block, 330.83 ms at B = 512 on an NVIDIA H100
// 80GB HBM3 at 700 W) was the bundle, 90 % of a group: 16 pattern words a
// (row, column, prime, position), each a 4-byte load consumed at once by a
// fully reduced Montgomery product, so the block waited on L2 latency.
// Design of the lazy exact kernel (blind_rotate_multibit_lazy_kernel,
// k + 1 = 2, one level, N = 2048, g = 2 or 4, four primes): XC = 2
// ciphertexts a block of 512 threads (217,088 B of shared memory: their
// residue rows, their u64 accumulators and one prime's monomial table);
// the first forward pass takes the u64 decomposition and four lazy stages
// in registers; the bundle's key words come as 8-byte loads (two
// positions) that feed both ciphertexts, the monomials psi^e from the
// one-period table in shared memory, and its products are summed in 64
// bits with one Montgomery reduction every four patterns; the last inverse
// pass takes N^-1 and Garner into the accumulator (ntt_common.cuh
// exact_last_inverse).  Other exact shapes (GROUP_3's l = 2, g = 1,
// k + 1 != 2) run the generic kernel (blind_rotate_multibit_kernel, the
// first design): one block per batch element, the accumulator and the digit
// residues in shared memory, ntt_common.cuh's fully reduced passes.

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
__device__ __forceinline__ void bundle_product(u32* res, const u32* __restrict__ key,
                                               const u32* __restrict__ mono,
                                               const int* d_s, int n_sub,
                                               size_t pattern_words, int k1,
                                               int levels, int log_n, int row,
                                               const Consts& c) {
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

// The generic instance (the first design): every shape the wrapper accepts.
__global__ void __launch_bounds__(THREADS, 1)
blind_rotate_multibit_kernel(long long* __restrict__ acc_g, const int* __restrict__ deg_g,
                             const u32* __restrict__ bsk, const u32* __restrict__ psi,
                             const u32* __restrict__ psi_inv,
                             const u32* __restrict__ mono,
                             const long long* __restrict__ consts_g, int n_groups,
                             int grouping, int k1, int log_n, int levels, int base_log) {
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
    bundle_product(res, key, mono, d_s, n_sub, pattern_words, k1, levels,
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

// ---------------------------------------------------------------------------
// The lazy exact kernel (blind_rotate_multibit_lazy_kernel): k + 1 = 2, one
// level, N = 2048, four primes, 2^g = NSUB patterns a group, XC ciphertexts
// a block sharing every key load.
// ---------------------------------------------------------------------------

constexpr int XC = 2;                   // ciphertexts a block
constexpr int X_LOG_N = 11;
constexpr int X_N = 1 << X_LOG_N;
constexpr int X_K1 = 2;
constexpr int X_ROW = X_N + X_N / 32;
constexpr int X_ROWS = XC * X_K1 * NP;  // residue rows (ct, r, prime), then (ct, cc, prime)
// the rows, the accumulators (XC, K1, N) u64 and one prime's monomial
// table psi^e, e < 2N (psi has order 2N): 217,088 B
constexpr int X_SMEM = X_ROWS * X_ROW * 4 + XC * X_K1 * X_N * 8 + 2 * X_N * 4;

__host__ __device__ constexpr bool lazy_exact_shape(int k1, int log_n, int levels,
                                                    int grouping, int base_log) {
  return k1 == X_K1 && log_n == X_LOG_N && levels == 1 && (grouping == 2 || grouping == 4) &&
         base_log <= 30;
}

template <int NSUB>
__global__ void __launch_bounds__(THREADS, 1)
blind_rotate_multibit_lazy_kernel(long long* __restrict__ acc_g, const int* __restrict__ deg_g,
                                  const uint2* __restrict__ bsk,
                                  const uint2* __restrict__ tw_fwd,
                                  const uint2* __restrict__ tw_inv,
                                  const u32* __restrict__ mono,
                                  const long long* __restrict__ consts_g, int n_groups,
                                  int base_log) {
  constexpr int N = X_N;
  constexpr int LO = X_LOG_N - 4;
  extern __shared__ u64 x_smem[];
  __shared__ Consts c;
  __shared__ int d_s[XC][NSUB];
  u64* acc = x_smem;                              // (XC, K1, N)
  u32* res = (u32*)(x_smem + XC * X_K1 * N);      // (X_ROWS, X_ROW)
  u32* mono_s = res + X_ROWS * X_ROW;             // (2N), one prime
  const int tid = threadIdx.x;
  long long* acc_b = acc_g + (size_t)blockIdx.x * XC * X_K1 * N;
  const int* deg_b = deg_g + (size_t)blockIdx.x * XC * n_groups * NSUB;
  if (tid == 0) load_consts(c, consts_g);
  for (int q = tid; q < XC * X_K1 * N; q += THREADS) acc[q] = (u64)acc_b[q];

  for (int grp = 0; grp < n_groups; ++grp) {
    if (tid < XC * NSUB) {
      d_s[tid / NSUB][tid % NSUB] = deg_b[((tid / NSUB) * n_groups + grp) * NSUB + tid % NSUB];
    }
    __syncthreads();
    // 1. the one-level signed digits of acc and, for each prime, their
    // residues and forward stages 0-3 in registers: task (ct, r, lo) owns
    // coefficients b 2^7 | lo
    for (int q = tid; q < (XC * X_K1) << LO; q += THREADS) {
      const int row = q >> LO;                    // ct K1 + r
      const int lo = q & ((1 << LO) - 1);
      const u64* A = acc + row * N + lo;
      int dig[16];
#pragma unroll
      for (int b = 0; b < 16; ++b) {
        u64 state = decomposer_state(A[b << LO], base_log, 1);
        dig[b] = (int)next_digit(state, base_log);
      }
      u32* rows = res + row * NP * X_ROW + pad(lo);
#pragma unroll
      for (int pi = 0; pi < NP; ++pi) {
        const u32 p = c.p[pi];
        u32 v[16];
#pragma unroll
        for (int b = 0; b < 16; ++b) v[b] = lazy_digit_residue(dig[b], p);
        lazy_forward_stages<4, X_LOG_N>(v, 0, 0, tw_fwd + (pi << X_LOG_N), p);
#pragma unroll
        for (int b = 0; b < 16; ++b) rows[pi * X_ROW + pad(b << LO)] = v[b];
      }
    }
    __syncthreads();
    lazy_pass<4, X_LOG_N, NP, THREADS, true>(res, X_ROWS, 4, tw_fwd, c);
    __syncthreads();
    lazy_pass<3, X_LOG_N, NP, THREADS, true>(res, X_ROWS, 8, tw_fwd, c);
    __syncthreads();

    // 2. the bundle eff = E_0 + sum_u w_u E_u of each ciphertext, w_u =
    // NTT(X^{d_u})[t] from the monomial table in shared memory, summed in
    // 64 bits with one Montgomery reduction for every four patterns; then
    // the product with the digits' transform, over the rows (ct, cc, prime).
    // Task: two positions of one prime, both ciphertexts, each key load
    // (8 bytes) feeding both.
    const uint2* gkey = bsk + (size_t)grp * NSUB * X_K1 * X_K1 * NP * (N / 2);
    for (int pi = 0; pi < NP; ++pi) {
      const u32 p = c.p[pi];
      const u32 pinv = c.pinv[pi];
      for (int q = tid; q < 2 * N; q += THREADS) mono_s[q] = __ldg(mono + (size_t)pi * 4 * N + q);
      __syncthreads();
      for (int q = tid; q < N / 2; q += THREADS) {
        const int t0 = 2 * q;
        const int at = pad(t0);                   // pad(t0 + 1) = at + 1
        u32 odd[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) odd[e] = 2u * (__brev((u32)(t0 + e)) >> (32 - X_LOG_N)) + 1u;
        u32 part[XC][4][2];
        u64 sum[XC][4][2];
#pragma unroll
        for (int en = 0; en < 4; ++en) {
          const uint2 k = __ldg(gkey + (en * NP + pi) * (N / 2) + q);
#pragma unroll
          for (int ct = 0; ct < XC; ++ct) {
            part[ct][en][0] = k.x;
            part[ct][en][1] = k.y;
            sum[ct][en][0] = sum[ct][en][1] = 0;
          }
        }
#pragma unroll
        for (int u = 1; u < NSUB; ++u) {
          uint2 k[4];
#pragma unroll
          for (int en = 0; en < 4; ++en) {
            k[en] = __ldg(gkey + ((u * 4 + en) * NP + pi) * (N / 2) + q);
          }
#pragma unroll
          for (int ct = 0; ct < XC; ++ct) {
            const u32 d = (u32)d_s[ct][u];
            const u32 w0 = mono_s[(odd[0] * d) & (2 * N - 1)];
            const u32 w1 = mono_s[(odd[1] * d) & (2 * N - 1)];
#pragma unroll
            for (int en = 0; en < 4; ++en) {
              sum[ct][en][0] += (u64)w0 * k[en].x;
              sum[ct][en][1] += (u64)w1 * k[en].y;
            }
          }
          if (u % 4 == 0 || u == NSUB - 1) {
#pragma unroll
            for (int ct = 0; ct < XC; ++ct) {
#pragma unroll
              for (int en = 0; en < 4; ++en) {
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  part[ct][en][e] =
                      reduce_to(part[ct][en][e] + redc_lazy(sum[ct][en][e], p, pinv), 2 * p);
                  sum[ct][en][e] = 0;
                }
              }
            }
          }
        }
#pragma unroll
        for (int ct = 0; ct < XC; ++ct) {
          u32 x[X_K1][2];
#pragma unroll
          for (int r = 0; r < X_K1; ++r) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              x[r][e] = reduce_to(reduce_to(res[((ct * X_K1 + r) * NP + pi) * X_ROW + at + e],
                                            2 * p), p);
            }
          }
#pragma unroll
          for (int cc = 0; cc < X_K1; ++cc) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              u64 t = 0;
#pragma unroll
              for (int r = 0; r < X_K1; ++r) {
                t += (u64)x[r][e] * reduce_to(part[ct][r * X_K1 + cc][e], p);
              }
              // every x of this ciphertext and position was read above, so
              // writing row (ct, cc) over row (ct, r = cc) is safe
              res[((ct * X_K1 + cc) * NP + pi) * X_ROW + at + e] = redc_lazy(t, p, pinv);
            }
          }
        }
      }
      __syncthreads();
    }

    // 3. inverse passes; the last fused with N^-1 and Garner into acc
    lazy_pass<4, X_LOG_N, NP, THREADS, false>(res, X_ROWS, 0, tw_inv, c);
    __syncthreads();
    lazy_pass<4, X_LOG_N, NP, THREADS, false>(res, X_ROWS, 4, tw_inv, c);
    __syncthreads();
    exact_last_inverse<X_LOG_N, X_K1, NP, XC, THREADS>(res, acc, tw_inv, c);
    __syncthreads();
  }

  for (int q = tid; q < XC * X_K1 * N; q += THREADS) acc_b[q] = (long long)acc[q];
}

}  // namespace

extern "C" int tfhe_torch_blind_rotate_multibit_smem_bytes(int k1, int n_poly, int levels) {
  return k1 * n_poly * 8 + levels * k1 * NP * padded_len(n_poly) * 4;
}

// The ciphertexts a block of the exact kernel this shape runs: XC on the
// lazy kernel's shapes (the wrapper pads the batch to a multiple), else 1.
extern "C" int tfhe_torch_blind_rotate_multibit_cts_per_block(int k1, int log_n, int levels,
                                                              int grouping, int base_log) {
  return lazy_exact_shape(k1, log_n, levels, grouping, base_log) ? XC : 1;
}

// Exact mode: psi, psi_inv, the plan's Montgomery twiddles (the generic
// kernel); tw_fwd, tw_inv, their Shoup pairs (the lazy kernel); mono, the
// (P, 4N) monomial table.  On the lazy kernel's shapes batch must be a
// multiple of XC.
extern "C" int tfhe_torch_blind_rotate_multibit(void* acc, const void* deg, const void* bsk,
                                                const void* psi, const void* psi_inv,
                                                const void* tw_fwd, const void* tw_inv,
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
  const cudaStream_t st = (cudaStream_t)stream;
  if (lazy_exact_shape(k1, log_n, levels, grouping, base_log)) {
    if (batch % XC != 0) return (int)cudaErrorInvalidValue;
    auto kernel = grouping == 4 ? blind_rotate_multibit_lazy_kernel<16>
                                : blind_rotate_multibit_lazy_kernel<4>;
    return (int)launch_blocks(kernel, batch / XC, X_SMEM, st, (long long*)acc,
                              (const int*)deg, (const uint2*)bsk, (const uint2*)tw_fwd,
                              (const uint2*)tw_inv, (const u32*)mono,
                              (const long long*)consts, n_groups, base_log);
  }
  return (int)launch_blocks(blind_rotate_multibit_kernel, batch,
                            tfhe_torch_blind_rotate_multibit_smem_bytes(k1, 1 << log_n, levels),
                            st, (long long*)acc, (const int*)deg, (const u32*)bsk,
                            (const u32*)psi, (const u32*)psi_inv, (const u32*)mono,
                            (const long long*)consts, n_groups, grouping, k1, log_n, levels,
                            base_log);
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
