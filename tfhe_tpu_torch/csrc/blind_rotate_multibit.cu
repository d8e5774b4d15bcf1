// K3: multi-bit blind rotation over the exact 4-prime CRT-NTT, for sm_90a.
//
// Replaces: tfhe_tpu/ops/pallas_mxu.py:2631 `build_blind_rotate_v9g` and
// :2178 `build_blind_rotate_v9` (the same function, unrolled; meaning
// tfhe_tpu/ops/mxu.py:1133 blind_rotate_mxu_multibit with trunc=True), in v9
// mode; in exact mode the key-bundle rotation tfhe_tpu/ops/server.py:425
// blind_rotate_multibit, which the TPU runs in XLA.  Plain versions:
// tfhe_tpu_torch/ops/server.py `blind_rotate_multibit_v9` and
// `blind_rotate_multibit`.
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
// v9 runs on the host-rounded key (ops/bsk_prep.round_bsk at
// mb_round_bits); the exact product on it is the TPU's 3-prime product.
// Both modes sum the patterns' products in the CRT domain and reconstruct
// once; that equals summing the reconstructed products mod 2^64 while
// |sum| < P/2: at GROUP_4 2_2 the sum is below 2^g l (k+1) N 2^21 2^64 =
// 2^101 and the four primes give P/2 > 2^119.
//
// What bounds it: integer multiply issue rate.  At GROUP_4 2_2 in v9 mode
// each group and ciphertext takes 2^g l (k+1) P = 128 forward NTTs of size
// N, the pointwise products, 8 inverse NTTs and Garner: about 2.1e6
// Montgomery products (three 32-bit multiplies each), 230 groups a
// ciphertext.  The v9 function needs three primes (1.5e6 products), which
// on the CUDA cores' integer rate bounds B = 512 at about 33 ms
// (chip_smoke.py k3_bound); the key-bundle form needs half as many.  The
// key is 482 MB of residues that every block streams, 247 GB a B = 512
// call, from L2 where the blocks stay in step.
// Design: one thread block per batch element looping over the groups, all
// blocks in the same order so that one group's 2.1 MB key slice is served
// from L2 to the blocks in flight.  The accumulator ((k+1) N u64), the digit
// residues (l (k+1) P rows) and, in v9 mode, the NTT-domain pattern sum
// ((k+1) P rows) stay in shared memory: 164 KB at GROUP_4 2_2, one block an
// SM.  NTTs, decomposition and Garner are K2's (ntt_common.cuh).

#include "ntt_common.cuh"

using namespace ntt_common;

namespace {

constexpr int POINTWISE_TILE = 4;
constexpr int MAXK1 = 5;        // k + 1 <= 5
constexpr int MAX_LEVELS = 8;
constexpr int MAX_SUB = 16;     // 2^g patterns a group, g <= 4

// v9 mode: sum[(cc, pi)] (+)= sum_{lev, r} res[(lev, r, pi)] . E[lev][r][cc][pi]
// at every NTT position; first assigns.  A thread takes POINTWISE_TILE
// positions at once so that their key loads are in flight together.
template <int K1T, int LVT>
__device__ __forceinline__ void pattern_product(const u32* res, u32* sum,
                                                const u32* __restrict__ key, bool first,
                                                int k1_arg, int levels_arg, int log_n,
                                                int row, const Consts& c) {
  const int k1 = K1T > 0 ? K1T : k1_arg;
  const int levels = LVT > 0 ? LVT : levels_arg;
  const int n_poly = 1 << log_n;
  for (int q0 = threadIdx.x; q0 < NP * n_poly; q0 += POINTWISE_TILE * THREADS) {
    u32 out[POINTWISE_TILE][MAXK1];
#pragma unroll
    for (int u = 0; u < POINTWISE_TILE; ++u) {
      const int q = q0 + u * THREADS;
      const int pi = q >> log_n;
      const int jp = pad(q & (n_poly - 1));
#pragma unroll
      for (int cc = 0; cc < MAXK1; ++cc) {
        out[u][cc] = (first || cc >= k1 || q >= NP * n_poly)
                         ? 0u : sum[(cc * NP + pi) * row + jp];
      }
    }
    for (int r = 0; r < levels * k1; ++r) {
#pragma unroll
      for (int u = 0; u < POINTWISE_TILE; ++u) {
        const int q = q0 + u * THREADS;
        if (q < NP * n_poly) {
          const int pi = q >> log_n;
          const int j = q & (n_poly - 1);
          const u32 p = c.p[pi];
          const u32 x = res[(r * NP + pi) * row + pad(j)];
          const u32* krow = key + ((size_t)r * k1 * NP + pi) * n_poly + j;
#pragma unroll
          for (int cc = 0; cc < MAXK1; ++cc) {
            if (cc < k1) {
              out[u][cc] = add_mod(
                  out[u][cc], mont_mul(x, __ldg(krow + cc * NP * n_poly), p, c.pinv[pi]), p);
            }
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < POINTWISE_TILE; ++u) {
      const int q = q0 + u * THREADS;
      if (q < NP * n_poly) {
        const int pi = q >> log_n;
        const int jp = pad(q & (n_poly - 1));
#pragma unroll
        for (int cc = 0; cc < MAXK1; ++cc) {
          if (cc < k1) sum[(cc * NP + pi) * row + jp] = out[u][cc];
        }
      }
    }
  }
}

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
// 2_2 main path); 0 takes them from the arguments.
template <int K1T, int LVT>
__global__ void __launch_bounds__(THREADS, 1)
blind_rotate_multibit_kernel(long long* __restrict__ acc_g, const int* __restrict__ deg_g,
                             const u32* __restrict__ bsk, const u32* __restrict__ psi,
                             const u32* __restrict__ psi_inv,
                             const u32* __restrict__ mono,
                             const long long* __restrict__ consts_g, int n_groups,
                             int grouping, int k1_arg, int log_n, int levels_arg,
                             int base_log, int v9) {
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
  u32* sum = res + levels * level_stride;   // (k1, NP, row), v9 mode only
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

    if (v9) {
      for (int u = 0; u < n_sub; ++u) {
        const int d = d_s[u];                     // in [0, 2N)
        const int rot = d & (n_poly - 1);
        const bool odd = ((d >> log_n) & 1) != 0;
        // 1. X^d . acc (negacyclic), signed digits, residues per prime
        for (int q = tid; q < coeffs; q += THREADS) {
          const int cpoly = q >> log_n;
          const int j = q & (n_poly - 1);
          u64 v = j < rot ? 0ull - acc[q - rot + n_poly] : acc[q - rot];
          if (odd) v = 0ull - v;
          write_digit_residues(res + cpoly * NP * row + pad(j), v, base_log, levels,
                               level_stride, row, c);
        }
        __syncthreads();
        // 2. forward NTT of every (lev, r, prime) polynomial
        forward_ntt(res, in_polys, log_n, row, psi, c);
        // 3. this pattern's product into the NTT-domain sum
        pattern_product<K1T, LVT>(res, sum, key + u * pattern_words, u == 0, k1, levels,
                                  log_n, row, c);
        __syncthreads();
      }
      // 4. inverse NTT of the sum, Garner, the 2^32 grid; replaces acc
      inverse_ntt(sum, out_polys, log_n, row, psi_inv, c);
      for (int q = tid; q < coeffs; q += THREADS) {
        const int cpoly = q >> log_n;
        acc[q] = round_hi32(garner_u64(sum + cpoly * NP * row + pad(q & (n_poly - 1)),
                                       row, c));
      }
    } else {
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
    }
    __syncthreads();
  }

  for (int q = tid; q < coeffs; q += THREADS) acc_b[q] = (long long)acc[q];
}

}  // namespace

extern "C" int tfhe_torch_blind_rotate_multibit_smem_bytes(int k1, int n_poly, int levels,
                                                           int v9) {
  return k1 * n_poly * 8 + (levels * k1 + (v9 ? k1 : 0)) * NP * padded_len(n_poly) * 4;
}

namespace {

template <int K1T, int LVT>
cudaError_t launch(long long* acc, const int* deg, const u32* bsk, const u32* psi,
                   const u32* psi_inv, const u32* mono, const long long* consts,
                   int batch, int n_groups, int grouping, int k1, int log_n, int levels,
                   int base_log, int v9, int smem, cudaStream_t stream) {
  auto kernel = blind_rotate_multibit_kernel<K1T, LVT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  kernel<<<batch, THREADS, smem, stream>>>(acc, deg, bsk, psi, psi_inv, mono, consts,
                                           n_groups, grouping, k1, log_n, levels,
                                           base_log, v9);
  return cudaGetLastError();
}

}  // namespace

extern "C" int tfhe_torch_blind_rotate_multibit(void* acc, const void* deg, const void* bsk,
                                                const void* psi, const void* psi_inv,
                                                const void* mono, const void* consts,
                                                int batch, int n_groups, int grouping,
                                                int k1, int log_n, int levels, int nprimes,
                                                int base_log, int v9, void* stream) {
  if (nprimes != NP || grouping < 1 || (1 << grouping) > MAX_SUB || k1 < 1 ||
      k1 > MAXK1 || levels < 1 || levels > MAX_LEVELS || base_log < 1 ||
      base_log * levels >= 64 || log_n < 1 || log_n > 15 || batch < 1 ||
      n_groups < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int smem = tfhe_torch_blind_rotate_multibit_smem_bytes(k1, 1 << log_n, levels, v9);
  auto run = (k1 == 2 && levels == 1) ? launch<2, 1> : launch<0, 0>;
  return (int)run((long long*)acc, (const int*)deg, (const u32*)bsk, (const u32*)psi,
                  (const u32*)psi_inv, (const u32*)mono, (const long long*)consts, batch,
                  n_groups, grouping, k1, log_n, levels, base_log, v9, smem,
                  (cudaStream_t)stream);
}
