// K7: the GLWE keyswitch, for sm_90a.
//
// Replaces: tfhe_tpu/ops/server.py:862 `glwe_keyswitch` (an XLA function:
// tfhe_tpu has no Pallas kernel for it) and, with the other sign,
// tfhe_tpu/core/experimental.py:218 `glwe_fast_keyswitch` on a
// pseudo-GGSW.  Plain version: tfhe_tpu_torch/ops/server.py
// `glwe_keyswitch_sum`.
//
// For each GLWE b of the batch and output row cc:
//   sum_cc = sum_{i < k_in, lev < l} NTT(residues(digit_lev(mask_i))) . key[i][lev][cc]
// on the four CRT primes of ops/ntt.py, then the inverse transform, N^-1
// and Garner to u64, then the body:
//   out = (0, body) - sum          (glwe_keyswitch: the key encrypts S_in)
//   out = sum + (0, body)          (add_sum, the fast keyswitch: the
//                                   pseudo-GGSW encrypts -S_in)
// The CRT route gives tfhe_tpu's words at every shape, also where the
// integer sum passes P/2 and the reconstruction wraps (an exact mod-2^64
// product would agree only below P/2).
//
// What bounds it on the H100: 32-bit integer issue, as K2's generic exact
// kernel (a GLWE of the 2_2-width keyswitch, k_in = 1, l = 4, k_out+1 = 2,
// N = 2048, is 16 forward and 8 inverse NTTs of N = 2048 and 32 N key
// products); the key (4 k_in l (k_out+1) N u32 words: 256 KB there) is
// read by every block and served from L2.
//
// Design (a first, simple kernel): one block a GLWE.  Shared memory holds
// the k_out+1 output rows' NTT-domain sums on the four primes and a chunk
// of input rows (input polynomial i, level lev), as many as fit beside
// them (ops/kernels.py glwe_keyswitch_rows: 4 rows at the shape above,
// 202,752 B, one block an SM).  Per chunk: each row's digit residues,
// decomposed from the mask word in global memory, the forward transforms
// (ntt_common.cuh's exact passes), and the products with the chunk's key
// rows added into the sums.  Then one inverse transform of each sum row and
// Garner.  Rows are padded by one word in 32 (ntt_common.cuh pad).

#include "ntt_common.cuh"

using namespace ntt_common;

namespace {

constexpr int GK_MAX_OUT = 8;        // k_out + 1 <= 8 (ops/kernels.py K7_MAX_OUT)
constexpr int GK_SMEM_LIMIT = 232448;

// sum[cc] += sum_{r < rows} res[r] . key[g0 + r][cc] mod p for every
// position (prime pi, coefficient j) the thread owns; the key's row g is
// (input polynomial g / l, level g % l), Montgomery form.
__device__ __forceinline__ void chunk_product(u32* sum, const u32* res,
                                              const u32* __restrict__ key, int g0, int rows,
                                              int kout1, int log_n, int row, const Consts& c) {
  const int n_poly = 1 << log_n;
  for (int q = threadIdx.x; q < NP * n_poly; q += THREADS) {
    const int pi = q >> log_n;
    const int j = q & (n_poly - 1);
    const int at = pi * row + pad(j);
    const u32 p = c.p[pi];
    const u32 pinv = c.pinv[pi];
    u32 acc[GK_MAX_OUT];
#pragma unroll
    for (int cc = 0; cc < GK_MAX_OUT; ++cc) acc[cc] = cc < kout1 ? sum[cc * NP * row + at] : 0u;
    for (int r = 0; r < rows; ++r) {
      const u32 x = res[r * NP * row + at];
      const u32* krow = key + ((size_t)(g0 + r) * kout1 * NP + pi) * n_poly + j;
#pragma unroll
      for (int cc = 0; cc < GK_MAX_OUT; ++cc) {
        if (cc < kout1) {
          acc[cc] = add_mod(acc[cc], mont_mul(x, __ldg(krow + (size_t)cc * NP * n_poly), p, pinv),
                            p);
        }
      }
    }
#pragma unroll
    for (int cc = 0; cc < GK_MAX_OUT; ++cc) {
      if (cc < kout1) sum[cc * NP * row + at] = acc[cc];
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
glwe_keyswitch_kernel(long long* __restrict__ out_g, const long long* __restrict__ glwe_g,
                      const u32* __restrict__ key, const u32* __restrict__ psi,
                      const u32* __restrict__ psi_inv, const long long* __restrict__ consts_g,
                      int k_in, int kout1, int log_n, int levels, int base_log, int add_sum,
                      int chunk) {
  extern __shared__ u32 gk_smem[];
  __shared__ Consts c;
  const int n_poly = 1 << log_n;
  const int row = padded_len(n_poly);
  u32* sum = gk_smem;                           // (k_out+1, NP, row)
  u32* res = gk_smem + kout1 * NP * row;        // (chunk, NP, row)
  const int tid = threadIdx.x;
  const long long* glwe = glwe_g + (size_t)blockIdx.x * (k_in + 1) * n_poly;

  if (tid == 0) load_consts(c, consts_g);
  for (int q = tid; q < kout1 * NP * row; q += THREADS) sum[q] = 0u;
  __syncthreads();

  const int total = k_in * levels;
  for (int g0 = 0; g0 < total; g0 += chunk) {
    const int rows = min(chunk, total - g0);
    // 1. row r of the chunk: digit lev of mask polynomial i (g0 + r = i l +
    // lev, lowest level first), its residue for every prime
    for (int q = tid; q < rows * n_poly; q += THREADS) {
      const int r = q >> log_n;
      const int j = q & (n_poly - 1);
      const int i = (g0 + r) / levels;
      const int lev = (g0 + r) - i * levels;
      u64 state = decomposer_state((u64)glwe[(size_t)i * n_poly + j], base_log, levels);
      long long d = 0;
      for (int t = 0; t <= lev; ++t) d = next_digit(state, base_log);
      u32* x = res + r * NP * row + pad(j);
#pragma unroll
      for (int pi = 0; pi < NP; ++pi) {
        x[pi * row] = d < 0 ? (u32)((long long)c.p[pi] + d) : (u32)d;
      }
    }
    __syncthreads();
    // 2. forward NTT of the chunk's rows; 3. their products added into the sums
    forward_ntt(res, rows * NP, log_n, row, psi, c);
    chunk_product(sum, res, key, g0, rows, kout1, log_n, row, c);
    __syncthreads();
  }

  // 4. inverse NTT of the sums; 5. N^-1, Garner, the sign and the body
  inverse_ntt(sum, kout1 * NP, log_n, row, psi_inv, c);
  long long* out = out_g + (size_t)blockIdx.x * kout1 * n_poly;
  const long long* body = glwe + (size_t)k_in * n_poly;
  for (int q = tid; q < kout1 * n_poly; q += THREADS) {
    const int cc = q >> log_n;
    const int j = q & (n_poly - 1);
    u64 v = garner_u64(sum + cc * NP * row + pad(j), row, c);
    if (!add_sum) v = 0ull - v;
    if (cc == kout1 - 1) v += (u64)body[j];
    out[q] = (long long)v;
  }
}

}  // namespace

// out (batch, k_out+1, N), glwe (batch, k_in+1, N) u64; key (k_in, l,
// k_out+1, NP, N) u32 Montgomery NTT domain; psi, psi_inv the plan's
// twiddles; chunk the input rows transformed at once (ops/kernels.py
// glwe_keyswitch_rows), 1 <= chunk <= k_in l.
extern "C" int tfhe_torch_glwe_keyswitch(void* out, const void* glwe, const void* key,
                                         const void* psi, const void* psi_inv, const void* consts,
                                         int batch, int k_in, int kout1, int log_n, int levels,
                                         int base_log, int add_sum, int chunk, void* stream) {
  if (batch < 1 || k_in < 1 || kout1 < 1 || kout1 > GK_MAX_OUT || levels < 1 ||
      base_log < 1 || base_log * levels >= 64 || log_n < 1 || log_n > 16 || chunk < 1 ||
      chunk > k_in * levels) {
    return (int)cudaErrorInvalidValue;
  }
  const int smem = (kout1 + chunk) * NP * padded_len(1 << log_n) * 4;
  if (smem > GK_SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  return (int)launch_blocks(glwe_keyswitch_kernel, batch, smem, (cudaStream_t)stream,
                            (long long*)out, (const long long*)glwe, (const u32*)key,
                            (const u32*)psi, (const u32*)psi_inv, (const long long*)consts, k_in,
                            kout1, log_n, levels, base_log, add_sum, chunk);
}
