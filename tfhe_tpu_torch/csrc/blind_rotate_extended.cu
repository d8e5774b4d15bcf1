// K8: the extended blind rotation, for sm_90a.
//
// Replaces: tfhe_tpu/core/experimental.py:306 `extended_blind_rotate` (a
// lax.scan of XLA external products: tfhe_tpu has no Pallas kernel for it;
// lwe_extended_programmable_bootstrapping.rs:338-418, eprint 2025/2214).
// Generalises tfhe_tpu/ops/pallas_ntt.py:296 `build_cmux_step` to E
// slots.  Plain version: tfhe_tpu_torch/ops/server.py
// `blind_rotate_extended`.
//
// A LUT of N E coefficients is evaluated with the size-N bootstrap key: a
// ciphertext's accumulator lives as E interleaved (k+1, N) accumulators
// (slot j holds coefficients j, j+E, ...).  For each mask element a_i in
// [0, 2NE) and each slot j:
//   rotated_j = acc_{(j - a_i) mod E} * X^((E + a_i - 1 - j) >> log E)
//   acc_j    += GGSW_i (x) (rotated_j - acc_j)
// the degree lies in [0, 2N] (the negacyclic sign flips past N; 2N is
// the identity), and the external product is K2's exact one: the signed
// digits' residues on the four CRT primes, forward NTTs, the product with
// GGSW_i, inverse NTTs, N^-1 and Garner.
//
// What bounds it on the H100: 32-bit integer issue, as K2's generic exact
// kernel: E times the work of a classic rotation (a step of a slot at the
// 2_2 shape is 8 forward and 8 inverse NTTs of N = 2048, 16 N key products
// and 2 N Garner reconstructions); the key (262 KB a step) comes from L2.
//
// Design (a first, simple kernel): the slots' gather crosses slots, so the
// E slots of a ciphertext must see each other's previous accumulators.  A
// thread-block cluster of E blocks a ciphertext (E <= 8, the portable
// cluster size), block rank j holding slot j: its (k+1, N) u64
// accumulator and the residues of the l (k+1) digit polynomials in shared
// memory (K2's generic layout: 100,352 B at the 2_2 shape, two blocks an
// SM).  A step: every block reads its source slot's accumulator through
// distributed shared memory (cluster.map_shared_rank), forms rotated -
// acc and its digit residues; cluster barrier (no slot is overwritten
// before its readers are done); forward NTTs (ntt_common.cuh's exact
// passes), the key product, inverse NTTs, Garner into the accumulator;
// cluster barrier (every slot updated before the next step reads it).  All
// n steps run in one launch.

#include <cooperative_groups.h>

#include "ntt_common.cuh"

namespace cg = cooperative_groups;
using namespace ntt_common;

namespace {

constexpr int EX_MAXK1 = 5;          // k + 1 <= 5 (ops/kernels.py GENERIC_MAX_K1)
constexpr int EX_MAX_LEVELS = 8;
constexpr int EX_MAX_LOG_E = 3;      // E <= 8 (ops/kernels.py K8_FACTORS)
constexpr int EX_SMEM_LIMIT = 232448;

// The product with one GGSW: rows cc < k+1 of res get sum_{lev, r}
// res[(lev, r)] . ggsw[lev][r][cc] in the NTT domain, in place (a thread
// reads every row of its positions before it writes them).
__device__ __forceinline__ void ggsw_product(u32* res, const u32* __restrict__ ggsw, int k1,
                                             int levels, int log_n, int row, const Consts& c) {
  const int n_poly = 1 << log_n;
  for (int q = threadIdx.x; q < NP * n_poly; q += THREADS) {
    const int pi = q >> log_n;
    const int j = q & (n_poly - 1);
    const int at = pi * row + pad(j);
    const u32 p = c.p[pi];
    const u32 pinv = c.pinv[pi];
    u32 out[EX_MAXK1];
#pragma unroll
    for (int cc = 0; cc < EX_MAXK1; ++cc) out[cc] = 0u;
    for (int r = 0; r < levels * k1; ++r) {
      const u32 x = res[r * NP * row + at];
      const u32* krow = ggsw + ((size_t)r * k1 * NP + pi) * n_poly + j;
#pragma unroll
      for (int cc = 0; cc < EX_MAXK1; ++cc) {
        if (cc < k1) {
          out[cc] = add_mod(out[cc], mont_mul(x, __ldg(krow + (size_t)cc * NP * n_poly), p, pinv),
                            p);
        }
      }
    }
#pragma unroll
    for (int cc = 0; cc < EX_MAXK1; ++cc) {
      if (cc < k1) res[cc * NP * row + at] = out[cc];
    }
  }
}

__global__ void __launch_bounds__(THREADS, 2)
blind_rotate_extended_kernel(long long* __restrict__ acc_g, const int* __restrict__ mask_g,
                             const u32* __restrict__ bsk, const u32* __restrict__ psi,
                             const u32* __restrict__ psi_inv,
                             const long long* __restrict__ consts_g, int n_steps, int k1,
                             int log_n, int levels, int base_log, int log_e) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ u64 ex_smem[];
  __shared__ Consts c;
  const int e = 1 << log_e;
  const int slot = (int)cluster.block_rank();   // blockIdx.x mod E
  const int n_poly = 1 << log_n;
  const int row = padded_len(n_poly);
  const int coeffs = k1 * n_poly;
  u64* acc = ex_smem;                           // (k1, N): this slot
  u32* res = (u32*)(ex_smem + coeffs);          // (levels, k1, NP, row)
  const int tid = threadIdx.x;
  long long* acc_b = acc_g + (size_t)blockIdx.x * coeffs;   // (B, E, k1, N)
  const int* mask_b = mask_g + (size_t)(blockIdx.x >> log_e) * n_steps;

  if (tid == 0) load_consts(c, consts_g);
  for (int q = tid; q < coeffs; q += THREADS) acc[q] = (u64)acc_b[q];
  cluster.sync();   // constants loaded; every slot loaded before any is read

  const int level_stride = k1 * NP * row;
  const size_t step_words = (size_t)levels * k1 * k1 * NP * n_poly;
  for (int step = 0; step < n_steps; ++step) {
    const int a = mask_b[step];                 // in [0, 2 N E)
    const int src = (slot - a) & (e - 1);       // (j - a) mod E
    const int deg = (e + a - 1 - slot) >> log_e;   // in [0, 2N]
    const int rot = deg & (n_poly - 1);
    const bool odd = ((deg >> log_n) & 1) != 0;
    const u64* from = cluster.map_shared_rank(acc, src);

    // 1. rotated - acc from the source slot; signed digits; residues
    for (int q = tid; q < coeffs; q += THREADS) {
      const int cpoly = q >> log_n;
      const int j = q & (n_poly - 1);
      u64 v = j < rot ? 0ull - from[q - rot + n_poly] : from[q - rot];
      if (odd) v = 0ull - v;
      write_digit_residues(res + cpoly * NP * row + pad(j), v - acc[q], base_log, levels,
                           level_stride, row, c);
    }
    cluster.sync();   // every slot's reads of this step are done

    // 2. forward NTTs; 3. the product with GGSW_step; 4. inverse NTTs
    forward_ntt(res, levels * k1 * NP, log_n, row, psi, c);
    ggsw_product(res, bsk + (size_t)step * step_words, k1, levels, log_n, row, c);
    __syncthreads();
    inverse_ntt(res, k1 * NP, log_n, row, psi_inv, c);

    // 5. N^-1, Garner, accumulate
    for (int q = tid; q < coeffs; q += THREADS) {
      const int cpoly = q >> log_n;
      acc[q] += garner_u64(res + cpoly * NP * row + pad(q & (n_poly - 1)), row, c);
    }
    cluster.sync();   // every slot updated before the next step reads it
  }

  for (int q = tid; q < coeffs; q += THREADS) acc_b[q] = (long long)acc[q];
}

}  // namespace

// acc (batch, E, k+1, N) u64, updated in place; mask (batch, n_steps)
// int32 in [0, 2 N E); bsk the exact key (n_steps, l, k+1, k+1, NP, N) u32
// Montgomery; psi, psi_inv the plan's twiddles; E = 2^log_e; smem the
// dynamic shared memory of a block, (k+1) N 8 + l (k+1) NP row 4 bytes
// (ops/kernels.py exact_smem_bytes).  A cluster of E blocks a ciphertext.
extern "C" int tfhe_torch_blind_rotate_extended(void* acc, const void* mask, const void* bsk,
                                                const void* psi, const void* psi_inv,
                                                const void* consts, int batch, int n_steps,
                                                int k1, int log_n, int levels, int base_log,
                                                int log_e, int smem, void* stream) {
  if (batch < 1 || n_steps < 1 || k1 < 1 || k1 > EX_MAXK1 || levels < 1 ||
      levels > EX_MAX_LEVELS || base_log < 1 || base_log * levels >= 64 || log_n < 1 ||
      log_n > 16 || log_e < 0 || log_e > EX_MAX_LOG_E ||
      smem != k1 * (1 << log_n) * 8 + levels * k1 * NP * padded_len(1 << log_n) * 4 ||
      smem > EX_SMEM_LIMIT) {
    return (int)cudaErrorInvalidValue;
  }
  auto kernel = blind_rotate_extended_kernel;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(batch << log_e, 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1 << log_e;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, (long long*)acc, (const int*)mask, (const u32*)bsk,
                           (const u32*)psi, (const u32*)psi_inv, (const long long*)consts,
                           n_steps, k1, log_n, levels, base_log, log_e);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
