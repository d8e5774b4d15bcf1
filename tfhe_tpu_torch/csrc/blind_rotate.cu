// K2: classic blind rotation over the exact 4-prime CRT-NTT, for sm_90a.
//
// Replaces: tfhe_tpu/ops/pallas_mxu.py:1289 `build_blind_rotate_v5` in its v7
// configuration (jfold, trunc_acc: the TPU production kernel; meaning
// tfhe_tpu/ops/mxu.py:910 blind_rotate_mxu_trunc), and with trunc = 0
// tfhe_tpu/ops/pallas_ntt.py:794 `build_blind_rotate_v2` (the exact rotation,
// meaning tfhe_tpu/ops/server.py:367 blind_rotate).  Plain version:
// tfhe_tpu_torch/ops/server.py `blind_rotate`.
//
// For every batch element and every mask element a_i (i = 0 .. n-1):
//   ct1  = acc * X^{a_i} - acc
//   prod = sum_{lev, r} NTT^-1( NTT(residues(digit_lev(ct1_r))) . GGSW_i[lev][r] )
//          reconstructed mod 2^64 with Garner
//   acc += trunc ? round_to_2^32_grid(prod) : prod
// The v7 key is the centered-rounded key (ops/bsk_prep.round_bsk) applied on
// the host; on it the exact product equals the TPU's 3-prime rounded-key
// product, so one kernel computes both TPU functions.
//
// What bounds it: per step and batch element, 2 * l(k+1)P size-N NTTs plus
// the pointwise products and Garner: about 2.5e5 Montgomery products (three
// 32-bit multiplies each), against a 128 KB key slice that every batch
// element reads.  Integer multiply issue rate bounds it, not memory.
// Design: one thread block per batch element, looping over the n steps
// inside the kernel (the TPU's sequential grid axis becomes this loop;
// batch elements share no state, so blocks never synchronise).  The
// accumulator ((k+1) N u64) and the residues (l(k+1) P N u32) stay in shared
// memory for the whole rotation: about 100 KB at the 2_2 set, so two blocks
// fit on an SM.  Each NTT runs in passes of up to four radix-2 stages: a
// thread loads the 16 elements one pass touches into registers, does the
// four stages there and stores them back, so a transform costs three round
// trips through shared memory and three barriers instead of eleven.  Rows
// are padded by one word in 32 so that the strided loads of the passes do
// not collide in shared-memory banks.  The prime count is a compile-time
// constant.  The key slice is read from global memory in coalesced rows;
// all blocks walk the steps in the same order, so it is served mostly from
// L2.  Twiddles and constants come from the port's ops/ntt.py plan, uploaded
// once.

#include "ntt_common.cuh"

using namespace ntt_common;

namespace {

constexpr int POINTWISE_TILE = 4;
constexpr int MAXK1 = 5;        // k + 1 <= 5
constexpr int MAX_LEVELS = 8;

// K1T, LVT > 0 fix k + 1 and the level count at compile time (the 2_2 main
// path), so the pointwise product unrolls and its key loads overlap; 0 takes
// them from the arguments.
template <int K1T, int LVT>
__global__ void __launch_bounds__(THREADS, 2)
blind_rotate_kernel(long long* __restrict__ acc_g, const int* __restrict__ mask_g,
                    const u32* __restrict__ bsk, const u32* __restrict__ psi,
                    const u32* __restrict__ psi_inv,
                    const long long* __restrict__ consts_g, int n_steps, int k1_arg,
                    int log_n, int levels_arg, int base_log, int trunc) {
  const int k1 = K1T > 0 ? K1T : k1_arg;
  const int levels = LVT > 0 ? LVT : levels_arg;
  extern __shared__ u64 smem[];
  __shared__ Consts c;
  const int n_poly = 1 << log_n;
  const int row = padded_len(n_poly);       // padded residue row
  const int coeffs = k1 * n_poly;
  u64* acc = smem;                          // (k1, N)
  u32* res = (u32*)(smem + coeffs);         // (levels, k1, NP, row)
  const int tid = threadIdx.x;
  long long* acc_b = acc_g + (size_t)blockIdx.x * coeffs;
  const int* mask_b = mask_g + (size_t)blockIdx.x * n_steps;

  if (tid == 0) load_consts(c, consts_g);
  for (int q = tid; q < coeffs; q += THREADS) acc[q] = (u64)acc_b[q];
  __syncthreads();

  const int in_polys = levels * k1 * NP;
  const int out_polys = k1 * NP;
  const int level_stride = k1 * NP * row;
  const size_t step_words = (size_t)levels * k1 * k1 * NP * n_poly;

  for (int step = 0; step < n_steps; ++step) {
    const int a = mask_b[step];                 // in [0, 2N)
    const int rot = a & (n_poly - 1);
    const bool odd = ((a >> log_n) & 1) != 0;

    // 1. ct1 = acc * X^a - acc; signed digits; residues per prime
    for (int q = tid; q < coeffs; q += THREADS) {
      const int cpoly = q >> log_n;
      const int j = q & (n_poly - 1);
      u64 v = j < rot ? 0ull - acc[q - rot + n_poly] : acc[q - rot];
      if (odd) v = 0ull - v;
      write_digit_residues(res + cpoly * NP * row + pad(j), v - acc[q], base_log,
                           levels, level_stride, row, c);
    }
    __syncthreads();

    // 2. forward NTT of every (lev, r, prime) polynomial
    forward_ntt(res, in_polys, log_n, row, psi, c);

    // 3. pointwise multiply-accumulate with GGSW_step into slots (0, c); a
    // thread takes POINTWISE_TILE positions at once so that their key loads
    // are in flight together
    const u32* key = bsk + (size_t)step * step_words;
    for (int q0 = tid; q0 < NP * n_poly; q0 += POINTWISE_TILE * THREADS) {
      u32 out[POINTWISE_TILE][MAXK1];
#pragma unroll
      for (int u = 0; u < POINTWISE_TILE; ++u) {
#pragma unroll
        for (int cc = 0; cc < MAXK1; ++cc) out[u][cc] = 0u;
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
            if (cc < k1) res[(cc * NP + pi) * row + jp] = out[u][cc];
          }
        }
      }
    }
    __syncthreads();

    // 4. inverse NTT of the (k+1) P output polynomials (N^-1 folded into 5)
    inverse_ntt(res, out_polys, log_n, row, psi_inv, c);

    // 5. scale by N^-1, Garner to u64, optional 2^32-grid rounding, accumulate
    for (int q = tid; q < coeffs; q += THREADS) {
      const int cpoly = q >> log_n;
      const u64 x = garner_u64(res + cpoly * NP * row + pad(q & (n_poly - 1)), row, c);
      acc[q] += trunc ? round_hi32(x) : x;
    }
    __syncthreads();
  }

  for (int q = tid; q < coeffs; q += THREADS) acc_b[q] = (long long)acc[q];
}

}  // namespace

extern "C" int tfhe_torch_blind_rotate_smem_bytes(int k1, int n_poly, int levels) {
  return k1 * n_poly * 8 + levels * k1 * NP * padded_len(n_poly) * 4;
}

namespace {

template <int K1T, int LVT>
cudaError_t launch(long long* acc, const int* mask, const u32* bsk, const u32* psi,
                   const u32* psi_inv, const long long* consts, int batch, int n_steps,
                   int k1, int log_n, int levels, int base_log, int trunc, int smem,
                   cudaStream_t stream) {
  auto kernel = blind_rotate_kernel<K1T, LVT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  // all of the SM's unified memory as shared memory, so two blocks fit
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  kernel<<<batch, THREADS, smem, stream>>>(acc, mask, bsk, psi, psi_inv, consts, n_steps,
                                           k1, log_n, levels, base_log, trunc);
  return cudaGetLastError();
}

}  // namespace

extern "C" int tfhe_torch_blind_rotate(void* acc, const void* mask, const void* bsk,
                                       const void* psi, const void* psi_inv,
                                       const void* consts, int batch, int n_steps,
                                       int k1, int log_n, int levels, int nprimes,
                                       int base_log, int trunc, void* stream) {
  if (nprimes != NP || k1 < 1 || k1 > MAXK1 || levels < 1 ||
      levels > MAX_LEVELS || base_log < 1 || base_log * levels >= 64 ||
      log_n < 1 || log_n > 16 || batch < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int smem = tfhe_torch_blind_rotate_smem_bytes(k1, 1 << log_n, levels);
  auto run = (k1 == 2 && levels == 1) ? launch<2, 1> : launch<0, 0>;
  return (int)run((long long*)acc, (const int*)mask, (const u32*)bsk, (const u32*)psi,
                  (const u32*)psi_inv, (const long long*)consts, batch, n_steps, k1,
                  log_n, levels, base_log, trunc, smem, (cudaStream_t)stream);
}
