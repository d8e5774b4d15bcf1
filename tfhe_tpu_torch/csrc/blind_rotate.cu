// K2: classic blind rotation, for sm_90a.
//
// Replaces: tfhe_tpu/ops/pallas_mxu.py:1289 `build_blind_rotate_v5` in its v7
// configuration (jfold, trunc_acc: the TPU production kernel; meaning
// tfhe_tpu/ops/mxu.py:910 blind_rotate_mxu_trunc) and :1782
// `build_blind_rotate_v8` (the same function for decompression), in the
// rounded-key kernel; and, in the exact kernels,
// tfhe_tpu/ops/pallas_ntt.py:794 `build_blind_rotate_v2` (the exact rotation,
// meaning tfhe_tpu/ops/server.py:367 blind_rotate), :456 `build_blind_rotate`,
// :296 `build_cmux_step` (one step a launch) and, on a four-prime key of
// round_bsk(bsk), pallas_mxu.py:428/:809 `build_blind_rotate_v3`/`_v4`.
// Plain version: tfhe_tpu_torch/ops/server.py `blind_rotate`.
//
// For every batch element and every mask element a_i (i = 0 .. n-1):
//   ct1  = acc * X^{a_i} - acc
//   prod = sum_{lev, r} NTT^-1( NTT(residues(digit_lev(ct1_r))) . GGSW_i[lev][r] )
//          reconstructed mod 2^64 with Garner
//   acc += prod                        (exact kernel)
//   acc += round_to_2^32_grid(prod)    (v7: the rounded-key kernel)
//
// The rounded-key kernel (v7; blind_rotate_rounded_kernel) runs on
// ops/bsk_prep.py's RoundedKeyNtt: the NTT of the signed quotients
// b' = round(b) / 2^15, N^-1 folded in, over three primes where the CRT
// bound l (k+1) N 2^(base_log-1) 2^(63-rb) (2^83 at 2_2) stays below half
// their product (2^89), else four.  Garner's word is shifted left by 15, so
// it gives the words of the four-prime product on round_bsk(bsk, 15).
//
// What bounds it on the H100: integer issue.  A step of one ciphertext is
// 12 NTTs of N = 2048 (2 digit rows and 2 output rows on 3 primes), 12 N
// key products and 2 N Garner reconstructions, about 1.1e6 32-bit integer
// instructions; the key (98 KB a step) comes from L2, the accumulator and
// the residues never leave the SM.  The first design of v7 mode (the exact
// kernel's: one ciphertext a block, four primes on round_bsk(bsk), nine
// barriers a step, fully reduced Montgomery butterflies, the accumulator
// as u64 in shared memory) spent a quarter of a step in the key product
// and ran at 152.57 ms for B = 512 (NVIDIA H100 80GB HBM3, 700 W).
// Design here: C = 2 ciphertexts a block of 512 threads (one block an SM:
// 134,144 B of shared memory) share every key load (one 16-byte load
// holds a position's l (k+1)^2 words); the accumulator keeps only its
// high words (it lives on the 2^32 grid); the first forward pass takes the
// rotation, the decomposition and the residues in registers, the last
// forward pass the key product, the last inverse pass Garner, the shift
// and the rounding, so a step is six passes over shared memory with a
// barrier after each; lazy butterflies with Shoup twiddles
// (ntt_common.cuh) halve the instructions of a butterfly.
//
// Exact modes (four primes: they must reproduce the unrounded product).
// The first design (blind_rotate_kernel, below; 147.62 ms at B = 512 on
// the 2_2 shape, NVIDIA H100 80GB HBM3, 700 W) spent its steps about
// evenly in fully reduced forward passes, a key product of 4-byte loads
// each consumed at once, and fully reduced inverse passes, one ciphertext
// a block.  The lazy exact kernel (blind_rotate_exact_lazy_kernel, at
// k + 1 = 2, one level, N = 2048, base_log <= 30: the V1_4 2_2 shape)
// takes XC = 2 ciphertexts a block of 512 threads, one block an SM: their
// u64 accumulators and 4-prime residue rows in 200,704 B of shared memory;
// the exact key in its own (n, l, k+1, k+1, P, N) layout (K3's lazy exact
// kernel reads the same), read as 16-byte loads that feed both
// ciphertexts; the first forward pass fused with the u64 rotation, the
// one-level decomposition (from the high word) and the residues, the last
// with the key product (two products summed in 64 bits, one reduction),
// lazy Shoup passes, the last inverse pass fused with N^-1, Garner and the
// accumulation: six passes a step with a barrier after each.
//
// Generic exact kernel (blind_rotate_kernel), every other shape the
// wrapper takes (the TEST sets, k + 1 = 5, l > 1): one thread block per batch element,
// looping over the n steps inside the kernel (the TPU's sequential grid
// axis becomes this loop; batch elements share no state, so blocks never
// synchronise).  The accumulator ((k+1) N u64) and the residues
// (l (k+1) P N u32) stay in shared memory for the whole rotation: about
// 100 KB at the 2_2 set, so two blocks fit on an SM.  Each NTT runs in
// passes of up to four radix-2 stages in registers.  Rows are padded by
// one word in 32 so that the strided loads of the passes do not collide
// in shared-memory banks.  The key slice is read from global memory in
// coalesced rows; all blocks walk the steps in the same order, so it is
// served mostly from L2.  Twiddles and constants come from the port's
// ops/ntt.py plan, uploaded once.

#include "ntt_common.cuh"

using namespace ntt_common;

namespace {

constexpr int POINTWISE_TILE = 4;
constexpr int MAXK1 = 5;        // k + 1 <= 5
constexpr int MAX_LEVELS = 8;

// The pointwise multiply-accumulate of one step: residue slot (cc, prime)
// of res gets sum_{lev, r} res[(lev, r), prime] . key[lev][r][cc] in the
// NTT domain.  A thread takes POINTWISE_TILE positions at once so that their
// key loads are in flight together.  K1T > 0 fixes k + 1 at compile time.
template <int K1T>
__device__ __forceinline__ void key_product(u32* res, const u32* __restrict__ key, int k1_arg,
                                            int levels, int log_n, int row, const Consts& c) {
  const int k1 = K1T > 0 ? K1T : k1_arg;
  const int n_poly = 1 << log_n;
  const int tid = threadIdx.x;
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
}

// K1T, LVT > 0 fix k + 1 and the level count at compile time (the 2_2 main
// path), so the pointwise product unrolls and its key loads overlap; 0 takes
// them from the arguments.
template <int K1T, int LVT>
__global__ void __launch_bounds__(THREADS, 2)
blind_rotate_kernel(long long* __restrict__ acc_g, const int* __restrict__ mask_g,
                    const u32* __restrict__ bsk, const u32* __restrict__ psi,
                    const u32* __restrict__ psi_inv,
                    const long long* __restrict__ consts_g, int n_steps, int k1_arg,
                    int log_n, int levels_arg, int base_log) {
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

    // 3. pointwise multiply-accumulate with GGSW_step into slots (0, c)
    key_product<K1T>(res, bsk + (size_t)step * step_words, k1, levels, log_n, row, c);
    __syncthreads();

    // 4. inverse NTT of the (k+1) P output polynomials (N^-1 folded into 5)
    inverse_ntt(res, out_polys, log_n, row, psi_inv, c);

    // 5. scale by N^-1, Garner to u64, accumulate
    for (int q = tid; q < coeffs; q += THREADS) {
      const int cpoly = q >> log_n;
      acc[q] += garner_u64(res + cpoly * NP * row + pad(q & (n_poly - 1)), row, c);
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
                   int k1, int log_n, int levels, int base_log, int smem,
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
                                           k1, log_n, levels, base_log);
  return cudaGetLastError();
}

}  // namespace

extern "C" int tfhe_torch_blind_rotate(void* acc, const void* mask, const void* bsk,
                                       const void* psi, const void* psi_inv,
                                       const void* consts, int batch, int n_steps,
                                       int k1, int log_n, int levels, int nprimes,
                                       int base_log, void* stream) {
  if (nprimes != NP || k1 < 1 || k1 > MAXK1 || levels < 1 ||
      levels > MAX_LEVELS || base_log < 1 || base_log * levels >= 64 ||
      log_n < 1 || log_n > 16 || batch < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int smem = tfhe_torch_blind_rotate_smem_bytes(k1, 1 << log_n, levels);
  auto run = (k1 == 2 && levels == 1) ? launch<2, 1> : launch<0, 0>;
  return (int)run((long long*)acc, (const int*)mask, (const u32*)bsk, (const u32*)psi,
                  (const u32*)psi_inv, (const long long*)consts, batch, n_steps, k1,
                  log_n, levels, base_log, smem, (cudaStream_t)stream);
}


// ---------------------------------------------------------------------------
// The CMux entry (cmux_kernel): out = ct0 + GGSW (x) (ct1 - ct0) for a batch
// sharing one GGSW, the exact external product of the generic kernel's step
// with the operand given instead of acc * X^a - acc: the CMux tree of
// vertical packing (tfhe_tpu/shortint/wopbs.py:212-218 `_cmux`, an XLA
// external product there; tfhe_tpu has no Pallas kernel for it).  Plain
// version: tfhe_tpu_torch/ops/server.py `cmux`.  One block a batch element,
// the generic kernel's shared-memory layout; a block reads its ct0 row
// whole before it writes out, so out may be ct0.  The first design: since
// the cluster kernels' one-step CMux mode (csrc/blind_rotate_cluster.cu
// tfhe_torch_cmux_cluster) took WoPBS's tree (N = 512: 0.0129 against this
// kernel's 0.0310 ms at B = 1, 0.0198 against 0.0315 at B = 64) and the
// common-mask CMux (N = 2048: 0.0484 against 0.1312 ms at C = 3, B = 64;
// NVIDIA H100 80GB HBM3, 700 W), ops/kernels.py cmux_route sends it only
// the shapes neither takes.
// ---------------------------------------------------------------------------

namespace {

template <int K1T>
__global__ void __launch_bounds__(THREADS, 2)
cmux_kernel(long long* __restrict__ out_g, const long long* ct0_g,
            const long long* __restrict__ ct1_g, const u32* __restrict__ ggsw,
            const u32* __restrict__ psi, const u32* __restrict__ psi_inv,
            const long long* __restrict__ consts_g, int k1_arg, int log_n, int levels,
            int base_log) {
  const int k1 = K1T > 0 ? K1T : k1_arg;
  extern __shared__ u64 smem[];
  __shared__ Consts c;
  const int n_poly = 1 << log_n;
  const int row = padded_len(n_poly);
  const int coeffs = k1 * n_poly;
  u64* acc = smem;                          // (k1, N): ct0
  u32* res = (u32*)(smem + coeffs);         // (levels, k1, NP, row)
  const int tid = threadIdx.x;
  const size_t off = (size_t)blockIdx.x * coeffs;

  if (tid == 0) load_consts(c, consts_g);
  for (int q = tid; q < coeffs; q += THREADS) acc[q] = (u64)ct0_g[off + q];
  __syncthreads();
  const int level_stride = k1 * NP * row;
  for (int q = tid; q < coeffs; q += THREADS) {
    write_digit_residues(res + (q >> log_n) * NP * row + pad(q & (n_poly - 1)),
                         (u64)ct1_g[off + q] - acc[q], base_log, levels, level_stride, row, c);
  }
  __syncthreads();
  forward_ntt(res, levels * k1 * NP, log_n, row, psi, c);
  key_product<K1T>(res, ggsw, k1, levels, log_n, row, c);
  __syncthreads();
  inverse_ntt(res, k1 * NP, log_n, row, psi_inv, c);
  for (int q = tid; q < coeffs; q += THREADS) {
    out_g[off + q] = (long long)(acc[q] + garner_u64(res + (q >> log_n) * NP * row
                                                     + pad(q & (n_poly - 1)), row, c));
  }
}

}  // namespace

// ct0, ct1, out (batch, k+1, N) u64; ggsw (l, k+1, k+1, P, N) u32 Montgomery
// NTT domain; the generic kernel's shapes (smem: tfhe_torch_blind_rotate_smem_bytes).
extern "C" int tfhe_torch_cmux(void* out, const void* ct0, const void* ct1, const void* ggsw,
                               const void* psi, const void* psi_inv, const void* consts,
                               int batch, int k1, int log_n, int levels, int nprimes,
                               int base_log, void* stream) {
  if (nprimes != NP || k1 < 1 || k1 > MAXK1 || levels < 1 || levels > MAX_LEVELS ||
      base_log < 1 || base_log * levels >= 64 || log_n < 1 || log_n > 16 || batch < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int smem = tfhe_torch_blind_rotate_smem_bytes(k1, 1 << log_n, levels);
  auto kernel = k1 == 2 ? cmux_kernel<2> : cmux_kernel<0>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  kernel<<<batch, THREADS, smem, (cudaStream_t)stream>>>(
      (long long*)out, (const long long*)ct0, (const long long*)ct1, (const u32*)ggsw,
      (const u32*)psi, (const u32*)psi_inv, (const long long*)consts, k1, log_n, levels,
      base_log);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The lazy exact kernel (blind_rotate_exact_lazy_kernel): the exact rotation
// at k + 1 = 2, one level, N = 2048, base_log <= 30 on the exact key
// (n, 1, 2, 2, 4, N) int32 Montgomery, XC ciphertexts a block sharing every
// key load.
// ---------------------------------------------------------------------------

namespace {

constexpr int XC = 2;                   // ciphertexts a block
constexpr int X_LOG_N = 11;
constexpr int X_N = 1 << X_LOG_N;
constexpr int X_K1 = 2;
constexpr int X_ROW = X_N + X_N / 32;
constexpr int X_ROWS = XC * X_K1 * NP;  // residue rows (ct, r, prime), then (ct, cc, prime)
constexpr int X_GROUPS = X_N / 8;       // positions hi 8 .. hi 8 + 7 of the key product
// the rows and the accumulators (XC, K1, N) u64: 200,704 B
constexpr int X_SMEM = X_ROWS * X_ROW * 4 + XC * X_K1 * X_N * 8;

// The lazy kernel's shape (tfhe_torch_blind_rotate_exact_lazy_shape).
__host__ __device__ constexpr bool exact_lazy_shape(int k1, int log_n, int levels,
                                                    int base_log) {
  return k1 == X_K1 && log_n == X_LOG_N && levels == 1 && base_log >= 1 && base_log <= 30;
}

// Stages 0-3 of the forward transforms fused with what feeds them.  Task
// (ct, r, lo) owns coefficients j = b 2^7 | lo, b < 16, of row r of
// ciphertext ct: it forms acc X^a - acc in u64 (a = mask[ct n_steps] in
// [0, 2N)), takes each word's one-level signed digit from its high word
// (for base_log <= 30 the decomposition reads no bit below 2^32:
// hi_word_digit), and for each prime the residues d + 2p and four lazy
// stages in registers, stored once.
__device__ __forceinline__ void exact_first_forward(u32* res, const u64* acc,
                                                    const int* __restrict__ mask, int n_steps,
                                                    int base_log,
                                                    const uint2* __restrict__ tw,
                                                    const Consts& c) {
  constexpr int LO = X_LOG_N - 4;
  for (int q = threadIdx.x; q < (XC * X_K1) << LO; q += THREADS) {
    const int row = q >> LO;                    // ct K1 + r
    const int lo = q & ((1 << LO) - 1);
    const int a = __ldg(mask + (row / X_K1) * n_steps);
    const int rot = a & (X_N - 1);
    const bool odd = (a >> X_LOG_N) & 1;
    const u64* A = acc + row * X_N;
    int dig[16];
#pragma unroll
    for (int b = 0; b < 16; ++b) {
      const int j = (b << LO) | lo;
      u64 v = j < rot ? 0ull - A[j - rot + X_N] : A[j - rot];
      if (odd) v = 0ull - v;
      dig[b] = hi_word_digit((u32)((v - A[j]) >> 32), base_log);
    }
    u32* rows = res + row * NP * X_ROW + pad(lo);   // pad splits, as in lazy_pass
#pragma unroll
    for (int pi = 0; pi < NP; ++pi) {
      const u32 p = c.p[pi];
      u32 v[16];
#pragma unroll
      for (int b = 0; b < 16; ++b) v[b] = lazy_digit_residue(dig[b], p);
      lazy_forward_stages<4, X_LOG_N>(v, 0, 0, tw + (pi << X_LOG_N), p);
#pragma unroll
      for (int b = 0; b < 16; ++b) rows[pi * X_ROW + pad(b << LO)] = v[b];
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
blind_rotate_exact_lazy_kernel(long long* __restrict__ acc_g, const int* __restrict__ mask_g,
                               const uint4* __restrict__ bsk, const uint2* __restrict__ tw_fwd,
                               const uint2* __restrict__ tw_inv,
                               const long long* __restrict__ consts_g, int n_steps,
                               int base_log) {
  constexpr int ACC = XC * X_K1 * X_N;
  constexpr int STEP = X_K1 * X_K1 * NP * X_N / 4;   // 16-byte words of a step's GGSW
  extern __shared__ u64 x_smem[];
  __shared__ Consts c;
  u64* acc = x_smem;                            // (XC, K1, N)
  u32* res = (u32*)(x_smem + ACC);              // (X_ROWS, X_ROW)
  long long* acc_b = acc_g + (size_t)blockIdx.x * ACC;
  const int* mask_b = mask_g + (size_t)blockIdx.x * XC * n_steps;
  const int tid = threadIdx.x;
  if (tid == 0) load_consts(c, consts_g);
  for (int q = tid; q < ACC; q += THREADS) acc[q] = (u64)acc_b[q];
  __syncthreads();

  for (int step = 0; step < n_steps; ++step) {
    exact_first_forward(res, acc, mask_b + step, n_steps, base_log, tw_fwd, c);
    __syncthreads();
    lazy_pass<4, X_LOG_N, NP, THREADS, true>(res, X_ROWS, 4, tw_fwd, c);
    __syncthreads();
    const uint4* skey = bsk + (size_t)step * STEP;
    for (int q = tid; q < XC * NP * X_GROUPS; q += THREADS) {
      exact_key_product<XC, X_LOG_N>(res, q, skey, tw_fwd, c);
    }
    __syncthreads();
    lazy_pass<4, X_LOG_N, NP, THREADS, false>(res, X_ROWS, 0, tw_inv, c);
    __syncthreads();
    lazy_pass<4, X_LOG_N, NP, THREADS, false>(res, X_ROWS, 4, tw_inv, c);
    __syncthreads();
    exact_last_inverse<X_LOG_N, X_K1, NP, XC, THREADS, true>(res, acc, tw_inv, c);
    __syncthreads();
  }

  for (int q = tid; q < ACC; q += THREADS) acc_b[q] = (long long)acc[q];
}

}  // namespace

// The ciphertexts a block of the lazy exact kernel: the batch must be a
// multiple of it (ops/kernels.py pads).
extern "C" int tfhe_torch_blind_rotate_exact_cts_per_block() { return XC; }

// Which kernel K2's exact rotation runs at a shape: 1 for the lazy kernel, 0
// for the generic one.  The wrapper (ops/kernels.py) chooses by it.
extern "C" int tfhe_torch_blind_rotate_exact_lazy_shape(int k1, int log_n, int levels,
                                                       int base_log) {
  return exact_lazy_shape(k1, log_n, levels, base_log) ? 1 : 0;
}

// The lazy exact kernel: tw_fwd, tw_inv the plan's Shoup twiddle pairs,
// bsk the exact key (16-byte aligned); batch a multiple of XC.
extern "C" int tfhe_torch_blind_rotate_exact_lazy(void* acc, const void* mask, const void* bsk,
                                                  const void* tw_fwd, const void* tw_inv,
                                                  const void* consts, int batch, int n_steps,
                                                  int k1, int log_n, int levels, int nprimes,
                                                  int base_log, void* stream) {
  if (!exact_lazy_shape(k1, log_n, levels, base_log) || nprimes != NP || batch < XC ||
      batch % XC != 0 || n_steps < 1 || ((uintptr_t)bsk & 15) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  return (int)launch_blocks(blind_rotate_exact_lazy_kernel, batch / XC, X_SMEM,
                            (cudaStream_t)stream, (long long*)acc, (const int*)mask,
                            (const uint4*)bsk, (const uint2*)tw_fwd, (const uint2*)tw_inv,
                            (const long long*)consts, n_steps, base_log);
}

// ---------------------------------------------------------------------------
// v7 mode on a rounded kernel-layout key (ops/bsk_prep.py RoundedKeyNtt):
// NPT = 3 primes (4 where the CRT bound asks for them), C ciphertexts a
// block sharing every key load, the 2^32-grid accumulator's high words in
// shared memory, the fused first and last passes and the lazy butterflies
// of ntt_common.cuh.  Shape: k + 1 = 2, one level, N = 2048.
// ---------------------------------------------------------------------------

namespace {

template <int NPT>
__global__ void __launch_bounds__(RK_THREADS, 1)
blind_rotate_rounded_kernel(long long* __restrict__ acc_g, const int* __restrict__ mask_g,
                            const uint4* __restrict__ key, const uint2* __restrict__ tw_fwd,
                            const uint2* __restrict__ tw_inv,
                            const long long* __restrict__ consts_g, int n_steps,
                            int base_log, int rb) {
  extern __shared__ u32 rk_smem[];
  __shared__ Consts c;
  constexpr int ROWS = RK_C * RK_K1 * NPT;
  constexpr int ACC = RK_C * RK_K1 * RK_N;
  u32* res = rk_smem;
  u32* acc = rk_smem + ROWS * RK_ROW;           // (C, K1, N) high words
  long long* acc_b = acc_g + (size_t)blockIdx.x * ACC;
  const int* mask_b = mask_g + (size_t)blockIdx.x * RK_C * n_steps;
  const int tid = threadIdx.x;
  if (tid == 0) load_consts(c, consts_g);
  for (int q = tid; q < ACC; q += RK_THREADS) acc[q] = (u32)((u64)acc_b[q] >> 32);
  __syncthreads();

  for (int step = 0; step < n_steps; ++step) {
    fused_first_forward<RK_LOG_N, RK_K1, NPT, RK_C, RK_THREADS, true>(
        res, acc, mask_b + step, n_steps, base_log, tw_fwd, c);
    __syncthreads();
    lazy_pass<4, RK_LOG_N, NPT, RK_THREADS, true>(res, ROWS, 4, tw_fwd, c);
    __syncthreads();
    // the last forward pass fused with the key product, in place
    const uint4* skey = key + (size_t)step * NPT * RK_N;
    for (int q = tid; q < RK_C * NPT * (RK_N / 8); q += RK_THREADS) {
      u32 out[8][RK_K1];
      rk_key_product<NPT>(res, q, skey, tw_fwd, out, false, true, c);
    }
    __syncthreads();
    lazy_pass<4, RK_LOG_N, NPT, RK_THREADS, false>(res, ROWS, 0, tw_inv, c);
    __syncthreads();
    lazy_pass<4, RK_LOG_N, NPT, RK_THREADS, false>(res, ROWS, 4, tw_inv, c);
    __syncthreads();
    fused_last_inverse<RK_LOG_N, RK_K1, NPT, RK_C, RK_THREADS, true>(res, acc, rb, tw_inv, c);
    __syncthreads();
  }

  for (int q = tid; q < ACC; q += RK_THREADS) acc_b[q] = (long long)((u64)acc[q] << 32);
}

}  // namespace

// The ciphertexts a block of the rounded-key rotations (K2 v7 and K3 v9,
// ntt_common.cuh RK_C) take: the batch must be a multiple of it
// (ops/kernels.py pads).
extern "C" int tfhe_torch_rounded_cts_per_block() { return RK_C; }

// Dynamic shared memory of one block of either rounded-key rotation.
extern "C" int tfhe_torch_rounded_smem_bytes(int nprimes) {
  return nprimes == 3 ? rk_smem_bytes<3>() : rk_smem_bytes<4>();
}

extern "C" int tfhe_torch_blind_rotate_rounded(void* acc, const void* mask, const void* key,
                                               const void* tw_fwd, const void* tw_inv,
                                               const void* consts, int batch, int n_steps,
                                               int k1, int log_n, int levels, int nprimes,
                                               int base_log, int round_bits, void* stream) {
  if (k1 != RK_K1 || log_n != RK_LOG_N || levels != 1 || (nprimes != 3 && nprimes != 4) ||
      base_log < 1 || base_log > 30 || round_bits < 0 || round_bits > 32 || batch < RK_C ||
      batch % RK_C != 0 || n_steps < 1) {
    return (int)cudaErrorInvalidValue;
  }
  auto run = [&](auto kernel, int smem) {
    return (int)rk_launch(kernel, smem, batch, (cudaStream_t)stream, (long long*)acc,
                          (const int*)mask, (const uint4*)key, (const uint2*)tw_fwd,
                          (const uint2*)tw_inv, (const long long*)consts, n_steps, base_log,
                          round_bits);
  };
  return nprimes == 3 ? run(blind_rotate_rounded_kernel<3>, rk_smem_bytes<3>())
                      : run(blind_rotate_rounded_kernel<4>, rk_smem_bytes<4>());
}
