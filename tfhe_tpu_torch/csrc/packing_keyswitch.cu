// K4: packing keyswitch (LWE list -> GLWEs), wrapping u64, for sm_90a.
//
// Replaces: tfhe_tpu/ops/server.py:537 `packing_keyswitch`, which the TPU runs
// as an XLA contraction over a 4-prime CRT-NTT (one call per packed GLWE,
// tfhe_tpu/shortint/compression.py:236-244).  Plain version:
// tfhe_tpu_torch/ops/server.py `packing_keyswitch`.
//
// For GLWE g, holding LWEs j = 0 .. b_g-1 of the batch:
//   out_g[c] = (c == k ? B(X) : 0) - sum_{i, lev} D_{i,lev}(X) * PKSK[i, lev, c](X)
// mod (X^N + 1, 2^64), where D_{i,lev} holds the level-lev signed digit of
// mask element i of LWE j as its coefficient j and B(X) the bodies.  The sum
// is taken directly in wrapping u64: every product and sum is then exact mod
// 2^64, which is the word tfhe_tpu's CRT-NTT route reconstructs (its exact
// integer stays far below P/2).
//
// What bounds it: the direct product is n l (k+1) N b_g multiply-adds of a
// small signed digit by a u64 key word per GLWE, about 2e9 at the production
// set (n = 2048, l = 3, k+1 = 5, N = 256, b_g = 256), against a 63 MB key:
// the integer multiply rate bounds it, not memory.
// Design: a block owns one output polynomial c of one GLWE and a range of
// input rows i; blocks of the same (g, c) add their partial sums into the
// zeroed output with 64-bit atomics (wrapping addition is exact in any
// order).  Inside a block, LANES rows are processed at a time, each by
// N / TPT threads that own TPT neighbouring output coefficients.  The rows'
// digits, all levels, are decomposed once into shared memory; for each level
// the key polynomial is staged as Kx[m] = -K[m] (m < N), K[m - N] (m >= N),
// so that coefficient t gains D[j] * Kx[t - j + N] with no branch for the
// negacyclic wrap.  A thread walks j keeping the TPT key words it needs in a
// ring of registers: one shared-memory load feeds TPT multiply-adds.

#include "ntt_common.cuh"

using ntt_common::decomposer_state;
using ntt_common::next_digit;

namespace {

typedef unsigned long long u64;

constexpr int THREADS = 256;
constexpr int TPT = 4;                       // output coefficients per thread
constexpr int SLOTS = THREADS * TPT;         // LANES * N
constexpr int ROUNDS = 16;                   // row groups per block
constexpr int MIN_N = 16;
constexpr int MAX_N = SLOTS;
constexpr int MAX_LEVELS = 8;

__global__ void __launch_bounds__(THREADS)
packing_keyswitch_kernel(u64* __restrict__ out, const u64* __restrict__ lwes,
                         const u64* __restrict__ pksk, int batch, int n_in, int levels,
                         int k1, int log_n, int per_glwe, int base_log) {
  extern __shared__ u64 smem[];
  const int n_poly = 1 << log_n;
  const int lanes = SLOTS >> log_n;
  u64* kx = smem;                               // (lanes, 2N)
  int* digit = (int*)(smem + 2 * SLOTS);        // (levels, lanes, N)

  const int g = blockIdx.x;
  const int c = blockIdx.y;
  const int rows = lanes * ROUNDS;
  const int i_begin = blockIdx.z * rows;
  const int i_end = min(n_in, i_begin + rows);
  const int first = g * per_glwe;
  const int b_g = min(per_glwe, batch - first);
  const int j_end = (b_g + TPT - 1) / TPT * TPT;  // digits past b_g are 0
  const size_t stride = (size_t)n_in + 1;

  const int tid = threadIdx.x;
  const int lane = tid >> (log_n - 2);          // N / TPT threads a lane
  const int t0 = (tid & ((n_poly >> 2) - 1)) * TPT;

  u64 acc[TPT];
#pragma unroll
  for (int u = 0; u < TPT; ++u) acc[u] = 0ull;

  for (int i0 = i_begin; i0 < i_end; i0 += lanes) {
    // digits of mask element i0 + l of every LWE j, all levels; neighbouring
    // threads read neighbouring elements of one LWE
    for (int q = tid; q < SLOTS; q += THREADS) {
      const int l = q % lanes;
      const int j = q / lanes;
      const int i = i0 + l;
      u64 state = (i < i_end && j < b_g)
          ? decomposer_state(lwes[(size_t)(first + j) * stride + i], base_log, levels)
          : 0ull;
      for (int lev = 0; lev < levels; ++lev) {
        digit[(lev * lanes + l) * n_poly + j] = (int)next_digit(state, base_log);
      }
    }
    for (int lev = 0; lev < levels; ++lev) {
      __syncthreads();   // digits written; the previous level's Kx read
      for (int q = tid; q < 2 * SLOTS; q += THREADS) {
        const int l = q >> (log_n + 1);
        const int m = q & (2 * n_poly - 1);
        const int i = i0 + l;
        u64 v = 0ull;
        if (i < i_end) {
          const u64* krow = pksk + (((size_t)i * levels + lev) * k1 + c) * n_poly;
          v = m < n_poly ? 0ull - krow[m] : krow[m - n_poly];
        }
        kx[q] = v;
      }
      __syncthreads();
      const u64* kl = kx + (size_t)lane * 2 * n_poly + t0 + n_poly;
      const int* dl = digit + (lev * lanes + lane) * n_poly;
      // at step j = j0 + jj, coefficient t0 + u needs kl[u - j], which is in
      // slot (u - jj) mod TPT; each step loads the one new word, kl[-j], into
      // slot (-jj) mod TPT, whose old word no coefficient needs any more
      u64 ring[TPT];
#pragma unroll
      for (int s = 1; s < TPT; ++s) ring[s] = kl[s];
      for (int j0 = 0; j0 < j_end; j0 += TPT) {
#pragma unroll
        for (int jj = 0; jj < TPT; ++jj) {
          ring[(TPT - jj) % TPT] = kl[-(j0 + jj)];
          const u64 d = (u64)(long long)dl[j0 + jj];   // two's complement
#pragma unroll
          for (int u = 0; u < TPT; ++u) acc[u] += d * ring[(u - jj + TPT) % TPT];
        }
      }
    }
    __syncthreads();   // the last level's Kx and the digits read
  }

  // sum the lanes' partial sums in shared memory, then one atomic a word
  u64* part = smem;                             // (lanes, N)
#pragma unroll
  for (int u = 0; u < TPT; ++u) part[lane * n_poly + t0 + u] = acc[u];
  __syncthreads();
  u64* out_c = out + ((size_t)g * k1 + c) * n_poly;
  for (int t = tid; t < n_poly; t += THREADS) {
    u64 sum = 0ull;
    for (int l = 0; l < lanes; ++l) sum += part[l * n_poly + t];
    u64 add = 0ull - sum;
    if (c == k1 - 1 && blockIdx.z == 0 && t < b_g) {
      add += lwes[(size_t)(first + t) * stride + n_in];
    }
    atomicAdd(out_c + t, add);
  }
}

// the staged key (lanes, 2N) u64 and the digits (levels, lanes, N) int32:
// 48 KB at MAX_LEVELS, within a block's default dynamic shared memory
int smem_bytes(int levels) { return 2 * SLOTS * 8 + levels * SLOTS * 4; }

}  // namespace

extern "C" int tfhe_torch_packing_keyswitch(void* out, const void* lwes, const void* pksk,
                                            int batch, int n_in, int levels, int k1,
                                            int log_n, int per_glwe, int base_log,
                                            void* stream) {
  const int n_poly = 1 << log_n;
  if (batch < 1 || n_in < 1 || levels < 1 || levels > MAX_LEVELS || k1 < 1 ||
      n_poly < MIN_N || n_poly > MAX_N || per_glwe < 1 || per_glwe > n_poly ||
      base_log < 1 || base_log * levels >= 64) {
    return (int)cudaErrorInvalidValue;
  }
  const int lanes = SLOTS / n_poly;
  const int n_glwe = (batch + per_glwe - 1) / per_glwe;
  const int splits = (n_in + lanes * ROUNDS - 1) / (lanes * ROUNDS);
  dim3 grid(n_glwe, k1, splits);
  packing_keyswitch_kernel<<<grid, THREADS, smem_bytes(levels), (cudaStream_t)stream>>>(
      (u64*)out, (const u64*)lwes, (const u64*)pksk, batch, n_in, levels, k1, log_n,
      per_glwe, base_log);
  return (int)cudaGetLastError();
}
