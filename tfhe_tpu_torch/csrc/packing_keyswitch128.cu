// K6: the u128 packing keyswitch of squashed-noise compression, for sm_90a.
//
// Replaces: the packing keyswitch of tfhe_tpu/shortint/noise_squashing.py:299
// `NoiseSquashingCompressionKey.compress` (an XLA contraction over an
// 8-prime CRT-NTT; tfhe_tpu has no Pallas kernel for it).  Plain version:
// tfhe_tpu_torch/ops/server128.py `packing_keyswitch128` (tfhe_tpu's
// formula on the torch half of the 8-prime CRT-NTT).
//
// For every list g of up to N squashed u128 LWEs (slots j < count_g):
//   out_g = (0, B(X)) - sum_{i < n, lev < l} D_{i,lev}(X) * K_{i,lev}(X)
//           mod (X^N + 1, 2^128)
// where D_{i,lev} holds the signed digit (base 2^base_log, |d| <= 2^(base_log-1))
// of mask element i of LWE j as its coefficient j, B(X) holds the bodies and
// K_{i,lev} is the (k+1, N) standard-domain key row (n, l, k+1, N) u128.
// tfhe_tpu takes the product over 8 primes, where the exact integer
// (|X| < n l N 2^60 2^128, 2^210 at V1_4) stays below P/2 (2^239): it is the
// product mod 2^128, which this kernel takes directly in wrapping u128
// arithmetic, so the words are the same and no CRT is needed.  The digits
// are 61-bit at V1_4 (base_log 61, one level): a byte-limb tensor-core form
// (K4's) would need about 100 limb pairs a product.
//
// What bounds it on the H100: integer issue.  A list of count slots is
// count n l (k+1) N multiply-adds of a signed 61-bit digit by a u128 key
// word, mod 2^128 (3.8e9 at V1_4 with 128 slots, about 12 32-bit IMADs
// each); the key is 470 MB at V1_4, read once a list (0.14 ms at 3.35 TB/s).
// Design: blocks of N / R threads, a block one (list, output row c, chunk
// of the input coefficients i); each thread keeps R consecutive output
// coefficients' u128 sums in registers.  For each (i, lev) the block puts
// the key row's negacyclic extension (-K, K: 2N u128) and the count digits
// in shared memory (the digits decomposed there from the LWEs' mask words),
// then every thread walks the slots j with a window of R key words in
// registers: one shared load and R multiply-adds a slot, the window slots
// fixed at compile time by unrolling j by R.  A second kernel sums the
// chunks' partial sums, negates, and adds the bodies at slots j < count.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;
typedef unsigned __int128 u128;
typedef __int128 i128;

constexpr int R = 4;              // output coefficients a thread
constexpr int MIN_N = 32 * R;     // a block is N / R threads: at least a warp
constexpr int MAX_N = 256 * R;   // a block is at most 256 threads
constexpr int MAX_LEVELS = 4;

// The signed digit of level `lev` (lowest first) of a u128 word,
// decomposer.rs semantics (tfhe_tpu/ops/server128.py signed_decompose128):
// closest-representable rounding with balanced tie-breaking, |d| <= B/2.
__device__ __forceinline__ long long digit128(u128 x, int base_log, int levels, int lev) {
  const int rep = base_log * levels;
  u128 res = x >> (128 - rep - 1);
  const u128 rounding = res & 1;
  res = (res + 1) >> 1;
  const u128 rep_mask = (((u128)1) << rep) - 1;
  res &= rep_mask;
  const u128 nb = (((res - 1) | (rounding << (rep - 1))) & res) >> (rep - 1);
  i128 state = (i128)(res - (nb << rep));
  const u64 mask = (1ull << base_log) - 1;
  long long d = 0;
  for (int t = 0; t <= lev; ++t) {
    const u64 lo = (u64)state & mask;
    state >>= base_log;                          // arithmetic
    const u64 carry = (((lo - 1) | (u64)state) & lo) >> (base_log - 1);
    state += (i128)carry;
    d = (long long)lo - (long long)(carry << base_log);
  }
  return d;
}

// |d| K mod 2^128 for |d| < 2^63, negated where d < 0 (neg all ones)
__device__ __forceinline__ u128 signed_product(u64 mag, u128 neg, u128 k) {
  const u64 klo = (u64)k, khi = (u64)(k >> 64);
  const u64 lo = mag * klo;
  const u64 hi = __umul64hi(mag, klo) + mag * khi;
  const u128 p = ((u128)hi << 64) | lo;
  return (p ^ neg) - neg;
}

// grid (chunks, k+1, lists); block N / R threads; dynamic shared memory
// 2N u128 (the key row's negacyclic extension) + N i64 (the digits).
__global__ void __launch_bounds__(256)
packing_keyswitch128_partial_kernel(u128* __restrict__ partial, const u128* __restrict__ lwes,
                                    const u128* __restrict__ key, const int* __restrict__ counts,
                                    int max_count, int n_in, int levels, int k1, int log_n,
                                    int base_log, int per_chunk) {
  extern __shared__ u128 smem[];
  const int n_poly = 1 << log_n;
  u128* kx = smem;                                        // (2N): -K, K
  long long* dig = (long long*)(smem + 2 * n_poly);       // (N)
  const int chunk = blockIdx.x, c = blockIdx.y, g = blockIdx.z;
  const int tid = threadIdx.x, threads = blockDim.x;
  const int count = counts[g];
  const int count_pad = (count + R - 1) / R * R;          // <= N
  const int i0 = chunk * per_chunk;
  const int i1 = min(n_in, i0 + per_chunk);
  const u128* lwes_g = lwes + (size_t)g * max_count * (n_in + 1);
  const int base = tid * R + n_poly;                      // kx index of output tid R, slot 0

  u128 acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0;

  for (int i = i0; i < i1; ++i) {
    for (int lev = 0; lev < levels; ++lev) {
      __syncthreads();
      const u128* krow = key + (((size_t)i * levels + lev) * k1 + c) * n_poly;
      for (int t = tid; t < n_poly; t += threads) {
        const u128 kv = krow[t];
        kx[t] = (u128)0 - kv;
        kx[n_poly + t] = kv;
      }
      for (int j = tid; j < count_pad; j += threads) {
        dig[j] = j < count ? digit128(lwes_g[(size_t)j * (n_in + 1) + i], base_log, levels, lev)
                           : 0ll;
      }
      __syncthreads();
      // window: w[x mod R] = kx[base + x] for x in [-j, R-1-j]
      u128 w[R];
#pragma unroll
      for (int r = 0; r < R; ++r) w[r] = kx[base + r];
      for (int j0 = 0; j0 < count_pad; j0 += R) {
#pragma unroll
        for (int jj = 0; jj < R; ++jj) {
          const long long d = dig[j0 + jj];
          const u64 mag = d < 0 ? (u64)(-d) : (u64)d;
          const u128 neg = d < 0 ? ~(u128)0 : (u128)0;
#pragma unroll
          for (int r = 0; r < R; ++r) acc[r] += signed_product(mag, neg, w[(r - jj + R) % R]);
          // slide: slot (R-1-jj) mod R takes kx[base - (j0 + jj) - 1]
          w[(R - 1 - jj) % R] = kx[base - (j0 + jj) - 1];
        }
      }
    }
  }
  u128* out = partial + (((size_t)g * gridDim.x + chunk) * k1 + c) * n_poly + tid * R;
#pragma unroll
  for (int r = 0; r < R; ++r) out[r] = acc[r];
}

// out[g, c, t] = -sum_chunks partial[g, chunk, c, t] (+ body_t for c = k, t < count)
__global__ void packing_keyswitch128_reduce_kernel(u128* __restrict__ out,
                                                   const u128* __restrict__ partial,
                                                   const u128* __restrict__ lwes,
                                                   const int* __restrict__ counts, int max_count,
                                                   int n_in, int k1, int log_n, int chunks,
                                                   int total) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= total) return;
  const int n_poly = 1 << log_n;
  const int t = q & (n_poly - 1);
  const int c = (q >> log_n) % k1;
  const int g = (q >> log_n) / k1;
  u128 s = 0;
  for (int ch = 0; ch < chunks; ++ch) s += partial[(((size_t)g * chunks + ch) * k1 + c) * n_poly + t];
  s = (u128)0 - s;
  if (c == k1 - 1 && t < counts[g]) s += lwes[((size_t)g * max_count + t) * (n_in + 1) + n_in];
  out[q] = s;
}

}  // namespace

extern "C" int tfhe_torch_packing_keyswitch128_smem_bytes(int n_poly) {
  return 2 * n_poly * 16 + n_poly * 8;
}

// Whether K6 takes a shape (the wrapper raises a ValueError on others).
extern "C" int tfhe_torch_packing_keyswitch128_shape(int n_in, int levels, int k1, int log_n,
                                                     int base_log) {
  const int n_poly = 1 << log_n;
  return (n_in >= 1 && levels >= 1 && levels <= MAX_LEVELS && k1 >= 1 && log_n >= 1 &&
          n_poly >= MIN_N && n_poly <= MAX_N && base_log >= 1 && base_log <= 62 &&
          base_log * levels < 128) ? 1 : 0;
}

// lwes (lists, max_count, n_in + 1) u128; key (n_in, levels, k1, N) u128;
// counts (lists,) int32 in [1, min(max_count, N)] on the card; partial the
// (lists, chunks, k1, N) u128 scratch, chunks = ceil(n_in / per_chunk);
// out (lists, k1, N) u128.
extern "C" int tfhe_torch_packing_keyswitch128(void* out, void* partial, const void* lwes,
                                               const void* key, const void* counts, int lists,
                                               int max_count, int n_in, int levels, int k1,
                                               int log_n, int base_log, int per_chunk,
                                               void* stream) {
  const int n_poly = 1 << log_n;
  if (!tfhe_torch_packing_keyswitch128_shape(n_in, levels, k1, log_n, base_log) || lists < 1 ||
      max_count < 1 || max_count > n_poly || per_chunk < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int chunks = (n_in + per_chunk - 1) / per_chunk;
  const int smem = tfhe_torch_packing_keyswitch128_smem_bytes(n_poly);
  cudaError_t err = cudaFuncSetAttribute(packing_keyswitch128_partial_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(chunks, k1, lists);
  packing_keyswitch128_partial_kernel<<<grid, n_poly / R, smem, (cudaStream_t)stream>>>(
      (u128*)partial, (const u128*)lwes, (const u128*)key, (const int*)counts, max_count, n_in,
      levels, k1, log_n, base_log, per_chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int total = lists * k1 * n_poly;
  packing_keyswitch128_reduce_kernel<<<(total + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      (u128*)out, (const u128*)partial, (const u128*)lwes, (const int*)counts, max_count, n_in,
      k1, log_n, chunks, total);
  return (int)cudaGetLastError();
}
