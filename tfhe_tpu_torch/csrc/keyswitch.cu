// K1: batched LWE keyswitch, wrapping u64, for sm_90a.
//
// Replaces: tfhe_tpu/ops/server.py:84 `keyswitch`, which the TPU runs as an
// XLA contraction over 7-bit int8 limbs (_matmul_digits_u64_mxu, :157).
// Plain version: tfhe_tpu_torch/ops/server.py `keyswitch`.
//
//   out[b] = (0, ..., 0, body[b]) - sum_{i, lev} digit_lev(ct[b, i]) * ksk[i, lev]
//
// with the signed gadget decomposition (balanced rounding and the carry
// trick of server.py:41-75) done inside the kernel.
//
// What bounds it: at the 2_2 set and B = 512 the contraction is
// (512 x 8192) x (8192 x 919) = 3.9e9 multiply-adds of a small signed digit
// by a u64 key word, against 60 MB of key: far more operations than bytes.
// On the int32 lanes each 64-bit multiply-add is several instructions, so the
// kernel is bound by integer issue rate, not by memory.
// Design: a block owns a TB x TC output tile and walks the K axis in chunks
// of whole input coefficients.  Each chunk's digits are decomposed once into
// shared memory (every digit is used TC times) and the key tile is staged in
// shared memory (every key word is used TB times); each thread keeps 8
// accumulators of one output column in registers.  Blocks that share a
// column tile have neighbouring indices, so the key is read from device
// memory about once and from L2 by the rest.  Tensor-core limb products are
// work for a later change.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int TB = 32;         // batch rows per block
constexpr int TC = 64;         // output columns per block
constexpr int KC = 64;         // K rows per chunk (whole coefficients)
constexpr int THREADS = 256;   // TC columns x 4 row groups
constexpr int ROWS_PER_THREAD = TB / (THREADS / TC);
constexpr int MAX_LEVELS = 16;

// Closest-representable rounding with balanced tie-breaking
// (ops/server.py init_decomposer_state).
__device__ __forceinline__ u64 decomposer_state(u64 x, int base_log, int levels) {
  const int rep = base_log * levels;      // < 64, checked by the launcher
  u64 res = x >> (64 - rep - 1);
  const u64 rounding_bit = res & 1ull;
  res = (res + 1ull) >> 1;
  res &= (1ull << rep) - 1ull;
  const u64 nb = (((res - 1ull) | (rounding_bit << (rep - 1))) & res) >> (rep - 1);
  return res - (nb << rep);
}

// The next signed digit, lowest level first, advancing the state
// (ops/server.py signed_decompose; the shift of the state is arithmetic).
__device__ __forceinline__ long long next_digit(u64& state, int base_log) {
  const u64 r = state & ((1ull << base_log) - 1ull);
  state = (u64)((long long)state >> base_log);
  const u64 carry = (((r - 1ull) | state) & r) >> (base_log - 1);
  state += carry;
  return (long long)(r - (carry << base_log));
}

__global__ void __launch_bounds__(THREADS)
keyswitch_kernel(u64* __restrict__ out, const u64* __restrict__ ct,
                 const u64* __restrict__ ksk, int batch, int n_in, int levels,
                 int m_out, int base_log) {
  __shared__ int s_digit[TB][KC];
  __shared__ u64 s_key[KC][TC];

  const int tid = threadIdx.x;
  const int tx = tid % TC;
  const int ty = tid / TC;
  const int row0 = blockIdx.x * TB;
  const int col0 = blockIdx.y * TC;
  const int coef_per_chunk = KC / levels;
  const size_t ct_stride = (size_t)n_in + 1;

  u64 acc[ROWS_PER_THREAD];
#pragma unroll
  for (int r = 0; r < ROWS_PER_THREAD; ++r) acc[r] = 0ull;

  for (int i0 = 0; i0 < n_in; i0 += coef_per_chunk) {
    const int ni = min(coef_per_chunk, n_in - i0);
    const int kc = ni * levels;
    for (int q = tid; q < TB * ni; q += THREADS) {
      const int rb = q / ni;
      const int ii = q - rb * ni;
      const int b = row0 + rb;
      int* dst = &s_digit[rb][ii * levels];
      // rows past the batch hold the state of 0, whose digits are all 0
      u64 state = b < batch
          ? decomposer_state(ct[(size_t)b * ct_stride + i0 + ii], base_log, levels)
          : 0ull;
      for (int lev = 0; lev < levels; ++lev) dst[lev] = (int)next_digit(state, base_log);
    }
    for (int q = tid; q < kc * TC; q += THREADS) {
      const int kk = q / TC;
      const int cc = q - kk * TC;
      const int col = col0 + cc;
      s_key[kk][cc] = col < m_out
          ? ksk[((size_t)i0 * levels + kk) * (size_t)m_out + col] : 0ull;
    }
    __syncthreads();
    for (int kk = 0; kk < kc; ++kk) {
      const u64 kv = s_key[kk][tx];
#pragma unroll
      for (int r = 0; r < ROWS_PER_THREAD; ++r) {
        acc[r] += (u64)(long long)s_digit[ty * ROWS_PER_THREAD + r][kk] * kv;
      }
    }
    __syncthreads();
  }

  const int col = col0 + tx;
  if (col >= m_out) return;
#pragma unroll
  for (int r = 0; r < ROWS_PER_THREAD; ++r) {
    const int b = row0 + ty * ROWS_PER_THREAD + r;
    if (b < batch) {
      const u64 body = (col == m_out - 1) ? ct[(size_t)b * ct_stride + n_in] : 0ull;
      out[(size_t)b * m_out + col] = body - acc[r];
    }
  }
}

}  // namespace

extern "C" int tfhe_torch_keyswitch(void* out, const void* ct, const void* ksk,
                                    int batch, int n_in, int levels, int m_out,
                                    int base_log, void* stream) {
  if (levels < 1 || levels > MAX_LEVELS || levels > KC || base_log < 1 ||
      base_log * levels >= 64) {
    return (int)cudaErrorInvalidValue;
  }
  dim3 grid((batch + TB - 1) / TB, (m_out + TC - 1) / TC);
  keyswitch_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (u64*)out, (const u64*)ct, (const u64*)ksk, batch, n_in, levels, m_out,
      base_log);
  return (int)cudaGetLastError();
}
