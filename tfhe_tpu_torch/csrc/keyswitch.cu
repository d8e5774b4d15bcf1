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
// Counted as 8 byte limbs of each key word on the int8 tensor cores it is
// 61.7e9 operations, 0.031 ms on an H100 (the 60 MB of key: 0.018 ms).
//
// Tensor-core kernel (keyswitch_imma_kernel), for signed digits that fit s8
// (base_log <= 7), a decomposition in 32 bits (base_log l <= 30), 2 <= l <= 8
// and limb sums exact in s32 (n_in l 2^(base_log-1) 255 < 2^31; 1.7e7 at
// 2_2): each u64 key word is 8 unsigned byte limbs, so
//   sum_k d_k w_k = sum_j 2^(8j) sum_k d_k limb_j(w_k)   (mod 2^64),
// an s8 x u8 -> s32 GEMM of (B x K) digits by (K x 8 (n_out+1)) limbs,
// recombined in the epilogue: bit-identical by construction.  The key is
// laid out once per key tensor by the wrapper (ops/kernels.py
// keyswitch_key_limbs) as (chunks, columns, 128) bytes, K-major, a chunk
// holding the l digits of 128 / l whole input coefficients (zero-padded),
// so the fragments of mma.sync.m16n8k32.s8.u8 load with ldmatrix.  A block
// of 512 threads owns 128 batch rows x 256 limb columns (32 output words)
// and a slice of the chunks; per chunk it stages the key tile (32 KB) and
// its rows' digit tile (16 KB) with cp.async three chunks ahead of the mma
// (four stages, 196,608 B); both tiles are 128-byte rows with their
// 16-byte units swizzled by row, so ldmatrix reads without bank conflicts.
// The digits are decomposed once a keyswitch, from each word's high word,
// by a kernel of their own (keyswitch_digits_kernel) into a (rows, chunks,
// 128) byte scratch in the key's chunk order.  Decomposed in every block of
// a row instead, once for each of its column blocks (15 at V1_4 KS32, 29
// at 2_2), they took by instruction count about 2 us of a chunk's 4.7 us
// on the card, where the chunk's 1,024 mma take about 0.6.  16 warps of
// 32 x 64 each run 16 mma a 32-deep step; the epilogue adds each output
// word's 8 limb sums, held by the 4 lanes of a quad, with two shuffles.
// Where the grid of (columns, rows) blocks would fill less than half the
// SMs, the wrapper (ops/kernels.py keyswitch_splits) cuts the contraction
// into slices of chunks, a third grid axis, so that the grid covers at
// least two waves; each slice adds its
// words into the zeroed output with atomics (mod 2^64 or 2^32: wrapping sums
// commute, so the words do not depend on the order), the body added once.
// With the digit kernel and the split, K1 at 2_2 and B = 512 took 0.1329 ms
// (0.2977 before) and K1-32 at V1_4 KS32 0.1433 ms (0.3825), NVIDIA H100
// 80GB HBM3, 700 W.
//
// Limb-row kernel (keyswitch_limbs_kernel), for the u64 keyswitches the
// tensor-core kernel refuses whose digits fit four balanced bytes
// (limb_shape: base_log <= 31, l <= 8, limb sums exact in s32): the WoPBS
// PFPKS (base 2^20 x 2, n_in = 513, 2048 columns, B = 40) and the compact
// list's cast to the big key (base 2^24 x 1, n_in = 2048, B = 32).  There
// the generic kernel ran 64 and 33 blocks on the CUDA cores' u64
// multiply-adds (68 % and 51 % of its cycles), 0.153 and 0.385 ms.  Each
// signed digit, decomposed from the whole word once (base_log l passes 30
// at the PFPKS), is cut into T = ceil((base_log + 1) / 8) balanced s8
// limbs, d = sum_t 2^(8t) e_t, and limb t of ciphertext b becomes row (b,
// t) of the digit operand (128 / T ciphertexts a row block: B = 40 and 32
// are one row block each), so the key's byte layout is read once and the
// same mma.sync main loop as the tensor-core kernel's gives every
// S[(b, t), (w, j)] in s32; the epilogue stages those sums in shared
// memory and folds sum_t sum_j 2^(8 (t + j)) S into each word.  The
// contraction is split as the tensor-core kernel's (at least 2 chunks a
// slice); the digits kernel (keyswitch_limb_rows_kernel) zeroes the output
// first.
//
// Generic kernel (keyswitch_kernel), every other shape (the test vectors'
// base 2^37; K1-32's u32 twin): a block owns a TB x TC output tile and
// walks the K axis in chunks of whole input coefficients, decomposing each chunk's digits once into shared memory
// and staging the key tile there; each thread keeps 8 u64 accumulators of
// one output column in registers, multiply-adds on the CUDA cores.  Digits
// are 32-bit up to base_log 31; above it (the test vectors' toy set, base
// 2^37) keyswitch_wide_kernel holds them in 64 bits.
//
// K1-32, the KS32 atomic pattern's keyswitch (the same kernels at 4 byte
// limbs a key word).  Replaces: tfhe_tpu/ops/server.py:110 `keyswitch32`,
// an XLA contraction in wrapping u32 (_matmul_u32, :131); plain version:
// tfhe_tpu_torch/ops/server.py `keyswitch32`.
//
//   out[b] = (0, ..., 0, ct[b, n_in] >> 32) - sum_{i, lev} digit_lev(ct[b, i]) * ksk32[i, lev]
//
// mod 2^32, the digits those of the u64 mask as above, the key's u32 words
// (and the output's) held in int64 in [0, 2^32).  Mod 2^32 only a word's 4
// low bytes count, so the tensor-core kernel reads half the limb columns
// (4 a word: a block's 256 limb columns are 64 output words, each n8 tile
// two of them) and its epilogue adds a word's 4 limb sums, held by a lane
// pair, with one shuffle, mod 2^32; the limb sums are the same s32-exact
// sums, so imma_shape is unchanged (2048 x 5 x 8 x 255 < 2^31 at the V1_4
// KS32 set).  At V1_4 KS32 and B = 512 the contraction is (512 x 10240) x
// (10240 x 919), 30.8e9 int8 operations at 4 limbs, 0.016 ms; the key's 4
// limbs are 37.6 MB, 0.011 ms.  Its grid is 15 column blocks x 4 row
// blocks, one wave on 60 of 132 SMs, each block walking all 82 chunks (PR
// 12's kernel: 0.3825 ms, NVIDIA H100 80GB HBM3, 700 W); split 5 ways it is
// 300 blocks of 17 chunks.  The generic kernel's u32 twin accumulates in
// u32 on the CUDA cores.

#include <type_traits>

#include "ntt_common.cuh"

using ntt_common::decomposer_state;
using ntt_common::hi_decomposer_state;
using ntt_common::hi_next_digit;
using ntt_common::ldmatrix_x4;
using ntt_common::mma_s8u8;
using ntt_common::next_digit;
using ntt_common::smem_u32;

namespace {

typedef unsigned long long u64;

constexpr int TB = 32;         // batch rows per block
constexpr int TC = 64;         // output columns per block
constexpr int KC = 64;         // K rows per chunk (whole coefficients)
constexpr int THREADS = 256;   // TC columns x 4 row groups
constexpr int ROWS_PER_THREAD = TB / (THREADS / TC);
constexpr int MAX_LEVELS = 16;

// The generic kernel's body: WB = 8 is the u64 keyswitch (K1), WB = 4 the
// KS32 keyswitch mod 2^32 (the body ct >> 32, accumulators and key tile in
// u32).  Each output word is written as a u64 (in [0, 2^32) for WB = 4).
// D holds a digit: int up to base_log 31 (|d| <= 2^30), long long above
// (the test vectors' toy set keyswitches at base 2^37).
template <int WB, typename D>
__device__ __forceinline__ void keyswitch_body(u64* __restrict__ out,
                                               const u64* __restrict__ ct,
                                               const u64* __restrict__ ksk, int batch,
                                               int n_in, int levels, int m_out,
                                               int base_log) {
  typedef typename std::conditional<WB == 8, u64, unsigned int>::type word;
  __shared__ D s_digit[TB][KC];
  __shared__ word s_key[KC][TC];

  const int tid = threadIdx.x;
  const int tx = tid % TC;
  const int ty = tid / TC;
  const int row0 = blockIdx.x * TB;
  const int col0 = blockIdx.y * TC;
  const int coef_per_chunk = KC / levels;
  const size_t ct_stride = (size_t)n_in + 1;

  word acc[ROWS_PER_THREAD];
#pragma unroll
  for (int r = 0; r < ROWS_PER_THREAD; ++r) acc[r] = 0;

  for (int i0 = 0; i0 < n_in; i0 += coef_per_chunk) {
    const int ni = min(coef_per_chunk, n_in - i0);
    const int kc = ni * levels;
    for (int q = tid; q < TB * ni; q += THREADS) {
      const int rb = q / ni;
      const int ii = q - rb * ni;
      const int b = row0 + rb;
      D* dst = &s_digit[rb][ii * levels];
      // rows past the batch hold the state of 0, whose digits are all 0
      u64 state = b < batch
          ? decomposer_state(ct[(size_t)b * ct_stride + i0 + ii], base_log, levels)
          : 0ull;
      for (int lev = 0; lev < levels; ++lev) dst[lev] = (D)next_digit(state, base_log);
    }
    for (int q = tid; q < kc * TC; q += THREADS) {
      const int kk = q / TC;
      const int cc = q - kk * TC;
      const int col = col0 + cc;
      s_key[kk][cc] = col < m_out
          ? (word)ksk[((size_t)i0 * levels + kk) * (size_t)m_out + col] : (word)0;
    }
    __syncthreads();
    for (int kk = 0; kk < kc; ++kk) {
      const word kv = s_key[kk][tx];
#pragma unroll
      for (int r = 0; r < ROWS_PER_THREAD; ++r) {
        acc[r] += (word)(long long)s_digit[ty * ROWS_PER_THREAD + r][kk] * kv;
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
      const word body = (col == m_out - 1)
          ? (word)(ct[(size_t)b * ct_stride + n_in] >> (64 - 8 * WB)) : (word)0;
      out[(size_t)b * m_out + col] = (u64)(word)(body - acc[r]);
    }
  }
}

__global__ void __launch_bounds__(THREADS)
keyswitch_kernel(u64* __restrict__ out, const u64* __restrict__ ct,
                 const u64* __restrict__ ksk, int batch, int n_in, int levels,
                 int m_out, int base_log) {
  keyswitch_body<8, int>(out, ct, ksk, batch, n_in, levels, m_out, base_log);
}

// K1's generic kernel at base_log > 31: 64-bit digits (48 KB of static
// shared memory).
__global__ void __launch_bounds__(THREADS)
keyswitch_wide_kernel(u64* __restrict__ out, const u64* __restrict__ ct,
                      const u64* __restrict__ ksk, int batch, int n_in, int levels,
                      int m_out, int base_log) {
  keyswitch_body<8, long long>(out, ct, ksk, batch, n_in, levels, m_out, base_log);
}

__global__ void __launch_bounds__(THREADS)
keyswitch32_kernel(u64* __restrict__ out, const u64* __restrict__ ct,
                   const u64* __restrict__ ksk, int batch, int n_in, int levels,
                   int m_out, int base_log) {
  keyswitch_body<4, int>(out, ct, ksk, batch, n_in, levels, m_out, base_log);
}

// ---------------------------------------------------------------------------
// The tensor-core kernel.
// ---------------------------------------------------------------------------

typedef unsigned int u32;

constexpr int IM_BM = 128;        // batch rows a block
constexpr int IM_BN = 256;        // limb columns a block (32 output words)
constexpr int IM_KC = 128;        // digit positions (bytes) a chunk
constexpr int IM_THREADS = 512;   // 16 warps: 4 along the rows x 4 along the columns
constexpr int IM_STAGES = 4;      // key chunks in flight (IM_STAGES - 1 ahead of the mma)
constexpr int IM_SMEM = IM_STAGES * (IM_BN + IM_BM) * IM_KC;   // 196,608 B
constexpr int IM_DIGIT_THREADS = 256;

// The tensor-core kernel's shape: signed digits |d| <= 2^(base_log-1) that
// fit s8, a decomposition read from the high word alone (base_log l <= 30),
// 2 <= l <= 8 (128 / l whole coefficients a chunk), every limb sum exact in
// s32.  ops/kernels.py chooses by it (tfhe_torch_keyswitch_imma_shape).
__host__ __device__ constexpr bool imma_shape(int n_in, int levels, int base_log) {
  return base_log >= 1 && base_log <= 7 && levels >= 2 && levels <= 8 &&
         base_log * levels <= 30 &&
         (long long)n_in * levels * (1ll << (base_log - 1)) * 255 < (1ll << 31);
}

// The limb-row kernel's shape (keyswitch_limbs_kernel): every u64
// keyswitch the tensor-core kernel refuses whose signed digits
// |d| <= 2^(base_log-1) fit T = limb_count(base_log) <= 4 balanced s8 limbs
// (base_log <= 31), 1 <= l <= 8 (128 / l whole coefficients a chunk), and
// whose limb sums stay exact in s32 with every limb at -128 and every key
// byte 255 (n_in l 128 255 < 2^31: 3.4e7 at the PFPKS, 6.7e7 at the cast).
// ops/kernels.py chooses by it (tfhe_torch_keyswitch_limb_shape), after
// imma_shape.
__host__ __device__ constexpr int limb_count(int base_log) { return (base_log + 8) / 8; }

__host__ __device__ constexpr bool limb_shape(int n_in, int levels, int base_log) {
  return !imma_shape(n_in, levels, base_log) && base_log >= 1 && base_log <= 31 &&
         levels >= 1 && levels <= 8 && base_log * levels < 64 && n_in >= 1 &&
         (long long)n_in * levels * 128 * 255 < (1ll << 31);
}

// The byte offset of digit position k of row r in a tile of 128-byte rows,
// its 16-byte unit swizzled by the row's low 3 bits.
__device__ __forceinline__ int swz(int r, int k) {
  return r * IM_KC + ((((k >> 4) ^ r) & 7) << 4) + (k & 15);
}

// The digits of the tensor-core kernel, once a keyswitch: dig (rows_pad,
// n_chunks, IM_KC) s8, row b's chunk c holding at byte slot l + lev the
// level-lev signed digit of input coefficient c (128 / l) + slot, from its
// high word (0 past n_in, past the chunk's whole coefficients and for the
// rows past the batch).  A thread a byte; neighbouring threads write
// neighbouring bytes and share their coefficient's high word.
__global__ void __launch_bounds__(IM_DIGIT_THREADS)
keyswitch_digits_kernel(signed char* __restrict__ dig, const u64* __restrict__ ct, int batch,
                        int n_in, int levels, int base_log, int n_chunks, int rows_pad) {
  const size_t q = (size_t)blockIdx.x * IM_DIGIT_THREADS + threadIdx.x;
  if (q >= (size_t)rows_pad * n_chunks * IM_KC) return;
  const int k = (int)(q % IM_KC);
  const int c = (int)((q / IM_KC) % n_chunks);
  const int b = (int)(q / ((size_t)IM_KC * n_chunks));
  const int slot = k / levels, lev = k % levels;
  const int i = c * (IM_KC / levels) + slot;
  int d = 0;
  if (b < batch && slot < IM_KC / levels && i < n_in) {
    const u32 hi = ((const u32*)ct)[2 * ((size_t)b * (n_in + 1) + i) + 1];
    int state = hi_decomposer_state(hi, base_log, levels);
    for (int t = 0; t <= lev; ++t) d = hi_next_digit(state, base_log);
  }
  dig[q] = (signed char)d;
}

// The limb rows of the limb-row kernel, once a keyswitch: dig (row_blocks
// IM_BM, n_chunks, IM_KC) s8.  Row r = cb T + t of row block rb (cb <
// IM_BM / T) holds at chunk c, byte slot l + lev, limb t of the balanced
// byte limbs d = sum_t 2^(8t) e_t, e_t in [-128, 127], of the level-lev
// signed digit of input coefficient c (128 / l) + slot of ciphertext
// rb (IM_BM / T) + cb, decomposed from the whole u64 word (base_log l may
// pass 30: 40 at the PFPKS); 0 past n_in, past the chunk's whole
// coefficients, past the batch and in the IM_BM mod T rows a block leaves.
// Threads below zero_words first zero that many words of out, which a
// split contraction adds its slices into.
__global__ void __launch_bounds__(IM_DIGIT_THREADS)
keyswitch_limb_rows_kernel(signed char* __restrict__ dig, u64* __restrict__ out,
                           size_t zero_words, const u64* __restrict__ ct, int batch, int n_in,
                           int levels, int base_log, int n_chunks, int limbs, size_t bytes) {
  const size_t q = (size_t)blockIdx.x * IM_DIGIT_THREADS + threadIdx.x;
  if (q < zero_words) out[q] = 0ull;
  if (q >= bytes) return;
  const int k = (int)(q % IM_KC);
  const int c = (int)((q / IM_KC) % n_chunks);
  const int row = (int)(q / ((size_t)IM_KC * n_chunks));
  const int per = IM_BM / limbs;
  const int cb = (row % IM_BM) / limbs;
  const int t = (row % IM_BM) - cb * limbs;
  const int b = (row / IM_BM) * per + cb;
  const int slot = k / levels, lev = k % levels;
  const int i = c * (IM_KC / levels) + slot;
  int e = 0;
  if (cb < per && b < batch && slot < IM_KC / levels && i < n_in) {
    u64 state = decomposer_state(ct[(size_t)b * (n_in + 1) + i], base_log, levels);
    long long d = 0;
    for (int s = 0; s <= lev; ++s) d = next_digit(state, base_log);
    int x = (int)d;                     // |d| <= 2^30
    for (int s = 0; s <= t; ++s) {
      e = ((x + 128) & 255) - 128;
      x = (x - e) >> 8;
    }
  }
  dig[q] = (signed char)e;
}

// The tensor-core kernels' main loop: block (blockIdx.x, blockIdx.y) of
// IM_BM rows of the byte scratch dig and IM_BN limb columns of the key walks
// chunks c0 .. c0 + n_slice - 1 and leaves warp (wm, wn)'s s32 sums in acc:
// acc[mi][ni] the m16n8 tile of rows wm 32 + mi 16 .. and limb columns
// wn 64 + ni 8 ...  Its tiles use all IM_SMEM bytes of im_smem.
__device__ __forceinline__ void imma_main_loop(int (&acc)[2][8][4], unsigned char* key_s,
                                               unsigned char* dig_s,
                                               const uint4* __restrict__ key,
                                               const uint4* __restrict__ dig, int n_chunks,
                                               int key_cols, int c0, int n_slice) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp & 3;          // rows wm 32 .. +32
  const int wn = warp >> 2;         // limb columns wn 64 .. +64
  const int n0 = blockIdx.x * IM_BN;
  const int m0 = blockIdx.y * IM_BM;

  // chunk c's key tile (BN rows) and digit tile (the block's BM rows) into
  // stage s: rows of 128 bytes, 16-byte units swizzled by row
  auto load_chunk = [&](int c, int s) {
    const uint4* src = key + ((size_t)c * key_cols + n0) * (IM_KC / 16);
    const u32 dst = smem_u32(key_s + s * IM_BN * IM_KC);
#pragma unroll
    for (int i = 0; i < IM_BN * IM_KC / 16 / IM_THREADS; ++i) {
      const int q = i * IM_THREADS + tid;
      const int r = q >> 3;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                       dst + swz(r, (q & 7) << 4)),
                   "l"(src + q));
    }
    const u32 ddst = smem_u32(dig_s + s * IM_BM * IM_KC);
#pragma unroll
    for (int i = 0; i < IM_BM * IM_KC / 16 / IM_THREADS; ++i) {
      const int q = i * IM_THREADS + tid;
      const int r = q >> 3;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                       ddst + swz(r, (q & 7) << 4)),
                   "l"(dig + ((size_t)(m0 + r) * n_chunks + c) * (IM_KC / 16) + (q & 7)));
    }
  };

  // local chunk c of the slice is chunk c0 + c; its tiles land in stage
  // c % IM_STAGES, IM_STAGES - 1 chunks ahead of the mma
#pragma unroll
  for (int st = 0; st < IM_STAGES - 1; ++st) {
    if (st < n_slice) load_chunk(c0 + st, st);
    asm volatile("cp.async.commit_group;\n" ::);
  }

#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;
    }
  }

  for (int c = 0; c < n_slice; ++c) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(IM_STAGES - 2));
    __syncthreads();    // chunk c's tiles landed; chunk c - 1 is done
    if (c + IM_STAGES - 1 < n_slice) {
      load_chunk(c0 + c + IM_STAGES - 1, (c + IM_STAGES - 1) % IM_STAGES);
    }
    asm volatile("cp.async.commit_group;\n" ::);
    const unsigned char* ks = key_s + (c % IM_STAGES) * IM_BN * IM_KC;
    const unsigned char* ds = dig_s + (c % IM_STAGES) * IM_BM * IM_KC;
#pragma unroll
    for (int kk = 0; kk < IM_KC / 32; ++kk) {
      u32 a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int r = wm * 32 + mi * 16 + (lane & 15);
        ldmatrix_x4(a[mi], smem_u32(ds + swz(r, (kk * 2 + (lane >> 4)) << 4)));
      }
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        u32 b[4];
        const int r = wn * 64 + nj * 16 + (lane & 7) + ((lane >> 4) << 3);
        ldmatrix_x4(b, smem_u32(ks + swz(r, (kk * 2 + ((lane >> 3) & 1)) << 4)));
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_s8u8(acc[mi][2 * nj], a[mi], b[0], b[1]);
          mma_s8u8(acc[mi][2 * nj + 1], a[mi], b[2], b[3]);
        }
      }
    }
  }
}

// The tensor-core kernel's body at WB limbs a key word: 8 (K1) or 4 (K1-32,
// mod 2^32; the body ct >> 32).
template <int WB>
__device__ __forceinline__ void keyswitch_imma_body(u64* __restrict__ out,
                                                    const u64* __restrict__ ct,
                                                    const uint4* __restrict__ key,
                                                    const uint4* __restrict__ dig,
                                                    int batch, int n_in, int m_out,
                                                    int n_chunks, int key_cols,
                                                    int chunks_per_split) {
  extern __shared__ uint4 im_smem[];
  unsigned char* key_s = (unsigned char*)im_smem;                    // (STAGES, BN, KC)
  unsigned char* dig_s = key_s + IM_STAGES * IM_BN * IM_KC;          // (STAGES, BM, KC)
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wm = warp & 3;
  const int wn = warp >> 2;
  const int n0 = blockIdx.x * IM_BN;
  const int m0 = blockIdx.y * IM_BM;
  // this block's slice of the contraction: chunks c0 .. c0 + n_slice - 1
  // (slice blockIdx.z; the slices' partial words are summed by atomics)
  const int c0 = blockIdx.z * chunks_per_split;
  const int n_slice = min(chunks_per_split, n_chunks - c0);
  const bool split = gridDim.z > 1;
  const size_t ct_stride = (size_t)n_in + 1;

  int acc[2][8][4];
  imma_main_loop(acc, key_s, dig_s, key, dig, n_chunks, key_cols, c0, n_slice);

  const int g = lane >> 2;
  const int t = lane & 3;
  if (WB == 8) {
    // each n8 tile is one output word: lane (g, t) holds its limbs 2t, 2t + 1
    // of rows g and g + 8; a quad's sum is the word's product sum
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const int col = (n0 + wn * 64 + ni * 8) >> 3;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          u64 part = ((u64)(long long)acc[mi][ni][2 * h] << (16 * t)) +
                     ((u64)(long long)acc[mi][ni][2 * h + 1] << (16 * t + 8));
          part += __shfl_xor_sync(0xffffffffu, part, 1);
          part += __shfl_xor_sync(0xffffffffu, part, 2);
          const int b = m0 + wm * 32 + mi * 16 + g + 8 * h;
          if (t == h && b < batch && col < m_out) {
            const u64 body = (col == m_out - 1 && blockIdx.z == 0)
                                 ? ct[(size_t)b * ct_stride + n_in] : 0ull;
            u64* o = out + (size_t)b * m_out + col;
            if (split) {
              atomicAdd((unsigned long long*)o, body - part);
            } else {
              *o = body - part;
            }
          }
        }
      }
    }
  } else {
    // each n8 tile is two output words: lane (g, t) holds limbs 2t mod 4 and
    // 2t + 1 mod 4 of word t / 2, rows g and g + 8; a lane pair's sum is the
    // word's product sum mod 2^32
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const int col = ((n0 + wn * 64 + ni * 8) >> 2) + (t >> 1);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          u32 part = ((u32)acc[mi][ni][2 * h] << (16 * (t & 1))) +
                     ((u32)acc[mi][ni][2 * h + 1] << (16 * (t & 1) + 8));
          part += __shfl_xor_sync(0xffffffffu, part, 1);
          const int b = m0 + wm * 32 + mi * 16 + g + 8 * h;
          if ((t & 1) == h && b < batch && col < m_out) {
            const u32 body = (col == m_out - 1 && blockIdx.z == 0)
                                 ? (u32)(ct[(size_t)b * ct_stride + n_in] >> 32) : 0u;
            u64* o = out + (size_t)b * m_out + col;
            if (split) {
              // the word's low half (little-endian), mod 2^32; its high half
              // stays the zero the wrapper wrote
              atomicAdd((u32*)o, body - part);
            } else {
              *o = (u64)(u32)(body - part);
            }
          }
        }
      }
    }
  }
}

__global__ void __launch_bounds__(IM_THREADS, 1)
keyswitch_imma_kernel(u64* __restrict__ out, const u64* __restrict__ ct,
                      const uint4* __restrict__ key, const uint4* __restrict__ dig, int batch,
                      int n_in, int m_out, int n_chunks, int key_cols, int chunks_per_split) {
  keyswitch_imma_body<8>(out, ct, key, dig, batch, n_in, m_out, n_chunks, key_cols,
                         chunks_per_split);
}

__global__ void __launch_bounds__(IM_THREADS, 1)
keyswitch32_imma_kernel(u64* __restrict__ out, const u64* __restrict__ ct,
                        const uint4* __restrict__ key, const uint4* __restrict__ dig,
                        int batch, int n_in, int m_out, int n_chunks, int key_cols,
                        int chunks_per_split) {
  keyswitch_imma_body<4>(out, ct, key, dig, batch, n_in, m_out, n_chunks, key_cols,
                         chunks_per_split);
}

// K1's limb-row kernel: the tensor-core kernel's main loop on the limb
// rows of keyswitch_limb_rows_kernel (row (cb, t) of a block the limbs t of
// ciphertext cb's digits), then every s32 sum staged in shared memory over
// the finished tiles, and each output word folded from its ciphertext's T
// rows by one thread (with atomics where the contraction is split).  The
// fold by quad shuffles of the tensor-core kernel's epilogue, each row's
// word stored and then T of them added, took 14,000 cycles of a block's
// 35,600 at the PFPKS (tools/phase_cycles.py k1g; NVIDIA H100 80GB HBM3,
// 700 W).
constexpr int LR_ROW = IM_BN + 8;   // ints a staged row: 135,168 B of the tiles' 196,608
__global__ void __launch_bounds__(IM_THREADS, 1)
keyswitch_limbs_kernel(u64* __restrict__ out, const u64* __restrict__ ct,
                       const uint4* __restrict__ key, const uint4* __restrict__ dig, int batch,
                       int n_in, int m_out, int n_chunks, int key_cols, int chunks_per_split,
                       int limbs) {
  extern __shared__ uint4 im_smem[];
  unsigned char* key_s = (unsigned char*)im_smem;
  unsigned char* dig_s = key_s + IM_STAGES * IM_BN * IM_KC;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp & 3;
  const int wn = warp >> 2;
  const int c0 = blockIdx.z * chunks_per_split;
  const int n_slice = min(chunks_per_split, n_chunks - c0);

  int acc[2][8][4];
  imma_main_loop(acc, key_s, dig_s, key, dig, n_chunks, key_cols, c0, n_slice);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();    // every warp is done with the tiles

  // every s32 limb sum of the block into shared memory, rows padded to
  // LR_ROW ints (a quad's 8-byte stores cover the 32 banks once a half warp)
  int* sums = (int*)im_smem;
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
      int* at = sums + (wm * 32 + mi * 16 + g) * LR_ROW + wn * 64 + ni * 8 + 2 * t;
      *(int2*)at = make_int2(acc[mi][ni][0], acc[mi][ni][1]);
      *(int2*)(at + 8 * LR_ROW) = make_int2(acc[mi][ni][2], acc[mi][ni][3]);
    }
  }
  __syncthreads();
  // output word w of ciphertext cb: sum_t sum_j 2^(8 (t + j)) S[cb T + t][8 w + j]
  // mod 2^64 (the pairs t + j >= 8 vanish)
  const int per = IM_BM / limbs;
  const bool split = gridDim.z > 1;
  for (int q = tid; q < per * (IM_BN / 8); q += IM_THREADS) {
    const int cb = q / (IM_BN / 8);
    const int w = q - cb * (IM_BN / 8);
    const int b = blockIdx.y * per + cb;
    const int col = blockIdx.x * (IM_BN / 8) + w;
    if (b >= batch || col >= m_out) continue;
    u64 sum = 0ull;
    for (int tt = 0; tt < limbs; ++tt) {
      const int4* row = (const int4*)(sums + (cb * limbs + tt) * LR_ROW + 8 * w);
      const int4 lo = row[0], hi = row[1];
      const int s[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (tt + j < 8) sum += (u64)(long long)s[j] << (8 * (tt + j));
      }
    }
    const u64 body = (col == m_out - 1 && blockIdx.z == 0)
                         ? ct[(size_t)b * ((size_t)n_in + 1) + n_in] : 0ull;
    u64* o = out + (size_t)b * m_out + col;
    if (split) {
      atomicAdd((unsigned long long*)o, body - sum);
    } else {
      *o = body - sum;
    }
  }
}

template <int WB>
int launch_generic(void* out, const void* ct, const void* ksk, int batch, int n_in,
                   int levels, int m_out, int base_log, void* stream) {
  if (levels < 1 || levels > MAX_LEVELS || levels > KC || base_log < 1 ||
      base_log * levels >= 64 || (WB == 4 && base_log > 31)) {
    return (int)cudaErrorInvalidValue;
  }
  dim3 grid((batch + TB - 1) / TB, (m_out + TC - 1) / TC);
  if (WB == 8 && base_log > 31) {
    keyswitch_wide_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (u64*)out, (const u64*)ct, (const u64*)ksk, batch, n_in, levels, m_out, base_log);
  } else if (WB == 8) {
    keyswitch_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (u64*)out, (const u64*)ct, (const u64*)ksk, batch, n_in, levels, m_out, base_log);
  } else {
    keyswitch32_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (u64*)out, (const u64*)ct, (const u64*)ksk, batch, n_in, levels, m_out, base_log);
  }
  return (int)cudaGetLastError();
}

template <int WB>
int launch_imma(void* out, const void* ct, const void* key, void* digits, int batch,
                int n_in, int levels, int m_out, int base_log, int n_chunks, int key_cols,
                int splits, void* stream) {
  if (!imma_shape(n_in, levels, base_log) || batch < 1 || m_out < 1 ||
      key_cols % IM_BN != 0 || key_cols < WB * m_out ||
      n_chunks != (n_in + IM_KC / levels - 1) / (IM_KC / levels) ||
      ((uintptr_t)key & 15) != 0 || ((uintptr_t)digits & 15) != 0 || splits < 1 ||
      splits > n_chunks) {
    return (int)cudaErrorInvalidValue;
  }
  // the slices of the contraction: per chunks each (the last may be
  // shorter), none empty
  const int per = (n_chunks + splits - 1) / splits;
  splits = (n_chunks + per - 1) / per;
  auto kernel = WB == 8 ? keyswitch_imma_kernel : keyswitch32_imma_kernel;
  static std::atomic<unsigned> smem_set{0};   // one a WB instance
  cudaError_t err = ntt_common::set_smem_once(kernel, IM_SMEM, false, smem_set);
  if (err != cudaSuccess) return (int)err;
  const int rows_pad = (batch + IM_BM - 1) / IM_BM * IM_BM;
  const size_t bytes = (size_t)rows_pad * n_chunks * IM_KC;
  keyswitch_digits_kernel<<<(unsigned)((bytes + IM_DIGIT_THREADS - 1) / IM_DIGIT_THREADS),
                            IM_DIGIT_THREADS, 0, (cudaStream_t)stream>>>(
      (signed char*)digits, (const u64*)ct, batch, n_in, levels, base_log, n_chunks, rows_pad);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 grid(key_cols / IM_BN, rows_pad / IM_BM, splits);
  kernel<<<grid, IM_THREADS, IM_SMEM, (cudaStream_t)stream>>>(
      (u64*)out, (const u64*)ct, (const uint4*)key, (const uint4*)digits, batch, n_in, m_out,
      n_chunks, key_cols, per);
  return (int)cudaGetLastError();
}

int launch_limbs(void* out, const void* ct, const void* key, void* digits, int batch,
                 int n_in, int levels, int m_out, int base_log, int n_chunks, int key_cols,
                 int splits, void* stream) {
  if (!limb_shape(n_in, levels, base_log) || batch < 1 || m_out < 1 ||
      key_cols % IM_BN != 0 || key_cols < 8 * m_out ||
      n_chunks != (n_in + IM_KC / levels - 1) / (IM_KC / levels) ||
      ((uintptr_t)key & 15) != 0 || ((uintptr_t)digits & 15) != 0 || splits < 1 ||
      splits > n_chunks) {
    return (int)cudaErrorInvalidValue;
  }
  const int per = (n_chunks + splits - 1) / splits;
  splits = (n_chunks + per - 1) / per;
  static std::atomic<unsigned> smem_set{0};
  cudaError_t err = ntt_common::set_smem_once(keyswitch_limbs_kernel, IM_SMEM, false, smem_set);
  if (err != cudaSuccess) return (int)err;
  const int limbs = limb_count(base_log);
  const int row_blocks = (batch + IM_BM / limbs - 1) / (IM_BM / limbs);
  const size_t bytes = (size_t)row_blocks * IM_BM * n_chunks * IM_KC;
  const size_t zero_words = splits > 1 ? (size_t)batch * m_out : 0;
  const size_t threads = bytes > zero_words ? bytes : zero_words;
  keyswitch_limb_rows_kernel<<<(unsigned)((threads + IM_DIGIT_THREADS - 1) / IM_DIGIT_THREADS),
                               IM_DIGIT_THREADS, 0, (cudaStream_t)stream>>>(
      (signed char*)digits, (u64*)out, zero_words, (const u64*)ct, batch, n_in, levels,
      base_log, n_chunks, limbs, bytes);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 grid(key_cols / IM_BN, row_blocks, splits);
  keyswitch_limbs_kernel<<<grid, IM_THREADS, IM_SMEM, (cudaStream_t)stream>>>(
      (u64*)out, (const u64*)ct, (const uint4*)key, (const uint4*)digits, batch, n_in, m_out,
      n_chunks, key_cols, per, limbs);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tfhe_torch_keyswitch(void* out, const void* ct, const void* ksk,
                                    int batch, int n_in, int levels, int m_out,
                                    int base_log, void* stream) {
  return launch_generic<8>(out, ct, ksk, batch, n_in, levels, m_out, base_log, stream);
}

// K1-32's generic kernel: ksk the (n_in, l, m_out) key of u32 words held in
// u64, out (batch, m_out) u64 in [0, 2^32).
extern "C" int tfhe_torch_keyswitch32(void* out, const void* ct, const void* ksk,
                                      int batch, int n_in, int levels, int m_out,
                                      int base_log, void* stream) {
  return launch_generic<4>(out, ct, ksk, batch, n_in, levels, m_out, base_log, stream);
}

// Which kernel K1 (and K1-32) runs at a shape: 1 for the tensor-core kernel,
// 0 for the generic one.  The wrapper (ops/kernels.py keyswitch) chooses by it.
extern "C" int tfhe_torch_keyswitch_imma_shape(int n_in, int levels, int base_log) {
  return imma_shape(n_in, levels, base_log) ? 1 : 0;
}

// The tensor-core kernel's key layout: digit positions a chunk (IM_KC) and
// limb columns a block (IM_BN), which ops/kernels.py keyswitch_key_limbs
// builds the key's byte layout with.
extern "C" int tfhe_torch_keyswitch_imma_chunk() { return IM_KC; }
extern "C" int tfhe_torch_keyswitch_imma_columns() { return IM_BN; }

// The tensor-core kernel: key the (n_chunks, key_cols, 128) byte layout of
// ops/kernels.py keyswitch_key_limbs (16-byte aligned), key_cols a multiple
// of IM_BN covering 8 m_out limb columns, n_chunks = ceil(n_in / (128 / l));
// the contraction is cut into splits slices of chunks (out zeroed where
// splits > 1: the slices add their words into it); digits the (ceil(batch /
// IM_BM) IM_BM, n_chunks, IM_KC) byte scratch of the digit tiles (16-byte
// aligned), written by the digits kernel first.
extern "C" int tfhe_torch_keyswitch_imma(void* out, const void* ct, const void* key,
                                         void* digits, int batch, int n_in, int levels,
                                         int m_out, int base_log, int n_chunks, int key_cols,
                                         int splits, void* stream) {
  return launch_imma<8>(out, ct, key, digits, batch, n_in, levels, m_out, base_log, n_chunks,
                        key_cols, splits, stream);
}

// K1-32's tensor-core kernel: the same layout at 4 limb columns a word
// (key_cols covering 4 m_out), out u64 in [0, 2^32).
extern "C" int tfhe_torch_keyswitch32_imma(void* out, const void* ct, const void* key,
                                           void* digits, int batch, int n_in, int levels,
                                           int m_out, int base_log, int n_chunks,
                                           int key_cols, int splits, void* stream) {
  return launch_imma<4>(out, ct, key, digits, batch, n_in, levels, m_out, base_log, n_chunks,
                        key_cols, splits, stream);
}

// Whether K1 runs its limb-row kernel at a shape: its limbs a digit T
// (limb_shape), else 0.  ops/kernels.py asks it where
// tfhe_torch_keyswitch_imma_shape says 0.
extern "C" int tfhe_torch_keyswitch_limb_shape(int n_in, int levels, int base_log) {
  return limb_shape(n_in, levels, base_log) ? limb_count(base_log) : 0;
}

// K1's limb-row kernel: key the tensor-core kernel's (n_chunks, key_cols,
// 128) byte layout (16-byte aligned, key_cols covering 8 m_out), digits the
// (ceil(batch / (IM_BM / T)) IM_BM, n_chunks, IM_KC) byte scratch of the
// limb rows (16-byte aligned), written by the limb-row digits kernel, which
// also zeroes out where splits > 1.
extern "C" int tfhe_torch_keyswitch_limbs(void* out, const void* ct, const void* key,
                                          void* digits, int batch, int n_in, int levels,
                                          int m_out, int base_log, int n_chunks, int key_cols,
                                          int splits, void* stream) {
  return launch_limbs(out, ct, key, digits, batch, n_in, levels, m_out, base_log, n_chunks,
                      key_cols, splits, stream);
}
