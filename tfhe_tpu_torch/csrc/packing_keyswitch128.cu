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
// product mod 2^128, which the kernel below takes exactly mod 2^128, so the
// words are the same and no CRT is needed.  The digits
// are 61-bit at V1_4 (base_log 61, one level).
//
// What bounds it on the H100: operations.  A list of count slots is count
// n l (k+1) N multiply-adds of a signed 61-bit digit by a u128 key word, mod
// 2^128 (3.8e9 at V1_4 with 128 slots); the key is 470 MB at V1_4, read
// once a list (0.14 ms at 3.35 TB/s).  On the CUDA cores a multiply-add is
// about 12 32-bit IMADs (10.8 ms for 4 lists); as int8 limb products on the
// tensor cores it is 100 limb pairs (a digit is 8 byte limbs, a u128 word
// 16, and mod 2^128 only the pairs a + b <= 15 count: 1.5 ms for 4 lists).
//
// The kernel (packing_keyswitch128_imma_kernel) takes the shapes that
// tfhe_torch_packing_keyswitch128_imma_smem takes (N in 256, 512, 1024,
// k+1 <= 8, base_log <= 62, the lists' shared memory within a block's:
// both squashed-noise compression sets); the wrapper refuses the others.
//
// Coefficient t of D(X) K(X) is sum_{m_v} Dx[t - m_v] K[m_v mod N] over the
// positions m_v in (t - count, t]: a Toeplitz of the digits times the key,
// as K4's (packing_keyswitch.cu), the wrap m_v < 0 taking -d.  Each signed
// digit d (and -d) is split into eight balanced bytes e_a in [-128, 127]
// (d = sum e_a 2^(8a)), each key word into sixteen unsigned bytes k_b, and
//   d K = sum_{a + b <= 15} 2^(8 (a+b)) e_a k_b   (mod 2^128),
// an s8 x u8 -> s32 product per limb pair on mma.sync.m16n8k32.  The
// accumulators hold the sums by shift s = a + b, sixteen columns a word:
// for digit limb a the B fragment of columns s is key limb row b = s - a
// (a row of zeros where b < 0), so each digit limb's 32-deep step is two
// mma a (tile, output polynomial) and the pairs a + b > 15 are never
// formed.  A block is 256 output coefficients of one list, 8 warps of two
// m16 tiles each and all k+1 <= 8 output polynomials, over a chunk of the
// input coefficients; for each row (i, lev) it stages, with cp.async two
// rows deep, the key's byte layout (ops/kernels.py
// packing_keyswitch128_key_limbs, built once by the key's owner) at the
// block's band m_v in [T0 - cp, T0 + 256), and decomposes the count digits
// of the row into reversed byte vectors R[x] = e_a(D[Z - x]) (of d and of
// -d); an A fragment register is four bytes of R, one funnel shift of two
// aligned shared loads.  A warp walks only its own band, cp / 32 + 1 steps
// (80 % of them useful at 128 slots).  Exactness: a row adds at most count
// x 8 x 128 x 255 to an s32 sum, so every floor(2^31 / (count 261,120))
// rows (64 at 128 slots) the sums are folded into u128 partial sums in
// shared memory (each word's sixteen columns shifted and added, the quad's
// lanes reduced with shuffles) and cleared; the words are exact mod 2^128.
// The chunks' partial sums go to global memory and a second kernel
// (packing_keyswitch128_reduce_kernel) sums them, negates, and adds the
// bodies.
//
// Why the int8 limbs and not 32-bit limb products with mad.wide.u32 and
// carry chains: the tensor cores' int8 rate (1,979 TOP/s) is about 120
// times the CUDA cores' 32-bit multiply rate, and a multiply-add needs 100
// limb pairs (200 operations) against 12 multiplies, so the limb form's
// bound is 7 times lower; the carry-chain form would keep K6 on the CUDA
// cores, where the direct-u128 design it replaced was 3.3 times slower
// (PERF.md, row 0e).

#include <cstdint>
#include <cuda_runtime.h>

#include "ntt_common.cuh"

using ntt_common::ldmatrix_x4;
using ntt_common::mma_s8u8;
using ntt_common::smem_u32;

namespace {

typedef unsigned long long u64;
typedef unsigned __int128 u128;
typedef __int128 i128;

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

typedef unsigned int u32;

constexpr int TC_ROWS = 256;        // output coefficients t a block (8 warps of 32)
constexpr int TC_THREADS = 256;
constexpr int TC_TILES = 2;         // m16 tiles of consecutive rows a warp
constexpr int TC_MAX_K1 = 8;        // output polynomials: n8 tile pairs a warp
constexpr int TC_LIMBS = 8;         // balanced byte limbs of a signed digit
constexpr int TC_KEY_LIMBS = 16;    // unsigned byte limbs of a u128 key word
// a limb-sum term: |e_a k_b| <= 128 255, at most 8 pairs a column s a position
constexpr long long TC_TERM = 8ll * 128 * 255;

// The shapes of the tensor-core kernel: N a multiple of TC_ROWS up to 1024,
// k+1 <= 8, digits |d| <= 2^61 (base_log <= 62: eight balanced bytes), and
// its shared memory (tc_smem_bytes) within a block's.
__host__ __device__ constexpr bool tc_shape(int levels, int k1, int log_n, int base_log) {
  return log_n >= 8 && log_n <= 10 && k1 >= 1 && k1 <= TC_MAX_K1 && levels >= 1 &&
         levels <= MAX_LEVELS && base_log >= 1 && base_log <= 62 && base_log * levels < 128;
}

// The digit band a list of count slots spans, in 32-deep steps: cp.
__host__ __device__ constexpr int tc_band(int count) { return (count + 31) / 32 * 32; }

// A key-limb row in shared memory: the block's positions m_v in
// [T0 - cp, T0 + TC_ROWS), padded by 16 bytes so that the eight rows of an
// ldmatrix phase fall on eight different 16-byte bank groups.
__host__ __device__ constexpr int tc_row_stride(int cp) { return cp + TC_ROWS + 16; }

// A reversed digit-limb vector: R[x] = limb(D[Z - x]), Z = cp + 32.
__host__ __device__ constexpr int tc_rlen(int cp) { return cp + 80; }

// Dynamic shared memory: two key stages (k+1 polynomials x 16 limb rows),
// 8 zero rows, two buffers of the 16 digit vectors (8 limbs of d and of -d),
// and the block's u128 partial sums (TC_ROWS x (k+1)).
__host__ __device__ constexpr int tc_smem_bytes(int k1, int max_count) {
  return 2 * k1 * TC_KEY_LIMBS * tc_row_stride(tc_band(max_count)) +
         8 * tc_row_stride(tc_band(max_count)) +
         2 * 2 * TC_LIMBS * tc_rlen(tc_band(max_count)) + TC_ROWS * k1 * 16;
}

// grid (N / TC_ROWS, lists, chunks of the input coefficients); 8 warps: warp
// w owns rows T0 + 32 w .. + 31 (two m16 tiles) of one list and all k+1
// output polynomials.  K1 fixes k+1 at compile time.
template <int K1>
__global__ void __launch_bounds__(TC_THREADS, 1)
packing_keyswitch128_imma_kernel(u128* __restrict__ partial, const u128* __restrict__ lwes,
                                 const uint4* __restrict__ key, const int* __restrict__ counts,
                                 int max_count, int n_in, int levels, int log_n, int base_log,
                                 int per_chunk) {
  extern __shared__ uint4 tc_smem[];
  const int n_poly = 1 << log_n;
  const int g = blockIdx.y, chunk = blockIdx.z;
  const int T0 = blockIdx.x * TC_ROWS;
  const int count = counts[g];
  const int cp = tc_band(count);
  const int rs = tc_row_stride(cp);
  const int rlen = tc_rlen(cp);
  const int stage_bytes = K1 * TC_KEY_LIMBS * rs;
  unsigned char* key_s = (unsigned char*)tc_smem;             // (2, K1, 16, rs)
  unsigned char* zero_s = key_s + 2 * stage_bytes;             // (8, rs)
  signed char* r_s = (signed char*)(zero_s + 8 * rs);          // (2, 2, 8, rlen)
  u128* part = (u128*)(r_s + 2 * 2 * TC_LIMBS * rlen);         // (TC_ROWS, K1)
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gq = lane >> 2, q = lane & 3;
  const int i0 = chunk * per_chunk;
  const int rows = (min(n_in, i0 + per_chunk) - i0) * levels;  // (i, lev) rows
  const u128* lwes_g = lwes + (size_t)g * max_count * (n_in + 1);
  // rows of s32 limb sums between two flushes into the u128 partial sums:
  // each row adds at most count TC_TERM to a sum
  const int flush_rows = (int)(((1ll << 31) - 1) / ((long long)count * TC_TERM));

  // zero the digit vectors, the zero rows and the partial sums
  for (int q16 = tid; q16 < (8 * rs + 2 * 2 * TC_LIMBS * rlen + TC_ROWS * K1 * 16) / 16;
       q16 += TC_THREADS) {
    ((uint4*)zero_s)[q16] = make_uint4(0u, 0u, 0u, 0u);
  }

  // key row r = (i0 + r / l, r % l) into stage s: for each output polynomial
  // c and limb b, the positions m_v = T0 - cp .. T0 + TC_ROWS - 1, m_v mod N
  // (the band wraps negacyclically: the sign is the digits')
  auto load_key = [&](int r, int s) {
    const int i = i0 + r / levels, lev = r % levels;
    const uint4* src = key + ((size_t)i * levels + lev) * K1 * TC_KEY_LIMBS * (n_poly / 16);
    unsigned char* dst = key_s + s * stage_bytes;
    const int units = (cp + TC_ROWS) / 16;
    for (int u = tid; u < K1 * TC_KEY_LIMBS * units; u += TC_THREADS) {
      const int row = u / units, v = u % units;
      const int m = (T0 - cp + 16 * v + n_poly) & (n_poly - 1);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                       smem_u32(dst + row * rs + 16 * v)),
                   "l"(src + row * (n_poly / 16) + m / 16));
    }
  };
  // the digits of row r into buffer buf: slot j's signed digit d, its eight
  // balanced bytes e_a (d = sum_a e_a 2^(8a), e_a in [-128, 127]) and those
  // of -d, at R[Z - j]
  auto decompose = [&](int r, int buf) {
    const int i = i0 + r / levels, lev = r % levels;
    for (int j = tid; j < count; j += TC_THREADS) {
      const long long d = digit128(lwes_g[(size_t)j * (n_in + 1) + i], base_log, levels, lev);
      long long vp = d, vn = -d;
      signed char* rp = r_s + (size_t)(buf * 2) * TC_LIMBS * rlen + cp + 32 - j;
      signed char* rn = rp + TC_LIMBS * rlen;
#pragma unroll
      for (int a = 0; a < TC_LIMBS; ++a) {
        const signed char ep = (signed char)(vp & 0xff), en = (signed char)(vn & 0xff);
        rp[a * rlen] = ep;
        rn[a * rlen] = en;
        vp = (vp - ep) >> 8;
        vn = (vn - en) >> 8;
      }
    }
  };

  int acc[TC_TILES][K1][2][4];
#pragma unroll
  for (int ti = 0; ti < TC_TILES; ++ti)
#pragma unroll
    for (int c = 0; c < K1; ++c)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[ti][c][h][e] = 0;

  const int Tw = 32 * warp;   // the warp's rows, from T0

  __syncthreads();   // zeroed before the digits are written
  if (rows > 0) {
    load_key(0, 0);
    decompose(0, 0);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  // the warp's band: 32-deep steps st at m_v = T0 + Tw - cp + 32 st
  const int steps = cp / 32 + 1;
  const int sh = ((-gq) & 3) * 8;   // x0 & 3 of every fragment register of the lane
  int since_flush = 0;
  for (int r = 0; r < rows; ++r) {
    __syncthreads();   // row r - 1 is done: its stage and digit buffer are free
    if (r + 1 < rows) {
      load_key(r + 1, (r + 1) & 1);
      decompose(r + 1, (r + 1) & 1);
    }
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 1;\n" ::);
    __syncthreads();   // row r's key tile and digits are visible
    const unsigned char* ks = key_s + (r & 1) * stage_bytes;
    for (int st = 0; st < steps; ++st) {
      const bool neg = T0 + Tw - cp + 32 * st < 0;   // m_v < 0: the wrapped band, -d
      const u32* rw0 = (const u32*)(r_s + (size_t)(((r & 1) * 2 + neg) * TC_LIMBS) * rlen);
      const int kcol = Tw + 32 * st;                  // the step's byte in a key row
      const int k0 = (32 + 32 * st + 4 * q - gq) >> 2;
#pragma unroll
      for (int a = 0; a < TC_LIMBS; ++a) {
        const u32* rw = rw0 + a * (rlen / 4);
        // A: tile ti's rows Tw + 16 ti + gq (+8), columns 32 st + 4 q (+16):
        // R at x0 = 32 + 32 st + 4 q - 16 ti - gq, x0 - 8, x0 + 16, x0 + 8
        u32 af[TC_TILES][4];
#pragma unroll
        for (int ti = 0; ti < TC_TILES; ++ti) {
          const int k = k0 - 4 * ti;
          af[ti][0] = __funnelshift_r(rw[k], rw[k + 1], sh);
          af[ti][1] = __funnelshift_r(rw[k - 2], rw[k - 1], sh);
          af[ti][2] = __funnelshift_r(rw[k + 4], rw[k + 5], sh);
          af[ti][3] = __funnelshift_r(rw[k + 2], rw[k + 3], sh);
        }
        // B: for each c, columns s = 8 h + (lane & 7) of limb b = s - a
        // (a zero row where b < 0), digit positions kcol .. + 31
        const int mat = lane >> 3;
        const int s = 8 * (mat >> 1) + (lane & 7);
        const int b = s - a;
        const int kb = kcol + 16 * (mat & 1);
#pragma unroll
        for (int c = 0; c < K1; ++c) {
          const unsigned char* row = b >= 0 ? ks + (c * TC_KEY_LIMBS + b) * rs
                                            : zero_s + (lane & 7) * rs;
          u32 bf[4];
          ldmatrix_x4(bf, smem_u32(row + kb));
#pragma unroll
          for (int ti = 0; ti < TC_TILES; ++ti) {
            mma_s8u8(acc[ti][c][0], af[ti], bf[0], bf[1]);
            mma_s8u8(acc[ti][c][1], af[ti], bf[2], bf[3]);
          }
        }
      }
    }
    if (++since_flush == flush_rows || r + 1 == rows) {
      // fold the s32 limb sums into the warp's u128 partial sums: lane
      // (gq, q) holds columns s = 8 h + 2 q + e, e < 2, of rows gq and
      // gq + 8 of each tile; the quad's four lanes hold a word's sixteen s
#pragma unroll
      for (int ti = 0; ti < TC_TILES; ++ti) {
#pragma unroll
        for (int c = 0; c < K1; ++c) {
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            u128 w = 0;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                w += (u128)(i128)acc[ti][c][h][2 * hr + e] << (8 * (8 * h + 2 * q + e));
                acc[ti][c][h][2 * hr + e] = 0;
              }
            }
#pragma unroll
            for (int x = 1; x <= 2; x <<= 1) {
              const u64 lo = __shfl_xor_sync(0xffffffffu, (u64)w, x);
              const u64 hi = __shfl_xor_sync(0xffffffffu, (u64)(w >> 64), x);
              w += ((u128)hi << 64) | lo;
            }
            if (q == 0) part[(Tw + 16 * ti + gq + 8 * hr) * K1 + c] += w;
          }
        }
      }
      since_flush = 0;
    }
  }
  __syncthreads();
  u128* out = partial + ((size_t)g * gridDim.z + chunk) * K1 * n_poly;
  for (int x = tid; x < TC_ROWS * K1; x += TC_THREADS) {
    const int c = x / TC_ROWS, t = x % TC_ROWS;
    out[(size_t)c * n_poly + T0 + t] = part[t * K1 + c];
  }
}

template <int K1>
int tc_launch(u128* partial, const u128* lwes, const uint4* key, const int* counts, int lists,
              int max_count, int n_in, int levels, int log_n, int base_log, int per_chunk,
              int smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(packing_keyswitch128_imma_kernel<K1>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((1 << log_n) / TC_ROWS, lists, (n_in + per_chunk - 1) / per_chunk);
  packing_keyswitch128_imma_kernel<K1><<<grid, TC_THREADS, smem, stream>>>(
      partial, lwes, key, counts, max_count, n_in, levels, log_n, base_log, per_chunk);
  return (int)cudaGetLastError();
}

}  // namespace

// The kernel's dynamic shared memory for lists of up to max_count slots, or
// -1 where it does not take the shape (the wrapper refuses those shapes,
// and those whose bytes pass a block's).
extern "C" int tfhe_torch_packing_keyswitch128_imma_smem(int k1, int log_n, int levels,
                                                         int base_log, int max_count) {
  if (!tc_shape(levels, k1, log_n, base_log) || max_count < 1 || max_count > (1 << log_n)) {
    return -1;
  }
  return tc_smem_bytes(k1, max_count);
}

// lwes (lists, max_count, n_in + 1) u128; key the (n_in, levels, k1, 16, N)
// byte layout of ops/kernels.py packing_keyswitch128_key_limbs (16-byte
// aligned); counts (lists,) int32 in [1, max_count] on the card; partial
// the (lists, chunks, k1, N) u128 scratch, chunks = ceil(n_in / per_chunk);
// out (lists, k1, N) u128.
extern "C" int tfhe_torch_packing_keyswitch128_imma(void* out, void* partial, const void* lwes,
                                                    const void* key, const void* counts,
                                                    int lists, int max_count, int n_in,
                                                    int levels, int k1, int log_n, int base_log,
                                                    int per_chunk, void* stream) {
  const int smem = tfhe_torch_packing_keyswitch128_imma_smem(k1, log_n, levels, base_log,
                                                             max_count);
  if (smem < 0 || lists < 1 || n_in < 1 || per_chunk < 1 || ((uintptr_t)key & 15) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  auto run = [&](auto launch) {
    return launch((u128*)partial, (const u128*)lwes, (const uint4*)key, (const int*)counts,
                  lists, max_count, n_in, levels, log_n, base_log, per_chunk, smem, st);
  };
  int err;
  switch (k1) {
    case 1: err = run(tc_launch<1>); break;
    case 2: err = run(tc_launch<2>); break;
    case 3: err = run(tc_launch<3>); break;
    case 4: err = run(tc_launch<4>); break;
    case 5: err = run(tc_launch<5>); break;
    case 6: err = run(tc_launch<6>); break;
    case 7: err = run(tc_launch<7>); break;
    default: err = run(tc_launch<8>); break;
  }
  if (err != 0) return err;
  const int n_poly = 1 << log_n;
  const int chunks = (n_in + per_chunk - 1) / per_chunk;
  const int total = lists * k1 * n_poly;
  packing_keyswitch128_reduce_kernel<<<(total + 255) / 256, 256, 0, st>>>(
      (u128*)out, (const u128*)partial, (const u128*)lwes, (const int*)counts, max_count, n_in,
      k1, log_n, chunks, total);
  return (int)cudaGetLastError();
}
