// K5: exact u128 blind rotation over a 6-prime CRT-NTT (the PBS128 of noise
// squashing), for sm_90a.
//
// Replaces: tfhe_tpu/ops/pallas_ntt.py:1123 `build_blind_rotate_v2q` (the
// quad-word u128 Pallas kernel; meaning tfhe_tpu/ops/server128.py:185
// blind_rotate128).  Plain version: tfhe_tpu_torch/ops/server128.py
// `blind_rotate128`.
//
// For every batch element and every mask element a_i (i = 0 .. n-1), on the
// u128 torus:
//   ct1  = acc * X^{a_i} - acc
//   prod = sum_{lev, r} NTT^-1( NTT(residues(digit_lev(ct1_r))) . GGSW_i[lev][r] )
//          reconstructed mod 2^128 with Garner (the signed |X| < P/2 fix)
//   acc += prod
// The product's integer stays below 2^(11+23+128+log2 9) ~ 2^165.2 at the
// production set, against P/2 ~ 2^179 for the six primes, so it is exact in
// any summation order once each residue is canonical.
//
// What bounds it: per step and batch element, l(k+1) digit polynomials and
// (k+1) output polynomials transformed for each of six primes (72 NTTs of
// N = 2048 at k+1 = l = 3) plus 27 x 6 x N pointwise products and Garner,
// against a 1.33 MB key slice that every batch element reads from L2.
// The first design (one prime at a time, the digits decomposed again
// for each prime, fully reduced butterflies, a key product that waited on
// one 4-byte load after another) spent 41 % of a step in the key product,
// 27 % in the forward transforms and 15 % in the six decompositions, at
// 1201.12 ms for B = 512 (NVIDIA H100 80GB HBM3, 700 W; PERF.md §6).
//
// Design (blind_rotate128_lazy_kernel, the squashing shapes k+1 = 3, l = 3,
// N = 2048 and k+1 = 2, l = 3, N = 512): one block of 512 threads a
// ciphertext; the u128 accumulator stays in global memory (L2: 96 KB a
// block, read rotated once a step with one wrap, coalesced), so shared
// memory holds the step's signed digits, decomposed once a step (l (k+1)
// N int32, 73,728 B), and one prime's padded residue rows (76,032 B).  For
// each prime: the first forward pass forms the digits' residues and runs
// four lazy stages in registers; the other passes are ntt_common.cuh's
// lazy Shoup butterflies (residues in [0, 4p), one stage an
// instantiation); the key product loads 16 bytes (four positions) a
// (row, column) and sums up to four products in 64 bits before one
// Montgomery reduction; the last inverse pass writes canonical residues
// to a per-block global scratch (6 (k+1) N u32), which Garner (N^-1
// applied there) reads once a step.  Other shapes run the first design
// (blind_rotate128_kernel): the accumulator and one prime's rows in shared
// memory, the digits decomposed again for each prime.

#include "ntt_common.cuh"

using namespace ntt_common;

namespace {

typedef unsigned __int128 u128;
typedef __int128 i128;

constexpr int NP6 = 6;          // primes of the u128 CRT-NTT (ops/ntt.py 6-prime plans)
constexpr int POINTWISE_TILE = 4;
constexpr int MAXK1 = 3;        // k + 1 <= 3
constexpr int MAX_LEVELS = 8;

// layout of the packed table written by ops/ntt.py _kernel_consts128
struct Consts128 {
  u32 p[NP6];
  u32 pinv[NP6];
  u32 ninv[NP6];
  u32 inv[NP6];
  u32 pm[NP6][NP6];
  u128 prods[NP6];
  u128 pmod;
  u32 half[NP6];
};

// One thread fills c from the packed table; the caller synchronises.
__device__ __forceinline__ void load_consts128(Consts128& c, const long long* __restrict__ g) {
  for (int i = 0; i < NP6; ++i) {
    c.p[i] = (u32)g[i];
    c.pinv[i] = (u32)g[NP6 + i];
    c.ninv[i] = (u32)g[2 * NP6 + i];
    c.inv[i] = (u32)g[3 * NP6 + i];
    for (int j = 0; j < NP6; ++j) c.pm[i][j] = (u32)g[24 + NP6 * i + j];
    c.prods[i] = (u128)(u64)g[60 + 2 * i] | ((u128)(u64)g[61 + 2 * i] << 64);
    c.half[i] = (u32)g[74 + i];
  }
  c.pmod = (u128)(u64)g[72] | ((u128)(u64)g[73] << 64);
}

// The constants object of ntt_common's passes for one prime: every
// polynomial of the residue block holds prime pi.
struct OnePrime {
  u32 p;
  u32 pinv;
  int pi;
  __device__ __forceinline__ int prime_of(int) const { return pi; }
  __device__ __forceinline__ u32 modulus(int) const { return p; }
  __device__ __forceinline__ u32 minv(int) const { return pinv; }
};

// Closest-representable rounding with balanced tie-breaking on 128 bits
// (ops/server128.py signed_decompose128; rep = base_log * levels < 128).
__device__ __forceinline__ u128 decomposer_state128(u128 x, int base_log, int levels) {
  const int rep = base_log * levels;
  u128 res = x >> (128 - rep - 1);
  const u128 rounding_bit = res & 1u;
  res = (res + 1u) >> 1;
  res &= (((u128)1) << rep) - 1u;
  const u128 nb = (((res - 1u) | (rounding_bit << (rep - 1))) & res) >> (rep - 1);
  return res - (nb << rep);
}

// The next signed digit, lowest level first; the state shifts arithmetically.
__device__ __forceinline__ long long next_digit128(u128& state, int base_log) {
  const u64 r = (u64)state & ((1ull << base_log) - 1ull);
  state = (u128)((i128)state >> base_log);
  const u64 carry = (((r - 1ull) | (u64)state) & r) >> (base_log - 1);
  state += carry;
  return (long long)(r - (carry << base_log));
}

// The canonical residue of a digit |d| <= 2^30 (base_log <= 31) mod p > 2^29.
__device__ __forceinline__ u32 digit_residue(long long d, u32 p) {
  d += d < 0 ? (long long)p : 0ll;
  d += d < 0 ? (long long)p : 0ll;
  d -= d >= (long long)p ? (long long)p : 0ll;
  return (u32)d;
}

// The u128 word of one coefficient from its six inverse-transformed
// residues col[pi * stride]: scale by N^-1, Garner's mixed radix, the signed
// value |X| < P/2 taken mod 2^128 (ops/ntt.py garner_to_u128).
__device__ __forceinline__ u128 garner_u128(const u32* col, int stride, const Consts128& c) {
  u32 dg[NP6];
#pragma unroll
  for (int pi = 0; pi < NP6; ++pi) {
    dg[pi] = mont_mul(col[pi * stride], c.ninv[pi], c.p[pi], c.pinv[pi]);
  }
#pragma unroll
  for (int jp = 1; jp < NP6; ++jp) {
    const u32 pj = c.p[jp];
    const u32 pinvj = c.pinv[jp];
    u32 v = dg[0] >= pj ? dg[0] - pj : dg[0];
#pragma unroll
    for (int i = 1; i < jp; ++i) {
      v += mont_mul(dg[i], c.pm[i - 1][jp], pj, pinvj);
      v = v >= pj ? v - pj : v;
    }
    const u32 rr = dg[jp];
    const u32 d = rr >= v ? rr - v : rr + pj - v;
    dg[jp] = mont_mul(d, c.inv[jp], pj, pinvj);
  }
  u128 x = dg[0];
  bool neg = dg[0] > c.half[0];
#pragma unroll
  for (int i = 1; i < NP6; ++i) {
    x += (u128)dg[i] * c.prods[i];
    neg = (dg[i] > c.half[i]) || (dg[i] == c.half[i] && neg);
  }
  return neg ? x - c.pmod : x;
}

// The generic instance (the first design): any shape the wrapper accepts.
__global__ void __launch_bounds__(THREADS, 1)
blind_rotate128_kernel(u128* __restrict__ acc_g, const int* __restrict__ mask_g,
                       const u32* __restrict__ bsk, const u32* __restrict__ psi,
                       const u32* __restrict__ psi_inv,
                       const long long* __restrict__ consts_g, u32* __restrict__ scratch_g,
                       int n_steps, int k1, int log_n, int levels, int base_log) {
  extern __shared__ u128 smem128[];
  __shared__ Consts128 c;
  const int n_poly = 1 << log_n;
  const int row = padded_len(n_poly);       // padded residue row
  const int coeffs = k1 * n_poly;
  const int in_polys = levels * k1;
  u128* acc = smem128;                      // (k1, N)
  u32* res = (u32*)(smem128 + coeffs);      // (levels, k1, row)
  const int tid = threadIdx.x;
  u128* acc_b = acc_g + (size_t)blockIdx.x * coeffs;
  const int* mask_b = mask_g + (size_t)blockIdx.x * n_steps;
  u32* scr = scratch_g + (size_t)blockIdx.x * NP6 * coeffs;   // (6, k1, N)

  if (tid == 0) load_consts128(c, consts_g);
  for (int q = tid; q < coeffs; q += THREADS) acc[q] = acc_b[q];
  __syncthreads();

  const size_t step_words = (size_t)in_polys * k1 * NP6 * n_poly;

  for (int step = 0; step < n_steps; ++step) {
    const int a = mask_b[step];                 // in [0, 2N)
    const int rot = a & (n_poly - 1);
    const bool odd = ((a >> log_n) & 1) != 0;
    const u32* key = bsk + (size_t)step * step_words;

    for (int pi = 0; pi < NP6; ++pi) {
      const OnePrime sel{c.p[pi], c.pinv[pi], pi};

      // 1. ct1 = acc * X^a - acc; signed digits; their residues mod p_pi
      for (int q = tid; q < coeffs; q += THREADS) {
        const int cpoly = q >> log_n;
        const int j = q & (n_poly - 1);
        u128 v = j < rot ? (u128)0 - acc[q - rot + n_poly] : acc[q - rot];
        if (odd) v = (u128)0 - v;
        u128 state = decomposer_state128(v - acc[q], base_log, levels);
        u32* out = res + cpoly * row + pad(j);
        for (int lev = 0; lev < levels; ++lev, out += k1 * row) {
          *out = digit_residue(next_digit128(state, base_log), sel.p);
        }
      }
      __syncthreads();

      // 2. forward NTT of every (lev, r) polynomial
      forward_ntt(res, in_polys, log_n, row, psi, sel);

      // 3. pointwise multiply-accumulate with the key slice into rows (0, c)
      for (int j0 = tid; j0 < n_poly; j0 += POINTWISE_TILE * THREADS) {
        u32 out[POINTWISE_TILE][MAXK1];
#pragma unroll
        for (int u = 0; u < POINTWISE_TILE; ++u) {
#pragma unroll
          for (int cc = 0; cc < MAXK1; ++cc) out[u][cc] = 0u;
        }
        for (int r = 0; r < in_polys; ++r) {
#pragma unroll
          for (int u = 0; u < POINTWISE_TILE; ++u) {
            const int j = j0 + u * THREADS;
            if (j < n_poly) {
              const u32 x = res[r * row + pad(j)];
              const u32* krow = key + ((size_t)r * k1 * NP6 + pi) * n_poly + j;
#pragma unroll
              for (int cc = 0; cc < MAXK1; ++cc) {
                if (cc < k1) {
                  out[u][cc] = add_mod(
                      out[u][cc], mont_mul(x, __ldg(krow + cc * NP6 * n_poly), sel.p, sel.pinv),
                      sel.p);
                }
              }
            }
          }
        }
#pragma unroll
        for (int u = 0; u < POINTWISE_TILE; ++u) {
          const int j = j0 + u * THREADS;
          if (j < n_poly) {
#pragma unroll
            for (int cc = 0; cc < MAXK1; ++cc) {
              if (cc < k1) res[cc * row + pad(j)] = out[u][cc];
            }
          }
        }
      }
      __syncthreads();

      // 4. inverse NTT of the (k+1) output columns, kept for Garner
      inverse_ntt(res, k1, log_n, row, psi_inv, sel);
      for (int q = tid; q < coeffs; q += THREADS) {
        scr[pi * coeffs + q] = res[(q >> log_n) * row + pad(q & (n_poly - 1))];
      }
      __syncthreads();
    }

    // 5. N^-1, Garner to u128 over the six stored residues, accumulate (each
    // thread reads the scratch words it wrote itself)
    for (int q = tid; q < coeffs; q += THREADS) acc[q] += garner_u128(scr + q, coeffs, c);
    __syncthreads();
  }

  for (int q = tid; q < coeffs; q += THREADS) acc_b[q] = acc[q];
}

// ---------------------------------------------------------------------------
// The lazy kernel: digits decomposed once a step, the accumulator in global
// memory, ntt_common.cuh's lazy passes one prime at a time.
// ---------------------------------------------------------------------------

template <int K1, int LEVELS, int LOG_N>
struct Lazy128 {
  static constexpr int N = 1 << LOG_N;
  static constexpr int ROW = N + N / 32;             // padded residue row
  static constexpr int ROWS = LEVELS * K1;           // digit rows (lev, r)
  static constexpr int LO = LOG_N - 4;               // the first pass takes stages 0-3
  static constexpr int LAST = (LOG_N - 5) % 4 + 1;   // stages of the last forward pass
  static constexpr int MIDDLE = (LOG_N - 4 - LAST) / 4;
  static constexpr int INV_LAST = (LOG_N - 1) % 4 + 1;
  static constexpr int INV_MIDDLE = (LOG_N - INV_LAST) / 4;
  // the digits (ROWS, N) int32 and one prime's padded rows (ROWS, ROW)
  static constexpr int SMEM = (ROWS * N + ROWS * ROW) * 4;
  static_assert(LOG_N >= 9 && LOG_N - LAST >= 5 && LOG_N - INV_LAST >= 5,
                "the fused passes split pad() over their strides");
};

template <int K1, int LEVELS, int LOG_N>
__global__ void __launch_bounds__(THREADS, 1)
blind_rotate128_lazy_kernel(u128* __restrict__ acc_g, const int* __restrict__ mask_g,
                            const uint4* __restrict__ bsk, const uint2* __restrict__ tw_fwd,
                            const uint2* __restrict__ tw_inv,
                            const long long* __restrict__ consts_g,
                            u32* __restrict__ scratch_g, int n_steps, int base_log) {
  using S = Lazy128<K1, LEVELS, LOG_N>;
  constexpr int N = S::N;
  constexpr int ROW = S::ROW;
  constexpr int ROWS = S::ROWS;
  constexpr int LO = S::LO;
  extern __shared__ u32 lazy_smem[];
  __shared__ Consts128 c;
  int* dig = (int*)lazy_smem;                 // (LEVELS, K1, N)
  u32* rows = lazy_smem + ROWS * N;           // (LEVELS K1, ROW), one prime
  const int tid = threadIdx.x;
  u128* acc = acc_g + (size_t)blockIdx.x * K1 * N;
  const int* mask_b = mask_g + (size_t)blockIdx.x * n_steps;
  u32* scr = scratch_g + (size_t)blockIdx.x * NP6 * K1 * N;   // (6, K1, N)
  if (tid == 0) load_consts128(c, consts_g);
  __syncthreads();

  for (int step = 0; step < n_steps; ++step) {
    const int a = mask_b[step];                 // in [0, 2N)
    const int rot = a & (N - 1);
    const bool odd = ((a >> LOG_N) & 1) != 0;

    // 1. ct1 = acc X^a - acc, read from global memory, decomposed once
    for (int q = tid; q < K1 * N; q += THREADS) {
      const int r = q >> LOG_N;
      const int j = q & (N - 1);
      const u128* A = acc + r * N;
      u128 v = j < rot ? (u128)0 - A[j - rot + N] : A[j - rot];
      if (odd) v = (u128)0 - v;
      u128 state = decomposer_state128(v - A[j], base_log, LEVELS);
#pragma unroll
      for (int lev = 0; lev < LEVELS; ++lev) {
        dig[(lev * K1 + r) * N + j] = (int)next_digit128(state, base_log);
      }
    }
    __syncthreads();

    const uint4* key = bsk + (size_t)step * ROWS * K1 * NP6 * (N / 4);
    for (int pi = 0; pi < NP6; ++pi) {
      const u32 p = c.p[pi];
      const u32 pinv = c.pinv[pi];
      Consts one;                               // lazy_pass reads its prime from p[0]
      one.p[0] = p;
      const uint2* twf = tw_fwd + (pi << LOG_N);
      const uint2* twi = tw_inv + (pi << LOG_N);

      // 2. the digits' residues and forward stages 0-3, in registers
      for (int q = tid; q < ROWS << LO; q += THREADS) {
        const int row = q >> LO;
        const int lo = q & ((1 << LO) - 1);
        const int* d = dig + row * N + lo;
        u32 v[16];
#pragma unroll
        for (int b = 0; b < 16; ++b) v[b] = lazy_digit_residue(d[b << LO], p);
        lazy_forward_stages<4, LOG_N>(v, 0, 0, twf, p);
        u32* x = rows + row * ROW + pad(lo);
#pragma unroll
        for (int b = 0; b < 16; ++b) x[pad(b << LO)] = v[b];
      }
      __syncthreads();
      for (int m = 0; m < S::MIDDLE; ++m) {
        lazy_pass<4, LOG_N, 1, THREADS, true>(rows, ROWS, 4 + 4 * m, twf, one);
        __syncthreads();
      }
      lazy_pass<S::LAST, LOG_N, 1, THREADS, true>(rows, ROWS, LOG_N - S::LAST, twf, one);
      __syncthreads();

      // 3. the key product over four positions a task: one 16-byte key load
      // a (row, column), up to four products summed in 64 bits before each
      // Montgomery reduction (4 p^2 < p 2^32 for p < 2^30); written over
      // rows 0 .. K1-1 in [0, 2p)
      for (int q = tid; q < N / 4; q += THREADS) {
        const int t0 = q * 4;
        const int at = pad(t0);                 // pad(t0 + e) = at + e
        u32 x[ROWS][4];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
#pragma unroll
          for (int e = 0; e < 4; ++e) x[r][e] = reduce_to(reduce_to(rows[r * ROW + at + e], 2 * p), p);
        }
        u32 out[K1][4];
#pragma unroll
        for (int cc = 0; cc < K1; ++cc) {
          u64 sum[4] = {0, 0, 0, 0};
#pragma unroll
          for (int e = 0; e < 4; ++e) out[cc][e] = 0u;
#pragma unroll
          for (int r = 0; r < ROWS; ++r) {
            const uint4 k = __ldg(key + (((r * K1 + cc) * NP6 + pi) * N + t0) / 4);
            sum[0] += (u64)x[r][0] * k.x;
            sum[1] += (u64)x[r][1] * k.y;
            sum[2] += (u64)x[r][2] * k.z;
            sum[3] += (u64)x[r][3] * k.w;
            if (r % 4 == 3 || r == ROWS - 1) {
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                out[cc][e] = reduce_to(out[cc][e] + redc_lazy(sum[e], p, pinv), 2 * p);
                sum[e] = 0;
              }
            }
          }
        }
#pragma unroll
        for (int cc = 0; cc < K1; ++cc) {
#pragma unroll
          for (int e = 0; e < 4; ++e) rows[cc * ROW + at + e] = out[cc][e];
        }
      }
      __syncthreads();

      // 4. the inverse transforms of the K1 output rows; the last pass
      // writes canonical residues to the scratch
      for (int m = 0; m < S::INV_MIDDLE; ++m) {
        lazy_pass<4, LOG_N, 1, THREADS, false>(rows, K1, 4 * m, twi, one);
        __syncthreads();
      }
      constexpr int SL = S::INV_LAST;
      constexpr int K0 = LOG_N - SL;
      for (int q = tid; q < K1 << K0; q += THREADS) {
        const int cc = q >> K0;
        const int lo = q & ((1 << K0) - 1);
        const u32* x = rows + cc * ROW + pad(lo);
        u32 y[1 << SL];
#pragma unroll
        for (int b = 0; b < (1 << SL); ++b) y[b] = x[pad(b << K0)];
        lazy_inverse_stages<SL, LOG_N>(y, K0, 0, twi, p);
        u32* out = scr + (pi * K1 + cc) * N + lo;
#pragma unroll
        for (int b = 0; b < (1 << SL); ++b) out[b << K0] = reduce_to(y[b], p);
      }
      __syncthreads();
    }

    // 5. N^-1 and Garner to u128 over the six primes' residues; accumulate
    for (int q = tid; q < K1 * N; q += THREADS) acc[q] += garner_u128(scr + q, K1 * N, c);
    __syncthreads();
  }
}

}  // namespace

extern "C" int tfhe_torch_blind_rotate128_smem_bytes(int k1, int n_poly, int levels) {
  return k1 * n_poly * 16 + levels * k1 * padded_len(n_poly) * 4;
}

namespace {

template <int K1, int LEVELS, int LOG_N>
cudaError_t launch_lazy(void* acc, const void* mask, const void* bsk, const void* tw_fwd,
                        const void* tw_inv, const void* consts, void* scratch, int batch,
                        int n_steps, int base_log, cudaStream_t stream) {
  return launch_blocks(blind_rotate128_lazy_kernel<K1, LEVELS, LOG_N>, batch,
                       Lazy128<K1, LEVELS, LOG_N>::SMEM, stream, (u128*)acc, (const int*)mask,
                       (const uint4*)bsk, (const uint2*)tw_fwd, (const uint2*)tw_inv,
                       (const long long*)consts, (u32*)scratch, n_steps, base_log);
}

}  // namespace

// acc: (batch, k1, N) u128 (little-endian (lo, hi) u64 pairs), rotated in
// place; psi, psi_inv: the plan's Montgomery twiddles (the generic kernel);
// tw_fwd, tw_inv: their Shoup pairs (the lazy kernel); scratch:
// batch * 6 * k1 * N u32.
extern "C" int tfhe_torch_blind_rotate128(void* acc, const void* mask, const void* bsk,
                                          const void* psi, const void* psi_inv,
                                          const void* tw_fwd, const void* tw_inv,
                                          const void* consts, void* scratch, int batch,
                                          int n_steps, int k1, int log_n, int levels,
                                          int nprimes, int base_log, void* stream) {
  if (nprimes != NP6 || k1 < 1 || k1 > MAXK1 || levels < 1 || levels > MAX_LEVELS ||
      base_log < 1 || base_log > 31 || base_log * levels >= 128 || log_n < 1 ||
      log_n > 16 || batch < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  if (k1 == 3 && levels == 3 && log_n == 11) {
    return (int)launch_lazy<3, 3, 11>(acc, mask, bsk, tw_fwd, tw_inv, consts, scratch, batch,
                                      n_steps, base_log, st);
  }
  if (k1 == 2 && levels == 3 && log_n == 9) {
    return (int)launch_lazy<2, 3, 9>(acc, mask, bsk, tw_fwd, tw_inv, consts, scratch, batch,
                                     n_steps, base_log, st);
  }
  return (int)launch_blocks(blind_rotate128_kernel, batch,
                            tfhe_torch_blind_rotate128_smem_bytes(k1, 1 << log_n, levels), st,
                            (u128*)acc, (const int*)mask, (const u32*)bsk, (const u32*)psi,
                            (const u32*)psi_inv, (const long long*)consts, (u32*)scratch,
                            n_steps, k1, log_n, levels, base_log);
}
