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
// N = 2048 at k+1 = l = 3) plus 27 x 6 x N pointwise products and Garner:
// about 1.2e6 Montgomery products (three 32-bit multiplies each), against a
// 1.3 MB key slice that every batch element reads.  Integer multiply issue
// rate bounds it, as it bounds K2.
// Design: one thread block per batch element looping over the n steps, as
// K2.  The u128 accumulator (k+1) N x 16 B (96 KB at N = 2048, k+1 = 3)
// stays in shared memory for the whole rotation; K2's "every prime's
// residues in shared memory too" does not fit (six primes' digit rows alone
// are 432 KB), so each step walks the primes one at a time: the digits are
// decomposed again from the accumulator for each prime (elementwise, cheap
// next to the transforms), their residues (l (k+1) rows, 74 KB) are
// transformed, multiplied with the key slice into (k+1) output columns
// written in place over the first rows, transformed back and stored to a
// per-block global scratch (6 (k+1) N u32, 144 KB a block, served from L2:
// each thread later reads back only the words it wrote).  Garner then runs
// once per coefficient over the six stored residues and adds the u128
// result to the accumulator.  The NTT passes, Montgomery arithmetic and row
// padding are ntt_common.cuh's, run with one prime at a time (OnePrime).
// Shared memory: 174 KB at the production shape, so one block an SM.

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

// K1T, LVT > 0 fix k + 1 and the level count at compile time (the
// production squashing set), so the pointwise product unrolls; 0 takes them
// from the arguments.
template <int K1T, int LVT>
__global__ void __launch_bounds__(THREADS, 1)
blind_rotate128_kernel(u128* __restrict__ acc_g, const int* __restrict__ mask_g,
                       const u32* __restrict__ bsk, const u32* __restrict__ psi,
                       const u32* __restrict__ psi_inv,
                       const long long* __restrict__ consts_g, u32* __restrict__ scratch_g,
                       int n_steps, int k1_arg, int log_n, int levels_arg, int base_log) {
  const int k1 = K1T > 0 ? K1T : k1_arg;
  const int levels = LVT > 0 ? LVT : levels_arg;
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

}  // namespace

extern "C" int tfhe_torch_blind_rotate128_smem_bytes(int k1, int n_poly, int levels) {
  return k1 * n_poly * 16 + levels * k1 * padded_len(n_poly) * 4;
}

namespace {

template <int K1T, int LVT>
cudaError_t launch(u128* acc, const int* mask, const u32* bsk, const u32* psi,
                   const u32* psi_inv, const long long* consts, u32* scratch, int batch,
                   int n_steps, int k1, int log_n, int levels, int base_log, int smem,
                   cudaStream_t stream) {
  auto kernel = blind_rotate128_kernel<K1T, LVT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  kernel<<<batch, THREADS, smem, stream>>>(acc, mask, bsk, psi, psi_inv, consts, scratch,
                                           n_steps, k1, log_n, levels, base_log);
  return cudaGetLastError();
}

}  // namespace

// acc: (batch, k1, N) u128 (little-endian (lo, hi) u64 pairs), rotated in
// place; scratch: batch * 6 * k1 * N u32.
extern "C" int tfhe_torch_blind_rotate128(void* acc, const void* mask, const void* bsk,
                                          const void* psi, const void* psi_inv,
                                          const void* consts, void* scratch, int batch,
                                          int n_steps, int k1, int log_n, int levels,
                                          int nprimes, int base_log, void* stream) {
  if (nprimes != NP6 || k1 < 1 || k1 > MAXK1 || levels < 1 || levels > MAX_LEVELS ||
      base_log < 1 || base_log > 31 || base_log * levels >= 128 || log_n < 1 ||
      log_n > 16 || batch < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int smem = tfhe_torch_blind_rotate128_smem_bytes(k1, 1 << log_n, levels);
  auto run = (k1 == 3 && levels == 3) ? launch<3, 3> : launch<0, 0>;
  return (int)run((u128*)acc, (const int*)mask, (const u32*)bsk, (const u32*)psi,
                  (const u32*)psi_inv, (const long long*)consts, (u32*)scratch, batch,
                  n_steps, k1, log_n, levels, base_log, smem, (cudaStream_t)stream);
}
