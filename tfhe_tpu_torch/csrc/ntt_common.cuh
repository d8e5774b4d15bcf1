// The pieces shared by K1 (keyswitch.cu), K2 (blind_rotate.cu), K3
// (blind_rotate_multibit.cu), K4 (packing_keyswitch.cu) and K5
// (blind_rotate128.cu): the gadget decomposer (64-bit, and from the high
// word alone), the int8 tensor-core limb product of K1's and K4's
// tensor-core kernels (mma_s8u8, ldmatrix_x4, smem_u32) and the CRT-NTT.
//
// Two sets of NTT pieces.  The exact passes (forward_ntt, inverse_ntt,
// garner_u64): Montgomery arithmetic reduced after every add, sub and
// product, radix-2 stages in register passes of up to four over padded
// shared-memory rows, N^-1 applied in Garner; their prime comes from a
// constants object (prime_of, modulus, minv), so K5's generic kernel runs
// them one prime of its six at a time.  K2's generic exact kernel and the
// generic kernels of K3's exact mode and of K5 use them.
//
// The lazy core (from reduce_to on), for K2's v7 and K3's v9 kernels on a
// RoundedKeyNtt and for the lazy exact kernels of K2, K3 and K5 (one prime at
// a time there: lazy_pass with NPT = 1 on a Consts whose p[0] is that
// prime; redc_lazy for sums of up to four products, lazy_digit_residue for
// the first pass's inputs, exact_last_inverse for K2's and K3's N^-1 and
// Garner):
// what bounds those kernels on the H100 is
// 32-bit integer issue, so the core cuts instructions and passes.  Lazy
// (Harvey) butterflies with Shoup twiddle pairs keep residues in [0, 4p)
// (every prime is below 2^30, so that fits a u32) and spend three
// multiplies and four adds a butterfly, with no conditional subtraction
// but one; N^-1 lives in the key; the first forward pass takes the
// rotation, a 32-bit decomposition and the residues, the last forward
// pass the key product (rk_key_product), the last inverse pass Garner and
// the 2^32-grid rounding, so a step is six passes over shared memory
// instead of nine; the stage loops are unrolled one stage an
// instantiation so the values stay in registers; a pass whose warp would
// straddle two rows four or eight banks apart takes its tasks in an order
// that covers the banks once.  The transforms keep three register passes
// (4 + 4 + 3 stages), not two of 5 and 6: with 512 threads and one block
// an SM a thread holds at most 128 registers, which the kernels already
// use, so a pass of 32 or 64 values a task would spill.
//
// Twiddles and constants come from the port's ops/ntt.py plan (the packed
// table of _kernel_consts; the Shoup pairs of shoup_twiddles).  Residue
// rows are padded by one word in 32, so that the strided loads of the NTT
// passes do not collide in banks.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace ntt_common {

typedef unsigned long long u64;
typedef unsigned int u32;

constexpr int THREADS = 512;
constexpr int NP = 4;           // primes of the CRT-NTT (ops/ntt.py plans)
constexpr int PASS = 4;         // radix-2 stages per register pass

// layout of the packed table written by ops/ntt.py _kernel_consts
struct Consts {
  u32 p[NP];
  u32 pinv[NP];
  u32 ninv[NP];
  u32 inv[NP];
  u32 pm[NP][NP];
  u64 prods[NP];
  u64 pmod;
  u32 half[NP];

  // polynomial q of a residue block holds prime q % NP
  __device__ __forceinline__ int prime_of(int poly) const { return poly & (NP - 1); }
  __device__ __forceinline__ u32 modulus(int pi) const { return p[pi]; }
  __device__ __forceinline__ u32 minv(int pi) const { return pinv[pi]; }
};

// One thread fills c from the packed table; the caller synchronises.
__device__ __forceinline__ void load_consts(Consts& c, const long long* __restrict__ g) {
  for (int i = 0; i < NP; ++i) {
    c.p[i] = (u32)g[i];
    c.pinv[i] = (u32)g[4 + i];
    c.ninv[i] = (u32)g[8 + i];
    c.inv[i] = (u32)g[12 + i];
    for (int j = 0; j < NP; ++j) c.pm[i][j] = (u32)g[16 + 4 * i + j];
    c.prods[i] = (u64)g[32 + i];
    c.half[i] = (u32)g[40 + i];
  }
  c.pmod = (u64)g[36];
}

__device__ __forceinline__ u32 mont_mul(u32 a, u32 b, u32 p, u32 pinv) {
  const u64 t = (u64)a * b;
  const u32 m = (u32)t * pinv;
  const u32 u = (u32)((t + (u64)m * p) >> 32);
  return u >= p ? u - p : u;
}

__device__ __forceinline__ u32 add_mod(u32 a, u32 b, u32 p) {
  const u32 s = a + b;
  return s >= p ? s - p : s;
}

__device__ __forceinline__ u32 sub_mod(u32 a, u32 b, u32 p) {
  const u32 d = a + p - b;
  return d >= p ? d - p : d;
}

// Closest-representable rounding with balanced tie-breaking
// (ops/server.py init_decomposer_state).
__device__ __forceinline__ u64 decomposer_state(u64 x, int base_log, int levels) {
  const int rep = base_log * levels;      // < 64, checked by the launchers
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

// The decomposer state of a word whose rounding reads only its high word
// (base_log l <= 30: bits from 2^(63 - rep) up), in 32 bits: as
// decomposer_state, its value res - (nb << rep) kept signed.
__device__ __forceinline__ int hi_decomposer_state(u32 hi, int base_log, int levels) {
  const int rep = base_log * levels;
  u32 res = hi >> (31 - rep);
  const u32 rounding_bit = res & 1u;
  res = ((res + 1u) >> 1) & ((1u << rep) - 1u);
  const u32 nb = (((res - 1u) | (rounding_bit << (rep - 1))) & res) >> (rep - 1);
  return (int)(res - (nb << rep));
}

// next_digit on the 32-bit state.
__device__ __forceinline__ int hi_next_digit(int& state, int base_log) {
  const u32 r = (u32)state & ((1u << base_log) - 1u);
  state >>= base_log;
  const u32 carry = (((r - 1u) | (u32)state) & r) >> (base_log - 1);
  state += (int)carry;
  return (int)r - (int)(carry << base_log);
}

// The int8 tensor-core limb product (K1's and K4's tensor-core kernels):
// a u64 key word is 8 unsigned byte limbs, so sum_k d_k w_k = sum_j 2^(8j)
// sum_k d_k limb_j(w_k) (mod 2^64), an s8 x u8 -> s32 product.
__device__ __forceinline__ u32 smem_u32(const void* p) {
  return (u32)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldmatrix_x4(u32 (&r)[4], u32 addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_s8u8(int (&d)[4], const u32 (&a)[4], u32 b0, u32 b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.u8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Index of coefficient i in a padded shared-memory row (one word in 32).
__device__ __forceinline__ int pad(int i) { return i + (i >> 5); }

__host__ __device__ __forceinline__ int padded_len(int n) { return n + (n >> 5); }

// Decompose the u64 word v into its signed digits and write each digit's
// residue for every prime: out[lev * level_stride + pi * row] (d or p + d).
__device__ __forceinline__ void write_digit_residues(u32* out, u64 v, int base_log,
                                                     int levels, int level_stride,
                                                     int row, const Consts& c) {
  u64 state = decomposer_state(v, base_log, levels);
  for (int lev = 0; lev < levels; ++lev, out += level_stride) {
    const long long d = next_digit(state, base_log);
#pragma unroll
    for (int pi = 0; pi < NP; ++pi) {
      out[pi * row] = d < 0 ? (u32)((long long)c.p[pi] + d) : (u32)d;
    }
  }
}

// Forward (Cooley-Tukey, natural -> bit-reversed) stages k0 .. k0+S-1 of
// every polynomial: a thread owns the 2^S coefficients i = hi|b|lo that
// differ only in the S bits those stages pair (ops/ntt.py ntt_forward).
// Polynomial q of res holds prime c.prime_of(q).
template <int S, class C>
__device__ __forceinline__ void forward_pass(u32* res, int polys, int log_n, int row,
                                             int k0, const u32* __restrict__ psi,
                                             const C& c) {
  const int lo_bits = log_n - k0 - S;
  const int per_poly = 1 << (log_n - S);
  for (int q = threadIdx.x; q < polys * per_poly; q += THREADS) {
    const int poly = q >> (log_n - S);
    const int rest = q & (per_poly - 1);
    const int lo = rest & ((1 << lo_bits) - 1);
    const int hi = rest >> lo_bits;
    const int pi = c.prime_of(poly);
    const u32 p = c.modulus(pi);
    const u32 pinv = c.minv(pi);
    u32* x = res + poly * row;
    const int base = (hi << (S + lo_bits)) | lo;
    u32 v[1 << S];
#pragma unroll
    for (int b = 0; b < (1 << S); ++b) v[b] = x[pad(base | (b << lo_bits))];
#pragma unroll
    for (int d = 0; d < S; ++d) {
      const int half = 1 << (S - 1 - d);
#pragma unroll
      for (int g = 0; g < (1 << d); ++g) {
        // stage k0+d, block ii = (hi << d) | g: twiddle psi[2^(k0+d) + ii]
        const u32 s = __ldg(psi + (pi << log_n) + (1 << (k0 + d)) + (hi << d) + g);
#pragma unroll
        for (int e = 0; e < half; ++e) {
          const int i0 = (g << (S - d)) + e;
          const u32 U = v[i0];
          const u32 V = mont_mul(v[i0 + half], s, p, pinv);
          v[i0] = add_mod(U, V, p);
          v[i0 + half] = sub_mod(U, V, p);
        }
      }
    }
#pragma unroll
    for (int b = 0; b < (1 << S); ++b) x[pad(base | (b << lo_bits))] = v[b];
  }
}

// Inverse (Gentleman-Sande, bit-reversed -> natural) stages k0 .. k0+S-1,
// t = 2^k doubling (ops/ntt.py ntt_inverse without the N^-1 factor).
template <int S, class C>
__device__ __forceinline__ void inverse_pass(u32* res, int polys, int log_n, int row,
                                             int k0, const u32* __restrict__ psi_inv,
                                             const C& c) {
  const int lo_bits = k0;
  const int per_poly = 1 << (log_n - S);
  for (int q = threadIdx.x; q < polys * per_poly; q += THREADS) {
    const int poly = q >> (log_n - S);
    const int rest = q & (per_poly - 1);
    const int lo = rest & ((1 << lo_bits) - 1);
    const int hi = rest >> lo_bits;
    const int pi = c.prime_of(poly);
    const u32 p = c.modulus(pi);
    const u32 pinv = c.minv(pi);
    u32* x = res + poly * row;
    const int base = (hi << (S + lo_bits)) | lo;
    u32 v[1 << S];
#pragma unroll
    for (int b = 0; b < (1 << S); ++b) v[b] = x[pad(base | (b << lo_bits))];
#pragma unroll
    for (int d = 0; d < S; ++d) {
      const int dist = 1 << d;
#pragma unroll
      for (int g = 0; g < (1 << (S - 1 - d)); ++g) {
        // stage k0+d, block ii = (hi << (S-1-d)) | g: psi_inv[N/2^(k0+d+1) + ii]
        const u32 s = __ldg(psi_inv + (pi << log_n) + (1 << (log_n - k0 - d - 1)) +
                            (hi << (S - 1 - d)) + g);
#pragma unroll
        for (int e = 0; e < dist; ++e) {
          const int i0 = (g << (d + 1)) + e;
          const u32 U = v[i0];
          const u32 V = v[i0 + dist];
          v[i0] = add_mod(U, V, p);
          v[i0 + dist] = mont_mul(sub_mod(U, V, p), s, p, pinv);
        }
      }
    }
#pragma unroll
    for (int b = 0; b < (1 << S); ++b) x[pad(base | (b << lo_bits))] = v[b];
  }
}

// All log_n stages in passes of PASS, the remainder last; a barrier after
// each pass.
template <class C>
__device__ __forceinline__ void forward_ntt(u32* res, int polys, int log_n, int row,
                                            const u32* __restrict__ psi, const C& c) {
  int k0 = 0;
  for (; k0 + PASS <= log_n; k0 += PASS) {
    forward_pass<PASS>(res, polys, log_n, row, k0, psi, c);
    __syncthreads();
  }
  if (k0 == log_n) return;
  switch (log_n - k0) {
    case 1: forward_pass<1>(res, polys, log_n, row, k0, psi, c); break;
    case 2: forward_pass<2>(res, polys, log_n, row, k0, psi, c); break;
    default: forward_pass<3>(res, polys, log_n, row, k0, psi, c); break;
  }
  __syncthreads();
}

template <class C>
__device__ __forceinline__ void inverse_ntt(u32* res, int polys, int log_n, int row,
                                            const u32* __restrict__ psi_inv, const C& c) {
  int k0 = 0;
  for (; k0 + PASS <= log_n; k0 += PASS) {
    inverse_pass<PASS>(res, polys, log_n, row, k0, psi_inv, c);
    __syncthreads();
  }
  if (k0 == log_n) return;
  switch (log_n - k0) {
    case 1: inverse_pass<1>(res, polys, log_n, row, k0, psi_inv, c); break;
    case 2: inverse_pass<2>(res, polys, log_n, row, k0, psi_inv, c); break;
    default: inverse_pass<3>(res, polys, log_n, row, k0, psi_inv, c); break;
  }
  __syncthreads();
}

// The u64 word of one coefficient from its NP inverse-transformed residues
// col[pi * row]: scale by N^-1, Garner's mixed radix, the signed value
// |X| < P/2 taken mod 2^64 (ops/ntt.py garner_to_u64).
__device__ __forceinline__ u64 garner_u64(const u32* col, int row, const Consts& c) {
  u32 dg[NP];
#pragma unroll
  for (int pi = 0; pi < NP; ++pi) {
    dg[pi] = mont_mul(col[pi * row], c.ninv[pi], c.p[pi], c.pinv[pi]);
  }
#pragma unroll
  for (int jp = 1; jp < NP; ++jp) {
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
  u64 x = dg[0];
  bool neg = dg[0] > c.half[0];
#pragma unroll
  for (int i = 1; i < NP; ++i) {
    x += (u64)dg[i] * c.prods[i];
    neg = (dg[i] > c.half[i]) || (dg[i] == c.half[i] && neg);
  }
  return neg ? x - c.pmod : x;
}

// ---------------------------------------------------------------------------
// The rounded-key core of K2's and K3's 2^32-grid rotations (v7, v9).
//
// Arithmetic: lazy (Harvey) butterflies with Shoup twiddles.  Every prime
// is below 2^30, so a residue is kept anywhere in [0, 4p) and never
// overflows a u32; it is brought to [0, p) once, before Garner.  A
// twiddle is a pair (W, floor(W 2^32 / p)), W in normal form
// (ops/ntt.py shoup_twiddles), and W.y mod p costs one high and two low
// 32-bit multiplies, with no conditional subtraction.  The key's
// pointwise product stays Montgomery (the key is stored times R and times
// N^-1, so the inverse transform has no scaling pass).
//
// Layout: a block takes C ciphertexts of a (K1, N) accumulator, N = 2^LOG_N.
// The accumulator lives on the 2^32 grid, so only its high words are kept,
// (C, K1, N) u32 in shared memory.  The residue rows of ciphertext ct are
// (ct, r, prime) for the K1 digit polynomials of one level, each padded
// (ntt_common::pad); the key's product is written back over the same rows,
// as (ct, cc, prime).  Forward transforms run in three register passes
// (4 + 4 + 3 stages), the first of them fused with the rotation, the
// decomposition and the residues; inverse transforms in three, the last
// fused with Garner, the shift by the key's rounding and the 2^32-grid
// rounding into the accumulator.
// ---------------------------------------------------------------------------

__device__ __forceinline__ u32 reduce_to(u32 x, u32 m) {   // [0, 2m) -> [0, m)
  return min(x, x - m);
}

// W y mod p in [0, 2p) for any y < 2^32; w = (W, floor(W 2^32 / p)).
__device__ __forceinline__ u32 shoup_mul(u32 y, uint2 w, u32 p) {
  return w.x * y - __umulhi(w.y, y) * p;
}

// a b R^-1 mod p in [0, 2p) for a < 2^32, b < p.
__device__ __forceinline__ u32 mont_lazy(u32 a, u32 b, u32 p, u32 pinv) {
  const u64 t = (u64)a * b;
  const u32 m = (u32)t * pinv;
  return (u32)((t + (u64)m * p) >> 32);
}

// t R^-1 mod p in [0, 2p) for a 64-bit sum t < p 2^32: up to four products
// of canonical residues (4 p^2 < p 2^32 for p < 2^30), one reduction.
__device__ __forceinline__ u32 redc_lazy(u64 t, u32 p, u32 pinv) {
  const u32 m = (u32)t * pinv;
  return (u32)((t + (u64)m * p) >> 32);
}

// The residue in [0, 4p) of a signed digit |d| <= 2^30 (p > 2^29): d + 2p,
// a valid input of the lazy forward stages.
__device__ __forceinline__ u32 lazy_digit_residue(int d, u32 p) {
  return (u32)d + 2 * p;
}

// Forward butterflies of stages k0 .. k0+S-1 on the 2^S values a thread
// holds (coefficient base | b << lo_bits), twiddle block offset hi.  One
// stage D an instantiation, so that every loop bound is a constant and the
// values stay in registers.
template <int S, int LOG_N, int D = 0>
__device__ __forceinline__ void lazy_forward_stages(u32 (&v)[1 << S], int k0, int hi,
                                                    const uint2* __restrict__ tw, u32 p) {
  if constexpr (D < S) {
    constexpr int half = 1 << (S - 1 - D);
    const u32 two_p = 2 * p;
#pragma unroll
    for (int g = 0; g < (1 << D); ++g) {
      const uint2 w = __ldg(tw + (1 << (k0 + D)) + (hi << D) + g);
#pragma unroll
      for (int e = 0; e < half; ++e) {
        const int i0 = (g << (S - D)) + e;
        const u32 x = reduce_to(v[i0], two_p);
        const u32 t = shoup_mul(v[i0 + half], w, p);
        v[i0] = x + t;
        v[i0 + half] = x - t + two_p;
      }
    }
    lazy_forward_stages<S, LOG_N, D + 1>(v, k0, hi, tw, p);
  }
}

// Inverse (Gentleman-Sande) butterflies of stages k0 .. k0+S-1, inputs and
// outputs in [0, 2p).
template <int S, int LOG_N, int D = 0>
__device__ __forceinline__ void lazy_inverse_stages(u32 (&v)[1 << S], int k0, int hi,
                                                    const uint2* __restrict__ tw, u32 p) {
  if constexpr (D < S) {
    constexpr int dist = 1 << D;
    const u32 two_p = 2 * p;
#pragma unroll
    for (int g = 0; g < (1 << (S - 1 - D)); ++g) {
      const uint2 w = __ldg(tw + (1 << (LOG_N - k0 - D - 1)) + (hi << (S - 1 - D)) + g);
#pragma unroll
      for (int e = 0; e < dist; ++e) {
        const int i0 = (g << (D + 1)) + e;
        const u32 x = v[i0];
        const u32 y = v[i0 + dist];
        v[i0] = reduce_to(x + y, two_p);
        v[i0 + dist] = shoup_mul(x - y + two_p, w, p);
      }
    }
    lazy_inverse_stages<S, LOG_N, D + 1>(v, k0, hi, tw, p);
  }
}

// One forward (or inverse) register pass over every row of a block's
// residues: rows = C K1 NPT polynomials, row q holding prime q % NPT.
template <int S, int LOG_N, int NPT, int NT, bool FORWARD>
__device__ __forceinline__ void lazy_pass(u32* res, int rows, int k0,
                                          const uint2* __restrict__ tw, const Consts& c) {
  constexpr int ROW = (1 << LOG_N) + (1 << LOG_N) / 32;
  const int lo_bits = FORWARD ? LOG_N - k0 - S : k0;
  const int per_poly = 1 << (LOG_N - S);
  for (int q = threadIdx.x; q < rows * per_poly; q += NT) {
    const int poly = q >> (LOG_N - S);
    const int rest = q & (per_poly - 1);
    const int lo = rest & ((1 << lo_bits) - 1);
    int hi = rest >> lo_bits;
    if ((lo_bits == 3 || lo_bits == 4) && LOG_N - S - lo_bits > 5 - lo_bits) {
      // a warp would span hi and hi + 1, whose rows sit 4 (8) banks apart
      // and collide; swapping hi's bit 0 with bit 5 - lo_bits makes a warp
      // span hi + 2 (+ 4) instead, which covers the 32 banks once
      const int sb = 5 - lo_bits;
      const int flip = (hi ^ (hi >> sb)) & 1;
      hi ^= flip | (flip << sb);
    }
    const int pi = poly % NPT;
    const u32 p = c.p[pi];
    // base and b << lo_bits share no bit, so the padded index splits into
    // pad(base) plus a constant a b: no address arithmetic an element
    u32* x = res + poly * ROW + pad((hi << (S + lo_bits)) | lo);
    u32 v[1 << S];
#pragma unroll
    for (int b = 0; b < (1 << S); ++b) v[b] = x[pad(b << lo_bits)];
    if (FORWARD) {
      lazy_forward_stages<S, LOG_N>(v, k0, hi, tw + (pi << LOG_N), p);
    } else {
      lazy_inverse_stages<S, LOG_N>(v, k0, hi, tw + (pi << LOG_N), p);
    }
#pragma unroll
    for (int b = 0; b < (1 << S); ++b) x[pad(b << lo_bits)] = v[b];
  }
}

// The one-level signed digit of the word v << 32 (its low half zero), as
// decomposer_state and next_digit give it, in 32-bit arithmetic: for
// base_log <= 30 every intermediate fits, and the state after the digit,
// which one level drops, is all ones exactly when the rounding wrapped.
__device__ __forceinline__ int hi_word_digit(u32 v, int base_log) {
  u32 res = v >> (31 - base_log);
  const u32 rounding_bit = res & 1u;
  res = ((res + 1u) >> 1) & ((1u << base_log) - 1u);
  const u32 nb = (((res - 1u) | (rounding_bit << (base_log - 1))) & res) >> (base_log - 1);
  const u32 rest = 0u - nb;                 // the state shifted right by base_log
  const u32 carry = (((res - 1u) | rest) & res) >> (base_log - 1);
  return (int)res - (int)(carry << base_log);
}

// The first forward pass (stages 0-3) fused with what feeds it.  Task
// (ct, r, lo) owns coefficients j = b 2^(LOG_N-4) | lo, b < 16, of row r:
// it reads the rotated accumulator, X^a acc (minus acc where SUB: K2's
// CMux input), shift a = shifts[ct * shift_stride] in [0, 2N), takes the
// one-level signed digit of each word (high word << 32) in registers, and
// for each prime forms the digit's residues and runs the four stages
// before storing them once.
template <int LOG_N, int K1, int NPT, int C, int NT, bool SUB>
__device__ __forceinline__ void fused_first_forward(u32* res, const u32* acc,
                                                    const int* __restrict__ shifts,
                                                    int shift_stride, int base_log,
                                                    const uint2* __restrict__ tw,
                                                    const Consts& c) {
  constexpr int N = 1 << LOG_N;
  constexpr int ROW = N + N / 32;
  constexpr int S = 4;
  constexpr int LO = LOG_N - S;
  for (int q = threadIdx.x; q < C * K1 * (1 << LO); q += NT) {
    const int ct = q / (K1 << LO);
    const int r = (q >> LO) % K1;
    const int lo = q & ((1 << LO) - 1);
    const int a = __ldg(shifts + ct * shift_stride);
    const int rot = a & (N - 1);
    const bool odd = (a >> LOG_N) & 1;
    const u32* A = acc + (ct * K1 + r) * N;
    u32* rows = res + (ct * K1 + r) * NPT * ROW + pad(lo);   // pad splits, as in lazy_pass
    int dig[1 << S];
#pragma unroll
    for (int b = 0; b < (1 << S); ++b) {
      const int j = (b << LO) | lo;
      u32 v = j < rot ? 0u - A[j - rot + N] : A[j - rot];
      if (odd) v = 0u - v;
      if (SUB) v -= A[j];
      dig[b] = hi_word_digit(v, base_log);
    }
#pragma unroll
    for (int pi = 0; pi < NPT; ++pi) {
      const u32 p = c.p[pi];
      u32 v[1 << S];
#pragma unroll
      for (int b = 0; b < (1 << S); ++b) v[b] = dig[b] < 0 ? (u32)(dig[b] + (int)p) : (u32)dig[b];
      lazy_forward_stages<S, LOG_N>(v, 0, 0, tw + (pi << LOG_N), p);
#pragma unroll
      for (int b = 0; b < (1 << S); ++b) rows[pi * ROW + pad(b << LO)] = v[b];
    }
  }
}

// The last forward pass (stages LOG_N-3 .. LOG_N-1) of the two digit rows
// of one ciphertext and prime at coefficients hi 8 + b, b < 8, into
// registers: row0 is the ciphertext's row (r = 0, prime), row1 its row
// (r = 1, prime).  The key product then runs in the same task, with no
// pass over shared memory of its own.
template <int LOG_N>
__device__ __forceinline__ void last_forward_pair(const u32* row0, const u32* row1, int hi,
                                                  const uint2* __restrict__ tw, u32 p,
                                                  u32 (&v0)[8], u32 (&v1)[8]) {
  const int at = pad(hi << 3);              // pad(hi 8 + b) = at + b
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    v0[b] = row0[at + b];
    v1[b] = row1[at + b];
  }
  lazy_forward_stages<3, LOG_N>(v0, LOG_N - 3, hi, tw, p);
  lazy_forward_stages<3, LOG_N>(v1, LOG_N - 3, hi, tw, p);
}

// The signed integer |X| < P/2 with canonical residues r[0 .. NPT-1] (no
// N^-1 factor), mod 2^64 (ops/ntt.py garner_to_u64).
template <int NPT>
__device__ __forceinline__ u64 garner_signed(u32 (&dg)[NPT], const Consts& c) {
#pragma unroll
  for (int jp = 1; jp < NPT; ++jp) {
    const u32 pj = c.p[jp];
    const u32 pinvj = c.pinv[jp];
    u32 v = dg[0] >= pj ? dg[0] - pj : dg[0];
#pragma unroll
    for (int i = 1; i < NPT; ++i) {   // a constant bound, so dg stays in registers
      if (i < jp) {
        v += mont_mul(dg[i], c.pm[i - 1][jp], pj, pinvj);
        v = v >= pj ? v - pj : v;
      }
    }
    const u32 rr = dg[jp];
    const u32 d = rr >= v ? rr - v : rr + pj - v;
    dg[jp] = mont_mul(d, c.inv[jp], pj, pinvj);
  }
  u64 x = dg[0];
  bool neg = dg[0] > c.half[0];
#pragma unroll
  for (int i = 1; i < NPT; ++i) {
    x += (u64)dg[i] * c.prods[i];
    neg = (dg[i] > c.half[i]) || (dg[i] == c.half[i] && neg);
  }
  return neg ? x - c.pmod : x;
}

// The last inverse pass (stages LOG_N-3 .. LOG_N-1) fused with Garner.
// Task (ct, cc, lo) owns coefficients j = lo | b 2^(LOG_N-3), b < 8, of
// output row cc, for every prime: it finishes their transforms in
// registers, reconstructs each word, shifts it left by rb (the key held
// the quotients b / 2^rb), rounds it to the 2^32 grid and adds its high
// word to the accumulator (ADD: K2) or replaces it (K3's group sum).
template <int LOG_N, int K1, int NPT, int C, int NT, bool ADD>
__device__ __forceinline__ void fused_last_inverse(const u32* res, u32* acc, int rb,
                                                   const uint2* __restrict__ tw,
                                                   const Consts& c) {
  constexpr int N = 1 << LOG_N;
  constexpr int ROW = N + N / 32;
  constexpr int S = 3;
  constexpr int K0 = LOG_N - S;
  for (int q = threadIdx.x; q < C * K1 * (1 << K0); q += NT) {
    const int ct = q / (K1 << K0);
    const int cc = (q >> K0) % K1;
    const int lo = q & ((1 << K0) - 1);
    const u32* rows = res + (ct * K1 + cc) * NPT * ROW + pad(lo);
    u32 y[NPT][1 << S];
#pragma unroll
    for (int pi = 0; pi < NPT; ++pi) {
      const u32 p = c.p[pi];
#pragma unroll
      for (int b = 0; b < (1 << S); ++b) y[pi][b] = rows[pi * ROW + pad(b << K0)];
      lazy_inverse_stages<S, LOG_N>(y[pi], K0, 0, tw + (pi << LOG_N), p);
#pragma unroll
      for (int b = 0; b < (1 << S); ++b) y[pi][b] = reduce_to(y[pi][b], p);
    }
    u32* A = acc + (ct * K1 + cc) * N;
#pragma unroll
    for (int b = 0; b < (1 << S); ++b) {
      u32 dg[NPT];
#pragma unroll
      for (int pi = 0; pi < NPT; ++pi) dg[pi] = y[pi][b];
      const u64 x = garner_signed<NPT>(dg, c) << rb;
      const u32 h = (u32)((x + (1ull << 31)) >> 32);
      const int j = lo | (b << K0);
      A[j] = ADD ? A[j] + h : h;
    }
  }
}

// The last inverse pass (stages LOG_N-3 .. LOG_N-1) of an exact product
// (a key without N^-1) fused with N^-1 and Garner: task (ct, cc, lo) owns
// coefficients j = lo | b 2^(LOG_N-3), b < 8, of output row cc of
// ciphertext ct, finishes their transforms for every prime in registers
// and adds each reconstructed u64 word to the accumulator (C, K1, N) (ADD:
// K2's lazy exact kernel), or to the same word of `from` into acc (ADD
// with from: K8's lazy kernel's two copies), or writes it over it (K3's
// lazy exact kernel).
template <int LOG_N, int K1, int NPT, int C, int NT, bool ADD = false>
__device__ __forceinline__ void exact_last_inverse(const u32* res, u64* acc,
                                                   const uint2* __restrict__ tw,
                                                   const Consts& c,
                                                   const u64* from = nullptr) {
  constexpr int N = 1 << LOG_N;
  constexpr int ROW = N + N / 32;
  constexpr int S = 3;
  constexpr int K0 = LOG_N - S;
  for (int q = threadIdx.x; q < C * K1 * (1 << K0); q += NT) {
    const int ct = q / (K1 << K0);
    const int cc = (q >> K0) % K1;
    const int lo = q & ((1 << K0) - 1);
    const u32* rows = res + (ct * K1 + cc) * NPT * ROW + pad(lo);
    u32 y[NPT][1 << S];
#pragma unroll
    for (int pi = 0; pi < NPT; ++pi) {
      const u32 p = c.p[pi];
#pragma unroll
      for (int b = 0; b < (1 << S); ++b) y[pi][b] = rows[pi * ROW + pad(b << K0)];
      lazy_inverse_stages<S, LOG_N>(y[pi], K0, 0, tw + (pi << LOG_N), p);
#pragma unroll
      for (int b = 0; b < (1 << S); ++b) {
        y[pi][b] = mont_mul(reduce_to(y[pi][b], p), c.ninv[pi], p, c.pinv[pi]);
      }
    }
    u64* A = acc + (ct * K1 + cc) * N;
    const u64* F = (from ? from : acc) + (ct * K1 + cc) * N;
#pragma unroll
    for (int b = 0; b < (1 << S); ++b) {
      u32 dg[NPT];
#pragma unroll
      for (int pi = 0; pi < NPT; ++pi) dg[pi] = y[pi][b];
      const u64 x = garner_signed<NPT>(dg, c);
      A[lo | (b << K0)] = ADD ? F[lo | (b << K0)] + x : x;
    }
  }
}

// The last forward pass fused with the key product of the lazy exact kernels
// at k + 1 = 2, one level (K2's csrc/blind_rotate.cu and K8's
// csrc/blind_rotate_extended.cu), C ciphertexts a block: task q = (prime
// pi, hi, ct), ct fastest, runs the last forward pass (stages LOG_N-3 ..
// LOG_N-1) of ciphertext ct's two digit rows at positions hi 8 + b, b < 8,
// in registers, then out[cc] = sum_r x_r k[r][cc] with x_r reduced to [0,
// 2p) and the two products summed in 64 bits before one reduction (2 (2p)
// p < p 2^32).  Each key entry (r, cc) of the eight positions is two
// 16-byte loads, all eight issued before the transform; the C lanes of a
// position load the same words in one transaction.  out is written over
// the two rows, as (ct, cc, prime), in [0, 2p).  Rows are (ct, r, prime),
// padded; key the step's GGSW (1, 2, 2, NP, N) as 16-byte words.
__device__ __forceinline__ u32 lane_of(const uint4& k, int i) {
  return i == 0 ? k.x : i == 1 ? k.y : i == 2 ? k.z : k.w;
}

template <int C, int LOG_N>
__device__ __forceinline__ void exact_key_product(u32* res, int q,
                                                  const uint4* __restrict__ key,
                                                  const uint2* __restrict__ tw,
                                                  const Consts& c) {
  constexpr int N = 1 << LOG_N;
  constexpr int ROW = N + N / 32;
  constexpr int GROUPS = N / 8;
  constexpr int K1 = 2;
  const int ct = q % C;
  const int hi = (q / C) % GROUPS;
  const int pi = q / (C * GROUPS);
  const u32 p = c.p[pi];
  const u32 pinv = c.pinv[pi];
  uint4 k[K1 * K1][2];                          // entry r K1 + cc, positions 0-3 and 4-7
#pragma unroll
  for (int en = 0; en < K1 * K1; ++en) {
    const uint4* kp = key + (en * NP + pi) * (N / 4) + 2 * hi;
    k[en][0] = __ldg(kp);
    k[en][1] = __ldg(kp + 1);
  }
  u32* row0 = res + (ct * K1 * NP + pi) * ROW;
  u32* row1 = row0 + NP * ROW;
  u32 v0[8], v1[8];
  last_forward_pair<LOG_N>(row0, row1, hi, tw + (pi << LOG_N), p, v0, v1);
  const int at = pad(hi << 3);
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    const u32 x0 = reduce_to(v0[b], 2 * p);
    const u32 x1 = reduce_to(v1[b], 2 * p);
    row0[at + b] = redc_lazy((u64)x0 * lane_of(k[0][b >> 2], b & 3) +
                             (u64)x1 * lane_of(k[2][b >> 2], b & 3), p, pinv);
    row1[at + b] = redc_lazy((u64)x0 * lane_of(k[1][b >> 2], b & 3) +
                             (u64)x1 * lane_of(k[3][b >> 2], b & 3), p, pinv);
  }
}

// ---------------------------------------------------------------------------
// The rounded-key kernels' shape and key product (K2's v7 and K3's v9
// kernels): k + 1 = 2, one level, N = 2048, RK_C ciphertexts a block of
// RK_THREADS threads.  RK_C = 2: the residue rows of a ciphertext take
// 50,688 B on three primes, so two ciphertexts and their accumulators'
// high words (134,144 B) leave room for no third on an SM.
// ---------------------------------------------------------------------------

constexpr int RK_LOG_N = 11;
constexpr int RK_N = 1 << RK_LOG_N;
constexpr int RK_K1 = 2;
constexpr int RK_C = 2;           // ciphertexts a block
constexpr int RK_THREADS = 512;
constexpr int RK_ROW = RK_N + RK_N / 32;

// Dynamic shared memory of one block: the residue rows (C, K1, NPT) and
// the accumulators' high words (C, K1, N).
template <int NPT>
constexpr int rk_smem_bytes() {
  return (RK_C * RK_K1 * NPT * RK_ROW + RK_C * RK_K1 * RK_N) * 4;
}

// The tasks (prime, hi, ct) of the last forward pass a thread takes.
template <int NPT>
__host__ __device__ constexpr int rk_tasks_per_thread() {
  return RK_C * NPT * (RK_N / 8) / RK_THREADS;
}

// Task q = (prime pi, hi, ct), ct fastest, of the last forward pass fused
// with the key product: it transforms ciphertext ct's two digit rows at
// positions hi 8 + b and forms out[b][cc] = sum_r x_r . k[r][cc] in
// [0, 2p), k read as one 16-byte load a position.  The C lanes of the C
// ciphertexts load the same key words in one transaction, so each key word
// read from L2 feeds all C.  accumulate: out is added to what sum holds
// (K3's NTT-domain pattern sum, kept in registers); the result is left in
// sum and, where write, stored over the two rows (as (ct, cc, prime)) for
// the inverse transforms.
template <int NPT>
__device__ __forceinline__ void rk_key_product(u32* res, int q, const uint4* __restrict__ key,
                                               const uint2* __restrict__ tw,
                                               u32 (&sum)[8][RK_K1], bool accumulate,
                                               bool write, const Consts& c) {
  constexpr int GROUPS = RK_N / 8;
  constexpr int CT_WORDS = RK_K1 * NPT * RK_ROW;
  const int ct = q % RK_C;
  const int pi = q / (RK_C * GROUPS);
  const int hi = (q / RK_C) % GROUPS;
  const u32 p = c.p[pi];
  const u32 pinv = c.pinv[pi];
  const u32 two_p = 2 * p;
  u32* row0 = res + ct * CT_WORDS + pi * RK_ROW;
  u32* row1 = row0 + NPT * RK_ROW;
  u32 v0[8], v1[8];
  last_forward_pair<RK_LOG_N>(row0, row1, hi, tw + (pi << RK_LOG_N), p, v0, v1);
  const uint4* kp = key + (pi << RK_LOG_N) + (hi << 3);
  const int at = pad(hi << 3);
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    const uint4 k = __ldg(kp + b);
    u32 o0 = reduce_to(mont_lazy(v0[b], k.x, p, pinv) + mont_lazy(v1[b], k.z, p, pinv), two_p);
    u32 o1 = reduce_to(mont_lazy(v0[b], k.y, p, pinv) + mont_lazy(v1[b], k.w, p, pinv), two_p);
    if (accumulate) {
      o0 = reduce_to(o0 + sum[b][0], two_p);
      o1 = reduce_to(o1 + sum[b][1], two_p);
    }
    sum[b][0] = o0;
    sum[b][1] = o1;
    if (write) {
      row0[at + b] = o0;
      row1[at + b] = o1;
    }
  }
}

// The largest dynamic shared memory of kernel set to bytes (and, where
// carveout, the SM's carveout to shared memory first) once a device, done
// holding one bit a device: cudaFuncSetAttribute costs the host several
// microseconds a call, which a launch of a few microseconds would pay.
template <class K>
cudaError_t set_smem_once(K kernel, int bytes, bool carveout, std::atomic<unsigned>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = dev < 32 ? 1u << dev : 0u;
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && carveout) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  }
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

// Launch kernel on blocks blocks of THREADS threads with smem bytes of
// dynamic shared memory, the SM's carveout set to shared memory first.
template <class K, class... A>
cudaError_t launch_blocks(K kernel, int blocks, int smem, cudaStream_t stream, A... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, THREADS, smem, stream>>>(args...);
  return cudaGetLastError();
}

// Launch a rounded-key kernel over batch / RK_C blocks (the caller checks
// that RK_C divides batch) with smem bytes of dynamic shared memory.
template <class... P, class... A>
cudaError_t rk_launch(void (*kernel)(P...), int smem, int batch, cudaStream_t stream,
                      A... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<batch / RK_C, RK_THREADS, smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace ntt_common
