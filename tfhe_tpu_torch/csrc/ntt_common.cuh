// The exact 4-prime CRT-NTT pieces shared by K2 (blind_rotate.cu) and K3
// (blind_rotate_multibit.cu): Montgomery arithmetic, the signed gadget
// decomposition, shared-memory NTTs in register passes, and Garner
// reconstruction to u64.  Twiddles and constants come from the port's
// ops/ntt.py plan (the packed table of _kernel_consts).  The NTT passes
// take the prime of each polynomial from their constants object
// (prime_of, modulus, minv), so K5 (blind_rotate128.cu) runs them one
// prime of its six at a time.
//
// Both kernels run THREADS threads a block and keep their residues in
// shared-memory rows padded by one word in 32, so that the strided loads of
// the NTT passes do not collide in banks.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

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

// Round a u64 word to the nearest multiple of 2^32 (the v7/v9 grid).
__device__ __forceinline__ u64 round_hi32(u64 x) {
  return (x + (1ull << 31)) & 0xFFFFFFFF00000000ull;
}

}  // namespace ntt_common
