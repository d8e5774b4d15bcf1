// K9: the slot-local stages of the four-step split of one negacyclic
// product over D slots (parallel/poly_shard.py; plain versions in
// ops/four_step.py).  It replaces no pallas_call: tfhe_tpu computes these
// stages as XLA mod-p matmuls (tfhe_tpu/parallel/poly_shard.py _mat_mod
// :107, _fwd_local :118, _inv_local :137), and torch has no int64 matmul
// on CUDA, so the card gets three entries a CMux step on each slot:
//
//   (a) tfhe_torch_poly_shard_forward: a slot's C = N / D coefficients
//       (a + D c) of M polynomials -> their signed gadget digits (or the
//       u64 words' residues), the negacyclic twist psi^(a + D c), the
//       cyclic size-C transform (root om^D), the twiddle om^(a k2):
//       (L, M, NP, C) u32 residues.  One block a (row, prime); the transform
//       is radix-2 butterflies over shared memory (bit-reversed load,
//       natural order out).
//   (b) tfhe_torch_poly_shard_cross: after the exchange, slot b's
//       (D, L, M, NP, C/D) blocks -> the size-D transform (root om^C), the
//       product with the slot's key slice summed over the levels and the
//       k+1 input rows, and the size-D inverse: (D, B, k+1, NP, C/D), the
//       block of slot a at a.  Without a key it returns the evaluation
//       slice in Montgomery form (a key's, prepare_bsk_poly_sharded).  One
//       block a (ciphertext, prime); the size-D sums are dense (D <= 8).
//   (c) tfhe_torch_poly_shard_inverse: after the exchange back, slot a's
//       (D, M, NP, C/D) -> the inverse twiddle, the inverse cyclic size-C
//       transform, the inverse twist times C^-1, Garner to u64: (M, C).
//       One block a row, the NP primes in turn, then Garner.
//
// Residues and key slices are u32 (the primes are below 2^30), as the
// port's other NTT-domain keys are; words and tables are 8 bytes.  All
// arithmetic is exact mod p (Montgomery products of values below p,
// every sum reduced), so the words equal the plain versions' whatever the
// order.  What bounds it: at the main path's shapes (N = 2048, D <= 4, B
// <= 4) a step's grids are a few dozen blocks, so the launches and the
// host's exchanges between them, not the card's arithmetic, set the time;
// the design keeps each entry one launch for all NP primes and every
// row, and runs the size-C transforms as butterflies (C log C products a
// row instead of C^2) so that preparing a 918-GGSW key takes milliseconds.

#include "ntt_common.cuh"

using namespace ntt_common;

namespace {

constexpr int K9_THREADS = 256;
constexpr int K9_MAX_K1 = 8;
constexpr int K9_MAX_LEVELS = 8;
constexpr int K9_MAX_LOG_C = 13;
constexpr int K9_SMEM = 232448;
// ps_inverse_kernel's static Consts comes out of the same per-block limit
constexpr int K9_INVERSE_SMEM = K9_SMEM - 1024;

__device__ __forceinline__ int bit_reverse(int i, int log_c) {
  return log_c == 0 ? 0 : (int)(__brev((unsigned)i) >> (32 - log_c));
}

// In place, the cyclic transform v[k] <- sum_c v[c] w^(c k) of size
// C = 2^log_c over a row of shared memory loaded in bit-reversed order:
// Cooley-Tukey stages, the stage of half-length h taking w^(j C / 2h) =
// pw[j C / 2h] (pw[j] = w^j R, Montgomery form).  Every thread of the block
// calls it; it synchronises after each stage.
__device__ __forceinline__ void cyclic_ntt(u32* v, const u32* pw, int log_c, u32 p, u32 pinv) {
  const int c_len = 1 << log_c;
  for (int s = 1; s <= log_c; ++s) {
    const int half = 1 << (s - 1);
    const int stride = c_len >> s;
    for (int t = threadIdx.x; t < c_len / 2; t += blockDim.x) {
      const int j = t & (half - 1);
      const int base = ((t >> (s - 1)) << s) + j;
      const u32 u = v[base];
      const u32 x = mont_mul(v[base + half], pw[j * stride], p, pinv);
      v[base] = add_mod(u, x, p);
      v[base + half] = sub_mod(u, x, p);
    }
    __syncthreads();
  }
}

// Entry (a).  x (rows, C) u64 words; tw, twd, pw (NP, C) Montgomery
// (this slot's twist and twiddle, om^(D j)); out (L, rows, NP, C) u32.
__global__ void __launch_bounds__(K9_THREADS)
ps_forward_kernel(const long long* __restrict__ x, u32* __restrict__ out,
                  const long long* __restrict__ consts, const long long* __restrict__ tw,
                  const long long* __restrict__ twd, const long long* __restrict__ pw,
                  int rows, int log_c, int levels, int base_log) {
  extern __shared__ u32 sm[];
  const int c_len = 1 << log_c;
  const int nl = levels > 0 ? levels : 1;
  const int row = blockIdx.x / NP;
  const int pi = blockIdx.x % NP;
  const u32 p = (u32)consts[pi];
  const u32 pinv = (u32)consts[4 + pi];
  u32* w = sm;                     // C powers
  u32* z = sm + c_len;             // nl rows of C
  const long long* xr = x + (long long)row * c_len;
  for (int c = threadIdx.x; c < c_len; c += blockDim.x) {
    w[c] = (u32)pw[pi * c_len + c];
    const u32 t = (u32)tw[pi * c_len + c];
    const int at = bit_reverse(c, log_c);
    const u64 v = (u64)xr[c];
    if (levels == 0) {
      z[at] = mont_mul((u32)(v % p), t, p, pinv);
    } else {
      u64 state = decomposer_state(v, base_log, levels);
      for (int lev = 0; lev < levels; ++lev) {
        const long long d = next_digit(state, base_log);
        const u32 r = d < 0 ? (u32)((long long)p + d) : (u32)d;
        z[lev * c_len + at] = mont_mul(r, t, p, pinv);
      }
    }
  }
  __syncthreads();
  for (int lev = 0; lev < nl; ++lev) cyclic_ntt(z + lev * c_len, w, log_c, p, pinv);
  for (int lev = 0; lev < nl; ++lev) {
    u32* o = out + (((long long)lev * rows + row) * NP + pi) * c_len;
    for (int k2 = threadIdx.x; k2 < c_len; k2 += blockDim.x) {
      o[k2] = mont_mul(z[lev * c_len + k2], (u32)twd[pi * c_len + k2], p, pinv);
    }
  }
}

// Entry (b).  ya (D, L, rows, NP, cd) u32, rows = batch k1.  With a key
// (L, k1, k1, NP, C) u32 Montgomery (the key of batch element b at key + b
// key_stride): out (D, batch, k1, NP, cd) u32.  Without (forward_only):
// out (L, rows, NP, C), Montgomery form, one block a (level-row, prime).
__global__ void __launch_bounds__(K9_THREADS)
ps_cross_kernel(const u32* __restrict__ ya, const u32* __restrict__ key,
                u32* __restrict__ out, const long long* __restrict__ consts,
                const long long* __restrict__ pwd_f, const long long* __restrict__ pwd_i,
                const long long* __restrict__ r2, int d, int cd, int levels, int batch, int k1,
                long long key_stride, int forward_only) {
  extern __shared__ u32 sm[];      // k1 rows of C
  const int c_len = cd * d;
  const int pi = blockIdx.x % NP;
  const int unit = blockIdx.x / NP;
  const u32 p = (u32)consts[pi];
  const u32 pinv = (u32)consts[4 + pi];
  const long long rows = (long long)batch * k1;
  // element (a, level-row u, k2loc) of ya for this prime
  auto at = [&](int a, long long u, int k2loc) {
    return ya[(((long long)a * levels * rows + u) * NP + pi) * cd + k2loc];
  };
  if (forward_only) {
    const u32 rr = (u32)r2[pi];
    u32* o = out + ((long long)unit * NP + pi) * c_len;
    for (int j = threadIdx.x; j < c_len; j += blockDim.x) {
      const int k2loc = j / d, kk = j % d;
      u64 s = 0;
      for (int a = 0; a < d; ++a) {
        s += mont_mul(at(a, unit, k2loc), (u32)pwd_f[pi * d + (a * kk) % d], p, pinv);
      }
      o[j] = mont_mul((u32)(s % p), rr, p, pinv);
    }
    return;
  }
  const u32* kb = key + (long long)unit * key_stride;
  for (int j = threadIdx.x; j < c_len; j += blockDim.x) {
    const int k2loc = j / d, kk = j % d;
    u64 acc[K9_MAX_K1];
#pragma unroll
    for (int ro = 0; ro < K9_MAX_K1; ++ro) acc[ro] = 0;
    for (int lev = 0; lev < levels; ++lev) {
      for (int r = 0; r < k1; ++r) {
        const long long u = (long long)lev * rows + (long long)unit * k1 + r;
        u64 s = 0;
        for (int a = 0; a < d; ++a) {
          s += mont_mul(at(a, u, k2loc), (u32)pwd_f[pi * d + (a * kk) % d], p, pinv);
        }
        const u32 x2 = (u32)(s % p);
        const u32* kr = kb + (((long long)lev * k1 + r) * k1 * NP + pi) * c_len + j;
#pragma unroll
        for (int ro = 0; ro < K9_MAX_K1; ++ro) {
          if (ro < k1) acc[ro] += mont_mul(x2, kr[(long long)ro * NP * c_len], p, pinv);
        }
      }
    }
#pragma unroll
    for (int ro = 0; ro < K9_MAX_K1; ++ro) {
      if (ro < k1) sm[ro * c_len + j] = (u32)(acc[ro] % p);
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < k1 * c_len; t += blockDim.x) {
    const int ro = t / c_len, rem = t % c_len, k2loc = rem / d, a = rem % d;
    u64 s = 0;
    for (int kk = 0; kk < d; ++kk) {
      s += mont_mul(sm[ro * c_len + k2loc * d + kk], (u32)pwd_i[pi * d + (kk * a) % d], p, pinv);
    }
    out[((((long long)a * batch + unit) * k1 + ro) * NP + pi) * cd + k2loc] = (u32)(s % p);
  }
}

// Entry (c).  yb (D, rows, NP, cd) u32; twd_i, tw_ci, pw_i (NP, C) Montgomery
// (this slot's inverse twiddle, inverse twist times C^-1, om^-(D j));
// out (rows, C) u64 words.  consts holds R in place of N^-1.
__global__ void __launch_bounds__(K9_THREADS)
ps_inverse_kernel(const u32* __restrict__ yb, long long* __restrict__ out,
                  const long long* __restrict__ consts, const long long* __restrict__ twd_i,
                  const long long* __restrict__ tw_ci, const long long* __restrict__ pw_i,
                  int rows, int d, int log_c) {
  extern __shared__ u32 sm[];      // C powers, C scratch, NP rows of C
  __shared__ Consts cs;
  if (threadIdx.x == 0) load_consts(cs, consts);
  const int c_len = 1 << log_c;
  const int cd = c_len / d;
  const int m = blockIdx.x;
  u32* w = sm;
  u32* v = sm + c_len;
  u32* z = sm + 2 * c_len;
  __syncthreads();
  for (int pi = 0; pi < NP; ++pi) {
    const u32 p = cs.p[pi], pinv = cs.pinv[pi];
    for (int k2 = threadIdx.x; k2 < c_len; k2 += blockDim.x) {
      const int b = k2 / cd, k2loc = k2 % cd;
      const u32 y = yb[(((long long)b * rows + m) * NP + pi) * cd + k2loc];
      v[bit_reverse(k2, log_c)] = mont_mul(y, (u32)twd_i[pi * c_len + k2], p, pinv);
      w[k2] = (u32)pw_i[pi * c_len + k2];
    }
    __syncthreads();
    cyclic_ntt(v, w, log_c, p, pinv);
    for (int c = threadIdx.x; c < c_len; c += blockDim.x) {
      z[pi * c_len + c] = mont_mul(v[c], (u32)tw_ci[pi * c_len + c], p, pinv);
    }
    __syncthreads();
  }
  long long* o = out + (long long)m * c_len;
  for (int c = threadIdx.x; c < c_len; c += blockDim.x) {
    o[c] = (long long)garner_u64(z + c, c_len, cs);
  }
}

// Each kernel's dynamic shared memory limit is raised to the most it can
// take (K9_SMEM, less the inverse's static part) once a device
// (set_smem_once), not on every launch: the attribute call costs the host
// more than a small launch does.
std::atomic<unsigned> forward_sized{0}, cross_sized{0}, inverse_sized{0};

}  // namespace

extern "C" {

int tfhe_torch_poly_shard_forward(const long long* x, unsigned* out, const long long* consts,
                                  const long long* tw, const long long* twd, const long long* pw,
                                  int rows, int log_c, int levels, int base_log, void* stream) {
  if (rows <= 0 || log_c < 0 || log_c > K9_MAX_LOG_C || levels < 0 || levels > K9_MAX_LEVELS ||
      (levels > 0 && (base_log < 1 || base_log > 30 || base_log * levels >= 64))) {
    return cudaErrorInvalidValue;
  }
  const int nl = levels > 0 ? levels : 1;
  const int smem = (nl + 1) * (1 << log_c) * 4;
  if (smem > K9_SMEM) return cudaErrorInvalidValue;
  cudaError_t err = set_smem_once(ps_forward_kernel, K9_SMEM, false, forward_sized);
  if (err != cudaSuccess) return err;
  ps_forward_kernel<<<rows * NP, K9_THREADS, smem, (cudaStream_t)stream>>>(
      x, out, consts, tw, twd, pw, rows, log_c, levels, base_log);
  return cudaGetLastError();
}

int tfhe_torch_poly_shard_cross(const unsigned* ya, const unsigned* key, unsigned* out,
                                const long long* consts, const long long* pwd_f,
                                const long long* pwd_i, const long long* r2, int d, int cd,
                                int levels, int batch, int k1, long long key_stride,
                                int forward_only, void* stream) {
  if (d < 1 || d > 8 || cd < 1 || levels < 1 || batch < 1 || k1 < 1 || k1 > K9_MAX_K1 ||
      (!forward_only && key == nullptr)) {
    return cudaErrorInvalidValue;
  }
  const int smem = forward_only ? 0 : k1 * cd * d * 4;
  const int blocks = (forward_only ? levels * batch * k1 : batch) * NP;
  if (smem > K9_SMEM) return cudaErrorInvalidValue;
  cudaError_t err = set_smem_once(ps_cross_kernel, K9_SMEM, false, cross_sized);
  if (err != cudaSuccess) return err;
  ps_cross_kernel<<<blocks, K9_THREADS, smem, (cudaStream_t)stream>>>(
      ya, key, out, consts, pwd_f, pwd_i, r2, d, cd, levels, batch, k1, key_stride,
      forward_only);
  return cudaGetLastError();
}

int tfhe_torch_poly_shard_inverse(const unsigned* yb, long long* out, const long long* consts,
                                  const long long* twd_i, const long long* tw_ci,
                                  const long long* pw_i, int rows, int d, int log_c,
                                  void* stream) {
  if (rows <= 0 || d < 1 || log_c < 0 || log_c > K9_MAX_LOG_C || (1 << log_c) % d) {
    return cudaErrorInvalidValue;
  }
  const int smem = (2 + NP) * (1 << log_c) * 4;
  if (smem > K9_INVERSE_SMEM) return cudaErrorInvalidValue;
  cudaError_t err = set_smem_once(ps_inverse_kernel, K9_INVERSE_SMEM, false, inverse_sized);
  if (err != cudaSuccess) return err;
  ps_inverse_kernel<<<rows, K9_THREADS, smem, (cudaStream_t)stream>>>(
      yb, out, consts, twd_i, tw_ci, pw_i, rows, d, log_c);
  return cudaGetLastError();
}

}  // extern "C"
