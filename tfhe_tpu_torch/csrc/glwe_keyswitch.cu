// K7: the GLWE keyswitch, for sm_90a.
//
// Replaces: tfhe_tpu/ops/server.py:862 `glwe_keyswitch` (an XLA function:
// tfhe_tpu has no Pallas kernel for it) and, with the other sign,
// tfhe_tpu/core/experimental.py:218 `glwe_fast_keyswitch` on a
// pseudo-GGSW.  Plain version: tfhe_tpu_torch/ops/server.py
// `glwe_keyswitch_sum`.
//
// For each GLWE b of the batch and output row cc:
//   sum_cc = sum_{i < k_in, lev < l} NTT(residues(digit_lev(mask_i))) . key[i][lev][cc]
// on the four CRT primes of ops/ntt.py, then the inverse transform, N^-1
// and Garner to u64, then the body:
//   out = (0, body) - sum          (glwe_keyswitch: the key encrypts S_in)
//   out = sum + (0, body)          (add_sum, the fast keyswitch: the
//                                   pseudo-GGSW encrypts -S_in)
// The CRT route gives tfhe_tpu's words at every shape, also where the
// integer sum passes P/2 and the reconstruction wraps (an exact mod-2^64
// product would agree only below P/2).
//
// What bounds it on the H100: 32-bit integer issue, as K2's exact kernels
// (a GLWE of the 2_2-width keyswitch, k_in = 1, l = 4, k_out+1 = 2, N =
// 2048, is 16 forward and 8 inverse NTTs of N = 2048 and 32 N key
// products); the key (4 k_in l (k_out+1) N u32 words: 256 KB there) is read
// by every GLWE and served from L2.
//
// Two kernels, chosen by shape (ops/kernels.py glwe_keyswitch_route):
//
// The cluster kernel (glwe_keyswitch_cluster_kernel, below), at N = 2048,
// k_in l <= 8, base_log <= 30: both research shapes.  Four blocks a GLWE,
// one a CRT prime, as K2's and K3's cluster kernels: each block holds only
// its prime's rows (33,792 B at k_in l = 4), so four blocks share an SM
// (63 registers a thread); lazy Shoup passes; Garner through distributed
// shared memory.  At B = 512 it took 0.145-0.146 ms against the first
// kernel's 0.360 (0.160 at three blocks an SM, 0.187 at two), the fast
// keyswitch 0.243 against 0.642 (tools/phase_cycles.py k7; NVIDIA H100
// 80GB HBM3, 700 W).
//
// The first kernel (glwe_keyswitch_kernel), every other shape: one block
// a GLWE.  Shared memory holds the k_out+1 output rows' NTT-domain sums on
// the four primes and a chunk of input rows (input polynomial i, level
// lev), as many as fit beside them (ops/kernels.py glwe_keyswitch_rows: 4
// rows at the shape above, 202,752 B, one block an SM).  Per chunk: each
// row's digit residues, decomposed from the mask word in global memory,
// the forward transforms (ntt_common.cuh's exact passes), and the
// products with the chunk's key rows added into the sums.  Then one
// inverse transform of each sum row and Garner.  Rows are padded by one
// word in 32 (ntt_common.cuh pad).  At the research shapes its block spent
// 39 % of its cycles in the key product (a 4-byte load and a fully reduced
// product a word) and 32 % in the exact forward passes.

#include <cooperative_groups.h>

#include "ntt_common.cuh"

namespace cg = cooperative_groups;
using namespace ntt_common;

namespace {

constexpr int GK_MAX_OUT = 8;        // k_out + 1 <= 8 (ops/kernels.py K7_MAX_OUT)
constexpr int GK_SMEM_LIMIT = 232448;

// sum[cc] += sum_{r < rows} res[r] . key[g0 + r][cc] mod p for every
// position (prime pi, coefficient j) the thread owns; the key's row g is
// (input polynomial g / l, level g % l), Montgomery form.
__device__ __forceinline__ void chunk_product(u32* sum, const u32* res,
                                              const u32* __restrict__ key, int g0, int rows,
                                              int kout1, int log_n, int row, const Consts& c) {
  const int n_poly = 1 << log_n;
  for (int q = threadIdx.x; q < NP * n_poly; q += THREADS) {
    const int pi = q >> log_n;
    const int j = q & (n_poly - 1);
    const int at = pi * row + pad(j);
    const u32 p = c.p[pi];
    const u32 pinv = c.pinv[pi];
    u32 acc[GK_MAX_OUT];
#pragma unroll
    for (int cc = 0; cc < GK_MAX_OUT; ++cc) acc[cc] = cc < kout1 ? sum[cc * NP * row + at] : 0u;
    for (int r = 0; r < rows; ++r) {
      const u32 x = res[r * NP * row + at];
      const u32* krow = key + ((size_t)(g0 + r) * kout1 * NP + pi) * n_poly + j;
#pragma unroll
      for (int cc = 0; cc < GK_MAX_OUT; ++cc) {
        if (cc < kout1) {
          acc[cc] = add_mod(acc[cc], mont_mul(x, __ldg(krow + (size_t)cc * NP * n_poly), p, pinv),
                            p);
        }
      }
    }
#pragma unroll
    for (int cc = 0; cc < GK_MAX_OUT; ++cc) {
      if (cc < kout1) sum[cc * NP * row + at] = acc[cc];
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
glwe_keyswitch_kernel(long long* __restrict__ out_g, const long long* __restrict__ glwe_g,
                      const u32* __restrict__ key, const u32* __restrict__ psi,
                      const u32* __restrict__ psi_inv, const long long* __restrict__ consts_g,
                      int k_in, int kout1, int log_n, int levels, int base_log, int add_sum,
                      int chunk) {
  extern __shared__ u32 gk_smem[];
  __shared__ Consts c;
  const int n_poly = 1 << log_n;
  const int row = padded_len(n_poly);
  u32* sum = gk_smem;                           // (k_out+1, NP, row)
  u32* res = gk_smem + kout1 * NP * row;        // (chunk, NP, row)
  const int tid = threadIdx.x;
  const long long* glwe = glwe_g + (size_t)blockIdx.x * (k_in + 1) * n_poly;

  if (tid == 0) load_consts(c, consts_g);
  for (int q = tid; q < kout1 * NP * row; q += THREADS) sum[q] = 0u;
  __syncthreads();

  const int total = k_in * levels;
  for (int g0 = 0; g0 < total; g0 += chunk) {
    const int rows = min(chunk, total - g0);
    // 1. row r of the chunk: digit lev of mask polynomial i (g0 + r = i l +
    // lev, lowest level first), its residue for every prime
    for (int q = tid; q < rows * n_poly; q += THREADS) {
      const int r = q >> log_n;
      const int j = q & (n_poly - 1);
      const int i = (g0 + r) / levels;
      const int lev = (g0 + r) - i * levels;
      u64 state = decomposer_state((u64)glwe[(size_t)i * n_poly + j], base_log, levels);
      long long d = 0;
      for (int t = 0; t <= lev; ++t) d = next_digit(state, base_log);
      u32* x = res + r * NP * row + pad(j);
#pragma unroll
      for (int pi = 0; pi < NP; ++pi) {
        x[pi * row] = d < 0 ? (u32)((long long)c.p[pi] + d) : (u32)d;
      }
    }
    __syncthreads();
    // 2. forward NTT of the chunk's rows; 3. their products added into the sums
    forward_ntt(res, rows * NP, log_n, row, psi, c);
    chunk_product(sum, res, key, g0, rows, kout1, log_n, row, c);
    __syncthreads();
  }

  // 4. inverse NTT of the sums; 5. N^-1, Garner, the sign and the body
  inverse_ntt(sum, kout1 * NP, log_n, row, psi_inv, c);
  long long* out = out_g + (size_t)blockIdx.x * kout1 * n_poly;
  const long long* body = glwe + (size_t)k_in * n_poly;
  for (int q = tid; q < kout1 * n_poly; q += THREADS) {
    const int cc = q >> log_n;
    const int j = q & (n_poly - 1);
    u64 v = garner_u64(sum + cc * NP * row + pad(j), row, c);
    if (!add_sum) v = 0ull - v;
    if (cc == kout1 - 1) v += (u64)body[j];
    out[q] = (long long)v;
  }
}

// ---------------------------------------------------------------------------
// The cluster kernel (glwe_keyswitch_cluster_kernel): a cluster of NP = 4
// blocks of GC_THREADS a GLWE, block rank p holding CRT prime p.  A block
// keeps in shared memory max(k_in l, k_out+1) padded residue rows mod its
// prime: 33,792 B at the GLWE keyswitch's k_in l = 4, 67,584 B at the fast
// keyswitch's 8, so several blocks share an SM.  Per block:
//   1. task (i, lo) reads the 8 mask words j = b 2^(LOG_N-3) | lo of mask
//      polynomial i once, decomposes each once (64-bit decomposer state),
//      and for each level forms the residues d + 2p, runs forward stages
//      0-2 in registers and stores row i l + lev;
//   2. the middle forward stages, ntt_common.cuh's lazy Shoup passes;
//   3. task q, positions 4q .. 4q+3: the last two forward stages of every
//      row, the key product sum_r x_r key[r][cc] (16-byte key loads, four
//      products summed in 64 bits a reduction), the first two inverse
//      stages, written over rows 0 .. k_out;
//   4. the middle inverse stages; the last three with N^-1, canonical;
//   5. cluster barrier; each block reconstructs a quarter of the (k_out+1)
//      N words with Garner from the four blocks' residues, read through
//      distributed shared memory, applies the sign and adds the body;
//      cluster barrier.
// ---------------------------------------------------------------------------

constexpr int GC_THREADS = 256;
constexpr int GC_LOG_N = 11;         // N = 2048, the 2_2 widths
constexpr int GC_MAX_ROWS = 8;       // k_in l digit rows a block holds
constexpr int GC_MIN_BLOCKS = 4;     // blocks an SM (__launch_bounds__: 63 registers)

// The cluster kernel's shapes (ops/kernels.py glwe_keyswitch_route asks
// the entry point tfhe_torch_glwe_keyswitch_cluster_shape): N = 2048, k_in l
// <= 8 digit rows, k_out+1 <= 8, base_log <= 30 (|d| <= 2^29, so d + 2p is
// a valid lazy residue) and base_log l < 64.
__host__ __device__ constexpr bool gk_cluster_shape(int k_in, int kout1, int log_n, int levels,
                                                    int base_log) {
  return log_n == GC_LOG_N && k_in >= 1 && levels >= 1 && k_in * levels <= GC_MAX_ROWS &&
         kout1 >= 1 && kout1 <= GK_MAX_OUT && base_log >= 1 && base_log <= 30 &&
         base_log * levels < 64;
}

// A block's dynamic shared memory: max(k_in l, k_out+1) padded rows.
__host__ __device__ constexpr int gk_cluster_smem(int k_in, int kout1, int levels) {
  return (k_in * levels > kout1 ? k_in * levels : kout1) *
         ((1 << GC_LOG_N) + (1 << GC_LOG_N) / 32) * 4;
}

// Lazy passes over stages K0 .. K0 + M - 1 of the first nrows rows, in
// ceil(M / 4) passes of near-equal length, a block barrier after each.
template <int K0, int M, int LOG_N, bool FORWARD>
__device__ __forceinline__ void gc_middle_passes(u32* rows, int nrows,
                                                 const uint2* __restrict__ tw, const Consts& one) {
  if constexpr (M > 0) {
    constexpr int PASSES = (M + 3) / 4;
    constexpr int S = (M + PASSES - 1) / PASSES;
    lazy_pass<S, LOG_N, 1, GC_THREADS, FORWARD>(rows, nrows, K0, tw, one);
    __syncthreads();
    gc_middle_passes<K0 + S, M - S, LOG_N, FORWARD>(rows, nrows, tw, one);
  }
}

__device__ __forceinline__ u32 gc_lane(const uint4& k, int e) {
  return e == 0 ? k.x : e == 1 ? k.y : e == 2 ? k.z : k.w;
}

// out (batch, k_out+1, N), glwe (batch, k_in+1, N) u64; key (k_in, l,
// k_out+1, NP, N) u32 Montgomery NTT domain, 16-byte aligned; tw_fwd,
// tw_inv the plan's Shoup twiddle pairs (NP, N).
template <int LOG_N>
__global__ void __cluster_dims__(NP, 1, 1) __launch_bounds__(GC_THREADS, GC_MIN_BLOCKS)
glwe_keyswitch_cluster_kernel(long long* __restrict__ out_g, const long long* __restrict__ glwe_g,
                              const uint4* __restrict__ key, const uint2* __restrict__ tw_fwd,
                              const uint2* __restrict__ tw_inv,
                              const long long* __restrict__ consts_g, int k_in, int kout1,
                              int levels, int base_log, int add_sum) {
  constexpr int N = 1 << LOG_N;
  constexpr int ROW = N + N / 32;
  constexpr int LO = LOG_N - 3;            // the first pass takes stages 0-2
  constexpr int NT = GC_THREADS;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();   // this block's prime
  extern __shared__ uint4 gc_smem[];
  __shared__ Consts c;                          // the four primes (Garner)
  __shared__ Consts one;                        // the lazy passes read their prime from p[0]
  u32* rows = (u32*)gc_smem;                    // (max(k_in l, k_out+1), ROW) mod this prime
  const int tid = threadIdx.x;
  const int nrows = k_in * levels;
  const int gi = blockIdx.x / NP;
  const long long* glwe = glwe_g + (size_t)gi * (k_in + 1) * N;

  if (tid == 0) {
    load_consts(c, consts_g);
    one = c;
    one.p[0] = c.p[rank];
    one.pinv[0] = c.pinv[rank];
  }
  const u32* rows_of[NP];                       // every block's residues
#pragma unroll
  for (int r = 0; r < NP; ++r) rows_of[r] = cluster.map_shared_rank(rows, r);
  __syncthreads();
  const u32 p = c.p[rank];
  const u32 pinv = c.pinv[rank];
  const uint2* twf = tw_fwd + (rank << LOG_N);
  const uint2* twi = tw_inv + (rank << LOG_N);

  // 1. task (i, lo): each of the 8 words decomposed once; per level its
  // residues d + 2p through forward stages 0-2 in registers
  for (int q = tid; q < (k_in << LO); q += NT) {
    const int i = q >> LO;
    const int lo = q & ((1 << LO) - 1);
    u64 st[8];
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      st[b] = decomposer_state((u64)__ldg(glwe + (size_t)i * N + ((b << LO) | lo)), base_log,
                               levels);
    }
    for (int lev = 0; lev < levels; ++lev) {
      u32 v[8];
#pragma unroll
      for (int b = 0; b < 8; ++b) v[b] = lazy_digit_residue((int)next_digit(st[b], base_log), p);
      lazy_forward_stages<3, LOG_N>(v, 0, 0, twf, p);
      u32* x = rows + (i * levels + lev) * ROW + pad(lo);
#pragma unroll
      for (int b = 0; b < 8; ++b) x[pad(b << LO)] = v[b];
    }
  }
  __syncthreads();

  // 2. forward stages 3 .. LOG_N - 3
  gc_middle_passes<3, LOG_N - 5, LOG_N, true>(rows, nrows, twf, one);

  // 3. task q, positions 4q .. 4q+3 of every row: the last two forward
  // stages, canonical; per output row cc the key product (the k_in l
  // products summed in 64 bits, a reduction a four: 4 p^2 < p 2^32) and
  // inverse stages 0-1, written over row cc in [0, 2p)
  for (int q = tid; q < N / 4; q += NT) {
    const int at = pad(q * 4);                  // pad(4q + e) = at + e
    u32 x[GC_MAX_ROWS][4];
#pragma unroll
    for (int r = 0; r < GC_MAX_ROWS; ++r) {
      if (r < nrows) {
#pragma unroll
        for (int e = 0; e < 4; ++e) x[r][e] = rows[r * ROW + at + e];
        lazy_forward_stages<2, LOG_N>(x[r], LOG_N - 2, q, twf, p);
#pragma unroll
        for (int e = 0; e < 4; ++e) x[r][e] = reduce_to(reduce_to(x[r][e], 2 * p), p);
      }
    }
    for (int cc = 0; cc < kout1; ++cc) {
      u64 sum[4] = {0, 0, 0, 0};
      u32 o[4] = {0, 0, 0, 0};
#pragma unroll
      for (int r = 0; r < GC_MAX_ROWS; ++r) {
        if (r < nrows) {
          const uint4 k = __ldg(key + ((size_t)(r * kout1 + cc) * NP + rank) * (N / 4) + q);
#pragma unroll
          for (int e = 0; e < 4; ++e) sum[e] += (u64)x[r][e] * gc_lane(k, e);
          if ((r & 3) == 3 || r == nrows - 1) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              o[e] = reduce_to(o[e] + redc_lazy(sum[e], p, pinv), 2 * p);
              sum[e] = 0;
            }
          }
        }
      }
      lazy_inverse_stages<2, LOG_N>(o, 0, q, twi, p);
#pragma unroll
      for (int e = 0; e < 4; ++e) rows[cc * ROW + at + e] = o[e];
    }
  }
  __syncthreads();

  // 4. inverse stages 2 .. LOG_N - 4; the last three with N^-1, canonical
  // residues in place
  gc_middle_passes<2, LOG_N - 5, LOG_N, false>(rows, kout1, twi, one);
  for (int q = tid; q < (kout1 << (LOG_N - 3)); q += NT) {
    constexpr int K0 = LOG_N - 3;
    const int cc = q >> K0;
    const int lo = q & ((1 << K0) - 1);
    u32* x = rows + cc * ROW + pad(lo);
    u32 y[8];
#pragma unroll
    for (int b = 0; b < 8; ++b) y[b] = x[pad(b << K0)];
    lazy_inverse_stages<3, LOG_N>(y, K0, 0, twi, p);
#pragma unroll
    for (int b = 0; b < 8; ++b) x[pad(b << K0)] = mont_mul(reduce_to(y[b], p), c.ninv[rank], p, pinv);
  }
  cluster.sync();   // every prime's output residues are final

  // 5. Garner on this block's quarter of the words from the four blocks'
  // residues; the sign and the body
  const int quarter = kout1 * N / NP;
  long long* out = out_g + (size_t)gi * kout1 * N;
  const long long* body = glwe + (size_t)k_in * N;
  for (int q = tid; q < quarter; q += NT) {
    const int g = rank * quarter + q;
    const int cc = g >> LOG_N;
    const int j = g & (N - 1);
    const int at = cc * ROW + pad(j);
    u32 dg[NP];
#pragma unroll
    for (int pi = 0; pi < NP; ++pi) dg[pi] = rows_of[pi][at];
    u64 v = garner_signed<NP>(dg, c);
    if (!add_sum) v = 0ull - v;
    if (cc == kout1 - 1) v += (u64)__ldg(body + j);
    out[g] = (long long)v;
  }
  cluster.sync();   // every residue read before any block leaves
}

// The cluster kernel's largest dynamic shared memory, that of any shape it
// takes (GC_MAX_ROWS rows), and its carveout, set once a device: every
// caller that touches the attribute goes through here, so none lowers it
// under a later launch's need.
cudaError_t gk_cluster_prepare() {
  static std::atomic<unsigned> smem_set{0};
  return set_smem_once(glwe_keyswitch_cluster_kernel<GC_LOG_N>,
                       gk_cluster_smem(GC_MAX_ROWS, 1, 1), true, smem_set);
}

template <int LOG_N>
cudaError_t gk_cluster_launch(long long* out, const long long* glwe, const uint4* key,
                              const uint2* tw_fwd, const uint2* tw_inv, const long long* consts,
                              int batch, int k_in, int kout1, int levels, int base_log,
                              int add_sum, cudaStream_t stream) {
  auto kernel = glwe_keyswitch_cluster_kernel<LOG_N>;
  const int smem = gk_cluster_smem(k_in, kout1, levels);
  cudaError_t err = gk_cluster_prepare();
  if (err != cudaSuccess) return err;
  kernel<<<batch * NP, GC_THREADS, smem, stream>>>(out, glwe, key, tw_fwd, tw_inv, consts, k_in,
                                                   kout1, levels, base_log, add_sum);
  return cudaGetLastError();
}

}  // namespace

// out (batch, k_out+1, N), glwe (batch, k_in+1, N) u64; key (k_in, l,
// k_out+1, NP, N) u32 Montgomery NTT domain; psi, psi_inv the plan's
// twiddles; chunk the input rows transformed at once (ops/kernels.py
// glwe_keyswitch_rows), 1 <= chunk <= k_in l.
extern "C" int tfhe_torch_glwe_keyswitch(void* out, const void* glwe, const void* key,
                                         const void* psi, const void* psi_inv, const void* consts,
                                         int batch, int k_in, int kout1, int log_n, int levels,
                                         int base_log, int add_sum, int chunk, void* stream) {
  if (batch < 1 || k_in < 1 || kout1 < 1 || kout1 > GK_MAX_OUT || levels < 1 ||
      base_log < 1 || base_log * levels >= 64 || log_n < 1 || log_n > 16 || chunk < 1 ||
      chunk > k_in * levels) {
    return (int)cudaErrorInvalidValue;
  }
  const int smem = (kout1 + chunk) * NP * padded_len(1 << log_n) * 4;
  if (smem > GK_SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  return (int)launch_blocks(glwe_keyswitch_kernel, batch, smem, (cudaStream_t)stream,
                            (long long*)out, (const long long*)glwe, (const u32*)key,
                            (const u32*)psi, (const u32*)psi_inv, (const long long*)consts, k_in,
                            kout1, log_n, levels, base_log, add_sum, chunk);
}

// Whether K7 runs its cluster kernel at a shape (gk_cluster_shape);
// ops/kernels.py glwe_keyswitch_route chooses by it.
extern "C" int tfhe_torch_glwe_keyswitch_cluster_shape(int k_in, int kout1, int log_n,
                                                       int levels, int base_log) {
  return gk_cluster_shape(k_in, kout1, log_n, levels, base_log) ? 1 : 0;
}

// K7's cluster kernel: out (batch, k_out+1, N), glwe (batch, k_in+1, N)
// u64; key (k_in, l, k_out+1, NP, N) u32 Montgomery NTT domain, 16-byte
// aligned; tw_fwd, tw_inv the plan's Shoup twiddle pairs (NP, N); one
// cluster of NP blocks a GLWE.
extern "C" int tfhe_torch_glwe_keyswitch_cluster(void* out, const void* glwe, const void* key,
                                                 const void* tw_fwd, const void* tw_inv,
                                                 const void* consts, int batch, int k_in,
                                                 int kout1, int log_n, int levels, int base_log,
                                                 int add_sum, void* stream) {
  if (!gk_cluster_shape(k_in, kout1, log_n, levels, base_log) || batch < 1 ||
      ((uintptr_t)key & 15) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  return (int)gk_cluster_launch<GC_LOG_N>(
      (long long*)out, (const long long*)glwe, (const uint4*)key, (const uint2*)tw_fwd,
      (const uint2*)tw_inv, (const long long*)consts, batch, k_in, kout1, levels, base_log,
      add_sum, (cudaStream_t)stream);
}

// The cluster kernel's dynamic shared memory a block and the clusters of
// NP blocks the card holds at once (cudaOccupancyMaxActiveClusters, or
// minus the CUDA error) at a shape it takes; -1 elsewhere.
extern "C" int tfhe_torch_glwe_keyswitch_cluster_smem(int k_in, int kout1, int levels) {
  if (!gk_cluster_shape(k_in, kout1, GC_LOG_N, levels, 1)) return -1;
  return gk_cluster_smem(k_in, kout1, levels);
}

extern "C" int tfhe_torch_glwe_keyswitch_cluster_occupancy(int k_in, int kout1, int levels) {
  if (!gk_cluster_shape(k_in, kout1, GC_LOG_N, levels, 1)) return -1;
  auto kernel = glwe_keyswitch_cluster_kernel<GC_LOG_N>;
  const int smem = gk_cluster_smem(k_in, kout1, levels);
  cudaError_t err = gk_cluster_prepare();
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(NP * 64, 1, 1);
  cfg.blockDim = dim3(GC_THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, (void*)kernel, &cfg);
  return err != cudaSuccess ? -(int)err : n;
}
