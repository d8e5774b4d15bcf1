// K2's exact rotation at large N: a thread-block cluster a ciphertext, for
// sm_90a.
//
// Replaces: tfhe_tpu/ops/pallas_ntt.py:794 `build_blind_rotate_v2` (the
// exact rotation, meaning tfhe_tpu/ops/server.py:367 blind_rotate) at the
// shapes whose accumulator and residues do not fit one block's shared
// memory (csrc/blind_rotate.cu tfhe_torch_blind_rotate_smem_bytes above
// 232,448 B): V1_4_PARAM_MESSAGE_3_CARRY_3_KS_PBS_TUNIFORM_2M128, k+1 = 2,
// l = 2, N = 8192, whose u64 accumulator (131,072 B) and 4-prime residues of
// l (k+1) = 4 digit polynomials (540,672 B) need 671,744 B.  tfhe_tpu runs
// that set through the same 4-prime server.blind_rotate.  Plain version:
// tfhe_tpu_torch/ops/server.py `blind_rotate`.
//
// Per step, as K2's generic exact kernel:
//   ct1  = acc * X^{a_i} - acc
//   acc += sum_{lev, r} NTT^-1( NTT(residues(digit_lev(ct1_r))) . GGSW_i[lev][r] )
// reconstructed mod 2^64 with Garner from the four primes' residues.
//
// What bounds it on the H100: 32-bit integer issue, as K2 (a step of one
// ciphertext is 24 NTTs of N = 8192, 32 N key products and 2 N Garner
// reconstructions); the key is 1.13 GB at 3_3 (1 MB a step), read once a
// step by every cluster from L2.
//
// Design: a cluster of NP = 4 blocks per ciphertext, block rank p holding
// prime p.  Block p keeps in its shared memory the residues mod p of the
// l (k+1) digit polynomials (135,168 B at 3_3) and a quarter of the u64
// accumulator (32,768 B): 167,936 B, one block an SM.  A step:
//   1. the first forward pass, fused: every block reads the whole rotated
//      accumulator through distributed shared memory
//      (cluster.map_shared_rank), forms acc X^a - acc, keeps each word's
//      decomposer state in registers, and for each level takes the signed
//      digit's residue d + 2p and transform stages 0-3 in registers before
//      one store;
//   2. the remaining forward stages (two passes of four and one of one),
//      the product with its prime's slice of the step's GGSW (16-byte key
//      loads, four positions a task, the l (k+1) products summed in 64
//      bits, one reduction), the inverse transforms of the k+1 output rows
//      (three passes of four; the last stage fused with N^-1), all as
//      ntt_common.cuh's lazy Shoup passes on one prime, as K5's lazy
//      kernel runs them;
//   3. cluster barrier; each block reconstructs its quarter of the
//      coefficients with Garner from the four blocks' canonical residues
//      (read through distributed shared memory) and adds them to its
//      accumulator quarter; cluster barrier.
// The same kernel serves the common-mask rotation at the 2_2 widths
// (tfhe_tpu/core/cm.py:299 cm_blind_rotate, K2's exact rotation at k+1 =
// k + C): l = 1, N = 2048, k+1 from 3 to 8, where one block of K2's
// generic kernel would hold the whole (k+1, N) accumulator and 4-prime
// residues (200,704 B at k+1 = 4, one block an SM; 250,880 B at k+1 = 5,
// more than a block may use).  A cluster block needs 12,544 (k+1) B there
// (50,176 at k+1 = 4, 100,352 at k+1 = 8), so four blocks a ciphertext
// fill four times the SMs, and the first pass takes the one-level digit
// from the high word (hi_word_digit: base_log <= 30 reads no lower bit).
// The accumulator and the residues never leave the cluster's SMs; each
// block reads only its prime's quarter of the key.  The first design (PR
// 14's chip runs 1-3: fully reduced Montgomery passes, ntt_common.cuh's
// generic exact passes on one prime, the key product a position a thread)
// took 443.5 ms at B = 64; this one 174.0 ms (B = 4: 58.4 ms), NVIDIA H100
// 80GB HBM3, 700 W.
//
// The small-N kernel (blind_rotate_cluster_small_kernel, below) takes the
// TEST shapes, k+1 = 2, N = 512, l <= 4, and 1_1's k+1 = 5, l = 1 (k+1 = 3,
// 4 too): the PBS of WoPBS and AES (l = 1,
// base 2^23) and, with a key a ciphertext (key_index), the low-bit CMux
// chain of vertical packing (l = 4, base 2^6; tfhe_tpu/shortint/wopbs.py
// vertical_packing, one _cmux a bit; tfhe_tpu/ops/pallas_ntt.py:296
// `build_cmux_step` is the step it chains).  There the generic kernel's
// one block of 512 threads a ciphertext walks its steps alone (a step
// 12.5 us at l = 1, 36.8 us at l = 4 on an NVIDIA H100 80GB HBM3 at 700 W:
// fully reduced passes, nine barriers, the key slice read from L2 with
// nothing in flight ahead), and at B = 4 it
// fills 4 of the 132 SMs.  Here a cluster of four blocks of 128 threads a
// ciphertext, one a prime, as above, with: the rows of one prime (N = 512:
// 17 KB at l = 4), so four times the SMs work on a ciphertext; the next
// step's key slice of its prime (8 KB a level) copied into shared memory
// by cp.async while the step runs, double-buffered; the last two forward
// stages and the first two inverse ones fused into the key product (four
// consecutive positions a task: stages 7-8 pair positions 2 and 1 apart,
// inverse stages 0-1 the same), so a step is four block barriers and the
// two cluster barriers around Garner; and each block holds a whole copy
// of the accumulator: the last inverse pass stores each residue into the
// block that reconstructs its coefficient, and Garner stores each new word
// into all four copies, so no block reads another's shared memory (a
// first design that read the rotated accumulator through distributed
// shared memory spent 8,400 of a step's 14,540 cycles in that first pass
// at B = 4, and at B = 128 lost to the generic kernel, 0.211 against
// 0.203 ms a launch, NVIDIA H100 80GB HBM3, 700 W).  The fallback, a
// chain of global-memory (L2-resident) kernels a step, would move the
// 671,744 B of state through L2 three times a step; the cluster moves only
// the accumulator's reads (2 u64 a coefficient) and Garner's residues (4
// u32 a coefficient) between SMs.
//
// Both kernels also run K2's CMux entry (tfhe_torch_cmux_cluster; ops/
// kernels.py cmux, its "small" and "cluster" routes): out = ct0 + GGSW (x)
// (ct1 - ct0) for a batch sharing one GGSW, the CMux tree of vertical
// packing (tfhe_tpu/shortint/wopbs.py:212 `_cmux`, N = 512, l = 4) and the
// common-mask CMux and external product (tfhe_tpu/core/cm.py:249, N =
// 2048, l = 1, k+1 = k + C up to 8), in a one-step mode (template argument
// CMUX): the operands come in place of acc X^a - acc and ct0 in place of
// the accumulator, the GGSW is one step of the exact key's layout, and the
// result goes to out.  The first design of that entry (csrc/blind_rotate.cu
// cmux_kernel, one block of 512 threads a ciphertext, fully reduced passes,
// 4-byte key loads) filled 1 of the 132 SMs at B = 1 and could not hold
// k+1 >= 5 at N = 2048 in a block.

#include <atomic>
#include <cooperative_groups.h>

#include "ntt_common.cuh"

namespace cg = cooperative_groups;
using namespace ntt_common;

namespace {

// The kernel's shapes, digits |d| <= 2^29 (base_log <= 30) for the lazy
// residues d + 2p: k + 1 = 2, l <= 2 (at l = 3 a block's residues would
// pass its shared memory), N = 8192 (3_3: l = 2); and l = 1, N = 2048,
// 3 <= k + 1 <= 8 (ROWS <= 8: the common-mask rotation at C <= 7); and the
// small-N kernel's at N = 512, base_log l < 64 (the decomposer's width):
// k + 1 = 2, l <= 4 (the TEST sets) and 3 <= k + 1 <= 5, l = 1 (1_1: k + 1
// = 5, base 2^23).  The wrapper routes by its own copy of this predicate
// (ops/kernels.py CLUSTER_SHAPES); the entry point refuses any other shape.
constexpr int CL_K1 = 2;
constexpr int CL_LOG_N = 13;
constexpr int CL_MAX_LEVELS = 2;
constexpr int CM_LOG_N = 11;
constexpr int CM_MIN_K1 = 3;
constexpr int CM_MAX_K1 = 8;
constexpr int SN_LOG_N = 9;
constexpr int SN_MAX_LEVELS = 4;
constexpr int SN_MAX_K1 = 5;

__host__ __device__ constexpr bool small_shape(int k1, int log_n, int levels, int base_log) {
  return base_log >= 1 && base_log <= 30 && log_n == SN_LOG_N && levels >= 1 &&
         base_log * levels < 64 &&
         ((k1 == CL_K1 && levels <= SN_MAX_LEVELS) || (k1 > CL_K1 && k1 <= SN_MAX_K1 && levels == 1));
}

// The small-N kernel's shapes at k + 1 = 2, the only ones that take a key a
// ciphertext (tfhe_torch_blind_rotate_cluster with a key_index: the CMux
// chain, ops/kernels.py chain_shape).
__host__ __device__ constexpr bool chain_shape(int k1, int log_n, int levels, int base_log) {
  return k1 == CL_K1 && small_shape(k1, log_n, levels, base_log);
}

// The CMux mode's shapes (tfhe_torch_cmux_cluster; ops/kernels.py
// cmux_route): the small-N kernel's, and the cluster kernel's at N = 2048
// (the common-mask CMux at C <= 7).
__host__ __device__ constexpr bool cmux_shape(int k1, int log_n, int levels, int base_log) {
  return small_shape(k1, log_n, levels, base_log) ||
         (base_log >= 1 && base_log <= 30 && log_n == CM_LOG_N && levels == 1 &&
          k1 >= CM_MIN_K1 && k1 <= CM_MAX_K1);
}

__host__ __device__ constexpr bool cluster_shape(int k1, int log_n, int levels, int base_log) {
  return small_shape(k1, log_n, levels, base_log) ||
         (base_log >= 1 && base_log <= 30 &&
          ((k1 == CL_K1 && log_n == CL_LOG_N && levels >= 1 && levels <= CL_MAX_LEVELS) ||
           (log_n == CM_LOG_N && levels == 1 && k1 >= CM_MIN_K1 && k1 <= CM_MAX_K1)));
}

// Blocks an SM the kernel is compiled for at a shape (__launch_bounds__: 2
// holds a thread to 64 registers): two at N = 2048, where two blocks fit an
// SM's shared memory (faster at every k+1 from 3 to 8 at B = 64: 45.1
// against 52.7 ms at k+1 = 4, 108.9 against 110.6 at k+1 = 8,
// tools/rotation_probe.py on an NVIDIA H100 80GB HBM3 at 700 W), one at
// N = 8192 (ops/kernels.py CLUSTER_BLOCKS_PER_SM).
__host__ __device__ constexpr int cluster_min_blocks(int log_n) {
  return log_n == CM_LOG_N ? 2 : 1;
}

template <int K1, int LEVELS, int LOG_N>
struct Cluster {
  static constexpr int N = 1 << LOG_N;
  static constexpr int ROW = N + N / 32;             // padded residue row
  static constexpr int ROWS = LEVELS * K1;           // digit rows (lev, r)
  static constexpr int QUARTER = K1 * N / NP;        // accumulator words a block
  static constexpr int LO = LOG_N - 4;               // the first pass takes stages 0-3
  static constexpr int LAST = (LOG_N - 5) % 4 + 1;   // stages of the last forward pass
  static constexpr int MIDDLE = (LOG_N - 4 - LAST) / 4;
  static constexpr int INV_LAST = (LOG_N - 1) % 4 + 1;
  static constexpr int INV_MIDDLE = (LOG_N - INV_LAST) / 4;
  static constexpr int SMEM = QUARTER * 8 + ROWS * ROW * 4;
  static_assert(LOG_N - LAST >= 5 && LOG_N - INV_LAST >= 5 && ROWS <= 8,
                "the fused passes split pad() over their strides");
};

// CMUX: the one-step, operand-given mode (tfhe_torch_cmux_cluster): the
// first pass reads ct0 and ct1 from global memory and takes d = ct1 - ct0
// in place of acc X^a - acc, ct0 (in_g) is the accumulator Garner adds
// into, and the result goes to out_g; mask_g is not read and n_steps is 1.
// Without it, in_g = out_g, the accumulators rotated in place.  Every read
// of in_g and ct1_g comes before the cluster barrier that precedes the
// first write of out_g, and a cluster reads and writes only its own
// ciphertext, so out may be ct0.
template <int K1, int LEVELS, int LOG_N, bool CMUX>
__global__ void __cluster_dims__(NP, 1, 1)
__launch_bounds__(THREADS, cluster_min_blocks(LOG_N))
blind_rotate_cluster_kernel(long long* out_g, const long long* in_g,
                            const long long* __restrict__ ct1_g, const int* __restrict__ mask_g,
                            const uint4* __restrict__ bsk, const uint2* __restrict__ tw_fwd,
                            const uint2* __restrict__ tw_inv,
                            const long long* __restrict__ consts_g, int n_steps,
                            int base_log) {
  using S = Cluster<K1, LEVELS, LOG_N>;
  constexpr int N = S::N;
  constexpr int ROW = S::ROW;
  constexpr int ROWS = S::ROWS;
  constexpr int QUARTER = S::QUARTER;
  constexpr int LO = S::LO;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();   // this block's prime
  extern __shared__ u64 cl_smem[];
  __shared__ Consts c;                          // the four primes (Garner)
  __shared__ Consts one;                        // the lazy passes read their prime from p[0]
  u64* acc = cl_smem;                           // coefficients rank QUARTER ..
  u32* rows = (u32*)(cl_smem + QUARTER);        // (LEVELS K1, ROW) mod this prime
  const int tid = threadIdx.x;
  const size_t ct = blockIdx.x / NP;
  const long long* in_b = in_g + ct * K1 * N;
  const long long* ct1_b = CMUX ? ct1_g + ct * K1 * N : nullptr;
  const int* mask_b = CMUX ? nullptr : mask_g + ct * n_steps;

  if (tid == 0) {
    load_consts(c, consts_g);
    one = c;
    one.p[0] = c.p[rank];
    one.pinv[0] = c.pinv[rank];
  }
  for (int q = tid; q < QUARTER; q += THREADS) acc[q] = (u64)in_b[rank * QUARTER + q];
  const u64* acc_of[NP];                        // every block's quarter
  const u32* rows_of[NP];                       // every block's residues
#pragma unroll
  for (int r = 0; r < NP; ++r) {
    acc_of[r] = cluster.map_shared_rank(acc, r);
    rows_of[r] = cluster.map_shared_rank(rows, r);
  }
  cluster.sync();   // constants loaded; every quarter loaded before any is read
  const u32 p = c.p[rank];
  const u32 pinv = c.pinv[rank];
  const uint2* twf = tw_fwd + (rank << LOG_N);
  const uint2* twi = tw_inv + (rank << LOG_N);

  for (int step = 0; step < n_steps; ++step) {
    const int a = CMUX ? 0 : mask_b[step];      // in [0, 2N)
    const int rot = a & (N - 1);
    const bool odd = ((a >> LOG_N) & 1) != 0;

    // 1. acc X^a - acc from the four quarters (CMUX: ct1 - ct0 from global
    // memory), its decomposer states, and per level the digits' residues
    // d + 2p and forward stages 0-3 in registers: task (r, lo) owns
    // coefficients j = b 2^LO | lo, b < 16
    for (int q = tid; q < K1 << LO; q += THREADS) {
      const int r = q >> LO;
      const int lo = q & ((1 << LO) - 1);
      // one level: the digit itself (from the high word); else the state
      u64 state[16];
      int dig[16];
#pragma unroll
      for (int b = 0; b < 16; ++b) {
        const int j = (b << LO) | lo;
        const int g = r * N + j;
        u64 d;
        if constexpr (CMUX) {
          d = (u64)ct1_b[g] - (u64)in_b[g];
        } else {
          const int src = j < rot ? g - rot + N : g - rot;
          u64 v = acc_of[src / QUARTER][src % QUARTER];
          if (j < rot) v = 0ull - v;
          if (odd) v = 0ull - v;
          d = v - acc_of[g / QUARTER][g % QUARTER];
        }
        if constexpr (LEVELS == 1) {
          dig[b] = hi_word_digit((u32)(d >> 32), base_log);
        } else {
          state[b] = decomposer_state(d, base_log, LEVELS);
        }
      }
#pragma unroll
      for (int lev = 0; lev < LEVELS; ++lev) {
        u32 v[16];
#pragma unroll
        for (int b = 0; b < 16; ++b) {
          if constexpr (LEVELS == 1) {
            v[b] = lazy_digit_residue(dig[b], p);
          } else {
            v[b] = lazy_digit_residue((int)next_digit(state[b], base_log), p);
          }
        }
        lazy_forward_stages<4, LOG_N>(v, 0, 0, twf, p);
        u32* x = rows + (lev * K1 + r) * ROW + pad(lo);
#pragma unroll
        for (int b = 0; b < 16; ++b) x[pad(b << LO)] = v[b];
      }
    }
    __syncthreads();

    // 2. the remaining forward stages; the product with the step's GGSW
    // slice of this prime over four positions a task, written over rows
    // 0 .. K1-1 in [0, 2p); the inverse transforms, the last stage with
    // N^-1, canonical residues
#pragma unroll
    for (int m = 0; m < S::MIDDLE; ++m) {
      lazy_pass<4, LOG_N, 1, THREADS, true>(rows, ROWS, 4 + 4 * m, twf, one);
      __syncthreads();
    }
    lazy_pass<S::LAST, LOG_N, 1, THREADS, true>(rows, ROWS, LOG_N - S::LAST, twf, one);
    __syncthreads();
    const uint4* key = bsk + (size_t)step * ROWS * K1 * NP * (N / 4);
    for (int q = tid; q < N / 4; q += THREADS) {
      const int t0 = q * 4;
      const int at = pad(t0);                   // pad(t0 + e) = at + e
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
          const uint4 k = __ldg(key + (((r * K1 + cc) * NP + rank) * N + t0) / 4);
          sum[0] += (u64)x[r][0] * k.x;
          sum[1] += (u64)x[r][1] * k.y;
          sum[2] += (u64)x[r][2] * k.z;
          sum[3] += (u64)x[r][3] * k.w;
          if (r % 4 == 3 || r == ROWS - 1) {   // 4 p^2 < p 2^32: one reduction a four
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
#pragma unroll
    for (int m = 0; m < S::INV_MIDDLE; ++m) {
      lazy_pass<4, LOG_N, 1, THREADS, false>(rows, K1, 4 * m, twi, one);
      __syncthreads();
    }
    {
      constexpr int SL = S::INV_LAST;
      constexpr int K0 = LOG_N - SL;
      for (int q = tid; q < K1 << K0; q += THREADS) {
        const int cc = q >> K0;
        const int lo = q & ((1 << K0) - 1);
        u32* x = rows + cc * ROW + pad(lo);
        u32 y[1 << SL];
#pragma unroll
        for (int b = 0; b < (1 << SL); ++b) y[b] = x[pad(b << K0)];
        lazy_inverse_stages<SL, LOG_N>(y, K0, 0, twi, p);
#pragma unroll
        for (int b = 0; b < (1 << SL); ++b) {
          x[pad(b << K0)] = mont_mul(reduce_to(y[b], p), c.ninv[rank], p, pinv);
        }
      }
    }
    cluster.sync();   // every prime's output residues are final

    // 3. Garner on this block's quarter from the four blocks' residues
    for (int q = tid; q < QUARTER; q += THREADS) {
      const int g = rank * QUARTER + q;
      const int at = (g >> LOG_N) * ROW + pad(g & (N - 1));
      u32 dg[NP];
#pragma unroll
      for (int pi = 0; pi < NP; ++pi) dg[pi] = rows_of[pi][at];
      acc[q] += garner_signed<NP>(dg, c);
    }
    cluster.sync();   // every quarter updated; every residue read
  }

  long long* out_b = out_g + ct * K1 * N;
  for (int q = tid; q < QUARTER; q += THREADS) out_b[rank * QUARTER + q] = (long long)acc[q];
}

// The small-N kernel: N = 512, K1 = 2 and LEVELS <= 4 or K1 <= 5 and
// LEVELS = 1, SN_THREADS threads a block, block rank p of a ciphertext's
// cluster holding prime p.  Shared memory: a whole copy of the u64
// accumulator (every block keeps one, so the first pass reads no other
// block), its prime's slice of a step's GGSW ((lev, r, cc) rows of N words,
// as cp.async copies them: 16 KB at k + 1 = 2, l = 1, 64 KB at l = 4, 50 KB
// at k + 1 = 5) in two buffers where two blocks an SM still fit with them,
// else in one (k + 1 = 5: 143,680 B a block with two, so one an SM and 30
// clusters on the card, a second wave at B = 32; 92,480 B with one), the
// residue rows (lev, r) mod p, padded, and the four primes' residues of the
// block's quarter of the coefficients (its Garner inputs, which the other
// blocks store into it).
constexpr int SN_THREADS = 128;

template <int K1_, int LEVELS, bool CMUX = false>
struct Small {
  static constexpr int K1 = K1_;
  static constexpr int LOG_N = SN_LOG_N;
  static constexpr int N = 1 << LOG_N;
  static constexpr int ROW = N + N / 32;
  static constexpr int ROWS = LEVELS * K1;           // digit rows (lev, r)
  static constexpr int QUARTER = K1 * N / NP;        // coefficients a block reconstructs
  static constexpr int KEY = ROWS * K1 * N;          // u32 words of a step's prime slice
  static constexpr int STEP4 = ROWS * K1 * NP * N / 4;   // 16-byte words of a step's GGSW
  static constexpr int LO = LOG_N - 4;               // the first pass takes stages 0-3
  // the CMux mode (one step) keeps ct0's quarter of the coefficients too
  // and needs one key buffer
  static constexpr int BASE = K1 * N * 8 + ROWS * ROW * 4 + NP * QUARTER * 4 + (CMUX ? QUARTER * 8 : 0);
  static constexpr int BUFS = !CMUX && 2 * (BASE + 2 * KEY * 4 + 1024) <= 228 * 1024 ? 2 : 1;
  static constexpr int SMEM = BASE + BUFS * KEY * 4;
  // blocks an SM the kernel is compiled for (__launch_bounds__): four (128
  // registers a thread) where four fit shared memory, else two
  static constexpr int MIN_BLOCKS = 4 * SMEM <= 228 * 1024 ? 4 : 2;
  static_assert(2 * (SMEM + 1024) <= 228 * 1024, "two blocks an SM");
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src));
}

// Step step's slice of this block's prime, from the ciphertext's GGSWs
// key (STEP4 16-byte words a step), into buffer step & 1 (of two) or the
// one buffer; one commit group a call, empty past the last step.
template <class S>
__device__ __forceinline__ void prefetch_key(u32* keys, const uint4* __restrict__ key, int step,
                                             int n_steps, int rank) {
  if (step < n_steps) {
    const uint4* src = key + (size_t)step * S::STEP4;
    uint4* dst = (uint4*)(keys + (step & (S::BUFS - 1)) * S::KEY);
    for (int q = threadIdx.x; q < S::KEY / 4; q += SN_THREADS) {
      const int e = q / (S::N / 4);             // row (lev, r, cc)
      const int t = q % (S::N / 4);
      cp_async16(dst + q, src + (e * NP + rank) * (S::N / 4) + t);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// acc (batch, k+1, N) u64, in_g = out_g, in place; mask (batch, n_steps)
// in [0, 2N); bsk the GGSWs: ciphertext b's step i is (l, k+1, k+1, NP, N)
// u32 at bsk + key_index[b] set_words + i STEP4 16-byte words (key_index
// null: the one key, (n_steps, l, k+1, k+1, NP, N)).  CMUX: the one-step,
// operand-given mode, as the cluster kernel's (in_g ct0, ct1_g, out_g; the
// GGSW at bsk; mask_g and key_index not read): the accumulator copy is
// loaded as d = ct1 - ct0, which the first pass reads as it reads acc X^a
// - acc, ct0's quarter beside it; Garner writes out_g, and no block reads
// another's shared memory after the cluster barrier before Garner, so the
// last barrier goes.  One key buffer: 64,000 B at the tree's l = 4, three
// blocks an SM (92 clusters at once) where the rotation's two buffers
// (94,720 B) hold two (62 clusters, two waves at B = 64).
template <int K1_, int LEVELS, bool CMUX>
__global__ void __cluster_dims__(NP, 1, 1)
__launch_bounds__(SN_THREADS, Small<K1_, LEVELS, CMUX>::MIN_BLOCKS)
blind_rotate_cluster_small_kernel(long long* out_g, const long long* in_g,
                                  const long long* __restrict__ ct1_g,
                                  const int* __restrict__ mask_g,
                                  const uint4* __restrict__ bsk,
                                  const int* __restrict__ key_index, long long set_words,
                                  const uint2* __restrict__ tw_fwd,
                                  const uint2* __restrict__ tw_inv,
                                  const long long* __restrict__ consts_g, int n_steps,
                                  int base_log) {
  using S = Small<K1_, LEVELS, CMUX>;
  constexpr int K1 = S::K1;
  constexpr int LOG_N = S::LOG_N;
  constexpr int N = S::N;
  constexpr int ROW = S::ROW;
  constexpr int ROWS = S::ROWS;
  constexpr int QUARTER = S::QUARTER;
  constexpr int LO = S::LO;
  constexpr int NT = SN_THREADS;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  extern __shared__ uint4 sn_smem[];
  __shared__ Consts c;
  __shared__ Consts one;
  u64* acc = (u64*)sn_smem;                     // (K1, N), the whole accumulator
  u32* keys = (u32*)(acc + K1 * N);             // BUFS key slices, 16-byte aligned
  u32* rows = keys + S::BUFS * S::KEY;          // (LEVELS K1, ROW) mod this prime
  u32* gath = rows + ROWS * ROW;                // (NP, QUARTER): this quarter's residues
  u64* base = (u64*)(gath + NP * QUARTER);      // CMUX: ct0 at this quarter
  const int tid = threadIdx.x;
  const size_t ct = blockIdx.x / NP;
  const long long* in_b = in_g + ct * K1 * N;
  long long* out_b = out_g + ct * K1 * N;
  const int* mask_b = CMUX ? nullptr : mask_g + ct * n_steps;
  const uint4* key_b = bsk + (key_index ? (size_t)key_index[ct] * (size_t)(set_words / 4) : 0);

  if (tid == 0) {
    load_consts(c, consts_g);
    one = c;
    one.p[0] = c.p[rank];
    one.pinv[0] = c.pinv[rank];
  }
  if constexpr (CMUX) {
    const long long* ct1_b = ct1_g + ct * K1 * N;
#pragma unroll 4
    for (int q = tid; q < K1 * N; q += NT) {
      const u64 c0 = (u64)in_b[q];
      acc[q] = (u64)ct1_b[q] - c0;
      const int own = q - rank * QUARTER;
      if ((unsigned)own < (unsigned)QUARTER) base[own] = c0;
    }
  } else {
    for (int q = tid; q < K1 * N; q += NT) acc[q] = (u64)in_b[q];
  }
  prefetch_key<S>(keys, key_b, 0, n_steps, rank);
  u64* acc_of[NP];                              // every block's copy
  u32* gath_of[NP];                             // every block's Garner inputs
#pragma unroll
  for (int r = 0; r < NP; ++r) {
    acc_of[r] = cluster.map_shared_rank(acc, r);
    gath_of[r] = cluster.map_shared_rank(gath, r);
  }
  cluster.sync();   // every block has started before any stores into it
  const u32 p = c.p[rank];
  const u32 pinv = c.pinv[rank];
  const uint2* twf = tw_fwd + (rank << LOG_N);
  const uint2* twi = tw_inv + (rank << LOG_N);

  for (int step = 0; step < n_steps; ++step) {
    const int a = CMUX ? 0 : mask_b[step];      // in [0, 2N)
    const int rot = a & (N - 1);
    const bool odd = ((a >> LOG_N) & 1) != 0;
    // two buffers: the next step's slice into the one step - 1 read
    if constexpr (S::BUFS == 2) prefetch_key<S>(keys, key_b, step + 1, n_steps, rank);

    // 1. task (lev, r, lo): acc X^a - acc (CMUX: ct1 - ct0) at
    // coefficients j = b 2^LO | lo of row r, level lev's signed digit, its
    // residue d + 2p and forward stages 0-3 in registers
    for (int q = tid; q < LEVELS * (K1 << LO); q += NT) {
      const int lev = q / (K1 << LO);
      const int r = (q >> LO) % K1;
      const int lo = q & ((1 << LO) - 1);
      const u64* A = acc + r * N;
      u32 v[16];
#pragma unroll
      for (int b = 0; b < 16; ++b) {
        const int j = (b << LO) | lo;
        u64 d;
        if constexpr (CMUX) {
          d = A[j];
        } else {
          u64 w = j < rot ? 0ull - A[j - rot + N] : A[j - rot];
          if (odd) w = 0ull - w;
          d = w - A[j];
        }
        int dig;
        if constexpr (LEVELS == 1) {
          dig = hi_word_digit((u32)(d >> 32), base_log);
        } else if (base_log * LEVELS <= 30) {  // the rounding reads the high word only
          int state = hi_decomposer_state((u32)(d >> 32), base_log, LEVELS);
          dig = hi_next_digit(state, base_log);
          for (int l = 0; l < lev; ++l) dig = hi_next_digit(state, base_log);
        } else {
          u64 state = decomposer_state(d, base_log, LEVELS);
          dig = (int)next_digit(state, base_log);
          for (int l = 0; l < lev; ++l) dig = (int)next_digit(state, base_log);
        }
        v[b] = lazy_digit_residue(dig, p);
      }
      lazy_forward_stages<4, LOG_N>(v, 0, 0, twf, p);
      u32* x = rows + (lev * K1 + r) * ROW + pad(lo);
#pragma unroll
      for (int b = 0; b < 16; ++b) x[pad(b << LO)] = v[b];
    }
    __syncthreads();

    // 2. forward stages 4-6
    lazy_pass<3, LOG_N, 1, NT, true>(rows, ROWS, 4, twf, one);
    if constexpr (S::BUFS == 2) {
      asm volatile("cp.async.wait_group 1;\n" ::);   // this step's slice has landed
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();

    // 3. task q, positions 4q .. 4q+3 of every row: forward stages 7-8,
    // the product with the step's slice (the l (k+1) products summed in
    // 64 bits, a reduction a four), inverse stages 0-1, written over rows
    // 0 .. K1-1 in [0, 2p)
    {
      const uint4* ks = (const uint4*)(keys + (step & (S::BUFS - 1)) * S::KEY);
      for (int q = tid; q < N / 4; q += NT) {
        const int at = pad(q * 4);              // pad(4q + e) = at + e
        u32 x[ROWS][4];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
#pragma unroll
          for (int e = 0; e < 4; ++e) x[r][e] = rows[r * ROW + at + e];
          lazy_forward_stages<2, LOG_N>(x[r], LOG_N - 2, q, twf, p);
#pragma unroll
          for (int e = 0; e < 4; ++e) x[r][e] = reduce_to(reduce_to(x[r][e], 2 * p), p);
        }
#pragma unroll
        for (int cc = 0; cc < K1; ++cc) {
          u64 sum[4] = {0, 0, 0, 0};
          u32 out[4] = {0, 0, 0, 0};
#pragma unroll
          for (int r = 0; r < ROWS; ++r) {
            const uint4 k = ks[(r * K1 + cc) * (N / 4) + q];
            sum[0] += (u64)x[r][0] * k.x;
            sum[1] += (u64)x[r][1] * k.y;
            sum[2] += (u64)x[r][2] * k.z;
            sum[3] += (u64)x[r][3] * k.w;
            if (r % 4 == 3 || r == ROWS - 1) {  // 4 p^2 < p 2^32: one reduction a four
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                out[e] = reduce_to(out[e] + redc_lazy(sum[e], p, pinv), 2 * p);
                sum[e] = 0;
              }
            }
          }
          lazy_inverse_stages<2, LOG_N>(out, 0, q, twi, p);
#pragma unroll
          for (int e = 0; e < 4; ++e) rows[cc * ROW + at + e] = out[e];
        }
      }
    }
    __syncthreads();
    // one buffer: the next step's slice into it, now that every read of it is done
    if constexpr (S::BUFS == 1) prefetch_key<S>(keys, key_b, step + 1, n_steps, rank);

    // 4. inverse stages 2-5; then 6-8 with N^-1, each canonical residue
    // stored into the Garner inputs of the block that owns its coefficient
    lazy_pass<4, LOG_N, 1, NT, false>(rows, K1, 2, twi, one);
    __syncthreads();
    for (int q = tid; q < K1 << (LOG_N - 3); q += NT) {
      constexpr int K0 = LOG_N - 3;
      const int cc = q >> K0;
      const int lo = q & ((1 << K0) - 1);
      const u32* x = rows + cc * ROW + pad(lo);
      u32 y[8];
#pragma unroll
      for (int b = 0; b < 8; ++b) y[b] = x[pad(b << K0)];
      lazy_inverse_stages<3, LOG_N>(y, K0, 0, twi, p);
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        const int g = cc * N + (lo | (b << K0));
        gath_of[g / QUARTER][rank * QUARTER + g % QUARTER] =
            mont_mul(reduce_to(y[b], p), c.ninv[rank], p, pinv);
      }
    }
    cluster.sync();   // every quarter's four residues have landed

    // 5. Garner on this block's quarter, the new words stored into every
    // block's copy of the accumulator (CMUX: ct0 + the product, to out)
    for (int q = tid; q < QUARTER; q += NT) {
      u32 dg[NP];
#pragma unroll
      for (int pi = 0; pi < NP; ++pi) dg[pi] = gath[pi * QUARTER + q];
      const int g = rank * QUARTER + q;
      if constexpr (CMUX) {
        out_b[g] = (long long)(base[q] + garner_signed<NP>(dg, c));
      } else {
        const u64 w = acc[g] + garner_signed<NP>(dg, c);
#pragma unroll
        for (int r = 0; r < NP; ++r) acc_of[r][g] = w;
      }
    }
    if constexpr (!CMUX) cluster.sync();   // every copy updated; every Garner input read
  }

  if constexpr (!CMUX) {
    for (int q = tid; q < QUARTER; q += NT) {
      out_b[rank * QUARTER + q] = (long long)acc[rank * QUARTER + q];
    }
  }
}

// The operands of a launch: the accumulators (in = out, in place) or, in
// the CMux mode, ct0 (in), ct1 and out.
struct Operands {
  long long* out;
  const long long* in;
  const long long* ct1;
};

template <int K1, int LEVELS, bool CMUX>
cudaError_t small_launch(Operands ops, const int* mask, const uint4* bsk, const int* key_index,
                         long long set_words, const uint2* tw_fwd, const uint2* tw_inv,
                         const long long* consts, int batch, int n_steps, int base_log,
                         cudaStream_t stream) {
  using S = Small<K1, LEVELS, CMUX>;
  auto kernel = blind_rotate_cluster_small_kernel<K1, LEVELS, CMUX>;
  static std::atomic<unsigned> sized{0};
  cudaError_t err = set_smem_once(kernel, S::SMEM, true, sized);
  if (err != cudaSuccess) return err;
  kernel<<<batch * NP, SN_THREADS, S::SMEM, stream>>>(ops.out, ops.in, ops.ct1, mask, bsk,
                                                      key_index, set_words, tw_fwd, tw_inv,
                                                      consts, n_steps, base_log);
  return cudaGetLastError();
}

template <int K1, int LEVELS, int LOG_N, bool CMUX>
cudaError_t cluster_launch(Operands ops, const int* mask, const uint4* bsk, const uint2* tw_fwd,
                           const uint2* tw_inv, const long long* consts, int batch,
                           int n_steps, int base_log, cudaStream_t stream) {
  using S = Cluster<K1, LEVELS, LOG_N>;
  auto kernel = blind_rotate_cluster_kernel<K1, LEVELS, LOG_N, CMUX>;
  static std::atomic<unsigned> sized{0};
  cudaError_t err = set_smem_once(kernel, S::SMEM, true, sized);
  if (err != cudaSuccess) return err;
  kernel<<<batch * NP, THREADS, S::SMEM, stream>>>(ops.out, ops.in, ops.ct1, mask, bsk, tw_fwd,
                                                   tw_inv, consts, n_steps, base_log);
  return cudaGetLastError();
}

// The clusters of NP blocks of threads threads the card holds at once for
// kernel at smem bytes a block (cudaOccupancyMaxActiveClusters), or minus
// the CUDA error.
template <class K>
int occupancy_of(K kernel, int smem, int threads) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(NP * 64, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, (void*)kernel, &cfg);
  return err != cudaSuccess ? -(int)err : n;
}

template <int K1, int LEVELS, int LOG_N, bool CMUX>
int cluster_occupancy() {
  if constexpr (LOG_N == SN_LOG_N) {
    return occupancy_of(blind_rotate_cluster_small_kernel<K1, LEVELS, CMUX>,
                        Small<K1, LEVELS, CMUX>::SMEM, SN_THREADS);
  } else {
    return occupancy_of(blind_rotate_cluster_kernel<K1, LEVELS, LOG_N, CMUX>,
                        Cluster<K1, LEVELS, LOG_N>::SMEM, THREADS);
  }
}

// Calls fn.template run<K1, LEVELS, LOG_N>() on the instance of a shape
// that cluster_shape takes.
template <class F>
int by_shape(int k1, int log_n, int levels, const F& fn) {
  if (log_n == SN_LOG_N) {
    switch (k1) {
      case 3: return fn.template run<3, 1, SN_LOG_N>();
      case 4: return fn.template run<4, 1, SN_LOG_N>();
      case 5: return fn.template run<5, 1, SN_LOG_N>();
      default: break;
    }
    switch (levels) {
      case 1: return fn.template run<CL_K1, 1, SN_LOG_N>();
      case 2: return fn.template run<CL_K1, 2, SN_LOG_N>();
      case 3: return fn.template run<CL_K1, 3, SN_LOG_N>();
      default: return fn.template run<CL_K1, 4, SN_LOG_N>();
    }
  }
  if (log_n == CL_LOG_N) {
    return levels == 1 ? fn.template run<CL_K1, 1, CL_LOG_N>()
                       : fn.template run<CL_K1, 2, CL_LOG_N>();
  }
  switch (k1) {
    case 3: return fn.template run<3, 1, CM_LOG_N>();
    case 4: return fn.template run<4, 1, CM_LOG_N>();
    case 5: return fn.template run<5, 1, CM_LOG_N>();
    case 6: return fn.template run<6, 1, CM_LOG_N>();
    case 7: return fn.template run<7, 1, CM_LOG_N>();
    default: return fn.template run<8, 1, CM_LOG_N>();
  }
}

struct Launch {
  Operands ops;
  const int* mask;
  const uint4* bsk;
  const int* key_index;     // the small-N kernel's key a ciphertext, or null
  long long set_words;
  const uint2* tw_fwd;
  const uint2* tw_inv;
  const long long* consts;
  int batch, n_steps, base_log;
  cudaStream_t stream;
  template <int K1, int LEVELS, int LOG_N>
  int run() const {
    if constexpr (LOG_N == SN_LOG_N) {
      return (int)small_launch<K1, LEVELS, false>(ops, mask, bsk, key_index, set_words, tw_fwd,
                                                  tw_inv, consts, batch, n_steps, base_log,
                                                  stream);
    } else {
      return (int)cluster_launch<K1, LEVELS, LOG_N, false>(ops, mask, bsk, tw_fwd, tw_inv,
                                                           consts, batch, n_steps, base_log,
                                                           stream);
    }
  }
};

// The CMux mode's launch: one step, the GGSW at bsk, no mask.  Its shapes
// (cmux_shape) have no N = 8192 instance.
struct CmuxLaunch {
  Operands ops;
  const uint4* ggsw;
  const uint2* tw_fwd;
  const uint2* tw_inv;
  const long long* consts;
  int batch, base_log;
  cudaStream_t stream;
  template <int K1, int LEVELS, int LOG_N>
  int run() const {
    if constexpr (LOG_N == SN_LOG_N) {
      return (int)small_launch<K1, LEVELS, true>(ops, nullptr, ggsw, nullptr, 0, tw_fwd, tw_inv,
                                                 consts, batch, 1, base_log, stream);
    } else if constexpr (LOG_N == CM_LOG_N) {
      return (int)cluster_launch<K1, LEVELS, LOG_N, true>(ops, nullptr, ggsw, tw_fwd, tw_inv,
                                                          consts, batch, 1, base_log, stream);
    } else {
      return (int)cudaErrorInvalidValue;
    }
  }
};

// The figures below of the rotation's instance or (cmux) of the CMux
// mode's, which has none at N = 8192.
struct Occupancy {
  bool cmux;
  template <int K1, int LEVELS, int LOG_N>
  int run() const {
    if constexpr (LOG_N == CL_LOG_N) {
      return cmux ? -1 : cluster_occupancy<K1, LEVELS, LOG_N, false>();
    } else {
      return cmux ? cluster_occupancy<K1, LEVELS, LOG_N, true>()
                  : cluster_occupancy<K1, LEVELS, LOG_N, false>();
    }
  }
};

struct MinBlocks {
  template <int K1, int LEVELS, int LOG_N>
  int run() const {
    if constexpr (LOG_N == SN_LOG_N) {
      return Small<K1, LEVELS>::MIN_BLOCKS;
    } else {
      return cluster_min_blocks(LOG_N);
    }
  }
};

struct Smem {
  bool cmux;
  template <int K1, int LEVELS, int LOG_N>
  int run() const {
    if constexpr (LOG_N == SN_LOG_N) {
      return cmux ? Small<K1, LEVELS, true>::SMEM : Small<K1, LEVELS>::SMEM;
    } else {
      return Cluster<K1, LEVELS, LOG_N>::SMEM;
    }
  }
};

}  // namespace

// acc (batch, k+1, N) u64, updated in place; mask (batch, n_steps) int32 in
// [0, 2N); bsk the exact key (n_steps, l, k+1, k+1, NP, N) u32 Montgomery,
// 16-byte aligned; tw_fwd, tw_inv the plan's Shoup twiddle pairs (NP, N);
// one cluster of NP blocks a ciphertext.  key_index null: one key for the
// whole batch (set_words 0).  key_index (batch,) int32: ciphertext b runs
// on the key at bsk + key_index[b] set_words words (set_words a multiple of
// 4), the CMux chain of ops/kernels.py cmux_chain; only at the shapes
// chain_shape takes.
extern "C" int tfhe_torch_blind_rotate_cluster(void* acc, const void* mask, const void* bsk,
                                               const void* key_index, long long set_words,
                                               const void* tw_fwd, const void* tw_inv,
                                               const void* consts, int batch, int n_steps,
                                               int k1, int log_n, int levels, int nprimes,
                                               int base_log, void* stream) {
  if (!cluster_shape(k1, log_n, levels, base_log) || nprimes != NP || batch < 1 ||
      n_steps < 1 || ((uintptr_t)bsk & 15) != 0 || set_words < 0 || set_words % 4 != 0 ||
      (key_index == nullptr ? set_words != 0 : !chain_shape(k1, log_n, levels, base_log))) {
    return (int)cudaErrorInvalidValue;
  }
  const Launch launch{{(long long*)acc, (const long long*)acc, nullptr}, (const int*)mask,
                      (const uint4*)bsk,
                      (const int*)key_index, set_words, (const uint2*)tw_fwd,
                      (const uint2*)tw_inv, (const long long*)consts, batch, n_steps,
                      base_log, (cudaStream_t)stream};
  return by_shape(k1, log_n, levels, launch);
}

// The clusters the card holds at once at a shape the kernel takes, and a
// block's dynamic shared memory (-1 at other shapes).
extern "C" int tfhe_torch_blind_rotate_cluster_occupancy(int k1, int log_n, int levels) {
  if (!cluster_shape(k1, log_n, levels, 1)) return -1;
  return by_shape(k1, log_n, levels, Occupancy{false});
}

extern "C" int tfhe_torch_blind_rotate_cluster_smem(int k1, int log_n, int levels) {
  if (!cluster_shape(k1, log_n, levels, 1)) return -1;
  return by_shape(k1, log_n, levels, Smem{false});
}

// The blocks an SM the kernel's instance at a shape is compiled for
// (__launch_bounds__), -1 at other shapes.
extern "C" int tfhe_torch_blind_rotate_cluster_min_blocks(int k1, int log_n, int levels) {
  if (!cluster_shape(k1, log_n, levels, 1)) return -1;
  return by_shape(k1, log_n, levels, MinBlocks{});
}

// K2's CMux entry on the cluster kernels (ops/kernels.py cmux, its "small"
// and "cluster" routes): out = ct0 + GGSW (x) (ct1 - ct0) for a batch
// sharing one GGSW, one step of the kernels above in their CMux mode.
// ct0, ct1, out (batch, k+1, N) u64, out may be ct0; ggsw (l, k+1, k+1, NP,
// N) u32 Montgomery NTT domain, 16-byte aligned (the exact key's layout of
// one step); at the shapes cmux_shape takes: every small-N shape, and
// 3 <= k+1 <= 8, l = 1 at N = 2048.
extern "C" int tfhe_torch_cmux_cluster(void* out, const void* ct0, const void* ct1,
                                       const void* ggsw, const void* tw_fwd, const void* tw_inv,
                                       const void* consts, int batch, int k1, int log_n,
                                       int levels, int nprimes, int base_log, void* stream) {
  if (!cmux_shape(k1, log_n, levels, base_log) || nprimes != NP || batch < 1 ||
      ((uintptr_t)ggsw & 15) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const CmuxLaunch launch{{(long long*)out, (const long long*)ct0, (const long long*)ct1},
                          (const uint4*)ggsw, (const uint2*)tw_fwd, (const uint2*)tw_inv,
                          (const long long*)consts, batch, base_log, (cudaStream_t)stream};
  return by_shape(k1, log_n, levels, launch);
}

// The CMux mode's instance at a shape cmux_shape takes: the clusters the
// card holds at once, and a block's dynamic shared memory (-1 elsewhere).
extern "C" int tfhe_torch_cmux_cluster_occupancy(int k1, int log_n, int levels) {
  if (!cmux_shape(k1, log_n, levels, 1)) return -1;
  return by_shape(k1, log_n, levels, Occupancy{true});
}

extern "C" int tfhe_torch_cmux_cluster_smem(int k1, int log_n, int levels) {
  if (!cmux_shape(k1, log_n, levels, 1)) return -1;
  return by_shape(k1, log_n, levels, Smem{true});
}
