// K3's exact rotation at the GPU multi-bit sets: a thread-block cluster a
// ciphertext, for sm_90a.
//
// Replaces: the key-bundle rotation tfhe_tpu/ops/server.py:425
// blind_rotate_multibit (which the TPU runs in XLA) at the shapes of
// V1_4_PARAM_GPU_MULTI_BIT_GROUP_2_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128
// (k+1 = 2, l = 1, N = 4096, g = 2, base 2^21) and
// V1_4_PARAM_GPU_MULTI_BIT_GROUP_3_MESSAGE_2_CARRY_2_KS_PBS_TUNIFORM_2M128
// (k+1 = 2, l = 2, N = 2048, g = 3, base 2^14), which the lazy exact kernel
// of csrc/blind_rotate_multibit.cu does not take.  Plain version:
// tfhe_tpu_torch/ops/server.py `blind_rotate_multibit`.
//
// Per group j of g mask elements, with the 2^g indicator GGSWs E_ju and the
// degrees d_ju (d_j0 = 0, ops/server.py multibit_switched_degrees):
//   acc <- EP( E_j0 + sum_{u>0} NTT(X^{d_ju}) . E_ju, acc )
// the product summed over the four CRT primes' residues and reconstructed
// mod 2^64 with Garner.
//
// What held the first design there (blind_rotate_multibit_kernel, one block
// of 512 threads a ciphertext on 32 of the 132 SMs at B = 32, fully reduced
// passes): the bundle, each key word a 4-byte load consumed at once by a
// fully reduced Montgomery product; a GROUP_2 round at B = 32 took 185 ms,
// GROUP_3's 109 ms (NVIDIA H100 80GB HBM3, 700 W).
//
// Design: a cluster of NP = 4 blocks of 256 threads a ciphertext, block
// rank p holding prime p, two blocks an SM (so B = 32 is one wave of
// clusters).  A block keeps in shared memory the decomposer states of the
// whole accumulator (one int a coefficient: base_log l <= 30, so a word's
// digits come from its high word alone, ntt_common.cuh
// hi_decomposer_state), the residues mod p of the l (k+1) digit rows and
// its prime's one-period monomial table psi^e, e < 2N: 99,328 B at
// GROUP_2, 66,560 B at GROUP_3.  The u64 accumulator itself is never
// stored: the group's product replaces it, so each new word is
// decomposed at once.  A group:
//   1. the first forward pass: each coefficient's digit from its state,
//      its residue d + 2p and forward stages 0-3 in registers;
//   2. the middle forward stages, ntt_common.cuh's lazy Shoup passes;
//   3. task q, positions 4q .. 4q+3 of its prime: the last two forward
//      stages, the bundle eff = E_0 + sum_u w_u E_u (16-byte key loads,
//      the monomials w_u from the table in shared memory, the products
//      summed in 64 bits with one reduction a four), the product with
//      the digits' transform, the first two inverse stages, written over
//      rows 0 .. k;
//   4. the middle inverse stages; the last three with N^-1, canonical;
//   5. cluster barrier; each block reconstructs its quarter of the
//      coefficients with Garner from the four blocks' residues (read
//      through distributed shared memory) and stores each new word's
//      decomposer state into all four blocks' copies (at the last group,
//      the word into the output); cluster barrier.
// Each block reads only its prime's quarter of a group's key; the 32
// clusters of a B = 32 round walk the groups together, so L2 serves the
// key (480 MB at GROUP_2, 610 MB at GROUP_3) about once from memory.

#include <cooperative_groups.h>

#include "ntt_common.cuh"

namespace cg = cooperative_groups;
using namespace ntt_common;

namespace {

constexpr int MC_THREADS = 256;
constexpr int MC_K1 = 2;

// The kernel's shapes (the wrapper routes by its own copy of this
// predicate, ops/kernels.py MULTIBIT_CLUSTER_SHAPES; the entry point
// refuses any other shape): k + 1 = 2 and base_log l <= 30, at N = 4096,
// l = 1, g = 2 (GPU GROUP_2) and N = 2048, l = 2, g = 3 (GPU GROUP_3).
__host__ __device__ constexpr bool mb_cluster_shape(int k1, int log_n, int levels, int grouping,
                                                    int base_log) {
  return k1 == MC_K1 && base_log >= 1 && levels >= 1 && base_log * levels <= 30 &&
         ((log_n == 12 && levels == 1 && grouping == 2) ||
          (log_n == 11 && levels == 2 && grouping == 3));
}

template <int LOG_N, int LEVELS, int NSUB>
struct Mb {
  static constexpr int K1 = MC_K1;
  static constexpr int N = 1 << LOG_N;
  static constexpr int ROW = N + N / 32;             // padded residue row
  static constexpr int ROWS = LEVELS * K1;           // digit rows (lev, r)
  static constexpr int ENTRIES = ROWS * K1;          // GGSW entries (lev, r, cc)
  static constexpr int QUARTER = K1 * N / NP;        // coefficients a block reconstructs
  static constexpr int LO = LOG_N - 4;               // the first pass takes stages 0-3
  static constexpr int FWD_MIDDLE = LOG_N - 6;       // stages between the first pass and the product's two
  static constexpr int INV_MIDDLE = LOG_N - 5;       // between the product's two and the last three
  static constexpr int PATTERN4 = ENTRIES * NP * N / 4;   // 16-byte words of a pattern's GGSW
  // the decomposer states (K1, N), the residue rows, the monomial table
  static constexpr int SMEM = K1 * N * 4 + ROWS * ROW * 4 + 2 * N * 4;
  static_assert(2 * (SMEM + 1024) <= 228 * 1024, "two blocks an SM");
};

// Lazy passes over stages K0 .. K0 + M - 1 of the first rows rows, in
// ceil(M / 4) passes of near-equal length, a block barrier after each.
template <int K0, int M, int LOG_N, bool FORWARD>
__device__ __forceinline__ void middle_passes(u32* rows, int nrows, const uint2* __restrict__ tw,
                                              const Consts& one) {
  if constexpr (M > 0) {
    constexpr int PASSES = (M + 3) / 4;
    constexpr int S = (M + PASSES - 1) / PASSES;
    lazy_pass<S, LOG_N, 1, MC_THREADS, FORWARD>(rows, nrows, K0, tw, one);
    __syncthreads();
    middle_passes<K0 + S, M - S, LOG_N, FORWARD>(rows, nrows, tw, one);
  }
}

__device__ __forceinline__ u32 lane4(const uint4& k, int e) {
  return e == 0 ? k.x : e == 1 ? k.y : e == 2 ? k.z : k.w;
}

// acc (batch, 2, N) u64, updated in place; deg (batch, n_groups, NSUB)
// int32 in [0, 2N); bsk the exact key (n_groups, NSUB, l, 2, 2, NP, N) u32
// Montgomery, 16-byte aligned; tw_fwd, tw_inv the plan's Shoup pairs (NP,
// N); mono the (NP, 4N) monomial table (ops/server.py monomial_table).
template <int LOG_N, int LEVELS, int NSUB>
__global__ void __cluster_dims__(NP, 1, 1) __launch_bounds__(MC_THREADS, 2)
blind_rotate_multibit_cluster_kernel(long long* __restrict__ acc_g, const int* __restrict__ deg_g,
                                     const uint4* __restrict__ bsk,
                                     const uint2* __restrict__ tw_fwd,
                                     const uint2* __restrict__ tw_inv,
                                     const u32* __restrict__ mono,
                                     const long long* __restrict__ consts_g, int n_groups,
                                     int base_log) {
  using S = Mb<LOG_N, LEVELS, NSUB>;
  constexpr int K1 = S::K1;
  constexpr int N = S::N;
  constexpr int ROW = S::ROW;
  constexpr int ROWS = S::ROWS;
  constexpr int QUARTER = S::QUARTER;
  constexpr int LO = S::LO;
  constexpr int NT = MC_THREADS;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();   // this block's prime
  extern __shared__ uint4 mc_smem[];
  __shared__ Consts c;                          // the four primes (Garner)
  __shared__ Consts one;                        // the lazy passes read their prime from p[0]
  __shared__ int d_s[NSUB];                     // the group's degrees
  int* st = (int*)mc_smem;                      // (K1, N) decomposer states, the whole accumulator
  u32* rows = (u32*)(st + K1 * N);              // (LEVELS K1, ROW) mod this prime
  u32* mono_s = rows + ROWS * ROW;              // (2N) this prime's monomials
  const int tid = threadIdx.x;
  const int ct = blockIdx.x / NP;
  long long* acc_b = acc_g + (size_t)ct * K1 * N;
  const int* deg_b = deg_g + (size_t)ct * n_groups * NSUB;

  if (tid == 0) {
    load_consts(c, consts_g);
    one = c;
    one.p[0] = c.p[rank];
    one.pinv[0] = c.pinv[rank];
  }
  for (int q = tid; q < K1 * N; q += NT) {
    st[q] = hi_decomposer_state((u32)((u64)acc_b[q] >> 32), base_log, LEVELS);
  }
  for (int q = tid; q < 2 * N; q += NT) mono_s[q] = __ldg(mono + (size_t)rank * 4 * N + q);
  int* st_of[NP];                               // every block's states
  const u32* rows_of[NP];                       // every block's residues
#pragma unroll
  for (int r = 0; r < NP; ++r) {
    st_of[r] = cluster.map_shared_rank(st, r);
    rows_of[r] = cluster.map_shared_rank(rows, r);
  }
  __syncthreads();
  const u32 p = c.p[rank];
  const u32 pinv = c.pinv[rank];
  const uint2* twf = tw_fwd + (rank << LOG_N);
  const uint2* twi = tw_inv + (rank << LOG_N);

  for (int grp = 0; grp < n_groups; ++grp) {
    if (tid < NSUB) d_s[tid] = deg_b[grp * NSUB + tid];

    // 1. task (lev, r, lo): level lev's signed digit of row r's
    // coefficients j = b 2^LO | lo from their states, the residues d + 2p
    // and forward stages 0-3 in registers
    for (int q = tid; q < LEVELS * (K1 << LO); q += NT) {
      const int lev = q / (K1 << LO);
      const int r = (q >> LO) % K1;
      const int lo = q & ((1 << LO) - 1);
      const int* A = st + r * N;
      u32 v[16];
#pragma unroll
      for (int b = 0; b < 16; ++b) {
        int state = A[(b << LO) | lo];
        int dig = hi_next_digit(state, base_log);
        for (int l = 0; l < lev; ++l) dig = hi_next_digit(state, base_log);
        v[b] = lazy_digit_residue(dig, p);
      }
      lazy_forward_stages<4, LOG_N>(v, 0, 0, twf, p);
      u32* x = rows + (lev * K1 + r) * ROW + pad(lo);
#pragma unroll
      for (int b = 0; b < 16; ++b) x[pad(b << LO)] = v[b];
    }
    __syncthreads();

    // 2. forward stages 4 .. LOG_N - 3
    middle_passes<4, S::FWD_MIDDLE, LOG_N, true>(rows, ROWS, twf, one);

    // 3. task q, positions 4q .. 4q+3 of every row: the last two forward
    // stages, the bundle of each entry and its product with the digits'
    // transform (the l (k+1) products summed in 64 bits, a reduction a
    // four), inverse stages 0-1, written over rows 0 .. K1-1 in [0, 2p)
    const uint4* gkey = bsk + (size_t)grp * NSUB * S::PATTERN4;
    for (int q = tid; q < N / 4; q += NT) {
      const int at = pad(q * 4);                // pad(4q + e) = at + e
      u32 x[ROWS][4];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
#pragma unroll
        for (int e = 0; e < 4; ++e) x[r][e] = rows[r * ROW + at + e];
        lazy_forward_stages<2, LOG_N>(x[r], LOG_N - 2, q, twf, p);
#pragma unroll
        for (int e = 0; e < 4; ++e) x[r][e] = reduce_to(reduce_to(x[r][e], 2 * p), p);
      }
      // NTT(X^d)[t] = psi^{(2 br(t) + 1) d mod 2N} (psi has order 2N; the
      // product may wrap: 2N divides 2^32)
      u32 w[NSUB][4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const u32 odd = 2u * (__brev((u32)(4 * q + e)) >> (32 - LOG_N)) + 1u;
#pragma unroll
        for (int u = 1; u < NSUB; ++u) w[u][e] = mono_s[(odd * (u32)d_s[u]) & (2 * N - 1)];
      }
#pragma unroll
      for (int cc = 0; cc < K1; ++cc) {
        u64 sum[4] = {0, 0, 0, 0};
        u32 out[4] = {0, 0, 0, 0};
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const uint4* kp = gkey + (size_t)((r * K1 + cc) * NP + rank) * (N / 4) + q;
          const uint4 k0 = __ldg(kp);
          u32 eff[4] = {k0.x, k0.y, k0.z, k0.w};
          u64 bs[4] = {0, 0, 0, 0};
#pragma unroll
          for (int u = 1; u < NSUB; ++u) {
            const uint4 k = __ldg(kp + (size_t)u * S::PATTERN4);
#pragma unroll
            for (int e = 0; e < 4; ++e) bs[e] += (u64)w[u][e] * lane4(k, e);
            if (u % 4 == 0 || u == NSUB - 1) {  // 4 p^2 < p 2^32: one reduction a four
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                eff[e] = reduce_to(eff[e] + redc_lazy(bs[e], p, pinv), 2 * p);
                bs[e] = 0;
              }
            }
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) sum[e] += (u64)x[r][e] * reduce_to(eff[e], p);
          if (r % 4 == 3 || r == ROWS - 1) {
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
    __syncthreads();

    // 4. inverse stages 2 .. LOG_N - 4; the last three with N^-1,
    // canonical residues in place
    middle_passes<2, S::INV_MIDDLE, LOG_N, false>(rows, K1, twi, one);
    for (int q = tid; q < K1 << (LOG_N - 3); q += NT) {
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

    // 5. Garner on this block's quarter from the four blocks' residues;
    // each new word's states into every block's copy (the word itself out
    // at the last group)
    const bool last = grp == n_groups - 1;
    for (int q = tid; q < QUARTER; q += NT) {
      const int g = rank * QUARTER + q;
      const int at = (g >> LOG_N) * ROW + pad(g & (N - 1));
      u32 dg[NP];
#pragma unroll
      for (int pi = 0; pi < NP; ++pi) dg[pi] = rows_of[pi][at];
      const u64 word = garner_signed<NP>(dg, c);
      if (last) {
        acc_b[g] = (long long)word;
      } else {
        const int state = hi_decomposer_state((u32)(word >> 32), base_log, LEVELS);
#pragma unroll
        for (int r = 0; r < NP; ++r) st_of[r][g] = state;
      }
    }
    cluster.sync();   // every copy updated; every residue read
  }
}

template <int LOG_N, int LEVELS, int NSUB>
cudaError_t mc_launch(long long* acc, const int* deg, const uint4* bsk, const uint2* tw_fwd,
                      const uint2* tw_inv, const u32* mono, const long long* consts, int batch,
                      int n_groups, int base_log, cudaStream_t stream) {
  using S = Mb<LOG_N, LEVELS, NSUB>;
  auto kernel = blind_rotate_multibit_cluster_kernel<LOG_N, LEVELS, NSUB>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  kernel<<<batch * NP, MC_THREADS, S::SMEM, stream>>>(acc, deg, bsk, tw_fwd, tw_inv, mono, consts,
                                                      n_groups, base_log);
  return cudaGetLastError();
}

template <int LOG_N, int LEVELS, int NSUB>
int mc_occupancy() {
  using S = Mb<LOG_N, LEVELS, NSUB>;
  auto kernel = blind_rotate_multibit_cluster_kernel<LOG_N, LEVELS, NSUB>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(NP * 64, 1, 1);
  cfg.blockDim = dim3(MC_THREADS, 1, 1);
  cfg.dynamicSmemBytes = S::SMEM;
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, (void*)kernel, &cfg);
  return err != cudaSuccess ? -(int)err : n;
}

}  // namespace

// acc (batch, 2, N) u64, updated in place; deg (batch, n_groups, 2^g)
// int32; bsk (n_groups, 2^g, l, 2, 2, NP, N) u32 Montgomery, 16-byte
// aligned; tw_fwd, tw_inv the plan's Shoup twiddle pairs (NP, N); mono
// the (NP, 4N) monomial table; one cluster of NP blocks a ciphertext.
extern "C" int tfhe_torch_blind_rotate_multibit_cluster(void* acc, const void* deg,
                                                        const void* bsk, const void* tw_fwd,
                                                        const void* tw_inv, const void* mono,
                                                        const void* consts, int batch,
                                                        int n_groups, int grouping, int k1,
                                                        int log_n, int levels, int nprimes,
                                                        int base_log, void* stream) {
  if (!mb_cluster_shape(k1, log_n, levels, grouping, base_log) || nprimes != NP ||
      batch < 1 || n_groups < 1 || ((uintptr_t)bsk & 15) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  if (log_n == 12) {
    return (int)mc_launch<12, 1, 4>((long long*)acc, (const int*)deg, (const uint4*)bsk,
                                    (const uint2*)tw_fwd, (const uint2*)tw_inv,
                                    (const u32*)mono, (const long long*)consts, batch, n_groups,
                                    base_log, st);
  }
  return (int)mc_launch<11, 2, 8>((long long*)acc, (const int*)deg, (const uint4*)bsk,
                                  (const uint2*)tw_fwd, (const uint2*)tw_inv, (const u32*)mono,
                                  (const long long*)consts, batch, n_groups, base_log, st);
}

extern "C" int tfhe_torch_blind_rotate_multibit_cluster_shape(int k1, int log_n, int levels,
                                                              int grouping, int base_log) {
  return mb_cluster_shape(k1, log_n, levels, grouping, base_log) ? 1 : 0;
}

// A block's dynamic shared memory and the clusters of NP blocks the card
// holds at once (cudaOccupancyMaxActiveClusters, or minus the CUDA error)
// at a shape the kernel takes; -1 elsewhere.
extern "C" int tfhe_torch_blind_rotate_multibit_cluster_smem(int log_n, int levels, int grouping) {
  if (!mb_cluster_shape(MC_K1, log_n, levels, grouping, 1)) return -1;
  return log_n == 12 ? Mb<12, 1, 4>::SMEM : Mb<11, 2, 8>::SMEM;
}

extern "C" int tfhe_torch_blind_rotate_multibit_cluster_occupancy(int log_n, int levels,
                                                                  int grouping) {
  if (!mb_cluster_shape(MC_K1, log_n, levels, grouping, 1)) return -1;
  return log_n == 12 ? mc_occupancy<12, 1, 4>() : mc_occupancy<11, 2, 8>();
}
