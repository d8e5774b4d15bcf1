// K8: the extended blind rotation, for sm_90a.
//
// Replaces: tfhe_tpu/core/experimental.py:306 `extended_blind_rotate` (a
// lax.scan of XLA external products: tfhe_tpu has no Pallas kernel for it;
// lwe_extended_programmable_bootstrapping.rs:338-418, eprint 2025/2214).
// Generalises tfhe_tpu/ops/pallas_ntt.py:296 `build_cmux_step` to E
// slots.  Plain version: tfhe_tpu_torch/ops/server.py
// `blind_rotate_extended`.
//
// A LUT of N E coefficients is evaluated with the size-N bootstrap key: a
// ciphertext's accumulator lives as E interleaved (k+1, N) accumulators
// (slot j holds coefficients j, j+E, ...).  For each mask element a_i in
// [0, 2NE) and each slot j:
//   rotated_j = acc_{(j - a_i) mod E} * X^((E + a_i - 1 - j) >> log E)
//   acc_j    += GGSW_i (x) (rotated_j - acc_j)
// the degree lies in [0, 2N] (the negacyclic sign flips past N; 2N is
// the identity), and the external product is K2's exact one: the signed
// digits' residues on the four CRT primes, forward NTTs, the product with
// GGSW_i, inverse NTTs, N^-1 and Garner.
//
// What bounds it on the H100: 32-bit integer issue, as K2's exact kernels:
// E times the work of a classic rotation (a step of a slot at the 2_2
// shape is 8 forward and 8 inverse NTTs of N = 2048, 16 N key products and
// 2 N Garner reconstructions); the key (262 KB a step) comes from L2.
//
// The slots' gather crosses slots, so the E slots of a ciphertext must see
// each other's previous accumulators: a thread-block cluster of E blocks
// (E <= 8, the portable cluster size), block rank j holding slot j, reads
// its source slot's accumulator through distributed shared memory
// (cluster.map_shared_rank).  Two kernels, routed by shape in ops/kernels.py
// (K8_LAZY_SHAPE, mirrored by extended_lazy_shape below; each entry point
// refuses the other's shapes):
//
// The lazy kernel (blind_rotate_extended_lazy_kernel), at K2's lazy exact
// shape: k+1 = 2, l = 1, N = 2048, base_log <= 30 (every 2_2 set).  A
// block holds SB <= 2 slots of one ciphertext (each slot's (2, N) u64
// accumulator and 4-prime residue rows: 100,352 B at SB = 1, 200,704 B at
// SB = 2), a cluster of E / SB blocks a ciphertext.  A step is K2's lazy
// exact kernel's six passes (csrc/blind_rotate.cu, lazy Shoup butterflies
// of ntt_common.cuh): the first forward pass fused with the gather of the
// source slot (j - a) mod E, the negacyclic rotation by a degree in [0,
// 2N], the difference with the slot's accumulator, the one-level digit
// from the high word and stages 0-3 in registers; the last forward pass
// fused with the key product on 16-byte key loads, which a block's slots
// share (every slot runs the same GGSW a step); the last inverse pass
// fused with N^-1, Garner and the accumulation.  Synchronisation: at SB =
// 1 a block keeps two copies of its slot's accumulator (133,120 B, still
// one block an SM): step s reads the source slots from copy s mod 2 and
// writes the sums into the other, so one full cluster barrier a step,
// after the writes, orders them before the next step's reads, and no
// block overwrites what another may still read.  At SB = 2 a second copy
// does not fit (266,240 B): the accumulators are overwritten in place, so
// no block may write them before every block of the cluster has read
// them: the cluster barrier is split, arrived at after the first pass's
// reads and waited for only before the last inverse pass's writes, so the
// transforms between hide it, and the full barrier follows the writes.
// (One copy at SB = 1 took 0.3-1.2 % longer at every E on the H100:
// tools/rotation_probe.py, PERF.md row 0l.)  The slots a
// block (SB = 1 or 2) are chosen in ops/kernels.py extended_slots from the
// batch, E and the clusters the card holds at once: a cluster of 4 blocks
// of 100 KB or more fits only 30 times on the H100's 132 SMs (its clusters
// stay within a GPC), so at B = 64 and E = 4 SB = 2 makes 64 clusters of 2
// blocks, one wave, where SB = 1 would take three.
//
// The generic kernel (blind_rotate_extended_kernel), the first design,
// at every other shape that K2's generic exact kernel takes (k+1 <= 5, l <=
// 8, one block's shared memory): block rank j keeps slot j's (k+1, N) u64
// accumulator and the residues of the l (k+1) digit polynomials in shared
// memory (K2's generic layout).  A step: every block reads its source
// slot's accumulator, forms rotated - acc and its digit residues; cluster
// barrier; forward NTTs (ntt_common.cuh's exact passes), the key product,
// inverse NTTs, Garner into the accumulator; cluster barrier.  All n steps
// run in one launch in both kernels.

#include <cooperative_groups.h>

#include "ntt_common.cuh"

namespace cg = cooperative_groups;
using namespace ntt_common;

namespace {

constexpr int EX_MAXK1 = 5;          // k + 1 <= 5 (ops/kernels.py GENERIC_MAX_K1)
constexpr int EX_MAX_LEVELS = 8;
constexpr int EX_MAX_LOG_E = 3;      // E <= 8 (ops/kernels.py K8_FACTORS)
constexpr int EX_SMEM_LIMIT = 232448;

// The product with one GGSW: rows cc < k+1 of res get sum_{lev, r}
// res[(lev, r)] . ggsw[lev][r][cc] in the NTT domain, in place (a thread
// reads every row of its positions before it writes them).
__device__ __forceinline__ void ggsw_product(u32* res, const u32* __restrict__ ggsw, int k1,
                                             int levels, int log_n, int row, const Consts& c) {
  const int n_poly = 1 << log_n;
  for (int q = threadIdx.x; q < NP * n_poly; q += THREADS) {
    const int pi = q >> log_n;
    const int j = q & (n_poly - 1);
    const int at = pi * row + pad(j);
    const u32 p = c.p[pi];
    const u32 pinv = c.pinv[pi];
    u32 out[EX_MAXK1];
#pragma unroll
    for (int cc = 0; cc < EX_MAXK1; ++cc) out[cc] = 0u;
    for (int r = 0; r < levels * k1; ++r) {
      const u32 x = res[r * NP * row + at];
      const u32* krow = ggsw + ((size_t)r * k1 * NP + pi) * n_poly + j;
#pragma unroll
      for (int cc = 0; cc < EX_MAXK1; ++cc) {
        if (cc < k1) {
          out[cc] = add_mod(out[cc], mont_mul(x, __ldg(krow + (size_t)cc * NP * n_poly), p, pinv),
                            p);
        }
      }
    }
#pragma unroll
    for (int cc = 0; cc < EX_MAXK1; ++cc) {
      if (cc < k1) res[cc * NP * row + at] = out[cc];
    }
  }
}

__global__ void __launch_bounds__(THREADS, 2)
blind_rotate_extended_kernel(long long* __restrict__ acc_g, const int* __restrict__ mask_g,
                             const u32* __restrict__ bsk, const u32* __restrict__ psi,
                             const u32* __restrict__ psi_inv,
                             const long long* __restrict__ consts_g, int n_steps, int k1,
                             int log_n, int levels, int base_log, int log_e) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ u64 ex_smem[];
  __shared__ Consts c;
  const int e = 1 << log_e;
  const int slot = (int)cluster.block_rank();   // blockIdx.x mod E
  const int n_poly = 1 << log_n;
  const int row = padded_len(n_poly);
  const int coeffs = k1 * n_poly;
  u64* acc = ex_smem;                           // (k1, N): this slot
  u32* res = (u32*)(ex_smem + coeffs);          // (levels, k1, NP, row)
  const int tid = threadIdx.x;
  long long* acc_b = acc_g + (size_t)blockIdx.x * coeffs;   // (B, E, k1, N)
  const int* mask_b = mask_g + (size_t)(blockIdx.x >> log_e) * n_steps;

  if (tid == 0) load_consts(c, consts_g);
  for (int q = tid; q < coeffs; q += THREADS) acc[q] = (u64)acc_b[q];
  cluster.sync();   // constants loaded; every slot loaded before any is read

  const int level_stride = k1 * NP * row;
  const size_t step_words = (size_t)levels * k1 * k1 * NP * n_poly;
  for (int step = 0; step < n_steps; ++step) {
    const int a = mask_b[step];                 // in [0, 2 N E)
    const int src = (slot - a) & (e - 1);       // (j - a) mod E
    const int deg = (e + a - 1 - slot) >> log_e;   // in [0, 2N]
    const int rot = deg & (n_poly - 1);
    const bool odd = ((deg >> log_n) & 1) != 0;
    const u64* from = cluster.map_shared_rank(acc, src);

    // 1. rotated - acc from the source slot; signed digits; residues
    for (int q = tid; q < coeffs; q += THREADS) {
      const int cpoly = q >> log_n;
      const int j = q & (n_poly - 1);
      u64 v = j < rot ? 0ull - from[q - rot + n_poly] : from[q - rot];
      if (odd) v = 0ull - v;
      write_digit_residues(res + cpoly * NP * row + pad(j), v - acc[q], base_log, levels,
                           level_stride, row, c);
    }
    cluster.sync();   // every slot's reads of this step are done

    // 2. forward NTTs; 3. the product with GGSW_step; 4. inverse NTTs
    forward_ntt(res, levels * k1 * NP, log_n, row, psi, c);
    ggsw_product(res, bsk + (size_t)step * step_words, k1, levels, log_n, row, c);
    __syncthreads();
    inverse_ntt(res, k1 * NP, log_n, row, psi_inv, c);

    // 5. N^-1, Garner, accumulate
    for (int q = tid; q < coeffs; q += THREADS) {
      const int cpoly = q >> log_n;
      acc[q] += garner_u64(res + cpoly * NP * row + pad(q & (n_poly - 1)), row, c);
    }
    cluster.sync();   // every slot updated before the next step reads it
  }

  for (int q = tid; q < coeffs; q += THREADS) acc_b[q] = (long long)acc[q];
}

// ---------------------------------------------------------------------------
// The lazy kernel: k+1 = 2, l = 1, N = 2048, base_log <= 30.
// ---------------------------------------------------------------------------

constexpr int XL_LOG_N = 11;
constexpr int XL_N = 1 << XL_LOG_N;
constexpr int XL_K1 = 2;
constexpr int XL_ROW = XL_N + XL_N / 32;

// The lazy kernel's shape (ops/kernels.py K8_LAZY_SHAPE): the digits
// |d| <= 2^29 of one level come from the high word (hi_word_digit).
__host__ __device__ constexpr bool extended_lazy_shape(int k1, int log_n, int levels,
                                                       int base_log) {
  return k1 == XL_K1 && log_n == XL_LOG_N && levels == 1 && base_log >= 1 && base_log <= 30;
}

// A block of the lazy kernel holds slots j SB .. j SB + SB - 1 (j its
// cluster rank) of ciphertext g (its cluster); a cluster has E / SB
// blocks.  Every slot runs the same GGSW a step, so a block's SB slots
// share each key load.  BUFS copies of the accumulators: two where they
// fit.
template <int SB>
struct ExLazy {
  static constexpr int ROWS = SB * XL_K1 * NP;    // residue rows (s, r, prime)
  static constexpr int ACC = SB * XL_K1 * XL_N;   // the slots' accumulators, u64
  static constexpr int BUFS = SB == 1 ? 2 : 1;
  static constexpr int SMEM = ROWS * XL_ROW * 4 + BUFS * ACC * 8;   // 133,120 B; 200,704 B
  static_assert(SB == 1 || SB == 2,
                "three slots' rows and accumulators pass a block's shared memory");
};

// The split cluster barrier (barrier.cluster.arrive has release and
// barrier.cluster.wait acquire semantics): every thread of the cluster's
// blocks arrives, and a wait returns once all have arrived.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Stages 0-3 of the forward transforms fused with the gather.  Task (s, r,
// lo) owns coefficients j = b 2^7 | lo, b < 16, of row r of the block's
// slot s (the ciphertext's slot rank SB + s): with a = *mask in [0, 2 N E)
// it reads the source slot (slot - a) mod E (a slot of this block or,
// through distributed shared memory, of another block of the cluster),
// rotates it
// by the degree (E + a - 1 - slot) >> log E in [0, 2N], subtracts the
// slot's accumulator in u64, takes each word's one-level signed digit from
// its high word, and for each prime the residues d + 2p and four lazy
// stages in registers, stored once.
template <int SB>
__device__ __forceinline__ void extended_first_forward(u32* res, u64* acc,
                                                       const int* __restrict__ mask,
                                                       int base_log, int rank, int log_e,
                                                       const uint2* __restrict__ tw,
                                                       const Consts& c) {
  constexpr int LO = XL_LOG_N - 4;
  cg::cluster_group cluster = cg::this_cluster();
  const int e = 1 << log_e;
  const int a = __ldg(mask);
  for (int q = threadIdx.x; q < (SB * XL_K1) << LO; q += THREADS) {
    const int row = q >> LO;                    // s K1 + r
    const int lo = q & ((1 << LO) - 1);
    const int slot = rank * SB + row / XL_K1;
    const int src = (slot - a) & (e - 1);       // (slot - a) mod E
    const int deg = (e + a - 1 - slot) >> log_e;
    const int rot = deg & (XL_N - 1);
    const bool odd = (deg >> XL_LOG_N) & 1;
    const u64* A = acc + row * XL_N;
    const int src_rank = src / SB;
    const int src_row = src % SB * XL_K1 + row % XL_K1;
    const u64* F = (src_rank == rank ? acc : cluster.map_shared_rank(acc, src_rank)) +
                   src_row * XL_N;
    int dig[16];
#pragma unroll
    for (int b = 0; b < 16; ++b) {
      const int j = (b << LO) | lo;
      u64 v = j < rot ? 0ull - F[j - rot + XL_N] : F[j - rot];
      if (odd) v = 0ull - v;
      dig[b] = hi_word_digit((u32)((v - A[j]) >> 32), base_log);
    }
    u32* rows = res + row * NP * XL_ROW + pad(lo);   // pad splits, as in lazy_pass
#pragma unroll
    for (int pi = 0; pi < NP; ++pi) {
      const u32 p = c.p[pi];
      u32 v[16];
#pragma unroll
      for (int b = 0; b < 16; ++b) v[b] = lazy_digit_residue(dig[b], p);
      lazy_forward_stages<4, XL_LOG_N>(v, 0, 0, tw + (pi << XL_LOG_N), p);
#pragma unroll
      for (int b = 0; b < 16; ++b) rows[pi * XL_ROW + pad(b << LO)] = v[b];
    }
  }
}

// Cluster g of E / SB blocks, rank j: slots j SB .. j SB + SB - 1 of
// ciphertext g; log_c = log2(E / SB).
template <int SB>
__global__ void __launch_bounds__(THREADS, 1)
blind_rotate_extended_lazy_kernel(long long* __restrict__ acc_g,
                                  const int* __restrict__ mask_g,
                                  const uint4* __restrict__ bsk,
                                  const uint2* __restrict__ tw_fwd,
                                  const uint2* __restrict__ tw_inv,
                                  const long long* __restrict__ consts_g, int n_steps,
                                  int base_log, int log_e) {
  using S = ExLazy<SB>;
  constexpr int STEP = XL_K1 * XL_K1 * NP * XL_N / 4;   // 16-byte words of a step's GGSW
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ u64 xl_smem[];
  __shared__ Consts c;
  const int rank = (int)cluster.block_rank();
  const int log_c = log_e - (SB == 2);
  const int group = blockIdx.x >> log_c;
  u64* acc = xl_smem;                           // (BUFS, SB, K1, N)
  u32* res = (u32*)(xl_smem + S::BUFS * S::ACC);   // (ROWS, ROW)
  const int tid = threadIdx.x;
  const int* mask_b = mask_g + (size_t)group * n_steps;
  // acc_g (B, E, K1, N): this block's slots rank SB .. rank SB + SB - 1
  long long* acc_b = acc_g + (((size_t)group << log_e) + rank * SB) * (XL_K1 * XL_N);
  if (tid == 0) load_consts(c, consts_g);
  for (int q = tid; q < S::ACC; q += THREADS) acc[q] = (u64)acc_b[q];
  cluster.sync();   // constants loaded; every slot loaded before any is read

  for (int step = 0; step < n_steps; ++step) {
    u64* cur = acc + (step % S::BUFS) * S::ACC;
    u64* nxt = acc + ((step + 1) % S::BUFS) * S::ACC;
    extended_first_forward<SB>(res, cur, mask_b + step, base_log, rank, log_e, tw_fwd, c);
    __syncthreads();
    if (S::BUFS == 1) cluster_arrive();   // this block's reads of the slots are done
    lazy_pass<4, XL_LOG_N, NP, THREADS, true>(res, S::ROWS, 4, tw_fwd, c);
    __syncthreads();
    const uint4* skey = bsk + (size_t)step * STEP;
    for (int q = tid; q < SB * NP * (XL_N / 8); q += THREADS) {
      exact_key_product<SB, XL_LOG_N>(res, q, skey, tw_fwd, c);
    }
    __syncthreads();
    lazy_pass<4, XL_LOG_N, NP, THREADS, false>(res, S::ROWS, 0, tw_inv, c);
    __syncthreads();
    lazy_pass<4, XL_LOG_N, NP, THREADS, false>(res, S::ROWS, 4, tw_inv, c);
    __syncthreads();
    if (S::BUFS == 1) cluster_wait();   // every block's reads are done: overwrite
    exact_last_inverse<XL_LOG_N, XL_K1, NP, SB, THREADS, true>(res, nxt, tw_inv, c, cur);
    cluster.sync();     // every slot updated before the next step reads it
  }

  const u64* fin = acc + (n_steps % S::BUFS) * S::ACC;
  for (int q = tid; q < S::ACC; q += THREADS) acc_b[q] = (long long)fin[q];
}

// Calls fn.template run<SB>() for a block of sb slots (1 or 2).
template <class F>
int by_slots(int sb, const F& fn) {
  return sb == 2 ? fn.template run<2>() : fn.template run<1>();
}

// Launch kernel on blocks blocks of THREADS threads in clusters of `cluster`
// blocks, with smem bytes of dynamic shared memory.
template <class... P, class... A>
cudaError_t launch_clusters(void (*kernel)(P...), int blocks, int cluster, int smem,
                            cudaStream_t stream, A... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The clusters of `cluster` blocks of kernel with smem bytes each that the
// card can hold at once (cudaOccupancyMaxActiveClusters), or minus the
// CUDA error.
template <class... P>
int active_clusters(void (*kernel)(P...), int cluster, int smem) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster * 64, 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, (void*)kernel, &cfg);
  return err != cudaSuccess ? -(int)err : n;
}

}  // namespace

// acc (batch, E, k+1, N) u64, updated in place; mask (batch, n_steps)
// int32 in [0, 2 N E); bsk the exact key (n_steps, l, k+1, k+1, NP, N) u32
// Montgomery; psi, psi_inv the plan's twiddles; E = 2^log_e; smem the
// dynamic shared memory of a block, (k+1) N 8 + l (k+1) NP row 4 bytes
// (ops/kernels.py exact_smem_bytes).  A cluster of E blocks a ciphertext.
extern "C" int tfhe_torch_blind_rotate_extended(void* acc, const void* mask, const void* bsk,
                                                const void* psi, const void* psi_inv,
                                                const void* consts, int batch, int n_steps,
                                                int k1, int log_n, int levels, int base_log,
                                                int log_e, int smem, void* stream) {
  if (batch < 1 || n_steps < 1 || k1 < 1 || k1 > EX_MAXK1 || levels < 1 ||
      levels > EX_MAX_LEVELS || base_log < 1 || base_log * levels >= 64 || log_n < 1 ||
      log_n > 16 || log_e < 0 || log_e > EX_MAX_LOG_E ||
      smem != k1 * (1 << log_n) * 8 + levels * k1 * NP * padded_len(1 << log_n) * 4 ||
      smem > EX_SMEM_LIMIT) {
    return (int)cudaErrorInvalidValue;
  }
  return (int)launch_clusters(blind_rotate_extended_kernel, batch << log_e, 1 << log_e, smem,
                              (cudaStream_t)stream, (long long*)acc, (const int*)mask,
                              (const u32*)bsk, (const u32*)psi, (const u32*)psi_inv,
                              (const long long*)consts, n_steps, k1, log_n, levels, base_log,
                              log_e);
}

// The lazy kernel: acc (batch, E, 2, N) u64, updated in place; mask (batch,
// n_steps) int32 in [0, 2 N E); bsk the exact key (n_steps, 1, 2, 2, NP, N)
// u32 Montgomery, 16-byte aligned; tw_fwd, tw_inv the plan's Shoup twiddle
// pairs (NP, N); a block holds sb slots (1 or 2, sb <= E) of one
// ciphertext: a cluster of E / sb blocks a ciphertext.
namespace {

struct LazyLaunch {
  long long* acc;
  const int* mask;
  const uint4* bsk;
  const uint2* tw_fwd;
  const uint2* tw_inv;
  const long long* consts;
  int batch, n_steps, base_log, log_e;
  cudaStream_t stream;
  template <int SB>
  int run() const {
    const int log_c = log_e - (SB == 2);
    return (int)launch_clusters(blind_rotate_extended_lazy_kernel<SB>, batch << log_c,
                                1 << log_c, ExLazy<SB>::SMEM, stream, acc, mask, bsk, tw_fwd,
                                tw_inv, consts, n_steps, base_log, log_e);
  }
};

struct LazySmem {
  template <int SB>
  int run() const { return ExLazy<SB>::SMEM; }
};

struct LazyClusters {
  int log_e;
  template <int SB>
  int run() const {
    return active_clusters(blind_rotate_extended_lazy_kernel<SB>, 1 << (log_e - (SB == 2)),
                           ExLazy<SB>::SMEM);
  }
};

bool lazy_slots(int sb, int log_e) {
  return (sb == 1 || sb == 2) && log_e >= 0 && log_e <= EX_MAX_LOG_E && sb <= (1 << log_e);
}

}  // namespace

extern "C" int tfhe_torch_blind_rotate_extended_lazy(void* acc, const void* mask,
                                                     const void* bsk, const void* tw_fwd,
                                                     const void* tw_inv, const void* consts,
                                                     int batch, int n_steps, int k1, int log_n,
                                                     int levels, int base_log, int log_e,
                                                     int sb, void* stream) {
  if (!extended_lazy_shape(k1, log_n, levels, base_log) || !lazy_slots(sb, log_e) ||
      batch < 1 || n_steps < 1 || ((uintptr_t)bsk & 15) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const LazyLaunch launch{(long long*)acc, (const int*)mask, (const uint4*)bsk,
                          (const uint2*)tw_fwd, (const uint2*)tw_inv, (const long long*)consts,
                          batch, n_steps, base_log, log_e, (cudaStream_t)stream};
  return by_slots(sb, launch);
}

// Dynamic shared memory of a block of the lazy kernel at sb slots a block,
// and the clusters of E / sb such blocks the card holds at once
// (cudaOccupancyMaxActiveClusters; minus the CUDA error, -1 at slots the
// kernel does not take).
extern "C" int tfhe_torch_blind_rotate_extended_lazy_smem(int sb) {
  return lazy_slots(sb, 1) ? by_slots(sb, LazySmem{}) : -1;
}

extern "C" int tfhe_torch_blind_rotate_extended_lazy_clusters(int log_e, int sb) {
  return lazy_slots(sb, log_e) ? by_slots(sb, LazyClusters{log_e}) : -1;
}

// The same for the generic kernel at its dynamic shared memory smem.
extern "C" int tfhe_torch_blind_rotate_extended_clusters(int log_e, int smem) {
  if (log_e < 0 || log_e > EX_MAX_LOG_E || smem < 0 || smem > EX_SMEM_LIMIT) return -1;
  return active_clusters(blind_rotate_extended_kernel, 1 << log_e, smem);
}
