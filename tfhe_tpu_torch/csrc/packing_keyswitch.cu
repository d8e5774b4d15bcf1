// K4: packing keyswitch (LWE list -> GLWEs), wrapping u64, for sm_90a.
//
// Replaces: tfhe_tpu/ops/server.py:537 `packing_keyswitch`, which the TPU runs
// as an XLA contraction over a 4-prime CRT-NTT (one call per packed GLWE,
// tfhe_tpu/shortint/compression.py:236-244).  Plain version:
// tfhe_tpu_torch/ops/server.py `packing_keyswitch`.
//
// For GLWE g, holding LWEs j = 0 .. b_g-1 of the batch:
//   out_g[c] = (c == k ? B(X) : 0) - sum_{i, lev} D_{i,lev}(X) * PKSK[i, lev, c](X)
// mod (X^N + 1, 2^64), where D_{i,lev} holds the level-lev signed digit of
// mask element i of LWE j as its coefficient j and B(X) the bodies.  The sum
// is taken directly in wrapping u64: every product and sum is then exact mod
// 2^64, which is the word tfhe_tpu's CRT-NTT route reconstructs (its exact
// integer stays far below P/2).
//
// What bounds it: the direct product is n l (k+1) N b_g multiply-adds of a
// small signed digit by a u64 key word per GLWE, about 2e9 at the production
// set (n = 2048, l = 3, k+1 = 5, N = 256, b_g = 256), against a 63 MB key.
// Counted as 8 byte limbs a key word on the int8 tensor cores that is
// 0.033 ms at B = 512 on an H100; the key read once, 0.019 ms.
//
// Tensor-core kernel (packing_keyswitch_imma_kernel), at the shapes of
// packing_keyswitch_imma_shape (N = 256, k+1 <= 5, s8 digits from the high
// word): coefficient t of D(X) K(X) is sum_m Dx[t - m] K[m], Dx the digit
// vector extended negacyclically (Dx[s] = D[s] for s >= 0, -D[s + N] for
// s < 0), so the product is a GEMM of an s8 Toeplitz matrix of digits,
// rows (g, t), columns (i, lev, m), by the u8 byte limbs of the key,
// (i, lev, m) x (c, limb): M = N a GLWE, K = n l N, 8 (k+1) columns, each
// n8 tile of mma.m16n8k32.s8.u8 one output polynomial's 8 limbs.  The key
// is the dense operand and the same for every GLWE; its K-major byte layout
// (ops/kernels.py packing_keyswitch_key_limbs, built once by the key's
// owner) streams through a ring of shared-memory stages with cp.async,
// its 16-byte units swizzled by limb row so that ldmatrix reads without
// bank conflicts.  The Toeplitz tile is never written: each (GLWE, i, lev)
// digit vector is stored reversed and extended, R[u] = Dx[N - u] (2N
// bytes), and the four bytes of row t, columns m .. m+3 that an A fragment
// register holds are R[N - t + m ..], one funnel shift of two aligned
// 32-bit shared loads.  A warp owns four m16 tiles of consecutive rows, so
// a fragment depends on m - t alone: each 32-deep step needs four new
// windows, the other twelve registers of its four fragments are the
// previous step's.  A block owns two GLWEs (512 rows) and a range of input
// coefficients i; it decomposes each of its mask words once, from the
// high word, into the digit vectors of the next coefficient while the
// current one's l rows run.  Limb sums are s32; a block's rows are few
// enough that they stay exact (packing_keyswitch_imma_rows), and the
// epilogue recombines sum_b 2^(8b) sext(S_b) mod 2^64 with two shuffles of
// a quad and adds its negation (the bodies in the first range's blocks)
// into the zeroed output with 64-bit atomics, exact in any order.  The
// ranges are cut so that the grid fills the SMs once, one block each.
//
// Generic kernel (packing_keyswitch_kernel), every other shape: the
// product on the CUDA cores.  A block owns one output polynomial c of one
// GLWE and a range of input rows i; blocks of the same (g, c) add their
// partial sums into the zeroed output with 64-bit atomics.  Inside a block,
// LANES rows are processed at a time, each by N / TPT threads that own TPT
// neighbouring output coefficients.  The rows' digits, all levels, are
// decomposed once into shared memory; for each level the key polynomial is
// staged as Kx[m] = -K[m] (m < N), K[m - N] (m >= N), so that coefficient t
// gains D[j] * Kx[t - j + N] with no branch for the negacyclic wrap.  A
// thread walks j keeping the TPT key words it needs in a ring of
// registers: one shared-memory load feeds TPT multiply-adds.

#include "ntt_common.cuh"

using ntt_common::decomposer_state;
using ntt_common::hi_decomposer_state;
using ntt_common::hi_next_digit;
using ntt_common::ldmatrix_x4;
using ntt_common::mma_s8u8;
using ntt_common::next_digit;
using ntt_common::smem_u32;

namespace {

typedef unsigned long long u64;

constexpr int THREADS = 256;
constexpr int TPT = 4;                       // output coefficients per thread
constexpr int SLOTS = THREADS * TPT;         // LANES * N
constexpr int ROUNDS = 16;                   // row groups per block
constexpr int MIN_N = 16;
constexpr int MAX_N = SLOTS;
constexpr int MAX_LEVELS = 8;

__global__ void __launch_bounds__(THREADS)
packing_keyswitch_kernel(u64* __restrict__ out, const u64* __restrict__ lwes,
                         const u64* __restrict__ pksk, int batch, int n_in, int levels,
                         int k1, int log_n, int per_glwe, int base_log) {
  extern __shared__ u64 smem[];
  const int n_poly = 1 << log_n;
  const int lanes = SLOTS >> log_n;
  u64* kx = smem;                               // (lanes, 2N)
  int* digit = (int*)(smem + 2 * SLOTS);        // (levels, lanes, N)

  const int g = blockIdx.x;
  const int c = blockIdx.y;
  const int rows = lanes * ROUNDS;
  const int i_begin = blockIdx.z * rows;
  const int i_end = min(n_in, i_begin + rows);
  const int first = g * per_glwe;
  const int b_g = min(per_glwe, batch - first);
  const int j_end = (b_g + TPT - 1) / TPT * TPT;  // digits past b_g are 0
  const size_t stride = (size_t)n_in + 1;

  const int tid = threadIdx.x;
  const int lane = tid >> (log_n - 2);          // N / TPT threads a lane
  const int t0 = (tid & ((n_poly >> 2) - 1)) * TPT;

  u64 acc[TPT];
#pragma unroll
  for (int u = 0; u < TPT; ++u) acc[u] = 0ull;

  for (int i0 = i_begin; i0 < i_end; i0 += lanes) {
    // digits of mask element i0 + l of every LWE j, all levels; neighbouring
    // threads read neighbouring elements of one LWE
    for (int q = tid; q < SLOTS; q += THREADS) {
      const int l = q % lanes;
      const int j = q / lanes;
      const int i = i0 + l;
      u64 state = (i < i_end && j < b_g)
          ? decomposer_state(lwes[(size_t)(first + j) * stride + i], base_log, levels)
          : 0ull;
      for (int lev = 0; lev < levels; ++lev) {
        digit[(lev * lanes + l) * n_poly + j] = (int)next_digit(state, base_log);
      }
    }
    for (int lev = 0; lev < levels; ++lev) {
      __syncthreads();   // digits written; the previous level's Kx read
      for (int q = tid; q < 2 * SLOTS; q += THREADS) {
        const int l = q >> (log_n + 1);
        const int m = q & (2 * n_poly - 1);
        const int i = i0 + l;
        u64 v = 0ull;
        if (i < i_end) {
          const u64* krow = pksk + (((size_t)i * levels + lev) * k1 + c) * n_poly;
          v = m < n_poly ? 0ull - krow[m] : krow[m - n_poly];
        }
        kx[q] = v;
      }
      __syncthreads();
      const u64* kl = kx + (size_t)lane * 2 * n_poly + t0 + n_poly;
      const int* dl = digit + (lev * lanes + lane) * n_poly;
      // at step j = j0 + jj, coefficient t0 + u needs kl[u - j], which is in
      // slot (u - jj) mod TPT; each step loads the one new word, kl[-j], into
      // slot (-jj) mod TPT, whose old word no coefficient needs any more
      u64 ring[TPT];
#pragma unroll
      for (int s = 1; s < TPT; ++s) ring[s] = kl[s];
      for (int j0 = 0; j0 < j_end; j0 += TPT) {
#pragma unroll
        for (int jj = 0; jj < TPT; ++jj) {
          ring[(TPT - jj) % TPT] = kl[-(j0 + jj)];
          const u64 d = (u64)(long long)dl[j0 + jj];   // two's complement
#pragma unroll
          for (int u = 0; u < TPT; ++u) acc[u] += d * ring[(u - jj + TPT) % TPT];
        }
      }
    }
    __syncthreads();   // the last level's Kx and the digits read
  }

  // sum the lanes' partial sums in shared memory, then one atomic a word
  u64* part = smem;                             // (lanes, N)
#pragma unroll
  for (int u = 0; u < TPT; ++u) part[lane * n_poly + t0 + u] = acc[u];
  __syncthreads();
  u64* out_c = out + ((size_t)g * k1 + c) * n_poly;
  for (int t = tid; t < n_poly; t += THREADS) {
    u64 sum = 0ull;
    for (int l = 0; l < lanes; ++l) sum += part[l * n_poly + t];
    u64 add = 0ull - sum;
    if (c == k1 - 1 && blockIdx.z == 0 && t < b_g) {
      add += lwes[(size_t)(first + t) * stride + n_in];
    }
    atomicAdd(out_c + t, add);
  }
}

// the staged key (lanes, 2N) u64 and the digits (levels, lanes, N) int32:
// 48 KB at MAX_LEVELS, within a block's default dynamic shared memory
int smem_bytes(int levels) { return 2 * SLOTS * 8 + levels * SLOTS * 4; }

// ---------------------------------------------------------------------------
// The tensor-core kernel.
// ---------------------------------------------------------------------------

typedef unsigned int u32;

constexpr int PK_LOG_N = 8;
constexpr int PK_N = 1 << PK_LOG_N;        // the polynomial size the tiles take
constexpr int PK_THREADS = 256;            // 8 warps
constexpr int PK_GLWES = 2;                // GLWEs a block: 512 output rows (g, t)
constexpr int PK_TILES = 4;                // m16 tiles of consecutive rows a warp (64 rows)
constexpr int PK_WARP_ROWS = 16 * PK_TILES;
constexpr int PK_SLOTS = PK_GLWES * PK_N / PK_THREADS;   // mask words a thread decomposes
constexpr int PK_KP0 = 1 - 2 * PK_TILES;   // the lowest window k' a row reads
constexpr int PK_MAX_K1 = 5;               // 40 limb columns: five n8 tiles
constexpr int PK_MAX_LEVELS = 8;
constexpr int PK_STAGES = 4;               // key rows (i, lev) in flight
constexpr int PK_STEPS = PK_N / 32;        // 32-deep mma steps a row
constexpr int PK_KEY_ROW = PK_MAX_K1 * 8 * PK_N;   // a stage: 10,240 B
constexpr int PK_RS = 2 * PK_N + 16;       // a reversed, extended digit vector (bytes)
constexpr int PK_SMEM = PK_STAGES * PK_KEY_ROW + 2 * PK_GLWES * PK_MAX_LEVELS * PK_RS;  // 57,856 B
static_assert(PK_SLOTS * PK_THREADS == PK_GLWES * PK_N, "the threads cover the LWEs");
static_assert(PK_THREADS / 32 * PK_WARP_ROWS == PK_GLWES * PK_N, "the warps cover the rows");

// Rows (i, lev) whose s32 limb sums stay exact with every digit at
// -2^(base_log-1) and every key byte 255: R N 2^(base_log-1) 255 < 2^31
// (4,112 at base_log 4).
__host__ __device__ constexpr int pk_rows(int base_log) {
  return (int)(((1ll << 31) - 1) / ((long long)PK_N * (1ll << (base_log - 1)) * 255));
}

// The tensor-core kernel's shape: N = 256, k+1 <= 5, signed digits
// |d| <= 2^(base_log-1) that fit s8 (base_log <= 7), a decomposition read
// from the high word alone (base_log l <= 30), l <= 8, and one input
// coefficient's l rows exact in s32 (the launcher cuts the coefficients
// into ranges of at most pk_rows / l).  ops/kernels.py chooses by it
// (tfhe_torch_packing_keyswitch_imma_shape).
__host__ __device__ constexpr bool pk_imma_shape(int n_in, int levels, int k1, int log_n,
                                                 int base_log) {
  return log_n == PK_LOG_N && n_in >= 1 && k1 >= 1 && k1 <= PK_MAX_K1 && levels >= 1 &&
         levels <= PK_MAX_LEVELS && base_log >= 1 && base_log <= 7 &&
         base_log * levels <= 30 && levels <= pk_rows(base_log);
}

// Input coefficients a block: the ranges fill the SMs once, one block
// each, over m_tiles tiles of PK_GLWES GLWEs, and keep a block's rows
// within pk_rows.
int pk_inputs_per_block(int n_in, int levels, int base_log, int m_tiles, int sms) {
  const int splits = max(1, sms / m_tiles);
  return min((n_in + splits - 1) / splits, pk_rows(base_log) / levels);
}

// K1 = k+1 output polynomials (n8 tiles), a template argument so that the
// step loop has no branch.
template <int K1>
__global__ void __launch_bounds__(PK_THREADS, 1)
packing_keyswitch_imma_kernel(u64* __restrict__ out, const u64* __restrict__ lwes,
                              const uint4* __restrict__ key, int batch, int n_in, int levels,
                              int per_glwe, int base_log, int inputs) {
  extern __shared__ uint4 pk_smem[];
  unsigned char* key_s = (unsigned char*)pk_smem;                      // (STAGES, 8 k1, N)
  signed char* rs_s = (signed char*)(key_s + PK_STAGES * PK_KEY_ROW);  // (2, GLWES, MAX_LEVELS, RS)
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_glwe = (batch + per_glwe - 1) / per_glwe;
  const int g0 = blockIdx.x * PK_GLWES;
  const int i_begin = blockIdx.y * inputs;
  const int n_i = min(n_in, i_begin + inputs) - i_begin;
  const int rows = n_i * levels;
  const size_t stride = (size_t)n_in + 1;
  constexpr int row_units = K1 * 8 * PK_N / 16;   // 16-byte units of a key row

  // key row r of the block, (i_begin + r / l, r % l), into stage s: limb
  // row n = 8 c + limb of N bytes, its 16-byte unit u stored at u ^ (n & 7)
  auto load_key = [&](int r, int s) {
    const uint4* src = key + ((size_t)i_begin * levels + r) * row_units;
    unsigned char* dst = key_s + s * PK_KEY_ROW;
    for (int q = tid; q < row_units; q += PK_THREADS) {
      const int n = q >> (PK_LOG_N - 4);
      const int u = q & (PK_N / 16 - 1);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                       smem_u32(dst + n * PK_N + ((u ^ (n & 7)) << 4))),
                   "l"(src + q));
    }
  };

  // thread tid decomposes mask element i of LWE j of GLWE h of the block,
  // for the slots h N + j = tid + PK_THREADS v (0 past the list: its digits
  // are 0), from the high word fetched one coefficient ahead, into
  // R[N - j] = d and R[2N - j] = -d
  int lwe_row[PK_SLOTS];
#pragma unroll
  for (int v = 0; v < PK_SLOTS; ++v) {
    const int h = (tid + PK_THREADS * v) / PK_N;
    const int j = (tid + PK_THREADS * v) % PK_N;
    const int lwe = (g0 + h) * per_glwe + j;
    lwe_row[v] = (j < per_glwe && lwe < batch) ? lwe : -1;
  }
  const u32* words = (const u32*)lwes;
  u32 hw[PK_SLOTS];
  auto fetch = [&](int i) {
#pragma unroll
    for (int v = 0; v < PK_SLOTS; ++v) {
      hw[v] = lwe_row[v] >= 0 ? __ldg(words + 2 * ((size_t)lwe_row[v] * stride + i) + 1) : 0u;
    }
  };
  auto decompose = [&](int buf) {
#pragma unroll
    for (int v = 0; v < PK_SLOTS; ++v) {
      const int h = (tid + PK_THREADS * v) / PK_N;
      const int j = (tid + PK_THREADS * v) % PK_N;
      int state = hi_decomposer_state(hw[v], base_log, levels);
      signed char* r = rs_s + (buf * PK_GLWES + h) * PK_MAX_LEVELS * PK_RS;
      for (int lev = 0; lev < levels; ++lev) {
        const int d = hi_next_digit(state, base_log);
        r[lev * PK_RS + PK_N - j] = (signed char)d;
        r[lev * PK_RS + 2 * PK_N - j] = (signed char)(-d);
      }
    }
  };

  // warp: GLWE gl of the block, rows t = T .. T + 16 PK_TILES - 1 in
  // PK_TILES m16 tiles.  Lane (g, q)'s fragment registers of tile i at step
  // st are the 4-byte windows of R at byte o + 8 k', k' = 4 st - 2 i + (0,
  // -1, 2, 1) for (a0, a1, a2, a3): a0 holds row T + 16 i + g, columns m =
  // 32 st + 4 q .. + 3, which is R[N - t + m ..]; a1 is 8 rows down, a2 16
  // columns on.
  const int gl = warp / (PK_N / PK_WARP_ROWS);
  const int T = (warp % (PK_N / PK_WARP_ROWS)) * PK_WARP_ROWS;
  const int g = lane >> 2;
  const int q = lane & 3;
  const int o = PK_N - T - g + 4 * q;
  const int sh = (o & 3) * 8;

  int acc[PK_TILES][K1][4];
#pragma unroll
  for (int i = 0; i < PK_TILES; ++i) {
#pragma unroll
    for (int c = 0; c < K1; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][c][e] = 0;
    }
  }

#pragma unroll
  for (int s = 0; s < PK_STAGES - 1; ++s) {
    if (s < rows) load_key(s, s);
    asm volatile("cp.async.commit_group;\n" ::);
  }
  fetch(i_begin);
  decompose(0);
  if (n_i > 1) fetch(i_begin + 1);

  int si = 0;
  int lev = 0;
  for (int r = 0; r < rows; ++r) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(PK_STAGES - 2));
    __syncthreads();   // row r's key and digits landed; row r - 1 is done
    if (r + PK_STAGES - 1 < rows) load_key(r + PK_STAGES - 1, (r + PK_STAGES - 1) % PK_STAGES);
    asm volatile("cp.async.commit_group;\n" ::);
    // the row (i, lev): the warp's 64 x N Toeplitz tile of digits times
    // the stage's 8 K1 limb columns
    const unsigned char* ks = key_s + (r % PK_STAGES) * PK_KEY_ROW;
    const u32* rw =
        (const u32*)(rs_s + (((si & 1) * PK_GLWES + gl) * PK_MAX_LEVELS + lev) * PK_RS) + (o >> 2);
    u32 win[4 * PK_STEPS + 3 - PK_KP0];   // the window k' at win[k' - PK_KP0]
#pragma unroll
    for (int kp = PK_KP0; kp <= -2; ++kp) {
      win[kp - PK_KP0] = __funnelshift_r(rw[2 * kp], rw[2 * kp + 1], sh);
    }
#pragma unroll
    for (int st = 0; st < PK_STEPS; ++st) {
#pragma unroll
      for (int kp = 4 * st - 1; kp <= 4 * st + 2; ++kp) {
        win[kp - PK_KP0] = __funnelshift_r(rw[2 * kp], rw[2 * kp + 1], sh);
      }
      // B fragments of output polynomial c: limb rows 8 c .. 8 c + 7,
      // digit positions 32 st ..; lanes past row 8 K1 - 1 read it, unused
      u32 b[K1 + 1][2];
#pragma unroll
      for (int p = 0; p < (K1 + 1) / 2; ++p) {
        const int n = min(16 * p + (lane & 7) + ((lane >> 4) << 3), 8 * K1 - 1);
        const int u = 2 * st + ((lane >> 3) & 1);
        u32 r4[4];
        ldmatrix_x4(r4, smem_u32(ks + n * PK_N + ((u ^ (n & 7)) << 4)));
        b[2 * p][0] = r4[0];
        b[2 * p][1] = r4[1];
        b[2 * p + 1][0] = r4[2];
        b[2 * p + 1][1] = r4[3];
      }
#pragma unroll
      for (int i = 0; i < PK_TILES; ++i) {
        const int kb = 4 * st - 2 * i - PK_KP0;
        const u32 a[4] = {win[kb], win[kb - 1], win[kb + 2], win[kb + 1]};
#pragma unroll
        for (int c = 0; c < K1; ++c) mma_s8u8(acc[i][c], a, b[c][0], b[c][1]);
      }
    }
    if (++lev == levels) {
      // the next coefficient's digits into the other buffer, whose last
      // reader (row r - 1 or earlier) every warp has passed
      lev = 0;
      ++si;
      if (si < n_i) decompose(si & 1);
      if (si + 1 < n_i) fetch(i_begin + si + 1);
    }
  }

  // each n8 tile is one output polynomial: lane (g, q) holds limbs 2q,
  // 2q + 1 of rows g and g + 8; a quad's sum is the word's product sum
  const int G = g0 + gl;
#pragma unroll
  for (int i = 0; i < PK_TILES; ++i) {
#pragma unroll
    for (int c = 0; c < K1; ++c) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        u64 part = ((u64)(long long)acc[i][c][2 * h] << (16 * q)) +
                   ((u64)(long long)acc[i][c][2 * h + 1] << (16 * q + 8));
        part += __shfl_xor_sync(0xffffffffu, part, 1);
        part += __shfl_xor_sync(0xffffffffu, part, 2);
        const int t = T + 16 * i + g + 8 * h;
        if (q == h && G < n_glwe) {
          u64 add = 0ull - part;
          const int lwe = G * per_glwe + t;
          if (blockIdx.y == 0 && c == K1 - 1 && t < per_glwe && lwe < batch) {
            add += lwes[(size_t)lwe * stride + n_in];
          }
          atomicAdd(out + ((size_t)G * K1 + c) * PK_N + t, add);
        }
      }
    }
  }
}

}  // namespace

extern "C" int tfhe_torch_packing_keyswitch(void* out, const void* lwes, const void* pksk,
                                            int batch, int n_in, int levels, int k1,
                                            int log_n, int per_glwe, int base_log,
                                            void* stream) {
  const int n_poly = 1 << log_n;
  if (batch < 1 || n_in < 1 || levels < 1 || levels > MAX_LEVELS || k1 < 1 ||
      n_poly < MIN_N || n_poly > MAX_N || per_glwe < 1 || per_glwe > n_poly ||
      base_log < 1 || base_log * levels >= 64) {
    return (int)cudaErrorInvalidValue;
  }
  const int lanes = SLOTS / n_poly;
  const int n_glwe = (batch + per_glwe - 1) / per_glwe;
  const int splits = (n_in + lanes * ROUNDS - 1) / (lanes * ROUNDS);
  dim3 grid(n_glwe, k1, splits);
  packing_keyswitch_kernel<<<grid, THREADS, smem_bytes(levels), (cudaStream_t)stream>>>(
      (u64*)out, (const u64*)lwes, (const u64*)pksk, batch, n_in, levels, k1, log_n,
      per_glwe, base_log);
  return (int)cudaGetLastError();
}

// Which kernel K4 runs at a shape: 1 for the tensor-core kernel, 0 for the
// generic one.  The wrapper (ops/kernels.py packing_keyswitch) chooses by it.
extern "C" int tfhe_torch_packing_keyswitch_imma_shape(int n_in, int levels, int k1, int log_n,
                                                       int base_log) {
  return pk_imma_shape(n_in, levels, k1, log_n, base_log) ? 1 : 0;
}

static int pk_sms(int* sms) {
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return (int)err;
}

// The input coefficients a block of the tensor-core kernel takes for a
// list of batch LWEs on the current device (its s32 sums run over that
// many times l rows), or -1.
extern "C" int tfhe_torch_packing_keyswitch_imma_inputs(int n_in, int levels, int base_log,
                                                        int batch, int per_glwe) {
  int sms;
  if (pk_sms(&sms) != 0 || batch < 1 || per_glwe < 1) return -1;
  const int m_tiles = ((batch + per_glwe - 1) / per_glwe + PK_GLWES - 1) / PK_GLWES;
  return pk_inputs_per_block(n_in, levels, base_log, m_tiles, sms);
}

template <int K1>
static int pk_launch(void* out, const void* lwes, const void* key, int batch, int n_in,
                     int levels, int per_glwe, int base_log, void* stream) {
  int sms;
  const int err = pk_sms(&sms);
  if (err != 0) return err;
  const int m_tiles = ((batch + per_glwe - 1) / per_glwe + PK_GLWES - 1) / PK_GLWES;
  const int inputs = pk_inputs_per_block(n_in, levels, base_log, m_tiles, sms);
  const cudaError_t set = cudaFuncSetAttribute(
      packing_keyswitch_imma_kernel<K1>, cudaFuncAttributeMaxDynamicSharedMemorySize, PK_SMEM);
  if (set != cudaSuccess) return (int)set;
  const dim3 grid(m_tiles, (n_in + inputs - 1) / inputs);
  packing_keyswitch_imma_kernel<K1><<<grid, PK_THREADS, PK_SMEM, (cudaStream_t)stream>>>(
      (u64*)out, (const u64*)lwes, (const uint4*)key, batch, n_in, levels, per_glwe, base_log,
      inputs);
  return (int)cudaGetLastError();
}

// The tensor-core kernel: key the (n_in, l, k+1, 8, N) byte layout of
// ops/kernels.py packing_keyswitch_key_limbs (16-byte aligned), out the
// zeroed (ceil(batch / per_glwe), k+1, N) output.
extern "C" int tfhe_torch_packing_keyswitch_imma(void* out, const void* lwes, const void* key,
                                                 int batch, int n_in, int levels, int k1,
                                                 int log_n, int per_glwe, int base_log,
                                                 void* stream) {
  if (!pk_imma_shape(n_in, levels, k1, log_n, base_log) || batch < 1 || per_glwe < 1 ||
      per_glwe > PK_N || ((uintptr_t)key & 15) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  switch (k1) {
    case 1: return pk_launch<1>(out, lwes, key, batch, n_in, levels, per_glwe, base_log, stream);
    case 2: return pk_launch<2>(out, lwes, key, batch, n_in, levels, per_glwe, base_log, stream);
    case 3: return pk_launch<3>(out, lwes, key, batch, n_in, levels, per_glwe, base_log, stream);
    case 4: return pk_launch<4>(out, lwes, key, batch, n_in, levels, per_glwe, base_log, stream);
    default: return pk_launch<5>(out, lwes, key, batch, n_in, levels, per_glwe, base_log, stream);
  }
}
