// The PCS openings and the FRI fold for NVIDIA Hopper (sm_90a): three
// kernels over BabyBear and its degree-4 extension.
//
// open_eval_kernel replaces lurk_tpu's jitted _ext_powers_fn and
// _eval_coeffs_fn (lurk_tpu/stark/device_prover.py), which its
// device_open_rounds runs once per (height group, opening point). For
// every height group of every round of a shard (a (h, w) coefficient
// slice) and each of its points z_k it computes the opened values
//   y[k, c] = sum_i coeffs[i, c] * z_k^i        (an extension element)
// for all groups and points in ONE launch.
//
// open_reduce_kernel replaces _inv_xz_fn and _reduce_fn and the addition
// of their result into the reduced codeword of the group's height. For
// every row x of the group's (H, w) LDE, on the coset GENERATOR * <g_H>,
//   ro[x] (+)= sum_k (sum_c weights[k, c] * lde[x, c] - ya[k]) / (x - z_k)
// with 1/0 taken as 0, as einv does.
//
// fri_fold_kernel replaces _fold_fn and the addition of the input
// codeword of the next height. For i < n/2, with f(x) = cw[i] and f(-x) =
// cw[i + n/2] on the coset shift * <g_n>,
//   out[i] = (f(x) + f(-x)) / 2 + beta * (f(x) - f(-x)) / (2x) (+ add[i])
// reading cw as the layer's committed pair matrix (row i = f(x), f(-x))
// and writing out as the next layer's (row i mod n/4, block i div n/4).
//
// What bounds them on this card, and what the designs do about it.
//
// open_eval. Its function reads every coefficient once and does four
// 31-bit products per (row, column, point): on the CUDA cores about 24
// integer instructions per 4 bytes read, which made the operations, not
// the bytes, its bound. Here the products go to the tensor cores,
// exactly. Split every canonical value into four bytes, v = sum_a 2^(8a)
// v_a; then sum_i A[i, c] Z[i, n] = sum_(a,b) 2^(8(a+b)) sum_i A_a[i, c]
// Z_b[i, n], and each inner sum is a u8 x u8 -> s32 matrix product
// (mma.sync m16n8k32, Hopper's int8 MMA for small tiles). It is exact:
// 255^2 * 2^15 < 2^31, and a warp sums at most ITEM_ROWS (far below 2^15)
// rows into one s32 accumulator before it reduces each of its 16 partial
// sums mod p, scales it by 2^(8(a+b)) and adds it into a 64-bit canonical
// sum. 16 byte products per base product are a few percent of the int8
// rate, so the kernel is bound by reading the coefficients once.
// - mma.sync rather than wgmma: the products are skinny (16 coefficient
//   columns by 32 (point, limb, byte) columns of Z per MMA tile) and the
//   operands need a byte transpose in registers anyway (K, the row index,
//   is the slow index of the row-major slice), which wgmma's shared-memory
//   descriptor layouts would have to be given in shared memory first.
// - A block takes one work item: ITEM_ROWS rows of one column tile
//   (16 m columns, m = 1, 2, 4 or 8) of one group; the launch covers every
//   group of every round through a small table (one record per column
//   tile, and a block -> tile map). Its 8 warps each own 16 columns and
//   1/(8/m) of each stage's rows. (Blocks of several items, each warp
//   summing up to 2^15 rows before its atomics, measured no faster on the
//   card: fewer, longer blocks balance worse at the end of the launch.)
// - Coefficient tiles of 4,096 words come in by cp.async into a ring of
//   STAGES stages (16-byte copies where the slice's stride and address
//   allow, else 4-byte ones; the ragged edges zero-filled), so loads stay
//   in flight while the previous stage's MMAs run. A stage's 4-word chunks
//   are XOR-swizzled by row, so a warp's fragment loads hit 32 banks.
// - A fragments: four words (rows) of one column byte-transposed by prmt
//   give the four byte planes' registers at once.
// - Z's byte planes for the item's rows are built once per block in
//   shared memory and shared by its warps: each thread raises z to its
//   first row from the group's table of z^(2^j) (at most log h products,
//   no squarings), steps by z, and transposes each limb's bytes by prmt.
// - Sums across blocks are exact: each warp adds its canonical sums into
//   64-bit accumulators with atomics (order-free integers), and the last
//   block of a column tile reduces them mod p, writes the output and sets
//   the accumulators and its counter back to zero.
//
// open_reduce does four products per (row, column, point) on four bytes of
// input, a few hundred columns wide; it stages a tile of REDUCE_ROWS LDE
// rows and REDUCE_COLS columns with coalesced loads into shared memory
// (odd row stride: a warp, one row a thread, hits 32 banks) beside the
// chunk's weights, read as broadcasts; one thread sums its row for every
// point in Montgomery form with lazy 64-bit sums (babybear.cuh) and divides
// by x - z with one extension inverse per row and point (0 maps to 0).
//
// fri_fold moves 64 bytes an output for about 30 products: its bytes bound
// it. A thread takes FOLD_RUN outputs FOLD_THREADS apart (each warp's
// loads and stores side by side), gets 1/(2x) of its first one from the
// layer's table of g^-(2^j) (at most log n products) and steps by
// g^-FOLD_THREADS; every load and store is 16 bytes. Its output is the next
// layer's pair matrix, which that layer commits as it stands and folds
// again, so no copy makes pairs between the layers.

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

#include "babybear.cuh"
#include "on_device.cuh"

namespace {

using bb::Ext;

constexpr int MAX_POINTS = 2;      // opening points of one group
constexpr int LOG_POWERS = 32;     // table entries z^(2^j), g^-(2^j)
constexpr int EVAL_THREADS = 256;  // threads of an open_eval block
constexpr int EVAL_WARPS = EVAL_THREADS / 32;
constexpr int ITEM_ROWS = 1024;    // rows of a block's work item
constexpr int STAGE_WORDS = 4096;  // coefficient words of a staged tile
constexpr int STAGES = 4;          // the cp.async ring
constexpr int Z_COLS = 32;         // Z's byte-plane columns (b, k, l)
constexpr int Z_LD = ITEM_ROWS / 4 + 4;  // words a column: 4 mod 32
constexpr int EVAL_SMEM = 4 * (STAGES * STAGE_WORDS + Z_COLS * Z_LD);
constexpr int TILE_WORDS = 11;     // 8-byte words of an EvalTile
constexpr int REDUCE_ROWS = 128;  // rows (and threads) of an open_reduce block
constexpr int REDUCE_COLS = 32;   // LDE columns staged at a time
constexpr int FOLD_THREADS = 256;
constexpr int LOG_FOLD_THREADS = 8;
constexpr int FOLD_RUN = 4;       // outputs of a fri_fold thread
constexpr uint32_t TWO_INV_M = 134217727u;  // 1/2 in Montgomery form

static_assert((1 << LOG_FOLD_THREADS) == FOLD_THREADS, "FOLD_THREADS");
static_assert(Z_LD % 32 == 4, "Z_LD: a warp's B loads hit 32 banks");

// SHIFT_M[s] = 2^(8s) in Montgomery form: 2^(8s + 32) mod p.
__constant__ uint32_t SHIFT_M[7] = {268435454u, 268434910u, 268295646u,
                                    232644062u, 1172168163u, 98427499u,
                                    1038248692u};

// The argument structures, field for field as stark/open_kernel.py packs
// them: 8-byte integers and pointers. Points, powers and weights are
// Montgomery; y_alpha and every matrix canonical.

// One column tile of one height group: `items` blocks of ITEM_ROWS rows.
struct EvalTile {
  const int32_t* coeffs;     // the group's (h, w) slice, row stride ld
  long long ld;
  long long h;
  long long w;
  long long n_points;
  long long c0;              // the tile's first column
  long long m_tiles;         // 16-column MMA tiles: 1, 2, 4 or 8
  long long group;           // the group's power table in EvalArgs::zpow
  long long out_row;         // the group's first row of out
  long long first_block;     // blocks of the tiles before this one
  long long items;           // blocks of this tile
};

struct EvalArgs {
  const EvalTile* tiles;     // (n_tiles,)
  const int32_t* block_tile; // (blocks,): each block's tile
  const uint32_t* zpow;      // (groups, MAX_POINTS, LOG_POWERS, 4)
  long long n_tiles;
  long long blocks;
  unsigned long long* acc;   // (rows, 4), zero before the launch
  int* counter;              // (n_tiles,), zero before the launch
  int32_t* out;              // (rows, 4): group by group, (n_points, w, 4)
};

struct ReduceArgs {
  const int32_t* lde;        // (2^log_big, w), row stride ld
  long long ld;
  long long log_big;
  long long w;
  long long n_points;
  long long z[MAX_POINTS * 4];
  long long ya[MAX_POINTS * 4];
  const uint32_t* weights;   // (n_points, w, 4)
  long long x0;              // GENERATOR
  long long g;               // the domain's generator
  long long accumulate;      // 1: add into out; 0: write out
  int32_t* out;              // (2^log_big, 4)
};

struct FoldArgs {
  const int32_t* pair;       // (2^(log_n - 1), 8): rows f(x), f(-x)
  const int32_t* add;        // (2^(log_n - 1), 4) or null
  long long log_n;
  long long beta[4];
  long long inv_shift2;      // 1 / (2 shift)
  long long g_inv[LOG_POWERS];  // g^-(2^j) of the domain's generator g
  int32_t* out;              // (2^(log_n - 2), 8): the next layer's pairs
};

static_assert(sizeof(EvalTile) == 8 * TILE_WORDS, "EvalTile");

__device__ __forceinline__ Ext ext_at(const long long* v, int k) {
  return Ext{{static_cast<uint32_t>(v[4 * k]),
              static_cast<uint32_t>(v[4 * k + 1]),
              static_cast<uint32_t>(v[4 * k + 2]),
              static_cast<uint32_t>(v[4 * k + 3])}};
}

__device__ __forceinline__ Ext ext_of(uint4 v) {
  return Ext{{v.x, v.y, v.z, v.w}};
}

__device__ __forceinline__ uint4 uint4_of(const Ext& e) {
  return make_uint4(e.c[0], e.c[1], e.c[2], e.c[3]);
}

// x^e in Montgomery form.
__device__ inline uint32_t mpow(uint32_t x, unsigned long long e) {
  uint32_t acc = bb::ONE_M;
  while (e) {
    if (e & 1) acc = bb::mmul(acc, x);
    e >>= 1;
    if (e) x = bb::mmul(x, x);
  }
  return acc;
}

// acc += v * p for the four limbs of p (v canonical, p Montgomery), each
// sum kept below p * 2^32 by one fold per product.
__device__ __forceinline__ void mac4(uint64_t acc[4], uint32_t v,
                                     const uint32_t* p) {
#pragma unroll
  for (int l = 0; l < 4; ++l) acc[l] = bb::fold_hi(acc[l] + bb::wide(v, p[l]));
}

// ---------------------------------------------------------------------------
// open_eval
// ---------------------------------------------------------------------------

// Asynchronous copies into shared memory of `bytes` (<= the copy's size)
// from src, the rest of the copy zero-filled.
__device__ __forceinline__ void cp_async4(uint32_t* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async16(uint32_t* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The word of a staged tile (rows of ct words) that holds (row, col): each
// 4-word chunk's place in its 32-word line XORed with 8 * ((row / 4) % 4),
// so the 8 columns x 4 row groups of a warp's fragment load hit 32 banks
// (for ct = 16 the XOR may move a chunk to the other row of its line).
__device__ __forceinline__ int a_word(int row, int col, int ct) {
  return (row * ct + col) ^ (((row >> 2) & 3) << 3);
}

// o[a] = byte a of v0, v1, v2, v3 (low byte first): a 4 x 4 byte transpose.
__device__ __forceinline__ void transpose4(uint32_t v0, uint32_t v1,
                                           uint32_t v2, uint32_t v3,
                                           uint32_t o[4]) {
  const uint32_t t0 = __byte_perm(v0, v1, 0x5140);  // v0.0 v1.0 v0.1 v1.1
  const uint32_t t1 = __byte_perm(v0, v1, 0x7362);  // v0.2 v1.2 v0.3 v1.3
  const uint32_t t2 = __byte_perm(v2, v3, 0x5140);
  const uint32_t t3 = __byte_perm(v2, v3, 0x7362);
  o[0] = __byte_perm(t0, t2, 0x5410);
  o[1] = __byte_perm(t0, t2, 0x7632);
  o[2] = __byte_perm(t1, t3, 0x5410);
  o[3] = __byte_perm(t1, t3, 0x7632);
}

// d += a * b: a 16 x 32 u8 tile (rows: coefficient columns, K: rows), a
// 32 x 8 u8 tile (K: rows, columns: point and limb), s32 sums.
__device__ __forceinline__ void mma_u8(int d[4], const uint32_t a[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ Ext ext_word(const uint32_t* p) {
  return Ext{{p[0], p[1], p[2], p[3]}};
}

__global__ void __launch_bounds__(EVAL_THREADS, 2)
    open_eval_kernel(const EvalArgs a) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* ring = smem;                         // STAGES x STAGE_WORDS
  uint32_t* zs = smem + STAGES * STAGE_WORDS;    // Z_COLS x Z_LD
  __shared__ bool last;
  const int t = threadIdx.x, warp = t >> 5;
  const int g = (t & 31) >> 2, tig = t & 3;
  const int tile = a.block_tile[blockIdx.x];
  const EvalTile& T = a.tiles[tile];
  const int32_t* coeffs = T.coeffs;
  const long long ld = T.ld, w = T.w, c0 = T.c0;
  const int np = static_cast<int>(T.n_points);
  const int m = static_cast<int>(T.m_tiles), ct = 16 * m;
  const int stage_rows = STAGE_WORDS / ct;       // 32 rows a warp
  const long long r0 = (blockIdx.x - T.first_block) * ITEM_ROWS;
  const int rows = static_cast<int>(min(static_cast<long long>(ITEM_ROWS),
                                        T.h - r0));
  const int cols = static_cast<int>(min(static_cast<long long>(ct), w - c0));
  const int stages = (rows + stage_rows - 1) / stage_rows;
  const bool vec = ((reinterpret_cast<uintptr_t>(coeffs) |
                     static_cast<uintptr_t>(4 * ld)) & 15u) == 0;
  const int32_t* base = coeffs + r0 * ld + c0;

  // stage s: the item's rows s * stage_rows .. + stage_rows, the tile's ct
  // columns, past the item's rows or the group's columns zero
  auto issue = [&](int s) {
    if (s < stages) {
      uint32_t* buf = ring + (s % STAGES) * STAGE_WORDS;
      const int row0 = s * stage_rows;
      if (vec) {
        const int chunks = ct / 4;
        for (int e = t; e < STAGE_WORDS / 4; e += EVAL_THREADS) {
          const int row = e / chunks, col = 4 * (e % chunks);
          const int n = row0 + row < rows ? max(0, min(4, cols - col)) : 0;
          cp_async16(buf + a_word(row, col, ct),
                     n ? base + (row0 + row) * ld + col : coeffs, 4 * n);
        }
      } else {
        for (int e = t; e < STAGE_WORDS; e += EVAL_THREADS) {
          const int row = e / ct, col = e % ct;
          const bool live = row0 + row < rows && col < cols;
          cp_async4(buf + a_word(row, col, ct),
                    live ? base + (row0 + row) * ld + col : coeffs,
                    live ? 4 : 0);
        }
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) issue(s);

  // Z's byte planes: column b * 8 + k * 4 + l holds byte b of limb l of
  // z_k^(r0 + i) at byte i; each thread makes 8 rows of one point
  {
    const int k = t / (EVAL_THREADS / MAX_POINTS);
    const int i0 = 8 * (t % (EVAL_THREADS / MAX_POINTS));
    if (k < np && i0 < rows) {
      const uint32_t* zp = a.zpow + (T.group * MAX_POINTS + k) *
                                        (LOG_POWERS * 4);
      Ext p{{1u, 0u, 0u, 0u}};     // canonical times Montgomery: canonical
      unsigned long long e = r0 + i0;
      for (int j = 0; e; ++j, e >>= 1)
        if (e & 1) p = bb::ext_mmul(p, ext_word(zp + 4 * j));
      const Ext z = ext_word(zp);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        Ext v[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          v[r] = p;
          p = bb::ext_mmul(p, z);
        }
#pragma unroll
        for (int l = 0; l < 4; ++l) {
          uint32_t o[4];
          transpose4(v[0].c[l], v[1].c[l], v[2].c[l], v[3].c[l], o);
#pragma unroll
          for (int b = 0; b < 4; ++b)
            zs[(b * 8 + k * 4 + l) * Z_LD + i0 / 4 + q] = o[b];
        }
      }
    }
  }

  // the warp's 16 columns and its 32 rows of each stage
  const int mt = warp % m, kr = 32 * (warp / m);
  int acc[4][4][4];  // [byte of A][byte of Z][fragment]
#pragma unroll
  for (int x = 0; x < 4; ++x)
#pragma unroll
    for (int y = 0; y < 4; ++y)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[x][y][r] = 0;
  for (int s = 0; s < stages; ++s) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage s (and Z) in place; stage s - 1 consumed
    issue(s + STAGES - 1);
    if (s * stage_rows + kr >= rows) continue;   // zero rows
    const uint32_t* buf = ring + (s % STAGES) * STAGE_WORDS;
    uint32_t af[4][4];  // [byte plane][fragment register]
#pragma unroll
    for (int rg = 0; rg < 4; ++rg) {
      const int row = kr + 4 * tig + 16 * (rg >> 1);
      const int col = 16 * mt + g + 8 * (rg & 1);
      uint32_t o[4];
      transpose4(buf[a_word(row, col, ct)], buf[a_word(row + 1, col, ct)],
                 buf[a_word(row + 2, col, ct)],
                 buf[a_word(row + 3, col, ct)], o);
#pragma unroll
      for (int b = 0; b < 4; ++b) af[b][rg] = o[b];
    }
    const int zw = (s * stage_rows + kr) / 4 + tig;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const uint32_t* zc = zs + (b * 8 + g) * Z_LD + zw;
      const uint32_t b0 = zc[0], b1 = zc[4];
#pragma unroll
      for (int x = 0; x < 4; ++x) mma_u8(acc[x][b], af[x], b0, b1);
    }
  }
  cp_async_wait<0>();

  // fragment r holds column 16 mt + g + 8 (r / 2) at point k = tig / 2,
  // limb l = 2 (tig % 2) + r % 2: its 16 byte-plane sums, each reduced mod
  // p and scaled by 2^(8(a + b)), give a canonical partial sum
  if (kr < rows) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const long long col = c0 + 16 * mt + g + 8 * (r >> 1);
      const int k = tig >> 1, l = 2 * (tig & 1) + (r & 1);
      if (k >= np || col >= w) continue;
      uint64_t sum = 0;
#pragma unroll
      for (int x = 0; x < 4; ++x)
#pragma unroll
        for (int y = 0; y < 4; ++y)
          sum = bb::fold_hi(sum + bb::wide(bb::reduce1(
                                               static_cast<uint32_t>(
                                                   acc[x][y][r])),
                                           SHIFT_M[x + y]));
      atomicAdd(a.acc + (T.out_row + k * w + col) * 4 + l,
                static_cast<unsigned long long>(bb::redc(sum)));
    }
  }
  // the last block of the column tile writes its columns' outputs
  __threadfence();
  __syncthreads();
  if (t == 0)
    last = atomicAdd(a.counter + tile, 1) == static_cast<int>(T.items) - 1;
  __syncthreads();
  if (!last) return;
  for (int e = t; e < np * cols * 4; e += EVAL_THREADS) {
    const int k = e / (cols * 4), cc = (e / 4) % cols, l = e % 4;
    const long long i = (T.out_row + k * w + c0 + cc) * 4 + l;
    const unsigned long long s = __ldcg(a.acc + i);
    a.out[i] = static_cast<int32_t>(s % bb::P);
    a.acc[i] = 0;
  }
  if (t == 0) a.counter[tile] = 0;
}

template <int NP>
__global__ void __launch_bounds__(REDUCE_ROWS)
    open_reduce_kernel(const ReduceArgs a) {
  constexpr int LD = REDUCE_COLS + 1;
  __shared__ uint32_t tile[REDUCE_ROWS * LD];
  __shared__ uint4 wts[NP * REDUCE_COLS];
  const int t = threadIdx.x;
  const long long big = 1LL << a.log_big;
  const long long r0 = static_cast<long long>(blockIdx.x) * REDUCE_ROWS;
  const int rows = static_cast<int>(
      min(static_cast<long long>(REDUCE_ROWS), big - r0));
  const uint4* weights = reinterpret_cast<const uint4*>(a.weights);
  uint64_t acc[NP][4];
#pragma unroll
  for (int k = 0; k < NP; ++k)
#pragma unroll
    for (int l = 0; l < 4; ++l) acc[k][l] = 0;
  for (long long c0 = 0; c0 < a.w; c0 += REDUCE_COLS) {
    const int cols = static_cast<int>(
        min(static_cast<long long>(REDUCE_COLS), a.w - c0));
    __syncthreads();  // the previous chunk is consumed
    for (int e = t; e < rows * REDUCE_COLS; e += REDUCE_ROWS) {
      const int r = e / REDUCE_COLS, cc = e % REDUCE_COLS;
      if (cc < cols)
        tile[r * LD + cc] =
            static_cast<uint32_t>(__ldg(a.lde + (r0 + r) * a.ld + c0 + cc));
    }
    for (int e = t; e < NP * cols; e += REDUCE_ROWS)
      wts[(e / cols) * REDUCE_COLS + e % cols] =
          __ldg(weights + (e / cols) * a.w + c0 + e % cols);
    __syncthreads();
    if (t < rows) {
      const uint32_t* mine = tile + t * LD;
      for (int cc = 0; cc < cols; ++cc) {
        const uint32_t v = mine[cc];
#pragma unroll
        for (int k = 0; k < NP; ++k) {
          const uint4 wv = wts[k * REDUCE_COLS + cc];
          const uint32_t p[4] = {wv.x, wv.y, wv.z, wv.w};
          mac4(acc[k], v, p);
        }
      }
    }
  }
  if (t >= rows) return;
  const long long row = r0 + t;
  const uint32_t xm = bb::mmul(static_cast<uint32_t>(a.x0),
                               mpow(static_cast<uint32_t>(a.g), row));
  Ext sum = bb::ext_zero();
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    const Ext f{{bb::redc(acc[k][0]), bb::redc(acc[k][1]),
                 bb::redc(acc[k][2]), bb::redc(acc[k][3])}};  // canonical
    const Ext z = ext_at(a.z, k);
    const Ext d{{bb::msub(xm, z.c[0]), bb::mneg(z.c[1]), bb::mneg(z.c[2]),
                 bb::mneg(z.c[3])}};                         // x - z
    // canonical numerator times a Montgomery inverse: canonical
    sum = bb::ext_madd(sum, bb::ext_mmul(bb::ext_msub(f, ext_at(a.ya, k)),
                                         bb::ext_minv(d)));
  }
  uint4* out = reinterpret_cast<uint4*>(a.out) + row;
  if (a.accumulate) sum = bb::ext_madd(sum, ext_of(*out));
  *out = uint4_of(sum);
}

__global__ void __launch_bounds__(FOLD_THREADS)
    fri_fold_kernel(const FoldArgs a) {
  const long long half = 1LL << (a.log_n - 1), quarter = half >> 1;
  const long long i0 = static_cast<long long>(blockIdx.x) * FOLD_THREADS *
                           FOLD_RUN + threadIdx.x;
  if (i0 >= half) return;
  const uint4* pair = reinterpret_cast<const uint4*>(a.pair);
  const uint4* add = reinterpret_cast<const uint4*>(a.add);
  uint4* out = reinterpret_cast<uint4*>(a.out);
  // every load of the run first, so that they are in flight together
  uint4 fx[FOLD_RUN], fm[FOLD_RUN], ad[FOLD_RUN];
#pragma unroll
  for (int r = 0; r < FOLD_RUN; ++r) {
    const long long i = i0 + r * FOLD_THREADS;
    if (i < half) {
      fx[r] = __ldg(pair + 2 * i);
      fm[r] = __ldg(pair + 2 * i + 1);
      ad[r] = add ? __ldg(add + i) : make_uint4(0u, 0u, 0u, 0u);
    }
  }
  // 1/(2x) = (1 / (2 shift)) * g^-i, Montgomery: g^-i0 from the table,
  // then a step of g^-FOLD_THREADS an output (the products overlap the
  // loads above)
  uint32_t inv2x = static_cast<uint32_t>(a.inv_shift2);
  for (int j = 0; (i0 >> j) != 0; ++j)
    if ((i0 >> j) & 1)
      inv2x = bb::mmul(inv2x, static_cast<uint32_t>(a.g_inv[j]));
  const uint32_t step = static_cast<uint32_t>(a.g_inv[LOG_FOLD_THREADS]);
  const Ext beta{{static_cast<uint32_t>(a.beta[0]),
                  static_cast<uint32_t>(a.beta[1]),
                  static_cast<uint32_t>(a.beta[2]),
                  static_cast<uint32_t>(a.beta[3])}};
#pragma unroll
  for (int r = 0; r < FOLD_RUN; ++r) {
    const long long i = i0 + r * FOLD_THREADS;
    if (i >= half) break;
    Ext s, d;
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      const uint32_t x = (&fx[r].x)[l], y = (&fm[r].x)[l];
      s.c[l] = bb::mmul(bb::madd(x, y), TWO_INV_M);
      d.c[l] = bb::mmul(bb::msub(x, y), inv2x);
    }
    const Ext o = bb::ext_madd(bb::ext_madd(s, bb::ext_mmul(d, beta)),
                               ext_of(ad[r]));
    // output i is row i mod n/4, column block i div n/4 of the next pairs
    out[2 * (i & (quarter - 1)) + (i >= quarter)] = uint4_of(o);
    inv2x = bb::mmul(inv2x, step);
  }
}

using lurk::on_device;

// Launches k1(a) or k2(a), the kernel of the args' point count: a group's
// matrices open at zeta and zeta * g, or at one point.
template <typename Args>
int launch_points(long long n, void (*k1)(Args), void (*k2)(Args),
                  dim3 grid, dim3 block, cudaStream_t s, const Args& a) {
  if (n != 1 && n != 2) return static_cast<int>(cudaErrorInvalidValue);
  void (*kernel)(Args) = n == 1 ? k1 : k2;
  kernel<<<grid, block, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Bit d: open_eval_kernel may take EVAL_SMEM bytes of dynamic shared
// memory on device d. Set once per device, never per launch: host threads
// launch at once (parallel/shard_prover.py).
std::atomic<unsigned long long> eval_ready{0};

cudaError_t configure_eval() {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ULL << dev : 0ULL;
  if (eval_ready.load() & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(open_eval_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             EVAL_SMEM);
  if (err == cudaSuccess) eval_ready.fetch_or(bit);
  return err;
}

}  // namespace

extern "C" {

// sizeof the argument structures, for the wrapper's layout check.
long long lurk_open_eval_args_size() { return sizeof(EvalArgs); }
long long lurk_open_reduce_args_size() { return sizeof(ReduceArgs); }
long long lurk_fri_fold_args_size() { return sizeof(FoldArgs); }

// The opened values of every group of args (an EvalArgs, passed as void*:
// a parameter of a type in the unnamed namespace would take the
// function's external linkage away) at its points, written to args->out,
// in one launch of args->blocks blocks of EVAL_THREADS threads. Launches
// on `stream` (a stream of `device`) without synchronising; the caller's
// current device is unchanged on return. Returns a cudaError_t (0 on
// success).
int lurk_open_eval(int device, const void* args, void* stream) {
  const EvalArgs& a = *static_cast<const EvalArgs*>(args);
  if (a.n_tiles < 1 || a.blocks < 1 || a.blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return on_device(device, [&]() -> int {
    cudaError_t err = configure_eval();
    if (err != cudaSuccess) return static_cast<int>(err);
    open_eval_kernel<<<static_cast<unsigned>(a.blocks), EVAL_THREADS,
                       EVAL_SMEM, s>>>(a);
    return static_cast<int>(cudaGetLastError());
  });
}

// One group's reduced openings added into (or, with accumulate = 0,
// written to)
// args->out (a ReduceArgs): 2^log_big / REDUCE_ROWS blocks of REDUCE_ROWS
// threads. Launches as lurk_open_eval does.
int lurk_open_reduce(int device, const void* args, void* stream) {
  const ReduceArgs& a = *static_cast<const ReduceArgs*>(args);
  if (a.w < 1 || a.log_big < 0 || a.log_big > 30)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long big = 1LL << a.log_big;
  const dim3 grid(static_cast<unsigned>((big + REDUCE_ROWS - 1) / REDUCE_ROWS));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return on_device(device, [&]() -> int {
    return launch_points(a.n_points, open_reduce_kernel<1>,
                         open_reduce_kernel<2>, grid, dim3(REDUCE_ROWS), s,
                         a);
  });
}

// One FRI fold (a FoldArgs) of a layer's pair matrix into the next
// layer's, with the next height's input codeword added where args->add is
// not null: 2^(log_n - 1) / (FOLD_THREADS * FOLD_RUN) blocks. Launches as
// lurk_open_eval does.
int lurk_fri_fold(int device, const void* args, void* stream) {
  const FoldArgs& a = *static_cast<const FoldArgs*>(args);
  if (a.log_n < 2 || a.log_n > 31)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long half = 1LL << (a.log_n - 1);
  const long long per_block = FOLD_THREADS * FOLD_RUN;
  const dim3 grid(static_cast<unsigned>((half + per_block - 1) / per_block));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return on_device(device, [&]() -> int {
    fri_fold_kernel<<<grid, FOLD_THREADS, 0, s>>>(a);
    return static_cast<int>(cudaGetLastError());
  });
}

}  // extern "C"
