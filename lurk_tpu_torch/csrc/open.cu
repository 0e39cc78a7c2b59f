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
// of their results into the reduced codewords. For every row x of the
// coset GENERATOR * <g_H> of every height H, over the (H, w) LDEs of the
// height's groups in every round of a shard,
//   ro[H][x] = sum_groups sum_k (sum_c W[k, c] * lde[x, c] - ya[k]) / (x - z_k)
// with 1/0 taken as 0, as einv does, in ONE launch; the weights W are
// alpha^(o + e), made on the card from one scalar alpha^o a segment.
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
// open_reduce. Its function is the same kind of product, transposed: an
// (H x w) LDE times a (w x 4 points) matrix of extension weights, four
// bytes read per 16 base products. On the CUDA cores (its first version:
// 31-bit Montgomery products, one launch a group, synchronous tile loads,
// a domain power and an extension inverse per row and point) it ran at
// about a third of its bytes bound. Here:
// - The products go to the tensor cores as open_eval's do, exactly, with
//   u8 x u8 -> s32 mma.sync m16n8k32: A is a stage of the LDE (M = 16
//   rows a warp, K = 32 columns, the fast index of the row-major slice;
//   one 16-byte word is four columns of a row, byte-transposed by prmt
//   into the four planes' registers), B the weights' byte planes (N =
//   2 slots x 4 limbs an n-tile; a chunk takes the one or two n-tiles
//   its segments' slots need, so the quotient round's third point costs
//   its own chunks' MMAs only). The 16 plane pairs
//   (a, b) of one a + b share an s32 sum: 4 * 255^2 * 32 * FLUSH_CHUNKS <
//   2^31, so every FLUSH_CHUNKS stages each sum is reduced mod p, scaled
//   by 2^(8(a+b)) and added into a canonical one; there is no width limit.
// - mma.sync rather than wgmma, for open_eval's reasons: skinny products
//   (N = 8 or 16) on operands that need a byte transpose in registers.
// - One launch a shard: a work item is REDUCE_ROWS rows of one output
//   height, through a table of heights (their codewords, distinct points
//   and y_alpha), of column chunks (a group's REDUCE_COLS columns) and of
//   weight segments. An item sums every group of its height into the same
//   accumulators (groups that share a point share its numerator) and
//   writes each row of ro once: no read-modify-write per group.
// - Persistent blocks: the launch has as many blocks as the card holds
//   at once (small ones, 4 warps of 16 rows, four an SM), and each draws
//   tickets from an atomic counter until they run out, heavy heights
//   first. A block draws its next ticket while it streams an item and
//   issues the next item's first stages before the last one's epilogue,
//   so copies stay in flight across items.
// - LDE stages come in by cp.async into a ring of REDUCE_STAGES (16-, 8-
//   or 4-byte copies, as the slice's stride and address allow; ragged
//   rows and columns zero-filled), XOR-swizzled so fragment loads hit 32
//   banks.
// - Weights are made on the card, in the same launch: the first tickets
//   each make the B planes of WEIGHT_CHUNKS chunks into a small global
//   buffer (a table of alpha^e from alpha^(2^j); per column and slot,
//   a * alpha^(c - c0) summed over the segments that hold it; four lanes
//   byte-transpose one limb of four columns). A block's first row item
//   waits for those tickets, which were drawn before its own by running
//   blocks that wait for nothing, then copies each stage's planes beside
//   its LDE words. (Made by every block for every stage, the weights sat
//   on each stage's critical path.)
// - The stages' sources (a chunk's address, stride and width) are read
//   an iteration ahead of their copies.
// - Denominators once per (row, distinct point), a thread a row: x =
//   GENERATOR * g^row from the table of generators (the item's first
//   row once, then each row's low bits; no squarings), and every x - z of
//   the item inverted as one Montgomery batch (warp shuffles for the
//   prefix and suffix products, the warps' products combined by a lane
//   each, one extension inverse an item; a zero denominator counts as one
//   in the batch and its inverse as zero).
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
constexpr int HEIGHT_WORDS = 39;   // ... of a ReduceHeight
constexpr int CHUNK_WORDS = 8;     // ... of a ReduceChunk
constexpr int SEG_WORDS = 7;       // ... of a ReduceSeg
constexpr int REDUCE_THREADS = 128;  // threads of an open_reduce block
constexpr int REDUCE_WARPS = REDUCE_THREADS / 32;
constexpr int REDUCE_ROWS = 64;      // rows of a block: 16 a warp
constexpr int ROW_WARPS = REDUCE_ROWS / 32;  // a row a thread at the end
constexpr int REDUCE_COLS = 32;      // LDE columns of a stage: the MMA's K
constexpr int REDUCE_STAGES = 4;     // the cp.async ring
constexpr int RSTAGE_WORDS = REDUCE_ROWS * REDUCE_COLS;
constexpr int MAX_SLOTS = 4;         // distinct points of one height
constexpr int N_TILES = MAX_SLOTS / 2;  // n-tiles of 8: 2 slots x 4 limbs
constexpr int WB_WORDS = N_TILES * 4 * 8 * 8;  // a stage's weight planes
constexpr int MAX_SEG_W = 256;       // columns of a weight segment
constexpr int LOG_SEG = 8;
constexpr int FLUSH_CHUNKS = 256;    // stages summed in s32 between flushes
constexpr int WEIGHT_CHUNKS = 8;     // chunks of a weight ticket
constexpr int REDUCE_SMEM =
    4 * (REDUCE_STAGES * (RSTAGE_WORDS + WB_WORDS) + 4 * 2 * REDUCE_WARPS);
constexpr int FOLD_THREADS = 256;
constexpr int LOG_FOLD_THREADS = 8;
constexpr int FOLD_RUN = 4;       // outputs of a fri_fold thread
constexpr uint32_t TWO_INV_M = 134217727u;  // 1/2 in Montgomery form

static_assert((1 << LOG_FOLD_THREADS) == FOLD_THREADS, "FOLD_THREADS");
static_assert(Z_LD % 32 == 4, "Z_LD: a warp's B loads hit 32 banks");
static_assert(REDUCE_ROWS == 16 * REDUCE_WARPS, "REDUCE_ROWS: 16 a warp");
static_assert(REDUCE_ROWS % 32 == 0 && REDUCE_ROWS < REDUCE_THREADS,
              "the epilogue's warps");
static_assert(1 << LOG_SEG == MAX_SEG_W, "LOG_SEG");
static_assert(16 * (MAX_SEG_W + REDUCE_WARPS * REDUCE_COLS) <= REDUCE_SMEM,
              "a weight ticket's tables fit a row item's shared memory");
// an s32 sum takes the four (a, b) byte planes of one a + b over
// FLUSH_CHUNKS stages: exact below 2^31
static_assert(4LL * 255 * 255 * REDUCE_COLS * FLUSH_CHUNKS < (1LL << 31),
              "FLUSH_CHUNKS");

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

// One output height: its codeword and the points of its groups.
struct ReduceHeight {
  int32_t* out;              // (2^log_h, 4)
  const int32_t* add;        // (2^log_h, 4) added into out, or null
  long long log_h;
  long long n_slots;         // the height's distinct points, 1 to MAX_SLOTS
  long long first_chunk;     // its column chunks in ReduceArgs::chunks
  long long chunks;
  long long first_block;     // row items of the heights before this one
  long long z[MAX_SLOTS * 4];   // the points, Montgomery
  long long ya[MAX_SLOTS * 4];  // y_alpha of each point, summed over groups
};

// REDUCE_COLS columns of one group's LDE.
struct ReduceChunk {
  const int32_t* lde;        // the group's (2^log_h, w) slice, row stride ld
  long long ld;
  long long w;
  long long c0;              // the chunk's first column
  long long vec;             // words a copy: 4, 2 or 1
  long long tiles;           // n-tiles its segments' slots need: 1 or 2
  long long first_seg;       // the segments that meet the chunk
  long long segs;
};

// Weights a * alpha^e of columns c0 + e, e < w, of a group at one slot.
struct ReduceSeg {
  long long c0;
  long long w;               // at most MAX_SEG_W
  long long slot;
  long long a[4];            // alpha^o, Montgomery
};

struct ReduceArgs {
  const ReduceHeight* heights;  // (n_heights,)
  const ReduceChunk* chunks;    // each height's in turn
  const ReduceSeg* segs;        // each chunk's in turn
  uint32_t* wts;                // (n_chunks, WB_WORDS): the weight planes
  int* ctr;                     // (3,): tickets, weight tickets done,
                                // blocks done; zero before the launch
  long long n_heights;
  long long n_chunks;
  long long wblocks;            // weight tickets: WEIGHT_CHUNKS chunks each
  long long blocks;             // row items
  long long seg_w;              // the widest segment: alpha^e table rows
  long long x0;                 // GENERATOR, Montgomery
  long long gens[LOG_POWERS];   // g_k, the generator of order 2^k, Montgomery
  long long apow[LOG_SEG * 4];  // alpha^(2^j), Montgomery
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
static_assert(sizeof(ReduceHeight) == 8 * HEIGHT_WORDS, "ReduceHeight");
static_assert(sizeof(ReduceChunk) == 8 * CHUNK_WORDS, "ReduceChunk");
static_assert(sizeof(ReduceSeg) == 8 * SEG_WORDS, "ReduceSeg");

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

// ---------------------------------------------------------------------------
// open_reduce
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async8(uint32_t* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(bytes)
               : "memory");
}

// The first word of 4-word chunk q of a staged row (REDUCE_COLS words): the
// chunk's place XORed with 4 * (row % 2), so that the 8 lanes of a quarter
// warp's 16-byte fragment loads (rows r, r + 1 by 4 chunks) hit 32 banks.
__device__ __forceinline__ int r_word(int row, int q) {
  return row * REDUCE_COLS + ((q ^ ((row & 1) << 2)) << 2);
}

// The word of a stage's weight planes that holds byte plane b of column
// n (slot 4 n_tile + n / 4, limb n % 4) at the stage's columns 4 kw ..
// 4 kw + 3: a lane's two B registers (kw = tig, tig + 4) side by side.
__device__ __forceinline__ int wb_word(int nt, int b, int n, int kw) {
  return ((nt * 4 + b) * 8 + n) * 8 + 2 * (kw & 3) + (kw >> 2);
}

__device__ __forceinline__ Ext shfl_up_ext(const Ext& v, int d) {
  return Ext{{__shfl_up_sync(0xffffffffu, v.c[0], d),
              __shfl_up_sync(0xffffffffu, v.c[1], d),
              __shfl_up_sync(0xffffffffu, v.c[2], d),
              __shfl_up_sync(0xffffffffu, v.c[3], d)}};
}

__device__ __forceinline__ Ext shfl_down_ext(const Ext& v, int d) {
  return Ext{{__shfl_down_sync(0xffffffffu, v.c[0], d),
              __shfl_down_sync(0xffffffffu, v.c[1], d),
              __shfl_down_sync(0xffffffffu, v.c[2], d),
              __shfl_down_sync(0xffffffffu, v.c[3], d)}};
}

// A weight ticket: the B planes of chunks WEIGHT_CHUNKS * ticket .. + 8,
// written to args.wts. Warp w makes slot w % MAX_SLOTS of the ticket's
// chunks (every REDUCE_WARPS / MAX_SLOTS-th from w / MAX_SLOTS): lane c sums a * alpha^(c - c0) over the chunk's segments of the
// slot that hold column c (zero past the group's columns and for slots
// past the height's points), then four lanes byte-transpose one limb of
// four columns. alpha^e comes from a table made once a ticket.
__device__ void make_weights(const ReduceArgs& a, int ticket,
                             uint32_t* smem) {
  uint4* ptab = reinterpret_cast<uint4*>(smem);       // (MAX_SEG_W,)
  uint4* wv = ptab + MAX_SEG_W;                       // (REDUCE_WARPS, 32)
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  for (int e = t; e < a.seg_w; e += REDUCE_THREADS) {
    Ext p{{1u, 0u, 0u, 0u}};                          // canonical
    for (int j = 0; (e >> j) != 0; ++j)
      if ((e >> j) & 1) p = bb::ext_mmul(p, ext_at(a.apow, j));
    ptab[e] = uint4_of(p);
  }
  __syncthreads();
  const int j = warp % MAX_SLOTS;
  const long long last = min(a.n_chunks,
                             static_cast<long long>(ticket + 1) *
                                 WEIGHT_CHUNKS);
  for (long long q = static_cast<long long>(ticket) * WEIGHT_CHUNKS +
                     warp / MAX_SLOTS;
       q < last; q += REDUCE_WARPS / MAX_SLOTS) {
    const ReduceChunk& C = a.chunks[q];
    const long long c = C.c0 + lane;
    Ext sum = bb::ext_zero();
    for (long long i = C.first_seg; i < C.first_seg + C.segs; ++i) {
      const ReduceSeg& S = a.segs[i];
      const long long e = c - S.c0;
      if (S.slot == j && e >= 0 && e < S.w)
        sum = bb::ext_madd(sum, bb::ext_mmul(ext_at(S.a, 0), ext_of(ptab[e])));
    }
    uint4* mine = wv + warp * REDUCE_COLS;
    mine[lane] = uint4_of(sum);
    __syncwarp();
    const int kw = lane >> 2, l = lane & 3;
    const uint32_t* v = reinterpret_cast<const uint32_t*>(mine + 4 * kw);
    uint32_t o[4];
    transpose4(v[l], v[4 + l], v[8 + l], v[12 + l], o);
    uint32_t* dst = a.wts + q * WB_WORDS;
#pragma unroll
    for (int b = 0; b < 4; ++b)
      dst[wb_word(j >> 1, b, 4 * (j & 1) + l, kw)] = o[b];
    __syncwarp();
  }
  __threadfence();  // the planes before the count that publishes them
  __syncthreads();
  if (t == 0) atomicAdd(a.ctr + 1, 1);
}

// Where a stage's LDE words come from: the chunk's columns at the block's
// first row.
struct Src {
  const int32_t* base;
  long long ld;
  int cols;
  int vec;
  int tiles;
};

// The barrier of the warps that hold a row each (named barrier 1).
__device__ __forceinline__ void rows_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(REDUCE_ROWS) : "memory");
}

// An item's rows from its numerators, a thread a row (warps 0 ..
// ROW_WARPS - 1): x - z for every row and slot, inverted as one
// Montgomery batch over the item (each thread's running product over its
// slots, a zero replaced by one; the warp's exclusive prefix and suffix
// products by shuffles; per warp, the inverse of the item's product times
// the other warps' products, one inverse an item), then each slot's
// numerator less
// y_alpha times its inverse (0 for x = z), summed, plus the addend,
// written once. x0 is x of the item's first row.
__device__ void reduce_epilogue(const ReduceArgs& a, const ReduceHeight& H,
                                long long r0, int rows, int ns, uint32_t x0,
                                const uint32_t* num, uint4* tot, uint4* fac) {
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const bool live = t < rows;
  const Ext one{{bb::ONE_M, 0u, 0u, 0u}};
  // x = x0 * g^t from the table of generators, g^(2^j) = g_(log_h - j)
  uint32_t xm = x0;
  if (live)
    for (int j = 0; (t >> j) != 0; ++j)
      if ((t >> j) & 1)
        xm = bb::mmul(xm, static_cast<uint32_t>(a.gens[H.log_h - j]));
  Ext d[MAX_SLOTS], pre[MAX_SLOTS];
  bool zero[MAX_SLOTS];
  Ext run = one;
#pragma unroll
  for (int j = 0; j < MAX_SLOTS; ++j) {
    d[j] = one;
    zero[j] = false;
    if (live && j < ns) {
      const Ext z = ext_at(H.z, j);
      d[j] = Ext{{bb::msub(xm, z.c[0]), bb::mneg(z.c[1]), bb::mneg(z.c[2]),
                  bb::mneg(z.c[3])}};
      zero[j] = (d[j].c[0] | d[j].c[1] | d[j].c[2] | d[j].c[3]) == 0u;
      if (zero[j]) d[j] = one;
    }
    pre[j] = run;
    if (j < ns) run = bb::ext_mmul(run, d[j]);
  }
  // each lane's exclusive prefix and suffix products over the lanes of
  // its warp
  Ext inc = run, suf = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const Ext y = shfl_up_ext(inc, o), u = shfl_down_ext(suf, o);
    if (lane >= o) inc = bb::ext_mmul(inc, y);
    if (lane + o < 32) suf = bb::ext_mmul(suf, u);
  }
  Ext before = shfl_up_ext(inc, 1), after = shfl_down_ext(suf, 1);
  if (lane == 0) before = one;
  if (lane == 31) after = one;
  if (lane == 31) tot[warp] = uint4_of(inc);
  rows_sync();
  if (warp == 0 && lane < ROW_WARPS) {
    // fac[w] = (the item's product)^-1 * the other warps' products
    Ext total = one, others = one;
#pragma unroll
    for (int w = 0; w < ROW_WARPS; ++w) {
      total = bb::ext_mmul(total, ext_of(tot[w]));
      if (w != lane) others = bb::ext_mmul(others, ext_of(tot[w]));
    }
    fac[lane] = uint4_of(bb::ext_mmul(bb::ext_minv(total), others));
  }
  rows_sync();
  if (!live) return;
  // 1 / run, then each slot's 1 / (x - z) from the back, times its
  // numerator less y_alpha: canonical
  Ext inv = bb::ext_mmul(bb::ext_mmul(ext_of(fac[warp]), before), after);
  Ext sum = bb::ext_zero();
  const uint4* mine = reinterpret_cast<const uint4*>(num) + t * MAX_SLOTS;
#pragma unroll
  for (int j = MAX_SLOTS - 1; j >= 0; --j) {
    if (j >= ns) continue;
    Ext ij = bb::ext_mmul(inv, pre[j]);
    inv = bb::ext_mmul(inv, d[j]);
    if (zero[j]) ij = bb::ext_zero();
    sum = bb::ext_madd(sum, bb::ext_mmul(bb::ext_msub(ext_of(mine[j]),
                                                       ext_at(H.ya, j)),
                                         ij));
  }
  const long long row = r0 + t;
  if (H.add)
    sum = bb::ext_madd(sum, ext_of(reinterpret_cast<const uint4*>(H.add)[row]));
  reinterpret_cast<uint4*>(H.out)[row] = uint4_of(sum);
}

// Row items, REDUCE_ROWS rows of one height each, every chunk of the
// height, from `ticket` on: the block draws its next ticket while it
// streams an item, and issues the next item's first stages before it
// finishes the last one's rows, so that the copies run under the
// epilogue.
__device__ void reduce_rows(const ReduceArgs& a, int ticket,
                            uint32_t* smem) {
  uint32_t* ring = smem;                              // stages of LDE rows
  uint32_t* wb = ring + REDUCE_STAGES * RSTAGE_WORDS;  // their weight planes
  uint4* tot = reinterpret_cast<uint4*>(wb + REDUCE_STAGES * WB_WORDS);
  uint4* fac = tot + REDUCE_WARPS;                    // (REDUCE_WARPS,)
  // the numerators, (REDUCE_ROWS, MAX_SLOTS, 4) canonical, in the last
  // stage's place: the next item's first stages take the others
  uint32_t* num = ring + (REDUCE_STAGES - 1) * RSTAGE_WORDS;
  __shared__ int stiles[REDUCE_STAGES];              // each stage's n-tiles
  __shared__ int next_ticket;
  __shared__ uint32_t xr0;                           // x of the first row
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int g = lane >> 2, tig = lane & 3;

  // every weight ticket was drawn before this block's first row ticket:
  // wait for their planes (they run, and wait for nothing)
  if (t == 0) {
    while (*reinterpret_cast<volatile int*>(a.ctr + 1) < a.wblocks)
      __nanosleep(256);
    __threadfence();
  }
  __syncthreads();

  // the item's place
  const ReduceHeight* H = nullptr;
  long long r0 = 0;
  int rows = 0, nch = 0, ns = 0;
  const ReduceChunk* chunks = nullptr;
  const uint32_t* wts = nullptr;
  auto place = [&](int item) {
    int hi = 0;
    while (hi + 1 < a.n_heights && a.heights[hi + 1].first_block <= item)
      ++hi;
    H = a.heights + hi;
    r0 = (item - H->first_block) * REDUCE_ROWS;
    rows = static_cast<int>(min(static_cast<long long>(REDUCE_ROWS),
                                (1LL << H->log_h) - r0));
    nch = static_cast<int>(H->chunks);
    ns = static_cast<int>(H->n_slots);
    chunks = a.chunks + H->first_chunk;
    wts = a.wts + H->first_chunk * WB_WORDS;
  };
  auto source = [&](int s) {
    const ReduceChunk& C = chunks[s];
    return Src{C.lde + r0 * C.ld + C.c0, C.ld,
               static_cast<int>(min(static_cast<long long>(REDUCE_COLS),
                                    C.w - C.c0)),
               static_cast<int>(C.vec), static_cast<int>(C.tiles)};
  };
  // stage s: chunk s's REDUCE_COLS columns of the block's rows (zero past
  // the height's rows and the group's columns), in copies of S.vec words,
  // and the weight planes of the n-tiles its segments use (the others are
  // zero: their MMAs are skipped), 16 bytes a thread
  auto issue = [&](int s, const Src& S) {
    if (s < nch) {
      uint32_t* buf = ring + (s % REDUCE_STAGES) * RSTAGE_WORDS;
      if (S.vec == 4) {
        for (int e = t; e < REDUCE_ROWS * 8; e += REDUCE_THREADS) {
          const int row = e >> 3, q = e & 7;
          const int n = row < rows ? max(0, min(4, S.cols - 4 * q)) : 0;
          cp_async16(buf + r_word(row, q), n ? S.base + row * S.ld + 4 * q
                                             : S.base, 4 * n);
        }
      } else if (S.vec == 2) {
        for (int e = t; e < REDUCE_ROWS * 16; e += REDUCE_THREADS) {
          const int row = e >> 4, col = 2 * (e & 15);
          const int n = row < rows ? max(0, min(2, S.cols - col)) : 0;
          cp_async8(buf + r_word(row, col >> 2) + (col & 3),
                    n ? S.base + row * S.ld + col : S.base, 4 * n);
        }
      } else {
        for (int e = t; e < RSTAGE_WORDS; e += REDUCE_THREADS) {
          const int row = e >> 5, col = e & 31;
          const bool live = row < rows && col < S.cols;
          cp_async4(buf + r_word(row, col >> 2) + (col & 3),
                    live ? S.base + row * S.ld + col : S.base,
                    live ? 4 : 0);
        }
      }
      if (t < S.tiles * (WB_WORDS / N_TILES / 4))
        cp_async16(wb + (s % REDUCE_STAGES) * WB_WORDS + 4 * t,
                   wts + static_cast<long long>(s) * WB_WORDS + 4 * t, 16);
      if (t == 0) stiles[s % REDUCE_STAGES] = S.tiles;
    }
    cp_async_commit();
  };
  // an item's first stages; the next chunk's source is read an iteration
  // ahead of its stage
  Src next;
  auto start = [&]() {
    next = source(0);
#pragma unroll
    for (int s = 0; s < REDUCE_STAGES - 1; ++s) {
      issue(s, next);
      if (s + 1 < nch) next = source(s + 1);
    }
  };
  place(ticket - static_cast<int>(a.wblocks));
  start();

  while (true) {
    // the ticket after this item's, drawn while it streams
    int drawn = 0;
    if (t == 0) drawn = atomicAdd(a.ctr, 1);
    // acc[a + b][nt]: byte plane a of the LDE times byte plane b of the
    // weights, for the warp's 16 rows and n-tile nt (slots 2 nt, 2 nt + 1
    // by 4 limbs), summed in s32 over at most FLUSH_CHUNKS stages; part:
    // the canonical sums of the flushed stages
    int acc[7][N_TILES][4];
    uint32_t part[N_TILES][4];
#pragma unroll
    for (int nt = 0; nt < N_TILES; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        part[nt][r] = 0u;
#pragma unroll
        for (int x = 0; x < 7; ++x) acc[x][nt][r] = 0;
      }
    auto flush = [&]() {
#pragma unroll
      for (int nt = 0; nt < N_TILES; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          uint64_t sum = 0;
#pragma unroll
          for (int x = 0; x < 7; ++x) {
            sum = bb::fold_hi(sum + bb::wide(bb::reduce1(
                                                 static_cast<uint32_t>(
                                                     acc[x][nt][r])),
                                             SHIFT_M[x]));
            acc[x][nt][r] = 0;
          }
          part[nt][r] = bb::madd(part[nt][r], bb::redc(sum));
        }
    };
    const bool busy = 16 * warp < rows;
    int since = 0;
    for (int s = 0; s < nch; ++s) {
      cp_async_wait<REDUCE_STAGES - 2>();
      __syncthreads();  // stage s in place; stage s - 1 consumed
      issue(s + REDUCE_STAGES - 1, next);
      if (s + REDUCE_STAGES < nch) next = source(s + REDUCE_STAGES);
      if (busy) {
        const uint32_t* buf = ring + (s % REDUCE_STAGES) * RSTAGE_WORDS;
        const uint32_t* wbs = wb + (s % REDUCE_STAGES) * WB_WORDS;
        const int tiles = stiles[s % REDUCE_STAGES];
        // A: rows g, g + 8 of the warp's 16 by columns 4 tig (+ 16): four
        // words of a row, byte-transposed into the four planes' registers
        uint32_t af[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint4 v = *reinterpret_cast<const uint4*>(
              buf + r_word(16 * warp + g + 8 * (i & 1), tig + 4 * (i >> 1)));
          uint32_t o[4];
          transpose4(v.x, v.y, v.z, v.w, o);
#pragma unroll
          for (int x = 0; x < 4; ++x) af[x][i] = o[x];
        }
#pragma unroll
        for (int nt = 0; nt < N_TILES; ++nt) {
          if (nt >= tiles) break;
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const uint2 bv = *reinterpret_cast<const uint2*>(
                wbs + wb_word(nt, b, g, tig));
#pragma unroll
            for (int x = 0; x < 4; ++x)
              mma_u8(acc[x + b][nt], af[x], bv.x, bv.y);
          }
        }
      }
      if (++since == FLUSH_CHUNKS) {
        flush();
        since = 0;
      }
    }
    cp_async_wait<0>();
    flush();
    __syncthreads();  // every warp is past its last stage: the ring is free

    // D's register r: row g + 8 (r / 2), slot 2 nt + tig / 2, limb
    // 2 (tig % 2) + r % 2
#pragma unroll
    for (int nt = 0; nt < N_TILES; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = 16 * warp + g + 8 * (r >> 1);
        const int j = 2 * nt + (tig >> 1), l = 2 * (tig & 1) + (r & 1);
        num[(row * MAX_SLOTS + j) * 4 + l] = part[nt][r];
      }
    if (t == 0) {
      next_ticket = drawn;
      // x of the item's first row: GENERATOR * g^r0 from the table of
      // generators, g^(2^j) = g_(log_h - j), no squarings
      uint32_t x = static_cast<uint32_t>(a.x0);
      for (int j = 0; (r0 >> j) != 0; ++j)
        if ((r0 >> j) & 1)
          x = bb::mmul(x, static_cast<uint32_t>(a.gens[H->log_h - j]));
      xr0 = x;
    }
    __syncthreads();
    // this item's place, for its epilogue; then the next item's first
    // stages, in flight under it
    const ReduceHeight* const Hc = H;
    const long long rc = r0;
    const int rows_c = rows, ns_c = ns;
    const uint32_t x0 = xr0;
    const int item = next_ticket - static_cast<int>(a.wblocks);
    const bool more = item < a.blocks;
    if (more) {
      place(item);
      start();
    }
    if (warp < ROW_WARPS)
      reduce_epilogue(a, *Hc, rc, rows_c, ns_c, x0, num, tot, fac);
    if (!more) break;
  }
}

// Each block draws tickets until they run out: the first wblocks make the
// weight planes, the rest are row items; the last block to finish sets
// the counters back to zero, so the same arguments may be launched again.
__global__ void __launch_bounds__(REDUCE_THREADS, 4)
    open_reduce_kernel(const ReduceArgs a) {
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ int ticket;
  while (true) {
    if (threadIdx.x == 0) ticket = atomicAdd(a.ctr, 1);
    __syncthreads();
    const int mine = ticket;
    __syncthreads();  // every thread has read it
    if (mine >= a.wblocks) {
      if (mine < a.wblocks + a.blocks) reduce_rows(a, mine, smem);
      break;
    }
    make_weights(a, mine, smem);
  }
  __syncthreads();
  if (threadIdx.x == 0 &&
      atomicAdd(a.ctr + 2, 1) == static_cast<int>(gridDim.x) - 1) {
    a.ctr[0] = 0;
    a.ctr[1] = 0;
    a.ctr[2] = 0;
  }
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

// Bit d of `ready`: `kernel` may take `smem` bytes of dynamic shared
// memory on device d. Set once per device and kernel, never per launch:
// host threads launch at once (parallel/shard_prover.py).
std::atomic<unsigned long long> eval_ready{0}, reduce_ready{0};

template <typename Kernel>
cudaError_t configure(Kernel kernel, int smem,
                      std::atomic<unsigned long long>& ready) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ULL << dev : 0ULL;
  if (ready.load() & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err == cudaSuccess) ready.fetch_or(bit);
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
    cudaError_t err = configure(open_eval_kernel, EVAL_SMEM, eval_ready);
    if (err != cudaSuccess) return static_cast<int>(err);
    open_eval_kernel<<<static_cast<unsigned>(a.blocks), EVAL_THREADS,
                       EVAL_SMEM, s>>>(a);
    return static_cast<int>(cudaGetLastError());
  });
}

// The reduced codeword of every height of args (a ReduceArgs), written to
// each height's out (plus its add, where not null), in one launch of as
// many blocks of REDUCE_THREADS threads as the device holds at once (at
// most one a ticket: args->wblocks + args->blocks). Launches as
// lurk_open_eval does.
int lurk_open_reduce(int device, const void* args, void* stream) {
  const ReduceArgs& a = *static_cast<const ReduceArgs*>(args);
  if (a.n_heights < 1 || a.blocks < 1 || a.n_chunks < 1 ||
      a.wblocks != (a.n_chunks + WEIGHT_CHUNKS - 1) / WEIGHT_CHUNKS ||
      a.seg_w < 1 || a.seg_w > MAX_SEG_W ||
      a.wblocks + a.blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return on_device(device, [&]() -> int {
    cudaError_t err = configure(open_reduce_kernel, REDUCE_SMEM,
                                reduce_ready);
    int dev = 0, sms = 0, per_sm = 0;
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, open_reduce_kernel, REDUCE_THREADS, REDUCE_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    // as many blocks as the card holds at once, each drawing tickets
    const long long grid = min(a.wblocks + a.blocks,
                               static_cast<long long>(max(1, sms * per_sm)));
    open_reduce_kernel<<<static_cast<unsigned>(grid), REDUCE_THREADS,
                         REDUCE_SMEM, s>>>(a);
    return static_cast<int>(cudaGetLastError());
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
