// The prover's constraint quotient and LogUp perm trace for NVIDIA Hopper
// (sm_90a): two kernels over one chip's rows, BabyBear in Montgomery form.
//
// constraint_quotient replaces lurk_tpu's jitted constraint VM and
// perm-quotient (lurk_tpu/stark/device_prover.py: _vm_fn, a lax.scan over
// the chip's linearized ops, and _pq_fn, both run per row window by
// device_quotient_chunk_vm). For LDE row i of one chip it computes the
// alpha-fold of every constraint of the chip's AIR and of its LogUp
// perm-quotient:
//   sum_c wbase[c] * reg_c
//   + sum_b wb[b] * (phi_b * d_2b * d_2b+1 - (d_2b+1 * m_2b + d_2b * m_2b+1))
//   + wsel[0] * first * (s - sum_b phi_b)
//   + wsel[1] * transition * (s' - s - sum_b phi'_b)
//   + wsel[2] * last * (s - cum)
// where reg_c is what the VM program (stark/constraint_vm.py) leaves in
// register c, phi and s are the perm LDE's batch and running-sum columns,
// ' marks the next row (i + stride) mod big, and d, m are the affine plan's
// fingerprints and multiplicities (logup/affine.py, padded partners with
// d = 1, m = 0).
//
// logup_perm_phi replaces lurk_tpu's jitted perm trace (_generic_perm_fn
// via device_perm_trace_plan). For trace row i it writes
//   phi_b = m_2b / d_2b + m_2b+1 / d_2b+1      (1/0 taken as 0)
// into the perm matrix's first 4 nb columns; the running sum stays a torch
// scan.
//
// What bounds them on this card: field operations. Per LDE row of
// eval_builtin_expr the quotient needs about 13,000 products (the VM's
// 1,189, the fold's 2,464, the fingerprints' 4,616 ext-by-base, the
// batches' ext products) on a few hundred bytes of input, and the perm
// trace about 600 per interaction. The design spends the card's issue
// slots on those products, keeps every operand on chip, and leaves one
// limit: the rows an SM holds (their tiles fill its shared memory), whose
// dependent multiply chains are what the schedulers wait on.
//
// - Rows and registers on chip. A block of T threads takes T consecutive
//   LDE rows. It copies the rows' X = [main | prep | first | last |
//   transition | ones] and the `stride` rows after them (wrapping at the
//   end of the LDE) into shared memory with cp.async, a warp's copies side
//   by side in device memory, then each thread converts whole rows to
//   Montgomery form in place. Row r of the tile holds [X (Wx words) |
//   scratch (S words)] at a row stride `ld` that is odd, so the threads of
//   a warp, each reading its own row at one column, hit 32 different
//   banks. The VM's constants sit before the tile.
// - A compiled program (stark/quotient_kernel.py). The host renumbers the
//   VM's scratch registers to the S the program uses, and turns every
//   write of a constraint register that is written once and never read
//   into a fold-on-write: the op adds wbase[c] * v to the thread's four
//   64-bit sums and stores nothing. An op is two words: two 16-bit
//   operand offsets (into the thread's tile row, the next row at stride *
//   ld, or the constant table), the destination, the opcode and flags.
// - Everything every thread reads alike is staged in shared memory by
//   the block: the op stream in chunks of OP_CHUNK ops with the fold
//   weights they use, and the plan's records, a few batches (or G
//   interactions) at a time. Read from device memory instead, through the
//   small L1 that the tiles leave, each such load would wait on L2.
// - Montgomery products with lazy reduction (babybear.cuh): one reduction
//   per product, one per ext coefficient of four products, and the fold's
//   sums reduced once at the end. The fold weights stay canonical, so the
//   output comes out canonical.
// - The fingerprints and multiplicities run over per-interaction lists of
//   the plan's nonzero terms (no padded terms).
// - The perm trace inverts its fingerprints with Montgomery's trick over
//   groups of G = 8 interactions a thread, the prefix products in
//   registers (the register budget: 127 a thread): one extension inverse
//   per group and row (41 products) and three extension products per
//   interaction, where a Fermat inverse each cost about 150 products. A
//   zero fingerprint enters the product as 1 and gets a zero inverse; a
//   constant fingerprint (no row-varying term) is inverted once by the
//   wrapper and only scaled by its multiplicity.
//
// The perm-LDE rows (phi, s) are read by each thread from device memory,
// 16 bytes per batch in its own row (one load where the slice's base and
// row stride are 16-byte aligned), not staged in the tile: on
// eval_builtin_expr they are 316 of the row's 476 words, and staging them
// would cut the rows resident per SM to a third.

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

#include "babybear.cuh"

namespace {

using bb::Ext;

constexpr int MAX_THREADS = 128;     // the largest tile the wrapper picks
constexpr int SMEM_MAX = 232448;     // a block's shared memory on sm_90
constexpr int G = 8;                 // perm: interactions per inverse
constexpr uint32_t OPCODE_SHIFT = 24;
constexpr uint32_t DST_MASK = (1u << OPCODE_SHIFT) - 1;
constexpr uint32_t OP_ADD = 0;
constexpr uint32_t OP_SUB = 1;
constexpr uint32_t OP_MUL = 2;
// opcode 3 is MOV, v = a: a late fold
constexpr uint32_t A_CONST = 4;      // operand a indexes the constant table
constexpr uint32_t B_CONST = 8;
constexpr uint32_t FOLD = 16;        // dst is a constraint: fold, no store

// Every field is 8 bytes wide, so the layout has no padding and matches
// the wrapper's ctypes structures field for field (the wrapper checks the
// size, and a CPU test the names and their order). The small arrays lie
// in one buffer, each at a 16-byte boundary.
struct QuotientArgs {
  const int32_t* main;       // (big, main_w) slice, row stride main_ld
  long long main_ld;
  long long main_w;
  const int32_t* prep;       // (big, prep_w) slice or null
  long long prep_ld;
  long long prep_w;
  const int32_t* perm;       // (big, 4 (nb + 1)) slice, canonical
  long long perm_ld;
  long long nb;
  const int64_t* first;      // (big,) coset selectors, canonical
  const int64_t* last;
  const int64_t* trans;
  long long log_big;
  long long stride;          // next row = (i + stride) mod big
  const int32_t* ops;        // (n_ops, 2) packed ops, then a zero op
                             // where n_ops is odd
  long long n_ops;
  long long op_chunk;        // ops staged in shared memory at a time
  const int32_t* fold_off;   // (chunks + 1,) each chunk's first fold
  long long max_folds;       // the most folds in one chunk
  const int32_t* wfold;      // (folds, 4) canonical fold weights, in the
                             // order the ops fold
  const int32_t* consts;     // (n_consts,) Montgomery
  long long n_consts;
  const int32_t* recs;       // the batches' records, `group` a record
  const int32_t* rec_off;    // (records + 1,) word offsets into recs
  long long rec_words;       // the longest record
  long long group;           // batches per record
  const int32_t* wsel;       // (3, 8) Montgomery w0..w3, W w1..W w3, 0
  const int32_t* cum;        // (4,) canonical
  long long ld;              // tile row stride in words, odd, >= Wx + S
  long long tile;            // T: rows and threads of a block
  int32_t* out;              // (big, 4) canonical fold
};

struct PermArgs {
  const int32_t* main;       // (h, main_w) trace, row stride main_ld
  long long main_ld;
  long long main_w;
  const int32_t* prep;       // (h, prep_w) or null
  long long prep_ld;
  long long prep_w;
  long long h;
  long long nb;
  const int32_t* recs;       // the interactions' records, G a record
  const int32_t* rec_off;    // (records + 1,) word offsets into recs
  long long rec_words;       // the longest record
  long long ld;              // tile row stride in words, odd, >= Wx
  long long tile;            // T: rows and threads of a block
  int32_t* out;              // phi_b at out[i * out_ld + 4 b + l]
  long long out_ld;
};

__device__ __forceinline__ uint32_t ld(const int32_t* p) {
  return static_cast<uint32_t>(__ldg(p));
}

__device__ __forceinline__ Ext ld_ext(const int32_t* p) {
  return Ext{{ld(p), ld(p + 1), ld(p + 2), ld(p + 3)}};
}

__device__ __forceinline__ uint4 ld4(const int32_t* p) {  // 16-byte aligned
  return __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ uint4 lds4(const uint32_t* p) {  // shared, aligned
  return *reinterpret_cast<const uint4*>(p);
}

// Four words at p: one 16-byte load where the matrix's base and row
// stride allow it (`vec`, the same for every thread), four otherwise.
__device__ __forceinline__ Ext ld_ext_v(const int32_t* p, bool vec) {
  if (vec) {
    const uint4 v = ld4(p);
    return Ext{{v.x, v.y, v.z, v.w}};
  }
  return ld_ext(p);
}

__device__ __forceinline__ bool aligned16(const void* p, long long ld) {
  return ((reinterpret_cast<uintptr_t>(p) | static_cast<uintptr_t>(4 * ld))
          & 15u) == 0;
}

__device__ __forceinline__ int pad4(int n) { return (n + 3) & ~3; }

// Asynchronous copies from device memory into shared memory (cp.async):
// nothing waits for them until cp_async_wait, so a thread keeps many in
// flight.
__device__ __forceinline__ void cp_async4(uint32_t* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(uint32_t* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Columns [c0, c0 + w) of tile rows 0 .. rows - 1 from the rows (r0 + j)
// & mask (those below h) of a (., w) int32 slice with row stride src_ld:
// the block's threads take the rows' words in order, so a warp's copies
// are side by side in device memory.
__device__ void copy_cols(uint32_t* tile, long long ld_t, int c0,
                          const int32_t* src, long long src_ld, int w,
                          long long r0, int rows, long long mask,
                          long long h) {
  if (w == 0) return;
  const int T = blockDim.x;
  int row = threadIdx.x / w, col = threadIdx.x % w;
  const int dq = T / w, dr = T % w;
  while (row < rows) {
    const long long lr = (r0 + row) & mask;
    if (lr < h) cp_async4(tile + row * ld_t + c0 + col, src + lr * src_ld +
                          col);
    col += dr;
    row += dq;
    if (col >= w) {
      col -= w;
      ++row;
    }
  }
}

// Tile rows 0 .. rows - 1 hold X = [main | prep | extras] of the rows
// (r0 + j) & mask (those below h), in Montgomery form: the columns copied
// raw, then each thread converts whole rows in place. extra(j, lr) writes
// extra column j of row lr (canonical) to its place.
template <typename Extra>
__device__ void load_tile(uint32_t* tile, long long ld_t, long long r0,
                          int rows, long long mask, long long h,
                          const int32_t* main, long long main_ld,
                          int main_w, const int32_t* prep, long long prep_ld,
                          int prep_w, int n_extra, Extra extra) {
  copy_cols(tile, ld_t, 0, main, main_ld, main_w, r0, rows, mask, h);
  copy_cols(tile, ld_t, main_w, prep, prep_ld, prep_w, r0, rows, mask, h);
  for (int e = threadIdx.x; e < rows * n_extra; e += blockDim.x) {
    const int j = e / rows, row = e % rows;
    const long long lr = (r0 + row) & mask;
    if (lr < h) extra(j, lr, tile + row * ld_t + main_w + prep_w + j);
  }
  cp_async_wait();
  __syncthreads();
  const int wx = main_w + prep_w + n_extra;
  for (int j = threadIdx.x; j < rows; j += blockDim.x) {
    uint32_t* x = tile + j * ld_t;
    for (int c = 0; c < wx; ++c) x[c] = bb::to_mont(x[c]);
  }
  __syncthreads();
}

// Words [from, to) of src into dst (shared), 16 bytes a copy with
// cp.async; both ends are multiples of 4 words. The caller waits.
__device__ __forceinline__ void stage(uint32_t* dst, const int32_t* src,
                                      int from, int to) {
  for (int i = from + 4 * static_cast<int>(threadIdx.x); i < to;
       i += 4 * static_cast<int>(blockDim.x))
    cp_async16(dst + (i - from), src + i);
}

// One interaction's record, staged in shared memory (the wrapper's
// _records): a header [term count, multiplicity-term count, mconst
// (Montgomery), 0, d0..d3], the term weights (4 words each, Montgomery),
// the term columns (padded to 4 words), then (column, canonical weight)
// pairs of the multiplicity (padded to 4 words). d is dconst * 2^64 mod p
// (where a sum of Montgomery products starts), or for the perm trace's
// constant fingerprints (no term) their Montgomery inverse.
struct Inter {
  const uint32_t* r;
  int t_cnt, m_cnt;

  __device__ __forceinline__ explicit Inter(const uint32_t* rec) : r(rec) {
    const uint4 h = lds4(rec);
    t_cnt = static_cast<int>(h.x);
    m_cnt = static_cast<int>(h.y);
  }
  __device__ __forceinline__ int words() const {
    return 8 + 4 * t_cnt + pad4(t_cnt) + pad4(2 * m_cnt);
  }
  __device__ __forceinline__ Ext d() const {
    const uint4 v = lds4(r + 4);
    return Ext{{v.x, v.y, v.z, v.w}};
  }

  // d + sum tw * x, the Montgomery weights' products summed in 64 bits,
  // two terms between folds: the fingerprint, Montgomery.
  __device__ Ext fingerprint(const uint32_t* x) const {
    const uint32_t* tw = r + 8;
    const uint32_t* tcol = tw + 4 * t_cnt;
    const uint4 d0 = lds4(r + 4);
    uint64_t s[4] = {d0.x, d0.y, d0.z, d0.w};
    int t = 0;
    for (; t + 3 < t_cnt; t += 4) {
      const uint4 c = lds4(tcol + t);
      const uint32_t xv[4] = {x[c.x], x[c.y], x[c.z], x[c.w]};
      uint4 w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) w[j] = lds4(tw + 4 * (t + j));
#pragma unroll
      for (int j = 0; j < 4; j += 2) {
        s[0] = bb::fold_hi(s[0] + bb::wide(w[j].x, xv[j]) +
                           bb::wide(w[j + 1].x, xv[j + 1]));
        s[1] = bb::fold_hi(s[1] + bb::wide(w[j].y, xv[j]) +
                           bb::wide(w[j + 1].y, xv[j + 1]));
        s[2] = bb::fold_hi(s[2] + bb::wide(w[j].z, xv[j]) +
                           bb::wide(w[j + 1].z, xv[j + 1]));
        s[3] = bb::fold_hi(s[3] + bb::wide(w[j].w, xv[j]) +
                           bb::wide(w[j + 1].w, xv[j + 1]));
      }
    }
    for (; t < t_cnt; ++t) {
      const uint32_t xa = x[tcol[t]];
      const uint4 w = lds4(tw + 4 * t);
      s[0] = bb::fold_hi(s[0] + bb::wide(w.x, xa));
      s[1] = bb::fold_hi(s[1] + bb::wide(w.y, xa));
      s[2] = bb::fold_hi(s[2] + bb::wide(w.z, xa));
      s[3] = bb::fold_hi(s[3] + bb::wide(w.w, xa));
    }
    return Ext{{bb::redc(s[0]), bb::redc(s[1]), bb::redc(s[2]),
                bb::redc(s[3])}};
  }

  // mconst + sum mw * x with canonical weights: the multiplicity,
  // canonical.
  __device__ uint32_t multiplicity(const uint32_t* x) const {
    const uint32_t* mt = r + 8 + 4 * t_cnt + pad4(t_cnt);
    uint64_t s = r[2];
    int t = 0;
    for (; t + 1 < m_cnt; t += 2) {
      const uint4 v = lds4(mt + 2 * t);
      s = bb::fold_hi(s + bb::wide(v.y, x[v.x]) + bb::wide(v.w, x[v.z]));
    }
    if (t < m_cnt) s = bb::fold_hi(s + bb::wide(mt[2 * t + 1],
                                                x[mt[2 * t]]));
    return bb::redc(s);
  }
};

__device__ __forceinline__ void mac_base(uint64_t acc[4], const uint4& w,
                                         uint32_t v) {
  acc[0] = bb::fold_hi(acc[0] + bb::wide(w.x, v));
  acc[1] = bb::fold_hi(acc[1] + bb::wide(w.y, v));
  acc[2] = bb::fold_hi(acc[2] + bb::wide(w.z, v));
  acc[3] = bb::fold_hi(acc[3] + bb::wide(w.w, v));
}

// Operand a (shift 0) or b (shift 16) of a packed op: a constant-table
// entry or a word of the thread's tile row.
__device__ __forceinline__ uint32_t operand(uint2 op, const uint32_t* consts,
                                           const uint32_t* mine, int shift) {
  const uint32_t* base =
      ((op.y >> OPCODE_SHIFT) & (shift ? B_CONST : A_CONST)) ? consts : mine;
  return base[(op.x >> shift) & 0xffffu];
}

// Shared memory of a quotient block, in words: [op chunk (2 op_chunk) |
// its fold weights (4 max_folds) | constants | record (rec_words) | tile
// ((tile + stride) * ld)].
__global__ void __launch_bounds__(MAX_THREADS)
quotient_kernel(const __grid_constant__ QuotientArgs a) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int T = blockDim.x;
  const int t = threadIdx.x;
  const long long mask = (1LL << a.log_big) - 1;
  const long long r0 = static_cast<long long>(blockIdx.x) * T;
  const int nc = static_cast<int>(a.n_consts);
  const int main_w = static_cast<int>(a.main_w);
  const int prep_w = static_cast<int>(a.prep_w);
  const int wx = main_w + prep_w + 4;
  uint2* sops = reinterpret_cast<uint2*>(smem);
  uint4* sw = reinterpret_cast<uint4*>(smem + 2 * a.op_chunk);
  uint32_t* consts = smem + 2 * a.op_chunk + 4 * a.max_folds;
  uint32_t* rec = consts + pad4(nc);
  uint32_t* tile = rec + a.rec_words;
  for (int i = t; i < nc; i += T) consts[i] = ld(a.consts + i);
  load_tile(tile, a.ld, r0, T + static_cast<int>(a.stride), mask, mask + 1,
            a.main, a.main_ld, main_w, a.prep, a.prep_ld, prep_w, 4,
            [&](int j, long long lr, uint32_t* dst) {
              if (j == 3)
                *dst = 1u;
              else         // the low word of a canonical int64
                cp_async4(dst, (j == 0 ? a.first : j == 1 ? a.last
                                                          : a.trans) + lr);
            });

  uint32_t* mine = tile + t * a.ld;
  const long long row = r0 + t;
  uint64_t acc[4] = {0u, 0u, 0u, 0u};

  // the VM program, staged in chunks (an even number of ops: the stream
  // ends on a zero op where its count is odd) with their fold weights
  for (long long c0 = 0, c = 0; c0 < a.n_ops; c0 += a.op_chunk, ++c) {
    const int len = static_cast<int>(
        a.n_ops - c0 < a.op_chunk ? a.n_ops - c0 : a.op_chunk);
    __syncthreads();                       // the last chunk is done
    stage(reinterpret_cast<uint32_t*>(sops), a.ops, 2 * c0,
          2 * (c0 + ((len + 1) & ~1)));
    stage(reinterpret_cast<uint32_t*>(sw), a.wfold, 4 * ld(a.fold_off + c),
          4 * ld(a.fold_off + c + 1));
    cp_async_wait();
    __syncthreads();
    for (int k = 0; k < len; ++k) {
      const uint2 op = sops[k];
      const uint32_t fl = op.y >> OPCODE_SHIFT;
      const uint32_t va = operand(op, consts, mine, 0);
      const uint32_t vb = operand(op, consts, mine, 16);
      // both results, then a select on the op's kind
      const uint32_t code = fl & 3u;
      const uint32_t prod = bb::mmul(va, vb);
      const uint32_t sum = bb::madd(va, code == OP_ADD   ? vb
                                        : code == OP_SUB ? bb::P - vb
                                                         : 0u);  // MOV
      const uint32_t v = code == OP_MUL ? prod : sum;
      const uint32_t dst = op.y & DST_MASK;
      if (fl & FOLD)
        mac_base(acc, sw[dst], v);               // canonical weight
      else
        mine[dst] = v;
    }
  }

  // the perm-quotient: every batch's lhs - rhs, a record of `group`
  // batches at a time, then the running sum
  const long long nrow = (row + a.stride) & mask;
  const int32_t* pl = a.perm + row * a.perm_ld;
  const int32_t* pn = a.perm + nrow * a.perm_ld;
  const int nb = static_cast<int>(a.nb);
  const bool vec = aligned16(a.perm, a.perm_ld);
  Ext tphi = bb::ext_zero();
  Ext tphi_next = bb::ext_zero();
  const int group = static_cast<int>(a.group);
  for (int b0 = 0, g = 0; b0 < nb; b0 += group, ++g) {
    __syncthreads();
    stage(rec, a.recs, ld(a.rec_off + g), ld(a.rec_off + g + 1));
    cp_async_wait();
    __syncthreads();
    const uint32_t* r = rec;
    for (int b = b0; b < b0 + group && b < nb; ++b) {
      const Ext phi = ld_ext_v(pl + 4 * b, vec);        // canonical
      tphi = bb::ext_madd(tphi, phi);
      tphi_next = bb::ext_madd(tphi_next, ld_ext_v(pn + 4 * b, vec));
      const uint32_t* wb = r;                           // 8 words
      const Inter i0(r + 8);
      const Inter i1(r + 8 + i0.words());
      r += 8 + i0.words() + i1.words();
      const Ext d0 = i0.fingerprint(mine);              // Montgomery
      const Ext d1 = i1.fingerprint(mine);
      const uint32_t m0 = i0.multiplicity(mine);        // canonical
      const uint32_t m1 = i1.multiplicity(mine);
      const Ext lhs = bb::ext_mmul(phi, bb::ext_mmul(d0, d1));  // canonical
      Ext diff;
      for (int l = 0; l < 4; ++l)
        diff.c[l] = bb::msub(lhs.c[l], bb::redc(bb::wide(d1.c[l], m0) +
                                                bb::wide(d0.c[l], m1)));
      bb::ext_mac_w(acc, diff, wb);
    }
  }
  const Ext s = ld_ext_v(pl + 4 * nb, vec);
  const Ext s_next = ld_ext_v(pn + 4 * nb, vec);
  const Ext cum = ld_ext(a.cum);
  const Ext terms[3] = {
      bb::ext_mscale(bb::ext_msub(s, tphi), mine[wx - 4]),        // first
      bb::ext_mscale(bb::ext_msub(bb::ext_msub(s_next, s), tphi_next),
                     mine[wx - 2]),                               // transition
      bb::ext_mscale(bb::ext_msub(s, cum), mine[wx - 3])};        // last
  for (int j = 0; j < 3; ++j) {
    const uint4 lo = ld4(a.wsel + 8 * j), hi = ld4(a.wsel + 8 * j + 4);
    const uint32_t w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    bb::ext_mac_w(acc, terms[j], w);
  }

  // the sums stand for canonical * 2^32: one reduction each
  reinterpret_cast<uint4*>(a.out)[row] =
      make_uint4(bb::redc(acc[0]), bb::redc(acc[1]), bb::redc(acc[2]),
                 bb::redc(acc[3]));
}

// Shared memory of a perm block, in words: [record (rec_words) | tile
// (tile * ld)].
__global__ void __launch_bounds__(MAX_THREADS)
perm_phi_kernel(const __grid_constant__ PermArgs a) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int T = blockDim.x;
  const int t = threadIdx.x;
  const long long r0 = static_cast<long long>(blockIdx.x) * T;
  const long long h = a.h;
  uint32_t* rec = smem;
  uint32_t* tile = smem + a.rec_words;
  load_tile(tile, a.ld, r0, T, -1LL, h, a.main, a.main_ld,
            static_cast<int>(a.main_w), a.prep, a.prep_ld,
            static_cast<int>(a.prep_w), 3,
            [&](int j, long long lr, uint32_t* dst) {
              *dst = j == 0 ? lr == 0 : j == 1 ? lr == h - 1 : lr < h - 1;
            });
  const long long row = r0 + t;
  const bool live_row = row < h;   // the others compute, write nothing
  const uint32_t* x = tile + t * a.ld;
  const int n = 2 * static_cast<int>(a.nb);
  const Ext one{{bb::ONE_M, 0u, 0u, 0u}};
  int32_t* o = a.out + row * a.out_ld;
  const bool vec = aligned16(a.out, a.out_ld);
  for (int k0 = 0, g = 0; k0 < n; k0 += G, ++g) {
    __syncthreads();                       // the last record is done
    stage(rec, a.recs, ld(a.rec_off + g), ld(a.rec_off + g + 1));
    cp_async_wait();
    __syncthreads();
    // forward: each varying fingerprint d (1 where it is 0), and the
    // product of the group's earlier ones before it
    Ext d[G], before[G];
    uint32_t m[G];
    bool varying[G], zero[G], has_before[G];
    Ext run = one;
    bool have = false;
    const uint32_t* r = rec;
#pragma unroll
    for (int i = 0; i < G; ++i) {
      const int k = k0 + i;
      varying[i] = zero[i] = has_before[i] = false;
      m[i] = 0u;
      if (k < n) {
        const Inter it(r);
        r += it.words();
        m[i] = it.multiplicity(x);
        if (it.t_cnt > 0) {
          const Ext v = it.fingerprint(x);
          zero[i] = (v.c[0] | v.c[1] | v.c[2] | v.c[3]) == 0u;
          d[i] = zero[i] ? one : v;
          varying[i] = true;
          has_before[i] = have;
          before[i] = run;
          run = have ? bb::ext_mmul(run, d[i]) : d[i];
          have = true;
        } else {
          d[i] = it.d();                   // the wrapper's inverse
        }
      }
    }
    // backward from one inverse of the product: 1/d_i = inv * before_i,
    // then inv *= d_i
    if (have) {
      Ext inv = bb::ext_minv(run);
#pragma unroll
      for (int i = G - 1; i >= 0; --i) {
        if (!varying[i]) continue;
        const Ext di = has_before[i] ? bb::ext_mmul(inv, before[i]) : inv;
        if (has_before[i]) inv = bb::ext_mmul(inv, d[i]);
        d[i] = zero[i] ? bb::ext_zero() : di;
      }
    }
    // contributions m / d (Montgomery times canonical: canonical), paired
#pragma unroll
    for (int i = 0; i < G; i += 2) {
      const int k = k0 + i;
      if (k >= n || !live_row) break;
      const Ext phi = bb::ext_madd(bb::ext_mscale(d[i], m[i]),
                                   bb::ext_mscale(d[i + 1], m[i + 1]));
      if (vec)
        *reinterpret_cast<uint4*>(o + 2 * k) =
            make_uint4(phi.c[0], phi.c[1], phi.c[2], phi.c[3]);
      else
        for (int l = 0; l < 4; ++l)
          o[2 * k + l] = static_cast<int32_t>(phi.c[l]);
    }
  }
}

// Runs body() with `device` current and sets the caller's device back
// before returning (the runtime's current device belongs to the calling
// host thread, and PyTorch keeps its own record of it). Returns body()'s
// cudaError_t, or the first error of the device switch.
template <typename F>
int on_device(int device, F body) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (prev != device) {
    err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int res = body();
  if (prev != device) {
    err = cudaSetDevice(prev);
    if (res == 0 && err != cudaSuccess) res = static_cast<int>(err);
  }
  return res;
}

// Bit d: the kernel may take SMEM_MAX bytes of dynamic shared memory on
// device d (the attribute belongs to the kernel on each device).
std::atomic<unsigned long long> quotient_ready{0}, perm_ready{0};

// Lets a block of the kernel take up to SMEM_MAX bytes of dynamic shared
// memory (past the default 48 KB) on the current device. Every call sets
// the same value, the most any launch asks for, so host threads that
// launch the kernel at once with different tiles never lower it under one
// another's launch; after the first success on a device it is not set
// again.
template <typename Args>
cudaError_t configure(void (*kernel)(Args),
                      std::atomic<unsigned long long>& ready) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ULL << dev : 0ULL;
  if (ready.load() & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_MAX);
  if (err == cudaSuccess) ready.fetch_or(bit);
  return err;
}

// Launches kernel(args) over `rows` rows in blocks of `threads` rows and
// threads with `smem` bytes of shared memory each.
template <typename Args>
int launch(void (*kernel)(Args), std::atomic<unsigned long long>& ready,
           const Args& a, long long rows, long long threads, long long smem,
           cudaStream_t s) {
  if (threads < 1 || threads > MAX_THREADS)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  if (smem < 0 || smem > SMEM_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (rows + threads - 1) / threads;
  cudaError_t err = configure(kernel, ready);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(blocks), static_cast<unsigned>(threads),
           static_cast<size_t>(smem), s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

long long quotient_smem(const QuotientArgs& a) {
  return 4 * (2 * a.op_chunk + 4 * a.max_folds +
              ((a.n_consts + 3) & ~3LL) + a.rec_words +
              (a.tile + a.stride) * a.ld);
}

long long perm_smem(const PermArgs& a) {
  return 4 * (a.rec_words + a.tile * a.ld);
}

}  // namespace

extern "C" {

// sizeof the argument structures, for the wrapper's layout check.
long long lurk_quotient_args_size() { return sizeof(QuotientArgs); }
long long lurk_perm_args_size() { return sizeof(PermArgs); }

// Blocks of `threads` threads and `smem` bytes of one kernel (0 the
// quotient, 1 the perm trace) resident on one SM of `device`, or -1 on an
// error: the occupancy a chip's tile gives.
int lurk_kernel_occupancy(int device, int which, long long threads,
                          long long smem) {
  int blocks = -1;
  int err = on_device(device, [&]() -> int {
    cudaError_t e = which == 0 ? configure(quotient_kernel, quotient_ready)
                               : configure(perm_phi_kernel, perm_ready);
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(
        which == 0 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                         &blocks, quotient_kernel, static_cast<int>(threads),
                         static_cast<size_t>(smem))
                   : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                         &blocks, perm_phi_kernel, static_cast<int>(threads),
                         static_cast<size_t>(smem)));
  });
  return err == 0 ? blocks : -1;
}

// Every LDE row's constraint-quotient fold, written to args->out, in one
// launch of 2^log_big / tile blocks of tile threads. `args` is a
// QuotientArgs (passed as void*: a parameter of a type in the unnamed
// namespace would take the function's external linkage away). Launches on
// `stream` (a stream of `device`) without synchronising; the caller's
// current device is unchanged on return. Returns a cudaError_t (0 on
// success).
int lurk_constraint_quotient(int device, const void* args, void* stream) {
  const QuotientArgs& a = *static_cast<const QuotientArgs*>(args);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return on_device(device, [&]() -> int {
    return launch(quotient_kernel, quotient_ready, a, 1LL << a.log_big,
                  a.tile, quotient_smem(a), s);
  });
}

// Every row's batch contributions phi, written to args->out (a PermArgs).
// Launches as lurk_constraint_quotient does.
int lurk_logup_perm_phi(int device, const void* args, void* stream) {
  const PermArgs& a = *static_cast<const PermArgs*>(args);
  if (a.h <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return on_device(device, [&]() -> int {
    return launch(perm_phi_kernel, perm_ready, a, a.h, a.tile,
                  perm_smem(a), s);
  });
}

}  // extern "C"
