// The PCS openings and the FRI fold for NVIDIA Hopper (sm_90a): three
// kernels over BabyBear and its degree-4 extension, in Montgomery form.
//
// open_eval_kernel replaces lurk_tpu's jitted _ext_powers_fn and
// _eval_coeffs_fn (lurk_tpu/stark/device_prover.py), which its
// device_open_rounds runs once per (height group, opening point). For
// every column c of a group's (h, w) coefficient matrix and every point
// z_k of the group it computes the opened value
//   y[k, c] = sum_i coeffs[i, c] * z_k^i        (an extension element)
// for all of the group's points in one launch.
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
//
// What bounds them on this card. open_eval and open_reduce do four
// products per (row, column, point) on four bytes of input, a few hundred
// columns wide: about as many issue slots as the card's memory rate
// allows bytes, so both the bytes and the products are kept to the
// least. fri_fold moves 48 to 64 bytes a row for about 30 products: its
// bytes bound it.
//
// - Every row is read once for all of the group's points, and nothing is
//   materialised per row: the powers of z (open_eval) and the domain
//   points x (open_reduce, fri_fold) are computed in the kernel. A block
//   of open_eval raises each z to its first row and keeps the powers of a
//   tile of EVAL_TILE rows in shared memory, stepping them by z^EVAL_TILE;
//   threads of a warp take neighbouring columns of one row (or, for a
//   narrow group, a few rows), so that every coefficient load is
//   coalesced and every power is a broadcast.
// - open_reduce stages a tile of REDUCE_ROWS LDE rows and REDUCE_COLS
//   columns with coalesced loads into shared memory (odd row stride: a
//   warp, one row a thread, hits 32 banks) beside the chunk's weights,
//   read as broadcasts; one thread sums its row for every point.
// - Products in Montgomery form with lazy reduction (babybear.cuh): a
//   canonical value times a Montgomery weight or power, summed in 64
//   bits and folded once per product, gives the canonical sum after one
//   reduction; no conversion pass on either side.
// - Sums across blocks are exact: each block adds its canonical sums into
//   64-bit accumulators with atomics (order-free integers), and the last
//   block of a column tile reduces them mod p, writes the output and sets
//   the accumulators and its counter back to zero.
// - 1/(x - z) is one extension inverse per row and point (ext_minv: 0
//   maps to 0), a few dozen products against the row's 4 w.

#include <cstdint>
#include <cuda_runtime.h>

#include "babybear.cuh"
#include "on_device.cuh"

namespace {

using bb::Ext;

constexpr int MAX_POINTS = 2;     // opening points of one group
constexpr int EVAL_THREADS = 256;  // threads of an open_eval block
constexpr int EVAL_TILE = 64;     // rows whose powers are staged at a time
constexpr int REDUCE_ROWS = 128;  // rows (and threads) of an open_reduce block
constexpr int REDUCE_COLS = 32;   // LDE columns staged at a time
constexpr int FOLD_THREADS = 256;
constexpr uint32_t TWO_INV_M = 134217727u;  // 1/2 in Montgomery form

// The argument structures, field for field as stark/open_kernel.py packs
// them: 8-byte integers and pointers. Points are Montgomery, weights
// Montgomery, y_alpha and every matrix canonical.
struct EvalArgs {
  const int32_t* coeffs;     // (h, w), row stride ld
  long long ld;
  long long h;
  long long w;
  long long n_points;
  long long z[MAX_POINTS * 4];
  long long rows_per_block;  // a multiple of EVAL_TILE
  long long tx;              // columns of a block
  long long ty;              // rows of a block taken at once: tx * ty <= 256
  unsigned long long* acc;   // (n_points, w, 4), zero before the launch
  int* counter;              // (column tiles,), zero before the launch
  int32_t* out;              // (n_points, w, 4)
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
  const int32_t* cw;         // (2^log_n, 4)
  const int32_t* add;        // (2^(log_n - 1), 4) or null
  long long log_n;
  long long beta[4];
  long long inv_shift2;      // 1 / (2 shift)
  long long g_inv;           // the inverse of the domain's generator
  int32_t* out;              // (2^(log_n - 1), 4)
};

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

__device__ inline Ext ext_mpow(Ext x, unsigned long long e) {
  Ext acc{{bb::ONE_M, 0u, 0u, 0u}};
  while (e) {
    if (e & 1) acc = bb::ext_mmul(acc, x);
    e >>= 1;
    if (e) x = bb::ext_mmul(x, x);
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

template <int NP>
__global__ void __launch_bounds__(EVAL_THREADS)
    open_eval_kernel(const EvalArgs a) {
  __shared__ Ext pw[EVAL_TILE][NP];    // z_k^(row) of the tile's rows
  __shared__ Ext zstep[NP];            // z_k^EVAL_TILE
  __shared__ uint32_t red[NP * 4][EVAL_THREADS];
  __shared__ bool last;
  const int tx = blockDim.x, ty = blockDim.y;
  const int x = threadIdx.x, y = threadIdx.y;
  const int t = y * tx + x, nt = tx * ty;
  const long long c = static_cast<long long>(blockIdx.y) * tx + x;
  const long long r0 = static_cast<long long>(blockIdx.x) * a.rows_per_block;
  const long long r1 = min(a.h, r0 + a.rows_per_block);
  if (t < NP) {
    Ext s = ext_at(a.z, t);
    for (int e = 1; e < EVAL_TILE; e <<= 1) s = bb::ext_mmul(s, s);
    zstep[t] = s;
  }
  for (int s = t; s < NP * EVAL_TILE; s += nt)
    pw[s % EVAL_TILE][s / EVAL_TILE] =
        ext_mpow(ext_at(a.z, s / EVAL_TILE), r0 + s % EVAL_TILE);
  uint64_t acc[NP][4];
#pragma unroll
  for (int k = 0; k < NP; ++k)
#pragma unroll
    for (int l = 0; l < 4; ++l) acc[k][l] = 0;
  for (long long base = r0; base < r1; base += EVAL_TILE) {
    __syncthreads();  // the tile's powers are in place
    if (c < a.w) {
      const int n = static_cast<int>(min(static_cast<long long>(EVAL_TILE),
                                         r1 - base));
      const int32_t* col = a.coeffs + base * a.ld + c;
      for (int j = y; j < n; j += ty) {
        const uint32_t v = static_cast<uint32_t>(__ldg(col + j * a.ld));
#pragma unroll
        for (int k = 0; k < NP; ++k) mac4(acc[k], v, pw[j][k].c);
      }
    }
    __syncthreads();  // the tile is consumed: step every power
    for (int s = t; s < NP * EVAL_TILE; s += nt)
      pw[s % EVAL_TILE][s / EVAL_TILE] = bb::ext_mmul(
          pw[s % EVAL_TILE][s / EVAL_TILE], zstep[s / EVAL_TILE]);
  }
  // canonical sums (a canonical value times a Montgomery power), summed
  // over the block's row lanes, added into the 64-bit accumulators
#pragma unroll
  for (int k = 0; k < NP; ++k)
#pragma unroll
    for (int l = 0; l < 4; ++l) red[4 * k + l][t] = bb::redc(acc[k][l]);
  __syncthreads();
  if (y == 0 && c < a.w) {
#pragma unroll
    for (int k = 0; k < NP; ++k)
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        uint32_t s = red[4 * k + l][x];
        for (int yy = 1; yy < ty; ++yy) s = bb::madd(s, red[4 * k + l][yy * tx + x]);
        atomicAdd(a.acc + (k * a.w + c) * 4 + l,
                  static_cast<unsigned long long>(s));
      }
  }
  // the last block of the column tile writes its columns' outputs
  __threadfence();
  __syncthreads();
  if (t == 0)
    last = atomicAdd(a.counter + blockIdx.y, 1) ==
           static_cast<int>(gridDim.x) - 1;
  __syncthreads();
  if (!last) return;
  const long long c0 = static_cast<long long>(blockIdx.y) * tx;
  const int cols = static_cast<int>(min(static_cast<long long>(tx), a.w - c0));
  for (int e = t; e < NP * cols * 4; e += nt) {
    const int k = e / (cols * 4), cc = (e / 4) % cols, l = e % 4;
    const long long i = (k * a.w + c0 + cc) * 4 + l;
    const unsigned long long s = __ldcg(a.acc + i);
    a.out[i] = static_cast<int32_t>(s % bb::P);
    a.acc[i] = 0;
  }
  if (t == 0) a.counter[blockIdx.y] = 0;
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
  const long long half = 1LL << (a.log_n - 1);
  const long long i =
      static_cast<long long>(blockIdx.x) * FOLD_THREADS + threadIdx.x;
  if (i >= half) return;
  const uint4* cw = reinterpret_cast<const uint4*>(a.cw);
  const Ext fx = ext_of(__ldg(cw + i)), fm = ext_of(__ldg(cw + i + half));
  // 1/(2x) = (1 / (2 shift)) * g^-i, Montgomery
  const uint32_t inv2x = bb::mmul(static_cast<uint32_t>(a.inv_shift2),
                                  mpow(static_cast<uint32_t>(a.g_inv), i));
  Ext s, d;
#pragma unroll
  for (int l = 0; l < 4; ++l) {
    s.c[l] = bb::mmul(bb::madd(fx.c[l], fm.c[l]), TWO_INV_M);
    d.c[l] = bb::mmul(bb::msub(fx.c[l], fm.c[l]), inv2x);
  }
  const Ext beta{{static_cast<uint32_t>(a.beta[0]),
                  static_cast<uint32_t>(a.beta[1]),
                  static_cast<uint32_t>(a.beta[2]),
                  static_cast<uint32_t>(a.beta[3])}};
  Ext o = bb::ext_madd(s, bb::ext_mmul(d, beta));
  if (a.add)
    o = bb::ext_madd(o, ext_of(__ldg(reinterpret_cast<const uint4*>(a.add) + i)));
  reinterpret_cast<uint4*>(a.out)[i] = uint4_of(o);
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

}  // namespace

extern "C" {

// sizeof the argument structures, for the wrapper's layout check.
long long lurk_open_eval_args_size() { return sizeof(EvalArgs); }
long long lurk_open_reduce_args_size() { return sizeof(ReduceArgs); }
long long lurk_fri_fold_args_size() { return sizeof(FoldArgs); }

// The opened values of one group at its points, written to args->out (an
// EvalArgs, passed as void*: a parameter of a type in the unnamed
// namespace would take the function's external linkage away), in one
// launch of ceil(h / rows_per_block) x ceil(w / tx) blocks of tx x ty
// threads. Launches on `stream` (a stream of `device`) without
// synchronising; the caller's current device is unchanged on return.
// Returns a cudaError_t (0 on success).
int lurk_open_eval(int device, const void* args, void* stream) {
  const EvalArgs& a = *static_cast<const EvalArgs*>(args);
  if (a.h < 1 || a.w < 1 || a.tx < 1 || a.ty < 1 ||
      a.tx * a.ty > EVAL_THREADS || a.rows_per_block < EVAL_TILE ||
      a.rows_per_block % EVAL_TILE)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((a.h + a.rows_per_block - 1) /
                                        a.rows_per_block),
                  static_cast<unsigned>((a.w + a.tx - 1) / a.tx));
  const dim3 block(static_cast<unsigned>(a.tx), static_cast<unsigned>(a.ty));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return on_device(device, [&]() -> int {
    return launch_points(a.n_points, open_eval_kernel<1>,
                         open_eval_kernel<2>, grid, block, s, a);
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

// One FRI fold (a FoldArgs), with the next height's input codeword added
// where args->add is not null: 2^(log_n - 1) / FOLD_THREADS blocks.
// Launches as lurk_open_eval does.
int lurk_fri_fold(int device, const void* args, void* stream) {
  const FoldArgs& a = *static_cast<const FoldArgs*>(args);
  if (a.log_n < 1 || a.log_n > 31)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long half = 1LL << (a.log_n - 1);
  const dim3 grid(static_cast<unsigned>((half + FOLD_THREADS - 1) /
                                        FOLD_THREADS));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return on_device(device, [&]() -> int {
    fri_fold_kernel<<<grid, FOLD_THREADS, 0, s>>>(a);
    return static_cast<int>(cudaGetLastError());
  });
}

}  // extern "C"
