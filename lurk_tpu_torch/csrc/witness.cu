// The device witness of the prover's func chips for NVIDIA Hopper (sm_90a):
// one launch writes one chip's whole (height, width) int32 trace.
//
// It replaces lurk_tpu's jitted witness VM and row scatter
// (lurk_tpu/lair/device_trace.py: _witness_vm, a lax.scan over one (chip,
// path) row group's register bytecode, and _scatter_rows; not Pallas), which
// run once per row group after the host has gathered, padded and uploaded
// the group's streams. Here the host uploads the chip's range of its query
// streams as they are, 32-bit words (lair/witness_kernel.py), with the
// chip's rows sorted by path and cut into tiles of one path each, and the
// programs of every path packed once per chip. A block of T threads takes
// one tile: T rows of one path, so its threads run one program.
//
// For chip row r (query row start + r) of path p, the row is the register
// file of device_trace's PathPlan of p after:
//   nonce (start + r) mod p in register 0, the args, outputs and provide
//   pair in their columns, the depth's bytes (partial funcs) and the
//   selector 1; each hint in its column (or nowhere); each require's
//   nonce, count and (count + 1)^-1 (0 for 0); each depth less-than
//   witness (the dependency's bytes, a one-hot of the most significant
//   byte where it differs from the row's depth, byte DEPTH_W - 1 where
//   none does, and the two bytes there); then the op stream, in order.
// Its first `width` registers are trace row r. Rows n .. height - 1 (the
// padding) are zero but for their nonce start + r in column 0.
//
// What bounds it on this card: bytes. A row writes `width` words and reads
// its streams' few dozen; its field operations are the inverses (about 41
// Montgomery products each: one per INVZ op, one per row for all of its
// requires) and a few dozen more, which the SMs' integer pipes retire far
// faster than the trace and the streams cross HBM at 3.35 TB/s.
//
// - The register file in shared memory, canonical: register c of the
//   tile's row j at word c * ld + j, with ld = T or T + 1, odd. The threads
//   of a warp, each on its own row, read one register side by side; a warp
//   reading one row's registers c, c + 1, ... steps ld words, odd, so both
//   touch 32 banks.
// - The block places the streams with all of its threads, a (row, word)
//   pair each, so a warp reads a row's words side by side; then each thread
//   computes its row; then the block writes the rows, a warp on 32 columns
//   of one row at a time, so each store is one row's consecutive words.
// - Products of canonical values through two Montgomery reductions
//   (babybear.cuh's mul); an inverse in Montgomery form (minv). A row's
//   require inverses are one inverse of their product (Montgomery's trick,
//   the prefix products parked in the inverse columns); a count + 1 of 0
//   enters the product as 1 and gets 0.
// - Stream values are field elements (below p), as every query value is.

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

#include "babybear.cuh"
#include "on_device.cuh"

namespace {

constexpr int MAX_THREADS = 128;     // the largest tile the wrapper picks
constexpr int SMEM_MAX = 232448;     // a block's shared memory on sm_90
constexpr int DEPTH_W = 4;           // bytes of a depth (func_chip.py)
constexpr int META = 4;              // words a row: r, its three offsets
// the VM's opcodes (device_trace.py)
constexpr int NOP = 0;
constexpr int ADD = 1;
constexpr int SUB = 2;
constexpr int MUL = 3;
constexpr int INVZ = 4;
constexpr int EQZ = 5;
constexpr int CONST = 6;

// A path's header: counts and word offsets into WitnessArgs::prog, each
// section at a 4-word boundary. Ops are 4 words (opcode, dst, a, b; a
// CONST's a is its value); a require is 4 (nonce, count and inverse
// columns, 2 k + s for pair k of the row's requires (s = 0) or depth
// requires (s = 1)); a hint is its column, or -1 where it has none; a
// depth less-than witness is 12 (the hint index of the dependency's depth,
// its 10 columns, 0); the depth's byte columns one word each.
enum PathWord {
  PW_N_OPS, PW_OPS, PW_N_REQ, PW_REQ, PW_N_HINT, PW_HINT, PW_N_DLT, PW_DLT,
  PW_N_DEPTH, PW_DEPTH, PW_IN, PW_OUT, PW_SEL, PW_PROV_NONCE, PW_PROV_COUNT,
  PW_PAD, PATH_WORDS
};

// Every field is 8 bytes wide, so the layout has no padding and matches
// the wrapper's ctypes structure field for field (the wrapper checks the
// size, and a CPU test the names and their order). The streams lie in one
// buffer, each at a 16-byte boundary.
struct WitnessArgs {
  const int32_t* tiles;      // (n_tiles, 4): path, first sorted row, rows, 0
  long long n_tiles;
  long long pad_tiles;       // blocks after the tiles: T padding rows each
  long long tile;            // T: rows and threads of a block
  long long ld;              // register stride in words: odd, >= T
  long long n_reg;           // registers a row, the most of any path
  const int32_t* paths;      // (paths, PATH_WORDS) headers
  const int32_t* prog;       // the paths' sections
  const int32_t* order;      // (n,) chip rows sorted by path
  long long start;           // query row of chip row 0
  long long n;               // real rows
  const int32_t* args;       // (n, n_in) words
  long long n_in;
  const int32_t* outs;       // (n, n_out)
  long long n_out;
  const int32_t* provide;    // (n, 2)
  const int32_t* depth;      // (n,): the low 32 bits, all the trace reads
  const int32_t* req_offs;   // (n + 1,) offsets into the whole stream; the
  const int32_t* req;        // range's words from req_offs[0] on
  const int32_t* dreq_offs;
  const int32_t* dreq;
  const int32_t* hint_offs;
  const int32_t* hint;
  int32_t* trace;            // (height, width) row-major
  long long height;
  long long width;
};

__device__ __forceinline__ uint32_t ld(const int32_t* p) {
  return static_cast<uint32_t>(__ldg(p));
}

__device__ __forceinline__ int4 ld4(const int32_t* p) {  // 16-byte aligned
  return __ldg(reinterpret_cast<const int4*>(p));
}

__device__ __forceinline__ uint32_t byte_of(uint32_t v, int b) {
  return (v >> (8 * b)) & 0xffu;
}

// (v + 1) mod p in Montgomery form, and 1 (ONE_M) where that is 0.
__device__ __forceinline__ uint32_t plus_one_m(uint32_t v) {
  const uint32_t s = bb::reduce1(v + 1u);
  return s == 0u ? bb::ONE_M : bb::to_mont(s);
}

// Registers of the block's rows j < rows from an (n, k) stream: register
// cols[c] (or first + c where cols is null) of row j takes word c of row
// meta[META j]. The block's threads take the (row, word) pairs in order.
__device__ void place(uint32_t* X, int ld_x, const uint32_t* meta, int rows,
                      const int32_t* src, int k, int first) {
  for (int e = threadIdx.x; e < rows * k; e += blockDim.x) {
    const int j = e / k, c = e - j * k;
    X[(first + c) * ld_x + j] =
        ld(src + static_cast<long long>(meta[META * j]) * k + c);
  }
}

// Rows n + T p .. of the trace, p = blockIdx.x - n_tiles: zero but for
// their nonce in column 0 (device_trace._init_trace's rows).
__device__ void padding_rows(const WitnessArgs& a, long long p) {
  const long long r0 = a.n + p * a.tile;
  const long long end = r0 + a.tile < a.height ? r0 + a.tile : a.height;
  const int w = static_cast<int>(a.width);
  const long long cells = (end - r0) * w;
  for (long long e = threadIdx.x; e < cells; e += blockDim.x) {
    const long long j = e / w;
    const int c = static_cast<int>(e - j * w);
    a.trace[(r0 + j) * w + c] =
        c == 0 ? static_cast<int32_t>(a.start + r0 + j) : 0;
  }
}

// Shared memory of a block, in words: [rows' meta (META T) | registers
// (n_reg ld)].
__global__ void __launch_bounds__(MAX_THREADS)
witness_kernel(const __grid_constant__ WitnessArgs a) {
  extern __shared__ __align__(16) uint32_t smem[];
  if (blockIdx.x >= a.n_tiles) {
    padding_rows(a, blockIdx.x - a.n_tiles);
    return;
  }
  const int T = blockDim.x;
  const int t = threadIdx.x;
  const int ld_x = static_cast<int>(a.ld);
  const int n_reg = static_cast<int>(a.n_reg);
  const int4 tl = ld4(a.tiles + 4 * blockIdx.x);
  const int rows = tl.z;
  const int32_t* hdr = a.paths + PATH_WORDS * tl.x;
  uint32_t* meta = smem;
  uint32_t* X = smem + META * T;

  // each row's chip row and its offsets into the three flat streams
  if (t < rows) {
    const uint32_t r = ld(a.order + tl.y + t);
    meta[META * t] = r;
    meta[META * t + 1] = ld(a.req_offs + r) - ld(a.req_offs);
    meta[META * t + 2] = ld(a.dreq_offs + r) - ld(a.dreq_offs);
    meta[META * t + 3] = ld(a.hint_offs + r) - ld(a.hint_offs);
  }
  for (int i = t; i < n_reg * ld_x; i += T) X[i] = 0u;
  __syncthreads();

  // the streams' words into their registers, by the whole block
  const int n_in = static_cast<int>(a.n_in);
  const int n_out = static_cast<int>(a.n_out);
  place(X, ld_x, meta, rows, a.args, n_in, __ldg(hdr + PW_IN));
  place(X, ld_x, meta, rows, a.outs, n_out, __ldg(hdr + PW_OUT));
  const int prov = __ldg(hdr + PW_PROV_NONCE);
  const int prov_count = __ldg(hdr + PW_PROV_COUNT);
  for (int e = t; e < 2 * rows; e += T) {
    const int j = e >> 1, c = e & 1;
    X[(c ? prov_count : prov) * ld_x + j] =
        ld(a.provide + 2 * static_cast<long long>(meta[META * j]) + c);
  }
  const int n_hint = __ldg(hdr + PW_N_HINT);
  const int32_t* hint_cols = a.prog + __ldg(hdr + PW_HINT);
  for (int e = t; e < rows * n_hint; e += T) {
    const int j = e / n_hint, h = e - j * n_hint;
    const int col = __ldg(hint_cols + h);
    if (col >= 0) X[col * ld_x + j] = ld(a.hint + meta[META * j + 3] + h);
  }
  const int n_req = __ldg(hdr + PW_N_REQ);
  const int32_t* reqs = a.prog + __ldg(hdr + PW_REQ);
  for (int e = t; e < rows * n_req; e += T) {
    const int j = e / n_req, i = e - j * n_req;
    const int4 q = ld4(reqs + 4 * i);
    const int32_t* pair = (q.w & 1) ? a.dreq + meta[META * j + 2]
                                    : a.req + meta[META * j + 1];
    pair += 2 * (q.w >> 1);
    X[q.x * ld_x + j] = ld(pair);
    X[q.y * ld_x + j] = ld(pair + 1);
  }
  __syncthreads();

  if (t < rows) {
    uint32_t* x = X + t;                       // register c at x[c * ld]
    const uint32_t r = meta[META * t];
    x[0] = static_cast<uint32_t>((a.start + r) % bb::P);
    x[__ldg(hdr + PW_SEL) * ld_x] = 1u;
    const uint32_t own = ld(a.depth + r);
    const int n_depth = __ldg(hdr + PW_N_DEPTH);
    const int32_t* depth_cols = a.prog + __ldg(hdr + PW_DEPTH);
    for (int b = 0; b < n_depth; ++b)
      x[__ldg(depth_cols + b) * ld_x] = byte_of(own, b);

    // the requires' inverses: forward, each inverse column holds the
    // product of the (count + 1)s before it; backward from one inverse
    uint32_t acc = bb::ONE_M;
    for (int i = 0; i < n_req; ++i) {
      const int4 q = ld4(reqs + 4 * i);
      x[q.z * ld_x] = acc;
      acc = bb::mmul(acc, plus_one_m(x[q.y * ld_x]));
    }
    uint32_t inv = bb::minv(acc);
    for (int i = n_req - 1; i >= 0; --i) {
      const int4 q = ld4(reqs + 4 * i);
      const uint32_t c = x[q.y * ld_x];
      const uint32_t before = x[q.z * ld_x];
      x[q.z * ld_x] = bb::reduce1(c + 1u) == 0u
                          ? 0u
                          : bb::redc(bb::mmul(inv, before));
      inv = bb::mmul(inv, plus_one_m(c));
    }

    // the depth less-than witnesses against the row's depth
    const int n_dlt = __ldg(hdr + PW_N_DLT);
    const int32_t* dlt = a.prog + __ldg(hdr + PW_DLT);
    const int32_t* hints = a.hint + meta[META * t + 3];
    for (int k = 0; k < n_dlt; ++k) {
      const int32_t* w = dlt + 12 * k;
      const uint32_t dep = ld(hints + __ldg(w));
      int ms = DEPTH_W - 1;
      for (int b = DEPTH_W - 1; b >= 0; --b)
        if (byte_of(dep, b) != byte_of(own, b)) {
          ms = b;
          break;
        }
      for (int b = 0; b < DEPTH_W; ++b) {
        x[__ldg(w + 1 + b) * ld_x] = byte_of(dep, b);
        x[__ldg(w + 1 + DEPTH_W + b) * ld_x] = b == ms;
      }
      x[__ldg(w + 1 + 2 * DEPTH_W) * ld_x] = byte_of(dep, ms);
      x[__ldg(w + 2 + 2 * DEPTH_W) * ld_x] = byte_of(own, ms);
    }

    // the op stream; operands are read before the write
    const int n_ops = __ldg(hdr + PW_N_OPS);
    const int32_t* ops = a.prog + __ldg(hdr + PW_OPS);
    for (int i = 0; i < n_ops; ++i) {
      const int4 op = ld4(ops + 4 * i);
      uint32_t v = 0u;
      switch (op.x) {
        case ADD:
          v = bb::add(x[op.z * ld_x], x[op.w * ld_x]);
          break;
        case SUB:
          v = bb::sub(x[op.z * ld_x], x[op.w * ld_x]);
          break;
        case MUL:
          v = bb::mul(x[op.z * ld_x], x[op.w * ld_x]);
          break;
        case INVZ:
          v = bb::redc(bb::minv(bb::to_mont(x[op.z * ld_x])));
          break;
        case EQZ:
          v = x[op.z * ld_x] == 0u;
          break;
        case CONST:
          v = static_cast<uint32_t>(op.z);
          break;
        case NOP:
        default:
          break;
      }
      x[op.y * ld_x] = v;
    }
  }
  __syncthreads();

  // the rows' first `width` registers into the trace, row by row
  const int w = static_cast<int>(a.width);
  for (int e = t; e < rows * w; e += T) {
    const int j = e / w, c = e - j * w;
    a.trace[static_cast<long long>(meta[META * j]) * w + c] =
        static_cast<int32_t>(X[c * ld_x + j]);
  }
}

using lurk::on_device;

// Bit d: the kernel may take SMEM_MAX bytes of dynamic shared memory on
// device d (the attribute belongs to the kernel on each device). Every call
// sets the same value, so host threads that launch at once with different
// tiles never lower it under one another's launch.
std::atomic<unsigned long long> witness_ready{0};

cudaError_t configure() {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ULL << dev : 0ULL;
  if (witness_ready.load() & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(witness_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_MAX);
  if (err == cudaSuccess) witness_ready.fetch_or(bit);
  return err;
}

long long witness_smem(const WitnessArgs& a) {
  return 4 * (META * a.tile + a.n_reg * a.ld);
}

}  // namespace

extern "C" {

// sizeof the argument structure, for the wrapper's layout check.
long long lurk_witness_args_size() { return sizeof(WitnessArgs); }

// One chip's trace, written to args->trace, in one launch of n_tiles +
// pad_tiles blocks of `tile` threads. `args` is a WitnessArgs (passed as
// void*: a parameter of a type in the unnamed namespace would take the
// function's external linkage away). Launches on `stream` (a stream of
// `device`) without synchronising; the caller's current device is
// unchanged on return. Returns a cudaError_t (0 on success).
int lurk_witness_trace(int device, const void* args, void* stream) {
  const WitnessArgs& a = *static_cast<const WitnessArgs*>(args);
  const long long blocks = a.n_tiles + a.pad_tiles;
  if (blocks == 0) return 0;
  if (a.tile < 1 || a.tile > MAX_THREADS || a.ld < a.tile || !(a.ld & 1))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long smem = witness_smem(a);
  if (smem > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return on_device(device, [&]() -> int {
    cudaError_t err = configure();
    if (err != cudaSuccess) return static_cast<int>(err);
    witness_kernel<<<static_cast<unsigned>(blocks),
                     static_cast<unsigned>(a.tile),
                     static_cast<size_t>(smem), s>>>(a);
    return static_cast<int>(cudaGetLastError());
  });
}

}  // extern "C"
