// The column-batched NTT over BabyBear and the two-coset LDE of the
// prover's commits, for NVIDIA Hopper (sm_90a): one kernel, lurk_ntt_pass,
// launched once for each pass of a transform.
//
// It replaces lurk_tpu's jitted XLA NTT (lurk_tpu/field/ntt.py:
// device_ntt, its constant-geometry stages below the four-step threshold
// and the four-step split above it; not Pallas), which the commits' LDE
// (lurk_tpu/stark/device_prover.py: _lde_kernel, an INTT, a 1/n scale, a
// zero-padded 2h-point coset NTT) and the quotient's epilogue call. The
// port's eager version (field/ntt.py: device_ntt_plain's int64 stages) is
// the plain version; field/ntt_kernel.py packs the passes.
//
// What bounds it on this card: the SMs' integer pipes, then bytes. A
// pass reads and writes each value once (8 bytes of int32 a point); an
// LDE's Montgomery products (1.5 log h + 3 a trace cell) at the FMA and
// ALU pipes' rate take about twice the 16 bytes a trace cell that the LDE
// must move at 3.35 TB/s (chip_smoke.py phase 28 counts both). A
// transform of up to 2^11 points is one pass; above, the four-step split
// (lurk_tpu's derivation) in two passes up to 2^22 and three up to 2^27,
// the field's two-adicity. With n = n0 n1 ... and the input index
// j = j0 (n / n0) + r, pass 0 takes the n0-point transforms over j0 of
// each r and multiplies output k0 by w_n^(r k0); what is left is, for
// each k0, the (n / n0)-point transform over r, taken the same way. Each
// pass writes output digit k_l at its place in the natural order, weight
// n0 ... n_(l-1), and the digits it has not reached yet at theirs, so that
// pass 0 reads the input and writes the output matrix, and every later
// pass writes the rows it read (in place). The LDE writes its coset c's
// row r to row 2 r + c of the 2h-row output: the same passes with doubled
// output strides.
//
// - A block owns one transform's points across a tile of 2^log_lanes
//   neighbouring columns (32 where the pass is at most 2^9 points, fewer
//   above, so that a block's tile is at most 2^14 words, 64 KB), so each
//   point's row segment is one coalesced access, and a ragged width is
//   masked. Shared memory holds the tile as [point][lane]: the 32 lanes of
//   a warp sit in 32 banks.
// - The load places point j at bit-reversed position rev(j) (no gather
//   pass); radix-2 DIT stages, two at a time (four points a thread)
//   between barriers, leave natural order for the store.
// - Values stay canonical int32. Twiddles are in Montgomery form, so one
//   reduction (babybear.cuh's mmul) takes canonical times Montgomery to
//   canonical. The stage twiddles w_2h^j sit at TW[h + j] in one table of
//   2^11 words; the four-step twiddles and the LDE's coset powers s_c^k
//   are a product of the words of a three-level power table (base^i,
//   base^(2^11 i), base^(2^22 i), 2^11 words each), read through the
//   read-only cache.
// - Scales are fused: the coset shift s_c^k into the load of the
//   coefficients, w_n^(r k0) and the INTT's 1/n into the store.

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

#include "babybear.cuh"
#include "on_device.cuh"

namespace {

constexpr int MAX_PASS_LOG = 11;     // points of one pass: at most 2^11
constexpr int MAX_LANES_LOG = 5;     // columns of a block: at most 32
constexpr int BLOCK_WORDS_LOG = 14;  // a block's tile: at most 2^14 words
constexpr int TAB_LOG = 11;          // a power table: 3 levels of 2^11
constexpr int TAB = 1 << TAB_LOG;
constexpr int MAX_THREADS = 512;
constexpr int BATCH = 8;             // loads a thread issues before it waits

// One pass over row-major matrices of w columns. Block (g, t) of coset c
// reads point j from row c c_in + g g_in + t t_in + j j_in of src and
// writes its output k to row c c_out + g g_out + t t_out + k k_out of dst
// (src and dst may be one buffer: a block then writes only the rows it
// read). Every field is 8 bytes wide, so the layout matches the wrapper's
// ctypes structure field for field (the wrapper checks the size, a CPU
// test the names).
struct NttArgs {
  const int32_t* src;
  int32_t* dst;
  long long w;           // columns
  long long log_pts;     // points of each transform: 2^log_pts
  long long log_lanes;   // columns a block: 2^log_lanes
  long long j_in;        // the row steps of a point, a group, a batch and
  long long g_in;        // a coset, in src
  long long t_in;
  long long c_in;
  long long k_out;       // and of an output, a group, a batch and a
  long long g_out;       // coset, in dst
  long long t_out;
  long long c_out;
  long long groups;      // transforms a batch
  long long batches;
  long long cosets;      // 1, or 2 for the LDE's cosets
  long long tw_t;        // the store twiddle's exponent is (g + t tw_t) k
  const uint32_t* stage_tw;   // TW[h + j] = w_2h^j, Montgomery, 2^11 words
  const uint32_t* load_tab;   // coset c's power table at 3 TAB c, or null:
                              // point j times base_c^(g g_in + t t_in +
                              // j j_in)
  const uint32_t* store_tab;  // output k times base^((g + t tw_t) k), or
                              // null
  long long scale;            // then times this Montgomery factor, or 0
};

// base^e (e < 2^27), Montgomery, from a three-level power table.
__device__ __forceinline__ uint32_t pow_of(const uint32_t* tab,
                                           unsigned long long e) {
  uint32_t v = bb::mmul(__ldg(tab + TAB + ((e >> TAB_LOG) & (TAB - 1))),
                        __ldg(tab + (e & (TAB - 1))));
  if (e >> (2 * TAB_LOG))
    v = bb::mmul(v, __ldg(tab + 2 * TAB + (e >> (2 * TAB_LOG))));
  return v;
}

__global__ void __launch_bounds__(MAX_THREADS)
    lurk_ntt_pass(const NttArgs a) {
  extern __shared__ uint32_t X[];
  const int m = static_cast<int>(a.log_pts);
  const int lg = static_cast<int>(a.log_lanes);
  const int L = 1 << lg;
  const int n = 1 << m;
  const int T = blockDim.x;
  // blockIdx.x = tile + tiles (g + groups t): a row's tiles side by side
  const long long tiles = (a.w + L - 1) >> lg;
  const long long gt = static_cast<long long>(blockIdx.x) / tiles;
  const long long g = gt % a.groups, t = gt / a.groups;
  const long long c0 = (static_cast<long long>(blockIdx.x) % tiles) << lg;
  const long long c = blockIdx.y;

  // BATCH loads a thread in flight before their values are placed
  const int N = n << lg;
  const long long at = g * a.g_in + t * a.t_in;  // the load's exponent base
  const long long in0 = c * a.c_in + at;
  const uint32_t* ltab = a.load_tab ? a.load_tab + 3 * TAB * c : nullptr;
  for (int e0 = threadIdx.x; e0 < N; e0 += BATCH * T) {
    uint32_t v[BATCH];
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      const int e = e0 + k * T;
      const long long col = c0 + (e & (L - 1));
      v[k] = e < N && col < a.w
                 ? static_cast<uint32_t>(
                       a.src[(in0 + (e >> lg) * a.j_in) * a.w + col])
                 : 0u;
    }
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      const int e = e0 + k * T;
      if (e >= N) break;
      const int j = e >> lg;
      if (ltab)
        v[k] = bb::mmul(v[k], pow_of(ltab, at + j * a.j_in));
      const int r = m ? static_cast<int>(__brev(j) >> (32 - m)) : 0;
      X[(r << lg) + (e & (L - 1))] = v[k];
    }
  }
  __syncthreads();

  // stages s and s + 1: points base, base + h, base + 2h, base + 3h of a
  // block of 4h, base = 4h b + i with i < h
  int s = 0;
  for (; s + 2 <= m; s += 2) {
    const int h = 1 << s;
    const int st = h << lg;
    for (int q = threadIdx.x; q < ((n >> 2) << lg); q += T) {
      const int l = q & (L - 1), gi = q >> lg;
      const int i = gi & (h - 1);
      const int base = ((gi >> s) << (s + 2)) + i;
      uint32_t* x = X + (base << lg) + l;
      uint32_t x0 = x[0], x1 = x[st], x2 = x[2 * st], x3 = x[3 * st];
      const uint32_t t1 = __ldg(a.stage_tw + h + i);
      const uint32_t ta = __ldg(a.stage_tw + 2 * h + i);
      const uint32_t tb = __ldg(a.stage_tw + 3 * h + i);
      uint32_t u = bb::mmul(x1, t1);
      x1 = bb::msub(x0, u);
      x0 = bb::madd(x0, u);
      u = bb::mmul(x3, t1);
      x3 = bb::msub(x2, u);
      x2 = bb::madd(x2, u);
      u = bb::mmul(x2, ta);
      x2 = bb::msub(x0, u);
      x0 = bb::madd(x0, u);
      u = bb::mmul(x3, tb);
      x3 = bb::msub(x1, u);
      x1 = bb::madd(x1, u);
      x[0] = x0;
      x[st] = x1;
      x[2 * st] = x2;
      x[3 * st] = x3;
    }
    __syncthreads();
  }
  if (s < m) {  // the last stage alone: pairs base, base + h
    const int h = 1 << s;
    const int st = h << lg;
    for (int q = threadIdx.x; q < ((n >> 1) << lg); q += T) {
      const int l = q & (L - 1), gi = q >> lg;
      const int i = gi & (h - 1);
      const int base = ((gi >> s) << (s + 1)) + i;
      uint32_t* x = X + (base << lg) + l;
      const uint32_t u = bb::mmul(x[st], __ldg(a.stage_tw + h + i));
      const uint32_t x0 = x[0];
      x[0] = bb::madd(x0, u);
      x[st] = bb::msub(x0, u);
    }
    __syncthreads();
  }

  const long long out0 = c * a.c_out + g * a.g_out + t * a.t_out;
  const unsigned long long tw_base =
      static_cast<unsigned long long>(g + t * a.tw_t);
  const uint32_t scale = static_cast<uint32_t>(a.scale);
  for (int e0 = threadIdx.x; e0 < N; e0 += BATCH * T) {
#pragma unroll
    for (int q = 0; q < BATCH; ++q) {
      const int e = e0 + q * T;
      const int k = e >> lg;
      const long long col = c0 + (e & (L - 1));
      if (e >= N) break;
      if (col >= a.w) continue;
      uint32_t v = X[e];
      if (a.store_tab) v = bb::mmul(v, pow_of(a.store_tab, tw_base * k));
      if (scale) v = bb::mmul(v, scale);
      a.dst[(out0 + k * a.k_out) * a.w + col] = static_cast<int32_t>(v);
    }
  }
}

using lurk::on_device;

int pass_threads(const NttArgs& a) {
  const long long work = (1LL << (a.log_pts + a.log_lanes)) >> 2;
  return static_cast<int>(work < 32 ? 32
                          : work > MAX_THREADS ? MAX_THREADS : work);
}

// Bit d: the kernel may take 2^BLOCK_WORDS_LOG words of dynamic shared
// memory on device d (set once per device, never lowered).
std::atomic<unsigned long long> ntt_ready{0};

cudaError_t configure() {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ULL << dev : 0ULL;
  if (ntt_ready.load() & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(lurk_ntt_pass,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             4 << BLOCK_WORDS_LOG);
  if (err == cudaSuccess) ntt_ready.fetch_or(bit);
  return err;
}

}  // namespace

extern "C" {

// sizeof the argument structure, for the wrapper's layout check.
long long lurk_ntt_args_size() { return sizeof(NttArgs); }

// One pass (`args` a NttArgs, passed as void*) in one launch of
// ceil(w / 2^log_lanes) groups batches x cosets blocks, on `stream` (a
// stream of `device`) without synchronising; the caller's current device
// is unchanged on return. Returns a cudaError_t (0 on success).
int lurk_ntt_pass_launch(int device, const void* args, void* stream) {
  const NttArgs& a = *static_cast<const NttArgs*>(args);
  if (a.w == 0) return 0;
  if (a.log_pts < 0 || a.log_pts > MAX_PASS_LOG || a.log_lanes < 0 ||
      a.log_lanes > MAX_LANES_LOG ||
      a.log_pts + a.log_lanes > BLOCK_WORDS_LOG || a.w < 0 ||
      a.groups < 1 || a.batches < 1 ||
      a.cosets < 1 || a.cosets > 2 || a.stage_tw == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = (a.w + (1LL << a.log_lanes) - 1) >> a.log_lanes;
  if (a.groups > 0x7fffffff / a.batches / tiles)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 4ull << (a.log_pts + a.log_lanes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return on_device(device, [&]() -> int {
    cudaError_t err = configure();
    if (err != cudaSuccess) return static_cast<int>(err);
    lurk_ntt_pass<<<dim3(static_cast<unsigned>(tiles * a.groups * a.batches),
                         static_cast<unsigned>(a.cosets)),
                    pass_threads(a), smem, s>>>(a);
    return static_cast<int>(cudaGetLastError());
  });
}

}  // extern "C"
