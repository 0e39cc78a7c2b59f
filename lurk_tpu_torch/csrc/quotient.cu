// The prover's constraint quotient and LogUp perm trace for NVIDIA Hopper
// (sm_90a): two kernels over one chip's rows, canonical BabyBear.
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
// Layout. One thread per row. The VM's operand space is [R registers |
// Wx local columns | Wx next columns | constants], its columns [main |
// prep | first | last | transition | ones]; main, prep and perm are column
// slices of their round's leaf concat, read in place through a base
// pointer and a row stride. The register file is a (R, scratch_ld) int32
// buffer that the caller allocates: register r of thread t sits at
// scratch[r * scratch_ld + t], so a warp's register accesses coalesce, and
// the memory is the caching allocator's, not the per-thread local memory
// the runtime would reserve for every resident thread. Every thread runs
// the same op at the same time, so the op stream is warp-uniform.
//
// What bounds it on this card: memory traffic. Each op reads two operands
// and writes one register in device memory (12 bytes a row), and the
// register file of the rows in flight exceeds the 50 MB L2, so the kernel
// moves about 12 * n_ops bytes a row where the inputs are a few hundred.
// A first version that is right; keeping registers on chip is later work.

#include <cstdint>
#include <cuda_runtime.h>

#include "babybear.cuh"

namespace {

using bb::Ext;

constexpr int THREADS = 256;
constexpr int OP_ADD = 0;
constexpr int OP_SUB = 1;

// Every field is 8 bytes wide, so the layout has no padding and matches
// the wrapper's ctypes structures field for field (the wrapper checks the
// size, and a CPU test the names and their order).
struct QuotientArgs {
  const int32_t* main;       // (big, main_w) slice, row stride main_ld
  long long main_ld;
  long long main_w;
  const int32_t* prep;       // (big, prep_w) slice or null
  long long prep_ld;
  long long prep_w;
  const int32_t* perm;       // (big, 4 (nb + 1)) slice
  long long perm_ld;
  long long nb;
  const int64_t* first;      // (big,) coset selectors, canonical
  const int64_t* last;
  const int64_t* trans;
  long long log_big;
  long long stride;          // next row = (i + stride) mod big
  const int32_t* ops;        // (n_ops, 4): op, dst, a, b
  long long n_ops;
  long long n_regs;
  const int32_t* consts;     // (n_consts,) canonical
  long long n_consts;
  const int32_t* wbase;      // (n_cons, 4) canonical ext fold weights
  long long n_cons;
  const int32_t* wb;         // (nb, 4)
  const int32_t* wsel;       // (3, 4)
  const int32_t* ti;         // (n_t, 2 nb) column indices
  const int32_t* tw;         // (n_t, 2 nb, 4) ext term weights
  long long n_t;
  const int32_t* dconst;     // (2 nb, 4)
  const int32_t* mi;         // (n_m, 2 nb) column indices
  const int32_t* mw;         // (n_m, 2 nb) base weights
  long long n_m;
  const int32_t* mconst;     // (2 nb,)
  const int32_t* cum;        // (4,)
  int32_t* scratch;          // (n_regs, scratch_ld) register file
  long long scratch_ld;
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
  const int32_t* ti;
  const int32_t* tw;
  long long n_t;
  const int32_t* dconst;
  const int32_t* mi;
  const int32_t* mw;
  long long n_m;
  const int32_t* mconst;
  int32_t* out;              // phi_b at out[i * out_ld + 4 b + l]
  long long out_ld;
};

__device__ __forceinline__ uint32_t ld(const int32_t* p) {
  return static_cast<uint32_t>(__ldg(p));
}

__device__ __forceinline__ Ext ld_ext(const int32_t* p) {
  return Ext{{ld(p), ld(p + 1), ld(p + 2), ld(p + 3)}};
}

// Column c of the quotient's [main | prep | first | last | transition |
// ones] at LDE row `row`.
struct QuotientCols {
  const QuotientArgs& a;
  __device__ uint32_t operator()(long long c, long long row) const {
    if (c < a.main_w) return ld(a.main + row * a.main_ld + c);
    c -= a.main_w;
    if (c < a.prep_w) return ld(a.prep + row * a.prep_ld + c);
    c -= a.prep_w;
    if (c == 0) return static_cast<uint32_t>(a.first[row]);
    if (c == 1) return static_cast<uint32_t>(a.last[row]);
    if (c == 2) return static_cast<uint32_t>(a.trans[row]);
    return 1u;
  }
};

// Column c of the perm trace's [main | prep | first | last | transition]
// at trace row `row`; the selectors are the row-indicator columns.
struct PermCols {
  const PermArgs& a;
  __device__ uint32_t operator()(long long c, long long row) const {
    if (c < a.main_w) return ld(a.main + row * a.main_ld + c);
    c -= a.main_w;
    if (c < a.prep_w) return ld(a.prep + row * a.prep_ld + c);
    c -= a.prep_w;
    if (c == 0) return row == 0 ? 1u : 0u;
    if (c == 1) return row == a.h - 1 ? 1u : 0u;
    return row < a.h - 1 ? 1u : 0u;
  }
};

// Interaction k's fingerprint dconst_k + sum_t tw[t][k] * X[ti[t][k]]
// and multiplicity mconst_k + sum_t mw[t][k] * X[mi[t][k]] at one row.
template <typename Cols>
__device__ Ext fingerprint(const Cols& x, long long row, long long k,
                           long long n, const int32_t* ti,
                           const int32_t* tw, long long n_t,
                           const int32_t* dconst) {
  Ext d = ld_ext(dconst + 4 * k);
  for (long long t = 0; t < n_t; ++t) {
    uint32_t v = x(ld(ti + t * n + k), row);
    d = bb::ext_add(d, bb::ext_scale(ld_ext(tw + 4 * (t * n + k)), v));
  }
  return d;
}

template <typename Cols>
__device__ uint32_t multiplicity(const Cols& x, long long row, long long k,
                                 long long n, const int32_t* mi,
                                 const int32_t* mw, long long n_m,
                                 const int32_t* mconst) {
  uint32_t m = ld(mconst + k);
  for (long long t = 0; t < n_m; ++t)
    m = bb::add(m, bb::mul(ld(mw + t * n + k), x(ld(mi + t * n + k), row)));
  return m;
}

__global__ void __launch_bounds__(THREADS)
quotient_kernel(const __grid_constant__ QuotientArgs a, long long row0,
                long long rows) {
  long long t = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (t >= rows) return;
  const long long big_mask = (1LL << a.log_big) - 1;
  const long long row = row0 + t;
  const long long nrow = (row + a.stride) & big_mask;
  const long long R = a.n_regs;
  const long long wx = a.main_w + a.prep_w + 4;
  const long long sld = a.scratch_ld;
  int32_t* regs = a.scratch + t;
  QuotientCols x{a};

  auto operand = [&](long long i) -> uint32_t {
    if (i < R) return static_cast<uint32_t>(regs[i * sld]);
    i -= R;
    if (i < wx) return x(i, row);
    i -= wx;
    if (i < wx) return x(i, nrow);
    return ld(a.consts + (i - wx));
  };

  for (long long k = 0; k < a.n_ops; ++k) {
    const int32_t* op = a.ops + 4 * k;
    int code = __ldg(op);
    uint32_t va = operand(__ldg(op + 2));
    uint32_t vb = operand(__ldg(op + 3));
    uint32_t v = code == OP_ADD ? bb::add(va, vb)
               : code == OP_SUB ? bb::sub(va, vb) : bb::mul(va, vb);
    long long dst = __ldg(op + 1);
    regs[dst * sld] = static_cast<int32_t>(v);
  }

  Ext acc = bb::ext_zero();
  for (long long c = 0; c < a.n_cons; ++c)
    acc = bb::ext_add(acc, bb::ext_scale(
        ld_ext(a.wbase + 4 * c), static_cast<uint32_t>(regs[c * sld])));

  const long long n = 2 * a.nb;
  const int32_t* pl = a.perm + row * a.perm_ld;
  const int32_t* pn = a.perm + nrow * a.perm_ld;
  Ext tphi = bb::ext_zero();
  Ext tphi_next = bb::ext_zero();
  for (long long b = 0; b < a.nb; ++b) {
    Ext phi = ld_ext(pl + 4 * b);
    tphi = bb::ext_add(tphi, phi);
    tphi_next = bb::ext_add(tphi_next, ld_ext(pn + 4 * b));
    Ext d0 = fingerprint(x, row, 2 * b, n, a.ti, a.tw, a.n_t, a.dconst);
    Ext d1 = fingerprint(x, row, 2 * b + 1, n, a.ti, a.tw, a.n_t, a.dconst);
    uint32_t m0 = multiplicity(x, row, 2 * b, n, a.mi, a.mw, a.n_m, a.mconst);
    uint32_t m1 = multiplicity(x, row, 2 * b + 1, n, a.mi, a.mw, a.n_m,
                               a.mconst);
    Ext lhs = bb::ext_mul(bb::ext_mul(phi, d0), d1);
    Ext rhs = bb::ext_add(bb::ext_scale(d1, m0), bb::ext_scale(d0, m1));
    acc = bb::ext_add(acc, bb::ext_mul(ld_ext(a.wb + 4 * b),
                                       bb::ext_sub(lhs, rhs)));
  }
  Ext s = ld_ext(pl + 4 * a.nb);
  Ext s_next = ld_ext(pn + 4 * a.nb);
  Ext first = bb::ext_scale(bb::ext_sub(s, tphi),
                            static_cast<uint32_t>(a.first[row]));
  Ext trans = bb::ext_scale(bb::ext_sub(bb::ext_sub(s_next, s), tphi_next),
                            static_cast<uint32_t>(a.trans[row]));
  Ext last = bb::ext_scale(bb::ext_sub(s, ld_ext(a.cum)),
                           static_cast<uint32_t>(a.last[row]));
  acc = bb::ext_add(acc, bb::ext_mul(ld_ext(a.wsel), first));
  acc = bb::ext_add(acc, bb::ext_mul(ld_ext(a.wsel + 4), trans));
  acc = bb::ext_add(acc, bb::ext_mul(ld_ext(a.wsel + 8), last));

  int32_t* o = a.out + 4 * row;
  for (int l = 0; l < 4; ++l) o[l] = static_cast<int32_t>(acc.c[l]);
}

__global__ void __launch_bounds__(THREADS)
perm_phi_kernel(const __grid_constant__ PermArgs a) {
  long long row = blockIdx.x * static_cast<long long>(blockDim.x) +
                  threadIdx.x;
  if (row >= a.h) return;
  PermCols x{a};
  const long long n = 2 * a.nb;
  int32_t* o = a.out + row * a.out_ld;
  for (long long b = 0; b < a.nb; ++b) {
    Ext phi = bb::ext_zero();
    for (long long k = 2 * b; k < 2 * b + 2; ++k) {
      Ext d = fingerprint(x, row, k, n, a.ti, a.tw, a.n_t, a.dconst);
      uint32_t m = multiplicity(x, row, k, n, a.mi, a.mw, a.n_m, a.mconst);
      phi = bb::ext_add(phi, bb::ext_scale(bb::ext_inv(d), m));
    }
    for (int l = 0; l < 4; ++l) o[4 * b + l] = static_cast<int32_t>(phi.c[l]);
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

unsigned blocks(long long rows) {
  return static_cast<unsigned>((rows + THREADS - 1) / THREADS);
}

}  // namespace

extern "C" {

// sizeof the argument structures, for the wrapper's layout check.
long long lurk_quotient_args_size() { return sizeof(QuotientArgs); }
long long lurk_perm_args_size() { return sizeof(PermArgs); }

// Rows row0 .. row0 + rows of the constraint quotient's fold, written to
// args->out; rows <= args->scratch_ld. `args` is a QuotientArgs (passed
// as void*: a parameter of a type in the unnamed namespace would take the
// function's external linkage away). Launches on `stream` (a stream of
// `device`) without synchronising; the caller's current device is
// unchanged on return. Returns a cudaError_t (0 on success).
int lurk_constraint_quotient(int device, const void* args, long long row0,
                             long long rows, void* stream) {
  if (rows <= 0) return 0;
  const QuotientArgs& a = *static_cast<const QuotientArgs*>(args);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return on_device(device, [&]() -> int {
    quotient_kernel<<<blocks(rows), THREADS, 0, s>>>(a, row0, rows);
    return static_cast<int>(cudaGetLastError());
  });
}

// Every row's batch contributions phi, written to args->out (a PermArgs).
// Launches as lurk_constraint_quotient does.
int lurk_logup_perm_phi(int device, const void* args, void* stream) {
  const PermArgs& a = *static_cast<const PermArgs*>(args);
  if (a.h <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return on_device(device, [&]() -> int {
    perm_phi_kernel<<<blocks(a.h), THREADS, 0, s>>>(a);
    return static_cast<int>(cudaGetLastError());
  });
}

}  // extern "C"
