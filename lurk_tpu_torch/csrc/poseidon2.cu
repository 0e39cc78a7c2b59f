// Poseidon2 permutation over BabyBear for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel lurk_tpu/poseidon/tpu_kernel.py::
// permute_mont_tpu (body _perm_kernel -> _permute_tile). Same function:
// `n_chain` Poseidon2 permutations of a (width, batch) Montgomery-form
// state, widths 16/24/32/40 with R_F = 8 and R_P = 13/21/30/38:
//   external layer;
//   4 full rounds: add RC, x^7 on every lane, external layer;
//   R_P partial rounds: add RC and x^7 on lane 0, then diag*s + sum(s);
//   4 full rounds.
// The external layer is the blockwise M4 followed by the block-column
// sums, exactly lurk_tpu/poseidon/ref.py.
//
// Design. One thread owns one permutation state, held in registers
// (at most 40 x u32), rounds fully unrolled. Thread t reads
// state[i * batch + t], so a warp's loads and stores are coalesced on
// the (width, batch) layout the hasher already uses. Any batch size
// works: the grid covers ceil(batch / 128) blocks and the ragged edge is
// bounds-checked. Round constants and the internal diagonal sit in
// __constant__ memory in Montgomery form; every thread of a warp reads the
// same constant at the same time, which the constant cache broadcasts.
//
// What bounds it on this card: 32-bit integer multiply throughput. A
// Montgomery multiply is one 32x32->64 product plus two more multiplies
// for the reduction; a w24 permutation needs roughly 1.3k of them against
// 192 bytes of device-memory traffic (96 in, 96 out), so the kernel is
// compute bound by two orders of magnitude and the layout only has to keep
// the loads coalesced. The TPU kernel's sublane repacking and 16x16-bit
// partial products do not carry over: Hopper has a native wide multiply.

#include <cstdint>
#include <cuda_runtime.h>

#include "on_device.cuh"

namespace {

constexpr uint32_t P = 0x78000001u;   // 2^31 - 2^27 + 1
constexpr uint32_t MU = 0x77ffffffu;  // -p^-1 mod 2^32
constexpr int R_F = 8;
constexpr int THREADS = 128;

template <int W> struct Consts {
  uint32_t full[R_F][W];
  uint32_t part[W == 16 ? 13 : W == 24 ? 21 : W == 32 ? 30 : 38];
  uint32_t diag[W];
};

__constant__ Consts<16> k16;
__constant__ Consts<24> k24;
__constant__ Consts<32> k32;
__constant__ Consts<40> k40;

template <int W> __device__ __forceinline__ const Consts<W>& consts();
template <> __device__ __forceinline__ const Consts<16>& consts<16>() { return k16; }
template <> __device__ __forceinline__ const Consts<24>& consts<24>() { return k24; }
template <> __device__ __forceinline__ const Consts<32>& consts<32>() { return k32; }
template <> __device__ __forceinline__ const Consts<40>& consts<40>() { return k40; }

__device__ __forceinline__ uint32_t add(uint32_t a, uint32_t b) {
  uint32_t s = a + b;  // a, b < p < 2^31: no wrap
  return s >= P ? s - P : s;
}

// Montgomery product a*b*2^-32 mod p for a, b < p.
__device__ __forceinline__ uint32_t mul(uint32_t a, uint32_t b) {
  uint64_t t = static_cast<uint64_t>(a) * b;            // < 2^62
  uint32_t m = static_cast<uint32_t>(t) * MU;
  uint64_t u = (t + static_cast<uint64_t>(m) * P) >> 32;  // < 2p
  uint32_t r = static_cast<uint32_t>(u);
  return r >= P ? r - P : r;
}

__device__ __forceinline__ uint32_t pow7(uint32_t x) {
  uint32_t x2 = mul(x, x);
  uint32_t x3 = mul(x2, x);
  uint32_t x6 = mul(x3, x3);
  return mul(x6, x);
}

template <int W>
__device__ __forceinline__ void external_layer(uint32_t (&s)[W]) {
  uint32_t sums[4] = {0, 0, 0, 0};
#pragma unroll
  for (int c = 0; c < W; c += 4) {
    uint32_t x0 = s[c], x1 = s[c + 1], x2 = s[c + 2], x3 = s[c + 3];
    uint32_t t01 = add(x0, x1);
    uint32_t t23 = add(x2, x3);
    uint32_t t0123 = add(t01, t23);
    uint32_t t01123 = add(t0123, x1);
    uint32_t t01233 = add(t0123, x3);
    s[c] = add(t01123, t01);
    s[c + 1] = add(t01123, add(x2, x2));
    s[c + 2] = add(t01233, t23);
    s[c + 3] = add(t01233, add(x0, x0));
#pragma unroll
    for (int k = 0; k < 4; ++k) sums[k] = add(sums[k], s[c + k]);
  }
#pragma unroll
  for (int i = 0; i < W; ++i) s[i] = add(s[i], sums[i & 3]);
}

template <int W>
__device__ __forceinline__ void full_round(uint32_t (&s)[W], int r) {
  const Consts<W>& k = consts<W>();
#pragma unroll
  for (int i = 0; i < W; ++i) s[i] = pow7(add(s[i], k.full[r][i]));
  external_layer<W>(s);
}

template <int W, int RP>
__device__ __forceinline__ void permute(uint32_t (&s)[W]) {
  const Consts<W>& k = consts<W>();
  external_layer<W>(s);
#pragma unroll
  for (int r = 0; r < R_F / 2; ++r) full_round<W>(s, r);
#pragma unroll
  for (int r = 0; r < RP; ++r) {
    s[0] = pow7(add(s[0], k.part[r]));
    uint32_t sum = s[0];
#pragma unroll
    for (int i = 1; i < W; ++i) sum = add(sum, s[i]);
#pragma unroll
    for (int i = 0; i < W; ++i) s[i] = add(mul(s[i], k.diag[i]), sum);
  }
#pragma unroll
  for (int r = R_F / 2; r < R_F; ++r) full_round<W>(s, r);
}

template <int W, int RP>
__global__ void __launch_bounds__(THREADS)
perm_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
            long long batch, int n_chain) {
  long long t = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (t >= batch) return;
  uint32_t s[W];
#pragma unroll
  for (int i = 0; i < W; ++i) s[i] = in[i * batch + t];
  for (int c = 0; c < n_chain; ++c) permute<W, RP>(s);
#pragma unroll
  for (int i = 0; i < W; ++i) out[i * batch + t] = s[i];
}

template <int W, int RP>
int launch(const uint32_t* in, uint32_t* out, long long batch, int n_chain,
           cudaStream_t stream) {
  long long blocks = (batch + THREADS - 1) / THREADS;
  perm_kernel<W, RP><<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(
      in, out, batch, n_chain);
  return static_cast<int>(cudaGetLastError());
}

template <int W>
int set_consts(const Consts<W>& sym, const uint32_t* full,
               const uint32_t* part, const uint32_t* diag) {
  Consts<W> h;
  for (int r = 0; r < R_F; ++r)
    for (int i = 0; i < W; ++i) h.full[r][i] = full[r * W + i];
  for (size_t r = 0; r < sizeof(h.part) / sizeof(uint32_t); ++r)
    h.part[r] = part[r];
  for (int i = 0; i < W; ++i) h.diag[i] = diag[i];
  return static_cast<int>(cudaMemcpyToSymbol(sym, &h, sizeof(h)));
}

using lurk::on_device;

}  // namespace

extern "C" {

// Number of partial rounds the kernel was compiled with for `width`
// (0: width not supported). The wrapper checks it against the constants.
int lurk_poseidon2_partial_rounds(int width) {
  switch (width) {
    case 16: return static_cast<int>(sizeof(Consts<16>::part) / 4);
    case 24: return static_cast<int>(sizeof(Consts<24>::part) / 4);
    case 32: return static_cast<int>(sizeof(Consts<32>::part) / 4);
    case 40: return static_cast<int>(sizeof(Consts<40>::part) / 4);
    default: return 0;
  }
}

// Upload Montgomery-form constants for one width to `device`: full
// (R_F, width) row-major, part (R_P,), diag (width,). The caller's current
// device is unchanged on return. Returns a cudaError_t.
int lurk_poseidon2_set_constants(int device, int width, const uint32_t* full,
                                 const uint32_t* part, const uint32_t* diag) {
  return on_device(device, [&]() -> int {
    switch (width) {
      case 16: return set_consts<16>(k16, full, part, diag);
      case 24: return set_consts<24>(k24, full, part, diag);
      case 32: return set_consts<32>(k32, full, part, diag);
      case 40: return set_consts<40>(k40, full, part, diag);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  });
}

// out = n_chain permutations of in; both (width, batch) u32 Montgomery,
// contiguous, on `device`. Launches on `stream` (a stream of that device)
// without synchronising; the caller's current device is unchanged on
// return. Returns a cudaError_t (0 on success).
int lurk_poseidon2_permute(int device, const uint32_t* in, uint32_t* out,
                           int width, long long batch, int n_chain,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch <= 0) return 0;
  return on_device(device, [&]() -> int {
    switch (width) {
      case 16: return launch<16, 13>(in, out, batch, n_chain, s);
      case 24: return launch<24, 21>(in, out, batch, n_chain, s);
      case 32: return launch<32, 30>(in, out, batch, n_chain, s);
      case 40: return launch<40, 38>(in, out, batch, n_chain, s);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  });
}

}  // extern "C"
