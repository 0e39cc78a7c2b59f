// BabyBear field and its degree-4 extension on the device, canonical form.
//
// Every value is a canonical residue in [0, p), stored as a 32-bit word
// (the port's int32 tensors hold the same bits). A product is exact: the
// 62-bit product is brought back below p by two Montgomery reductions,
// the second against R^2 = 2^64 mod p, so the result is a*b mod p itself
// and not a Montgomery form. The extension is F_p[x] / (x^4 - 11), as in
// lurk_tpu_torch/field/ext.py, and its inverse maps 0 to 0 as einv does.
//
// Shared by the constraint-quotient and LogUp perm-trace kernels
// (quotient.cu). tests/test_torch_quotient_kernel.py holds the constants
// below to the field's own.

#pragma once

#include <cstdint>

namespace bb {

constexpr uint32_t P = 0x78000001u;     // 2^31 - 2^27 + 1
constexpr uint32_t MU = 0x77ffffffu;    // -p^-1 mod 2^32
constexpr uint32_t R2 = 0x45dddde3u;    // 2^64 mod p
constexpr uint32_t W = 11u;             // x^4 = W
// FROB[i] = c^i with c = W^((p-1)/4): the Frobenius map scales
// coefficient i of a^(p^k) by c^(i*k mod 4)
constexpr uint32_t FROB1 = 1728404513u;
constexpr uint32_t FROB2 = 2013265920u;  // c^2 = p - 1
constexpr uint32_t FROB3 = 284861408u;

__device__ __forceinline__ uint32_t add(uint32_t a, uint32_t b) {
  uint32_t s = a + b;  // a, b < p < 2^31: no wrap
  return s >= P ? s - P : s;
}

__device__ __forceinline__ uint32_t sub(uint32_t a, uint32_t b) {
  return a >= b ? a - b : a + (P - b);
}

// t * 2^-32 mod p for t < p * 2^32.
__device__ __forceinline__ uint32_t mont_reduce(uint64_t t) {
  uint32_t m = static_cast<uint32_t>(t) * MU;
  uint64_t u = (t + static_cast<uint64_t>(m) * P) >> 32;  // < 2p
  uint32_t r = static_cast<uint32_t>(u);
  return r >= P ? r - P : r;
}

// a * b mod p for a, b < p.
__device__ __forceinline__ uint32_t mul(uint32_t a, uint32_t b) {
  uint32_t x = mont_reduce(static_cast<uint64_t>(a) * b);  // a*b*2^-32
  return mont_reduce(static_cast<uint64_t>(x) * R2);
}

// x^(p-2): the inverse of x, and 0 for 0.
__device__ inline uint32_t inv(uint32_t x) {
  uint32_t acc = 1u;
  uint32_t base = x;
  uint32_t e = P - 2u;
  while (e) {
    if (e & 1u) acc = mul(acc, base);
    base = mul(base, base);
    e >>= 1;
  }
  return acc;
}

struct Ext {
  uint32_t c[4];
};

__device__ __forceinline__ Ext ext_zero() { return Ext{{0u, 0u, 0u, 0u}}; }

__device__ __forceinline__ Ext ext_add(const Ext& a, const Ext& b) {
  return Ext{{add(a.c[0], b.c[0]), add(a.c[1], b.c[1]),
              add(a.c[2], b.c[2]), add(a.c[3], b.c[3])}};
}

__device__ __forceinline__ Ext ext_sub(const Ext& a, const Ext& b) {
  return Ext{{sub(a.c[0], b.c[0]), sub(a.c[1], b.c[1]),
              sub(a.c[2], b.c[2]), sub(a.c[3], b.c[3])}};
}

__device__ __forceinline__ Ext ext_scale(const Ext& a, uint32_t s) {
  return Ext{{mul(a.c[0], s), mul(a.c[1], s), mul(a.c[2], s),
              mul(a.c[3], s)}};
}

__device__ inline Ext ext_mul(const Ext& a, const Ext& b) {
  const uint32_t* x = a.c;
  const uint32_t* y = b.c;
  uint32_t c0 = mul(x[0], y[0]);
  uint32_t c1 = add(mul(x[0], y[1]), mul(x[1], y[0]));
  uint32_t c2 = add(add(mul(x[0], y[2]), mul(x[1], y[1])), mul(x[2], y[0]));
  uint32_t c3 = add(add(mul(x[0], y[3]), mul(x[1], y[2])),
                    add(mul(x[2], y[1]), mul(x[3], y[0])));
  uint32_t c4 = add(add(mul(x[1], y[3]), mul(x[2], y[2])), mul(x[3], y[1]));
  uint32_t c5 = add(mul(x[2], y[3]), mul(x[3], y[2]));
  uint32_t c6 = mul(x[3], y[3]);
  return Ext{{add(c0, mul(c4, W)), add(c1, mul(c5, W)), add(c2, mul(c6, W)),
              c3}};
}

// a^-1 = b / N(a) with b = a^(p + p^2 + p^3) (three Frobenius maps) and
// the norm N(a) = (a * b)_0 in the base field; 0 maps to 0.
__device__ inline Ext ext_inv(const Ext& a) {
  Ext f1{{a.c[0], mul(a.c[1], FROB1), mul(a.c[2], FROB2),
          mul(a.c[3], FROB3)}};
  Ext f2{{a.c[0], mul(a.c[1], FROB2), a.c[2], mul(a.c[3], FROB2)}};
  Ext f3{{a.c[0], mul(a.c[1], FROB3), mul(a.c[2], FROB2),
          mul(a.c[3], FROB1)}};
  Ext b = ext_mul(f1, ext_mul(f2, f3));
  uint32_t norm = ext_mul(a, b).c[0];
  return ext_scale(b, inv(norm));
}

}  // namespace bb
