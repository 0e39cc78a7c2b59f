// BabyBear field and its degree-4 extension on the device.
//
// Two forms. The canonical helpers (add, sub, mul, inv, ext_*) keep every
// value a residue in [0, p): a product is two Montgomery reductions, the
// second against R^2 = 2^64 mod p, so it is a*b mod p itself. The
// Montgomery helpers (redc, mmul, ext_mmul, ext_minv, ...) are what the
// kernels run: a value v is held as v * 2^32 mod p (to_mont), a product
// is ONE reduction (redc(a * b) = a * b * 2^-32), and sums of up to four
// 62-bit products are taken in 64 bits and reduced once. The extension
// is F_p[x] / (x^4 - 11), as in lurk_tpu_torch/field/ext.py, and both
// inverses map 0 to 0 as einv does.
//
// A product of a Montgomery value and a canonical one is canonical
// (v*R * c * R^-1 = v*c): the kernels keep their fold weights canonical
// and write canonical results without a conversion pass.
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
// the same in Montgomery form (x * 2^32 mod p); ONE_M is 1
constexpr uint32_t ONE_M = 268435454u;
constexpr uint32_t W_M = 939524073u;
constexpr uint32_t FROB1_M = 473486609u;
constexpr uint32_t FROB3_M = 1539779312u;

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

// ---------------------------------------------------------------------------
// Montgomery form with lazy reduction
//
// A 64-bit sum `t` of products stands for t * 2^-32 mod p. redc needs
// t < p * 2^32; fold_hi brings any t < 2p * 2^32 there by taking p * 2^32
// off its high word. One product is < p^2 < 0.47 p * 2^32, so a folded sum
// takes two more products before the next fold, and a sum from zero takes
// four (< 1.88 p * 2^32). Conditional subtracts are an unsigned min(s,
// s - p): s - p wraps above s when s < p.
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t reduce1(uint32_t s) {  // s < 2p
  return min(s, s - P);
}

__device__ __forceinline__ uint32_t madd(uint32_t a, uint32_t b) {
  return reduce1(a + b);
}

__device__ __forceinline__ uint32_t msub(uint32_t a, uint32_t b) {
  return reduce1(a + (P - b));  // P - b in (0, p]
}

__device__ __forceinline__ uint32_t mneg(uint32_t a) {
  return min(P - a, 0u - a);  // 0 for 0
}

// t * 2^-32 mod p for t < p * 2^32: one multiply-add and a subtract.
__device__ __forceinline__ uint32_t redc(uint64_t t) {
  uint32_t m = static_cast<uint32_t>(t) * MU;
  uint64_t u = t + static_cast<uint64_t>(m) * P;  // < 2p * 2^32, low word 0
  return reduce1(static_cast<uint32_t>(u >> 32));
}

// t mod p * 2^32 (the same residue) for t < 2p * 2^32.
__device__ __forceinline__ uint64_t fold_hi(uint64_t t) {
  uint32_t hi = reduce1(static_cast<uint32_t>(t >> 32));
  return (static_cast<uint64_t>(hi) << 32) | static_cast<uint32_t>(t);
}

__device__ __forceinline__ uint64_t wide(uint32_t a, uint32_t b) {
  return static_cast<uint64_t>(a) * b;
}

// a * b * 2^-32: Montgomery times Montgomery is Montgomery, Montgomery
// times canonical is canonical.
__device__ __forceinline__ uint32_t mmul(uint32_t a, uint32_t b) {
  return redc(wide(a, b));
}

__device__ __forceinline__ uint32_t to_mont(uint32_t a) {  // a < p
  return redc(wide(a, R2));
}

__device__ __forceinline__ Ext ext_madd(const Ext& a, const Ext& b) {
  return Ext{{madd(a.c[0], b.c[0]), madd(a.c[1], b.c[1]),
              madd(a.c[2], b.c[2]), madd(a.c[3], b.c[3])}};
}

__device__ __forceinline__ Ext ext_msub(const Ext& a, const Ext& b) {
  return Ext{{msub(a.c[0], b.c[0]), msub(a.c[1], b.c[1]),
              msub(a.c[2], b.c[2]), msub(a.c[3], b.c[3])}};
}

__device__ __forceinline__ Ext ext_mscale(const Ext& a, uint32_t s) {
  return Ext{{mmul(a.c[0], s), mmul(a.c[1], s), mmul(a.c[2], s),
              mmul(a.c[3], s)}};
}

// x * y given y and wy = (W y1, W y2, W y3): each coefficient is four
// products summed in 64 bits, one fold and one reduction.
__device__ __forceinline__ Ext ext_mmul_w(const Ext& x, const Ext& y,
                                          const uint32_t* wy) {
  const uint32_t* a = x.c;
  const uint32_t* b = y.c;
  uint64_t c0 = wide(a[0], b[0]) + wide(a[1], wy[2]) + wide(a[2], wy[1]) +
                wide(a[3], wy[0]);
  uint64_t c1 = wide(a[0], b[1]) + wide(a[1], b[0]) + wide(a[2], wy[2]) +
                wide(a[3], wy[1]);
  uint64_t c2 = wide(a[0], b[2]) + wide(a[1], b[1]) + wide(a[2], b[0]) +
                wide(a[3], wy[2]);
  uint64_t c3 = wide(a[0], b[3]) + wide(a[1], b[2]) + wide(a[2], b[1]) +
                wide(a[3], b[0]);
  return Ext{{redc(fold_hi(c0)), redc(fold_hi(c1)), redc(fold_hi(c2)),
              redc(fold_hi(c3))}};
}

// x * y: 16 products and 3 by W_M, 7 reductions. The result's form is
// the product of the operands' (Montgomery times Montgomery is
// Montgomery, times canonical canonical).
__device__ __forceinline__ Ext ext_mmul(const Ext& x, const Ext& y) {
  uint32_t wy[3] = {mmul(y.c[1], W_M), mmul(y.c[2], W_M),
                    mmul(y.c[3], W_M)};
  return ext_mmul_w(x, y, wy);
}

// acc += x * w for a constant w given as 8 words (w0..w3, W w1, W w2,
// W w3, pad), into four 64-bit sums kept below p * 2^32.
__device__ __forceinline__ void ext_mac_w(uint64_t acc[4], const Ext& x,
                                          const uint32_t* w) {
  const uint32_t* a = x.c;
  const uint32_t* wy = w + 4;
  acc[0] = fold_hi(fold_hi(acc[0] + wide(a[0], w[0]) + wide(a[1], wy[2])) +
                   wide(a[2], wy[1]) + wide(a[3], wy[0]));
  acc[1] = fold_hi(fold_hi(acc[1] + wide(a[0], w[1]) + wide(a[1], w[0])) +
                   wide(a[2], wy[2]) + wide(a[3], wy[1]));
  acc[2] = fold_hi(fold_hi(acc[2] + wide(a[0], w[2]) + wide(a[1], w[1])) +
                   wide(a[2], w[0]) + wide(a[3], wy[2]));
  acc[3] = fold_hi(fold_hi(acc[3] + wide(a[0], w[3]) + wide(a[1], w[2])) +
                   wide(a[2], w[1]) + wide(a[3], w[0]));
}

// x^(p-2) in Montgomery form, 0 for 0: 30 squarings and 11 products.
// p - 2 = 0b111_0111 followed by 24 ones: x^7, then 0111, then eight
// windows of 111.
__device__ inline uint32_t minv(uint32_t x) {
  uint32_t x3 = mmul(mmul(x, x), x);
  uint32_t x7 = mmul(mmul(x3, x3), x);
  uint32_t y = x7;
#pragma unroll
  for (int i = 0; i < 4; ++i) y = mmul(y, y);
  y = mmul(y, x7);
#pragma unroll 1
  for (int w = 0; w < 8; ++w) {
    y = mmul(y, y);
    y = mmul(y, y);
    y = mmul(y, y);
    y = mmul(y, x7);
  }
  return y;
}

// The extension inverse in Montgomery form, as ext_inv: b = a^(p + p^2 +
// p^3) from three Frobenius maps (c^2 = -1 is a negation), the norm's
// coefficient 0 alone, and one base-field inverse; 0 maps to 0.
__device__ inline Ext ext_minv(const Ext& a) {
  const uint32_t* x = a.c;
  Ext f1{{x[0], mmul(x[1], FROB1_M), mneg(x[2]), mmul(x[3], FROB3_M)}};
  Ext f2{{x[0], mneg(x[1]), x[2], mneg(x[3])}};
  Ext f3{{x[0], mmul(x[1], FROB3_M), mneg(x[2]), mmul(x[3], FROB1_M)}};
  Ext b = ext_mmul(f1, ext_mmul(f2, f3));
  const uint32_t* y = b.c;
  uint32_t r = redc(fold_hi(wide(x[1], y[3]) + wide(x[2], y[2]) +
                            wide(x[3], y[1])));
  uint32_t norm = redc(wide(x[0], y[0]) + wide(r, W_M));
  return ext_mscale(b, minv(norm));
}

}  // namespace bb
