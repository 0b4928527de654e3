// secp256k1 field library shared by the port's CUDA kernels.
//
// A field element is 8 x 32-bit little-endian limbs holding any residue
// below 2^256 ("weak"): every operation returns a value < 2^256 that is
// congruent mod p = 2^256 - 2^32 - 977 to the exact result.  fe_canon
// gives the representative in [0, p).
//
// Products and sums are PTX carry chains (mad.lo.cc / madc.hi.cc / addc),
// each chain inside ONE asm statement: the compiler keeps no carry flag
// between two asm statements.  fe_mul is the 8 x 8 schoolbook product by
// rows (operand scanning): row i adds a * b_i with the even limbs of a
// into accumulator e and the odd ones into o, so each row is two
// independent carry chains of 8 multiply-adds, not one serial 64-bit
// accumulator; t = e + o at the end.  fe_sqr forms the 28 cross products
// once the same way, doubles them with one funnel-shift pass and adds the
// 8 squares: 36 products instead of 64 (vuke_tpu/ecc/pallas_smul13.py
// _sqr13_cols is the TPU kernel's counterpart).  Both fold the 512-bit t
// with 2^256 == 2^32 + 977 (mod p) in VK_PTX_REDUCE512.  Every register
// the asm text names is declared inside it; operands are copied in first
// and out last, so r may alias a or b.  tests/test_torch_field_ptx.py runs
// this PTX text under a small interpreter on the CPU.
#pragma once

#include <cstdint>

namespace vk {

struct Fe {
    uint32_t v[8];
};

__device__ __forceinline__ void fe_set_small(Fe& r, uint32_t x) {
    r.v[0] = x;
#pragma unroll
    for (int i = 1; i < 8; i++) r.v[i] = 0;
}

// r += c * (2^32 + 977) for a small c; returns the carry out of 2^256.
__device__ __forceinline__ uint32_t fe_add_c(Fe& r, uint64_t c) {
    uint64_t d = (uint64_t)r.v[0] + c * 977u;
    r.v[0] = (uint32_t)d;
    d >>= 32;
    d += (uint64_t)r.v[1] + c;
    r.v[1] = (uint32_t)d;
    d >>= 32;
#pragma unroll
    for (int i = 2; i < 8; i++) {
        d += r.v[i];
        r.v[i] = (uint32_t)d;
        d >>= 32;
    }
    return (uint32_t)d;
}

#define VK_PTX_IN_A \
    "mov.b32 a0, %8; mov.b32 a1, %9; mov.b32 a2, %10; mov.b32 a3, %11;\n\t" \
    "mov.b32 a4, %12; mov.b32 a5, %13; mov.b32 a6, %14; mov.b32 a7, %15;\n\t"
#define VK_PTX_IN_B \
    "mov.b32 b0, %16; mov.b32 b1, %17; mov.b32 b2, %18; mov.b32 b3, %19;\n\t" \
    "mov.b32 b4, %20; mov.b32 b5, %21; mov.b32 b6, %22; mov.b32 b7, %23;\n\t"
#define VK_PTX_OUT_R \
    "mov.b32 %0, r0; mov.b32 %1, r1; mov.b32 %2, r2; mov.b32 %3, r3;\n\t" \
    "mov.b32 %4, r4; mov.b32 %5, r5; mov.b32 %6, r6; mov.b32 %7, r7;\n\t"
#define VK_FE_OUT(r) "=r"(r.v[0]), "=r"(r.v[1]), "=r"(r.v[2]), "=r"(r.v[3]), \
    "=r"(r.v[4]), "=r"(r.v[5]), "=r"(r.v[6]), "=r"(r.v[7])
#define VK_FE_IN(a) "r"(a.v[0]), "r"(a.v[1]), "r"(a.v[2]), "r"(a.v[3]), \
    "r"(a.v[4]), "r"(a.v[5]), "r"(a.v[6]), "r"(a.v[7])

// t0..t15 (the 512-bit product, L = t0..t7, H = t8..t15) -> r0..r7, a weak
// residue: t = L + H * 2^256 == L + H * 977 + H * 2^32 (mod p).
#define VK_PTX_REDUCE512 \
    /* r = L + lo(H * 977), L = t0..t7, H = t8..t15 */ \
    "mad.lo.cc.u32 r0, t8, 977, t0; madc.lo.cc.u32 r1, t9, 977, t1; madc.lo.cc.u32 r2, t10, 977, t2;\n\t" \
    "madc.lo.cc.u32 r3, t11, 977, t3; madc.lo.cc.u32 r4, t12, 977, t4; madc.lo.cc.u32 r5, t13, 977, t5;\n\t" \
    "madc.lo.cc.u32 r6, t14, 977, t6; madc.lo.cc.u32 r7, t15, 977, t7; addc.u32 r8, z, z;\n\t" \
    /* h = H + hi(H * 977), to be added one limb up */ \
    "mad.hi.cc.u32 h0, t8, 977, t8; madc.hi.cc.u32 h1, t9, 977, t9; madc.hi.cc.u32 h2, t10, 977, t10;\n\t" \
    "madc.hi.cc.u32 h3, t11, 977, t11; madc.hi.cc.u32 h4, t12, 977, t12; madc.hi.cc.u32 h5, t13, 977, t13;\n\t" \
    "madc.hi.cc.u32 h6, t14, 977, t14; madc.hi.cc.u32 h7, t15, 977, t15; addc.u32 h8, z, z;\n\t" \
    /* r += h * 2^32: now r0..r7 + c * 2^256 with c = r8 + r9 * 2^32 < 2^33 */ \
    "add.cc.u32 r1, r1, h0; addc.cc.u32 r2, r2, h1; addc.cc.u32 r3, r3, h2;\n\t" \
    "addc.cc.u32 r4, r4, h3; addc.cc.u32 r5, r5, h4; addc.cc.u32 r6, r6, h5;\n\t" \
    "addc.cc.u32 r7, r7, h6; addc.cc.u32 r8, r8, h7; addc.u32 r9, h8, z;\n\t" \
    /* r += c * (2^32 + 977); d = the carry out, 0 or 1 */ \
    "mul.lo.u32 m0, r8, 977; mul.hi.u32 m1, r8, 977; mad.lo.u32 m1, r9, 977, m1;\n\t" \
    "add.cc.u32 m1, m1, r8; addc.u32 m2, r9, z; add.cc.u32 r0, r0, m0;\n\t" \
    "addc.cc.u32 r1, r1, m1; addc.cc.u32 r2, r2, m2; addc.cc.u32 r3, r3, z;\n\t" \
    "addc.cc.u32 r4, r4, z; addc.cc.u32 r5, r5, z; addc.cc.u32 r6, r6, z;\n\t" \
    "addc.cc.u32 r7, r7, z; addc.u32 d, z, z;\n\t" \
    /* r += d * (2^32 + 977): r is below 2^66 when d == 1, so no carry out */ \
    "mad.lo.cc.u32 r0, d, 977, r0; addc.cc.u32 r1, r1, d; addc.cc.u32 r2, r2, z;\n\t" \
    "addc.cc.u32 r3, r3, z; addc.cc.u32 r4, r4, z; addc.cc.u32 r5, r5, z;\n\t" \
    "addc.cc.u32 r6, r6, z; addc.u32 r7, r7, z;\n\t"

// r = a * b mod p (weak).  r may alias a or b.
__device__ __forceinline__ void fe_mul(Fe& r, const Fe& a, const Fe& b) {
    asm volatile(
        "{\n\t"
        ".reg .u32 a<8>, b<8>, e<16>, o<16>, t<16>, r<10>, h<9>, m<3>, d, z;\n\t"
        "mov.b32 z, 0;\n\t"
        VK_PTX_IN_A
        VK_PTX_IN_B
        // a * b0: even limbs of a into e, odd ones into o
        "mul.lo.u32 e0, a0, b0; mul.hi.u32 e1, a0, b0; mul.lo.u32 e2, a2, b0;\n\t"
        "mul.hi.u32 e3, a2, b0; mul.lo.u32 e4, a4, b0; mul.hi.u32 e5, a4, b0;\n\t"
        "mul.lo.u32 e6, a6, b0; mul.hi.u32 e7, a6, b0;\n\t"
        "mul.lo.u32 o1, a1, b0; mul.hi.u32 o2, a1, b0; mul.lo.u32 o3, a3, b0;\n\t"
        "mul.hi.u32 o4, a3, b0; mul.lo.u32 o5, a5, b0; mul.hi.u32 o6, a5, b0;\n\t"
        "mul.lo.u32 o7, a7, b0; mul.hi.u32 o8, a7, b0;\n\t"
        // a * b1: even limbs of a into e, odd ones into o
        "mad.lo.cc.u32 e1, a0, b1, e1; madc.hi.cc.u32 e2, a0, b1, e2; madc.lo.cc.u32 e3, a2, b1, e3;\n\t"
        "madc.hi.cc.u32 e4, a2, b1, e4; madc.lo.cc.u32 e5, a4, b1, e5; madc.hi.cc.u32 e6, a4, b1, e6;\n\t"
        "madc.lo.cc.u32 e7, a6, b1, e7; madc.hi.cc.u32 e8, a6, b1, z; addc.u32 e9, z, z;\n\t"
        "mad.lo.cc.u32 o2, a1, b1, o2; madc.hi.cc.u32 o3, a1, b1, o3; madc.lo.cc.u32 o4, a3, b1, o4;\n\t"
        "madc.hi.cc.u32 o5, a3, b1, o5; madc.lo.cc.u32 o6, a5, b1, o6; madc.hi.cc.u32 o7, a5, b1, o7;\n\t"
        "madc.lo.cc.u32 o8, a7, b1, o8; madc.hi.cc.u32 o9, a7, b1, z; addc.u32 o10, z, z;\n\t"
        // a * b2: even limbs of a into e, odd ones into o
        "mad.lo.cc.u32 e2, a0, b2, e2; madc.hi.cc.u32 e3, a0, b2, e3; madc.lo.cc.u32 e4, a2, b2, e4;\n\t"
        "madc.hi.cc.u32 e5, a2, b2, e5; madc.lo.cc.u32 e6, a4, b2, e6; madc.hi.cc.u32 e7, a4, b2, e7;\n\t"
        "madc.lo.cc.u32 e8, a6, b2, e8; madc.hi.cc.u32 e9, a6, b2, e9; addc.u32 e10, z, z;\n\t"
        "mad.lo.cc.u32 o3, a1, b2, o3; madc.hi.cc.u32 o4, a1, b2, o4; madc.lo.cc.u32 o5, a3, b2, o5;\n\t"
        "madc.hi.cc.u32 o6, a3, b2, o6; madc.lo.cc.u32 o7, a5, b2, o7; madc.hi.cc.u32 o8, a5, b2, o8;\n\t"
        "madc.lo.cc.u32 o9, a7, b2, o9; madc.hi.cc.u32 o10, a7, b2, o10; addc.u32 o11, z, z;\n\t"
        // a * b3: even limbs of a into e, odd ones into o
        "mad.lo.cc.u32 e3, a0, b3, e3; madc.hi.cc.u32 e4, a0, b3, e4; madc.lo.cc.u32 e5, a2, b3, e5;\n\t"
        "madc.hi.cc.u32 e6, a2, b3, e6; madc.lo.cc.u32 e7, a4, b3, e7; madc.hi.cc.u32 e8, a4, b3, e8;\n\t"
        "madc.lo.cc.u32 e9, a6, b3, e9; madc.hi.cc.u32 e10, a6, b3, e10; addc.u32 e11, z, z;\n\t"
        "mad.lo.cc.u32 o4, a1, b3, o4; madc.hi.cc.u32 o5, a1, b3, o5; madc.lo.cc.u32 o6, a3, b3, o6;\n\t"
        "madc.hi.cc.u32 o7, a3, b3, o7; madc.lo.cc.u32 o8, a5, b3, o8; madc.hi.cc.u32 o9, a5, b3, o9;\n\t"
        "madc.lo.cc.u32 o10, a7, b3, o10; madc.hi.cc.u32 o11, a7, b3, o11; addc.u32 o12, z, z;\n\t"
        // a * b4: even limbs of a into e, odd ones into o
        "mad.lo.cc.u32 e4, a0, b4, e4; madc.hi.cc.u32 e5, a0, b4, e5; madc.lo.cc.u32 e6, a2, b4, e6;\n\t"
        "madc.hi.cc.u32 e7, a2, b4, e7; madc.lo.cc.u32 e8, a4, b4, e8; madc.hi.cc.u32 e9, a4, b4, e9;\n\t"
        "madc.lo.cc.u32 e10, a6, b4, e10; madc.hi.cc.u32 e11, a6, b4, e11; addc.u32 e12, z, z;\n\t"
        "mad.lo.cc.u32 o5, a1, b4, o5; madc.hi.cc.u32 o6, a1, b4, o6; madc.lo.cc.u32 o7, a3, b4, o7;\n\t"
        "madc.hi.cc.u32 o8, a3, b4, o8; madc.lo.cc.u32 o9, a5, b4, o9; madc.hi.cc.u32 o10, a5, b4, o10;\n\t"
        "madc.lo.cc.u32 o11, a7, b4, o11; madc.hi.cc.u32 o12, a7, b4, o12; addc.u32 o13, z, z;\n\t"
        // a * b5: even limbs of a into e, odd ones into o
        "mad.lo.cc.u32 e5, a0, b5, e5; madc.hi.cc.u32 e6, a0, b5, e6; madc.lo.cc.u32 e7, a2, b5, e7;\n\t"
        "madc.hi.cc.u32 e8, a2, b5, e8; madc.lo.cc.u32 e9, a4, b5, e9; madc.hi.cc.u32 e10, a4, b5, e10;\n\t"
        "madc.lo.cc.u32 e11, a6, b5, e11; madc.hi.cc.u32 e12, a6, b5, e12; addc.u32 e13, z, z;\n\t"
        "mad.lo.cc.u32 o6, a1, b5, o6; madc.hi.cc.u32 o7, a1, b5, o7; madc.lo.cc.u32 o8, a3, b5, o8;\n\t"
        "madc.hi.cc.u32 o9, a3, b5, o9; madc.lo.cc.u32 o10, a5, b5, o10; madc.hi.cc.u32 o11, a5, b5, o11;\n\t"
        "madc.lo.cc.u32 o12, a7, b5, o12; madc.hi.cc.u32 o13, a7, b5, o13; addc.u32 o14, z, z;\n\t"
        // a * b6: even limbs of a into e, odd ones into o
        "mad.lo.cc.u32 e6, a0, b6, e6; madc.hi.cc.u32 e7, a0, b6, e7; madc.lo.cc.u32 e8, a2, b6, e8;\n\t"
        "madc.hi.cc.u32 e9, a2, b6, e9; madc.lo.cc.u32 e10, a4, b6, e10; madc.hi.cc.u32 e11, a4, b6, e11;\n\t"
        "madc.lo.cc.u32 e12, a6, b6, e12; madc.hi.cc.u32 e13, a6, b6, e13; addc.u32 e14, z, z;\n\t"
        "mad.lo.cc.u32 o7, a1, b6, o7; madc.hi.cc.u32 o8, a1, b6, o8; madc.lo.cc.u32 o9, a3, b6, o9;\n\t"
        "madc.hi.cc.u32 o10, a3, b6, o10; madc.lo.cc.u32 o11, a5, b6, o11; madc.hi.cc.u32 o12, a5, b6, o12;\n\t"
        "madc.lo.cc.u32 o13, a7, b6, o13; madc.hi.cc.u32 o14, a7, b6, o14; addc.u32 o15, z, z;\n\t"
        // a * b7: even limbs of a into e, odd ones into o
        "mad.lo.cc.u32 e7, a0, b7, e7; madc.hi.cc.u32 e8, a0, b7, e8; madc.lo.cc.u32 e9, a2, b7, e9;\n\t"
        "madc.hi.cc.u32 e10, a2, b7, e10; madc.lo.cc.u32 e11, a4, b7, e11; madc.hi.cc.u32 e12, a4, b7, e12;\n\t"
        "madc.lo.cc.u32 e13, a6, b7, e13; madc.hi.cc.u32 e14, a6, b7, e14; addc.u32 e15, z, z;\n\t"
        "mad.lo.cc.u32 o8, a1, b7, o8; madc.hi.cc.u32 o9, a1, b7, o9; madc.lo.cc.u32 o10, a3, b7, o10;\n\t"
        "madc.hi.cc.u32 o11, a3, b7, o11; madc.lo.cc.u32 o12, a5, b7, o12; madc.hi.cc.u32 o13, a5, b7, o13;\n\t"
        "madc.lo.cc.u32 o14, a7, b7, o14; madc.hi.cc.u32 o15, a7, b7, o15;\n\t"
        // t = e + o
        "mov.b32 t0, e0; add.cc.u32 t1, e1, o1; addc.cc.u32 t2, e2, o2;\n\t"
        "addc.cc.u32 t3, e3, o3; addc.cc.u32 t4, e4, o4; addc.cc.u32 t5, e5, o5;\n\t"
        "addc.cc.u32 t6, e6, o6; addc.cc.u32 t7, e7, o7; addc.cc.u32 t8, e8, o8;\n\t"
        "addc.cc.u32 t9, e9, o9; addc.cc.u32 t10, e10, o10; addc.cc.u32 t11, e11, o11;\n\t"
        "addc.cc.u32 t12, e12, o12; addc.cc.u32 t13, e13, o13; addc.cc.u32 t14, e14, o14;\n\t"
        "addc.u32 t15, e15, o15;\n\t"
        VK_PTX_REDUCE512
        VK_PTX_OUT_R
        "}"
        : VK_FE_OUT(r)
        : VK_FE_IN(a), VK_FE_IN(b));
}

// r = a^2 mod p (weak).  r may alias a.
__device__ __forceinline__ void fe_sqr(Fe& r, const Fe& a) {
    asm volatile(
        "{\n\t"
        ".reg .u32 a<8>, e<16>, o<16>, s<16>, u<16>, t<16>, r<10>, h<9>, m<3>, d, z;\n\t"
        "mov.b32 z, 0;\n\t"
        VK_PTX_IN_A
        // a0 * a1..a7: alternate products into e and o
        "mul.lo.u32 e1, a0, a1; mul.hi.u32 e2, a0, a1; mul.lo.u32 e3, a0, a3;\n\t"
        "mul.hi.u32 e4, a0, a3; mul.lo.u32 e5, a0, a5; mul.hi.u32 e6, a0, a5;\n\t"
        "mul.lo.u32 e7, a0, a7; mul.hi.u32 e8, a0, a7;\n\t"
        "mul.lo.u32 o2, a0, a2; mul.hi.u32 o3, a0, a2; mul.lo.u32 o4, a0, a4;\n\t"
        "mul.hi.u32 o5, a0, a4; mul.lo.u32 o6, a0, a6; mul.hi.u32 o7, a0, a6;\n\t"
        // a1 * a2..a7: alternate products into e and o
        "mad.lo.cc.u32 e3, a1, a2, e3; madc.hi.cc.u32 e4, a1, a2, e4; madc.lo.cc.u32 e5, a1, a4, e5;\n\t"
        "madc.hi.cc.u32 e6, a1, a4, e6; madc.lo.cc.u32 e7, a1, a6, e7; madc.hi.cc.u32 e8, a1, a6, e8;\n\t"
        "addc.u32 e9, z, z;\n\t"
        "mad.lo.cc.u32 o4, a1, a3, o4; madc.hi.cc.u32 o5, a1, a3, o5; madc.lo.cc.u32 o6, a1, a5, o6;\n\t"
        "madc.hi.cc.u32 o7, a1, a5, o7; madc.lo.cc.u32 o8, a1, a7, z; madc.hi.cc.u32 o9, a1, a7, z;\n\t"
        "addc.u32 o10, z, z;\n\t"
        // a2 * a3..a7: alternate products into e and o
        "mad.lo.cc.u32 e5, a2, a3, e5; madc.hi.cc.u32 e6, a2, a3, e6; madc.lo.cc.u32 e7, a2, a5, e7;\n\t"
        "madc.hi.cc.u32 e8, a2, a5, e8; madc.lo.cc.u32 e9, a2, a7, e9; madc.hi.cc.u32 e10, a2, a7, z;\n\t"
        "addc.u32 e11, z, z;\n\t"
        "mad.lo.cc.u32 o6, a2, a4, o6; madc.hi.cc.u32 o7, a2, a4, o7; madc.lo.cc.u32 o8, a2, a6, o8;\n\t"
        "madc.hi.cc.u32 o9, a2, a6, o9; addc.cc.u32 o10, o10, z; addc.u32 o11, z, z;\n\t"
        // a3 * a4..a7: alternate products into e and o
        "mad.lo.cc.u32 e7, a3, a4, e7; madc.hi.cc.u32 e8, a3, a4, e8; madc.lo.cc.u32 e9, a3, a6, e9;\n\t"
        "madc.hi.cc.u32 e10, a3, a6, e10; addc.cc.u32 e11, e11, z; addc.u32 e12, z, z;\n\t"
        "mad.lo.cc.u32 o8, a3, a5, o8; madc.hi.cc.u32 o9, a3, a5, o9; madc.lo.cc.u32 o10, a3, a7, o10;\n\t"
        "madc.hi.cc.u32 o11, a3, a7, o11; addc.u32 o12, z, z;\n\t"
        // a4 * a5..a7: alternate products into e and o
        "mad.lo.cc.u32 e9, a4, a5, e9; madc.hi.cc.u32 e10, a4, a5, e10; madc.lo.cc.u32 e11, a4, a7, e11;\n\t"
        "madc.hi.cc.u32 e12, a4, a7, e12; addc.u32 e13, z, z;\n\t"
        "mad.lo.cc.u32 o10, a4, a6, o10; madc.hi.cc.u32 o11, a4, a6, o11; addc.cc.u32 o12, o12, z;\n\t"
        "addc.u32 o13, z, z;\n\t"
        // a5 * a6..a7: alternate products into e and o
        "mad.lo.cc.u32 e11, a5, a6, e11; madc.hi.cc.u32 e12, a5, a6, e12; addc.cc.u32 e13, e13, z;\n\t"
        "addc.u32 e14, z, z;\n\t"
        "mad.lo.cc.u32 o12, a5, a7, o12; madc.hi.cc.u32 o13, a5, a7, o13; addc.u32 o14, z, z;\n\t"
        // a6 * a7..a7: alternate products into e and o
        "mad.lo.cc.u32 e13, a6, a7, e13; madc.hi.cc.u32 e14, a6, a7, e14; addc.u32 e15, z, z;\n\t"
        // s = e + o: the 28 cross products, below 2^511
        "mov.b32 s1, e1; add.cc.u32 s2, e2, o2; addc.cc.u32 s3, e3, o3;\n\t"
        "addc.cc.u32 s4, e4, o4; addc.cc.u32 s5, e5, o5; addc.cc.u32 s6, e6, o6;\n\t"
        "addc.cc.u32 s7, e7, o7; addc.cc.u32 s8, e8, o8; addc.cc.u32 s9, e9, o9;\n\t"
        "addc.cc.u32 s10, e10, o10; addc.cc.u32 s11, e11, o11; addc.cc.u32 s12, e12, o12;\n\t"
        "addc.cc.u32 s13, e13, o13; addc.cc.u32 s14, e14, o14; addc.u32 s15, e15, z;\n\t"
        // u = 2 s
        "shl.b32 u1, s1, 1; shf.l.clamp.b32 u2, s1, s2, 1; shf.l.clamp.b32 u3, s2, s3, 1;\n\t"
        "shf.l.clamp.b32 u4, s3, s4, 1; shf.l.clamp.b32 u5, s4, s5, 1; shf.l.clamp.b32 u6, s5, s6, 1;\n\t"
        "shf.l.clamp.b32 u7, s6, s7, 1; shf.l.clamp.b32 u8, s7, s8, 1; shf.l.clamp.b32 u9, s8, s9, 1;\n\t"
        "shf.l.clamp.b32 u10, s9, s10, 1; shf.l.clamp.b32 u11, s10, s11, 1; shf.l.clamp.b32 u12, s11, s12, 1;\n\t"
        "shf.l.clamp.b32 u13, s12, s13, 1; shf.l.clamp.b32 u14, s13, s14, 1; shf.l.clamp.b32 u15, s14, s15, 1;\n\t"
        // t = u + the squares a_i^2 at 2^(64 i)
        "mul.lo.u32 t0, a0, a0; mad.hi.cc.u32 t1, a0, a0, u1; madc.lo.cc.u32 t2, a1, a1, u2;\n\t"
        "madc.hi.cc.u32 t3, a1, a1, u3; madc.lo.cc.u32 t4, a2, a2, u4; madc.hi.cc.u32 t5, a2, a2, u5;\n\t"
        "madc.lo.cc.u32 t6, a3, a3, u6; madc.hi.cc.u32 t7, a3, a3, u7; madc.lo.cc.u32 t8, a4, a4, u8;\n\t"
        "madc.hi.cc.u32 t9, a4, a4, u9; madc.lo.cc.u32 t10, a5, a5, u10; madc.hi.cc.u32 t11, a5, a5, u11;\n\t"
        "madc.lo.cc.u32 t12, a6, a6, u12; madc.hi.cc.u32 t13, a6, a6, u13; madc.lo.cc.u32 t14, a7, a7, u14;\n\t"
        "madc.hi.u32 t15, a7, a7, u15;\n\t"
        VK_PTX_REDUCE512
        VK_PTX_OUT_R
        "}"
        : VK_FE_OUT(r)
        : VK_FE_IN(a));
}

// r = a + b mod p (weak): a carry c out of 2^256 adds c * (2^32 + 977),
// which can carry once more, into a value too small to carry again.
// r may alias a or b.
__device__ __forceinline__ void fe_add(Fe& r, const Fe& a, const Fe& b) {
    asm volatile(
        "{\n\t"
        ".reg .u32 a<8>, b<8>, r<8>, c, z;\n\t"
        "mov.b32 z, 0;\n\t"
        VK_PTX_IN_A
        VK_PTX_IN_B
        "add.cc.u32 r0, a0, b0; addc.cc.u32 r1, a1, b1; addc.cc.u32 r2, a2, b2;\n\t"
        "addc.cc.u32 r3, a3, b3; addc.cc.u32 r4, a4, b4; addc.cc.u32 r5, a5, b5;\n\t"
        "addc.cc.u32 r6, a6, b6; addc.cc.u32 r7, a7, b7; addc.u32 c, z, z;\n\t"
        "mad.lo.cc.u32 r0, c, 977, r0; addc.cc.u32 r1, r1, c; addc.cc.u32 r2, r2, z;\n\t"
        "addc.cc.u32 r3, r3, z; addc.cc.u32 r4, r4, z; addc.cc.u32 r5, r5, z;\n\t"
        "addc.cc.u32 r6, r6, z; addc.cc.u32 r7, r7, z; addc.u32 c, z, z;\n\t"
        "mad.lo.cc.u32 r0, c, 977, r0; addc.cc.u32 r1, r1, c; addc.cc.u32 r2, r2, z;\n\t"
        "addc.cc.u32 r3, r3, z; addc.cc.u32 r4, r4, z; addc.cc.u32 r5, r5, z;\n\t"
        "addc.cc.u32 r6, r6, z; addc.u32 r7, r7, z;\n\t"
        VK_PTX_OUT_R
        "}"
        : VK_FE_OUT(r)
        : VK_FE_IN(a), VK_FE_IN(b));
}

// r = a - b mod p (weak).  A borrow out of 2^256 added 2^256 == 2^32 + 977,
// which is taken back (c is 0 or all ones: a mask); that can borrow once
// more, and the second take-back cannot.  r may alias a or b.
__device__ __forceinline__ void fe_sub(Fe& r, const Fe& a, const Fe& b) {
    asm volatile(
        "{\n\t"
        ".reg .u32 a<8>, b<8>, r<8>, c, m, n, z;\n\t"
        "mov.b32 z, 0;\n\t"
        VK_PTX_IN_A
        VK_PTX_IN_B
        "sub.cc.u32 r0, a0, b0; subc.cc.u32 r1, a1, b1; subc.cc.u32 r2, a2, b2;\n\t"
        "subc.cc.u32 r3, a3, b3; subc.cc.u32 r4, a4, b4; subc.cc.u32 r5, a5, b5;\n\t"
        "subc.cc.u32 r6, a6, b6; subc.cc.u32 r7, a7, b7; subc.u32 c, z, z;\n\t"
        "and.b32 m, c, 977; and.b32 n, c, 1;\n\t"
        "sub.cc.u32 r0, r0, m; subc.cc.u32 r1, r1, n; subc.cc.u32 r2, r2, z;\n\t"
        "subc.cc.u32 r3, r3, z; subc.cc.u32 r4, r4, z; subc.cc.u32 r5, r5, z;\n\t"
        "subc.cc.u32 r6, r6, z; subc.cc.u32 r7, r7, z; subc.u32 c, z, z;\n\t"
        "and.b32 m, c, 977; and.b32 n, c, 1;\n\t"
        "sub.cc.u32 r0, r0, m; subc.cc.u32 r1, r1, n; subc.cc.u32 r2, r2, z;\n\t"
        "subc.cc.u32 r3, r3, z; subc.cc.u32 r4, r4, z; subc.cc.u32 r5, r5, z;\n\t"
        "subc.cc.u32 r6, r6, z; subc.u32 r7, r7, z;\n\t"
        VK_PTX_OUT_R
        "}"
        : VK_FE_OUT(r)
        : VK_FE_IN(a), VK_FE_IN(b));
}

__device__ __forceinline__ void fe_neg(Fe& r, const Fe& a) {
    Fe z;
    fe_set_small(z, 0);
    fe_sub(r, z, a);
}

// In place: the canonical representative in [0, p).  A weak value is below
// 2^256 < 2p, so one conditional subtract of p suffices.
__device__ __forceinline__ void fe_canon(Fe& r) {
    uint32_t top = 0xFFFFFFFFu;
#pragma unroll
    for (int i = 2; i < 8; i++) top &= r.v[i];
    bool ge = top == 0xFFFFFFFFu &&
              (r.v[1] > 0xFFFFFFFEu || (r.v[1] == 0xFFFFFFFEu && r.v[0] >= 0xFFFFFC2Fu));
    if (ge) fe_add_c(r, 1);          // r - p == r + 2^32 + 977 - 2^256
}

__device__ __forceinline__ void fe_sqr_n(Fe& r, const Fe& a, int k) {
    r = a;
#pragma unroll 1
    for (int i = 0; i < k; i++) fe_sqr(r, r);
}

// r = a^(p-2), the addition chain of vuke_tpu.ecc.tiled._fe_inv_rows:
// 255 squarings and 15 products.  A call, not inlined: K4 measured 2-3%
// faster so (PERF.md).
static __device__ __noinline__ void fe_inv(Fe& r, const Fe& a) {
    Fe x2, x3, x6, x9, x11, x22, x44, x88, x176, x220, x223, t;
    fe_sqr_n(t, a, 1);     fe_mul(x2, t, a);
    fe_sqr_n(t, x2, 1);    fe_mul(x3, t, a);
    fe_sqr_n(t, x3, 3);    fe_mul(x6, t, x3);
    fe_sqr_n(t, x6, 3);    fe_mul(x9, t, x3);
    fe_sqr_n(t, x9, 2);    fe_mul(x11, t, x2);
    fe_sqr_n(t, x11, 11);  fe_mul(x22, t, x11);
    fe_sqr_n(t, x22, 22);  fe_mul(x44, t, x22);
    fe_sqr_n(t, x44, 44);  fe_mul(x88, t, x44);
    fe_sqr_n(t, x88, 88);  fe_mul(x176, t, x88);
    fe_sqr_n(t, x176, 44); fe_mul(x220, t, x44);
    fe_sqr_n(t, x220, 3);  fe_mul(x223, t, x3);
    fe_sqr_n(t, x223, 23); fe_mul(t, t, x22);
    fe_sqr_n(t, t, 5);     fe_mul(t, t, a);
    fe_sqr_n(t, t, 3);     fe_mul(t, t, x2);
    fe_sqr_n(t, t, 2);     fe_mul(r, t, a);
}

// (X, Y, ZZ = Z^2, ZZZ = Z^3) += affine (x2, y2), in place: 8M + 2S, the
// formulas of vuke_tpu/ecc/pallas_smul13.py::_madd13.  The caller
// guarantees the points are neither equal nor opposite.  Ordered for
// registers: x2 dies in the first product, HH after its three uses, and
// y2 is fetched (load_y2(Fe&)) only after them, so at most seven field
// elements are live at once.
template <class LoadY>
__device__ __forceinline__ void madd(Fe& X, Fe& Y, Fe& ZZ, Fe& ZZZ, const Fe& x2,
                                     LoadY load_y2) {
    Fe H, HH, R, T;
    fe_mul(H, x2, ZZ);
    fe_sub(H, H, X);                 // H = x2*ZZ - X
    fe_sqr(HH, H);
    fe_mul(X, X, HH);                // X := V = X*HH
    fe_mul(ZZ, ZZ, HH);              // ZZ3 = ZZ*HH
    fe_mul(H, H, HH);                // H := HHH = H*HH
    load_y2(R);
    fe_mul(R, R, ZZZ);
    fe_sub(R, R, Y);                 // R = y2*ZZZ - Y
    fe_mul(ZZZ, ZZZ, H);             // ZZZ3 = ZZZ*HHH
    fe_mul(Y, Y, H);                 // Y := Y*HHH
    fe_sqr(T, R);
    fe_sub(T, T, H);
    fe_sub(T, T, X);
    fe_sub(T, T, X);                 // X3 = R^2 - HHH - 2V
    fe_sub(X, X, T);
    fe_mul(X, R, X);                 // R*(V - X3)
    fe_sub(Y, X, Y);                 // Y3 = R*(V - X3) - Y*HHH
    X = T;
}

__device__ __forceinline__ void madd(Fe& X, Fe& Y, Fe& ZZ, Fe& ZZZ, const Fe& x2,
                                     const Fe& y2) {
    madd(X, Y, ZZ, ZZZ, x2, [&](Fe& y) { y = y2; });
}

// One 64-byte table row of an affine point, x then y as 8 LE limbs each:
// four 16-byte read-only loads (the scalar multiplications' window tables).
__device__ __forceinline__ void load_xy(const uint4* __restrict__ row, Fe& x, Fe& y) {
    uint4 q0 = __ldg(row), q1 = __ldg(row + 1), q2 = __ldg(row + 2), q3 = __ldg(row + 3);
    x.v[0] = q0.x; x.v[1] = q0.y; x.v[2] = q0.z; x.v[3] = q0.w;
    x.v[4] = q1.x; x.v[5] = q1.y; x.v[6] = q1.z; x.v[7] = q1.w;
    y.v[0] = q2.x; y.v[1] = q2.y; y.v[2] = q2.z; y.v[3] = q2.w;
    y.v[4] = q3.x; y.v[5] = q3.y; y.v[6] = q3.z; y.v[7] = q3.w;
}

// Word-major (8, n) tensors: limb / word j of lane i at p[j * n + i].
__device__ __forceinline__ void fe_load_le(Fe& r, const uint32_t* __restrict__ p,
                                           long long n, long long i) {
#pragma unroll
    for (int j = 0; j < 8; j++) r.v[j] = p[j * n + i];
}

__device__ __forceinline__ void fe_store_le(uint32_t* __restrict__ p, long long n,
                                            long long i, const Fe& a) {
#pragma unroll
    for (int j = 0; j < 8; j++) p[j * n + i] = a.v[j];
}

// Big-endian words: word j holds limb 7 - j.
__device__ __forceinline__ void fe_store_be(uint32_t* __restrict__ p, long long n,
                                            long long i, const Fe& a) {
#pragma unroll
    for (int j = 0; j < 8; j++) p[j * n + i] = a.v[7 - j];
}

}  // namespace vk

#define VK_LAUNCH_STATUS() ((int)cudaGetLastError())
