// secp256k1 field library shared by the port's CUDA kernels.
//
// A field element is 8 x 32-bit little-endian limbs holding any residue
// below 2^256 ("weak"): every operation returns a value < 2^256 that is
// congruent mod p = 2^256 - 2^32 - 977 to the exact result.  Products use
// 32 x 32 -> 64-bit multiplies (IMAD.WIDE); the fold uses
// 2^256 == 2^32 + 977 (mod p).  fe_canon gives the representative in
// [0, p).  Started from native/vuke_ecc.cpp's Fe / fe_mul / madd, without
// its unsigned __int128 (not available in device code).
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

// r -= c * (2^32 + 977) for c in {0, 1}; returns the borrow out of 2^256.
__device__ __forceinline__ uint32_t fe_sub_c(Fe& r, uint32_t c) {
    uint64_t t = (uint64_t)r.v[0] - (uint64_t)(c * 977u);
    r.v[0] = (uint32_t)t;
    uint32_t br = (uint32_t)(t >> 63);
    t = (uint64_t)r.v[1] - c - br;
    r.v[1] = (uint32_t)t;
    br = (uint32_t)(t >> 63);
#pragma unroll
    for (int i = 2; i < 8; i++) {
        t = (uint64_t)r.v[i] - br;
        r.v[i] = (uint32_t)t;
        br = (uint32_t)(t >> 63);
    }
    return br;
}

// 512-bit t (16 LE limbs) -> weak residue mod p.
__device__ __forceinline__ void fe_reduce512(Fe& r, const uint32_t t[16]) {
    // t = L + H * 2^256 == L + H * 977 + H * 2^32
    uint64_t c = 0;
#pragma unroll
    for (int i = 0; i < 8; i++) {
        c += (uint64_t)t[i] + (uint64_t)t[8 + i] * 977u;
        if (i > 0) c += t[7 + i];
        r.v[i] = (uint32_t)c;
        c >>= 32;
    }
    c += t[15];                      // < 2^33: the overflow at 2^256
    uint32_t d = fe_add_c(r, c);     // d in {0, 1}
    fe_add_c(r, d);                  // r is tiny when d == 1: no carry out
}

// r = a * b mod p (weak).  r may alias a or b.
__device__ __forceinline__ void fe_mul(Fe& r, const Fe& a, const Fe& b) {
    uint32_t t[16];
#pragma unroll
    for (int i = 0; i < 16; i++) t[i] = 0;
#pragma unroll
    for (int i = 0; i < 8; i++) {
        uint64_t c = 0;
#pragma unroll
        for (int j = 0; j < 8; j++) {
            c += (uint64_t)a.v[i] * b.v[j] + t[i + j];   // <= 2^64 - 1
            t[i + j] = (uint32_t)c;
            c >>= 32;
        }
        t[i + 8] = (uint32_t)c;
    }
    fe_reduce512(r, t);
}

__device__ __forceinline__ void fe_sqr(Fe& r, const Fe& a) { fe_mul(r, a, a); }

// r = a + b mod p (weak).  r may alias a or b.
__device__ __forceinline__ void fe_add(Fe& r, const Fe& a, const Fe& b) {
    uint64_t c = 0;
#pragma unroll
    for (int i = 0; i < 8; i++) {
        c += (uint64_t)a.v[i] + b.v[i];
        r.v[i] = (uint32_t)c;
        c >>= 32;
    }
    uint32_t d = fe_add_c(r, c);
    fe_add_c(r, d);
}

// r = a - b mod p (weak).  A borrow out of 2^256 added 2^256 == 2^32 + 977,
// which is taken back; that can borrow once more.  r may alias a or b.
__device__ __forceinline__ void fe_sub(Fe& r, const Fe& a, const Fe& b) {
    uint32_t br = 0;
#pragma unroll
    for (int i = 0; i < 8; i++) {
        uint64_t t = (uint64_t)a.v[i] - b.v[i] - br;
        r.v[i] = (uint32_t)t;
        br = (uint32_t)(t >> 63);
    }
    uint32_t br2 = fe_sub_c(r, br);
    fe_sub_c(r, br2);
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

// r = a^(p-2), the addition chain of vuke_tpu.ecc.tiled._fe_inv_rows.
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
// guarantees the points are neither equal nor opposite.
__device__ __forceinline__ void madd(Fe& X, Fe& Y, Fe& ZZ, Fe& ZZZ,
                                     const Fe& x2, const Fe& y2) {
    Fe H, R, HH, HHH, V, X3;
    fe_mul(H, x2, ZZ);
    fe_sub(H, H, X);                 // H = x2*ZZ - X
    fe_mul(R, y2, ZZZ);
    fe_sub(R, R, Y);                 // R = y2*ZZZ - Y
    fe_sqr(HH, H);
    fe_mul(HHH, H, HH);
    fe_mul(V, X, HH);
    fe_sqr(X3, R);
    fe_sub(X3, X3, HHH);
    fe_sub(X3, X3, V);
    fe_sub(X3, X3, V);               // X3 = R^2 - HHH - 2V
    fe_sub(V, V, X3);
    fe_mul(V, R, V);                 // R * (V - X3)
    fe_mul(R, Y, HHH);
    fe_sub(Y, V, R);                 // Y3 = R*(V - X3) - Y*HHH
    X = X3;
    fe_mul(ZZ, ZZ, HH);
    fe_mul(ZZZ, ZZZ, HHH);
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
