// K2: hash160 of both public-key forms, one thread per lane.
//
// Replaces vuke_tpu/cores/pallas_kernels.py::_hash160_kernel:
//   h160c = RIPEMD160(SHA256(02|03 || x))      1 SHA-256 block
//   h160u = RIPEMD160(SHA256(04 || x || y))    2 SHA-256 blocks
// with the padding of the fixed 33- and 65-byte messages written out as in
// the TPU kernel.  The parity of y is the low bit of y's last BE word.
//
// Bound: the 32-bit ALU pipe (rotates as funnel shifts and logic; the adds
// can go to either pipe): 3 SHA-256 and 2 RIPEMD-160 compressions per lane
// against 64 bytes read and 56 written, counted operation by operation in
// vuke_tpu_torch/kernels/work.py.  Every loop is fully unrolled so the
// message schedule, the state and the table lookups (constant arrays indexed
// by compile-time round numbers) stay in registers; loads and stores are
// coalesced (thread i <-> lane i).
//
// Output: (5, N) little-endian digest words for each form and, from the
// epilogue, the match fragments: (4, N) words c_hi, c_lo, u_hi, u_lo, the
// first 8 bytes of each digest read big-endian (byteswaps of digest words 0
// and 1, vuke_tpu/ecc/tiled.py:443-446), so the match needs no pass over
// the digests.  16 bytes a lane, beside the 40 of the digests.

#include <cuda_runtime.h>
#include <cstdint>

#include "secp256k1.cuh"

namespace {

__device__ __forceinline__ uint32_t rotr(uint32_t x, int k) { return __funnelshift_r(x, x, k); }
__device__ __forceinline__ uint32_t rotl(uint32_t x, int k) { return __funnelshift_l(x, x, k); }
__device__ __forceinline__ uint32_t bswap(uint32_t x) { return __byte_perm(x, 0, 0x0123); }

// One SHA-256 compression of block w[16] into s[8].
__device__ __forceinline__ void sha256_compress(uint32_t s[8], uint32_t w[16]) {
    constexpr uint32_t K[64] = {
        0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
        0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
        0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
        0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
        0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
        0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
        0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
        0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
        0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
        0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
        0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2};
    uint32_t a = s[0], b = s[1], c = s[2], d = s[3];
    uint32_t e = s[4], f = s[5], g = s[6], h = s[7];
#pragma unroll
    for (int t = 0; t < 64; t++) {
        uint32_t wt;
        if (t < 16) {
            wt = w[t];
        } else {
            uint32_t w15 = w[(t - 15) & 15], w2 = w[(t - 2) & 15];
            uint32_t s0 = rotr(w15, 7) ^ rotr(w15, 18) ^ (w15 >> 3);
            uint32_t s1 = rotr(w2, 17) ^ rotr(w2, 19) ^ (w2 >> 10);
            wt = w[t & 15] = w[(t - 16) & 15] + s0 + w[(t - 7) & 15] + s1;
        }
        uint32_t t1 = h + (rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25)) + ((e & f) ^ (~e & g)) +
                      K[t] + wt;
        uint32_t t2 = (rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22)) + ((a & b) ^ (a & c) ^ (b & c));
        h = g; g = f; f = e; e = d + t1;
        d = c; c = b; b = a; a = t1 + t2;
    }
    s[0] += a; s[1] += b; s[2] += c; s[3] += d;
    s[4] += e; s[5] += f; s[6] += g; s[7] += h;
}

__device__ __forceinline__ uint32_t rmd_f(int j, uint32_t x, uint32_t y, uint32_t z) {
    if (j < 16) return x ^ y ^ z;
    if (j < 32) return (x & y) | (~x & z);
    if (j < 48) return (x | ~y) ^ z;
    if (j < 64) return (x & z) | (y & ~z);
    return x ^ (y | ~z);
}

// RIPEMD-160 of a 32-byte SHA-256 digest (8 BE state words) -> 5 LE words.
__device__ __forceinline__ void ripemd160_of_digest(const uint32_t dg[8], uint32_t out[5]) {
    constexpr int RL[80] = {
        0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
        7, 4, 13, 1, 10, 6, 15, 3, 12, 0, 9, 5, 2, 14, 11, 8,
        3, 10, 14, 4, 9, 15, 8, 1, 2, 7, 0, 6, 13, 11, 5, 12,
        1, 9, 11, 10, 0, 8, 12, 4, 13, 3, 7, 15, 14, 5, 6, 2,
        4, 0, 5, 9, 7, 12, 2, 10, 14, 1, 3, 8, 11, 6, 15, 13};
    constexpr int RR[80] = {
        5, 14, 7, 0, 9, 2, 11, 4, 13, 6, 15, 8, 1, 10, 3, 12,
        6, 11, 3, 7, 0, 13, 5, 10, 14, 15, 8, 12, 4, 9, 1, 2,
        15, 5, 1, 3, 7, 14, 6, 9, 11, 8, 12, 2, 10, 0, 4, 13,
        8, 6, 4, 1, 3, 11, 15, 0, 5, 12, 2, 13, 9, 7, 10, 14,
        12, 15, 10, 4, 1, 5, 8, 7, 6, 2, 13, 14, 0, 3, 9, 11};
    constexpr int SL[80] = {
        11, 14, 15, 12, 5, 8, 7, 9, 11, 13, 14, 15, 6, 7, 9, 8,
        7, 6, 8, 13, 11, 9, 7, 15, 7, 12, 15, 9, 11, 7, 13, 12,
        11, 13, 6, 7, 14, 9, 13, 15, 14, 8, 13, 6, 5, 12, 7, 5,
        11, 12, 14, 15, 14, 15, 9, 8, 9, 14, 5, 6, 8, 6, 5, 12,
        9, 15, 5, 11, 6, 8, 13, 12, 5, 12, 13, 14, 11, 8, 5, 6};
    constexpr int SR[80] = {
        8, 9, 9, 11, 13, 15, 15, 5, 7, 7, 8, 11, 14, 14, 12, 6,
        9, 13, 15, 7, 12, 8, 9, 11, 7, 7, 12, 7, 6, 15, 13, 11,
        9, 7, 15, 11, 8, 6, 6, 14, 12, 13, 5, 14, 13, 13, 7, 5,
        15, 5, 8, 11, 14, 14, 6, 14, 6, 9, 12, 9, 12, 5, 15, 8,
        8, 5, 12, 9, 12, 5, 14, 6, 8, 13, 6, 5, 15, 13, 11, 11};
    constexpr uint32_t KL[5] = {0x00000000, 0x5A827999, 0x6ED9EBA1, 0x8F1BBCDC, 0xA953FD4E};
    constexpr uint32_t KR[5] = {0x50A28BE6, 0x5C4DD124, 0x6D703EF3, 0x7A6D76E9, 0x00000000};
    constexpr uint32_t IV[5] = {0x67452301, 0xEFCDAB89, 0x98BADCFE, 0x10325476, 0xC3D2E1F0};

    uint32_t m[16];
#pragma unroll
    for (int i = 0; i < 8; i++) m[i] = bswap(dg[i]);   // LE message words
    m[8] = 0x80;
    m[9] = m[10] = m[11] = m[12] = m[13] = 0;
    m[14] = 256;                                       // bit length
    m[15] = 0;

    uint32_t al = IV[0], bl = IV[1], cl = IV[2], dl = IV[3], el = IV[4];
    uint32_t ar = IV[0], br = IV[1], cr = IV[2], dr = IV[3], er = IV[4];
#pragma unroll
    for (int j = 0; j < 80; j++) {
        const int r = j / 16;
        uint32_t t = rotl(al + rmd_f(j, bl, cl, dl) + m[RL[j]] + KL[r], SL[j]) + el;
        al = el; el = dl; dl = rotl(cl, 10); cl = bl; bl = t;
        t = rotl(ar + rmd_f(79 - j, br, cr, dr) + m[RR[j]] + KR[r], SR[j]) + er;
        ar = er; er = dr; dr = rotl(cr, 10); cr = br; br = t;
    }
    out[0] = IV[1] + cl + dr;
    out[1] = IV[2] + dl + er;
    out[2] = IV[3] + el + ar;
    out[3] = IV[4] + al + br;
    out[4] = IV[0] + bl + cr;
}

__device__ __forceinline__ void sha256_iv(uint32_t s[8]) {
    s[0] = 0x6a09e667; s[1] = 0xbb67ae85; s[2] = 0x3c6ef372; s[3] = 0xa54ff53a;
    s[4] = 0x510e527f; s[5] = 0x9b05688c; s[6] = 0x1f83d9ab; s[7] = 0x5be0cd19;
}

__global__ void __launch_bounds__(128)
hash160_kernel(const uint32_t* __restrict__ xw, const uint32_t* __restrict__ yw,
               uint32_t* __restrict__ hc, uint32_t* __restrict__ hu,
               uint32_t* __restrict__ frag, long long n) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    uint32_t x[8], y[8], w[16], s[8], h[5];
#pragma unroll
    for (int j = 0; j < 8; j++) {
        x[j] = xw[j * n + i];
        y[j] = yw[j * n + i];
    }

    // compressed: 33 bytes = (02 | parity) || x, one block
    w[0] = ((0x02u + (y[7] & 1u)) << 24) | (x[0] >> 8);
#pragma unroll
    for (int j = 1; j < 8; j++) w[j] = (x[j - 1] << 24) | (x[j] >> 8);
    w[8] = (x[7] << 24) | 0x800000u;
#pragma unroll
    for (int j = 9; j < 15; j++) w[j] = 0;
    w[15] = 33 * 8;
    sha256_iv(s);
    sha256_compress(s, w);
    ripemd160_of_digest(s, h);
#pragma unroll
    for (int j = 0; j < 5; j++) hc[j * n + i] = h[j];
    frag[i] = bswap(h[0]);
    frag[n + i] = bswap(h[1]);

    // uncompressed: 65 bytes = 04 || x || y, two blocks
    w[0] = (0x04u << 24) | (x[0] >> 8);
#pragma unroll
    for (int j = 1; j < 8; j++) w[j] = (x[j - 1] << 24) | (x[j] >> 8);
    w[8] = (x[7] << 24) | (y[0] >> 8);
#pragma unroll
    for (int j = 9; j < 16; j++) w[j] = (y[j - 9] << 24) | (y[j - 8] >> 8);
    sha256_iv(s);
    sha256_compress(s, w);
    w[0] = (y[7] << 24) | 0x800000u;
#pragma unroll
    for (int j = 1; j < 15; j++) w[j] = 0;
    w[15] = 65 * 8;
    sha256_compress(s, w);
    ripemd160_of_digest(s, h);
#pragma unroll
    for (int j = 0; j < 5; j++) hu[j * n + i] = h[j];
    frag[2 * n + i] = bswap(h[0]);
    frag[3 * n + i] = bswap(h[1]);
}

}  // namespace

// frag: (4, n) fragment words.
extern "C" int vk_hash160(const uint32_t* xw, const uint32_t* yw, uint32_t* hc,
                          uint32_t* hu, uint32_t* frag, long long n, void* stream) {
    const int threads = 128;
    const long long blocks = (n + threads - 1) / threads;
    hash160_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(xw, yw, hc, hu,
                                                                           frag, n);
    return VK_LAUNCH_STATUS();
}
