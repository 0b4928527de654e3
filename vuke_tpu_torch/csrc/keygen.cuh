// Device code shared by the three keygen kernels (keygen_hash.cu,
// keygen_prng.cu, keygen_chain.cu): the decimal ASCII rendering of a u64
// seed, SHA-256 and MD5 compression, single-block messages of a per-lane
// length, and constant bytes appended at a per-lane offset.
//
// Words are big-endian message words (word w holds bytes 4w..4w+3, the
// first byte most significant), as vuke_tpu/cores/{decimal,sha256}.py keep
// them; MD5 reads the same bytes as little-endian words.  Every loop is
// fully unrolled, so the message schedule, the state and every index stay
// in registers and the round constants are constant-bank operands.
#pragma once

#include <cuda_runtime.h>
#include <cstdint>

#ifndef VK_LAUNCH_STATUS
#define VK_LAUNCH_STATUS() ((int)cudaGetLastError())
#endif

namespace vk {
namespace kg {

// static: each kernel's translation unit keeps its own copy
static __constant__ uint32_t kSha256K[64] = {
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

// floor(|sin(i + 1)| * 2^32)
static __constant__ uint32_t kMd5K[64] = {
    0xd76aa478, 0xe8c7b756, 0x242070db, 0xc1bdceee, 0xf57c0faf, 0x4787c62a,
    0xa8304613, 0xfd469501, 0x698098d8, 0x8b44f7af, 0xffff5bb1, 0x895cd7be,
    0x6b901122, 0xfd987193, 0xa679438e, 0x49b40821, 0xf61e2562, 0xc040b340,
    0x265e5a51, 0xe9b6c7aa, 0xd62f105d, 0x02441453, 0xd8a1e681, 0xe7d3fbc8,
    0x21e1cde6, 0xc33707d6, 0xf4d50d87, 0x455a14ed, 0xa9e3e905, 0xfcefa3f8,
    0x676f02d9, 0x8d2a4c8a, 0xfffa3942, 0x8771f681, 0x6d9d6122, 0xfde5380c,
    0xa4beea44, 0x4bdecfa9, 0xf6bb4b60, 0xbebfbc70, 0x289b7ec6, 0xeaa127fa,
    0xd4ef3085, 0x04881d05, 0xd9d4d039, 0xe6db99e5, 0x1fa27cf8, 0xc4ac5665,
    0xf4292244, 0x432aff97, 0xab9423a7, 0xfc93a039, 0x655b59c3, 0x8f0ccc92,
    0xffeff47d, 0x85845dd1, 0x6fa87e4f, 0xfe2ce6e0, 0xa3014314, 0x4e0811a1,
    0xf7537e82, 0xbd3af235, 0x2ad7d2bb, 0xeb86d391};

__device__ __forceinline__ uint32_t rotr(uint32_t x, int k) { return __funnelshift_r(x, x, k); }
__device__ __forceinline__ uint32_t rotl(uint32_t x, int k) { return __funnelshift_l(x, x, k); }
__device__ __forceinline__ uint32_t bswap(uint32_t x) { return __byte_perm(x, 0, 0x0123); }

// Stores the 8 key words of slot s of lane i: out is (S, 8, n).
__device__ __forceinline__ void store_key(uint32_t* out, long long n, long long i, int s,
                                          const uint32_t k[8]) {
#pragma unroll
    for (int j = 0; j < 8; j++) out[((long long)s * 8 + j) * n + i] = k[j];
}

// The decimal ASCII string of the u64 (hi:lo), no leading zeros ("0" for
// 0): out[0..4] its bytes as BE words from the first byte on, zeros beyond;
// returns its length, 1..20.  Twenty divisions by 10 (a multiply-high by
// the u64 reciprocal) put each digit at a fixed byte of a right-aligned
// 20-byte field; one shift of the field by 20 - length bytes aligns it
// left, where the reference's (vuke_tpu/cores/decimal.py) 20 x 20 selects
// per byte find each digit.
__device__ __forceinline__ uint32_t decimal_words(uint32_t hi, uint32_t lo, uint32_t out[5]) {
    uint64_t x = ((uint64_t)hi << 32) | lo;
    uint32_t r[5] = {0, 0, 0, 0, 0};
    uint32_t len = 1;
#pragma unroll
    for (int j = 0; j < 20; j++) {
        if (j > 0 && x != 0) len = j + 1;
        const uint64_t q = x / 10;
        const uint32_t d = (uint32_t)x - (uint32_t)q * 10u;
        const int pos = 19 - j;                       // byte of the right-aligned field
        r[pos >> 2] |= (0x30u + d) << (8 * (3 - (pos & 3)));
        x = q;
    }
    // the '0' bytes left of the number are shifted out
    const uint32_t s = 20 - len, q = s >> 2, sh = (s & 3) * 8;
#pragma unroll
    for (int i = 0; i < 5; i++) {
        uint32_t a = 0, b = 0;
#pragma unroll
        for (int k = 0; k < 5; k++) {
            if (i + k < 5) a = q == (uint32_t)k ? r[i + k] : a;
            if (i + k + 1 < 5) b = q == (uint32_t)k ? r[i + k + 1] : b;
        }
        out[i] = __funnelshift_l(b, a, sh);           // (a:b) << sh, high word
    }
    return len;
}

// The decimal ASCII of a small n (below 10^8) as BE words c[0..1] from the
// first byte on; returns its length in bytes.
__device__ __forceinline__ uint32_t small_decimal_words(uint32_t n, uint32_t c[2]) {
    uint32_t digits[8], len = 0;
    do {
        digits[len++] = n % 10;
        n /= 10;
    } while (n && len < 8);
    c[0] = c[1] = 0;
    for (uint32_t i = 0; i < len; i++) {
        const uint32_t byte = 0x30u + digits[len - 1 - i];
        c[i >> 2] |= byte << (8 * (3 - (i & 3)));
    }
    return len;
}

// Ors the words c[0..nc-1] (BE bytes, nc <= 2) into m[0..13] at byte
// offset len (a per-lane value): each lands across the word at len / 4 and
// the next, as vuke_tpu/transforms/numeric.py::_append_const_bytes places
// them.
__device__ __forceinline__ void append_words(uint32_t m[14], uint32_t len, const uint32_t c[2],
                                             int nc) {
    const uint32_t widx = len >> 2, sh = (len & 3) * 8;
#pragma unroll
    for (int ci = 0; ci < 2; ci++) {
        if (ci >= nc) break;
        const uint32_t hi_part = __funnelshift_r(c[ci], 0u, sh);   // c >> sh
        const uint32_t lo_part = __funnelshift_r(0u, c[ci], sh);   // c << (32 - sh), 0 at sh 0
#pragma unroll
        for (int i = 0; i < 14; i++) {
            m[i] |= (uint32_t)i == widx + ci ? hi_part : 0u;
            m[i] |= (uint32_t)i == widx + ci + 1 ? lo_part : 0u;
        }
    }
}

__device__ __forceinline__ void sha256_init(uint32_t s[8]) {
    s[0] = 0x6a09e667; s[1] = 0xbb67ae85; s[2] = 0x3c6ef372; s[3] = 0xa54ff53a;
    s[4] = 0x510e527f; s[5] = 0x9b05688c; s[6] = 0x1f83d9ab; s[7] = 0x5be0cd19;
}

// One SHA-256 compression of block w[16] (overwritten: the schedule) into s[8].
__device__ __forceinline__ void sha256_compress(uint32_t s[8], uint32_t w[16]) {
    uint32_t a = s[0], b = s[1], c = s[2], d = s[3];
    uint32_t e = s[4], f = s[5], g = s[6], h = s[7];
#pragma unroll
    for (int t = 0; t < 64; t++) {
        uint32_t wt;
        if (t < 16) {
            wt = w[t];
        } else {
            const uint32_t w15 = w[(t - 15) & 15], w2 = w[(t - 2) & 15];
            const uint32_t s0 = rotr(w15, 7) ^ rotr(w15, 18) ^ (w15 >> 3);
            const uint32_t s1 = rotr(w2, 17) ^ rotr(w2, 19) ^ (w2 >> 10);
            wt = w[t & 15] = w[(t - 16) & 15] + s0 + w[(t - 7) & 15] + s1;
        }
        const uint32_t t1 = h + (rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25)) + ((e & f) ^ (~e & g)) +
                            kSha256K[t] + wt;
        const uint32_t t2 = (rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22)) + ((a & b) ^ (a & c) ^ (b & c));
        h = g; g = f; f = e; e = d + t1;
        d = c; c = b; b = a; a = t1 + t2;
    }
    s[0] += a; s[1] += b; s[2] += c; s[3] += d;
    s[4] += e; s[5] += f; s[6] += g; s[7] += h;
}

// SHA-256 of a one-block message: m[0..13] its BE words (zeros beyond its
// len bytes, len <= 55).  With a len known at compile time the padding folds.
__device__ __forceinline__ void sha256_msg(const uint32_t m[14], uint32_t len, uint32_t out[8]) {
    uint32_t w[16];
    const uint32_t widx = len >> 2, term = 0x80u << (8 * (3 - (len & 3)));
#pragma unroll
    for (int i = 0; i < 14; i++) w[i] = m[i] | ((uint32_t)i == widx ? term : 0u);
    w[14] = 0;
    w[15] = len * 8;
    sha256_init(out);
    sha256_compress(out, w);
}

// SHA-256 of a 32-byte key given as 8 BE words, in place.
__device__ __forceinline__ void sha256_of_key(uint32_t k[8]) {
    uint32_t m[14];
#pragma unroll
    for (int i = 0; i < 14; i++) m[i] = i < 8 ? k[i] : 0u;
    sha256_msg(m, 32, k);
}

// One MD5 compression of the LE message words m[16] into s[4].
__device__ __forceinline__ void md5_compress(uint32_t s[4], const uint32_t m[16]) {
    constexpr int S[64] = {7, 12, 17, 22, 7, 12, 17, 22, 7, 12, 17, 22, 7, 12, 17, 22,
                           5, 9,  14, 20, 5, 9,  14, 20, 5, 9,  14, 20, 5, 9,  14, 20,
                           4, 11, 16, 23, 4, 11, 16, 23, 4, 11, 16, 23, 4, 11, 16, 23,
                           6, 10, 15, 21, 6, 10, 15, 21, 6, 10, 15, 21, 6, 10, 15, 21};
    uint32_t A = s[0], B = s[1], C = s[2], D = s[3];
#pragma unroll
    for (int i = 0; i < 64; i++) {
        uint32_t f;
        int g;
        if (i < 16) {
            f = (B & C) | (~B & D);
            g = i;
        } else if (i < 32) {
            f = (D & B) | (~D & C);
            g = (5 * i + 1) & 15;
        } else if (i < 48) {
            f = B ^ C ^ D;
            g = (3 * i + 5) & 15;
        } else {
            f = C ^ (B | ~D);
            g = (7 * i) & 15;
        }
        f = f + A + kMd5K[i] + m[g];
        A = D; D = C; C = B;
        B = B + rotl(f, S[i]);
    }
    s[0] += A; s[1] += B; s[2] += C; s[3] += D;
}

// MD5 of a one-block message given by the same BE words as sha256_msg:
// the 4 LE digest words (serialized LE they are the digest's bytes).
__device__ __forceinline__ void md5_msg(const uint32_t m_be[14], uint32_t len, uint32_t out[4]) {
    uint32_t m[16];
    const uint32_t widx = len >> 2, term = 0x80u << (8 * (len & 3));
#pragma unroll
    for (int i = 0; i < 14; i++) m[i] = bswap(m_be[i]) | ((uint32_t)i == widx ? term : 0u);
    m[14] = len * 8;
    m[15] = 0;
    out[0] = 0x67452301; out[1] = 0xefcdab89; out[2] = 0x98badcfe; out[3] = 0x10325476;
    md5_compress(out, m);
}

}  // namespace kg
}  // namespace vk
