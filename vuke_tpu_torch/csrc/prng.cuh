// Device code of the PRNG keystreams, shared by K1 (mt19937.cu), the PRNG
// keygen (keygen_prng.cu) and the sweep kernel S1 (sweep_prng.cu).
//
// Keys are 8 big-endian u32 words.  MT19937 and MT19937-64 keys are read
// off the init recurrence: key j of the stream needs only the state words
// its outputs tap, so a caller that wants key j computes it from the seed
// (`base` = its first output); with `base` 0 the loops are those K1 and the
// keygen always ran.  The LCGs give one key; the xorshift generators stream
// key after key from a state kept in registers.  Every u64 is native: the
// reference carries them as uint32 pairs.
#pragma once

#include <cuda_runtime.h>
#include <cstdint>

namespace vk {
namespace prng {

__device__ __forceinline__ uint32_t bswap32(uint32_t x) { return __byte_perm(x, 0, 0x0123); }

// MT19937 (init_genrand): the key of outputs base..base+7, each tempered
// output byteswapped into a BE word (the key bytes are the outputs
// serialized little-endian).  Output k twists state words k, k + 1 and
// k + 397, so the recurrence runs to base + 404 and keeps 17 taps;
// base + 7 <= 226 keeps every tap inside the 624-word init block.
__device__ __forceinline__ void mt19937_key(uint32_t seed, uint32_t base, uint32_t key[8]) {
    constexpr uint32_t kF = 1812433253u;
    constexpr uint32_t kMatrixA = 0x9908B0DFu;
    constexpr uint32_t kUpper = 0x80000000u;
    constexpr uint32_t kLower = 0x7FFFFFFFu;
    uint32_t lo[9], hi[8];
    uint32_t s = seed;
    for (uint32_t k = 1; k <= base; k++) s = kF * (s ^ (s >> 30)) + k;
    lo[0] = s;
#pragma unroll
    for (uint32_t k = 1; k <= 8; k++) {
        s = kF * (s ^ (s >> 30)) + (base + k);
        lo[k] = s;
    }
#pragma unroll 4
    for (uint32_t k = 9; k < 397; k++) s = kF * (s ^ (s >> 30)) + (base + k);
#pragma unroll
    for (uint32_t k = 397; k < 405; k++) {
        s = kF * (s ^ (s >> 30)) + (base + k);
        hi[k - 397] = s;
    }
#pragma unroll
    for (int k = 0; k < 8; k++) {
        uint32_t y = (lo[k] & kUpper) | (lo[k + 1] & kLower);
        uint32_t x = hi[k] ^ (y >> 1) ^ ((y & 1u) ? kMatrixA : 0u);
        x ^= x >> 11;
        x ^= (x << 7) & 0x9D2C5680u;
        x ^= (x << 15) & 0xEFC60000u;
        x ^= x >> 18;
        key[k] = bswap32(x);
    }
}

// MT19937-64 seeded with the u64 seed: the key of outputs base..base+3,
// each serialized little-endian (words bswap(lo), bswap(hi)).  Output k
// twists state words k, k + 1 and k + 156; base + 3 <= 155.
__device__ __forceinline__ void mt64_key(uint64_t seed, uint32_t base, uint32_t key[8]) {
    constexpr uint64_t kF = 6364136223846793005ull;
    constexpr uint64_t kA = 0xB5026F5AA96619E9ull;
    constexpr uint64_t kUpper = 0xFFFFFFFF80000000ull, kLower = 0x7FFFFFFFull;
    uint64_t s = seed;
    for (uint32_t k = 1; k <= base; k++) s = kF * (s ^ (s >> 62)) + k;
    uint64_t head[5], tail[4];                    // state words base..base+4, base+156..159
    head[0] = s;
#pragma unroll
    for (int k = 1; k < 5; k++) {
        s = kF * (s ^ (s >> 62)) + (uint64_t)(base + k);
        head[k] = s;
    }
#pragma unroll 4
    for (int k = 5; k < 156; k++) s = kF * (s ^ (s >> 62)) + (uint64_t)(base + k);
#pragma unroll
    for (int k = 156; k < 160; k++) {
        s = kF * (s ^ (s >> 62)) + (uint64_t)(base + k);
        tail[k - 156] = s;
    }
#pragma unroll
    for (int j = 0; j < 4; j++) {
        const uint64_t y = (head[j] & kUpper) | (head[j + 1] & kLower);
        uint64_t x = tail[j] ^ (y >> 1) ^ ((y & 1) ? kA : 0ull);
        x ^= (x >> 29) & 0x5555555555555555ull;
        x ^= (x << 17) & 0x71D67FFFEDA60000ull;
        x ^= (x << 37) & 0xFFF7EEE000000000ull;
        x ^= x >> 43;
        key[2 * j] = bswap32((uint32_t)x);
        key[2 * j + 1] = bswap32((uint32_t)(x >> 32));
    }
}

constexpr uint32_t kM31 = 0x7FFFFFFFu;

// glibc (m = 2^31), minstd (m = 2^31 - 1), msvc and borland (m = 2^32)
__device__ __forceinline__ uint32_t lcg_next(uint32_t s, int v) {
    switch (v) {
        case 0:
            return (s * 1103515245u + 12345u) & kM31;
        case 1: {
            const uint64_t x = (uint64_t)s * 16807u;        // below 2^47; 2^32 == 2 mod m
            uint32_t t = (uint32_t)(x >> 32) * 2u + ((uint32_t)x & kM31) + ((uint32_t)x >> 31);
            t = (t & kM31) + (t >> 31);
            t = (t & kM31) + (t >> 31);
            return t == kM31 ? 0u : t;
        }
        case 2:
            return s * 214013u + 2531011u;
        default:
            return s * 22695477u + 1u;
    }
}

// 8 outputs of LCG variant v from the raw u32 seed, byteswapped when
// little-endian.
__device__ __forceinline__ void lcg_key(uint32_t seed, int v, int big_endian, uint32_t key[8]) {
    uint32_t s = seed;
#pragma unroll
    for (int j = 0; j < 8; j++) {
        s = lcg_next(s, v);
        key[j] = big_endian ? s : bswap32(s);
    }
}

__device__ __forceinline__ uint64_t rotl64(uint64_t x, int k) { return (x << k) | (x >> (64 - k)); }

__device__ __forceinline__ uint64_t splitmix64(uint64_t x) {
    x += 0x9E3779B97F4A7C15ull;
    x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
    x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
    return x ^ (x >> 31);
}

__device__ __forceinline__ void put64(uint32_t key[8], int j, uint64_t v) {
    key[2 * j] = (uint32_t)(v >> 32);
    key[2 * j + 1] = (uint32_t)v;
}

// The xorshift family, variants 0 xorshift64 (4 outputs a key, high word
// first), 1 xorshift128 (32-bit lanes from the seed's halves; 8 outputs),
// 2 xorshift128+ and 3 xoroshiro128** (state from two splitmix64 steps; 4
// outputs).  A zero seed becomes 1.  Each next_key continues the stream.
struct Xorshift {
    int v;
    uint64_t s0, s1;
    uint32_t x, y, z, w;

    __device__ __forceinline__ void init(uint32_t hi, uint32_t lo, int variant) {
        v = variant;
        if (hi == 0 && lo == 0) lo = 1;
        const uint64_t seed = ((uint64_t)hi << 32) | lo;
        if (v == 0) {
            s0 = seed;
        } else if (v == 1) {
            x = lo; y = hi; z = lo ^ 0x12345678u; w = hi ^ 0x87654321u;
        } else {
            s0 = splitmix64(seed);
            s1 = splitmix64(s0);
        }
    }

    __device__ __forceinline__ void next_key(uint32_t key[8]) {
        if (v == 0) {
#pragma unroll
            for (int j = 0; j < 4; j++) {
                s0 ^= s0 << 13;
                s0 ^= s0 >> 7;
                s0 ^= s0 << 17;
                put64(key, j, s0);
            }
        } else if (v == 1) {
#pragma unroll
            for (int j = 0; j < 8; j++) {
                const uint32_t t = x ^ (x << 11);
                x = y; y = z; z = w;
                w = (w ^ (w >> 19)) ^ (t ^ (t >> 8));
                key[j] = w;
            }
        } else {
#pragma unroll
            for (int j = 0; j < 4; j++) {
                put64(key, j, v == 2 ? s0 + s1 : rotl64(s0 * 5, 7) * 9);
                s1 ^= s0;
                s0 = rotl64(s0, 24) ^ s1 ^ (s1 << 16);
                s1 = rotl64(s1, 37);
            }
        }
    }
};

}  // namespace prng
}  // namespace vk
