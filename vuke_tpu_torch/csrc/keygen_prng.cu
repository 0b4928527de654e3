// The PRNG keygens of the numeric transforms, one thread per seed: the four
// LCGs (vuke_tpu/cores/lcg.py), the four xorshift generators
// (vuke_tpu/cores/xorshift.py) and MT19937-64 (vuke_tpu/cores/mt19937.py).
//
// Replaces no Pallas kernel: vuke_tpu/transforms/numeric.py::make_lcg,
// make_xorshift and _mt64 are jnp code that XLA fuses; here each transform
// is one launch that writes all of its slots.  Output: (S, 8, N) big-endian
// key words, slot s word j of lane i at out[(s * 8 + j) * N + i]; with
// variant -1 the S slots are the family's variants in the reference's order.
//   lcg: 8 outputs of next = (a * state + c) mod m from the raw u32 seed (lo),
//       each a key word, byteswapped when little-endian; minstd's product
//       mod 2^31 - 1 folds twice and keeps 0 canonical;
//   xorshift: xorshift64 (a zero seed becomes 1; 4 outputs, high word
//       first), xorshift128 (32-bit lanes from the seed's halves; 8
//       outputs), xorshift128+ and xoroshiro128** (state from two splitmix64
//       steps; 4 outputs, high word first);
//   mt64: MT19937-64 seeded with the u64 seed; its first 4 outputs
//       serialized little-endian.
// Every u64 is native: the reference carries them as uint32 pairs.
//
// Bound: the ALU and FMA pipes (MT19937-64's 159 init steps are a u64
// multiply each; the rest are a few dozen operations a slot) against the
// seed's 8 bytes read (4 for an LCG, which reads lo alone) and 32 written
// a slot (vuke_tpu_torch/kernels/work.py::keygen_prng).  MT19937-64 runs its init as a recurrence in one register
// pair and keeps the 9 state words its four outputs read (indices 0..4 and
// 156..159), not a 312-word state.  family, variant and endian are uniform
// across a launch, so no branch diverges.

#include <cuda_runtime.h>
#include <cstdint>

#include "keygen.cuh"

namespace {

using namespace vk::kg;

enum Family { kLcg = 0, kXorshift = 1, kMt64 = 2 };

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

__device__ __forceinline__ void lcg_key(uint32_t seed, int v, int big_endian, uint32_t key[8]) {
    uint32_t s = seed;
#pragma unroll
    for (int j = 0; j < 8; j++) {
        s = lcg_next(s, v);
        key[j] = big_endian ? s : bswap(s);
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

// variants: 0 xorshift64, 1 xorshift128, 2 xorshift128+, 3 xoroshiro128**
__device__ __forceinline__ void xorshift_key(uint32_t hi, uint32_t lo, int v, uint32_t key[8]) {
    if (hi == 0 && lo == 0) lo = 1;
    const uint64_t seed = ((uint64_t)hi << 32) | lo;
    if (v == 0) {
        uint64_t s = seed;
#pragma unroll
        for (int j = 0; j < 4; j++) {
            s ^= s << 13;
            s ^= s >> 7;
            s ^= s << 17;
            put64(key, j, s);
        }
    } else if (v == 1) {
        uint32_t x = lo, y = hi, z = lo ^ 0x12345678u, w = hi ^ 0x87654321u;
#pragma unroll
        for (int j = 0; j < 8; j++) {
            const uint32_t t = x ^ (x << 11);
            x = y; y = z; z = w;
            w = (w ^ (w >> 19)) ^ (t ^ (t >> 8));
            key[j] = w;
        }
    } else {
        uint64_t s0 = splitmix64(seed);
        uint64_t s1 = splitmix64(s0);
#pragma unroll
        for (int j = 0; j < 4; j++) {
            put64(key, j, v == 2 ? s0 + s1 : rotl64(s0 * 5, 7) * 9);
            s1 ^= s0;
            s0 = rotl64(s0, 24) ^ s1 ^ (s1 << 16);
            s1 = rotl64(s1, 37);
        }
    }
}

__device__ __forceinline__ void mt64_key(uint32_t hi, uint32_t lo, uint32_t key[8]) {
    constexpr uint64_t kF = 6364136223846793005ull;
    constexpr uint64_t kA = 0xB5026F5AA96619E9ull;
    constexpr uint64_t kUpper = 0xFFFFFFFF80000000ull, kLower = 0x7FFFFFFFull;
    uint64_t s = ((uint64_t)hi << 32) | lo;
    uint64_t head[5], tail[4];                    // state words 0..4 and 156..159
    head[0] = s;
#pragma unroll
    for (int k = 1; k < 5; k++) {
        s = kF * (s ^ (s >> 62)) + (uint64_t)k;
        head[k] = s;
    }
#pragma unroll 4
    for (int k = 5; k < 156; k++) s = kF * (s ^ (s >> 62)) + (uint64_t)k;
#pragma unroll
    for (int k = 156; k < 160; k++) {
        s = kF * (s ^ (s >> 62)) + (uint64_t)k;
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
        key[2 * j] = bswap((uint32_t)x);         // LE bytes of the output
        key[2 * j + 1] = bswap((uint32_t)(x >> 32));
    }
}

__global__ void __launch_bounds__(256)
keygen_prng_kernel(const uint32_t* __restrict__ hi_in, const uint32_t* __restrict__ lo_in,
                   int family, int variant, int slots, int big_endian,
                   uint32_t* __restrict__ out, long long n) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const uint32_t lo = lo_in[i];
    const uint32_t hi = family == kLcg ? 0u : hi_in[i];    // an LCG reads the low word alone
    uint32_t key[8];
    for (int s = 0; s < slots; s++) {
        const int v = variant < 0 ? s : variant;
        if (family == kLcg) {
            lcg_key(lo, v, big_endian, key);
        } else if (family == kXorshift) {
            xorshift_key(hi, lo, v, key);
        } else {
            mt64_key(hi, lo, key);
        }
        store_key(out, n, i, s, key);
    }
}

}  // namespace

// family: 0 lcg, 1 xorshift, 2 mt64; variant: the family's variant, or -1
// for each in turn over the slots; out: (slots, 8, n).
extern "C" int vk_keygen_prng(const uint32_t* hi, const uint32_t* lo, int family, int variant,
                              int slots, int big_endian, uint32_t* out, long long n,
                              void* stream) {
    if (family < kLcg || family > kMt64 || variant < -1 || variant > 3 || slots < 1)
        return (int)cudaErrorInvalidValue;
    const int threads = 256;
    const long long blocks = (n + threads - 1) / threads;
    keygen_prng_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        hi, lo, family, variant, slots, big_endian, out, n);
    return VK_LAUNCH_STATUS();
}
