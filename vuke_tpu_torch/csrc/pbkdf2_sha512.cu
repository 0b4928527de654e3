// W1: PBKDF2-HMAC-SHA512 with dkLen 64 (the BIP39 stretch), one thread a
// candidate.
//
// Replaces vuke_tpu/wallets/pbkdf2_device.py::_pbkdf2_program (:65, XLA),
// a fori_loop of 2 x (iterations - 1) SHA-512 compressions over uint32
// pairs.  Per lane: the inner and outer HMAC states, each one compression
// of the key block XOR ipad / opad; U_1 = HMAC(salt || INT(1)), the salt's
// block a kernel parameter (it is the same for every lane); then
// U_c = HMAC(U_{c-1}) and T ^= U_c, two compressions an iteration from the
// two saved states.  The message of every later compression is the 64-byte
// U (or inner digest) padded to one block: its words 8..15 are the
// constants 0x80..., zeros and the bit length 1536, which fold into the
// schedule (the loops are unrolled, so every index is static).
//
// Bound: operations.  A lane reads 128 bytes and writes 64, and runs
// 4 + 2 (iterations - 1) compressions: 4,098 for BIP39.  Hopper has no
// 64-bit integer ALU: each 64-bit add is an add and an add with carry, each
// rotate two funnel shifts, each logic op two LOP3s (kernels/work.py counts
// them).  The state (8 words), the schedule (16), the inner and outer states,
// T and U (8 each) are 56 u64 words, 112 registers; __launch_bounds__(128)
// leaves each thread up to 255, so nothing spills (phase 2 prints it).

#include <cuda_runtime.h>
#include <cstdint>

namespace {

static __constant__ uint64_t kK512[80] = {
    0x428a2f98d728ae22ull, 0x7137449123ef65cdull, 0xb5c0fbcfec4d3b2full, 0xe9b5dba58189dbbcull,
    0x3956c25bf348b538ull, 0x59f111f1b605d019ull, 0x923f82a4af194f9bull, 0xab1c5ed5da6d8118ull,
    0xd807aa98a3030242ull, 0x12835b0145706fbeull, 0x243185be4ee4b28cull, 0x550c7dc3d5ffb4e2ull,
    0x72be5d74f27b896full, 0x80deb1fe3b1696b1ull, 0x9bdc06a725c71235ull, 0xc19bf174cf692694ull,
    0xe49b69c19ef14ad2ull, 0xefbe4786384f25e3ull, 0x0fc19dc68b8cd5b5ull, 0x240ca1cc77ac9c65ull,
    0x2de92c6f592b0275ull, 0x4a7484aa6ea6e483ull, 0x5cb0a9dcbd41fbd4ull, 0x76f988da831153b5ull,
    0x983e5152ee66dfabull, 0xa831c66d2db43210ull, 0xb00327c898fb213full, 0xbf597fc7beef0ee4ull,
    0xc6e00bf33da88fc2ull, 0xd5a79147930aa725ull, 0x06ca6351e003826full, 0x142929670a0e6e70ull,
    0x27b70a8546d22ffcull, 0x2e1b21385c26c926ull, 0x4d2c6dfc5ac42aedull, 0x53380d139d95b3dfull,
    0x650a73548baf63deull, 0x766a0abb3c77b2a8ull, 0x81c2c92e47edaee6ull, 0x92722c851482353bull,
    0xa2bfe8a14cf10364ull, 0xa81a664bbc423001ull, 0xc24b8b70d0f89791ull, 0xc76c51a30654be30ull,
    0xd192e819d6ef5218ull, 0xd69906245565a910ull, 0xf40e35855771202aull, 0x106aa07032bbd1b8ull,
    0x19a4c116b8d2d0c8ull, 0x1e376c085141ab53ull, 0x2748774cdf8eeb99ull, 0x34b0bcb5e19b48a8ull,
    0x391c0cb3c5c95a63ull, 0x4ed8aa4ae3418acbull, 0x5b9cca4f7763e373ull, 0x682e6ff3d6b2b8a3ull,
    0x748f82ee5defb2fcull, 0x78a5636f43172f60ull, 0x84c87814a1f0ab72ull, 0x8cc702081a6439ecull,
    0x90befffa23631e28ull, 0xa4506cebde82bde9ull, 0xbef9a3f7b2c67915ull, 0xc67178f2e372532bull,
    0xca273eceea26619cull, 0xd186b8c721c0c207ull, 0xeada7dd6cde0eb1eull, 0xf57d4f7fee6ed178ull,
    0x06f067aa72176fbaull, 0x0a637dc5a2c898a6ull, 0x113f9804bef90daeull, 0x1b710b35131c471bull,
    0x28db77f523047d84ull, 0x32caab7b40c72493ull, 0x3c9ebe0a15c9bebcull, 0x431d67c49c100d4cull,
    0x4cc5d4becb3e42b6ull, 0x597f299cfc657e2aull, 0x5fcb6fab3ad6faecull, 0x6c44198c4a475817ull};

__device__ __forceinline__ uint64_t rotr64(uint64_t x, int n) { return (x >> n) | (x << (64 - n)); }

__device__ __forceinline__ void sha512_iv(uint64_t s[8]) {
    s[0] = 0x6a09e667f3bcc908ull; s[1] = 0xbb67ae8584caa73bull;
    s[2] = 0x3c6ef372fe94f82bull; s[3] = 0xa54ff53a5f1d36f1ull;
    s[4] = 0x510e527fade682d1ull; s[5] = 0x9b05688c2b3e6c1full;
    s[6] = 0x1f83d9abfb41bd6bull; s[7] = 0x5be0cd19137e2179ull;
}

// One SHA-512 compression of block w[16] (overwritten: the schedule) into s[8].
__device__ __forceinline__ void sha512_compress(uint64_t s[8], uint64_t w[16]) {
    uint64_t a = s[0], b = s[1], c = s[2], d = s[3];
    uint64_t e = s[4], f = s[5], g = s[6], h = s[7];
#pragma unroll
    for (int t = 0; t < 80; t++) {
        uint64_t wt;
        if (t < 16) {
            wt = w[t];
        } else {
            const uint64_t w15 = w[(t - 15) & 15], w2 = w[(t - 2) & 15];
            const uint64_t s0 = rotr64(w15, 1) ^ rotr64(w15, 8) ^ (w15 >> 7);
            const uint64_t s1 = rotr64(w2, 19) ^ rotr64(w2, 61) ^ (w2 >> 6);
            wt = w[t & 15] = w[(t - 16) & 15] + s0 + w[(t - 7) & 15] + s1;
        }
        const uint64_t t1 = h + (rotr64(e, 14) ^ rotr64(e, 18) ^ rotr64(e, 41)) +
                            ((e & f) ^ (~e & g)) + kK512[t] + wt;
        const uint64_t t2 =
            (rotr64(a, 28) ^ rotr64(a, 34) ^ rotr64(a, 39)) + ((a & b) ^ (a & c) ^ (b & c));
        h = g; g = f; f = e; e = d + t1;
        d = c; c = b; b = a; a = t1 + t2;
    }
    s[0] += a; s[1] += b; s[2] += c; s[3] += d;
    s[4] += e; s[5] += f; s[6] += g; s[7] += h;
}

// out = the compression from `from` of the 64-byte message m[8] that
// follows one 128-byte block (the HMAC iterations' second block).
__device__ __forceinline__ void hmac_step(const uint64_t from[8], const uint64_t m[8],
                                          uint64_t out[8]) {
    uint64_t w[16];
#pragma unroll
    for (int j = 0; j < 8; j++) {
        w[j] = m[j];
        out[j] = from[j];
    }
    w[8] = 0x8000000000000000ull;
#pragma unroll
    for (int j = 9; j < 15; j++) w[j] = 0;
    w[15] = (128 + 64) * 8;
    sha512_compress(out, w);
}

struct SaltBlock {
    uint32_t w[32];      // BE u32 words of salt || INT(1) || padding || bit length
};

__global__ void __launch_bounds__(128)
pbkdf2_sha512_kernel(const uint32_t* __restrict__ keys, long long n, int iterations,
                     const __grid_constant__ SaltBlock salt, uint32_t* __restrict__ out) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    uint64_t k[16];
#pragma unroll
    for (int j = 0; j < 16; j++)
        k[j] = ((uint64_t)keys[(2 * j) * n + i] << 32) | keys[(2 * j + 1) * n + i];
    uint64_t inner[8], outer[8], w[16];
    sha512_iv(inner);
#pragma unroll
    for (int j = 0; j < 16; j++) w[j] = k[j] ^ 0x3636363636363636ull;
    sha512_compress(inner, w);
    sha512_iv(outer);
#pragma unroll
    for (int j = 0; j < 16; j++) w[j] = k[j] ^ 0x5C5C5C5C5C5C5C5Cull;
    sha512_compress(outer, w);

    uint64_t d[8], u[8], t[8];
#pragma unroll
    for (int j = 0; j < 8; j++) d[j] = inner[j];
#pragma unroll
    for (int j = 0; j < 16; j++) w[j] = ((uint64_t)salt.w[2 * j] << 32) | salt.w[2 * j + 1];
    sha512_compress(d, w);
    hmac_step(outer, d, u);
#pragma unroll
    for (int j = 0; j < 8; j++) t[j] = u[j];
    for (int c = 1; c < iterations; c++) {
        hmac_step(inner, u, d);
        hmac_step(outer, d, u);
#pragma unroll
        for (int j = 0; j < 8; j++) t[j] ^= u[j];
    }
#pragma unroll
    for (int j = 0; j < 8; j++) {
        out[(2 * j) * n + i] = (uint32_t)(t[j] >> 32);
        out[(2 * j + 1) * n + i] = (uint32_t)t[j];
    }
}

}  // namespace

// keys: (32, n) device u32, each lane's HMAC key block as BE words; salt:
// a host array of the 32 words of the salt's block; out: (16, n) device
// u32, each lane's derived key as BE words.
extern "C" int vk_pbkdf2_sha512(const uint32_t* keys, long long n, int iterations,
                                const uint32_t* salt, uint32_t* out, void* stream) {
    if (n < 0 || iterations < 1) return (int)cudaErrorInvalidValue;
    if (n == 0) return 0;
    SaltBlock s;
    for (int j = 0; j < 32; j++) s.w[j] = salt[j];
    const int threads = 128;
    const long long blocks = (n + threads - 1) / threads;
    pbkdf2_sha512_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        keys, n, iterations, s, out);
    return (int)cudaGetLastError();
}
