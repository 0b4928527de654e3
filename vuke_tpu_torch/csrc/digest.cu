// D1: SHA-256, SHA-256d and MD5 of M byte strings of any length, one
// thread a string, and the iterated SHA-256 chain of M 32-byte keys.
//
// Replaces no Pallas kernel: it is the card-side counterpart of
// vuke_tpu/transforms/strings.py::batched_digest (XLA: cores/sha256.py::
// sha256_blocks, cores/md5.py::md5_blocks over strings bucketed by block
// count on the host) and of the iterated chain's jax.jit(sha256_key_words)
// loop (strings.py:172-181).  The strings arrive as one packed byte buffer
// (read as LE u32 words, 8 spare bytes past the end) and M + 1 int64
// offsets; each thread pads its own message while it streams its blocks,
// so nothing is bucketed or padded on the host.  Lanes of a warp with
// different block counts diverge: right, only slower.
//
// Outputs: (M, 8) BE digest words (sha256, sha256d), (M, 4) LE words
// (md5), as batched_digest returns them; the chain writes (depth, M, 8),
// row 0 the keys themselves, row d SHA-256 of row d - 1.
//
// Bound: the ALU pipe, about 1,950 operations a SHA-256 compression and
// ~1,000 an MD5 one, a compression for every 64 bytes of a string plus its
// padding; bytes are the strings once and 16 or 32 a digest
// (vuke_tpu_torch/kernels/work.py::digest).  The message words come from
// two aligned word loads and one funnel shift each, the padding from a
// compare and a select, so the block costs little beside the rounds.

#include <cuda_runtime.h>
#include <cstdint>

#include "keygen.cuh"

namespace {

using namespace vk::kg;

enum Mode { kSha256 = 0, kSha256d = 1, kMd5 = 2, kChain = 3 };

// Bytes p .. p + 3 of the message of len bytes at byte off of the buffer,
// as a LE word (memory order), with the 0x80 terminator at byte len and
// zeros beyond it.  Only bytes below len are loaded.
__device__ __forceinline__ uint32_t message_word(const uint32_t* __restrict__ words,
                                                 long long off, uint32_t len, uint32_t p) {
    const long long k = (long long)len - (long long)p;   // message bytes from p on
    if (k <= 0) return k == 0 ? 0x80u : 0u;
    const long long a = off + p;
    const uint32_t raw = __funnelshift_r(words[a >> 2], words[(a >> 2) + 1],
                                         (uint32_t)(a & 3) * 8u);
    if (k >= 4) return raw;
    const uint32_t sh = (uint32_t)k * 8u;
    return (raw & ((1u << sh) - 1u)) | (0x80u << sh);
}

__device__ __forceinline__ void store8(uint32_t* __restrict__ out, long long row,
                                       const uint32_t v[8]) {
    uint4* o = reinterpret_cast<uint4*>(out + row * 8);
    o[0] = make_uint4(v[0], v[1], v[2], v[3]);
    o[1] = make_uint4(v[4], v[5], v[6], v[7]);
}

__global__ void __launch_bounds__(256)
digest_kernel(const uint32_t* __restrict__ words, const long long* __restrict__ offsets,
              const uint32_t* __restrict__ keys, int mode, int depth,
              uint32_t* __restrict__ out, long long m) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= m) return;
    if (mode == kChain) {
        const uint4* kin = reinterpret_cast<const uint4*>(keys + i * 8);
        const uint4 k0 = kin[0], k1 = kin[1];
        uint32_t k[8] = {k0.x, k0.y, k0.z, k0.w, k1.x, k1.y, k1.z, k1.w};
        for (int d = 0; d < depth; d++) {
            if (d) sha256_of_key(k);
            store8(out, (long long)d * m + i, k);
        }
        return;
    }
    const long long off = offsets[i];
    const uint32_t len = (uint32_t)(offsets[i + 1] - off);
    const uint32_t nb = (len + 9u + 63u) / 64u;
    const uint64_t bits = (uint64_t)len * 8u;
    uint32_t w[16];
    if (mode == kMd5) {
        uint32_t s[4] = {0x67452301u, 0xefcdab89u, 0x98badcfeu, 0x10325476u};
        for (uint32_t b = 0; b < nb; b++) {
#pragma unroll
            for (int j = 0; j < 16; j++) w[j] = message_word(words, off, len, 64u * b + 4u * j);
            if (b == nb - 1) {
                w[14] = (uint32_t)bits;
                w[15] = (uint32_t)(bits >> 32);
            }
            md5_compress(s, w);
        }
        reinterpret_cast<uint4*>(out + i * 4)[0] = make_uint4(s[0], s[1], s[2], s[3]);
        return;
    }
    uint32_t s[8];
    sha256_init(s);
    for (uint32_t b = 0; b < nb; b++) {
#pragma unroll
        for (int j = 0; j < 16; j++) w[j] = bswap(message_word(words, off, len, 64u * b + 4u * j));
        if (b == nb - 1) {
            w[14] = (uint32_t)(bits >> 32);
            w[15] = (uint32_t)bits;
        }
        sha256_compress(s, w);
    }
    if (mode == kSha256d) sha256_of_key(s);
    store8(out, i, s);
}

}  // namespace

// mode 0 sha256, 1 sha256d, 2 md5: words (the packed strings, 8 spare
// bytes past the last), offsets (m + 1), out (m, 8) or (m, 4); mode 3, the
// iterated chain: keys (m, 8), out (depth, m, 8).
extern "C" int vk_digest(const uint32_t* words, const long long* offsets, const uint32_t* keys,
                         int mode, int depth, uint32_t* out, long long m, void* stream) {
    if (mode < kSha256 || mode > kChain || (mode == kChain && depth < 1))
        return (int)cudaErrorInvalidValue;
    const int threads = 256;
    const long long blocks = (m + threads - 1) / threads;
    digest_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        words, offsets, keys, mode, depth, out, m);
    return VK_LAUNCH_STATUS();
}
