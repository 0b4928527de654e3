// The seed-as-key and hash keygens of the numeric transforms, one thread per
// seed: direct, sha256, double_sha256 and md5.
//
// Replaces no Pallas kernel: vuke_tpu/transforms/numeric.py::_direct,
// _hash_three and _md5 are jnp code that XLA fuses into the JAX package's
// keygen program.  As eager torch ops they would be thousands of launches a
// superbatch (one SHA-256 compression is ~1,600), so on the card each mode
// is this one launch.  Output: (S, 8, N) big-endian key words, slot s word
// j of lane i at out[(s * 8 + j) * N + i], the slots in the reference's
// order:
//   direct (3): the seed as the key's last 8 bytes; its 8 bytes
//       little-endian as the key's first 8; its decimal string as the key's
//       first bytes;
//   sha256 (3): SHA-256 of the decimal string, of the 8 BE bytes
//       [hi, lo], of the 8 LE bytes [bswap(lo), bswap(hi)];
//   double_sha256 (3): each of those hashed once more (32-byte message);
//   md5 (1): the MD5 digest of the decimal string, its 16 bytes twice.
//
// Bound: the ALU pipe (rotates and logic of 3 or 6 SHA-256 compressions, or
// one MD5, plus the decimal rendering's 20 divisions), against 8 bytes read
// and 32 written a slot (vuke_tpu_torch/kernels/work.py::keygen_hash).  The
// three messages are hashed one after another, so only one schedule and one
// state are live; the mode is uniform across a launch, so its branches never
// diverge.

#include <cuda_runtime.h>
#include <cstdint>

#include "keygen.cuh"

namespace {

using namespace vk::kg;

enum Mode { kDirect = 0, kSha256 = 1, kDoubleSha256 = 2, kMd5 = 3 };

__global__ void __launch_bounds__(256)
keygen_hash_kernel(const uint32_t* __restrict__ hi_in, const uint32_t* __restrict__ lo_in,
                   int mode, uint32_t* __restrict__ out, long long n) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const uint32_t hi = hi_in[i], lo = lo_in[i];
    uint32_t str[5], key[8];
    const uint32_t len = decimal_words(hi, lo, str);

    if (mode == kDirect) {
#pragma unroll
        for (int j = 0; j < 8; j++) key[j] = j == 6 ? hi : j == 7 ? lo : 0u;
        store_key(out, n, i, 0, key);
#pragma unroll
        for (int j = 0; j < 8; j++) key[j] = j == 0 ? bswap(lo) : j == 1 ? bswap(hi) : 0u;
        store_key(out, n, i, 1, key);
#pragma unroll
        for (int j = 0; j < 8; j++) key[j] = j < 5 ? str[j] : 0u;
        store_key(out, n, i, 2, key);
        return;
    }
    uint32_t m[14];
    if (mode == kMd5) {
#pragma unroll
        for (int j = 0; j < 14; j++) m[j] = j < 5 ? str[j] : 0u;
        uint32_t d[4];
        md5_msg(m, len, d);
#pragma unroll
        for (int j = 0; j < 8; j++) key[j] = bswap(d[j & 3]);
        store_key(out, n, i, 0, key);
        return;
    }
    const bool twice = mode == kDoubleSha256;
#pragma unroll
    for (int j = 0; j < 14; j++) m[j] = j < 5 ? str[j] : 0u;
    sha256_msg(m, len, key);
    if (twice) sha256_of_key(key);
    store_key(out, n, i, 0, key);
#pragma unroll
    for (int j = 0; j < 14; j++) m[j] = j == 0 ? hi : j == 1 ? lo : 0u;
    sha256_msg(m, 8, key);
    if (twice) sha256_of_key(key);
    store_key(out, n, i, 1, key);
#pragma unroll
    for (int j = 0; j < 14; j++) m[j] = j == 0 ? bswap(lo) : j == 1 ? bswap(hi) : 0u;
    sha256_msg(m, 8, key);
    if (twice) sha256_of_key(key);
    store_key(out, n, i, 2, key);
}

}  // namespace

// mode: 0 direct, 1 sha256, 2 double_sha256, 3 md5; out: (S, 8, n) with S
// 3, 3, 3 and 1.
extern "C" int vk_keygen_hash(const uint32_t* hi, const uint32_t* lo, int mode, uint32_t* out,
                              long long n, void* stream) {
    if (mode < kDirect || mode > kMd5) return (int)cudaErrorInvalidValue;
    const int threads = 256;
    const long long blocks = (n + threads - 1) / threads;
    keygen_hash_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(hi, lo, mode,
                                                                               out, n);
    return VK_LAUNCH_STATUS();
}
