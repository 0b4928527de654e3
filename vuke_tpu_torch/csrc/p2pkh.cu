// D2: P2PKH addresses of N hash160s, one thread a lane: version || h160 ->
// SHA-256d checksum -> base58, written as NUL-padded rows of 35 bytes.
//
// Replaces no Pallas kernel: it is the card-side counterpart of the JAX
// package's host C++ encoder, vuke_tpu/native.py:71 batch_p2pkh
// (native/vuke_native.cpp:179), which generate runs for every line.  It
// reads K2's compressed digests where K2 wrote them, (5, N) LE words, with
// no transpose.
//
// The 25 bytes version || h160 || checksum are a 200-bit big-endian number
// whose 7 limbs are the version, the digest's 5 words read big-endian and
// the checksum word.  Seven divisions of the limbs by 58^5 (each a 64-bit
// division by a constant: a multiply-high) give 35 base-58 digits, five
// from each remainder; the leading zero digits go, and each leading zero
// byte of the 25 becomes a '1' (version 0x00 always gives one).  Addresses
// are 26 to 34 characters, so a row ends in at least one NUL.
//
// Bound: the ALU and FMA pipes: two SHA-256 compressions (~3,900
// operations) and the divisions (vuke_tpu_torch/kernels/work.py::p2pkh),
// against 20 bytes read and 35 written a lane.

#include <cuda_runtime.h>
#include <cstdint>

#include "keygen.cuh"

namespace {

using namespace vk::kg;

constexpr int kRow = 35;
constexpr uint64_t kB58Pow5 = 58ull * 58 * 58 * 58 * 58;   // 656,356,768 < 2^32

// Base-58 digit -> its character of 123456789ABCDEFGHJKLMNPQRSTUVWXYZ
// abcdefghijkmnopqrstuvwxyz, by ranges (no table, so no divergent reads).
__device__ __forceinline__ uint8_t b58_char(uint32_t d) {
    return (uint8_t)(d < 9 ? '1' + d : d < 17 ? 'A' + (d - 9) : d < 22 ? 'J' + (d - 17)
                     : d < 33 ? 'P' + (d - 22) : d < 44 ? 'a' + (d - 33) : 'm' + (d - 44));
}

__global__ void __launch_bounds__(256)
p2pkh_kernel(const uint32_t* __restrict__ h160, uint32_t version, uint8_t* __restrict__ out,
             long long n) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    uint32_t d[5];
#pragma unroll
    for (int j = 0; j < 5; j++) d[j] = bswap(h160[j * n + i]);   // digest bytes 4j.. as BE
    // SHA-256 of the 21-byte payload, then of its digest: the checksum is
    // the first word
    uint32_t w[16];
    w[0] = (version << 24) | (d[0] >> 8);
#pragma unroll
    for (int j = 1; j < 5; j++) w[j] = (d[j - 1] << 24) | (d[j] >> 8);
    w[5] = (d[4] << 24) | 0x00800000u;
#pragma unroll
    for (int j = 6; j < 15; j++) w[j] = 0;
    w[15] = 21 * 8;
    uint32_t s[8];
    sha256_init(s);
    sha256_compress(s, w);
    sha256_of_key(s);
    uint32_t limb[7] = {version, d[0], d[1], d[2], d[3], d[4], s[0]};
    // leading zero bytes of the 25
    uint32_t zeros = 0;
    if (version == 0) {
        zeros = 1;
        bool more = true;
#pragma unroll
        for (int j = 1; j < 7; j++) {
            const uint32_t z = more ? (uint32_t)__clz(limb[j]) >> 3 : 0u;   // 4 for a zero word
            zeros += z;
            more = more && limb[j] == 0;
        }
    }
    // 35 digits, most significant first
    uint8_t digit[kRow];
#pragma unroll
    for (int r = 0; r < 7; r++) {
        uint64_t rem = 0;
#pragma unroll
        for (int j = 0; j < 7; j++) {
            const uint64_t cur = (rem << 32) | limb[j];
            const uint64_t q = cur / kB58Pow5;
            rem = cur - q * kB58Pow5;
            limb[j] = (uint32_t)q;
        }
        uint32_t v = (uint32_t)rem;
#pragma unroll
        for (int t = 0; t < 5; t++) {
            digit[kRow - 1 - 5 * r - t] = (uint8_t)(v % 58u);
            v /= 58u;
        }
    }
    uint32_t first = kRow;
#pragma unroll
    for (int t = kRow - 1; t >= 0; t--) first = digit[t] ? (uint32_t)t : first;
    // '1' x zeros, then the digits from the first non-zero one, then NULs
    uint8_t* row = out + i * kRow;
    const uint32_t len = zeros + kRow - first;
    for (uint32_t t = 0; t < (uint32_t)kRow; t++) {
        uint8_t c = 0;
        if (t < zeros) c = '1';
        else if (t < len) c = b58_char(digit[first + t - zeros]);
        row[t] = c;
    }
}

}  // namespace

// h160: (5, n) LE words (K2's compressed digests); out: (n, 35) bytes.
extern "C" int vk_p2pkh(const uint32_t* h160, int version, uint8_t* out, long long n,
                        void* stream) {
    if (version < 0 || version > 255) return (int)cudaErrorInvalidValue;
    const int threads = 256;
    const long long blocks = (n + threads - 1) / threads;
    p2pkh_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(h160, (uint32_t)version,
                                                                         out, n);
    return VK_LAUNCH_STATUS();
}
