// Base58check device code shared by D2 (p2pkh.cu) and E1 (records.cu): the
// SHA-256d checksum of a one-block payload, the leading zero bytes of a
// number, and its base-58 digits written as NUL-padded ASCII.
//
// A number is big-endian 32-bit limbs, limb 0 holding its top kTop bytes
// (1 to 4), each later limb 4.  Each pass divides every limb by 58^5 (a
// 64-bit division by a constant: a multiply-high), giving five digits from
// its remainder; the leading zero digits go, and each leading zero byte of
// the number becomes a '1'.
#pragma once

#include <cuda_runtime.h>
#include <cstdint>

#include "keygen.cuh"

namespace vk {
namespace b58 {

using namespace vk::kg;

constexpr uint64_t kB58Pow5 = 58ull * 58 * 58 * 58 * 58;   // 656,356,768 < 2^32

// Base-58 digit -> its character of 123456789ABCDEFGHJKLMNPQRSTUVWXYZ
// abcdefghijkmnopqrstuvwxyz, by ranges (no table, so no divergent reads).
__device__ __forceinline__ uint8_t b58_char(uint32_t d) {
    return (uint8_t)(d < 9 ? '1' + d : d < 17 ? 'A' + (d - 9) : d < 22 ? 'J' + (d - 17)
                     : d < 33 ? 'P' + (d - 22) : d < 44 ? 'a' + (d - 33) : 'm' + (d - 44));
}

// The checksum word: the first word of SHA-256(SHA-256(m)), m[0..13] the
// BE words of a payload of len bytes (len <= 55, zeros beyond).
__device__ __forceinline__ uint32_t sha256d_word0(const uint32_t m[14], uint32_t len) {
    uint32_t s[8];
    sha256_msg(m, len, s);
    sha256_of_key(s);
    return s[0];
}

// Leading zero bytes of the number limb[0..L-1].
template <int L, int kTop>
__device__ __forceinline__ uint32_t leading_zero_bytes(const uint32_t limb[L]) {
    uint32_t zeros = 0;
    bool more = true;
#pragma unroll
    for (int j = 0; j < L; j++) {
        const uint32_t nb = j == 0 ? kTop : 4;
        const uint32_t z = limb[j] == 0 ? nb : ((uint32_t)__clz(limb[j]) >> 3) - (4 - nb);
        zeros += more ? z : 0u;
        more = more && limb[j] == 0;
    }
    return zeros;
}

// '1' x zeros, then the base-58 digits of limb[0..L-1] (overwritten) from
// the first non-zero one, into row[0..W-1], NULs after.  kPasses x 5 digits
// must hold the number; zeros + its digit count must fit W.
template <int L, int kPasses, int W>
__device__ __forceinline__ void base58_row(uint32_t limb[L], uint32_t zeros, uint8_t* row) {
    constexpr int D = 5 * kPasses;
    uint8_t digit[D];
#pragma unroll
    for (int r = 0; r < kPasses; r++) {
        uint64_t rem = 0;
#pragma unroll
        for (int j = 0; j < L; j++) {
            const uint64_t cur = (rem << 32) | limb[j];
            const uint64_t q = cur / kB58Pow5;
            rem = cur - q * kB58Pow5;
            limb[j] = (uint32_t)q;
        }
        uint32_t v = (uint32_t)rem;
#pragma unroll
        for (int t = 0; t < 5; t++) {
            digit[D - 1 - 5 * r - t] = (uint8_t)(v % 58u);
            v /= 58u;
        }
    }
    uint32_t first = D;
#pragma unroll
    for (int t = D - 1; t >= 0; t--) first = digit[t] ? (uint32_t)t : first;
    const uint32_t len = zeros + D - first;
    for (uint32_t t = 0; t < (uint32_t)W; t++) {
        uint8_t c = 0;
        if (t < zeros) c = '1';
        else if (t < len) c = b58_char(digit[first + t - zeros]);
        row[t] = c;
    }
}

}  // namespace b58
}  // namespace vk
