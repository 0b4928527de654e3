// Base58check device code shared by D2 (p2pkh.cu) and E1 (records.cu): the
// SHA-256d checksum of a one-block payload, the leading zero bytes of a
// number, its digits in any radix written straight into a row of a
// shared-memory tile, and the tile's zeroing and coalesced store.
//
// A number is big-endian 32-bit limbs, limb 0 holding its top kTop bytes
// (1 to 4), each later limb 4.  Each pass divides every limb still live by
// a constant of at least 2^29 (58^5 or 10^9: a 64-bit division by a
// constant, a multiply-high on the FMA pipe); after r passes the number is
// below 2^(bits - 29 r), so the limbs above that are skipped.  A pass keeps
// only its remainder, a register: no digit array exists.  The count of
// significant digits comes from the highest non-zero remainder; then each
// digit is made from its remainder and stored once, at its final place in
// the row, len - 1 - idx for the idx-th digit from the least significant.
// For base58 the digits past the number's own are zeros, so the same
// stores write the '1' of each leading zero byte (len = zeros + digits).
// Every index into a per-thread array is a compile-time constant (all
// loops unroll), so nothing lives in local memory.
//
// Rows are NUL-padded: a block zeroes its tile first, the threads write
// only characters, and after a barrier the block stores the tile, whose
// rows are contiguous in the output, as lane-consecutive 16-byte vectors.
#pragma once

#include <cuda_runtime.h>
#include <cstdint>

#include "keygen.cuh"

namespace vk {
namespace b58 {

using namespace vk::kg;

constexpr uint64_t kB58Pow5 = 58ull * 58 * 58 * 58 * 58;   // 656,356,768, in [2^29, 2^30)

// Base-58 digit -> its character of 123456789ABCDEFGHJKLMNPQRSTUVWXYZ
// abcdefghijkmnopqrstuvwxyz, by ranges; it fills the shared alphabet that
// the rows' characters are looked up in.
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

// Leading zero bytes of the number limb[0..L-1], limb 0 holding its top
// `top` bytes.
template <int L>
__device__ __forceinline__ uint32_t leading_zero_bytes(const uint32_t limb[L], uint32_t top) {
    uint32_t zeros = 0;
    bool more = true;
#pragma unroll
    for (int j = 0; j < L; j++) {
        const uint32_t nb = j == 0 ? top : 4;
        const uint32_t z = limb[j] == 0 ? nb : ((uint32_t)__clz(limb[j]) >> 3) - (4 - nb);
        zeros += more ? z : 0u;
        more = more && limb[j] == 0;
    }
    return zeros;
}

// kPasses divisions of the kBits-bit number limb[0..L-1] (overwritten) by
// kDiv >= 2^29; rem[r] is pass r's remainder, the number's base-kDiv digit
// r from the least significant.
template <uint64_t kDiv, int L, int kBits, int kPasses>
__device__ __forceinline__ void divide_out(uint32_t limb[L], uint32_t rem[kPasses]) {
    static_assert(kDiv >= (1ull << 29) && kDiv < (1ull << 32), "a pass strips 29 bits or more");
#pragma unroll
    for (int r = 0; r < kPasses; r++) {
        const int live_bits = kBits - 29 * r;
        const int first = live_bits <= 0 ? L : L - (live_bits + 31) / 32;
        uint64_t rm = 0;
#pragma unroll
        for (int j = 0; j < L; j++) {
            if (j < first) continue;
            const uint64_t cur = (rm << 32) | limb[j];
            const uint64_t q = cur / kDiv;
            rm = cur - q * kDiv;
            limb[j] = (uint32_t)q;
        }
        rem[r] = (uint32_t)rm;
    }
}

// The significant digits (radix kRadix, kPer a remainder) of the number
// whose remainders are rem[0..kPasses-1]: 0 for 0.
template <int kPasses, int kPer, uint32_t kRadix>
__device__ __forceinline__ uint32_t significant_digits(const uint32_t rem[kPasses]) {
    uint32_t top = 0, topv = 0;
#pragma unroll
    for (int r = 0; r < kPasses; r++) {
        top = rem[r] ? (uint32_t)(kPer * r) : top;
        topv = rem[r] ? rem[r] : topv;
    }
    uint32_t p = 1;
#pragma unroll
    for (int t = 0; t < kPer; t++) {
        top += topv >= p ? 1u : 0u;
        p *= kRadix;
    }
    return top;
}

// The digit characters of rem[0..kPasses-1] into row[0..len-1], most
// significant first: digit idx (from the least significant) goes to
// row[len - 1 - idx] as chars[digit].  len <= kPer * kPasses.
template <int kPasses, int kPer, uint32_t kRadix>
__device__ __forceinline__ void emit_digits(const uint32_t rem[kPasses], uint32_t len,
                                            const uint8_t* chars, uint8_t* row) {
    uint8_t* last = row + len - 1;
#pragma unroll
    for (int r = 0; r < kPasses; r++) {
        uint32_t v = rem[r];
#pragma unroll
        for (int t = 0; t < kPer; t++) {
            const int idx = kPer * r + t;
            const uint32_t d = v % kRadix;
            v /= kRadix;
            if ((uint32_t)idx < len) last[-idx] = chars[d];
        }
    }
}

// '1' x zeros, then the base-58 digits of the number limb[0..L-1]
// (overwritten; kTop bytes in limb 0) from its first non-zero one, into
// row[0..]; kPasses x 5 digits must hold the number and the '1's.
// alphabet: the 58 characters, in shared memory.
template <int L, int kTop, int kPasses>
__device__ __forceinline__ void base58_row(uint32_t limb[L], uint32_t zeros,
                                           const uint8_t* alphabet, uint8_t* row) {
    uint32_t rem[kPasses];
    divide_out<kB58Pow5, L, 8 * (kTop + 4 * (L - 1)), kPasses>(limb, rem);
    const uint32_t len = zeros + significant_digits<kPasses, 5, 58>(rem);
    emit_digits<kPasses, 5, 58>(rem, len, alphabet, row);
}

// The base58check of version || payload [|| 0x01] into row[0..]: the
// payload's BE words p[0..7] are a key (a WIF, `wif`; `compressed` appends
// 0x01) or a hash160 in p[0..4] with p[5..7] zero (a P2PKH address).  One
// checksum code for every kind, so the warps of E1's four base58check
// roles run the same hash code; then the digits of a 10-limb number (a
// WIF: 37 or 38 bytes, limb 0 one or two of them) or of a 7-limb one (an
// address: 25 bytes).  With wif and compressed known at compile time (D2)
// the other kinds' code folds away.
__device__ __forceinline__ void base58check_row(bool wif, bool compressed, uint32_t version,
                                                const uint32_t p[8], const uint8_t* alphabet,
                                                uint8_t* row) {
    uint32_t m[14];
    m[0] = (version << 24) | (p[0] >> 8);
#pragma unroll
    for (int j = 1; j < 8; j++) m[j] = (p[j - 1] << 24) | (p[j] >> 8);
    m[8] = (p[7] << 24) | (compressed ? 0x00010000u : 0u);
#pragma unroll
    for (int j = 9; j < 14; j++) m[j] = 0;
    const uint32_t chk = sha256d_word0(m, wif ? (compressed ? 34u : 33u) : 21u);
    if (wif) {
        const uint32_t sh = compressed ? 8 : 0;
        uint32_t limb[10];
        limb[0] = __funnelshift_l(p[0], version, sh);
#pragma unroll
        for (int j = 1; j < 8; j++) limb[j] = __funnelshift_l(p[j], p[j - 1], sh);
        limb[8] = __funnelshift_l(0x01000000u, p[7], sh);
        limb[9] = chk;
        base58_row<10, 2, 11>(limb, leading_zero_bytes<10>(limb, compressed ? 2 : 1), alphabet,
                              row);
    } else {
        uint32_t limb[7] = {version, p[0], p[1], p[2], p[3], p[4], chk};
        base58_row<7, 1, 7>(limb, leading_zero_bytes<7>(limb, 1), alphabet, row);
    }
}

// The BE words of lane i of the (5, n) LE digest words h160 (K2's
// layout) into p[0..4], zeros in p[5..7]: base58check_row's payload.
__device__ __forceinline__ void digest_payload(const uint32_t* __restrict__ h160, long long n,
                                               long long i, uint32_t p[8]) {
#pragma unroll
    for (int j = 0; j < 8; j++) p[j] = j < 5 ? bswap(h160[j * n + i]) : 0u;
}

// The 58 characters into alphabet[0..57] (shared), by threads 0..57.
__device__ __forceinline__ void load_alphabet(uint8_t* alphabet) {
    if (threadIdx.x < 58) alphabet[threadIdx.x] = b58_char(threadIdx.x);
}

// Zeroes the kVecs 16-byte vectors of a tile, kThreads threads a block.
template <int kVecs, int kThreads>
__device__ __forceinline__ void zero_tile(uint4* tile) {
#pragma unroll
    for (int k = 0; k < (kVecs + kThreads - 1) / kThreads; k++) {
        const int idx = (int)threadIdx.x + k * kThreads;
        if (idx < kVecs) tile[idx] = make_uint4(0, 0, 0, 0);
    }
}

// Stores the first `bytes` bytes of a tile of kVecs 16-byte vectors to dst
// (16-byte aligned): the whole vectors lane-consecutive, a partial last
// one byte by byte.
template <int kVecs, int kThreads>
__device__ __forceinline__ void store_tile(const uint4* tile, uint8_t* __restrict__ dst,
                                           uint32_t bytes) {
    static_assert(kThreads >= 16, "the partial vector takes 16 threads");
    const uint32_t vecs = bytes / 16;
    uint4* d = reinterpret_cast<uint4*>(dst);
#pragma unroll
    for (int k = 0; k < (kVecs + kThreads - 1) / kThreads; k++) {
        const uint32_t idx = threadIdx.x + (uint32_t)(k * kThreads);
        if (idx < vecs) d[idx] = tile[idx];
    }
    const uint32_t rest = bytes - 16 * vecs;
    if (threadIdx.x < rest)
        dst[16 * vecs + threadIdx.x] = reinterpret_cast<const uint8_t*>(tile)[16 * vecs + threadIdx.x];
}

}  // namespace b58
}  // namespace vk
