// E1: the string columns of a Parquet record that need arithmetic, one
// thread a lane, written as one NUL-padded row of 304 bytes:
//
//   [  0,  78) private_key_decimal        [181, 215) address_p2pkh_compressed
//   [ 78, 130) wif_compressed             [215, 249) address_p2pkh_uncompressed
//   [130, 181) wif_uncompressed           [249, 293) address_p2wpkh
//   [293, 298) bit length (u16 LE), Hamming weight (u16 LE), leading zero
//              hex digits (u8); [298, 304) zeros
//
// Replaces no Pallas kernel: it is the card-side counterpart of the host
// encoders of vuke_tpu/derive.py:66-93 (KeyDeriver.derive) as
// vuke_tpu/storage/output.py:42-46 runs them for every generate record
// (native/vuke_native.cpp:179 for the P2PKH part, Python for the rest).  It
// reads the normalized key words ((8, N) BE) and K2's two (5, N) LE digests
// where they lie; the hex columns (the key, its bits, both public keys) are
// the host's, from the same words (cores/records.py::host_columns).
//
// - decimal: nine divisions of the key's eight limbs by 10^9, each
//   remainder split into nine digits, the leading zeros dropped;
// - WIF: base58check of wif_version || key [|| 0x01], a 37- or 38-byte
//   number in ten limbs, eleven passes of division by 58^5 (base58.cuh);
// - P2PKH: base58check of p2pkh_version || hash160, as D2 (p2pkh.cu);
// - P2WPKH: bech32 v0 of the compressed hash160 under the network's hrp;
//   the checksum's state after the hrp's expansion comes from the host;
// - the statistics from the limbs' leading zeros and population counts.
//
// Bound: the ALU and FMA pipes: eight SHA-256 compressions (four
// checksums) and the divisions (vuke_tpu_torch/kernels/work.py::records),
// against 72 bytes read and 304 written a lane.  A first, simple kernel:
// the row is assembled in local memory and stored as 16-byte vectors.

#include <cuda_runtime.h>
#include <cstdint>

#include "base58.cuh"

namespace {

using namespace vk::kg;
using namespace vk::b58;

constexpr int kRow = 304;
constexpr int kDec = 0, kWifC = 78, kWifU = 130, kP2pkhC = 181, kP2pkhU = 215, kP2wpkh = 249,
              kStats = 293;

static __constant__ uint8_t kBech32[33] = "qpzry9x8gf2tvdw0s3jn54khce6mua7l";

// The decimal digits of the key k[8] (BE words), no leading zeros ("0" for
// 0), into row[0..77], NULs after.
__device__ __forceinline__ void decimal_row(const uint32_t k[8], uint8_t* row) {
    uint32_t limb[8];
#pragma unroll
    for (int j = 0; j < 8; j++) limb[j] = k[j];
    uint8_t digit[81];
#pragma unroll
    for (int r = 0; r < 9; r++) {
        uint64_t rem = 0;
#pragma unroll
        for (int j = 0; j < 8; j++) {
            const uint64_t cur = (rem << 32) | limb[j];
            const uint64_t q = cur / 1000000000ull;
            rem = cur - q * 1000000000ull;
            limb[j] = (uint32_t)q;
        }
        uint32_t v = (uint32_t)rem;
#pragma unroll
        for (int t = 0; t < 9; t++) {
            digit[80 - 9 * r - t] = (uint8_t)(v % 10u);
            v /= 10u;
        }
    }
    uint32_t first = 80;                       // a key below 10^78 leaves digits 0..2 zero
#pragma unroll
    for (int t = 79; t >= 0; t--) first = digit[t] ? (uint32_t)t : first;
    const uint32_t len = 81 - first;
    for (uint32_t t = 0; t < 78; t++) row[t] = t < len ? (uint8_t)('0' + digit[first + t]) : 0;
}

__device__ __forceinline__ void polymod_step(uint32_t& chk, uint32_t v) {
    const uint32_t top = chk >> 25;
    chk = ((chk & 0x1FFFFFFu) << 5) ^ v;
    chk ^= (top & 1u) ? 0x3B6A57B2u : 0u;
    chk ^= (top & 2u) ? 0x26508E6Du : 0u;
    chk ^= (top & 4u) ? 0x1EA119FAu : 0u;
    chk ^= (top & 8u) ? 0x3D4233DDu : 0u;
    chk ^= (top & 16u) ? 0x2A1462B3u : 0u;
}

// bech32 v0 of the 20 bytes d[5] (BE words): hrp (hrp_len bytes, packed
// LE in hrp_word) || '1' || 'q' || 32 data characters || 6 checksum
// characters, into row[0..43], NULs after.  chk0: the polymod's state
// after the hrp's expansion.
__device__ __forceinline__ void bech32_row(const uint32_t d[5], uint32_t hrp_word,
                                           uint32_t hrp_len, uint32_t chk0, uint8_t* row) {
    uint32_t chk = chk0;
    uint8_t data[33];
    data[0] = 0;
    polymod_step(chk, 0);
#pragma unroll
    for (int g = 0; g < 32; g++) {
        const int bit = 5 * g, w = bit >> 5, off = bit & 31;
        uint32_t v;
        if (off <= 27) v = d[w] >> (27 - off);
        else v = (d[w] << (off - 27)) | (d[w + 1] >> (59 - off));
        v &= 31u;
        data[1 + g] = (uint8_t)v;
        polymod_step(chk, v);
    }
#pragma unroll
    for (int t = 0; t < 6; t++) polymod_step(chk, 0);
    chk ^= 1u;
    for (uint32_t t = 0; t < 44; t++) {
        uint8_t c = 0;
        if (t < hrp_len) c = (uint8_t)(hrp_word >> (8 * t));
        else if (t == hrp_len) c = '1';
        else if (t < hrp_len + 34) c = kBech32[data[t - hrp_len - 1]];
        else if (t < hrp_len + 40) c = kBech32[(chk >> (5 * (hrp_len + 39 - t))) & 31u];
        row[t] = c;
    }
}

__global__ void __launch_bounds__(256)
records_kernel(const uint32_t* __restrict__ keys, const uint32_t* __restrict__ h160c,
               const uint32_t* __restrict__ h160u, uint32_t p2pkh_version, uint32_t wif_version,
               uint32_t hrp_word, uint32_t hrp_len, uint32_t chk0, uint8_t* __restrict__ out,
               long long n) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    uint4 buf[kRow / 16];
    uint8_t* row = reinterpret_cast<uint8_t*>(buf);
    uint32_t k[8];
#pragma unroll
    for (int j = 0; j < 8; j++) k[j] = keys[j * n + i];

    decimal_row(k, row + kDec);

    // WIF: the payload's BE message words, 33 bytes (uncompressed) or 34
    uint32_t m[14];
    m[0] = (wif_version << 24) | (k[0] >> 8);
#pragma unroll
    for (int j = 1; j < 8; j++) m[j] = (k[j - 1] << 24) | (k[j] >> 8);
#pragma unroll
    for (int j = 9; j < 14; j++) m[j] = 0;
    {
        m[8] = k[7] << 24;
        uint32_t limb[10] = {wif_version, k[0], k[1], k[2], k[3], k[4], k[5], k[6], k[7],
                             sha256d_word0(m, 33)};
        const uint32_t zeros = leading_zero_bytes<10, 1>(limb);
        base58_row<10, 11, 51>(limb, zeros, row + kWifU);
    }
    {
        m[8] = (k[7] << 24) | 0x00010000u;
        uint32_t limb[10];
        limb[0] = (wif_version << 8) | (k[0] >> 24);
#pragma unroll
        for (int j = 1; j < 8; j++) limb[j] = (k[j - 1] << 8) | (k[j] >> 24);
        limb[8] = (k[7] << 8) | 0x01u;
        limb[9] = sha256d_word0(m, 34);
        const uint32_t zeros = leading_zero_bytes<10, 2>(limb);
        base58_row<10, 11, 52>(limb, zeros, row + kWifC);
    }

    // P2PKH of both digests, then bech32 of the compressed one
    uint32_t dc[5];
#pragma unroll
    for (int form = 0; form < 2; form++) {
        const uint32_t* h = form == 0 ? h160c : h160u;
        uint32_t d[5];
#pragma unroll
        for (int j = 0; j < 5; j++) d[j] = bswap(h[j * n + i]);   // digest bytes 4j.. as BE
        if (form == 0) {
#pragma unroll
            for (int j = 0; j < 5; j++) dc[j] = d[j];
        }
        m[0] = (p2pkh_version << 24) | (d[0] >> 8);
#pragma unroll
        for (int j = 1; j < 5; j++) m[j] = (d[j - 1] << 24) | (d[j] >> 8);
        m[5] = d[4] << 24;
#pragma unroll
        for (int j = 6; j < 14; j++) m[j] = 0;
        uint32_t limb[7] = {p2pkh_version, d[0], d[1], d[2], d[3], d[4], sha256d_word0(m, 21)};
        const uint32_t zeros = leading_zero_bytes<7, 1>(limb);
        base58_row<7, 7, 34>(limb, zeros, row + (form == 0 ? kP2pkhC : kP2pkhU));
    }
    bech32_row(dc, hrp_word, hrp_len, chk0, row + kP2wpkh);

    // bit length, Hamming weight, leading zero hex digits
    uint32_t lz = 0, weight = 0;
    bool more = true;
#pragma unroll
    for (int j = 0; j < 8; j++) {
        lz += more ? (uint32_t)__clz(k[j]) : 0u;
        more = more && k[j] == 0;
        weight += (uint32_t)__popc(k[j]);
    }
    const uint32_t bits = 256 - lz;
    row[kStats + 0] = (uint8_t)bits;
    row[kStats + 1] = (uint8_t)(bits >> 8);
    row[kStats + 2] = (uint8_t)weight;
    row[kStats + 3] = (uint8_t)(weight >> 8);
    row[kStats + 4] = (uint8_t)(lz >> 2);
#pragma unroll
    for (int t = kStats + 5; t < kRow; t++) row[t] = 0;

    uint4* dst = reinterpret_cast<uint4*>(out + i * kRow);
#pragma unroll
    for (int j = 0; j < kRow / 16; j++) dst[j] = buf[j];
}

}  // namespace

// keys: (8, n) BE words; h160c, h160u: (5, n) LE words; out: (n, 304) bytes.
extern "C" int vk_records(const uint32_t* keys, const uint32_t* h160c, const uint32_t* h160u,
                          int p2pkh_version, int wif_version, uint32_t hrp_word, int hrp_len,
                          uint32_t chk0, uint8_t* out, long long n, void* stream) {
    if (p2pkh_version < 0 || p2pkh_version > 255 || wif_version < 0 || wif_version > 255 ||
        hrp_len < 1 || hrp_len > 4)
        return (int)cudaErrorInvalidValue;
    const int threads = 256;
    const long long blocks = (n + threads - 1) / threads;
    records_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        keys, h160c, h160u, (uint32_t)p2pkh_version, (uint32_t)wif_version, hrp_word,
        (uint32_t)hrp_len, chk0, out, n);
    return VK_LAUNCH_STATUS();
}
