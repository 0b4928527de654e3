// E1: the string columns of a Parquet record that need arithmetic, written
// as one NUL-padded row of 304 bytes a record:
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
// - decimal: nine divisions of the key's eight limbs by 10^9, nine digits
//   from each remainder, no leading zeros;
// - WIF: base58check of wif_version || key [|| 0x01], a 37- or 38-byte
//   number in ten limbs, eleven passes of division by 58^5 (base58.cuh);
// - P2PKH: base58check of p2pkh_version || hash160, as D2 (p2pkh.cu);
// - P2WPKH: bech32 v0 of the compressed hash160 under the network's hrp;
//   the checksum's state after the hrp's expansion comes from the host;
// - the statistics from the limbs' leading zeros and population counts.
//
// Bound: the ALU pipe: eight SHA-256 compressions (four checksums) and the
// divisions (vuke_tpu_torch/kernels/work.py::records), against 72 bytes
// read and 304 written a record.  The design, for Hopper:
// - five roles, one a warp: the decimal with the bech32 and the
//   statistics; then four base58check roles, the uncompressed WIF, the
//   compressed WIF, the compressed P2PKH, the uncompressed P2PKH.  A block
//   holds kRecords = 64 records in kGroups = 2 groups of 32, ten warps: a
//   role's warp works on 32 consecutive records, so no warp diverges on
//   the role, the five dependent chains of a record run in parallel, and
//   a thread keeps one encoding's state (the first kernel ran all five in
//   one thread at 128 registers and 88 bytes of stack, 16 warps an SM);
// - the four base58check roles run one code (base58.cuh::base58check_row:
//   the payload's words, one SHA-256d, then a WIF's or an address's
//   digits), so the warps of an SM share one copy of the fully unrolled
//   hash in the instruction cache (four separately inlined checksums made
//   the kernel more than twice as long, and slower on the H100; so did a
//   checksum rolled into 16-round blocks, which costs ALU work);
// - every field is written straight into its record's row of a shared tile
//   (64 x 304 = 19,456 bytes, zeroed first), digit by digit at its final
//   place (base58.cuh), with no per-lane array read at a runtime index;
// - after a barrier the block stores the tile, contiguous in `out`, as
//   lane-consecutive 16-byte vectors (the first kernel stored 19 vectors a
//   lane with lanes 304 bytes apart: half-sector writes);
// - the base58 and bech32 characters come from shared tables.
// The divisions stay 64-bit divisions by a constant: their multiply-highs
// run on the FMA pipe, beside the ALU-bound hashes.

#include <cuda_runtime.h>
#include <cstdint>

#include "base58.cuh"

namespace {

using namespace vk::kg;
using namespace vk::b58;

constexpr int kRow = 304;
constexpr int kDec = 0, kWifC = 78, kWifU = 130, kP2pkhC = 181, kP2pkhU = 215, kP2wpkh = 249,
              kStats = 293;
constexpr int kRoles = 5;
constexpr int kGroups = 2;
constexpr int kRecords = 32 * kGroups;
constexpr int kThreads = 32 * kGroups * kRoles;
constexpr int kVecs = kRow * kRecords / 16;   // the tile: 19,456 bytes
static_assert(kRow % 16 == 0, "a record's row is whole 16-byte vectors");

static __constant__ uint8_t kBech32[33] = "qpzry9x8gf2tvdw0s3jn54khce6mua7l";

// A block's character tables, in shared memory: a lookup there is one load
// on the memory pipe, conflict-free (each table spans distinct banks).
struct Tables {
    uint8_t b58[64];
    uint8_t bech32[32];
    uint8_t dec[16];
};

// The decimal digits of the key k[8] (BE words), no leading zeros ("0" for
// 0), into row[0..77].
__device__ __forceinline__ void decimal_row(const uint32_t k[8], const uint8_t* dec,
                                            uint8_t* row) {
    uint32_t limb[8], rem[9];
#pragma unroll
    for (int j = 0; j < 8; j++) limb[j] = k[j];
    divide_out<1000000000ull, 8, 256, 9>(limb, rem);
    const uint32_t len = max(significant_digits<9, 9, 10>(rem), 1u);
    emit_digits<9, 9, 10>(rem, len, dec, row);
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
// characters, into row[0..43].  chk0: the polymod's state after the hrp's
// expansion.  Each character is stored as it is made.
__device__ __forceinline__ void bech32_row(const uint32_t d[5], uint32_t hrp_word,
                                           uint32_t hrp_len, uint32_t chk0,
                                           const uint8_t* charset, uint8_t* row) {
#pragma unroll
    for (int t = 0; t < 4; t++)
        if ((uint32_t)t < hrp_len) row[t] = (uint8_t)(hrp_word >> (8 * t));
    uint8_t* data = row + hrp_len;
    data[0] = '1';
    data[1] = charset[0];                     // the witness version, 0
    uint32_t chk = chk0;
    polymod_step(chk, 0);
#pragma unroll
    for (int g = 0; g < 32; g++) {
        const int bit = 5 * g, w = bit >> 5, off = bit & 31;
        uint32_t v;
        if (off <= 27) v = d[w] >> (27 - off);
        else v = (d[w] << (off - 27)) | (d[w + 1] >> (59 - off));
        v &= 31u;
        data[2 + g] = charset[v];
        polymod_step(chk, v);
    }
#pragma unroll
    for (int t = 0; t < 6; t++) polymod_step(chk, 0);
    chk ^= 1u;
#pragma unroll
    for (int t = 0; t < 6; t++) data[34 + t] = charset[(chk >> (5 * (5 - t))) & 31u];
}

// Role 0: the decimal, the bech32 of the compressed digest and the
// statistics of record i.
__device__ __forceinline__ void decimal_bech32_stats(
        const uint32_t* __restrict__ keys, const uint32_t* __restrict__ h160c, long long n,
        long long i, uint32_t hrp_word, uint32_t hrp_len, uint32_t chk0, const Tables& tab,
        uint8_t* row) {
    uint32_t k[8];
#pragma unroll
    for (int j = 0; j < 8; j++) k[j] = keys[j * n + i];
    decimal_row(k, tab.dec, row + kDec);
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
    uint32_t d[5];
#pragma unroll
    for (int j = 0; j < 5; j++) d[j] = bswap(h160c[j * n + i]);   // digest bytes 4j.. as BE
    bech32_row(d, hrp_word, hrp_len, chk0, tab.bech32, row + kP2wpkh);
}

__global__ void __launch_bounds__(kThreads)
records_kernel(const uint32_t* __restrict__ keys, const uint32_t* __restrict__ h160c,
               const uint32_t* __restrict__ h160u, uint32_t p2pkh_version, uint32_t wif_version,
               uint32_t hrp_word, uint32_t hrp_len, uint32_t chk0, uint8_t* __restrict__ out,
               long long n) {
    __shared__ uint4 tile[kVecs];
    __shared__ Tables tab;
    const long long base = (long long)blockIdx.x * kRecords;
    const uint32_t records = (uint32_t)min((long long)kRecords, n - base);
    zero_tile<kVecs, kThreads>(tile);
    load_alphabet(tab.b58);
    if (threadIdx.x < 32) tab.bech32[threadIdx.x] = kBech32[threadIdx.x];
    if (threadIdx.x < 10) tab.dec[threadIdx.x] = (uint8_t)('0' + threadIdx.x);
    __syncthreads();
    const uint32_t warp = threadIdx.x >> 5;
    const uint32_t role = warp / kGroups;                          // warp-uniform
    const uint32_t rec = (warp % kGroups) * 32 + (threadIdx.x & 31);
    if (rec < records) {
        const long long i = base + rec;
        uint8_t* row = reinterpret_cast<uint8_t*>(tile) + rec * kRow;
        if (role == 0) {
            decimal_bech32_stats(keys, h160c, n, i, hrp_word, hrp_len, chk0, tab, row);
        } else {
            // roles 1-4: the uncompressed and the compressed WIF of the key, the
            // P2PKH addresses of the compressed and the uncompressed digest
            const bool wif = role <= 2;
            uint32_t p[8];
            if (wif) {
#pragma unroll
                for (int j = 0; j < 8; j++) p[j] = keys[j * n + i];
            } else {
                digest_payload(role == 3 ? h160c : h160u, n, i, p);
            }
            const uint32_t at = role == 1 ? kWifU : role == 2 ? kWifC : role == 3 ? kP2pkhC
                                                                                 : kP2pkhU;
            base58check_row(wif, role == 2, wif ? wif_version : p2pkh_version, p, tab.b58,
                            row + at);
        }
    }
    __syncthreads();
    store_tile<kVecs, kThreads>(tile, out + base * kRow, records * kRow);
}

}  // namespace

// keys: (8, n) BE words; h160c, h160u: (5, n) LE words; out: (n, 304)
// bytes, 16-byte aligned.
extern "C" int vk_records(const uint32_t* keys, const uint32_t* h160c, const uint32_t* h160u,
                          int p2pkh_version, int wif_version, uint32_t hrp_word, int hrp_len,
                          uint32_t chk0, uint8_t* out, long long n, void* stream) {
    if (p2pkh_version < 0 || p2pkh_version > 255 || wif_version < 0 || wif_version > 255 ||
        hrp_len < 1 || hrp_len > 4 || reinterpret_cast<uintptr_t>(out) % 16 != 0)
        return (int)cudaErrorInvalidValue;
    const long long blocks = (n + kRecords - 1) / kRecords;
    records_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        keys, h160c, h160u, (uint32_t)p2pkh_version, (uint32_t)wif_version, hrp_word,
        (uint32_t)hrp_len, chk0, out, n);
    return VK_LAUNCH_STATUS();
}
