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
// the checksum word.  Seven passes of division by 58^5 give its base-58
// digits, five from each remainder (base58.cuh::base58check_row); each leading
// zero byte of the 25 becomes a '1' (version 0x00 always gives one).
// Addresses are 26 to 34 characters, so a row ends in at least one NUL.
//
// Bound: the ALU pipe: two SHA-256 compressions (~3,900 operations) and
// the divisions (vuke_tpu_torch/kernels/work.py::p2pkh), against 20 bytes
// read and 35 written a lane.  What the design does about the rest:
// - a block of 256 lanes writes its rows into a 8,960-byte shared tile
//   (zeroed first), then stores the tile, which is contiguous in `out`, as
//   lane-consecutive 16-byte vectors: a warp's store touches 16 sectors
//   for 512 bytes, where one byte a lane 35 bytes apart touched 32
//   sectors for 32 bytes;
// - the digits are kept as the passes' remainders (registers) and each is
//   stored once at its final place, so no per-lane array is read at a
//   runtime index (no local memory);
// - the characters come from a 58-byte shared alphabet: one load on the
//   memory pipe in place of ~10 ALU operations of range compares.
// The divisions stay 64-bit divisions by a constant: their multiply-highs
// run on the FMA pipe, beside the ALU-bound hashes.

#include <cuda_runtime.h>
#include <cstdint>

#include "base58.cuh"

namespace {

using namespace vk::b58;

constexpr int kRow = 35;
constexpr int kThreads = 256;
constexpr int kVecs = kRow * kThreads / 16;   // the tile: 8,960 bytes
static_assert(kRow * kThreads % 16 == 0, "a block's rows are whole 16-byte vectors");

__global__ void __launch_bounds__(kThreads)
p2pkh_kernel(const uint32_t* __restrict__ h160, uint32_t version, uint8_t* __restrict__ out,
             long long n) {
    __shared__ uint4 tile[kVecs];
    __shared__ uint8_t alphabet[64];
    const long long base = (long long)blockIdx.x * kThreads;
    const uint32_t rows = (uint32_t)min((long long)kThreads, n - base);
    zero_tile<kVecs, kThreads>(tile);
    load_alphabet(alphabet);
    __syncthreads();
    if (threadIdx.x < rows) {
        uint32_t p[8];
        digest_payload(h160, n, base + threadIdx.x, p);
        base58check_row(false, false, version, p, alphabet,
                        reinterpret_cast<uint8_t*>(tile) + threadIdx.x * kRow);
    }
    __syncthreads();
    store_tile<kVecs, kThreads>(tile, out + base * kRow, rows * kRow);
}

}  // namespace

// h160: (5, n) LE words (K2's compressed digests); out: (n, 35) bytes,
// 16-byte aligned.
extern "C" int vk_p2pkh(const uint32_t* h160, int version, uint8_t* out, long long n,
                        void* stream) {
    if (version < 0 || version > 255 || reinterpret_cast<uintptr_t>(out) % 16 != 0)
        return (int)cudaErrorInvalidValue;
    const long long blocks = (n + kThreads - 1) / kThreads;
    p2pkh_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        h160, (uint32_t)version, out, n);
    return VK_LAUNCH_STATUS();
}
