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
// against 20 bytes read and 35 written a lane.  The checksum and the base58
// digits are base58.cuh's, shared with E1 (records.cu).

#include <cuda_runtime.h>
#include <cstdint>

#include "base58.cuh"

namespace {

using namespace vk::kg;
using namespace vk::b58;

constexpr int kRow = 35;

__global__ void __launch_bounds__(256)
p2pkh_kernel(const uint32_t* __restrict__ h160, uint32_t version, uint8_t* __restrict__ out,
             long long n) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    uint32_t d[5];
#pragma unroll
    for (int j = 0; j < 5; j++) d[j] = bswap(h160[j * n + i]);   // digest bytes 4j.. as BE
    // the 21-byte payload version || h160 as BE message words
    uint32_t m[14];
    m[0] = (version << 24) | (d[0] >> 8);
#pragma unroll
    for (int j = 1; j < 5; j++) m[j] = (d[j - 1] << 24) | (d[j] >> 8);
    m[5] = d[4] << 24;
#pragma unroll
    for (int j = 6; j < 14; j++) m[j] = 0;
    uint32_t limb[7] = {version, d[0], d[1], d[2], d[3], d[4], sha256d_word0(m, 21)};
    const uint32_t zeros = leading_zero_bytes<7, 1>(limb);
    // '1' x zeros, then the 35 digits from the first non-zero one, then NULs
    base58_row<7, 7, kRow>(limb, zeros, out + i * kRow);
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
