// W2: Electrum's key stretch, one thread a seed: x = SHA256(x || s),
// `rounds` times (99,999), from x_0 = SHA256(s || s), which the host
// computes.
//
// Replaces vuke_tpu/wallets/electrum.py::stretch_keys_device (:225; its
// jitted `stretch`, :255, a fori_loop over the batch in XLA).  Every seed
// of a launch has the same length L (the JAX grouping), so the message
// x || s of 32 + L bytes has the same shape on every lane and in every
// round: x fills words 0..7, the seed words 8..7 + ceil(L / 4) (the seed
// starts on a word boundary), then the 0x80 byte, zeros and the bit length.
// Everything after x is the same in every round, so a lane builds those
// words once:
//   - one block (L <= 23) or two (L <= 87): in registers, the seed words
//     read once;
//   - L == 32 (an Electrum seed of 32 hex digits): two blocks, and the
//     second is the padding alone, known at compile time, so its schedule
//     folds to constants;
//   - longer seeds: the blocks' words beyond x are formed from the seed
//     words in device memory in each round (through L1), for any length.
// The compression is keygen.cuh's sha256_compress, shared with the keygen,
// chain and digest kernels.
//
// Bound: operations.  A lane reads 32 + 4 ceil(L / 4) bytes and writes 32,
// and runs rounds x blocks compressions, a dependent chain: one lane's
// 99,999 rounds take ~100 ms whatever the batch, so a launch needs many
// lanes (the card holds 2048 a SM) before its time grows with them.

#include <cuda_runtime.h>
#include <cstdint>

#include "keygen.cuh"

namespace {

using namespace vk::kg;

// Word j (0-based from message word 8) of the message tail after x: the
// seed's words, the 0x80 terminator after its L bytes, zeros, and in the
// last word of block nb the bit length.
__device__ __forceinline__ uint32_t tail_word(const uint32_t* __restrict__ seed, long long n,
                                              long long i, int j, int len, int nb) {
    const int nw = (len + 3) / 4;
    uint32_t v = j < nw ? __ldg(seed + (long long)j * n + i) : 0u;
    if (j == len / 4) v |= 0x80u << (8 * (3 - (len & 3)));
    if (j == 16 * nb - 9) v |= (uint32_t)(32 + len) * 8u;
    return v;
}

// NB blocks with the tail in registers; PAD_ONLY: the last block is the
// padding alone (L == 32), its words constants.
template <int NB, bool PAD_ONLY>
__global__ void __launch_bounds__(128)
electrum_stretch_kernel(const uint32_t* __restrict__ x0, const uint32_t* __restrict__ seed,
                        long long n, int len, int rounds, uint32_t* __restrict__ out) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    constexpr int T = 16 * NB - 8;
    uint32_t tail[T];
#pragma unroll
    for (int j = 0; j < T; j++)
        tail[j] = (PAD_ONLY && j >= 8) ? 0u : tail_word(seed, n, i, j, len, NB);
    if (PAD_ONLY) {
        tail[8] = 0x80000000u;
        tail[T - 1] = 64 * 8;
    }
    uint32_t x[8];
#pragma unroll
    for (int k = 0; k < 8; k++) x[k] = x0[k * n + i];
    for (int r = 0; r < rounds; r++) {
        uint32_t s[8], w[16];
        sha256_init(s);
#pragma unroll
        for (int k = 0; k < 8; k++) {
            w[k] = x[k];
            w[8 + k] = tail[k];
        }
        sha256_compress(s, w);
#pragma unroll
        for (int b = 1; b < NB; b++) {
#pragma unroll
            for (int k = 0; k < 16; k++) w[k] = tail[16 * b - 8 + k];
            sha256_compress(s, w);
        }
#pragma unroll
        for (int k = 0; k < 8; k++) x[k] = s[k];
    }
#pragma unroll
    for (int k = 0; k < 8; k++) out[k * n + i] = x[k];
}

// Any length: `nb` blocks, the tail's words formed in each round.
__global__ void __launch_bounds__(128)
electrum_stretch_long_kernel(const uint32_t* __restrict__ x0, const uint32_t* __restrict__ seed,
                             long long n, int len, int nb, int rounds,
                             uint32_t* __restrict__ out) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    uint32_t x[8];
#pragma unroll
    for (int k = 0; k < 8; k++) x[k] = x0[k * n + i];
    for (int r = 0; r < rounds; r++) {
        uint32_t s[8], w[16];
        sha256_init(s);
#pragma unroll
        for (int k = 0; k < 8; k++) {
            w[k] = x[k];
            w[8 + k] = tail_word(seed, n, i, k, len, nb);
        }
        sha256_compress(s, w);
        for (int b = 1; b < nb; b++) {
#pragma unroll
            for (int k = 0; k < 16; k++) w[k] = tail_word(seed, n, i, 16 * b - 8 + k, len, nb);
            sha256_compress(s, w);
        }
#pragma unroll
        for (int k = 0; k < 8; k++) x[k] = s[k];
    }
#pragma unroll
    for (int k = 0; k < 8; k++) out[k * n + i] = x[k];
}

}  // namespace

// x0: (8, n) device u32, SHA256(s || s) of each seed as BE words; seed:
// (ceil(len / 4), n) device u32, each seed's bytes as BE words, zero-padded
// (nullptr when len is 0); out: (8, n) device u32.
extern "C" int vk_electrum_stretch(const uint32_t* x0, const uint32_t* seed, long long n,
                                   int len, int rounds, uint32_t* out, void* stream) {
    if (n < 0 || len < 0 || len > (1 << 24) || rounds < 0 || (len > 0 && seed == nullptr))
        return (int)cudaErrorInvalidValue;
    if (n == 0) return 0;
    const cudaStream_t s = (cudaStream_t)stream;
    const int threads = 128;
    const unsigned blocks = (unsigned)((n + threads - 1) / threads);
    const int nb = (32 + len + 9 + 63) / 64;
    if (len == 32)
        electrum_stretch_kernel<2, true><<<blocks, threads, 0, s>>>(x0, seed, n, len, rounds, out);
    else if (nb == 1)
        electrum_stretch_kernel<1, false><<<blocks, threads, 0, s>>>(x0, seed, n, len, rounds,
                                                                     out);
    else if (nb == 2)
        electrum_stretch_kernel<2, false><<<blocks, threads, 0, s>>>(x0, seed, n, len, rounds,
                                                                     out);
    else
        electrum_stretch_long_kernel<<<blocks, threads, 0, s>>>(x0, seed, n, len, nb, rounds,
                                                                out);
    return (int)cudaGetLastError();
}
