// K1: MT19937 milksad keygen, one thread per seed.
//
// Replaces vuke_tpu/cores/pallas_kernels.py::_mt_kernel.  Per seed: the
// init_genrand recurrence to state index 404, keeping only the taps the
// first 8 outputs read (0..8 and 397..404), then twist, temper, and
// byteswap each output into a big-endian key word (the key bytes are the
// outputs serialized little-endian).  With normalize set, the epilogue
// reduces the key into [1, n-1] before the store (scalar.cuh, the derive's
// normalize step, vuke_tpu/ecc/tiled.py::_normalize_words_t), so the derive
// needs no pass over the key words between K1 and K3; unset, the kernel
// computes exactly what _mt_kernel computes.
//
// Bound: ALU.  The recurrence is ~405 dependent multiply-xor-add steps per
// seed and reads 4 bytes / writes 32 bytes, so memory is idle.  The TPU
// interleaved 8 seed tiles per grid step to hide the chain's latency; here
// every thread runs its own chain and the warp scheduler interleaves
// warps, so nothing in the kernel needs to batch.  The 17 taps live in
// registers; loads and stores are coalesced (thread i <-> lane i).  The
// normalize flag is uniform across the launch, so its branch never diverges.

#include <cuda_runtime.h>
#include <cstdint>

#include "scalar.cuh"
#include "secp256k1.cuh"

namespace {

constexpr uint32_t kF = 1812433253u;
constexpr uint32_t kMatrixA = 0x9908B0DFu;
constexpr uint32_t kUpper = 0x80000000u;
constexpr uint32_t kLower = 0x7FFFFFFFu;

__global__ void __launch_bounds__(256)
mt19937_kernel(const uint32_t* __restrict__ seeds, uint32_t* __restrict__ out,
               long long n, int normalize) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    uint32_t lo[9], hi[8], key[8];
    uint32_t s = seeds[i];
    lo[0] = s;
#pragma unroll
    for (uint32_t k = 1; k <= 8; k++) {
        s = kF * (s ^ (s >> 30)) + k;
        lo[k] = s;
    }
#pragma unroll 4
    for (uint32_t k = 9; k < 397; k++) s = kF * (s ^ (s >> 30)) + k;
#pragma unroll
    for (uint32_t k = 397; k < 405; k++) {
        s = kF * (s ^ (s >> 30)) + k;
        hi[k - 397] = s;
    }
#pragma unroll
    for (int k = 0; k < 8; k++) {
        uint32_t y = (lo[k] & kUpper) | (lo[k + 1] & kLower);
        uint32_t x = hi[k] ^ (y >> 1) ^ ((y & 1u) ? kMatrixA : 0u);
        x ^= x >> 11;
        x ^= (x << 7) & 0x9D2C5680u;
        x ^= (x << 15) & 0xEFC60000u;
        x ^= x >> 18;
        key[k] = __byte_perm(x, 0, 0x0123);            // LE bytes -> BE word
    }
    if (normalize) vk::scalar_normalize_be(key);
#pragma unroll
    for (int k = 0; k < 8; k++) out[k * n + i] = key[k];
}

}  // namespace

// normalize: 0 for the raw key words, 1 for keys reduced into [1, n-1].
extern "C" int vk_mt19937(const uint32_t* seeds, uint32_t* out, long long n, int normalize,
                          void* stream) {
    const int threads = 256;
    const long long blocks = (n + threads - 1) / threads;
    mt19937_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(seeds, out, n,
                                                                            normalize);
    return VK_LAUNCH_STATUS();
}

extern "C" const char* vk_error_string(int status) {
    return cudaGetErrorString((cudaError_t)status);
}
