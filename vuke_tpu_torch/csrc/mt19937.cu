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
// computes exactly what _mt_kernel computes.  The recurrence itself is
// prng.cuh::mt19937_key, which the sweep kernel S1 (sweep_prng.cu) shares.
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

#include "prng.cuh"
#include "scalar.cuh"
#include "secp256k1.cuh"

namespace {

__global__ void __launch_bounds__(256)
mt19937_kernel(const uint32_t* __restrict__ seeds, uint32_t* __restrict__ out,
               long long n, int normalize) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    uint32_t key[8];
    vk::prng::mt19937_key(seeds[i], 0, key);       // prng.cuh: the first key of the stream
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
