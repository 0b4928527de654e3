// Scalars reduced into [1, n-1], one thread per lane: the normalize step of
// the derive (ecc/scalar.py::normalize_words) as one launch.
//
// Replaces no Pallas kernel: vuke_tpu/ecc/tiled.py::_normalize_words_t is
// XLA glue, one fusion inside the JAX package's jit, where the port's torch
// version is about 118 eager launches.  Same function as K1's epilogue
// (scalar.cuh), for key words that do not come from K1: the scan's
// superbatches (K1's raw words, direct:be's words) and pubkey.normalize_scalar.
//
// Bound: bytes.  32 bytes read and 32 written per lane against 22 operations;
// loads and stores are coalesced (thread i <-> lane i of each word row).
//
// Input and output: (8, N) big-endian words; out may alias in.

#include <cuda_runtime.h>
#include <cstdint>

#include "scalar.cuh"
#include "secp256k1.cuh"

namespace {

__global__ void __launch_bounds__(256)
normalize_kernel(const uint32_t* in, uint32_t* out, long long n) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    uint32_t w[8];
#pragma unroll
    for (int j = 0; j < 8; j++) w[j] = in[j * n + i];
    vk::scalar_normalize_be(w);
#pragma unroll
    for (int j = 0; j < 8; j++) out[j * n + i] = w[j];
}

}  // namespace

extern "C" int vk_normalize(const uint32_t* in, uint32_t* out, long long n, void* stream) {
    const int threads = 256;
    const long long blocks = (n + threads - 1) / threads;
    normalize_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(in, out, n);
    return VK_LAUNCH_STATUS();
}
