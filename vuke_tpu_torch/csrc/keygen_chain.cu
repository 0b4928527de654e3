// The sha256_chain keygen, one thread per seed: every slot of the
// transform in one launch.
//
// Replaces no Pallas kernel: vuke_tpu/transforms/numeric.py::
// make_sha256_chain (with _string_seed_chain and _append_const_bytes) and
// vuke_tpu/cores/sha256_chain.py are jnp code that XLA fuses.  For each
// variant in turn (iterated, indexed:be, indexed:le, counter, or the one
// asked for), `depth` keys from the seed's decimal string; then the same
// variants again from the seed's low word as 4 BE bytes (the reference
// emits that half only for seeds below 2^32; its validity is the caller's):
//   iterated:   k_0 = SHA256(seed), k_d = SHA256(k_{d-1});
//   indexed:be: k_d = SHA256(seed || d as 4 BE bytes);
//   indexed:le: k_d = SHA256(seed || d as 4 LE bytes);
//   counter:    k_d = SHA256(seed || decimal ASCII of d).
// The seed's string has a per-lane length, so the appended bytes land at a
// per-lane offset (keygen.cuh::append_words).  Output: (S, 8, N) BE key
// words with S = 2 x variants x depth, slot s word j of lane i at
// out[(s * 8 + j) * N + i].
//
// Bound: the ALU pipe, one SHA-256 compression a slot (80 at the default
// depth of 10 over all four variants), against 8 bytes read and 32 written a
// slot (vuke_tpu_torch/kernels/work.py::keygen_chain).  One message, one
// schedule and one state are live at a time; the variant is uniform across
// the launch, so no branch diverges.

#include <cuda_runtime.h>
#include <cstdint>

#include "keygen.cuh"

namespace {

using namespace vk::kg;

enum Variant { kIterated = 0, kIndexedBe = 1, kIndexedLe = 2, kCounter = 3 };

// The `depth` keys of variant v over the seed message base[0..4] (BE words,
// blen bytes), stored from slot `slot` on.
__device__ __forceinline__ void chain(const uint32_t base[5], uint32_t blen, int v, int depth,
                                      uint32_t* out, long long n, long long i, int slot) {
    uint32_t key[8];
    for (int d = 0; d < depth; d++) {
        uint32_t m[14];
        uint32_t len;
        if (v == kIterated && d > 0) {
#pragma unroll
            for (int j = 0; j < 14; j++) m[j] = j < 8 ? key[j] : 0u;
            len = 32;
        } else {
#pragma unroll
            for (int j = 0; j < 14; j++) m[j] = j < 5 ? base[j] : 0u;
            len = blen;
            if (v != kIterated) {
                uint32_t c[2];
                int nb;
                if (v == kCounter) {
                    nb = (int)small_decimal_words((uint32_t)d, c);
                } else {
                    c[0] = v == kIndexedBe ? (uint32_t)d : bswap((uint32_t)d);
                    c[1] = 0;
                    nb = 4;
                }
                append_words(m, len, c, (nb + 3) >> 2);
                len += nb;
            }
        }
        sha256_msg(m, len, key);
        store_key(out, n, i, slot + d, key);
    }
}

__global__ void __launch_bounds__(256)
keygen_chain_kernel(const uint32_t* __restrict__ hi_in, const uint32_t* __restrict__ lo_in,
                    int variant, int depth, uint32_t* __restrict__ out, long long n) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const uint32_t hi = hi_in[i], lo = lo_in[i];
    const int variants = variant < 0 ? 4 : 1;
    uint32_t base[5];
    const uint32_t len = decimal_words(hi, lo, base);
    for (int k = 0; k < variants; k++)
        chain(base, len, variant < 0 ? k : variant, depth, out, n, i, k * depth);
    const uint32_t bin[5] = {lo, 0u, 0u, 0u, 0u};
    for (int k = 0; k < variants; k++)
        chain(bin, 4, variant < 0 ? k : variant, depth, out, n, i, (variants + k) * depth);
}

}  // namespace

// variant: 0 iterated, 1 indexed:be, 2 indexed:le, 3 counter, or -1 for all
// four; depth below 10^8; out: (2 x variants x depth, 8, n).
extern "C" int vk_keygen_chain(const uint32_t* hi, const uint32_t* lo, int variant, int depth,
                               uint32_t* out, long long n, void* stream) {
    if (variant < -1 || variant > kCounter || depth < 1 || depth >= 100000000)
        return (int)cudaErrorInvalidValue;
    const int threads = 256;
    const long long blocks = (n + threads - 1) / threads;
    keygen_chain_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        hi, lo, variant, depth, out, n);
    return VK_LAUNCH_STATUS();
}
