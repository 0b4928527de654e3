// The PRNG keygens of the numeric transforms, one thread per seed: the four
// LCGs (vuke_tpu/cores/lcg.py), the four xorshift generators
// (vuke_tpu/cores/xorshift.py) and MT19937-64 (vuke_tpu/cores/mt19937.py).
//
// Replaces no Pallas kernel: vuke_tpu/transforms/numeric.py::make_lcg,
// make_xorshift and _mt64 are jnp code that XLA fuses; here each transform
// is one launch that writes all of its slots.  Output: (S, 8, N) big-endian
// key words, slot s word j of lane i at out[(s * 8 + j) * N + i]; with
// variant -1 the S slots are the family's variants in the reference's order.
//   lcg: 8 outputs of next = (a * state + c) mod m from the raw u32 seed (lo),
//       each a key word, byteswapped when little-endian; minstd's product
//       mod 2^31 - 1 folds twice and keeps 0 canonical;
//   xorshift: xorshift64 (a zero seed becomes 1; 4 outputs, high word
//       first), xorshift128 (32-bit lanes from the seed's halves; 8
//       outputs), xorshift128+ and xoroshiro128** (state from two splitmix64
//       steps; 4 outputs, high word first);
//   mt64: MT19937-64 seeded with the u64 seed; its first 4 outputs
//       serialized little-endian.
// Every u64 is native: the reference carries them as uint32 pairs.  The
// generators are prng.cuh's, which the sweep kernel S1 (sweep_prng.cu) shares.
//
// Bound: the ALU and FMA pipes (MT19937-64's 159 init steps are a u64
// multiply each; the rest are a few dozen operations a slot) against the
// seed's 8 bytes read (4 for an LCG, which reads lo alone) and 32 written
// a slot (vuke_tpu_torch/kernels/work.py::keygen_prng).  MT19937-64 runs its init as a recurrence in one register
// pair and keeps the 9 state words its four outputs read (indices 0..4 and
// 156..159), not a 312-word state.  family, variant and endian are uniform
// across a launch, so no branch diverges.

#include <cuda_runtime.h>
#include <cstdint>

#include "keygen.cuh"
#include "prng.cuh"

namespace {

using namespace vk::kg;
using namespace vk::prng;

enum Family { kLcg = 0, kXorshift = 1, kMt64 = 2 };

__global__ void __launch_bounds__(256)
keygen_prng_kernel(const uint32_t* __restrict__ hi_in, const uint32_t* __restrict__ lo_in,
                   int family, int variant, int slots, int big_endian,
                   uint32_t* __restrict__ out, long long n) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const uint32_t lo = lo_in[i];
    const uint32_t hi = family == kLcg ? 0u : hi_in[i];    // an LCG reads the low word alone
    uint32_t key[8];
    for (int s = 0; s < slots; s++) {
        const int v = variant < 0 ? s : variant;
        if (family == kLcg) {
            lcg_key(lo, v, big_endian, key);
        } else if (family == kXorshift) {
            Xorshift g;
            g.init(hi, lo, v);
            g.next_key(key);
        } else {
            mt64_key(((uint64_t)hi << 32) | lo, 0, key);
        }
        store_key(out, n, i, s, key);
    }
}

}  // namespace

// family: 0 lcg, 1 xorshift, 2 mt64; variant: the family's variant, or -1
// for each in turn over the slots; out: (slots, 8, n).
extern "C" int vk_keygen_prng(const uint32_t* hi, const uint32_t* lo, int family, int variant,
                              int slots, int big_endian, uint32_t* out, long long n,
                              void* stream) {
    if (family < kLcg || family > kMt64 || variant < -1 || variant > 3 || slots < 1)
        return (int)cudaErrorInvalidValue;
    const int threads = 256;
    const long long blocks = (n + threads - 1) / threads;
    keygen_prng_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        hi, lo, family, variant, slots, big_endian, out, n);
    return VK_LAUNCH_STATUS();
}
