// K3: fixed-base scalar multiplication k*G, one thread per lane.
//
// Replaces vuke_tpu/ecc/pallas_smul13.py::_smul13_kernel (odd digits,
// 10-bit windows).  Input: normalized scalars in [1, n-1] as (8, N)
// big-endian words.  The zero-free odd-digit recoding of
// pallas_smul13.odd_encode_rows runs in the prologue, in registers: an
// even k gains the (odd) group order n, with bit 256 kept as a ninth limb,
// and each window's digit is peeled off just before its addition, so the
// 26 digits never exist in memory.  Window 0 seeds the accumulator from
// its table entry (ZZ = ZZZ = 1); windows 1..25 are unconditional mixed
// additions (8M + 2S, secp256k1.cuh madd).  A negative digit adds -P by
// using p - y.
//
// Bound: integer multiply throughput.  ~25 * 10 field products of 64
// IMAD.WIDE each, against one 64-byte table gather per window.  The table
// is (26, 512, 16) u32 = 0.85 MB: it stays resident in the 50 MB L2, so
// the gathers (4 x 16-byte loads, random rows) cost little next to the
// arithmetic.  The TPU kernel looked entries up with int8 one-hot matrix
// products because its vector unit has no per-lane gather; a thread here
// simply loads its row.  The accumulator (4 field elements), the entry (2)
// and madd's temporaries stay in registers; the window loop is not
// unrolled, to keep the code and register count small.
//
// Output: X, Y, ZZ, ZZZ as (8, N) little-endian limbs below 2^256, equal
// mod p to the TPU kernel's (the representatives may differ).

#include <cuda_runtime.h>
#include <cstdint>

#include "secp256k1.cuh"

using namespace vk;

namespace {

constexpr int kWindows = 26;
constexpr int kWbits = 10;
constexpr int kTsize = 1 << (kWbits - 1);

// group order n, little-endian 32-bit limbs
__device__ __forceinline__ uint32_t n_limb(int j) {
    switch (j) {
        case 0: return 0xD0364141u;
        case 1: return 0xBFD25E8Cu;
        case 2: return 0xAF48A03Bu;
        case 3: return 0xBAAEDCE6u;
        case 4: return 0xFFFFFFFEu;
        default: return 0xFFFFFFFFu;
    }
}

__device__ __forceinline__ void lookup(const uint4* __restrict__ table, int w,
                                       uint32_t idx, bool negate, Fe& x, Fe& y) {
    load_xy(table + ((size_t)w * kTsize + idx) * 4, x, y);
    if (negate) fe_neg(y, y);
}

// Next odd digit of k (9 LE limbs, k odd): d = (k mod 2^11) - 2^10, then
// k = ((k >> 10) & ~1) | 1.  Returns idx = (|d| - 1) / 2; sets *negative.
__device__ __forceinline__ uint32_t next_digit(uint32_t k[9], bool* negative) {
    uint32_t low = k[0] & ((1u << (kWbits + 1)) - 1);
    bool neg = low < (1u << kWbits);
    uint32_t mag = neg ? (1u << kWbits) - low : low - (1u << kWbits);
#pragma unroll
    for (int j = 0; j < 8; j++) k[j] = (k[j] >> kWbits) | (k[j + 1] << (32 - kWbits));
    k[8] >>= kWbits;
    k[0] |= 1u;
    *negative = neg;
    return mag >> 1;
}

__global__ void __launch_bounds__(128)
smul_kernel(const uint32_t* __restrict__ words, const uint4* __restrict__ table,
            uint32_t* __restrict__ X_out, uint32_t* __restrict__ Y_out,
            uint32_t* __restrict__ ZZ_out, uint32_t* __restrict__ ZZZ_out,
            long long n) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;

    uint32_t k[9];
#pragma unroll
    for (int j = 0; j < 8; j++) k[j] = words[(7 - j) * n + i];
    k[8] = 0;
    if ((k[0] & 1u) == 0) {          // even k: k += n (k + n == k mod n)
        uint64_t c = 0;
#pragma unroll
        for (int j = 0; j < 8; j++) {
            c += (uint64_t)k[j] + n_limb(j);
            k[j] = (uint32_t)c;
            c >>= 32;
        }
        k[8] = (uint32_t)c;
    }

    Fe X, Y, ZZ, ZZZ, x2, y2;
    bool neg;
    uint32_t idx = next_digit(k, &neg);
    lookup(table, 0, idx, neg, X, Y);
    fe_set_small(ZZ, 1);
    fe_set_small(ZZZ, 1);
#pragma unroll 1
    for (int w = 1; w < kWindows; w++) {
        if (w < kWindows - 1) {
            idx = next_digit(k, &neg);
        } else {                     // top digit: k < 2^10, odd, positive
            idx = k[0] >> 1;
            neg = false;
        }
        lookup(table, w, idx, neg, x2, y2);
        madd(X, Y, ZZ, ZZZ, x2, y2);
    }
    fe_store_le(X_out, n, i, X);
    fe_store_le(Y_out, n, i, Y);
    fe_store_le(ZZ_out, n, i, ZZ);
    fe_store_le(ZZZ_out, n, i, ZZZ);
}

}  // namespace

extern "C" int vk_smul(const uint32_t* words, const uint32_t* table, uint32_t* X,
                       uint32_t* Y, uint32_t* ZZ, uint32_t* ZZZ, long long n,
                       void* stream) {
    const int threads = 128;
    const long long blocks = (n + threads - 1) / threads;
    smul_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        words, reinterpret_cast<const uint4*>(table), X, Y, ZZ, ZZZ, n);
    return VK_LAUNCH_STATUS();
}
