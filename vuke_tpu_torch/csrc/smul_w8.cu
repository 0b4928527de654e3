// K6: fixed-base scalar multiplication k*G over byte windows, one thread
// per lane.
//
// Replaces vuke_tpu/ecc/pallas_smul.py::_smul_kernel (32 unsigned 8-bit
// windows, table d * 2^(8w) * G).  Input: normalized scalars in [1, n-1] as
// (8, N) big-endian words.  The byte digits are peeled off the scalar in
// registers, lowest first, just before each window's addition, so no
// digits tensor exists in memory.  A zero digit skips its window; the first
// non-zero digit loads its table point with ZZ = ZZZ = 1 (the TPU kernel's
// acc_inf select: zero low bytes are common, so window 0 cannot seed the
// accumulator as it does in K3); every later non-zero digit is one mixed
// addition (8M + 2S, secp256k1.cuh madd).  The digits are unsigned, so no
// negation.  For k in [1, n-1] the accumulator after w windows is
// (k mod 2^(8w)) * G, never +-d * 2^(8w) * G, so madd's missing doubling
// branch is never needed.
//
// Bound: integer multiply throughput.  ~31 * 10 field products of 64
// IMAD.WIDE each, against one 64-byte table row per non-zero window.  The
// table is (32, 256, 16) u32 = 512 KiB and stays resident in the 50 MB L2.
// The TPU kernel looked entries up with 8 per-sublane one-hot f32 matrix
// products because its vector unit has no per-lane gather; a thread here
// loads its row with four 16-byte loads.  The window loop is not unrolled,
// to keep the code and register count small.  A lane whose digit is 0
// idles through its warp's addition: 1 window in 256 on random scalars.
//
// Output: X, Y, ZZ, ZZZ as (8, N) little-endian limbs below 2^256, equal
// mod p to the TPU kernel's (the representatives may differ).

#include <cuda_runtime.h>
#include <cstdint>

#include "secp256k1.cuh"

using namespace vk;

namespace {

constexpr int kWindows = 32;
constexpr int kTsize = 256;

__global__ void __launch_bounds__(128)
smul_w8_kernel(const uint32_t* __restrict__ words, const uint4* __restrict__ table,
               uint32_t* __restrict__ X_out, uint32_t* __restrict__ Y_out,
               uint32_t* __restrict__ ZZ_out, uint32_t* __restrict__ ZZZ_out,
               long long n) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;

    uint32_t k[8];                   // little-endian limbs, shifted down a byte per window
#pragma unroll
    for (int j = 0; j < 8; j++) k[j] = words[(7 - j) * n + i];

    Fe X, Y, ZZ, ZZZ, x2, y2;
    fe_set_small(X, 0);              // k = 0 (never after normalization) leaves zeros,
    fe_set_small(Y, 0);              // as the TPU kernel does
    fe_set_small(ZZ, 0);
    fe_set_small(ZZZ, 0);
    bool inf = true;
#pragma unroll 1
    for (int w = 0; w < kWindows; w++) {
        uint32_t d = k[0] & 0xFFu;
#pragma unroll
        for (int j = 0; j < 7; j++) k[j] = (k[j] >> 8) | (k[j + 1] << 24);
        k[7] >>= 8;
        if (d == 0) continue;
        load_xy(table + ((size_t)w * kTsize + d) * 4, x2, y2);
        if (inf) {
            X = x2;
            Y = y2;
            fe_set_small(ZZ, 1);
            fe_set_small(ZZZ, 1);
            inf = false;
        } else {
            madd(X, Y, ZZ, ZZZ, x2, y2);
        }
    }
    fe_store_le(X_out, n, i, X);
    fe_store_le(Y_out, n, i, Y);
    fe_store_le(ZZ_out, n, i, ZZ);
    fe_store_le(ZZZ_out, n, i, ZZZ);
}

}  // namespace

extern "C" int vk_smul_w8(const uint32_t* words, const uint32_t* table, uint32_t* X,
                          uint32_t* Y, uint32_t* ZZ, uint32_t* ZZZ, long long n,
                          void* stream) {
    const int threads = 128;
    const long long blocks = (n + threads - 1) / threads;
    smul_w8_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        words, reinterpret_cast<const uint4*>(table), X, Y, ZZ, ZZZ, n);
    return VK_LAUNCH_STATUS();
}
