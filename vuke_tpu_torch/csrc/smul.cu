// K3: fixed-base scalar multiplication k*G, one thread per lane.
//
// Replaces vuke_tpu/ecc/pallas_smul13.py::_smul13_kernel (odd digits; the
// TPU kernel's 10-bit windows are 14 bits wide here).  Input: normalized
// scalars in [1, n-1] as (8, N) big-endian words.  The zero-free odd-digit
// recoding of pallas_smul13.odd_encode_rows runs in the prologue, in
// registers: an even k gains the (odd) group order n, with bit 256 kept as
// a ninth limb, and the 19 digits are peeled off it into shared memory (38
// bytes a thread), so the scalar is not live across the window loop (no
// digits tensor exists in device memory).  Window 0 seeds the accumulator
// from its table entry (ZZ = ZZZ = 1); windows 1..18 are unconditional
// mixed additions (8M + 2S, secp256k1.cuh madd).  A negative digit adds -P
// by using p - y.
//
// Bound: integer multiply throughput.  18 additions of 8 products and 2
// squarings (secp256k1.cuh: 128 and 72 32-bit multiply results each)
// against one 64-byte table row per window.  The width trades additions
// for table: 10 bits took 26 windows and a 0.85 MB table; 14 bits take 19
// windows (266 bits, the two spare top bits the recoding of an even k
// needs) and a (19, 8192, 16) u32 table of 9.96 MB.  It stays in the 50 MB
// L2: a launch of 2^19 lanes reads about 10 M rows over its 155,648, about
// 64 reads a row, so the rows come from HBM about once a launch.  The TPU
// kernel looked entries up with int8 one-hot matrix products because its
// vector unit has no per-lane gather; a thread here loads its row.  The
// design is for registers and overlap: the field library runs two carry
// chains per product row; madd keeps at most seven field elements live;
// the digits wait in shared memory, not in registers;
// __launch_bounds__(128, 3) caps the registers where ptxas spills nothing
// (4, 5 or 6 blocks spill, and measured no faster, since the multiply pipe
// and not occupancy is the limit); and the next window's row is copied
// into a per-thread double-buffered 128-byte slot of shared memory with
// cp.async while the current addition runs (its digit does not depend on
// the accumulator), its y half read only where madd needs it; prefetching
// into 16 registers, or not at all, measured slower.  The window loop is
// not unrolled.
//
// The width, swept on an H100 (700 W) at 2^19 lanes, device time, and the
// milksad scan cell end to end: 10 bits 1.981 ms, 182.9 M keys/s; 13 bits
// 1.50 ms, 219.7 M; 14 bits 1.433 ms, 228.1 M; 15 bits 1.375 ms, 233.4 M.
// 15 bits would need a table of 18.9 MB whose host build takes 2.4 s against
// 1.1 s at 14 bits (ecc/smul.py build_table), so the width is 14.  PERF.md
// has the sweeps (of the width and of the design).
//
// Output: X, Y, ZZ, ZZZ as (8, N) little-endian limbs below 2^256, equal
// mod p to the TPU kernel's (the representatives may differ).

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <cstdint>

#include "secp256k1.cuh"

using namespace vk;

namespace {

constexpr int kThreads = 128;
constexpr int kMinBlocks = 3;       // blocks per SM that __launch_bounds__ asks room for
constexpr int kWbits = 14;          // ecc/smul.py's WBITS
constexpr int kWindows = (256 + kWbits - 1) / kWbits;
constexpr int kTsize = 1 << (kWbits - 1);
// k + n < 2^257 needs two spare top bits; idx | negative << 15 needs idx < 2^15
static_assert(kWindows * kWbits >= 258 && kWbits <= 15, "window width out of range");

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

__device__ __forceinline__ const uint4* row_of(const uint4* __restrict__ table, int w,
                                               uint32_t idx) {
    return table + ((size_t)w * kTsize + idx) * 4;
}

// Next odd digit of k (9 LE limbs, k odd): d = (k mod 2^(w+1)) - 2^w, then
// k = ((k >> w) & ~1) | 1, w = kWbits.  Returns idx = (|d| - 1) / 2; sets
// *negative.
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

// A row's x half (quarters 0, 1) or y half (2, 3) out of four 16-byte words.
__device__ __forceinline__ void fe_from(Fe& r, uint4 lo, uint4 hi) {
    r.v[0] = lo.x; r.v[1] = lo.y; r.v[2] = lo.z; r.v[3] = lo.w;
    r.v[4] = hi.x; r.v[5] = hi.y; r.v[6] = hi.z; r.v[7] = hi.w;
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
smul_kernel(const uint32_t* __restrict__ words, const uint4* __restrict__ table,
            uint32_t* __restrict__ X_out, uint32_t* __restrict__ Y_out,
            uint32_t* __restrict__ ZZ_out, uint32_t* __restrict__ ZZZ_out,
            long long n) {
    // The 19 digits, idx | negative << 15, recoded once in the prologue:
    // the scalar's nine limbs are not live across the window loop.
    __shared__ uint16_t digits[kWindows][kThreads];
    const int tid = threadIdx.x;
    long long i = (long long)blockIdx.x * kThreads + tid;
    if (i >= n) return;

    {
        uint32_t k[9];
#pragma unroll
        for (int j = 0; j < 8; j++) k[j] = words[(7 - j) * n + i];
        k[8] = 0;
        if ((k[0] & 1u) == 0) {      // even k: k += n (k + n == k mod n)
            uint64_t c = 0;
#pragma unroll
            for (int j = 0; j < 8; j++) {
                c += (uint64_t)k[j] + n_limb(j);
                k[j] = (uint32_t)c;
                c >>= 32;
            }
            k[8] = (uint32_t)c;
        }
#pragma unroll 1
        for (int w = 0; w < kWindows - 1; w++) {
            bool neg;
            uint32_t idx = next_digit(k, &neg);
            digits[w][tid] = (uint16_t)(idx | (uint32_t)neg << 15);
        }
        digits[kWindows - 1][tid] = (uint16_t)(k[0] >> 1);   // top: k < 2^kWbits, odd, positive
    }

    Fe X, Y, ZZ, ZZZ, x2;
    uint32_t d = digits[0][tid];
    load_xy(row_of(table, 0, d & 0x7FFF), X, Y);
    if (d >> 15) fe_neg(Y, Y);
    fe_set_small(ZZ, 1);
    fe_set_small(ZZZ, 1);
    // Window w + 1's row is copied (cp.async, 16-byte cg copies) into
    // slot[(w + 1) & 1] while window w's addition runs.  slot[buffer]
    // [quarter][thread]: neighbouring threads on neighbouring 16-byte
    // words, so the shared-memory reads have no bank conflicts.
    __shared__ __align__(16) uint4 slot[2][4][kThreads];
    {
        const uint4* row = row_of(table, 1, digits[1][tid] & 0x7FFF);
#pragma unroll
        for (int q = 0; q < 4; q++) __pipeline_memcpy_async(&slot[1][q][tid], row + q, 16);
        __pipeline_commit();
    }
#pragma unroll 1
    for (int w = 1; w < kWindows; w++) {
        d = digits[w][tid];
        __pipeline_wait_prior(0);
        const int b = w & 1;
        fe_from(x2, slot[b][0][tid], slot[b][1][tid]);
        if (w + 1 < kWindows) {
            const uint4* row = row_of(table, w + 1, digits[w + 1][tid] & 0x7FFF);
#pragma unroll
            for (int q = 0; q < 4; q++) __pipeline_memcpy_async(&slot[b ^ 1][q][tid], row + q, 16);
            __pipeline_commit();
        }
        // y2 is read from shared memory only where madd needs it
        madd(X, Y, ZZ, ZZZ, x2, [&](Fe& y) {
            fe_from(y, slot[b][2][tid], slot[b][3][tid]);
            if (d >> 15) fe_neg(y, y);
        });
    }
    // the lane index again, read afresh rather than held across the loop
    uint32_t block;
    asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(block));
    i = (long long)block * kThreads + tid;
    fe_store_le(X_out, n, i, X);
    fe_store_le(Y_out, n, i, Y);
    fe_store_le(ZZ_out, n, i, ZZ);
    fe_store_le(ZZZ_out, n, i, ZZZ);
}

}  // namespace

extern "C" int vk_smul(const uint32_t* words, const uint32_t* table, uint32_t* X,
                       uint32_t* Y, uint32_t* ZZ, uint32_t* ZZZ, long long n,
                       void* stream) {
    const long long blocks = (n + kThreads - 1) / kThreads;
    smul_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        words, reinterpret_cast<const uint4*>(table), X, Y, ZZ, ZZZ, n);
    return VK_LAUNCH_STATUS();
}
