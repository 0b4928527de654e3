// K4: Montgomery batch inversion + affine conversion, in one kernel.
//
// Replaces vuke_tpu/ecc/pallas_inv.py::_fwd_kernel, _fermat_kernel and
// _bwd_kernel.  Those carry one running prefix product across an ORDERED
// TPU grid, then invert the grand product once.  CUDA blocks run in no
// order, so the batching is per thread instead: with T = N / M threads,
// thread t owns the M lanes t, t + T, ..., t + (M-1)T (neighbouring
// threads read neighbouring addresses, so every load coalesces).  Each
// thread forms T_j = ZZ_j * ZZZ_j and its prefix products, inverts its own
// total by Fermat (the addition chain of tiled._fe_inv_rows, 255 S + 15 M),
// and walks back: iT_j = inv * prefix_j, x = X * iT * ZZZ,
// y = Y * iT * ZZ, both made canonical (< p).  Canonical values do not
// depend on how the products were grouped, so x and y are bit-identical to
// the JAX path's.
//
// Bound: integer multiplies.  Per lane ~9 field products plus the chain's
// 270 / M, of which 255 are squarings (36 multiplies each, not 64).  Held
// in registers (both loops unrolled at compile-time indices), the prefix
// and the loads ptxas hoisted across the unrolled iterations took 164-255
// registers, two blocks an SM, and ran slower (PERF.md).  So the prefix
// products wait in shared memory (M * 32 bytes a thread, [j][half][thread]
// for conflict-free 16-byte accesses), the loops stay rolled, and the
// registers hold the inversion chain: 88 of them.
// M = 16: of m = 4, 8, 16 and 32 it measured fastest (PERF.md); smaller M
// means more threads to hide the products' latency but more Fermat chains
// per lane.  The wrapper's ecc/inv.py::CHUNK is the same M.
//
// Output: x, y as (8, N) big-endian words, what K2 reads.

#include <cuda_runtime.h>
#include <cstdint>

#include "secp256k1.cuh"

using namespace vk;

namespace {

constexpr int M = 16;               // lanes per chain (per thread)
constexpr int kThreads = 64;        // M * 32 bytes of shared memory each, 32 KiB a block

// x, made opaque to the optimizer, so that the addresses computed from it
// are computed where they are used and not carried from one iteration to
// the next (or across the inversion) in registers.
__device__ __forceinline__ long long opaque(long long x) {
    asm volatile("" : "+l"(x));
    return x;
}

__global__ void __launch_bounds__(kThreads)
inv_affine_kernel(const uint32_t* __restrict__ X, const uint32_t* __restrict__ Y,
                  const uint32_t* __restrict__ ZZ, const uint32_t* __restrict__ ZZZ,
                  uint32_t* __restrict__ x_out, uint32_t* __restrict__ y_out,
                  long long n) {
    const long long chains = n / M;
    long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= chains) return;

    // prefix[j] = T_0 .. T_{j-1} (prefix[0] = 1 is implied, never stored)
    __shared__ __align__(16) uint4 prefix[M][2][kThreads];
    const int tid = threadIdx.x;
    Fe acc, zz, zzz, prod;
#pragma unroll 1
    for (int j = 0; j < M; j++) {
        const long long lane = opaque(j * chains + t), stride = opaque(n);
        fe_load_le(zz, ZZ, stride, lane);
        fe_load_le(zzz, ZZZ, stride, lane);
        if (j == 0) {
            fe_mul(acc, zz, zzz);
        } else {
            fe_mul(prod, zz, zzz);
            prefix[j][0][tid] = make_uint4(acc.v[0], acc.v[1], acc.v[2], acc.v[3]);
            prefix[j][1][tid] = make_uint4(acc.v[4], acc.v[5], acc.v[6], acc.v[7]);
            fe_mul(acc, acc, prod);
        }
    }
    Fe inv;
    fe_inv(inv, acc);                // 1 / (T_0 .. T_{M-1})
#pragma unroll 1
    for (int j = M - 1; j >= 0; j--) {
        const long long lane = opaque(j * chains + t), stride = opaque(n);
        fe_load_le(zz, ZZ, stride, lane);
        fe_load_le(zzz, ZZZ, stride, lane);
        Fe it, p;
        if (j == 0) {
            it = inv;                // 1 / T_0
        } else {
            const uint4 lo = prefix[j][0][tid], hi = prefix[j][1][tid];
            Fe pre = {{lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w}};
            fe_mul(it, inv, pre);        // 1 / T_j
            fe_mul(prod, zz, zzz);
            fe_mul(inv, inv, prod);      // 1 / (T_0 .. T_{j-1})
        }
        fe_load_le(p, X, stride, lane);
        fe_mul(p, p, it);
        fe_mul(p, p, zzz);           // X / ZZ
        fe_canon(p);
        fe_store_be(x_out, stride, lane, p);
        fe_load_le(p, Y, stride, lane);
        fe_mul(p, p, it);
        fe_mul(p, p, zz);            // Y / ZZZ
        fe_canon(p);
        fe_store_be(y_out, stride, lane, p);
    }
}

}  // namespace

// m: lanes per chain, which must be the kernel's M = 16; n a multiple of it.
extern "C" int vk_inv_affine(const uint32_t* X, const uint32_t* Y, const uint32_t* ZZ,
                             const uint32_t* ZZZ, uint32_t* x, uint32_t* y,
                             long long n, int m, void* stream) {
    if (m != M || n % M != 0) return (int)cudaErrorInvalidValue;
    const long long blocks = (n / M + kThreads - 1) / kThreads;
    inv_affine_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        X, Y, ZZ, ZZZ, x, y, n);
    return VK_LAUNCH_STATUS();
}
