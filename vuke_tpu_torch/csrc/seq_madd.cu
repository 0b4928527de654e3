// K5: the sequential scan's point addition P_i = B + O_i, one thread per lane.
//
// Replaces vuke_tpu/ecc/pallas_inv.py::_seq_madd_kernel.  B = (start-1)*G is
// one affine base point per superbatch; O_i = (i+1)*G is lane i's entry of
// the offset table (ecc/incremental.py).  Affine + affine addition in
// (X, Y, ZZ = Z^2, ZZZ = Z^3) coordinates, 5M + 2S:
//   dx = ox - bx, dy = oy - by, ZZ = dx^2, ZZZ = ZZ * dx,
//   X3 = dy^2 - (ox + bx) * ZZ,  Y3 = dy * (bx * ZZ - X3) - by * ZZZ.
// The caller keeps B != +-O_i (ecc/incremental.sequential_safe).
//
// Bound: bytes.  64 bytes read (ox, oy) and 128 written (X3, Y3, ZZ, ZZZ)
// per lane: 192 B, so ~30 us at 2^19 lanes and 3.35 TB/s, against 7 field
// products (448 32x32-bit multiplies, ~14 us at 64 per SM clock).  One
// thread per lane keeps every load and store coalesced (thread i <-> lane
// i of each (8, N) word row).  The base point arrives by value as a kernel
// argument, where the TPU kernel broadcast it into a (16, 8, 128) VMEM
// block per grid step: no device tensor is uploaded per superbatch, so the
// host never waits on a copy.
//
// Output: (8, N) little-endian limbs below 2^256, equal mod p to the TPU
// kernel's (the representatives may differ); K4 reads them as they are.

#include <cuda_runtime.h>
#include <cstdint>

#include "secp256k1.cuh"

using namespace vk;

namespace {

struct BasePoint {
    Fe x, y;
};

__global__ void __launch_bounds__(128)
seq_madd_kernel(const uint32_t* __restrict__ ox_in, const uint32_t* __restrict__ oy_in,
                const BasePoint b, uint32_t* __restrict__ X_out,
                uint32_t* __restrict__ Y_out, uint32_t* __restrict__ ZZ_out,
                uint32_t* __restrict__ ZZZ_out, long long n) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;

    Fe ox, oy, dx, dy, zz, zzz, t, u;
    fe_load_le(ox, ox_in, n, i);
    fe_load_le(oy, oy_in, n, i);
    fe_sub(dx, ox, b.x);
    fe_sub(dy, oy, b.y);
    fe_sqr(zz, dx);
    fe_mul(zzz, zz, dx);
    fe_add(t, ox, b.x);
    fe_mul(t, t, zz);                // (ox + bx) * ZZ
    fe_sqr(u, dy);
    fe_sub(u, u, t);                 // X3
    fe_mul(t, b.x, zz);
    fe_sub(t, t, u);
    fe_mul(t, dy, t);                // dy * (bx * ZZ - X3)
    fe_mul(ox, b.y, zzz);
    fe_sub(t, t, ox);                // Y3
    fe_store_le(X_out, n, i, u);
    fe_store_le(Y_out, n, i, t);
    fe_store_le(ZZ_out, n, i, zz);
    fe_store_le(ZZZ_out, n, i, zzz);
}

}  // namespace

// base: 16 host words, bx then by, each 8 little-endian limbs below 2^256.
// They are read here, before the launch, and passed to the kernel by value.
extern "C" int vk_seq_madd(const uint32_t* ox, const uint32_t* oy, const uint32_t* base,
                           uint32_t* X, uint32_t* Y, uint32_t* ZZ, uint32_t* ZZZ,
                           long long n, void* stream) {
    BasePoint b;
    for (int j = 0; j < 8; j++) {
        b.x.v[j] = base[j];
        b.y.v[j] = base[8 + j];
    }
    const int threads = 128;
    const long long blocks = (n + threads - 1) / threads;
    seq_madd_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        ox, oy, b, X, Y, ZZ, ZZZ, n);
    return VK_LAUNCH_STATUS();
}
