// Field self-test: the library's primitives lane by lane, for the tests.
//
// Not a counterpart of any TPU kernel and on no scan path.  It applies
// secp256k1.cuh's fe_mul, fe_sqr, fe_inv, fe_canon, fe_add and fe_sub to
// (8, N) little-endian limbs a and b (any values below 2^256) and writes
// each result as (8, N) limbs, so that tests/test_torch_cuda.py and
// chip_smoke.py can hold the compiled carry chains against Python integers
// on adversarial operands (ecc/field.py::selftest is the wrapper).

#include <cuda_runtime.h>
#include <cstdint>

#include "secp256k1.cuh"

using namespace vk;

namespace {

__global__ void __launch_bounds__(128)
fe_selftest_kernel(const uint32_t* __restrict__ a_in, const uint32_t* __restrict__ b_in,
                   uint32_t* __restrict__ mul_out, uint32_t* __restrict__ sqr_out,
                   uint32_t* __restrict__ inv_out, uint32_t* __restrict__ canon_out,
                   uint32_t* __restrict__ add_out, uint32_t* __restrict__ sub_out,
                   long long n) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    Fe a, b, r;
    fe_load_le(a, a_in, n, i);
    fe_load_le(b, b_in, n, i);
    fe_mul(r, a, b);
    fe_store_le(mul_out, n, i, r);
    fe_sqr(r, a);
    fe_store_le(sqr_out, n, i, r);
    fe_inv(r, a);
    fe_store_le(inv_out, n, i, r);
    r = a;
    fe_canon(r);
    fe_store_le(canon_out, n, i, r);
    fe_add(r, a, b);
    fe_store_le(add_out, n, i, r);
    fe_sub(r, a, b);
    fe_store_le(sub_out, n, i, r);
}

}  // namespace

extern "C" int vk_fe_selftest(const uint32_t* a, const uint32_t* b, uint32_t* mul,
                              uint32_t* sqr, uint32_t* inv, uint32_t* canon, uint32_t* add,
                              uint32_t* sub, long long n, void* stream) {
    const int threads = 128;
    const long long blocks = (n + threads - 1) / threads;
    fe_selftest_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        a, b, mul, sqr, inv, canon, add, sub, n);
    return VK_LAUNCH_STATUS();
}
