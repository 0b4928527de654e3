// Scalars mod the secp256k1 group order n, shared by K1's epilogue
// (mt19937.cu) and the normalize kernel (normalize.cu).
//
// scalar_normalize_be is vuke_tpu/ecc/tiled.py::_normalize_words_t for one
// lane: 8 big-endian words (w[0] most significant) below 2^256 < 2n are
// reduced into [1, n-1] by one conditional subtract of n, and 0 maps to 1.
// Branch-free: the subtract's borrow chain runs on every lane and a select
// keeps its result where there was no borrow out (w >= n): 8 subtracts and
// 14 ALU operations (vuke_tpu_torch/kernels/work.py NORMALIZE).
// Kept apart from secp256k1.cuh, whose PTX text tests/test_torch_field_ptx.py
// interprets.
#pragma once

#include <cstdint>

namespace vk {

__device__ __forceinline__ void scalar_normalize_be(uint32_t w[8]) {
    constexpr uint32_t kN[8] = {0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFEu,
                                0xBAAEDCE6u, 0xAF48A03Bu, 0xBFD25E8Cu, 0xD0364141u};
    uint32_t d[8], borrow = 0;
#pragma unroll
    for (int i = 7; i >= 0; i--) {
        const uint64_t t = (uint64_t)w[i] - kN[i] - borrow;
        d[i] = (uint32_t)t;
        borrow = (uint32_t)(t >> 63);
    }
    uint32_t any = 0;
#pragma unroll
    for (int i = 0; i < 8; i++) {
        w[i] = borrow ? w[i] : d[i];     // w >= n: take w - n
        any |= w[i];
    }
    if (any == 0) w[7] = 1;              // 0 and n both land here
}

}  // namespace vk
