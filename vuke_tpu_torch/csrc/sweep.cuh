// What the two sweep kernels share (sweep_prng.cu, S1; sweep_chain.cu, S2):
// the targets, the compare of a key with them, and the batch record with
// the first hit.
//
// A sweep's targets stay the same over every batch.  Target 0, the compare
// every lane makes, travels in the launch's parameter space
// (__grid_constant__: read from the constant bank with a lane-uniform
// index, never copied to local memory).  A cascade's further targets, any
// number of them, lie in a read-only device buffer that the wrapper uploads
// once a sweep; only the lanes that pass target 0 read it.  exact mode uses
// words 0..7 of target 0, the key itself; mask and cascade use 6 words a
// target j (at 6j in the buffer, which holds target 0 too): the mask of the
// key's low 64 bits (hi, lo), the high bit or-ed in (hi, lo) and the masked
// target (hi, lo), so a key k passes when ((k6 & m_hi) | h_hi) == t_hi and
// ((k7 & m_lo) | h_lo) == t_lo, as vuke_tpu/analyze/sweeps.py::_mask_compare
// has it.
//
// The record of a batch is two u64: the first hit's index, taken with an
// atomicMin from UINT64_MAX, and the count of lanes that pass target 0
// (the cascade's first filter), taken with one atomicAdd a block.  Both are
// set by the host entry (two memsets) before the launch.
#pragma once

#include <cuda_runtime.h>
#include <cstdint>

namespace vk {
namespace sweep {

constexpr int kExact = 0, kMask = 1, kCascade = 2;

// target 0: the 8 words of an exact key, or a mask target's 6
struct Target0 {
    uint32_t w[8];
};

__device__ __forceinline__ bool exact_eq(const uint32_t key[8], const uint32_t* t) {
    bool ok = true;
#pragma unroll
    for (int j = 0; j < 8; j++) ok &= key[j] == t[j];
    return ok;
}

__device__ __forceinline__ bool mask_eq(const uint32_t key[8], const uint32_t* t) {
    return (((key[6] & t[0]) | t[2]) == t[4]) & (((key[7] & t[1]) | t[3]) == t[5]);
}

// mask_eq against target j of the device buffer
__device__ __forceinline__ bool mask_eq_at(const uint32_t key[8],
                                           const uint32_t* __restrict__ targets, int j) {
    const uint32_t* t = targets + 6 * j;
    return (((key[6] & __ldg(t)) | __ldg(t + 2)) == __ldg(t + 4)) &
           (((key[7] & __ldg(t + 1)) | __ldg(t + 3)) == __ldg(t + 5));
}

// The warp's lowest lane with a hit records its index: lanes are in index
// order, so it is the warp's least.  Every lane of the warp calls this.
__device__ __forceinline__ void record_first(bool hit, unsigned long long idx,
                                             unsigned long long* rec) {
    const unsigned hits = __ballot_sync(0xffffffffu, hit);
    if (hits && (int)(threadIdx.x & 31) == __ffs(hits) - 1) atomicMin(rec, idx);
}

// Host side: target 0 from the host array `targets` (8 words).
inline Target0 load_target0(const uint32_t* targets) {
    Target0 t;
    for (int k = 0; k < 8; k++) t.w[k] = targets[k];
    return t;
}

// Host side: set the record to (UINT64_MAX, 0) on the stream.
inline int reset_record(unsigned long long* rec, cudaStream_t stream) {
    cudaError_t e = cudaMemsetAsync(rec, 0xFF, sizeof(unsigned long long), stream);
    if (e == cudaSuccess) e = cudaMemsetAsync(rec + 1, 0, sizeof(unsigned long long), stream);
    return (int)e;
}

}  // namespace sweep
}  // namespace vk
