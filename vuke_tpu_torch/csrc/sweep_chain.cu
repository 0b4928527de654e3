// S2: the reverse sweep of the sha256_chain variants, one thread a u32
// seed: the chain and the compare fused, one small record a batch.
//
// Replaces the jitted step of vuke_tpu/analyze/sweeps.py::ChainSweepProgram
// (:139-191) with vuke_tpu/cores/sha256_chain.py::chain_words (:74), which
// XLA compiles; no Pallas kernel.  Lane i hashes the seed start_lo + i (u32,
// wrapping) as its 4 big-endian bytes:
//   iterated:   k_0 = SHA256(seed), k_d = SHA256(k_{d-1});
//   indexed:be: k_d = SHA256(seed || d as 4 BE bytes);
//   indexed:le: k_d = SHA256(seed || d as 4 LE bytes);
//   counter:    k_d = SHA256(seed || decimal ASCII of d).
// exact and mask check positions 0..depth-1 in turn and the lane's hit is
// its first passing position, index i * depth + d; cascade checks position
// j against target j for every j (depth = the number of targets) and the
// hit's index is i.  The record (sweep.cuh) keeps the batch's least index,
// which is the JAX step's argmax of the flat (N, depth) `ok`.
//
// Bound: operations, one SHA-256 compression a position (the SHA-256 code
// of keygen.cuh, which keygen_chain.cu and the string digests share); a
// lane reads nothing and the batch writes 16 bytes.  Nothing but the
// record leaves the registers: the keygen kernel would write 32 bytes a
// position, 1.4 TB for one 2^32 x depth 10 sweep.  A lane stops at its
// first hit or, in a cascade, at its first failed target.

#include <cuda_runtime.h>
#include <cstdint>

#include "keygen.cuh"
#include "sweep.cuh"

namespace {

using namespace vk::kg;
using namespace vk::sweep;

enum Variant { kIterated = 0, kIndexedBe = 1, kIndexedLe = 2, kCounter = 3 };

// Key d of variant v over the seed, in place: `key` holds key d - 1 on
// entry (read by iterated only).
__device__ __forceinline__ void chain_key(uint32_t seed, int v, uint32_t d, uint32_t key[8]) {
    if (v == kIterated && d > 0) {
        sha256_of_key(key);
        return;
    }
    uint32_t m[14];
#pragma unroll
    for (int j = 0; j < 14; j++) m[j] = 0u;
    m[0] = seed;
    uint32_t len = 4;
    if (v == kCounter) {
        uint32_t c[2];
        len += small_decimal_words(d, c);
        m[1] = c[0];
        m[2] = c[1];
    } else if (v != kIterated) {
        m[1] = v == kIndexedBe ? d : bswap(d);
        len = 8;
    }
    sha256_msg(m, len, key);
}

__global__ void __launch_bounds__(256)
sweep_chain_kernel(uint32_t start_lo, long long limit, int variant, int depth, int mode,
                   int n_targets, const __grid_constant__ Target0 t0,
                   const uint32_t* __restrict__ targets, unsigned long long* __restrict__ rec) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    bool hit = false;
    unsigned long long idx = 0;
    if (i < limit) {
        const uint32_t seed = start_lo + (uint32_t)i;
        uint32_t key[8];
        if (mode == kCascade) {
            chain_key(seed, variant, 0u, key);
            hit = mask_eq(key, t0.w);
            for (int j = 1; hit && j < n_targets; j++) {
                chain_key(seed, variant, (uint32_t)j, key);
                hit = mask_eq_at(key, targets, j);
            }
            idx = (unsigned long long)i;
        } else {
            for (int d = 0; d < depth; d++) {
                chain_key(seed, variant, (uint32_t)d, key);
                if (mode == kExact ? exact_eq(key, t0.w) : mask_eq(key, t0.w)) {
                    hit = true;
                    idx = (unsigned long long)i * depth + d;
                    break;
                }
            }
        }
    }
    record_first(hit, idx, rec);
}

}  // namespace

// variant: 0 iterated, 1 indexed:be, 2 indexed:le, 3 counter; depth below
// 10^8 (exact and mask); mode: 0 exact, 1 mask, 2 cascade over n_targets
// positions; target0: a host array of 8 words (sweep.cuh); targets: a
// device array of 6 words a target, all n_targets of them (mask and
// cascade); rec: 2 device u64.  The batch's lanes are 0..limit-1, limit at
// most 2^32.
extern "C" int vk_sweep_chain(uint32_t start_lo, long long limit, int variant, int depth,
                              int mode, int n_targets, const uint32_t* target0,
                              const uint32_t* targets, unsigned long long* rec, void* stream) {
    if (variant < kIterated || variant > kCounter || depth < 1 || depth >= 100000000 ||
        mode < kExact || mode > kCascade || n_targets < 1 ||
        (mode != kCascade && n_targets != 1) || limit < 0 || limit > 0x100000000ll ||
        (mode != kExact && targets == nullptr))
        return (int)cudaErrorInvalidValue;
    const cudaStream_t s = (cudaStream_t)stream;
    int status = reset_record(rec, s);
    if (status != 0 || limit == 0) return status;
    const int threads = 256;
    const long long blocks = (limit + threads - 1) / threads;
    sweep_chain_kernel<<<(unsigned)blocks, threads, 0, s>>>(start_lo, limit, variant, depth,
                                                            mode, n_targets,
                                                            load_target0(target0), targets, rec);
    return (int)cudaGetLastError();
}
