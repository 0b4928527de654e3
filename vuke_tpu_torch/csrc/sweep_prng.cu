// S1: the reverse sweep of the PRNG families, one thread a seed: keystream
// and compare fused, one small record a batch.
//
// Replaces the jitted step of vuke_tpu/analyze/sweeps.py::SweepProgram
// (:79-136) with its keystreams: milksad (MT19937; the Pallas kernel K1
// _mt_kernel, vuke_tpu/cores/pallas_kernels.py:46, for one key, XLA for
// more), mt64 (vuke_tpu/analyze/analyzers.py:160), the four LCGs
// (vuke_tpu/cores/lcg.py:67) and the four xorshift generators
// (vuke_tpu/cores/xorshift.py:41-148).  Lane i of a batch takes the seed
// (start_hi, start_lo) + i with the carry into the high word
// (sweeps.py::_seed_lattice); lanes i >= limit do nothing.  Per lane:
//   exact:   key 0 == the 8 target words;
//   mask:    key 0 passes target 0 (sweep.cuh::mask_eq);
//   cascade: key j passes target j for every j, keys taken in turn from the
//            seed's stream; the lane stops at the first that fails.
// milksad and the LCGs read the low seed word alone.  The keys are the raw
// keystream words: no reduction mod n (K1's normalize epilogue is off).
//
// Output: the batch record (sweep.cuh): the least lane index with a hit,
// which is the JAX step's argmax of the flat `ok`, and, with `track`, the
// count of lanes that pass target 0 (the JAX step's first_filter_hits).
//
// Bound: operations.  A lane reads nothing and the batch writes 16 bytes;
// milksad's 405 dependent init steps (mt64's 160 u64 ones) are the work.
// The key stays in registers: a keygen kernel would write 32 bytes a key,
// 137 GB for one 2^32 milksad sweep.  A cascade lane that fails target 0
// (all but 2^-(bits-1) of them) computes no further key, so MT19937 and
// MT19937-64 recompute a further key from the seed (prng.cuh, `base`)
// rather than keep the stream's state.  family, variant, mode and the
// targets are uniform across a launch, so only the rare pass diverges.

#include <cuda_runtime.h>
#include <cstdint>

#include "prng.cuh"
#include "sweep.cuh"

namespace {

using namespace vk::prng;
using namespace vk::sweep;

enum Family { kMilksad = 0, kMt64 = 1, kLcg = 2, kXorshift = 3 };

// The lane's verdict: `next(key)` yields the stream's keys in turn.
// `first` is set to whether key 0 passes target 0 (mask and cascade).
template <class Next>
__device__ __forceinline__ bool lane_hit(Next next, int mode, int n_targets, const Targets& t,
                                         bool& first) {
    uint32_t key[8];
    next(key);
    if (mode == kExact) return exact_eq(key, t.w);
    bool ok = mask_eq(key, t.w);
    first = ok;
    for (int j = 1; ok && j < n_targets; j++) {
        next(key);
        ok = mask_eq(key, t.w + 6 * j);
    }
    return ok;
}

__global__ void __launch_bounds__(256)
sweep_prng_kernel(uint32_t start_hi, uint32_t start_lo, long long limit, int family,
                  int variant, int big_endian, int mode, int n_targets, int track,
                  const __grid_constant__ Targets t, unsigned long long* __restrict__ rec) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    bool hit = false, first = false;
    if (i < limit) {
        const uint32_t off = (uint32_t)i;
        const uint32_t lo = start_lo + off;
        const uint32_t hi = start_hi + (lo < off ? 1u : 0u);
        switch (family) {
            case kMilksad: {
                uint32_t base = 0;
                hit = lane_hit([&](uint32_t k[8]) { mt19937_key(lo, base, k); base += 8; },
                               mode, n_targets, t, first);
                break;
            }
            case kMt64: {
                const uint64_t seed = ((uint64_t)hi << 32) | lo;
                uint32_t base = 0;
                hit = lane_hit([&](uint32_t k[8]) { mt64_key(seed, base, k); base += 4; },
                               mode, n_targets, t, first);
                break;
            }
            case kLcg:
                hit = lane_hit([&](uint32_t k[8]) { lcg_key(lo, variant, big_endian, k); },
                               mode, n_targets, t, first);
                break;
            default: {
                Xorshift g;
                g.init(hi, lo, variant);
                hit = lane_hit([&](uint32_t k[8]) { g.next_key(k); }, mode, n_targets, t, first);
            }
        }
    }
    record_first(hit, (unsigned long long)i, rec);
    if (track) {
        const int n = __syncthreads_count(first);
        if (threadIdx.x == 0 && n) atomicAdd(rec + 1, (unsigned long long)n);
    }
}

}  // namespace

// family: 0 milksad, 1 mt64, 2 lcg, 3 xorshift; variant: the LCG's or the
// xorshift generator's; mode: 0 exact, 1 mask, 2 cascade over n_targets;
// targets: a host array of 6 x 28 words (sweep.cuh); rec: 2 device u64.
// The batch's lanes are 0..limit-1, limit at most 2^32.
extern "C" int vk_sweep_prng(uint32_t start_hi, uint32_t start_lo, long long limit, int family,
                             int variant, int big_endian, int mode, int n_targets, int track,
                             const uint32_t* targets, unsigned long long* rec, void* stream) {
    if (family < kMilksad || family > kXorshift || variant < 0 || variant > 3 || mode < kExact ||
        mode > kCascade || n_targets < 1 || n_targets > kMaxTargets || limit < 0 ||
        limit > 0x100000000ll || (family == kLcg && mode == kCascade))
        return (int)cudaErrorInvalidValue;
    const cudaStream_t s = (cudaStream_t)stream;
    int status = reset_record(rec, s);
    if (status != 0 || limit == 0) return status;
    Targets t;
    for (int k = 0; k < 6 * kMaxTargets; k++) t.w[k] = targets[k];
    const int threads = 256;
    const long long blocks = (limit + threads - 1) / threads;
    sweep_prng_kernel<<<(unsigned)blocks, threads, 0, s>>>(start_hi, start_lo, limit, family,
                                                           variant, big_endian, mode, n_targets,
                                                           track, t, rec);
    return (int)cudaGetLastError();
}
