// S1: the reverse sweep of the PRNG families: keystream and compare fused,
// one small record a batch.
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
// Two launch shapes.
//
// milksad, mt64 and xorshift: one thread a seed (sweep_prng_kernel<kFar>).
// Bound: operations; milksad's 405 dependent init steps (mt64's 160 u64
// ones) are the work, so a thread's life is long beside its launch.  A
// cascade runs for any number of targets, as the JAX package's does.
// MT19937 keys 0..27 (outputs up to 223) and MT19937-64 keys 0..38 (outputs
// up to 155) lie inside the init block; a lane that passes all of those
// targets goes on in a separate, never-inlined function that builds the
// whole state and twists it for real (`mt19937_far`, `mt64_far`: the
// generator as rand_mt runs it, so outputs past the block equal
// vuke_tpu/cores/mt19937.py's extension s[k] = s[k-227] ^ twist(s[k-624],
// s[k-623]) and its 64-bit twin).  Only a lane that already passed 28 (39)
// targets calls it, and only the kernel's second instantiation (kFar, which
// the host picks for such cascades alone) holds the call.  A cascade lane
// that fails target 0 (all but 2^-(bits-1) of them) computes no further
// key, so MT19937 and MT19937-64 recompute a further key from the seed
// (prng.cuh, `base`) rather than keep the stream's state.
//
// The LCGs: a grid sized to the card, each thread looping over many seeds
// (sweep_prng_kernel<kVariant, kBigEndian, kExact>).  An LCG key is 8
// multiply-adds, so one thread a seed spent most of a launch retiring and
// launching 65,536 blocks.  Here the grid is two 256-thread blocks an SM
// (no more than the batch needs; more blocks cost more launch than their
// warps hide), and thread t of T takes lanes t, t + T, t + 2T, ...: a
// warp's seeds stay consecutive.  Variant and byte order are template
// parameters, so the loop body holds no uniform branch.  In exact mode a
// lane computes output 1 alone and compares it with target word 0
// (byteswapped once for LE), 16 seeds to a branch, each of the 16 outputs
// kept in its own register and stepped by the same add (the LCGs but
// minstd are affine mod 2^32), so a group's 32 operations are 16
// independent pairs; outputs 2..8 are computed only for the lanes that
// pass, 2^-32 of them.  A thread keeps its first hit (its least index,
// since its indices grow) in a register; after the loop each warp takes
// the least of its lanes' with one reduction and one atomicMin.  With
// `track` (mask mode), each thread counts its passing seeds and the block
// adds them once.  Bound: operations (exact: a lane needs an add and a
// compare, minstd its whole step; kernels/work.py::sweep_prng); the
// launch's own fixed cost is what remains beside them at 2^24 seeds.
//
// Every key stays in registers: a keygen kernel would write 32 bytes a
// key, 137 GB for one 2^32 milksad sweep.  A lane reads nothing and the
// batch writes 16 bytes.  family, variant, mode and the targets are
// uniform across a launch, so only the rare pass diverges.

#include <cuda_runtime.h>
#include <cstdint>

#include "prng.cuh"
#include "sweep.cuh"

namespace {

using namespace vk::prng;
using namespace vk::sweep;

enum Family { kMilksad = 0, kMt64 = 1, kLcg = 2, kXorshift = 3 };

// keys of a stream that the init recurrence alone gives (prng.cuh)
constexpr int kMtInitKeys = 28, kMt64InitKeys = 39;

// The lane's verdict on targets 0..n_targets-1: `next(key)` yields the
// stream's keys in turn.  `first` is set to whether key 0 passes target 0
// (mask and cascade).
template <class Next>
__device__ __forceinline__ bool lane_hit(Next next, int mode, int n_targets, const Target0& t0,
                                         const uint32_t* __restrict__ targets, bool& first) {
    uint32_t key[8];
    next(key);
    if (mode == kExact) return exact_eq(key, t0.w);
    bool ok = mask_eq(key, t0.w);
    first = ok;
    for (int j = 1; ok && j < n_targets; j++) {
        next(key);
        ok = mask_eq_at(key, targets, j);
    }
    return ok;
}

__device__ __forceinline__ uint32_t mt_temper(uint32_t x) {
    x ^= x >> 11;
    x ^= (x << 7) & 0x9D2C5680u;
    x ^= (x << 15) & 0xEFC60000u;
    return x ^ (x >> 18);
}

// Keys j0..n-1 of the MT19937 stream of `seed` against targets j0..n-1,
// from the whole 624-word state, twisted in place as rand_mt twists it:
// output i is the tempered word i % 624 after i / 624 + 1 twists.
__device__ __noinline__ bool mt19937_far(uint32_t seed, int j0, int n,
                                         const uint32_t* __restrict__ targets) {
    uint32_t mt[624];
    mt[0] = seed;
    for (uint32_t k = 1; k < 624; k++) mt[k] = 1812433253u * (mt[k - 1] ^ (mt[k - 1] >> 30)) + k;
    uint32_t twists = 0;
    for (int j = j0; j < n; j++) {
        uint32_t key[8];
        for (int q = 0; q < 8; q++) {
            const uint32_t i = 8u * (uint32_t)j + (uint32_t)q;
            while (twists <= i / 624u) {
                for (int k = 0; k < 624; k++) {
                    const uint32_t y =
                        (mt[k] & 0x80000000u) | (mt[k + 1 < 624 ? k + 1 : 0] & 0x7FFFFFFFu);
                    mt[k] = mt[k + 397 < 624 ? k + 397 : k - 227] ^ (y >> 1) ^
                            ((y & 1u) ? 0x9908B0DFu : 0u);
                }
                twists++;
            }
            key[q] = bswap32(mt_temper(mt[i % 624u]));
        }
        if (!mask_eq_at(key, targets, j)) return false;
    }
    return true;
}

// The same for MT19937-64: keys j0..n-1, 4 outputs each, from the whole
// 312-word state twisted in place.
__device__ __noinline__ bool mt64_far(uint64_t seed, int j0, int n,
                                      const uint32_t* __restrict__ targets) {
    constexpr uint64_t kUpper = 0xFFFFFFFF80000000ull, kLower = 0x7FFFFFFFull;
    uint64_t mt[312];
    mt[0] = seed;
    for (int k = 1; k < 312; k++)
        mt[k] = 6364136223846793005ull * (mt[k - 1] ^ (mt[k - 1] >> 62)) + (uint64_t)k;
    uint32_t twists = 0;
    for (int j = j0; j < n; j++) {
        uint32_t key[8];
        for (int q = 0; q < 4; q++) {
            const uint32_t i = 4u * (uint32_t)j + (uint32_t)q;
            while (twists <= i / 312u) {
                for (int k = 0; k < 312; k++) {
                    const uint64_t y = (mt[k] & kUpper) | (mt[k + 1 < 312 ? k + 1 : 0] & kLower);
                    mt[k] = mt[k + 156 < 312 ? k + 156 : k - 156] ^ (y >> 1) ^
                            ((y & 1) ? 0xB5026F5AA96619E9ull : 0ull);
                }
                twists++;
            }
            uint64_t x = mt[i % 312u];
            x ^= (x >> 29) & 0x5555555555555555ull;
            x ^= (x << 17) & 0x71D67FFFEDA60000ull;
            x ^= (x << 37) & 0xFFF7EEE000000000ull;
            x ^= x >> 43;
            key[2 * q] = bswap32((uint32_t)x);
            key[2 * q + 1] = bswap32((uint32_t)(x >> 32));
        }
        if (!mask_eq_at(key, targets, j)) return false;
    }
    return true;
}

template <bool kFar>
__global__ void __launch_bounds__(256)
sweep_prng_kernel(uint32_t start_hi, uint32_t start_lo, long long limit, int family,
                  int variant, int big_endian, int mode, int n_targets, int track,
                  const __grid_constant__ Target0 t0, const uint32_t* __restrict__ targets,
                  unsigned long long* __restrict__ rec) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    bool hit = false, first = false;
    if (i < limit) {
        const uint32_t off = (uint32_t)i;
        const uint32_t lo = start_lo + off;
        const uint32_t hi = start_hi + (lo < off ? 1u : 0u);
        switch (family) {
            case kMilksad: {
                uint32_t base = 0;
                const int near = kFar && n_targets > kMtInitKeys ? kMtInitKeys : n_targets;
                hit = lane_hit([&](uint32_t k[8]) { mt19937_key(lo, base, k); base += 8; },
                               mode, near, t0, targets, first);
                if (kFar && hit && near < n_targets)
                    hit = mt19937_far(lo, near, n_targets, targets);
                break;
            }
            case kMt64: {
                const uint64_t seed = ((uint64_t)hi << 32) | lo;
                uint32_t base = 0;
                const int near = kFar && n_targets > kMt64InitKeys ? kMt64InitKeys : n_targets;
                hit = lane_hit([&](uint32_t k[8]) { mt64_key(seed, base, k); base += 4; },
                               mode, near, t0, targets, first);
                if (kFar && hit && near < n_targets)
                    hit = mt64_far(seed, near, n_targets, targets);
                break;
            }
            case kLcg:
                // never taken (the LCGs launch the grid kernel below); kept
                // because without it the kernel's loops land at addresses
                // where the mt64 cascade runs 1.5% slower (H100)
                hit = lane_hit([&](uint32_t k[8]) { lcg_key(lo, variant, big_endian, k); },
                               mode, n_targets, t0, targets, first);
                break;
            default: {
                Xorshift g;
                g.init(hi, lo, variant);
                hit = lane_hit([&](uint32_t k[8]) { g.next_key(k); }, mode, n_targets, t0, targets,
                               first);
            }
        }
    }
    record_first(hit, (unsigned long long)i, rec);
    if (track) {
        const int n = __syncthreads_count(first);
        if (threadIdx.x == 0 && n) atomicAdd(rec + 1, (unsigned long long)n);
    }
}

// --- the LCGs: a grid sized to the card, many seeds a thread ---

constexpr int kLcgThreads = 256;
constexpr int kLcgBlocksPerSm = 2;   // resident blocks an SM, at most

// Whether the key of `seed` equals the 8 target words.
template <int kV, bool kBE>
__device__ __forceinline__ bool lcg_exact(uint32_t seed, const Target0& t0) {
    uint32_t key[8];
    lcg_key(seed, kV, kBE, key);
    return exact_eq(key, t0.w);
}

// Output 1 of variant kV as the exact loop compares it with target word 0.
// glibc's, msvc's and borland's are a s + c mod 2^32 for these (a, c),
// glibc's doubled: 2 (a s + c) mod 2^32 is its 31-bit output shifted up one
// bit, so no mask is needed; minstd's (variant 1) is its whole step.
__device__ constexpr uint32_t probe_a(int v) {
    return v == 0 ? 2u * 1103515245u : v == 1 ? 16807u : v == 2 ? 214013u : 22695477u;
}
__device__ constexpr uint32_t probe_c(int v) {
    return v == 0 ? 2u * 12345u : v == 1 ? 0u : v == 2 ? 2531011u : 1u;
}

template <int kV>
__device__ __forceinline__ uint32_t lcg_probe(uint32_t seed) {
    return kV == 1 ? lcg_next(seed, kV) : seed * probe_a(kV) + probe_c(kV);
}

constexpr int kLcgGroup = 16;        // seeds a thread compares before one branch

// Thread t of T takes lanes t + k T, k < n (the header's second shape).
template <int kV, bool kBE, bool kExact>
__global__ void __launch_bounds__(kLcgThreads)
sweep_prng_kernel(uint32_t start_lo, long long limit, int track, const __grid_constant__ Target0 t0,
                  unsigned long long* __restrict__ rec) {
    const uint32_t T = gridDim.x * kLcgThreads;
    const uint32_t t = blockIdx.x * kLcgThreads + threadIdx.x;
    const uint32_t n = t < limit ? (uint32_t)(limit - 1 - t) / T + 1u : 0u;
    uint32_t seed = start_lo + t, k = 0, at = 0, passed = 0;
    bool hit = false;
    if (kExact) {
        // output 1 against target word 0, a group of seeds to a branch; the
        // rest of the key only where one of them passes.  The loops end on
        // their conditions alone (a break costs the warp a reconvergence
        // barrier a group)
        const uint32_t w0 = kBE ? t0.w[0] : bswap32(t0.w[0]);
        const uint32_t want = kV == 0 ? w0 << 1 : w0;
        // glibc's, msvc's and borland's probes are affine mod 2^32: each of
        // the group's 16 is kept apart and stepped by 16 T a, so the
        // group's adds and compares are 16 independent pairs; minstd's
        // (mod 2^31 - 1 of the raw u32 seed) is taken whole each time
        uint32_t probe[kLcgGroup];
#pragma unroll
        for (int j = 0; j < kLcgGroup; j++) probe[j] = lcg_probe<kV>(seed + j * T);
        const uint32_t step = kLcgGroup * T * probe_a(kV);
#pragma unroll 1
        for (; !hit && k + kLcgGroup <= n; k += kLcgGroup, seed += kLcgGroup * T) {
            bool any[4] = {false, false, false, false};
#pragma unroll
            for (int j = 0; j < kLcgGroup; j++) {
                const uint32_t p = kV == 1 ? lcg_probe<kV>(seed + j * T) : probe[j];
                any[j & 3] |= p == want;
                probe[j] += step;
            }
            if (any[0] | any[1] | any[2] | any[3]) {
#pragma unroll 1
                for (int j = kLcgGroup - 1; j >= 0; j--)      // the least passing seed last
                    if (lcg_exact<kV, kBE>(seed + j * T, t0)) {
                        hit = true;
                        at = k + j;
                    }
            }
        }
#pragma unroll 1
        for (; !hit && k < n; k++, seed += T)
            if (lcg_probe<kV>(seed) == want && lcg_exact<kV, kBE>(seed, t0)) {
                hit = true;
                at = k;
            }
    } else {
        for (; k < n; k++, seed += T) {
            uint32_t key[8];
            lcg_key(seed, kV, kBE, key);
            if (mask_eq(key, t0.w)) {
                if (!hit) at = k;
                hit = true;
                passed++;
                if (!track) break;
            }
        }
    }
    // a thread's first hit is its least lane; the warp's least, once
    const unsigned lane = threadIdx.x & 31u, hits = __ballot_sync(0xffffffffu, hit);
    if (hits) {
        const uint32_t least = __reduce_min_sync(0xffffffffu, hit ? t + at * T : 0xffffffffu);
        if (lane == (unsigned)__ffs(hits) - 1u) atomicMin(rec, (unsigned long long)least);
    }
    if (track) {
        __shared__ unsigned block_passed;
        if (threadIdx.x == 0) block_passed = 0;
        __syncthreads();
        const unsigned warp_passed = __reduce_add_sync(0xffffffffu, passed);
        if (lane == 0 && warp_passed) atomicAdd(&block_passed, warp_passed);
        __syncthreads();
        if (threadIdx.x == 0 && block_passed)
            atomicAdd(rec + 1, (unsigned long long)block_passed);
    }
}

// Launch an LCG sweep: kLcgBlocksPerSm blocks an SM, no more than the
// lanes need.
template <int kV, bool kBE, bool kExact>
int lcg_launch(uint32_t start_lo, long long limit, int track, const Target0& t0,
               unsigned long long* rec, cudaStream_t s) {
    int dev = 0, sms = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    const long long need = (limit + kLcgThreads - 1) / kLcgThreads;
    const long long most = (long long)sms * kLcgBlocksPerSm;
    const unsigned blocks = (unsigned)(need < most ? need : most);
    sweep_prng_kernel<kV, kBE, kExact><<<blocks, kLcgThreads, 0, s>>>(start_lo, limit, track, t0,
                                                                       rec);
    return (int)cudaGetLastError();
}

using LcgLaunch = int (*)(uint32_t, long long, int, const Target0&, unsigned long long*,
                          cudaStream_t);

#define VK_LCG_VARIANT(v)                                              \
    {{lcg_launch<v, false, false>, lcg_launch<v, false, true>},        \
     {lcg_launch<v, true, false>, lcg_launch<v, true, true>}}
// [variant][big_endian][exact]
const LcgLaunch kLcgLaunch[4][2][2] = {VK_LCG_VARIANT(0), VK_LCG_VARIANT(1), VK_LCG_VARIANT(2),
                                       VK_LCG_VARIANT(3)};
#undef VK_LCG_VARIANT

}  // namespace

// family: 0 milksad, 1 mt64, 2 lcg, 3 xorshift; variant: the LCG's or the
// xorshift generator's; mode: 0 exact, 1 mask, 2 cascade over n_targets;
// target0: a host array of 8 words (sweep.cuh); targets: a device array of
// 6 words a target, all n_targets of them (mask and cascade); rec: 2
// device u64.  The batch's lanes are 0..limit-1, limit at most 2^32.
extern "C" int vk_sweep_prng(uint32_t start_hi, uint32_t start_lo, long long limit, int family,
                             int variant, int big_endian, int mode, int n_targets, int track,
                             const uint32_t* target0, const uint32_t* targets,
                             unsigned long long* rec, void* stream) {
    if (family < kMilksad || family > kXorshift || variant < 0 || variant > 3 || mode < kExact ||
        mode > kCascade || n_targets < 1 || (mode != kCascade && n_targets != 1) || limit < 0 ||
        limit > 0x100000000ll || (family == kLcg && mode == kCascade) ||
        (mode != kExact && targets == nullptr))
        return (int)cudaErrorInvalidValue;
    const cudaStream_t s = (cudaStream_t)stream;
    int status = reset_record(rec, s);
    if (status != 0 || limit == 0) return status;
    const Target0 t0 = load_target0(target0);
    if (family == kLcg)
        return kLcgLaunch[variant][big_endian != 0][mode == kExact](start_lo, limit, track, t0,
                                                                    rec, s);
    const int threads = 256;
    const unsigned blocks = (unsigned)((limit + threads - 1) / threads);
    const bool far = (family == kMilksad && n_targets > kMtInitKeys) ||
                     (family == kMt64 && n_targets > kMt64InitKeys);
    if (far)
        sweep_prng_kernel<true><<<blocks, threads, 0, s>>>(start_hi, start_lo, limit, family,
                                                           variant, big_endian, mode, n_targets,
                                                           track, t0, targets, rec);
    else
        sweep_prng_kernel<false><<<blocks, threads, 0, s>>>(start_hi, start_lo, limit, family,
                                                            variant, big_endian, mode, n_targets,
                                                            track, t0, targets, rec);
    return (int)cudaGetLastError();
}
