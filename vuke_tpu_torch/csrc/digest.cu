// D1: SHA-256, SHA-256d and MD5 of M byte strings of any length, and the
// iterated SHA-256 chain of M 32-byte keys.
//
// Replaces no Pallas kernel: it is the card-side counterpart of
// vuke_tpu/transforms/strings.py::batched_digest (XLA: cores/sha256.py::
// sha256_blocks, cores/md5.py::md5_blocks over strings bucketed by block
// count on the host) and of the iterated chain's jax.jit(sha256_key_words)
// loop (strings.py:172-181).  The strings arrive as one packed byte buffer
// (read as LE u32 words, 8 spare bytes past the end) and M + 1 int64
// offsets; the kernel pads each message itself, so nothing is bucketed or
// padded on the host.
//
// Outputs: (M, 8) BE digest words (sha256, sha256d), (M, 4) LE words
// (md5), as batched_digest returns them; the chain writes (depth, M, 8),
// row 0 the keys themselves, row d SHA-256 of row d - 1.
//
// Bound: the ALU pipe, about 1,950 operations a SHA-256 compression and
// ~1,000 an MD5 one, a compression for every 64 bytes of a string plus its
// padding; bytes are the strings once and 16 or 32 a digest
// (vuke_tpu_torch/kernels/work.py::digest).
//
// A block takes 256 strings, whose bytes are one contiguous range of the
// buffer.  Two things kept one thread a string from that bound:
// - Block counts differ between lanes (of strings of 1-64 bytes, 14% take
//   two), so nearly every warp ran two compressions for 1.14 a lane on
//   average.  Here every thread compresses its string's first block; a
//   string with blocks left goes onto a queue in shared memory (its index,
//   next block and state, warp-aggregated: a ballot and one atomicAdd a
//   warp), and the block's threads then take the queue's entries in
//   consecutive threads, one block an entry a round, until it is empty.
//   A warp's lanes thus compress together, whatever the strings' lengths.
// - Each message word was two scattered global loads at the lane's own
//   unaligned offset.  Here the block's range is first staged in a shared
//   tile by coalesced 16-byte loads, and a block's 16 words are 17 loads
//   and 16 byte permutes from it (the SHA-256 byteswap folded in), the
//   padding masks and the length words selects, not branches.  A string
//   whose bytes run past the tile (a long string, or a block whose range
//   exceeds the tile) reads the same words from global memory in the same
//   code.
// The chain neither loads strings nor diverges: one thread a key, no
// shared memory.

#include <cuda_runtime.h>
#include <cstdint>

#include "keygen.cuh"

namespace {

using namespace vk::kg;

enum Mode { kSha256 = 0, kSha256d = 1, kMd5 = 2, kChain = 3 };

constexpr int kThreads = 256;        // strings a block
constexpr int kTileWords = 4096;     // 16 KB of staged string bytes

struct Shared {
    uint32_t tile[kTileWords];                 // first: 16-byte aligned
    uint32_t q_idx[kThreads];                  // the queue: string in the block,
    uint32_t q_blk[kThreads];                  // its next block,
    uint32_t q_s[8][kThreads];                 // its state
    int q_n[2];                                // entries pushed, by round parity
};

__device__ __forceinline__ void store8(uint32_t* __restrict__ out, long long row,
                                       const uint32_t v[8]) {
    uint4* o = reinterpret_cast<uint4*>(out + row * 8);
    o[0] = make_uint4(v[0], v[1], v[2], v[3]);
    o[1] = make_uint4(v[4], v[5], v[6], v[7]);
}

// The 16 message words of one 64-byte block: BE (SHA-256) or LE (MD5).
// base[0] is the word holding the block's first byte, at byte `o` of it;
// `avail` of base's words hold message bytes (nothing past them is read);
// `rem` is the message's bytes from the block's start (>= -8: the last
// block holds the terminator).  One byte permute takes each word out of
// two loaded ones, byteswapped for BE at no cost; two clamped shifts give
// the mask of its message bytes and the 0x80 terminator's bit past them,
// and one three-input logic op merges them, without a branch.
template <bool kBE>
__device__ __forceinline__ void block_words(const uint32_t* base, uint32_t o, int avail, int rem,
                                            uint32_t w[16]) {
    const uint32_t sel = (kBE ? 0x0123u : 0x3210u) + 0x1111u * o;
    uint32_t cur = avail > 0 ? base[0] : 0u;
#pragma unroll
    for (int j = 0; j < 16; j++) {
        const uint32_t next = j + 1 < avail ? base[j + 1] : 0u;
        const uint32_t raw = __byte_perm(cur, next, sel);
        cur = next;
        // the word's message bits, and those up to its terminator's byte
        const int u = 8 * rem - 32 * j;
        const uint32_t s0 = (uint32_t)max(u, 0), s1 = (uint32_t)max(u + 8, 0);
        // past: the bits after the message (all 32 before it, none after
        // a full word); term: the 0x80 byte's top bit at bits s1 - 8 ..
        // s1 - 1 of the word, or a bit that past clears
        const uint32_t past = kBE ? __funnelshift_rc(0xffffffffu, 0u, s0)
                                  : ~__funnelshift_lc(0xffffffffu, 0u, s0);
        const uint32_t term = kBE ? __funnelshift_rc(0u, 0x80u, s1)
                                  : __funnelshift_lc(0x80000000u, 0u, s1);
        w[j] = (raw & ~past) | (term & past);
    }
}

__global__ void __launch_bounds__(kThreads, 4)
digest_kernel(const uint32_t* __restrict__ words, const long long* __restrict__ offsets,
              const uint32_t* __restrict__ keys, int mode, int depth,
              uint32_t* __restrict__ out, long long m) {
    const int tid = threadIdx.x;
    const long long b0 = (long long)blockIdx.x * kThreads;
    if (mode == kChain) {
        const long long i = b0 + tid;
        if (i >= m) return;
        const uint4* kin = reinterpret_cast<const uint4*>(keys + i * 8);
        const uint4 k0 = kin[0], k1 = kin[1];
        uint32_t k[8] = {k0.x, k0.y, k0.z, k0.w, k1.x, k1.y, k1.z, k1.w};
        for (int d = 0; d < depth; d++) {
            if (d) sha256_of_key(k);
            store8(out, (long long)d * m + i, k);
        }
        return;
    }
    extern __shared__ uint4 smem[];
    Shared& sh = *reinterpret_cast<Shared*>(smem);

    // stage bytes [a0, a0 + 4 staged) of the block's range [lo, hi)
    const long long strings = m - b0 < kThreads ? m - b0 : kThreads;
    const long long lo = offsets[b0], hi = offsets[b0 + strings];
    const long long a0 = lo & ~15ll;
    const long long want = (hi - a0 + 3) >> 2;
    const int staged = (int)(want < kTileWords ? want : kTileWords);
    const uint32_t* src = words + (a0 >> 2);
    const bool vec = (reinterpret_cast<uintptr_t>(words) & 15u) == 0;
    for (int c = tid; 4 * c < staged; c += kThreads) {
        if (vec && 4 * c + 4 <= staged) {
            reinterpret_cast<uint4*>(sh.tile)[c] = __ldg(reinterpret_cast<const uint4*>(src) + c);
        } else {
            for (int q = 4 * c; q < 4 * c + 4 && q < staged; q++) sh.tile[q] = __ldg(src + q);
        }
    }
    if (tid == 0) sh.q_n[0] = 0;
    __syncthreads();

    const bool md5 = mode == kMd5;
    bool have = b0 + tid < m;
    uint32_t idx = tid, blk = 0, s[8];
    if (md5) {
        s[0] = 0x67452301u; s[1] = 0xefcdab89u; s[2] = 0x98badcfeu; s[3] = 0x10325476u;
        s[4] = s[5] = s[6] = s[7] = 0u;
    } else {
        sha256_init(s);
    }
    for (int round = 0;; round ^= 1) {
        bool more = false;
        if (have) {
            const long long off = offsets[b0 + idx], len = offsets[b0 + idx + 1] - off;
            const bool in_tile = off + len <= a0 + 4ll * staged;
            const uint32_t* base = (in_tile ? sh.tile + ((off - a0) >> 2) : words + (off >> 2)) +
                                   16 * blk;
            // the words holding message bytes from the block's start, and
            // the message bytes from there, each clamped to what matters
            const long long nw = ((off & 3) + len + 3) / 4 - 16ll * blk;
            const long long rem = len - 64ll * blk;
            const int avail = (int)(nw < 17 ? nw : 17), rem_c = (int)(rem < 72 ? rem : 72);
            const uint32_t nb = (uint32_t)((len + 9 + 63) >> 6);
            const uint64_t bits = (uint64_t)len * 8u;
            const bool last = blk + 1 == nb;
            uint32_t w[16];
            if (md5) {
                block_words<false>(base, (uint32_t)(off & 3), avail, rem_c, w);
                if (last) {
                    w[14] = (uint32_t)bits;
                    w[15] = (uint32_t)(bits >> 32);
                }
                md5_compress(s, w);
            } else {
                block_words<true>(base, (uint32_t)(off & 3), avail, rem_c, w);
                if (last) {
                    w[14] = (uint32_t)(bits >> 32);
                    w[15] = (uint32_t)bits;
                }
                sha256_compress(s, w);
            }
            more = !last;
            if (last) {
                const long long row = b0 + idx;
                if (md5) {
                    reinterpret_cast<uint4*>(out + row * 4)[0] = make_uint4(s[0], s[1], s[2], s[3]);
                } else {
                    if (mode == kSha256d) sha256_of_key(s);
                    store8(out, row, s);
                }
            }
        }
        // push the strings with blocks left: one atomicAdd a warp
        const unsigned lane = tid & 31, pushing = __ballot_sync(0xffffffffu, more);
        if (more) {
            const int leader = __ffs(pushing) - 1;
            int slot = 0;
            if ((int)lane == leader) slot = atomicAdd(&sh.q_n[round], __popc(pushing));
            slot = __shfl_sync(pushing, slot, leader) + __popc(pushing & ((1u << lane) - 1u));
            sh.q_idx[slot] = idx;
            sh.q_blk[slot] = blk + 1;
#pragma unroll
            for (int j = 0; j < 8; j++) sh.q_s[j][slot] = s[j];
        }
        __syncthreads();
        const int n = sh.q_n[round];
        if (n == 0) break;
        // take entry tid of this round's queue; the next round pushes anew
        have = tid < n;
        if (have) {
            idx = sh.q_idx[tid];
            blk = sh.q_blk[tid];
#pragma unroll
            for (int j = 0; j < 8; j++) s[j] = sh.q_s[j][tid];
        }
        if (tid == 0) sh.q_n[round ^ 1] = 0;
        __syncthreads();
    }
}

}  // namespace

// mode 0 sha256, 1 sha256d, 2 md5: words (the packed strings, 8 spare
// bytes past the last), offsets (m + 1), out (m, 8) or (m, 4); mode 3, the
// iterated chain: keys (m, 8), out (depth, m, 8).
extern "C" int vk_digest(const uint32_t* words, const long long* offsets, const uint32_t* keys,
                         int mode, int depth, uint32_t* out, long long m, void* stream) {
    if (mode < kSha256 || mode > kChain || (mode == kChain && depth < 1) || m < 0)
        return (int)cudaErrorInvalidValue;
    if (m == 0) return 0;
    const long long blocks = (m + kThreads - 1) / kThreads;
    const size_t smem = mode == kChain ? 0 : sizeof(Shared);
    digest_kernel<<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(
        words, offsets, keys, mode, depth, out, m);
    return VK_LAUNCH_STATUS();
}
