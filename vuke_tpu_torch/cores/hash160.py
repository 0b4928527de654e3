"""hash160 of both public-key forms, fused.

Counterpart of ``vuke_tpu/cores/pallas_kernels.py::_hash160_kernel`` (K2):
RIPEMD160(SHA256(02|03 || x)), one SHA-256 block, and
RIPEMD160(SHA256(04 || x || y)), two blocks, with the padding of the
fixed 33- and 65-byte messages written out.  The parity of y is the low
bit of y's last big-endian word.  ``hash160s_and_fragments`` also returns
the 8-byte match fragments of both digests, written by K2's epilogue on
the card (``vuke_tpu/ecc/tiled.py:443-446`` in the JAX package).
"""

from __future__ import annotations

import torch

from .._device import (MASK32, byteswap32, check_same_device, check_words, i64,
                       rotl32, rotr32, u32)
from ..kernels import PTR, SIZE, Kernel

KERNEL = Kernel(
    "hash160", "vk_hash160", [PTR, PTR, PTR, PTR, PTR, SIZE],
    source="vuke_tpu_torch/csrc/hash160.cu",
    replaces="vuke_tpu/cores/pallas_kernels.py:146 _hash160_kernel")

SHA_K = (
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2)
SHA_IV = (0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
          0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19)

RMD_IV = (0x67452301, 0xEFCDAB89, 0x98BADCFE, 0x10325476, 0xC3D2E1F0)
RMD_KL = (0x00000000, 0x5A827999, 0x6ED9EBA1, 0x8F1BBCDC, 0xA953FD4E)
RMD_KR = (0x50A28BE6, 0x5C4DD124, 0x6D703EF3, 0x7A6D76E9, 0x00000000)
RMD_RL = (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
          7, 4, 13, 1, 10, 6, 15, 3, 12, 0, 9, 5, 2, 14, 11, 8,
          3, 10, 14, 4, 9, 15, 8, 1, 2, 7, 0, 6, 13, 11, 5, 12,
          1, 9, 11, 10, 0, 8, 12, 4, 13, 3, 7, 15, 14, 5, 6, 2,
          4, 0, 5, 9, 7, 12, 2, 10, 14, 1, 3, 8, 11, 6, 15, 13)
RMD_RR = (5, 14, 7, 0, 9, 2, 11, 4, 13, 6, 15, 8, 1, 10, 3, 12,
          6, 11, 3, 7, 0, 13, 5, 10, 14, 15, 8, 12, 4, 9, 1, 2,
          15, 5, 1, 3, 7, 14, 6, 9, 11, 8, 12, 2, 10, 0, 4, 13,
          8, 6, 4, 1, 3, 11, 15, 0, 5, 12, 2, 13, 9, 7, 10, 14,
          12, 15, 10, 4, 1, 5, 8, 7, 6, 2, 13, 14, 0, 3, 9, 11)
RMD_SL = (11, 14, 15, 12, 5, 8, 7, 9, 11, 13, 14, 15, 6, 7, 9, 8,
          7, 6, 8, 13, 11, 9, 7, 15, 7, 12, 15, 9, 11, 7, 13, 12,
          11, 13, 6, 7, 14, 9, 13, 15, 14, 8, 13, 6, 5, 12, 7, 5,
          11, 12, 14, 15, 14, 15, 9, 8, 9, 14, 5, 6, 8, 6, 5, 12,
          9, 15, 5, 11, 6, 8, 13, 12, 5, 12, 13, 14, 11, 8, 5, 6)
RMD_SR = (8, 9, 9, 11, 13, 15, 15, 5, 7, 7, 8, 11, 14, 14, 12, 6,
          9, 13, 15, 7, 12, 8, 9, 11, 7, 7, 12, 7, 6, 15, 13, 11,
          9, 7, 15, 11, 8, 6, 6, 14, 12, 13, 5, 14, 13, 13, 7, 5,
          15, 5, 8, 11, 14, 14, 6, 14, 6, 9, 12, 9, 12, 5, 15, 8,
          8, 5, 12, 9, 12, 5, 14, 6, 8, 13, 6, 5, 15, 13, 11, 11)


def _sha_compress(state, block):
    """One SHA-256 compression over int64-held u32 words (tensors or ints)."""
    a, b, c, d, e, f, g, h = state
    w = list(block)
    for t in range(64):
        if t >= 16:
            s0 = rotr32(w[t - 15], 7) ^ rotr32(w[t - 15], 18) ^ (w[t - 15] >> 3)
            s1 = rotr32(w[t - 2], 17) ^ rotr32(w[t - 2], 19) ^ (w[t - 2] >> 10)
            w.append((w[t - 16] + s0 + w[t - 7] + s1) & MASK32)
        s1e = rotr32(e, 6) ^ rotr32(e, 11) ^ rotr32(e, 25)
        ch = (e & f) ^ ((e ^ MASK32) & g)
        t1 = h + s1e + ch + SHA_K[t] + w[t]
        s0a = rotr32(a, 2) ^ rotr32(a, 13) ^ rotr32(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        h, g, f, e = g, f, e, (d + t1) & MASK32
        d, c, b, a = c, b, a, (t1 + s0a + maj) & MASK32
    return [(x + s) & MASK32 for x, s in zip((a, b, c, d, e, f, g, h), state)]


def _rmd_f(j, x, y, z):
    if j < 16:
        return x ^ y ^ z
    if j < 32:
        return (x & y) | ((x ^ MASK32) & z)
    if j < 48:
        return (x | (y ^ MASK32)) ^ z
    if j < 64:
        return (x & z) | (y & (z ^ MASK32))
    return x ^ (y | (z ^ MASK32))


def _ripemd_of_digest(digest):
    """RIPEMD-160 of a 32-byte SHA-256 digest (8 BE words) -> 5 LE words."""
    m = [byteswap32(v) for v in digest] + [0x80, 0, 0, 0, 0, 0, 256, 0]
    al = ar = RMD_IV[0]
    bl = br = RMD_IV[1]
    cl = cr = RMD_IV[2]
    dl = dr = RMD_IV[3]
    el = er = RMD_IV[4]
    for j in range(80):
        r = j // 16
        t = (rotl32((al + _rmd_f(j, bl, cl, dl) + m[RMD_RL[j]] + RMD_KL[r])
                    & MASK32, RMD_SL[j]) + el) & MASK32
        al, el, dl, cl, bl = el, dl, rotl32(cl, 10), bl, t
        t = (rotl32((ar + _rmd_f(79 - j, br, cr, dr) + m[RMD_RR[j]] + RMD_KR[r])
                    & MASK32, RMD_SR[j]) + er) & MASK32
        ar, er, dr, cr, br = er, dr, rotl32(cr, 10), br, t
    h = RMD_IV
    return [(h[1] + cl + dr) & MASK32, (h[2] + dl + er) & MASK32,
            (h[3] + el + ar) & MASK32, (h[4] + al + br) & MASK32,
            (h[0] + bl + cr) & MASK32]


def hash160s_plain(xw: torch.Tensor, yw: torch.Tensor):
    """Plain version of K2: (8, N) BE words of canonical x, y ->
    (h160c, h160u), each (5, N) uint32 LE digest words."""
    x = [i64(xw[j]) for j in range(8)]
    y = [i64(yw[j]) for j in range(8)]
    parity = y[7] & 1

    def spliced(prefix, words, tail):
        # prefix byte, then the words, shifted one byte right
        out = [((prefix << 24) | (words[0] >> 8)) & MASK32]
        out += [((words[j - 1] << 24) | (words[j] >> 8)) & MASK32
                for j in range(1, 8)]
        out.append(((words[7] << 24) | tail) & MASK32)
        return out

    comp = spliced(0x02 + parity, x, 0x800000) + [0] * 6 + [33 * 8]
    hc = _ripemd_of_digest(_sha_compress(SHA_IV, comp))

    uncomp = spliced(0x04, x, y[0] >> 8)
    uncomp += [((y[j - 1] << 24) | (y[j] >> 8)) & MASK32 for j in range(1, 8)]
    s = _sha_compress(SHA_IV, uncomp)
    block2 = [((y[7] << 24) | 0x800000) & MASK32] + [0] * 14 + [65 * 8]
    hu = _ripemd_of_digest(_sha_compress(s, block2))
    return u32(torch.stack(hc, dim=0)), u32(torch.stack(hu, dim=0))


def fragments(h160_t: torch.Tensor):
    """(5, N) LE digest words -> the (hi, lo) uint32 (N,) pair of the first
    8 hash160 bytes read big-endian: byteswap32 of words 0 and 1."""
    return u32(byteswap32(i64(h160_t[0]))), u32(byteswap32(i64(h160_t[1])))


def hash160s_and_fragments_plain(xw: torch.Tensor, yw: torch.Tensor):
    """Plain version of K2 with its fragment epilogue: ``hash160s_plain``,
    then ``fragments`` of each digest."""
    hc, hu = hash160s_plain(xw, yw)
    return hc, hu, fragments(hc), fragments(hu)


def hash160s_and_fragments(xw: torch.Tensor, yw: torch.Tensor):
    """(8, N) uint32 BE words of canonical affine x, y -> (h160c, h160u,
    (c_hi, c_lo), (u_hi, u_lo)): each digest (5, N) uint32 LE words, each
    fragment word (N,) uint32 (``fragments``).

    A CUDA tensor goes through the K2 kernel, the fragments written by its
    epilogue; a CPU tensor through the plain version."""
    n = check_words(xw, 8, "xw")
    if check_words(yw, 8, "yw") != n:
        raise ValueError(f"yw: batch {yw.shape[1]} != {n}")
    dev = check_same_device(xw, yw)
    if dev.type == "cpu":
        return hash160s_and_fragments_plain(xw, yw)
    hc = torch.empty((5, n), dtype=torch.uint32, device=dev)
    hu = torch.empty((5, n), dtype=torch.uint32, device=dev)
    frag = torch.empty((4, n), dtype=torch.uint32, device=dev)
    if n:
        KERNEL.launch(dev, xw.data_ptr(), yw.data_ptr(), hc.data_ptr(), hu.data_ptr(),
                      frag.data_ptr(), n)
    return hc, hu, (frag[0], frag[1]), (frag[2], frag[3])


def hash160s(xw: torch.Tensor, yw: torch.Tensor):
    """(8, N) uint32 BE words of canonical affine x, y -> (h160c, h160u),
    each (5, N) uint32 LE digest words: ``hash160s_and_fragments`` without
    the fragments."""
    return hash160s_and_fragments(xw, yw)[:2]
