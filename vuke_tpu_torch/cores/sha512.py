"""SHA-512 over 64-bit words carried as (hi, lo) pairs of u32 values.

The plain version of the PBKDF2 kernel W1 (``wallets/pbkdf2_device.py``,
``csrc/pbkdf2_sha512.cu``) and the port's counterpart of
``vuke_tpu/cores/sha512.py``.  torch's CPU build has no shifts or adds on
``uint32`` and ``uint64``, and an int64 add of two 64-bit words would
overflow, so each word is a pair of int64 tensors (or Python ints) holding
u32 values, combined with masks: no int64 overflow and no right shift of a
negative value.  ``compress`` is one compression of a 16-word block into an
8-word state, 80 rounds with the rolling 16-word schedule.
"""

from __future__ import annotations

MASK32 = 0xFFFFFFFF

K = [
    0x428a2f98d728ae22, 0x7137449123ef65cd, 0xb5c0fbcfec4d3b2f, 0xe9b5dba58189dbbc,
    0x3956c25bf348b538, 0x59f111f1b605d019, 0x923f82a4af194f9b, 0xab1c5ed5da6d8118,
    0xd807aa98a3030242, 0x12835b0145706fbe, 0x243185be4ee4b28c, 0x550c7dc3d5ffb4e2,
    0x72be5d74f27b896f, 0x80deb1fe3b1696b1, 0x9bdc06a725c71235, 0xc19bf174cf692694,
    0xe49b69c19ef14ad2, 0xefbe4786384f25e3, 0x0fc19dc68b8cd5b5, 0x240ca1cc77ac9c65,
    0x2de92c6f592b0275, 0x4a7484aa6ea6e483, 0x5cb0a9dcbd41fbd4, 0x76f988da831153b5,
    0x983e5152ee66dfab, 0xa831c66d2db43210, 0xb00327c898fb213f, 0xbf597fc7beef0ee4,
    0xc6e00bf33da88fc2, 0xd5a79147930aa725, 0x06ca6351e003826f, 0x142929670a0e6e70,
    0x27b70a8546d22ffc, 0x2e1b21385c26c926, 0x4d2c6dfc5ac42aed, 0x53380d139d95b3df,
    0x650a73548baf63de, 0x766a0abb3c77b2a8, 0x81c2c92e47edaee6, 0x92722c851482353b,
    0xa2bfe8a14cf10364, 0xa81a664bbc423001, 0xc24b8b70d0f89791, 0xc76c51a30654be30,
    0xd192e819d6ef5218, 0xd69906245565a910, 0xf40e35855771202a, 0x106aa07032bbd1b8,
    0x19a4c116b8d2d0c8, 0x1e376c085141ab53, 0x2748774cdf8eeb99, 0x34b0bcb5e19b48a8,
    0x391c0cb3c5c95a63, 0x4ed8aa4ae3418acb, 0x5b9cca4f7763e373, 0x682e6ff3d6b2b8a3,
    0x748f82ee5defb2fc, 0x78a5636f43172f60, 0x84c87814a1f0ab72, 0x8cc702081a6439ec,
    0x90befffa23631e28, 0xa4506cebde82bde9, 0xbef9a3f7b2c67915, 0xc67178f2e372532b,
    0xca273eceea26619c, 0xd186b8c721c0c207, 0xeada7dd6cde0eb1e, 0xf57d4f7fee6ed178,
    0x06f067aa72176fba, 0x0a637dc5a2c898a6, 0x113f9804bef90dae, 0x1b710b35131c471b,
    0x28db77f523047d84, 0x32caab7b40c72493, 0x3c9ebe0a15c9bebc, 0x431d67c49c100d4c,
    0x4cc5d4becb3e42b6, 0x597f299cfc657e2a, 0x5fcb6fab3ad6faec, 0x6c44198c4a475817,
]

IV = [
    0x6a09e667f3bcc908, 0xbb67ae8584caa73b, 0x3c6ef372fe94f82b, 0xa54ff53a5f1d36f1,
    0x510e527fade682d1, 0x9b05688c2b3e6c1f, 0x1f83d9abfb41bd6b, 0x5be0cd19137e2179,
]


def split(v: int):
    """A Python u64 -> its (hi, lo) pair."""
    return v >> 32, v & MASK32


def add(*xs):
    """The sum mod 2^64 of (hi, lo) pairs: the low words' sum carries into
    the high words' (a few terms stay far below 2^63)."""
    lo = sum(x[1] for x in xs)
    hi = sum(x[0] for x in xs) + (lo >> 32)
    return hi & MASK32, lo & MASK32


def xor(a, b):
    return a[0] ^ b[0], a[1] ^ b[1]


def rotr(x, n: int):
    """(hi, lo) rotated right by n, 0 < n < 64."""
    hi, lo = x if n < 32 else (x[1], x[0])
    n %= 32
    if n == 0:
        return hi, lo
    return (((hi >> n) | (lo << (32 - n))) & MASK32,
            ((lo >> n) | (hi << (32 - n))) & MASK32)


def shr(x, n: int):
    """(hi, lo) shifted right by n, 0 < n < 32."""
    return x[0] >> n, ((x[1] >> n) | (x[0] << (32 - n))) & MASK32


def compress(state, block):
    """One SHA-512 compression: ``state`` 8 (hi, lo) pairs, ``block`` the 16
    (hi, lo) message words -> the 8 new state words."""
    a, b, c, d, e, f, g, h = state
    w = list(block)
    for t in range(80):
        if t < 16:
            wt = w[t]
        else:
            w15, w2 = w[(t - 15) % 16], w[(t - 2) % 16]
            s0 = xor(xor(rotr(w15, 1), rotr(w15, 8)), shr(w15, 7))
            s1 = xor(xor(rotr(w2, 19), rotr(w2, 61)), shr(w2, 6))
            wt = w[t % 16] = add(w[t % 16], s0, w[(t - 7) % 16], s1)
        s1e = xor(xor(rotr(e, 14), rotr(e, 18)), rotr(e, 41))
        ch = ((e[0] & f[0]) ^ (~e[0] & MASK32 & g[0]), (e[1] & f[1]) ^ (~e[1] & MASK32 & g[1]))
        t1 = add(h, s1e, ch, split(K[t]), wt)
        s0a = xor(xor(rotr(a, 28), rotr(a, 34)), rotr(a, 39))
        maj = tuple((a[i] & b[i]) ^ (a[i] & c[i]) ^ (b[i] & c[i]) for i in range(2))
        h, g, f, e = g, f, e, add(d, t1)
        d, c, b, a = c, b, a, add(t1, s0a, maj)
    return [add(x, s) for x, s in zip((a, b, c, d, e, f, g, h), state)]


def iv():
    return [split(v) for v in IV]


def pad_64(words, prev_blocks: int = 1):
    """The block of a 64-byte message (8 (hi, lo) words) after
    ``prev_blocks`` compressed 128-byte blocks: the words, 0x80, zeros and
    the bit length (the HMAC iterations' second block)."""
    return list(words) + [split(1 << 63)] + [(0, 0)] * 6 + [split((prev_blocks * 128 + 64) * 8)]
