"""u64 arithmetic over (hi, lo) pairs of u32 words held in int64 tensors.

The port's copy of the u64 helpers of ``vuke_tpu/cores/common.py`` for the
plain PyTorch versions of the keygens.  torch's uint32 has no arithmetic on
the CPU, so each u32 word is an int64 tensor (or a Python int) in
[0, 2^32), masked after every operation that can leave that range.  A
32 x 32-bit product would overflow int64, so products are taken in 16-bit
halves.  The kernels use native u64 instead.
"""

from __future__ import annotations

from .._device import MASK32

MASK16 = 0xFFFF


def mul_wide(a, b):
    """(hi, lo) words of the 64-bit product of two u32 words."""
    p0 = (a & MASK16) * b                 # below 2^48
    p1 = (a >> 16) * b                    # below 2^48
    t = p0 + ((p1 & MASK16) << 16)        # below 2^49
    return ((t >> 32) + (p1 >> 16)) & MASK32, t & MASK32


def u64_const(v: int):
    v &= (1 << 64) - 1
    return v >> 32, v & MASK32


def u64_add(a, b):
    lo = a[1] + b[1]
    return (a[0] + b[0] + (lo >> 32)) & MASK32, lo & MASK32


def u64_xor(a, b):
    return a[0] ^ b[0], a[1] ^ b[1]


def u64_and(a, b):
    return a[0] & b[0], a[1] & b[1]


def u64_or(a, b):
    return a[0] | b[0], a[1] | b[1]


def u64_shl(a, n: int):
    hi, lo = a
    n &= 63
    if n == 0:
        return a
    if n >= 32:
        return (lo << (n - 32)) & MASK32, lo * 0
    return ((hi << n) | (lo >> (32 - n))) & MASK32, (lo << n) & MASK32


def u64_shr(a, n: int):
    hi, lo = a
    n &= 63
    if n == 0:
        return a
    if n >= 32:
        return hi * 0, hi >> (n - 32)
    return hi >> n, ((lo >> n) | (hi << (32 - n))) & MASK32


def u64_rotl(a, n: int):
    n &= 63
    if n == 0:
        return a
    return u64_or(u64_shl(a, n), u64_shr(a, 64 - n))


def u64_mul_lo(a, b):
    """The low 64 bits of the product of two u64 pairs."""
    ph, pl = mul_wide(a[1], b[1])
    hi = (ph + mul_wide(a[1], b[0])[1] + mul_wide(a[0], b[1])[1]) & MASK32
    return hi, pl
