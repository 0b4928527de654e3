"""The xorshift-family keystreams of the xorshift transform.

Counterpart of ``vuke_tpu/cores/xorshift.py``: xorshift64 (shifts 13, 7,
17), xorshift128 (32-bit lanes seeded from the seed's halves), and
xorshift128+ and xoroshiro128** (state from two splitmix64 steps; the
reference's "xorshift128+" steps a xoroshiro128 state).  A zero seed
becomes 1; u64 outputs are written high word first.  Each function
returns the 8 x ``n_keys`` words of the stream's first ``n_keys`` keys
(``vuke_tpu/cores/xorshift.py``'s ``*_keystream_words``).  Plain PyTorch over
(hi, lo) pairs of int64-held u32 words (``cores/common.py``); the kernel is
``csrc/keygen_prng.cu``.
"""

from __future__ import annotations

import torch

from .._device import MASK32
from .common import (u64_add, u64_const, u64_mul_lo, u64_rotl, u64_shl, u64_shr,
                     u64_xor)

VARIANT_NAMES = ("xorshift64", "xorshift128", "xorshift128+", "xoroshiro128**")


def splitmix64(x):
    x = u64_add(x, u64_const(0x9E3779B97F4A7C15))
    x = u64_mul_lo(u64_xor(x, u64_shr(x, 30)), u64_const(0xBF58476D1CE4E5B9))
    x = u64_mul_lo(u64_xor(x, u64_shr(x, 27)), u64_const(0x94D049BB133111EB))
    return u64_xor(x, u64_shr(x, 31))


def _nonzero(hi, lo):
    return hi, torch.where((hi == 0) & (lo == 0), 1, lo)


def xorshift64(hi, lo, n_keys: int = 1):
    s = _nonzero(hi, lo)
    out = []
    for _ in range(4 * n_keys):
        s = u64_xor(s, u64_shl(s, 13))
        s = u64_xor(s, u64_shr(s, 7))
        s = u64_xor(s, u64_shl(s, 17))
        out += list(s)
    return out


def xorshift128(hi, lo, n_keys: int = 1):
    hi, lo = _nonzero(hi, lo)
    x, y, z, w = lo, hi, lo ^ 0x12345678, hi ^ 0x87654321
    out = []
    for _ in range(8 * n_keys):
        t = x ^ ((x << 11) & MASK32)
        x, y, z = y, z, w
        w = (w ^ (w >> 19)) ^ (t ^ (t >> 8))
        out.append(w)
    return out


def _xoroshiro(hi, lo, output, n_keys: int):
    s0 = splitmix64(_nonzero(hi, lo))
    s1 = splitmix64(s0)
    out = []
    for _ in range(4 * n_keys):
        out += list(output(s0, s1))
        s1 = u64_xor(s1, s0)
        s0 = u64_xor(u64_xor(u64_rotl(s0, 24), s1), u64_shl(s1, 16))
        s1 = u64_rotl(s1, 37)
    return out


def xorshift128plus(hi, lo, n_keys: int = 1):
    return _xoroshiro(hi, lo, u64_add, n_keys)


def xoroshiro128starstar(hi, lo, n_keys: int = 1):
    return _xoroshiro(hi, lo, lambda s0, s1: u64_mul_lo(
        u64_rotl(u64_mul_lo(s0, (0, 5)), 7), (0, 9)), n_keys)


KEY_FNS = dict(zip(VARIANT_NAMES, (xorshift64, xorshift128, xorshift128plus,
                                   xoroshiro128starstar)))
