"""The LCG keystreams (glibc, MINSTD, MSVC, Borland) of the lcg transform.

Counterpart of ``vuke_tpu/cores/lcg.py``: next = (a * state + c) mod m from
the raw u32 seed, 8 successive outputs as the key's words, each serialized
big- or little-endian.  MINSTD's result stays canonical (2^31 - 1 is 0).
Plain PyTorch over int64-held u32 words; the kernel is ``csrc/keygen_prng.cu``.
"""

from __future__ import annotations

from dataclasses import dataclass

from .._device import MASK32, byteswap32


@dataclass(frozen=True)
class LcgVariant:
    name: str
    a: int
    c: int
    m: int  # 2**31, 2**32, or 2**31 - 1

    @property
    def max_seed(self) -> int:
        return self.m - 1


GLIBC = LcgVariant("glibc", 1103515245, 12345, 1 << 31)
MINSTD = LcgVariant("minstd", 16807, 0, (1 << 31) - 1)
MSVC = LcgVariant("msvc", 214013, 2531011, 1 << 32)
BORLAND = LcgVariant("borland", 22695477, 1, 1 << 32)

ALL_VARIANTS = (GLIBC, MINSTD, MSVC, BORLAND)
VARIANTS_BY_NAME = {v.name: v for v in ALL_VARIANTS}


def lcg_next(state, v: LcgVariant):
    """One step on int64-held u32 states (a raw u32 seed for the first):
    a * state + c is below 2^62, so it is exact in int64."""
    return (v.a * state + v.c) % v.m


def lcg_key_words(seed, v: LcgVariant, big_endian: bool = True):
    """8 BE key words: the next 8 outputs, byteswapped when little-endian."""
    state, out = seed, []
    for _ in range(8):
        state = lcg_next(state, v)
        out.append(state if big_endian else byteswap32(state))
    return [w & MASK32 for w in out]
