"""Numeric transforms: a u64 seed lattice -> private-key words on the device.

Counterpart of ``vuke_tpu/transforms/numeric.py`` (``NumericTransform``)
and of the entries of ``transforms/registry.py`` that the port runs.  A
seed is a ``(hi, lo)`` pair of uint32 (N,) tensors; ``keygen`` returns
(8, N) uint32 big-endian key words and an (N,) validity mask.  ``key_for``
gives one seed's 32 key bytes on the host (for the confirm of a
candidate), or None where the transform yields no key.

``sequential_slot`` marks a transform whose key IS the seed (key of
seed + 1 = key of seed + 1), so a contiguous range can take the
sequential scan's one-point-addition-per-key path (``ecc/incremental.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from ._device import i64
from .cores import mt19937


@dataclass(frozen=True)
class NumericTransform:
    name: str                    # registry name (``--transform``)
    display: str                 # the name a hit prints
    keygen: Callable             # (hi, lo) -> ((8, N) BE key words, (N,) bool)
    key_for: Callable            # seed -> 32 key bytes, or None
    sequential_slot: Optional[int] = None


def _milksad_keygen(hi: torch.Tensor, lo: torch.Tensor):
    """MT19937 seeded with a u32 (K1); seeds above 2^32 - 1 yield no key."""
    return mt19937.milksad_key_words(lo), i64(hi) == 0


def _milksad_key(seed: int) -> Optional[bytes]:
    if seed >> 32:
        return None
    kw = mt19937.milksad_key_words_plain(torch.tensor([seed], dtype=torch.int64)
                                         .to(torch.uint32))
    return b"".join(int(v).to_bytes(4, "big") for v in i64(kw[:, 0]))


def _direct_be_keygen(hi: torch.Tensor, lo: torch.Tensor):
    """The seed is the key: BE words [0, 0, 0, 0, 0, 0, hi, lo]."""
    words = torch.zeros((8, lo.shape[0]), dtype=torch.uint32, device=lo.device)
    words[6] = hi
    words[7] = lo
    return words, torch.ones(lo.shape, dtype=torch.bool, device=lo.device)


def _direct_be_key(seed: int) -> bytes:
    return seed.to_bytes(32, "big")


MILKSAD = NumericTransform("milksad", "milksad", _milksad_keygen, _milksad_key)
DIRECT_BE = NumericTransform("direct:be", "direct", _direct_be_keygen, _direct_be_key,
                             sequential_slot=0)

TRANSFORMS = {t.name: t for t in (MILKSAD, DIRECT_BE)}


def get(name: str) -> NumericTransform:
    try:
        return TRANSFORMS[name.lower()]
    except KeyError:
        raise ValueError(f"transform {name!r} is not ported yet") from None
