"""Numeric transforms: a u64 seed lattice -> the private-key words of every slot.

Counterpart of ``vuke_tpu/transforms/numeric.py``.  A transform has S
slots, each one key per seed, with the reference's source-string suffix as
its label (``''``, ``':msvc'``, ``'[iterated:3]'``).  A seed lattice is a
``(hi, lo)`` pair of (N,) uint32 tensors; ``keygen`` returns (S, 8, N)
uint32 big-endian key words, so each ``keys[s]`` is the contiguous (8, N)
the derive takes (the JAX package keeps (N, S, 8)), and an (S, N) validity
mask: a seed the transform yields no key for in a slot (milksad above
2^32 - 1, an LCG seed past its modulus, the 4-byte chains above 2^32 - 1)
is masked out there.

On the card each transform's words come from one kernel launch
(``cores/keygen.py``, or K1 for milksad); ``keygen(..., plain=True)``
computes them with the plain PyTorch versions on any device, as the host
confirm and the tests do.

``sequential_slot`` marks the slot whose key IS the seed (key of seed + 1
= key of seed + 1), so a contiguous range can take the sequential scan's
one-point-addition-per-key path (``ecc/incremental.py``).

A host-only transform (armory's numeric path: EC multiplications a key)
has ``host`` in place of ``words`` and ``valid``: its keys are computed on
the host from the seeds, then sent to the device for the derive and the
match, as ``vuke_tpu/pipeline.py:328-333`` runs them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from .._device import i64
from ..cores import keygen, lcg as lcg_core, mt19937, sha256_chain as chain_core
from ..cores import xorshift as xs_core


@dataclass(frozen=True)
class NumericTransform:
    """``name``: the JAX package's ``NumericTransform.name``; ``slots``: the
    label suffix of each slot; ``words(hi, lo, plain)``: (S, 8, N) uint32
    key words, one kernel launch a call on the card; ``valid(hi, lo)``:
    (S, N) bool."""
    name: str
    slots: tuple
    words: Optional[Callable] = None
    valid: Optional[Callable] = None
    sequential_slot: Optional[int] = None
    host: Optional[Callable] = None

    @property
    def n_slots(self) -> int:
        return len(self.slots)

    @property
    def host_only(self) -> bool:
        return self.host is not None

    def keygen(self, hi: torch.Tensor, lo: torch.Tensor, plain: bool = False,
               limit: Optional[int] = None):
        """(N,) uint32 seed words -> ((S, 8, N) uint32 BE key words, (S, N)
        bool validity); ``plain`` runs the plain version on any device.  A
        host-only transform computes the first ``limit`` lanes (all when
        None) on the host, the rest invalid, and sends them to the seeds'
        device."""
        if self.host is None:
            return self.words(hi, lo, plain), self.valid(hi, lo)
        n = lo.shape[0]
        m = n if limit is None else min(limit, n)
        seeds = [(h << 32) | l for h, l in zip(i64(hi[:m]).tolist(), i64(lo[:m]).tolist())]
        keys_np, valid_np = self.host(seeds)                   # (m, S, 8), (m, S)
        keys = np.zeros((self.n_slots, 8, n), dtype=np.uint32)
        valid = np.zeros((self.n_slots, n), dtype=bool)
        keys[:, :, :m] = keys_np.transpose(1, 2, 0)
        valid[:, :m] = valid_np.T
        words = torch.from_numpy(keys.view(np.int32)).view(torch.uint32)
        return words.to(lo.device), torch.from_numpy(valid).to(lo.device)


def _all_valid(slots: int):
    def valid(hi, lo):
        return torch.ones((slots, lo.shape[0]), dtype=torch.bool, device=lo.device)
    return valid


def _below_2_32(slots: int):
    """Valid where hi == 0, in every slot."""
    def valid(hi, lo):
        return (i64(hi) == 0)[None].expand(slots, -1)
    return valid


def _hash(mode: str, first: int = 0, count: Optional[int] = None):
    """Slots first .. first + count - 1 of ``keygen_hash``'s ``mode``."""
    def words(hi, lo, plain):
        fn = keygen.keygen_hash_plain if plain else keygen.keygen_hash
        keys = fn(hi, lo, mode)
        return keys if count is None else keys[first:first + count]
    return words


# --- direct: the seed as the key, BE, LE and as its decimal string ---------

DIRECT = NumericTransform("direct", ("", "", ""), _hash("direct"), _all_valid(3),
                          sequential_slot=0)
# single interpretations (an extension of the TPU package): direct:be scans
# the seeds as the keys themselves, the bitcoin-puzzle workload, served by
# the sequential path over contiguous ranges
DIRECT_BE = NumericTransform("direct", ("",), _hash("direct", 0, 1), _all_valid(1),
                             sequential_slot=0)
DIRECT_LE = NumericTransform("direct", ("",), _hash("direct", 1, 1), _all_valid(1))
DIRECT_STR = NumericTransform("direct", ("",), _hash("direct", 2, 1), _all_valid(1))

# --- sha256, double_sha256, md5 --------------------------------------------

SHA256 = NumericTransform("sha256", ("", "", ""), _hash("sha256"), _all_valid(3))
DOUBLE_SHA256 = NumericTransform("double_sha256", ("", "", ""), _hash("double_sha256"),
                                 _all_valid(3))
MD5 = NumericTransform("md5", ("",), _hash("md5"), _all_valid(1))


# --- milksad (MT19937, u32 seeds only): K1 --------------------------------

def _milksad_words(hi, lo, plain):
    fn = mt19937.milksad_key_words_plain if plain else mt19937.milksad_key_words
    return fn(lo)[None]


MILKSAD = NumericTransform("milksad", ("",), _milksad_words, _below_2_32(1))


# --- mt64, lcg, xorshift: keygen_prng --------------------------------------

def _prng(family: str, variant: int = -1, big_endian: bool = True):
    def words(hi, lo, plain):
        fn = keygen.keygen_prng_plain if plain else keygen.keygen_prng
        return fn(hi, lo, family, variant, big_endian)
    return words


MT64 = NumericTransform("mt64", ("",), _prng("mt64"), _all_valid(1))


def make_lcg(variants=None, big_endian: bool = True) -> NumericTransform:
    """The lcg transform over ``variants`` (``lcg_core.LcgVariant``s; all
    four when None).  A seed is valid in a variant's slot when it is below
    2^32 and at most min(m - 1, 2^32 - 1); labels are '' for one variant,
    ':name' for several big-endian, ':name:le' little-endian."""
    vs = list(variants) if variants else list(lcg_core.ALL_VARIANTS)
    if len(vs) == 1:
        variant = lcg_core.ALL_VARIANTS.index(vs[0])
    elif vs == list(lcg_core.ALL_VARIANTS):
        variant = -1
    else:
        raise ValueError("make_lcg: one variant or all four")
    caps = [min(v.max_seed, 0xFFFFFFFF) for v in vs]

    def valid(hi, lo):
        h, l = i64(hi), i64(lo)
        return torch.stack([(h == 0) & (l <= cap) for cap in caps])

    if len(vs) == 1:
        slots = ("",)
    elif big_endian:
        slots = tuple(f":{v.name}" for v in vs)
    else:
        slots = tuple(f":{v.name}:le" for v in vs)
    return NumericTransform("lcg", slots, _prng("lcg", variant, big_endian), valid)


def make_xorshift(variant: Optional[str] = None) -> NumericTransform:
    """The xorshift transform: one variant of ``xs_core.VARIANT_NAMES``, or
    all four labelled ':name'."""
    names = [variant] if variant else list(xs_core.VARIANT_NAMES)
    index = xs_core.VARIANT_NAMES.index(variant) if variant else -1
    slots = ("",) if len(names) == 1 else tuple(f":{n}" for n in names)
    return NumericTransform("xorshift", slots, _prng("xorshift", index),
                            _all_valid(len(names)))


# --- sha256_chain: keygen_chain --------------------------------------------

def make_sha256_chain(variant: Optional[str] = None,
                      depth: int = chain_core.DEFAULT_CHAIN_DEPTH) -> NumericTransform:
    """The chain transform: for numeric inputs the reference emits both the
    decimal-string chains (every seed) and the 4-byte BE seed chains (seeds
    below 2^32), with the same labels '[variant:d]' in both halves."""
    variants = [variant] if variant else list(chain_core.VARIANTS)
    index = chain_core.VARIANTS.index(variant) if variant else -1
    half = len(variants) * depth

    def words(hi, lo, plain):
        fn = keygen.keygen_chain_plain if plain else keygen.keygen_chain
        return fn(hi, lo, index, depth)

    def valid(hi, lo):
        top = (i64(hi) == 0)[None].expand(half, -1)
        return torch.cat([torch.ones_like(top), top])

    labels = tuple(f"[{v}:{i}]" for v in variants for i in range(depth))
    return NumericTransform("sha256_chain", labels + labels, words, valid)
