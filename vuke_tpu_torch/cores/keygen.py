"""The keygen kernels of the numeric transforms: a u64 seed lattice -> the
key words of every slot, one launch a superbatch.

Each transform family is one CUDA kernel with a plain PyTorch version
beside it (``*_plain``), which the tests and the CPU path use:

- ``keygen_hash`` (``csrc/keygen_hash.cu``): direct, sha256, double_sha256
  and md5 (``vuke_tpu/transforms/numeric.py``'s ``_direct``,
  ``_hash_three`` and ``_md5``);
- ``keygen_prng`` (``csrc/keygen_prng.cu``): the four LCGs, the four
  xorshift generators and MT19937-64 (``make_lcg``, ``make_xorshift`` and
  ``_mt64``);
- ``keygen_chain`` (``csrc/keygen_chain.cu``): the sha256_chain variants
  over the decimal string and over the 4-byte seed
  (``make_sha256_chain``).

In the JAX package these are ``jnp`` code that XLA fuses, with no Pallas
kernel; as eager torch ops each would be thousands of launches a
superbatch.  Seeds are (N,) uint32 ``hi`` and ``lo`` words; every function
returns (S, 8, N) uint32 big-endian key words, slot by slot in the
reference's order, so ``keys[s]`` is the contiguous (8, N) the derive
takes.  A CUDA tensor goes through the kernel, a CPU tensor through the
plain version.
"""

from __future__ import annotations

import torch

from .._device import byteswap32, check_same_device, i64, u32
from ..kernels import INT, PTR, SIZE, Kernel
from . import lcg, mt19937, sha256_chain, xorshift
from .decimal import decimal_ascii_words_be
from .md5 import md5_single_block_varlen
from .sha256 import sha256_key_words, sha256_single_block_varlen, sha256_words

HASH_KERNEL = Kernel(
    "keygen_hash", "vk_keygen_hash", [PTR, PTR, INT, PTR, SIZE],
    source="vuke_tpu_torch/csrc/keygen_hash.cu",
    replaces="vuke_tpu/transforms/numeric.py:49 _direct / :82 _hash_three / :102 _md5 "
             "(XLA, no Pallas)")
PRNG_KERNEL = Kernel(
    "keygen_prng", "vk_keygen_prng", [PTR, PTR, INT, INT, INT, INT, PTR, SIZE],
    source="vuke_tpu_torch/csrc/keygen_prng.cu",
    replaces="vuke_tpu/transforms/numeric.py:126 _mt64 / :136 make_lcg / :166 "
             "make_xorshift (XLA, no Pallas)")
CHAIN_KERNEL = Kernel(
    "keygen_chain", "vk_keygen_chain", [PTR, PTR, INT, INT, PTR, SIZE],
    source="vuke_tpu_torch/csrc/keygen_chain.cu",
    replaces="vuke_tpu/transforms/numeric.py:179 make_sha256_chain (XLA, no Pallas)")

HASH_MODES = ("direct", "sha256", "double_sha256", "md5")
HASH_SLOTS = {"direct": 3, "sha256": 3, "double_sha256": 3, "md5": 1}
PRNG_FAMILIES = ("lcg", "xorshift", "mt64")
PRNG_VARIANTS = {"lcg": len(lcg.ALL_VARIANTS), "xorshift": len(xorshift.VARIANT_NAMES),
                 "mt64": 1}


def _check_seeds(hi: torch.Tensor, lo: torch.Tensor):
    for name, t in (("hi", hi), ("lo", lo)):
        if t.dtype != torch.uint32 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous (N,) torch.uint32 tensor, "
                             f"got {tuple(t.shape)} {t.dtype}")
    if hi.shape != lo.shape:
        raise ValueError(f"hi {tuple(hi.shape)} and lo {tuple(lo.shape)} differ")
    check_same_device(hi, lo)


def _keys(slots) -> torch.Tensor:
    """A list of slots, each 8 int64-held words -> (S, 8, N) uint32."""
    return u32(torch.stack([torch.stack(list(k)) for k in slots]))


def _launch(kernel: Kernel, hi, lo, slots: int, *args) -> torch.Tensor:
    """One launch of ``kernel(hi, lo, *args, out, n)`` into a new (slots,
    8, N) output."""
    n = lo.shape[0]
    out = torch.empty((slots, 8, n), dtype=torch.uint32, device=lo.device)
    if n:
        kernel.launch(lo.device, hi.data_ptr(), lo.data_ptr(), *args, out.data_ptr(), n)
    return out


# --- keygen_hash: direct, sha256, double_sha256, md5 ---

def keygen_hash_plain(hi: torch.Tensor, lo: torch.Tensor, mode: str) -> torch.Tensor:
    """Plain version of ``keygen_hash``."""
    if mode not in HASH_MODES:
        raise ValueError(f"keygen_hash: unknown mode {mode!r}")
    h, l = i64(hi), i64(lo)
    z = torch.zeros_like(l)
    words, length = decimal_ascii_words_be(h, l)
    if mode == "direct":
        return _keys([[z] * 6 + [h, l], [byteswap32(l), byteswap32(h)] + [z] * 6,
                      words + [z] * 3])
    if mode == "md5":
        be = [byteswap32(w) for w in md5_single_block_varlen(words, length)]
        return _keys([be + be])
    keys = [sha256_single_block_varlen(words, length), sha256_words([h, l], 8),
            sha256_words([byteswap32(l), byteswap32(h)], 8)]
    if mode == "double_sha256":
        keys = [sha256_key_words(k) for k in keys]
    return _keys([[w + z for w in k] for k in keys])


def keygen_hash(hi: torch.Tensor, lo: torch.Tensor, mode: str) -> torch.Tensor:
    """(N,) uint32 seed words -> (S, 8, N) uint32 BE key words of ``mode``
    (``HASH_MODES``; S is ``HASH_SLOTS[mode]``)."""
    _check_seeds(hi, lo)
    if lo.device.type == "cpu":
        return keygen_hash_plain(hi, lo, mode)
    if mode not in HASH_MODES:
        raise ValueError(f"keygen_hash: unknown mode {mode!r}")
    return _launch(HASH_KERNEL, hi, lo, HASH_SLOTS[mode], HASH_MODES.index(mode))


# --- keygen_prng: lcg, xorshift, mt64 ---

def _variants(family: str, variant: int) -> list[int]:
    if family not in PRNG_FAMILIES:
        raise ValueError(f"keygen_prng: unknown family {family!r}")
    count = PRNG_VARIANTS[family]
    if not -1 <= variant < count:
        raise ValueError(f"keygen_prng: {family} has no variant {variant}")
    return list(range(count)) if variant < 0 else [variant]


def keygen_prng_plain(hi: torch.Tensor, lo: torch.Tensor, family: str, variant: int = -1,
                      big_endian: bool = True) -> torch.Tensor:
    """Plain version of ``keygen_prng``."""
    h, l = i64(hi), i64(lo)
    slots = []
    for v in _variants(family, variant):
        if family == "lcg":
            slots.append(lcg.lcg_key_words(l, lcg.ALL_VARIANTS[v], big_endian))
        elif family == "xorshift":
            slots.append(xorshift.KEY_FNS[xorshift.VARIANT_NAMES[v]](h, l))
        else:
            slots.append(mt19937.mt64_key_words_plain(h, l))
    return _keys(slots)


def keygen_prng(hi: torch.Tensor, lo: torch.Tensor, family: str, variant: int = -1,
                big_endian: bool = True) -> torch.Tensor:
    """(N,) uint32 seed words -> (S, 8, N) uint32 BE key words of ``family``
    (``PRNG_FAMILIES``): one slot of ``variant`` (its index in
    ``lcg.ALL_VARIANTS`` or ``xorshift.VARIANT_NAMES``), or with -1 one slot
    per variant in that order.  ``big_endian`` is the LCG outputs' byte
    order."""
    _check_seeds(hi, lo)
    if lo.device.type == "cpu":
        return keygen_prng_plain(hi, lo, family, variant, big_endian)
    slots = len(_variants(family, variant))
    return _launch(PRNG_KERNEL, hi, lo, slots, PRNG_FAMILIES.index(family), variant, slots,
                   int(big_endian))


# --- keygen_chain: sha256_chain ---

def _chain_variants(variant: int) -> list[str]:
    if not -1 <= variant < len(sha256_chain.VARIANTS):
        raise ValueError(f"keygen_chain: no variant {variant}")
    return list(sha256_chain.VARIANTS) if variant < 0 else [sha256_chain.VARIANTS[variant]]


def keygen_chain_plain(hi: torch.Tensor, lo: torch.Tensor, variant: int = -1,
                       depth: int = sha256_chain.DEFAULT_CHAIN_DEPTH) -> torch.Tensor:
    """Plain version of ``keygen_chain``."""
    h, l = i64(hi), i64(lo)
    words, length = decimal_ascii_words_be(h, l)
    four = torch.full_like(l, 4)
    slots = []
    for base, blen in ((words, length), ([l], four)):
        for v in _chain_variants(variant):
            slots += sha256_chain.chain(base, blen, v, depth)
    return _keys(slots)


def keygen_chain(hi: torch.Tensor, lo: torch.Tensor, variant: int = -1,
                 depth: int = sha256_chain.DEFAULT_CHAIN_DEPTH) -> torch.Tensor:
    """(N,) uint32 seed words -> (S, 8, N) uint32 BE key words, S = 2 x
    variants x ``depth``: the chains of ``variant`` (its index in
    ``sha256_chain.VARIANTS``, or -1 for all four in turn) over the seed's
    decimal string, then over its low word as 4 BE bytes."""
    _check_seeds(hi, lo)
    if lo.device.type == "cpu":
        return keygen_chain_plain(hi, lo, variant, depth)
    if not 1 <= depth < 10 ** 8:
        raise ValueError(f"keygen_chain: depth {depth} is out of range")
    return _launch(CHAIN_KERNEL, hi, lo, 2 * len(_chain_variants(variant)) * depth, variant,
                   depth)
