"""The reverse sweeps' kernels: keystream and compare fused, one record a
batch.

- S1, ``sweep_prng`` (``csrc/sweep_prng.cu``): the PRNG families milksad
  (MT19937), mt64 (MT19937-64), lcg (four variants, BE or LE) and xorshift
  (four variants) over the u64 seed lattice ``start + i`` of a batch;
- S2, ``sweep_chain`` (``csrc/sweep_chain.cu``): the four sha256_chain
  variants over the u32 seeds ``start + i`` (wrapping), as 4 BE bytes.

They replace the jitted steps of ``vuke_tpu/analyze/sweeps.py``'s
``SweepProgram`` and ``ChainSweepProgram``.  A ``Compare`` says what each
key is held against: "exact" (the 8 words of the key), "mask" (one
``(bits, target)``: ``(low64 & (2^bits - 1)) | 2^(bits - 1) == target``
over key words 6 and 7) or "cascade" (key j, or chain position j, against
target j, for every j).  Each writes a (2,) int64 record: the batch's first
hit, as the JAX step's argmax of its flat ``ok`` (S1: the lane; S2: lane x
depth + position, or the lane in a cascade), or ``NONE``; and, when the
compare tracks it, the number of lanes that pass target 0.  A cascade
holds any number of targets, as the JAX package's does: target 0 travels
with the launch, the rest in a device buffer uploaded once a compare and
device (``device_targets``).

A record on the card is filled by the kernel; a record on the CPU by the
plain version beside it (``*_plain``): the port's plain keystreams
(``mt19937``, ``lcg``, ``xorshift``, ``sha256_chain``) and the compare in
torch.  Nothing falls back from one to the other: a failed launch raises.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from .._device import MASK32, byteswap32, device_key
from ..kernels import INT, PTR, SIZE, U32, Kernel
from . import lcg, mt19937, sha256_chain, xorshift

FAMILIES = ("milksad", "mt64", "lcg", "xorshift")
MODES = ("exact", "mask", "cascade")
CHAIN_VARIANTS = sha256_chain.VARIANTS
MAX_LANES = 1 << 32          # a batch's lanes: offsets are u32
NONE = -1                    # record[0] of a batch without a hit

PRNG_KERNEL = Kernel(
    "sweep_prng", "vk_sweep_prng",
    [U32, U32, SIZE, INT, INT, INT, INT, INT, INT, PTR, PTR, PTR],
    source="vuke_tpu_torch/csrc/sweep_prng.cu",
    replaces="vuke_tpu/analyze/sweeps.py:79 SweepProgram (XLA) with "
             "vuke_tpu/cores/pallas_kernels.py:46 _mt_kernel")
CHAIN_KERNEL = Kernel(
    "sweep_chain", "vk_sweep_chain", [U32, SIZE, INT, INT, INT, INT, PTR, PTR, PTR],
    source="vuke_tpu_torch/csrc/sweep_chain.cu",
    replaces="vuke_tpu/analyze/sweeps.py:139 ChainSweepProgram (XLA, "
             "vuke_tpu/cores/sha256_chain.py:74)")


def mask_words(bits: int, target: int) -> tuple:
    """A mask target as the kernels take it: the mask of the low 64 bits,
    the high bit or-ed in and the target, each as (hi, lo) u32."""
    if not 1 <= bits <= 64:
        raise ValueError(f"mask bits {bits} outside 1..64")
    mask = (1 << bits) - 1 if bits < 64 else (1 << 64) - 1
    high = 1 << (bits - 1)
    target &= (1 << 64) - 1
    return (mask >> 32, mask & MASK32, high >> 32, high & MASK32, target >> 32,
            target & MASK32)


@dataclass(frozen=True)
class Compare:
    """What a sweep holds each key against: ``mode`` "exact" with the 8 BE
    ``words`` of the key; "mask" with one ``(bits, target)`` in
    ``targets``; "cascade" with key j against ``targets[j]``.  ``track``
    counts the lanes that pass target 0 (mask and cascade)."""
    mode: str
    words: tuple = ()
    targets: tuple = ()
    track: bool = False

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"sweep: unknown compare mode {self.mode!r}")
        if self.mode == "exact":
            if len(self.words) != 8 or self.track:
                raise ValueError("sweep: exact compares 8 key words and tracks nothing")
        elif not self.targets or (self.mode == "mask" and len(self.targets) != 1):
            want = "one target" if self.mode == "mask" else "one target or more"
            raise ValueError(f"sweep: {self.mode} takes {want}, got {len(self.targets)}")

    @property
    def n_targets(self) -> int:
        return 1 if self.mode == "exact" else len(self.targets)

    @functools.cached_property
    def packed(self) -> np.ndarray:
        """The kernels' target words (csrc/sweep.cuh): the 8 words of an
        exact key, or 6 words a mask or cascade target."""
        if self.mode == "exact":
            return np.array([int(w) & MASK32 for w in self.words], dtype=np.uint32)
        return np.array([w for bits, target in self.targets for w in mask_words(bits, target)],
                        dtype=np.uint32)

    @functools.cached_property
    def target0(self) -> np.ndarray:
        """Target 0 as the launch takes it: 8 host words."""
        out = np.zeros(8, dtype=np.uint32)
        w = self.packed[:8 if self.mode == "exact" else 6]
        out[:len(w)] = w
        return out


@functools.lru_cache(maxsize=16)
def device_targets(compare: Compare, device: str):
    """``compare.packed`` on ``device``, uploaded once (a sweep launches a
    batch after a batch with the same compare); None for exact."""
    if compare.mode == "exact":
        return None
    return torch.from_numpy(compare.packed.view(np.int32)).to(device)


def _targets_ptr(compare: Compare, device: torch.device) -> int:
    t = device_targets(compare, device_key(device))
    return 0 if t is None else t.data_ptr()


def _check_record(record: torch.Tensor):
    if record.dtype != torch.int64 or record.shape != (2,) or not record.is_contiguous():
        raise ValueError(f"record: expected a contiguous (2,) torch.int64 tensor, got "
                         f"{tuple(record.shape)} {record.dtype}")
    if record.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {record.device}")


def _check_batch(start: int, limit: int):
    if not 0 <= start < 1 << 64 or not 0 <= limit <= MAX_LANES:
        raise ValueError(f"sweep: start {start} or limit {limit} out of range")


def mask_ok(key, bits: int, target: int) -> torch.Tensor:
    """Which lanes' key (8 int64 word tensors) pass the mask target."""
    m_hi, m_lo, h_hi, h_lo, t_hi, t_lo = mask_words(bits, target)
    return (((key[6] & m_hi) | h_hi) == t_hi) & (((key[7] & m_lo) | h_lo) == t_lo)


def _cascade_ok(keys_of, targets) -> tuple:
    """(ok, first) of a cascade over every lane: target 0 held against key 0
    of every lane (``keys_of(None, 1)``), the rest against the keys of the
    lanes that pass it (``keys_of(index, len(targets))``, their streams from
    the seed), as the kernels go on only for those lanes."""
    first = mask_ok(keys_of(None, 1)[0], *targets[0])
    ok = first.clone()
    idx = torch.nonzero(first).flatten()
    if len(targets) > 1 and idx.numel():
        keys = keys_of(idx, len(targets))
        ok[idx] = functools.reduce(torch.logical_and, [
            mask_ok(k, bits, t) for k, (bits, t) in zip(keys[1:], targets[1:])])
    return ok, first


def _fill(record: torch.Tensor, ok: torch.Tensor, first=None):
    """Record the first set entry of the flat ``ok`` and the count of
    ``first``."""
    hits = torch.nonzero(ok.reshape(-1))
    record[0] = int(hits[0, 0]) if hits.numel() else NONE
    record[1] = int(first.sum()) if first is not None else 0


def _prng_check(family: str, variant: int, compare: Compare):
    if family not in FAMILIES:
        raise ValueError(f"sweep_prng: unknown family {family!r}")
    if not 0 <= variant < {"lcg": len(lcg.ALL_VARIANTS),
                           "xorshift": len(xorshift.VARIANT_NAMES)}.get(family, 1):
        raise ValueError(f"sweep_prng: {family} has no variant {variant}")
    if family == "lcg" and compare.mode == "cascade":
        raise ValueError("sweep_prng: an LCG stream holds one key; no cascade")


def prng_keys_plain(family: str, variant: int, big_endian: bool, hi: torch.Tensor,
                    lo: torch.Tensor, n_keys: int = 1) -> list:
    """The first ``n_keys`` keys of each int64-held (hi, lo) seed's stream,
    each a list of 8 int64 BE word tensors."""
    if family == "milksad":
        words = [byteswap32(x) for x in mt19937.mt19937_outputs_plain(lo, 8 * n_keys)]
    elif family == "mt64":
        words = mt19937.mt64_key_words_plain(hi, lo, n_keys)
    elif family == "lcg":
        words = lcg.lcg_key_words(lo, lcg.ALL_VARIANTS[variant], big_endian)
    else:
        words = xorshift.KEY_FNS[xorshift.VARIANT_NAMES[variant]](hi, lo, n_keys)
    return [words[8 * j:8 * j + 8] for j in range(n_keys)]


def sweep_prng_plain(record: torch.Tensor, start: int, limit: int, family: str, variant: int,
                     big_endian: bool, compare: Compare) -> torch.Tensor:
    """Plain version of ``sweep_prng`` (torch ops on the record's device)."""
    _prng_check(family, variant, compare)
    offs = torch.arange(limit, dtype=torch.int64, device=record.device)
    lo = (start & MASK32) + offs
    hi = ((start >> 32) + (lo >> 32)) & MASK32
    lo = lo & MASK32
    if compare.mode == "exact":
        ok = torch.ones(limit, dtype=torch.bool, device=record.device)
        for w, t in zip(prng_keys_plain(family, variant, big_endian, hi, lo)[0], compare.words):
            ok &= w == int(t)
        _fill(record, ok)
        return record
    ok, first = _cascade_ok(
        lambda idx, n: prng_keys_plain(family, variant, big_endian,
                                       hi if idx is None else hi[idx],
                                       lo if idx is None else lo[idx], n),
        compare.targets)
    _fill(record, ok, first if compare.track else None)
    return record


def sweep_prng(record: torch.Tensor, start: int, limit: int, family: str, variant: int = 0,
               big_endian: bool = True, compare: Compare = None) -> torch.Tensor:
    """One batch of a PRNG sweep: seeds ``start + i`` (u64, carried) for
    lanes i < ``limit``, each seed's keys of ``family`` (``variant``: the
    LCG's index in ``lcg.ALL_VARIANTS`` or the generator's in
    ``xorshift.VARIANT_NAMES``; ``big_endian``: the LCG outputs' byte
    order) held against ``compare``; the result into ``record``, a (2,)
    int64 tensor, which is returned.  A CUDA record is filled by S1, a CPU
    record by the plain version."""
    _check_record(record)
    _check_batch(start, limit)
    if record.device.type == "cpu":
        return sweep_prng_plain(record, start, limit, family, variant, big_endian, compare)
    _prng_check(family, variant, compare)
    PRNG_KERNEL.launch(record.device, start >> 32, start & MASK32, limit,
                       FAMILIES.index(family), variant, int(big_endian),
                       MODES.index(compare.mode), compare.n_targets, int(compare.track),
                       compare.target0.ctypes.data, _targets_ptr(compare, record.device),
                       record.data_ptr())
    return record


def _chain_check(variant: str, depth: int, compare: Compare):
    if variant not in CHAIN_VARIANTS:
        raise ValueError(f"sweep_chain: unknown variant {variant!r}")
    if not 1 <= depth < 10 ** 8:
        raise ValueError(f"sweep_chain: depth {depth} is out of range")
    if compare.track:
        raise ValueError("sweep_chain: tracks nothing")


def sweep_chain_plain(record: torch.Tensor, start: int, limit: int, variant: str, depth: int,
                      compare: Compare) -> torch.Tensor:
    """Plain version of ``sweep_chain`` (torch ops on the record's device)."""
    _chain_check(variant, depth, compare)
    seeds = ((start & MASK32) + torch.arange(limit, dtype=torch.int64,
                                             device=record.device)) & MASK32
    if compare.mode == "cascade":
        def keys_of(idx, n):
            s = seeds if idx is None else seeds[idx]
            return sha256_chain.chain([s], torch.full_like(s, 4), variant, n)
        _fill(record, _cascade_ok(keys_of, compare.targets)[0])
        return record
    keys = sha256_chain.chain([seeds], torch.full_like(seeds, 4), variant, depth)
    okm = torch.ones((limit, depth), dtype=torch.bool, device=record.device)
    for d, k in enumerate(keys):
        if compare.mode == "exact":
            for w, t in zip(k, compare.words):
                okm[:, d] &= w == int(t)
        else:
            okm[:, d] = mask_ok(k, *compare.targets[0])
    _fill(record, okm)
    return record


def sweep_chain(record: torch.Tensor, start: int, limit: int, variant: str,
                depth: int = sha256_chain.DEFAULT_CHAIN_DEPTH,
                compare: Compare = None) -> torch.Tensor:
    """One batch of a sha256_chain sweep: u32 seeds ``start + i`` (wrapping)
    for lanes i < ``limit``, ``depth`` chain positions of ``variant`` each
    (a cascade: one a target), held against ``compare``; the result into
    ``record``, which is returned.  A CUDA record is filled by S2, a CPU
    record by the plain version."""
    _check_record(record)
    _check_batch(start, limit)
    if record.device.type == "cpu":
        return sweep_chain_plain(record, start, limit, variant, depth, compare)
    _chain_check(variant, depth, compare)
    CHAIN_KERNEL.launch(record.device, start & MASK32, limit, CHAIN_VARIANTS.index(variant),
                        depth, MODES.index(compare.mode), compare.n_targets,
                        compare.target0.ctypes.data, _targets_ptr(compare, record.device),
                        record.data_ptr())
    return record
