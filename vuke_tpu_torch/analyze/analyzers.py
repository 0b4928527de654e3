"""Reverse analyzers: key-origin detection by brute-force sweeps on the card.

The port of ``vuke_tpu/analyze/analyzers.py``: statuses, detail strings
and mask/cascade behaviour field for field (the reference's
analyze/{milksad,mt64,lcg,xorshift,sha256_chain,direct,heuristic}.rs).
The sweeps are ``analyze/sweeps.py``'s programs, S1 for milksad, mt64,
lcg and xorshift and S2 for sha256_chain, on ``AnalysisConfig.device``.
A found seed's full key is recomputed on the host by the plain keystreams.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from enum import Enum
from typing import List, Optional, Tuple

import torch

from ..cores import lcg as lcg_core, mt19937, sha256_chain, xorshift as xs_core
from ..cores.sha256_chain import DEFAULT_CHAIN_DEPTH, VARIANTS as CHAIN_VARIANTS
from . import sweeps
from .key_parser import apply_mask


def key_bytes_to_words(key: bytes) -> list:
    """32 key bytes -> 8 BE u32 words."""
    return [int.from_bytes(key[4 * i:4 * i + 4], "big") for i in range(8)]


def _key_bytes(words) -> bytes:
    """8 BE words (ints or one-lane tensors) -> 32 key bytes."""
    return b"".join((int(w) & 0xFFFFFFFF).to_bytes(4, "big") for w in words)


def _seed(seed: int) -> torch.Tensor:
    return torch.tensor([seed], dtype=torch.int64)


class AnalysisStatus(Enum):
    CONFIRMED = "confirmed"
    POSSIBLE = "possible"
    NOT_FOUND = "not_found"
    UNKNOWN = "unknown"

    def symbol(self) -> str:
        return {"confirmed": "✓", "possible": "?", "not_found": "✗",
                "unknown": "?"}[self.value]

    def as_str(self) -> str:
        return self.value


@dataclass
class AnalysisResult:
    analyzer: str
    status: AnalysisStatus
    details: Optional[str] = None


@dataclass
class AnalysisConfig:
    mask_bits: Optional[int] = None
    cascade_targets: Optional[List[Tuple[int, int]]] = None
    # bound open-ended 2^64 sweeps (None = unbounded, as the reference)
    max_seeds: Optional[int] = None
    batch: int = sweeps.DEFAULT_SWEEP_BATCH
    # durable sweep progress: manifest path for checkpoint/resume
    # (parallel/checkpoint.py; exceeds the reference, which restarts from 0)
    checkpoint_path: Optional[str] = None
    # where the sweeps run: "cuda" (S1 and S2) or "cpu" (their plain versions)
    device: str = "cuda"


def calculate_bit_length(key: bytes) -> int:
    v = int.from_bytes(key, "big")
    return v.bit_length()


@dataclass
class KeyMetadata:
    hex: str
    bit_length: int
    hamming_weight: int
    leading_zeros: int

    @classmethod
    def from_key(cls, key: bytes) -> "KeyMetadata":
        h = key.hex()
        v = int.from_bytes(key, "big")
        return cls(hex=h, bit_length=v.bit_length(),
                   hamming_weight=bin(v).count("1"),
                   leading_zeros=len(h) - len(h.lstrip("0")))


def _cascade_desc(targets) -> str:
    return ",".join(f"P{b}:0x{t:x}" for b, t in targets)


# ---------------------------------------------------------------------------
# milksad (MT19937, 2^32 exhaustive)
# ---------------------------------------------------------------------------

class MilksadAnalyzer:
    name = "milksad"
    supports_mask = True
    is_brute_force = True

    @staticmethod
    def _full_key(seed: int) -> bytes:
        return _key_bytes(mt19937.milksad_key_words_plain(
            torch.tensor([seed], dtype=torch.uint32))[:, 0])

    def analyze(self, key: bytes, config: AnalysisConfig, progress=None) -> AnalysisResult:
        total = 1 << 32
        if config.cascade_targets:
            prog = sweeps.SweepProgram("milksad", "cascade",
                                       cascade=config.cascade_targets,
                                       batch=config.batch, device=config.device)
            r = sweeps.dispatch_sweep(
                prog, 0, total - 1, progress=progress,
                max_seeds=config.max_seeds, config=config,
                job=f"milksad:cascade:{_cascade_desc(config.cascade_targets)}")
            if r.found:
                full = self._full_key(r.seed)
                return AnalysisResult(self.name, AnalysisStatus.CONFIRMED,
                                      f"seed = {r.seed}, cascade=[{_cascade_desc(config.cascade_targets)}], "
                                      f"first_key={full.hex()}")
            return AnalysisResult(self.name, AnalysisStatus.NOT_FOUND,
                                  f"checked {r.searched} seeds with cascade filter")
        if config.mask_bits:
            bits = config.mask_bits
            target = apply_mask(key, bits)
            prog = sweeps.SweepProgram("milksad", "mask", mask=(bits, target),
                                       batch=config.batch, device=config.device)
            r = sweeps.dispatch_sweep(
                prog, 0, total - 1, progress=progress,
                max_seeds=config.max_seeds, config=config,
                job=f"milksad:mask{bits}:{target:x}")
            if r.found:
                full = self._full_key(r.seed)
                mask = (1 << bits) - 1 if bits < 64 else (1 << 64) - 1
                high_bit = 1 << (bits - 1)
                return AnalysisResult(
                    self.name, AnalysisStatus.CONFIRMED,
                    f"seed = {r.seed}, full_key={full.hex()}, masked=0x{target:x}, "
                    f"mask_bits={bits}, formula=(key & 0x{mask:x}) | 0x{high_bit:x}")
            return AnalysisResult(self.name, AnalysisStatus.NOT_FOUND,
                                  f"checked {r.searched} seeds with {bits}-bit mask")
        prog = sweeps.SweepProgram("milksad", "exact", batch=config.batch,
                                   device=config.device)
        tw = key_bytes_to_words(key)
        r = sweeps.dispatch_sweep(prog, 0, total - 1, target_words=tw,
                                  progress=progress, max_seeds=config.max_seeds,
                                  config=config, job=f"milksad:exact:{key.hex()}")
        if r.found:
            return AnalysisResult(self.name, AnalysisStatus.CONFIRMED,
                                  f"seed = {r.seed}")
        return AnalysisResult(self.name, AnalysisStatus.NOT_FOUND,
                              f"checked {r.searched} seeds")


# ---------------------------------------------------------------------------
# mt64 (2^64, cascade-gated)
# ---------------------------------------------------------------------------

class Mt64Analyzer:
    name = "mt64"
    supports_mask = True
    is_brute_force = True

    def analyze(self, key: bytes, config: AnalysisConfig, progress=None) -> AnalysisResult:
        if not config.cascade_targets:
            return AnalysisResult(
                self.name, AnalysisStatus.UNKNOWN,
                "64-bit seed space (2^64) requires --cascade filter. "
                "Without cascade, brute-force is infeasible. "
                "Example: --cascade 5:0x15,10:0x202,20:0xd2c55")
        prog = sweeps.SweepProgram("mt64", "cascade",
                                   cascade=config.cascade_targets,
                                   batch=config.batch, track_first_filter=True,
                                   device=config.device)
        desc = _cascade_desc(config.cascade_targets)
        r = sweeps.dispatch_sweep(prog, 0, 2**64 - 1, progress=progress,
                                  max_seeds=config.max_seeds, config=config,
                                  job=f"mt64:cascade:{desc}")
        if r.found:
            return AnalysisResult(self.name, AnalysisStatus.CONFIRMED,
                                  f"seed = {r.seed}, cascade=[{desc}]")
        return AnalysisResult(
            self.name, AnalysisStatus.NOT_FOUND,
            f"searched {r.searched} seeds in {r.elapsed:.2f}s, cascade=[{desc}], "
            f"cascade_hits={r.cascade_hits}")


# ---------------------------------------------------------------------------
# lcg (per-variant exhaustive up to max_seed)
# ---------------------------------------------------------------------------

class LcgAnalyzer:
    name = "lcg"
    supports_mask = True
    is_brute_force = True

    def __init__(self, variant=None, big_endian: bool = True):
        self.variants = [variant] if variant else list(lcg_core.ALL_VARIANTS)
        self.big_endian = big_endian

    def analyze(self, key: bytes, config: AnalysisConfig, progress=None) -> AnalysisResult:
        endian = "be" if self.big_endian else "le"
        checked = 0
        for v in self.variants:
            vi = lcg_core.ALL_VARIANTS.index(v)
            space_end = min(v.max_seed, 2**32 - 1)
            if config.mask_bits:
                bits = config.mask_bits
                target = apply_mask(key, bits)
                prog = sweeps.SweepProgram("lcg", "mask", mask=(bits, target),
                                           batch=config.batch, variant=vi,
                                           big_endian=self.big_endian, device=config.device)
                r = sweeps.dispatch_sweep(
                    prog, 0, space_end, progress=progress,
                    max_seeds=config.max_seeds, config=config,
                    job=f"lcg:{v.name}:{endian}:mask{bits}:{target:x}")
                if r.found:
                    kb = self._key_for_seed(r.seed, v)
                    mask = (1 << bits) - 1 if bits < 64 else (1 << 64) - 1
                    high_bit = 1 << (bits - 1)
                    return AnalysisResult(
                        self.name, AnalysisStatus.CONFIRMED,
                        f"variant={v.name}, seed={r.seed}, full_key={kb.hex()}, "
                        f"masked=0x{target:x}, mask_bits={bits}, endian={endian}, "
                        f"formula=(key & 0x{mask:x}) | 0x{high_bit:x}")
            else:
                prog = sweeps.SweepProgram("lcg", "exact", batch=config.batch, variant=vi,
                                           big_endian=self.big_endian, device=config.device)
                tw = key_bytes_to_words(key)
                r = sweeps.dispatch_sweep(
                    prog, 0, space_end, target_words=tw, progress=progress,
                    max_seeds=config.max_seeds, config=config,
                    job=f"lcg:{v.name}:{endian}:exact:{key.hex()}")
                if r.found:
                    return AnalysisResult(
                        self.name, AnalysisStatus.CONFIRMED,
                        f"variant={v.name}, seed={r.seed}, endian={endian}")
            checked += r.searched
        names = ", ".join(v.name for v in self.variants)
        return AnalysisResult(self.name, AnalysisStatus.NOT_FOUND,
                              f"checked {checked} seeds across variants: {names}")

    def _key_for_seed(self, seed: int, variant) -> bytes:
        return _key_bytes(lcg_core.lcg_key_words(_seed(seed), variant, self.big_endian))


# ---------------------------------------------------------------------------
# xorshift (2^64, cascade-gated)
# ---------------------------------------------------------------------------

class XorshiftAnalyzer:
    name = "xorshift"
    supports_mask = True
    is_brute_force = True

    def __init__(self, variant: Optional[str] = None):
        self.variants = [variant] if variant else list(xs_core.VARIANT_NAMES)

    def analyze(self, key: bytes, config: AnalysisConfig, progress=None) -> AnalysisResult:
        if not config.cascade_targets:
            return AnalysisResult(
                self.name, AnalysisStatus.UNKNOWN,
                "64-bit seed space requires --cascade filter. "
                "Example: --cascade 5:0x15,10:0x202,20:0xd2c55")
        for vname in self.variants:
            prog = sweeps.SweepProgram("xorshift", "cascade",
                                       cascade=config.cascade_targets,
                                       batch=config.batch,
                                       variant=xs_core.VARIANT_NAMES.index(vname),
                                       device=config.device)
            r = sweeps.dispatch_sweep(
                prog, 0, 2**64 - 1, progress=progress,
                max_seeds=config.max_seeds, config=config,
                job=f"xorshift:{vname}:cascade:"
                    f"{_cascade_desc(config.cascade_targets)}")
            if r.found:
                return AnalysisResult(
                    self.name, AnalysisStatus.CONFIRMED,
                    f"variant={vname}, seed={r.seed}, "
                    f"cascade=[{_cascade_desc(config.cascade_targets)}]")
        names = ", ".join(self.variants)
        return AnalysisResult(
            self.name, AnalysisStatus.NOT_FOUND,
            f"checked variants=[{names}], "
            f"cascade=[{_cascade_desc(config.cascade_targets)}]")


# ---------------------------------------------------------------------------
# sha256_chain (2^32 u32 seeds x variants x chain positions)
# ---------------------------------------------------------------------------

class Sha256ChainAnalyzer:
    name = "sha256_chain"
    supports_mask = True
    is_brute_force = True

    def __init__(self, variant: Optional[str] = None,
                 chain_depth: int = DEFAULT_CHAIN_DEPTH):
        self.variants = [variant] if variant else list(CHAIN_VARIANTS)
        self.chain_depth = chain_depth

    def analyze(self, key: bytes, config: AnalysisConfig, progress=None) -> AnalysisResult:
        total = 0
        names = ", ".join(self.variants)
        batch = max(1, config.batch // 4)
        for v in self.variants:
            depth = self.chain_depth
            decode = lambda bstart, idx: (bstart + idx // depth, idx % depth)
            if config.cascade_targets:
                n_t = len(config.cascade_targets)
                # cascade generates a chain of exactly n_t keys per seed and
                # maps position i -> target i (sha256_chain.rs:331-358)
                prog = sweeps.ChainSweepProgram(v, n_t, "cascade",
                                                cascade=config.cascade_targets,
                                                batch=batch, device=config.device)
                dec = lambda bstart, idx: (bstart + idx, 0)
                r = sweeps.dispatch_sweep(
                    prog, 0, 2**32 - 1, progress=progress,
                    max_seeds=config.max_seeds, decode=dec, config=config,
                    job=f"sha256_chain:{v}:cascade:"
                        f"{_cascade_desc(config.cascade_targets)}")
                total += r.searched
                if r.found:
                    seed, index = r.seed
                    return AnalysisResult(
                        self.name, AnalysisStatus.CONFIRMED,
                        f"seed={seed} (0x{seed:08x}), variant={v}, "
                        f"chain_index={index}, "
                        f"cascade=[{_cascade_desc(config.cascade_targets)}]")
            elif config.mask_bits:
                bits = config.mask_bits
                target = apply_mask(key, bits)
                prog = sweeps.ChainSweepProgram(v, depth, "mask", mask=(bits, target),
                                                batch=batch, device=config.device)
                r = sweeps.dispatch_sweep(
                    prog, 0, 2**32 - 1, progress=progress,
                    max_seeds=config.max_seeds, decode=decode, config=config,
                    job=f"sha256_chain:{v}:mask{bits}:{target:x}")
                total += r.searched
                if r.found:
                    seed, index = r.seed
                    s = _seed(seed)
                    kw = sha256_chain.chain([s], torch.full_like(s, 4), v, index + 1)[index]
                    return AnalysisResult(
                        self.name, AnalysisStatus.CONFIRMED,
                        f"seed={seed} (0x{seed:08x}), variant={v}, chain_index={index}, "
                        f"full_key={_key_bytes(kw).hex()}, mask_bits={bits}")
            else:
                prog = sweeps.ChainSweepProgram(v, depth, "exact", batch=batch,
                                                device=config.device)
                tw = key_bytes_to_words(key)
                r = sweeps.dispatch_sweep(
                    prog, 0, 2**32 - 1, target_words=tw, progress=progress,
                    max_seeds=config.max_seeds, decode=decode, config=config,
                    job=f"sha256_chain:{v}:exact:{key.hex()}")
                total += r.searched
                if r.found:
                    seed, index = r.seed
                    return AnalysisResult(
                        self.name, AnalysisStatus.CONFIRMED,
                        f"seed={seed} (0x{seed:08x}), variant={v}, chain_index={index}")
        if config.cascade_targets:
            return AnalysisResult(
                self.name, AnalysisStatus.NOT_FOUND,
                f"checked {total} seeds, variants=[{names}], "
                f"cascade=[{_cascade_desc(config.cascade_targets)}]")
        if config.mask_bits:
            return AnalysisResult(
                self.name, AnalysisStatus.NOT_FOUND,
                f"checked {total} seeds with {config.mask_bits}-bit mask, "
                f"variants=[{names}], chain_depth={self.chain_depth}")
        return AnalysisResult(
            self.name, AnalysisStatus.NOT_FOUND,
            f"checked {total} seeds, variants=[{names}], "
            f"chain_depth={self.chain_depth}")


# ---------------------------------------------------------------------------
# direct / heuristic (host-side pattern detection)
# ---------------------------------------------------------------------------

class DirectAnalyzer:
    name = "direct"
    supports_mask = False
    is_brute_force = False

    def analyze(self, key: bytes, config: AnalysisConfig, progress=None) -> AnalysisResult:
        if config.mask_bits:
            return AnalysisResult(self.name, AnalysisStatus.UNKNOWN,
                                  "masked analysis not supported")
        obs = []
        leading = len(key) - len(key.lstrip(b"\x00"))
        trailing = len(key) - len(key.rstrip(b"\x00"))
        bit_length = calculate_bit_length(key)
        if bit_length <= 64:
            obs.append(f"bit_length={bit_length}, fits in u64")
        if leading >= 24:
            obs.append(f"BE padding detected ({leading} leading zero bytes)")
        if trailing >= 24:
            obs.append(f"LE padding detected ({trailing} trailing zero bytes)")
        s = self._ascii_string(key)
        if s is not None:
            obs.append(f'ASCII string: "{s}"')
        if obs:
            return AnalysisResult(self.name, AnalysisStatus.POSSIBLE, ", ".join(obs))
        return AnalysisResult(self.name, AnalysisStatus.NOT_FOUND,
                              "no direct patterns detected")

    @staticmethod
    def _ascii_string(key: bytes) -> Optional[str]:
        non_null = key.split(b"\x00", 1)[0]
        if not 3 <= len(non_null) <= 31:
            return None
        if any(b != 0 for b in key[len(non_null):]):
            return None
        if all(0x20 <= b <= 0x7E for b in non_null):
            return non_null.decode("ascii")
        return None


class HeuristicAnalyzer:
    name = "heuristic"
    supports_mask = False
    is_brute_force = False

    def analyze(self, key: bytes, config: AnalysisConfig, progress=None) -> AnalysisResult:
        if config.mask_bits:
            return AnalysisResult(self.name, AnalysisStatus.UNKNOWN,
                                  "masked analysis not supported")
        entropy = self._byte_entropy(key)
        hamming = bin(int.from_bytes(key, "big")).count("1")
        obs = []
        if entropy < 4.0:
            obs.append(f"low entropy ({entropy:.2f})")
        if not 104 <= hamming <= 152:
            obs.append(f"unusual hamming weight ({hamming})")
        if self._has_repeating_pattern(key):
            obs.append("repeating byte pattern")
        if obs:
            return AnalysisResult(self.name, AnalysisStatus.POSSIBLE, ", ".join(obs))
        return AnalysisResult(self.name, AnalysisStatus.UNKNOWN,
                              f"entropy={entropy:.2f}, hamming={hamming}")

    @staticmethod
    def _byte_entropy(data: bytes) -> float:
        counts = {}
        for b in data:
            counts[b] = counts.get(b, 0) + 1
        n = len(data)
        return -sum((c / n) * math.log2(c / n) for c in counts.values())

    @staticmethod
    def _has_repeating_pattern(key: bytes) -> bool:
        for plen in range(1, 9):
            if 32 % plen == 0:
                pattern = key[:plen]
                if (all(key[i:i + plen] == pattern for i in range(0, 32, plen))
                        and not all(b == pattern[0] for b in pattern)):
                    return True
        return False
