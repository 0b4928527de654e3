"""Puzzle-data provider: ``boha:...`` references resolved to addresses,
single-puzzle contexts, cascades and key verification.

The port's copy of ``vuke_tpu/provider.py`` (the reference's
``provider.rs:61-476``), with its grammar, results and error texts:
  ``boha:collection``            -> unsolved addresses (default filter)
  ``boha:collection:filter``     -> address list (all, unsolved, solved,
                                    with-pubkey = unsolved AND pubkey known)
  ``boha:all:filter``            -> filtered addresses across every collection
  ``boha:collection:id[:n]``     -> single puzzle context (auto mask bits +
                                    expected address; ``:n`` builds a cascade
                                    from n solved below-neighbors)

The puzzle data is the local JSON dataset ``vuke_tpu_torch/data/
puzzles.json`` (a byte-identical copy of the JAX package's), or the file
that ``VUKE_TPU_PUZZLE_DATA`` names.  Entries whose address could not be
reproduced offline carry ``address: null``: they count toward collection
totals but are skipped by address listings.  ``verify_key`` derives the
key's addresses with the port's host ``derive.KeyDeriver``.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import List, Optional

_DATA_PATH = os.path.join(os.path.dirname(__file__), "data", "puzzles.json")

FILTERS = ("all", "unsolved", "solved", "with-pubkey")


@dataclass
class Puzzle:
    id: object  # int for b1000, str for named bounties (e.g. "sha1")
    bits: Optional[int]
    address: Optional[str]
    solved: bool = False
    pubkey: Optional[str] = None
    key_hex: Optional[str] = None
    prize: Optional[float] = None
    provenance: Optional[str] = None


@dataclass
class PuzzleContext:
    """Single-puzzle analysis context (provider.rs:23-34)."""
    puzzle: Puzzle
    collection: str
    mask_bits: Optional[int] = None
    cascade_targets: List[tuple] = field(default_factory=list)  # (bits, target)

    @property
    def expected_address(self) -> Optional[str]:
        return self.puzzle.address

    @property
    def has_pubkey(self) -> bool:
        return self.puzzle.pubkey is not None


@dataclass
class ProviderResult:
    addresses: List[str]
    description: str
    context: Optional[PuzzleContext] = None
    # entries that matched the query but ship address: null in the offline
    # dataset ("unavailable-offline" provenance) — surfaced so callers can
    # warn/error instead of silently scanning against nothing
    skipped_offline: int = 0


@dataclass
class VerifyMatch:
    """One matching puzzle from verify_key (provider.rs:37-49)."""
    puzzle: Puzzle
    collection: str
    address_type: str


@dataclass
class VerifyReport:
    """verify_key result (provider.rs:52-58)."""
    matches: List[VerifyMatch]
    total_checked: int


class _Dataset:
    def __init__(self):
        self._collections = None
        self._path = None

    def load(self):
        path = os.environ.get("VUKE_TPU_PUZZLE_DATA", _DATA_PATH)
        if self._collections is not None and path == self._path:
            return self._collections
        self._path = path
        if not os.path.exists(path):
            self._collections = {}
            return self._collections
        with open(path) as f:
            raw = json.load(f)
        self._collections = {
            name: [Puzzle(**p) for p in ps] for name, ps in raw.items()
        }
        return self._collections


_DATASET = _Dataset()


def is_provider(s: str) -> bool:
    """True iff ``s`` is a provider reference (provider.rs:61-71): a known
    provider name before the first ':' — single letters are drive prefixes."""
    head, sep, _ = s.partition(":")
    return bool(sep) and len(head) > 1 and head == "boha"


def _collection(name: str) -> List[Puzzle]:
    cols = _DATASET.load()
    if name not in cols:
        avail = ", ".join(sorted(cols)) or "(no dataset loaded — set VUKE_TPU_PUZZLE_DATA)"
        raise ValueError(f"Unknown collection '{name}'. Available: {avail}")
    return cols[name]


def _filter_fn(selector: str):
    """Status filters (provider.rs:220-232): with-pubkey means *unsolved*
    puzzles whose pubkey is known."""
    if selector == "all":
        return lambda p: True
    if selector == "unsolved":
        return lambda p: not p.solved
    if selector == "solved":
        return lambda p: p.solved
    if selector == "with-pubkey":
        return lambda p: not p.solved and p.pubkey is not None
    raise ValueError(
        f"Unknown filter: '{selector}'. Valid: {', '.join(FILTERS)}")


def _addresses(puzzles: List[Puzzle], selector: str):
    """(addresses, skipped_offline) for a filter over a collection."""
    fn = _filter_fn(selector)
    sel = [p for p in puzzles if fn(p)]
    return ([p.address for p in sel if p.address],
            sum(1 for p in sel if not p.address))


def resolve(s: str) -> Optional[ProviderResult]:
    """Resolve a provider reference to addresses, or None if ``s`` is not a
    provider reference (then it is treated as a file path).
    Mirrors provider.rs:155-214."""
    if not is_provider(s):
        return None
    query = s.split(":", 1)[1]
    parts = query.split(":") if query else [""]

    # numeric id (2 or 3 parts) -> single puzzle context (provider.rs:159-183)
    if len(parts) in (2, 3) and parts[1].isdigit():
        coll_name, pid = parts[0], int(parts[1])
        puzzles = _collection(coll_name)
        pz = next((p for p in puzzles if p.id == pid), None)
        if pz is None:
            raise ValueError(f"No puzzle id {pid} in collection {coll_name}")
        ctx = PuzzleContext(puzzle=pz, collection=coll_name,
                            mask_bits=pz.bits)
        if len(parts) == 3:
            ctx.cascade_targets = build_cascade(coll_name, pid, int(parts[2]))
        return ProviderResult(
            addresses=[pz.address] if pz.address else [],
            description=f"boha:{coll_name}/{pid}", context=ctx,
            skipped_offline=0 if pz.address else 1)

    # "all" pseudo-collection (provider.rs:185-192)
    if len(parts) == 2 and parts[0] == "all":
        fn = _filter_fn(parts[1])
        sel = [p for ps in _DATASET.load().values() for p in ps if fn(p)]
        addrs = [p.address for p in sel if p.address]
        return ProviderResult(
            addresses=addrs,
            description=f"boha:all:{parts[1]} ({len(addrs)} puzzles)",
            skipped_offline=sum(1 for p in sel if not p.address))

    if len(parts) == 2:
        coll_name, selector = parts
    elif len(parts) == 1:
        # bare collection defaults to the unsolved filter (provider.rs:200-207)
        coll_name, selector = parts[0], "unsolved"
    else:
        raise ValueError(
            f"Invalid boha query: '{query}'. Expected: collection:filter, "
            f"collection:id, or collection:id:neighbors")
    addrs, skipped = _addresses(_collection(coll_name), selector)
    return ProviderResult(
        addresses=addrs,
        description=f"boha:{coll_name}:{selector} ({len(addrs)} puzzles)",
        skipped_offline=skipped)


def build_cascade(coll_name: str, pid: int, neighbors: int = 5) -> List[tuple]:
    """Cascade targets from solved below-neighbor puzzles: (bits,
    masked_key_u64) sorted ascending by bits (provider.rs:330-396).

    The reference walks ids pid-1 down to pid-neighbors, keeping solved
    puzzles with a known key and 0 < bits < 64; the mask formula matches the
    analyzers: (key & (2^bits - 1)) | 2^(bits-1) over the low 8 key bytes
    (the reference's analyze/milksad.rs:146-189).
    """
    if coll_name != "b1000":
        raise ValueError("Cascade is only supported for b1000 collection")
    by_id = {p.id: p for p in _collection(coll_name)}
    out = []
    for n in range(pid - 1, max(pid - neighbors, 1) - 1, -1):
        p = by_id.get(n)
        if p is None or not p.solved or not p.key_hex:
            continue
        bits = p.bits
        if not bits or not 0 < bits < 64:
            continue
        low64 = int(p.key_hex, 16) & 0xFFFFFFFFFFFFFFFF
        out.append((bits, (low64 & ((1 << bits) - 1)) | (1 << (bits - 1))))
    out.sort(key=lambda t: t[0])
    if not out:
        raise ValueError(
            f"No solved puzzles with known keys found for cascade. "
            f"Need puzzles < {pid} to be solved.")
    return out


def parse_cascade_ref(s: str) -> Optional[List[tuple]]:
    """Parse a ``boha:b1000:66[:n]`` cascade reference (provider.rs:100-115).
    Returns None if ``s`` is not a provider reference."""
    if not is_provider(s):
        return None
    parts = s.split(":")[1:]
    if len(parts) == 2:
        return build_cascade(parts[0], int(parts[1]), 5)
    if len(parts) == 3:
        return build_cascade(parts[0], int(parts[1]), int(parts[2]))
    raise ValueError(
        f"Invalid cascade query: '{s}'. Expected: collection:id or "
        f"collection:id:neighbors")


def verify_key(key: bytes, coll_name: str) -> VerifyReport:
    """Check a key's three addresses against a collection (or ``all``),
    returning every matching puzzle plus the total checked
    (provider.rs:398-476)."""
    from .derive import KeyDeriver
    cols = _DATASET.load()
    if coll_name == "all":
        puzzles = [(c, p) for c, ps in cols.items() for p in ps]
    else:
        puzzles = [(coll_name, p) for p in _collection(coll_name)]
    derived = KeyDeriver().derive(key)
    matches = []
    for coll, p in puzzles:
        if not p.address:
            continue
        if p.address == derived.p2pkh_compressed:
            kind = "p2pkh_compressed"
        elif p.address == derived.p2pkh_uncompressed:
            kind = "p2pkh_uncompressed"
        elif p.address == derived.p2wpkh:
            kind = "p2wpkh"
        else:
            continue
        matches.append(VerifyMatch(puzzle=p, collection=coll, address_type=kind))
    return VerifyReport(matches=matches, total_checked=len(puzzles))
