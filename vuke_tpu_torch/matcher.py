"""Target matching on the device: exact membership of 8-byte fragments.

Port of ``vuke_tpu.matcher.DeviceTargetSet``'s device side.  Target
addresses decode to hash160s once (``encode.decode_address_h160``);
the first 8 bytes of each, read big-endian, are packed as ONE int64
``(hi << 32) | lo`` in two's complement.  Two pools, as in
``matcher.py:93-111``: the compressed pool holds every address (p2pkh and
p2wpkh both fire on the compressed hash160), the uncompressed pool only
p2pkh ones.

Each pool is sorted in *signed* int64 order: membership needs a consistent
order, not the unsigned one.  A lookup is ``torch.searchsorted``, a clamp,
and an equality test.  The TPU's compare-all branch (``matcher.py:176-179``)
was a gather-cost choice of that chip and is not ported: at N = 2^19
against 8192 entries it would materialize ~4 G booleans here.  Device
false positives (8-byte collisions) are filtered by the host string
confirm, ``TargetPools.check`` (``vuke_tpu.matcher.Matcher.check``), as
in the JAX package; ``AddressType`` and ``MatchInfo`` are its result.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum
from typing import Iterable, Optional

import numpy as np
import torch

from . import encode
from ._device import device_key
from .derive import DerivedKey


class AddressType(Enum):
    P2PKH_COMPRESSED = "p2pkh_compressed"
    P2PKH_UNCOMPRESSED = "p2pkh_uncompressed"
    P2WPKH = "p2wpkh"

    def as_str(self) -> str:
        return self.value


@dataclass
class MatchInfo:
    address_type: AddressType
    address: str


def pack_fragments_np(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    """uint32 (hi, lo) arrays -> int64 ``(hi << 32) | lo`` (two's complement)."""
    v = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    return v.view(np.int64)


def pack_fragments(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """uint32 (hi, lo) tensors -> int64 ``(hi << 32) | lo`` (two's
    complement), computed without overflow from the signed high word."""
    return hi.view(torch.int32).to(torch.int64) * (1 << 32) + lo.to(torch.int64)


def _member(pool: torch.Tensor, frags: torch.Tensor) -> torch.Tensor:
    if pool.numel() == 0:
        return torch.zeros(frags.shape, dtype=torch.bool, device=frags.device)
    pos = torch.searchsorted(pool, frags).clamp_(max=pool.numel() - 1)
    return pool[pos] == frags


class TargetPools:
    """Sorted int64 fragment pools, copied to each device on first use.

    ``targets`` holds the address strings the pools were built from (empty
    for pools carried over from the JAX package), for the host confirm."""

    def __init__(self, comp: np.ndarray, uncomp: np.ndarray,
                 targets: frozenset = frozenset(), unparsed: tuple = ()):
        self.comp = np.unique(np.asarray(comp, dtype=np.int64))
        self.uncomp = np.unique(np.asarray(uncomp, dtype=np.int64))
        self.targets = targets
        self.unparsed = unparsed
        self._on_device: dict[str, tuple[torch.Tensor, torch.Tensor]] = {}

    @classmethod
    def from_addresses(cls, addresses: Iterable[str]) -> "TargetPools":
        comp, uncomp, unparsed, targets = [], [], [], set()
        for addr in addresses:
            targets.add(addr)
            dec = encode.decode_address_h160(addr)
            if dec is None:
                unparsed.append(addr)
                continue
            h160, kind = dec
            frag = int.from_bytes(h160[:8], "big", signed=True)
            comp.append(frag)
            if kind == "p2pkh":
                uncomp.append(frag)
        return cls(np.array(comp, dtype=np.int64), np.array(uncomp, dtype=np.int64),
                   frozenset(targets), tuple(unparsed))

    @classmethod
    def load(cls, path) -> "TargetPools":
        """One address per line; blank lines and ``#`` comments skipped."""
        with open(path) as f:
            return cls.from_addresses(
                s for s in (line.strip() for line in f) if s and not s.startswith("#"))

    def count(self) -> int:
        """Distinct target lines, unparseable ones included (``Loaded N
        target addresses``)."""
        return len(self.targets)

    def check(self, derived: DerivedKey) -> Optional[MatchInfo]:
        """The host confirm: the first of the compressed p2pkh, the
        uncompressed p2pkh and the p2wpkh address that is a target."""
        for kind in AddressType:
            addr = getattr(derived, kind.value)
            if addr in self.targets:
                return MatchInfo(kind, addr)
        return None

    def on(self, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
        key = device_key(device)
        if key not in self._on_device:
            self._on_device[key] = (torch.from_numpy(self.comp).to(device),
                                    torch.from_numpy(self.uncomp).to(device))
        return self._on_device[key]

    def lookup(self, frag_c, frag_u) -> torch.Tensor:
        """(hi, lo) uint32 (N,) fragment pairs of the compressed and the
        uncompressed hash160s -> (N,) bool: either is in its pool."""
        comp, uncomp = self.on(frag_c[0].device)
        return (_member(comp, pack_fragments(*frag_c))
                | _member(uncomp, pack_fragments(*frag_u)))
