"""The forward-search engine over a range source: seed lattice in, hits out.

Port of ``vuke_tpu/pipeline.py``'s numeric scan: ``ScanProgram`` and
``ForwardDriver.run_range``.  A superbatch of each transform takes, slot by
slot, one of two device paths, as the JAX package chooses:

- its keygen (one kernel launch for all of the transform's slots,
  ``transforms/numeric.py``), then per slot the derive of ``ecc/tiled.py``,
  through K3 or, with ``smul13`` off (``VUKE_TPU_SMUL13=0``), K6;
- ``SequentialScan``, for the slot whose key IS the seed: one point
  addition per key from a cached offset table (``ecc/incremental.py``),
  whenever ``sequential_safe`` allows it and ``VUKE_TPU_SEQUENTIAL`` does
  not turn it off.

Each slot ends in fragment membership in the target pools, a bit-packed
hit mask and ``[n_valid, count]`` (``Matcher``); a superbatch's (S, 2)
counts go to the host in one copy that does not block (``StatsRing``).  The driver keeps
one superbatch in flight: it launches superbatch k + 1 of every transform
before it reads k, so the host's work for the next one (the base point,
the seed lattice, the launches) overlaps the device's.  The mask crosses to the host only on a
hit batch, where each candidate is confirmed with ``derive.KeyDeriver``
against the target address strings.

Unlike the JAX package, a failure on the device (a kernel, the offset
table's build) is not caught and retried on another path: it raises.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch

from ._device import MASK32, u32
from .derive import DerivedKey, KeyDeriver
from .ecc.incremental import (BaseStepper, offset_table, sequential_core, sequential_safe,
                              use_sequential)
from .ecc.tiled import derive_tiled_from_words, use_smul13
from .matcher import TargetPools
from .transforms import TransformSpec, parse_transform

DEFAULT_BATCH = 1 << 19


@functools.lru_cache(maxsize=None)
def _shifts(device: str) -> torch.Tensor:
    return torch.arange(32, dtype=torch.int64, device=device)


def pack_mask(m: torch.Tensor) -> torch.Tensor:
    """(N,) bool -> (N/32,) uint32, bit j of word w = lane 32w + j."""
    n = m.shape[0]
    if n % 32:
        raise ValueError(f"mask length {n} is not a multiple of 32")
    bits = m.reshape(n // 32, 32).to(torch.int64) << _shifts(str(m.device))
    return u32(bits.sum(dim=1))


def unpack_mask(packed: np.ndarray, n: int) -> np.ndarray:
    """Host-side inverse of ``pack_mask`` -> (n,) bool."""
    b = np.asarray(packed, dtype="<u4").tobytes()
    return np.unpackbits(np.frombuffer(b, dtype=np.uint8),
                         bitorder="little")[:n].astype(bool)


def seed_lattice(start: int, offsets: torch.Tensor):
    """u64 ``start`` + int64 ``offsets`` -> (hi, lo) uint32 word pairs, the
    carry of the low word going into the high one."""
    lo = (start & MASK32) + offsets
    hi = (start >> 32) + (lo >> 32)
    return u32(hi), u32(lo)


class StatsRing:
    """The per-slot ``[n_valid, count]`` of a superbatch, on their way to the
    host without blocking.  On the card each superbatch's (S, 2) tensor goes
    into the next of two pinned rows, with an event behind the copy, and
    ``_Pending.tolist`` waits for that event alone: work enqueued after the
    copy (the next superbatch) keeps the device busy meanwhile.  Rows and
    events are reused, so a superbatch allocates nothing on the host; the
    driver reads a row before it sends the one after next.  On the CPU a
    copy of the tensor is kept."""

    def __init__(self, device: torch.device, slots: int):
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.rows = [torch.empty((slots, 2), dtype=torch.int64, pin_memory=True)
                         for _ in range(2)]
            self.events = [torch.cuda.Event() for _ in range(2)]
        self.turn = 0

    def send(self, stats: torch.Tensor):
        if not self.cuda:
            return stats.clone()
        i = self.turn % 2
        self.turn += 1
        self.rows[i].copy_(stats, non_blocking=True)
        self.events[i].record()
        return _Pending(self.rows[i], self.events[i])


class _Pending:
    def __init__(self, row: torch.Tensor, event):
        self.row, self.event = row, event

    def tolist(self) -> list:
        self.event.synchronize()
        return self.row.tolist()


class Matcher:
    """The match of one program's slots against the target pools, into
    device scratch that every slot and superbatch reuses (the stream orders
    them): a (2, batch) bool of each lane's validity (``valid``, row 0, set
    by the caller) and hit (row 1), and the (S, 2) int64 ``stats``, a slot's
    ``[n_valid, count]`` from one sum over both rows."""

    def __init__(self, pools: TargetPools, batch: int, slots: int, device):
        self.pools = pools
        self.flags = torch.empty((2, batch), dtype=torch.bool, device=device)
        self.valid, self.hit = self.flags.unbind(0)
        self.stats = torch.empty((slots, 2), dtype=torch.int64, device=device)
        self.rows = self.stats.unbind(0)

    def __call__(self, d: dict, slot: int) -> torch.Tensor:
        """A derive dict's fragments -> the slot's hit mask, packed ((N/32,)
        uint32); its counts go into ``stats[slot]``."""
        torch.bitwise_and(self.pools.lookup(d["frag_c"], d["frag_u"]), self.valid,
                          out=self.hit)
        torch.sum(self.flags, dim=1, out=self.rows[slot])
        return pack_mask(self.hit)


class SequentialScan:
    """Contiguous keys, one affine point addition each: the offset table
    (built here with K3 or K6 as ``smul13`` says, once per batch size,
    device and kernel), an int64 lane index and the host base point of each
    superbatch."""

    def __init__(self, batch: int, device, smul13: bool | None = None):
        self.batch = batch
        self.offx, self.offy = offset_table(batch, device, smul13)
        self.offsets = torch.arange(batch, dtype=torch.int64, device=device)
        self.stepper = BaseStepper(batch)

    def run(self, start: int, limit: int, match: Matcher, slot: int) -> torch.Tensor:
        """Keys start .. start + batch - 1, lanes from ``limit`` on masked
        out, through ``match`` as ``slot`` -> the packed hit mask."""
        bx, by = self.stepper.base_for(start)
        d = sequential_core(bx, by, self.offx, self.offy)
        torch.lt(self.offsets, limit, out=match.valid)
        return match(d, slot)


class ScanProgram:
    """One transform over superbatches of ``batch`` seeds, every slot.

    The transform's ``sequential_slot`` takes ``SequentialScan`` in every
    superbatch that ``sequential_safe`` allows, unless ``use_sequential``
    says no (its table is built on the first such superbatch); the keygen
    runs once a superbatch for all the other slots, and each of them takes
    its own derive and match.  ``smul13`` picks K3 (True) or K6 (False) for
    the derive and the table, once for the whole run; None reads the
    environment (``ecc/tiled.use_smul13``)."""

    def __init__(self, spec: TransformSpec, pools: TargetPools, batch: int, device,
                 smul13: bool | None = None):
        self.spec = spec
        self.batch = batch
        self.device = torch.device(device)
        self.smul13 = use_smul13(smul13)
        self.offsets = torch.arange(batch, dtype=torch.int64, device=self.device)
        self.seq_slot = spec.numeric.sequential_slot if use_sequential() else None
        self._seq: Optional[SequentialScan] = None
        self._match = Matcher(pools, batch, spec.numeric.n_slots, self.device)
        self._ring = StatsRing(self.device, spec.numeric.n_slots)

    def run(self, start: int, limit: int):
        """Launch the superbatch of seeds start .. start + batch - 1, lanes
        from ``limit`` on masked out -> (the (S, 2) ``[n_valid, count]`` of
        its slots on their way to the host, ``StatsRing.send``; each slot's
        packed hit mask)."""
        nt = self.spec.numeric
        keys = valid = in_range = None
        masks = []
        for s in range(nt.n_slots):
            if s == self.seq_slot and sequential_safe(start, self.batch):
                if self._seq is None:
                    self._seq = SequentialScan(self.batch, self.device, self.smul13)
                masks.append(self._seq.run(start, limit, self._match, s))
                continue
            if keys is None:
                keys, valid = nt.keygen(*seed_lattice(start, self.offsets))
                in_range = self.offsets < limit
            d = derive_tiled_from_words(keys[s], smul13=self.smul13)
            torch.bitwise_and(valid[s], in_range, out=self._match.valid)
            masks.append(self._match(d, s))
        return self._ring.send(self._match.stats), masks


@dataclass
class Hit:
    seed: int
    source: str                  # f"{seed}{slot label}", as the reference prints it
    transform: str               # the spec's display name
    address: str
    address_type: str            # p2pkh_compressed | p2pkh_uncompressed | p2wpkh
    derived: DerivedKey


@dataclass
class ScanResult:
    inputs_processed: int = 0
    keys_generated: int = 0
    candidates: int = 0          # device fragment hits, before the host confirm
    hits: list = field(default_factory=list)


class ForwardDriver:
    """Numeric transforms over a contiguous seed range with one superbatch
    in flight, confirming device-flagged candidates on the host: the port
    of ``vuke_tpu/pipeline.py::ForwardDriver`` for the scan (no generate,
    no checkpoints)."""

    def __init__(self, specs: Sequence[TransformSpec], pools: TargetPools, *,
                 batch: int = DEFAULT_BATCH, device, on_hit=None,
                 smul13: bool | None = None):
        if batch % 32:
            raise ValueError(f"batch {batch} is not a multiple of 32")
        self.specs = list(specs)
        self.pools = pools
        self.batch = batch
        self.on_hit = on_hit
        self.deriver = KeyDeriver()
        self.programs = [ScanProgram(spec, pools, batch, device, smul13)
                         for spec in self.specs]

    def run_range(self, start: int, end: int) -> ScanResult:
        """Process the inclusive u64 seed range [start, end]: superbatch k +
        1 of every program is launched before superbatch k is read."""
        result = ScanResult()
        pending = []
        pos = start
        while pos <= end or pending:
            if pos <= end:
                n = min(self.batch, end - pos + 1)
                for prog in self.programs:
                    pending.append((prog, pos, n, prog.run(pos, n)))
                pos += self.batch
            while len(pending) > len(self.programs) or (pos > end and pending):
                self._consume(result, *pending.pop(0))
        return result

    def _consume(self, result: ScanResult, prog: ScanProgram, bstart: int, n: int,
                 launched):
        stats, masks = launched
        result.inputs_processed += n
        for slot_i, (n_valid, count) in enumerate(stats.tolist()):
            result.keys_generated += n_valid
            if not count:
                continue
            result.candidates += count
            packed = masks[slot_i].to(torch.int64).cpu().numpy()
            for lane in np.nonzero(unpack_mask(packed, self.batch))[0]:
                hit = self._confirm(prog.spec, bstart + int(lane), slot_i)
                if hit is not None:
                    result.hits.append(hit)
                    if self.on_hit is not None:
                        self.on_hit(hit)

    def _confirm(self, spec: TransformSpec, seed: int, slot_i: int) -> Optional[Hit]:
        """Recompute the key of (seed, slot) with the plain keygen on a
        one-lane CPU batch and check its addresses against the targets, in
        the reference's order (compressed p2pkh, uncompressed p2pkh,
        p2wpkh)."""
        hi = torch.tensor([seed >> 32], dtype=torch.int64).to(torch.uint32)
        lo = torch.tensor([seed & MASK32], dtype=torch.int64).to(torch.uint32)
        keys, valid = spec.numeric.keygen(hi, lo, plain=True)
        if not bool(valid[slot_i, 0]):
            return None
        key = b"".join(int(w).to_bytes(4, "big") for w in keys[slot_i, :, 0].to(torch.int64))
        derived = self.deriver.derive(key)
        for kind, addr in (("p2pkh_compressed", derived.p2pkh_compressed),
                           ("p2pkh_uncompressed", derived.p2pkh_uncompressed),
                           ("p2wpkh", derived.p2wpkh)):
            if addr in self.pools.targets:
                return Hit(seed, f"{seed}{spec.numeric.slots[slot_i]}", spec.name, addr, kind,
                           derived)
        return None


def scan_range(start: int, end: int, pools: TargetPools, *, transform="milksad",
               batch: int = DEFAULT_BATCH, device, on_hit=None,
               smul13: bool | None = None) -> ScanResult:
    """``transform`` (a ``--transform`` string or a ``TransformSpec``) over
    the inclusive u64 seed range [start, end], through ``ForwardDriver``.

    Every superbatch runs at full width; lanes past ``end`` are masked out,
    as are seeds the transform yields no key for (milksad above 2^32 - 1),
    which count as inputs only.  ``on_hit`` is called with each confirmed
    ``Hit`` as it is found.  ``smul13`` as in ``ScanProgram``."""
    spec = parse_transform(transform) if isinstance(transform, str) else transform
    return ForwardDriver([spec], pools, batch=batch, device=device, on_hit=on_hit,
                         smul13=smul13).run_range(start, end)
