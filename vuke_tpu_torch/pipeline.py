"""The forward-search engine: seeds or strings in, hits or key lines out.

Port of ``vuke_tpu/pipeline.py``: ``ScanProgram``, ``ForwardDriver``
(range and timestamp sources, ``scan`` and ``generate``) and
``StringDriver`` (wordlist, stdin and file sources).  A superbatch of each
transform takes, slot by slot, one of two device paths, as the JAX package
chooses:

- its keygen (one kernel launch for all of the transform's slots,
  ``transforms/numeric.py``), then per slot the derive of ``ecc/tiled.py``,
  through K3 or, with ``smul13`` off (``VUKE_TPU_SMUL13=0``), K6;
- ``SequentialScan``, for the slot whose key IS the seed: one point
  addition per key from a cached offset table (``ecc/incremental.py``),
  whenever ``sequential_safe`` allows it and ``VUKE_TPU_SEQUENTIAL`` does
  not turn it off (never in ``generate``, as in the JAX package).

In a scan each slot ends in fragment membership in the target pools, a
bit-packed hit mask and ``[n_valid, count]`` (``Matcher``); a superbatch's
(S, 2) counts go to the host in one copy that does not block
(``StatsRing``).  In ``generate`` each slot ends in D2 (``cores/p2pkh.py``):
the normalized keys, the address rows and the validity go to the host in
copies that do not block (``HostCopy``), where ``format_lines`` writes the
compact lines.  Where the output takes whole records (a ``StorageOutput``,
a verbose console, any other handler: ``cores/records.needs_records``) each
slot ends in E1 (``cores/records.py``) instead, and its rows go to the host
with the keys and K4's affine x and y, as a ``RecordBlock`` a chunk; a
console beside the storage gets the same lines, ``format_lines`` fed E1's
P2PKH field in place of D2's rows.  The
driver keeps one superbatch in flight: it launches superbatch k + 1 of
every transform before it reads k.  The mask crosses
to the host only on a hit batch, where each candidate is confirmed with
``derive.KeyDeriver`` against the target address strings.

Output order.  The port's device superbatch is 2^19 seeds, the JAX
package's 65536, and the JAX order of hits and lines follows its
superbatch: per superbatch, per transform, then per slot and lane (hits)
or per seed and slot (lines).  The driver holds each superbatch's output
and writes it sorted by (chunk of ``order_batch`` seeds from the range's
start, transform, slot, lane) for hits and (chunk, transform, seed, slot)
for lines, which is the JAX package's order for the same command line.

Unlike the JAX package, a failure on the device (a kernel, the offset
table's build) is not caught and retried on another path: it raises.
"""

from __future__ import annotations

import functools
import os
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch

from ._device import MASK32, u32
from . import encode
from .cores import hash160, p2pkh
from .cores import records as rec
from .derive import DerivedKey, KeyDeriver
from .ecc import inv
from .ecc.incremental import (BaseStepper, offset_table, sequential_core, sequential_safe,
                              use_sequential)
from .ecc.scalar import normalize_words
from .ecc.tiled import affine_points, derive_tiled_from_words, use_smul13
from .matcher import AddressType, MatchInfo, TargetPools
from .transforms import TransformSpec, parse_transform

DEFAULT_BATCH = 1 << 19
# the JAX package's default superbatch (vuke_tpu/pipeline.py:31), which sets
# its output order
ORDER_BATCH = 1 << 16


@dataclass
class ProcessStats:
    inputs_processed: int = 0
    keys_generated: int = 0
    matches_found: int = 0

    def merge(self, other: "ProcessStats"):
        self.inputs_processed += other.inputs_processed
        self.keys_generated += other.keys_generated
        self.matches_found += other.matches_found




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
    """The per-slot ``[n_valid, count]`` of a superbatch (or a sweep
    batch's record), on their way to the host without blocking.  On the
    card each (S, 2) tensor goes into the next of ``depth`` pinned rows,
    with an event behind the copy, and ``_Pending.tolist`` waits for that
    event alone: work enqueued after the copy (the next superbatch) keeps
    the device busy meanwhile.  Rows and events are reused, so a send
    allocates nothing on the host; the caller reads a row before it sends
    ``depth`` more.  On the CPU a copy of the tensor is kept."""

    def __init__(self, device: torch.device, slots: int, depth: int = 2):
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.rows = [torch.empty((slots, 2), dtype=torch.int64, pin_memory=True)
                         for _ in range(depth)]
            self.events = [torch.cuda.Event() for _ in range(depth)]
        self.turn = 0

    def send(self, stats: torch.Tensor):
        if not self.cuda:
            return stats.clone()
        i = self.turn % len(self.rows)
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


class HostCopy:
    """Tensors on their way to the host without blocking: on the card each
    goes into pinned memory behind one event, which ``arrays`` waits for
    alone; on the CPU the tensors themselves."""

    def __init__(self, tensors):
        self.event = None
        if tensors[0].device.type == "cuda":
            tensors = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                       .copy_(t, non_blocking=True) for t in tensors]
            self.event = torch.cuda.Event()
            self.event.record()
        self.tensors = tensors

    def arrays(self) -> list:
        if self.event is not None:
            self.event.synchronize()
        return [t.numpy() for t in self.tensors]


def _host_words(t: torch.Tensor) -> torch.Tensor:
    """uint32 words as int32, which every torch build moves to numpy."""
    return t.view(torch.int32)


def derive_addresses(words: torch.Tensor, version: int, smul13: bool | None = None):
    """(8, N) uint32 key words -> (the normalized keys (8, N), their
    compressed P2PKH addresses as (N, 35) rows): the derive, then D2 on K2's
    digests where they lie."""
    d = derive_tiled_from_words(words, smul13=smul13)
    return d["norm"].T, p2pkh.batch_p2pkh(d["h160c"].T, version)


def derive_records(words: torch.Tensor, network: encode.Network, smul13: bool | None = None):
    """(8, N) uint32 key words -> (the normalized keys, K4's affine x and y,
    each (8, N), and E1's record rows (N, ``records.ROW``)): normalize, K3
    or K6, K4, K2, then E1 on K2's digests where they lie."""
    if words.shape[1] % inv.CHUNK:
        raise ValueError(f"batch {words.shape[1]} is not a multiple of {inv.CHUNK}")
    norm = normalize_words(words)
    x, y = affine_points(norm, smul13=smul13)
    hc, hu, _, _ = hash160.hash160s_and_fragments(x, y)
    return norm, x, y, rec.encode_records(norm, hc, hu, network)


class ScanProgram:
    """One transform over superbatches of ``batch`` seeds, every slot.

    With ``pools`` (a scan), the transform's ``sequential_slot`` takes
    ``SequentialScan`` in every superbatch that ``sequential_safe`` allows,
    unless ``use_sequential`` says no (its table is built on the first such
    superbatch); the keygen runs once a superbatch for all the other slots,
    and each of them takes its own derive and match.  Without pools
    (``generate``) every slot takes the keygen and the derive, then D2
    under ``network``'s P2PKH version, or with ``records`` E1 under
    ``network``.  ``smul13`` picks K3 (True) or K6 (False) for the derive
    and the table, once for the whole run; None reads the environment
    (``ecc/tiled.use_smul13``)."""

    def __init__(self, spec: TransformSpec, pools: Optional[TargetPools], batch: int, device,
                 smul13: bool | None = None, network: encode.Network = encode.BITCOIN,
                 records: bool = False):
        self.spec = spec
        self.batch = batch
        self.device = torch.device(device)
        self.smul13 = use_smul13(smul13)
        self.network = network
        self.records = records
        self.offsets = torch.arange(batch, dtype=torch.int64, device=self.device)
        self.generate = pools is None
        self.seq_slot = (spec.numeric.sequential_slot
                         if use_sequential() and not self.generate else None)
        self._seq: Optional[SequentialScan] = None
        if not self.generate:
            self._match = Matcher(pools, batch, spec.numeric.n_slots, self.device)
            self._ring = StatsRing(self.device, spec.numeric.n_slots)

    def run(self, start: int, limit: int):
        """Launch the superbatch of seeds start .. start + batch - 1, lanes
        from ``limit`` on masked out.  A scan returns (the (S, 2) ``[n_valid,
        count]`` of its slots on their way to the host, ``StatsRing.send``;
        each slot's packed hit mask); ``generate`` a ``HostCopy`` of, per
        slot, the normalized keys (8, N), the address rows (N, 35) and the
        validity (N,); with ``records``, the keys, x and y (8, N), E1's rows
        (N, ``records.ROW``) and the validity."""
        nt = self.spec.numeric
        keys = valid = in_range = None
        masks, out = [], []
        for s in range(nt.n_slots):
            if s == self.seq_slot and sequential_safe(start, self.batch):
                if self._seq is None:
                    self._seq = SequentialScan(self.batch, self.device, self.smul13)
                masks.append(self._seq.run(start, limit, self._match, s))
                continue
            if keys is None:
                # a host-only transform computes the lanes in range alone
                keys, valid = nt.keygen(*seed_lattice(start, self.offsets), limit=limit)
                in_range = self.offsets < limit
            if self.generate and self.records:
                norm, x, y, rows = derive_records(keys[s], self.network, self.smul13)
                out += [_host_words(norm), _host_words(x), _host_words(y), rows,
                        valid[s] & in_range]
                continue
            if self.generate:
                norm, rows = derive_addresses(keys[s], self.network.p2pkh_version, self.smul13)
                out += [_host_words(norm), rows, valid[s] & in_range]
                continue
            d = derive_tiled_from_words(keys[s], smul13=self.smul13)
            torch.bitwise_and(valid[s], in_range, out=self._match.valid)
            masks.append(self._match(d, s))
        if self.generate:
            return HostCopy(out)
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
class ScanResult(ProcessStats):
    """``ProcessStats`` of a ``run_range`` with its confirmed hits, in the
    order they were written."""
    candidates: int = 0          # device fragment hits, before the host confirm
    hits: list = field(default_factory=list)


_HEX = np.frombuffer(b"0123456789abcdef", dtype=np.uint8)


def source_rows(first: int, n: int, labels: Sequence[str]) -> np.ndarray:
    """(n * S, 20 + label width) uint8: the sources ``{seed}{label}`` of the
    seeds first .. first + n - 1, per seed every label, NUL-padded."""
    lw = max(len(label.encode()) for label in labels)
    out = np.zeros((n, len(labels), 20 + lw), dtype=np.uint8)
    out[:, :, :20] = _decimal_columns(first, n)[:, None, :]
    for s, label in enumerate(labels):
        b = np.frombuffer(label.encode(), dtype=np.uint8)
        out[:, s, 20:20 + len(b)] = b
    return out.reshape(n * len(labels), -1)


def _decimal_columns(first: int, n: int) -> np.ndarray:
    """(n, 20) uint8: the decimal strings of first .. first + n - 1 (u64),
    right-aligned, NULs in place of leading zeros."""
    v = np.uint64(first) + np.arange(n, dtype=np.uint64)
    out = np.empty((n, 20), dtype=np.uint8)
    for j in range(19, -1, -1):
        out[:, j] = (v % np.uint64(10)).astype(np.uint8) + 48
        v //= np.uint64(10)
    lead = np.cumsum(out != 48, axis=1) == 0
    lead[:, -1] = False
    out[lead] = 0
    return out


def format_lines(first: int, labels: Sequence[str], name: str, norm: np.ndarray,
                 rows: np.ndarray, valid: np.ndarray) -> str:
    """The compact lines ``{seed}{label},{name},{key hex},{address}`` of the
    seeds first .. first + n - 1, per seed every valid slot: ``norm`` (S, n,
    8) uint32 BE key words, ``rows`` (S, n, W) NUL-padded addresses (D2's
    rows, or E1's P2PKH field), ``valid`` (S, n) bool.  Each line is laid
    out in a fixed-width byte row, NULs in the gaps, and the NULs dropped at
    the end."""
    S, n = valid.shape
    consts = [np.frombuffer(f"{label},{name},".encode(), dtype=np.uint8) for label in labels]
    cw = max(len(c) for c in consts)
    hx, ad = 20 + cw, 20 + cw + 65
    aw = rows.shape[-1]
    width = ad + aw + 1
    step = max(1, (1 << 17) // S)
    parts = []
    for a in range(0, n, step):
        b = min(n, a + step)
        m = np.zeros((b - a, S, width), dtype=np.uint8)
        m[:, :, :20] = _decimal_columns(first + a, b - a)[:, None, :]
        for s, c in enumerate(consts):
            m[:, s, 20:20 + len(c)] = c
        key = np.ascontiguousarray(norm[:, a:b].astype(">u4")).view(np.uint8)
        key = key.reshape(S, b - a, 32)
        m[:, :, hx:hx + 64] = _HEX[np.stack([key >> 4, key & 15], axis=-1)].reshape(
            S, b - a, 64).transpose(1, 0, 2)
        m[:, :, hx + 64] = ord(",")
        m[:, :, ad:ad + aw] = rows[:, a:b].transpose(1, 0, 2)
        m[:, :, -1] = ord("\n")
        m[~valid[:, a:b].T] = 0
        parts.append(m[m != 0].tobytes())
    return b"".join(parts).decode("ascii")


def write_keys(output, deriver: KeyDeriver, name: str, sources: Sequence[str],
               norm: np.ndarray, addrs: Sequence[str]):
    """One ``key_fast`` line a key: ``norm`` (M, 8) uint32 BE words."""
    for source, words, addr in zip(sources, norm, addrs):
        output.key_fast(source, name, words.astype(">u4").tobytes(), addr, deriver=deriver)


def write_lines(first: int, labels: Sequence[str], name: str, norm: np.ndarray,
                rows: np.ndarray, valid: np.ndarray, output):
    """``format_lines`` of the arguments to ``output.lines``."""
    output.lines(format_lines(first, labels, name, norm, rows, valid))


class ForwardDriver:
    """Numeric transforms over a contiguous seed range with one superbatch
    in flight: the port of ``vuke_tpu/pipeline.py::ForwardDriver``.

    With ``pools`` it scans: device-flagged candidates are confirmed on the
    host and written through ``output.hit``; with ``pools`` None it
    generates, every valid key written as a compact line, or, where the
    output takes records (``records.needs_records``), as a ``RecordBlock``
    of E1's rows a chunk (``records.emit_block``).  ``order_batch``
    (``batch`` when None) is the JAX package's superbatch for the same
    command line; output is written in its order (see the module's
    docstring).  ``batch`` must be a multiple of ``order_batch`` unless one
    superbatch covers the range."""

    def __init__(self, specs: Sequence[TransformSpec], pools: Optional[TargetPools], *,
                 batch: int = DEFAULT_BATCH, device, output=None,
                 deriver: Optional[KeyDeriver] = None, progress=None,
                 order_batch: Optional[int] = None, smul13: bool | None = None):
        if batch % 32:
            raise ValueError(f"batch {batch} is not a multiple of 32")
        self.specs = [s for s in specs if s.numeric is not None]
        self.pools = pools
        self.batch = batch
        self.order_batch = order_batch or batch
        self.output = output
        self.deriver = deriver or KeyDeriver()
        self.progress = progress
        self.records = pools is None and rec.needs_records(output)
        self.programs = [ScanProgram(spec, pools, batch, device, smul13,
                                     self.deriver.network, self.records)
                         for spec in self.specs]

    def run_range(self, start: int, end: int) -> ScanResult:
        """Process the inclusive u64 seed range [start, end]: superbatch k +
        1 of every program is launched before superbatch k is read; a
        superbatch's output is written once every program's is in."""
        result = ScanResult()
        held = []
        pending = []
        pos = start
        last = len(self.programs) - 1
        while pos <= end or pending:
            if pos <= end:
                n = min(self.batch, end - pos + 1)
                for p, prog in enumerate(self.programs):
                    pending.append((p, prog, pos, n, prog.run(pos, n)))
                pos += self.batch
            while len(pending) > len(self.programs) or (pos > end and pending):
                p, prog, bstart, n, launched = pending.pop(0)
                args = (result, held, start, p, prog.spec, bstart, n, launched)
                if self.pools is None:
                    self._consume_keys(*args)
                else:
                    self._consume_hits(*args)
                if self.progress is not None:
                    self.progress.advance(n)
                if p == last:
                    self._release(held, (bstart + self.batch - start) // self.order_batch)
        self._release(held, None)
        if self.output is not None:
            self.output.flush()
        return result

    @staticmethod
    def _release(held: list, below: Optional[int]):
        """Write the held output of order chunks below ``below`` (all when
        None), sorted by its order key."""
        held.sort(key=lambda item: item[0])
        k = len(held) if below is None else sum(item[0][0] < below for item in held)
        for _, write in held[:k]:
            write()
        del held[:k]

    def _consume_hits(self, result: ScanResult, held: list, start: int, p: int,
                      spec: TransformSpec, bstart: int, n: int, launched):
        stats, masks = launched
        result.inputs_processed += n
        for slot_i, (n_valid, count) in enumerate(stats.tolist()):
            result.keys_generated += n_valid
            if not count:
                continue
            result.candidates += count
            packed = masks[slot_i].to(torch.int64).cpu().numpy()
            for lane in np.nonzero(unpack_mask(packed, self.batch))[0]:
                seed = bstart + int(lane)
                hit = self._confirm(spec, seed, slot_i)
                if hit is not None:
                    result.matches_found += 1
                    held.append((((seed - start) // self.order_batch, p, slot_i, seed),
                                 functools.partial(self._write_hit, result, hit)))

    def _write_hit(self, result: ScanResult, hit: Hit):
        result.hits.append(hit)
        if self.output is not None:
            self.output.hit(hit.source, hit.transform, hit.derived,
                            MatchInfo(AddressType(hit.address_type), hit.address))

    def _consume_keys(self, result: ScanResult, held: list, start: int, p: int,
                      spec: TransformSpec, bstart: int, n: int, launched):
        arrays = launched.arrays()
        k = 5 if self.records else 3
        norm = np.stack([a[:, :n].view(np.uint32).T for a in arrays[0::k]])
        rows = np.stack([a[:n] for a in arrays[k - 2::k]])
        valid = np.stack([a[:n] for a in arrays[k - 1::k]])
        points = ([np.stack([a[:, :n].view(np.uint32).T for a in arrays[j::k]]) for j in (1, 2)]
                  if self.records else [None, None])
        result.inputs_processed += n
        result.keys_generated += int(np.count_nonzero(valid))
        ob = self.order_batch
        first = bstart
        while first < bstart + n:
            stop = min(bstart + n, start + ((first - start) // ob + 1) * ob)
            a, b = first - bstart, stop - bstart
            held.append((((first - start) // ob, p), functools.partial(
                self._write_keys, spec, first, norm[:, a:b], rows[:, a:b], valid[:, a:b],
                *[None if q is None else q[:, a:b] for q in points])))
            first = stop

    def _write_keys(self, spec: TransformSpec, first: int, norm, rows, valid, x=None, y=None):
        """A chunk's keys, (S, n, ...) arrays: compact lines from D2's rows,
        or with ``records`` one ``RecordBlock`` in the order of the lines
        (per seed, every valid slot), whose lines come from E1's P2PKH
        field."""
        out = self.output
        if out is None:
            return
        slots = spec.numeric.slots
        if not self.records:
            write_lines(first, slots, spec.name, norm, rows, valid, out)
            return
        order = valid.T.reshape(-1)                 # seed-major, slot-minor

        def take(q):
            return q.transpose(1, 0, 2).reshape(-1, q.shape[-1])[order]

        off, width = rec.field_span("address_p2pkh_compressed")
        lines = functools.partial(write_lines, first, slots, spec.name, norm,
                                  rows[:, :, off:off + width], valid)
        rec.emit_block(out, rec.RecordBlock(
            spec.name, source_rows(first, valid.shape[1], slots)[order], take(norm), take(x),
            take(y), take(rows), lines))

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
        info = self.pools.check(derived)
        if info is None:
            return None
        return Hit(seed, f"{seed}{spec.numeric.slots[slot_i]}", spec.name, info.address,
                   info.address_type.as_str(), derived)


def scan_range(start: int, end: int, pools: TargetPools, *, transform="milksad",
               batch: int = DEFAULT_BATCH, device, smul13: bool | None = None) -> ScanResult:
    """``transform`` (a ``--transform`` string or a ``TransformSpec``) over
    the inclusive u64 seed range [start, end], through ``ForwardDriver``.

    Every superbatch runs at full width; lanes past ``end`` are masked out,
    as are seeds the transform yields no key for (milksad above 2^32 - 1),
    which count as inputs only.  The confirmed hits are in ``hits``.
    ``smul13`` as in ``ScanProgram``."""
    spec = parse_transform(transform) if isinstance(transform, str) else transform
    return ForwardDriver([spec], pools, batch=batch, device=device,
                         smul13=smul13).run_range(start, end)


class StringDriver:
    """String inputs (wordlist, stdin, files) through the string
    transforms: the port of ``vuke_tpu/pipeline.py::StringDriver``.

    Per batch and per spec: the keys on the host (``StringTransform.fn``,
    D1 on ``device`` above ``VUKE_HOST_DIGEST_MAX`` strings), then on the
    device the derive of every (string, slot) key in one call at a width
    padded to a multiple of ``pad`` (``VUKE_STRING_PAD``, default 1024, a
    multiple of ``inv.CHUNK``), and either the match against ``pools``
    (hits confirmed on the host) or, without pools, D2 and one compact
    line a valid key.  Output order: per spec, per string, per slot."""

    PAD = 1024

    def __init__(self, specs: Sequence[TransformSpec], pools: Optional[TargetPools], output,
                 deriver: Optional[KeyDeriver] = None, *, device, progress=None):
        self.specs = list(specs)
        self.pools = pools
        self.output = output
        self.deriver = deriver or KeyDeriver()
        self.device = torch.device(device)
        self.pad = int(os.environ.get("VUKE_STRING_PAD", self.PAD))
        if self.pad <= 0 or self.pad % inv.CHUNK:
            raise ValueError(f"VUKE_STRING_PAD {self.pad} is not a positive multiple of "
                             f"{inv.CHUNK}")
        self.progress = progress
        self._matchers: dict[int, Matcher] = {}

    def _words(self, keys_flat: np.ndarray) -> torch.Tensor:
        """(M, 8) uint32 keys -> (8, W) on the device, W the next multiple
        of ``pad``, the last key repeated into the padding."""
        m = len(keys_flat)
        width = -(-m // self.pad) * self.pad
        chunk = np.empty((width, 8), dtype=np.uint32)
        chunk[:m] = keys_flat
        chunk[m:] = keys_flat[-1]
        words = torch.from_numpy(chunk.view(np.int32)).view(torch.uint32)
        return words.to(self.device).T.contiguous()

    def _device_match(self, keys_flat: np.ndarray) -> np.ndarray:
        """(M, 8) keys -> (M,) bool candidates of the target pools."""
        words = self._words(keys_flat)
        width = words.shape[1]
        if width not in self._matchers:
            self._matchers[width] = Matcher(self.pools, width, 1, self.device)
        match = self._matchers[width]
        match.valid.fill_(True)
        packed = match(derive_tiled_from_words(words), 0)
        return unpack_mask(packed.to(torch.int64).cpu().numpy(), width)[:len(keys_flat)]

    def process_blob(self, data: bytes, label: str) -> ProcessStats:
        """One file (``vuke_tpu/pipeline.py:605-650``): the transforms with
        a ``blob_fn`` (bitimage) take its bytes, each key derived and
        checked on the host; every other string transform sees its path
        (``label``) once, through one ``process_batch``.  The file counts
        as one input, by the caller."""
        stats = ProcessStats()
        if self.progress is not None:
            self.progress.advance(1)
        specs = [s for s in self.specs if s.string is not None and s.string.blob_fn is None]
        if specs:
            prog, self.progress = self.progress, None
            try:
                stats.merge(self.process_batch([label], specs=specs))
            finally:
                self.progress = prog
            stats.inputs_processed = 0
        for spec in self.specs:
            st = spec.string
            if st is None or st.blob_fn is None:
                continue
            keys = st.blob_fn([(data, label)], self.device)
            valid = st.valid_fn([label])
            stats.keys_generated += int(valid.sum())
            for s_i in range(keys.shape[1]):
                if not valid[0, s_i]:
                    continue
                derived = self.deriver.derive(keys[0, s_i].astype(">u4").tobytes())
                source = f"{label}{st.slots[s_i]}"
                if self.pools is None:
                    self.output.key(source, spec.name, derived)
                    continue
                info = self.pools.check(derived)
                if info is not None:
                    stats.matches_found += 1
                    self.output.hit(source, spec.name, derived, info)
        return stats

    def process_batch(self, strings: Sequence[str],
                      specs: Optional[Sequence[TransformSpec]] = None) -> ProcessStats:
        stats = ProcessStats(inputs_processed=len(strings))
        if not strings:
            return stats
        if self.progress is not None:
            self.progress.advance(len(strings))
        for spec in (self.specs if specs is None else specs):
            st = spec.string
            if st is None:
                continue
            keys = st.fn(list(strings), self.device)                # (N, S, 8)
            valid = (st.valid_fn(list(strings)) if st.valid_fn is not None
                     else np.ones(keys.shape[:2], dtype=bool))
            stats.keys_generated += int(valid.sum())
            n, S = keys.shape[:2]
            if not n * S:
                continue
            flat = keys.reshape(-1, 8)
            if self.pools is None:
                self._emit_generate(spec, strings, flat, valid)
            elif self.pools.comp.size:
                mask = self._device_match(flat) & valid.reshape(-1)
                for flat_i in np.nonzero(mask)[0]:
                    i, s_i = divmod(int(flat_i), S)
                    derived = self.deriver.derive(flat[flat_i].astype(">u4").tobytes())
                    info = self.pools.check(derived)
                    if info is not None:
                        stats.matches_found += 1
                        self.output.hit(f"{st.label(strings[i])}{st.slots[s_i]}", spec.name,
                                        derived, info)
        return stats

    def _emit_generate(self, spec: TransformSpec, strings, flat: np.ndarray, valid):
        """One compact line a valid key (the derive and D2 on the device),
        or, where the output takes records, one ``RecordBlock`` of E1's
        rows."""
        S = valid.shape[1]
        idx = np.nonzero(valid.reshape(-1))[0]
        st = spec.string
        sources = [f"{st.label(strings[i // S])}{st.slots[i % S]}" for i in idx]
        if rec.needs_records(self.output):
            norm, x, y, rows = derive_records(self._words(flat), self.deriver.network)
            norm, x, y, rows = HostCopy([_host_words(t.T.contiguous()) for t in (norm, x, y)]
                                        + [rows]).arrays()
            words = [t.view(np.uint32)[idx] for t in (norm, x, y)]
            off, width = rec.field_span("address_p2pkh_compressed")
            lines = functools.partial(write_keys, deriver=self.deriver, name=spec.name,
                                      sources=sources, norm=words[0],
                                      addrs=rec.texts(rows[idx, off:off + width]))
            rec.emit_block(self.output, rec.RecordBlock(spec.name, sources, *words, rows[idx],
                                                        lines))
            return
        norm, rows = derive_addresses(self._words(flat), self.deriver.network.p2pkh_version)
        norm, rows = HostCopy([_host_words(norm.T.contiguous()), rows]).arrays()
        write_keys(self.output, self.deriver, spec.name, sources,
                   norm.view(np.uint32)[idx], p2pkh.addresses(rows[idx]))
