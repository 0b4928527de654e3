"""The forward-search engine over a range source: seed lattice in, hits out.

Port of ``vuke_tpu/pipeline.py``'s device programs and scan loop for the
ported numeric transforms (``transforms.py``).  Each superbatch takes one
of two device paths, as ``pipeline.ScanProgram`` chooses in the JAX
package:

- keygen -> the derive of ``ecc/tiled.py``, through K3 or, with
  ``smul13`` off (``VUKE_TPU_SMUL13=0``), K6;
- ``SequentialScan``: for a transform whose key is the seed, one point
  addition per key from a cached offset table (``ecc/incremental.py``),
  whenever ``sequential_safe`` allows it.

Both end in fragment membership in the target pools and a bit-packed hit
mask.  Only the mask crosses to the host; the host unpacks it on the rare
hit batch and confirms each candidate with ``derive.KeyDeriver`` against
the target address strings.

Unlike the JAX package, a failure on the device (a kernel, the offset
table's build) is not caught and retried on another path: it raises.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from . import transforms
from ._device import MASK32, u32
from .derive import DerivedKey, KeyDeriver
from .ecc.incremental import BaseStepper, offset_table, sequential_core, sequential_safe
from .ecc.tiled import derive_tiled_from_words, use_smul13
from .matcher import TargetPools

DEFAULT_BATCH = 1 << 19


def pack_mask(m: torch.Tensor) -> torch.Tensor:
    """(N,) bool -> (N/32,) uint32, bit j of word w = lane 32w + j."""
    n = m.shape[0]
    if n % 32:
        raise ValueError(f"mask length {n} is not a multiple of 32")
    shifts = torch.arange(32, dtype=torch.int64, device=m.device)
    bits = m.reshape(n // 32, 32).to(torch.int64) << shifts
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


def match(pools: TargetPools, d: dict, valid: torch.Tensor) -> dict:
    """A derive dict's fragments -> ``n_valid``, ``count`` (0-d int64
    tensors) and ``mask_packed`` ((N/32,) uint32), on the input's device."""
    m = pools.lookup(d["frag_c"], d["frag_u"]) & valid
    return {"n_valid": valid.sum(), "count": m.sum(), "mask_packed": pack_mask(m)}


class SequentialScan:
    """Contiguous keys, one affine point addition each: the offset table
    (built here with K3 or K6 as ``smul13`` says, once per batch size,
    device and kernel), an int64 lane index and the host base point of each
    superbatch."""

    def __init__(self, pools: TargetPools, batch: int, device,
                 smul13: bool | None = None):
        self.pools = pools
        self.batch = batch
        self.offx, self.offy = offset_table(batch, device, smul13)
        self.offsets = torch.arange(batch, dtype=torch.int64, device=device)
        self.stepper = BaseStepper(batch)

    def run(self, start: int, limit: int) -> dict:
        """Keys start .. start + batch - 1; lanes from ``limit`` on are
        masked out."""
        bx, by = self.stepper.base_for(start)
        d = sequential_core(bx, by, self.offx, self.offy)
        return match(self.pools, d, self.offsets < limit)


class ScanProgram:
    """One numeric transform over superbatches of ``batch`` seeds.

    A transform with a ``sequential_slot`` takes ``SequentialScan`` for
    every superbatch that ``sequential_safe`` allows (its table is built on
    the first such superbatch); every other superbatch takes keygen -> the
    derive.  ``smul13`` picks K3 (True) or K6 (False) for the derive and the
    table, once for the whole run; None reads the environment
    (``ecc/tiled.use_smul13``)."""

    def __init__(self, transform: transforms.NumericTransform, pools: TargetPools,
                 batch: int, device, smul13: bool | None = None):
        self.transform = transform
        self.pools = pools
        self.batch = batch
        self.device = torch.device(device)
        self.smul13 = use_smul13(smul13)
        self.offsets = torch.arange(batch, dtype=torch.int64, device=self.device)
        self._seq: Optional[SequentialScan] = None

    def run(self, start: int, limit: int) -> dict:
        """The superbatch of seeds start .. start + batch - 1, lanes from
        ``limit`` on masked out."""
        if (self.transform.sequential_slot is not None
                and sequential_safe(start, self.batch)):
            if self._seq is None:
                self._seq = SequentialScan(self.pools, self.batch, self.device,
                                           self.smul13)
            return self._seq.run(start, limit)
        hi, lo = seed_lattice(start, self.offsets)
        words, valid = self.transform.keygen(hi, lo)
        return match(self.pools, derive_tiled_from_words(words, smul13=self.smul13),
                     valid & (self.offsets < limit))


@dataclass
class Hit:
    seed: int
    transform: str               # the transform's display name
    address: str
    address_type: str            # p2pkh_compressed | p2pkh_uncompressed | p2wpkh
    derived: DerivedKey


@dataclass
class ScanResult:
    inputs_processed: int = 0
    keys_generated: int = 0
    candidates: int = 0          # device fragment hits, before the host confirm
    hits: list = field(default_factory=list)


def _confirm(seed: int, transform: transforms.NumericTransform, targets: frozenset,
             deriver: KeyDeriver):
    """Host confirm of one candidate seed against the address strings, in
    the reference's order (compressed p2pkh, uncompressed p2pkh, p2wpkh)."""
    key = transform.key_for(seed)
    if key is None:
        return None
    derived = deriver.derive(key)
    for kind, addr in (("p2pkh_compressed", derived.p2pkh_compressed),
                       ("p2pkh_uncompressed", derived.p2pkh_uncompressed),
                       ("p2wpkh", derived.p2wpkh)):
        if addr in targets:
            return Hit(seed, transform.display, addr, kind, derived)
    return None


def scan_range(start: int, end: int, pools: TargetPools, *, transform="milksad",
               batch: int = DEFAULT_BATCH, device, on_hit=None,
               smul13: bool | None = None) -> ScanResult:
    """``transform`` (a name or a ``NumericTransform``) over the inclusive
    u64 seed range [start, end].

    Every superbatch runs at full width; lanes past ``end`` are masked out,
    as are seeds the transform yields no key for (milksad above 2^32 - 1),
    which count as inputs only.  ``on_hit`` is called with each confirmed
    ``Hit`` as it is found.  ``smul13`` as in ``ScanProgram``."""
    if batch % 32:
        raise ValueError(f"batch {batch} is not a multiple of 32")
    if isinstance(transform, str):
        transform = transforms.get(transform)
    prog = ScanProgram(transform, pools, batch, device, smul13)
    deriver = KeyDeriver()
    result = ScanResult()
    pos = start
    while pos <= end:
        n = min(batch, end - pos + 1)
        out = prog.run(pos, n)
        result.inputs_processed += n
        result.keys_generated += int(out["n_valid"])
        count = int(out["count"])
        if count:
            result.candidates += count
            packed = out["mask_packed"].to(torch.int64).cpu().numpy()
            for lane in np.nonzero(unpack_mask(packed, batch))[0]:
                hit = _confirm(pos + int(lane), transform, pools.targets, deriver)
                if hit is not None:
                    result.hits.append(hit)
                    if on_hit is not None:
                        on_hit(hit)
        pos += batch
    return result
