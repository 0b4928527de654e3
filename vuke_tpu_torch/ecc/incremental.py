"""Sequential-scan derive: one point addition per key instead of a scalar mul.

Counterpart of ``vuke_tpu/ecc/incremental.py``.  For contiguous keys
start, start + 1, ... the key of lane i is (start - 1) + (i + 1): with the
base B = (start - 1) * G, one host point per superbatch, and the offset
O_i = (i + 1) * G from a table built once per batch size, each key costs
ONE affine + affine addition (K5, 5M + 2S) before the shared batch
inversion (K4) and hash160 (K2), where the scalar multiplication (K3, or
K6 with ``smul13`` off) costs ~250-310 field products.

The addition breaks only where B = +-O_i or B is the point at infinity;
seeds are u64 (far below n), so ``sequential_safe`` reduces to
start >= batch + 2.  Unsafe superbatches take the scalar-multiplication
path.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Optional

import torch

from .._device import MASK32, check_same_device, check_words, device_key, i64, u32
from ..cores import hash160
from ..kernels import PTR, SIZE, Kernel
from . import field as F
from . import inv, ref
from .tiled import affine_points, derive_dict, use_smul13

KERNEL = Kernel(
    "seq_madd", "vk_seq_madd", [PTR, PTR, PTR, PTR, PTR, PTR, PTR, SIZE],
    source="vuke_tpu_torch/csrc/seq_madd.cu",
    replaces="vuke_tpu/ecc/pallas_inv.py:223 _seq_madd_kernel")


def use_sequential() -> bool:
    """Whether a slot whose key is the seed may take the sequential path:
    True unless ``VUKE_TPU_SEQUENTIAL`` is 0, false or no, the JAX
    package's switch (``vuke_tpu/pipeline.py:284-289``)."""
    return os.environ.get("VUKE_TPU_SEQUENTIAL", "1") not in ("0", "false", "no")


def sequential_safe(start: int, batch: int) -> bool:
    """True when the superbatch [start, start + batch) may take the point
    addition: the base scalar start - 1 stays clear of the offset scalars
    1..batch (mod n), so dx != 0 and B is finite on every lane."""
    return start >= batch + 2 and start + batch < (1 << 64)


class BaseStepper:
    """The base point (start - 1) * G of each superbatch, on the host: a
    superbatch that follows the previous one advances it by one affine
    addition of batch * G; any other start takes a fresh ``point_mul``."""

    def __init__(self, batch: int):
        self.batch = batch
        self._step = ref.point_mul(batch)
        self._at: Optional[int] = None
        self._pt = None

    def base_for(self, start: int):
        """Affine (x, y) of (start - 1) * G."""
        if self._at is not None and start == self._at + self.batch:
            pt = ref.point_add(self._pt, self._step)
        else:
            pt = ref.point_mul(start - 1)
        self._at, self._pt = start, pt
        return pt


def build_offset_table(n: int, device, smul13: bool | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Affine (i + 1) * G for i < n as two (8, n) uint32 LE-limb tensors,
    computed with the port's own K3 (or K6 with ``smul13`` off; None reads
    the environment, ``tiled.use_smul13``) + K4, their plain versions on the
    CPU."""
    if not 0 < n < 1 << 32:
        raise ValueError(f"offset table size {n} is out of range")
    scalars = torch.zeros((8, n), dtype=torch.int64, device=device)
    scalars[7] = torch.arange(1, n + 1, dtype=torch.int64, device=device)
    x, y = affine_points(u32(scalars), smul13=smul13)
    # affine_points gives BE words; the table keeps LE limbs, as K5 reads them
    return tuple(u32(i64(a).flip(0)).contiguous() for a in (x, y))


@functools.lru_cache(maxsize=None)
def _cached_table(n: int, device: str, smul13: bool):
    return build_offset_table(n, device, smul13)


def offset_table(n: int, device, smul13: bool | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """``build_offset_table`` once per (n, device, kernel), kept for reuse:
    64 bytes a lane, 32 MiB at n = 2^19; a run holds one a card it scans
    on.  The key holds the indexed device (``_device.device_key``) and the
    resolved ``smul13``, so a run's launch counts show the kernel that
    built its table."""
    return _cached_table(n, device_key(device), use_smul13(smul13))


def _check_base(bx: int, by: int):
    for name, v in (("bx", bx), ("by", by)):
        if not 0 <= v < 1 << 256:
            raise ValueError(f"{name} is not a 256-bit value")


def seq_madd_plain(ox: torch.Tensor, oy: torch.Tensor, bx: int, by: int):
    """Plain version of K5: (8, N) uint32 LE offset limbs and the affine
    base (bx, by) -> X3, Y3, ZZ, ZZZ as (8, N) uint32 LE limbs below 2^256,
    the formulas of ``vuke_tpu/ecc/incremental.py:73-78``."""
    _check_base(bx, by)
    n, dev = ox.shape[1], ox.device
    ox, oy = F.from_u32_le(ox), F.from_u32_le(oy)
    bxl, byl = F.const(bx, n, dev), F.const(by, n, dev)
    dx = F.sub(ox, bxl)
    dy = F.sub(oy, byl)
    zz = F.sqr(dx)
    zzz = F.mul(zz, dx)
    x3 = F.sub(F.sqr(dy), F.mul(F.add(ox, bxl), zz))
    y3 = F.sub(F.mul(dy, F.sub(F.mul(bxl, zz), x3)), F.mul(byl, zzz))
    return tuple(F.to_u32_le(F.exact(a)) for a in (x3, y3, zz, zzz))


def seq_madd(ox: torch.Tensor, oy: torch.Tensor, bx: int, by: int):
    """(8, N) uint32 LE offset limbs + affine base (bx, by) -> (X3, Y3, ZZ,
    ZZZ), each (8, N) uint32 LE limbs below 2^256.

    A CUDA tensor goes through the K5 kernel, the base point passed by
    value; a CPU tensor through the plain version."""
    n = check_words(ox, 8, "ox")
    if check_words(oy, 8, "oy") != n:
        raise ValueError(f"oy: batch {oy.shape[1]} != {n}")
    dev = check_same_device(ox, oy)
    if dev.type == "cpu":
        return seq_madd_plain(ox, oy, bx, by)
    _check_base(bx, by)
    base = (ctypes.c_uint32 * 16)(*[(v >> (32 * j)) & MASK32
                                    for v in (bx, by) for j in range(8)])
    outs = [torch.empty((8, n), dtype=torch.uint32, device=dev) for _ in range(4)]
    if n:
        KERNEL.launch(dev, ox.data_ptr(), oy.data_ptr(), ctypes.addressof(base),
                      *[o.data_ptr() for o in outs], n)
    return tuple(outs)


def sequential_core(bx: int, by: int, offx: torch.Tensor, offy: torch.Tensor, *,
                    plain: bool = False) -> dict:
    """Base point + offset table -> the derive dict of ``tiled._derive_core``
    (``h160c``/``h160u`` (N, 5) LE words, ``frag_c``/``frag_u`` (hi, lo)
    pairs): lane i holds B + (i + 1) * G.  K5 -> K4 -> K2 (fragments in its
    epilogue), no torch op between them; ``plain=True`` runs every stage's
    plain version on any device."""
    if plain:
        madd, affine, digests = (seq_madd_plain, inv.affine_plain,
                                 hash160.hash160s_and_fragments_plain)
    else:
        madd, affine, digests = seq_madd, inv.affine, hash160.hash160s_and_fragments
    return derive_dict(*digests(*affine(*madd(offx, offy, bx, by))))
