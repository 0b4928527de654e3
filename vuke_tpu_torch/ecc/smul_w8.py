"""Fixed-base scalar multiplication k*G over 32 unsigned byte windows.

Counterpart of ``vuke_tpu/ecc/pallas_smul.py`` (kernel K6,
``_smul_kernel``) and of its table, ``vuke_tpu/ecc/point.py``'s
``fixed_base_table``: 32 windows, each one lookup of d * 2^(8w) * G for the
byte digit d and one mixed addition in (X, Y, ZZ = Z^2, ZZZ = Z^3)
coordinates.  The JAX package takes this kernel only with
``VUKE_TPU_SMUL13=0`` (``ecc/tiled.use_smul13``); so does the port.

Unlike K3's zero-free odd digits, a byte digit can be 0: that window keeps
the accumulator, and the accumulator starts at infinity, so the first
non-zero digit loads its table point with ZZ = ZZZ = 1.  No doubling case
arises for k in [1, n-1]: after w windows the accumulator is
(k mod 2^(8w)) * G, below 2^(8w) times G, never +-d * 2^(8w) * G.

Contract: X, Y, ZZ, ZZZ equal the TPU kernel's mod p.  The port's
representatives are 8 x 32-bit little-endian limbs below 2^256, word-major
``(8, N)`` uint32; they need not be the TPU's.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .._device import MASK32, check_same_device, check_words, device_key, i64, u32
from ..kernels import PTR, SIZE, Kernel
from . import field as F
from . import ref
from .smul import affine_add, madd

WBITS = 8
WINDOWS = 32
TSIZE = 1 << WBITS                # digits 0 .. 255; entry 0 is never added

KERNEL = Kernel(
    "smul_w8", "vk_smul_w8", [PTR, PTR, PTR, PTR, PTR, PTR, SIZE],
    source="vuke_tpu_torch/csrc/smul_w8.cu",
    replaces="vuke_tpu/ecc/pallas_smul.py:149 _smul_kernel")


@functools.lru_cache(maxsize=1)
def window_table() -> np.ndarray:
    """(32, 256, 16) uint32: entry [w, d] = affine d * 2^(8w) * G, x as 8
    LE 32-bit limbs then y as 8 LE limbs; entry d = 0 is zeros, as in
    ``point.fixed_base_table``.  Built from ``ecc.ref``; 512 KiB."""
    out = np.zeros((WINDOWS, TSIZE, 16), dtype=np.uint32)
    shifts = np.arange(8, dtype=object) * 32
    base = (ref.GX, ref.GY)
    for w in range(WINDOWS):
        acc = base
        for d in range(1, TSIZE):
            x, y = acc
            out[w, d, :8] = (x >> shifts) & MASK32
            out[w, d, 8:] = (y >> shifts) & MASK32
            if d + 1 < TSIZE:
                acc = affine_add(acc, base)
        for _ in range(WBITS):
            base = affine_add(base, base)
    return out


@functools.lru_cache(maxsize=None)
def table_on(device: str) -> torch.Tensor:
    """The window table as a uint32 tensor on ``device`` (kept for reuse,
    one a device; ``_device.device_key`` names the device)."""
    return torch.from_numpy(window_table()).to(device)


def byte_digits(words: torch.Tensor) -> torch.Tensor:
    """(8, N) BE words -> (32, N) uint32 byte windows, LSB first: window w
    is byte ``w % 4`` of word ``7 - w // 4`` (``tiled._digits_t`` with
    ``wbits=8``)."""
    limbs = i64(words).flip(0)                                # LE 32-bit limbs
    shifts = torch.arange(0, 32, 8, dtype=torch.int64, device=words.device)
    return u32(((limbs[:, None, :] >> shifts[None, :, None]) & 0xFF)
               .reshape(WINDOWS, -1))


def scalar_mul_plain(words: torch.Tensor, table: torch.Tensor):
    """Plain version of K6: (8, N) normalized BE scalar words and the
    (32, 256, 16) table -> X, Y, ZZ, ZZZ as (8, N) uint32 LE limbs.

    The window loop of ``pallas_smul._smul_kernel`` with its selects: every
    window computes the mixed addition; a lane still at infinity takes the
    table point with ZZ = ZZZ = 1 instead, and a lane whose digit is 0
    keeps its accumulator."""
    n, dev = words.shape[1], words.device
    table = table.to(torch.int64)
    digits = i64(byte_digits(words))
    one = F.const(1, n, dev)
    X = Y = ZZ = ZZZ = F.const(0, n, dev)
    inf = torch.ones(n, dtype=torch.bool, device=dev)
    for w in range(WINDOWS):
        d = digits[w]
        entry = table[w].index_select(0, d).T                 # (16, N)
        x2, y2 = F.from_u32_le(entry[:8]), F.from_u32_le(entry[8:])
        added = madd(X, Y, ZZ, ZZZ, x2, y2)
        seeded = (x2, y2, one, one)
        keep = (d == 0)[None]
        X, Y, ZZ, ZZZ = [torch.where(keep, old, torch.where(inf[None], s, a))
                         for old, s, a in zip((X, Y, ZZ, ZZZ), seeded, added)]
        inf = inf & (d == 0)
    return tuple(F.to_u32_le(F.exact(a)) for a in (X, Y, ZZ, ZZZ))


def scalar_mul(words: torch.Tensor):
    """(8, N) uint32 normalized BE scalar words -> (X, Y, ZZ, ZZZ), each
    (8, N) uint32 LE limbs below 2^256.

    A CUDA tensor goes through the K6 kernel (byte digits taken in its
    prologue); a CPU tensor through the plain version."""
    n = check_words(words, 8, "words")
    dev = check_same_device(words)
    table = table_on(device_key(dev))
    if dev.type == "cpu":
        return scalar_mul_plain(words, table)
    outs = [torch.empty((8, n), dtype=torch.uint32, device=dev) for _ in range(4)]
    if n:
        KERNEL.launch(dev, words.data_ptr(), table.data_ptr(),
                      *[o.data_ptr() for o in outs], n)
    return tuple(outs)
