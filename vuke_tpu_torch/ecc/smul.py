"""Fixed-base scalar multiplication k*G over zero-free odd 14-bit digits.

Counterpart of ``vuke_tpu/ecc/pallas_smul13.py`` (kernel K3,
``_smul13_kernel`` with ``signed="odd"``), at the width ``WBITS`` picked on
the card (``csrc/smul.cu`` has the sweep), where the TPU kernel took 10
bits: 19 windows, each one table lookup of an odd multiple (2j+1) *
2^(14w) * G and one mixed addition in (X, Y, ZZ = Z^2, ZZZ = Z^3)
coordinates.  Window 0 seeds the accumulator (ZZ = ZZZ = 1); a negative
digit negates the looked-up y.  The recoding, the table and the plain
version take any width from 10 to 15 (``wbits``), so the tests hold width
10 against the JAX package; the kernel (``csrc/smul.cu``) is compiled for
``WBITS`` alone.

Contract: the affine point (X / ZZ, Y / ZZZ) equals the TPU kernel's.  The
port's representatives are 8 x 32-bit little-endian limbs below 2^256,
word-major ``(8, N)`` uint32; they need not be the TPU's.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .._device import MASK32, check_same_device, check_words, device_key, i64
from ..kernels import PTR, SIZE, Kernel
from . import field as F
from . import ref

WBITS = 14                        # csrc/smul.cu's kWbits


def n_windows(wbits: int) -> int:
    """Windows of a width: ceil(256 / wbits), which leaves the two spare
    top bits that an even k's k + n < 2^257 needs for widths 10 to 15."""
    return -(-256 // wbits)


WINDOWS = n_windows(WBITS)        # 19: 266 bits
TSIZE = 1 << (WBITS - 1)          # odd magnitudes 1, 3, .., 2^14 - 1
_N_WORDS_BE = [(ref.N >> (32 * (7 - i))) & MASK32 for i in range(8)]

KERNEL = Kernel(
    "smul", "vk_smul", [PTR, PTR, PTR, PTR, PTR, PTR, SIZE],
    source="vuke_tpu_torch/csrc/smul.cu",
    replaces="vuke_tpu/ecc/pallas_smul13.py:500 _smul13_kernel")


def _check_wbits(wbits: int) -> None:
    # idx | sign << 15 needs idx < 2^15; the odd recoding needs 258 bits
    if not 10 <= wbits <= 15:
        raise ValueError(f"window width {wbits} is outside 10..15")


def affine_add(p1, p2):
    """Affine sum of two distinct, non-opposite points (table building)."""
    (x1, y1), (x2, y2) = p1, p2
    if x1 == x2:
        lam = 3 * x1 * x1 * pow(2 * y1, -1, ref.P) % ref.P
    else:
        lam = (y2 - y1) * pow(x2 - x1, -1, ref.P) % ref.P
    x3 = (lam * lam - x1 - x2) % ref.P
    return x3, (lam * (x1 - x3) - y1) % ref.P


def build_table(wbits: int = WBITS) -> np.ndarray:
    """(windows, 2^(wbits-1), 16) uint32: entry [w, j] = affine (2j+1) *
    2^(wbits w) * G, x as 8 LE 32-bit limbs then y as 8 LE limbs; at 14
    bits 19 x 8192 rows, 9.96 MB.  Built from ``ecc.ref``'s curve
    constants: each window's row j + 1 is row j plus 2 * 2^(wbits w) * G,
    in affine coordinates, with one inversion a step for all the windows
    (Montgomery's trick over their x differences), so a row costs six
    modular products and a share of one inversion."""
    _check_wbits(wbits)
    p, windows, tsize = ref.P, n_windows(wbits), 1 << (wbits - 1)
    xs, ys, sxs, sys_ = [], [], [], []
    base = (ref.GX, ref.GY)
    for _ in range(windows):
        sx, sy = affine_add(base, base)
        xs.append(base[0])
        ys.append(base[1])
        sxs.append(sx)
        sys_.append(sy)
        for _ in range(wbits):
            base = affine_add(base, base)
    rows = [[b""] * tsize for _ in range(windows)]
    prefix = [0] * windows
    for j in range(tsize):
        for w in range(windows):
            rows[w][j] = xs[w].to_bytes(32, "little") + ys[w].to_bytes(32, "little")
        if j + 1 == tsize:
            break
        acc = 1
        for w in range(windows):               # prefix[w] = d_0 ... d_(w-1)
            prefix[w] = acc
            acc = acc * (sxs[w] - xs[w]) % p
        inv = pow(acc, -1, p)                  # 1 / (d_0 ... d_w), w from the top
        for w in range(windows - 1, -1, -1):
            x1, sx = xs[w], sxs[w]
            lam = (sys_[w] - ys[w]) * (inv * prefix[w] % p) % p
            inv = inv * (sx - x1) % p
            x3 = (lam * lam - x1 - sx) % p
            ys[w] = (lam * (x1 - x3) - ys[w]) % p
            xs[w] = x3
    table = np.frombuffer(b"".join(b"".join(r) for r in rows), dtype="<u4")
    return table.astype(np.uint32).reshape(windows, tsize, 16)


@functools.lru_cache(maxsize=2)
def window_table(wbits: int = WBITS) -> np.ndarray:
    """``build_table(wbits)``, built once and kept."""
    return build_table(wbits)


@functools.lru_cache(maxsize=None)
def table_on(device: str) -> torch.Tensor:
    """The kernel's window table as a uint32 tensor on ``device`` (kept for
    reuse, one a device; ``_device.device_key`` names the device)."""
    return torch.from_numpy(window_table()).to(device)


def odd_encode(words: torch.Tensor, wbits: int = WBITS) -> torch.Tensor:
    """Zero-free odd-digit recoding of normalized scalars.

    (8, N) BE words in [1, n-1] -> (n_windows(wbits), N) uint32 digits
    ``idx | sign<<15``, LSB window first, window value (2*idx + 1) *
    (-1)^sign.  Same recoding as
    ``vuke_tpu.ecc.pallas_smul13.odd_encode_rows``: an even k first gains n
    (bit 256 kept as a ninth, most significant word)."""
    _check_wbits(wbits)
    w = [i64(words[i]) for i in range(8)]
    even = (w[7] & 1) == 0
    plus = [None] * 8
    carry = torch.zeros_like(w[0])
    for i in range(7, -1, -1):
        t = w[i] + _N_WORDS_BE[i] + carry
        plus[i] = t & MASK32
        carry = t >> 32
    k = [torch.where(even, carry, 0)] + \
        [torch.where(even, plus[i], w[i]) for i in range(8)]
    lowmask = (1 << (wbits + 1)) - 1
    half = 1 << wbits
    digs = []
    for _ in range(n_windows(wbits) - 1):
        low = k[8] & lowmask                       # odd, k mod 2^(wbits+1)
        neg = low < half
        mag = torch.where(neg, half - low, low - half)
        digs.append((mag >> 1) | (neg.to(torch.int64) << 15))
        # k = ((k >> wbits) & ~1) | 1 over the 9-word chain
        nk = [k[0] >> wbits] + [((k[i] >> wbits) | (k[i - 1] << (32 - wbits)))
                                & MASK32 for i in range(1, 9)]
        nk[8] = nk[8] | 1
        k = nk
    digs.append(k[8] >> 1)                         # top digit: odd, positive
    return torch.stack(digs, dim=0).to(torch.uint32)


def madd(X, Y, ZZ, ZZZ, x2, y2):
    """(X, Y, ZZ, ZZZ) + affine (x2, y2): 8M + 2S, the formulas of
    ``pallas_smul13._madd13``."""
    H = F.sub(F.mul(x2, ZZ), X)
    R = F.sub(F.mul(y2, ZZZ), Y)
    HH = F.sqr(H)
    HHH = F.mul(H, HH)
    V = F.mul(X, HH)
    X3 = F.sub(F.sub(F.sqr(R), HHH), F.add(V, V))
    Y3 = F.sub(F.mul(R, F.sub(V, X3)), F.mul(Y, HHH))
    return X3, Y3, F.mul(ZZ, HH), F.mul(ZZZ, HHH)


def _lookup(table: torch.Tensor, w: int, digit: torch.Tensor):
    d = i64(digit)
    entry = i64(table[w].view(torch.int32).index_select(0, d & 0x7FFF).T) & MASK32  # (16, N)
    x2 = F.from_u32_le(entry[:8])
    y2 = F.from_u32_le(entry[8:])
    y2 = torch.where(((d >> 15) & 1).bool()[None], F.neg(y2), y2)
    return x2, y2


def scalar_mul_plain(words: torch.Tensor, table: torch.Tensor, wbits: int = WBITS):
    """Plain version of K3: (8, N) normalized BE scalar words and the
    ``window_table(wbits)`` (as a uint32 tensor) -> X, Y, ZZ, ZZZ as (8, N)
    uint32 LE limbs."""
    if tuple(table.shape) != (n_windows(wbits), 1 << (wbits - 1), 16):
        raise ValueError(f"table of shape {tuple(table.shape)} is not the {wbits}-bit one")
    n = words.shape[1]
    digits = odd_encode(words, wbits)
    X, Y = _lookup(table, 0, digits[0])
    ZZ = F.const(1, n, words.device)
    ZZZ = ZZ.clone()
    for w in range(1, n_windows(wbits)):
        x2, y2 = _lookup(table, w, digits[w])
        X, Y, ZZ, ZZZ = madd(X, Y, ZZ, ZZZ, x2, y2)
    return tuple(F.to_u32_le(F.exact(a)) for a in (X, Y, ZZ, ZZZ))


def scalar_mul(words: torch.Tensor):
    """(8, N) uint32 normalized BE scalar words -> (X, Y, ZZ, ZZZ), each
    (8, N) uint32 LE limbs below 2^256.

    A CUDA tensor goes through the K3 kernel (digit recoding in its
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
