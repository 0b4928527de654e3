"""Plain PyTorch secp256k1 field algebra: the reference for kernels K3 and K4.

A field element is a ``(16, N)`` int64 tensor of 16-bit limbs, least
significant first.  Limbs are kept *weak*: each in [0, 2^17), so the
value, any representative of the residue, is below 2^257.  A schoolbook
column sums at most 16 products below 2^34, so every mul/sqr column fits
int64 with room for the fold 2^256 == 2^32 + 977 (mod p).  Four parallel
carry rounds bring every limb back below 2^17 (pinned at the bound by
tests/test_torch_inv.py).  Carries run in parallel rounds over all
limbs (a handful of tensor ops each), with the carry out of limb 15 folded
back into limbs 0 and 2.  ``exact`` and ``canonical`` run the slower
sequential carry and are used only at stage boundaries.

The plain versions use this module; the CUDA kernels have their own
field library in ``csrc/secp256k1.cuh`` (8 x 32-bit limbs).  ``selftest``
applies that library's primitives lane-wise on the card (test-only entry
point ``vk_fe_selftest``), and these plain functions on the CPU.
"""

from __future__ import annotations

import functools

import torch

from .._device import check_same_device, check_words, device_key
from ..kernels import PTR, SIZE, Kernel
from .ref import P

M16 = 0xFFFF
LIMBS = 16
SELFTEST_OPS = ("mul", "sqr", "inv", "canon", "add", "sub")

SELFTEST_KERNEL = Kernel(
    "fe_selftest", "vk_fe_selftest", [PTR] * 8 + [SIZE],
    source="vuke_tpu_torch/csrc/fe_selftest.cu",
    replaces="none: a test of csrc/secp256k1.cuh, not a TPU kernel's counterpart")

P_LIMBS = [(P >> (16 * i)) & M16 for i in range(LIMBS)]


def _negation_pad() -> list[int]:
    """Limbs of 4p with every limb in [2^17, 2^18]: adding them before a
    limbwise subtraction of a weak operand keeps every limb non-negative."""
    base = [1 << 17] * LIMBS
    d = 4 * P - sum(b << (16 * i) for i, b in enumerate(base))
    assert 0 < d < 1 << 257
    digits = [(d >> (16 * i)) & M16 for i in range(LIMBS - 1)] + [d >> 240]
    pad = [b + x for b, x in zip(base, digits)]
    assert sum(v << (16 * i) for i, v in enumerate(pad)) == 4 * P
    assert all((1 << 17) <= v <= (1 << 18) for v in pad)
    return pad


_PAD = _negation_pad()


@functools.lru_cache(maxsize=None)
def _pad_on(device: str) -> torch.Tensor:
    return torch.tensor(_PAD, dtype=torch.int64, device=device)[:, None]


def _pad_tensor(like: torch.Tensor) -> torch.Tensor:
    return _pad_on(device_key(like.device))


def _carry(r: torch.Tensor, rounds: int) -> torch.Tensor:
    """Parallel carry rounds over (16, N) non-negative limbs, in place."""
    for _ in range(rounds):
        c = r >> 16
        r &= M16
        r[1:] += c[:-1]
        top = c[15]
        r[0] += 977 * top
        r[2] += top
    return r


def from_u32_le(limbs32: torch.Tensor) -> torch.Tensor:
    """(8, N) u32 little-endian limbs (uint32 or int64) -> (16, N) limbs."""
    v = limbs32.to(torch.int64)
    return torch.stack([v & M16, v >> 16], dim=1).reshape(LIMBS, -1)


def _pack32(a: torch.Tensor) -> torch.Tensor:
    pairs = a.reshape(8, 2, -1)
    return pairs[:, 0] | (pairs[:, 1] << 16)


def to_u32_le(a: torch.Tensor) -> torch.Tensor:
    """Exact (16, N) limbs (each < 2^16) -> (8, N) uint32 LE limbs."""
    return _pack32(a).to(torch.uint32)


def to_be_words(a: torch.Tensor) -> torch.Tensor:
    """Exact (16, N) limbs -> (8, N) uint32 big-endian words."""
    return _pack32(a).flip(0).to(torch.uint32)


def const(v: int, n: int, device) -> torch.Tensor:
    """(16, N) limbs of the constant ``v`` (0 <= v < 2^256)."""
    col = torch.tensor([(v >> (16 * i)) & M16 for i in range(LIMBS)],
                       dtype=torch.int64, device=device)
    return col[:, None].expand(LIMBS, n).clone()


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b mod p, weak limbs in and out."""
    n = a.shape[1]
    cols = torch.zeros((2 * LIMBS - 1, n), dtype=torch.int64, device=a.device)
    for i in range(LIMBS):
        cols[i:i + LIMBS].addcmul_(b, a[i:i + 1])
    # value = lo + hi * 2^256 == lo + hi * (2^32 + 977)
    r = torch.zeros((LIMBS + 1, n), dtype=torch.int64, device=a.device)
    r[:LIMBS] = cols[:LIMBS]
    hi = cols[LIMBS:]
    r[:LIMBS - 1] += 977 * hi
    r[2:] += hi
    top = r[LIMBS]
    r[0] += 977 * top
    r[2] += top
    return _carry(r[:LIMBS], 4)


def sqr(a: torch.Tensor) -> torch.Tensor:
    return mul(a, a)


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _carry(a + b, 1)


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a - b mod p as a + 4p - b, limbwise non-negative."""
    return _carry(a + _pad_tensor(a) - b, 1)


def neg(a: torch.Tensor) -> torch.Tensor:
    return _carry(_pad_tensor(a) - a, 1)


def exact(a: torch.Tensor) -> torch.Tensor:
    """Weak limbs -> the same residue below 2^256, every limb < 2^16."""
    r = a.clone()
    for _ in range(3):
        c = torch.zeros_like(r[0])
        for i in range(LIMBS):
            r[i] += c
            c = r[i] >> 16
            r[i] &= M16
        r[0] += 977 * c
        r[2] += c
    return r


def canonical(a: torch.Tensor) -> torch.Tensor:
    """Weak limbs -> the canonical representative in [0, p)."""
    e = exact(a)
    d = torch.empty_like(e)
    borrow = torch.zeros_like(e[0])
    for i in range(LIMBS):
        t = e[i] - P_LIMBS[i] - borrow
        borrow = (t >> 16) & 1
        d[i] = t & M16
    # e < 2^256 < 2p: one conditional subtract of p
    return torch.where(borrow.bool()[None], e, d)


def inv(a: torch.Tensor) -> torch.Tensor:
    """a^(p-2) by the addition chain of vuke_tpu.ecc.tiled._fe_inv_rows."""

    def sqr_k(x, k):
        for _ in range(k):
            x = sqr(x)
        return x

    x1 = a
    x2 = mul(sqr_k(x1, 1), x1)
    x3 = mul(sqr_k(x2, 1), x1)
    x6 = mul(sqr_k(x3, 3), x3)
    x9 = mul(sqr_k(x6, 3), x3)
    x11 = mul(sqr_k(x9, 2), x2)
    x22 = mul(sqr_k(x11, 11), x11)
    x44 = mul(sqr_k(x22, 22), x22)
    x88 = mul(sqr_k(x44, 44), x44)
    x176 = mul(sqr_k(x88, 88), x88)
    x220 = mul(sqr_k(x176, 44), x44)
    x223 = mul(sqr_k(x220, 3), x3)
    t = mul(sqr_k(x223, 23), x22)
    t = mul(sqr_k(t, 5), x1)
    t = mul(sqr_k(t, 3), x2)
    return mul(sqr_k(t, 2), x1)


def selftest_plain(a: torch.Tensor, b: torch.Tensor) -> dict:
    """Plain version of ``vk_fe_selftest``: (8, N) LE limbs a, b below
    2^256 -> {op: (8, N) uint32 LE limbs} for a*b, a^2, a^(p-2), the
    canonical a, a+b and a-b, each below 2^256 (canonical only for
    ``canon``)."""
    x, y = from_u32_le(a), from_u32_le(b)
    out = {"mul": mul(x, y), "sqr": sqr(x), "inv": inv(x), "add": add(x, y), "sub": sub(x, y)}
    res = {k: to_u32_le(exact(v)) for k, v in out.items()}
    res["canon"] = to_u32_le(canonical(x))
    return {k: res[k] for k in SELFTEST_OPS}


def selftest(a: torch.Tensor, b: torch.Tensor) -> dict:
    """The field library's fe_mul, fe_sqr, fe_inv, fe_canon, fe_add and
    fe_sub lane-wise: (8, N) uint32 LE limbs a, b -> {op: (8, N) uint32}.

    A CUDA tensor goes through ``csrc/fe_selftest.cu``; a CPU tensor through
    ``selftest_plain``.  Results agree mod p (weak residues below 2^256;
    ``canon`` exactly)."""
    n = check_words(a, 8, "a")
    if check_words(b, 8, "b") != n:
        raise ValueError(f"b: batch {b.shape[1]} != {n}")
    dev = check_same_device(a, b)
    if dev.type == "cpu":
        return selftest_plain(a, b)
    outs = {k: torch.empty((8, n), dtype=torch.uint32, device=dev) for k in SELFTEST_OPS}
    if n:
        SELFTEST_KERNEL.launch(dev, a.data_ptr(), b.data_ptr(),
                               *[outs[k].data_ptr() for k in SELFTEST_OPS], n)
    return outs
