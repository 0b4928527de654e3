"""The derive path, word-major end to end: seeds or key words -> hash160s.

Counterpart of ``vuke_tpu/ecc/tiled.py``: keygen (K1) -> normalize mod n
-> fixed-base scalar multiplication (K3, odd recoding in its prologue; or
K6 over byte windows when ``smul13`` is off, as ``VUKE_TPU_SMUL13=0``
selects in the JAX package) -> batch inversion and affine conversion (K4)
-> hash160 of both pubkey forms (K2) -> 8-byte match fragments.  Every
stage boundary is a word-major ``(rows, N)`` uint32 tensor: the TPU's ``(rows, nb, 8, 128)`` tile layout
flattened, with the same lane order.

``plain=True`` runs every stage's plain PyTorch version on any device: the
reference the kernels are held against on the card.  Otherwise each stage
goes through its kernel for a CUDA tensor and its plain version for a CPU
tensor.
"""

from __future__ import annotations

import os

import torch

from .._device import MASK32, byteswap32, i64, u32
from ..cores import hash160, mt19937
from . import inv, ref, smul, smul_w8

_N_WORDS = [(ref.N >> (32 * (7 - i))) & MASK32 for i in range(8)]


def normalize_words(words: torch.Tensor) -> torch.Tensor:
    """(8, N) BE-word scalars -> reduced into [1, n-1]: one conditional
    subtract of n (inputs are below 2^256 < 2n), and 0 maps to 1."""
    w = [i64(words[i]) for i in range(8)]
    ge = torch.zeros_like(w[0], dtype=torch.bool)
    decided = torch.zeros_like(ge)
    for i in range(8):
        gt = w[i] > _N_WORDS[i]
        lt = w[i] < _N_WORDS[i]
        ge = ge | (~decided & gt)
        decided = decided | gt | lt
    ge = ge | ~decided
    sub = [None] * 8
    borrow = torch.zeros_like(w[0])
    for i in range(7, -1, -1):
        t = w[i] - _N_WORDS[i] - borrow
        borrow = (t >> 32) & 1
        sub[i] = t & MASK32
    out = torch.where(ge[None], torch.stack(sub), torch.stack(w))
    zero = (out == 0).all(dim=0)
    out[7] = torch.where(zero, 1, out[7])
    return u32(out)


def use_smul13(smul13: bool | None = None) -> bool:
    """Whether the scalar multiplication is K3 (odd 10-bit digits) rather
    than K6 (byte windows): ``smul13`` when given, else True unless
    ``VUKE_TPU_SMUL13`` is 0, false or no, the JAX package's switch
    (``vuke_tpu/ecc/tiled.py:22-27``)."""
    if smul13 is not None:
        return smul13
    return os.environ.get("VUKE_TPU_SMUL13", "1") not in ("0", "false", "no")


def _stages(plain: bool, smul13: bool | None):
    """(keygen, scalar_mul, affine, hash160s) for ``use_smul13(smul13)``."""
    mod = smul if use_smul13(smul13) else smul_w8
    if plain:
        return (mt19937.milksad_key_words_plain,
                lambda w: mod.scalar_mul_plain(w, mod.table_on(str(w.device))),
                inv.affine_plain, hash160.hash160s_plain)
    return (mt19937.milksad_key_words, mod.scalar_mul, inv.affine,
            hash160.hash160s)


def affine_points(norm: torch.Tensor, *, smul13: bool | None = None,
                  plain: bool = False):
    """Normalized (8, N) scalars -> canonical affine (x, y) of k * G as
    (8, N) uint32 BE words: K3 or K6, then K4.  N must be a multiple of
    ``inv.CHUNK``."""
    _, scalar_mul, affine, _ = _stages(plain, smul13)
    return affine(*scalar_mul(norm))


def _derive_core(norm: torch.Tensor, plain: bool, smul13: bool | None) -> dict:
    """Normalized (8, N) scalars -> hash160s and match fragments."""
    hash160s = _stages(plain, smul13)[3]
    hc, hu = hash160s(*affine_points(norm, smul13=smul13, plain=plain))
    return {
        "h160c": hc.T,
        "h160u": hu.T,
        "frag_c": fragments(hc),
        "frag_u": fragments(hu),
    }


def fragments(h160_t: torch.Tensor):
    """(5, N) LE digest words -> the (hi, lo) uint32 (N,) pair of the first
    8 hash160 bytes read big-endian: byteswap32 of words 0 and 1."""
    return u32(byteswap32(i64(h160_t[0]))), u32(byteswap32(i64(h160_t[1])))


def _check_batch(n: int):
    if n % inv.CHUNK:
        raise ValueError(f"batch {n} is not a multiple of {inv.CHUNK}")


def derive_hash160s_tiled(seeds: torch.Tensor, *, plain: bool = False,
                          smul13: bool | None = None) -> dict:
    """(N,) uint32 milksad seeds -> dict of ``h160c``/``h160u`` (N, 5) LE
    words and ``frag_c``/``frag_u`` (hi, lo) pairs of (N,) uint32.
    ``smul13`` picks K3 (True) or K6 (False); None reads the environment
    (``use_smul13``)."""
    _check_batch(seeds.shape[0])
    keygen = _stages(plain, smul13)[0]
    return _derive_core(normalize_words(keygen(seeds)), plain, smul13)


def derive_tiled_from_words(words: torch.Tensor, *, plain: bool = False,
                            smul13: bool | None = None) -> dict:
    """(8, N) uint32 BE-word scalars -> the derive dict plus ``norm``, the
    normalized scalars as (N, 8) words.  ``smul13`` as in
    ``derive_hash160s_tiled``."""
    _check_batch(words.shape[1])
    norm = normalize_words(words)
    out = _derive_core(norm, plain, smul13)
    out["norm"] = norm.T
    return out
