"""The derive path, word-major end to end: seeds or key words -> hash160s.

Counterpart of ``vuke_tpu/ecc/tiled.py``: keygen (K1, normalize mod n in
its epilogue) -> fixed-base scalar multiplication (K3, odd recoding in its
prologue; or K6 over byte windows when ``smul13`` is off, as
``VUKE_TPU_SMUL13=0`` selects in the JAX package) -> batch inversion and
affine conversion (K4) -> hash160 of both pubkey forms and the 8-byte match
fragments (K2, fragments in its epilogue).  Key words that do not come from
K1 are normalized by one kernel (``scalar.normalize_words``).  Every stage
boundary is a word-major ``(rows, N)`` uint32 tensor: the TPU's ``(rows,
nb, 8, 128)`` tile layout flattened, with the same lane order.  On the
card, no torch op runs between the kernels.

``plain=True`` runs every stage's plain PyTorch version on any device: the
reference the kernels are held against on the card.  Otherwise each stage
goes through its kernel for a CUDA tensor and its plain version for a CPU
tensor.
"""

from __future__ import annotations

import os

import torch

from .._device import device_key
from ..cores import hash160, mt19937
from . import inv, smul, smul_w8
from .scalar import normalize_words, normalize_words_plain


def use_smul13(smul13: bool | None = None) -> bool:
    """Whether the scalar multiplication is K3 (odd 14-bit digits) rather
    than K6 (byte windows): ``smul13`` when given, else True unless
    ``VUKE_TPU_SMUL13`` is 0, false or no, the JAX package's switch
    (``vuke_tpu/ecc/tiled.py:22-27``)."""
    if smul13 is not None:
        return smul13
    return os.environ.get("VUKE_TPU_SMUL13", "1") not in ("0", "false", "no")


def _stages(plain: bool, smul13: bool | None):
    """(keygen, normalize, scalar_mul, affine, hash160s_and_fragments) for
    ``use_smul13(smul13)``."""
    mod = smul if use_smul13(smul13) else smul_w8
    if plain:
        return (mt19937.milksad_key_words_plain, normalize_words_plain,
                lambda w: mod.scalar_mul_plain(w, mod.table_on(device_key(w.device))),
                inv.affine_plain, hash160.hash160s_and_fragments_plain)
    return (mt19937.milksad_key_words, normalize_words, mod.scalar_mul, inv.affine,
            hash160.hash160s_and_fragments)


def affine_points(norm: torch.Tensor, *, smul13: bool | None = None,
                  plain: bool = False):
    """Normalized (8, N) scalars -> canonical affine (x, y) of k * G as
    (8, N) uint32 BE words: K3 or K6, then K4.  N must be a multiple of
    ``inv.CHUNK``."""
    _, _, scalar_mul, affine, _ = _stages(plain, smul13)
    return affine(*scalar_mul(norm))


def derive_dict(hc: torch.Tensor, hu: torch.Tensor, frag_c, frag_u) -> dict:
    """K2's outputs -> the derive dict: ``h160c``/``h160u`` (N, 5) LE words
    (views of the (5, N) digests) and ``frag_c``/``frag_u`` (hi, lo) pairs
    of (N,) uint32."""
    return {"h160c": hc.T, "h160u": hu.T, "frag_c": frag_c, "frag_u": frag_u}


def _derive_core(norm: torch.Tensor, plain: bool, smul13: bool | None) -> dict:
    """Normalized (8, N) scalars -> hash160s and match fragments."""
    hash160s_and_fragments = _stages(plain, smul13)[4]
    return derive_dict(*hash160s_and_fragments(*affine_points(norm, smul13=smul13,
                                                             plain=plain)))


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
    return _derive_core(keygen(seeds, normalize=True), plain, smul13)


def derive_tiled_from_words(words: torch.Tensor, *, plain: bool = False,
                            smul13: bool | None = None) -> dict:
    """(8, N) uint32 BE-word scalars -> the derive dict plus ``norm``, the
    normalized scalars as (N, 8) words.  ``smul13`` as in
    ``derive_hash160s_tiled``."""
    _check_batch(words.shape[1])
    norm = _stages(plain, smul13)[1](words)
    out = _derive_core(norm, plain, smul13)
    out["norm"] = norm.T
    return out
