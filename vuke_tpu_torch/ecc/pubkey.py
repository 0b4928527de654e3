"""Lane-major derive API: (N, 8) key words -> affine pubkeys and hash160s.

Counterpart of ``vuke_tpu/ecc/pubkey.py``, with its names.  Keys are
lane-major ``(N, 8)`` uint32 big-endian words, as the JAX functions take
them.  The work runs on the word-major stages of ``ecc/tiled.py`` (K3, or
K6 with ``smul13`` off, then K4, then K2), with one transpose at each end:
the kernels read and write ``(8, N)`` words.  N is padded up to a multiple
of ``inv.CHUNK`` with the scalar 1 and the pad is dropped again.

The JAX functions' ``inv_chunk`` and ``use_pallas`` arguments have no
counterpart: the tensor's device decides (a CUDA tensor runs the kernels, a
CPU tensor their plain versions), and the chunk of K4 is fixed.
"""

from __future__ import annotations

import torch

from .._device import byteswap32, check_same_device, i64, u32
from ..cores import hash160
from . import inv, smul, smul_w8, tiled


def _check_lane_major(words: torch.Tensor) -> int:
    if words.dtype != torch.uint32:
        raise TypeError(f"words: expected torch.uint32, got {words.dtype}")
    if words.dim() != 2 or words.shape[1] != 8:
        raise ValueError(f"words: expected shape (N, 8), got {tuple(words.shape)}")
    check_same_device(words)
    return words.shape[0]


def normalize_scalar(words: torch.Tensor) -> torch.Tensor:
    """Reduce (..., 8) BE-word scalars into [1, n-1]: one conditional
    subtract of n, and 0 maps to 1."""
    flat = words.reshape(-1, 8)
    return tiled.normalize_words(flat.T.contiguous()).T.reshape(words.shape)


def scalar_digits(words: torch.Tensor, wbits: int = 8, signed=False) -> torch.Tensor:
    """(..., 8) BE words -> (..., n_windows) uint32 digits, LSB first.

    Only the two recodings the port's kernels take: unsigned byte windows
    (``wbits=8, signed=False``, K6's) and the zero-free odd digits
    (``wbits=10, signed="odd"``, K3's, ``idx | sign << 15``)."""
    flat = words.reshape(-1, 8).T.contiguous()
    if (wbits, signed) == (8, False):
        digs = smul_w8.byte_digits(flat)
    elif (wbits, signed) == (10, "odd"):
        digs = smul.odd_encode(flat, 10)
    else:
        raise ValueError(f"digit mode wbits={wbits}, signed={signed!r} is not ported")
    return digs.T.reshape(*words.shape[:-1], digs.shape[0])


def _affine_t(words: torch.Tensor, smul13: bool | None):
    """(N, 8) normalized words -> N and canonical affine (x, y) as padded
    (8, M) BE words, M the next multiple of ``inv.CHUNK``."""
    n = _check_lane_major(words)
    pad = -n % inv.CHUNK
    w = words.T
    if pad:
        ones = torch.zeros((8, pad), dtype=torch.int64, device=words.device)
        ones[7] = 1
        w = torch.cat([w, u32(ones)], dim=1)
    return (n, *tiled.affine_points(w.contiguous(), smul13=smul13))


def _lanes(t: torch.Tensor, n: int) -> torch.Tensor:
    """(rows, M) word-major -> (n, rows) lane-major, contiguous."""
    return t[:, :n].T.contiguous()


def _y_odd(y: torch.Tensor, n: int) -> torch.Tensor:
    return (i64(y[7, :n]) & 1).bool()


def derive_pubkey(words: torch.Tensor, *, smul13: bool | None = None):
    """(N, 8) uint32 BE-word scalars, already normalized (``normalize_scalar``)
    -> (x_words, y_words, y_odd): canonical affine x and y as (N, 8) BE
    words and the parity of y as (N,) bool.  ``smul13`` picks K3 (True) or
    K6 (False); None reads ``tiled.use_smul13()``."""
    n, x, y = _affine_t(words, smul13)
    return _lanes(x, n), _lanes(y, n), _y_odd(y, n)


def hash160_fragment(h160_le_words: torch.Tensor):
    """First 8 bytes of a hash160, (..., 5) LE words, as a (hi, lo) pair of
    uint32 (big-endian byte order within each), for matching."""
    w = i64(h160_le_words)
    return u32(byteswap32(w[..., 0])), u32(byteswap32(w[..., 1]))


def derive_hash160s(words: torch.Tensor, *, smul13: bool | None = None) -> dict:
    """(N, 8) normalized BE-word scalars -> dict of ``h160c``, ``h160u``
    ((N, 5) LE words), ``x_words``, ``y_words`` ((N, 8) BE words) and
    ``y_odd`` ((N,) bool), as ``vuke_tpu.ecc.pubkey.derive_hash160s``
    returns them.  ``smul13`` as in ``derive_pubkey``."""
    n, x, y = _affine_t(words, smul13)
    hc, hu = hash160.hash160s(x, y)
    return {
        "h160c": _lanes(hc, n),
        "h160u": _lanes(hu, n),
        "x_words": _lanes(x, n),
        "y_words": _lanes(y, n),
        "y_odd": _y_odd(y, n),
    }
