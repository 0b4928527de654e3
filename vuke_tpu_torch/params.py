"""Carry the JAX package's state into the port's layouts.

- ``table_from_jax``: ``pallas_smul13._table13_f32(wbits, "odd")``
  (windows, rows, 40) float32 13-bit limbs -> the port's
  ``smul.window_table(wbits)`` layout, (windows, rows, 16) uint32.
- ``table_w8_from_jax``: ``pallas_smul._table_f32()`` (32, 256, 32)
  float32 16-bit limbs -> the port's (32, 256, 16) uint32 byte-window table.
- ``pools_from_jax``: the numpy form of ``DeviceTargetSet.device_args()``
  -> the port's ``TargetPools``.
- ``offset_table_from_jax``: ``incremental.offset_table(n)``'s two
  (16, nb, 8, 128) 16-bit-row stacks -> the port's two (8, n) uint32
  LE-limb tensors, in the same lane order.

No function here imports jax: callers hand over numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from .matcher import TargetPools, pack_fragments_np

_L13 = 20


def _limbs13_to32(limbs: np.ndarray) -> np.ndarray:
    """(..., 20) 13-bit limbs -> (..., 8) u32 LE limbs of the same value."""
    lead = limbs.shape[:-1]
    flat = limbs.reshape(-1, _L13).astype(np.int64)
    out = np.zeros((flat.shape[0], 8), dtype=np.uint32)
    for r, row in enumerate(flat):
        v = sum(int(x) << (13 * i) for i, x in enumerate(row))
        if v >> 256:
            raise ValueError("table entry does not fit 256 bits")
        out[r] = [(v >> (32 * j)) & 0xFFFFFFFF for j in range(8)]
    return out.reshape(*lead, 8)


def table_from_jax(t13: np.ndarray) -> np.ndarray:
    """(..., 40) float32 (x limbs 0..19, y limbs 20..39, 13 bits each), as
    (26, 512, 40) at 10 bits -> (..., 16) uint32 (x then y, 8 LE 32-bit
    limbs each)."""
    t13 = np.asarray(t13)
    if t13.shape[-1] != 2 * _L13:
        raise ValueError(f"expected (..., {2 * _L13}) limbs, got {t13.shape}")
    x = _limbs13_to32(t13[..., :_L13])
    y = _limbs13_to32(t13[..., _L13:])
    return np.concatenate([x, y], axis=-1)


def table_w8_from_jax(t16: np.ndarray) -> np.ndarray:
    """``pallas_smul._table_f32()``: (32, 256, 32) float32 (x limbs 0..15,
    y limbs 16..31, 16 bits each, LE) -> (32, 256, 16) uint32 (x then y, 8
    LE 32-bit limbs each), the port's ``smul_w8.window_table()`` layout."""
    t16 = np.asarray(t16)
    if t16.shape[-1] != 32:
        raise ValueError(f"expected (..., 32) limbs, got {t16.shape}")
    limbs = t16.astype(np.int64)
    if (limbs != t16).any() or (limbs >> 16).any() or (limbs < 0).any():
        raise ValueError("table limbs are not 16-bit integers")
    limbs = limbs.astype(np.uint32)
    return limbs[..., 0::2] | (limbs[..., 1::2] << np.uint32(16))


def pools_from_jax(comp_hi, comp_lo, uncomp_hi, uncomp_lo) -> TargetPools:
    """``DeviceTargetSet.device_args()`` as numpy uint32 arrays -> pools.
    Padding entries repeat a real entry (or are the all-0xFF dummy of an
    empty pool), so the pools' deduplication keeps the membership the same."""
    comp = pack_fragments_np(np.asarray(comp_hi), np.asarray(comp_lo))
    uncomp = pack_fragments_np(np.asarray(uncomp_hi), np.asarray(uncomp_lo))
    return TargetPools(comp, uncomp)


def _rows16_to_limbs32(rows: np.ndarray) -> torch.Tensor:
    """(16, nb, 8, 128) 16-bit limb rows -> (8, n) uint32 LE limbs; lane
    t * 1024 + 128 * r + c of the result is tile t, sublane r, lane c."""
    rows = np.asarray(rows)
    if rows.ndim != 4 or rows.shape[0] != 16 or rows.shape[2:] != (8, 128):
        raise ValueError(f"expected (16, nb, 8, 128) limb rows, got {rows.shape}")
    flat = rows.reshape(16, -1).astype(np.uint32)
    if (flat >> 16).any():
        raise ValueError("limb rows are not 16-bit")
    return torch.from_numpy(flat[0::2] | (flat[1::2] << np.uint32(16)))


def offset_table_from_jax(offx: np.ndarray, offy: np.ndarray):
    """The JAX offset table (affine (i + 1) * G, x and y as 16-bit rows) ->
    the port's (8, n) uint32 LE-limb ``(offx, offy)`` on the CPU."""
    return _rows16_to_limbs32(offx), _rows16_to_limbs32(offy)
