"""Montgomery batch inversion and affine conversion.

Counterpart of ``vuke_tpu/ecc/pallas_inv.py``'s three kernels (K4a
``_fwd_kernel``, K4b ``_fermat_kernel``, K4c ``_bwd_kernel``).  The TPU
version carries one running prefix across an ordered grid; CUDA blocks run
in no order, so the port batches per thread instead: lanes are split into
``CHUNK`` interleaved groups (lane ``j*T + t`` is step ``j`` of chain
``t``, T = N / CHUNK), each chain does its own prefix products, ONE Fermat
inversion and a backward pass.  Canonical outputs do not depend on the
grouping, so x and y are bit-identical to the JAX path's
(``pallas_inv.py:28-30``).
"""

from __future__ import annotations

import torch

from .._device import check_same_device, check_words
from ..kernels import INT, PTR, SIZE, Kernel
from . import field as F

CHUNK = 16          # lanes per Montgomery chain (per CUDA thread): csrc/inv_affine.cu's M

KERNEL = Kernel(
    "inv_affine", "vk_inv_affine", [PTR, PTR, PTR, PTR, PTR, PTR, SIZE, INT],
    source="vuke_tpu_torch/csrc/inv_affine.cu",
    replaces="vuke_tpu/ecc/pallas_inv.py:92,112,144 "
             "_fwd_kernel+_fermat_kernel+_bwd_kernel")


def affine_plain(X, Y, ZZ, ZZZ, chunk: int = CHUNK):
    """Plain version of K4: (8, N) uint32 LE limbs of (X, Y, ZZ, ZZZ) ->
    canonical affine (x, y) as (8, N) uint32 BE words.  Chunked Montgomery
    vectorized over the N / chunk chains."""
    n = X.shape[1]
    if n % chunk:
        raise ValueError(f"batch {n} is not a multiple of the chunk {chunk}")
    t = n // chunk
    zz, zzz = F.from_u32_le(ZZ), F.from_u32_le(ZZZ)
    prod = F.mul(zz, zzz).reshape(F.LIMBS, chunk, t)
    acc = F.const(1, t, X.device)
    prefix = []
    for j in range(chunk):
        prefix.append(acc)
        acc = F.mul(acc, prod[:, j])
    inv_acc = F.inv(acc)
    inv_prod = [None] * chunk
    for j in range(chunk - 1, -1, -1):
        inv_prod[j] = F.mul(inv_acc, prefix[j])
        inv_acc = F.mul(inv_acc, prod[:, j])
    it = torch.stack(inv_prod, dim=1).reshape(F.LIMBS, n)
    x = F.canonical(F.mul(F.mul(F.from_u32_le(X), it), zzz))
    y = F.canonical(F.mul(F.mul(F.from_u32_le(Y), it), zz))
    return F.to_be_words(x), F.to_be_words(y)


def affine(X, Y, ZZ, ZZZ):
    """(X, Y, ZZ, ZZZ) (8, N) uint32 LE limbs -> canonical affine (x, y)
    as (8, N) uint32 BE words (what the hash160 stage reads).

    A CUDA tensor goes through the K4 kernel; a CPU tensor through the
    plain version.  N must be a multiple of ``CHUNK``."""
    n = check_words(X, 8, "X")
    for name, a in (("Y", Y), ("ZZ", ZZ), ("ZZZ", ZZZ)):
        if check_words(a, 8, name) != n:
            raise ValueError(f"{name}: batch {a.shape[1]} != {n}")
    dev = check_same_device(X, Y, ZZ, ZZZ)
    if n % CHUNK:
        raise ValueError(f"batch {n} is not a multiple of the chunk {CHUNK}")
    if dev.type == "cpu":
        return affine_plain(X, Y, ZZ, ZZZ)
    x = torch.empty((8, n), dtype=torch.uint32, device=dev)
    y = torch.empty((8, n), dtype=torch.uint32, device=dev)
    if n:
        KERNEL.launch(dev, X.data_ptr(), Y.data_ptr(), ZZ.data_ptr(),
                      ZZZ.data_ptr(), x.data_ptr(), y.data_ptr(), n, CHUNK)
    return x, y
