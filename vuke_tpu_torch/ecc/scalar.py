"""Scalars reduced mod the group order n: the derive's normalize step.

Counterpart of ``vuke_tpu/ecc/tiled.py::_normalize_words_t``, which is XLA
glue inside the JAX package's jit (no Pallas kernel).  Eager torch ops
would take about 118 launches for it, so on the card it is one kernel,
``csrc/normalize.cu``, built from the same ``csrc/scalar.cuh`` function
that K1's epilogue runs (``cores/mt19937.milksad_key_words(normalize=True)``).
"""

from __future__ import annotations

import torch

from .._device import MASK32, check_same_device, check_words, i64, u32
from ..kernels import PTR, SIZE, Kernel
from . import ref

N_WORDS = [(ref.N >> (32 * (7 - i))) & MASK32 for i in range(8)]

KERNEL = Kernel(
    "normalize", "vk_normalize", [PTR, PTR, SIZE],
    source="vuke_tpu_torch/csrc/normalize.cu",
    replaces="vuke_tpu/ecc/tiled.py:286 _normalize_words_t (XLA, no Pallas)")


def normalize_words_plain(words: torch.Tensor) -> torch.Tensor:
    """(8, N) BE-word scalars -> reduced into [1, n-1]: one conditional
    subtract of n (inputs are below 2^256 < 2n), and 0 maps to 1."""
    w = [i64(words[i]) for i in range(8)]
    ge = torch.zeros_like(w[0], dtype=torch.bool)
    decided = torch.zeros_like(ge)
    for i in range(8):
        gt = w[i] > N_WORDS[i]
        lt = w[i] < N_WORDS[i]
        ge = ge | (~decided & gt)
        decided = decided | gt | lt
    ge = ge | ~decided
    sub = [None] * 8
    borrow = torch.zeros_like(w[0])
    for i in range(7, -1, -1):
        t = w[i] - N_WORDS[i] - borrow
        borrow = (t >> 32) & 1
        sub[i] = t & MASK32
    out = torch.where(ge[None], torch.stack(sub), torch.stack(w))
    zero = (out == 0).all(dim=0)
    out[7] = torch.where(zero, 1, out[7])
    return u32(out)


def normalize_words(words: torch.Tensor) -> torch.Tensor:
    """(8, N) uint32 BE-word scalars -> a new (8, N) uint32 tensor reduced
    into [1, n-1].

    A CUDA tensor goes through the normalize kernel, one launch; a CPU
    tensor through the plain version."""
    dev = check_same_device(words)
    if dev.type == "cpu":
        return normalize_words_plain(words)
    n = check_words(words, 8, "words")
    out = torch.empty_like(words)
    if n:
        KERNEL.launch(dev, words.data_ptr(), out.data_ptr(), n)
    return out
