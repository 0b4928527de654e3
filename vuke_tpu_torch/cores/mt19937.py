"""MT19937 milksad keygen: u32 seeds -> 8 big-endian key words.

Counterpart of ``vuke_tpu/cores/pallas_kernels.py::_mt_kernel`` (K1) and
of ``vuke_tpu.cores.mt19937.milksad_key_words`` with ``n_keys=1``.  Key
bytes are the first 8 tempered outputs serialized little-endian (rand_mt
``fill_bytes``), so the big-endian key words are the outputs byteswapped.
Only the state taps the first 8 outputs need are kept: indices 0..8 and
397..404 of the ``init_genrand`` recurrence.  With ``normalize`` the key
words come out reduced into [1, n-1], the derive's next step
(``ecc/scalar.normalize_words``), in the kernel's epilogue.
"""

from __future__ import annotations

import torch

from .._device import MASK32, byteswap32, check_same_device, i64, u32
from ..ecc.scalar import normalize_words_plain
from ..kernels import INT, PTR, SIZE, Kernel

_F32 = 1812433253
_MATRIX_A = 0x9908B0DF
_UPPER = 0x80000000
_LOWER = 0x7FFFFFFF
_TEMPER_B = 0x9D2C5680
_TEMPER_C = 0xEFC60000

KERNEL = Kernel(
    "mt19937", "vk_mt19937", [PTR, PTR, SIZE, INT],
    source="vuke_tpu_torch/csrc/mt19937.cu",
    replaces="vuke_tpu/cores/pallas_kernels.py:46 _mt_kernel")


def milksad_key_words_plain(seeds: torch.Tensor, normalize: bool = False) -> torch.Tensor:
    """(N,) uint32 seeds -> (8, N) uint32 BE key words, in int64 torch ops;
    with ``normalize``, reduced into [1, n-1] (``normalize_words_plain``)."""
    s = i64(seeds)
    taps = {0: s}
    prev = s
    for i in range(1, 405):
        # _F32 < 2^31 and prev < 2^32: the product fits int64
        cur = (_F32 * (prev ^ (prev >> 30)) + i) & MASK32
        if i <= 8 or i >= 397:
            taps[i] = cur
        prev = cur
    out = []
    for i in range(8):
        y = (taps[i] & _UPPER) | (taps[i + 1] & _LOWER)
        x = taps[i + 397] ^ (y >> 1) ^ ((y & 1) * _MATRIX_A)
        x = x ^ (x >> 11)
        x = x ^ ((x << 7) & _TEMPER_B)
        x = x ^ ((x << 15) & _TEMPER_C)
        x = x ^ (x >> 18)
        out.append(byteswap32(x))
    words = u32(torch.stack(out, dim=0))
    return normalize_words_plain(words) if normalize else words


def milksad_key_words(seeds: torch.Tensor, normalize: bool = False) -> torch.Tensor:
    """(N,) uint32 seeds -> (8, N) uint32 BE key words; with ``normalize``,
    the scalars reduced into [1, n-1] (0 maps to 1), as the derive takes
    them.

    A CUDA tensor goes through the K1 kernel, the reduction in its
    epilogue; a CPU tensor through the plain version."""
    if seeds.dtype != torch.uint32 or seeds.dim() != 1 or not seeds.is_contiguous():
        raise ValueError(f"seeds: expected a contiguous (N,) torch.uint32 tensor, "
                         f"got {tuple(seeds.shape)} {seeds.dtype}")
    dev = check_same_device(seeds)
    if dev.type == "cpu":
        return milksad_key_words_plain(seeds, normalize)
    n = seeds.shape[0]
    out = torch.empty((8, n), dtype=torch.uint32, device=dev)
    if n:
        KERNEL.launch(dev, seeds.data_ptr(), out.data_ptr(), n, int(normalize))
    return out

