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


MAX_OUTPUTS = 227        # output 226 twists state word 623, the last of the init block


def mt19937_outputs_plain(s: torch.Tensor, n_out: int = 8) -> list:
    """int64-held u32 seeds -> the first ``n_out`` tempered outputs (int64).
    Output k twists state words k, k + 1 and k + 397, so the recurrence runs
    to n_out + 396 and keeps those taps; past the 624-word init block (more
    than ``MAX_OUTPUTS`` outputs) every word is kept and the sequence goes on
    with the real twist, s[k] = s[k-227] ^ twist(s[k-624], s[k-623])
    (``vuke_tpu/cores/mt19937.py:53-60``)."""
    if n_out < 1:
        raise ValueError(f"mt19937: {n_out} outputs")
    far = n_out > MAX_OUTPUTS
    taps = {0: s}
    prev = s
    for i in range(1, min(n_out + 397, 624)):
        # _F32 < 2^31 and prev < 2^32: the product fits int64
        cur = (_F32 * (prev ^ (prev >> 30)) + i) & MASK32
        if far or i <= n_out or i >= 397:
            taps[i] = cur
        prev = cur
    for k in range(624, n_out + 397):
        y = (taps[k - 624] & _UPPER) | (taps[k - 623] & _LOWER)
        taps[k] = taps[k - 227] ^ (y >> 1) ^ ((y & 1) * _MATRIX_A)
    out = []
    for i in range(n_out):
        y = (taps[i] & _UPPER) | (taps[i + 1] & _LOWER)
        x = taps[i + 397] ^ (y >> 1) ^ ((y & 1) * _MATRIX_A)
        x = x ^ (x >> 11)
        x = x ^ ((x << 7) & _TEMPER_B)
        x = x ^ ((x << 15) & _TEMPER_C)
        x = x ^ (x >> 18)
        out.append(x)
    return out


def milksad_key_words_plain(seeds: torch.Tensor, normalize: bool = False) -> torch.Tensor:
    """(N,) uint32 seeds -> (8, N) uint32 BE key words, in int64 torch ops;
    with ``normalize``, reduced into [1, n-1] (``normalize_words_plain``)."""
    words = u32(torch.stack([byteswap32(x) for x in mt19937_outputs_plain(i64(seeds), 8)], dim=0))
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



# --- MT19937-64 (the mt64 transform) ---

_F64 = 6364136223846793005
_MATRIX_A64 = 0xB5026F5AA96619E9
_UPPER64 = 0xFFFFFFFF80000000
_LOWER64 = 0x7FFFFFFF


MAX_OUTPUTS_64 = 156     # output 155 twists state word 311, the last of the init block


def mt64_key_words_plain(hi: torch.Tensor, lo: torch.Tensor, n_keys: int = 1):
    """int64-held u32 (hi, lo) seeds -> the 8 BE key words of each of
    ``n_keys`` keys of MT19937-64 seeded with the u64 seed: its outputs
    serialized little-endian, 4 a key (``vuke_tpu/cores/mt19937.py::
    mt64_key_words``; more keys continue the stream, as
    ``vuke_tpu/analyze/analyzers.py::Mt64Analyzer._keystream`` does).
    Output k twists state words k, k + 1 and k + 156
    (``vuke_tpu/cores/mt19937.py:116-135``); past the 312-word init block
    (more than ``MAX_OUTPUTS_64`` outputs) every word is kept and the
    sequence goes on with the real twist, s[k] = s[k-156] ^ twist(s[k-312],
    s[k-311])."""
    from .common import u64_and, u64_const, u64_mul_lo, u64_or, u64_shl, u64_shr, u64_xor

    n_out = 4 * n_keys
    if n_out < 1:
        raise ValueError(f"mt64: {n_out} outputs")
    far = n_out > MAX_OUTPUTS_64
    s = (hi, lo)
    taps = {0: s}
    for k in range(1, min(n_out + 156, 312)):
        x = u64_mul_lo(u64_xor(s, u64_shr(s, 62)), u64_const(_F64))
        low = x[1] + k
        s = ((x[0] + (low >> 32)) & MASK32, low & MASK32)
        if far or k <= n_out or k >= 156:
            taps[k] = s
    for k in range(312, n_out + 156):
        y = u64_or(u64_and(taps[k - 312], u64_const(_UPPER64)),
                   u64_and(taps[k - 311], u64_const(_LOWER64)))
        odd = y[1] & 1
        taps[k] = u64_xor(u64_xor(taps[k - 156], u64_shr(y, 1)),
                          (odd * (_MATRIX_A64 >> 32), odd * (_MATRIX_A64 & MASK32)))
    out = []
    for j in range(n_out):
        y = u64_or(u64_and(taps[j], u64_const(_UPPER64)),
                   u64_and(taps[j + 1], u64_const(_LOWER64)))
        odd = y[1] & 1
        x = u64_xor(u64_xor(taps[j + 156], u64_shr(y, 1)),
                    (odd * (_MATRIX_A64 >> 32), odd * (_MATRIX_A64 & MASK32)))
        x = u64_xor(x, u64_and(u64_shr(x, 29), u64_const(0x5555555555555555)))
        x = u64_xor(x, u64_and(u64_shl(x, 17), u64_const(0x71D67FFFEDA60000)))
        x = u64_xor(x, u64_and(u64_shl(x, 37), u64_const(0xFFF7EEE000000000)))
        x = u64_xor(x, u64_shr(x, 43))
        out += [byteswap32(x[1]), byteswap32(x[0])]
    return out
