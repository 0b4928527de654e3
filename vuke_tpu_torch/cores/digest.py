"""D1: SHA-256, SHA-256d and MD5 of byte strings of any length, and the
iterated SHA-256 chain of 32-byte keys, one launch for a whole batch.

The card-side counterpart of ``vuke_tpu/transforms/strings.py::
batched_digest`` (``cores/sha256.py::sha256_blocks`` and
``cores/md5.py::md5_blocks`` through XLA, over strings bucketed by block
count on the host) and of its iterated chain (``strings.py:172-181``).
``pack`` lays the strings out as the kernel reads them: one byte buffer,
as uint32 words with 8 spare bytes past the end, and (M + 1) int64
offsets; the kernel pads each message itself.  A CUDA tensor goes through
the kernel (``csrc/digest.cu``), a CPU tensor through the plain version,
which buckets and pads on the host as the JAX package does.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .._device import check_same_device, i64, u32
from ..kernels import INT, PTR, SIZE, Kernel
from . import md5, sha256

KERNEL = Kernel(
    "digest", "vk_digest", [PTR, PTR, PTR, INT, INT, PTR, SIZE],
    source="vuke_tpu_torch/csrc/digest.cu",
    replaces="vuke_tpu/transforms/strings.py:80 batched_digest / :177 iterated chain "
             "(XLA, no Pallas)")

MODES = ("sha256", "double_sha256", "md5")
WIDTH = {"sha256": 8, "double_sha256": 8, "md5": 4}
CHAIN = 3


def pack(datas: Sequence[bytes]):
    """Byte strings -> (words, offsets) CPU tensors: the strings end to end
    as (W,) uint32 words (LE, 8 spare zero bytes past the last), and
    (M + 1,) int64 byte offsets."""
    lens = np.fromiter((len(d) for d in datas), dtype=np.int64, count=len(datas))
    offsets = np.zeros(len(datas) + 1, dtype=np.int64)
    np.cumsum(lens, out=offsets[1:])
    blob = b"".join(datas)
    buf = np.zeros(-(-(len(blob) + 8) // 4) * 4, dtype=np.uint8)
    buf[:len(blob)] = np.frombuffer(blob, dtype=np.uint8)
    return torch.from_numpy(buf.view("<u4").copy()), torch.from_numpy(offsets)


def _check(words: torch.Tensor, offsets: torch.Tensor, mode: str):
    if mode not in MODES:
        raise ValueError(f"digest: unknown mode {mode!r}")
    if words.dtype != torch.uint32 or words.dim() != 1 or not words.is_contiguous():
        raise ValueError("digest: words must be a contiguous (W,) torch.uint32 tensor")
    if offsets.dtype != torch.int64 or offsets.dim() != 1 or not offsets.is_contiguous():
        raise ValueError("digest: offsets must be a contiguous (M + 1,) torch.int64 tensor")
    return check_same_device(words, offsets)


def unpack(words: torch.Tensor, offsets: torch.Tensor) -> list[bytes]:
    """The strings of ``pack``'s layout, back as bytes."""
    blob = i64(words).cpu().numpy().astype("<u4").tobytes()
    offs = offsets.cpu().tolist()
    return [blob[a:b] for a, b in zip(offs, offs[1:])]


def digest_plain(words: torch.Tensor, offsets: torch.Tensor, mode: str) -> torch.Tensor:
    """Plain version of ``digest``: the strings bucketed by block count,
    each padded on the host (``pad_message``), each bucket through
    ``sha256_blocks`` or ``md5_blocks``."""
    _check(words, offsets, mode)
    datas = unpack(words, offsets)
    core = md5 if mode == "md5" else sha256
    out = torch.zeros((len(datas), WIDTH[mode]), dtype=torch.int64)
    buckets: dict[int, list[int]] = {}
    for i, d in enumerate(datas):
        buckets.setdefault((len(d) + 9 + 63) // 64, []).append(i)
    for idx in buckets.values():
        blocks = torch.from_numpy(np.stack([core.pad_message(datas[i]) for i in idx]))
        dig = md5.md5_blocks(blocks) if mode == "md5" else sha256.sha256_blocks(blocks)
        if mode == "double_sha256":
            dig = torch.stack(sha256.sha256_key_words([i64(dig[:, j]) for j in range(8)]),
                              dim=1)
        out[idx] = i64(dig)
    return u32(out).to(words.device)


def digest(words: torch.Tensor, offsets: torch.Tensor, mode: str) -> torch.Tensor:
    """The strings of ``pack``'s layout -> (M, 8) uint32 BE digest words
    (sha256, double_sha256) or (M, 4) LE words (md5), one launch."""
    dev = _check(words, offsets, mode)
    if dev.type == "cpu":
        return digest_plain(words, offsets, mode)
    m = offsets.shape[0] - 1
    out = torch.empty((m, WIDTH[mode]), dtype=torch.uint32, device=dev)
    if m:
        KERNEL.launch(dev, words.data_ptr(), offsets.data_ptr(), None, MODES.index(mode), 0,
                      out.data_ptr(), m)
    return out


def _check_keys(keys: torch.Tensor, depth: int):
    if keys.dtype != torch.uint32 or keys.dim() != 2 or keys.shape[1] != 8 \
            or not keys.is_contiguous():
        raise ValueError(f"digest_chain: keys must be a contiguous (M, 8) torch.uint32 "
                         f"tensor, got {tuple(keys.shape)} {keys.dtype}")
    if depth < 1:
        raise ValueError(f"digest_chain: depth {depth} is below 1")


def digest_chain_plain(keys: torch.Tensor, depth: int) -> torch.Tensor:
    """Plain version of ``digest_chain``."""
    _check_keys(keys, depth)
    k = [i64(keys[:, j]) for j in range(8)]
    rows = [k]
    for _ in range(depth - 1):
        rows.append(sha256.sha256_key_words(rows[-1]))
    return u32(torch.stack([torch.stack(r, dim=1) for r in rows]))


def digest_chain(keys: torch.Tensor, depth: int) -> torch.Tensor:
    """(M, 8) uint32 BE key words -> (depth, M, 8): row 0 the keys, row d
    SHA-256 of row d - 1, one launch."""
    _check_keys(keys, depth)
    dev = keys.device
    if dev.type == "cpu":
        return digest_chain_plain(keys, depth)
    m = keys.shape[0]
    out = torch.empty((depth, m, 8), dtype=torch.uint32, device=dev)
    if m:
        KERNEL.launch(dev, None, None, keys.data_ptr(), CHAIN, depth, out.data_ptr(), m)
    return out
