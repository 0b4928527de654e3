"""String-input transforms: a batch of strings -> the key words of every slot.

The port's copy of ``vuke_tpu/transforms/strings.py``: ``StringTransform``,
``batched_digest``, ``make_string_hash``, ``make_string_direct`` and
``make_string_sha256_chain``, with the same slots, labels and validity.
``fn(strings, device)`` returns (N, S, 8) uint32 BE key words as a numpy
array, the JAX package's layout.

``batched_digest`` keeps the JAX package's rule: a batch of at most
``VUKE_HOST_DIGEST_MAX`` strings (default 4096) hashes on the host with
hashlib, a larger one through D1 (``cores/digest.py``) on ``device``; the
digest is exact either way.  The iterated chain follows the same rule.
"""

from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..cores import digest as digest_core
from ..cores import sha256_chain as chain_core


@dataclass(frozen=True)
class StringTransform:
    """``fn(strings, device=None)``: (N, S, 8) uint32 key words;
    ``valid_fn(strings)``: (N, S) bool, or None when every key is valid;
    ``label_fn(string)``: the source label a hit or line prints for the
    string (None: the string itself); ``blob_fn(blobs, device=None)``: the
    keys of ``(data, label)`` file blobs (bitimage), its validity in
    ``valid_fn``'s place."""
    name: str
    slots: tuple
    fn: Callable
    valid_fn: Optional[Callable] = None
    label_fn: Optional[Callable] = None
    blob_fn: Optional[Callable] = None

    def label(self, s: str) -> str:
        return s if self.label_fn is None else self.label_fn(s)


def host_digest_max() -> int:
    """Batches of at most this many strings hash with hashlib, larger ones
    on the device (``VUKE_HOST_DIGEST_MAX``, default 4096)."""
    return int(os.environ.get("VUKE_HOST_DIGEST_MAX", 4096))


def _words(raw: bytes, order: str, width: int) -> np.ndarray:
    """Concatenated digests -> (N, width) uint32 words read in ``order``."""
    return np.frombuffer(raw, dtype=f"{order}u4").reshape(-1, width).astype(np.uint32)


def _host_digest(datas: Sequence[bytes], algo: str) -> np.ndarray:
    if algo == "md5":
        return _words(b"".join(hashlib.md5(d).digest() for d in datas), "<", 4)
    if algo == "sha256":
        return _words(b"".join(hashlib.sha256(d).digest() for d in datas), ">", 8)
    return _words(b"".join(hashlib.sha256(hashlib.sha256(d).digest()).digest() for d in datas),
                  ">", 8)


def _to_host(words: torch.Tensor) -> np.ndarray:
    return words.view(torch.int32).cpu().numpy().view(np.uint32)


def _device(device) -> torch.device:
    return torch.device("cpu") if device is None else torch.device(device)


def batched_digest(datas: Sequence[bytes], algo: str, device=None) -> np.ndarray:
    """Byte strings -> (N, 8) uint32 BE digest words (sha256,
    double_sha256) or (N, 4) LE words (md5): hashlib for a batch of at most
    ``host_digest_max()`` strings, D1 on ``device`` (the CPU when None)
    otherwise."""
    if len(datas) == 0:
        return np.zeros((0, 4 if algo == "md5" else 8), dtype=np.uint32)
    if len(datas) <= host_digest_max():
        return _host_digest(datas, algo)
    words, offsets = digest_core.pack(datas)
    dev = _device(device)
    return _to_host(digest_core.digest(words.to(dev), offsets.to(dev), algo))


def _digest_to_key_words(dig: np.ndarray, algo: str) -> np.ndarray:
    if algo == "md5":
        # the 16-byte digest twice; key BE words are the LE words byteswapped
        be = np.asarray(dig, dtype=np.uint32).byteswap()
        return np.concatenate([be, be], axis=-1)
    return dig


def make_string_hash(algo: str) -> StringTransform:
    """sha256, double_sha256 or md5 of the string itself, one slot."""

    def fn(strings: Sequence[str], device=None) -> np.ndarray:
        dig = batched_digest([s.encode() for s in strings], algo, device)
        return _digest_to_key_words(dig, algo)[:, None, :]

    return StringTransform(algo, ("",), fn)


def make_string_direct() -> StringTransform:
    """direct: the string's bytes as the key's first bytes when they are at
    most 32; a longer string yields no key (its row is zeros, masked out by
    ``valid_fn``)."""

    def fn(strings: Sequence[str], device=None) -> np.ndarray:
        out = np.zeros((len(strings), 1, 8), dtype=np.uint32)
        for i, s in enumerate(strings):
            b = s.encode()
            if len(b) <= 32:
                out[i, 0] = np.frombuffer(b + b"\x00" * (32 - len(b)), dtype=">u4")
        return out

    def valid(strings: Sequence[str]) -> np.ndarray:
        return np.array([[len(s.encode()) <= 32] for s in strings], dtype=bool)

    return StringTransform("direct", ("",), fn, valid)


def _iterated_chain(datas: Sequence[bytes], depth: int, device) -> list:
    """[SHA-256(s), SHA-256 of that, ...]: ``depth`` (N, 8) arrays."""
    key = batched_digest(datas, "sha256", device)
    if len(datas) <= host_digest_max():
        chain = [key]
        cur = [k.astype(">u4").tobytes() for k in key]
        for _ in range(depth - 1):
            cur = [hashlib.sha256(b).digest() for b in cur]
            chain.append(_words(b"".join(cur), ">", 8))
        return chain
    keys = torch.from_numpy(key.view(np.int32)).view(torch.uint32).to(_device(device))
    return list(_to_host(digest_core.digest_chain(keys, depth)))


def make_string_sha256_chain(variant: Optional[str], depth: int) -> StringTransform:
    """The chains from string seeds: every variant (or ``variant``), each
    ``depth`` keys, labelled ``[variant:d]``."""
    variants = [variant] if variant else list(chain_core.VARIANTS)

    def fn(strings: Sequence[str], device=None) -> np.ndarray:
        datas = [s.encode() for s in strings]
        if depth <= 0:
            return np.zeros((len(datas), 0, 8), dtype=np.uint32)
        cols = []
        for v in variants:
            if v == "iterated":
                cols.extend(_iterated_chain(datas, depth, device))
            else:
                for n in range(depth):
                    tail = chain_core.suffix(v, n)
                    cols.append(batched_digest([d + tail for d in datas], "sha256", device))
        return np.stack(cols, axis=1)

    slots = tuple(f"[{v}:{i}]" for v in variants for i in range(depth))
    return StringTransform("sha256_chain", slots, fn)
