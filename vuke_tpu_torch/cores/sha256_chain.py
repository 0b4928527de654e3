"""The SHA-256 chains of the sha256_chain transform.

Counterpart of ``vuke_tpu/cores/sha256_chain.py`` and of the string-seed
chains of ``vuke_tpu/transforms/numeric.py`` (``_string_seed_chain``,
``_append_const_bytes``).  A chain of ``depth`` keys over a seed message
(the seed's decimal string, or its 4 BE bytes):
  iterated:   k_0 = SHA256(seed), k_d = SHA256(k_{d-1});
  indexed:be: k_d = SHA256(seed || d as 4 BE bytes);
  indexed:le: k_d = SHA256(seed || d as 4 LE bytes);
  counter:    k_d = SHA256(seed || decimal ASCII of d).
Plain PyTorch over int64-held u32 words; the kernel is
``csrc/keygen_chain.cu``.
"""

from __future__ import annotations

import torch

from .._device import MASK32
from .sha256 import sha256_key_words, sha256_single_block_varlen

DEFAULT_CHAIN_DEPTH = 10
VARIANTS = ("iterated", "indexed:be", "indexed:le", "counter")


def suffix(variant: str, d: int) -> bytes:
    """The bytes appended to the seed for key ``d`` of ``variant``."""
    if variant == "indexed:be":
        return d.to_bytes(4, "big")
    if variant == "indexed:le":
        return d.to_bytes(4, "little")
    if variant == "counter":
        return str(d).encode()
    raise ValueError(f"unknown sha256_chain variant: {variant}")


def append_const_bytes(words, length: torch.Tensor, data: bytes):
    """Or ``data`` into the BE message ``words`` at the per-lane byte offset
    ``length`` -> (14 words, the new length)."""
    out = list(words) + [0] * (14 - len(words))
    pad = data + b"\x00" * (-len(data) % 4)
    widx = length >> 2
    sh = (length & 3) * 8
    for ci in range(len(pad) // 4):
        c = int.from_bytes(pad[4 * ci:4 * ci + 4], "big")
        hi_part = c >> sh
        lo_part = torch.where(sh > 0, (c << (32 - sh)) & MASK32, 0)
        for wi in range(14):
            out[wi] = (out[wi] | torch.where(widx + ci == wi, hi_part, 0)
                       | torch.where(widx + ci + 1 == wi, lo_part, 0))
    return out, length + len(data)


def chain(words, length: torch.Tensor, variant: str, depth: int = DEFAULT_CHAIN_DEPTH):
    """The ``depth`` keys (each 8 BE words) of ``variant`` over the seed
    message ``words`` of ``length`` bytes (a per-lane tensor)."""
    keys = []
    for d in range(depth):
        if variant == "iterated":
            keys.append(sha256_single_block_varlen(words, length) if d == 0
                        else sha256_key_words(keys[-1]))
        else:
            keys.append(sha256_single_block_varlen(
                *append_const_bytes(words, length, suffix(variant, d))))
    return keys
