"""PBKDF2-HMAC-SHA512 of many passwords with one salt: the BIP39 stretch,
batched across candidates (MultiBit HD's dictionary attack).

The port of ``vuke_tpu/wallets/pbkdf2_device.py``.  ``pbkdf2_sha512`` is
the wrapper of the kernel W1 (``csrc/pbkdf2_sha512.cu``), which replaces
the JAX package's ``_pbkdf2_program`` (its ``fori_loop`` of 2 x 2047
SHA-512 compressions a lane): it takes each lane's 128-byte HMAC key block
and the salt's block, and gives the 64-byte derived key (dkLen 64, one
PRF block, the BIP39 shape).  A CUDA tensor goes through W1, a CPU tensor
through the plain version beside it (``cores/sha512.py``), whose torch ops
are far too slow for 2048 iterations: they serve the tests at a few.
``pbkdf2_hmac_sha512_batch`` packs the blocks and runs W1 on the card, or
hashlib (OpenSSL, the best host implementation) on the CPU.
"""

from __future__ import annotations

import hashlib
from typing import List, Sequence

import numpy as np
import torch

from .._device import MASK32, check_words, i64, u32
from ..cores import sha512 as s512
from ..kernels import INT, PTR, SIZE, Kernel

KERNEL = Kernel(
    "pbkdf2_sha512", "vk_pbkdf2_sha512", [PTR, SIZE, INT, PTR, PTR],
    source="vuke_tpu_torch/csrc/pbkdf2_sha512.cu",
    replaces="vuke_tpu/wallets/pbkdf2_device.py:65 _pbkdf2_program (XLA)")

IPAD, OPAD = 0x36363636, 0x5C5C5C5C


def _key_block(password: bytes) -> bytes:
    """The HMAC key padded to the 128-byte block (a longer key pre-hashed)."""
    if len(password) > 128:
        password = hashlib.sha512(password).digest()
    return password + b"\x00" * (128 - len(password))


def _salt_block_words(salt: bytes) -> List[int]:
    """The first inner hash's second block, salt || INT(1) || 0x80 || zeros
    || the 128-bit bit length, as 32 BE u32 words; the salt takes at most
    107 bytes, so that it fits one block after the key block."""
    msg = salt + (1).to_bytes(4, "big")
    if len(msg) > 111:
        raise AssertionError("salt too long for the single-block device path")
    total_bits = (128 + len(msg)) * 8
    block = msg + b"\x80" + b"\x00" * (111 - len(msg)) + total_bits.to_bytes(16, "big")
    return np.frombuffer(block, dtype=">u4").astype(np.int64).tolist()


def key_blocks(passwords: Sequence[bytes]) -> torch.Tensor:
    """Passwords -> (32, N) uint32: each one's key block as BE words."""
    raw = b"".join(_key_block(p) for p in passwords)
    words = np.frombuffer(raw, dtype=">u4").astype(np.uint32).reshape(len(passwords), 32)
    return torch.from_numpy(np.ascontiguousarray(words.T).view(np.int32)).view(torch.uint32)


def _pairs(words: list) -> list:
    """32 u32 words (tensors or ints) -> 16 (hi, lo) pairs."""
    return [(words[2 * j], words[2 * j + 1]) for j in range(len(words) // 2)]


def pbkdf2_sha512_plain(keys: torch.Tensor, salt_block: Sequence[int],
                        iterations: int) -> torch.Tensor:
    """Plain version of ``pbkdf2_sha512``, in int64 torch ops."""
    k = i64(keys)
    ipad = _pairs([k[j] ^ IPAD for j in range(32)])
    opad = _pairs([k[j] ^ OPAD for j in range(32)])
    inner = s512.compress(s512.iv(), ipad)
    outer = s512.compress(s512.iv(), opad)
    u = s512.compress(outer, s512.pad_64(s512.compress(inner, _pairs(list(salt_block)))))
    t = list(u)
    for _ in range(iterations - 1):
        u = s512.compress(outer, s512.pad_64(s512.compress(inner, s512.pad_64(u))))
        t = [s512.xor(a, b) for a, b in zip(t, u)]
    zero = k[0] * 0
    return u32(torch.stack([w + zero for pair in t for w in pair]))


def pbkdf2_sha512(keys: torch.Tensor, salt_block: Sequence[int],
                  iterations: int = 2048) -> torch.Tensor:
    """PBKDF2-HMAC-SHA512 with dkLen 64: ``keys`` (32, N) uint32, each
    lane's HMAC key block as BE words (``key_blocks``); ``salt_block`` the
    32 words of ``_salt_block_words``; -> (16, N) uint32, each lane's
    derived key as BE words.  A CUDA tensor goes through W1, a CPU tensor
    through the plain version."""
    n = check_words(keys, 32, "keys")
    if len(salt_block) != 32 or iterations < 1:
        raise ValueError(f"pbkdf2: {len(salt_block)} salt words, {iterations} iterations")
    if keys.device.type == "cpu":
        return pbkdf2_sha512_plain(keys, salt_block, iterations)
    out = torch.empty((16, n), dtype=torch.uint32, device=keys.device)
    if n:
        salt = np.array([int(w) & MASK32 for w in salt_block], dtype=np.uint32)
        KERNEL.launch(keys.device, keys.data_ptr(), n, iterations, salt.ctypes.data,
                      out.data_ptr())
    return out


def pbkdf2_hmac_sha512_batch(passwords: Sequence[bytes], salt: bytes, iterations: int = 2048,
                             device=None) -> List[bytes]:
    """The 64-byte PBKDF2-HMAC-SHA512 keys of ``passwords`` with one salt:
    W1 on a CUDA ``device``, hashlib on the CPU (``device`` None)."""
    if not passwords:
        return []
    dev = torch.device("cpu") if device is None else torch.device(device)
    if dev.type == "cpu":
        _salt_block_words(salt)
        return [hashlib.pbkdf2_hmac("sha512", p, salt, iterations, 64) for p in passwords]
    out = pbkdf2_sha512(key_blocks(passwords).to(dev), _salt_block_words(salt), iterations)
    raw = np.ascontiguousarray(out.view(torch.int32).cpu().numpy().view(np.uint32).T)
    raw = raw.astype(">u4").tobytes()
    return [raw[64 * i:64 * i + 64] for i in range(len(passwords))]


def device_available(device=None) -> bool:
    """True on the card: batches of candidates then go through W1."""
    return device is not None and torch.device(device).type == "cuda"
