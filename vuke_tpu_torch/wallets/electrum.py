"""Electrum's pre-BIP39 deterministic wallets (2011-2014).

The port's copy of ``vuke_tpu/wallets/electrum.py``: the seed (its ASCII
hex string) stretched by 100,000 SHA-256s into the master key, child keys
(master + SHA256d("{i}:{chg}:" || mpk64)) mod n, pinned by the official
Electrum vector.  A single seed stretches with hashlib (``stretch_key``).
Batches of one seed length stretch through the kernel W2
(``csrc/electrum_stretch.cu``, wrapper ``stretch``, plain version
``stretch_plain``) and their master public keys come from K3 -> K4 on the
card (``master_pubkeys_device``).
"""

from __future__ import annotations

import hashlib
from typing import List, Optional

import numpy as np
import torch

from .._device import check_words, i64, u32
from ..cores.hash160 import SHA_IV, _sha_compress
from ..ecc import ref
from ..kernels import INT, PTR, SIZE, Kernel

KERNEL = Kernel(
    "electrum_stretch", "vk_electrum_stretch", [PTR, PTR, SIZE, INT, INT, PTR],
    source="vuke_tpu_torch/csrc/electrum_stretch.cu",
    replaces="vuke_tpu/wallets/electrum.py:225 stretch_keys_device, its stretch :255 (XLA)")

ROUNDS = 99_999


class ElectrumError(ValueError):
    pass


def stretch_key(seed: bytes) -> bytes:
    """x = SHA256(seed + seed); then 99,999 times x = SHA256(x + seed)."""
    x = hashlib.sha256(seed + seed).digest()
    for _ in range(ROUNDS):
        x = hashlib.sha256(x + seed).digest()
    return x


def get_sequence(mpk64: bytes, for_change: int, index: int) -> bytes:
    data = f"{index}:{for_change}:".encode() + mpk64
    return hashlib.sha256(hashlib.sha256(data).digest()).digest()


def truncate_seed(seed: str) -> str:
    if len(seed) <= 20:
        return seed
    return f"{seed[:8]}...{seed[-8:]}"


class ElectrumDeriver:
    def __init__(self, stretched: bytes, for_change: bool = False,
                 pubkey_bytes: Optional[bytes] = None):
        k = int.from_bytes(stretched, "big")
        if k == 0 or k >= ref.N:
            raise ElectrumError("Invalid stretched key")
        self.master_privkey = k
        if pubkey_bytes is None:   # a single seed: host EC
            pubkey_bytes = ref.pubkey_uncompressed(k)[1:]
        self.master_pubkey_bytes = pubkey_bytes
        self.for_change = for_change

    @classmethod
    def from_hex_seed(cls, hex_seed: str, for_change: bool = False) -> "ElectrumDeriver":
        if not hex_seed or not all(c in "0123456789abcdefABCDEF" for c in hex_seed):
            raise ElectrumError("Seed must be valid hex")
        return cls(stretch_key(hex_seed.encode()), for_change)

    def master_pubkey_hex(self) -> str:
        return self.master_pubkey_bytes.hex()

    def derive_key(self, index: int) -> bytes:
        chg = 1 if self.for_change else 0
        seq = int.from_bytes(get_sequence(self.master_pubkey_bytes, chg, index), "big")
        if seq >= ref.N:
            raise ElectrumError("Sequence overflow")
        child = (self.master_privkey + seq) % ref.N
        if child == 0:
            raise ElectrumError("zero child key")
        return child.to_bytes(32, "big")

    def derive_keys(self, count: int) -> List[bytes]:
        return [self.derive_key(i) for i in range(count)]


def _blocks(length: int) -> int:
    """SHA-256 blocks of a 32 + ``length``-byte message."""
    return (32 + length + 9 + 63) // 64


def stretch_plain(x0: torch.Tensor, seed: torch.Tensor, length: int,
                  rounds: int) -> torch.Tensor:
    """Plain version of ``stretch``, in int64 torch ops (each round one or
    more compressions of x || seed, padded)."""
    nb = _blocks(length)
    s = i64(seed)
    tail = []
    for j in range(16 * nb - 8):
        v = s[j] if j < s.shape[0] else 0
        if j == length // 4:
            v = v | (0x80 << (8 * (3 - length % 4)))
        if j == 16 * nb - 9:
            v = v | (32 + length) * 8
        tail.append(v)
    x = list(i64(x0))
    zero = x[0] * 0
    for _ in range(rounds):
        block = x + tail[:8]
        st = _sha_compress(list(SHA_IV), block)
        for b in range(1, nb):
            st = _sha_compress(st, tail[16 * b - 8:16 * b + 8])
        x = [w + zero for w in st]
    return u32(torch.stack(x))


def stretch(x0: torch.Tensor, seed: torch.Tensor, length: int,
            rounds: int = ROUNDS) -> torch.Tensor:
    """``rounds`` times x = SHA256(x || s) on every lane: ``x0`` (8, N)
    uint32 BE words, ``seed`` (ceil(length / 4), N) uint32 BE words of the
    seeds, all ``length`` bytes long, zero-padded -> (8, N) uint32.  A CUDA
    tensor goes through W2, a CPU tensor through the plain version."""
    n = check_words(x0, 8, "x0")
    if check_words(seed, (length + 3) // 4, "seed") != n or rounds < 0:
        raise ValueError(f"stretch: {tuple(seed.shape)} seed words for {n} lanes, "
                         f"{rounds} rounds")
    if x0.device != seed.device:
        raise ValueError(f"tensors on different devices: {x0.device} and {seed.device}")
    if x0.device.type == "cpu":
        return stretch_plain(x0, seed, length, rounds)
    out = torch.empty((8, n), dtype=torch.uint32, device=x0.device)
    if n:
        KERNEL.launch(x0.device, x0.data_ptr(), seed.data_ptr() if length else 0, n, length,
                      rounds, out.data_ptr())
    return out


def seed_words(seeds: List[bytes]) -> torch.Tensor:
    """Seeds of one length -> (ceil(length / 4), N) uint32 BE words."""
    pad = -(-len(seeds[0]) // 4) * 4
    raw = b"".join(s.ljust(pad, b"\x00") for s in seeds)
    w = np.frombuffer(raw, dtype=">u4").astype(np.uint32).reshape(len(seeds), pad // 4)
    return torch.from_numpy(np.ascontiguousarray(w.T).view(np.int32)).view(torch.uint32)


def _words_bytes(words: torch.Tensor) -> List[bytes]:
    """(8, N) uint32 BE words -> N byte strings of 32."""
    raw = np.ascontiguousarray(words.view(torch.int32).cpu().numpy().view(np.uint32).T)
    raw = raw.astype(">u4").tobytes()
    return [raw[32 * i:32 * i + 32] for i in range(words.shape[1])]


def stretch_keys_device(seeds: List[bytes], device=None) -> List[bytes]:
    """The stretched keys of seeds of one length: x_0 = SHA256(s || s) on
    the host, then the 99,999 rounds through W2 on a CUDA ``device``, or
    hashlib on the CPU (``device`` None)."""
    if not seeds:
        return []
    slen = len(seeds[0])
    if any(len(s) != slen for s in seeds):
        raise AssertionError("uniform seed length required")
    dev = torch.device("cpu") if device is None else torch.device(device)
    if dev.type == "cpu":
        return [stretch_key(s) for s in seeds]
    x0 = b"".join(hashlib.sha256(s + s).digest() for s in seeds)
    xw = np.frombuffer(x0, dtype=">u4").astype(np.uint32).reshape(len(seeds), 8)
    xt = torch.from_numpy(np.ascontiguousarray(xw.T).view(np.int32)).view(torch.uint32)
    sw = (seed_words(seeds) if slen else torch.zeros((0, len(seeds)), dtype=torch.uint32))
    return _words_bytes(stretch(xt.to(dev), sw.to(dev), slen))


def master_pubkeys_device(stretched: List[bytes], device=None) -> List[Optional[bytes]]:
    """Uncompressed master public keys (x || y, 64 bytes) of stretched keys,
    through ``ecc/pubkey.derive_pubkey`` (K3 -> K4 on a CUDA ``device``,
    their plain versions on the CPU); a scalar 0 or >= n maps to None, as
    ``ElectrumDeriver`` refuses it."""
    from ..ecc.pubkey import derive_pubkey

    out: List[Optional[bytes]] = [None] * len(stretched)
    idxs = [i for i, s in enumerate(stretched) if 0 < int.from_bytes(s, "big") < ref.N]
    if not idxs:
        return out
    dev = torch.device("cpu") if device is None else torch.device(device)
    raw = b"".join(stretched[i] for i in idxs)
    w = np.frombuffer(raw, dtype=">u4").astype(np.uint32).reshape(len(idxs), 8)
    words = torch.from_numpy(w.view(np.int32)).view(torch.uint32).to(dev)
    x, y, _ = derive_pubkey(words)
    xs = _words_bytes(x.T.contiguous())
    ys = _words_bytes(y.T.contiguous())
    for j, i in enumerate(idxs):
        out[i] = xs[j] + ys[j]
    return out
