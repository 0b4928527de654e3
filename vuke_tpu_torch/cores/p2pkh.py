"""D2: P2PKH addresses of a batch of compressed hash160s on the card.

The counterpart of the JAX package's host C++ encoder
(``vuke_tpu/native.py:71`` ``batch_p2pkh``, ``native/vuke_native.cpp:179``),
which the port may not import: version || h160 -> SHA-256d checksum ->
base58.  It reads K2's (5, N) LE digest words where they lie and writes
(N, 35) uint8 rows, each an address of 26 to 34 ASCII characters padded
with NULs.  A CUDA tensor goes through the kernel (``csrc/p2pkh.cu``), a
CPU tensor through the plain version, ``encode.p2pkh_address``'s base58check
of each row.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import encode
from .._device import check_words, i64
from ..kernels import INT, PTR, SIZE, Kernel

KERNEL = Kernel(
    "p2pkh", "vk_p2pkh", [PTR, INT, PTR, SIZE],
    source="vuke_tpu_torch/csrc/p2pkh.cu",
    replaces="vuke_tpu/native.py:71 batch_p2pkh (host C++, native/vuke_native.cpp:179)")

ROW = 35


def _check(h160c: torch.Tensor, version: int) -> int:
    if not 0 <= version <= 255:
        raise ValueError(f"batch_p2pkh: version {version} is not a byte")
    return check_words(h160c, 5, "h160c")


def batch_p2pkh_plain(h160c: torch.Tensor, version: int) -> torch.Tensor:
    """Plain version of ``batch_p2pkh``: the base58check of each row,
    ``encode.p2pkh_address``'s encoding."""
    n = _check(h160c, version)
    digests = i64(h160c).cpu().numpy().astype("<u4").T.copy().tobytes()
    out = np.zeros((n, ROW), dtype=np.uint8)
    for i in range(n):
        addr = encode.base58check_encode(bytes([version]) + digests[20 * i:20 * i + 20])
        out[i, :len(addr)] = np.frombuffer(addr.encode(), dtype=np.uint8)
    return torch.from_numpy(out).to(h160c.device)


def batch_p2pkh(h160c: torch.Tensor, version: int) -> torch.Tensor:
    """(5, N) uint32 LE hash160 words -> (N, 35) uint8 rows of P2PKH
    addresses under ``version`` (0x00 mainnet, 0x6F the test networks),
    NUL-padded; one launch."""
    n = _check(h160c, version)
    dev = h160c.device
    if dev.type == "cpu":
        return batch_p2pkh_plain(h160c, version)
    out = torch.empty((n, ROW), dtype=torch.uint8, device=dev)
    if n:
        KERNEL.launch(dev, h160c.data_ptr(), version, out.data_ptr(), n)
    return out


def addresses(rows: np.ndarray) -> list[str]:
    """(N, 35) uint8 rows -> the address strings."""
    return [r.decode() for r in np.ascontiguousarray(rows).view(f"S{ROW}").ravel().tolist()]
