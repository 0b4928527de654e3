"""E1: the Parquet record's string columns that need arithmetic, on the card.

The counterpart of the host encoders of ``vuke_tpu/derive.py:66-93``
(``KeyDeriver.derive``) as ``vuke_tpu/storage/output.py:42-46`` runs them
for every generate record: the decimal key, both WIFs, both P2PKH
addresses, the P2WPKH address and the key's statistics.  ``encode_records``
reads the normalized (8, N) BE key words and K2's two (5, N) LE digests
where they lie and writes (N, ``ROW``) uint8 rows, each field NUL-padded at
its offset in ``FIELDS``; a CUDA tensor goes through the kernel
(``csrc/records.cu``), a CPU tensor through ``records_plain``, the same
rows from torch ops on int64-held words.

The hex columns (the key, its 256 bits, both public keys) are the host's:
``host_columns`` expands them from the same key words and K4's affine x
and y with numpy tables, as ``pipeline.format_lines`` expands its hex.
``RecordBlock`` holds a block of generate records in the order of their
lines and gives them to each output as it wants them: the driver's
compact lines, ``DerivedKey``s or an Arrow batch.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from .. import encode
from .._device import byteswap32, check_same_device, check_words, i64
from ..derive import DerivedKey
from ..kernels import INT, PTR, SIZE, U32, Kernel
from .sha256 import sha256_key_words, sha256_words

KERNEL = Kernel(
    "records", "vk_records", [PTR, PTR, PTR, INT, INT, U32, INT, U32, PTR, SIZE],
    source="vuke_tpu_torch/csrc/records.cu",
    replaces="vuke_tpu/derive.py:66-93 KeyDeriver.derive encoders, as "
             "vuke_tpu/storage/output.py:42-46 calls them (host Python; "
             "native/vuke_native.cpp:179 for P2PKH)")

# (column, offset, width) of each string field of a row, left-aligned, NULs after
FIELDS = (("private_key_decimal", 0, 78), ("wif_compressed", 78, 52),
          ("wif_uncompressed", 130, 51), ("address_p2pkh_compressed", 181, 34),
          ("address_p2pkh_uncompressed", 215, 34), ("address_p2wpkh", 249, 44))
# bit length (u16 LE), Hamming weight (u16 LE), leading zero hex digits (u8)
STATS = 293
ROW = 304

_B58 = torch.tensor(list(b"123456789ABCDEFGHJKLMNPQRSTUVWXYZabcdefghijkmnopqrstuvwxyz"))
_BECH32 = torch.tensor(list(b"qpzry9x8gf2tvdw0s3jn54khce6mua7l"))
_BECH32_GEN = (0x3B6A57B2, 0x26508E6D, 0x1EA119FA, 0x3D4233DD, 0x2A1462B3)
_B58_POW5 = 58 ** 5


def field_span(name: str) -> tuple:
    """(offset, width) of the string field ``name`` in a row."""
    return next((o, w) for f, o, w in FIELDS if f == name)


def network_params(network: encode.Network) -> tuple:
    """The launch's parameters of ``network``: (P2PKH version, WIF version,
    the hrp's bytes packed little-endian, its length, the bech32 checksum's
    state after the hrp's expansion)."""
    hrp = network.hrp.encode()
    if not 1 <= len(hrp) <= 4:
        raise ValueError(f"records: hrp {network.hrp!r} is not 1 to 4 bytes")
    chk = encode._bech32_polymod(encode._bech32_hrp_expand(network.hrp))
    return (network.p2pkh_version, network.wif_version, int.from_bytes(hrp, "little"),
            len(hrp), chk)


def _check(norm, h160c, h160u) -> int:
    n = check_words(norm, 8, "norm")
    if check_words(h160c, 5, "h160c") != n or check_words(h160u, 5, "h160u") != n:
        raise ValueError("records: norm, h160c and h160u differ in N")
    check_same_device(norm, h160c, h160u)
    return n


# --- the plain version: torch ops on int64-held words, any device ---

def _bytes_of(words) -> list:
    """BE words -> their bytes, most significant first."""
    return [(w >> s) & 0xFF for w in words for s in (24, 16, 8, 0)]


def _words_of(byts) -> list:
    """Bytes -> BE words, zeros after the last."""
    b = list(byts) + [0] * (-len(byts) % 4)
    return [(b[i] << 24) | (b[i + 1] << 16) | (b[i + 2] << 8) | b[i + 3]
            for i in range(0, len(b), 4)]


def _left_align(digits: torch.Tensor, first: torch.Tensor, zeros, table, width: int):
    """Rows of ``width``: '1' x ``zeros``, then ``table`` of the digits from
    ``first`` on, then NULs."""
    n, d = digits.shape
    t = torch.arange(width, device=digits.device)
    zeros = torch.as_tensor(zeros, device=digits.device).expand(n)[:, None]
    idx = (first[:, None] + t - zeros).clamp(0, d - 1)
    chars = table.to(digits.device)[torch.gather(digits, 1, idx)]
    out = torch.where(t < zeros, ord("1"), torch.where(t < zeros + d - first[:, None], chars, 0))
    return out.to(torch.uint8)


def _first_nonzero(digits: torch.Tensor, default: int) -> torch.Tensor:
    nz = digits != 0
    return torch.where(nz.any(dim=1), nz.to(torch.int8).argmax(dim=1), default)


def _base58check_plain(payload: list, width: int) -> torch.Tensor:
    """base58check of the payload bytes (int64 tensors or ints, at least one
    a tensor): (N, width) rows."""
    chk = sha256_key_words(sha256_words(_words_of(payload), len(payload)))[0]
    byts = list(payload) + _bytes_of([chk])
    like = next(b for b in byts if isinstance(b, torch.Tensor))
    byts = [b if isinstance(b, torch.Tensor) else torch.full_like(like, b) for b in byts]
    zeros = torch.zeros_like(like)
    more = torch.ones_like(like, dtype=torch.bool)
    for b in byts:
        more = more & (b == 0)
        zeros = zeros + more.to(torch.int64)
    limbs = _words_of([0] * (-len(byts) % 4) + byts)
    passes = -(-math.ceil(len(byts) * 8 / math.log2(58)) // 5)
    digits = []
    for _ in range(passes):
        rem = torch.zeros_like(like)
        for j in range(len(limbs)):
            cur = (rem << 32) | limbs[j]
            limbs[j] = cur // _B58_POW5
            rem = cur - limbs[j] * _B58_POW5
        for _ in range(5):
            digits.append(rem % 58)
            rem = rem // 58
    digits = torch.stack(digits[::-1], dim=1)
    return _left_align(digits, _first_nonzero(digits, digits.shape[1]), zeros, _B58, width)


def _decimal_plain(k: list) -> torch.Tensor:
    """(N, 78) rows of the decimal key, "0" for 0."""
    limbs = list(k)
    groups = []
    for _ in range(9):
        rem = torch.zeros_like(limbs[0])
        for j in range(8):
            cur = (rem << 32) | limbs[j]
            limbs[j] = cur // 1_000_000_000
            rem = cur - limbs[j] * 1_000_000_000
        groups.append(rem)
    digits = []
    for g in groups[::-1]:
        digits += [(g // 10 ** (8 - t)) % 10 for t in range(9)]
    digits = torch.stack(digits, dim=1)
    first = _first_nonzero(digits[:, :80], 80)
    return _left_align(digits, first, 0, torch.arange(48, 58), 78)


def _bech32_plain(d: list, network: encode.Network) -> torch.Tensor:
    """(N, 44) rows of the bech32 v0 address of the 20 bytes in BE words d."""
    bits = torch.stack([(w >> s) & 1 for w in d for s in range(31, -1, -1)], dim=1)
    groups = [torch.zeros_like(d[0])] + [
        (bits[:, 5 * g:5 * g + 5] * torch.tensor([16, 8, 4, 2, 1], device=bits.device)).sum(1)
        for g in range(32)]
    chk = torch.full_like(d[0], network_params(network)[4])
    for v in groups + [0] * 6:
        top = chk >> 25
        chk = ((chk & 0x1FFFFFF) << 5) ^ v
        for i, gen in enumerate(_BECH32_GEN):
            chk = chk ^ (((top >> i) & 1) * gen)
    chk = chk ^ 1
    data = torch.stack(groups + [(chk >> (5 * (5 - i))) & 31 for i in range(6)], dim=1)
    table = _BECH32.to(data.device)
    hrp = torch.tensor(list(network.hrp.encode() + b"1"), device=data.device)
    n = data.shape[0]
    out = torch.zeros((n, 44), dtype=torch.uint8, device=data.device)
    out[:, :len(hrp)] = hrp.to(torch.uint8)
    out[:, len(hrp):len(hrp) + 39] = table[data].to(torch.uint8)
    return out


def records_plain(norm: torch.Tensor, h160c: torch.Tensor, h160u: torch.Tensor,
                  network: encode.Network = encode.BITCOIN) -> torch.Tensor:
    """Plain version of ``encode_records``, on the tensors' device."""
    n = _check(norm, h160c, h160u)
    k = list(i64(norm).unbind(0))
    out = torch.zeros((n, ROW), dtype=torch.uint8, device=norm.device)
    if not n:
        return out
    fields = {"private_key_decimal": _decimal_plain(k)}
    key = _bytes_of(k)
    fields["wif_uncompressed"] = _base58check_plain([network.wif_version] + key, 51)
    fields["wif_compressed"] = _base58check_plain([network.wif_version] + key + [1], 52)
    for name, h in (("compressed", h160c), ("uncompressed", h160u)):
        d = [byteswap32(w) for w in i64(h).unbind(0)]
        fields[f"address_p2pkh_{name}"] = _base58check_plain(
            [network.p2pkh_version] + _bytes_of(d), 34)
        if name == "compressed":
            fields["address_p2wpkh"] = _bech32_plain(d, network)
    for name, off, width in FIELDS:
        out[:, off:off + width] = fields[name]
    lz = torch.zeros_like(k[0])
    weight = torch.zeros_like(k[0])
    more = torch.ones_like(k[0], dtype=torch.bool)
    for w in k:
        wlz = torch.full_like(w, 32)
        for b in range(32):
            weight = weight + ((w >> b) & 1)
            wlz = torch.where((w >> b) & 1 == 1, 31 - b, wlz)
        lz = lz + torch.where(more, wlz, 0)
        more = more & (w == 0)
    bits = 256 - lz
    for j, v in enumerate((bits & 0xFF, bits >> 8, weight & 0xFF, weight >> 8, lz >> 2)):
        out[:, STATS + j] = v.to(torch.uint8)
    return out


def encode_records(norm: torch.Tensor, h160c: torch.Tensor, h160u: torch.Tensor,
                   network: encode.Network = encode.BITCOIN) -> torch.Tensor:
    """(8, N) uint32 normalized BE key words and the (5, N) uint32 LE
    hash160 words of both public keys -> (N, ``ROW``) uint8 record rows
    under ``network``; one launch."""
    n = _check(norm, h160c, h160u)
    dev = norm.device
    if dev.type == "cpu":
        return records_plain(norm, h160c, h160u, network)
    params = network_params(network)
    out = torch.empty((n, ROW), dtype=torch.uint8, device=dev)
    if n:
        KERNEL.launch(dev, norm.data_ptr(), h160c.data_ptr(), h160u.data_ptr(), *params,
                      out.data_ptr(), n)
    return out


# --- the host's side: hex columns and blocks of records ---

_HEX = np.frombuffer(b"0123456789abcdef", dtype=np.uint8)


def key_bytes(words: np.ndarray) -> np.ndarray:
    """(M, 8) uint32 BE words -> (M, 32) uint8."""
    return np.ascontiguousarray(words, dtype=np.uint32).astype(">u4").view(np.uint8).reshape(
        len(words), 32)


def hex_rows(byts: np.ndarray) -> np.ndarray:
    """(M, B) uint8 -> (M, 2B) uint8 lowercase hex."""
    return _HEX[np.stack([byts >> 4, byts & 15], axis=-1)].reshape(len(byts), -1)


def host_columns(norm: np.ndarray, x: np.ndarray, y: np.ndarray) -> dict:
    """The hex columns of M records, each (M, W) uint8: the key's hex (64),
    its bits (256), both public keys (66 and 130); and ``private_key_raw``
    (M, 32).  ``norm``, ``x``, ``y``: (M, 8) uint32 BE words."""
    raw = key_bytes(norm)
    xh, yh = hex_rows(key_bytes(x)), hex_rows(key_bytes(y))
    m = len(raw)
    comp = np.empty((m, 66), dtype=np.uint8)
    comp[:, 0] = ord("0")
    comp[:, 1] = ord("2") + (np.asarray(y)[:, 7] & 1)
    comp[:, 2:] = xh
    uncomp = np.empty((m, 130), dtype=np.uint8)
    uncomp[:, :2] = np.frombuffer(b"04", dtype=np.uint8)
    uncomp[:, 2:66] = xh
    uncomp[:, 66:] = yh
    return {"private_key_raw": raw, "private_key_hex": hex_rows(raw),
            "private_key_binary": np.unpackbits(raw, axis=1) + np.uint8(48),
            "pubkey_compressed": comp, "pubkey_uncompressed": uncomp}


def texts(rows: np.ndarray) -> list:
    """(M, W) left-aligned NUL-padded uint8 rows -> strings."""
    rows = np.ascontiguousarray(rows)
    return [b.decode() for b in rows.view(f"S{rows.shape[1]}").ravel().tolist()]


@dataclass
class RecordBlock:
    """Generate records of one transform, in the order of their lines:
    ``sources`` a list of strings or (M, W) uint8 rows (non-NUL bytes the
    string), ``norm``, ``x``, ``y`` (M, 8) uint32 BE words, ``rows`` (M,
    ``ROW``) E1's rows; ``write_lines(output)`` writes the block's compact
    lines to a console, as the driver writes them without records
    (``pipeline.format_lines`` or ``write_keys``)."""
    transform: str
    sources: object
    norm: np.ndarray
    x: np.ndarray
    y: np.ndarray
    rows: np.ndarray
    write_lines: Optional[Callable] = None

    def __len__(self) -> int:
        return len(self.rows)

    def source_strings(self) -> list:
        if isinstance(self.sources, np.ndarray):
            s = self.sources
            return [bytes(r[r != 0]).decode() for r in s]
        return list(self.sources)

    def field(self, name: str) -> np.ndarray:
        off, width = field_span(name)
        return self.rows[:, off:off + width]

    def stats(self):
        """(bit length, Hamming weight, leading zero hex digits) arrays."""
        s = self.rows[:, STATS:STATS + 5].astype(np.uint16)
        return s[:, 0] | s[:, 1] << 8, s[:, 2] | s[:, 3] << 8, s[:, 4].astype(np.uint8)

    def derived(self) -> list:
        """One ``DerivedKey`` a record, as the host ``KeyDeriver`` derives it."""
        cols = host_columns(self.norm, self.x, self.y)
        text = {name: texts(cols[name]) for name in
                ("private_key_hex", "private_key_binary", "pubkey_compressed",
                 "pubkey_uncompressed")}
        text.update({name: texts(self.field(name)) for name, _, _ in FIELDS})
        bits, weight, lz = self.stats()
        raw = cols["private_key_raw"]
        return [DerivedKey(
            raw=raw[i].tobytes(), private_key_hex=text["private_key_hex"][i],
            private_key_decimal=text["private_key_decimal"][i],
            private_key_binary=text["private_key_binary"][i], bit_length=int(bits[i]),
            hamming_weight=int(weight[i]), leading_zeros=int(lz[i]),
            pubkey_compressed=text["pubkey_compressed"][i],
            pubkey_uncompressed=text["pubkey_uncompressed"][i],
            wif_compressed=text["wif_compressed"][i],
            wif_uncompressed=text["wif_uncompressed"][i],
            p2pkh_compressed=text["address_p2pkh_compressed"][i],
            p2pkh_uncompressed=text["address_p2pkh_uncompressed"][i],
            p2wpkh=text["address_p2wpkh"][i]) for i in range(len(self))]

    def record_batch(self, timestamp=None):
        """The block as a ``storage.records.result_schema`` Arrow batch."""
        from ..storage.records import columns_to_batch

        cols = host_columns(self.norm, self.x, self.y)
        strings = {name: cols[name] for name in
                   ("private_key_hex", "private_key_binary", "pubkey_compressed",
                    "pubkey_uncompressed")}
        strings.update({name: self.field(name) for name, _, _ in FIELDS})
        bits, weight, lz = self.stats()
        return columns_to_batch(sources=self.sources, transform=self.transform,
                                raw=cols["private_key_raw"], strings=strings, bit_length=bits,
                                hamming_weight=weight, leading_zeros=lz, timestamp=timestamp)


def emit_block(output, block: RecordBlock):
    """``block`` to ``output``: whole where it takes blocks (``key_columns``:
    storage, a fan-out), as the compact lines where it takes no records (a
    console not in verbose mode), else one ``key`` a record."""
    if hasattr(output, "key_columns"):
        output.key_columns(block)
    elif not needs_records(output):
        block.write_lines(output)
    else:
        for source, derived in zip(block.source_strings(), block.derived()):
            output.key(source, block.transform, derived)


def needs_records(output) -> bool:
    """Whether ``output`` takes generate records (E1's columns) rather than
    compact lines alone: anything but a non-verbose console."""
    return output is not None and getattr(output, "needs_records", True)
