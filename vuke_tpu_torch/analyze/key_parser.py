"""Private key parsing: hex / WIF / decimal, and cascade strings.

The port's copy of ``vuke_tpu/analyze/key_parser.py`` (the reference's
``analyze/key_parser.rs:32-151``): the same acceptance rules (0x prefix,
at most 64 hex digits left-padded; WIF first characters 5/K/L/9/c; decimal
with a scalar-range check), the same cascade grammar ``bits:target,...``
with duplicate rejection and an ascending sort, and the same error texts.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from .. import encode
from ..ecc import ref


class ParseError(ValueError):
    pass


def _try_parse_hex(s: str) -> Optional[bytes]:
    if s.startswith("0x"):
        s = s[2:]
    if not s or len(s) > 64:
        return None
    if not all(c in "0123456789abcdefABCDEF" for c in s):
        return None
    return bytes.fromhex(s.rjust(64, "0"))


def _try_parse_wif(s: str) -> Optional[bytes]:
    if not s or s[0] not in "5KL9c":
        return None
    try:
        key, _compressed, _version = encode.wif_decode(s)
        return key
    except ValueError:
        return None


def _try_parse_decimal(s: str) -> Optional[bytes]:
    if not s or not s.isdigit():
        return None
    v = int(s)
    if v.bit_length() > 256:
        return None
    key = v.to_bytes(32, "big")
    if v == 0 or v >= ref.N:
        return None
    return key


def parse_private_key(s: str) -> bytes:
    s = s.strip()
    for f in (_try_parse_wif, _try_parse_hex, _try_parse_decimal):
        key = f(s)
        if key is not None:
            return key
    raise ParseError("unknown key format")


def parse_cascade(s: str) -> List[Tuple[int, int]]:
    """'bits:target,bits:target,...' -> [(bits, target)] sorted ascending."""
    s = s.strip()
    if not s:
        raise ParseError("invalid cascade format: empty input")
    targets: List[Tuple[int, int]] = []
    for part in s.split(","):
        part = part.strip()
        if not part:
            continue
        pieces = part.split(":")
        if len(pieces) != 2:
            raise ParseError(f"invalid cascade format: expected 'bits:target', got '{part}'")
        bits_s, target_s = pieces[0].strip(), pieces[1].strip()
        try:
            bits = int(bits_s)
        except ValueError:
            raise ParseError(f"invalid cascade format: bad bits '{bits_s}'")
        if not 1 <= bits <= 64:
            raise ParseError(f"invalid cascade format: bits must be 1-64, got {bits}")
        try:
            target = int(target_s, 16) if target_s.lower().startswith("0x") else int(target_s)
        except ValueError:
            raise ParseError(f"invalid cascade format: bad target '{target_s}'")
        max_value = (1 << bits) - 1 if bits < 64 else (1 << 64) - 1
        if target > max_value:
            raise ParseError(
                f"invalid cascade format: target 0x{target:x} exceeds {bits}-bit "
                f"maximum (0x{max_value:x})")
        # high bit is a structural property of masked keys: (key & mask) | high_bit
        if target & (1 << (bits - 1)) == 0:
            raise ParseError(
                f"invalid cascade format: target 0x{target:x} must have high bit "
                f"set for {bits}-bit mask (bit {bits - 1})")
        if (bits, target) in targets:
            raise ParseError(f"invalid cascade format: duplicate target {bits}:{target}")
        targets.append((bits, target))
    if len(targets) < 2:
        raise ParseError(
            "invalid cascade format: cascade requires at least 2 targets "
            "(use --mask for single target)")
    targets.sort(key=lambda t: t[0])
    return targets


def apply_mask(key: bytes, bits: int) -> int:
    """(low-8-bytes-as-u64 & (2^bits - 1)) | 2^(bits-1)
    (the reference's analyze/milksad.rs:146-189)."""
    key_u64 = int.from_bytes(key[24:32], "big")
    mask = (1 << bits) - 1 if bits < 64 else 0xFFFFFFFFFFFFFFFF
    return (key_u64 & mask) | (1 << (bits - 1))
