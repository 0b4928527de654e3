"""Host-side Bitcoin encodings: hash160, base58check, bech32 v0, WIF.

The port's copy of what it uses from ``vuke_tpu/encode.py`` (BIP13 and
BIP173 from their public specs).  Only candidate hits and target parsing
reach these string paths; the device works in hash160 space.

``hash160`` takes RIPEMD-160 from ``hashlib`` where the OpenSSL build has
it, and otherwise from ``ripemd160``, written out here from the
specification, which gives the same bytes.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

_B58_ALPHABET = "123456789ABCDEFGHJKLMNPQRSTUVWXYZabcdefghijkmnopqrstuvwxyz"
_B58_INDEX = {c: i for i, c in enumerate(_B58_ALPHABET)}

_BECH32_CHARSET = "qpzry9x8gf2tvdw0s3jn54khce6mua7l"
_BECH32_INDEX = {c: i for i, c in enumerate(_BECH32_CHARSET)}

# RIPEMD-160 message-word order, rotations and constants, left and right lines
_RL = [list(range(16)),
       [7, 4, 13, 1, 10, 6, 15, 3, 12, 0, 9, 5, 2, 14, 11, 8],
       [3, 10, 14, 4, 9, 15, 8, 1, 2, 7, 0, 6, 13, 11, 5, 12],
       [1, 9, 11, 10, 0, 8, 12, 4, 13, 3, 7, 15, 14, 5, 6, 2],
       [4, 0, 5, 9, 7, 12, 2, 10, 14, 1, 3, 8, 11, 6, 15, 13]]
_RR = [[5, 14, 7, 0, 9, 2, 11, 4, 13, 6, 15, 8, 1, 10, 3, 12],
       [6, 11, 3, 7, 0, 13, 5, 10, 14, 15, 8, 12, 4, 9, 1, 2],
       [15, 5, 1, 3, 7, 14, 6, 9, 11, 8, 12, 2, 10, 0, 4, 13],
       [8, 6, 4, 1, 3, 11, 15, 0, 5, 12, 2, 13, 9, 7, 10, 14],
       [12, 15, 10, 4, 1, 5, 8, 7, 6, 2, 13, 14, 0, 3, 9, 11]]
_SL = [[11, 14, 15, 12, 5, 8, 7, 9, 11, 13, 14, 15, 6, 7, 9, 8],
       [7, 6, 8, 13, 11, 9, 7, 15, 7, 12, 15, 9, 11, 7, 13, 12],
       [11, 13, 6, 7, 14, 9, 13, 15, 14, 8, 13, 6, 5, 12, 7, 5],
       [11, 12, 14, 15, 14, 15, 9, 8, 9, 14, 5, 6, 8, 6, 5, 12],
       [9, 15, 5, 11, 6, 8, 13, 12, 5, 12, 13, 14, 11, 8, 5, 6]]
_SR = [[8, 9, 9, 11, 13, 15, 15, 5, 7, 7, 8, 11, 14, 14, 12, 6],
       [9, 13, 15, 7, 12, 8, 9, 11, 7, 7, 12, 7, 6, 15, 13, 11],
       [9, 7, 15, 11, 8, 6, 6, 14, 12, 13, 5, 14, 13, 13, 7, 5],
       [15, 5, 8, 11, 14, 14, 6, 14, 6, 9, 12, 9, 12, 5, 15, 8],
       [8, 5, 12, 9, 12, 5, 14, 6, 8, 13, 6, 5, 15, 13, 11, 11]]
_KL = [0, 0x5A827999, 0x6ED9EBA1, 0x8F1BBCDC, 0xA953FD4E]
_KR = [0x50A28BE6, 0x5C4DD124, 0x6D703EF3, 0x7A6D76E9, 0]
_FS = [lambda x, y, z: x ^ y ^ z,
       lambda x, y, z: (x & y) | (~x & z),
       lambda x, y, z: (x | ~y) ^ z,
       lambda x, y, z: (x & z) | (y & ~z),
       lambda x, y, z: x ^ (y | ~z)]
_M32 = 0xFFFFFFFF


def ripemd160(msg: bytes) -> bytes:
    """RIPEMD-160 from its specification, for ``hashlib`` builds without it."""

    def rol(x, s):
        return ((x << s) | (x >> (32 - s))) & _M32

    h = [0x67452301, 0xEFCDAB89, 0x98BADCFE, 0x10325476, 0xC3D2E1F0]
    data = (msg + b"\x80" + b"\x00" * ((55 - len(msg)) % 64)
            + (8 * len(msg)).to_bytes(8, "little"))
    for off in range(0, len(data), 64):
        x = [int.from_bytes(data[off + 4 * i:off + 4 * i + 4], "little") for i in range(16)]
        al, bl, cl, dl, el = h
        ar, br, cr, dr, er = h
        for r in range(5):
            for j in range(16):
                t = rol((al + (_FS[r](bl, cl, dl) & _M32) + x[_RL[r][j]] + _KL[r]) & _M32,
                        _SL[r][j]) + el
                al, el, dl, cl, bl = el, dl, rol(cl, 10), bl, t & _M32
                t = rol((ar + (_FS[4 - r](br, cr, dr) & _M32) + x[_RR[r][j]] + _KR[r]) & _M32,
                        _SR[r][j]) + er
                ar, er, dr, cr, br = er, dr, rol(cr, 10), br, t & _M32
        h = [(h[1] + cl + dr) & _M32, (h[2] + dl + er) & _M32, (h[3] + el + ar) & _M32,
             (h[4] + al + br) & _M32, (h[0] + bl + cr) & _M32]
    return b"".join(v.to_bytes(4, "little") for v in h)


def sha256d(data: bytes) -> bytes:
    return hashlib.sha256(hashlib.sha256(data).digest()).digest()


def hash160(data: bytes) -> bytes:
    d = hashlib.sha256(data).digest()
    try:
        return hashlib.new("ripemd160", d).digest()
    except ValueError:
        return ripemd160(d)


def base58check_encode(payload: bytes) -> str:
    data = payload + sha256d(payload)[:4]
    num = int.from_bytes(data, "big")
    out = []
    while num:
        num, rem = divmod(num, 58)
        out.append(_B58_ALPHABET[rem])
    pad = len(data) - len(data.lstrip(b"\x00"))
    return "1" * pad + "".join(reversed(out))


def base58check_decode(s: str) -> bytes:
    num = 0
    for c in s:
        if c not in _B58_INDEX:
            raise ValueError(f"invalid base58 character: {c!r}")
        num = num * 58 + _B58_INDEX[c]
    raw = num.to_bytes((num.bit_length() + 7) // 8, "big")
    data = b"\x00" * (len(s) - len(s.lstrip("1"))) + raw
    if len(data) < 4:
        raise ValueError("base58 string too short")
    payload, checksum = data[:-4], data[-4:]
    if sha256d(payload)[:4] != checksum:
        raise ValueError("base58 checksum mismatch")
    return payload


# --- bech32 (BIP173) -------------------------------------------------------

def _bech32_polymod(values) -> int:
    gen = [0x3B6A57B2, 0x26508E6D, 0x1EA119FA, 0x3D4233DD, 0x2A1462B3]
    chk = 1
    for v in values:
        top = chk >> 25
        chk = (chk & 0x1FFFFFF) << 5 ^ v
        for i in range(5):
            chk ^= gen[i] if ((top >> i) & 1) else 0
    return chk


def _bech32_hrp_expand(hrp: str):
    return [ord(x) >> 5 for x in hrp] + [0] + [ord(x) & 31 for x in hrp]


def _convertbits(data, frombits: int, tobits: int, pad: bool):
    acc = 0
    bits = 0
    ret = []
    maxv = (1 << tobits) - 1
    for value in data:
        if value < 0 or (value >> frombits):
            raise ValueError("invalid value for convertbits")
        acc = (acc << frombits) | value
        bits += frombits
        while bits >= tobits:
            bits -= tobits
            ret.append((acc >> bits) & maxv)
    if pad:
        if bits:
            ret.append((acc << (tobits - bits)) & maxv)
    elif bits >= frombits or ((acc << (tobits - bits)) & maxv):
        raise ValueError("invalid padding in convertbits")
    return ret


def bech32_encode_v0(hrp: str, witprog: bytes) -> str:
    data = [0] + _convertbits(witprog, 8, 5, True)
    polymod = _bech32_polymod(_bech32_hrp_expand(hrp) + data + [0] * 6) ^ 1
    checksum = [(polymod >> 5 * (5 - i)) & 31 for i in range(6)]
    return hrp + "1" + "".join(_BECH32_CHARSET[d] for d in data + checksum)


def bech32_decode(addr: str):
    """Returns (hrp, witver, witprog bytes). BIP173 (bech32, v0 only)."""
    if addr.lower() != addr and addr.upper() != addr:
        raise ValueError("mixed-case bech32")
    addr = addr.lower()
    pos = addr.rfind("1")
    if pos < 1 or pos + 7 > len(addr) or len(addr) > 90:
        raise ValueError("invalid bech32 framing")
    hrp, rest = addr[:pos], addr[pos + 1:]
    if any(c not in _BECH32_INDEX for c in rest):
        raise ValueError("invalid bech32 character")
    data = [_BECH32_INDEX[c] for c in rest]
    if _bech32_polymod(_bech32_hrp_expand(hrp) + data) != 1:
        raise ValueError("bech32 checksum mismatch")
    return hrp, data[0], bytes(_convertbits(data[1:-6], 5, 8, False))


# --- network parameters and address / WIF construction ---------------------

@dataclass(frozen=True)
class Network:
    """Version bytes and bech32 hrp of one network."""
    name: str
    p2pkh_version: int
    wif_version: int
    hrp: str


BITCOIN = Network("bitcoin", 0x00, 0x80, "bc")
TESTNET = Network("testnet", 0x6F, 0xEF, "tb")
SIGNET = Network("signet", 0x6F, 0xEF, "tb")
REGTEST = Network("regtest", 0x6F, 0xEF, "bcrt")

NETWORKS = {n.name: n for n in (BITCOIN, TESTNET, SIGNET, REGTEST)}


def parse_network(s: str) -> Network:
    """A ``--network`` name (any case) -> its Network; an unknown name warns
    on stderr and gives mainnet."""
    net = NETWORKS.get(s.lower())
    if net is None:
        import sys
        print(f"Warning: unknown network '{s}', using bitcoin mainnet", file=sys.stderr)
        return BITCOIN
    return net


def p2pkh_address(h160: bytes, network: Network = BITCOIN) -> str:
    return base58check_encode(bytes([network.p2pkh_version]) + h160)


def p2wpkh_address(h160: bytes, network: Network = BITCOIN) -> str:
    return bech32_encode_v0(network.hrp, h160)


def wif(key: bytes, compressed: bool, network: Network = BITCOIN) -> str:
    payload = bytes([network.wif_version]) + key
    if compressed:
        payload += b"\x01"
    return base58check_encode(payload)


def wif_decode(s: str):
    """(key bytes, compressed flag, version byte) of a WIF string."""
    payload = base58check_decode(s)
    version = payload[0]
    body = payload[1:]
    if len(body) == 33 and body[-1] == 0x01:
        return body[:32], True, version
    if len(body) == 32:
        return body, False, version
    raise ValueError("invalid WIF payload length")


def decode_address_h160(addr: str):
    """A target address -> (h160 bytes, "p2pkh" | "p2wpkh"), or None when
    the string is not a recognizable address."""
    try:
        if addr[:1] in "13mn2" and 25 <= len(addr) <= 36:
            payload = base58check_decode(addr)
            if len(payload) == 21:
                return payload[1:], "p2pkh"
        if "1" in addr and addr[:addr.rfind("1")].lower() in ("bc", "tb", "bcrt"):
            _, witver, prog = bech32_decode(addr)
            if witver == 0 and len(prog) == 20:
                return prog, "p2wpkh"
    except ValueError:
        return None
    return None
